"""Flax x-vector variables -> a torch `state_dict` for `models.XVector`.

The input is the reference's ``{'params', 'batch_stats'}`` tree with
numpy (or array-like) leaves; nothing of JAX is imported.  Layouts:
- ``frames/tdnn{i}/affine/kernel`` (k, in, out) -> ``Conv1d.weight``
  (out, in, k); ``bias`` as is.  ``segment/tdnn6``/``tdnn7`` follow the
  same rule (their kernels are (1, in, out)).
- ``batchnorm/scale`` -> the BN weight; the BN bias is fixed at 0 (the
  reference's batchnorm has none); ``batch_stats .../mean``/``var`` ->
  ``running_mean``/``running_var``.
- ``segment/output`` Dense kernel (in, out) -> ``Linear.weight`` (out, in).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _layer(prefix: str, params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    kernel = np.asarray(params["affine"]["kernel"])  # (k, in, out)
    scale = _t(params["batchnorm"]["scale"])
    return {
        f"{prefix}.affine.weight": _t(np.transpose(kernel, (2, 1, 0))),
        f"{prefix}.affine.bias": _t(params["affine"]["bias"]),
        f"{prefix}.batchnorm.weight": scale,
        f"{prefix}.batchnorm.bias": torch.zeros_like(scale),
        f"{prefix}.batchnorm.running_mean": _t(stats["batchnorm"]["mean"]),
        f"{prefix}.batchnorm.running_var": _t(stats["batchnorm"]["var"]),
        f"{prefix}.batchnorm.num_batches_tracked": torch.tensor(0, dtype=torch.int64),
    }


def xvector_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    frames = params["frames"]
    for name in sorted(frames, key=lambda s: int(s.removeprefix("tdnn"))):
        out.update(_layer(f"frames.{name}", frames[name], stats["frames"][name]))
    seg = params["segment"]
    for name in ("tdnn6", "tdnn7"):
        out.update(_layer(f"segment.{name}", seg[name], stats["segment"][name]))
    if "output" in seg:
        out["segment.output.weight"] = _t(np.asarray(seg["output"]["kernel"]).T)
        out["segment.output.bias"] = _t(seg["output"]["bias"])
    return out
