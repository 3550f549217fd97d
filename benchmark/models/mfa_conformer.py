"""MFA-Conformer (Zhang et al., Interspeech 2022, arXiv:2203.15249), the
6-block system with 1/2 subsampling: a kind of model, found by a
configuration's ``"model": "mfa_conformer"``.

Its configuration holds the widths of
`sepi_tpu_torch.models.MfaConformerConfig` under the same keys (feat_dim,
d_model, num_blocks, num_heads, ff_dim, conv_kernel, attention_bottleneck,
embed_dim, num_speakers; the lifter is the frontend's), and
``mfa_channels``, which must be num_blocks x d_model.  It extracts
only: no ``train`` section, so this kind has no training assembly.

- the program: the port's `MfaConformer`, built inside `build`, the one
  function here that imports the program;
- the weights' names and shapes, which start at 1 and which program
  buffers no configuration names (`reference.conformer`);
- the plain reference: `embed`, a chunk's embedding (`reference.conformer`);
- the counts: `embed_flops`, and `relpos_bytes` for the attention score
  kernel's roofline.
"""

from __future__ import annotations

from typing import Mapping

import torch

from reference.conformer import (PROGRAM_ONLY, embed, param_names, starts_at_one,  # noqa: F401
                                 sub_bins, subsampled)

KEYS = ("feat_dim", "d_model", "num_blocks", "num_heads", "ff_dim", "conv_kernel",
        "attention_bottleneck", "embed_dim", "num_speakers")


def build(cfg: Mapping, device: torch.device, dtype: str = "float32") -> torch.nn.Module:
    """The port's model for the configuration, constructed on ``device``;
    it computes in float32 alone."""
    from sepi_tpu_torch import models as M

    if dtype != "float32":
        raise ValueError(f"MFA-Conformer extracts in float32, not {dtype}")
    if cfg["mfa_channels"] != cfg["num_blocks"] * cfg["d_model"]:
        raise ValueError(f"mfa_channels {cfg['mfa_channels']} is not num_blocks x d_model")
    with torch.device(device):
        mc = M.MfaConformerConfig(cepstral_lifter=float(cfg["frontend"]["cepstral_lifter"]),
                                  **{k: int(cfg[k]) for k in KEYS})
        return M.MfaConformer(mc)


def frame_flops(cfg: Mapping) -> float:
    """Forward flops a subsampled frame (2 per multiply-add), outside the
    attention's T'-wide products: the subsampler's second convolution
    (d x d x 9 on each of F'' bins) and its affine (d x F'' -> d); per
    block the two feed-forwards, the q/k/v and output affines, the
    convolution module's pointwise affines (d -> 2d, d -> d) and depthwise
    taps; the attentive pooling's two products (3M -> a, a -> M)."""
    d, ff, k = cfg["d_model"], cfg["ff_dim"], cfg["conv_kernel"]
    f2 = sub_bins(cfg)
    m, a = cfg["num_blocks"] * d, cfg["attention_bottleneck"]
    sub = d * d * 9 * f2 + d * f2 * d
    block = 2 * 2 * d * ff + 4 * d * d + (2 * d * d + d * d + d * k)
    return 2.0 * (sub + cfg["num_blocks"] * block + 3 * m * a + a * m)


def embed_flops(cfg: Mapping, frames: int) -> float:
    """Forward flops of one chunk of ``frames`` real frames: the input map
    and the subsampler's first convolution on their frames and bins,
    `frame_flops` on the T' subsampled frames, each block's positional
    affine on 2T' - 1 rows and its three attention products (ac, bd over
    the T' keys, probabilities times values) on T'^2 scores, and the
    head's affine once."""
    t2 = subsampled(frames)
    if t2 < 1:
        return 0.0
    d, f = cfg["d_model"], cfg["feat_dim"]
    t1, f1 = (frames - 3) // 2 + 1, (f - 3) // 2 + 1
    front = frames * f * f + t1 * f1 * 9 * d
    attention = (2 * t2 - 1) * d * d + 3 * t2 * t2 * d
    head = 2 * cfg["num_blocks"] * d * cfg["embed_dim"]
    return 2.0 * (front + cfg["num_blocks"] * attention + head) + t2 * frame_flops(cfg)


def relpos_bytes(cfg: Mapping, frames: int) -> float:
    """The attention score kernel's bytes for one chunk of ``frames`` real
    frames: per block, head and subsampled query row, one row of ``ac``
    and one band of ``bd`` of T' floats read and T' probabilities
    written, 12 T' bytes."""
    t2 = subsampled(frames)
    return 0.0 if t2 < 1 else 12.0 * cfg["num_blocks"] * cfg["num_heads"] * t2 * t2
