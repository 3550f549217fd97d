"""Weights across from the reference: network variables, aligner models,
the classical v1 models.

`mono_aligner_from_jax` and `tied_tree_from_jax` carry the reference
aligner's GMM arrays and its senone tree into the port, so both packages
can align with the same acoustic model.

`state_dict_from_flax`: Flax variables of any TDNN-family model (the
x-vector, the AM net, the c-vectors) -> a torch `state_dict` under the
same module paths (`xvector_state_dict_from_flax` is the x-vector's
name for it).  The input is the reference's ``{'params', 'batch_stats'}``
tree with numpy (or array-like) leaves; nothing of JAX is imported.
Layouts:
- ``.../tdnn{i}/affine/kernel`` (k, in, out) -> ``Conv1d.weight``
  (out, in, k); ``bias`` as is.  ``segment/tdnn6``/``tdnn7`` follow the
  same rule (their kernels are (1, in, out)).
- ``batchnorm/scale`` -> the BN weight; the BN bias is fixed at 0 (the
  reference's batchnorm has none); ``batch_stats .../mean``/``var`` ->
  ``running_mean``/``running_var``.
- a Dense kernel (in, out) (``segment/output``, ``output_am``, the AM's
  ``output``) -> ``Linear.weight`` (out, in).
- a bare ``nn.Conv`` node (the nnet2's ``layer{i}/affine``, no batch norm)
  -> ``Conv1d.weight``/``bias`` (`nnet2_state_dict_from_flax`).

`diag_gmm_from_jax`, `full_gmm_from_jax` and `ivector_extractor_from_jax`
take the reference's classical models (any object with the same array
attributes) to the port's, on a device.

`flax_variables_from_state_dict` is the inverse: a port model's
`state_dict` -> the reference's ``{'params', 'batch_stats'}`` tree of
numpy arrays, so a model trained in the port loads into the reference.
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


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Any TDNN-family tree (x-vector, AM net, c-vectors, nnet2) -> a torch
    `state_dict` under the same module paths: a node holding ``affine`` and
    ``batchnorm`` is a `TdnnLayer`, a node holding a 2-D ``kernel`` a
    `Linear`, a 3-D ``kernel`` a `Conv1d`; every other node is walked into."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, params: Mapping, stats: Mapping) -> None:
        if "affine" in params and "batchnorm" in params:
            out.update(_layer(prefix, params, stats))
        elif "kernel" in params and np.ndim(params["kernel"]) == 2:
            out[f"{prefix}.weight"] = _t(np.asarray(params["kernel"]).T)
            out[f"{prefix}.bias"] = _t(params["bias"])
        elif "kernel" in params and np.ndim(params["kernel"]) == 3:
            out[f"{prefix}.weight"] = _t(np.transpose(np.asarray(params["kernel"]), (2, 1, 0)))
            out[f"{prefix}.bias"] = _t(params["bias"])
        else:
            for name, child in params.items():
                if not isinstance(child, Mapping):
                    raise ValueError(f"{prefix}.{name}: not a TDNN layer or a dense layer")
                walk(f"{prefix}.{name}" if prefix else name, child, stats.get(name, {}))

    walk("", variables["params"], variables.get("batch_stats", {}))
    return out


def xvector_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax x-vector variables -> a `models.XVector` state_dict."""
    return state_dict_from_flax(variables)


def nnet2_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax `Nnet2Multisplice` variables -> a `models.Nnet2Multisplice`
    state_dict (``layer{i}.affine`` Conv1d, ``output`` Linear)."""
    return state_dict_from_flax(variables)


def _arr(x, dev) -> torch.Tensor:
    return _t(x).to(dev)


def diag_gmm_from_jax(gmm, device="cuda"):
    """The reference's `DiagGmm` (``weights``, ``means``, ``vars``) ->
    `classical.gmm.DiagGmm` on ``device``."""
    from .classical.gmm import DiagGmm
    from .device import resolve_device

    dev = resolve_device(device)
    return DiagGmm(_arr(gmm.weights, dev), _arr(gmm.means, dev), _arr(gmm.vars, dev))


def full_gmm_from_jax(gmm, device="cuda"):
    """The reference's `FullGmm` (``weights``, ``means``, ``covars``) ->
    `classical.gmm.FullGmm` on ``device``."""
    from .classical.gmm import FullGmm
    from .device import resolve_device

    dev = resolve_device(device)
    return FullGmm(_arr(gmm.weights, dev), _arr(gmm.means, dev), _arr(gmm.covars, dev))


def ivector_extractor_from_jax(ext, device="cuda"):
    """The reference's `IvectorExtractor` (``t``, ``whitener``, ``means``)
    -> `classical.ivector.IvectorExtractor` on ``device``."""
    from .classical.ivector import IvectorExtractor
    from .device import resolve_device

    dev = resolve_device(device)
    return IvectorExtractor(_arr(ext.t, dev), _arr(ext.whitener, dev), _arr(ext.means, dev))


def flax_variables_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """A port `state_dict` -> ``{'params', 'batch_stats'}`` numpy trees in
    the reference's layout (the inverse of `xvector_state_dict_from_flax`).
    The batchnorm's offset must be zero: the reference has none."""
    params: Dict = {}
    stats: Dict = {}

    def put(tree, path, value):
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        tree[path[-1]] = value

    for name, t in state_dict.items():
        *path, leaf = name.split(".")
        a = t.detach().cpu().numpy()
        if leaf == "num_batches_tracked":
            continue
        if path and path[-1] == "batchnorm":
            if leaf == "bias":
                if np.any(a != 0):
                    raise ValueError(f"{name}: the reference's batchnorm has no offset")
                continue
            if leaf == "weight":
                put(params, path + ["scale"], a.copy())
            else:
                put(stats, path + [{"running_mean": "mean", "running_var": "var"}[leaf]], a.copy())
        elif leaf == "weight":
            # Conv1d (out, in, k) -> (k, in, out); Linear (out, in) -> (in, out)
            put(params, path + ["kernel"], np.ascontiguousarray(a.T if a.ndim == 2
                                                               else a.transpose(2, 1, 0)))
        else:
            put(params, path + [leaf], a.copy())
    return {"params": params, "batch_stats": stats}


def mono_aligner_from_jax(means, vars, mix_w, loop_logp, phones, states_per_phone,
                          device="cuda"):
    """A `align.mono.MonoAligner` from the reference aligner's arrays
    (numpy or array-like): the GMM on ``device``, ``loop_logp`` on the host."""
    from .align.mono import MonoAligner
    from .device import resolve_device

    dev = resolve_device(device)
    return MonoAligner(
        _t(means).to(dev), _t(vars).to(dev), _t(mix_w).to(dev),
        np.array(loop_logp, dtype=np.float32, copy=True),
        tuple(phones), int(states_per_phone),
    )


def tied_tree_from_jax(tree):
    """A port `align.tied.TiedTree` from the reference's tree, read by
    attribute (``roots``, ``num_leaves``, ``states_per_phone``,
    ``num_phones``; nodes' ``leaf_id``, ``side``, ``phone_set``, ``yes``,
    ``no``), so nothing of the reference package is imported."""
    from .align.tied import TiedTree, _Node

    def node(n):
        if n.leaf_id >= 0:
            return _Node(leaf_id=int(n.leaf_id))
        return _Node(leaf_id=-1, side=str(n.side),
                     phone_set=frozenset(int(p) for p in n.phone_set),
                     yes=node(n.yes), no=node(n.no))

    roots = {(int(c), int(s)): node(n) for (c, s), n in tree.roots.items()}
    return TiedTree(roots, int(tree.num_leaves), int(tree.states_per_phone),
                    int(tree.num_phones))
