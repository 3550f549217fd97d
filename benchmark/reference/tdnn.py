"""Plain reference of the TDNN layers the speaker networks are built of:
the x-vector (Snyder et al., ICASSP 2018; `egs/sre/v2`
`run_xvector_new.sh:90-115`) and the combined c-vector (Liu et al.,
Interspeech 2018; `egs/sre/v5` `prepare_nnet3_xconfig.sh:46-91`,
`train_cvector_with_am.sh:65-89`), whose wiring is each in its model
kind's file (`benchmark/models/<model>.py`).

A layer is Kaldi's relu-batchnorm-layer: a spliced affine (the frames at
the layer's offsets, concatenated, times the weight), ReLU, then batch
norm with a scale and no offset (eps 1e-3).  Stats pooling is the mean
and standard deviation (variance floored at 1e-10) over the valid
frames.  The embedding is tdnn6's affine output.  A model is described by
its configuration file (`benchmark/configs/<name>.json`): each stack
names the prefix of its parameters and lists its layers as [dim,
offsets], so this file reads the weights the benchmark made by their
names and knows nothing of the program's modules.

The eval layers (`layer_eval`, `stack_eval`, `head_embed`) run in
float64 or a control's precision with running statistics; the train
layers (`layer_train`, `stack_train`, `head_train`) run a batch in train
mode (batch statistics, as the training step normalises) with autograd,
in the precision of the configuration's training (`precision.mm_grad`).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch

from .precision import mm, mm_grad, round_bf16

EPS_BN = 1e-3
VAR_FLOOR = 1e-10

Params = Mapping[str, torch.Tensor]


def context(layers: List) -> Tuple[int, int]:
    return (sum(max(-min(o), 0) for _, o in layers), sum(max(max(o), 0) for _, o in layers))


def stacks_context(arch: Mapping, *stacks: str) -> Tuple[int, int]:
    """The (left, right) context of the named stacks of ``arch`` in a row."""
    return context([l for s in stacks for l in arch[s]["layers"]])


def _splice(x: torch.Tensor, offsets) -> torch.Tensor:
    """(..., T, C) -> (..., T', len(offsets) * C), VALID offsets."""
    lo, hi = min(offsets), max(offsets)
    t = x.shape[-2] - (hi - lo)
    return torch.cat([x[..., o - lo:o - lo + t, :] for o in offsets], dim=-1)


def _weight(p: Params, name: str) -> torch.Tensor:
    """The (k * C_in, C_out) matrix of a conv weight (C_out, C_in, k), tap-major."""
    w = p[name + ".affine.weight"]
    return w.permute(2, 1, 0).reshape(-1, w.shape[0])


def layer_eval(x, p: Params, name: str, offsets, prec: str):
    """One relu-batchnorm-layer in eval mode; returns (output, affine)."""
    affine = mm(_splice(x, offsets), _weight(p, name), prec) + p[name + ".affine.bias"].to(
        torch.float64 if prec == "ref" else torch.float32)
    h = torch.relu(affine)
    rm, rv = p[name + ".batchnorm.running_mean"], p[name + ".batchnorm.running_var"]
    scale = p[name + ".batchnorm.weight"]
    h = (h - rm.to(h.dtype)) * (scale.to(h.dtype) / torch.sqrt(rv.to(h.dtype) + EPS_BN))
    return h, affine


def stack_eval(x, p: Params, stack: Mapping, prec: str):
    for i, (_, offs) in enumerate(stack["layers"]):
        x, _ = layer_eval(x, p, f"{stack['prefix']}.tdnn{i + stack.get('first', 1)}", offs, prec)
    return x


def pool(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-2)
    var = ((x - mean.unsqueeze(-2)) ** 2).mean(-2)
    return torch.cat([mean, torch.sqrt(torch.clamp(var, min=VAR_FLOOR))], dim=-1)


def head_embed(h: torch.Tensor, p: Params, prec: str) -> torch.Tensor:
    """embedding_a of one chunk from the frame-level output stats pooling
    reads, (T', C): tdnn6's affine on the pooled statistics."""
    _, emb = layer_eval(pool(h)[None, :], p, "segment.tdnn6", [0], prec)
    return emb[0]


# ------------------------------------------------------------------ training


def layer_train(x, p: Params, name: str, offsets, prec: str):
    """Train mode: the affine in the training precision, ReLU, batch norm
    over (batch, time) with the biased variance, in float32."""
    w = _weight(p, name)
    b = p[name + ".affine.bias"]
    if prec in ("bf16", "fp8"):
        b = b + (round_bf16(b) - b).detach()
    h = torch.relu(mm_grad(_splice(x, offsets), w, prec) + b)
    if prec in ("bf16", "fp8"):
        h = h + (round_bf16(h) - h).detach()
    h = h.to(torch.float32) if prec != "ref" else h
    dims = tuple(range(h.dim() - 1))
    mean = h.mean(dims)
    var = torch.clamp((h * h).mean(dims) - mean * mean, min=0.0)
    return (h - mean) * (torch.rsqrt(var + EPS_BN) * p[name + ".batchnorm.weight"])


def stack_train(x, p: Params, stack: Mapping, prec: str):
    for i, (_, offs) in enumerate(stack["layers"]):
        x = layer_train(x, p, f"{stack['prefix']}.tdnn{i + stack.get('first', 1)}", offs, prec)
    return x


def linear(x, p: Params, name: str) -> torch.Tensor:
    """An output layer, float32 in every precision (it has no compute dtype)."""
    return x @ p[name + ".weight"].t() + p[name + ".bias"]


def append(streams) -> torch.Tensor:
    """xconfig Append over (x (..., T, C), (left, right)) streams: each
    cropped to the largest context on each side, then concatenated."""
    left = max(c[0] for _, c in streams)
    right = max(c[1] for _, c in streams)
    out = []
    for x, (l, r) in streams:
        t = x.shape[-2]
        out.append(x[..., left - l:t - (right - r), :])
    return torch.cat(out, dim=-1)


def head_train(h: torch.Tensor, p: Params, prec: str) -> torch.Tensor:
    """Speaker logits (B, speakers) from a batch's frame-level output
    (B, T', C): stats pooling, tdnn6, tdnn7, the output layer."""
    pooled = pool(h)
    h = layer_train(pooled[:, None, :], p, "segment.tdnn6", [0], prec)
    h = layer_train(h, p, "segment.tdnn7", [0], prec)
    return linear(h[:, 0, :], p, "segment.output")


def layer_names(out: Dict, name: str, in_dim: int, dim: int, k: int) -> None:
    """A relu-batchnorm-layer's parameters and batch-norm buffers, with
    their shapes, into ``out``."""
    out[name + ".affine.weight"] = (dim, in_dim, k)
    out[name + ".affine.bias"] = (dim,)
    out[name + ".batchnorm.weight"] = (dim,)
    for buf in ("running_mean", "running_var"):
        out[f"{name}.batchnorm.{buf}"] = (dim,)


def stack_names(out: Dict, st: Mapping, in_dim: int) -> int:
    """A stack's layers into ``out``; returns its output dim."""
    for i, (dim, offs) in enumerate(st["layers"]):
        layer_names(out, f"{st['prefix']}.tdnn{i + st.get('first', 1)}", in_dim, dim, len(offs))
        in_dim = dim
    return in_dim


def head_names(out: Dict, pooled: int, cfg: Mapping) -> None:
    """The segment head's layers (tdnn6, tdnn7, the output layer) into ``out``."""
    layer_names(out, "segment.tdnn6", pooled, cfg["embed_dim"], 1)
    layer_names(out, "segment.tdnn7", cfg["embed_dim"], cfg["embed_dim"], 1)
    if cfg["num_speakers"]:
        out["segment.output.weight"] = (cfg["num_speakers"], cfg["embed_dim"])
        out["segment.output.bias"] = (cfg["num_speakers"],)


def starts_at_one(name: str) -> bool:
    """The tensors a fresh TDNN holds at 1: batch-norm scales and variances."""
    return name.endswith("batchnorm.weight") or name.endswith("running_var")


# buffers of the port's TDNN modules that no configuration names
PROGRAM_ONLY = (".batchnorm.bias", ".num_batches_tracked")
