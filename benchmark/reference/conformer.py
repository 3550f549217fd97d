"""Plain reference of the MFA-Conformer (Zhang et al., Interspeech 2022,
arXiv:2203.15249), the 6-block system with 1/2 subsampling: one
utterance's embedding, in float64, straight from the equations.

One utterance (T, feat_dim) at a time, with no batch and no mask.
- input map: the cepstra back to log-mel energies, c / lifter times the
  inverse of the frontend's DCT table (`frontend.dct_matrix`, `lifter`);
- subsampling (wenet's Conv2dSubsampling2): a 3 x 3 convolution of
  stride 2 from one map to d over (time, bins), ReLU, a 3 x 3
  convolution of stride 1, ReLU, neither padded; each frame's d x F'
  values (channel-major) through an affine to d, times sqrt(d);
- relative positions (ESPnet's RelPositionalEncoding): 2T' - 1 rows, row
  r for position P = T' - 1 - r, [sin(P w_k), cos(P w_k)] interleaved,
  w_k = 10000^(-2k / d);
- each block: x += FF1(LN x) / 2; x += MHSA(LN x); x += Conv(LN x);
  x += FF2(LN x) / 2; x = LN x.  FF: affine to ff_dim, Swish, affine to
  d.  MHSA, per head of dk = d / heads: q, k, v from one affine (rows
  q, then k, then v, each head's dk in turn), p = W_pos pe (no bias),
  score[i, j] = ((q_i + u) . k_j + (q_i + v) . p[T' - 1 - i + j]) /
  sqrt(dk), softmax over j, then the affine out.  Conv: affine to 2d,
  GLU (the first half times the sigmoid of the second), depthwise
  convolution of ``conv_kernel`` taps with zero "same" padding, batch
  norm, Swish, affine to d;
- MFA: the blocks' outputs concatenated, LayerNorm;
- attentive statistics pooling and the BN -> affine -> BN head:
  `reference.ecapa`'s ``pool``, ``batchnorm`` and ``affine``.
LayerNorm: biased variance, eps 1e-5, a scale and an offset.  Batch norm:
eval mode, running statistics, a scale and no offset, eps 1e-5.

Departures from the papers, each also in the configuration's
``assumed``: the input is the frontend's cepstra mapped back to log-mel
(the papers feed 80 filterbank energies; with C0 the raw log energy, as
the harness's frontend computes it, the first row of the map reads the
energy's mean-removed deviation and adds it evenly to every bin);
the relative shift is ESPnet's (wenet's RelPositionMultiHeadedAttention
drops it); the batch norm has no learnt offset; the head is BN -> affine
-> BN as in ECAPA-TDNN.

Every product (the input map, the convolutions unfolded at their taps,
the affines, the three attention products, the depthwise taps) goes
through `precision.mm`, so the same code is the control when asked for a
lower precision; TF32 is off while it runs.  The weights are read by the
names `param_names` gives, which are the configuration's
(`benchmark/models/mfa_conformer.py`); this file imports nothing of the
program.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .ecapa import _bn_names, _dtype, _linear_names, affine, batchnorm, pool, tf32_off
from .frontend import dct_matrix, lifter
from .precision import mm

EPS_LN = 1e-5

Params = Mapping[str, torch.Tensor]


def subsampled(n: int) -> int:
    """Frames or bins after the subsampler's two unpadded convolutions
    (3 x 3 of stride 2, then 3 x 3 of stride 1): (n - 1) // 2 - 2."""
    return (n - 1) // 2 - 2


def sub_bins(cfg: Mapping) -> int:
    return subsampled(cfg["feat_dim"])


def input_map(cfg: Mapping, device) -> torch.Tensor:
    n = cfg["feat_dim"]
    inv = np.linalg.inv(dct_matrix(n, n)) / lifter(n, cfg["frontend"]["cepstral_lifter"])[:, None]
    return torch.from_numpy(inv).to(device)


def layernorm(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + EPS_LN) * p[name + ".weight"].to(x.dtype) \
        + p[name + ".bias"].to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def subsample(x: torch.Tensor, p: Params, cfg: Mapping, prec: str) -> torch.Tensor:
    """(T, F) -> (T', d)."""
    d = cfg["d_model"]
    w1, w2 = p["subsample.conv1.weight"], p["subsample.conv2.weight"]
    taps = x.unfold(0, 3, 2).unfold(1, 3, 2)  # (T1, F1, 3, 3)
    t1, f1 = taps.shape[:2]
    h = mm(taps.reshape(t1 * f1, 9), w1.reshape(d, 9).t(), prec)
    h = torch.relu(h + p["subsample.conv1.bias"].to(h.dtype)).reshape(t1, f1, d)
    taps = h.unfold(0, 3, 1).unfold(1, 3, 1)  # (T', F', d, 3, 3)
    t2, f2 = taps.shape[:2]
    h = mm(taps.reshape(t2 * f2, d * 9), w2.reshape(d, d * 9).t(), prec)
    h = torch.relu(h + p["subsample.conv2.bias"].to(h.dtype)).reshape(t2, f2, d)
    flat = h.permute(0, 2, 1).reshape(t2, d * f2)  # channel-major, as wenet flattens
    return affine(flat, p, "subsample.out", prec) * math.sqrt(d)


def positions(t: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(t - 1, -t, -1, dtype=torch.float64, device=device)
    w = 10000.0 ** (-torch.arange(0, d, 2, dtype=torch.float64, device=device) / d)
    ang = pos[:, None] * w[None, :]
    pe = torch.empty((2 * t - 1, d), dtype=torch.float64, device=device)
    pe[:, 0::2], pe[:, 1::2] = torch.sin(ang), torch.cos(ang)
    return pe


def mhsa(x: torch.Tensor, pe: torch.Tensor, p: Params, name: str, cfg: Mapping,
         prec: str) -> torch.Tensor:
    t, d = x.shape
    h = cfg["num_heads"]
    dk = d // h
    qkv = affine(x, p, name + ".qkv", prec)
    pos = mm(pe, p[name + ".linear_pos.weight"].t(), prec)  # (2T' - 1, d)
    i = torch.arange(t, device=x.device)
    shift = (t - 1 - i)[:, None] + i[None, :]  # score[i, j] reads bd[i, T' - 1 - i + j]
    heads = []
    for n in range(h):
        cols = slice(n * dk, (n + 1) * dk)
        q, k, v = qkv[:, cols], qkv[:, d:][:, cols], qkv[:, 2 * d:][:, cols]
        u, vb = (p[f"{name}.pos_bias_{s}"][n].to(q.dtype) for s in ("u", "v"))
        ac = mm(q + u, k.t(), prec)
        bd = mm(q + vb, pos[:, cols].t(), prec)  # (T', 2T' - 1)
        scores = (ac + torch.gather(bd, 1, shift)) / math.sqrt(dk)
        heads.append(mm(torch.softmax(scores, dim=-1), v, prec))
    return affine(torch.cat(heads, dim=1), p, name + ".linear_out", prec)


def conv_module(x: torch.Tensor, p: Params, name: str, cfg: Mapping, prec: str) -> torch.Tensor:
    d, k = cfg["d_model"], cfg["conv_kernel"]
    g = affine(x, p, name + ".pointwise1", prec)
    g = g[:, :d] * torch.sigmoid(g[:, d:])
    gp = torch.nn.functional.pad(g, (0, 0, (k - 1) // 2, (k - 1) // 2))
    taps = gp.unfold(0, k, 1)  # (T', d, k)
    w = p[name + ".depthwise.weight"].reshape(d, k, 1)
    y = mm(taps.permute(1, 0, 2), w, prec)[..., 0].t()  # (T', d)
    y = batchnorm(y + p[name + ".depthwise.bias"].to(y.dtype), p, name + ".bn")
    return affine(swish(y), p, name + ".pointwise2", prec)


def ffn(x: torch.Tensor, p: Params, name: str, prec: str) -> torch.Tensor:
    return affine(swish(affine(x, p, name + ".w1", prec)), p, name + ".w2", prec)


def block(x: torch.Tensor, pe: torch.Tensor, p: Params, name: str, cfg: Mapping,
          prec: str) -> torch.Tensor:
    x = x + 0.5 * ffn(layernorm(x, p, name + ".norm_ff1"), p, name + ".ff1", prec)
    x = x + mhsa(layernorm(x, p, name + ".norm_mhsa"), pe, p, name + ".mhsa", cfg, prec)
    x = x + conv_module(layernorm(x, p, name + ".norm_conv"), p, name + ".conv", cfg, prec)
    x = x + 0.5 * ffn(layernorm(x, p, name + ".norm_ff2"), p, name + ".ff2", prec)
    return layernorm(x, p, name + ".norm_final")


def embed(feats: torch.Tensor, p: Params, cfg: Mapping, prec: str = "ref") -> torch.Tensor:
    """The embedding (embed_dim,) of one chunk of features (T, feat_dim), T >= 7."""
    with tf32_off():
        x = mm(feats.to(_dtype(prec)), input_map(cfg, feats.device), prec)
        x = subsample(x, p, cfg, prec)
        pe = positions(x.shape[0], cfg["d_model"], x.device).to(x.dtype)
        outs = []
        for i in range(cfg["num_blocks"]):
            x = block(x, pe, p, f"blocks.{i}", cfg, prec)
            outs.append(x)
        h = layernorm(torch.cat(outs, dim=1), p, "mfa_norm")
        pooled = batchnorm(pool(h, p, prec), p, "pool_bn")
        return batchnorm(affine(pooled, p, "fc", prec), p, "embed_bn")


# ------------------------------------------------------------------- names


def param_names(cfg: Mapping) -> Dict[str, Tuple[int, ...]]:
    """Every tensor of the configuration, with its shape, the AAM-softmax
    weight (``aam.weight``) among them."""
    d, h, ff, k = cfg["d_model"], cfg["num_heads"], cfg["ff_dim"], cfg["conv_kernel"]
    m, a = cfg["num_blocks"] * d, cfg["attention_bottleneck"]
    out: Dict[str, Tuple[int, ...]] = {}
    _linear_names(out, "subsample.conv1", 1, d, (3, 3))
    _linear_names(out, "subsample.conv2", d, d, (3, 3))
    _linear_names(out, "subsample.out", d * sub_bins(cfg), d)
    for i in range(cfg["num_blocks"]):
        name = f"blocks.{i}"
        for ln in ("norm_ff1", "norm_mhsa", "norm_conv", "norm_ff2", "norm_final"):
            _ln_names(out, f"{name}.{ln}", d)
        for f in ("ff1", "ff2"):
            _linear_names(out, f"{name}.{f}.w1", d, ff)
            _linear_names(out, f"{name}.{f}.w2", ff, d)
        _linear_names(out, name + ".mhsa.qkv", d, 3 * d)
        out[name + ".mhsa.linear_pos.weight"] = (d, d)
        out[name + ".mhsa.pos_bias_u"] = (h, d // h)
        out[name + ".mhsa.pos_bias_v"] = (h, d // h)
        _linear_names(out, name + ".mhsa.linear_out", d, d)
        _linear_names(out, name + ".conv.pointwise1", d, 2 * d)
        out[name + ".conv.depthwise.weight"] = (d, 1, k)
        out[name + ".conv.depthwise.bias"] = (d,)
        _bn_names(out, name + ".conv.bn", d)
        _linear_names(out, name + ".conv.pointwise2", d, d)
    _ln_names(out, "mfa_norm", m)
    _linear_names(out, "pool.attn1", 3 * m, a, (1,))
    _bn_names(out, "pool.attn_bn", a)
    _linear_names(out, "pool.attn2", a, m, (1,))
    _bn_names(out, "pool_bn", 2 * m)
    _linear_names(out, "fc", 2 * m, cfg["embed_dim"])
    _bn_names(out, "embed_bn", cfg["embed_dim"])
    out["aam.weight"] = (cfg["num_speakers"], cfg["embed_dim"])
    return out


def _ln_names(out: Dict, name: str, c: int) -> None:
    out[name + ".weight"] = (c,)
    out[name + ".bias"] = (c,)


def starts_at_one(name: str) -> bool:
    """The tensors a fresh model holds at 1: batch-norm and layer-norm
    scales, batch-norm variances."""
    last = name.rsplit(".", 2)
    return name.endswith("running_var") or (
        last[-1] == "weight" and (last[-2].endswith("bn") or last[-2].startswith("norm")
                                  or last[-2] == "mfa_norm"))


# buffers of the program's batch norms that no configuration names: the
# offset it holds at 0 and its step count
PROGRAM_ONLY = ("bn.bias", ".num_batches_tracked")
