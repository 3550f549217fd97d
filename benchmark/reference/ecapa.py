"""Plain reference of ECAPA-TDNN (Desplanques, Thienpondt and Demuynck,
Interspeech 2020, arXiv:2005.07143, §2-3 and Fig. 2): one utterance's
embedding, in float64, straight from the equations.

One utterance (T, feat_dim) at a time, with no batch and no mask: the
utterance's own frames are all there is, and every convolution pads its
ends with zeros to keep T frames.  "CRB" is a convolution, ReLU, then
batch norm in eval mode (running statistics, a scale, no offset, eps
1e-5).
- stem: CRB, kernel ``stem_kernel``;
- three SE-Res2Blocks, one per dilation: CRB k = 1; the channels split
  into ``scale`` groups, y1 = x1, y2 = K2(x2), yi = Ki(xi + y(i-1)) with
  each Ki a CRB of kernel ``kernel`` and the block's dilation; CRB k = 1;
  SE: s = sigmoid(W2 ReLU(W1 mean_t(h) + b1) + b2), h * s; plus the
  block's input.  A block's input is the sum of the stem's output and of
  every earlier block's;
- MFA: the blocks' outputs concatenated, a k = 1 convolution, ReLU;
- attentive statistics pooling: mu and sigma of h over time,
  H_t = [h_t; mu; sigma], e = W2 tanh(BN(ReLU(W1 H_t + b1))) + b2,
  alpha = softmax over time per channel, mu~ = sum alpha h,
  sigma~ = sqrt(max(sum alpha h^2 - mu~^2, 1e-12));
- head: BN, the affine to ``embed_dim``, BN: the embedding.

Every convolution is the frames unfolded at its taps times the weight
through `precision.mm`, and so is every affine, so the same code is the
control when asked for a lower precision; TF32 is off while it runs.
The weights are read by the names `param_names` gives, which are the
configuration's (`benchmark/models/ecapa.py`); this file imports nothing
of the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Tuple

import torch

from .precision import mm

EPS_BN = 1e-5
VAR_FLOOR = 1e-12

Params = Mapping[str, torch.Tensor]


@contextlib.contextmanager
def tf32_off():
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    keep = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = keep


def _dtype(prec: str) -> torch.dtype:
    return torch.float64 if prec == "ref" else torch.float32


def conv(x: torch.Tensor, p: Params, name: str, dilation: int, prec: str) -> torch.Tensor:
    """(T, C_in) -> (T, C_out): a zero-padded "same" convolution of the
    weight (C_out, C_in, k) and bias under ``name``."""
    w = p[name + ".weight"]
    c_out, c_in, k = w.shape
    span = dilation * (k - 1)
    xp = torch.nn.functional.pad(x, (0, 0, span // 2, span - span // 2))
    taps = xp.unfold(0, span + 1, 1)[:, :, ::dilation]  # (T, C_in, k)
    y = mm(taps.reshape(x.shape[0], c_in * k), w.reshape(c_out, c_in * k).t(), prec)
    return y + p[name + ".bias"].to(y.dtype)


def affine(x: torch.Tensor, p: Params, name: str, prec: str) -> torch.Tensor:
    """(..., C_in) -> (..., C_out) of a Linear weight (C_out, C_in)."""
    y = mm(x, p[name + ".weight"].t(), prec)
    return y + p[name + ".bias"].to(y.dtype)


def batchnorm(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    rm, rv, scale = (p[f"{name}.{k}"].to(x.dtype) for k in ("running_mean", "running_var",
                                                               "weight"))
    return (x - rm) * (scale / torch.sqrt(rv + EPS_BN))


def crb(x, p: Params, name: str, dilation: int, prec: str) -> torch.Tensor:
    return batchnorm(torch.relu(conv(x, p, name + ".conv", dilation, prec)), p, name + ".bn")


def block(x, p: Params, name: str, dilation: int, cfg: Mapping, prec: str) -> torch.Tensor:
    groups = crb(x, p, name + ".conv1", 1, prec).chunk(cfg["scale"], dim=1)
    ys = [groups[0]]
    for i in range(1, cfg["scale"]):
        z = groups[i] if i == 1 else groups[i] + ys[-1]
        ys.append(crb(z, p, f"{name}.res2.{i - 1}", dilation, prec))
    h = crb(torch.cat(ys, dim=1), p, name + ".conv2", 1, prec)
    s = torch.sigmoid(affine(torch.relu(affine(h.mean(0), p, name + ".se_squeeze", prec)), p,
                             name + ".se_excite", prec))
    return h * s + x


def pool(h: torch.Tensor, p: Params, prec: str) -> torch.Tensor:
    """(T, C) -> (2C,): attentive statistics pooling."""
    mu = h.mean(0)
    sigma = torch.sqrt(torch.clamp((h * h).mean(0) - mu * mu, min=VAR_FLOOR))
    ctx = torch.cat([h, mu.expand_as(h), sigma.expand_as(h)], dim=1)
    hidden = batchnorm(torch.relu(conv(ctx, p, "pool.attn1", 1, prec)), p, "pool.attn_bn")
    e = conv(torch.tanh(hidden), p, "pool.attn2", 1, prec)
    alpha = torch.softmax(e, dim=0)
    mean = (alpha * h).sum(0)
    var = (alpha * h * h).sum(0) - mean * mean
    return torch.cat([mean, torch.sqrt(torch.clamp(var, min=VAR_FLOOR))])


def embed(feats: torch.Tensor, p: Params, cfg: Mapping, prec: str = "ref") -> torch.Tensor:
    """The embedding (embed_dim,) of one chunk of features (T, feat_dim)."""
    with tf32_off():
        x = crb(feats.to(_dtype(prec)), p, "stem", 1, prec)
        total, outs = x, []
        for i, d in enumerate(cfg["dilations"]):
            outs.append(block(total, p, f"blocks.{i}", d, cfg, prec))
            total = total + outs[-1]
        h = torch.relu(conv(torch.cat(outs, dim=1), p, "mfa", 1, prec))
        pooled = batchnorm(pool(h, p, prec), p, "pool_bn")
        return batchnorm(affine(pooled, p, "fc", prec), p, "embed_bn")


# ------------------------------------------------------------------- names


def _crb_names(out: Dict, name: str, c_in: int, c_out: int, k: int) -> None:
    out[name + ".conv.weight"] = (c_out, c_in, k)
    out[name + ".conv.bias"] = (c_out,)
    _bn_names(out, name + ".bn", c_out)


def _bn_names(out: Dict, name: str, c: int) -> None:
    for k in ("weight", "running_mean", "running_var"):
        out[f"{name}.{k}"] = (c,)


def _linear_names(out: Dict, name: str, c_in: int, c_out: int, k: Tuple = ()) -> None:
    out[name + ".weight"] = (c_out, c_in) + k
    out[name + ".bias"] = (c_out,)


def param_names(cfg: Mapping) -> Dict[str, Tuple[int, ...]]:
    """Every tensor of the configuration, with its shape, the AAM-softmax
    weight (``aam.weight``) among them."""
    c, width, nb = cfg["channels"], cfg["channels"] // cfg["scale"], len(cfg["dilations"])
    m, a, se = cfg["mfa_channels"], cfg["attention_bottleneck"], cfg["se_bottleneck"]
    out: Dict[str, Tuple[int, ...]] = {}
    _crb_names(out, "stem", cfg["feat_dim"], c, cfg["stem_kernel"])
    for i in range(nb):
        name = f"blocks.{i}"
        _crb_names(out, name + ".conv1", c, c, 1)
        for j in range(cfg["scale"] - 1):
            _crb_names(out, f"{name}.res2.{j}", width, width, cfg["kernel"])
        _crb_names(out, name + ".conv2", c, c, 1)
        _linear_names(out, name + ".se_squeeze", c, se)
        _linear_names(out, name + ".se_excite", se, c)
    _linear_names(out, "mfa", nb * c, m, (1,))
    _linear_names(out, "pool.attn1", 3 * m, a, (1,))
    _bn_names(out, "pool.attn_bn", a)
    _linear_names(out, "pool.attn2", a, m, (1,))
    _bn_names(out, "pool_bn", 2 * m)
    _linear_names(out, "fc", 2 * m, cfg["embed_dim"])
    _bn_names(out, "embed_bn", cfg["embed_dim"])
    out["aam.weight"] = (cfg["num_speakers"], cfg["embed_dim"])
    return out


def starts_at_one(name: str) -> bool:
    """The tensors a fresh model holds at 1: batch-norm scales and variances."""
    return name.endswith("bn.weight") or name.endswith("running_var")


# buffers of the program's batch norms that no configuration names: the
# offset it holds at 0 and its step count
PROGRAM_ONLY = ("bn.bias", ".num_batches_tracked")
