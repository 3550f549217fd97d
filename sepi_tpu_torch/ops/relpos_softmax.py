"""Relative-position attention scores: the hand-written Triton kernel, its
wrapper, its plain twin.

Replaces no TPU kernel: the JAX package has no attention.  Added for the
MFA-Conformer's self-attention (`models.conformer`), whose scores are
Transformer-XL's (Dai et al., ACL 2019, §3.3) as ESPnet's
``RelPositionMultiHeadedAttention`` computes them:

    score[i, j] = (ac[i, j] + bd[i, T - 1 - i + j]) * scale

with ``ac = (q + u) k^T`` over the keys and ``bd = (q + v) p^T`` over the
2T - 1 relative positions (row r of ``p`` the position T - 1 - r).
ESPnet's ``rel_shift`` shifts ``bd`` by padding, viewing and copying the
whole (B, H, T, 2T - 1) matrix.  Here a block of query rows i0 .. i0 + Q - 1
carries only the band of positions its rows read, Q + T - 1 columns, and
row il reads columns Q - 1 - il .. Q - 2 - il + T of it.  One pass per
score row gathers that band, adds the row of ``ac``, scales, puts the
floor on the keys at or past the batch row's length, and takes the
softmax; the probabilities are written over ``ac``.

- On a CUDA tensor `relpos_softmax` launches the kernel once (Triton,
  compiled at the first launch of each row width) and counts the launch
  in ``relpos_softmax.launches`` (`graphs.count_launch`).
- On a CPU tensor it runs `relpos_softmax_reference`: the same function
  as an index gather and `torch.softmax`.

Masked keys take float32's lowest finite value, not -inf: a row whose
every key is masked (a bucket's unused rows) stays finite, uniform.
Bound on this card: bytes.  Each score is one float of ``ac`` and one of
``bd`` read and one probability written, 12 bytes, against ~10 flops.
The design keeps the row in registers between the read and the write
(one pass, no max or sum written out) and reads ``bd`` straight from the
band, with no shifted copy.
"""

from __future__ import annotations

import os

import torch

from ..graphs import count_launch

FLOOR = float(torch.finfo(torch.float32).min)  # the score of a masked key

_KERNEL = None


def _relpos_softmax_kernel(ac_ptr, bd_ptr, lens_ptr, heads, rows, t, scale,
                           sa_b, sa_h, sa_q, sb_b, sb_h, sb_q, BLOCK: "tl.constexpr"):
    """One score row per program: program (b * heads + h) * rows + il."""
    pid = tl.program_id(0)
    il = pid % rows
    bh = pid // rows
    b = bh // heads
    h = bh % heads
    j = tl.arange(0, BLOCK)
    inside = j < t
    a_row = ac_ptr + b.to(tl.int64) * sa_b + h.to(tl.int64) * sa_h + il.to(tl.int64) * sa_q
    b_row = bd_ptr + b.to(tl.int64) * sb_b + h.to(tl.int64) * sb_h + il.to(tl.int64) * sb_q
    a = tl.load(a_row + j, mask=inside, other=0.0)
    d = tl.load(b_row + (rows - 1 - il) + j, mask=inside, other=0.0)
    s = (a + d) * scale
    n = tl.load(lens_ptr + b)
    s = tl.where(j < n, s, -3.4028234663852886e38)
    s = tl.where(inside, s, float("-inf"))
    e = tl.exp(s - tl.max(s, axis=0))
    tl.store(a_row + j, e / tl.sum(e, axis=0), mask=inside)


def _kernel():
    """The jitted kernel; Triton is imported at the first launch (this
    module imports where there is none), its cache kept under ``build/``
    at the repository root unless ``TRITON_CACHE_DIR`` says otherwise."""
    global _KERNEL
    if _KERNEL is None:
        from ..build import BUILD_DIR

        os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR.parent / "triton"))
        import triton
        import triton.language

        globals()["tl"] = triton.language
        _KERNEL = triton.jit(_relpos_softmax_kernel)
    return _KERNEL


def _warps(block: int) -> int:
    return 4 if block <= 1024 else 8 if block <= 4096 else 16


def relpos_softmax_reference(ac: torch.Tensor, bd: torch.Tensor, lengths: torch.Tensor,
                             scale: float) -> torch.Tensor:
    """(B, H, Q, T) ``ac``, (B, H, Q, Q + T - 1) ``bd``, (B,) key lengths ->
    (B, H, Q, T) probabilities: row il's scores read ``bd`` at columns
    Q - 1 - il + j."""
    b, h, q, t = ac.shape
    il = torch.arange(q, device=ac.device)
    j = torch.arange(t, device=ac.device)
    idx = ((q - 1 - il)[:, None] + j[None, :]).expand(b, h, q, t)
    s = (ac + bd.gather(-1, idx)) * scale
    masked = j[None, :] >= lengths.to(ac.device)[:, None]  # (B, T)
    return torch.softmax(s.masked_fill(masked[:, None, None, :], FLOOR), dim=-1)


def _check(ac: torch.Tensor, bd: torch.Tensor, lengths: torch.Tensor) -> None:
    b, h, q, t = ac.shape
    if ac.dtype != torch.float32 or bd.dtype != torch.float32:
        raise ValueError("relpos_softmax: ac and bd must be float32")
    if tuple(bd.shape) != (b, h, q, q + t - 1):
        raise ValueError(f"relpos_softmax: bd {tuple(bd.shape)} for ac {tuple(ac.shape)}: "
                         f"want {(b, h, q, q + t - 1)}")
    if ac.stride(-1) != 1 or bd.stride(-1) != 1:
        raise ValueError("relpos_softmax: the last dimension of ac and bd must be contiguous")
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"relpos_softmax: lengths must be ({b},) int32")
    if not (ac.device == bd.device == lengths.device):
        raise ValueError("relpos_softmax: ac, bd and lengths on different devices")


def relpos_softmax(ac: torch.Tensor, bd: torch.Tensor, lengths: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """The probabilities of `relpos_softmax_reference`.  On the card they
    are written over ``ac`` (which is returned); on the CPU into a new
    tensor.  ``lengths`` ((B,) int32): each batch row's valid keys, a
    prefix of the T."""
    _check(ac, bd, lengths)
    if ac.device.type == "cpu":
        return relpos_softmax_reference(ac, bd, lengths, scale)
    if ac.device.type != "cuda":
        raise ValueError(f"relpos_softmax: unsupported device {ac.device}")
    b, h, q, t = ac.shape
    if b * h * q == 0 or t == 0:
        return ac
    block = max(1 << (t - 1).bit_length(), 16)  # the row, a power of two
    _kernel()[(b * h * q,)](ac, bd, lengths, h, q, t, float(scale),
                            ac.stride(0), ac.stride(1), ac.stride(2),
                            bd.stride(0), bd.stride(1), bd.stride(2),
                            BLOCK=block, num_warps=_warps(block))
    count_launch(relpos_softmax)
    return ac


relpos_softmax.launches = 0
