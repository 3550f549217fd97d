"""Batched banded Viterbi: the hand-written Hopper kernel, its wrapper, its plain twin.

Replaces the Pallas TPU kernel `sepi_tpu/align/viterbi_pallas.py:viterbi_batch`
(kernel body `_make_kernel`).  `viterbi_batch` runs forced alignment over
a batch of linear alignment graphs, whose every state has the
predecessors stay (s), advance (s-1) and skip (s-skip):

    (emit (B, T, S) f32, t_len (B,) i32, trans (B, 3, S) f32)
        -> (bps (B, T-1, S) int8, delta (B, S) f32)

- On a CUDA tensor the wrapper launches `csrc/viterbi.cu` (built with nvcc
  at first use, `sepi_tpu_torch/build.py`) and counts the launch in
  ``viterbi_batch.launches``.  A failed build or launch raises.
- On a CPU tensor it runs `viterbi_batch_reference`, the plain PyTorch
  version of the same function, which the tests hold against the JAX
  kernel run in interpret mode and against its scan reference.

Ties go to the first maximum in the order stay, advance, skip (the TPU
kernel's `where` chain, and `jnp.argmax` in its reference).  The TPU
wrapper's lane padding and time blocking are layout concerns of that
chip and have no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from ..graphs import count_launch

_NEG = -1e30
MAX_STATES = 8192  # the kernel's 1024 threads x 8 states each


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[:, s - k] with -1e30 where s - k < 0 (no wrap-around)."""
    out = torch.full_like(x, _NEG)
    if k < x.shape[1]:
        out[:, k:] = x[:, : x.shape[1] - k]
    return out


def viterbi_batch_reference(state_emit: torch.Tensor, t_len: torch.Tensor,
                            trans: torch.Tensor, skip: int = 4):
    """Plain PyTorch version of the batched Viterbi, on any device."""
    b, t, s = state_emit.shape
    dev = state_emit.device
    delta = torch.full((b, s), _NEG, dtype=torch.float32, device=dev)
    delta[:, 0] = state_emit[:, 0, 0]
    bps = torch.zeros((b, max(t - 1, 0), s), dtype=torch.int8, device=dev)
    t_len = t_len.to(device=dev, dtype=torch.int64)
    zero = torch.zeros((), dtype=torch.int8, device=dev)
    one, two = zero + 1, zero + 2
    for tt in range(1, t):
        c0 = delta + trans[:, 0]
        c1 = _shift(delta, 1) + trans[:, 1]
        c2 = _shift(delta, skip) + trans[:, 2]
        m12 = torch.maximum(c1, c2)
        best = torch.maximum(torch.maximum(c0, c1), c2)
        bp = torch.where(c0 >= m12, zero, torch.where(c1 >= c2, one, two))
        keep = (tt < t_len)[:, None]
        delta = torch.where(keep, best + state_emit[:, tt], delta)
        bps[:, tt - 1] = torch.where(keep, bp, zero)
    return bps, delta


def _launch(state_emit, t_len, trans, skip, bps, delta) -> None:
    from ..build import load

    fn = load("viterbi").sepi_viterbi_batch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    b, t, s = state_emit.shape
    err = fn(state_emit.data_ptr(), t_len.data_ptr(), trans.data_ptr(), bps.data_ptr(),
             delta.data_ptr(), b, t, s, skip,
             torch.cuda.current_stream(state_emit.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"viterbi kernel launch failed: CUDA error {err}")


def viterbi_batch(state_emit: torch.Tensor, t_len: torch.Tensor, trans: torch.Tensor,
                  skip: int = 4):
    """Batched banded Viterbi -> (bps (B, T-1, S) int8, final delta (B, S)).

    CUDA tensors run the kernel; CPU tensors run `viterbi_batch_reference`."""
    dev = state_emit.device
    if dev.type == "cpu":
        return viterbi_batch_reference(state_emit, t_len, trans, skip)
    if dev.type != "cuda":
        raise ValueError(f"viterbi_batch: unsupported device {dev}")
    if state_emit.ndim != 3:
        raise ValueError("viterbi_batch: state_emit must be (B, T, S)")
    b, t, s = state_emit.shape
    for name, x, dtype, shape in (("state_emit", state_emit, torch.float32, (b, t, s)),
                                  ("t_len", t_len, torch.int32, (b,)),
                                  ("trans", trans, torch.float32, (b, 3, s))):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"viterbi_batch: {name} must be a {dtype} tensor of shape "
                             f"{shape} on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"viterbi_batch: {name} must be contiguous")
    if b == 0 or t == 0 or not 0 < s <= MAX_STATES or skip <= 0:
        raise ValueError(f"viterbi_batch: shape {(b, t, s)} (at most {MAX_STATES} states) "
                         f"or skip {skip} out of range")
    bps = torch.empty((b, t - 1, s), dtype=torch.int8, device=dev)
    delta = torch.empty((b, s), dtype=torch.float32, device=dev)
    _launch(state_emit, t_len, trans, skip, bps, delta)
    count_launch(viterbi_batch)
    return bps, delta


viterbi_batch.launches = 0
