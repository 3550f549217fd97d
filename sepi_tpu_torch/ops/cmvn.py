"""Sliding-window cepstral mean (and variance) normalization.

Port of `sepi_tpu/ops/cmvn.py:sliding_cmvn` (Kaldi `apply-cmvn-sliding
--norm-vars=false --center=true --cmn-window=300`).  With --center,
frame t's window is [t - w/2, t - w/2 + w), shifted to stay inside
[0, T); the window is always min(w, T) frames.

- On a CUDA tensor `sliding_cmvn` launches `csrc/cmvn.cu` (built with nvcc
  at first use, `sepi_tpu_torch/build.py`): three kernels, each parallel
  over (utterance, frame tile, column): per-tile column sums, their
  exclusive scan in double with the edge rows, then the normalized frames
  from two window scans in shared memory.  The source says why bytes bound
  it and how the design meets that.  It replaces no TPU kernel: the JAX
  function is plain jnp.  Each call counts one in ``sliding_cmvn.launches``
  (`graphs.count_launch`: a call recorded into a CUDA graph counts on every
  replay).  It takes float32 features and a bool mask; anything else, or a
  failed build or launch, raises.
- On a CPU tensor it runs `sliding_cmvn_reference`, the plain version,
  which the tests hold against the JAX function.

The plain version: interior frames read a static shift of the exclusive
prefix sum; the edge regimes read one constant row per utterance (start
pinned to 0 on the left, to n - win on the right).  The prefix sum is
edge-replicated past T so an interior read beyond the total saturates at
it, and an utterance with n <= window routes every frame to the left-edge
row, as the reference does.  The prefix sum is `torch.cumsum` in float32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..config import CmvnConfig
from ..graphs import count_launch

TILE = 32  # frames of one tile prefix (csrc/cmvn.cu kTile)


def _row_at(c: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """c: (B, T+1, D), idx: (B,) -> (B, D): one row per utterance."""
    d = c.shape[-1]
    return torch.gather(c, 1, idx.to(torch.int64)[:, None, None].expand(-1, 1, d))[:, 0]


def sliding_cmvn_reference(feats: torch.Tensor, frame_mask: torch.Tensor,
                           cfg: CmvnConfig = CmvnConfig()) -> torch.Tensor:
    """Plain PyTorch version of `sliding_cmvn`, on any device."""
    squeeze = feats.ndim == 2
    if squeeze:
        feats, frame_mask = feats[None], frame_mask[None]
    b, t, d = feats.shape
    w = cfg.window
    half = w // 2
    mask_f = frame_mask.to(feats.dtype)
    x = feats * mask_f[..., None]
    n = mask_f.sum(1).to(torch.int64)  # (B,) valid frames
    win = torch.clamp(n, min=1).clamp(max=w)  # (B,) effective window
    winf = win.to(x.dtype)[:, None]

    def stats_for(c):
        # c: (B, T+1, D) exclusive prefix sums of some quantity
        if cfg.center:
            # edge-replicated pad: reads past T saturate at the total
            cp = torch.cat([c[:, :1].expand(-1, half, -1), c,
                            c[:, -1:].expand(-1, w, -1)], dim=1)
            interior = cp[:, w:w + t] - cp[:, 0:t]
        else:
            cp = F.pad(c, (0, 0, w, 0))
            interior = cp[:, w + 1:w + t + 1] - cp[:, 1:t + 1]
        left = _row_at(c, win)
        right = _row_at(c, n) - _row_at(c, torch.clamp(n - win, min=0))
        return interior, left, right

    tt = torch.arange(t, device=feats.device)[None, :]
    start = tt - half if cfg.center else tt - w + 1
    lo_edge = (start < 0) | (win >= n)[:, None]
    hi_edge = start > (n[:, None] - win[:, None])

    def select(int_s, left_s, right_s):
        return torch.where(
            lo_edge[..., None], left_s[:, None, :],
            torch.where(hi_edge[..., None], right_s[:, None, :], int_s))

    zeros = torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
    csum = torch.cat([zeros, torch.cumsum(x, dim=1)], dim=1)
    mean = select(*stats_for(csum)) / winf[..., None]
    out = feats - mean
    if cfg.normalize_variance:
        csum2 = torch.cat([zeros, torch.cumsum(x * x, dim=1)], dim=1)
        var = torch.clamp(select(*stats_for(csum2)) / winf[..., None] - mean * mean,
                          min=1e-10)
        out = out * torch.rsqrt(var)
    out = out * mask_f[..., None]
    return out[0] if squeeze else out


def _launch(feats, mask, out, tp, cnt, edges, cfg: CmvnConfig) -> None:
    from ..build import load

    fn = load("cmvn").sepi_sliding_cmvn
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    b, t, d = feats.shape
    nv = cfg.normalize_variance
    err = fn(feats.data_ptr(), mask.data_ptr(), out.data_ptr(), tp[0].data_ptr(),
             tp[1].data_ptr() if nv else None, cnt.data_ptr(), edges.data_ptr(),
             b, t, d, cfg.window, int(cfg.center), int(nv),
             torch.cuda.current_stream(feats.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sliding_cmvn kernel launch failed: CUDA error {err}")


def sliding_cmvn(feats: torch.Tensor, frame_mask: torch.Tensor,
                 cfg: CmvnConfig = CmvnConfig()) -> torch.Tensor:
    """(B, T, D) or (T, D) features + (B, T) or (T,) mask -> normalized
    features, zero on padding.  CUDA tensors run the kernel (float32
    features, bool mask); CPU tensors run `sliding_cmvn_reference`."""
    dev = feats.device
    if dev.type == "cpu":
        return sliding_cmvn_reference(feats, frame_mask, cfg)
    if dev.type != "cuda":
        raise ValueError(f"sliding_cmvn: unsupported device {dev}")
    squeeze = feats.ndim == 2
    if squeeze:
        feats, frame_mask = feats[None], frame_mask[None]
    if feats.dtype != torch.float32 or feats.ndim != 3:
        raise ValueError("sliding_cmvn: features must be a (B, T, D) or (T, D) float32 tensor")
    b, t, d = feats.shape
    if (frame_mask.dtype != torch.bool or tuple(frame_mask.shape) != (b, t)
            or frame_mask.device != dev):
        raise ValueError(f"sliding_cmvn: the mask must be a bool ({b}, {t}) tensor on {dev}")
    if cfg.window < 1:
        raise ValueError(f"sliding_cmvn: window {cfg.window} is below one frame")
    out = torch.empty((b, t, d), dtype=torch.float32, device=dev)
    if out.numel():
        ntiles = -(-t // TILE)
        tp = torch.empty((1 + cfg.normalize_variance, b, ntiles + 1, d), dtype=torch.float64,
                         device=dev)
        cnt = torch.empty((b, ntiles + 1), dtype=torch.int32, device=dev)
        edges = torch.empty((b, 4, d), dtype=torch.float32, device=dev)
        _launch(feats.contiguous(), frame_mask.contiguous().view(torch.uint8), out, tp, cnt,
                edges, cfg)
        count_launch(sliding_cmvn)
    return out[0] if squeeze else out


sliding_cmvn.launches = 0
