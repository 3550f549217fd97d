"""Sliding-window cepstral mean (and variance) normalization.

Port of `sepi_tpu/ops/cmvn.py:sliding_cmvn` (Kaldi `apply-cmvn-sliding
--norm-vars=false --center=true --cmn-window=300`).  With --center,
frame t's window is [t - w/2, t - w/2 + w), shifted to stay inside
[0, T); the window is always min(w, T) frames.

Interior frames read a static shift of the exclusive prefix sum; the
edge regimes read one constant row per utterance (start pinned to 0 on
the left, to n - win on the right).  The prefix sum is edge-replicated
past T so an interior read beyond the total saturates at it, and an
utterance with n <= window routes every frame to the left-edge row, as
the reference does.  The prefix sum is `torch.cumsum` in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import CmvnConfig


def _row_at(c: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """c: (B, T+1, D), idx: (B,) -> (B, D): one row per utterance."""
    d = c.shape[-1]
    return torch.gather(c, 1, idx.to(torch.int64)[:, None, None].expand(-1, 1, d))[:, 0]


def sliding_cmvn(feats: torch.Tensor, frame_mask: torch.Tensor,
                 cfg: CmvnConfig = CmvnConfig()) -> torch.Tensor:
    """(B, T, D) or (T, D) features + (B, T) mask -> normalized features,
    zero on padding."""
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
