"""Delta features and frame splicing (Kaldi `add-deltas`, `splice-feats`).

Port of `sepi_tpu/ops/deltas.py`.  Order-k deltas repeatedly convolve
with the linear-slope kernel [-w..w]/sum(i^2); each utterance's edges
clamp to its first and last *valid* frame (index clipped to n_valid - 1),
so a padded batch gives every utterance the numbers it gets alone.  The
neighbour gather is `torch.gather` over clipped indices, then a (2w+1)-tap
weighted sum in the reference's tap order.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def delta_filter(window: int) -> np.ndarray:
    i = np.arange(-window, window + 1, dtype=np.float64)
    return (i / np.sum(i * i)).astype(np.float32)


def _clipped_index(frame_mask: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(B, T, len(offsets)) frame indices t + o clipped to [0, n_valid - 1]."""
    t = frame_mask.shape[1]
    n_valid = frame_mask.to(torch.int64).sum(1)
    hi = torch.clamp(n_valid - 1, min=0)[:, None, None]
    idx = torch.arange(t, device=frame_mask.device)[None, :, None] + offsets[None, None, :]
    return torch.minimum(torch.clamp(idx, min=0), hi)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, T, D), idx (B, T, W) -> (B, T, W, D) with rows x[b, idx[b, t, w]]."""
    b, t, w = idx.shape
    d = x.shape[-1]
    flat = torch.gather(x, 1, idx.reshape(b, t * w, 1).expand(-1, -1, d))
    return flat.reshape(b, t, w, d)


def add_deltas(feats: torch.Tensor, frame_mask: torch.Tensor, order: int = 2,
               window: int = 2) -> torch.Tensor:
    """(B, T, D) or (T, D) -> same with D*(order+1) columns [x, dx, ddx...],
    zero on padding."""
    squeeze = feats.ndim == 2
    if squeeze:
        feats, frame_mask = feats[None], frame_mask[None]
    # `delta_filter`'s float32 taps, made on the device (no host copy: the
    # frontend chain runs this inside a CUDA graph)
    i = torch.arange(-window, window + 1, dtype=torch.float64, device=feats.device)
    taps = (i / torch.sum(i * i)).to(torch.float32)
    offs = torch.arange(-window, window + 1, device=feats.device)
    idx = _clipped_index(frame_mask, offs)
    outs = [feats]
    cur = feats
    for _ in range(order):
        neigh = _gather_rows(cur, idx)  # (B, T, 2w+1, D)
        cur = torch.einsum("btwd,w->btd", neigh, taps)
        outs.append(cur)
    out = torch.cat(outs, dim=-1) * frame_mask[..., None].to(feats.dtype)
    return out[0] if squeeze else out


def subsample_frames(feats: torch.Tensor, every_n: int, offset: int = 0) -> torch.Tensor:
    """Kaldi subsample-feats: keep every n-th frame ((B,)T,D)."""
    return feats[..., offset::every_n, :]


def paste_features(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Kaldi paste-feats: concatenate feature streams along the feature
    axis; frame counts must already agree, as paste-feats requires."""
    t0 = parts[0].shape[-2]
    for p in parts[1:]:
        if p.shape[-2] != t0:
            raise ValueError(f"paste_features: frame counts differ ({t0} vs {p.shape[-2]})")
    return torch.cat(list(parts), dim=-1)


def splice_frames(feats: torch.Tensor, frame_mask: torch.Tensor,
                  context: Tuple[int, ...] = (-2, -1, 0, 1, 2)) -> torch.Tensor:
    """Kaldi splice-feats / xconfig `Append(x@c...)`: shifted copies
    concatenated, clamped at each utterance's edges.
    (B, T, D) -> (B, T, D*len(context))."""
    squeeze = feats.ndim == 2
    if squeeze:
        feats, frame_mask = feats[None], frame_mask[None]
    offs = torch.as_tensor(list(context), device=feats.device)
    rows = _gather_rows(feats, _clipped_index(frame_mask, offs))  # (B, T, C, D)
    out = rows.reshape(*rows.shape[:2], -1) * frame_mask[..., None].to(feats.dtype)
    return out[0] if squeeze else out
