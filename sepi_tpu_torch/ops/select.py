"""Voiced-frame selection (select-voiced-frames).

Port of `sepi_tpu/ops/select.py:select_voiced_frames`: a stable argsort
on (not voiced) moves voiced frames to the front in their original
order, then a gather; the output keeps the static T capacity with a
validity mask over the first ``sum(voiced)`` rows.
"""

from __future__ import annotations

from typing import Tuple

import torch


def select_voiced_frames(feats: torch.Tensor,
                         voiced: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, D) / (T, D) features + matching bool voiced mask ->
    (compacted features, new frame mask)."""
    squeeze = feats.ndim == 2
    if squeeze:
        feats, voiced = feats[None], voiced[None]
    voiced = voiced.bool()
    key = (~voiced).to(torch.int32)
    perm = torch.argsort(key, dim=-1, stable=True)
    counts = voiced.sum(-1)
    out = torch.gather(feats, 1, perm[..., None].expand(-1, -1, feats.shape[-1]))
    t = feats.shape[1]
    mask = torch.arange(t, device=feats.device)[None, :] < counts[:, None]
    out = out * mask[..., None]
    if squeeze:
        return out[0], mask[0]
    return out, mask
