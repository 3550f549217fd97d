"""Voiced-frame selection (select-voiced-frames / select-voiced-ali).

Port of `sepi_tpu/ops/select.py`: a stable argsort on (not voiced) moves
voiced frames to the front in their original order, then a gather; the
output keeps the static T capacity with a validity mask over the first
``sum(voiced)`` rows.  `select_voiced_counts` applies the same
permutation to an integer per-frame stream (alignments, labels): the
batched form of the reference recipe's custom `select-voiced-ali`
(`src/ivectorbin/select-voiced-ali.cc:27-101`).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _compaction_perm(voiced: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T) bool -> (perm (B, T), counts (B,))."""
    voiced = voiced.bool()
    perm = torch.argsort((~voiced).to(torch.int32), dim=-1, stable=True)
    return perm, voiced.sum(-1)


def select_voiced_frames(feats: torch.Tensor,
                         voiced: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, D) / (T, D) features + matching bool voiced mask ->
    (compacted features, new frame mask)."""
    squeeze = feats.ndim == 2
    if squeeze:
        feats, voiced = feats[None], voiced[None]
    perm, counts = _compaction_perm(voiced)
    out = torch.gather(feats, 1, perm[..., None].expand(-1, -1, feats.shape[-1]))
    t = feats.shape[1]
    mask = torch.arange(t, device=feats.device)[None, :] < counts[:, None]
    out = out * mask[..., None]
    if squeeze:
        return out[0], mask[0]
    return out, mask


def select_voiced_counts(values: torch.Tensor, voiced: torch.Tensor,
                         fill_value: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """select-voiced-ali: (B, T) / (T,) integer per-frame values and the
    matching voiced mask -> (values compacted by the same permutation as
    `select_voiced_frames`, ``fill_value`` past the voiced count; new
    frame mask)."""
    squeeze = values.ndim == 1
    if squeeze:
        values, voiced = values[None], voiced[None]
    perm, counts = _compaction_perm(voiced)
    out = torch.gather(values, 1, perm)
    t = values.shape[1]
    mask = torch.arange(t, device=values.device)[None, :] < counts[:, None]
    out = torch.where(mask, out, torch.full_like(out, fill_value))
    if squeeze:
        return out[0], mask[0]
    return out, mask
