"""The v2 x-vector model (run_xvector_new.sh:90-115).

Port of `sepi_tpu/models/xvector.py`:
  tdnn1 512 @ (-2..2) -> tdnn2 512 @ {-2,0,2} -> tdnn3 512 @ {-3,0,3}
  -> tdnn4 512 -> tdnn5 1500 -> stats(mean+stddev) -> tdnn6 512
  [embedding tap = tdnn6.affine] -> tdnn7 512 -> output(num_speakers).
Total frame-level context: left 7, right 7.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from .tdnn import (SegmentHead, StatsPooling, Stream, TdnnSpec, TdnnStack, pooled_mask,
                   stack_context)


@dataclasses.dataclass(frozen=True)
class XVectorConfig:
    feat_dim: int = 23
    num_speakers: int = 0
    frame_specs: Tuple[TdnnSpec, ...] = (
        TdnnSpec(512, (-2, -1, 0, 1, 2)),
        TdnnSpec(512, (-2, 0, 2)),
        TdnnSpec(512, (-3, 0, 3)),
        TdnnSpec(512, (0,)),
        TdnnSpec(1500, (0,)),
    )
    embed_dim: int = 512

    @property
    def context(self) -> Tuple[int, int]:
        return stack_context(self.frame_specs)

    @property
    def min_frames(self) -> int:
        l, r = self.context
        return l + r + 1


V2_XVECTOR = XVectorConfig()


class XVector(nn.Module):
    """``dtype`` is the compute dtype of every TDNN layer (see
    `models.tdnn`); parameters and logits stay float32."""

    def __init__(self, cfg: XVectorConfig, dtype: str = "float32"):
        super().__init__()
        self.cfg = cfg
        self.frames = TdnnStack(cfg.frame_specs, cfg.feat_dim, dtype)
        self.stats = StatsPooling()
        self.segment = SegmentHead(2 * cfg.frame_specs[-1].dim, cfg.embed_dim,
                                   cfg.num_speakers, dtype)

    def trunk(self, feats: torch.Tensor) -> Stream:
        """Frame-level layers only: (B, T, D) -> Stream of (B, T', C)."""
        return self.frames.stream(Stream(feats, 0, 0))

    def head(self, pooled: torch.Tensor):
        """Post-pooling layers: (B, 2*C) -> embeddings / logits."""
        return self.segment(pooled)

    def forward(self, feats: torch.Tensor, frame_mask: Optional[torch.Tensor] = None):
        """(B, T, D) features, optional (B, T) mask over input frames."""
        stream = self.trunk(feats)
        return self.head(self.stats(stream.x, pooled_mask(stream, frame_mask)))
