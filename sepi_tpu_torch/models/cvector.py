"""Phonetic models: AM net, multitask / adapted / combined c-vectors.

Port of `sepi_tpu/models/cvector.py`, the v3/v4/v5 graphs:

- AM net (`train_am.sh:30-38`): 4x650 TDNN + 128-dim bottleneck tdnn5 @
  Append(-6,-3,0) -> senones.  The phonetic feed is the bottleneck's
  batch-norm output.
- v3 multitask (`prepare_nnet3_xconfig.sh:46-70`): shared tdnn1 (1-4
  shared layers), AM branch -> ``output_am`` (senones), x-vector branch ->
  stats -> segment head (speakers); embedding tap ``segment.tdnn6.affine``.
- v4 adaptation (`train_xvector_with_am.sh:44-57`): an x-vector whose
  tdnn5 input is Append(tdnn4, am.bottleneck), the AM grafted from
  pretraining (`train/graft.py`) with a learning-rate factor.
- v5 combined (`train_cvector_with_am.sh:65-89`): the v3 graph with the
  pretrained AM's bottleneck appended ahead of the x-vector branch's tdnn5.

Submodule names are the reference's Flax names (every stack numbers its
layers from ``tdnn1``), so the bridge, the graft and the ``{"am": f}``
learning-rate factors go by the same paths.  Streams are (B, T, C); the
per-frame heads are a `Linear` over channels and return (B, T, senones).
Every model takes the compute ``dtype`` of its TDNN layers (see
`models.tdnn`); the per-frame and speaker ``output`` layers stay float32,
as the reference's `nn.Dense` has no dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from .tdnn import (
    SegmentHead,
    StatsPooling,
    Stream,
    TdnnLayer,
    TdnnSpec,
    TdnnStack,
    append_streams,
    pooled_mask,
    stack_context,
)

TASKS = ("am", "xvec", "both")


# ----------------------------------------------------------------- AM net


@dataclasses.dataclass(frozen=True)
class AmConfig:
    feat_dim: int = 23
    num_senones: int = 4000
    specs: Tuple[TdnnSpec, ...] = (
        TdnnSpec(650, (-2, -1, 0, 1, 2)),
        TdnnSpec(650, (-1, 0, 1)),
        TdnnSpec(650, (-1, 0, 1)),
        TdnnSpec(650, (-3, 0, 3)),
        TdnnSpec(128, (-6, -3, 0)),  # bottleneck
    )

    @property
    def context(self) -> Tuple[int, int]:
        return stack_context(self.specs)  # (13, 7)

    @property
    def bottleneck_dim(self) -> int:
        return self.specs[-1].dim


AM_BOTTLENECK = AmConfig()


class AmNet(nn.Module):
    """ASR TDNN with bottleneck; per-frame senone logits.  Without
    ``with_logits`` (the grafted feed of v4/v5) there is no ``output``
    layer, as the reference's tree has none there."""

    def __init__(self, cfg: AmConfig, with_logits: bool = True, dtype: str = "float32"):
        super().__init__()
        self.cfg = cfg
        self.frames = TdnnStack(cfg.specs, cfg.feat_dim, dtype)
        self.output = nn.Linear(cfg.bottleneck_dim, cfg.num_senones) if with_logits else None

    def forward(self, feats: torch.Tensor):
        """(B, T, D) -> {"bottleneck": Stream (B, T', C)[, "logits": (B, T', S)]}."""
        stream = self.frames.stream(Stream(feats, 0, 0))
        out = {"bottleneck": stream}
        if self.output is not None:
            out["logits"] = self.output(stream.x)
        return out


# ------------------------------------------------------ shared/branch specs


def _prefix(dim: int) -> Tuple[TdnnSpec, ...]:
    """tdnn1..4 splice pattern shared by every branch (reference dims=512)."""
    return (
        TdnnSpec(dim, (-2, -1, 0, 1, 2)),
        TdnnSpec(dim, (-2, 0, 2)),
        TdnnSpec(dim, (-3, 0, 3)),
        TdnnSpec(dim, (0,)),
    )


def _xvec_branch(num_shared: int, dim: int = 512, pool_dim: int = 1500) -> Tuple[TdnnSpec, ...]:
    return _prefix(dim)[num_shared:4] + (TdnnSpec(pool_dim, (0,)),)


def _am_branch(num_shared: int, dim: int = 512) -> Tuple[TdnnSpec, ...]:
    return _prefix(dim)[num_shared:4] + (
        TdnnSpec(dim, (0,)),
        TdnnSpec(dim, (0,)),
        TdnnSpec(dim, (0,)),
    )


def _check_task(task: str) -> None:
    if task not in TASKS:
        raise ValueError(f"task {task!r} not in {TASKS}")


def _pool_and_head(model: nn.Module, stream: Stream, frame_mask: Optional[torch.Tensor]):
    """Masked stats pooling over ``stream``, then the segment head."""
    return model.segment(model.stats(stream.x, pooled_mask(stream, frame_mask)))


def _tdnn5(layer: TdnnLayer, merged: Stream) -> Stream:
    """The 1-tap pooling layer over the appended stream."""
    return Stream(layer(merged.x.transpose(1, 2)).transpose(1, 2), merged.left, merged.right)


# ------------------------------------------------------------ v3 multitask


@dataclasses.dataclass(frozen=True)
class MultitaskConfig:
    feat_dim: int = 23
    num_speakers: int = 0
    num_senones: int = 4000
    num_shared: int = 1  # 1..4 (_2share/_3share/_4share variants)
    embed_dim: int = 512
    hidden_dim: int = 512
    pool_dim: int = 1500

    @property
    def shared_specs(self) -> Tuple[TdnnSpec, ...]:
        return _prefix(self.hidden_dim)[: self.num_shared]

    @property
    def xvec_context(self) -> Tuple[int, int]:
        return stack_context(
            self.shared_specs + _xvec_branch(self.num_shared, self.hidden_dim, self.pool_dim))

    @property
    def am_context(self) -> Tuple[int, int]:
        return stack_context(self.shared_specs + _am_branch(self.num_shared, self.hidden_dim))


V3_MULTITASK = MultitaskConfig()


class MultitaskCVector(nn.Module):
    """Two-head c-vector net; each training step is one task, as the
    reference's interleaved egs (`frame_level_objf/common.py:248-294`)."""

    def __init__(self, cfg: MultitaskConfig, dtype: str = "float32"):
        super().__init__()
        self.cfg = cfg
        self.shared = TdnnStack(cfg.shared_specs, cfg.feat_dim, dtype)
        d = self.shared.out_dim
        self.am_branch = TdnnStack(_am_branch(cfg.num_shared, cfg.hidden_dim), d, dtype)
        self.output_am = nn.Linear(self.am_branch.out_dim, cfg.num_senones)
        self.xvec_branch = TdnnStack(
            _xvec_branch(cfg.num_shared, cfg.hidden_dim, cfg.pool_dim), d, dtype)
        self.stats = StatsPooling()
        self.segment = SegmentHead(2 * cfg.pool_dim, cfg.embed_dim, cfg.num_speakers, dtype)

    def forward(self, feats: torch.Tensor, frame_mask: Optional[torch.Tensor] = None,
                task: str = "both"):
        _check_task(task)
        shared = self.shared.stream(Stream(feats, 0, 0))
        out = {}
        if task in ("am", "both"):
            am = self.am_branch.stream(shared)
            out["am_logits"] = self.output_am(am.x)
            out["am_context"] = (am.left, am.right)
        if task in ("xvec", "both"):
            out.update(_pool_and_head(self, self.xvec_branch.stream(shared), frame_mask))
        return out


# ----------------------------------------------------------- v4 adaptation


@dataclasses.dataclass(frozen=True)
class AdaptedConfig:
    feat_dim: int = 23
    num_speakers: int = 0
    am: AmConfig = AM_BOTTLENECK
    embed_dim: int = 512
    hidden_dim: int = 512
    pool_dim: int = 1500

    @property
    def context(self) -> Tuple[int, int]:
        xl, xr = stack_context(_prefix(self.hidden_dim)[:4])
        al, ar = self.am.context
        return max(xl, al), max(xr, ar)  # (13, 7)


V4_ADAPTED = AdaptedConfig()


class AdaptedXVector(nn.Module):
    """x-vector with the phonetic bottleneck appended ahead of tdnn5; the
    ``am`` subtree is grafted from a pretrained AmNet (train/graft.py)."""

    def __init__(self, cfg: AdaptedConfig, dtype: str = "float32"):
        super().__init__()
        self.cfg = cfg
        self.am = AmNet(cfg.am, with_logits=False, dtype=dtype)
        self.xvec_branch = TdnnStack(_prefix(cfg.hidden_dim)[:4], cfg.feat_dim, dtype)
        self.tdnn5 = TdnnLayer(TdnnSpec(cfg.pool_dim, (0,)),
                               self.xvec_branch.out_dim + cfg.am.bottleneck_dim, dtype)
        self.stats = StatsPooling()
        self.segment = SegmentHead(2 * cfg.pool_dim, cfg.embed_dim, cfg.num_speakers, dtype)

    def forward(self, feats: torch.Tensor, frame_mask: Optional[torch.Tensor] = None):
        am = self.am(feats)["bottleneck"]
        xv = self.xvec_branch.stream(Stream(feats, 0, 0))
        return _pool_and_head(self, _tdnn5(self.tdnn5, append_streams([xv, am])), frame_mask)


# ------------------------------------------------------------- v5 combined


@dataclasses.dataclass(frozen=True)
class CombinedConfig:
    feat_dim: int = 23
    num_speakers: int = 0
    num_senones: int = 4000
    am: AmConfig = AM_BOTTLENECK  # the *pretrained* bottleneck provider
    num_shared: int = 1  # 1..3 shared trunk layers
    embed_dim: int = 512
    hidden_dim: int = 512
    pool_dim: int = 1500

    @property
    def shared_specs(self) -> Tuple[TdnnSpec, ...]:
        return _prefix(self.hidden_dim)[: self.num_shared]

    @property
    def am_context(self) -> Tuple[int, int]:
        """Context of the multitask AM head: the frame-egs context of the
        am task."""
        return stack_context(self.shared_specs + _am_branch(self.num_shared, self.hidden_dim))

    @property
    def xvec_context(self) -> Tuple[int, int]:
        """Context of the embedding path: the largest of the x-vector
        branch's and the pretrained AM feed's ((13, 7) by default)."""
        xl, xr = stack_context(
            self.shared_specs
            + _xvec_branch(self.num_shared, self.hidden_dim, self.pool_dim)[:-1])
        al, ar = self.am.context
        return max(xl, al), max(xr, ar)


V5_COMBINED = CombinedConfig()


class CombinedCVector(nn.Module):
    """v5: shared trunk + multitask AM branch + pretrained-AM bottleneck
    feed into the x-vector branch's tdnn5 (`train_cvector_with_am.sh:65-89`)."""

    def __init__(self, cfg: CombinedConfig, dtype: str = "float32"):
        super().__init__()
        self.cfg = cfg
        self.shared = TdnnStack(cfg.shared_specs, cfg.feat_dim, dtype)
        d = self.shared.out_dim
        self.am_branch = TdnnStack(_am_branch(cfg.num_shared, cfg.hidden_dim), d, dtype)
        self.output_am = nn.Linear(self.am_branch.out_dim, cfg.num_senones)
        self.am = AmNet(cfg.am, with_logits=False, dtype=dtype)
        self.xvec_branch = TdnnStack(
            _xvec_branch(cfg.num_shared, cfg.hidden_dim, cfg.pool_dim)[:-1], d, dtype)
        self.tdnn5 = TdnnLayer(TdnnSpec(cfg.pool_dim, (0,)),
                               self.xvec_branch.out_dim + cfg.am.bottleneck_dim, dtype)
        self.stats = StatsPooling()
        self.segment = SegmentHead(2 * cfg.pool_dim, cfg.embed_dim, cfg.num_speakers, dtype)

    def forward(self, feats: torch.Tensor, frame_mask: Optional[torch.Tensor] = None,
                task: str = "both"):
        _check_task(task)
        shared = self.shared.stream(Stream(feats, 0, 0))
        out = {}
        if task in ("am", "both"):
            am_b = self.am_branch.stream(shared)
            out["am_logits"] = self.output_am(am_b.x)
            out["am_context"] = (am_b.left, am_b.right)
        if task in ("xvec", "both"):
            pre = self.am(feats)["bottleneck"]
            xv = self.xvec_branch.stream(shared)
            out.update(_pool_and_head(self, _tdnn5(self.tdnn5, append_streams([xv, pre])),
                                      frame_mask))
        return out
