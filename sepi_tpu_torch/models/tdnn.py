"""TDNN building blocks: dilated conv1d layers + statistics pooling.

Port of `sepi_tpu/models/tdnn.py`.  A splice ``Append(x@-3,x@0,x@3)`` is
a kernel-3 / dilation-3 VALID `Conv1d`; layer order is Kaldi's affine ->
ReLU -> batchnorm (eps 1e-3, a scale but no bias); the embedding tap is
the affine pre-activation.  Public functions keep the reference's
(B, T, C) layout; the convolutions run on (B, C, T) inside.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class TdnnSpec:
    """One relu-batchnorm-layer: output dim + uniformly spaced splice
    offsets (kernel_size = len(offsets), dilation = their spacing)."""

    dim: int
    offsets: Tuple[int, ...] = (0,)

    def __post_init__(self):
        offs = self.offsets
        if len(offs) > 1:
            gaps = {offs[i + 1] - offs[i] for i in range(len(offs) - 1)}
            if len(gaps) != 1:
                raise ValueError(f"non-uniform splice offsets {offs}")

    @property
    def kernel_size(self) -> int:
        return len(self.offsets)

    @property
    def dilation(self) -> int:
        if len(self.offsets) <= 1:
            return 1
        return self.offsets[1] - self.offsets[0]

    @property
    def left(self) -> int:
        return max(-min(self.offsets), 0)

    @property
    def right(self) -> int:
        return max(max(self.offsets), 0)


def stack_context(specs: Sequence[TdnnSpec]) -> Tuple[int, int]:
    """Total (left, right) context of a spec chain (nnet3 `vars` analog)."""
    return sum(s.left for s in specs), sum(s.right for s in specs)


@dataclasses.dataclass
class Stream:
    """A time series (B, T, C) plus the input frames it consumed per side."""

    x: torch.Tensor
    left: int
    right: int


class TdnnLayer(nn.Module):
    """affine (VALID dilated Conv1d) -> ReLU -> BatchNorm on (B, C, T).

    The batchnorm keeps a scale and no bias: its bias is held at zero and
    never trains, matching Kaldi's batchnorm-component.  Its EMA momentum
    0.05 is the reference's Flax decay 0.95.
    """

    def __init__(self, spec: TdnnSpec, in_dim: int):
        super().__init__()
        self.affine = nn.Conv1d(in_dim, spec.dim, spec.kernel_size,
                                dilation=spec.dilation)
        self.batchnorm = nn.BatchNorm1d(spec.dim, eps=1e-3, momentum=0.05)
        nn.init.zeros_(self.batchnorm.bias)
        self.batchnorm.bias.requires_grad_(False)

    def forward(self, x: torch.Tensor, return_affine: bool = False):
        affine = self.affine(x)
        h = self.batchnorm(torch.relu(affine))
        if return_affine:
            return h, affine
        return h


class TdnnStack(nn.Module):
    """A chain of TdnnLayers named ``tdnn1..n`` operating on (B, C, T)."""

    def __init__(self, specs: Sequence[TdnnSpec], in_dim: int):
        super().__init__()
        self.names = []
        for i, spec in enumerate(specs):
            name = f"tdnn{i + 1}"
            self.add_module(name, TdnnLayer(spec, in_dim))
            self.names.append(name)
            in_dim = spec.dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x)
        return x


class StatsPooling(nn.Module):
    """mean+stddev pooling over time (stats-layer mean+stddev(0:1:1:N)),
    masked, variance floored at ``var_floor``.  x: (B, T, C)."""

    def __init__(self, var_floor: float = 1e-10):
        super().__init__()
        self.var_floor = var_floor

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        if mask is None:
            mean = x.mean(1)
            var = (x * x).mean(1) - mean * mean
        else:
            m = mask.to(x.dtype)[..., None]
            count = torch.clamp(m.sum(1), min=1.0)
            mean = (x * m).sum(1) / count
            var = (x * x * m).sum(1) / count - mean * mean
        std = torch.sqrt(torch.clamp(var, min=self.var_floor))
        return torch.cat([mean, std], dim=-1)


class SegmentHead(nn.Module):
    """Post-pooling head: tdnn6 -> tdnn7 -> output layer.

    Returns a dict with ``embedding_a``/``embedding_b`` (the affine
    pre-activations of tdnn6/tdnn7) and, with classes, ``logits``."""

    def __init__(self, in_dim: int, embed_dim: int = 512, num_classes: int = 0):
        super().__init__()
        self.tdnn6 = TdnnLayer(TdnnSpec(embed_dim), in_dim)
        self.tdnn7 = TdnnLayer(TdnnSpec(embed_dim), embed_dim)
        self.output = nn.Linear(embed_dim, num_classes) if num_classes else None

    def forward(self, pooled: torch.Tensor):
        h, emb_a = self.tdnn6(pooled[:, :, None], return_affine=True)
        h, emb_b = self.tdnn7(h, return_affine=True)
        out = {"embedding_a": emb_a[:, :, 0], "embedding_b": emb_b[:, :, 0]}
        if self.output is not None:
            out["logits"] = self.output(h[:, :, 0])
        return out
