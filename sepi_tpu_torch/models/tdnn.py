"""TDNN building blocks: dilated conv1d layers + statistics pooling.

Port of `sepi_tpu/models/tdnn.py`.  A splice ``Append(x@-3,x@0,x@3)`` is
a kernel-3 / dilation-3 VALID `Conv1d`; layer order is Kaldi's affine ->
ReLU -> batchnorm (eps 1e-3, a scale but no bias); the embedding tap is
the affine pre-activation.  Public functions keep the reference's
(B, T, C) layout; the convolutions run on (B, C, T) inside.

Compute dtype (``dtype``, Flax's convention): parameters stay float32.
In ``"bfloat16"`` the affine casts its input, weight and bias to bf16 and
returns bf16, as Flax's ``nn.Conv(dtype=...)`` promotes all three, and
the ReLU runs in bf16; batch norm promotes its input to at least float32
first, so statistics pooling and the logits see float32, and the
embedding tap stays bf16.  In ``"float32"`` the affine computes in its
parameters' dtype (float64 too, for a host reference made with
``.to(torch.float64)``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import check_compute_dtype


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

    def crop_to(self, left: int, right: int) -> "Stream":
        """Center-crop so the stream's context becomes (left, right)."""
        dl, dr = left - self.left, right - self.right
        if dl < 0 or dr < 0:
            raise ValueError(f"cannot expand context ({self.left},{self.right}) -> "
                             f"({left},{right})")
        t = self.x.shape[1]
        return Stream(self.x[:, dl:t - dr, :], left, right)


def pooled_mask(stream: Stream, frame_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The (B, T') validity of ``stream``'s frames from the (B, T) mask over
    input frames: output frame t consumes input frames [t, t + left +
    right], so it is valid iff input frame t + left + right is."""
    if frame_mask is None:
        return None
    ctx = stream.left + stream.right
    return frame_mask[:, ctx:ctx + stream.x.shape[1]]


def append_streams(streams: Sequence[Stream]) -> Stream:
    """xconfig `Append(a, b)` across branches: align by the largest
    context, centre-crop, concatenate on channels."""
    left = max(s.left for s in streams)
    right = max(s.right for s in streams)
    aligned = [s.crop_to(left, right) for s in streams]
    return Stream(torch.cat([s.x for s in aligned], dim=-1), left, right)


class BatchNorm(nn.Module):
    """Batch norm over (B, C, T) with Flax's conventions (`nn.BatchNorm`
    as the reference's TdnnLayer uses it).

    - Train mode normalises with the batch mean and the *biased* batch
      variance E[x^2] - E[x]^2 (clamped at 0), and updates the running
      statistics with decay 0.95: ``running = 0.95 running + 0.05 batch``,
      the biased variance included (`torch.nn.BatchNorm1d` would store
      the unbiased one: 64/63 apart in the segment layers, where the
      statistics reduce over the batch only).
    - The input is promoted to at least float32 first, in both modes.
    - Eval mode normalises with the running statistics.
    - ``weight`` is the trainable scale; ``bias`` is a buffer held at 0
      (Kaldi's batchnorm-component has no offset), so no optimizer sees it.
    - While ``moments`` is a list (see `batch_moments`), a train-mode
      forward appends its (mean, var) there instead of updating the
      running statistics.
    - While ``group`` is a process group (see `sync_batch_norm`), the
      train-mode mean and E[x^2] are averaged over its ranks, forward and
      backward, before the variance is formed: the moments of the global
      batch, as GSPMD computes them, when each rank holds an equal shard.
      Every rank then stores the same running statistics.
    """

    def __init__(self, dim: int, eps: float = 1e-3, decay: float = 0.95):
        super().__init__()
        self.eps = eps
        self.decay = decay
        self.weight = nn.Parameter(torch.ones(dim))
        self.register_buffer("bias", torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.int64))
        self.moments: Optional[list] = None
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Flax's BatchNorm(dtype=float32): the input promoted to at least float32
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        mean = x.mean((0, 2))
        sq = (x * x).mean((0, 2))
        if self.group is not None:
            from ..parallel.mesh import all_reduce_mean

            mean, sq = all_reduce_mean(torch.cat([mean, sq]), self.group).chunk(2)
        var = torch.clamp(sq - mean * mean, min=0.0)
        if self.moments is not None:
            self.moments.append((mean.detach(), var.detach()))
        else:
            with torch.no_grad():
                d = self.decay
                self.running_mean.copy_(d * self.running_mean + (1 - d) * mean)
                self.running_var.copy_(d * self.running_var + (1 - d) * var)
                self.num_batches_tracked += 1
        # Flax's order: (x - mean) * (rsqrt(var + eps) * scale)
        return (x - mean[:, None]) * (torch.rsqrt(var + self.eps) * self.weight)[:, None]


@contextlib.contextmanager
def batch_moments(model: nn.Module) -> Iterator[Dict[str, list]]:
    """Inside the block, every `BatchNorm` of ``model`` records the batch
    (mean, biased var) of each train-mode forward and leaves its running
    statistics alone.  Yields module name -> that list."""
    bns = {name: m for name, m in model.named_modules() if isinstance(m, BatchNorm)}
    for m in bns.values():
        m.moments = []
    try:
        yield {name: m.moments for name, m in bns.items()}
    finally:
        for m in bns.values():
            m.moments = None


@contextlib.contextmanager
def sync_batch_norm(model: nn.Module, group) -> Iterator[None]:
    """Inside the block, every `BatchNorm` of ``model`` reduces its
    train-mode moments over ``group`` (a no-op for None)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.group = group
    try:
        yield
    finally:
        for m in bns:
            m.group = None


# std of a unit normal truncated to [-2, 2] (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_init(model: nn.Module, seed: int) -> None:
    """Flax's default initialisation, from a seeded torch generator:
    `Conv1d`/`Linear` weights lecun-normal (a normal truncated at two
    standard deviations, rescaled to variance 1/fan_in, fan_in =
    kernel size x input channels), biases 0, batch-norm scales 1 and
    fresh statistics.  The draws are not Flax's own numbers."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv1d, nn.Linear)):
                w = m.weight
                fan_in = w[0].numel()
                std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
                cpu = torch.empty(w.shape)
                nn.init.trunc_normal_(cpu, std=std, a=-2 * std, b=2 * std, generator=g)
                w.copy_(cpu)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()


class TdnnLayer(nn.Module):
    """affine (VALID dilated Conv1d) -> ReLU -> BatchNorm on (B, C, T);
    the affine and the ReLU in ``dtype``, the batch norm in float32."""

    def __init__(self, spec: TdnnSpec, in_dim: int, dtype: str = "float32"):
        super().__init__()
        self.affine = nn.Conv1d(in_dim, spec.dim, spec.kernel_size,
                                dilation=spec.dilation)
        self.batchnorm = BatchNorm(spec.dim)
        self.dtype = getattr(torch, check_compute_dtype(dtype))

    def forward(self, x: torch.Tensor, return_affine: bool = False):
        a = self.affine
        dt = self.dtype if self.dtype == torch.bfloat16 else a.weight.dtype
        affine = F.conv1d(x.to(dt), a.weight.to(dt), a.bias.to(dt), dilation=a.dilation)
        h = self.batchnorm(torch.relu(affine))
        if return_affine:
            return h, affine
        return h


def compute_dtype(model: nn.Module) -> torch.dtype:
    """The compute dtype of ``model``'s TDNN layers (its first layer's)."""
    return next(m.dtype for m in model.modules() if isinstance(m, TdnnLayer))


class TdnnStack(nn.Module):
    """A chain of TdnnLayers named ``tdnn1..n`` operating on (B, C, T)."""

    def __init__(self, specs: Sequence[TdnnSpec], in_dim: int, dtype: str = "float32"):
        super().__init__()
        self.names = []
        self.context = stack_context(specs)
        for i, spec in enumerate(specs):
            name = f"tdnn{i + 1}"
            self.add_module(name, TdnnLayer(spec, in_dim, dtype))
            self.names.append(name)
            in_dim = spec.dim
        self.out_dim = in_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x)
        return x

    def stream(self, s: Stream) -> Stream:
        """The stack on a Stream of (B, T, C): context accumulates; the
        transposes are views, so chained stacks copy nothing."""
        left, right = self.context
        x = self(s.x.transpose(1, 2)).transpose(1, 2)
        return Stream(x, s.left + left, s.right + right)


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
    pre-activations of tdnn6/tdnn7, in ``dtype``) and, with classes,
    ``logits`` (float32: the output layer has no compute dtype)."""

    def __init__(self, in_dim: int, embed_dim: int = 512, num_classes: int = 0,
                 dtype: str = "float32"):
        super().__init__()
        self.tdnn6 = TdnnLayer(TdnnSpec(embed_dim), in_dim, dtype)
        self.tdnn7 = TdnnLayer(TdnnSpec(embed_dim), embed_dim, dtype)
        self.output = nn.Linear(embed_dim, num_classes) if num_classes else None

    def forward(self, pooled: torch.Tensor):
        h, emb_a = self.tdnn6(pooled[:, :, None], return_affine=True)
        h, emb_b = self.tdnn7(h, return_affine=True)
        out = {"embedding_a": emb_a[:, :, 0], "embedding_b": emb_b[:, :, 0]}
        if self.output is not None:
            out["logits"] = self.output(h[:, :, 0])
        return out
