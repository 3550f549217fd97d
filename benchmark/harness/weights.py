"""Weights made from the seed on the device, by name, and put into the
program's model.

Affine and output-layer weights are lecun-normal: a normal truncated at
two standard deviations (by the inverse CDF of one uniform draw over all
of them), scaled to variance 1 / fan_in; every other tensor is 0 or, where
the model kind says it starts at 1 (its ``starts_at_one``: a TDNN's
batch-norm scales and variances), 1.  The names and shapes come from the
configuration (the model kind's ``param_names``, `benchmark/models/`), so
the reference and the program read the same tensors, and a program
module whose names or shapes differ from the configuration is refused.
"""

from __future__ import annotations

import math
from types import ModuleType
from typing import Dict, Mapping, Tuple

import torch

from .audio import generator

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def make(shapes: Mapping[str, Tuple[int, ...]], seed: int, device: torch.device,
         kind: ModuleType) -> Dict[str, torch.Tensor]:
    """The tensors ``shapes`` names, from ``seed``; the model kind's
    ``starts_at_one(name)`` says which of the non-matrix ones start at 1."""
    g = generator(seed, device)
    mats = [n for n in sorted(shapes) if n.endswith(".weight") and len(shapes[n]) >= 2]
    sizes = [math.prod(shapes[n]) for n in mats]
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = torch.rand(sum(sizes), generator=g, device=device, dtype=torch.float64)
    z = (math.sqrt(2) * torch.erfinv(2 * (lo + (1 - 2 * lo) * u) - 1)).to(torch.float32)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for n, size in zip(mats, sizes):
        shape = shapes[n]
        fan_in = math.prod(shape[1:])
        out[n] = (z[off:off + size] * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).reshape(shape)
        off += size
    for n, shape in shapes.items():
        if n in out:
            continue
        fill = 1.0 if kind.starts_at_one(n) else 0.0
        out[n] = torch.full(shape, fill, dtype=torch.float32, device=device)
    return out


def load_into(model: torch.nn.Module, weights: Mapping[str, torch.Tensor], kind: ModuleType,
              prefix: str = "") -> None:
    """Copy ``weights`` (names under ``prefix``) into ``model``'s own
    tensors, checking that the two hold the same names and shapes but for
    the program's buffers whose names end in one of the model kind's
    ``PROGRAM_ONLY``, which no configuration names."""
    state = model.state_dict()
    want = {n[len(prefix):]: t for n, t in weights.items() if n.startswith(prefix)}
    extra = sorted(set(want) - set(state))
    missing = sorted(n for n in set(state) - set(want) if not n.endswith(tuple(kind.PROGRAM_ONLY)))
    if extra or missing:
        raise ValueError(f"model and configuration differ: configuration only {extra[:4]}, "
                         f"model only {missing[:4]}")
    with torch.no_grad():
        for n, t in want.items():
            if tuple(state[n].shape) != tuple(t.shape):
                raise ValueError(f"{n}: model {tuple(state[n].shape)}, configuration "
                                 f"{tuple(t.shape)}")
            state[n].copy_(t)
