"""Counter-based Gaussian noise for dither: deterministic per utterance.

Port of `sepi_tpu/ops/dither.py`.  Each utterance gets a 32-bit seed
hashed from its id (`utt_seed`); every noise value is
murmur3-fmix32(seed ^ counter) pushed through Box-Muller, so the hash
bits are identical to the reference and the normals agree to a few ulps.

The hash runs in int64 masked to 32 bits after every multiply and shift:
CPU torch has no `>>` for uint32, and the low 32 bits of a wrapped int64
product are exact.  The MFCC kernel (`csrc/mfcc.cu`) computes the same
chain in native uint32.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_TWO_PI = 6.283185307179586
_INV_2_24 = 2.0 ** -24
# the angle scale as the reference applies it: rounded to float32 once
_ANG_SCALE = float(np.float32(_TWO_PI * _INV_2_24))


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 32-bit finalizer over int64 tensors holding uint32
    values (result in [0, 2^32))."""
    h = h.to(torch.int64) & MASK32
    h = ((h ^ (h >> 16)) * 0x85EBCA6B) & MASK32
    h = ((h ^ (h >> 13)) * 0xC2B2AE35) & MASK32
    return h ^ (h >> 16)


def u24(seed: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """Top 24 hash bits as float32 in [0, 2^24) (exact)."""
    return (fmix32(seed ^ counter) >> 8).to(torch.float32)


def hash_normal_pair(seed: torch.Tensor, counter: torch.Tensor,
                     span: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two independent standard normals per counter: one Box-Muller over
    two 24-bit hash uniforms (counters ``c`` and ``c + span``).

    The uniforms and the angle are the reference's float32 values; the
    transcendentals run in float64 and each output is rounded to float32
    once, so the result is the correctly rounded normal whatever the CPU
    library's float32 log/cos/sin path does (the reference stays within a
    few ulps of it)."""
    counter = counter.to(torch.int64)
    u1 = (u24(seed, counter) + 1.0) * _INV_2_24  # (0, 1]: log-safe
    ang = (_ANG_SCALE * u24(seed, (counter + span) & MASK32)).to(torch.float64)
    r = torch.sqrt(-2.0 * torch.log(u1.to(torch.float64)))
    return ((r * torch.cos(ang)).to(torch.float32),
            (r * torch.sin(ang)).to(torch.float32))


def hash_normal(seed: torch.Tensor, counter: torch.Tensor, span: int) -> torch.Tensor:
    """Single standard-normal tensor (first Box-Muller output)."""
    return hash_normal_pair(seed, counter, span)[0]


def utt_seed(utt_id: str, base_seed: int = 0) -> int:
    """Stable 31-bit seed for an utterance: md5 of the id mixed with the
    corpus-level base seed."""
    h = hashlib.md5(f"{base_seed}:{utt_id}".encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x7FFFFFFF


def utt_seeds(utt_ids: Sequence[str], base_seed: int = 0,
              salt: Optional[int] = None) -> np.ndarray:
    """(B,) int32 per-utterance dither seeds.  ``salt`` (an int; the
    reference draws it from a PRNG key) salts the whole corpus, the
    analog of compute-mfcc-feats' srand(seed)."""
    mixed = base_seed if salt is None else base_seed ^ int(salt)
    return np.asarray([utt_seed(u, mixed) for u in utt_ids], np.int32)
