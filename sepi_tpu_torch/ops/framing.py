"""Kaldi frame-extraction geometry: frame counts, windows, mirror gather.

Port of the parts of `sepi_tpu/ops/framing.py` that the MFCC path reads:

- ``snip_edges=True``:  frames = (N - flen) // shift + 1, frame t starts at
  t*shift.
- ``snip_edges=False`` (the SRE configs' choice): frames =
  (N + shift//2) // shift, frame t is centred at t*shift + shift//2, and
  out-of-range samples mirror-reflect without repeating the edge sample.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import FrontendConfig


def num_frames(num_samples, cfg: FrontendConfig):
    """Frame count for a sample count (a Python int or an int tensor)."""
    flen, shift = cfg.frame_length, cfg.frame_shift
    if cfg.snip_edges:
        if isinstance(num_samples, (int, np.integer)):
            return max((num_samples - flen) // shift + 1, 0) if num_samples >= flen else 0
        n = torch.div(num_samples - flen, shift, rounding_mode="floor") + 1
        return torch.where(num_samples >= flen, n, torch.zeros_like(n)).clamp(min=0)
    if isinstance(num_samples, (int, np.integer)):
        return (num_samples + shift // 2) // shift
    return torch.div(num_samples + shift // 2, shift, rounding_mode="floor")


def window_function(cfg: FrontendConfig) -> np.ndarray:
    """Kaldi window shapes; 'povey' is hanning raised to 0.85."""
    m = cfg.frame_length
    a = 2.0 * math.pi / (m - 1)
    n = np.arange(m, dtype=np.float64)
    if cfg.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * n)
    elif cfg.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * n)
    elif cfg.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * n)) ** 0.85
    elif cfg.window_type == "rectangular":
        w = np.ones(m)
    else:
        raise ValueError(f"unknown window type {cfg.window_type!r}")
    return w.astype(np.float32)


def frame_indices(frames: torch.Tensor, lengths: torch.Tensor,
                  cfg: FrontendConfig) -> torch.Tensor:
    """Sample indices of the given frames, mirror-reflected against each
    utterance's true length.

    frames: (B, F) int frame numbers; lengths: (B,) true sample counts.
    Returns (B, F, flen) int64 indices in [0, length).
    """
    flen, shift = cfg.frame_length, cfg.frame_shift
    n = torch.arange(flen, device=frames.device)
    length = lengths.to(torch.int64)[:, None, None]
    if cfg.snip_edges:
        idx = frames.to(torch.int64)[..., None] * shift + n
    else:
        idx = frames.to(torch.int64)[..., None] * shift + shift // 2 - flen // 2 + n
    # i < 0 -> -i - 1 ; i >= L -> 2L - 1 - i; twice for very short
    # utterances, then clamp
    idx = torch.where(idx < 0, -idx - 1, idx)
    idx = torch.where(idx >= length, 2 * length - 1 - idx, idx)
    idx = torch.where(idx < 0, -idx - 1, idx)
    return torch.minimum(idx.clamp(min=0), length - 1)


def gather_frames_exact(samples: torch.Tensor, lengths: torch.Tensor,
                        frames: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(B, N) samples -> (B, F, flen) raw frames by exact mirror gather."""
    b, f = frames.shape
    idx = frame_indices(frames, lengths, cfg)
    return torch.gather(samples, 1, idx.reshape(b, -1)).reshape(b, f, -1)
