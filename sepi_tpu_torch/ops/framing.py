"""Kaldi frame extraction: frame counts, windows, mirror gather, and the
per-frame processing chain.

Port of `sepi_tpu/ops/framing.py`:

- ``snip_edges=True``:  frames = (N - flen) // shift + 1, frame t starts at
  t*shift.
- ``snip_edges=False`` (the SRE configs' choice): frames =
  (N + shift//2) // shift, frame t is centred at t*shift + shift//2, and
  out-of-range samples mirror-reflect without repeating the edge sample.
- `frame_signal`: dither, DC-offset removal, raw log-energy, preemphasis
  and window multiply, in Kaldi's order; `raw_frames`: the framing alone.
Both gather every frame exactly (the reference's gather-free fast path
computes the same valid frames).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def _frames_and_mask(samples, lengths, cfg: FrontendConfig, max_frames: int):
    samples = torch.as_tensor(samples, dtype=torch.float32)
    lengths = torch.as_tensor(lengths, device=samples.device).to(torch.int64)
    t = torch.arange(max_frames, device=samples.device)
    frames = gather_frames_exact(samples, lengths, t.expand(samples.shape[0], -1), cfg)
    mask = t[None, :] < num_frames(lengths, cfg)[:, None]
    return frames, mask


def raw_frames(samples, lengths, cfg: FrontendConfig,
               max_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Framing only (no dither, DC removal, preemphasis or window): (B, N)
    samples and (B,) true lengths -> frames (B, max_frames, flen) float32
    and the frame mask (B, max_frames)."""
    return _frames_and_mask(samples, lengths, cfg, max_frames)


def frame_signal(samples, lengths, cfg: FrontendConfig, max_frames: int,
                 seeds: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched framing and Kaldi's per-frame chain: dither -> remove DC ->
    raw log-energy -> preemphasis -> window.

    ``seeds`` ((B,) int32 per-utterance dither seeds, `dither.utt_seeds`)
    turn on the dither when ``cfg.dither != 0``: the noise at sample n of
    frame t is the counter-hash normal of (seed, t * flen + n), the
    reference's per-frame field (`framing.py:335-349`), so features do not
    depend on the batch.  (The reference's PRNG-key dither has no
    counterpart.)

    Returns windowed (B, max_frames, flen), log_energy (B, max_frames)
    and the frame mask (B, max_frames)."""
    from .dither import MASK32, hash_normal

    frames, mask = _frames_and_mask(samples, lengths, cfg, max_frames)
    dev = frames.device
    if seeds is not None and cfg.dither != 0.0:
        flen = cfg.frame_length
        if not isinstance(seeds, torch.Tensor):
            seeds = torch.from_numpy(np.asarray(seeds, np.int64))
        s = (seeds.to(dev, torch.int64) & MASK32)[:, None, None]
        cnt = torch.arange(max_frames * flen, device=dev).reshape(1, max_frames, flen)
        # a fixed span (2^27, 1.9 h of 10 ms frames at flen 200): the second
        # uniform's counters must not depend on the batch's padding
        frames = frames + cfg.dither * hash_normal(s, cnt, 1 << 27)
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(-1, keepdim=True)
    tiny = torch.finfo(torch.float32).tiny
    log_energy = torch.log(torch.clamp((frames * frames).sum(-1), min=tiny))
    if cfg.preemphasis != 0.0:
        shifted = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemphasis * shifted
    from .features import _device_const

    frames = frames * _device_const("window", cfg, dev)
    if not cfg.raw_energy:
        log_energy = torch.log(torch.clamp((frames * frames).sum(-1), min=tiny))
    return frames, log_energy, mask
