"""Operations and bytes of the work, counted from shapes.

These are the yardstick of the roofline and MFU metrics: the work the
inputs need, whatever implements it, so no implementation can read over
100% against them.

- `mfcc_ops_per_frame`: an FFT-based Kaldi MFCC of one frame: dither,
  DC removal, raw energy, preemphasis and window on the frame; a real FFT
  of the padded frame (2.5 N log2 N, the usual count of a real transform
  of N points); power; the mel product over the bank's nonzero weights;
  log; DCT; lifter.  `mfcc_bytes`: each sample read once, each cepstrum
  and mask byte written once.
- `embed_flops`: the forward multiply-adds (2 per product) of the layers
  that make ``embedding_a`` from one chunk of real frames: the frame
  stacks, the 1-tap pooling layer and tdnn6's affine.  Padding frames and
  rows are not counted, nor are tdnn7 and the output layer, which the
  embedding does not need.
- `train_forward_flops`: one training step's forward on a batch, all the
  way to the logits; the step's work is taken as 3x that.
Both are the model kind's own (`benchmark/models/<model>.py`), built of
`stack_flops` and the segment head's counts here.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence, Tuple

import numpy as np

from reference.frontend import frame_length, mel_banks, padded_window

FLOAT_BYTES = 4


def mfcc_ops_per_frame(fcfg: Mapping) -> float:
    flen = frame_length(fcfg)
    nfft = padded_window(fcfg)
    bins = nfft // 2 + 1
    nnz = int(np.count_nonzero(mel_banks(fcfg)))
    m, c = fcfg["num_mel_bins"], fcfg["num_ceps"]
    framing = 1 + 2 + 2 + 2 + 1  # dither, DC removal, energy, preemphasis, window
    fft = 2.5 * nfft * math.log2(nfft)
    return float(framing * flen + fft + 3 * bins + 2 * nnz + m + 2 * m * c + c)


def mfcc_bytes(num_samples: int, num_frames: int, fcfg: Mapping) -> float:
    return float(FLOAT_BYTES * num_samples + num_frames * (FLOAT_BYTES * fcfg["num_ceps"] + 1))


def stack_flops(layers: Sequence, in_dim: int, frames: int) -> Tuple[float, int, int]:
    """(flops, output frames, output dim) of a stack on ``frames`` frames."""
    flops = 0.0
    for dim, offs in layers:
        frames -= max(offs) - min(offs)
        flops += 2.0 * max(frames, 0) * in_dim * len(offs) * dim
        in_dim = dim
    return flops, frames, in_dim


def embed_head_flops(dim: int, cfg: Mapping) -> float:
    """tdnn6's affine on the pooled statistics (2 x ``dim``) of one chunk."""
    return 2.0 * 2 * dim * cfg["embed_dim"]


def train_head_flops(dim: int, cfg: Mapping) -> float:
    """One example's segment head, to the speaker logits: tdnn6, tdnn7,
    the output layer."""
    e = cfg["embed_dim"]
    return 2.0 * (2 * dim * e + e * e + e * cfg["num_speakers"])


def _kind(cfg: Mapping, kind):
    if kind is None:
        from .core import model_kind

        kind = model_kind(cfg)
    return kind


def embed_flops(cfg: Mapping, frames: int, kind=None) -> float:
    """Of the configuration's model kind (``kind``, by default found by
    the configuration's ``model`` key)."""
    return _kind(cfg, kind).embed_flops(cfg, frames)


def train_forward_flops(cfg: Mapping, task: str, batch: int, frames: int, kind=None) -> float:
    """Forward flops of one step on ``batch`` examples of ``frames`` frames."""
    return _kind(cfg, kind).train_forward_flops(cfg, task, batch, frames)
