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
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence, Tuple

import numpy as np

from reference.frontend import frame_length, mel_banks, padded_window
from reference.tdnn import context

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


def _stack(layers: Sequence, in_dim: int, frames: int) -> Tuple[float, int, int]:
    """(flops, output frames, output dim) of a stack on ``frames`` frames."""
    flops = 0.0
    for dim, offs in layers:
        frames -= max(offs) - min(offs)
        flops += 2.0 * max(frames, 0) * in_dim * len(offs) * dim
        in_dim = dim
    return flops, frames, in_dim


def _trunk(cfg: Mapping, frames: int) -> Tuple[float, int, int]:
    """The frame-level layers up to stats pooling: (flops, frames, dim)."""
    arch, d = cfg["arch"], cfg["feat_dim"]
    if cfg["model"] == "xvector":
        return _stack(arch["frames"]["layers"], d, frames)
    f_sh, t_sh, d_sh = _stack(arch["shared"]["layers"], d, frames)
    f_xv, _, d_xv = _stack(arch["xvec_branch"]["layers"], d_sh, t_sh)
    f_am, _, d_am = _stack(arch["am"]["layers"], d, frames)
    xl, xr = context(arch["shared"]["layers"] + arch["xvec_branch"]["layers"])
    al, ar = context(arch["am"]["layers"])
    merged = frames - max(xl, al) - max(xr, ar)
    f5 = 2.0 * max(merged, 0) * (d_xv + d_am) * cfg["pool_dim"]
    return f_sh + f_xv + f_am + f5, merged, cfg["pool_dim"]


def embed_flops(cfg: Mapping, frames: int) -> float:
    f, _, dim = _trunk(cfg, frames)
    return f + 2.0 * 2 * dim * cfg["embed_dim"]


def train_forward_flops(cfg: Mapping, task: str, batch: int, frames: int) -> float:
    """Forward flops of one step on ``batch`` examples of ``frames`` frames."""
    arch, d = cfg["arch"], cfg["feat_dim"]
    f_sh, t_sh, d_sh = _stack(arch["shared"]["layers"], d, frames)
    if task == "am":
        f_am, t_am, d_am = _stack(arch["am_branch"]["layers"], d_sh, t_sh)
        return batch * (f_sh + f_am + 2.0 * t_am * d_am * cfg["num_senones"])
    f, _, dim = _trunk(cfg, frames)
    e = cfg["embed_dim"]
    head = 2.0 * (2 * dim * e + e * e + e * cfg["num_speakers"])
    return batch * (f + head)
