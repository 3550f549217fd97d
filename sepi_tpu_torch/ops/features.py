"""Kaldi MFCC and log-mel filterbank: the spectral constants and the
feature extractor.

Port of `sepi_tpu/ops/features.py`.  The constants (mel bank, DCT,
lifter, and the DFT basis with DC removal, preemphasis and the window
folded in) are built in float64 numpy exactly as the reference builds
them.  `FeatureExtractor.mfcc` follows the reference's main path on its
accelerator: every config that `mfcc_cuda.supported` accepts, dithered
or not, goes through the fused MFCC (`ops/mfcc_cuda.py`), whose dither is
the waveform-level counter-hash field of the TPU kernel.  Configs outside
that gate raise: the port has no second MFCC path.

`FeatureExtractor.fbank` (`compute-fbank-feats`) is the reference's
`_fbank_impl`, which no TPU kernel computes: plain torch ops on the
extractor's device.  Undithered, raw frames times the folded DFT basis
(one GEMM); dithered, `framing.frame_signal`'s per-frame counter-hash
field, the window chain and the plain DFT basis; then power, mel and log.

Kaldi conventions preserved: HTK mel scale 1127*ln(1+f/700) with
triangular banks; orthogonal DCT-II; lifter 1 + 0.5*Q*sin(pi*k/Q);
with use_energy, C0 is the raw-frame log energy.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import FrontendConfig
from ..device import DeviceLike, fp32_math, resolve_device
from .framing import frame_signal, num_frames, raw_frames, window_function

_EPS = float(np.finfo(np.float32).tiny)


def mel_scale(freq):
    return 1127.0 * np.log1p(np.asarray(freq, dtype=np.float64) / 700.0)


def mel_banks(cfg: FrontendConfig) -> np.ndarray:
    """(num_fft_bins, num_mel_bins) triangular mel weights, Kaldi-style."""
    nfft = cfg.padded_window_size
    num_fft_bins = nfft // 2 + 1
    fft_bin_width = cfg.sample_rate / nfft
    low, high = cfg.low_freq, cfg.high_freq_hz
    if not (0.0 <= low < high <= cfg.nyquist):
        raise ValueError(f"bad mel range [{low}, {high}] for fs={cfg.sample_rate}")
    mel_low, mel_high = mel_scale(low), mel_scale(high)
    delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)
    mel_freqs = mel_scale(np.arange(num_fft_bins) * fft_bin_width)  # (K,)
    left = mel_low + np.arange(cfg.num_mel_bins) * delta  # (M,)
    center = left + delta
    right = center + delta
    m = mel_freqs[:, None]
    up = (m - left[None, :]) / delta
    down = (right[None, :] - m) / delta
    w = np.minimum(up, down)
    w = np.clip(w, 0.0, None)
    return w.astype(np.float32)


def dct_matrix(num_ceps: int, num_bins: int) -> np.ndarray:
    """(num_bins, num_ceps) orthogonal DCT-II basis (Kaldi ComputeDctMatrix)."""
    n = np.arange(num_bins, dtype=np.float64)
    k = np.arange(num_ceps, dtype=np.float64)
    basis = np.cos(math.pi / num_bins * (n[:, None] + 0.5) * k[None, :])
    basis *= math.sqrt(2.0 / num_bins)
    basis[:, 0] = math.sqrt(1.0 / num_bins)
    return basis.astype(np.float32)


def lifter_coeffs(num_ceps: int, q: float) -> np.ndarray:
    if q == 0.0:
        return np.ones(num_ceps, dtype=np.float32)
    k = np.arange(num_ceps, dtype=np.float64)
    return (1.0 + 0.5 * q * np.sin(math.pi * k / q)).astype(np.float32)


def dft_basis(cfg: FrontendConfig) -> np.ndarray:
    """(flen, 2K) real-DFT basis: [cos | -sin] columns for bins 0..K-1.
    Only the first ``frame_length`` rows matter: the zero padding to
    ``padded_window_size`` contributes nothing."""
    nfft = cfg.padded_window_size
    k_bins = nfft // 2 + 1
    n = np.arange(cfg.frame_length, dtype=np.float64)
    k = np.arange(k_bins, dtype=np.float64)
    ang = 2.0 * math.pi * n[:, None] * k[None, :] / nfft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def fused_dft_basis(cfg: FrontendConfig) -> np.ndarray:
    """DFT basis with DC removal, preemphasis and the window folded in.

    All three are linear maps of the raw frame, so in float64 they compose
    into one (flen, 2K) matrix:
        spec = window * (P (f - mean(f) 1)) @ dft
             = f @ [ (I - 1 1'/flen)' P' diag(w) dft ]
    with P the frame-local preemphasis bidiagonal (P[0,0] uses Kaldi's
    edge rule f[0] -= c*f[0]).
    """
    flen = cfg.frame_length
    base = dft_basis(cfg).astype(np.float64)
    b1 = window_function(cfg).astype(np.float64)[:, None] * base
    c = cfg.preemphasis
    if c:
        p = np.eye(flen)
        p[0, 0] = 1.0 - c
        idx = np.arange(1, flen)
        p[idx, idx - 1] = -c
        b2 = p.T @ b1
    else:
        b2 = b1
    if cfg.remove_dc_offset:
        col_sums = b2.sum(axis=0)
        b3 = b2 - col_sums[None, :] / flen
    else:
        b3 = b2
    return b3.astype(np.float32)


def _power_spectrum(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """(..., flen) @ (flen, 2K) -> power (..., K)."""
    spec = x @ basis
    k = basis.shape[1] // 2
    return spec[..., :k] ** 2 + spec[..., k:] ** 2


class FeatureExtractor:
    """Batched MFCC and filterbank for a fixed FrontendConfig on one device.

    Usage::

        fe = FeatureExtractor(cfg)                       # device="cuda"
        feats, mask = fe.mfcc(samples, lengths, utt_seeds=seeds)  # (B, T, C)
        fbank, mask = fe.fbank(samples, lengths)         # (B, T, num_mel_bins)

    On a CUDA device every MFCC batch runs the hand-written MFCC kernel; on
    the CPU (only when asked for) its plain PyTorch version runs.  A config
    outside the kernel's gate raises in `mfcc`.
    """

    def __init__(self, cfg: FrontendConfig, device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def _batch(self, samples, lengths, max_frames):
        samples = torch.as_tensor(samples, dtype=torch.float32, device=self.device)
        squeeze = samples.ndim == 1
        if squeeze:
            samples = samples[None, :]
        if lengths is None:
            lengths = torch.full((samples.shape[0],), samples.shape[1],
                                 dtype=torch.int32, device=self.device)
        else:
            lengths = torch.atleast_1d(
                torch.as_tensor(lengths, dtype=torch.int32, device=self.device))
        if max_frames is None:
            max_frames = int(num_frames(samples.shape[1], self.cfg))
        return samples, lengths, max_frames, squeeze

    def mfcc(self, samples, lengths=None, max_frames: Optional[int] = None,
             utt_seeds=None):
        """(B, N) or (N,) samples -> (feats (B, T, C), mask (B, T)).

        ``utt_seeds`` ((B,) int32, `dither.utt_seeds`) turns on the
        counter-hash dither when ``cfg.dither != 0``; without seeds the
        features are undithered, as in the reference."""
        from .mfcc_cuda import mfcc_fused, supported

        if not supported(self.cfg):
            raise ValueError(f"frontend config outside the fused MFCC's gate: {self.cfg}")
        samples, lengths, max_frames, squeeze = self._batch(samples, lengths, max_frames)
        seeds = None
        if self.cfg.dither != 0.0 and utt_seeds is not None:
            seeds = torch.as_tensor(np.asarray(utt_seeds, np.int32), device=self.device)
        feats, mask = mfcc_fused(samples.contiguous(), lengths, self.cfg,
                                 max_frames, seeds)
        if squeeze:
            return feats[0], mask[0]
        return feats, mask

    @fp32_math()
    def fbank(self, samples, lengths=None, max_frames: Optional[int] = None,
              utt_seeds=None):
        """(B, N) or (N,) samples -> (log-mel filterbank (B, T, num_mel_bins),
        or the linear mel energies when ``cfg.use_log_fbank`` is off; mask
        (B, T)).  ``utt_seeds`` dithers as `framing.frame_signal` does."""
        cfg = self.cfg
        samples, lengths, max_frames, squeeze = self._batch(samples, lengths, max_frames)
        mel = torch.from_numpy(mel_banks(cfg)).to(self.device)
        seeds = utt_seeds if cfg.dither != 0.0 else None
        if seeds is None and cfg.raw_energy:
            # DC removal, preemphasis and the window folded into the basis
            frames, mask = raw_frames(samples, lengths, cfg, max_frames)
            basis = fused_dft_basis(cfg)
        else:
            frames, _, mask = frame_signal(samples, lengths, cfg, max_frames, seeds=seeds)
            basis = dft_basis(cfg)
        power = _power_spectrum(frames, torch.from_numpy(basis).to(self.device))
        out = torch.log(torch.clamp(power @ mel, min=_EPS))
        if not cfg.use_log_fbank:
            out = torch.exp(out)
        out = out * mask[..., None]
        if squeeze:
            return out[0], mask[0]
        return out, mask


def mfcc(samples, lengths=None, cfg: FrontendConfig = FrontendConfig(), utt_seeds=None,
         device: DeviceLike = "cuda"):
    """One-shot MFCC (builds the extractor; prefer the class in loops)."""
    return FeatureExtractor(cfg, device).mfcc(samples, lengths, utt_seeds=utt_seeds)


def fbank(samples, lengths=None, cfg: FrontendConfig = FrontendConfig(), utt_seeds=None,
          device: DeviceLike = "cuda"):
    """One-shot log-mel filterbank."""
    return FeatureExtractor(cfg, device).fbank(samples, lengths, utt_seeds=utt_seeds)
