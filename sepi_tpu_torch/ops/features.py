"""Kaldi MFCC and log-mel filterbank: the spectral constants and the
feature extractor.

Port of `sepi_tpu/ops/features.py`.  The constants (mel bank, DCT,
lifter, and the DFT basis with DC removal, preemphasis and the window
folded in) are built in float64 numpy exactly as the reference builds
them.  `FeatureExtractor.mfcc` takes the reference's routes, chosen from
the config and ``spectral_mode`` alone before anything runs:
- a config that `mfcc_cuda.supported` accepts, under "auto" or "pallas",
  goes through the fused MFCC (`ops/mfcc_cuda.py`), dithered or not, whose
  dither is the waveform-level counter-hash field of the TPU kernel; on a
  CUDA device its kernel launches or raises;
- any other config, and "slices" or "conv", takes the reference's
  stepwise route (`_spectral` and the cepstral tail of `_mfcc_impl`) in
  plain torch ops on the extractor's device.  The reference holds its two
  stepwise variants equal, and here they are one implementation.

`FeatureExtractor.fbank` (`compute-fbank-feats`) is the reference's
`_fbank_impl` on the same stepwise spectrum, which no TPU kernel computes.
Undithered with raw energy, raw frames times the folded DFT basis (one
GEMM); otherwise `framing.frame_signal`'s chain (its per-frame
counter-hash dither when seeded) and the plain DFT basis; then power, mel
and log.

Kaldi conventions preserved: HTK mel scale 1127*ln(1+f/700) with
triangular banks; orthogonal DCT-II; lifter 1 + 0.5*Q*sin(pi*k/Q);
with use_energy, C0 is the log energy, floored at log(energy_floor).
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


_CONST_TABLES = {
    "fused_basis": fused_dft_basis,
    "basis": dft_basis,
    "mel": mel_banks,
    "dct": lambda cfg: dct_matrix(cfg.num_ceps, cfg.num_mel_bins),
    "lifter": lambda cfg: lifter_coeffs(cfg.num_ceps, cfg.cepstral_lifter),
    "window": window_function,
}
_CONSTS = {}


def _device_const(name: str, cfg: FrontendConfig, dev: torch.device) -> torch.Tensor:
    """A float32 table of the stepwise route on ``dev``, copied there once:
    the first (eager) call of a captured frontend makes it, and the
    capture, in which no host copy may run, reads it."""
    key = (name, cfg, dev)
    if key not in _CONSTS:
        _CONSTS[key] = torch.from_numpy(_CONST_TABLES[name](cfg)).to(dev)
    return _CONSTS[key]


SPECTRAL_MODES = ("auto", "pallas", "slices", "conv")


class FeatureExtractor:
    """Batched MFCC and filterbank for a fixed FrontendConfig on one device.

    Usage::

        fe = FeatureExtractor(cfg)                       # device="cuda"
        feats, mask = fe.mfcc(samples, lengths, utt_seeds=seeds)  # (B, T, C)
        fbank, mask = fe.fbank(samples, lengths)         # (B, T, num_mel_bins)

    ``spectral_mode`` (the reference's):
    - "auto" (default) and "pallas": a config inside the fused MFCC's gate
      (`mfcc_cuda.supported`) runs the hand-written MFCC kernel on a CUDA
      device and its plain PyTorch version on the CPU (only when asked
      for); a config outside the gate takes the stepwise route;
    - "slices" and "conv": the stepwise route (framing, DFT power, mel,
      log, DCT, lifter, energy) in plain torch ops, for every config.
    The route depends on the config and the mode alone, never on a failure:
    a kernel that fails to build or launch raises.
    """

    def __init__(self, cfg: FrontendConfig, device: DeviceLike = "cuda",
                 spectral_mode: str = "auto"):
        from .mfcc_cuda import supported

        if spectral_mode not in SPECTRAL_MODES:
            raise ValueError(f"unknown spectral_mode {spectral_mode!r}; "
                             f"expected one of {SPECTRAL_MODES}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.fused = spectral_mode in ("auto", "pallas") and supported(cfg)

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

    def _seeds(self, utt_seeds) -> Optional[torch.Tensor]:
        """The dither's per-utterance seeds as an int32 tensor on the
        device, or None: undithered without seeds or with ``cfg.dither ==
        0``, as in the reference."""
        if self.cfg.dither == 0.0 or utt_seeds is None:
            return None
        if not isinstance(utt_seeds, torch.Tensor):
            utt_seeds = torch.from_numpy(np.asarray(utt_seeds, np.int32))
        return utt_seeds.to(self.device, torch.int32)

    def _spectral(self, samples, lengths, max_frames, seeds):
        """(log-mel (B, T, M), log-energy (B, T), mask (B, T)), the
        reference's `_spectral`: undithered with raw energy, DC removal,
        preemphasis and the window ride in the folded basis; otherwise
        `frame_signal` runs Kaldi's chain frame by frame."""
        cfg = self.cfg
        dev = self.device
        if seeds is None and cfg.raw_energy:
            frames, mask = raw_frames(samples, lengths, cfg, max_frames)
            s1 = frames.sum(-1)
            s2 = (frames * frames).sum(-1)
            energy = s2 - s1 * s1 / cfg.frame_length if cfg.remove_dc_offset else s2
            log_e = torch.log(torch.clamp(energy, min=_EPS))
            basis = _device_const("fused_basis", cfg, dev)
        else:
            frames, log_e, mask = frame_signal(samples, lengths, cfg, max_frames, seeds=seeds)
            basis = _device_const("basis", cfg, dev)
        power = _power_spectrum(frames, basis)
        mel = _device_const("mel", cfg, dev)
        return torch.log(torch.clamp(power @ mel, min=_EPS)), log_e, mask

    @fp32_math()
    def _mfcc_stepwise(self, samples, lengths, max_frames, seeds):
        """The reference's MFCC tail on `_spectral`: DCT, lifter, and C0
        replaced by the floored log energy when ``cfg.use_energy``."""
        cfg = self.cfg
        log_mel, log_e, mask = self._spectral(samples, lengths, max_frames, seeds)
        dct = _device_const("dct", cfg, self.device)
        ceps = (log_mel @ dct) * _device_const("lifter", cfg, self.device)
        if cfg.use_energy:
            if cfg.energy_floor > 0.0:
                log_e = torch.clamp(log_e, min=math.log(cfg.energy_floor))
            ceps = torch.cat([log_e[..., None], ceps[..., 1:]], dim=-1)
        return ceps * mask[..., None], mask

    def mfcc(self, samples, lengths=None, max_frames: Optional[int] = None,
             utt_seeds=None):
        """(B, N) or (N,) samples -> (feats (B, T, C), mask (B, T)).

        ``utt_seeds`` ((B,) int32, `dither.utt_seeds`) turns on the
        counter-hash dither when ``cfg.dither != 0``: the fused MFCC's
        waveform field, or `frame_signal`'s per-frame field on the
        stepwise route (each its reference route's); without seeds the
        features are undithered, as in the reference."""
        samples, lengths, max_frames, squeeze = self._batch(samples, lengths, max_frames)
        seeds = self._seeds(utt_seeds)
        if self.fused:
            from .mfcc_cuda import mfcc_fused

            feats, mask = mfcc_fused(samples.contiguous(), lengths, self.cfg, max_frames, seeds)
        else:
            feats, mask = self._mfcc_stepwise(samples, lengths, max_frames, seeds)
        if squeeze:
            return feats[0], mask[0]
        return feats, mask

    @fp32_math()
    def fbank(self, samples, lengths=None, max_frames: Optional[int] = None,
              utt_seeds=None):
        """(B, N) or (N,) samples -> (log-mel filterbank (B, T, num_mel_bins),
        or the linear mel energies when ``cfg.use_log_fbank`` is off; mask
        (B, T)).  ``utt_seeds`` dithers as `framing.frame_signal` does."""
        samples, lengths, max_frames, squeeze = self._batch(samples, lengths, max_frames)
        out, _, mask = self._spectral(samples, lengths, max_frames, self._seeds(utt_seeds))
        if not self.cfg.use_log_fbank:
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
