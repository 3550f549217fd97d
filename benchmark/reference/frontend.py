"""Plain reference of the frontend: Kaldi MFCC with the per-utterance
dither field, energy VAD, sliding CMVN and voiced-frame selection.

One utterance at a time, in float64, straight from the definitions:
frame -> dither -> remove DC -> raw log energy -> preemphasis -> window ->
zero pad -> real FFT -> power -> mel -> log -> DCT -> lifter, with C0
replaced by the raw log energy (`compute-mfcc-feats`, SRE `conf/mfcc.conf`);
`compute-vad` (energy threshold 5.5 + 0.5 x mean, +-2 frames, proportion
0.12); `apply-cmvn-sliding --center --cmn-window=300`; `select-voiced-frames`.

Frozen copies (the only places where the reference follows the program's
own choices, because they define which noise is added):
- the dither hash: `utt_seed` (md5 of ``"<salt>:<utt_id>"``), the
  murmur3 `fmix32` finaliser and the Box-Muller pair over two 24-bit
  uniforms, from `sepi_tpu_torch/ops/dither.py`;
- the noise map tied to 256-frame tiles (`noise_frames`) and the noise
  domain of the recomputed tail frames, from
  `sepi_tpu_torch/ops/mfcc_cuda.py` (`noise_frames`, `tail_plan`);
- the mel bank, DCT, lifter and window tables, from
  `sepi_tpu_torch/ops/features.py` and `ops/framing.py` (Kaldi's own
  formulas).

Every matrix product goes through `precision.mm`, so the same code is the
control when it is asked for a lower precision.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import numpy as np
import torch

from .precision import mm

MASK32 = 0xFFFFFFFF
_INV_2_24 = 2.0 ** -24
_ANG_SCALE = float(np.float32(2.0 * math.pi * _INV_2_24))
NOISE_TILE = 256
TILE_MIX = 0x9E3779B9
TAIL_MIX = 0x7F4A7C15
FLT_MIN = float(np.finfo(np.float32).tiny)


# ------------------------------------------------------------------ the hash


def utt_seed(utt_id: str, salt: int = 0) -> int:
    h = hashlib.md5(f"{salt}:{utt_id}".encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x7FFFFFFF


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h.to(torch.int64) & MASK32
    h = ((h ^ (h >> 16)) * 0x85EBCA6B) & MASK32
    h = ((h ^ (h >> 13)) * 0xC2B2AE35) & MASK32
    return h ^ (h >> 16)


def _u24(seed: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    return (fmix32(seed ^ counter) >> 8).to(torch.float32)


def normal_pair(seed: torch.Tensor, counter: torch.Tensor, span: int):
    """Two float32 normals per counter (cosine and sine outputs)."""
    counter = counter.to(torch.int64)
    u1 = (_u24(seed, counter) + 1.0) * _INV_2_24
    ang = (_ANG_SCALE * _u24(seed, (counter + span) & MASK32)).to(torch.float64)
    r = torch.sqrt(-2.0 * torch.log(u1.to(torch.float64)))
    return (r * torch.cos(ang)).to(torch.float32), (r * torch.sin(ang)).to(torch.float32)


# -------------------------------------------------------------- the tables


def mel_banks(cfg: Dict) -> np.ndarray:
    nfft = padded_window(cfg)
    k = nfft // 2 + 1
    width = cfg["sample_rate"] / nfft

    def mel(f):
        return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)

    lo, hi = mel(cfg["low_freq"]), mel(cfg["high_freq"])
    delta = (hi - lo) / (cfg["num_mel_bins"] + 1)
    m = mel(np.arange(k) * width)[:, None]
    left = lo + np.arange(cfg["num_mel_bins"]) * delta
    w = np.minimum((m - left) / delta, (left + 2 * delta - m) / delta)
    return np.clip(w, 0.0, None).astype(np.float32).astype(np.float64)


def dct_matrix(num_ceps: int, num_bins: int) -> np.ndarray:
    n = np.arange(num_bins, dtype=np.float64)
    k = np.arange(num_ceps, dtype=np.float64)
    basis = np.cos(math.pi / num_bins * (n[:, None] + 0.5) * k[None, :]) * math.sqrt(2.0 / num_bins)
    basis[:, 0] = math.sqrt(1.0 / num_bins)
    return basis.astype(np.float32).astype(np.float64)


def lifter(num_ceps: int, q: float) -> np.ndarray:
    k = np.arange(num_ceps, dtype=np.float64)
    return (1.0 + 0.5 * q * np.sin(math.pi * k / q)).astype(np.float32).astype(np.float64)


def povey_window(flen: int) -> np.ndarray:
    n = np.arange(flen, dtype=np.float64)
    w = (0.5 - 0.5 * np.cos(2.0 * math.pi * n / (flen - 1))) ** 0.85
    return w.astype(np.float32).astype(np.float64)


def padded_window(cfg: Dict) -> int:
    p = 1
    while p < frame_length(cfg):
        p *= 2
    return p


def frame_length(cfg: Dict) -> int:
    return int(cfg["sample_rate"] * cfg["frame_length_ms"] / 1000.0)


def frame_shift(cfg: Dict) -> int:
    return int(cfg["sample_rate"] * cfg["frame_shift_ms"] / 1000.0)


def num_frames(num_samples: int, cfg: Dict) -> int:
    shift = frame_shift(cfg)
    return (num_samples + shift // 2) // shift


# --------------------------------------------------------------------- MFCC


def _tile_noise(seed: int, frames: int, cfg: Dict, dev) -> torch.Tensor:
    """(frames, flen) standard normals of the 256-frame-tile noise map."""
    flen, shift = frame_length(cfg), frame_shift(cfg)
    n_t = max(-(-frames // NOISE_TILE), 1)
    extra = -(-flen // shift)
    rows_n = NOISE_TILE + extra
    half = (rows_n + 1) // 2
    tau = torch.arange(n_t, device=dev, dtype=torch.int64)
    tseed = fmix32((seed & MASK32) ^ ((tau * TILE_MIX) & MASK32))[:, None]
    cell = torch.arange(half * shift, device=dev, dtype=torch.int64)
    z1, z2 = normal_pair(tseed, cell, half * shift)
    rows = torch.cat([z1, z2], dim=-1)[:, : rows_n * shift]
    out = rows.unfold(-1, flen, shift)[:, :NOISE_TILE]
    return out.reshape(n_t * NOISE_TILE, flen)[:frames]


def _mirror(j: np.ndarray, n: int) -> np.ndarray:
    j = np.where(j < 0, -j - 1, j)
    j = np.where(j >= n, 2 * n - 1 - j, j)
    j = np.where(j < 0, -j - 1, j)
    return np.clip(j, 0, n - 1)


def raw_dithered_frames(samples: torch.Tensor, seed: int, cfg: Dict) -> torch.Tensor:
    """(T, flen) float64 frames of one utterance with the dither added:
    frames read the signal mirrored at the start and zero past the end
    with the tile noise, except the last frames whose window crosses the
    end, which read the mirrored signal with the tail-domain noise."""
    dev = samples.device
    n = samples.shape[0]
    flen, shift = frame_length(cfg), frame_shift(cfg)
    t = num_frames(n, cfg)
    off = shift // 2 - flen // 2
    j = np.arange(t)[:, None] * shift + off + np.arange(flen)[None, :]
    left = np.where(j < 0, -j - 1, j)  # mirror at the start only
    x = samples.to(torch.float64)
    padded = torch.cat([x, torch.zeros(flen + shift, dtype=torch.float64, device=dev)])
    frames = padded[torch.from_numpy(np.minimum(left, n + flen)).to(dev)]
    frames = torch.where(torch.from_numpy(left < n).to(dev), frames, torch.zeros_like(frames))
    dither = float(cfg["dither"])
    if dither:
        frames = frames + dither * _tile_noise(seed, t, cfg, dev).to(torch.float64)
    # the frames whose window can cross the end
    n_fix = min(-(-(flen - shift // 2) // shift) + 1, t)
    t0 = max(t - n_fix, 0)
    tail = np.arange(t0, t0 + n_fix)
    jt = tail[:, None] * shift + off + np.arange(flen)[None, :]
    exact = x[torch.from_numpy(_mirror(jt, n)).to(dev)]
    if dither:
        pseed = fmix32(torch.tensor((seed & MASK32) ^ TAIL_MIX, dtype=torch.int64, device=dev))
        cnt = torch.arange(n_fix * flen, device=dev).reshape(n_fix, flen)
        exact = exact + dither * normal_pair(pseed, cnt, n_fix * flen)[0].to(torch.float64)
    frames[torch.from_numpy(tail).to(dev)] = exact
    return frames


def mfcc(samples: torch.Tensor, seed: int, cfg: Dict, prec: str = "ref") -> torch.Tensor:
    """(T, num_ceps) float64 MFCC of one utterance (C0 = raw log energy)."""
    dev = samples.device
    flen = frame_length(cfg)
    frames = raw_dithered_frames(samples, seed, cfg)
    frames = frames - frames.mean(-1, keepdim=True)
    energy = torch.log(torch.clamp((frames * frames).sum(-1), min=FLT_MIN))
    prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=-1)
    frames = frames - cfg["preemphasis"] * prev
    frames = frames * torch.from_numpy(povey_window(flen)).to(dev)
    nfft = padded_window(cfg)
    if prec == "ref":
        power = torch.fft.rfft(frames, n=nfft).abs() ** 2
    else:  # the control's DFT: a product in the lower precision
        k = np.arange(nfft // 2 + 1)
        ang = 2.0 * math.pi * np.arange(flen)[:, None] * k[None, :] / nfft
        basis = torch.from_numpy(np.concatenate([np.cos(ang), -np.sin(ang)], 1)).to(dev)
        spec = mm(frames, basis, prec)
        power = spec[:, : nfft // 2 + 1] ** 2 + spec[:, nfft // 2 + 1:] ** 2
    mel = mm(power, torch.from_numpy(mel_banks(cfg)).to(dev), prec)
    logmel = torch.log(torch.clamp(mel, min=FLT_MIN))
    dct = torch.from_numpy(dct_matrix(cfg["num_ceps"], cfg["num_mel_bins"])).to(dev)
    ceps = mm(logmel, dct, prec) * torch.from_numpy(
        lifter(cfg["num_ceps"], cfg["cepstral_lifter"])).to(dev)
    ceps[:, 0] = energy
    return ceps


# ------------------------------------------------------------ VAD, CMVN, select


def energy_vad(log_e: torch.Tensor, vad: Dict) -> torch.Tensor:
    t = log_e.shape[0]
    thr = vad["energy_threshold"] + vad["energy_mean_scale"] * log_e.mean()
    above = (log_e > thr).to(torch.float64)
    c = vad["frames_context"]
    csum = torch.cat([torch.zeros(1, dtype=torch.float64, device=log_e.device),
                      torch.cumsum(above, 0)])
    idx = torch.arange(t, device=log_e.device)
    lo = torch.clamp(idx - c, min=0)
    hi = torch.clamp(idx + c + 1, max=t)
    num = csum[hi] - csum[lo]
    den = (hi - lo).to(torch.float64)
    return num >= vad["proportion_threshold"] * den


def sliding_cmvn(feats: torch.Tensor, window: int) -> torch.Tensor:
    """Centred sliding mean removal, the window min(window, T) frames
    shifted to lie inside the utterance."""
    t = feats.shape[0]
    win = min(window, t)
    idx = torch.arange(t, device=feats.device)
    start = torch.clamp(idx - window // 2, min=0)
    start = torch.minimum(start, torch.full_like(start, t - win))
    csum = torch.cat([torch.zeros(1, feats.shape[1], dtype=feats.dtype, device=feats.device),
                      torch.cumsum(feats, 0)])
    return feats - (csum[start + win] - csum[start]) / win


def nosil_features(samples: torch.Tensor, seed: int, cfg: Dict,
                   prec: str = "ref") -> Tuple[torch.Tensor, torch.Tensor]:
    """(voiced (T_v, C) float64 features, the (T,) voiced mask) of one
    utterance: `prepare_features_nosil`'s output for it."""
    ceps = mfcc(samples, seed, cfg["frontend"], prec)
    voiced = energy_vad(ceps[:, 0], cfg["vad"])
    normed = sliding_cmvn(ceps, cfg["cmvn"]["window"])
    return normed[voiced], voiced
