"""Fused MFCC: the hand-written Hopper kernel, its wrapper, its plain twin.

Replaces the Pallas TPU kernel `sepi_tpu/ops/mfcc_pallas.py:mfcc_fused`
(kernel body `_kernel`).  `mfcc_fused` computes batched Kaldi MFCC
``(B, N) -> ((B, T, C), mask)``: left mirror pad, optional waveform
dither from the counter hash, spectrum = frame @ fused DFT basis (DC bin
dropped), power, mel, log(max(., FLT_MIN)), DCT, lifter, and C0 = raw
energy s2 - s1^2/flen.  Then the few frames whose window crosses each
utterance's end are recomputed from an exact mirror gather of the clean
samples with their own noise domain, and frames past the end are zeroed.

- On a CUDA tensor the wrapper launches `csrc/mfcc.cu` (built with nvcc
  at first use, `sepi_tpu_torch/build.py`) and counts the launch in
  ``mfcc_fused.launches``; the tail patch and the mask then run in
  PyTorch on the same card.  A failed build or launch raises.
- On a CPU tensor it runs `mfcc_fused_reference`, the plain PyTorch
  version of the same function, which the tests hold against the JAX
  kernel run in interpret mode.

The dither noise reproduces the TPU kernel's map, which is tied to its
256-frame tiles (``NOISE_TILE``) and not to absolute sample positions:
frames at the end of a tile read halo rows whose noise differs from the
noise the next tile adds to the same samples.  The port keeps that map
whatever its own CUDA block size.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import FrontendConfig
from .dither import MASK32, fmix32, hash_normal, hash_normal_pair
from .framing import gather_frames_exact, num_frames

_EPS = float(np.finfo(np.float32).tiny)
NOISE_TILE = 256  # frames per tile of the reference kernel's noise map
_HALO_ROWS = 8  # the reference's halo block; sizes its padded signal
_TILE_MIX = 0x9E3779B9  # golden-ratio remix of the seed by tile index
_TAIL_MIX = 0x7F4A7C15  # seed domain of the recomputed tail frames


def _geometry(cfg: FrontendConfig):
    flen, shift = cfg.frame_length, cfg.frame_shift
    g = math.gcd(flen, shift)
    return g, shift // g, flen // g  # g, s_blocks, k_blocks


def supported(cfg: FrontendConfig) -> bool:
    """The reference kernel's config gate (`mfcc_pallas.supported`)."""
    g, s_blocks, k_blocks = _geometry(cfg)
    if g < 8 or s_blocks > 8:  # degenerate framing geometries
        return False
    if (k_blocks + s_blocks - 1) // s_blocks > _HALO_ROWS:
        return False
    if cfg.frame_shift > cfg.frame_length:
        return False
    if not cfg.raw_energy:
        return False
    return cfg.padded_window_size % 2 == 0


def reduced_spectral_consts(cfg: FrontendConfig):
    """(fused_basis[:, bins 1..K-1], mel[1:K], dct, lifter) as np arrays.

    Dropping bin 0 (DC) is exact: its mel weight is identically zero for
    any low_freq >= 0, and C0 comes from the energy/DCT."""
    from .features import dct_matrix, fused_dft_basis, lifter_coeffs, mel_banks

    mel = mel_banks(cfg)  # (K, M)
    if not np.all(mel[0] == 0.0):
        raise ValueError("DC bin carries mel weight; the fused MFCC assumes none")
    k = mel.shape[0]  # nfft//2 + 1
    fused = fused_dft_basis(cfg)  # (flen, 2K) [cos | -sin]
    basis = np.concatenate([fused[:, 1:k], fused[:, k + 1:]], axis=1)
    dct = dct_matrix(cfg.num_ceps, cfg.num_mel_bins)
    lift = lifter_coeffs(cfg.num_ceps, cfg.cepstral_lifter)
    return basis, mel[1:], dct, lift


class _Consts(NamedTuple):
    basis: torch.Tensor  # (flen, 2km)
    mel: torch.Tensor  # (km, M)
    dct: torch.Tensor  # (M, C)
    lift: torch.Tensor  # (C,)
    mel_lo: torch.Tensor  # (M,) int32 first nonzero mel row per band
    mel_hi: torch.Tensor  # (M,) int32 one past the last nonzero row


_CONSTS: Dict[Tuple[FrontendConfig, torch.device], _Consts] = {}


def _consts(cfg: FrontendConfig, device: torch.device) -> _Consts:
    key = (cfg, device)
    if key not in _CONSTS:
        basis, mel, dct, lift = reduced_spectral_consts(cfg)
        nz = mel != 0.0
        lo = np.where(nz.any(0), nz.argmax(0), 0)
        hi = np.where(nz.any(0), mel.shape[0] - nz[::-1].argmax(0), 0)
        _CONSTS[key] = _Consts(*(
            torch.as_tensor(a, device=device).contiguous()
            for a in (basis, mel, dct, lift, lo.astype(np.int32), hi.astype(np.int32))
        ))
    return _CONSTS[key]


def _pad_l(cfg: FrontendConfig) -> int:
    return 0 if cfg.snip_edges else cfg.frame_length // 2 - cfg.frame_shift // 2


def _spectral_chain(frames: torch.Tensor, c: _Consts, cfg: FrontendConfig) -> torch.Tensor:
    """(..., flen) raw frames -> (..., C) cepstra (with energy C0)."""
    km = c.mel.shape[0]
    spec = frames @ c.basis
    power = spec[..., :km] ** 2 + spec[..., km:] ** 2
    mel = power @ c.mel
    ceps = torch.log(torch.clamp(mel, min=_EPS)) @ c.dct * c.lift
    if cfg.use_energy:
        s1 = frames.sum(-1)
        s2 = (frames * frames).sum(-1)
        e = s2 - s1 * s1 / cfg.frame_length if cfg.remove_dc_offset else s2
        log_e = torch.log(torch.clamp(e, min=_EPS))
        if cfg.energy_floor > 0.0:
            log_e = torch.clamp(log_e, min=math.log(cfg.energy_floor))
        ceps = torch.cat([log_e[..., None], ceps[..., 1:]], dim=-1)
    return ceps


def _patch_tail_and_mask(out, samples, lengths, cfg, max_frames, seeds, c):
    """Recompute the frames whose window crosses each utterance's end
    from an exact mirror gather of the clean samples (noise from the
    tail domain), write them over ``out`` in place, then mask."""
    flen, shift = cfg.frame_length, cfg.frame_shift
    b = samples.shape[0]
    dev = samples.device
    n_fix = min(-(-(flen - shift // 2) // shift) + 1, max_frames)
    t_u = num_frames(lengths.to(torch.int64), cfg)
    t0 = torch.clamp(t_u - n_fix, 0, max_frames - n_fix)
    tail = t0[:, None] + torch.arange(n_fix, device=dev)
    exact = gather_frames_exact(samples, lengths, tail, cfg)  # (B, n_fix, flen)
    if seeds is not None:
        pseed = fmix32((seeds.to(torch.int64) & MASK32) ^ _TAIL_MIX)[:, None, None]
        cnt = torch.arange(n_fix * flen, device=dev).reshape(1, n_fix, flen)
        exact = exact + cfg.dither * hash_normal(pseed, cnt, n_fix * flen)
    out[torch.arange(b, device=dev)[:, None], tail] = _spectral_chain(exact, c, cfg)
    mask = torch.arange(max_frames, device=dev)[None, :] < t_u[:, None]
    return out * mask[..., None], mask


def noise_frames(seeds: torch.Tensor, max_frames: int, cfg: FrontendConfig) -> torch.Tensor:
    """(B, T, flen) standard-normal dither of every frame, as the TPU
    kernel draws it: per 256-frame tile tau, a (256 + extra, shift) row
    map keyed by fmix32(seed ^ tau * 0x9E3779B9); rows below ``half``
    take Box-Muller's cosine output, the rest its sine output."""
    flen, shift = cfg.frame_length, cfg.frame_shift
    dev = seeds.device
    n_t = max(-(-max_frames // NOISE_TILE), 1)
    extra = -(-flen // shift)
    rows_n = NOISE_TILE + extra
    half = (rows_n + 1) // 2
    tau = torch.arange(n_t, device=dev, dtype=torch.int64)
    mixed = (seeds.to(torch.int64)[:, None] & MASK32) ^ ((tau * _TILE_MIX) & MASK32)
    tseed = fmix32(mixed)[..., None]  # (B, n_t, 1)
    cell = torch.arange(half * shift, device=dev, dtype=torch.int64)
    z1, z2 = hash_normal_pair(tseed, cell, half * shift)  # (B, n_t, half*shift)
    rows = torch.cat([z1, z2], dim=-1)[..., : rows_n * shift]
    # frame i of a tile covers row cells [i*shift, i*shift + flen)
    frames = rows.unfold(-1, flen, shift)[:, :, :NOISE_TILE]  # (B, n_t, 256, flen)
    return frames.reshape(seeds.shape[0], n_t * NOISE_TILE, flen)[:, :max_frames]


def _padded_signal(samples: torch.Tensor, cfg: FrontendConfig, total: int) -> torch.Tensor:
    """[left mirror | samples | zeros] cut or padded to ``total`` samples."""
    pad_l = _pad_l(cfg)
    pieces = [samples[:, :pad_l].flip(1)] if pad_l else []
    pieces.append(samples)
    x = torch.cat(pieces, dim=1)[:, :total]
    return torch.nn.functional.pad(x, (0, total - x.shape[1]))


def mfcc_fused_reference(samples: torch.Tensor, lengths: torch.Tensor,
                         cfg: FrontendConfig, max_frames: int,
                         seeds: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the fused MFCC, on any device."""
    flen, shift = cfg.frame_length, cfg.frame_shift
    dithered = seeds is not None and cfg.dither != 0.0
    c = _consts(cfg, samples.device)
    samples = samples.to(torch.float32)
    n_t = max(-(-max_frames // NOISE_TILE), 1)
    total = (n_t * NOISE_TILE + _HALO_ROWS) * shift
    frames = _padded_signal(samples, cfg, total).unfold(1, flen, shift)[:, :max_frames]
    if dithered:
        frames = frames + cfg.dither * noise_frames(seeds, max_frames, cfg)
    out = _spectral_chain(frames, c, cfg)
    return _patch_tail_and_mask(out, samples, lengths, cfg, max_frames,
                                seeds if dithered else None, c)


def _launch(samples, t_valid, seeds, cfg, max_frames, c, out) -> None:
    from ..build import load

    lib = load("mfcc")
    fn = lib.sepi_mfcc_fused
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 12
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    b, n = samples.shape
    has_floor = cfg.energy_floor > 0.0
    dithered = seeds is not None
    err = fn(
        samples.data_ptr(), t_valid.data_ptr(),
        seeds.data_ptr() if dithered else None,
        c.basis.data_ptr(), c.mel.data_ptr(), c.mel_lo.data_ptr(),
        c.mel_hi.data_ptr(), c.dct.data_ptr(), c.lift.data_ptr(), out.data_ptr(),
        b, n, max_frames, cfg.frame_length, cfg.frame_shift, _pad_l(cfg),
        c.mel.shape[0], cfg.num_mel_bins, cfg.num_ceps, int(cfg.use_energy),
        int(cfg.remove_dc_offset), int(has_floor),
        math.log(cfg.energy_floor) if has_floor else 0.0, cfg.dither, int(dithered),
        torch.cuda.current_stream(samples.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mfcc kernel launch failed: CUDA error {err}")


def mfcc_fused(samples: torch.Tensor, lengths: torch.Tensor, cfg: FrontendConfig,
               max_frames: int, seeds: Optional[torch.Tensor] = None):
    """Batched MFCC: (B, N) float32 samples, (B,) lengths -> ((B, T, C), mask).

    ``seeds`` ((B,) int32, one per utterance, `dither.utt_seeds`) with
    ``cfg.dither != 0`` adds the counter-hash dither.  CUDA tensors run
    the kernel; CPU tensors run `mfcc_fused_reference`."""
    if not supported(cfg):
        raise ValueError(f"frontend config outside the fused MFCC's gate: {cfg}")
    dev = samples.device
    if dev.type == "cpu":
        return mfcc_fused_reference(samples, lengths, cfg, max_frames, seeds)
    if dev.type != "cuda":
        raise ValueError(f"mfcc_fused: unsupported device {dev}")
    if samples.dtype != torch.float32 or samples.ndim != 2 or not samples.is_contiguous():
        raise ValueError("mfcc_fused: samples must be a contiguous (B, N) float32 tensor")
    b, n = samples.shape
    if n < _pad_l(cfg):
        raise ValueError(f"mfcc_fused: {n} samples per row is below the mirror pad")
    lengths = lengths.to(device=dev, dtype=torch.int32)
    dithered = seeds is not None and cfg.dither != 0.0
    seeds = seeds.to(device=dev, dtype=torch.int32).contiguous() if dithered else None
    t_valid = num_frames(lengths, cfg).clamp(max=max_frames).to(torch.int32).contiguous()
    c = _consts(cfg, dev)
    out = torch.empty((b, max_frames, cfg.num_ceps), dtype=torch.float32, device=dev)
    _launch(samples, t_valid, seeds, cfg, max_frames, c, out)
    mfcc_fused.launches += 1
    return _patch_tail_and_mask(out, samples, lengths, cfg, max_frames, seeds, c)


mfcc_fused.launches = 0
