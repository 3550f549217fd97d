"""Data augmentation: reverberation and SNR-controlled noise mixing.

Replaces the reference's augmentation stage (`v2/run_sre10.sh:92-159`):
`steps/data/reverberate_data_dir.py` (RIR convolution via the
`wav-reverberate` binary) and `steps/data/augment_data_dir_new.py`
(MUSAN noise/music/babble mixing), including the dataset-level semantics:
augmented copies get suffixed utt ids with a ``uniq_id`` back-pointer
(utt2uniq) so train/valid splits never leak a speaker's clean copy into
the other side.

Port of `sepi_tpu/data/augment.py`.  The reverberation's FFT convolution
is `torch.fft` in float32 on the device the caller names (``device=``,
default "cuda"; the drivers pass theirs).  It rounds differently from the
reference's FFT, so reverberated copies agree with the reference to a
tolerance relative to the signal's RMS, not bit for bit.  Everything else
is numpy with the reference's draws in the reference's order: the
corpus-level `augment_dataset` is a manifest transform that pairs each
utterance with a deterministic per-utterance augmentation plan (seeded
like the reference's random pipelines), and its plans, SNRs, noise crops
and subsets equal the reference's.

Semantics matched to wav-reverberate / augment_data_dir:
- reverb: full convolution with the RIR, trimmed to the input length and
  *power-normalized* to the input's energy (wav-reverberate default
  behaviour keeps levels comparable);
- additive noise at target SNR: noise cropped/tiled to length, scaled so
  10*log10(P_signal/P_noise) == snr;
- babble: 3-7 noise sources summed before mixing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .manifest import Dataset, Utterance


def _power(x: np.ndarray) -> float:
    return float(np.mean(np.square(x, dtype=np.float64))) + 1e-20


def _fft_convolve(signal: np.ndarray, rir: np.ndarray, out_len: int,
                  device: torch.device) -> np.ndarray:
    """The first ``out_len`` samples of the full linear convolution, by a
    float32 FFT of the next power of two on ``device``."""
    n = signal.shape[0] + rir.shape[0] - 1
    nfft = 1 << (n - 1).bit_length()
    x = torch.as_tensor(np.asarray(signal, np.float32), device=device)
    h = torch.as_tensor(np.asarray(rir, np.float32), device=device)
    out = torch.fft.irfft(torch.fft.rfft(x, nfft) * torch.fft.rfft(h, nfft), nfft)
    return out[:out_len].cpu().numpy()


def reverberate(samples: np.ndarray, rir: np.ndarray,
                device: DeviceLike = "cuda") -> np.ndarray:
    """Convolve with an RIR; aligned to the RIR's direct path (peak) and
    power-normalized to the dry signal (wav-reverberate --shift-output)."""
    dev = resolve_device(device)
    rir = np.asarray(rir, np.float32)
    peak = int(np.argmax(np.abs(rir)))
    wet = _fft_convolve(samples, rir, len(samples) + peak, dev)[peak : peak + len(samples)]
    scale = np.sqrt(_power(samples) / _power(wet))
    return (wet * scale).astype(np.float32)


def _fit_noise(noise: np.ndarray, length: int, rng: np.random.Generator) -> np.ndarray:
    """Crop (random offset) or tile noise to the target length."""
    if len(noise) >= length:
        off = int(rng.integers(len(noise) - length + 1))
        return np.asarray(noise[off : off + length], np.float32)
    reps = -(-length // len(noise))
    return np.tile(np.asarray(noise, np.float32), reps)[:length]


def mix_noise(
    samples: np.ndarray,
    noise: np.ndarray,
    snr_db: float,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Additive mixing at an exact target SNR."""
    rng = rng or np.random.default_rng(0)
    n = _fit_noise(noise, len(samples), rng)
    scale = np.sqrt(_power(samples) / (_power(n) * 10.0 ** (snr_db / 10.0)))
    return (np.asarray(samples, np.float32) + scale * n).astype(np.float32)


def mix_babble(
    samples: np.ndarray,
    speech_sources: Sequence[np.ndarray],
    snr_db: float,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Babble: sum several speech sources, then mix at target SNR
    (augment_data_dir's 3-7 speaker babble)."""
    rng = rng or np.random.default_rng(0)
    acc = np.zeros(len(samples), np.float32)
    for src in speech_sources:
        acc += _fit_noise(src, len(samples), rng)
    return mix_noise(samples, acc, snr_db, rng)


@dataclasses.dataclass(frozen=True)
class AugmentSpec:
    """One augmentation kind with its SNR ladder (reference values:
    noise 0:5:10:15, music 5:8:10:15, babble 13:15:17:20)."""

    kind: str  # reverb | noise | music | babble
    snrs: Tuple[float, ...] = ()


REFERENCE_AUGMENTS = (
    AugmentSpec("reverb"),
    AugmentSpec("noise", (0.0, 5.0, 10.0, 15.0)),
    AugmentSpec("music", (5.0, 8.0, 10.0, 15.0)),
    AugmentSpec("babble", (13.0, 15.0, 17.0, 20.0)),
)


@dataclasses.dataclass(frozen=True)
class AugPlan:
    """One planned augmented copy: every random draw resolved up front
    (no audio needed to plan), so eager and lazy application produce
    identical samples.  ``offset_seed`` seeds the noise-crop rng —
    per-copy, so application order never matters."""

    utt_id: str
    aug_id: str
    kind: str
    snr: float = 0.0
    rir_idx: int = -1
    noise_idxs: Tuple[int, ...] = ()
    offset_seed: int = 0


def plan_augments(
    dataset: Dataset,
    rirs: Sequence[np.ndarray] = (),
    noises: Mapping[str, Sequence[np.ndarray]] = {},
    specs: Sequence[AugmentSpec] = REFERENCE_AUGMENTS,
    seed: int = 0,
) -> List[AugPlan]:
    """Resolve the augmentation draw table from manifests alone —
    pool/SNR indices from one shared seeded rng (the reference's
    seeded-pipeline determinism), noise-crop offsets from per-copy
    seeds so a lazy Mapping can realize copies in ANY order and match
    the eager path bitwise."""
    rng = np.random.default_rng(seed)
    plans: List[AugPlan] = []
    for utt in dataset:
        for spec in specs:
            aug_id = f"{utt.utt_id}-{spec.kind}"
            off = int(rng.integers(1 << 31))
            if spec.kind == "reverb":
                if not len(rirs):
                    continue
                plans.append(AugPlan(utt.utt_id, aug_id, "reverb",
                                     rir_idx=int(rng.integers(len(rirs))),
                                     offset_seed=off))
            else:
                pool = noises.get(spec.kind)
                if not pool:
                    continue
                snr = float(spec.snrs[int(rng.integers(len(spec.snrs)))])
                if spec.kind == "babble":
                    k = int(rng.integers(3, 8))
                    idxs = tuple(int(rng.integers(len(pool))) for _ in range(k))
                else:
                    idxs = (int(rng.integers(len(pool))),)
                plans.append(AugPlan(utt.utt_id, aug_id, spec.kind,
                                     snr=snr, noise_idxs=idxs,
                                     offset_seed=off))
    return plans


def apply_augment(
    plan: AugPlan,
    x: np.ndarray,
    rirs: Sequence[np.ndarray],
    noises: Mapping[str, Sequence[np.ndarray]],
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Realize one planned copy from the clean signal (a reverberated copy
    on ``device``)."""
    if plan.kind == "reverb":
        return reverberate(x, rirs[plan.rir_idx], device)
    rng = np.random.default_rng(plan.offset_seed)
    pool = noises[plan.kind]
    if plan.kind == "babble":
        return mix_babble(x, [pool[i] for i in plan.noise_idxs], plan.snr, rng)
    return mix_noise(x, pool[plan.noise_idxs[0]], plan.snr, rng)


def _aug_utterances(dataset: Dataset, plans: Sequence[AugPlan]) -> List[Utterance]:
    by_utt = {u.utt_id: u for u in dataset}
    return [
        by_utt[p.utt_id].replace(
            utt_id=p.aug_id,
            wav=f"aug:{p.aug_id}",
            uniq_id=by_utt[p.utt_id].uniq_id or p.utt_id,
        )
        for p in plans
    ]


def augment_dataset(
    dataset: Dataset,
    audio: Mapping[str, np.ndarray],
    rirs: Sequence[np.ndarray] = (),
    noises: Mapping[str, Sequence[np.ndarray]] = {},
    specs: Sequence[AugmentSpec] = REFERENCE_AUGMENTS,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> Tuple[Dataset, Dict[str, np.ndarray]]:
    """Create one augmented copy per utterance per applicable spec.

    ``noises`` maps kind ('noise'/'music'/'babble') to sample pools.
    Returns (augmented-only dataset, augmented audio).  Combine with the
    clean set via ``dataset.combine`` like `run_sre10.sh:155-159`.
    (Eager form; `lazy_augment_dataset` realizes the same plans
    on access for corpora that don't fit RAM.)
    """
    dev = resolve_device(device)
    plans = plan_augments(dataset, rirs, noises, specs, seed)
    new_audio = {
        p.aug_id: apply_augment(p, audio[p.utt_id], rirs, noises, dev)
        for p in plans
    }
    return Dataset(_aug_utterances(dataset, plans), f"{dataset.name}_aug"), new_audio


class LazyAugmentAudio(Mapping):
    """Decode/realize-on-access augmented audio: ``aug_id ->`` samples.

    Holds only the draw table; each access pulls the clean signal from
    ``base`` (itself possibly a `data.audio.LazyAudio`) and applies the
    planned transform — identical to `augment_dataset`'s eager output on
    the same device (per-copy offset seeds make realization order
    irrelevant).  Duck-types the two corpus-scale probes the pipeline
    uses: `num_samples` (augmentation preserves length) and
    `manifest_fingerprint` (base fingerprint + plan digest).
    """

    def __init__(self, base: Mapping[str, np.ndarray],
                 plans: Sequence[AugPlan],
                 rirs: Sequence[np.ndarray],
                 noises: Mapping[str, Sequence[np.ndarray]],
                 device: DeviceLike = "cuda"):
        self._base = base
        self._plans = {p.aug_id: p for p in plans}
        self._rirs = rirs
        self._noises = noises
        self._device = resolve_device(device)

    def __getitem__(self, aug_id: str) -> np.ndarray:
        p = self._plans[aug_id]
        return apply_augment(p, np.asarray(self._base[p.utt_id]),
                             self._rirs, self._noises, self._device)

    def __iter__(self):
        return iter(self._plans)

    def __len__(self):
        return len(self._plans)

    def __contains__(self, aug_id):
        return aug_id in self._plans

    def num_samples(self, aug_id: str) -> int:
        p = self._plans[aug_id]
        if hasattr(self._base, "num_samples"):
            return self._base.num_samples(p.utt_id)
        return len(self._base[p.utt_id])

    def subset(self, keep) -> "LazyAugmentAudio":
        """Restrict to a set of aug ids (the 128k-subset stage)."""
        return LazyAugmentAudio(
            self._base,
            [p for a, p in self._plans.items() if a in keep],
            self._rirs, self._noises, self._device,
        )

    def manifest_fingerprint(self) -> str:
        import hashlib

        h = hashlib.sha1()
        if hasattr(self._base, "manifest_fingerprint"):
            h.update(self._base.manifest_fingerprint().encode())
        else:
            h.update(f"base-dict-{len(self._base)}".encode())
        for aug_id in sorted(self._plans):
            p = self._plans[aug_id]
            h.update(repr((p.utt_id, p.aug_id, p.kind, p.snr, p.rir_idx,
                           p.noise_idxs, p.offset_seed)).encode())
        # pool identity: sizes + strided probes (pools are small relative
        # to the corpus — RIRS_NOISES/MUSAN samples — so probing is cheap)
        for name, pool in [("rirs", self._rirs)] + sorted(self._noises.items()):
            h.update(name.encode())
            for arr in pool:
                a = np.asarray(arr)
                h.update(np.int64(a.shape[0]).tobytes())
                h.update(np.asarray(a[:: max(1, len(a) // 64)], np.float32).tobytes())
        return h.hexdigest()


def lazy_augment_dataset(
    dataset: Dataset,
    audio: Mapping[str, np.ndarray],
    rirs: Sequence[np.ndarray] = (),
    noises: Mapping[str, Sequence[np.ndarray]] = {},
    specs: Sequence[AugmentSpec] = REFERENCE_AUGMENTS,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> Tuple[Dataset, LazyAugmentAudio]:
    """`augment_dataset` without materializing any audio: returns the
    augmented-only manifest plus a realize-on-access Mapping (same plans,
    same samples)."""
    plans = plan_augments(dataset, rirs, noises, specs, seed)
    return (
        Dataset(_aug_utterances(dataset, plans), f"{dataset.name}_aug"),
        LazyAugmentAudio(audio, plans, rirs, noises, device),
    )


def synthetic_rir(
    sample_rate: int = 8000,
    rt60: float = 0.3,
    length: float = 0.25,
    direct_delay: float = 0.01,
    seed: int = 0,
) -> np.ndarray:
    """Exponentially-decaying noise RIR (for tests / RIRS_NOISES-free runs)."""
    rng = np.random.default_rng(seed)
    n = int(length * sample_rate)
    t = np.arange(n) / sample_rate
    tail = rng.standard_normal(n) * np.exp(-6.9 * t / rt60)
    d = int(direct_delay * sample_rate)
    rir = 0.3 * tail
    rir[d] += 1.0
    return rir.astype(np.float32)
