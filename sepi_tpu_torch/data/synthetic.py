"""Synthetic multi-speaker corpus for tests and the chip smoke run.

A copy of `sepi_tpu/data/synthetic.py:make_synthetic_corpus` and its two
helpers: speakers with distinct, stable spectral signatures (a random
source-filter voice per speaker, pitch jitter per utterance), made from
a numpy seed, so the same call gives the same audio in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from .manifest import Dataset, Trial, Utterance


@dataclasses.dataclass
class SyntheticCorpus:
    dataset: Dataset
    audio: Dict[str, np.ndarray]  # utt_id -> float32 samples
    sample_rate: int
    trials: List[Trial]

    def samples(self, utt_id: str) -> np.ndarray:
        return self.audio[utt_id]


def _speaker_filter(rng: np.random.Generator, sample_rate: int) -> np.ndarray:
    """A random 64-tap FIR 'vocal tract' giving the speaker its timbre."""
    n_form = 3
    freqs = rng.uniform(300, min(3400, sample_rate / 2 - 200), size=n_form)
    bws = rng.uniform(80, 250, size=n_form)
    t = np.arange(64) / sample_rate
    h = np.zeros(64)
    for f, bw in zip(freqs, bws):
        h += np.exp(-np.pi * bw * t) * np.cos(2 * np.pi * f * t)
    return (h / np.max(np.abs(h))).astype(np.float32)


def _utterance(
    rng: np.random.Generator, h: np.ndarray, num_samples: int, sample_rate: int
) -> np.ndarray:
    """Pitch-pulsed excitation through the speaker filter + noise."""
    f0 = rng.uniform(80, 260)
    period = max(int(sample_rate / f0), 8)
    exc = np.zeros(num_samples, dtype=np.float32)
    exc[::period] = 1.0
    exc += 0.05 * rng.standard_normal(num_samples).astype(np.float32)
    x = np.convolve(exc, h, mode="same")
    # amplitude modulation: alternating "speech" and low-energy "silence"
    t = np.arange(num_samples)
    seg = ((t // (sample_rate // 2)) % 3) != 2  # 1s on, 0.5s near-silent
    x = x * np.where(seg, 1.0, 0.02).astype(np.float32)
    x = x / (np.std(x) + 1e-8)
    return (x * 8000.0).astype(np.float32)  # int16-ish scale, like wav input


def make_synthetic_corpus(
    num_speakers: int = 8,
    utts_per_speaker: int = 6,
    duration_sec: float = 3.0,
    sample_rate: int = 8000,
    seed: int = 0,
    name: str = "synth",
    duration_jitter: float = 0.3,
) -> SyntheticCorpus:
    rng = np.random.default_rng(seed)
    utts: List[Utterance] = []
    audio: Dict[str, np.ndarray] = {}
    for s in range(num_speakers):
        spk = f"spk{s:03d}"
        h = _speaker_filter(rng, sample_rate)
        for u in range(utts_per_speaker):
            utt_id = f"{spk}-utt{u:03d}"
            dur = duration_sec * (1.0 + duration_jitter * (rng.random() - 0.5))
            n = int(dur * sample_rate)
            audio[utt_id] = _utterance(rng, h, n, sample_rate)
            utts.append(
                Utterance(
                    utt_id=utt_id,
                    spk_id=spk,
                    wav=f"synth:{utt_id}",
                    num_samples=n,
                    sample_rate=sample_rate,
                    duration=n / sample_rate,
                )
            )
    ds = Dataset(utts, name)

    # Trials: first utterance of each speaker enrolls the model; remaining
    # utterances are tests against every model (the SRE trial-list shape).
    trials: List[Trial] = []
    spk2utt = ds.spk2utt
    for model_spk in ds.speakers:
        for test_spk in ds.speakers:
            for test_utt in spk2utt[test_spk][1:]:
                trials.append(Trial(model_spk, test_utt, model_spk == test_spk))
    return SyntheticCorpus(ds, audio, sample_rate, trials)
