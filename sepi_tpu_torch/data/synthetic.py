"""Synthetic multi-speaker corpus for tests and the chip smoke run.

A copy of `sepi_tpu/data/synthetic.py:make_synthetic_corpus` and
`make_phonetic_corpus` with their helpers: speakers with distinct, stable
spectral signatures (a random source-filter voice per speaker, pitch
jitter per utterance) and, for the aligner, utterances built from phone
segments of a fixed lexicon with transcripts.  Both are made from a numpy
seed with the reference's draw order, so the same call gives the same
audio in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..align.mono import Lexicon
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


@dataclasses.dataclass
class PhoneticCorpus:
    """A synthetic corpus with known phone structure: audio + transcripts
    + lexicon, for end-to-end aligner-driven (s5 -> v3/v4/v5) runs."""

    corpus: SyntheticCorpus
    transcripts: Dict[str, List[str]]  # utt_id -> word sequence
    lexicon: Lexicon

    @property
    def dataset(self) -> Dataset:
        return self.corpus.dataset

    @property
    def audio(self) -> Dict[str, np.ndarray]:
        return self.corpus.audio

    @property
    def trials(self) -> List[Trial]:
        return self.corpus.trials


def _phone_filter(freqs, bws, sample_rate: int) -> np.ndarray:
    """64-tap FIR resonator bank — one per phone, shared across speakers."""
    t = np.arange(64) / sample_rate
    h = np.zeros(64)
    for f, bw in zip(freqs, bws):
        h += np.exp(-np.pi * bw * t) * np.cos(2 * np.pi * f * t)
    return (h / np.max(np.abs(h))).astype(np.float32)


def _channel_filter(rng: np.random.Generator, strength: float) -> np.ndarray:
    """Random smooth 16-tap 'handset' FIR mixed with identity at
    ``strength``.  A channel FAMILY (one ``channel_seed``) is one fixed
    base filter drawn from this plus per-utterance jitter — the
    systematic component is what makes two families a real DOMAIN shift
    (an i.i.d. per-utterance filter alone is the same distribution under
    any seed and gives adaptation nothing to correct)."""
    g = rng.standard_normal(16).astype(np.float32)
    # smooth: 3-tap moving average twice, then normalize
    for _ in range(2):
        g = np.convolve(g, np.ones(3, np.float32) / 3.0, mode="same")
    g = g / (np.max(np.abs(g)) + 1e-8)
    h = np.zeros(16, np.float32)
    h[0] = 1.0
    return h + strength * g


def make_phonetic_corpus(
    num_speakers: int = 6,
    utts_per_speaker: int = 5,
    sample_rate: int = 8000,
    seed: int = 0,
    name: str = "synth_phone",
    words_per_utt: Tuple[int, int] = (2, 4),
    phone_ms: Tuple[int, int] = (90, 160),
    sil_ms: Tuple[int, int] = (120, 280),
    speaker_strength: float = 0.25,
    f0_jitter: float = 0.0,
    noise_snr_db: Optional[Tuple[float, float]] = None,
    channel_strength: float = 0.0,
    channel_seed: Optional[int] = None,
    phone_seed: Optional[int] = None,
    spk_prefix: str = "spk",
):
    """Synthetic corpus whose utterances are word sequences of phone
    segments with known acoustics (the s5 conformance world).

    Each phone is a fixed formant filter shared across speakers; each
    speaker adds its own pitch and a mild spectral-tilt filter on top, so
    both phone identity (for the aligner) and speaker identity (for the
    embedding) are recoverable from MFCCs.  Inter-word gaps are low-energy
    silence, exercising the optional-silence arcs of the alignment graph
    and the VAD strip / select-voiced-ali invariant downstream.

    Hardness knobs (the non-degenerate gauntlet; defaults preserve the
    original easy corpus):
      speaker_strength: how much of the speaker's spectral-tilt filter is
        mixed in (0.25 = easy; ~0.1 overlaps speakers enough that EER is
        measurable).
      f0_jitter: per-UTTERANCE relative pitch jitter around the speaker's
        mean f0 (pitch stops being a free speaker giveaway).
      noise_snr_db: (lo, hi) — each utterance gets white noise at an SNR
        drawn uniformly from this range (measured on the speech segments).
      channel_strength / channel_seed: per-utterance random smooth FIR
        'handset' at this strength; the seed selects the channel FAMILY,
        so corpora built with different channel_seed values are
        domain-shifted relative to each other (the SRE16 adaptation
        scenario).
      phone_seed: when given, the phone-filter inventory comes from its
        own rng stream — corpora built with different ``seed`` but the
        same ``phone_seed`` share one 'language' (disjoint-speaker
        train/eval gauntlets).  Default (None) keeps the inventory on the
        main stream, byte-identical to the original generator.
      spk_prefix: speaker-id prefix, so multiple corpora can coexist
        without utt-id collisions.
    """
    rng = np.random.default_rng(seed)
    chan_rng = np.random.default_rng(
        seed + 7919 if channel_seed is None else channel_seed
    )
    phone_rng = rng if phone_seed is None else np.random.default_rng(phone_seed)
    # The channel family's SYSTEMATIC component: one base filter per
    # corpus (per channel_seed); utterances add jitter at 1/3 strength.
    chan_base = (
        _channel_filter(chan_rng, channel_strength)
        if channel_strength > 0.0 else None
    )
    # Phone inventory: distinct formant pairs spread over the band.
    phone_names = ["aa", "ee", "oo", "kk", "ss", "tt", "mm", "rr"]
    filters = {}
    for i, p in enumerate(phone_names):
        f1 = 350 + 380 * i + phone_rng.uniform(-40, 40)
        f2 = 3400 - 330 * i + phone_rng.uniform(-40, 40)
        filters[p] = _phone_filter([f1, f2], [120.0, 160.0], sample_rate)
    pron = {
        "bab": ["aa", "kk", "aa"],
        "dee": ["ee", "tt"],
        "moo": ["mm", "oo"],
        "sore": ["ss", "oo", "rr"],
        "keet": ["kk", "ee", "tt"],
        "rass": ["rr", "aa", "ss"],
    }
    lexicon = Lexicon.from_dict(pron)

    utts: List[Utterance] = []
    audio: Dict[str, np.ndarray] = {}
    transcripts: Dict[str, List[str]] = {}
    word_list = sorted(pron)
    for s in range(num_speakers):
        spk = f"{spk_prefix}{s:03d}"
        f0 = rng.uniform(90, 240)
        spk_h = _speaker_filter(rng, sample_rate)
        for u in range(utts_per_speaker):
            utt_id = f"{spk}-utt{u:03d}"
            n_words = int(rng.integers(words_per_utt[0], words_per_utt[1] + 1))
            words = [word_list[int(rng.integers(len(word_list)))] for _ in range(n_words)]
            segs: List[np.ndarray] = []

            def sil_seg():
                n = int(rng.integers(*sil_ms) * sample_rate // 1000)
                # quiet enough that the energy VAD marks it unvoiced
                return 0.003 * rng.standard_normal(n).astype(np.float32)

            segs.append(sil_seg())
            # guard the draw: rng-stream compatibility for jitter-free
            # corpora (an unconditional draw would shift every later draw)
            f0_utt = (
                f0 * (1.0 + f0_jitter * float(rng.uniform(-1.0, 1.0)))
                if f0_jitter > 0.0 else f0
            )
            period = max(int(sample_rate / f0_utt), 8)
            spk_mix = speaker_strength * spk_h + (1.0 - speaker_strength) * _DELTA64
            for wi, w in enumerate(words):
                for p in pron[w]:
                    n = int(rng.integers(*phone_ms) * sample_rate // 1000)
                    exc = np.zeros(n, np.float32)
                    exc[::period] = 1.0
                    exc += 0.05 * rng.standard_normal(n).astype(np.float32)
                    x = np.convolve(exc, filters[p], mode="same")
                    x = np.convolve(x, spk_mix, mode="same")
                    segs.append(x.astype(np.float32))
                if wi < len(words) - 1 and rng.random() < 0.7:
                    segs.append(sil_seg())
            segs.append(sil_seg())
            x = np.concatenate(segs)
            if chan_base is not None:
                h_utt = np.convolve(
                    chan_base,
                    _channel_filter(chan_rng, channel_strength / 3.0),
                )
                x = np.convolve(x, h_utt, mode="same").astype(np.float32)
            if noise_snr_db is not None:
                snr = float(rng.uniform(*noise_snr_db))
                sig_p = float(np.mean(np.square(x))) + 1e-12
                noise_std = np.sqrt(sig_p / (10.0 ** (snr / 10.0)))
                x = x + noise_std * rng.standard_normal(len(x)).astype(np.float32)
            x = x / (np.std(x) + 1e-8) * 8000.0
            audio[utt_id] = x.astype(np.float32)
            transcripts[utt_id] = words
            utts.append(
                Utterance(
                    utt_id=utt_id,
                    spk_id=spk,
                    wav=f"synth:{utt_id}",
                    num_samples=len(x),
                    sample_rate=sample_rate,
                    duration=len(x) / sample_rate,
                )
            )
    ds = Dataset(utts, name)
    trials: List[Trial] = []
    spk2utt = ds.spk2utt
    for model_spk in ds.speakers:
        for test_spk in ds.speakers:
            for test_utt in spk2utt[test_spk][1:]:
                trials.append(Trial(model_spk, test_utt, model_spk == test_spk))
    return PhoneticCorpus(SyntheticCorpus(ds, audio, sample_rate, trials), transcripts, lexicon)


# identity kernel used to mix the speaker filter at partial strength
_DELTA64 = np.zeros(64, np.float32)
_DELTA64[0] = 1.0
