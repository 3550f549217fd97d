"""Synthetic multi-speaker corpus for tests and the chip smoke run.

A copy of `sepi_tpu/data/synthetic.py:make_synthetic_corpus`,
`make_phonetic_corpus` and `make_phonetic_corpus_v2` with their helpers: speakers with distinct, stable
spectral signatures (a random source-filter voice per speaker, pitch
jitter per utterance) and, for the aligner, utterances built from phone
segments of a fixed lexicon with transcripts; corpus v2 carries speaker
identity in how each speaker realizes each phone (a vocal-tract warp,
per-phone offsets, prosody) rather than in a stationary filter.  Each is
made from a numpy seed with the reference's draw order, so the same call
gives the same audio in both packages.
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


# ===========================================================================
# Corpus v2: phonetically realistic synthesis (VERDICT r4 item 1)
# ===========================================================================
#
# The v1 generator encodes speaker identity as a STATIONARY spectral-tilt
# filter applied identically to every phone — exactly a GMM supervector's
# sweet spot — and its 2-3-word utterances starve stats pooling, so the
# r4 hardware gauntlet ranked v1 GMM/i-vector above every neural system,
# inverting the field's basic SRE10 result.  Here speaker identity is
# NON-STATIONARY, carried by how each speaker realizes each phone:
#
#   - a vocal-tract-length warp (one multiplicative alpha on all formant
#     targets: the anatomical component);
#   - per-speaker PER-PHONE articulation offsets (idiolect: speaker A's
#     "ee" is fronted, their "oo" rounded differently — recoverable only
#     phone-conditionally, the mechanism the c-vector paper exploits);
#   - per-speaker bandwidth scale and f0 distribution (mean + range),
#     with per-utterance prosody (declination + accent bumps) so pitch
#     is informative but not a constant giveaway;
#   - only a WEAK stationary tilt (knob, default near zero).
#
# Realization is a frame-based source-filter vocoder: per-frame formant
# targets from the phone sequence, SMOOTHED across boundaries
# (coarticulation — no piecewise-stationary per-phone filtering), pitch
# contour via phase accumulation, voiced/noise excitation mixing, and
# overlap-add synthesis through per-frame resonator spectra.  Utterance
# lengths mix short and long (stats pooling needs length; the reference
# trains on 2-4 s chunks of much longer recordings).

# Formant targets (F1, F2, F3) Hz — vowel space spread for an 8 kHz band.
_V2_VOWELS = {
    "aa": (730, 1090, 2440), "ae": (660, 1720, 2410),
    "ah": (620, 1220, 2550), "ee": (270, 2290, 3010),
    "eh": (530, 1840, 2480), "ih": (390, 1990, 2550),
    "oo": (300, 870, 2240), "uh": (450, 1030, 2380),
}
# Sonorant consonants: formant-structured, voiced, lower amplitude.
_V2_SONORANTS = {
    "mm": (280, 900, 2200), "nn": (320, 1500, 2500),
    "rr": (420, 1300, 1700), "ll": (380, 1100, 2780),
}
# Fricatives: noise-excited with a spectral bump (center, bandwidth) Hz.
_V2_FRICS = {
    "ss": (3300, 700), "sh": (2400, 800), "ff": (1300, 1300), "hh": (900, 1600),
}
_V2_PHONES = list(_V2_VOWELS) + list(_V2_SONORANTS) + list(_V2_FRICS)

# 24-word lexicon over the 16 phones, 2-4 phones per word; drawn with a
# Zipf-ish weight so utterance phone COMPOSITION varies a lot (blind
# pooled stats are biased by composition; phone-aware nets normalize it).
_V2_PRON = {
    "base": ["ss", "ee", "ss"], "mare": ["mm", "ae", "rr"],
    "nole": ["nn", "oo", "ll"], "fesh": ["ff", "eh", "sh"],
    "halo": ["hh", "aa", "ll", "oo"], "rema": ["rr", "ee", "mm", "ah"],
    "shoon": ["sh", "oo", "nn"], "sila": ["ss", "ih", "ll", "aa"],
    "fahm": ["ff", "ah", "mm"], "leesh": ["ll", "ee", "sh"],
    "nuhr": ["nn", "uh", "rr"], "hassa": ["hh", "ae", "ss", "ah"],
    "moosh": ["mm", "oo", "sh"], "rife": ["rr", "ih", "ff"],
    "sheel": ["sh", "ee", "ll"], "naham": ["nn", "ah", "hh", "ae", "mm"],
    "lore": ["ll", "oo", "rr"], "seef": ["ss", "ee", "ff"],
    "huhn": ["hh", "uh", "nn"], "masha": ["mm", "ae", "sh", "aa"],
    "reno": ["rr", "eh", "nn", "oo"], "fihl": ["ff", "ih", "ll"],
    "soom": ["ss", "oo", "mm"], "hehr": ["hh", "eh", "rr"],
}


def _v2_frame_params(
    phones: List[str],
    phone_frames: List[int],
    targets: Dict[str, Tuple[float, float, float]],
    smooth: int,
):
    """Per-frame (formants (T,3), voicing (T,), amplitude (T,), fric (T,4))
    tracks from a phone segmentation, coarticulated by moving-average
    smoothing across phone boundaries.  ``fric`` rows carry (is_fric,
    center, bw, _) for noise shaping."""
    f_rows, v_rows, a_rows, fr_rows = [], [], [], []
    for p, n in zip(phones, phone_frames):
        if p == "_sil":
            f = targets["aa"]  # irrelevant at zero amplitude
            v, a, fr = 0.0, 0.0, (0.0, 0.0, 1.0, 0.0)
        elif p in _V2_FRICS:
            c, bw = targets[p][:2]
            f = (500.0, 1500.0, 2500.0)
            v, a, fr = 0.0, 0.5, (1.0, c, bw, 0.0)
        else:
            f = targets[p]
            v = 1.0
            a = 1.0 if p in _V2_VOWELS else 0.65
            fr = (0.0, 0.0, 1.0, 0.0)
        f_rows += [f] * n
        v_rows += [v] * n
        a_rows += [a] * n
        fr_rows += [fr] * n
    F = np.asarray(f_rows, np.float64)
    V = np.asarray(v_rows, np.float64)
    A = np.asarray(a_rows, np.float64)
    FR = np.asarray(fr_rows, np.float64)
    if smooth > 1:
        k = np.ones(smooth) / smooth
        pad = smooth // 2
        def ma(x):
            if x.ndim == 1:
                return np.convolve(np.pad(x, (pad, pad), mode="edge"), k, "valid")[: len(x)]
            return np.stack([ma(x[:, i]) for i in range(x.shape[1])], 1)
        F, V, A = ma(F), ma(V), ma(A)
        FR = np.stack([ma(FR[:, i]) for i in range(FR.shape[1])], 1)
    return F, V, A, FR


def _v2_synthesize(
    rng: np.random.Generator,
    F: np.ndarray,  # (T, 3) per-frame formant targets
    V: np.ndarray,  # (T,) voicing
    A: np.ndarray,  # (T,) amplitude
    FR: np.ndarray,  # (T, 4) fricative (flag, center, bw, _)
    f0_frames: np.ndarray,  # (T,)
    bws: np.ndarray,  # (3,) formant bandwidths
    sample_rate: int,
    hop: int = 64,
    win: int = 128,
    nfft: int = 256,
) -> np.ndarray:
    """Overlap-add source-filter synthesis with per-frame spectra."""
    T = F.shape[0]
    n = T * hop + win
    # --- excitation: pulse train by phase accumulation + aspiration noise
    f0_s = np.repeat(f0_frames, hop)[:n]
    if len(f0_s) < n:
        f0_s = np.pad(f0_s, (0, n - len(f0_s)), mode="edge")
    phase = np.cumsum(f0_s / sample_rate)
    pulses = np.zeros(n)
    marks = np.searchsorted(phase, np.arange(1, int(phase[-1]) + 1))
    pulses[np.clip(marks, 0, n - 1)] = 1.0
    noise = rng.standard_normal(n)
    v_s = np.repeat(V, hop)[:n]
    if len(v_s) < n:
        v_s = np.pad(v_s, (0, n - len(v_s)), mode="edge")
    exc = pulses * v_s + noise * (0.06 + 0.9 * (1.0 - v_s))
    # --- per-frame spectral envelopes
    freqs = np.fft.rfftfreq(nfft, 1.0 / sample_rate)  # (B,)
    z = np.exp(-2j * np.pi * freqs / sample_rate)  # (B,)
    H = np.ones((T, freqs.shape[0]), np.complex128)
    for i in range(3):
        r = np.exp(-np.pi * bws[i] / sample_rate)
        theta = 2 * np.pi * F[:, i] / sample_rate  # (T,)
        poles = (1 - 2 * r * np.cos(theta[:, None]) * z[None, :]
                 + (r * r) * (z * z)[None, :])
        H = H / poles
    env = np.abs(H)
    # fricative bump replaces the resonator envelope where FR flags it
    fric_env = np.exp(-0.5 * ((freqs[None, :] - FR[:, 1:2]) / FR[:, 2:3]) ** 2) + 0.05
    w_fric = FR[:, 0:1]
    env = env * (1.0 - w_fric) + 12.0 * fric_env * w_fric
    # mild glottal rolloff keeps energy speech-shaped
    env = env * (1.0 / (1.0 + (freqs[None, :] / 2500.0) ** 2)) ** 0.5
    # --- OLA
    window = np.hanning(win)
    frames = np.zeros((T, win))
    for t in range(T):  # gather is cheap; synthesis cost is the FFTs
        frames[t] = exc[t * hop : t * hop + win]
    spec = np.fft.rfft(frames * window[None, :], nfft)
    shaped = np.fft.irfft(spec * env, nfft)[:, :win]
    shaped *= (A[:, None] * window[None, :])
    out = np.zeros(n)
    for t in range(T):
        out[t * hop : t * hop + win] += shaped[t]
    return out[: T * hop]


def make_phonetic_corpus_v2(
    num_speakers: int = 6,
    utts_per_speaker: int = 5,
    sample_rate: int = 8000,
    seed: int = 0,
    name: str = "synth_phone2",
    words_per_utt: Tuple[int, int] = (3, 7),
    long_utt_frac: float = 0.25,
    long_words_per_utt: Tuple[int, int] = (16, 28),
    phone_ms: Tuple[int, int] = (60, 140),
    sil_ms: Tuple[int, int] = (100, 260),
    vtl_range: Tuple[float, float] = (0.88, 1.12),
    phone_offset_std: float = 0.035,
    tilt_strength: float = 0.06,
    f0_jitter: float = 0.12,
    noise_snr_db: Optional[Tuple[float, float]] = None,
    channel_strength: float = 0.0,
    channel_seed: Optional[int] = None,
    phone_seed: Optional[int] = None,
    spk_prefix: str = "spk",
):
    """Phonetically realistic synthetic corpus (gauntlet corpus v2).

    Speaker identity is non-stationary — VTL warp + per-phone
    articulation offsets + bandwidths + f0 statistics — realized through
    coarticulated formant tracks and prosodic pitch contours (see the
    section comment above for the design rationale and the failure mode
    of the v1 generator it replaces).  API mirrors
    `make_phonetic_corpus`; returns the same `PhoneticCorpus`
    (audio + transcripts + lexicon) so the s5 aligner stage and all
    drivers consume it unchanged.

    Identity knobs:
      vtl_range: speaker vocal-tract warp draw (multiplies all targets).
      phone_offset_std: per-speaker per-phone relative formant offsets —
        the phone-conditional identity component (what phonetic
        variants can exploit and blind pooling cannot).
      tilt_strength: residual STATIONARY spectral-tilt identity (kept
        near zero so supervector models must work for their supper).
      f0_jitter: per-utterance relative jitter of the speaker's mean f0.
    Content knobs:
      long_utt_frac: fraction of utterances drawn long
        (``long_words_per_utt``; ~10 s+ of speech) — the rest use
        ``words_per_utt`` (short, a few seconds).
    Domain knobs (same semantics as the v1 generator):
      noise_snr_db, channel_strength, channel_seed, phone_seed.
    """
    rng = np.random.default_rng(seed)
    chan_rng = np.random.default_rng(
        seed + 7919 if channel_seed is None else channel_seed
    )
    phone_rng = (np.random.default_rng(phone_seed)
                 if phone_seed is not None else rng)
    # language-level target perturbation (per phone_seed): ±2% on every
    # formant so two languages are distinct but share structure
    base_targets: Dict[str, Tuple[float, float, float]] = {}
    for p in _V2_PHONES:
        if p in _V2_FRICS:
            c, bw = _V2_FRICS[p]
            base_targets[p] = (
                c * (1.0 + phone_rng.uniform(-0.02, 0.02)),
                bw * (1.0 + phone_rng.uniform(-0.05, 0.05)),
                0.0,
            )
        else:
            src = _V2_VOWELS.get(p) or _V2_SONORANTS[p]
            base_targets[p] = tuple(
                f * (1.0 + phone_rng.uniform(-0.02, 0.02)) for f in src
            )
    lexicon = Lexicon.from_dict(_V2_PRON)
    word_list = sorted(_V2_PRON)
    # Zipf-ish word weights on the language stream
    w_weights = 1.0 / np.arange(1, len(word_list) + 1) ** 0.8
    w_weights = w_weights / w_weights.sum()

    chan_base = (
        _channel_filter(chan_rng, channel_strength)
        if channel_strength > 0.0 else None
    )
    nyq = sample_rate / 2 - 150
    hop = 64
    frame_s = hop / sample_rate

    utts: List[Utterance] = []
    audio: Dict[str, np.ndarray] = {}
    transcripts: Dict[str, List[str]] = {}
    for s in range(num_speakers):
        spk = f"{spk_prefix}{s:03d}"
        alpha = float(rng.uniform(*vtl_range))
        bw_scale = float(rng.uniform(0.8, 1.25))
        tilt = _speaker_filter(rng, sample_rate)
        f0_mean = float(rng.uniform(90, 230))
        f0_range = float(rng.uniform(0.08, 0.22))  # accent depth
        # per-phone articulation offsets (multiplicative, per formant)
        offsets = {
            p: rng.normal(0.0, phone_offset_std, size=3) for p in _V2_PHONES
        }
        targets: Dict[str, Tuple[float, float, float]] = {}
        for p in _V2_PHONES:
            if p in _V2_FRICS:
                c, bw, _ = base_targets[p]
                targets[p] = (
                    min(c * alpha * (1.0 + offsets[p][0]), nyq),
                    bw * (1.0 + 0.3 * offsets[p][1]),
                    0.0,
                )
            else:
                targets[p] = tuple(
                    min(f * alpha * (1.0 + o), nyq)
                    for f, o in zip(base_targets[p], offsets[p])
                )
        bws = np.array([90.0, 120.0, 180.0]) * bw_scale
        for u in range(utts_per_speaker):
            utt_id = f"{spk}-utt{u:03d}"
            if rng.random() < long_utt_frac:
                n_words = int(rng.integers(*long_words_per_utt))
            else:
                n_words = int(rng.integers(words_per_utt[0], words_per_utt[1] + 1))
            words = [
                word_list[int(i)]
                for i in rng.choice(len(word_list), size=n_words, p=w_weights)
            ]
            # phone segmentation in frames
            phones: List[str] = ["_sil"]
            frames: List[int] = [int(rng.integers(*sil_ms) / 1000 / frame_s)]
            for wi, w in enumerate(words):
                for p in _V2_PRON[w]:
                    ms = rng.integers(*phone_ms)
                    phones.append(p)
                    frames.append(max(int(ms / 1000 / frame_s), 3))
                if wi < len(words) - 1 and rng.random() < 0.35:
                    phones.append("_sil")
                    frames.append(int(rng.integers(*sil_ms) / 1000 / frame_s))
            phones.append("_sil")
            frames.append(int(rng.integers(*sil_ms) / 1000 / frame_s))
            F, V, A, FR = _v2_frame_params(phones, frames, targets, smooth=5)
            T = F.shape[0]
            # prosody: jittered mean, declination, smooth accent bumps
            f0_utt = f0_mean * (1.0 + f0_jitter * float(rng.uniform(-1, 1)))
            t_frames = np.arange(T) / (1.0 / frame_s)  # seconds
            contour = f0_utt * (1.0 - 0.035 * t_frames)
            n_acc = max(1, int(T * frame_s / 1.2))
            acc = np.zeros(T)
            for _ in range(n_acc):
                c0 = rng.uniform(0, T)
                wdt = rng.uniform(8, 25)
                acc += float(rng.uniform(-1, 1)) * np.exp(
                    -0.5 * ((np.arange(T) - c0) / wdt) ** 2)
            contour = np.clip(contour * (1.0 + f0_range * acc), 60.0, 320.0)
            x = _v2_synthesize(rng, F, V, A, FR, contour, bws, sample_rate,
                               hop=hop)
            if tilt_strength > 0.0:
                mix = tilt_strength * tilt + (1.0 - tilt_strength) * _DELTA64
                x = np.convolve(x, mix, mode="same")
            if chan_base is not None:
                h_utt = np.convolve(
                    chan_base, _channel_filter(chan_rng, channel_strength / 3.0))
                x = np.convolve(x, h_utt, mode="same")
            if noise_snr_db is not None:
                snr = float(rng.uniform(*noise_snr_db))
                sig_p = float(np.mean(np.square(x))) + 1e-12
                noise_std = np.sqrt(sig_p / (10.0 ** (snr / 10.0)))
                x = x + noise_std * rng.standard_normal(len(x))
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
    return PhoneticCorpus(
        SyntheticCorpus(ds, audio, sample_rate, trials), transcripts, lexicon
    )
