"""Audio ingest: WAV files + in-memory stores behind one resolver.

Replaces the reference's wav.scp command-pipeline convention (sph2pipe
shell pipes resolved lazily by Kaldi table I/O — `local/make_sre.pl`).
Pipelines-as-data-sources are replaced by a typed resolver: an
`Utterance.wav` field is either

  - a filesystem path to a PCM WAV ("/data/x.wav"),
  - an in-memory store key ("synth:utt1", "aug:utt1-noise"),
  - or a registered custom scheme ("mystore:key").

Samples are float32 at int16 scale (Kaldi's convention — its feature
configs, e.g. dither=1.0 and the VAD energy threshold, assume it).

A copy of `sepi_tpu/data/audio.py`; SPHERE decoding goes through the
port's own binding of `native/sphere.cc` (`utils/sphere.py`).  The
fingerprints hash the same bytes in the same order, so both packages key
their stage caches by the same strings.
"""

from __future__ import annotations

import os
import wave
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from .manifest import Dataset


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 samples at int16 scale, rate).

    Multi-channel audio is downmixed by taking channel 0 (the recipes
    split telephone channels at manifest level, e.g. `make_sre.pl`)."""
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        sw = w.getsampwidth()
        ch = w.getnchannels()
        rate = w.getframerate()
        raw = w.readframes(n)
    if sw == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    elif sw == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 65536.0
    elif sw == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) * 256.0
    else:
        raise ValueError(f"{path}: unsupported sample width {sw}")
    if ch > 1:
        x = x.reshape(-1, ch)[:, 0].copy()
    return x, rate


def read_audio(path: str, channel: int = 1) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV or NIST SPHERE file by extension.

    SPHERE (.sph) covers the LDC corpora the reference ingests through
    `sph2pipe` pipes (local/make_sre.pl); decoding — including
    embedded-shorten payloads — is native (native/sphere.cc).
    ``channel`` is 1-based and only meaningful for SPHERE."""
    if path.lower().endswith(".sph"):
        from ..utils.sphere import read_sph

        return read_sph(path, channel)
    return read_wav(path)


def write_wav(path: str, samples: np.ndarray, rate: int) -> None:
    x = np.round(np.clip(np.asarray(samples), -32768, 32767)).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(x.tobytes())


class AudioStore:
    """Resolves Utterance.wav references to sample arrays.

    In-memory pools are registered per scheme; bare paths hit the
    filesystem.  Results are optionally cached (small corpora / tests).
    """

    def __init__(self, cache: bool = False):
        self._schemes: Dict[str, Mapping[str, np.ndarray]] = {}
        self._loaders: Dict[str, Callable[[str], np.ndarray]] = {}
        self._cache: Optional[Dict[str, np.ndarray]] = {} if cache else None

    def register_pool(self, scheme: str, pool: Mapping[str, np.ndarray]) -> None:
        self._schemes[scheme] = pool

    def register_loader(self, scheme: str, fn: Callable[[str], np.ndarray]) -> None:
        self._loaders[scheme] = fn

    def load(self, ref: str, expect_rate: Optional[int] = None,
             channel: int = 1) -> np.ndarray:
        if self._cache is not None and channel == 1 and ref in self._cache:
            return self._cache[ref]
        if ":" in ref and not ref[1:3] == ":\\":
            scheme, key = ref.split(":", 1)
            if scheme in self._schemes:
                x = np.asarray(self._schemes[scheme][key], np.float32)
            elif scheme in self._loaders:
                x = np.asarray(self._loaders[scheme](key), np.float32)
            else:
                raise KeyError(f"unregistered audio scheme {scheme!r} in {ref!r}")
        else:
            x, rate = read_audio(ref, channel)
            if expect_rate is not None and rate != expect_rate:
                raise ValueError(f"{ref}: rate {rate} != expected {expect_rate}")
        if self._cache is not None and channel == 1:
            self._cache[ref] = x
        return x

    def load_utterance(self, u) -> np.ndarray:
        """Resolve one manifest row, honoring its channel/codec meta (the
        LDC walkers mark 2-channel SPHERE sides with ("channel", "2"))."""
        return self.load(
            u.wav, u.sample_rate, channel=int(u.get_meta("channel", "1"))
        )

    def load_dataset(self, dataset: Dataset) -> Dict[str, np.ndarray]:
        return {
            u.utt_id: self.load_utterance(u)
            for u in dataset
            if u.wav is not None
        }

    def lazy_dataset(self, dataset: Dataset) -> "LazyAudio":
        """Corpus-scale view: decode-on-access Mapping over the manifest.

        Use instead of `load_dataset` when the corpus doesn't fit RAM;
        the drivers' feature stages consume it one batch at a time and
        key their caches on its `manifest_fingerprint()` (no decoding
        needed to decide a cache hit)."""
        return LazyAudio(self, dataset)


#: bump when any decoder's output could change for identical source bytes
#: (read_wav/read_sph/scheme loaders) — part of every manifest fingerprint
#: so stale cached features can't be reused across decoder revisions.
_DECODER_VERSION = 1


class LazyAudio(Mapping):
    """Decode-on-access utt -> samples view over (AudioStore, Dataset).

    The corpus-scale replacement for a decoded-audio dict: the drivers'
    feature stages read it one length-bucketed batch at a time, so only
    ~batch_size signals are ever resident (SURVEY.md §7: the reference
    streams everything from disk — `prepare_feats_for_egs.sh`).

    Two extra capabilities over a plain Mapping, both duck-typed by the
    pipeline:

    - ``num_samples(utt)``: header-only length probe (WAV/SPHERE header
      fields; in-memory pools by len) for length-bucket sorting without
      decoding.  Scheme *loaders* have no headers: those decode once and
      cache only the length.
    - ``manifest_fingerprint()``: a cache key from manifest metadata
      (utt ids, wav refs, channel/segment fields, file size+mtime,
      decoder version) costing zero decodes — replacing the full-decode
      content hash that made cache HITS cost a corpus pass
      (`recipes.drivers._audio_fingerprint`).
    """

    def __init__(self, store: AudioStore, dataset: Dataset):
        self._store = store
        self._utts = {
            u.utt_id: u for u in dataset if u.wav is not None
        }
        self._lengths: Dict[str, int] = {}

    # -- Mapping --
    def __getitem__(self, utt: str) -> np.ndarray:
        return self._store.load_utterance(self._utts[utt])

    def __iter__(self):
        return iter(self._utts)

    def __len__(self):
        return len(self._utts)

    def __contains__(self, utt):
        return utt in self._utts

    # -- cheap probes --
    def num_samples(self, utt: str) -> int:
        if utt in self._lengths:
            return self._lengths[utt]
        u = self._utts[utt]
        if getattr(u, "num_samples", None):  # manifest field: free
            self._lengths[utt] = int(u.num_samples)
            return int(u.num_samples)
        ref = u.wav
        n: Optional[int] = None
        if ":" in ref and not ref[1:3] == ":\\":
            scheme, key = ref.split(":", 1)
            pool = self._store._schemes.get(scheme)
            if pool is not None:
                n = len(pool[key])
        elif ref.lower().endswith(".sph"):
            from ..utils.sphere import sph_info

            n = sph_info(ref)[2]
        else:
            with wave.open(ref, "rb") as w:
                n = w.getnframes()
        if n is None:  # scheme loader: decode once, keep only the length
            n = len(self[utt])
        self._lengths[utt] = int(n)
        return int(n)

    def manifest_fingerprint(self) -> str:
        """Digest of manifest-level identity — no audio decoding.

        File-backed refs contribute (path, size, mtime_ns): an edited
        file changes the digest; in-memory pool refs contribute their
        array length (pools are deterministic per scheme registration —
        callers re-registering different audio under the same scheme and
        lengths should use the drivers' ``content_hash`` opt-in).
        """
        import hashlib

        h = hashlib.sha1()
        h.update(f"decoder-v{_DECODER_VERSION}".encode())
        for utt in sorted(self._utts):
            u = self._utts[utt]
            h.update(utt.encode())
            h.update(str(u.wav).encode())
            h.update(str(u.get_meta("channel", "1")).encode())
            h.update(f"{u.start}-{u.end}".encode())
            ref = u.wav
            if ":" in ref and not ref[1:3] == ":\\":
                h.update(str(self.num_samples(utt)).encode())
            else:
                st = os.stat(ref)
                h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
        return h.hexdigest()


def content_fingerprint(audio: Mapping[str, np.ndarray]) -> str:
    """Content digest of a decoded-audio mapping (forces a full pass —
    use `LazyAudio.manifest_fingerprint` for corpus-scale caches).
    Hashes per-utterance length, a ~256-point strided sample spanning
    the whole signal, and the full-signal sum (edits anywhere in the
    buffer perturb the strided probe even when they preserve the sum)."""
    import hashlib

    h = hashlib.sha1()
    for u in sorted(audio):
        x = np.asarray(audio[u])
        h.update(u.encode())
        h.update(np.int64(x.shape[0]).tobytes())
        h.update(np.asarray(x[:: max(1, len(x) // 256)], np.float32).tobytes())
        h.update(np.float64(x.sum()).tobytes())
    return h.hexdigest()


class ChainAudio(Mapping):
    """Lazy union of audio mappings (first match wins) — the
    ``{**clean, **augmented}`` replacement that doesn't materialize lazy
    members.  Forwards the corpus-scale probes: `num_samples` per
    member, `manifest_fingerprint` as a digest of each member's own
    fingerprint (content fingerprint for plain dict members, which are
    in RAM anyway)."""

    def __init__(self, *maps: Mapping[str, np.ndarray]):
        self._maps = maps

    def __getitem__(self, k):
        for m in self._maps:
            if k in m:
                return m[k]
        raise KeyError(k)

    def __iter__(self):
        seen = set()
        for m in self._maps:
            for k in m:
                if k not in seen:
                    seen.add(k)
                    yield k

    def __len__(self):
        return len(set().union(*self._maps))

    def __contains__(self, k):
        return any(k in m for m in self._maps)

    def num_samples(self, k: str) -> int:
        for m in self._maps:
            if k in m:
                if hasattr(m, "num_samples"):
                    return m.num_samples(k)
                return len(m[k])
        raise KeyError(k)

    def manifest_fingerprint(self) -> str:
        import hashlib

        h = hashlib.sha1()
        for m in self._maps:
            if hasattr(m, "manifest_fingerprint"):
                h.update(m.manifest_fingerprint().encode())
            else:
                h.update(content_fingerprint(m).encode())
        return h.hexdigest()


def extract_segments(
    recordings,
    dataset,
    sample_rate: int,
    min_segment_length: float = 0.1,
    max_overshoot: float = 0.5,
    strict: bool = False,
    log=None,
):
    """Crop recording audio into per-utterance segments — the
    `extract-segments` binary's semantics on in-memory arrays.

    Args:
      recordings: recording_id -> (N,) samples (the wav.scp payloads).
      dataset: manifest whose utterances carry (recording, start, end);
        rows without segment info pass through via their own wav/utt id.
      sample_rate: Hz of the recordings.
      min_segment_length: segments shorter than this many seconds are
        skipped with a warning-by-omission (Kaldi --min-segment-length).
      max_overshoot: how far (s) ``end`` may exceed the recording before
        the row is rejected; within tolerance it is clamped
        (Kaldi --max-overshoot).
      strict: when False (default, matching extract-segments), a row
        with a missing recording or over-overshoot end is warned about
        and skipped so one malformed segments row cannot abort the
        corpus load; when True such rows raise.
      log: optional callable for skip warnings (default: print).
    Returns: utt_id -> samples.
    """
    warn = log or print
    out = {}
    skipped = 0
    for u in dataset:
        if u.start is None and u.end is None:
            key = u.recording or u.utt_id
            if key in recordings:
                out[u.utt_id] = recordings[key]
            continue
        rec = u.recording or u.wav
        if rec not in recordings:
            if strict:
                raise KeyError(f"{u.utt_id}: recording {rec!r} not supplied")
            warn(f"extract_segments: skipping {u.utt_id}: recording "
                 f"{rec!r} not supplied")
            skipped += 1
            continue
        x = recordings[rec]
        n = len(x)
        if u.end - u.start < min_segment_length:
            continue
        if u.end * sample_rate > n + max_overshoot * sample_rate:
            msg = (f"{u.utt_id}: segment end {u.end}s overshoots recording "
                   f"({n / sample_rate:.2f}s) beyond max_overshoot")
            if strict:
                raise ValueError(msg)
            warn(f"extract_segments: skipping {msg}")
            skipped += 1
            continue
        i0 = int(round(u.start * sample_rate))
        i1 = min(int(round(u.end * sample_rate)), n)
        if i1 - i0 < int(min_segment_length * sample_rate):
            continue
        out[u.utt_id] = x[i0:i1]
    if skipped:
        warn(f"extract_segments: skipped {skipped} malformed segment rows")
    return out
