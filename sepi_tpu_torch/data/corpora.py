"""Corpus ingestion helpers — the data-prep layer.

The reference ships ~3k lines of per-corpus LDC walkers
(`local/make_sre.pl`, `make_swbd*.pl`, `make_musan.py`, ... SURVEY.md
§2.3 "data prep") that emit Kaldi data dirs.  Those corpora are
license-gated, so the framework provides corpus-agnostic builders that
produce the same manifest structure from either (a) directory trees of
WAVs, (b) explicit (utt, spk, path) tables, or (c) existing Kaldi data
dirs (wav.scp/utt2spk interop).

A copy of `sepi_tpu/data/corpora.py` (the port imports nothing of the JAX
package); both packages write byte-equal data directories.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

from .audio import read_audio
from .manifest import Dataset, Utterance


def dataset_from_table(
    rows: Iterable[Tuple[str, str, str]],
    name: str = "corpus",
    meta: Optional[Mapping[str, Mapping[str, str]]] = None,
    probe_audio: bool = False,
) -> Dataset:
    """Build from (utt_id, spk_id, wav_path) rows; optional per-utt meta."""
    utts: List[Utterance] = []
    for utt_id, spk_id, wav in rows:
        m: Tuple[Tuple[str, str], ...] = ()
        if meta and utt_id in meta:
            m = tuple(sorted(meta[utt_id].items()))
        num_samples = rate = None
        if probe_audio:
            x, rate = read_audio(wav)
            num_samples = len(x)
        utts.append(
            Utterance(utt_id, spk_id, wav=wav, num_samples=num_samples,
                      sample_rate=rate, meta=m)
        )
    return Dataset(utts, name)


def dataset_from_wav_tree(
    root: str,
    name: str = "corpus",
    spk_from_path: Optional[Callable[[str], str]] = None,
) -> Dataset:
    """Walk a directory tree of WAVs; default speaker = parent dir name
    (the MUSAN/VoxCeleb-style layout)."""
    rows = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if not f.lower().endswith(".wav"):
                continue
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)
            spk = spk_from_path(rel) if spk_from_path else os.path.basename(dirpath)
            utt = rel.replace(os.sep, "-")[:-4]
            rows.append((f"{spk}-{utt}" if not utt.startswith(spk) else utt, spk, path))
    return dataset_from_table(rows, name)


def _parse_sph2pipe(cmd: str):
    """Recognize the reference's `sph2pipe -f wav [-p] [-c N] x.sph |`
    wav.scp pipelines (local/make_sre.pl and every LDC walker emit this
    form) -> (sph_path, channel) — decoded natively instead of forked.
    Returns None for any other pipeline."""
    toks = cmd.rstrip("|").split()
    if not toks or "sph2pipe" not in os.path.basename(toks[0]):
        return None
    channel = "1"
    sph = None
    i = 1
    while i < len(toks):
        t = toks[i]
        if t == "-c" and i + 1 < len(toks):
            channel = toks[i + 1]
            i += 2
        elif t in ("-f", "-t", "-s") and i + 1 < len(toks):
            i += 2
        elif t.startswith("-"):
            i += 1
        else:
            sph = t
            i += 1
    if sph is None or not sph.lower().endswith(".sph"):
        return None
    return sph, channel


def dataset_from_kaldi_dir(path: str, name: Optional[str] = None) -> Dataset:
    """Interop: read a Kaldi data dir (wav.scp + utt2spk [+ utt2num_frames,
    utt2dur, utt2uniq]).  wav.scp sph2pipe pipelines are converted to
    native SPHERE references (channel kept as utterance meta); other
    command pipelines are rejected — materialize them to wav first."""

    def read_map(fname) -> Dict[str, str]:
        p = os.path.join(path, fname)
        out = {}
        if os.path.exists(p):
            with open(p) as f:
                for line in f:
                    parts = line.split(None, 1)
                    if len(parts) == 2:
                        out[parts[0]] = parts[1].strip()
        return out

    wav = read_map("wav.scp")
    utt2spk = read_map("utt2spk")
    if not wav or not utt2spk:
        raise FileNotFoundError(f"{path}: need wav.scp and utt2spk")
    u2nf = read_map("utt2num_frames")
    u2dur = read_map("utt2dur")
    u2uniq = read_map("utt2uniq")
    # segments: utt_id recording_id start end — wav.scp is then keyed by
    # recording (the form augment_data_dir_new.py exists to preserve)
    segments = {}
    seg_path = os.path.join(path, "segments")
    if os.path.exists(seg_path):
        with open(seg_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 4:
                    segments[parts[0]] = (parts[1], float(parts[2]), float(parts[3]))
    utts = []
    for utt_id, spk in utt2spk.items():
        rec, start, end = segments.get(utt_id, (utt_id, None, None))
        w = wav.get(rec)
        if w is None:
            continue
        meta = ()
        if w.endswith("|"):
            parsed = _parse_sph2pipe(w)
            if parsed is None:
                raise ValueError(
                    f"{utt_id}: wav.scp command pipeline {w!r} not supported "
                    "— only sph2pipe pipes decode natively; materialize "
                    "others to wav files first"
                )
            w, channel = parsed
            meta = (("channel", channel), ("codec", "sph"))
        dur = float(u2dur[utt_id]) if utt_id in u2dur else None
        if dur is None and start is not None:
            dur = end - start
        utts.append(
            Utterance(
                utt_id, spk, wav=w,
                num_frames=int(u2nf[utt_id]) if utt_id in u2nf else None,
                duration=dur,
                uniq_id=u2uniq.get(utt_id),
                recording=rec if utt_id in segments else None,
                start=start,
                end=end,
                meta=meta,
            )
        )
    return Dataset(utts, name or os.path.basename(path))


def write_kaldi_dir(dataset: Dataset, path: str) -> None:
    """Interop: emit wav.scp / utt2spk / spk2utt (+optional maps).

    Utterances with segment info produce a `segments` file and a
    recording-keyed wav.scp; SPHERE channel meta is written back as the
    `sph2pipe -f wav -p -c N path |` pipe form `dataset_from_kaldi_dir`
    parses, so walker outputs round-trip."""
    os.makedirs(path, exist_ok=True)
    seg_rows = [
        (u.utt_id, u.recording, u.start, u.end)
        for u in dataset
        if u.recording is not None and u.start is not None and u.end is not None
    ]
    with open(os.path.join(path, "wav.scp"), "w") as f:
        seen = set()
        for u in dataset:
            if not u.wav:
                continue
            key = u.recording if (u.recording and u.start is not None) else u.utt_id
            if key in seen:
                continue
            seen.add(key)
            if u.get_meta("codec") == "sph":
                ch = u.get_meta("channel", "1")
                f.write(f"{key} sph2pipe -f wav -p -c {ch} {u.wav} |\n")
            else:
                f.write(f"{key} {u.wav}\n")
    if seg_rows:
        with open(os.path.join(path, "segments"), "w") as f:
            for utt, rec, s, e in seg_rows:
                f.write(f"{utt} {rec} {s:.2f} {e:.2f}\n")
    with open(os.path.join(path, "utt2spk"), "w") as f:
        for u in dataset:
            f.write(f"{u.utt_id} {u.spk_id}\n")
    with open(os.path.join(path, "spk2utt"), "w") as f:
        for spk, us in sorted(dataset.spk2utt.items()):
            f.write(f"{spk} {' '.join(us)}\n")
    rows = [(u.utt_id, u.num_frames) for u in dataset if u.num_frames is not None]
    if rows:
        with open(os.path.join(path, "utt2num_frames"), "w") as f:
            for k, v in rows:
                f.write(f"{k} {v}\n")
    rows = [(u.utt_id, u.uniq_id) for u in dataset if u.uniq_id]
    if rows:
        with open(os.path.join(path, "utt2uniq"), "w") as f:
            for k, v in rows:
                f.write(f"{k} {v}\n")
