"""Typed dataset manifests — the replacement for Kaldi data directories.

A copy of `sepi_tpu/data/manifest.py` (the port imports nothing of the
JAX package).

The reference's "dataframe" is a directory of sorted text tables
(`wav.scp`, `utt2spk`, `spk2utt`, `feats.scp`, `vad.scp`, `trials`,
`utt2num_frames`, `utt2uniq`) manipulated by ~150 awk/perl scripts under
`utils/` (SURVEY.md §1 L1: `combine_data.sh`, `fix_data_dir.sh`,
`validate_data_dir.sh`, `subset_data_dir.sh`, `filter_scp.pl` ...).

Here a dataset is one typed table of `Utterance` rows with jsonl
persistence.  Every Kaldi data-dir operation becomes a pure method
returning a new `Dataset`:

  combine_data.sh          -> Dataset.combine
  subset_data_dir.sh       -> Dataset.subset / head / filter
  fix_data_dir.sh          -> Dataset.fixed (drop dangling, sort)
  validate_data_dir.sh     -> Dataset.validate
  spk2utt/utt2spk maps     -> Dataset.spk2utt property
  utt2num_frames filters   -> Dataset.filter(lambda u: u.num_frames>=500)
  min-utts-per-spk filters -> Dataset.filter_min_utts_per_spk
  utt2uniq (augmentation)  -> Utterance.uniq_id

Binary payloads (audio, features, embeddings) live in an `ArrayStore`
(npz-backed; see artifacts.py) referenced by key, replacing ark/scp.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Utterance:
    utt_id: str
    spk_id: str
    # Audio source: path to a wav file OR a key into an ArrayStore.
    wav: Optional[str] = None
    num_samples: Optional[int] = None
    sample_rate: Optional[int] = None
    num_frames: Optional[int] = None  # after front-end (utt2num_frames)
    duration: Optional[float] = None  # seconds (utt2dur)
    uniq_id: Optional[str] = None  # clean-source id for augmented copies (utt2uniq)
    # Segments support (the `segments` file + extract-segments semantics
    # the reference's augment_data_dir_new.py exists to preserve): an
    # utterance may be a [start, end) second range of a longer recording;
    # `wav` then refers to the recording's audio.
    recording: Optional[str] = None  # recording id (segments col 2)
    start: Optional[float] = None  # segment start, seconds
    end: Optional[float] = None  # segment end, seconds
    meta: Tuple[Tuple[str, str], ...] = ()  # free-form (gender, language, ...)

    def get_meta(self, key: str, default=None):
        for k, v in self.meta:
            if k == key:
                return v
        return default

    def replace(self, **kw) -> "Utterance":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Trial:
    model: str  # enrollment speaker/model id
    test: str  # test utterance id
    target: bool


class Dataset:
    """An immutable, utt_id-sorted collection of utterances."""

    def __init__(self, utts: Iterable[Utterance], name: str = "dataset"):
        rows = sorted(utts, key=lambda u: u.utt_id)
        seen = set()
        for u in rows:
            if u.utt_id in seen:
                raise ValueError(f"duplicate utt_id {u.utt_id!r}")
            seen.add(u.utt_id)
        self._utts: Tuple[Utterance, ...] = tuple(rows)
        self._by_id: Dict[str, Utterance] = {u.utt_id: u for u in rows}
        self.name = name

    # -- core accessors ----------------------------------------------
    def __len__(self) -> int:
        return len(self._utts)

    def __iter__(self):
        return iter(self._utts)

    def __getitem__(self, utt_id: str) -> Utterance:
        return self._by_id[utt_id]

    def __contains__(self, utt_id: str) -> bool:
        return utt_id in self._by_id

    @property
    def utts(self) -> Tuple[Utterance, ...]:
        return self._utts

    @property
    def utt_ids(self) -> List[str]:
        return [u.utt_id for u in self._utts]

    @property
    def speakers(self) -> List[str]:
        return sorted({u.spk_id for u in self._utts})

    @property
    def spk2utt(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = defaultdict(list)
        for u in self._utts:
            out[u.spk_id].append(u.utt_id)
        return dict(out)

    def speaker_label_map(self) -> Dict[str, int]:
        """Stable speaker -> integer-id map (the pdf2num analog)."""
        return {s: i for i, s in enumerate(self.speakers)}

    # -- data-dir operations -----------------------------------------
    def filter(self, pred: Callable[[Utterance], bool], name: Optional[str] = None) -> "Dataset":
        return Dataset([u for u in self._utts if pred(u)], name or self.name)

    def filter_min_frames(self, min_frames: int) -> "Dataset":
        """min-length filter (`v2/run_sre10.sh:170-178`, >=500 frames)."""
        return self.filter(lambda u: (u.num_frames or 0) >= min_frames)

    def filter_min_utts_per_spk(self, min_utts: int) -> "Dataset":
        """>=8 utts/speaker filter (`v2/run_sre10.sh:181-190`)."""
        counts = {s: len(us) for s, us in self.spk2utt.items()}
        return self.filter(lambda u: counts[u.spk_id] >= min_utts)

    def subset(self, utt_ids: Sequence[str], name: Optional[str] = None) -> "Dataset":
        ids = set(utt_ids)
        missing = ids - set(self._by_id)
        if missing:
            raise KeyError(f"{len(missing)} utt_ids not in dataset, e.g. {sorted(missing)[:3]}")
        return Dataset([self._by_id[i] for i in ids], name or self.name)

    def head(self, n: int) -> "Dataset":
        return Dataset(self._utts[:n], self.name)

    def combine(self, *others: "Dataset", name: str = "combined") -> "Dataset":
        rows = list(self._utts)
        for d in others:
            rows.extend(d.utts)
        return Dataset(rows, name)

    def map(self, fn: Callable[[Utterance], Utterance], name: Optional[str] = None) -> "Dataset":
        return Dataset([fn(u) for u in self._utts], name or self.name)

    def split(self, n: int) -> List["Dataset"]:
        """split_data.sh: round-robin shards for host-parallel work."""
        shards: List[List[Utterance]] = [[] for _ in range(n)]
        for i, u in enumerate(self._utts):
            shards[i % n].append(u)
        return [Dataset(s, f"{self.name}.{i}") for i, s in enumerate(shards)]

    def validate(self, require_wav: bool = True) -> None:
        """validate_data_dir.sh: schema/consistency checks, raising on error."""
        for u in self._utts:
            if not u.utt_id or not u.spk_id:
                raise ValueError(f"empty ids in {u}")
            if require_wav and u.wav is None:
                raise ValueError(f"{u.utt_id}: no audio source")
            if u.num_samples is not None and u.num_samples < 0:
                raise ValueError(f"{u.utt_id}: negative num_samples")
            if u.start is not None or u.end is not None:
                if u.start is None or u.end is None or not 0 <= u.start < u.end:
                    raise ValueError(
                        f"{u.utt_id}: bad segment [{u.start}, {u.end})"
                    )

    # -- persistence --------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for u in self._utts:
                f.write(json.dumps(dataclasses.asdict(u)) + "\n")

    @classmethod
    def load(cls, path: str, name: Optional[str] = None) -> "Dataset":
        utts = []
        with open(path) as f:
            for line in f:
                d = json.loads(line)
                d["meta"] = tuple(tuple(kv) for kv in d.get("meta", []))
                utts.append(Utterance(**d))
        return cls(utts, name or os.path.basename(path))


# ---------------------------------------------------------------- trials
def load_trials(path: str) -> List[Trial]:
    """Read a NIST-style trial list: `<model> <test> target|nontarget`."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            model, test, label = parts[0], parts[1], parts[2]
            out.append(Trial(model, test, label == "target"))
    return out


def save_trials(trials: Sequence[Trial], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for t in trials:
            f.write(f"{t.model} {t.test} {'target' if t.target else 'nontarget'}\n")
