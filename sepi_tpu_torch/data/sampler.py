"""Training samplers: the egs pipeline without the disk round trip.

Port of `sepi_tpu/data/sampler.py` (`ChunkSampler`, `FrameSampler`,
`MultitaskInterleaver`), in numpy.  Each draws the same numbers in the
same order from ``np.random.default_rng(seed)`` as the reference, so both
packages see the same batches.  Chunks are cut on the fly from an
in-memory feature store and bucketed into a few static lengths, keeping
the reference's per-archive-constant chunk length (`get_egs_xvec.sh:9-14`).

Speaker balance as `allocate_egs_new.py:252-268`: each pass over a
bucket's rotation visits every eligible speaker once; a draw picks a
random utterance of that speaker at least ``chunk_len`` frames long and a
random offset; speakers with no long-enough utterance are skipped.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np

from ..config import ChunkConfig
from .manifest import Dataset


@dataclasses.dataclass
class ChunkBatch:
    """One fixed-length minibatch: feats (B, L, D) f32, labels (B,) i32."""

    feats: np.ndarray
    labels: np.ndarray
    chunk_len: int
    task: str = "xvec"


def bucket_lengths(cfg: ChunkConfig) -> List[int]:
    """Distinct static chunk lengths spanning [min, max] evenly."""
    if cfg.num_buckets <= 1:
        return [cfg.max_chunk_len]
    return sorted({
        int(round(l))
        for l in np.linspace(cfg.min_chunk_len, cfg.max_chunk_len, cfg.num_buckets)
    })


def diagnostic_lengths(cfg: ChunkConfig, num: int = 3) -> List[int]:
    """Geometric series min->max for diagnostics (allocate_egs_new.py:193-203)."""
    ratio = (cfg.max_chunk_len / cfg.min_chunk_len) ** (1.0 / max(num - 1, 1))
    return sorted({int(round(cfg.min_chunk_len * ratio**i)) for i in range(num)})


class ChunkSampler:
    """Speaker-balanced bucketed chunk sampler over a feature store.

    Args:
      features: utt_id -> (T, D) float32 array (CMVN'd, silence-stripped).
      dataset: manifest supplying the speaker structure.
      cfg: chunk length policy.
      batch_size: chunks per batch (all the same length).
      seed: deterministic sampling.
      block_size: batches per constant-length run when iterating, so
        supersteps can stack same-shape batches.
      label_map: speaker -> label; pass the global map when this sampler
        sees a subset of the training population (a held-out split).
    """

    def __init__(
        self,
        features: Mapping[str, np.ndarray],
        dataset: Dataset,
        cfg: ChunkConfig = ChunkConfig(),
        batch_size: int = 64,
        seed: int = 123,
        block_size: int = 1,
        label_map: Optional[Mapping[str, int]] = None,
    ):
        self.cfg = cfg
        self.batch_size = batch_size
        self.block_size = max(1, block_size)
        self.rng = np.random.default_rng(seed)
        self.label_map = dict(label_map) if label_map else dataset.speaker_label_map()
        self.num_speakers = len(self.label_map)
        self.feat_dim = next(iter(features.values())).shape[1]
        self.buckets = bucket_lengths(cfg)
        self._spk_utts: Dict[int, List[Tuple[str, int]]] = {}
        self._features = features
        for spk, utt_ids in dataset.spk2utt.items():
            lab = self.label_map[spk]
            rows = [(u, features[u].shape[0]) for u in utt_ids if u in features]
            if rows:
                self._spk_utts[lab] = rows
        # per-bucket speaker rotations, persistent across batches
        self._queues: Dict[int, List[int]] = {}
        self.draw_counts: Dict[int, int] = {lab: 0 for lab in self._spk_utts}

    def eligible_speakers(self, chunk_len: int) -> List[int]:
        return [lab for lab, rows in self._spk_utts.items()
                if any(n >= chunk_len for _, n in rows)]

    def _next_speakers(self, chunk_len: int, count: int) -> List[int]:
        """``count`` speakers from the bucket's rotation, reshuffled each
        time the eligible list is exhausted."""
        out: List[int] = []
        q = self._queues.get(chunk_len, [])
        while len(out) < count:
            if not q:
                eligible = self.eligible_speakers(chunk_len)
                if not eligible:
                    raise ValueError(f"no speaker has an utterance >= {chunk_len} frames")
                q = list(self.rng.permutation(eligible))
            out.append(int(q.pop()))
        self._queues[chunk_len] = q
        return out

    def sample_batch(self, chunk_len: Optional[int] = None) -> ChunkBatch:
        if chunk_len is None:
            chunk_len = int(self.rng.choice(self.buckets))
        feats = np.zeros((self.batch_size, chunk_len, self.feat_dim), np.float32)
        labels = np.zeros((self.batch_size,), np.int32)
        for b, lab in enumerate(self._next_speakers(chunk_len, self.batch_size)):
            rows = [(u, n) for u, n in self._spk_utts[lab] if n >= chunk_len]
            utt, n = rows[int(self.rng.integers(len(rows)))]
            off = int(self.rng.integers(n - chunk_len + 1))
            feats[b] = self._features[utt][off:off + chunk_len]
            labels[b] = lab
            self.draw_counts[lab] += 1
        return ChunkBatch(feats, labels, chunk_len, task="xvec")

    def __iter__(self) -> Iterator[ChunkBatch]:
        while True:
            chunk_len = int(self.rng.choice(self.buckets))
            for _ in range(self.block_size):
                yield self.sample_batch(chunk_len)

    def diagnostic_batches(self, num_lengths: int = 3) -> List[ChunkBatch]:
        """Held-out style diagnostics at geometric lengths."""
        return [self.sample_batch(l) for l in diagnostic_lengths(self.cfg, num_lengths)]


@dataclasses.dataclass
class FrameBatch:
    """AM example batch: feats (B, L + left + right, D), labels (B, L) i32,
    label_mask (B, L)."""

    feats: np.ndarray
    labels: np.ndarray
    label_mask: np.ndarray
    task: str = "am"


class FrameSampler:
    """Frame-level senone sampler (get_egs_am.sh semantics).

    ``alignments[utt]`` is an int32 (T,) senone stream aligned with
    ``features[utt]`` rows (the select-voiced-ali invariant).  Each example
    is ``chunk_len`` label frames with the model's (left, right) context
    around them, so VALID convolutions return exactly ``chunk_len``
    logits.  Utterances are drawn in proportion to their frame count.
    """

    def __init__(
        self,
        features: Mapping[str, np.ndarray],
        alignments: Mapping[str, np.ndarray],
        chunk_len: int = 8,
        batch_size: int = 256,
        seed: int = 123,
        context: Tuple[int, int] = (0, 0),
    ):
        self.chunk_len = chunk_len
        self.batch_size = batch_size
        if isinstance(context, int):
            context = (context, context)
        self.context = context
        self.rng = np.random.default_rng(seed)
        self._rows: List[Tuple[str, int]] = []
        self._features = features
        self._ali: Dict[str, np.ndarray] = {}
        min_len = chunk_len + context[0] + context[1]
        for utt, f in features.items():
            if utt not in alignments:
                continue
            a = alignments[utt]
            if len(a) != f.shape[0]:
                raise ValueError(
                    f"{utt}: alignment length {len(a)} != num frames {f.shape[0]}"
                    " (select-voiced-ali invariant violated)"
                )
            if f.shape[0] >= min_len:
                self._rows.append((utt, f.shape[0]))
                self._ali[utt] = a
        if not self._rows:
            raise ValueError("no utterance long enough for AM examples")
        self.feat_dim = next(iter(features.values())).shape[1]
        tot = sum(n for _, n in self._rows)
        self._probs = np.array([n / tot for _, n in self._rows])

    def sample_batch(self) -> FrameBatch:
        lc, rc = self.context
        l = self.chunk_len + lc + rc
        feats = np.zeros((self.batch_size, l, self.feat_dim), np.float32)
        labels = np.zeros((self.batch_size, self.chunk_len), np.int32)
        mask = np.ones((self.batch_size, self.chunk_len), bool)
        idx = self.rng.choice(len(self._rows), size=self.batch_size, p=self._probs)
        for b, i in enumerate(idx):
            utt, n = self._rows[int(i)]
            off = int(self.rng.integers(n - l + 1))
            feats[b] = self._features[utt][off:off + l]
            labels[b] = self._ali[utt][off + lc:off + lc + self.chunk_len]
        return FrameBatch(feats, labels, mask)

    def __iter__(self) -> Iterator[FrameBatch]:
        while True:
            yield self.sample_batch()


class MultitaskInterleaver:
    """nnet3-copy-cvector-egs: a stochastic two-stream interleave.

    Draws the AM or the x-vector stream with probability proportional to
    the *remaining* batch budget of each (`SelectExample`,
    `nnet3-copy-cvector-egs.cc:294-301`), so both run out together.  With
    ``block_size`` K a draw picks a stream for K batches (capped by its
    budget), a same-task same-shape run a superstep can stack; the chunk
    length of an x-vector run comes from ``xvec_sampler.rng``.  Yields
    (batch, loss weight) pairs.
    """

    def __init__(
        self,
        am_sampler: FrameSampler,
        xvec_sampler: ChunkSampler,
        num_am_batches: int,
        num_xvec_batches: int,
        am_weight: float = 1.0,
        xvec_weight: float = 1.0,
        seed: int = 123,
        block_size: int = 1,
    ):
        self.am_sampler = am_sampler
        self.xvec_sampler = xvec_sampler
        self.num_am = num_am_batches
        self.num_xvec = num_xvec_batches
        self.am_weight = am_weight
        self.xvec_weight = xvec_weight
        self.rng = np.random.default_rng(seed)
        self.block_size = max(1, block_size)

    def __iter__(self):
        rem_am, rem_xvec = self.num_am, self.num_xvec
        while rem_am > 0 or rem_xvec > 0:
            p_am = rem_am / (rem_am + rem_xvec)
            if self.rng.random() < p_am:
                k = min(self.block_size, rem_am)
                rem_am -= k
                for _ in range(k):
                    yield self.am_sampler.sample_batch(), self.am_weight
            else:
                k = min(self.block_size, rem_xvec)
                rem_xvec -= k
                chunk_len = int(self.xvec_sampler.rng.choice(self.xvec_sampler.buckets))
                for _ in range(k):
                    yield self.xvec_sampler.sample_batch(chunk_len), self.xvec_weight
