"""Port parity: the chunk sampler, the held-out split and the prefetch
loader against `sepi_tpu.data` / `sepi_tpu.recipes.pipeline`.

Both samplers draw from ``np.random.default_rng(seed)`` in the same order,
so their batches must be bit-identical.
"""

import threading

import numpy as np
import pytest
import torch

from sepi_tpu.config import ChunkConfig as JChunkConfig
from sepi_tpu.data import make_synthetic_corpus as jcorpus
from sepi_tpu.data.featstore import PrefetchLoader as JPrefetchLoader
from sepi_tpu.data.sampler import ChunkSampler as JChunkSampler
from sepi_tpu.data.sampler import bucket_lengths as jbuckets
from sepi_tpu.data.sampler import diagnostic_lengths as jdiag
from sepi_tpu.recipes.pipeline import auto_heldout as jauto
from sepi_tpu.recipes.pipeline import heldout_split as jsplit
from sepi_tpu_torch.config import ChunkConfig
from sepi_tpu_torch.data import (
    ChunkSampler,
    PrefetchLoader,
    bucket_lengths,
    diagnostic_lengths,
    make_synthetic_corpus,
)
from sepi_tpu_torch.recipes import auto_heldout, heldout_split

torch.set_num_threads(2)

CHUNKS = dict(min_chunk_len=40, max_chunk_len=90, num_buckets=4)


def _features(dataset, seed=0):
    """Random (T, 5) features per utterance, T in 30..120 (some shorter
    than the longest bucket, so eligibility matters)."""
    rng = np.random.default_rng(seed)
    return {u: rng.standard_normal((int(rng.integers(30, 121)), 5)).astype(np.float32)
            for u in dataset.utt_ids}


@pytest.fixture(scope="module")
def corpora():
    kw = dict(num_speakers=7, utts_per_speaker=4, duration_sec=0.2, seed=4)
    return jcorpus(**kw), make_synthetic_corpus(**kw)


@pytest.mark.parametrize("block_size", [1, 3])
def test_fifty_batches_are_bit_identical(corpora, block_size):
    jc, tc = corpora
    feats = _features(tc.dataset)
    ref = JChunkSampler(feats, jc.dataset, JChunkConfig(**CHUNKS), 6, 17, block_size=block_size)
    port = ChunkSampler(feats, tc.dataset, ChunkConfig(**CHUNKS), 6, 17, block_size=block_size)
    assert port.buckets == ref.buckets and port.label_map == ref.label_map
    # an explicit draw first, as train_xvector_model's probe batch
    a, b = ref.sample_batch(ref.buckets[0]), port.sample_batch(port.buckets[0])
    assert np.array_equal(a.feats, b.feats) and np.array_equal(a.labels, b.labels)
    for a, b, _ in zip(ref, port, range(50)):
        assert a.chunk_len == b.chunk_len and a.task == b.task
        assert a.feats.dtype == b.feats.dtype and a.labels.dtype == b.labels.dtype
        assert np.array_equal(a.feats, b.feats) and np.array_equal(a.labels, b.labels)
    assert port.draw_counts == ref.draw_counts
    assert [x.chunk_len for x in port.diagnostic_batches()] == \
        [x.chunk_len for x in ref.diagnostic_batches()]
    assert port.rng.integers(1 << 30) == ref.rng.integers(1 << 30)


def test_subset_sampler_with_global_label_map(corpora):
    jc, tc = corpora
    feats = _features(tc.dataset, 1)
    utts = tc.dataset.utt_ids[::3]
    lm = tc.dataset.speaker_label_map()
    ref = JChunkSampler({u: feats[u] for u in utts}, jc.dataset.subset(utts),
                        JChunkConfig(**CHUNKS), 4, 5, label_map=lm)
    port = ChunkSampler({u: feats[u] for u in utts}, tc.dataset.subset(utts),
                        ChunkConfig(**CHUNKS), 4, 5, label_map=lm)
    for length in port.buckets[:2]:
        a, b = ref.sample_batch(length), port.sample_batch(length)
        assert np.array_equal(a.feats, b.feats) and np.array_equal(a.labels, b.labels)


@pytest.mark.parametrize("cfg", [dict(), dict(num_buckets=1), CHUNKS,
                                 dict(min_chunk_len=50, max_chunk_len=100, num_buckets=2)])
def test_bucket_and_diagnostic_lengths(cfg):
    assert bucket_lengths(ChunkConfig(**cfg)) == jbuckets(JChunkConfig(**cfg))
    for num in (1, 3, 5):
        assert diagnostic_lengths(ChunkConfig(**cfg), num) == jdiag(JChunkConfig(**cfg), num)


def test_no_eligible_speaker_raises(corpora):
    _, tc = corpora
    feats = {u: np.zeros((10, 5), np.float32) for u in tc.dataset.utt_ids}
    with pytest.raises(ValueError, match="no speaker"):
        ChunkSampler(feats, tc.dataset, ChunkConfig(**CHUNKS), 4).sample_batch(40)


@pytest.mark.parametrize("n", [None, 0, 3, 9])
def test_heldout_split_and_auto_match(corpora, n):
    jc, tc = corpora
    assert auto_heldout(tc.dataset, n) == jauto(jc.dataset, n)
    budget = auto_heldout(tc.dataset, n)
    jt, jv = jsplit(jc.dataset, budget)
    tt, tv = heldout_split(tc.dataset, budget)
    assert tt.utt_ids == jt.utt_ids and tv.utt_ids == jv.utt_ids
    assert tt.name == jt.name and tv.name == jv.name


def test_prefetch_loader_order_close_and_errors():
    """Items arrive in order; close() joins the producer even when it is
    blocked on a full queue; a producer exception reaches the consumer."""
    loader = PrefetchLoader(iter(range(1000)), depth=2)
    assert [next(loader) for _ in range(20)] == list(range(20))
    loader.close()
    assert not loader._thread.is_alive()
    assert list(PrefetchLoader(iter(range(5)), depth=3)) == list(range(5))

    def failing():
        yield 1
        raise KeyError("boom")

    it = PrefetchLoader(failing(), depth=1)
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)
    # the same contract as the reference's loader
    ref = JPrefetchLoader(iter(range(7)), depth=2)
    assert list(ref) == list(PrefetchLoader(iter(range(7)), depth=2))


def test_prefetch_close_leaves_the_sampler_to_the_caller(corpora):
    """After close() returns, nothing else draws from the sampler: two
    closes at different points leave RNG states that a direct draw
    continues deterministically."""
    _, tc = corpora
    feats = _features(tc.dataset, 2)
    sampler = ChunkSampler(feats, tc.dataset, ChunkConfig(**CHUNKS), 4, 3)
    loader = PrefetchLoader(iter(sampler), depth=2)
    for _ in range(5):
        next(loader)
    loader.close()
    state = sampler.rng.bit_generator.state
    threading.Event().wait(0.3)  # a live producer would draw meanwhile
    assert sampler.rng.bit_generator.state == state
