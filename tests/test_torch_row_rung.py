"""The extractor's row rung (`EmbeddingExtractor._rows`) on the CPU.

Each bucket's batches are as many rows as the power of two at or above
the chunks the bucket holds in the call, capped at ``batch_size``:
- the embeddings of the x-vector, the combined c-vector (``task="xvec"``)
  and a small ECAPA-TDNN do not depend on it: against a forced
  ``batch_size``-row packing of the same chunks, relative l2 <= 1e-6 in
  float32, for buckets of 1, 3, 32 and 33 chunks (1, 4, 32 and 32 + 32
  rows);
- a call captures one graph per non-empty bucket, as a ``batch_size``-row
  packing does, and a second call of the same shapes only replays
  (`test_torch_graphs._Rerun` in place of the CUDA capture);
  ``extract.rung_batches`` counts the batches packed below
  ``batch_size``;
- with a mesh every batch keeps ``batch_size`` rows.
"""

import numpy as np
import pytest
import torch

from sepi_tpu_torch import graphs
from sepi_tpu_torch.config import ExtractConfig
from sepi_tpu_torch.extract import EmbeddingExtractor
from sepi_tpu_torch.models import (AmConfig, CombinedConfig, CombinedCVector, EcapaConfig,
                                   EcapaTdnn, TdnnSpec, XVector, XVectorConfig)
from sepi_tpu_torch.utils import logging as L
from test_torch_graphs import _Rerun

torch.set_num_threads(2)

ECFG = ExtractConfig(min_chunk_size=25, chunk_size=200, batch_size=32)  # buckets 25..200
FEAT_DIM = 23
REL_TOL = 1e-6  # float32; the rows of a batch are computed independently


def _seeded(model, seed=0):
    """Weights at 1/sqrt(fan_in), batch-norm scales and variances in
    0.5-1.5, biases and means around 0, in eval mode: the signal reaches
    the pooling in every channel, as in a trained network."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if not t.is_floating_point():
                continue
            if t.dim() >= 2:
                t.copy_(torch.randn(t.shape, generator=g) / t[0].numel() ** 0.5)
            elif name.endswith(("running_var", "bn.weight", "batchnorm.weight")):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            else:
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
    return model.eval()


def _xvector():
    cfg = XVectorConfig(feat_dim=FEAT_DIM, num_speakers=6, embed_dim=24, frame_specs=(
        TdnnSpec(32, (-2, -1, 0, 1, 2)), TdnnSpec(32, (-2, 0, 2)), TdnnSpec(48, (0,))))
    return _seeded(XVector(cfg)), {}, ECFG


def _cvector():
    cfg = CombinedConfig(num_speakers=8, num_senones=12, embed_dim=32, hidden_dim=24,
                         pool_dim=48, am=AmConfig(num_senones=12, specs=(
                             TdnnSpec(24, (-2, -1, 0, 1, 2)), TdnnSpec(24, (-1, 0, 1)),
                             TdnnSpec(12, (-3, 0, 3)))))
    return _seeded(CombinedCVector(cfg)), {"task": "xvec"}, ECFG


def _ecapa():
    cfg = EcapaConfig(feat_dim=FEAT_DIM, channels=32, se_bottleneck=8, attention_bottleneck=8,
                      mfa_channels=48, embed_dim=16, num_speakers=10)
    return _seeded(EcapaTdnn(cfg)), {}, ECFG.replace(embedding_node="embedding")


MODELS = {"xvector": _xvector, "cvector_xvec": _cvector, "ecapa": _ecapa}


def _features(n, lo=30, hi=50, seed=0):
    """``n`` utterances of ``lo``-``hi`` frames: one chunk each, all in one
    bucket."""
    rng = np.random.default_rng(seed)
    return {f"u{i:02d}": rng.standard_normal((int(rng.integers(lo, hi + 1)), FEAT_DIM)
                                             ).astype(np.float32) for i in range(n)}


def _batch_rows(ex, feats, monkeypatch):
    """The embeddings of one call and the rows of each batch it packed."""
    rows = []
    embed = EmbeddingExtractor._embed

    def record(self, f, m):
        rows.append(f.shape[0])
        return embed(self, f, m)

    with monkeypatch.context() as mp:
        mp.setattr(EmbeddingExtractor, "_embed", record)
        return ex.extract_utterances(feats), rows


@pytest.mark.parametrize("n,want_rows", [(1, [1]), (3, [4]), (32, [32]), (33, [32, 32])])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_embeddings_do_not_depend_on_the_rung(monkeypatch, kind, n, want_rows):
    model, kwargs, ecfg = MODELS[kind]()
    feats = _features(n, seed=n)
    ex = EmbeddingExtractor(model, ecfg, min_frames=1, model_kwargs=kwargs, device="cpu")
    got, rows = _batch_rows(ex, feats, monkeypatch)
    assert rows == want_rows
    with monkeypatch.context() as mp:
        mp.setattr(EmbeddingExtractor, "_rows", lambda self, n: self.cfg.batch_size)
        want, full = _batch_rows(ex, feats, monkeypatch)
    assert full == [ecfg.batch_size] * len(want_rows)
    assert sorted(got) == sorted(want) == sorted(feats)
    for u in feats:
        assert got[u].dtype == np.float32
        gap = np.linalg.norm(got[u].astype(np.float64) - want[u]) / np.linalg.norm(want[u])
        assert gap <= REL_TOL, (u, gap)


@pytest.mark.parametrize("n,bs,want", [
    (1, 32, 1), (2, 32, 2), (3, 32, 4), (5, 32, 8), (16, 32, 16), (17, 32, 32), (32, 32, 32),
    (33, 32, 32), (200, 32, 32), (5, 12, 8), (9, 12, 12), (1, 1, 1), (7, 1, 1)])
def test_the_rung_is_a_power_of_two_capped_at_the_batch(n, bs, want):
    model, kwargs, ecfg = _xvector()
    ex = EmbeddingExtractor(model, ecfg.replace(batch_size=bs), device="cpu")
    assert ex._rows(n) == want


# bucket 50 holds 26-50 frames, bucket 100 51-100, bucket 200 101-200
BUCKET_SPANS = {50: (30, 50), 100: (60, 100), 200: (120, 200)}


@pytest.mark.parametrize("per_bucket", [(1,), (1, 1, 1), (1, 3, 33)])
def test_the_rung_adds_no_capture(monkeypatch, per_bucket):
    """One graph per non-empty bucket on the first call (as a
    ``batch_size``-row packing captures), only replays on the second;
    ``extract.rung_batches`` counts the batches below ``batch_size``."""
    backend = _Rerun()
    monkeypatch.setattr(graphs, "BACKEND", backend)
    model, kwargs, ecfg = _xvector()
    feats = {}
    for (b, (lo, hi)), n in zip(BUCKET_SPANS.items(), per_bucket):
        feats.update({f"b{b}-{u}": f for u, f in _features(n, lo, hi, seed=b).items()})
    ex = EmbeddingExtractor(model, ecfg, min_frames=1, device="cpu")
    batches = sum(-(-n // ex._rows(n)) for n in per_bucket)
    narrow = sum(-(-n // ex._rows(n)) for n in per_bucket if ex._rows(n) < ecfg.batch_size)
    L.disable()
    L.reset()
    try:
        with L.tracing():
            first = ex.extract_utterances(feats)
        tot = L.totals()
        assert tot["graph.capture"]["count"] == len(per_bucket) == backend.captured
        assert tot.get("graph.replay", {"count": 0})["count"] == batches - len(per_bucket)
        assert L.counters()["extract.rung_batches"] == narrow
        assert L.counters().get("extract.row_slots") == sum(
            -(-n // ex._rows(n)) * ex._rows(n) for n in per_bucket)
        L.reset()
        with L.tracing():
            second = ex.extract_utterances(feats)
        counts = {n: t["count"] for n, t in L.totals().items()}
        assert counts["graph.replay"] == batches
        assert "graph.capture" not in counts and "graph.eager" not in counts
        assert backend.captured == len(per_bucket) == len(ex.graphs.graphs)
        assert L.counters()["extract.rung_batches"] == narrow
    finally:
        L.disable()
        L.reset()
    assert all(np.array_equal(first[u], second[u]) for u in feats)


def test_a_mesh_extraction_keeps_the_batch_rows(monkeypatch):
    from torch_dist import cpu_world_mesh

    model, kwargs, ecfg = _xvector()
    feats = _features(3)
    with cpu_world_mesh() as mesh:
        ex = EmbeddingExtractor(model, ecfg, min_frames=1, device="cpu", mesh=mesh)
        got, rows = _batch_rows(ex, feats, monkeypatch)
    assert rows == [ecfg.batch_size] and ex._rows(1) == ecfg.batch_size
    want = EmbeddingExtractor(model, ecfg, min_frames=1, device="cpu").extract_utterances(feats)
    for u in feats:
        assert np.linalg.norm(got[u] - want[u]) <= REL_TOL * np.linalg.norm(want[u])
