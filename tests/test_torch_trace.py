"""The port's spans and counters (`sepi_tpu_torch.utils.logging`) on the CPU:
- off, a span is one shared null context that records nothing and enters
  no `record_function`;
- on, spans nest per thread, share their outermost span's root id, and
  `totals` gives each name's seconds, count and self seconds;
- the prefetch thread's spans stay on its own stack;
- the extractor's padding counters against a hand count, and its spans
  and the graph spans around a capture and a replay;
- the frontend's and the Trainer's spans, once per batch, utterance or
  unit, and at the log and eval boundaries;
- ``frontend.graph_reused``: one per batch that a graph an earlier call
  captured served.
"""

import threading
import time

import numpy as np
import pytest
import torch

from sepi_tpu_torch import graphs
from sepi_tpu_torch.config import CmvnConfig, ExtractConfig, FrontendConfig, VadConfig
from sepi_tpu_torch.data import ChunkBatch
from sepi_tpu_torch.data.featstore import PrefetchLoader
from sepi_tpu_torch.extract import EmbeddingExtractor
from sepi_tpu_torch.models import TdnnSpec, XVector, XVectorConfig
from sepi_tpu_torch.recipes import pipeline
from sepi_tpu_torch.train import Trainer, make_eval_step, make_superstep
from sepi_tpu_torch.utils import logging as L
from test_torch_graphs import _Rerun, _xvec_state
from test_torch_train import _batch

torch.set_num_threads(2)

XCFG = XVectorConfig(feat_dim=8, num_speakers=4, embed_dim=16,
                     frame_specs=(TdnnSpec(16, (-2, -1, 0, 1, 2)), TdnnSpec(16, (-2, 0, 2)),
                                  TdnnSpec(32, (0,))))


@pytest.fixture(autouse=True)
def fresh_tracer():
    L.disable()
    L.reset()
    yield
    L.disable()
    L.reset()


@pytest.fixture(autouse=True)
def no_kept_graphs(monkeypatch):
    """No frontend graph kept across tests: a test's substitute backend
    stays with the test."""
    monkeypatch.setattr(pipeline, "_KEPT", {})


def _names(recs):
    return [r.name for r in recs]


def _by_name(recs, name):
    return [r for r in recs if r.name == name]


def test_off_records_nothing_and_enters_no_record_function():
    assert L.span("a") is L.span("b")  # one shared null context: nothing allocated
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with L.span("outer"):
            with L.span("inner"):
                torch.ones(3).sum()
        L.count("n", 2)
    assert L.spans() == [] and L.totals() == {}
    assert not [e.name for e in prof.events() if e.name.startswith("sepi.")]
    assert L.counters() == {"n": 2}  # counters are always on
    L.reset()
    assert L.counters() == {}


def test_nesting_root_ids_and_self_time():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with L.tracing():
            with L.span("outer"):
                with L.span("child"):
                    with L.span("grandchild"):
                        time.sleep(0.002)
                with L.span("child"):
                    time.sleep(0.001)
                time.sleep(0.001)
            with L.span("second"):
                pass
    with L.span("after"):  # `tracing` restored the off state
        pass
    recs = L.spans()
    assert _names(recs) == ["grandchild", "child", "child", "outer", "second"]
    outer, second = recs[3], recs[4]
    assert outer.parent is None and outer.root == outer.id
    assert second.parent is None and second.root == second.id != outer.root
    c1, c2 = _by_name(recs, "child")
    assert c1.parent == c2.parent == outer.id and recs[0].parent == c1.id
    assert all(r.root == outer.id for r in recs[:4])
    assert all(r.start_ns <= r.end_ns for r in recs)
    assert outer.start_ns <= c1.start_ns and c2.end_ns <= outer.end_ns

    def dur(r):
        return r.end_ns - r.start_ns

    tot = L.totals()
    assert tot["child"]["count"] == 2
    assert tot["outer"]["seconds"] == dur(outer) * 1e-9
    assert tot["outer"]["self_seconds"] == (dur(outer) - dur(c1) - dur(c2)) * 1e-9
    assert tot["child"]["self_seconds"] == pytest.approx(
        (dur(c1) - dur(recs[0])) * 1e-9 + dur(c2) * 1e-9, abs=1e-12)
    assert tot["grandchild"]["self_seconds"] == tot["grandchild"]["seconds"]
    assert 0.001 <= tot["outer"]["self_seconds"] < tot["outer"]["seconds"]
    events = {e.name for e in prof.events()}
    assert {"sepi.outer", "sepi.child", "sepi.grandchild", "sepi.second"} <= events


def test_prefetch_thread_spans_stay_on_their_own_stack():
    started = threading.Event()

    def batches():
        for i in range(6):
            with L.span("draw"):  # nested under the producer's own span
                item = i
            started.set()
            yield item

    L.enable()
    with L.span("consumer"):
        loader = PrefetchLoader(batches(), depth=2)
        try:
            assert started.wait(10)
            got = list(loader)
        finally:
            loader.close()
    assert got == list(range(6))
    recs = L.spans()
    (consumer,) = _by_name(recs, "consumer")
    samples = _by_name(recs, "train.sample")
    # one span per draw, and one for the draw that found the stream ended
    assert len(samples) == 7
    assert all(s.parent is None and s.root == s.id for s in samples)
    draws = _by_name(recs, "draw")
    assert len(draws) == 6 and all(d.parent in {s.id for s in samples} for d in draws)
    assert consumer.parent is None and all(r.root != consumer.root for r in samples + draws)


def _model(seed=0):
    model = XVector(XCFG)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / max(p[0].numel(), 1) ** 0.5)
    return model


def test_extraction_counters_by_hand_and_its_spans(monkeypatch):
    """Utterances of 30, 45, 70 and 260 frames, batch 4, the default ladder
    (25, 50, 100, 200, 400, ...): one batch in bucket 50 (30 and 45), one
    in 100, one in 400, each packed at the row rung of its bucket's chunks
    (2, 1 and 1 rows, all below the batch).  Each bucket is captured on its
    first call and replayed on the second."""
    monkeypatch.setattr(graphs, "BACKEND", _Rerun())
    rng = np.random.default_rng(0)
    feats = {f"u{n}": rng.standard_normal((n, XCFG.feat_dim)).astype(np.float32)
             for n in (30, 45, 70, 260)}
    ex = EmbeddingExtractor(_model(), ExtractConfig(batch_size=4), device="cpu")
    with L.tracing():
        first = ex.extract_utterances(feats)
    assert L.counters() == {"extract.rows": 4, "extract.row_slots": 2 + 1 + 1,
                            "extract.frames": 30 + 45 + 70 + 260,
                            "extract.frame_slots": 2 * 50 + 100 + 400,
                            "extract.rung_batches": 3}
    recs = L.spans()
    (root,) = _by_name(recs, "extract")
    assert root.parent is None and all(r.root == root.id for r in recs)
    tot = L.totals()
    assert {n: t["count"] for n, t in tot.items()} == {
        "extract": 1, "extract.plan": 1, "extract.pack": 3, "extract.readback": 3,
        "graph.load": 3, "graph.eager": 3, "graph.capture": 3}
    children = sum(t["seconds"] for n, t in tot.items() if n != "extract" and
                   all(r.parent == root.id for r in _by_name(recs, n)))
    assert tot["extract"]["self_seconds"] == pytest.approx(tot["extract"]["seconds"] - children)

    L.reset()
    with L.tracing():
        again = ex.extract_utterances(feats)
    assert {n: t["count"] for n, t in L.totals().items()} == {
        "extract": 1, "extract.plan": 1, "extract.pack": 3, "extract.readback": 3,
        "graph.load": 3, "graph.replay": 3}
    assert all(np.array_equal(first[u], again[u]) for u in feats)
    assert L.counters()["extract.frame_slots"] == 600


def test_frontend_spans_per_batch_and_utterance():
    rng = np.random.default_rng(3)
    audio = {f"a{i}": (rng.standard_normal(n) * 1000).astype(np.float32)
             for i, n in enumerate((8000, 12000, 16000))}
    with L.tracing():
        feats = pipeline.prepare_features_nosil(audio, FrontendConfig(dither=0.0), VadConfig(),
                                                CmvnConfig(), None, 2, device="cpu")
    recs = L.spans()
    (root,) = _by_name(recs, "frontend")
    assert all(r.root == root.id for r in recs)
    counts = {n: t["count"] for n, t in L.totals().items()}
    assert counts == {"frontend": 1, "frontend.pad": 2, "frontend.readback": 2,
                      "frontend.select": 3}
    assert all(r.parent == root.id for r in recs if r is not root)
    assert sorted(feats) == sorted(audio)


def test_frontend_graph_reused_counts_batches_of_earlier_calls(monkeypatch):
    """Widths 8000 (two batches) and 12000 (one): the first call captures
    two graphs and replays one of them, all its own; a second call's three
    batches are served by the first call's graphs; a third call of a kept
    and a new width counts the kept one alone."""
    monkeypatch.setattr(graphs, "BACKEND", _Rerun())
    graphs.reset_counts()
    rng = np.random.default_rng(5)

    def audio(*lengths):
        return {f"a{i}": (rng.standard_normal(n) * 1000).astype(np.float32)
                for i, n in enumerate(lengths)}

    def reused(a):
        L.reset()
        pipeline.prepare_features_nosil(a, FrontendConfig(), VadConfig(), CmvnConfig(), 3, 2,
                                        device="cpu")
        return L.counters().get("frontend.graph_reused", 0)

    first = audio(7000, 7500, 7800, 7900, 11000)
    assert reused(first) == 0
    assert graphs.call_counts == {"captures": 2, "replays": 1}
    assert reused(first) == 3
    assert graphs.call_counts == {"captures": 2, "replays": 4}
    assert reused(audio(7100, 7200, 15000)) == 1  # 8000 kept, 16000 captured
    assert graphs.call_counts == {"captures": 3, "replays": 5}


def test_trainer_spans_once_per_unit_and_at_boundaries():
    """K = 2 supersteps over 8 batches: 4 units, each pulled, staged and
    dispatched once; logs at steps 4 and 8, evaluations at 4 and 8."""
    chain, state = _xvec_state()
    rng = np.random.default_rng(5)
    batches = [ChunkBatch(*_batch(rng, n=8), 30) for _ in range(8)]
    vb = ChunkBatch(*_batch(rng, n=8), 30)
    tr = Trainer(steps={}, state=state, log_every=4,
                 supersteps={"xvec": make_superstep(chain)}, steps_per_dispatch=2,
                 valid_batches=[vb], eval_steps={"xvec": make_eval_step()}, eval_every=4)
    with L.tracing():
        tr.run(iter(batches), num_steps=8)
    assert tr.steps_done == 8
    recs = L.spans()
    (root,) = _by_name(recs, "train")
    counts = {n: t["count"] for n, t in L.totals().items()}
    assert counts == {"train": 1, "train.plan": 4, "train.stage": 4, "train.dispatch": 4,
                      "train.log": 2, "train.eval": 2}
    assert all(r.parent == root.id for r in recs if r is not root)
    assert [h[:2] for h in tr.history] == [(4, "xvec"), (4, "valid:xvec"), (8, "xvec"),
                                           (8, "valid:xvec")]
