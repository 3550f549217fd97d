"""The compiled serving path (`sepi_tpu_torch.graphs.CallGraphs`) on the CPU.

A CUDA graph needs the card, so these tests replace the capture by
`test_torch_graphs._Rerun` (a graph that replays by running its function
again) and hold what surrounds it:
- the captured extractor, frontend chain, eval step and the bench's two
  programs against ``capture=False``, bit for bit;
- the key: it changes with the model's storage and dtype, its
  ``training`` flag, the bucket and the TF32 flags, not after
  `load_state_dict`; a graph bound to replaced weights replays them;
- ``capture=True`` raising on the CPU and with a mesh; a capture that
  fails raising without running the eager call;
- kernel launches counted through replays;
- the frontend chain's graphs kept across calls (`pipeline._KEPT`): a
  second call replays them, a graph per frontend and shape, bounded,
  least recently used let go first, nothing kept eagerly;
- the captured path end to end against the reference's
  `extract_and_score` at `tests/test_torch_slice.py`'s widths and limits.
Every capture here runs under `_Strict`, which fails a captured body that
reads a tensor on the host or makes one from host data (a sync or a
pageable copy, which a CUDA capture refuses).
"""

import dataclasses
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from sepi_tpu.config import BackendConfig as JBackend
from sepi_tpu.config import FrontendConfig as JFrontend
from sepi_tpu.data import make_synthetic_corpus as j_corpus
from sepi_tpu.models import XVector as JXVector
from sepi_tpu.models import XVectorConfig as JConfig
from sepi_tpu.models.tdnn import TdnnSpec as JSpec
from sepi_tpu.recipes import pipeline as jp
from sepi_tpu_torch import bench, graphs
from sepi_tpu_torch.bridge import xvector_state_dict_from_flax
from sepi_tpu_torch.config import (MFCC_SRE_IVECTOR, BackendConfig, CmvnConfig, ExtractConfig,
                                   FrontendConfig, VadConfig)
from sepi_tpu_torch.data import make_synthetic_corpus
from sepi_tpu_torch.extract import EmbeddingExtractor, bucket_ladder
from sepi_tpu_torch.models import TdnnSpec, XVector, XVectorConfig
from sepi_tpu_torch.ops import FeatureExtractor
from sepi_tpu_torch.ops.deltas import add_deltas
from sepi_tpu_torch.recipes import pipeline as tp
from sepi_tpu_torch.train import make_eval_step
from test_torch_bench import SMALL
from test_torch_graphs import _Failing, _Rerun, _xvec_state
from test_torch_slice import SPECS
from test_torch_train import _batch

torch.set_num_threads(2)

ECFG = ExtractConfig(min_chunk_size=25, chunk_size=200, batch_size=8)  # buckets 25..200
XCFG = XVectorConfig(feat_dim=23, num_speakers=6,
                     frame_specs=tuple(TdnnSpec(d, o) for d, o in SPECS[:3]), embed_dim=24)

_SYNCS = {"item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__float__", "__index__",
          "nonzero", "argwhere", "masked_select", "unique", "unique_consecutive"}
_FROM_HOST = {"tensor", "as_tensor", "asarray"}


class _NoHost(TorchFunctionMode):
    """Fails a host read of a tensor (a sync) and a tensor made from host
    data (a pageable copy on the card), the calls a CUDA capture refuses."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        kwargs = kwargs or {}
        if name in _SYNCS:
            raise AssertionError(f"a captured body reads a tensor on the host ({name})")
        if name in _FROM_HOST and args and not isinstance(args[0], torch.Tensor):
            raise AssertionError(f"a captured body makes a tensor from host data ({name})")
        if name == "__getitem__":
            idx = args[1] if isinstance(args[1], tuple) else (args[1],)
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in idx):
                raise AssertionError("a captured body indexes with a boolean mask (a sync)")
        return func(*args, **kwargs)


def _no_from_numpy(*args, **kwargs):
    raise AssertionError("a captured body makes a tensor from host data (from_numpy)")


class _Strict(_Rerun):
    """`_Rerun` whose capture (the first run) is held by `_NoHost`."""

    def capture(self, dev, fn, pool):
        with _NoHost(), pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch, "from_numpy", _no_from_numpy)
            return super().capture(dev, fn, pool)


@pytest.fixture
def strict(monkeypatch):
    backend = _Strict()
    monkeypatch.setattr(graphs, "BACKEND", backend)
    monkeypatch.setattr(tp, "_KEPT", {})  # no frontend graph kept from another test
    graphs.reset_counts()
    return backend


def test_strict_backend_refuses_host_work(strict):
    """The lint itself: each refused call fails the capture."""
    for fn in (lambda x: x * x.sum().item(), lambda x: x * torch.as_tensor(np.ones(3, np.float32)),
               lambda x: x[x > 0].sum(), lambda x: x.cpu() + 1,
               lambda x: x * torch.from_numpy(np.ones(3, np.float32))):
        # the first call's warm-up runs eagerly and unchecked; its capture fails
        with pytest.raises(graphs.GraphCaptureError, match="a captured body"):
            graphs.CallGraphs(fn, device="cpu")(torch.ones(3))
    assert strict.captured == 5 and graphs.call_counts["captures"] == 0


# ------------------------------------------------------------ the extractor


def _model(dtype="float32", seed=0):
    model = XVector(XCFG, dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) / max(p[0].numel(), 1) ** 0.5)
        for name, b in model.named_buffers():
            if name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
    return model


def _features(seed=1):
    """Chunks in every bucket of `ECFG`, twelve of the second bucket's
    length (two batches), one utterance of three chunks."""
    rng = np.random.default_rng(seed)
    lengths = [25, 26, 50, 51, 100, 101, 200] + [50] * 12 + [2 * 200 + 60]
    return {f"u{i:02d}": rng.standard_normal((n, XCFG.feat_dim)).astype(np.float32)
            for i, n in enumerate(lengths)}


def _equal(a, b):
    return sorted(a) == sorted(b) and all(np.array_equal(a[u], b[u]) for u in a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_extractor_equals_eager(strict, dtype):
    model = _model(dtype)
    feats = _features()
    cap = EmbeddingExtractor(model, ECFG, min_frames=XCFG.min_frames, device="cpu")
    eag = EmbeddingExtractor(model, ECFG, min_frames=XCFG.min_frames, device="cpu",
                             capture=False)
    want = eag.extract_utterances(feats)
    assert graphs.call_counts == {"captures": 0, "replays": 0}
    first = cap.extract_utterances(feats)
    ladder = bucket_ladder(ECFG, XCFG.min_frames)
    # one capture a bucket; the second bucket's second batch replays
    assert graphs.call_counts == {"captures": len(ladder), "replays": 1}
    second = cap.extract_utterances(feats)
    assert graphs.call_counts == {"captures": len(ladder), "replays": 2 + len(ladder)}
    assert _equal(first, want) and _equal(second, want)
    assert all(v.dtype == np.float32 for v in second.values())
    assert len(cap.graphs.graphs) == len(ladder) == strict.captured


def test_weights_loaded_in_place_replay_and_moved_weights_recapture(strict):
    model = _model()
    feats = _features()
    cap = EmbeddingExtractor(model, ECFG, min_frames=XCFG.min_frames, device="cpu")
    eag = EmbeddingExtractor(model, ECFG, min_frames=XCFG.min_frames, device="cpu",
                             capture=False)
    cap.extract_utterances(feats)
    n = len(cap.graphs.graphs)
    model.load_state_dict(_model(seed=5).state_dict())
    assert _equal(cap.extract_utterances(feats), eag.extract_utterances(feats))
    assert graphs.call_counts["captures"] == n  # no new capture
    old = next(iter(cap.graphs.graphs.values()))
    model.to(torch.float64).to(torch.float32)  # new storage
    model.load_state_dict(_model(seed=6).state_dict())
    assert _equal(cap.extract_utterances(feats), eag.extract_utterances(feats))
    assert graphs.call_counts["captures"] == 2 * n and len(cap.graphs.graphs) == n
    # the old graph is bound to the replaced weights: its replay reads them
    x = torch.randn(old.args[1].shape)  # its bucket's rows (the rung) x 25 frames
    m = torch.ones(x.shape[:2], dtype=torch.bool)
    assert not torch.equal(old.run([model, x, m]), eag.graphs(model, x, m))


def test_key_follows_storage_dtype_training_bucket_and_flags():
    model = _model().eval()
    calls = EmbeddingExtractor(model, ECFG, device="cpu").graphs
    f, m = torch.zeros((8, 50, XCFG.feat_dim)), torch.ones((8, 50), dtype=torch.bool)
    key = calls.key([model, f, m])
    assert calls.key([model, f, m]) == key
    assert calls.key([model, f[:, :25], m[:, :25]])[0] != key[0]  # the bucket
    model.load_state_dict(_model(seed=3).state_dict())  # in place
    assert calls.key([model, f, m]) == key
    model.train()
    assert calls.key([model, f, m])[0] != key[0]
    model.eval()
    model.to(torch.float64)
    dtype_key = calls.key([model, f, m])
    assert dtype_key[1] != key[1]
    model.to(torch.float32)  # back to float32, on new storage
    assert calls.key([model, f, m])[1] not in (key[1], dtype_key[1])
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    key = calls.key([model, f, m])
    try:
        for flip in ("matmul", "cudnn"):
            torch.backends.cuda.matmul.allow_tf32 = (not matmul) if flip == "matmul" else matmul
            torch.backends.cudnn.allow_tf32 = (not cudnn) if flip == "cudnn" else cudnn
            assert calls.key([model, f, m])[0] != key[0], flip
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    assert calls.key([model, f, m]) == key


def test_capture_true_raises_on_the_cpu_and_with_a_mesh():
    from torch_dist import cpu_world_mesh

    model = _model()
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        EmbeddingExtractor(model, ECFG, device="cpu", capture=True)
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        tp.extract_and_score(model, None, _features(), ECFG, XCFG.min_frames, device="cpu",
                             capture=True)
    _, state = _xvec_state()
    f, lab = _batch(np.random.default_rng(1), n=8)
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        make_eval_step(capture=True)(state, f, lab)
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        graphs.CallGraphs(lambda x: x + 1, capture=True, device="cpu")(torch.ones(2))
    with cpu_world_mesh() as mesh:
        with pytest.raises(ValueError, match="capture=True with a mesh"):
            EmbeddingExtractor(model, ECFG, device="cpu", mesh=mesh, capture=True)
        with pytest.raises(ValueError, match="capture=True with a mesh"):
            make_eval_step(mesh=mesh, capture=True)
        ext = EmbeddingExtractor(model, ECFG, min_frames=XCFG.min_frames, mesh=mesh)
        assert ext.graphs.capture is False
        assert not hasattr(make_eval_step(mesh=mesh), "graphs")


def test_failed_capture_raises_and_runs_no_eager_call(monkeypatch):
    monkeypatch.setattr(graphs, "BACKEND", _Failing())
    graphs.reset_counts()
    ext = EmbeddingExtractor(_model(), ECFG, min_frames=XCFG.min_frames, device="cpu")

    def eager(*args):
        raise AssertionError("the eager forward ran in place of the capture")

    ext.graphs.eager = eager
    with pytest.raises(graphs.GraphCaptureError, match="capture=False"):
        ext.extract_utterances(_features())
    assert ext.graphs.graphs == {} and graphs.call_counts == {"captures": 0, "replays": 0}


# ------------------------------------------------------------ replay hooks and launches


def test_launches_count_through_replays(strict):
    """A wrapper counted with `count_launch` inside a captured function:
    once for the eager warm-up, none for the capture, once a replay."""
    wrapper = types.SimpleNamespace(launches=0)
    seen = []

    def fn(x):
        graphs.count_launch(wrapper)
        y = x * 2
        if not graphs.on_replay(lambda: seen.append(float(y.sum()))):
            seen.append(-1.0)
        return y

    calls = graphs.CallGraphs(fn, device="cpu")
    for i in range(4):
        assert torch.equal(calls(torch.full((3,), float(i))), torch.full((3,), 2.0 * i))
    assert wrapper.launches == 4 and seen == [-1.0, 6.0, 12.0, 18.0]
    graphs.count_launch(wrapper)  # outside any capture: at once
    assert wrapper.launches == 5
    assert graphs.counts == graphs.call_counts == {"captures": 1, "replays": 3}


def test_packed_host_tensors_and_numpy_reach_the_static_buffers_equal(strict):
    """One graph takes a batch packed into host buffers (`device.pack_rows`)
    and the same batch as numpy arrays: both reach its static buffers equal,
    and give the same outputs."""
    from sepi_tpu_torch.device import host_buffer, pack_rows

    rng = np.random.default_rng(3)
    rows = [rng.standard_normal((n, 3)).astype(np.float32) for n in (5, 2, 7)]
    feats = host_buffer((4, 8, 3), torch.float32, "cpu")
    mask = host_buffer((4, 8), torch.bool, "cpu")
    pack_rows(feats, rows, mask=mask)
    calls = graphs.CallGraphs(lambda f, m: f.sum(-1) * m, device="cpu")
    first = calls(feats, mask)  # the capture
    (g,) = calls.graphs.values()
    packed = [a.clone() for a in g.args]
    for a in g.args:
        a.zero_()
    second = calls(feats.numpy().copy(), mask.numpy().copy())  # a replay from numpy
    assert graphs.call_counts == {"captures": 1, "replays": 1} and len(calls.graphs) == 1
    assert all(torch.equal(a, b) for a, b in zip(g.args, packed))
    assert torch.equal(packed[0], feats) and torch.equal(packed[1], mask)
    assert torch.equal(first, second)


# ------------------------------------------------------------ the frontend chain


def _audio(n_same=20, n_odd=3, seed=2):
    rng = np.random.default_rng(seed)
    lengths = list(rng.integers(9000, 10500, n_same)) + list(rng.integers(4000, 20000, n_odd))
    return {f"a{i:02d}": (rng.standard_normal(n) * 1000 * (1.2 + np.sin(np.arange(n) / 500.0))
                          ).astype(np.float32) for i, n in enumerate(lengths)}


@pytest.mark.parametrize("case", ["dithered", "undithered", "deltas", "stepwise"])
def test_captured_frontend_chain_equals_eager(strict, case):
    cfg, mode, key, transform = {
        "dithered": (FrontendConfig(), "auto", 5, None),
        "undithered": (FrontendConfig(dither=0.0), "auto", None, None),
        "deltas": (MFCC_SRE_IVECTOR, "auto", None, lambda f, m: add_deltas(f, m, order=2)),
        "stepwise": (FrontendConfig(), "slices", 5, None),
    }[case]
    fe = FeatureExtractor(cfg, "cpu", spectral_mode=mode)
    audio = _audio()

    def run(capture):
        return list(tp._frontend_batches(audio, fe, VadConfig(), CmvnConfig(), key, 4,
                                         transform=transform, capture=capture))

    got, want = run(None), run(False)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g[0] == w[0] and all(np.array_equal(a, b) for a, b in zip(g[1:], w[1:]))
        assert g[1].shape[-1] == cfg.num_ceps * (3 if transform else 1)
    shapes = len({g[1].shape for g in got})
    assert graphs.call_counts == {"captures": shapes, "replays": len(got) - shapes}
    assert graphs.call_counts["replays"] > 0


def test_public_frontends_go_through_the_graphs(strict):
    audio = _audio(n_same=8, n_odd=1)
    feats = tp.prepare_features_nosil(audio, FrontendConfig(), key=3, batch_size=4,
                                      device="cpu")
    assert graphs.call_counts["captures"] > 0 and graphs.call_counts["replays"] > 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "BACKEND", graphs._Cuda())  # the CPU runs eagerly
        want = tp.prepare_features_nosil(audio, FrontendConfig(), key=3, batch_size=4,
                                         device="cpu")
    assert _equal(feats, want)


# ------------------------------------------------------------ the kept frontend graphs

# ECAPA-TDNN's 16 kHz, 80 x 80 frontend (benchmark/configs/ecapa_c1024.json)
VOX16K = FrontendConfig(sample_rate=16000, num_mel_bins=80, num_ceps=80, high_freq=7600.0)


def _bytes(batches):
    return [(names, *(a.tobytes() for a in arrays)) for names, *arrays in batches]


def test_second_call_replays_kept_frontend_graphs(strict):
    """A second `prepare_features_nosil` of the same shapes captures nothing
    and replays every batch; its features, and a second chain's features,
    voiced masks and frame counts, are byte-equal to the first call's and
    to capture=False."""
    audio = _audio(n_same=8, n_odd=3)
    first = tp.prepare_features_nosil(audio, FrontendConfig(), key=3, batch_size=4, device="cpu")
    batches = len(audio) // 4 + 1
    shapes = graphs.call_counts["captures"]
    assert 1 < shapes < batches and graphs.call_counts["replays"] == batches - shapes
    assert graphs.live_graphs() >= shapes and len(tp._KEPT) == shapes
    graphs.reset_counts()
    second = tp.prepare_features_nosil(audio, FrontendConfig(), key=3, batch_size=4,
                                       device="cpu")
    assert graphs.call_counts == {"captures": 0, "replays": batches}
    assert strict.captured == shapes
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "BACKEND", graphs._Cuda())  # the CPU runs eagerly
        want = tp.prepare_features_nosil(audio, FrontendConfig(), key=3, batch_size=4,
                                         device="cpu")
    assert sorted(first) == sorted(second) == sorted(want)
    assert all(first[u].tobytes() == second[u].tobytes() == want[u].tobytes() for u in want)
    # a new FeatureExtractor of the same frontend: the same kept graphs
    fe = FeatureExtractor(FrontendConfig(), "cpu")
    kept = _bytes(tp._frontend_batches(audio, fe, VadConfig(), CmvnConfig(), 3, 4))
    eager = _bytes(tp._frontend_batches(audio, fe, VadConfig(), CmvnConfig(), 3, 4,
                                        capture=False))
    assert kept == eager and len(kept) == batches
    assert graphs.call_counts == {"captures": 0, "replays": 2 * batches}


def test_kept_entries_per_frontend_and_dither(strict):
    """The 8 kHz 23-dim and 16 kHz 80-dim frontends, dithered and not, keep
    an entry each; a second round of the four captures nothing."""
    audio = _audio(n_same=4, n_odd=0)
    cfgs = [FrontendConfig(), FrontendConfig(dither=0.0), VOX16K,
            dataclasses.replace(VOX16K, dither=0.0)]

    def round_():
        return [tp.prepare_features_nosil(audio, c, key=5, batch_size=4, device="cpu")
                for c in cfgs]

    first = round_()
    assert graphs.call_counts == {"captures": 4, "replays": 0}
    assert len(tp._KEPT) == 4 and all(len(r.graphs) == 1 for r, _ in tp._KEPT.values())
    assert {k[0] for k in tp._KEPT} == set(cfgs)
    second = round_()
    assert graphs.call_counts == {"captures": 4, "replays": 4}
    for a, b in zip(first, second):
        assert all(a[u].tobytes() == b[u].tobytes() for u in a)
    # each frontend's own features: the four differ
    u = sorted(audio)[0]
    assert len({f[u].shape[-1] for f in first}) == 2
    assert not np.array_equal(first[0][u], first[1][u])


def test_kept_graphs_bounded_least_recently_used_first(strict, monkeypatch):
    """At most `KEPT_GRAPHS` over every frontend: a width used again is kept
    over one used less recently, and `live_graphs` never exceeds the
    bound."""
    monkeypatch.setattr(tp, "KEPT_GRAPHS", 3)
    rng = np.random.default_rng(4)
    # one utterance a call, at the widths 4000, 8000, 12000, 16000 samples
    calls = {w: {f"w{w}": (rng.standard_normal(w - 100) * 1000).astype(np.float32)}
             for w in (4000, 8000, 12000, 16000)}
    base = graphs.live_graphs()

    def call(w, cfg=FrontendConfig()):
        before = graphs.call_counts["captures"]
        tp.prepare_features_nosil(calls[w], cfg, key=1, batch_size=4, device="cpu")
        assert graphs.live_graphs() - base <= 3
        return graphs.call_counts["captures"] - before

    def widths():
        return sorted(g.args[0].shape[1] for r, _ in tp._KEPT.values() for g in r.graphs.values())

    assert [call(w) for w in (4000, 8000, 12000)] == [1, 1, 1]
    assert call(4000) == 0  # used again: now the most recent
    assert call(16000) == 1 and widths() == [4000, 12000, 16000]  # 8000 let go
    assert call(8000) == 1 and widths() == [4000, 8000, 16000]  # then 12000
    assert call(4000) == 0
    # another frontend's graph counts against the same bound, and takes the oldest
    assert call(4000, FrontendConfig(dither=0.0)) == 1
    assert widths() == [4000, 4000, 8000]
    assert {k[0] for k in tp._KEPT} == {FrontendConfig(), FrontendConfig(dither=0.0)}
    for w in (12000, 16000):
        call(w, FrontendConfig(dither=0.0))
    assert {k[0] for k in tp._KEPT} == {FrontendConfig(dither=0.0)}
    assert widths() == [4000, 12000, 16000]


def test_kept_frontend_graphs_shared_by_threads(monkeypatch):
    """Eight threads run one frontend at once, switching every microsecond:
    each batch shape is captured once, and every thread's features are
    byte-equal to the eager ones (a lost update to `_KEPT` or a static
    buffer overwritten between another thread's copy in and replay would
    break either)."""
    backend = _Rerun()  # `_Strict` patches `torch.from_numpy` for every thread
    audio = _audio(n_same=8, n_odd=3)
    want = tp.prepare_features_nosil(audio, FrontendConfig(), key=3, batch_size=4, device="cpu")
    shapes = {samples.shape for _, samples, _ in tp.padded_audio_batches(audio, 4)}
    monkeypatch.setattr(graphs, "BACKEND", backend)
    monkeypatch.setattr(tp, "_KEPT", {})
    got, errors = [None] * 8, []

    def work(i):
        try:
            got[i] = tp.prepare_features_nosil(audio, FrontendConfig(), key=3, batch_size=4,
                                               device="cpu")
        except Exception as e:  # reported below, with the thread's number
            errors.append((i, e))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(got))]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert backend.captured == len(tp._KEPT) == len(shapes)
    for g in got:
        assert sorted(g) == sorted(want)
        assert all(g[u].tobytes() == want[u].tobytes() for u in want)


def test_capture_false_and_the_cpu_keep_nothing(strict):
    audio = _audio(n_same=4, n_odd=1)
    fe = FeatureExtractor(FrontendConfig(), "cpu")
    list(tp._frontend_batches(audio, fe, VadConfig(), CmvnConfig(), 3, 4, capture=False))
    assert tp._KEPT == {} and graphs.call_counts == {"captures": 0, "replays": 0}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "BACKEND", graphs._Cuda())  # the CPU runs eagerly
        tp.prepare_features_nosil(audio, FrontendConfig(), key=3, batch_size=4, device="cpu")
        with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
            list(tp._frontend_batches(audio, fe, VadConfig(), CmvnConfig(), 3, 4, capture=True))
    assert tp._KEPT == {} and graphs.call_counts == {"captures": 0, "replays": 0}
    assert strict.captured == 0


# ------------------------------------------------------------ the eval step


def test_captured_eval_step_equals_eager(strict):
    _, state = _xvec_state()
    ev, ev_e = make_eval_step(), make_eval_step(capture=False)
    rng = np.random.default_rng(4)
    batches = [_batch(rng, n=8, t=t) for t in (24, 24, 30, 30)]
    for f, lab in batches:
        state.model.train()  # a training step leaves the model so
        got, want = ev(state, f, lab), ev_e(state, f, lab)
        assert set(got) == {"objf", "accuracy"}
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert len(ev.graphs.graphs) == 2
    assert graphs.call_counts == {"captures": 2, "replays": 2}
    assert not state.model.training


# ------------------------------------------------------------ the bench's programs


def test_bench_programs_are_captured_and_equal_eager(strict):
    rng = np.random.default_rng(0)
    ext = bench.bench_extraction(rng, device="cpu", shapes=SMALL, repeats=1)
    # the capturing call and the checked replay, then the timed replays
    assert graphs.call_counts["captures"] == 1
    assert graphs.call_counts["replays"] == 1 + SMALL.warmup + SMALL.extract_iters
    assert ext.calls == 2 + 2 * (SMALL.warmup + SMALL.extract_iters)
    fe = FeatureExtractor(FrontendConfig(), "cpu")
    from sepi_tpu_torch.ops.dither import utt_seeds
    from sepi_tpu_torch.ops.framing import num_frames

    n = ext.samples.shape[1]
    chain = bench.extraction_chain(fe, int(num_frames(n, FrontendConfig())))
    seeds = torch.from_numpy(utt_seeds([f"bench{i}" for i in range(SMALL.utts)]))
    with torch.no_grad():
        want = chain(ext.model, torch.from_numpy(ext.samples),
                     torch.full((SMALL.utts,), n, dtype=torch.int32), seeds)[0]
    assert torch.equal(ext.embeddings, want)
    extra = {}
    pl = bench.bench_plda_scoring(rng, extra, device="cpu", shapes=SMALL, repeats=1)
    assert graphs.call_counts["captures"] == 2
    params = [torch.from_numpy(np.asarray(a, np.float32))
              for a in (pl.plda.mean, pl.plda.transform, pl.plda.psi)]
    want = bench.plda_scoring(torch.device("cpu"))(*params, torch.from_numpy(pl.models),
                                                   torch.from_numpy(pl.tests))
    assert torch.equal(pl.scores, want) and pl.block_err <= bench.PLDA_RTOL


# ------------------------------------------------------------ against the reference


@pytest.fixture(scope="module")
def captured_slice():
    """`test_torch_slice.both` with the port's frontend and extraction
    captured (replayed by re-running)."""
    kw = dict(num_speakers=4, utts_per_speaker=3, duration_sec=2.0)
    jc, tc = j_corpus(**kw), make_synthetic_corpus(**kw)
    j_nosil = jp.prepare_features_nosil(jc.audio, JFrontend(dither=0.0))
    jmodel = JXVector(JConfig(feat_dim=23, num_speakers=0,
                              frame_specs=tuple(JSpec(d, o) for d, o in SPECS), embed_dim=32))
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 40, 23)), train=False))
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.normal(size=x.shape) * 0.2 if p[-1].key == "mean"
                      else rng.uniform(0.5, 2.0, size=x.shape)).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    state = types.SimpleNamespace(params=variables["params"], batch_stats=stats)
    j_embs = jp.extract_and_score(jmodel, state, j_nosil)
    tmodel = XVector(XVectorConfig(feat_dim=23, num_speakers=0,
                                   frame_specs=tuple(TdnnSpec(d, o) for d, o in SPECS),
                                   embed_dim=32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "BACKEND", _Strict())
        mp.setattr(tp, "_KEPT", {})
        graphs.reset_counts()
        # batches of 4 of the 12 equal-length utterances: a capture, then replays
        t_nosil = tp.prepare_features_nosil(tc.audio, FrontendConfig(dither=0.0), batch_size=4,
                                            device="cpu")
        t_embs = tp.extract_and_score(tmodel, xvector_state_dict_from_flax(variables), t_nosil,
                                      device="cpu")
        counts = dict(graphs.call_counts)
    enroll = {s: us[:1] for s, us in jc.dataset.spk2utt.items()}
    j_res, _ = jp.backend_eval(j_embs, jc.dataset, jc.trials, enroll, JBackend())
    t_res, _ = tp.backend_eval(t_embs, tc.dataset, tc.trials, enroll, BackendConfig())
    return dict(j_nosil=j_nosil, t_nosil=t_nosil, j_embs=j_embs, t_embs=t_embs, j_res=j_res,
                t_res=t_res, counts=counts)


def test_captured_path_ran_as_replays(captured_slice):
    c = captured_slice["counts"]
    assert c["captures"] > 0 and c["replays"] > 0


def test_captured_features_match_reference(captured_slice):
    j, t = captured_slice["j_nosil"], captured_slice["t_nosil"]
    assert sorted(j) == sorted(t)
    for u in j:
        assert t[u].shape == j[u].shape, u
        assert np.abs(t[u] - j[u]).max() <= 1e-3, u


def test_captured_embeddings_match_reference(captured_slice):
    j, t = captured_slice["j_embs"], captured_slice["t_embs"]
    assert sorted(j) == sorted(t)
    for u in j:
        rel = np.abs(t[u] - j[u]).max() / np.abs(j[u]).max()
        assert rel <= 1e-3, (u, rel)


def test_captured_eer_within_one_target_trial(captured_slice):
    j, t = captured_slice["j_res"], captured_slice["t_res"]
    assert (t.num_target, t.num_nontarget) == (j.num_target, j.num_nontarget)
    assert abs(t.eer - j.eer) <= 1.0 / j.num_target, (t.eer, j.eer)
