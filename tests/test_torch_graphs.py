"""The compiled training step (`sepi_tpu_torch.train.graphs`) on the CPU.

A CUDA graph needs the card, so these tests hold what surrounds it:
- the optimizer chain's per-step scalars, the rows a captured step
  reads, bit-equal to `lr_schedule`, `_bias_correction` and the shrink
  factor for every count, past ``total_steps`` and past 17,321 (where
  1 - 0.999^c first rounds to 1 in float32);
- the chain reading those rows as tensors, bit-equal to the host floats;
- the eager step after the refactor against the reference's jitted step
  (`tests/test_torch_train.py`'s measures and tolerances);
- `graph_key` as a plain function: it changes with the state's identity
  (`clone()`, a loaded ``opt_state``), the batch's shape, the task and
  the TF32 flags, and not after `load_state_dict`;
- the factories: ``capture=True`` raises on a CPU state and with a mesh,
  and a capture that fails raises without running the eager step;
- the capture machinery (warm-up and restore, static buffers, the scalar
  rows, the step counts, fresh metrics, one graph per key) with the CUDA
  calls replaced by a graph that replays by running its function again:
  its trajectory is the eager one, bit for bit.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu_torch.config import OptimizerConfig
from sepi_tpu_torch.models import XVector
from sepi_tpu_torch.train import (build_optimizer, load_checkpoint, lr_schedule, make_superstep,
                                  make_xvec_step, save_checkpoint)
from sepi_tpu_torch.train import graphs
from sepi_tpu_torch.train.optim import (ADAM_B1, ADAM_B2, StepScalars, _bias_correction,
                                        _shrink_factor)
from sepi_tpu_torch.train.trainer import TrainState
from test_torch_train import OPT, PARAM_TOL, TCFG, _batch, _leaves, _port, _setup

torch.set_num_threads(2)

SATURATES = 17321  # the first count at which 1 - 0.999^c is 1.0 in float32


# ------------------------------------------------------------ the chain's scalars


def _host_row(cfg, total, mult, c):
    lr = lr_schedule(cfg, total, mult)(c)
    beta = max(cfg.momentum, 0.9)
    exponent = min(1.0, cfg.shrink_iterations / max(total, 1))
    bc = dict(bc_beta_c1=_bias_correction(beta, c + 1), bc_beta_c2=_bias_correction(beta, c + 2),
              bc_b1_c1=_bias_correction(ADAM_B1, c + 1), bc_b1_c2=_bias_correction(ADAM_B1, c + 2),
              bc_b2_c1=_bias_correction(ADAM_B2, c + 1))
    inv = {"inv" + k[2:]: float(np.float32(1) / np.float32(v)) for k, v in bc.items()}
    return dict(lr=lr, shrink=_shrink_factor(cfg.proportional_shrink, lr, exponent), **bc, **inv)


@pytest.mark.parametrize("opt,total,mult", [("muon", 60, 1.0), ("none", 1000, 4.0),
                                            ("muon", 20000, 1.0)])
def test_scalar_rows_equal_the_host_floats(opt, total, mult):
    cfg = OptimizerConfig(**OPT[opt], momentum=0.95 if opt == "none" else 0.5)
    chain, _ = build_optimizer(cfg, total, mult)
    starts = sorted({0, 1, total - 3, total + 5, SATURATES - 4, 30000})
    for c0 in starts:
        rows = chain.scalar_rows(c0, 8)
        assert rows.dtype == np.float32 and rows.shape == (8, len(StepScalars._fields))
        for i, row in enumerate(rows):
            want = _host_row(cfg, total, mult, c0 + i)
            got = StepScalars(*torch.from_numpy(row).unbind(0))
            for name, value in want.items():
                # the device number is the host's float32, bit for bit
                assert float(getattr(got, name)) == value, (c0 + i, name)
                assert np.float32(value) == value, name
            assert chain.scalars(c0 + i)._asdict() == want
    # the lr clamps at total_steps; Adam's b2 correction saturates at SATURATES
    assert chain.scalars(total + 7).lr == chain.scalars(total).lr
    assert _bias_correction(ADAM_B2, SATURATES) == 1.0 > _bias_correction(ADAM_B2, SATURATES - 1)


def _params_and_grads(seed, count):
    """A narrow x-vector's parameters and a seeded gradient of each."""
    model = XVector(TCFG)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)))
    params = dict(model.named_parameters())
    grads = [{n: torch.from_numpy(rng.normal(size=p.shape).astype(np.float32) * 10.0 ** -i)
              for n, p in params.items()} for i in range(count)]
    return params, grads


@pytest.mark.parametrize("opt,lr_factors,start", [
    ("muon", None, 0), ("muon", {"segment/tdnn6": 0.5}, SATURATES - 3),
    ("none", None, 0), ("none", {"frames": 0.25}, 70),
])
def test_chain_reads_device_rows_like_host_floats(opt, lr_factors, start):
    """The same updates and state, bit for bit, whether the chain
    computes its scalars on the host or reads them from a row."""
    kw = dict(OPT[opt])
    if opt == "none":
        kw["l2_regularize"] = 1e-3
    chain, _ = build_optimizer(OptimizerConfig(**kw), 60, lr_factors=lr_factors)
    sides = []
    for use_rows in (False, True):
        params, grads = _params_and_grads(4, 4)
        state = chain.init(params)
        state["count"] = start
        ups = []
        for g in grads:
            row = torch.from_numpy(chain.scalar_rows(state["count"]))[0] if use_rows else None
            ups.append(chain.update(g, state, params, row))
        sides.append((ups, state))
    (ups_a, st_a), (ups_b, st_b) = sides
    assert st_a["count"] == st_b["count"] == start + 4
    for ua, ub in zip(ups_a, ups_b):
        for n in ua:
            assert torch.equal(ua[n], ub[n]), n
    for key in st_a:
        if key != "count":
            for n in st_a[key]:
                assert torch.equal(st_a[key][n], st_b[key][n]), (key, n)


# ------------------------------------------------------------ the graph key


def _xvec_state(seed=0):
    chain, _ = build_optimizer(OptimizerConfig(**OPT["muon"]), 60)
    model = XVector(TCFG)
    torch.manual_seed(seed)
    return chain, TrainState(model, chain.init(dict(model.named_parameters())))


def test_graph_key_follows_the_state_identity(tmp_path):
    _, state = _xvec_state()
    f, l = (torch.from_numpy(x) for x in _batch(np.random.default_rng(1), n=8))
    key = graphs.graph_key(state, {}, f, l)
    assert graphs.graph_key(state, {}, f, l) == key
    assert graphs.graph_key(state.clone(), {}, f, l) != key
    # load_state_dict copies in place: the same tensors, the same graph
    other = state.clone()
    with torch.no_grad():
        for p in other.model.parameters():
            p.add_(1.0)
    state.model.load_state_dict(other.model.state_dict())
    assert graphs.graph_key(state, {}, f, l) == key
    # a loaded checkpoint replaces the optimizer state's tensors
    save_checkpoint(state, str(tmp_path), 0)
    loaded = load_checkpoint(state, str(tmp_path))
    state.opt_state = loaded.opt_state
    assert graphs.graph_key(state, {}, f, l) != key


def test_graph_key_follows_shapes_task_k_and_flags():
    _, state = _xvec_state()
    f, l = (torch.from_numpy(x) for x in _batch(np.random.default_rng(1), n=8))
    key = graphs.graph_key(state, {}, f, l)
    assert graphs.graph_key(state, {}, f[:, :20], l) != key
    assert graphs.graph_key(state, {}, f[:4], l[:4]) != key
    assert graphs.graph_key(state, {"task": "xvec"}, f, l) != key
    assert graphs.graph_key(state, {"task": "xvec"}, f, l) != \
        graphs.graph_key(state, {"task": "am"}, f, l)
    assert graphs.graph_key(state, {}, f, l.long()) != key
    assert graphs.graph_key(state, {}, f[None], l[None], 1) != \
        graphs.graph_key(state, {}, f[None], l[None])
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        for flip in ("matmul", "cudnn"):
            torch.backends.cuda.matmul.allow_tf32 = (not matmul) if flip == "matmul" else matmul
            torch.backends.cudnn.allow_tf32 = (not cudnn) if flip == "cudnn" else cudnn
            assert graphs.graph_key(state, {}, f, l) != key, flip
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    assert graphs.graph_key(state, {}, f, l) == key


# ------------------------------------------------------------ the factories


def test_capture_true_raises_on_a_cpu_state_and_with_a_mesh():
    from torch_dist import cpu_world_mesh

    chain, state = _xvec_state()
    f, l = (torch.from_numpy(x) for x in _batch(np.random.default_rng(1), n=8))
    for make in (make_xvec_step, make_superstep):
        step = make(chain, capture=True)
        args = (f, l, 1.0) if make is make_xvec_step else (f[None], l[None], torch.ones(1))
        with pytest.raises(ValueError, match="capture=True needs a CUDA state"):
            step(state, *args)
    assert state.step == 0 and state.opt_state["count"] == 0
    with cpu_world_mesh() as mesh:
        for make in (make_xvec_step, make_superstep):
            with pytest.raises(ValueError, match="capture=True with a mesh"):
                make(chain, mesh=mesh, capture=True)
            assert not isinstance(make(chain, mesh=mesh), graphs.StepGraphs)
    assert isinstance(make_xvec_step(chain), graphs.StepGraphs)
    assert not isinstance(make_xvec_step(chain, capture=False), graphs.StepGraphs)


class _RerunGraph:
    """Replays by running the captured function again on the CPU."""

    def __init__(self, fn):
        self.fn, self.out = fn, fn()

    def replay(self):
        self.out.copy_(self.fn())


class _Rerun:
    """`graphs.BACKEND` for the CPU: no stream, and `_RerunGraph`."""

    def __init__(self):
        self.captured = 0

    def capturable(self, dev):
        return True

    def side_stream(self, dev):
        return contextlib.nullcontext()

    def pool(self, dev):
        return None

    def capture(self, dev, fn, pool):
        self.captured += 1
        g = _RerunGraph(fn)
        return g, g.out


class _Failing(_Rerun):
    def capture(self, dev, fn, pool):
        raise RuntimeError("operation not permitted when stream is capturing")


def _values(state):
    return [t.clone() for t in graphs.state_tensors(state)]


@pytest.mark.parametrize("superstep", [False, True])
def test_failed_capture_raises_and_runs_no_eager_step(monkeypatch, superstep):
    monkeypatch.setattr(graphs, "BACKEND", _Failing())
    chain, state = _xvec_state()
    before = _values(state)
    f, l = (torch.from_numpy(x) for x in _batch(np.random.default_rng(1), n=8))
    step = (make_superstep if superstep else make_xvec_step)(chain)

    def eager(*args):
        raise AssertionError("the eager step ran in place of the capture")

    step.eager = eager
    args = (f[None], l[None], torch.ones(1)) if superstep else (f, l, 1.0)
    with pytest.raises(graphs.GraphCaptureError, match="capture=False"):
        step(state, *args)
    # the warm-up's steps are undone, and no step counted
    assert all(torch.equal(a, b) for a, b in zip(before, _values(state)))
    assert state.step == 0 and state.opt_state["count"] == 0
    assert step.graphs == {}


# ------------------------------------------------------------ the capture machinery


@pytest.mark.parametrize("opt", ["muon", "none"])
def test_replayed_steps_equal_eager_steps(monkeypatch, opt):
    """Single steps of two chunk lengths in turn (two graphs of one step
    function) and a K = 3 superstep, replayed, against the eager steps
    from the same state: every state tensor and metric equal."""
    backend = _Rerun()
    monkeypatch.setattr(graphs, "BACKEND", backend)
    graphs.reset_counts()
    _, (chain, s_graph, _), _ = _setup(opt)
    s_eager = s_graph.clone()
    rng = np.random.default_rng(3)
    seq = [_batch(rng, n=16, t=30 if i % 2 else 24) for i in range(4)]
    seq += [_batch(rng, n=16) for _ in range(3)]
    step, sstep = make_xvec_step(chain), make_superstep(chain)
    e_step, e_sstep = make_xvec_step(chain, capture=False), make_superstep(chain, capture=False)
    got, want = [], []
    for f, l in seq[:4]:
        f, l = torch.from_numpy(f), torch.from_numpy(l)
        got.append(step(s_graph, f, l, torch.tensor(0.5)))
        want.append(e_step(s_eager, f, l, torch.tensor(0.5)))
    stacked = [torch.from_numpy(np.stack(x)) for x in zip(*seq[4:])]
    got.append(sstep(s_graph, *stacked, torch.ones(3)))
    want.append(e_sstep(s_eager, *stacked, torch.ones(3)))
    # a capture for each chunk length and one for the superstep; the rest replays
    assert backend.captured == 3 and graphs.counts == {"captures": 3, "replays": 5}
    assert len(step.graphs) == 2 and len(sstep.graphs) == 1
    assert s_graph.step == s_eager.step == 7
    assert s_graph.opt_state["count"] == s_eager.opt_state["count"] == 7
    for g, w in zip(got, want):  # earlier metrics are not overwritten by later replays
        assert set(g) == set(w) == {"objf", "accuracy", "grad_norm"}
        for m in g:
            assert g[m].shape == w[m].shape and torch.equal(g[m], w[m]), m
    for a, b in zip(_values(s_graph), _values(s_eager)):
        assert torch.equal(a, b)


def test_recapture_after_clone_and_checkpoint(monkeypatch, tmp_path):
    monkeypatch.setattr(graphs, "BACKEND", _Rerun())
    _, (chain, state, _), _ = _setup("muon")
    step, e_step = make_xvec_step(chain), make_xvec_step(chain, capture=False)
    rng = np.random.default_rng(5)
    f, l = (torch.from_numpy(x) for x in _batch(rng, n=16))
    step(state, f, l, 1.0)
    save_checkpoint(state, str(tmp_path), state.step)
    step(state, f, l, 1.0)
    assert len(step.graphs) == 1
    for other in (state.clone(), load_checkpoint(state, str(tmp_path))):
        ref = other.clone()
        m = step(other, f, l, 1.0)
        w = e_step(ref, f, l, 1.0)
        assert all(torch.equal(m[k], w[k]) for k in m)
        assert all(torch.equal(a, b) for a, b in zip(_values(other), _values(ref)))
    assert len(step.graphs) == 3
    # load_state_dict keeps the tensors: no new capture
    state.model.load_state_dict(load_checkpoint(state, str(tmp_path)).model.state_dict())
    step(state, f, l, 1.0)
    assert len(step.graphs) == 3


def test_replayed_step_matches_reference():
    """The captured path (replayed on the CPU) against the reference's
    jitted step: three momentum-SGD steps, metrics and the trajectory at
    `tests/test_torch_train.py`'s limits."""
    mp = pytest.MonkeyPatch()
    mp.setattr(graphs, "BACKEND", _Rerun())
    try:
        (_, _, jstate, jstep), (_, tstate, tstep), init = _setup("none")
        assert isinstance(tstep, graphs.StepGraphs)
        rng = np.random.default_rng(7)
        for i in range(3):
            feats, labels = _batch(rng)
            jstate, jm = jstep(jstate, feats, labels, jnp.float32(1.0))
            tm = tstep(tstate, torch.from_numpy(feats), torch.from_numpy(labels), 1.0)
            for k in ("objf", "accuracy", "grad_norm"):
                assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-5), (i, k)
        assert len(tstep.graphs) == 1 and tstate.step == int(jstate.step) == 3
    finally:
        mp.undo()
    ref, port, p0 = _leaves(jstate.params), _leaves(_port(tstate.model)["params"]), \
        _leaves(init["params"])
    for k, r in ref.items():
        rel = np.linalg.norm(port[k] - r) / np.linalg.norm(r - p0[k])
        assert rel <= PARAM_TOL, (k, rel)
