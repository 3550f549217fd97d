"""Port parity: the training step, supersteps, the Trainer and the
batch-norm conventions against `sepi_tpu.train`.

A narrow x-vector starts from the reference's Flax initialisation
(bridged), and both packages train on the same numpy batches.  Measures:
- metrics of one step: objf and accuracy within 1e-5;
- parameters after 3 momentum-SGD steps: ||p_port - p_ref|| /
  ||p_ref - p_init|| <= 1e-3 over each parameter;
- the default chain (Muon + Adam) after one step: equal to 1e-4 of the
  step except on entries whose gradient is rounding noise (Adam's first
  step is ~sign(g) * lr, so such an entry flips; see that test);
- batch-norm statistics: within 1e-5 of the reference's scale, so the
  unbiased-variance convention (64/63 in the segment layers) would fail.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu.config import OptimizerConfig as JOptimizerConfig
from sepi_tpu.data.sampler import ChunkBatch as JChunkBatch
from sepi_tpu.models import XVector as JXVector
from sepi_tpu.models import XVectorConfig as JConfig
from sepi_tpu.models.tdnn import TdnnSpec as JSpec
from sepi_tpu.train import build_optimizer as jbuild
from sepi_tpu.train import create_train_state as jcreate
from sepi_tpu.train import finalize_batch_stats as jfinalize
from sepi_tpu.train.trainer import make_xvec_step as jstep_fn
from sepi_tpu_torch.bridge import flax_variables_from_state_dict, xvector_state_dict_from_flax
from sepi_tpu_torch.config import OptimizerConfig
from sepi_tpu_torch.data import ChunkBatch
from sepi_tpu_torch.models import TdnnSpec, XVector, XVectorConfig, lecun_normal_init
from sepi_tpu_torch.train import (
    Trainer,
    TrainState,
    build_optimizer,
    finalize_batch_stats,
    make_superstep,
    make_xvec_step,
)

torch.set_num_threads(2)

SPECS = [(16, (-2, -1, 0, 1, 2)), (16, (-2, 0, 2)), (48, (0,))]
KW = dict(feat_dim=8, num_speakers=4, embed_dim=32)
JCFG = JConfig(frame_specs=tuple(JSpec(d, o) for d, o in SPECS), **KW)
TCFG = XVectorConfig(frame_specs=tuple(TdnnSpec(d, o) for d, o in SPECS), **KW)
OPT = {"muon": dict(initial_lr=0.05, final_lr=0.01, proportional_shrink=1.0),
       "none": dict(initial_lr=0.05, final_lr=0.01, proportional_shrink=1.0,
                    preconditioner="none")}
PARAM_TOL = 1e-3
STAT_TOL = 1e-5


def _batch(rng, n=32, t=30, d=8, num_spk=4):
    """Speaker-dependent offsets under unit noise.  (With noise much
    smaller than the offsets, stats pooling's E[x^2] - E[x]^2 cancels and
    amplifies float32 rounding by (mean/std)^2 in both packages.)"""
    labels = rng.integers(0, num_spk, size=n).astype(np.int32)
    centers = np.eye(num_spk, d) * 1.5
    feats = (rng.normal(size=(n, t, d)) + centers[labels][:, None, :]).astype(np.float32)
    return feats, labels


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def _setup(opt="muon", total_steps=60, seed=0):
    """The reference's state, step and the port's twin from its weights."""
    rng = np.random.default_rng(seed)
    feats, labels = _batch(rng)
    jmodel = JXVector(JCFG)
    tx, _ = jbuild(JOptimizerConfig(**OPT[opt]), total_steps)
    jstate = jcreate(jmodel, tx, jax.random.PRNGKey(0), feats[:2])
    init = {"params": _np(jstate.params), "batch_stats": _np(jstate.batch_stats)}
    model = XVector(TCFG)
    model.load_state_dict(xvector_state_dict_from_flax(init))
    chain, _ = build_optimizer(OptimizerConfig(**OPT[opt]), total_steps)
    tstate = TrainState(model, chain.init(dict(model.named_parameters())))
    return (jmodel, tx, jstate, jstep_fn(jmodel, tx)), (chain, tstate, make_xvec_step(chain)), init


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _port(model):
    return flax_variables_from_state_dict(model.state_dict())


def _assert_stats_close(port_stats, ref_stats):
    ref, port = _leaves(ref_stats), _leaves(port_stats)
    assert set(ref) == set(port)
    for k, r in ref.items():
        assert np.abs(port[k] - r).max() <= STAT_TOL * max(1.0, np.abs(r).max()), k


def test_bn_running_stats_after_a_step_equal_flax():
    """Biased batch variance and decay 0.95, as Flax: tdnn6/tdnn7 reduce
    over the batch only (n = 32), where the unbiased convention would
    differ by 32/31."""
    (jmodel, tx, jstate, jstep), (_, tstate, tstep), init = _setup()
    feats, labels = _batch(np.random.default_rng(5))
    jstate, _ = jstep(jstate, feats, labels, jnp.float32(1.0))
    tstep(tstate, torch.from_numpy(feats), torch.from_numpy(labels), 1.0)
    port = _port(tstate.model)["batch_stats"]
    _assert_stats_close(port, jstate.batch_stats)
    var6 = np.asarray(jstate.batch_stats["segment"]["tdnn6"]["batchnorm"]["var"])
    var6_init = init["batch_stats"]["segment"]["tdnn6"]["batchnorm"]["var"]
    np.testing.assert_allclose(port["segment"]["tdnn6"]["batchnorm"]["var"], var6, rtol=1e-5)
    # the unbiased update would be this far off: far outside the limit
    unbiased = var6_init * 0.95 + (var6 - 0.95 * var6_init) * 32 / 31
    assert np.abs(unbiased - var6).max() > 10 * STAT_TOL * np.abs(var6).max()


def test_ce_step_matches_reference():
    """Momentum SGD ("none"): three steps agree by the trajectory measure."""
    (_, _, jstate, jstep), (_, tstate, tstep), init = _setup("none")
    rng = np.random.default_rng(7)
    for i in range(3):
        feats, labels = _batch(rng)
        jstate, jm = jstep(jstate, feats, labels, jnp.float32(1.0))
        tm = tstep(tstate, torch.from_numpy(feats), torch.from_numpy(labels), 1.0)
        for k in ("objf", "accuracy", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-5), (i, k)
    assert tstate.step == int(jstate.step) == 3
    ref, port, p0 = _leaves(jstate.params), _leaves(_port(tstate.model)["params"]), \
        _leaves(init["params"])
    for k, r in ref.items():
        rel = np.linalg.norm(port[k] - r) / np.linalg.norm(r - p0[k])
        assert rel <= PARAM_TOL, (k, rel)
    _assert_stats_close(_port(tstate.model)["batch_stats"], jstate.batch_stats)


def _port_grads(model, feats, labels):
    """The port's loss gradient at the current weights, in Flax layout."""
    model.train()
    params = dict(model.named_parameters())
    logp = torch.log_softmax(model(torch.from_numpy(feats))["logits"], -1)
    loss = -logp[torch.arange(len(labels)), torch.from_numpy(labels).long()].mean()
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    return _leaves(flax_variables_from_state_dict({**model.state_dict(), **grads})["params"])


def test_muon_step_matches_reference_except_rounding_noise():
    """The default chain (Muon on the output matrix, Adam elsewhere).
    Adam's first update is ~1.47 lr * sign(g), so an entry whose true
    gradient is zero (the bias of a unit that is active on the whole batch
    ahead of its batch norm, chiefly in tdnn6 where the norm reduces over
    32 values) takes a full step of either sign from rounding noise, in
    any two implementations.  Every other entry agrees to 1e-4 of the
    step (the clip is active, and the reference's float32 global norm is
    ~2e-6 off); the entries that differ all have |g| below 1e-4 of their
    parameter's largest gradient.  (The reference's own tests say the same
    of Muon: it amplifies reassociation roundoff.)"""
    (_, _, jstate, jstep), (_, tstate, tstep), init = _setup("muon")
    state_before = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    feats, labels = _batch(np.random.default_rng(7))
    grads = _port_grads(tstate.model, feats, labels)
    tstate.model.load_state_dict(state_before)  # the gradient pass moved the EMA
    jstate, jm = jstep(jstate, feats, labels, jnp.float32(1.0))
    tm = tstep(tstate, torch.from_numpy(feats), torch.from_numpy(labels), 1.0)
    for k in ("objf", "accuracy", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-5), k
    ref, port, p0 = _leaves(jstate.params), _leaves(_port(tstate.model)["params"]), \
        _leaves(init["params"])
    flipped = 0
    for k, r in ref.items():
        step = np.abs(r - p0[k]).max()
        noise = np.abs(grads[k]) <= 1e-4 * np.abs(grads[k]).max()
        diff = np.abs(port[k] - r)
        assert diff[~noise].max(initial=0.0) <= 1e-4 * step, k
        flipped += int((diff > 1e-4 * step).sum())
    assert flipped < 0.01 * sum(v.size for v in ref.values())
    _assert_stats_close(_port(tstate.model)["batch_stats"], jstate.batch_stats)


def test_superstep_equals_single_steps():
    _, (chain, s_single, step), _ = _setup()
    _, (_, s_super, _), _ = _setup()
    rng = np.random.default_rng(9)
    seq = [_batch(rng, n=16) for _ in range(4)]
    singles = [step(s_single, torch.from_numpy(f), torch.from_numpy(l), 1.0) for f, l in seq]
    sup = make_superstep(chain)(s_super, torch.from_numpy(np.stack([f for f, _ in seq])),
                                torch.from_numpy(np.stack([l for _, l in seq])),
                                torch.ones(4))
    assert s_super.step == s_single.step == 4
    for m in ("objf", "accuracy", "grad_norm"):
        assert sup[m].shape == (4,)
        torch.testing.assert_close(sup[m], torch.stack([s[m] for s in singles]), rtol=0, atol=0)
    for (n, a), b in zip(s_single.model.state_dict().items(), s_super.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)


def test_trainer_accounting_matches_reference():
    """tests/test_train.py::test_superstep_trainer_accounting, in the port:
    18 steps with K=4 give 4 supersteps + 2 singles, recorded at the first
    dispatch that crosses each log_every=6 boundary."""
    _, (chain, tstate, step), _ = _setup()
    rng = np.random.default_rng(123)
    batches = [ChunkBatch(f, l, f.shape[1]) for f, l in (_batch(rng, n=16) for _ in range(18))]
    tr = Trainer(steps={"xvec": step}, state=tstate, log_every=6,
                 supersteps={"xvec": make_superstep(chain)}, steps_per_dispatch=4)
    tr.run(iter(batches), num_steps=18)
    assert tr.state.step == 18 and tr.steps_done == 18
    assert [h[0] for h in tr.history] == [8, 12, 18]
    assert all(np.isfinite(h[2]["objf"]) for h in tr.history)
    assert "objf_mean" in tr.history[0][2]


@pytest.mark.parametrize("k", [1, 4])
def test_divergence_guard_raises(k):
    _, (chain, tstate, step), _ = _setup()
    feats, labels = _batch(np.random.default_rng(1), n=16)
    bad = feats.copy()
    bad[0, 0, 0] = np.nan
    batches = [ChunkBatch(bad, labels, bad.shape[1])] * 8
    tr = Trainer(steps={"xvec": step}, state=tstate, log_every=4,
                 supersteps={"xvec": make_superstep(chain)}, steps_per_dispatch=k)
    with pytest.raises(RuntimeError, match="diverged"):
        tr.run(iter(batches), num_steps=8)


def test_finalize_batch_stats_matches_reference():
    (jmodel, _, jstate, jstep), (_, tstate, tstep), _ = _setup("none")
    rng = np.random.default_rng(3)
    for _ in range(2):
        feats, labels = _batch(rng)
        jstate, _ = jstep(jstate, feats, labels, jnp.float32(1.0))
        tstep(tstate, torch.from_numpy(feats), torch.from_numpy(labels), 1.0)
    calib = [_batch(rng)[0] for _ in range(3)]
    jfinal = jfinalize(jmodel, jstate, calib)
    before = {k: v.clone() for k, v in tstate.model.state_dict().items() if "num_batches" in k}
    finalize_batch_stats(tstate, calib)
    _assert_stats_close(_port(tstate.model)["batch_stats"], jfinal.batch_stats)
    # calibration reads the batch moments without advancing the EMA
    for k, v in before.items():
        assert torch.equal(tstate.model.state_dict()[k], v)
    assert not tstate.model.training


def test_flax_style_init_statistics():
    cfg = dataclasses.replace(TCFG, frame_specs=tuple(TdnnSpec(256, o) for _, o in SPECS),
                              embed_dim=256, num_speakers=300)
    model = XVector(cfg)
    lecun_normal_init(model, seed=0)
    for name, p in model.named_parameters():
        if name.endswith("batchnorm.weight"):
            assert torch.all(p == 1), name
        elif p.ndim == 1:
            assert torch.all(p == 0), name
        else:
            fan_in = p[0].numel()
            std = float(p.std())
            assert abs(std * fan_in ** 0.5 - 1.0) < 0.05, (name, std, fan_in)
            assert float(p.abs().max()) <= 2.0 / 0.87962566103423978 / fan_in ** 0.5 + 1e-6
    for name, b in model.named_buffers():
        if name.endswith("running_var"):
            assert torch.all(b == 1)
        elif name.endswith(("running_mean", "batchnorm.bias")):
            assert torch.all(b == 0)
    again = XVector(cfg)
    lecun_normal_init(again, seed=0)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


def test_bridge_round_trip():
    (_, _, _, _), (_, tstate, _), init = _setup()
    back = flax_variables_from_state_dict(tstate.model.state_dict())
    ref, got = _leaves(init), _leaves(back)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    # a trained port model loads into the reference and gives its logits
    feats = _batch(np.random.default_rng(2))[0]
    out = JXVector(JCFG).apply(back, feats, train=False)
    tstate.model.eval()
    with torch.no_grad():
        tout = tstate.model(torch.from_numpy(feats))
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(out["logits"]),
                               rtol=1e-4, atol=1e-4)


def test_reference_chunk_batch_trains_in_the_port():
    """The reference's ChunkBatch objects drive the port's Trainer too
    (duck-typed feats/labels/task)."""
    _, (_, tstate, step), _ = _setup()
    feats, labels = _batch(np.random.default_rng(4), n=8)
    tr = Trainer(steps={"xvec": step}, state=tstate, log_every=2)
    tr.run(iter([JChunkBatch(feats, labels, feats.shape[1])] * 2), num_steps=2)
    assert [h[0] for h in tr.history] == [2]
