"""Port parity: the phonetic training path against `sepi_tpu`.

- `FrameSampler` and `MultitaskInterleaver` draw bit-identical batches;
- the AM step and the v3/v5 am/xvec steps from the same (bridged) weights
  on the same batches: momentum SGD over an interleaved am, xvec, am
  sequence by the trajectory measure ||p_port - p_ref|| / ||p_ref -
  p_init|| <= 1e-3 per parameter, the parameters a task does not reach
  included (they move by momentum, as `jax.grad`'s zeros move them);
  the default Muon chain for one step of each task within 1e-4 of the
  step outside entries whose gradient is rounding noise (see
  tests/test_torch_train.py), and the unreached parameters by exactly
  the shrink;
- a v4 run with am_lr_factor=0 and shrink off leaves the grafted AM
  bit-identical and the pretrained model untouched.

Whole-trainer parity and the CPU chain are in tests/test_torch_phonetic_slice.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu.config import ChunkConfig as JChunkConfig
from sepi_tpu.config import OptimizerConfig as JOptimizerConfig
from sepi_tpu.data.manifest import Dataset as JDataset
from sepi_tpu.data.manifest import Utterance as JUtterance
from sepi_tpu.data.sampler import ChunkSampler as JChunkSampler
from sepi_tpu.data.sampler import FrameSampler as JFrameSampler
from sepi_tpu.data.sampler import MultitaskInterleaver as JInterleaver
from sepi_tpu.models import cvector as jcv
from sepi_tpu.models.tdnn import TdnnSpec as JSpec
from sepi_tpu.train import build_optimizer as jbuild
from sepi_tpu.train import create_train_state as jcreate
from sepi_tpu.train.trainer import make_am_step as jam_step
from sepi_tpu.train.trainer import make_xvec_step as jxvec_step
from sepi_tpu_torch.bridge import flax_variables_from_state_dict, state_dict_from_flax
from sepi_tpu_torch.config import ChunkConfig, OptimizerConfig, TrainConfig
from sepi_tpu_torch.data import ChunkSampler, FrameSampler, MultitaskInterleaver
from sepi_tpu_torch.data.manifest import Dataset, Utterance
from sepi_tpu_torch.models import cvector as tcv
from sepi_tpu_torch.models.tdnn import TdnnSpec
from sepi_tpu_torch.recipes import train_adapted_model, train_am_model
from sepi_tpu_torch.train import TrainState, build_optimizer
from sepi_tpu_torch.train.trainer import make_am_step, make_xvec_step

torch.set_num_threads(2)

NUM_SENONES = 12
NUM_SPK = 6
AM_SPECS = [(24, (-2, -1, 0, 1, 2)), (24, (-1, 0, 1)), (24, (-1, 0, 1)), (24, (-3, 0, 3)),
            (12, (-6, -3, 0))]
J_AM = jcv.AmConfig(num_senones=NUM_SENONES, specs=tuple(JSpec(d, o) for d, o in AM_SPECS))
T_AM = tcv.AmConfig(num_senones=NUM_SENONES, specs=tuple(TdnnSpec(d, o) for d, o in AM_SPECS))
WIDTHS = dict(num_speakers=NUM_SPK, num_senones=NUM_SENONES, embed_dim=32, hidden_dim=24,
              pool_dim=48)
OPT = {"none": dict(initial_lr=0.05, final_lr=0.01, proportional_shrink=1.0,
                    preconditioner="none"),
       "muon": dict(initial_lr=0.05, final_lr=0.01, proportional_shrink=1.0)}
PARAM_TOL = 1e-3


def _world(seed=0, num_utts=4, frames=(90, 160)):
    """Random features with speaker offsets, frame labels that follow the
    features (learnable), and the same manifest in both packages."""
    rng = np.random.default_rng(seed)
    feats, ali, rows = {}, {}, []
    for s in range(NUM_SPK):
        for u in range(num_utts):
            utt = f"spk{s}-u{u}"
            n = int(rng.integers(*frames))
            f = rng.normal(size=(n, 23)).astype(np.float32)
            f[:, s] += 1.5
            feats[utt] = f
            ali[utt] = np.argmax(f[:, 1:1 + NUM_SENONES], axis=1).astype(np.int32)
            rows.append((utt, f"spk{s}"))
    jds = JDataset([JUtterance(u, s) for u, s in rows], name="w")
    tds = Dataset([Utterance(u, s) for u, s in rows], name="w")
    return feats, ali, jds, tds


def _same_batch(a, b):
    assert a.task == b.task
    np.testing.assert_array_equal(a.feats, b.feats)
    np.testing.assert_array_equal(a.labels, b.labels)


def test_frame_sampler_bit_identical():
    feats, ali, _, _ = _world()
    kw = dict(chunk_len=8, batch_size=16, seed=5, context=(13, 7))
    j, t = JFrameSampler(feats, ali, **kw), FrameSampler(feats, ali, **kw)
    for _ in range(5):
        jb, tb = j.sample_batch(), t.sample_batch()
        _same_batch(jb, tb)
        np.testing.assert_array_equal(jb.label_mask, tb.label_mask)
        assert tb.feats.shape == (16, 28, 23) and tb.labels.shape == (16, 8)
    # labels are the central frames of each window (the context margin cut around them)
    f0, a0 = tb.feats[0], tb.labels[0]
    utt = next(u for u, f in feats.items()
               for o in range(f.shape[0] - 27) if np.array_equal(f[o:o + 28], f0))
    off = next(o for o in range(feats[utt].shape[0] - 27)
               if np.array_equal(feats[utt][o:o + 28], f0))
    np.testing.assert_array_equal(a0, ali[utt][off + 13:off + 21])
    with pytest.raises(ValueError, match="select-voiced-ali"):
        FrameSampler(feats, {u: a[:-1] for u, a in ali.items()}, **kw)


@pytest.mark.parametrize("block_size", [1, 4])
def test_multitask_interleaver_bit_identical(block_size):
    feats, ali, jds, tds = _world(seed=1)
    chunks = dict(min_chunk_len=40, max_chunk_len=80, num_buckets=3)
    fk = dict(chunk_len=8, batch_size=8, seed=3, context=(7, 7))

    def build(frame_cls, chunk_cls, inter_cls, cc, ds):
        am = frame_cls(feats, ali, **fk)
        xv = chunk_cls(feats, ds, cc(**chunks), 6, 3, block_size=block_size)
        return inter_cls(am, xv, num_am_batches=9, num_xvec_batches=7, am_weight=0.5,
                         xvec_weight=2.0, seed=3, block_size=block_size)

    j = list(build(JFrameSampler, JChunkSampler, JInterleaver, JChunkConfig, jds))
    t = list(build(FrameSampler, ChunkSampler, MultitaskInterleaver, ChunkConfig, tds))
    assert len(t) == len(j) == 16
    assert sum(b.task == "am" for b, _ in t) == 9
    for (jb, jw), (tb, tw) in zip(j, t):
        _same_batch(jb, tb)
        assert jw == tw == (0.5 if tb.task == "am" else 2.0)


# ---------------------------------------------------------------- steps


def _models(kind):
    if kind == "am":
        return jcv.AmNet(J_AM), tcv.AmNet(T_AM), {}
    if kind == "multitask":
        return (jcv.MultitaskCVector(jcv.MultitaskConfig(**WIDTHS)),
                tcv.MultitaskCVector(tcv.MultitaskConfig(**WIDTHS)), {"task": "both"})
    return (jcv.CombinedCVector(jcv.CombinedConfig(am=J_AM, **WIDTHS)),
            tcv.CombinedCVector(tcv.CombinedConfig(am=T_AM, **WIDTHS)), {"task": "both"})


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _setup(kind, opt, total_steps=60):
    jmodel, tmodel, init_kw = _models(kind)
    tx, _ = jbuild(JOptimizerConfig(**OPT[opt]), total_steps)
    jstate = jcreate(jmodel, tx, jax.random.PRNGKey(0), np.zeros((2, 60, 23), np.float32),
                     model_kwargs=init_kw)
    init = {"params": _np(jstate.params), "batch_stats": _np(jstate.batch_stats)}
    tmodel.load_state_dict(state_dict_from_flax(init))
    chain, _ = build_optimizer(OptimizerConfig(**OPT[opt]), total_steps)
    tstate = TrainState(tmodel, chain.init(dict(tmodel.named_parameters())))
    if kind == "am":
        jsteps = {"am": jam_step(jmodel, tx)}
        tsteps = {"am": make_am_step(chain)}
    else:
        jsteps = {"am": jam_step(jmodel, tx, task_kwargs={"task": "am"}),
                  "xvec": jxvec_step(jmodel, tx, task_kwargs={"task": "xvec"})}
        tsteps = {"am": make_am_step(chain, {"task": "am"}),
                  "xvec": make_xvec_step(chain, {"task": "xvec"})}
    return jstate, tstate, jsteps, tsteps, init


def _batch(rng, task, ctx):
    """An AM frame batch (B, 8 + l + r, 23) with (B, 8) labels that follow
    the features, or a speaker-chunk batch (B, 60, 23) with offsets."""
    if task == "am":
        f = rng.normal(size=(24, 8 + sum(ctx), 23)).astype(np.float32)
        labels = np.argmax(f[:, ctx[0]:ctx[0] + 8, 1:1 + NUM_SENONES], -1).astype(np.int32)
        return f, labels
    labels = rng.integers(0, NUM_SPK, size=16).astype(np.int32)
    f = rng.normal(size=(16, 60, 23)) + np.eye(NUM_SPK, 23)[labels][:, None, :] * 1.5
    return f.astype(np.float32), labels


def _ctx(kind):
    return T_AM.context if kind == "am" else tcv.MultitaskConfig(**WIDTHS).am_context


def _port(model):
    return flax_variables_from_state_dict(model.state_dict())


@pytest.mark.parametrize("kind", ["am", "multitask", "combined"])
def test_sgd_steps_match_reference(kind):
    """am, xvec, am (the AM net: am x 3): metrics within 1e-5 and every
    parameter by the trajectory measure, the ones the task does not reach
    included; batch-norm statistics within 1e-5."""
    jstate, tstate, jsteps, tsteps, init = _setup(kind, "none")
    rng = np.random.default_rng(7)
    tasks = ["am"] * 3 if kind == "am" else ["am", "xvec", "am"]
    for task in tasks:
        feats, labels = _batch(rng, task, _ctx(kind))
        jstate, jm = jsteps[task](jstate, feats, labels, jnp.float32(1.0))
        tm = tsteps[task](tstate, torch.from_numpy(feats), torch.from_numpy(labels), 1.0)
        for k in ("objf", "accuracy", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-5), (task, k)
    ref, port, p0 = (_leaves(jstate.params), _leaves(_port(tstate.model)["params"]),
                     _leaves(init["params"]))
    assert set(ref) == set(port)
    for k, r in ref.items():
        rel = np.linalg.norm(port[k] - r) / np.linalg.norm(r - p0[k])
        assert rel <= PARAM_TOL, (k, rel)
    ref_s, port_s = _leaves(jstate.batch_stats), _leaves(_port(tstate.model)["batch_stats"])
    for k, r in ref_s.items():
        assert np.abs(port_s[k] - r).max() <= 1e-5 * max(1.0, np.abs(r).max()), k


def _port_grads(model, feats, labels, task_kw):
    model.train()
    params = dict(model.named_parameters())
    out = model(torch.from_numpy(feats), **task_kw)
    logits = out["logits"] if "logits" in out else out["am_logits"]
    logp = torch.log_softmax(logits, -1)
    loss = -torch.gather(logp, -1, torch.from_numpy(labels).long()[..., None]).mean()
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), grads)}
    return _leaves(flax_variables_from_state_dict({**model.state_dict(), **grads})["params"])


@pytest.mark.parametrize("kind,task", [("am", "am"), ("multitask", "am"),
                                       ("multitask", "xvec"), ("combined", "xvec")])
def test_muon_step_matches_reference(kind, task):
    """One default-chain step (Muon on the 2-D heads, Adam elsewhere):
    reached entries within 1e-4 of the step outside rounding-noise
    gradients; a parameter the task does not reach takes exactly the
    reference's update (zero gradient: Muon and Adam give 0, the shrink
    moves it)."""
    jstate, tstate, jsteps, tsteps, init = _setup(kind, "muon")
    feats, labels = _batch(np.random.default_rng(11), task, _ctx(kind))
    before = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    task_kw = {} if kind == "am" else {"task": task}
    grads = _port_grads(tstate.model, feats, labels, task_kw)
    tstate.model.load_state_dict(before)  # the gradient pass moved the running statistics
    jstate, jm = jsteps[task](jstate, feats, labels, jnp.float32(1.0))
    tm = tsteps[task](tstate, torch.from_numpy(feats), torch.from_numpy(labels), 1.0)
    assert float(tm["objf"]) == pytest.approx(float(jm["objf"]), rel=1e-5, abs=1e-5)
    ref, port, p0 = (_leaves(jstate.params), _leaves(_port(tstate.model)["params"]),
                     _leaves(init["params"]))
    unreached = moved = 0
    for k, r in ref.items():
        step = np.abs(r - p0[k]).max()
        diff = np.abs(port[k] - r)
        if not np.any(grads[k]):
            unreached += 1
            moved += int(step > 0)  # the shrink (not on batch-norm scales or zero biases)
            assert diff.max() <= 1e-6 * np.abs(r).max(), k
            continue
        noise = np.abs(grads[k]) <= 1e-4 * np.abs(grads[k]).max()
        assert diff[~noise].max(initial=0.0) <= 1e-4 * step, k
    assert (unreached, moved) == (0, 0) if kind == "am" else moved > 2


def test_frozen_graft_stays_frozen(tmp_path):
    """v4 with am_lr_factor=0 and shrink off: the grafted AM's parameters
    equal the pretrained ones bit for bit after training, the pretrained
    model is unchanged, and the x-vector branch moved."""
    feats, ali, _, tds = _world(seed=2)
    cfg = TrainConfig(optimizer=OptimizerConfig(initial_lr=0.02, final_lr=0.005,
                                                proportional_shrink=0.0),
                      chunks=ChunkConfig(min_chunk_len=50, max_chunk_len=80, num_buckets=2),
                      batch_size=12, am_batch_size=32)
    am_model, am_state = train_am_model(feats, ali, T_AM, cfg, num_steps=4, device="cpu")
    pre = {k: v.clone() for k, v in am_model.state_dict().items()}
    model, state = train_adapted_model(
        feats, tds, am_model, am_state,
        tcv.AdaptedConfig(am=T_AM, **{k: v for k, v in WIDTHS.items() if k != "num_senones"}),
        cfg, num_steps=8, am_lr_factor=0.0, checkpoint_dir=str(tmp_path / "ckpt"),
        device="cpu")
    assert state.model is model and not model.training
    for n, p in model.am.named_parameters():
        assert torch.equal(p, am_model.state_dict()[n]), n
    assert all(torch.equal(v, pre[k]) for k, v in am_model.state_dict().items())
    assert model.am.frames.tdnn1.affine.weight.data_ptr() != \
        am_model.frames.tdnn1.affine.weight.data_ptr()
    from sepi_tpu_torch.models.tdnn import lecun_normal_init

    fresh = tcv.AdaptedXVector(model.cfg)
    lecun_normal_init(fresh, cfg.seed)
    assert not torch.equal(fresh.xvec_branch.tdnn1.affine.weight,
                           model.xvec_branch.tdnn1.affine.weight)
