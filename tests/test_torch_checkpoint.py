"""Port: checkpoints, resume, pruning, tail combination and parameter
progress, the last two against `sepi_tpu.train.checkpoint`."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu.config import OptimizerConfig as JOptimizerConfig
from sepi_tpu.models import XVector as JXVector
from sepi_tpu.models import XVectorConfig as JConfig
from sepi_tpu.models.tdnn import TdnnSpec as JSpec
from sepi_tpu.train import build_optimizer as jbuild
from sepi_tpu.train import combine_checkpoints as jcombine
from sepi_tpu.train import create_train_state as jcreate
from sepi_tpu.train import save_checkpoint as jsave
from sepi_tpu.train.checkpoint import parameter_progress as jprogress
from sepi_tpu.train.trainer import make_eval_step as jeval_fn
from sepi_tpu.train.trainer import make_xvec_step as jstep_fn
from sepi_tpu_torch.bridge import flax_variables_from_state_dict, xvector_state_dict_from_flax
from sepi_tpu_torch.config import OptimizerConfig, TrainConfig
from sepi_tpu_torch.data import ChunkBatch
from sepi_tpu_torch.models import TdnnSpec, XVector, XVectorConfig, lecun_normal_init
from sepi_tpu_torch.recipes import run_checkpointed
from sepi_tpu_torch.train import (
    Trainer,
    TrainState,
    build_optimizer,
    combine_checkpoints,
    load_checkpoint,
    make_eval_step,
    make_xvec_step,
    save_checkpoint,
)
from sepi_tpu_torch.train.checkpoint import latest_checkpoint, parameter_progress

torch.set_num_threads(2)

SPECS = [(16, (-2, -1, 0, 1, 2)), (16, (-2, 0, 2)), (48, (0,))]
KW = dict(feat_dim=8, num_speakers=4, embed_dim=32)
JCFG = JConfig(frame_specs=tuple(JSpec(d, o) for d, o in SPECS), **KW)
TCFG = XVectorConfig(frame_specs=tuple(TdnnSpec(d, o) for d, o in SPECS), **KW)
OPT = dict(initial_lr=0.05, final_lr=0.01, proportional_shrink=1.0, preconditioner="none")


def _batches(seed, count, n=16, t=30):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        labels = rng.integers(0, 4, size=n).astype(np.int32)
        feats = (rng.normal(size=(n, t, 8)) + 1.5 * np.eye(4, 8)[labels][:, None, :])
        out.append(ChunkBatch(feats.astype(np.float32), labels, t))
    return out


def _fresh(opt=None, total_steps=6):
    model = XVector(TCFG)
    lecun_normal_init(model, 0)
    chain, _ = build_optimizer(OptimizerConfig(**(opt or {})), total_steps)
    return chain, TrainState(model, chain.init(dict(model.named_parameters())))


@pytest.mark.parametrize("opt", [{}, OPT])  # the default (Muon) chain and momentum SGD
def test_two_segments_equal_six_straight_steps(tmp_path, opt):
    batches = _batches(0, 6)
    chain, state = _fresh(opt)
    straight = Trainer(steps={"xvec": make_xvec_step(chain)}, state=state, log_every=3)
    straight.run(iter(batches), num_steps=6)

    cfg = TrainConfig(checkpoint_every=3)
    ckpt = str(tmp_path / "ckpt")
    chain1, s1 = _fresh(opt)
    first = Trainer(steps={"xvec": make_xvec_step(chain1)}, state=s1, log_every=3)
    run_checkpointed(first, iter(batches[:3]), 3, cfg, ckpt)  # then the job stops
    assert latest_checkpoint(ckpt) == 3
    chain2, s2 = _fresh(opt)  # a new process: fresh weights, resumed from disk
    logged = []
    second = Trainer(steps={"xvec": make_xvec_step(chain2)}, state=s2, log_every=3,
                     logger=lambda n, task, m: logged.append((n, task)))
    resumed = run_checkpointed(second, iter(batches[3:]), 6, cfg, ckpt)
    assert resumed.step == straight.state.step == 6
    assert logged == [(6, "xvec")]  # global step numbers after a resume
    assert sorted(os.listdir(ckpt)) == ["ckpt_3.pt", "ckpt_6.pt"]
    for (n, a), b in zip(straight.state.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), n
    loaded = load_checkpoint(s2, ckpt)
    assert loaded.step == 6 and loaded.model is not s2.model
    assert all(torch.equal(loaded.opt_state["trace" if opt else "mu"][k], v)
               for k, v in resumed.opt_state["trace" if opt else "mu"].items())


def test_pruning_keeps_every_kth_and_the_newest(tmp_path):
    _, state = _fresh()
    for step in range(1, 13):
        save_checkpoint(state, str(tmp_path), step, keep_every=5, max_keep=3)
    assert sorted(int(f[5:-3]) for f in os.listdir(tmp_path)) == [5, 10, 11, 12]
    with pytest.raises(FileNotFoundError):
        load_checkpoint(state, str(tmp_path / "missing"))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Four reference checkpoints of a short momentum-SGD run, a held-out
    batch, and the port's copies of the same checkpoints (bridged)."""
    root = tmp_path_factory.mktemp("combine")
    batches = _batches(1, 8, n=24)
    valid = _batches(2, 1, n=24)[0]
    jmodel = JXVector(JCFG)
    tx, _ = jbuild(JOptimizerConfig(**OPT), 8)
    state = jcreate(jmodel, tx, jax.random.PRNGKey(0), batches[0].feats[:2])
    step = jstep_fn(jmodel, tx)
    chain, tstate = _fresh(OPT, 8)
    snapshots = {}
    for i, b in enumerate(batches, 1):
        state, _ = step(state, b.feats, b.labels, jnp.float32(1.0))
        if i % 2 == 0:
            jsave(state, str(root / "jax"), i)
            variables = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                            "batch_stats": state.batch_stats})
            tstate.model.load_state_dict(xvector_state_dict_from_flax(variables))
            tstate.step = i
            save_checkpoint(tstate, str(root / "port"), i)
            snapshots[i] = variables
    return jmodel, state, tstate, valid, root, snapshots


def test_combine_picks_the_same_tail_average(jax_run):
    jmodel, jstate, tstate, valid, root, snapshots = jax_run
    jev, tev = jeval_fn(jmodel), make_eval_step()

    def jobjf(s):
        return float(jev(s, valid.feats, valid.labels)["objf"])

    def tobjf(s):
        return float(tev(s, valid.feats, valid.labels)["objf"])

    jbest, jbest_objf = jcombine(jstate, str(root / "jax"), jobjf, num_tail=3)
    tbest, tbest_objf = combine_checkpoints(tstate, str(root / "port"), tobjf, num_tail=3)
    assert tbest_objf == pytest.approx(jbest_objf, rel=1e-5, abs=1e-6)
    got = flax_variables_from_state_dict(tbest.model.state_dict())
    for path, r in jax.tree_util.tree_leaves_with_path(jbest.params):
        p = got["params"]
        for k in path:
            p = p[k.key]
        np.testing.assert_allclose(p, np.asarray(r), rtol=1e-6, atol=1e-7)
    # only parameters average: the statistics are the freshest checkpoint's
    for path, r in jax.tree_util.tree_leaves_with_path(snapshots[8]["batch_stats"]):
        p = got["batch_stats"]
        for k in path:
            p = p[k.key]
        np.testing.assert_array_equal(p, r)
    assert tbest.step == 8


def test_parameter_progress_matches_reference(jax_run):
    _, _, tstate, _, _, snapshots = jax_run
    old, new = snapshots[2], snapshots[8]
    ref = jprogress(old["params"], new["params"])
    t_old = XVector(TCFG)
    t_old.load_state_dict(xvector_state_dict_from_flax(old))
    t_new = XVector(TCFG)
    t_new.load_state_dict(xvector_state_dict_from_flax(new))
    got = parameter_progress(dict(t_old.named_parameters()), dict(t_new.named_parameters()))
    assert set(got) == set(ref) == {"frames", "segment"}
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-6)


def test_profile_and_metrics_logger_write_their_records(tmp_path):
    """TrainConfig(profile=True) writes one torch.profiler trace per
    checkpoint segment next to the checkpoint directory, in which the
    program's spans name the Trainer's layers; MetricsLogger appends one
    json record per call."""
    import json

    from sepi_tpu_torch.utils import MetricsLogger

    chain, state = _fresh(OPT)
    logger = MetricsLogger(str(tmp_path / "metrics.jsonl"), echo=False)
    tr = Trainer(steps={"xvec": make_xvec_step(chain)}, state=state, log_every=2, logger=logger)
    run_checkpointed(tr, iter(_batches(3, 4)), 4, TrainConfig(checkpoint_every=2, profile=True),
                     str(tmp_path / "ckpt"), log=logger)
    logger.close()
    for seg in ("seg0-2", "seg2-4"):
        trace = json.loads((tmp_path / "profile" / seg / "trace.json").read_text())
        assert trace["traceEvents"]
        names = {e.get("name") for e in trace["traceEvents"]}
        assert {"sepi.train", "sepi.train.dispatch", "sepi.train.log"} <= names
    recs = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], r["task"]) for r in recs] == [(2, "xvec"), (2, "progress"),
                                                      (4, "xvec"), (4, "progress")]
    assert set(recs[1]) >= {"frames", "segment", "t"}
