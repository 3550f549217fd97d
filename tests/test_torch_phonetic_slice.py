"""Port parity: the four phonetic trainers end to end.

`train_am_model`, and `train_multitask_model`, `train_adapted_model` and
`train_combined_model` with held-out batches and checkpoints on, in both
packages on one small synthetic corpus (the same features and frame
labels) for 6 steps (v5 in supersteps of 4).  The port's initialisation is monkeypatched to load
the reference's Flax initial variables through the bridge and the v4/v5
runs graft the same pretrained AM, so both start from the same weights
and draw the same batches (held-out, probe and calibration batches before
training, as the reference).  Momentum SGD (see
tests/test_torch_train_slice.py).  Measures: the logged records equal in
order and within 1e-3; the final parameters ||p_port - p_ref|| / ||p_ref -
p_init|| <= 1e-3 per parameter; the calibrated batch-norm statistics
within 1e-3 of their own l2 size per layer.

The port's whole phonetic chain on the CPU is in
tests/test_torch_phonetic_chain.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu.config import ChunkConfig as JChunkConfig
from sepi_tpu.config import OptimizerConfig as JOptimizerConfig
from sepi_tpu.config import TrainConfig as JTrainConfig
from sepi_tpu.data import make_synthetic_corpus as jcorpus
from sepi_tpu.models import cvector as jcv
from sepi_tpu.models.tdnn import TdnnSpec as JSpec
from sepi_tpu.recipes import phonetic as jph
from sepi_tpu_torch.bridge import flax_variables_from_state_dict, state_dict_from_flax
from sepi_tpu_torch.config import ChunkConfig, OptimizerConfig, TrainConfig
from sepi_tpu_torch.data import make_synthetic_corpus
from sepi_tpu_torch.models import cvector as tcv
from sepi_tpu_torch.models.tdnn import TdnnSpec
from sepi_tpu_torch.recipes import (
    prepare_features_nosil,
    train_adapted_model,
    train_am_model,
    train_combined_model,
    train_multitask_model,
)
from sepi_tpu_torch.train import trainer as port_trainer
from sepi_tpu_torch.train.checkpoint import latest_checkpoint

torch.set_num_threads(2)

NUM_SENONES = 12
AM_SPECS = [(24, (-2, -1, 0, 1, 2)), (24, (-1, 0, 1)), (24, (-1, 0, 1)), (24, (-3, 0, 3)),
            (12, (-6, -3, 0))]
WIDTHS = dict(num_speakers=6, embed_dim=32, hidden_dim=24, pool_dim=48)
CORPUS = dict(num_speakers=6, utts_per_speaker=5, duration_sec=3.0, seed=55)
OPT = dict(initial_lr=0.02, final_lr=0.005, proportional_shrink=0.5)
CHUNKS = dict(min_chunk_len=50, max_chunk_len=100, num_buckets=2)
TRAIN = dict(batch_size=24, am_batch_size=64, checkpoint_every=3)
STEPS = 6
TOL = 1e-3


def _am_cfg(pkg, num_senones=NUM_SENONES):
    spec = JSpec if pkg is jcv else TdnnSpec
    return pkg.AmConfig(num_senones=num_senones, specs=tuple(spec(d, o) for d, o in AM_SPECS))


@pytest.fixture(scope="module")
def data():
    jc, tc = jcorpus(**CORPUS), make_synthetic_corpus(**CORPUS)
    feats = prepare_features_nosil(tc.audio, device="cpu")
    # frame labels that follow the features: learnable, deterministic
    ali = {u: np.argmax(f[:, 1:1 + NUM_SENONES], axis=1).astype(np.int32)
           for u, f in feats.items()}
    return jc, tc, feats, ali


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _flax_init(jmodel, seed, **kw):
    v = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((2, 60, 23)), train=False, **kw)
    return jax.tree_util.tree_map(np.asarray, v)


def _configs(spd=1):
    opt = dict(OPT, preconditioner="none")
    kw = dict(TRAIN, steps_per_dispatch=spd, checkpoint_every=max(TRAIN["checkpoint_every"], spd))
    return (JTrainConfig(optimizer=JOptimizerConfig(**opt), chunks=JChunkConfig(**CHUNKS), **kw),
            TrainConfig(optimizer=OptimizerConfig(**opt), chunks=ChunkConfig(**CHUNKS), **kw))


def _assert_runs_agree(jlog, tlog, jstate, model, init):
    assert [(n, task) for n, task, _ in tlog] == [(n, task) for n, task, _ in jlog]
    for (n, task, tm), (_, _, jm) in zip(tlog, jlog):
        assert set(tm) == set(jm), (n, task)
        for k in tm:
            assert tm[k] == pytest.approx(jm[k], rel=1e-3, abs=1e-4), (n, task, k)
    got = flax_variables_from_state_dict(model.state_dict())
    ref, port, p0 = _leaves(jstate.params), _leaves(got["params"]), _leaves(init["params"])
    assert set(ref) == set(port)
    for k, r in ref.items():
        rel = np.linalg.norm(port[k] - r) / np.linalg.norm(r - p0[k])
        assert rel <= TOL, (k, rel)
    ref_s, port_s = _leaves(jstate.batch_stats), _leaves(got["batch_stats"])
    assert set(ref_s) == set(port_s)
    for k, r in ref_s.items():
        assert np.linalg.norm(port_s[k] - r) <= TOL * np.linalg.norm(r), k


@pytest.mark.parametrize("kind,spd", [("am", 1), ("multitask", 1), ("adapted", 1),
                                      ("combined", 4)])
def test_trainer_matches_reference(data, tmp_path, monkeypatch, kind, spd):
    """``spd``: steps_per_dispatch (4: same-task runs of the interleaver
    go through supersteps)."""
    jc, tc, feats, ali = data
    jtc, ttc = _configs(spd)
    jam, tam = _am_cfg(jcv), _am_cfg(tcv)
    jlog, tlog = [], []
    jkw = dict(log=lambda *a: jlog.append(a))
    tkw = dict(log=lambda *a: tlog.append(a), device="cpu")
    ckpt = {} if kind == "am" else {"checkpoint_dir": str(tmp_path / "jax")}
    tckpt = {} if kind == "am" else {"checkpoint_dir": str(tmp_path / "port")}
    if kind in ("adapted", "combined"):
        # the pretrained AM both runs graft: the reference's, bridged into the port
        am_j, am_jstate = jph.train_am_model(feats, ali, jam, jtc, num_steps=3)
        am_t = tcv.AmNet(tam)
        am_t.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, {"params": am_jstate.params, "batch_stats": am_jstate.batch_stats})))
    if kind == "am":
        init = _flax_init(jcv.AmNet(jam), jtc.seed)
        jrun = lambda: jph.train_am_model(feats, ali, jam, jtc, STEPS, **jkw)  # noqa: E731
        trun = lambda: train_am_model(feats, ali, tam, ttc, STEPS, **tkw)  # noqa: E731
    elif kind == "multitask":
        jcfg, tcfg = (pkg.MultitaskConfig(num_senones=NUM_SENONES, **WIDTHS) for pkg in (jcv, tcv))
        init = _flax_init(jcv.MultitaskCVector(jcfg), jtc.seed, task="both")
        jrun = lambda: jph.train_multitask_model(  # noqa: E731
            feats, ali, jc.dataset, jcfg, jtc, STEPS, **jkw, **ckpt)
        trun = lambda: train_multitask_model(  # noqa: E731
            feats, ali, tc.dataset, tcfg, ttc, STEPS, **tkw, **tckpt)
    elif kind == "adapted":
        jcfg, tcfg = jcv.AdaptedConfig(am=jam, **WIDTHS), tcv.AdaptedConfig(am=tam, **WIDTHS)
        init = _flax_init(jcv.AdaptedXVector(jcfg), jtc.seed)
        jrun = lambda: jph.train_adapted_model(  # noqa: E731
            feats, jc.dataset, am_j, am_jstate, jcfg, jtc, STEPS, **jkw, **ckpt)
        trun = lambda: train_adapted_model(  # noqa: E731
            feats, tc.dataset, am_t, None, tcfg, ttc, STEPS, **tkw, **tckpt)
    else:
        jcfg = jcv.CombinedConfig(num_senones=NUM_SENONES, am=jam, **WIDTHS)
        tcfg = tcv.CombinedConfig(num_senones=NUM_SENONES, am=tam, **WIDTHS)
        init = _flax_init(jcv.CombinedCVector(jcfg), jtc.seed, task="both")
        jrun = lambda: jph.train_combined_model(  # noqa: E731
            feats, ali, jc.dataset, am_j, am_jstate, jcfg, jtc, STEPS, **jkw, **ckpt)
        trun = lambda: train_combined_model(  # noqa: E731
            feats, ali, tc.dataset, am_t, None, tcfg, ttc, STEPS, **tkw, **tckpt)

    _, jstate = jrun()
    bridged = state_dict_from_flax(init)
    monkeypatch.setattr(port_trainer, "init_weights",
                        lambda model, seed: model.load_state_dict(bridged))
    model, state = trun()
    assert state.model is model and not model.training
    if kind != "am":
        assert latest_checkpoint(str(tmp_path / "port")) == STEPS
        assert any(task.startswith("valid:") for _, task, _ in tlog)
    if kind in ("multitask", "combined"):
        assert {"valid:am", "valid:xvec"} <= {task for _, task, _ in tlog}
    # the reference's tree has the grafted AM's initial values, not the graft's
    if kind in ("adapted", "combined"):
        init = dict(init, params={**init["params"], "am": _leaves_tree(am_jstate.params)})
    _assert_runs_agree(jlog, tlog, jstate, model, init)


def _leaves_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)
