"""Port parity: the v2 training slice end to end.

`recipes.pipeline.train_xvector_model` in both packages on one small
synthetic corpus (the same features), held-out split and checkpoint-tail
combination on.  The port's initialisation is monkeypatched to load the
reference's Flax initial variables through the bridge, so both runs start
from the same weights and draw the same batches.  Momentum SGD: under the
default Muon + Adam chain, Adam's first step turns zero-gradient rounding
noise into full steps of either sign (tests/test_torch_train.py), so two
implementations do not follow one trajectory.

Measures: the final parameters ||p_port - p_ref|| / ||p_ref - p_init|| <=
1e-3 per parameter; the calibrated batch-norm statistics within 1e-3 of
their own l2 size per layer.  A second case trains the port alone for 120
steps (default chain) and holds run_v2's EER bound.
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
from sepi_tpu.models import XVector as JXVector
from sepi_tpu.models import XVectorConfig as JConfig
from sepi_tpu.models.tdnn import TdnnSpec as JSpec
from sepi_tpu.recipes.pipeline import train_xvector_model as jtrain
from sepi_tpu_torch.bridge import flax_variables_from_state_dict, xvector_state_dict_from_flax
from sepi_tpu_torch.config import ChunkConfig, ExtractConfig, OptimizerConfig, TrainConfig
from sepi_tpu_torch.data import make_synthetic_corpus
from sepi_tpu_torch.models import TdnnSpec, XVectorConfig, compute_dtype
from sepi_tpu_torch.recipes import (
    backend_eval,
    extract_and_score,
    prepare_features_nosil,
    train_xvector_model,
)
from sepi_tpu_torch.train import trainer as port_trainer
from sepi_tpu_torch.train.checkpoint import latest_checkpoint
from torch_dist import cpu_world_mesh

torch.set_num_threads(2)

SPECS = [(24, (-2, -1, 0, 1, 2)), (24, (-2, 0, 2)), (24, (-3, 0, 3)), (24, (0,)), (64, (0,))]
CORPUS = dict(num_speakers=6, utts_per_speaker=5, duration_sec=3.0, seed=55)
OPT = dict(initial_lr=0.02, final_lr=0.005, proportional_shrink=0.5)
CHUNKS = dict(min_chunk_len=50, max_chunk_len=100, num_buckets=2)
TRAIN = dict(batch_size=24, checkpoint_every=3, steps_per_eval=3, prefetch=0)
STEPS = 6
TOL = 1e-3


@pytest.fixture(scope="module")
def data():
    corpus = make_synthetic_corpus(**CORPUS)
    return jcorpus(**CORPUS), corpus, prepare_features_nosil(corpus.audio, device="cpu")


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_train_xvector_model_matches_reference(data, tmp_path, monkeypatch):
    jc, tc, feats = data
    kw = dict(feat_dim=23, num_speakers=6, embed_dim=32)
    jcfg = JConfig(frame_specs=tuple(JSpec(d, o) for d, o in SPECS), **kw)
    tcfg = XVectorConfig(frame_specs=tuple(TdnnSpec(d, o) for d, o in SPECS), **kw)
    opt = dict(OPT, preconditioner="none")
    jtc = JTrainConfig(optimizer=JOptimizerConfig(**opt), chunks=JChunkConfig(**CHUNKS), **TRAIN)
    ttc = TrainConfig(optimizer=OptimizerConfig(**opt), chunks=ChunkConfig(**CHUNKS), **TRAIN)

    jlog, tlog = [], []
    _, jstate, jlabels = jtrain(feats, jc.dataset, jcfg, jtc, num_steps=STEPS,
                                log=lambda *a: jlog.append(a),
                                checkpoint_dir=str(tmp_path / "jax"))
    init = JXVector(jcfg).init(jax.random.PRNGKey(jtc.seed), jnp.zeros((2, 50, 23)), train=False)
    init = jax.tree_util.tree_map(np.asarray, init)
    bridged = xvector_state_dict_from_flax(init)
    monkeypatch.setattr(port_trainer, "init_weights",
                        lambda model, seed: model.load_state_dict(bridged))
    model, state, labels = train_xvector_model(
        feats, tc.dataset, tcfg, ttc, num_steps=STEPS, log=lambda *a: tlog.append(a),
        checkpoint_dir=str(tmp_path / "port"), device="cpu")

    assert labels == jlabels and state.model is model and not model.training
    assert latest_checkpoint(str(tmp_path / "port")) == STEPS
    assert [(n, task) for n, task, _ in tlog] == [(n, task) for n, task, _ in jlog]
    for (n, task, tm), (_, _, jm) in zip(tlog, jlog):
        assert set(tm) == set(jm), (n, task)
        for k in tm:
            assert tm[k] == pytest.approx(jm[k], rel=1e-3, abs=1e-4), (n, task, k)
    got = flax_variables_from_state_dict(model.state_dict())
    ref, port, p0 = _leaves(jstate.params), _leaves(got["params"]), _leaves(init["params"])
    for k, r in ref.items():
        rel = np.linalg.norm(port[k] - r) / np.linalg.norm(r - p0[k])
        assert rel <= TOL, (k, rel)
    ref_s, port_s = _leaves(jstate.batch_stats), _leaves(got["batch_stats"])
    for k, r in ref_s.items():
        assert np.linalg.norm(port_s[k] - r) <= TOL * np.linalg.norm(r), k


def test_port_training_reaches_the_run_v2_eer_bound(data, tmp_path):
    """120 steps of the default chain (run_v2's test config) from the
    port's own initialisation: EER < 0.15, as `run_v2` must reach."""
    _, tc, feats = data
    tcfg = XVectorConfig(feat_dim=23, num_speakers=6, embed_dim=32,
                         frame_specs=tuple(TdnnSpec(d, o) for d, o in SPECS))
    ttc = TrainConfig(optimizer=OptimizerConfig(**OPT), chunks=ChunkConfig(**CHUNKS),
                      batch_size=24)
    model, _, _ = train_xvector_model(feats, tc.dataset, tcfg, ttc, num_steps=120,
                                      checkpoint_dir=str(tmp_path / "ckpt"), device="cpu")
    embs = extract_and_score(model, None, feats, ExtractConfig(chunk_size=300, batch_size=16),
                             min_frames=tcfg.min_frames, device="cpu")
    enroll = {s: us[:1] for s, us in tc.dataset.spk2utt.items()}
    result, _ = backend_eval(embs, tc.dataset, tc.trials, enroll)
    assert result.eer < 0.15


def test_training_entry_point_refuses_cpu_fallback(data, monkeypatch):
    _, tc, feats = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_xvector_model(feats, tc.dataset, num_steps=1)
    with cpu_world_mesh() as mesh, pytest.raises(ValueError, match="mesh"):
        train_xvector_model(feats, tc.dataset, num_steps=1, mesh=mesh, device="cuda")
    tcfg = XVectorConfig(feat_dim=23, num_speakers=6, embed_dim=32,
                         frame_specs=tuple(TdnnSpec(d, o) for d, o in SPECS))
    bf16 = TrainConfig(chunks=ChunkConfig(**CHUNKS), compute_dtype="bfloat16", **TRAIN)
    model, _, _ = train_xvector_model(feats, tc.dataset, tcfg, bf16, num_steps=1, device="cpu")
    assert compute_dtype(model) == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        TrainConfig(compute_dtype="float16")
