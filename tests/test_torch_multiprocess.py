"""The port's data-parallel paths across real processes, against the JAX
package's sharded functions.

Port of tests/multiproc_worker.py: gloo ranks on the CPU
(`torch_mp_worker.py`, started by `torch_dist.run_ranks`) run the port,
and this process runs the reference's own sharded functions on conftest's
8-device CPU mesh on the same inputs, with the initial weights bridged
from the reference's Flax initialisation.  The tolerances are the
reference's own:
- one x-vector DP step (momentum SGD, `preconditioner="none"`): objf rtol
  1e-5, parameters rtol 1e-4 / atol 1e-5 (`multiproc_worker.py:94-98`),
  and the v5 combined c-vector's xvec and am steps at the same limits;
- the Trainer's K = 4 supersteps over 12 local shards against 3 global
  supersteps: rtol / atol 2e-4 (`:107-132`), every rank bit-equal;
- a planted fault, batch-norm moments left rank-local, must miss the
  step's tolerance;
- sharded extraction on 13 ragged utterances: rtol / atol 1e-5
  (`tests/test_train.py:305-333`);
- accumulate_stats_sharded: gamma rtol 2e-5 / atol 1e-4, first moments
  atol 1e-3, second atol 5e-3, sum(gamma) = frames at rtol 1e-5
  (`tests/test_classical.py:219-223`); plda_score_matrix_sharded: atol
  1e-3 x scale, rtol 1e-3 (`tests/test_backend_device.py:53`); both also
  on 3 ranks with n and M not multiples of 3;
- a tiny run_v2 on a 2-rank mesh: embeddings within 1e-4 of the
  embedding scale of the 1-rank run's, and only the primary writes files.
  It trains 10 momentum-SGD steps at lr 0.005 with the shrink off: at lr
  0.02 with the default shrink, a 1e-7 relative change of the initial
  weights alone moves one process's objf by 8e-4 within 20 steps, so no
  two summation orders would agree there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from sepi_tpu.backend.device import plda_score_matrix_sharded as jplda_sharded
from sepi_tpu.backend.plda import train_plda as jtrain_plda
from sepi_tpu.classical.gmm import accumulate_stats_sharded as jacc_sharded
from sepi_tpu.classical.gmm import init_diag_from_frames as jinit_gmm
from sepi_tpu.config import ExtractConfig as JExtractConfig
from sepi_tpu.config import OptimizerConfig as JOptimizerConfig
from sepi_tpu.data.manifest import Dataset as JDataset
from sepi_tpu.data.manifest import Utterance as JUtterance
from sepi_tpu.extract import EmbeddingExtractor as JExtractor
from sepi_tpu.models import AmConfig as JAmConfig
from sepi_tpu.models import CombinedConfig as JCombinedConfig
from sepi_tpu.models import CombinedCVector as JCombined
from sepi_tpu.models import XVector as JXVector
from sepi_tpu.models import XVectorConfig as JXConfig
from sepi_tpu.models.tdnn import TdnnSpec as JSpec
from sepi_tpu.parallel.mesh import host_shard_dataset as jhost_shard
from sepi_tpu.parallel.mesh import make_mesh as jmake_mesh
from sepi_tpu.train import build_optimizer as jbuild
from sepi_tpu.train import create_train_state as jcreate
from sepi_tpu.train import finalize_batch_stats as jfinalize
from sepi_tpu.train import make_superstep as jsuperstep
from sepi_tpu.train.trainer import make_am_step as jam_step
from sepi_tpu.train.trainer import make_xvec_step as jxvec_step
from sepi_tpu_torch.bridge import state_dict_from_flax, xvector_state_dict_from_flax
from sepi_tpu_torch.config import (BackendConfig, ChunkConfig, ExtractConfig, OptimizerConfig,
                                   TrainConfig)
from sepi_tpu_torch.models import (AmConfig, CombinedConfig, TdnnSpec, XVector, XVectorConfig,
                                   lecun_normal_init)
from torch_dist import run_ranks

torch.set_num_threads(2)

X_SPECS = ((16, (-2, -1, 0, 1, 2)), (32, (0,)))
X_KW = dict(feat_dim=8, num_speakers=4, embed_dim=16)
E_SPECS = ((12, (-2, -1, 0, 1, 2)), (24, (0,)))
E_KW = dict(feat_dim=10, num_speakers=4, embed_dim=16)
AM_SPECS = ((32, (-2, -1, 0, 1, 2)), (32, (-1, 0, 1)), (32, (-1, 0, 1)), (32, (-3, 0, 3)),
            (16, (-6, -3, 0)))
C_KW = dict(feat_dim=23, num_speakers=16, num_senones=40, embed_dim=32, hidden_dim=32,
            pool_dim=64)
GMM_KWARGS = ({"num_gselect": 3, "min_post": 0.02}, {"full": True})
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
TRAINER_TOL = dict(rtol=2e-4, atol=2e-4)
EMB_TOL = 1e-4  # run_v2 on 2 ranks against 1 rank, of the embedding scale


def _specs(spec_cls, specs):
    return tuple(spec_cls(d, o) for d, o in specs)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def _sd(state, convert=xvector_state_dict_from_flax):
    """The reference's train state as a port state_dict (numpy)."""
    sd = convert({"params": _np(state.params), "batch_stats": _np(state.batch_stats)})
    return {k: v.numpy() for k, v in sd.items()}


def _compare(port, ref, keys=None, **tol):
    keys = keys or [k for k in ref if not k.endswith("num_batches_tracked")]
    for k in keys:
        np.testing.assert_allclose(port[k], ref[k], err_msg=k, **tol)


def _gmm_plda_inputs(rng, n, m):
    """Frames from a 5-component mixture (n, 4), a diag GMM, a trained
    PLDA and (m, 6) enrollment x (17, 6) test vectors with counts."""
    centers = rng.normal(size=(5, 4)) * 3
    frames = (centers[rng.integers(0, 5, n)] + rng.normal(size=(n, 4))).astype(np.float32)
    gmm = jinit_gmm(frames, 5, seed=1)
    mu, ys = rng.normal(size=6), rng.normal(size=(25, 6)) * 2
    x = np.concatenate([mu + ys[k] + rng.normal(size=(6, 6)) for k in range(25)])
    plda = jtrain_plda(x, [k for k in range(25) for _ in range(6)], num_iters=6)
    return {
        "frames": frames, "gmm_kwargs": GMM_KWARGS,
        "gmm": {k: np.asarray(getattr(gmm, k), np.float32) for k in ("weights", "means", "vars")},
        "plda": {k: np.asarray(getattr(plda, k)) for k in ("mean", "transform", "psi")},
        "enroll": rng.normal(size=(m, 6)), "test": rng.normal(size=(17, 6)),
        "num_utts": rng.integers(1, 4, size=m).astype(np.float64),
    }, gmm, plda


def _gmm_plda_refs(inp, gmm, plda):
    mesh = jmake_mesh(8)
    stats = [jacc_sharded(gmm, jnp.asarray(inp["frames"]), mesh, chunk=256, **kw)
             for kw in GMM_KWARGS]
    llr = jplda_sharded(plda, inp["enroll"], inp["test"], mesh, inp["num_utts"])
    return {"gmm": [tuple(np.asarray(a) for a in (s.gamma, s.first, s.second)) for s in stats],
            "plda": np.asarray(llr)}


def _assert_gmm_plda(got, ref, n):
    for (g, f, s), (rg, rf, rs) in zip(got["gmm"], ref["gmm"]):
        np.testing.assert_allclose(g, rg, rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(f, rf, rtol=2e-5, atol=1e-3)
        np.testing.assert_allclose(s, rs, rtol=2e-5, atol=5e-3)
        np.testing.assert_allclose(float(np.sum(g)), n, rtol=1e-5)
    assert got["plda"].shape == ref["plda"].shape
    scale = np.abs(ref["plda"]).max()
    np.testing.assert_allclose(got["plda"], ref["plda"], atol=1e-3 * scale, rtol=1e-3)


@pytest.fixture(scope="module")
def main_run(tmp_path_factory):
    """Inputs, the reference's results on the 8-device mesh, and the two
    ranks' results."""
    rng = np.random.default_rng(0)
    jmesh = jmake_mesh()
    tx, _ = jbuild(JOptimizerConfig(preconditioner="none"), 100)
    jx = JXVector(JXConfig(frame_specs=_specs(JSpec, X_SPECS), **X_KW))
    xcfg = XVectorConfig(frame_specs=_specs(TdnnSpec, X_SPECS), **X_KW)
    feats = rng.normal(size=(8, 20, 8)).astype(np.float32)
    labels = (np.arange(8) % 4).astype(np.int64)
    calib = rng.normal(size=(8, 30, 8)).astype(np.float32)

    def fresh():
        return jcreate(jx, tx, jax.random.PRNGKey(0), jnp.asarray(feats[:2]))

    inp = {"xcfg": xcfg, "xinit": _sd(fresh()), "feats": feats, "labels": labels,
           "calib": calib}
    ref = {}
    s, m = jxvec_step(jx, tx, mesh=jmesh)(fresh(), feats, labels.astype(np.int32), 1.0)
    ref["xstep"] = {"objf": float(m["objf"]), "state": _sd(s)}
    ref["finalize"] = _sd(jfinalize(jx, s, [calib]))

    # v5 combined c-vector
    jam = JAmConfig(num_senones=40, specs=_specs(JSpec, AM_SPECS))
    jc = JCombined(JCombinedConfig(am=jam, **C_KW))
    ccfg = CombinedConfig(am=AmConfig(num_senones=40, specs=_specs(TdnnSpec, AM_SPECS)), **C_KW)
    cfeats = rng.normal(size=(8, 60, 23)).astype(np.float32)
    clabels = rng.integers(0, 16, size=8).astype(np.int64)
    left, right = ccfg.am_context
    am_labels = rng.integers(0, 40, size=(8, 60 - left - right)).astype(np.int64)
    cs = jcreate(jc, tx, jax.random.PRNGKey(1), jnp.asarray(cfeats[:2]),
                 model_kwargs={"task": "both"})
    inp.update(ccfg=ccfg, cinit=_sd(cs, state_dict_from_flax), cfeats=cfeats, clabels=clabels,
               am_labels=am_labels)
    cs, m1 = jxvec_step(jc, tx, {"task": "xvec"}, mesh=jmesh)(cs, cfeats,
                                                                clabels.astype(np.int32), 1.0)
    s1 = _sd(cs, state_dict_from_flax)
    cs, m2 = jam_step(jc, tx, {"task": "am"}, mesh=jmesh)(cs, cfeats,
                                                            am_labels.astype(np.int32), 1.0)
    ref["v5"] = {"xvec_objf": float(m1["objf"]), "xvec_state": s1,
                 "am_objf": float(m2["objf"]), "am_state": _sd(cs, state_dict_from_flax)}

    # 12 steps as 3 global supersteps
    seq = [(rng.normal(size=(8, 20, 8)).astype(np.float32), (np.arange(8) % 4).astype(np.int64))
           for _ in range(12)]
    inp["seq"] = seq
    s4, sstep = fresh(), jsuperstep(jx, tx)
    for i in range(0, 12, 4):
        s4, _ = sstep(s4, np.stack([f for f, _ in seq[i:i + 4]]),
                      np.stack([l for _, l in seq[i:i + 4]]).astype(np.int32),
                      np.ones(4, np.float32))
    ref["trainer"] = _sd(s4)

    # extraction on 13 ragged utterances
    je = JXVector(JXConfig(frame_specs=_specs(JSpec, E_SPECS), **E_KW))
    ecfg = XVectorConfig(frame_specs=_specs(TdnnSpec, E_SPECS), **E_KW)
    evars = je.init(jax.random.PRNGKey(0), np.zeros((1, 40, 10), np.float32), train=False)
    utts = {f"u{i}": rng.normal(size=(60 + 7 * i, 10)).astype(np.float32) for i in range(13)}
    extract_kw = dict(min_chunk_size=25, chunk_size=64, batch_size=8)
    inp.update(ecfg=ecfg, einit={k: v.numpy() for k, v in xvector_state_dict_from_flax(
        _np(evars)).items()}, utts=utts, extract_cfg=ExtractConfig(**extract_kw))
    ref["emb"] = JExtractor(je, evars, JExtractConfig(**extract_kw), min_frames=ecfg.min_frames,
                            mesh=jmake_mesh(8)).extract_utterances(utts)

    gp, gmm, plda = _gmm_plda_inputs(rng, 1011, 13)
    inp.update(gp)
    ref.update(_gmm_plda_refs(gp, gmm, plda))
    inp["full"] = rng.normal(size=(8, 16)).astype(np.float32)
    ranks = run_ranks(2, "main", tmp_path_factory.mktemp("mp_main"), inp)
    return inp, ref, ranks


def test_xvector_dp_step_matches_reference(main_run):
    _, ref, ranks = main_run
    for r in ranks:
        np.testing.assert_allclose(r["xstep"]["objf"], ref["xstep"]["objf"], rtol=1e-5)
        _compare(r["xstep"]["state"], ref["xstep"]["state"], **STEP_TOL)


@pytest.mark.parametrize("task", ["xvec", "am"])
def test_v5_dp_steps_match_reference(main_run, task):
    _, ref, ranks = main_run
    for r in ranks:
        np.testing.assert_allclose(r["v5"][f"{task}_objf"], ref["v5"][f"{task}_objf"], rtol=1e-5)
        _compare(r["v5"][f"{task}_state"], ref["v5"][f"{task}_state"], **STEP_TOL)


def test_trainer_supersteps_match_reference(main_run):
    _, ref, ranks = main_run
    for r in ranks:
        assert r["trainer"]["steps"] == 12
        _compare(r["trainer"]["state"], ref["trainer"], **TRAINER_TOL)


def test_ranks_bit_equal_after_supersteps(main_run):
    """The batch-norm reduction keeps every rank's parameters and running
    statistics bit-equal, and the fault leaves them apart."""
    _, _, (a, b) = main_run
    for key in ("trainer",):
        for k in a[key]["state"]:
            np.testing.assert_array_equal(a[key]["state"][k], b[key]["state"][k], err_msg=k)
    assert any(not np.array_equal(a["fault"]["state"][k], b["fault"]["state"][k])
               for k in a["fault"]["state"] if k.endswith("running_mean"))


def test_planted_local_batch_norm_fault_misses_tolerance(main_run):
    """With each rank normalising by its own half batch's moments, the
    step misses the reference at the tolerance the real step holds."""
    _, ref, ranks = main_run
    with pytest.raises(AssertionError):
        _compare(ranks[0]["fault"]["state"], ref["xstep"]["state"], **STEP_TOL)
    params = [k for k in ref["xstep"]["state"] if k.endswith(".weight")]
    worst = max(np.max(np.abs(ranks[0]["fault"]["state"][k] - ref["xstep"]["state"][k])
                       / (STEP_TOL["atol"] + STEP_TOL["rtol"] * np.abs(ref["xstep"]["state"][k])))
                for k in params)
    assert worst > 10.0


def test_finalize_batch_stats_over_the_mesh(main_run):
    _, ref, ranks = main_run
    stats = [k for k in ref["finalize"] if k.endswith(("running_mean", "running_var"))]
    for r in ranks:
        for k in stats:
            scale = max(1.0, np.abs(ref["finalize"][k]).max())
            assert np.abs(r["finalize"][k] - ref["finalize"][k]).max() <= 1e-5 * scale, k


def test_create_train_state_broadcasts_the_primary(main_run):
    """Ranks seeded 7 and 8 both start from rank 0's initialisation."""
    inp, _, (a, b) = main_run
    want = XVector(inp["xcfg"])
    lecun_normal_init(want, 7)
    for k, v in want.state_dict().items():
        np.testing.assert_array_equal(a["broadcast"][k], v.numpy(), err_msg=k)
        np.testing.assert_array_equal(b["broadcast"][k], v.numpy(), err_msg=k)


def test_sharded_extraction_matches_reference(main_run):
    _, ref, ranks = main_run
    for r in ranks:
        assert set(r["emb"]) == set(ref["emb"])
        for u in ref["emb"]:
            np.testing.assert_allclose(r["emb"][u], ref["emb"][u], rtol=1e-5, atol=1e-5)


def test_gmm_and_plda_sharded_match_reference(main_run):
    inp, ref, ranks = main_run
    for r in ranks:
        _assert_gmm_plda(r, ref, inp["frames"].shape[0])


def test_global_batch_and_host_shards(main_run):
    inp, _, ranks = main_run
    for r in ranks:
        assert r["global_shape"] == inp["full"].shape
        np.testing.assert_allclose(r["global_mean"], inp["full"].mean(), rtol=1e-6)
    jds = JDataset([JUtterance(f"u{i:02d}", f"s{i % 3}") for i in range(10)])
    for i, r in enumerate(ranks):
        assert r["host_shard"] == jhost_shard(jds, host_index=i, host_count=2).utt_ids
    assert sorted(ranks[0]["host_shard"] + ranks[1]["host_shard"]) == [
        f"u{i:02d}" for i in range(10)]


def test_three_ranks_pad_the_gmm_and_plda_shards(tmp_path):
    """n = 1012 frames and M = 13 models, multiples of neither 3 nor 8."""
    inp, gmm, plda = _gmm_plda_inputs(np.random.default_rng(3), 1012, 13)
    ref = _gmm_plda_refs(inp, gmm, plda)
    for r in run_ranks(3, "pad", tmp_path, inp):
        _assert_gmm_plda(r, ref, 1012)


RUN_KW = dict(
    model_cfg=XVectorConfig(feat_dim=23, num_speakers=6, embed_dim=32, frame_specs=tuple(
        TdnnSpec(d, o) for d, o in ((24, (-2, -1, 0, 1, 2)), (24, (-2, 0, 2)), (24, (-3, 0, 3)),
                                    (24, (0,)), (64, (0,))))),
    train_cfg=TrainConfig(optimizer=OptimizerConfig(initial_lr=0.005, final_lr=0.002,
                                                    proportional_shrink=0.0,
                                                    preconditioner="none"),
                          chunks=ChunkConfig(min_chunk_len=50, max_chunk_len=100, num_buckets=2),
                          batch_size=24, prefetch=0, checkpoint_every=5),
    extract_cfg=ExtractConfig(chunk_size=300, batch_size=16),
    backend_cfg=BackendConfig(lda_dim=8), num_steps=10)
CORPUS = dict(num_speakers=6, utts_per_speaker=5, duration_sec=3.0, seed=55)


@pytest.fixture(scope="module")
def run_v2_ranks(tmp_path_factory):
    from sepi_tpu_torch.data import make_synthetic_corpus
    from sepi_tpu_torch.recipes.drivers import run_v2
    from sepi_tpu_torch.utils import read_scp, read_vector

    def embeddings(wd):
        return {k: read_vector(p, o) for k, (p, o) in read_scp(f"{wd}/xvector.scp")}

    one = tmp_path_factory.mktemp("v2_one")
    corpus = make_synthetic_corpus(**CORPUS)
    enroll = {s: us[:1] for s, us in corpus.dataset.spk2utt.items()}
    res1 = run_v2(corpus.dataset, corpus.audio, corpus.dataset, {}, corpus.trials, enroll,
                  str(one), device="cpu", **RUN_KW)
    two = tmp_path_factory.mktemp("v2_two")
    ranks = run_ranks(2, "run_v2", tmp_path_factory.mktemp("v2_io"),
                      {"corpus": CORPUS, "kwargs": RUN_KW, "workdir": str(two)})
    return embeddings(one), res1, embeddings(two), ranks


def test_run_v2_on_two_ranks_matches_one_rank(run_v2_ranks):
    one, res1, two, ranks = run_v2_ranks
    assert set(one) == set(two)
    scale = max(np.abs(v).max() for v in one.values())
    gap = max(np.abs(two[u] - one[u]).max() for u in one)
    assert gap <= EMB_TOL * scale, (gap, scale)
    # every rank returns the same scores
    assert ranks[0]["scores"] == ranks[1]["scores"]
    assert set(ranks[0]["scores"]) == set(res1.scores)


def test_run_v2_on_two_ranks_only_the_primary_writes(run_v2_ranks):
    *_, ranks = run_v2_ranks
    primary, other = ranks
    assert primary["primary"] and not other["primary"]
    assert other["writes"] == {}
    for name in ("ark", "plda", "metrics", "checkpoint", "store"):
        assert primary["writes"].get(name, 0) >= 1, (name, primary["writes"])
