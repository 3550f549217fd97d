"""Port parity: `sepi_tpu_torch.bench` against the functions `bench.py`
composes, at a small size on the CPU.

Each stage runs its shape-taking core with ``device="cpu"`` at `SMALL`
(2 x 3 s of audio, the V2 narrowed to 2 layers of 64, a narrow v5, PLDA
32 x 32 x 16), and the same inputs go through the JAX package:
- extraction: `FeatureExtractor._mfcc_impl` (the Pallas MFCC in interpret
  mode, dithered with the same seeds), VAD, CMVN, select and
  `XVector.apply` with the port's weights bridged; embeddings within 1e-4
  of their scale;
- training: one bf16 V2 `make_xvec_step` from the port's initial weights
  under momentum SGD; the objective within `ULPS` bf16 ulps of its value
  and the parameter update within the gradient limits of
  tests/test_torch_bf16.py;
- scoring: `plda_score_matrix_device` within 1e-3 of its scale and 1e-3
  relative (tests/test_torch_backend_device.py).
Then: the JSON line carries `bench.py`'s keys, read from its AST; the
default shapes are `bench.py`'s, read the same way; a planted fault in each
stage, or a stage that raises, fails the run; without a GPU, `main()` and
``python -m sepi_tpu_torch.bench`` raise; and smoke phase 15 runs on the CPU.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu.backend import device as jdev
from sepi_tpu.backend import plda as jplda
from sepi_tpu.config import CmvnConfig as JCmvnConfig
from sepi_tpu.config import FrontendConfig as JFrontendConfig
from sepi_tpu.config import OptimizerConfig as JOptimizerConfig
from sepi_tpu.config import VadConfig as JVadConfig
from sepi_tpu.models import XVector as JXVector
from sepi_tpu.models import XVectorConfig as JXConfig
from sepi_tpu.models.tdnn import TdnnSpec as JSpec
from sepi_tpu.ops import energy_vad, select_voiced_frames, sliding_cmvn
from sepi_tpu.ops.dither import utt_seeds as jutt_seeds
from sepi_tpu.ops.features import FeatureExtractor as JFeatureExtractor
from sepi_tpu.ops.framing import num_frames as jnum_frames
from sepi_tpu.train import build_optimizer as jbuild
from sepi_tpu.train import create_train_state as jcreate
from sepi_tpu.train.trainer import make_xvec_step as jstep_fn
from sepi_tpu_torch import bench
from sepi_tpu_torch.bridge import flax_variables_from_state_dict
from sepi_tpu_torch.config import OptimizerConfig
from sepi_tpu_torch.models import AmConfig, CombinedConfig, TdnnSpec, XVectorConfig
from test_torch_bf16 import BF16_EPS, GRAD_RTOL, GRAD_ULPS, ULPS

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
FRAME_SPECS = ((64, (-2, -1, 0, 1, 2)), (64, (0,)))
X_KW = dict(feat_dim=23, num_speakers=8, embed_dim=32)
SMALL = bench.Shapes(
    utts=2, secs=3.0,
    xvector=XVectorConfig(frame_specs=tuple(TdnnSpec(d, o) for d, o in FRAME_SPECS), **X_KW),
    chunks=8, chunk_frames=30, superstep=2,
    combined=CombinedConfig(num_speakers=8, num_senones=12, embed_dim=32, hidden_dim=24,
                            pool_dim=48, am=AmConfig(num_senones=12, specs=(
                                TdnnSpec(24, (-2, -1, 0, 1, 2)), TdnnSpec(24, (-1, 0, 1)),
                                TdnnSpec(12, (-3, 0, 3))))),
    am_chunks=8, am_frames=4, pair_superstep=2,
    plda_dim=16, plda_models=32, plda_tests=32,
    extract_iters=1, step_iters=1, superstep_iters=1, plda_iters=1, warmup=0)
EMB_TOL = 1e-4  # of the embedding's scale
SGD = OptimizerConfig(preconditioner="none")


def _rng():
    return np.random.default_rng(bench.SEED)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


# ----------------------------------------------------- each stage vs the JAX functions


def test_extraction_matches_reference():
    """The dithered chain on the bench's generator draws: the Pallas MFCC in
    interpret mode with the bench's seeds, VAD, CMVN, select and the
    reference's XVector with the port's weights."""
    run = bench.bench_extraction(_rng(), device="cpu", shapes=SMALL, repeats=1)
    assert run.embeddings.shape == (SMALL.utts, X_KW["embed_dim"])
    assert run.mfcc_err <= bench.MFCC_TOL and len(run.timing.ms) == 1

    fcfg = JFrontendConfig()
    assert fcfg.dither == 1.0
    n = run.samples.shape[1]
    assert n == int(bench.SR * SMALL.secs)
    t_max = int(jnum_frames(n, fcfg))
    seeds = jnp.asarray(jutt_seeds([f"bench{i}" for i in range(SMALL.utts)]))
    lengths = jnp.full((SMALL.utts,), n, jnp.int32)
    fe = JFeatureExtractor(fcfg, spectral_mode="pallas")  # interpret mode on the CPU
    feats, mask = fe._mfcc_impl(jnp.asarray(run.samples), lengths, t_max, seeds)
    voiced = energy_vad(feats[..., 0], mask, JVadConfig())
    normed = sliding_cmvn(feats, mask, JCmvnConfig())
    sel, sel_mask = select_voiced_frames(normed, voiced)
    jcfg = JXConfig(frame_specs=tuple(JSpec(d, o) for d, o in FRAME_SPECS), **X_KW)
    variables = flax_variables_from_state_dict(run.model.state_dict())
    want = np.asarray(JXVector(jcfg).apply(variables, sel, frame_mask=sel_mask,
                                           train=False)["embedding_a"])
    got = run.embeddings.numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= EMB_TOL * scale, (np.abs(got - want).max(), scale)


def test_training_step_matches_reference():
    """The bench's first bf16 V2 step (no warm-up, one timed call) against
    the reference's step from the same initial weights on the same batch,
    under momentum SGD: the objective within ULPS bf16 ulps, the update of
    each parameter within GRAD_ULPS of its own scale and GRAD_RTOL relative
    L2 over all of them."""
    extra = {}
    run = bench.bench_training(_rng(), extra, device="cpu", shapes=SMALL, repeats=1,
                               opt_cfg=SGD)
    assert set(run.timings) == {"v2", "v2_superstep", "v5_pair", "v5_superstep"}
    assert run.v2_state.step == 1  # exactly the compared step
    feats, labels = run.v2_batch

    jcfg = JXConfig(frame_specs=tuple(JSpec(d, o) for d, o in FRAME_SPECS), **X_KW)
    jmodel = JXVector(jcfg, dtype="bfloat16")
    tx, _ = jbuild(JOptimizerConfig(preconditioner="none"), 1000)
    init = flax_variables_from_state_dict(run.v2_init)
    jstate = jcreate(jmodel, tx, jax.random.PRNGKey(0), feats[:2])
    jstate = jstate.replace(params=init["params"], batch_stats=init["batch_stats"],
                            opt_state=tx.init(init["params"]))
    jstate, jm = jstep_fn(jmodel, tx)(jstate, feats, labels, jnp.float32(1.0))

    want = float(jm["objf"])
    got = float(run.v2_metrics["objf"])
    assert abs(got - want) <= ULPS * BF16_EPS * abs(want), (got, want)
    after = _leaves(flax_variables_from_state_dict(run.v2_state.model.state_dict())["params"])
    before, ref = _leaves(init["params"]), _leaves(_np_tree(jstate.params))
    assert set(after) == set(ref)
    for k in ref:
        d_want, d_got = ref[k] - before[k], after[k] - before[k]
        assert np.abs(d_want).max() > 0, k
        assert np.abs(d_got - d_want).max() <= GRAD_ULPS * BF16_EPS * np.abs(d_want).max(), k
    got_u, want_u = (np.concatenate([(d[k] - before[k]).ravel() for k in sorted(ref)])
                     for d in (after, ref))
    assert np.linalg.norm(got_u - want_u) <= GRAD_RTOL * np.linalg.norm(want_u)


def test_plda_scoring_matches_reference():
    extra = {}
    run = bench.bench_plda_scoring(_rng(), extra, device="cpu", shapes=SMALL, repeats=1)
    assert run.scores.shape == (SMALL.plda_models, SMALL.plda_tests)
    assert run.block_err <= bench.PLDA_RTOL and extra["plda_trials_per_s"] > 0
    p = run.plda
    want = np.asarray(jdev.plda_score_matrix_device(
        jplda.Plda(mean=p.mean, transform=p.transform, psi=p.psi), run.models, run.tests))
    scale = np.abs(want).max()
    np.testing.assert_allclose(run.scores.numpy(), want, atol=1e-3 * scale, rtol=1e-3)


# ----------------------------------------------------------- the line and its shapes


def _bench_py():
    return ast.parse((REPO / "bench.py").read_text())


def _functions(tree):
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def bench_py_keys():
    """(the keys of `main`'s ``result`` dict, every ``extra["..."]`` key)."""
    fns = _functions(_bench_py())
    result = next(n.value for n in ast.walk(fns["main"]) if isinstance(n, ast.Assign)
                  and [t.id for t in n.targets if isinstance(t, ast.Name)] == ["result"])
    top = {k.value for k in result.keys}
    extra = {n.slice.value for n in ast.walk(_bench_py()) if isinstance(n, ast.Subscript)
             and isinstance(n.value, ast.Name) and n.value.id == "extra"
             and isinstance(n.slice, ast.Constant)}
    return top, extra


def bench_py_constants(fn_name):
    """Each name a `bench.py` function binds to a number (``a, b = 1, 2``
    included), in source order; a later binding wins."""
    out = {}
    for n in ast.walk(_functions(_bench_py())[fn_name]):
        if not isinstance(n, ast.Assign) or len(n.targets) != 1:
            continue
        t, v = n.targets[0], n.value
        pairs = (zip(t.elts, v.elts) if isinstance(t, ast.Tuple) and isinstance(v, ast.Tuple)
                 else [(t, v)])
        for name, val in pairs:
            if isinstance(name, ast.Name) and isinstance(val, ast.Constant) \
                    and isinstance(val.value, (int, float)):
                out[name.id] = val.value
    return out


def test_line_carries_bench_py_keys(capsys):
    """A successful run prints one line with `bench.py`'s result keys plus
    "device", and every ``extra`` key `bench.py` writes, none null."""
    top, extra_keys = bench_py_keys()
    assert {"metric", "value", "unit", "vs_baseline", "extra"} <= top
    assert len(extra_keys) == 7, extra_keys
    line, runs = bench.main(device="cpu", repeats=2, shapes=SMALL)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert set(line) == top | {"device"} and set(line["extra"]) == extra_keys
    assert line["metric"] == "xvector_extraction_throughput"
    assert line["unit"] == "audio_seconds_per_second_per_chip"
    assert line["device"] == "cpu" and set(runs) == {"extraction", "training", "plda"}
    values = [line["value"], line["vs_baseline"], *line["extra"].values()]
    assert all(v is not None and np.isfinite(v) and v > 0 for v in values), line
    assert len(runs["extraction"].timing.ms) == 2


def test_default_shapes_are_bench_py():
    ext, tr, pl = (bench_py_constants(f) for f in
                   ("bench_extraction", "bench_training", "bench_plda_scoring"))
    s = bench.Shapes()
    assert (s.utts, s.secs, s.extract_iters) == (ext["batch"], ext["secs"], ext["iters"])
    assert (s.chunks, s.chunk_frames, s.superstep) == (tr["tb"], tr["chunk_len"], tr["K"])
    assert (s.am_chunks, s.am_frames, s.pair_superstep) == (tr["am_b"], tr["am_len"], tr["K5"])
    assert (s.plda_dim, s.plda_models, s.plda_tests, s.plda_iters) == (
        pl["dim"], pl["n_models"], pl["n_tests"], pl["iters"])
    # the training loops' lengths: time_loop's default, and the supersteps' iters=
    training = _functions(_bench_py())["bench_training"]
    loop = next(n for n in ast.walk(training)
                if isinstance(n, ast.FunctionDef) and n.name == "time_loop")
    assert [a.arg for a in loop.args.kwonlyargs] == ["iters"]
    assert s.step_iters == loop.args.kw_defaults[0].value
    given = {k.value.value for n in ast.walk(training) if isinstance(n, ast.Call)
             for k in n.keywords if k.arg == "iters"}
    assert given == {s.superstep_iters}
    assert s.xvector.num_speakers == 5000 and s.xvector.embed_dim == 512
    assert s.xvector.frame_specs[-1].dim == 1500
    assert (s.combined.num_speakers, s.combined.num_senones) == (5000, 4000)
    assert bench.REPEATS >= 10


# ----------------------------------------------------------------- failures


def _add(fn, delta, index=None):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        if index is None:
            return out + delta
        return (out[index] + delta,) + tuple(out[index + 1:])
    return wrapped


def _plant(monkeypatch, stage):
    if stage == "mfcc":  # cepstra 0.01 off the plain version
        from sepi_tpu_torch.ops import mfcc_cuda
        monkeypatch.setattr(mfcc_cuda, "mfcc_fused", _add(mfcc_cuda.mfcc_fused, 0.01, 0))
    elif stage == "train":  # a step that updates nothing
        from sepi_tpu_torch.train import trainer
        monkeypatch.setattr(trainer, "apply_updates", lambda params, updates: None)
    else:  # trial scores one nat off
        from sepi_tpu_torch import backend
        monkeypatch.setattr(backend, "plda_score_matrix_device",
                            _add(backend.plda_score_matrix_device, 1.0))


@pytest.mark.parametrize("stage", ["mfcc", "train", "plda"])
def test_planted_fault_fails_the_run(monkeypatch, capsys, stage):
    """Each stage's check catches a fault in what it timed: the run raises
    and its line says why, with no "device"."""
    _plant(monkeypatch, stage)
    with pytest.raises(bench.BenchCheckFailed):
        bench.main(device="cpu", repeats=1, shapes=SMALL)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "BenchCheckFailed" in line["error"] and "device" not in line


def _run(code, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_a_failing_stage_exits_non_zero():
    """`python -m sepi_tpu_torch.bench`'s entry with a stage that raises:
    the line is printed with the error, and the exit code is not 0."""
    out = _run("import sys\n"
               "from sepi_tpu_torch import bench\n"
               "def boom(*args, **kwargs):\n"
               "    raise RuntimeError('planted stage failure')\n"
               "bench.bench_extraction = boom\n"
               "sys.exit(bench.cli(['--device', 'cpu']))\n")
    assert out.returncode != 0
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert "planted stage failure" in line["error"] and line["value"] is None
    assert "planted stage failure" in out.stderr


def test_main_without_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main()
    with pytest.raises(RuntimeError, match="cuda"):
        bench.bench_extraction(_rng(), shapes=SMALL)


def test_module_run_without_a_gpu_fails():
    out = _run("import runpy, torch\n"
               "torch.cuda.is_available = lambda: False\n"
               "runpy.run_module('sepi_tpu_torch.bench', run_name='__main__')\n")
    assert out.returncode != 0 and "device 'cuda' requested" in out.stderr
    assert '"value"' not in out.stdout


def test_time_calls_counts_its_calls():
    calls = []
    timing, last = bench.time_calls(lambda: calls.append(1) or len(calls),
                                    torch.device("cpu"), iters=3, repeats=4, warmup=2)
    assert len(calls) == 2 + 3 * 4 and last == len(calls)
    assert len(timing.ms) == 4 and timing.iters == 3 and all(m >= 0 for m in timing.ms)
    assert "R=4" in timing.describe()


def test_smoke_phase_15_on_the_cpu():
    """chip_smoke's phase 15 at the small shapes: the bench's line and its
    checks, no kernel launch on the CPU."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    out = chip_smoke.phase_bench(None, device="cpu", repeats=1, shapes=SMALL)
    assert out["launches"] == 0 and out["mfcc_err"] == 0.0
    assert out["line"]["device"] == "cpu" and out["line"]["value"] > 0
