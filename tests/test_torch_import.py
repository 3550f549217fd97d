"""The port stands alone: no JAX, no Flax, nothing of sepi_tpu.

Every module of sepi_tpu_torch (and chip_smoke.py) imports in a fresh
interpreter whose import system refuses jax, jaxlib, flax and sepi_tpu;
entry points default to the GPU and raise where there is none.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "sepi_tpu")

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = {blocked!r}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import sepi_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sepi_tpu_torch.__path__, "sepi_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(k for k in sys.modules if k.split(".")[0] in BLOCKED)
print(len(names), leaked, ",".join(names))
"""

# the v1 slice's modules, each imported by the probe above
V1_MODULES = ("classical", "classical.gmm", "classical.ivector", "models.nnet2",
              "recipes.ivector_recipe", "recipes.nnet2_recipe", "ops.deltas")
# the bf16 and on-device backend slice's new modules
BACKEND_MODULES = ("backend.device", "backend.normalize", "backend.fusion")
# the command line, Kaldi model interop and gauntlet slice's new modules
CLI_MODULES = ("cli", "__main__", "data.corpora", "data.ldc", "data.asr_prep", "utils.nnet3",
               "utils.nnet2_io", "recipes.gauntlet")
# the mesh slice's new modules
PARALLEL_MODULES = ("parallel", "parallel.mesh", "parallel.multihost", "parallel.dryrun")
# the port's headline measurement
BENCH_MODULES = ("bench",)


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("PYTHONSTARTUP", None)
    return env


def test_imports_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(blocked=BLOCKED)],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n, leaked, names = out.stdout.strip().split(" ", 2)
    assert int(n) >= 20 and leaked == "[]", out.stdout
    assert set(f"sepi_tpu_torch.{m}" for m in V1_MODULES + BACKEND_MODULES + CLI_MODULES
               + PARALLEL_MODULES + BENCH_MODULES) <= set(names.split(","))


def test_no_import_statement_names_the_reference():
    files = list((ROOT / "sepi_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BLOCKED, f"{f}: imports {name}"


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """With no usable GPU, an entry point called without device= raises
    instead of running on the CPU."""
    from sepi_tpu_torch.backend import Plda, score_trials
    from sepi_tpu_torch.config import FrontendConfig
    from sepi_tpu_torch.data import Trial
    from sepi_tpu_torch.extract import EmbeddingExtractor, streaming_embed
    from sepi_tpu_torch.models import V2_XVECTOR, XVector
    from sepi_tpu_torch.ops import FeatureExtractor
    from sepi_tpu_torch.parallel import initialize
    from sepi_tpu_torch.recipes import extract_and_score, prepare_features_nosil

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    audio = {"u": np.zeros(8000, np.float32)}
    with pytest.raises(RuntimeError, match="cuda"):
        initialize()
    with pytest.raises(RuntimeError, match="cuda"):
        FeatureExtractor(FrontendConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        prepare_features_nosil(audio)
    with pytest.raises(RuntimeError, match="cuda"):
        EmbeddingExtractor(XVector(V2_XVECTOR))
    with pytest.raises(RuntimeError, match="cuda"):
        extract_and_score(XVector(V2_XVECTOR), None, {"u": np.zeros((50, 23), np.float32)})
    with pytest.raises(RuntimeError, match="cuda"):
        streaming_embed(XVector(V2_XVECTOR), np.zeros((50, 23), np.float32))
    plda = Plda(mean=np.zeros(2), transform=np.eye(2), psi=np.ones(2))
    vecs = {"m": np.ones(2), "t": np.ones(2)}
    with pytest.raises(RuntimeError, match="cuda"):
        score_trials(plda, vecs, vecs, [Trial("m", "t", True)], device=True)


@pytest.mark.parametrize("driver", ["run_v1", "run_v2", "run_v3", "run_v4", "run_v5"])
def test_drivers_refuse_cpu_fallback(monkeypatch, tmp_path, driver):
    """A recipe driver called without device= raises with no usable GPU,
    before it writes anything; so does the augmentation it runs."""
    from sepi_tpu_torch.data import Dataset, Utterance
    from sepi_tpu_torch.data.augment import augment_dataset, reverberate
    from sepi_tpu_torch.recipes import drivers

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = Dataset([Utterance("s-u", "s")], "d")
    audio = {"s-u": np.zeros(8000, np.float32)}
    args = (ds, audio, ds, audio) if driver == "run_v2" else (ds, audio, audio)
    wd = tmp_path / "wd"
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(drivers, driver)(*args, [], {}, str(wd))
    assert not wd.exists()
    with pytest.raises(RuntimeError, match="cuda"):
        augment_dataset(ds, audio, rirs=[np.ones(4, np.float32)])
    with pytest.raises(RuntimeError, match="cuda"):
        reverberate(audio["s-u"], np.ones(4, np.float32))


def test_drivers_import_no_classical_module():
    """The classical stack (GMM, i-vector, nnet2) is imported by `run_v1`
    alone: no module-level import of drivers.py names it, and run_v1's
    body does."""
    tree = ast.parse((ROOT / "sepi_tpu_torch" / "recipes" / "drivers.py").read_text())

    def classical_imports(nodes):
        return [n.module for n in nodes if isinstance(n, ast.ImportFrom) and any(
            k in (n.module or "") for k in ("classical", "ivector", "nnet2"))]

    assert classical_imports(tree.body) == []
    run_v1 = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run_v1")
    assert len(classical_imports(ast.walk(run_v1))) >= 3
    others = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name != "run_v1"]
    assert all(classical_imports(ast.walk(f)) == [] for f in others)


def test_v1_entry_points_refuse_cpu_fallback(monkeypatch):
    """The v1 slice's entry points raise with no usable GPU unless the
    caller names the CPU."""
    from sepi_tpu_torch.classical import train_diag_ubm
    from sepi_tpu_torch.recipes import (nnet2_posteriors, prepare_features_ivector,
                                        prepare_paired_features, pseudo_senone_alignments,
                                        train_nnet2_am, train_v1_frontend)
    from sepi_tpu_torch.models import Nnet2Config, Nnet2Multisplice

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    audio = {"u": np.zeros(8000, np.float32)}
    feats = {"u": np.zeros((40, 6), np.float32)}
    calls = [
        lambda: train_diag_ubm(feats["u"]),
        lambda: prepare_features_ivector(audio),
        lambda: prepare_paired_features(audio),
        lambda: pseudo_senone_alignments(feats, 4),
        lambda: train_v1_frontend(feats),
        lambda: train_nnet2_am(feats, {"u": np.zeros(40, np.int32)}),
        lambda: nnet2_posteriors(Nnet2Multisplice(Nnet2Config(feat_dim=6)), None, feats),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_chip_smoke_refuses_without_a_gpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_outside_the_repository(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
