"""The harness finds every file of a cell by name, and a cell, a mix, a
per-layer metric and a model kind are added by files and entries alone."""

import json
import re
import shutil

import pytest

import tiny
from harness import core

BENCH = json.load(open(f"{tiny.REPO}/BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = core.find_cell(BENCH, cell)
    assert c.config["name"] == c.entry["config"]
    assert hasattr(core.driver_for(c), "run")
    assert c.limits["limits"]
    for m in core.cell_metrics(BENCH, cell, trace=True):
        assert hasattr(core.load_module(core.BENCH_DIR / "metrics" / f"{m['name']}.py"), "read")


def test_the_metrics_of_each_cell():
    e2e = {w["name"]: {m["name"] for m in core.cell_metrics(BENCH, w["name"], False)}
           for w in BENCH["workloads"]}
    assert e2e["xvector_v2.extract"] == e2e["cvector_v5.extract"] == {"extract_audio_s_per_s",
                                                                      "setup_s"}
    assert e2e["xvector_v2.verify"] == {"verify_p50_ms", "verify_p95_ms", "setup_s"}
    assert e2e["cvector_v5.train"] == {"train_step_ms", "setup_s"}
    layer = {m["name"] for m in core.cell_metrics(BENCH, "xvector_v2.verify", True)}
    assert layer == {"frontend_ms.verify", "embed_ms.verify", "captures_per_request.verify",
                     "device_idle_pct.verify"}


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    reported = {}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25
        for c in m.get("workloads", cells):
            reported.setdefault(c, set()).add(m["name"])
    assert all("setup_s" in v and len(v) >= 2 for v in reported.values())
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["source"] in ("device_trace", "program_span",
                                                         "program_counter", "host_clock")
        for c in m["workloads"]:
            assert m["moves"] in reported[c]
            layers.setdefault(c, []).append(m["name"])
    assert set(layers) == set(cells)


def test_a_cell_added_by_files_and_entries_alone(tmp_path):
    """A throwaway configuration, mix, limits and per-layer metric, as a
    later change would add them: new files under a copy of the folders
    and new entries, no existing file edited."""
    for d in ("configs", "traffic", "limits", "metrics", "drivers", "models"):
        shutil.copytree(core.BENCH_DIR / d, tmp_path / d)
    cfg = core.merge(core.load_json(core.BENCH_DIR / "configs" / "xvector_v2.json"),
                     dict(tiny.XVEC, name="xvector_tiny"))
    (tmp_path / "configs" / "xvector_tiny.json").write_text(json.dumps(cfg))
    mix = core.merge(core.load_json(core.BENCH_DIR / "traffic" / "extract_shards.json"),
                     dict(tiny.SERVE, duration_s={"law": "uniform", "min": 1.5, "max": 2.5}))
    (tmp_path / "traffic" / "short_shards.json").write_text(json.dumps(mix))
    (tmp_path / "limits" / "xvector_tiny.short.json").write_text(
        json.dumps({"limits": {"embedding_rel_gap": 5e-5}}))
    (tmp_path / "metrics" / "shards.short.py").write_text(
        "def read(out, cell, peaks):\n    return out.work['shards']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "xvector_tiny", "source": "test", "reduced": [],
                             "file": "benchmark/configs/xvector_tiny.json", "why": "test"})
    bench["workloads"].append({"name": "xvector_tiny.short", "config": "xvector_tiny",
                               "traffic": "short_shards", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("xvector_tiny.short")
    bench["per_layer"].append({"name": "shards.short", "unit": "shards", "better": "higher",
                               "source": "host_clock", "layer": "host batching and frontend",
                               "moves": "extract_audio_s_per_s",
                               "workloads": ["xvector_tiny.short"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    for trace, want in ((0, {"extract_audio_s_per_s", "setup_s"}), (1, {"shards.short"})):
        rc, res = tiny.run("xvector_tiny.short", trace=trace, overrides={}, bench_file=str(path),
                           root=tmp_path)
        assert rc == 0 and res["correct"]
        assert want <= set(res["metrics"])
    assert res["metrics"]["shards.short"]["value"] >= 1


def test_a_mix_sets_the_runs_cpu_threads_before_torch_loads():
    import os
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, 'benchmark'); import run\n"
            "a = run.parse(['--workload', 'xvector_v2.verify', '--seed', '1', '--seconds', '1'])\n"
            "run.setup_paths(); run.host_threads(a)\n"
            "import torch; print(torch.get_num_threads())\n")
    want = core.find_cell(BENCH, "xvector_v2.verify").traffic["host_threads"]
    env = {k: v for k, v in os.environ.items() if k != "OMP_NUM_THREADS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True,
                         text=True, check=True, env=env)
    assert int(out.stdout.split()[-1]) == want


def test_a_model_kind_added_by_files_and_entries_alone(tmp_path):
    """A kind no file of the benchmark names (`tests/toy_kind.py`, a flat
    TDNN), added as ``models/tdnn_flat.py`` with a configuration, limits
    and two cells, one extracting and one training, in a copy of the
    folders: both run end to end and are correct."""
    for d in ("configs", "traffic", "limits", "metrics", "drivers", "models"):
        shutil.copytree(core.BENCH_DIR / d, tmp_path / d)
    assert not (tmp_path / "models" / "tdnn_flat.py").exists()
    shutil.copy(core.BENCH_DIR / "tests" / "toy_kind.py", tmp_path / "models" / "tdnn_flat.py")
    base = core.load_json(core.BENCH_DIR / "configs" / "xvector_v2.json")
    cfg = {k: v for k, v in core.merge(base, tiny.XTRAIN).items() if k != "arch"}
    cfg.update(name="flat_tiny", model="tdnn_flat", layers=tiny.X_ARCH["frames"]["layers"])
    (tmp_path / "configs" / "flat_tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "limits" / "flat_tiny.extract.json").write_text(
        json.dumps({"limits": {"embedding_rel_gap": 5e-5}}))
    train_limits = dict(core.load_json(core.BENCH_DIR / "limits" / "cvector_v5.train.json")["limits"],
                        **tiny.OVERRIDES["cvector_v5.train"]["limits"]["limits"])
    (tmp_path / "limits" / "flat_tiny.train.json").write_text(json.dumps({"limits": train_limits}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "flat_tiny", "source": "test", "reduced": [],
                             "file": "benchmark/configs/flat_tiny.json", "why": "test"})
    for cell, mix in (("flat_tiny.extract", "extract_shards"), ("flat_tiny.train", "train_multitask")):
        bench["workloads"].append({"name": cell, "config": "flat_tiny", "traffic": mix, "chips": 1,
                                   "why": "test"})
    bench["end_to_end"][0]["workloads"].append("flat_tiny.extract")
    bench["end_to_end"][1]["workloads"].append("flat_tiny.train")
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    for cell, over, want in (("flat_tiny.extract", {"traffic": tiny.SERVE}, "extract_audio_s_per_s"),
                             ("flat_tiny.train", {"traffic": tiny.XTRAIN_MIX}, "train_step_ms")):
        rc, res = tiny.run(cell, overrides=over, bench_file=str(path), root=tmp_path)
        assert rc == 0 and res["correct"], res and res["checks"]
        assert {want, "setup_s"} == set(res["metrics"])


def test_an_unknown_model_kind_names_its_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError, match=r"models/no_such_kind\.py"):
        core.model_kind({"model": "no_such_kind"}, tmp_path)
    with pytest.raises(FileNotFoundError, match=r"models/no_such_kind\.py"):
        core.model_kind({"model": "no_such_kind"})
