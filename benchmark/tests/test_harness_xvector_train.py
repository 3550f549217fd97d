"""The x-vector trained through its model kind's ``train_setup``
(`models/xvector.py`, as `recipes/pipeline.train_xvector_model`
assembles it), as a one-card cell that a later change adds by files and
entries alone, on the CPU at the tests' small sizes: the plain reference
follows its checked units, and the fp8 control and half of each batch
fail what decides ``correct``."""

import json
import shutil

import pytest

import tiny
from harness import core

CELL = "xvector_v2.train"
OVERRIDES = {"config": tiny.XTRAIN, "traffic": tiny.XTRAIN_MIX}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the folders with the cell's limits and entries added."""
    root = tmp_path_factory.mktemp("bench")
    for d in ("configs", "traffic", "limits", "metrics", "drivers", "models"):
        shutil.copytree(core.BENCH_DIR / d, root / d)
    limits = dict(core.load_json(core.BENCH_DIR / "limits" / "cvector_v5.train.json")["limits"],
                  **tiny.OVERRIDES["cvector_v5.train"]["limits"]["limits"])
    (root / "limits" / f"{CELL}.json").write_text(json.dumps({"limits": limits}))
    bench = json.load(open(f"{tiny.REPO}/BENCHMARK.json"))
    bench["workloads"].append({"name": CELL, "config": "xvector_v2", "traffic": "train_multitask",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("train_step_ms", "mfu.train", "device_idle_pct.train"):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_the_xvector_trains_one_task_that_holds_the_reference(root):
    import run as bench_run

    args = bench_run.parse(["--workload", CELL, "--seed", str(tiny.SEED), "--seconds", "0.3"])
    bench, cell, _, out = bench_run.execute(args, device="cpu", overrides=OVERRIDES,
                                            bench_file=str(root / "BENCHMARK.json"),
                                            controls=("fp8", "bf16-half"), root=root)
    assert cell.model.TASKS == {"xvec": {}}
    checks = {c.name: c for c in out.checks}
    assert out.correct, {c.name: (c.value, c.limit) for c in out.checks}
    assert out.work["checked_units"]["set-up"] >= 6 and out.work["steps"] > 0
    assert out.work["am_units"] == 0 and out.work["train_flops"] > 0
    for control in ("fp8", "bf16-half"):
        got = out.work["readings"][control]
        assert any(got[k] > c.limit for k, c in checks.items() if k in got), control


def test_the_run_reports_the_cells_metrics(root):
    rc, res = tiny.run(CELL, overrides=OVERRIDES, bench_file=str(root / "BENCHMARK.json"),
                       root=root)
    assert rc == 0 and res["correct"] and res["device"]["count"] == 1
    assert set(res["metrics"]) == {"train_step_ms", "setup_s"}
