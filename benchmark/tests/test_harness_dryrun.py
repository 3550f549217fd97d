"""Each cell's run, driven on the CPU at a small size; the run on the
card is a `gpu` test that skips without one."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import tiny

CELLS = list(tiny.OVERRIDES)
E2E = {"xvector_v2.extract": {"extract_audio_s_per_s", "setup_s"},
       "cvector_v5.extract": {"extract_audio_s_per_s", "setup_s"},
       "xvector_v2.verify": {"verify_p50_ms", "verify_p95_ms", "setup_s"},
       "cvector_v5.train": {"train_step_ms", "setup_s"}}
# the per-layer metrics a CPU run can read (no device trace, no peaks table)
CPU_LAYER = {"xvector_v2.extract": {"frontend_pct.extract"},
             "cvector_v5.extract": {"frontend_pct.extract"},
             "xvector_v2.verify": {"frontend_ms.verify", "embed_ms.verify",
                                   "captures_per_request.verify"},
             "cvector_v5.train": set()}


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_reports_the_cells_end_to_end_metrics(cell):
    rc, res = tiny.run(cell)
    assert rc == 0 and res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == E2E[cell]
    assert list(res)[-1] == "checks" and all(v["value"] <= v["limit"]
                                             for v in res["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_per_layer_metrics(cell):
    rc, res = tiny.run(cell, trace=1)
    assert rc == 0 and res["correct"]
    assert set(res["metrics"]) == CPU_LAYER[cell]
    assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res


def test_no_card_no_result(tmp_path):
    """Without CUDA (a machine with no card), or in a folder that holds only
    BENCHMARK.json and the benchmark, the run exits non-zero and prints
    nothing on standard output."""
    shutil.copy(f"{tiny.REPO}/BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (tiny.REPO, str(tmp_path)):
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                            "xvector_v2.extract", "--seed", "1", "--seconds", "1", "--trace", "0"],
                           cwd=cwd, capture_output=True, text=True, timeout=300,
                           env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert p.returncode != 0 and p.stdout == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs on the card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                        str(tiny.SEED), "--seconds", "3", "--trace", "0"], cwd=tiny.REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
