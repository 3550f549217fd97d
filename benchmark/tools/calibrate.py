"""Readings of the numbers that decide ``correct``, for setting limits.

    python3 benchmark/tools/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 3 --controls tf32 [--override JSON] [--out FILE]

Runs the cell once per seed in one process (set-up, a short window at
the cell's own load, the check), and with each run the control: the
reference computed in the lower precision named (`reference.precision`)
in the program's place, read against the reference on the same inputs.
Prints one JSON line per seed: the program's readings and the control's.
``--override`` changes the cell's files as `harness.core.find_cell` does,
e.g. '{"config": {"train": {"steps_per_dispatch": 1}}}' to read the
training cell's first steps one step a unit.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--controls", default="")
    p.add_argument("--override", default="")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    run.setup_paths()
    import torch

    controls = tuple(c for c in a.controls.split(",") if c)
    lines = []
    for seed in (int(s) for s in a.seeds.split(",")):
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        args = run.parse(["--workload", a.workload, "--seed", str(seed), "--seconds",
                          str(a.seconds), "--trace", "0"])
        ran = run.execute(args, overrides=json.loads(a.override) if a.override else None,
                          controls=controls, process_start=time.perf_counter())
        if ran is None:
            return 3
        out = ran[3]
        line = {"workload": a.workload, "seed": seed, "override": a.override,
                "correct": out.correct,
                "readings": out.work.get("readings"), "metrics": out.metrics,
                "attempted": out.attempted, "reference_s": out.work.get("reference_s")}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if a.out:
        with open(a.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
