"""The benchmark of sepi_tpu_torch, the PyTorch and CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration, traffic mix, limits, driver and per-layer readers are
files under ``benchmark/`` found by name (`harness.core`).  The run makes
its inputs and weights from ``--seed``, warms up every shape it will use,
measures for ``--seconds``, checks what the timed path produced against
the plain reference in ``benchmark/reference/``, and prints one JSON
line as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` a ``breakdown`` of
the device trace, and last ``checks``: each number compared beside its
limit, which also end standard error.  Everything else goes to standard
error.

It exits non-zero and prints no result when CUDA is not available or
has fewer cards than the cell asks for, or when the process holds JAX
or the JAX package once the window has closed.  Build and kernel caches
stay inside the checkout, under ``build/``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

PROCESS_T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux), else since this module ran."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


PROCESS_START = PROCESS_T0 - _process_age()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "sepi_tpu")


def _caches(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(root, "build", "cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole: ``sepi_tpu_torch`` is not ``sepi_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description="sepi_tpu_torch benchmark: one run of one cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def setup_paths() -> None:
    _caches(REPO)
    for path in (REPO, BENCH_DIR):
        if path not in sys.path:
            sys.path.insert(0, path)


def host_threads(args, bench_file=None) -> None:
    """The mix's ``host_threads`` (if it names one) as ``OMP_NUM_THREADS``:
    the CPU threads of torch's and the BLAS's pools, which read it when
    they load, so this runs before either is imported."""
    from harness import core

    bench = core.load_json(bench_file or os.path.join(REPO, "BENCHMARK.json"))
    n = core.find_cell(bench, args.workload).traffic.get("host_threads")
    if n is not None and not {"torch", "numpy"} & set(sys.modules):
        os.environ["OMP_NUM_THREADS"] = str(int(n))


def execute(args, device=None, overrides=None, bench_file=None, controls=(),
            process_start=PROCESS_START, root=None):
    """Run the cell's driver: (bench, cell, device, outcome), or None when
    the machine lacks the cards the cell asks for.  ``device`` (tests)
    skips the look for cards and runs there; ``overrides`` change the
    cell's files for the tests' small sizes; ``controls`` are precisions
    whose gaps to the reference the cell's driver reads too."""
    import contextlib

    import torch

    from harness import core

    root = core.BENCH_DIR if root is None else root
    bench = core.load_json(bench_file or os.path.join(REPO, "BENCHMARK.json"))
    cell = core.find_cell(bench, args.workload, root, overrides)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            log(f"no result: the cell needs {cell.chips} CUDA card(s), this machine has {n}")
            return None
        device = "cuda:0"
    dev = torch.device(device)
    ctx = core.RunContext(cell, args.seed, args.seconds, bool(args.trace), dev, process_start,
                          tuple(controls))
    with contextlib.redirect_stdout(sys.stderr):  # the program's prints: standard error
        out = core.driver_for(cell, root).run(ctx)
    return bench, cell, dev, out


def main(argv=None, device=None, overrides=None, bench_file=None, controls=(), root=None):
    """One run; returns (exit code, result dict or None).  The arguments
    past ``argv`` are `execute`'s; ``root`` is the folder the cell's
    files are found in (default: this one)."""
    args = parse(argv)
    setup_paths()
    if device is None:
        host_threads(args, bench_file)
    import json

    import torch

    from harness import core, peaks

    root = core.BENCH_DIR if root is None else core.Path(root)
    ran = execute(args, device, overrides, bench_file, controls, root=root)
    if ran is None:
        return 3, None
    bench, cell, dev, out = ran
    bad = forbidden_modules()
    if bad:
        log(f"no result: the process holds {bad} once the window has closed")
        return 4, None

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    power = _power_limit() if dev.type == "cuda" else None
    table = peaks.for_device(kind)
    metrics = {}
    for m in core.cell_metrics(bench, cell.name, bool(args.trace)):
        if args.trace:
            value = core.load_module(root / "metrics" / f"{m['name']}.py").read(out, cell, table)
        else:
            value = out.metrics.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
                   "count": cell.chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    if power is not None:
        device_info["power_limit_w"] = power
    result = {"correct": out.correct, "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "device": device_info}
    if args.trace and out.trace is not None:
        device_info["busy_s"] = out.trace.busy_s
        device_info["window_s"] = out.trace.window_s
        result["breakdown"] = out.trace.breakdown()
    log(f"# {cell.name} seed {args.seed}: window {out.window_s:.3f} s, set-up {out.setup_s:.3f} s, "
        f"attempted {out.attempted}, failed {out.failed}, {kind}, power limit {power} W, "
        f"{torch.get_num_threads()} CPU threads; "
        f"work {json.dumps(out.work, default=str)}")
    if out.spans is not None:
        log("# spans " + json.dumps({k: v for k, v in out.spans.totals.items()}))
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    for c in out.checks:
        log(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0, result


def _power_limit():
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]],
                             capture_output=True, text=True, timeout=60, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


if __name__ == "__main__":
    sys.exit(main()[0])
