"""Smoke phase 7c's float32 momentum-SGD check, in fresh processes.

Phase 7c holds 3 momentum-SGD steps of the full-width V2 x-vector on the
card against the same steps on the CPU (||p_card - p_cpu|| /
||p_cpu - p_init|| <= chip_smoke.TRAJ_TOL).  Every run of it reads
5.84-5.87e-4, but one read 1.775e-2 with code that never changed.  This
probe runs the check in many fresh processes, with cuDNN's determinism
off (as 7c runs) and on, and logs per run:

- the distance, each step's objf on the card and the CPU;
- the cuDNN state (version, enabled, benchmark, deterministic, TF32);
- the CUDA kernels of a second, profiled pass of the same 3 steps (which
  cuDNN algorithms ran), and that pass's own distance.

The corpus, the features (phase 7b's corpus, MFCC on the card) and the
CPU's 3 steps are made once; each fresh process runs the card's side.

    python3 tools/train_agreement_probe.py [--runs 20]

writes one JSON line per run to ``--out`` (default
build/train_agreement/runs.jsonl) and a summary per mode to standard
output (~17 min on an H100 for 2 x 20 runs).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORK = os.path.join(ROOT, "build", "train_agreement")
BATCH, STEPS, SEED = 32, 3, 3  # phase 7c's batch, steps and initialisation seed


def _setup():
    sys.path.insert(0, ROOT)
    import torch

    # chip_smoke's phase 1: TF32 off for matmuls and cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


def _batches(nosil, dataset):
    from sepi_tpu_torch.config import ChunkConfig
    from sepi_tpu_torch.data import ChunkSampler

    sampler = ChunkSampler(nosil, dataset, ChunkConfig(), BATCH, seed=7)
    return [sampler.sample_batch() for _ in range(STEPS)]


def _config(dataset):
    import dataclasses

    from sepi_tpu_torch.models import V2_XVECTOR

    return dataclasses.replace(V2_XVECTOR, num_speakers=len(dataset.speaker_label_map()))


def _steps(cfg, batches, device):
    """Phase 7c's momentum-SGD run: (initial params, final params, objfs)."""
    import torch

    import chip_smoke
    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.train import make_xvec_step

    chain, state = chip_smoke._train_state(cfg, device, OptimizerConfig(preconditioner="none"),
                                           seed=SEED)
    p0 = chip_smoke._flat(state.model)
    step = make_xvec_step(chain)
    objf = []
    for b in batches:
        m = step(state, torch.from_numpy(b.feats).to(device), torch.from_numpy(b.labels).to(device),
                 1.0)
        objf.append(float(m["objf"]))
    return p0, chip_smoke._flat(state.model), objf


def prepare(device="cuda"):
    """Phase 7b's corpus and features on the card; the CPU's 3 steps."""
    torch = _setup()
    import numpy as np

    from sepi_tpu_torch import build
    from sepi_tpu_torch.data import make_synthetic_corpus
    from sepi_tpu_torch.recipes import prepare_features_nosil

    os.makedirs(WORK, exist_ok=True)
    if device != "cpu":
        build.build()
    t0 = time.perf_counter()
    corpus = make_synthetic_corpus(num_speakers=32, utts_per_speaker=8, duration_sec=8.0, seed=1)
    nosil = prepare_features_nosil(corpus.audio, device=device)
    corpus.dataset.save(os.path.join(WORK, "dataset.jsonl"))
    np.savez(os.path.join(WORK, "feats.npz"), **nosil)
    batches = _batches(nosil, corpus.dataset)
    p0, pc, objf = _steps(_config(corpus.dataset), batches, "cpu")
    torch.save({"p0": p0, "pc": pc, "objf": objf}, os.path.join(WORK, "cpu.pt"))
    print(f"prepared {len(nosil)} utterances and the CPU's {STEPS} steps in "
          f"{time.perf_counter() - t0:.1f} s; objf {objf}", flush=True)


def one(deterministic: bool, device="cuda"):
    """The card's side in this process; prints one JSON line."""
    torch = _setup()
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from sepi_tpu_torch.data import Dataset

    torch.backends.cudnn.deterministic = deterministic
    dataset = Dataset.load(os.path.join(WORK, "dataset.jsonl"))
    with np.load(os.path.join(WORK, "feats.npz")) as z:
        nosil = {k: z[k] for k in z.files}
    ref = torch.load(os.path.join(WORK, "cpu.pt"), weights_only=True)
    cfg = _config(dataset)
    batches = _batches(nosil, dataset)
    p0, pd, objf = _steps(cfg, batches, device)
    err = chip_smoke._traj(pd, ref["pc"], ref["p0"])
    activity = ProfilerActivity.CPU if device == "cpu" else ProfilerActivity.CUDA
    with profile(activities=[activity]) as prof:
        _, pd2, objf2 = _steps(cfg, batches, device)
        if device != "cpu":
            torch.cuda.synchronize()
    kernels = sorted({e.name for e in prof.events()
                      if e.device_type.name in ("CUDA", "CPU") and any(
                          k in e.name.lower() for k in ("conv", "cudnn", "gemm", "sm90", "xmma",
                                                        "wgrad", "dgrad", "implicit"))})
    cudnn = torch.backends.cudnn
    print(json.dumps({
        "deterministic": deterministic, "err": err, "tol": chip_smoke.TRAJ_TOL,
        "objf_card": objf, "objf_cpu": ref["objf"],
        "profiled_err": chip_smoke._traj(pd2, ref["pc"], ref["p0"]), "objf_profiled": objf2,
        "cudnn": {"version": cudnn.version(), "enabled": cudnn.enabled,
                  "benchmark": cudnn.benchmark, "deterministic": cudnn.deterministic,
                  "allow_tf32": cudnn.allow_tf32,
                  "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32},
        "kernels_sha1": hashlib.sha1("\n".join(kernels).encode()).hexdigest()[:12],
        "kernels": kernels}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("mode", nargs="?", default="all", choices=["all", "prepare", "one"])
    p.add_argument("--runs", type=int, default=20, help="fresh processes per mode")
    p.add_argument("--deterministic", type=int, default=0)
    p.add_argument("--device", default="cuda", help="'cpu' rehearses the probe without a card")
    p.add_argument("--out", default=os.path.join(WORK, "runs.jsonl"),
                   help="one JSON line per run")
    args = p.parse_args(argv)
    if args.mode == "prepare":
        prepare(args.device)
        return 0
    if args.mode == "one":
        one(bool(args.deterministic), args.device)
        return 0
    prepare(args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    rows = []
    with open(args.out, "w") as f:
        for det in (0, 1):
            for i in range(args.runs):
                t0 = time.perf_counter()
                proc = subprocess.run([sys.executable, os.path.abspath(__file__), "one",
                                       "--deterministic", str(det), "--device", args.device],
                                      cwd=ROOT,
                                      capture_output=True, text=True, timeout=600)
                line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else "{}"
                if proc.returncode != 0:
                    line = json.dumps({"deterministic": bool(det), "error": proc.stderr[-2000:]})
                row = json.loads(line)
                row["run"], row["seconds"] = i, time.perf_counter() - t0
                rows.append(row)
                f.write(json.dumps(row) + "\n")
                f.flush()
                print(f"run {i} deterministic={det}: err {row.get('err')} objf card "
                      f"{row.get('objf_card')} kernels {row.get('kernels_sha1')} "
                      f"({row['seconds']:.1f} s)", flush=True)
    for det in (False, True):
        done = [r for r in rows if r.get("deterministic") == det and "err" in r]
        failed = sum(1 for r in rows if r.get("deterministic") == det and "error" in r)
        errs = [r["err"] for r in done]
        over = sum(r["err"] > r["tol"] for r in done)
        sets = sorted({r["kernels_sha1"] for r in done})
        span = f"err min {min(errs):.4e} max {max(errs):.4e}, " if errs else ""
        print(f"deterministic={det}: {len(done)} runs ({failed} failed to run), {span}{over} "
              f"over the limit; kernel sets {sets}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
