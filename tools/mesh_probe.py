"""The device mesh over NCCL with one rank per card.

    python3 tools/mesh_probe.py [--ranks 4] [--device cpu --backend gloo]

On a machine with ``--ranks`` cards: `dryrun_multichip(N)` over NCCL, then
smoke phase 13b's check at world size N (`chip_smoke.mesh_steps`): 3
momentum-SGD DP steps of the full-width V2 x-vector at 64 x 200 x 23
(64 / N chunks a rank) against one process's steps on the global batch
within rtol = atol = 2e-4, every rank's parameters bit-equal to rank 0's,
a planted fault (batch-norm moments rank-local) that must read above the
limit, and each rank's median step ms beside one process's plain step.
``--device cpu --backend gloo`` rehearses it without a card (a narrow
x-vector).  Exits non-zero on a failed check.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, help="default: nccl on cuda, gloo on the CPU")
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.models import V2_XVECTOR, TdnnSpec, XVectorConfig
    from sepi_tpu_torch.parallel.dryrun import dryrun_multichip, launch
    from sepi_tpu_torch.train import make_xvec_step

    dev = torch.device(a.device)
    backend = a.backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        where = f"{cs.nvidia_smi_line()} x{torch.cuda.device_count()}"
        cfg, width = dataclasses.replace(V2_XVECTOR, num_speakers=cs.CV_SPEAKERS), "full-width V2"
    else:
        where = "cpu"
        cfg = XVectorConfig(feat_dim=23, num_speakers=40, embed_dim=32, frame_specs=tuple(
            TdnnSpec(d, o) for d, o in ((24, (-2, -1, 0, 1, 2)), (24, (-2, 0, 2)), (64, (0,)))))
        width = "narrow x-vector"
    root = os.path.join(ROOT, "build", "mesh_probe")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t = time.perf_counter()
    launch(a.ranks, dryrun_multichip, (a.ranks, dev.type), device=dev.type, backend=backend,
           timeout_s=cs.P13_RANK_TIMEOUT_S)
    cs.log(f"dryrun_multichip({a.ranks}) over {backend} on {where}: passed in "
           f"{time.perf_counter() - t:.1f} s")
    out = cs.mesh_steps(root, cfg, dev, a.ranks, backend,
                        f"{a.ranks} {backend} ranks, one a card, on {where}", width,
                        "data parallel over distinct cards" if dev.type == "cuda" else "CPU")
    chain, st = cs._train_state(cfg, dev, OptimizerConfig(preconditioner="none",
                                                          proportional_shrink=0.0), seed=3)
    f, lab = (x.to(dev) for x in cs._p13_batches(cfg, 1)[0])
    step = make_xvec_step(chain)
    plain = cs._p13_ms(lambda: step(st, f, lab, 1.0), dev)
    cs.log(f"one process's plain step at {cs.TRAIN_B} x {cs.TRAIN_T} on {where}: {plain:.3f} ms")
    shutil.rmtree(root, ignore_errors=True)
    if out["problems"]:
        print("; ".join(out["problems"]), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
