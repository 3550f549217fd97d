"""Fresh-process probe of the port's Box-Muller dither against the JAX package.

The parity test `tests/test_torch_dither.py::test_hash_normal_pair_matches`
once failed on a loaded machine, on the first call in a process only.  This
script starts many fresh processes, several at a time, and in each makes
that first call on the test's inputs, for two versions of the port's
Box-Muller:

- ``f64``: `sepi_tpu_torch.ops.dither.hash_normal_pair` as shipped
  (log/sqrt/cos/sin in float64, each output rounded once to float32);
- ``f32``: the same formula with float32 transcendentals, the earlier
  version, kept here as the control that shows the probe can see the fault.

It prints, per version, how many processes exceeded the test's 1e-5 limit
and the largest error seen.  Run from the repo root on the CPU:

    python tools/dither_probe.py --runs 128 --parallel 8
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
LIMIT = 1e-5  # tests/test_torch_dither.py


def child(version: str) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from sepi_tpu.ops import dither as jd
    from sepi_tpu_torch.ops import dither as td

    torch.set_num_threads(2)
    span = 10400
    rng = np.random.default_rng(span)  # the test's inputs for this span
    seed = rng.integers(0, 2**32, size=(8, 1), dtype=np.uint64).astype(np.uint32)
    seed.flat[:4] = [0, 2**31 - 1, 2**31, 2**32 - 1]
    ctr = np.arange(512, dtype=np.uint32)[None, :]
    ts, tc = torch.from_numpy(seed.astype(np.int64)), torch.from_numpy(ctr.astype(np.int64))
    if version == "f64":
        g1, g2 = td.hash_normal_pair(ts, tc, span)
    else:
        u1 = (td.u24(ts, tc) + 1.0) * td._INV_2_24
        ang = td._ANG_SCALE * td.u24(ts, (tc + span) & td.MASK32)
        r = torch.sqrt(-2.0 * torch.log(u1))
        g1, g2 = r * torch.cos(ang), r * torch.sin(ang)
    r1, r2 = jd.hash_normal_pair(jnp.asarray(seed), jnp.asarray(ctr), span)
    err = max(float(np.abs(g1.numpy() - np.asarray(r1)).max()),
              float(np.abs(g2.numpy() - np.asarray(r2)).max()))
    print(json.dumps({"version": version, "max_abs_err": err}))


def run_one(version: str) -> float:
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, __file__, "--child", version], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(out.stderr[-2000:])
    return json.loads(out.stdout.strip().splitlines()[-1])["max_abs_err"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=128, help="fresh processes per version")
    ap.add_argument("--parallel", type=int, default=8, help="processes at a time")
    ap.add_argument("--versions", default="f64,f32")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return
    versions = args.versions.split(",")
    jobs = [v for _ in range(args.runs) for v in versions]  # interleaved: same load for both
    with ThreadPoolExecutor(args.parallel) as pool:
        errs = list(pool.map(run_one, jobs))
    for v in versions:
        e = [x for j, x in zip(jobs, errs) if j == v]
        print(json.dumps({"version": v, "runs": len(e), "over_limit": sum(x > LIMIT for x in e),
                          "limit": LIMIT, "max_abs_err": max(e)}))


if __name__ == "__main__":
    main()
