"""Helpers of the port's multi-process tests (not a test module).

- `cpu_world_mesh()`: this process as a gloo world of size 1 on the CPU,
  with its (1, 1) mesh, for the single-process cases.
- `run_ranks(n, mode, workdir, inputs)`: ``n`` rank processes of
  `torch_mp_worker.py` (gloo, the CPU, ``tcp://127.0.0.1`` on a free port,
  one thread each, a 60 s process-group timeout) on the inputs pickled to
  ``workdir``; returns each rank's pickled results.  The child's
  PYTHONPATH is the repository alone, as tests/test_multiprocess.py sets
  it, so the ranks import no JAX.
"""

import contextlib
import datetime
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_mp_worker.py"
RANK_TIMEOUT_S = 240


@contextlib.contextmanager
def cpu_world_mesh():
    from sepi_tpu_torch.parallel import initialize, make_mesh, shutdown

    initialize(device="cpu", timeout=datetime.timedelta(seconds=30))
    try:
        yield make_mesh()
    finally:
        shutdown()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(n: int, mode: str, workdir, inputs=None, timeout: float = RANK_TIMEOUT_S):
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs or {}, f)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for k in ("JAX_PLATFORM_NAME", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        env.pop(k, None)
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(n), port, str(workdir),
                               mode], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env, cwd=str(REPO)) for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"
        assert f"rank {r}: PASS" in out, out[-3000:]
    results = []
    for r in range(n):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results
