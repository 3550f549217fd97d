"""Multi-device dry run: one real data-parallel pass of every sharded path.

Port of `__graft_entry__.dryrun_multichip`.  `dryrun_multichip(n)` runs
inside an initialised world of ``n`` ranks (`multihost.initialize`) and
checks, on tiny widths with the real graph structure:
- one data-parallel step of the v2 x-vector;
- the v5 combined c-vector's xvec step and am step;
- a K = 4 superstep;
- sharded extraction;
- the sharded GMM E-step against the local one;
- the sharded PLDA trial matrix.
The models are 5-10M parameters at full width, so data parallelism is the
only sharded axis (the model axis is kept, of size 1).

`launch(n, fn, ...)` starts ``n`` rank processes with
`torch.multiprocessing` and runs ``fn(*args)`` in each inside the world;
``python -m sepi_tpu_torch.parallel.dryrun N [--device cpu] [--backend
gloo]`` runs the dry run that way.  ``n`` ranks on fewer cards need
``backend="gloo"``: NCCL refuses two ranks on one device.
"""

from __future__ import annotations

import argparse
import datetime
import multiprocessing
import sys
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda") -> None:
    """The dry run on a mesh of ``n_devices`` ranks; every rank calls it.
    Raises on a non-finite result or a sharded/local mismatch."""
    import torch.distributed as dist

    from ..backend.device import plda_score_matrix_sharded
    from ..backend.plda import Plda
    from ..classical.gmm import accumulate_stats, accumulate_stats_sharded, init_diag_from_frames
    from ..config import ExtractConfig, OptimizerConfig
    from ..extract import EmbeddingExtractor
    from ..models import AmConfig, CombinedConfig, CombinedCVector, TdnnSpec, XVector, XVectorConfig
    from ..train import build_optimizer, create_train_state
    from ..train.trainer import make_am_step, make_superstep, make_xvec_step
    from .mesh import make_mesh, mesh_device

    if not dist.is_initialized() or dist.get_world_size() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs an initialised world of at "
                           f"least {n_devices} ranks")
    mesh = make_mesh(num_devices=n_devices)
    dev = mesh_device(mesh)
    if torch.device(device).type != dev.type:
        raise ValueError(f"device {device} disagrees with the mesh's {dev}")
    b = max(2 * n_devices, 8)
    rng = np.random.default_rng(0)  # the same global data on every rank
    tx, _ = build_optimizer(OptimizerConfig(), total_steps=10)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    # v2 x-vector data-parallel step (tiny widths, the real graph)
    xcfg = XVectorConfig(
        feat_dim=23, num_speakers=16,
        frame_specs=(TdnnSpec(32, (-2, -1, 0, 1, 2)), TdnnSpec(32, (-2, 0, 2)),
                     TdnnSpec(32, (-3, 0, 3)), TdnnSpec(32, (0,)), TdnnSpec(64, (0,))),
        embed_dim=32,
    )
    feats = rng.normal(size=(b, 60, 23)).astype(np.float32)
    labels = rng.integers(0, 16, size=b).astype(np.int64)
    state = create_train_state(XVector(xcfg), tx, 0, dev, mesh=mesh)
    metrics = make_xvec_step(tx, mesh=mesh)(state, t(feats), t(labels), 1.0)
    _finite("v2 step objf", metrics["objf"])

    # v5 combined c-vector multitask steps
    ccfg = CombinedConfig(
        feat_dim=23, num_speakers=16, num_senones=40,
        am=AmConfig(num_senones=40, specs=(
            TdnnSpec(32, (-2, -1, 0, 1, 2)), TdnnSpec(32, (-1, 0, 1)), TdnnSpec(32, (-1, 0, 1)),
            TdnnSpec(32, (-3, 0, 3)), TdnnSpec(16, (-6, -3, 0)))),
        embed_dim=32, hidden_dim=32, pool_dim=64,
    )
    cstate = create_train_state(CombinedCVector(ccfg), tx, 1, dev, mesh=mesh)
    m1 = make_xvec_step(tx, {"task": "xvec"}, mesh)(cstate, t(feats), t(labels), 1.0)
    left, right = ccfg.am_context
    am_labels = rng.integers(0, 40, size=(b, 60 - left - right)).astype(np.int64)
    m2 = make_am_step(tx, {"task": "am"}, mesh)(cstate, t(feats), t(am_labels), 1.0)
    _finite("v5 xvec step objf", m1["objf"])
    _finite("v5 am step objf", m2["objf"])

    # K = 4 steps in one superstep
    k = 4
    sfeats = rng.normal(size=(k, b, 60, 23)).astype(np.float32)
    slabels = rng.integers(0, 16, size=(k, b)).astype(np.int64)
    sm = make_superstep(tx, mesh=mesh)(state, t(sfeats), t(slabels),
                                       torch.ones(k, device=dev))
    _finite("superstep objf", sm["objf"])

    # sharded extraction: one bucketed batch over the data axis
    extractor = EmbeddingExtractor(state.model, ExtractConfig(min_chunk_size=25, chunk_size=60,
                                                              batch_size=b),
                                   min_frames=15, mesh=mesh)
    embs = extractor.extract_utterances(
        {f"u{i:02d}": rng.normal(size=(40 + 3 * i, 23)).astype(np.float32) for i in range(b)})
    if len(embs) != b or not all(np.isfinite(e).all() for e in embs.values()):
        raise RuntimeError("sharded extraction: missing or non-finite embeddings")

    # map-reduce GMM E-step against the local one
    frames = rng.normal(size=(64 * n_devices, 8)).astype(np.float32)
    gmm = init_diag_from_frames(frames, num_comp=4, seed=0, device=dev)
    sharded = accumulate_stats_sharded(gmm, frames, mesh, num_gselect=2)
    local = accumulate_stats(gmm, frames, num_gselect=2)
    np.testing.assert_allclose(sharded.gamma.cpu().numpy(), local.gamma.cpu().numpy(),
                               rtol=1e-4)

    # sharded PLDA trial scoring
    dim = 6
    plda = Plda(mean=np.zeros(dim), transform=np.eye(dim), psi=np.linspace(1.0, 2.0, dim))
    enroll = rng.normal(size=(2 * n_devices, dim)).astype(np.float32)
    test = rng.normal(size=(5, dim)).astype(np.float32)
    llr = plda_score_matrix_sharded(plda, enroll, test, mesh)
    if tuple(llr.shape) != (2 * n_devices, 5) or not torch.isfinite(llr).all():
        raise RuntimeError(f"sharded PLDA: shape {tuple(llr.shape)} or non-finite")


def _finite(what: str, x: torch.Tensor) -> None:
    if not torch.isfinite(x).all():
        raise RuntimeError(f"{what} not finite: {x}")


def _rank_main(rank: int, n: int, port: int, device: str, backend: Optional[str],
               timeout_s: float, fn: Callable, args: Sequence) -> None:
    from .multihost import initialize, shutdown

    torch.set_num_threads(1)
    initialize(f"127.0.0.1:{port}", n, rank, backend=backend, device=device,
               timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(*args)
    finally:
        shutdown()


def launch(n: int, fn: Callable, args: Sequence = (), device: DeviceLike = "cuda",
           backend: Optional[str] = None, timeout_s: float = 600.0) -> None:
    """Run ``fn(*args)`` in ``n`` spawned rank processes of one world (rank
    ``i`` on card ``i`` modulo the card count).  Raises if a rank fails or
    the whole run outlasts ``timeout_s`` (also each collective's limit);
    the ranks are killed then."""
    from .multihost import _free_port

    dev = torch.device(device)
    if dev.type == "cuda" and backend in (None, "nccl") and n > torch.cuda.device_count():
        raise ValueError(f"{n} ranks on {torch.cuda.device_count()} card(s): NCCL refuses two "
                         "ranks on one device; pass backend='gloo'")
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(n, _free_port(), str(dev), backend, timeout_s, fn, tuple(args)),
        nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n}-rank run exceeded {timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    launch(a.n, dryrun_multichip, (a.n, a.device), device=a.device, backend=a.backend,
           timeout_s=a.timeout)
    print(f"dryrun_multichip({a.n}) on {a.device} passed in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    multiprocessing.freeze_support()
    sys.exit(main())
