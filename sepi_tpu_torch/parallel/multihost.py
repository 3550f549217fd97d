"""Multi-process initialisation and data distribution.

Port of `sepi_tpu/parallel/multihost.py` on `torch.distributed`.  The
reference's cluster layer (`utils/run.pl` / `queue.pl` + shared-filesystem
IPC) becomes one process per card, every process running the same
program: `initialize` wires them into one world, each feeds its shard of
every batch, the reductions go over the mesh (`parallel.mesh`), and only
the primary writes checkpoints and files.

A multi-GPU run starts with ``torchrun --nproc-per-node N script.py``,
where the script calls bare `initialize()` (it reads torchrun's
environment) and `mesh.make_mesh()`, and passes the mesh to a trainer or
driver.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from .mesh import (batch_sharded, data_index, data_size, mesh_groups, mesh_ranks,
                   require_member)

# the device type the world was initialised for ("cuda" or "cpu")
_DEVICE_TYPE = {"value": None}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               timeout: datetime.timedelta = datetime.timedelta(minutes=30),
               device: DeviceLike = "cuda") -> None:
    """Join (or start) the world of processes; a no-op when this process
    already belongs to one.

    ``coordinator_address`` is "host:port" of rank 0's store; with it,
    ``num_processes`` and ``process_id`` describe this process.  Left out,
    they come from torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), and with no such
    environment the world is this process alone, on a free local port.

    ``backend`` defaults to "nccl" for a CUDA ``device`` and "gloo" for
    the CPU; "gloo" on CUDA is the caller's choice (ranks that share one
    card, which NCCL refuses), never a silent switch.  On CUDA the process
    takes card ``LOCAL_RANK`` (or ``process_id``) modulo the card count.

    Failure policy (the reference's): a multi-process request that fails
    raises; it never degrades to processes that run unconnected."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if coordinator_address is None:
        if num_processes > 1:
            raise RuntimeError(f"a {num_processes}-process world needs a coordinator address")
        coordinator_address = f"127.0.0.1:{_free_port()}"
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs device='cuda'")
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    try:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, timeout=timeout)
    except Exception as e:
        raise RuntimeError(
            f"torch.distributed init failed for process {process_id} of {num_processes} "
            f"(coordinator {coordinator_address!r}, backend {backend}); refusing to run "
            "unconnected") from e
    _DEVICE_TYPE["value"] = dev.type


def world_device_type() -> str:
    """The device type `initialize` set the world up for."""
    if _DEVICE_TYPE["value"] is None:
        raise RuntimeError("no world: call parallel.multihost.initialize first")
    return _DEVICE_TYPE["value"]


def shutdown() -> None:
    """Leave the world (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE_TYPE["value"] = None


def is_primary(mesh=None) -> bool:
    """The process that writes: with ``mesh``, the mesh's first rank (a
    rank outside the mesh raises); without, rank 0 of the world, or a
    process outside any world."""
    if mesh is not None:
        require_member(mesh)
        return dist.get_rank() == mesh_ranks(mesh)[0]
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(mesh) -> None:
    """Wait for every rank of ``mesh`` (a no-op without one; a rank
    outside the mesh raises)."""
    if mesh is not None:
        for g in mesh_groups(mesh):
            dist.barrier(group=g)


def local_batch_slice(global_batch: int, mesh=None) -> slice:
    """This process's row range of a global batch: by data-axis index
    over the data-axis size of ``mesh``, or by rank over the world size.
    A batch the count does not divide raises."""
    if mesh is not None:
        n, i = data_size(mesh), data_index(mesh)
    elif dist.is_initialized():
        n, i = dist.get_world_size(), dist.get_rank()
    else:
        n, i = 1, 0
    if global_batch % n:
        raise ValueError(f"batch {global_batch} not divisible by {n} "
                         + ("on the data axis" if mesh is not None else "processes"))
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def assemble_global_batch(local_arrays, mesh, spec=None):
    """The global batch from every process's local shard (the counterpart
    of `jax.make_array_from_process_local_data`): a DTensor over ``mesh``
    with placements ``spec`` (default `mesh.batch_sharded`) whose local
    tensor is ``local_arrays`` on this rank's device.  Tuples, lists and dicts
    map leaf by leaf.  The steps take its local shard."""
    from torch.distributed.tensor import DTensor

    from .mesh import mesh_device

    x = local_arrays
    if isinstance(x, dict):
        return {k: assemble_global_batch(v, mesh, spec) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(assemble_global_batch(v, mesh, spec) for v in x)
    placements = spec if spec is not None else batch_sharded(mesh)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return DTensor.from_local(t.to(mesh_device(mesh)), mesh, placements, run_check=False)
