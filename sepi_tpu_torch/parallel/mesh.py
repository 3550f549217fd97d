"""Device mesh, placements and the collectives of the data-parallel paths.

Port of `sepi_tpu/parallel/mesh.py` on `torch.distributed`.  The
reference's mesh is ('data', 'model') over every device, with batches
sharded over 'data' and parameters replicated; GSPMD inserts the gradient
all-reduce.  Here each process of an initialised world (`multihost.
initialize`) holds one card (or the CPU) and computes on its shard of the
batch, and the reductions are explicit calls over the mesh's 'data'
sub-group:

- `all_reduce_mean`: an autograd function, all-reduce mean forward and
  backward, through which the batch-norm moments flow (the gradient of a
  rank's loss reaches the other ranks' activations);
- `reduce_sum_`: the gradients and the reported metrics (averaged) and
  the GMM statistics (summed), one flat buffer per call;
- `all_gather_rows`: the extraction and scoring outputs, so that every
  rank returns the whole result, as the reference replicates its output;
- `broadcast_state`: the primary's parameters, buffers and optimizer state
  at the start of training, as DDP does.

A mesh may cover part of the world (`make_mesh(devices=[1, 2])`): its
collectives, its barrier (`multihost.barrier`) and its primary
(`multihost.is_primary(mesh)`, the mesh's first rank) are the mesh's own.
A rank outside the mesh that is handed it raises (`require_member`) and
never waits in a collective.

The TDNNs fit one card, so the model axis replicates (size 1 in every
caller), as in the reference.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

if TYPE_CHECKING:  # DTensor's modules load only where a mesh is used
    from torch.distributed.device_mesh import DeviceMesh

DATA, MODEL = "data", "model"


def make_mesh(num_devices: Optional[int] = None, model_parallel_size: int = 1,
              devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A (data, model) `DeviceMesh` of shape (n // model_parallel_size,
    model_parallel_size) over the first ``num_devices`` ranks of the world
    (or the given global ``devices`` ranks).  Every rank of the world calls
    it, members or not (sub-group creation needs every rank); a rank
    outside the mesh takes no further part.  The mesh's device type is the
    one `multihost.initialize` set up."""
    from torch.distributed.device_mesh import DeviceMesh

    from .multihost import world_device_type

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.multihost.initialize)")
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if num_devices is not None:
        ranks = ranks[:num_devices]
    n = len(ranks)
    if n == 0 or n % model_parallel_size:
        raise ValueError(f"{n} devices not divisible by model={model_parallel_size}")
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(n // model_parallel_size,
                                                          model_parallel_size)
    return DeviceMesh(world_device_type(), grid, mesh_dim_names=(DATA, MODEL))


def replicated(mesh: DeviceMesh):
    """DTensor placements of the reference's ``P()``."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in range(mesh.ndim))


def batch_sharded(mesh: DeviceMesh):
    """``P("data")``: dim 0 (the batch) over the data axis."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0),) + tuple(Replicate() for _ in range(mesh.ndim - 1))


def superbatch_sharded(mesh: DeviceMesh):
    """``P(None, "data")``: stacked-step batches (K, B, ...) with the batch
    axis (dim 1) over the data axis."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(1),) + tuple(Replicate() for _ in range(mesh.ndim - 1))


def host_shard_dataset(dataset, host_index: Optional[int] = None,
                       host_count: Optional[int] = None):
    """This process's part of a manifest (`split_data.sh` across hosts):
    ``dataset.split(host_count)[host_index]``, by default the rank's."""
    if host_index is None:
        host_index = dist.get_rank() if dist.is_initialized() else 0
    if host_count is None:
        host_count = dist.get_world_size() if dist.is_initialized() else 1
    return dataset.split(host_count)[host_index]


# ------------------------------------------------------------ mesh queries


def mesh_ranks(mesh: DeviceMesh) -> list:
    """The mesh's global ranks in row-major order; the first is its primary."""
    return mesh.mesh.flatten().tolist()


def require_member(mesh: DeviceMesh) -> None:
    """Raise ValueError on a rank outside ``mesh``."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is outside the mesh over ranks "
                         f"{mesh_ranks(mesh)}: only its ranks may use it")


def data_group(mesh: Optional[DeviceMesh], axis: str = DATA):
    """The mesh's ``axis`` process group (None without a mesh)."""
    if mesh is None:
        return None
    require_member(mesh)
    return mesh.get_group(axis)


def data_size(mesh: Optional[DeviceMesh]) -> int:
    return 1 if mesh is None else mesh[DATA].size()


def data_index(mesh: Optional[DeviceMesh]) -> int:
    if mesh is None:
        return 0
    require_member(mesh)
    return mesh.get_local_rank(DATA)


def mesh_groups(mesh: DeviceMesh) -> list:
    """Process groups whose collectives, taken in order, span every rank of
    ``mesh``: the model axis's (when it has more than one rank), then the
    data axis's.  A broadcast from each group's first rank in turn carries
    the mesh's first rank's values to all; a barrier on each in turn waits
    for all."""
    require_member(mesh)
    return [mesh.get_group(a) for a in (MODEL, DATA) if mesh[a].size() > 1]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_shard(x: torch.Tensor, mesh: DeviceMesh, dim: int = 0) -> torch.Tensor:
    """This rank's rows of a batch along ``dim``: the local tensor of a
    DTensor (`multihost.assemble_global_batch`), or the data-axis slice of
    a global tensor every rank holds.  A batch the data axis does not
    divide raises."""
    from .multihost import local_batch_slice

    if hasattr(x, "to_local"):
        return x.to_local()
    sl = local_batch_slice(x.shape[dim], mesh)
    return x.narrow(dim, sl.start, sl.stop - sl.start)


# ------------------------------------------------------------- collectives


class _AllReduceMean(torch.autograd.Function):
    """Mean over the group, forward and backward.  The backward averages
    the incoming gradients: with every rank backpropagating its own mean
    loss and the parameter gradients averaged after, this gives the
    gradient of the global mean loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable mean of ``x`` over ``group`` (see `_AllReduceMean`)."""
    return _AllReduceMean.apply(x, group)


def reduce_sum_(tensors: Iterable[torch.Tensor], group, mean: bool = False) -> None:
    """Sum (or with ``mean``, average) same-dtype tensors in place over
    ``group`` with one all-reduce of a flat buffer."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if mean:
        flat /= dist.get_world_size(group)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's equal-shaped block along dim 0, in rank
    order of ``group``."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return torch.cat(out)


def broadcast_state(tensors: Iterable[torch.Tensor], mesh: Optional[DeviceMesh] = None) -> None:
    """Overwrite ``tensors`` in place with the primary's values: the mesh's
    first rank's over the mesh's groups, or without a mesh world rank 0's
    over the world (every rank passes the same list, in the same order)."""
    tensors = list(tensors)
    groups = [None] if mesh is None else mesh_groups(mesh)
    with torch.no_grad():
        for g in groups:
            src = 0 if g is None else dist.get_global_rank(g, 0)
            for t in tensors:
                dist.broadcast(t, src, group=g)
