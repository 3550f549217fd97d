"""Multi-process data parallelism on torch.distributed (port of
`sepi_tpu/parallel`): the (data, model) device mesh, the collectives of
the data-parallel steps, and the multi-process runtime."""

from .mesh import batch_sharded, host_shard_dataset, make_mesh, replicated, superbatch_sharded
from .multihost import (assemble_global_batch, initialize, is_primary, local_batch_slice,
                        shutdown)

__all__ = ["make_mesh", "replicated", "batch_sharded", "superbatch_sharded",
           "host_shard_dataset", "initialize", "is_primary", "local_batch_slice",
           "assemble_global_batch", "shutdown"]
