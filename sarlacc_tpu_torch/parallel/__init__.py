"""Device-mesh parallelism: the counterpart of ``sarlacc_tpu/parallel``.

``mesh`` holds the mesh and the data-parallel score steps, ``context`` the
active-mesh context the API layer uses to split batches over shards,
``shuffle`` the co-location of UMI pre-groups on shards and
``distributed`` the multi-process bootstrap on ``torch.distributed``.
Importing the package initialises no process group and touches no card.
"""

from .context import active_mesh, mesh_size, pad_to_mesh, shard_batch, use_mesh
from .distributed import (
    common_local_rows,
    global_mesh,
    host_local_batch_to_global,
    host_shard,
    init_distributed,
    is_distributed,
)
from .mesh import (
    make_mesh,
    shard_reads,
    sharded_adaptor_scores,
    sharded_pipeline_step,
)

__all__ = [
    "active_mesh",
    "mesh_size",
    "pad_to_mesh",
    "shard_batch",
    "use_mesh",
    "make_mesh",
    "shard_reads",
    "sharded_adaptor_scores",
    "sharded_pipeline_step",
    "init_distributed",
    "is_distributed",
    "host_shard",
    "global_mesh",
    "host_local_batch_to_global",
    "common_local_rows",
]
