"""The mesh over torch.distributed: data parallelism and the spatial axis
(port of rvdd_tpu/parallel)."""

from rvdd_tpu_torch.parallel.mesh import (
    Mesh,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
)
