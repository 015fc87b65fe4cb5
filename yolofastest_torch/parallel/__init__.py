from yolofastest_torch.parallel.distributed import (
    global_batch_size,
    host_to_global,
    init_distributed,
)
from yolofastest_torch.parallel.mesh import (
    Mesh,
    Sharding,
    batch_sharding,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = [
    "Mesh",
    "Sharding",
    "batch_sharding",
    "global_batch_size",
    "host_to_global",
    "init_distributed",
    "make_mesh",
    "replicate",
    "shard_batch",
]
