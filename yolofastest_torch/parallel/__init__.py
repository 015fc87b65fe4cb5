from yolofastest_torch.parallel.distributed import (
    global_batch_size,
    host_to_global,
    init_distributed,
)
from yolofastest_torch.parallel.halo import EXCHANGES, RowShard, gather_rows, halo_rows, row_window
from yolofastest_torch.parallel.mesh import (
    Mesh,
    Sharding,
    batch_sharding,
    check_image_rows,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = [
    "EXCHANGES",
    "Mesh",
    "RowShard",
    "Sharding",
    "batch_sharding",
    "check_image_rows",
    "gather_rows",
    "global_batch_size",
    "halo_rows",
    "host_to_global",
    "init_distributed",
    "make_mesh",
    "replicate",
    "row_window",
    "shard_batch",
]
