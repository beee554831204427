"""Distribution layer over `torch.distributed`: device meshes, shardings,
collectives (counterpart of `spateo_tpu.parallel`)."""

from .distributed import (
    global_mesh,
    initialize_distributed,
    is_distributed,
    make_global_array,
    process_allgather,
)
from .mesh import (
    create_mesh,
    device_count,
    local_device_count,
    mesh_axis_size,
    pad_rows,
    pad_to_multiple,
    pairwise_sharding,
    replicated,
    row_sharding,
    shard_rows,
)
