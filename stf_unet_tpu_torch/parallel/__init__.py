"""Data- and spatial-parallel helpers (counterpart of
stf_unet_tpu/parallel/__init__.py).

The data axis shards the batch (core/mesh.py); the space axis of a 2-D
group shards image rows, with the halo exchanges that GSPMD inserts in
the JAX package written by hand (parallel/spatial.py)."""

from stf_unet_tpu_torch.core.mesh import (
    DATA_AXIS,
    SPACE_AXIS,
    DataGroup,
    create_2d_mesh,
    create_mesh,
    pad_batch_to_multiple,
    replicate,
    shard_batch,
)
from stf_unet_tpu_torch.parallel.spatial import (
    gather_rows,
    halo_exchange,
    halo_rows,
    row_sharded,
    scatter_rows,
    space_sum,
    spatial_sharding,
)

__all__ = [
    "DATA_AXIS",
    "SPACE_AXIS",
    "DataGroup",
    "create_2d_mesh",
    "create_mesh",
    "gather_rows",
    "halo_exchange",
    "halo_rows",
    "pad_batch_to_multiple",
    "replicate",
    "row_sharded",
    "scatter_rows",
    "shard_batch",
    "space_sum",
    "spatial_sharding",
]
