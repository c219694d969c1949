"""Data-parallel helpers (counterpart of stf_unet_tpu/parallel/__init__.py).

The JAX package also exports its spatial axis (`parallel/spatial.py`:
image rows sharded over a second mesh axis, the conv halo exchanges
inserted by GSPMD). In PyTorch those exchanges must be written by hand;
until then `--spatial-parallel` is refused (ROADMAP.md §1, 'spatial
parallelism')."""

from stf_unet_tpu_torch.core.mesh import (
    DATA_AXIS,
    DataGroup,
    create_mesh,
    pad_batch_to_multiple,
    replicate,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "DataGroup",
    "create_mesh",
    "pad_batch_to_multiple",
    "replicate",
    "shard_batch",
]
