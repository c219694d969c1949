"""The data-parallel group (counterpart of stf_unet_tpu/core/mesh.py).

The JAX package shards the batch axis over a 1-D `Mesh(('data',))` and
lets GSPMD insert the collectives. The port runs one process per device
instead, so a `DataGroup` (world size, this process's rank, its device)
stands in for the mesh: each rank holds its rows of the global batch
(`shard_batch`), the model starts from rank 0's weights (`replicate`,
which DistributedDataParallel also does), and the reductions that XLA
inserted are explicit calls: DDP's gradient all-reduce, the synced BN
statistics (models/blocks.convert_sync_batchnorm), the metric sums
(train/loop.evaluate), the agreed stop (train/preempt.py). The helpers
below are those host-side calls; outside a process group each is the
one-process identity.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, List, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"


@dataclass(frozen=True)
class DataGroup:
    """This process's place in the data-parallel group: `world` ranks,
    this one `rank`, computing on `device`. `host_group` carries the
    host-side flags, objects and barriers: a gloo group beside an NCCL
    one (so agreeing on a stop never waits for the device), None where
    the default group is gloo already."""

    world: int
    rank: int
    device: torch.device
    host_group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def data_world(n_data: int = 0, device="cuda") -> int:
    """The world size `--data-parallel n_data` asks for: n_data, or every
    visible GPU for 0 (one on the CPU, where any number of gloo ranks may
    share the host). Raises when more shards than devices are requested,
    never shrinking the world quietly."""
    if torch.device(device).type != "cuda":
        return max(n_data, 1)
    count = torch.cuda.device_count()
    if n_data <= 0:
        return max(count, 1)
    if n_data > count:
        raise ValueError(f"requested {n_data} data shards but only {count} "
                         f"devices")
    return n_data


def create_mesh(n_data: int = 0, device="cuda") -> DataGroup:
    """This process's DataGroup. Inside a process group it spans every
    rank (a prefix subset would leave ranks out of the collectives), so
    n_data must be 0 or the world size; outside one only a world of one
    exists. On CUDA each rank computes on cuda:<LOCAL_RANK>, the device
    initialize() set."""
    dev = torch.device(device)
    if not dist.is_initialized():
        n = data_world(n_data, dev)
        if n > 1:
            raise ValueError(
                f"a data group of {n} needs {n} processes: join a process "
                "group first (core/distributed.initialize, or cli/train "
                "--data-parallel / --multihost)")
        return DataGroup(1, 0, dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data > 0 and n_data != world:
        raise ValueError(
            f"multi-process data groups must span all {world} processes "
            f"(got data_parallel={n_data}); use data_parallel=0")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    host = None
    if dist.get_backend() != "gloo":
        host = dist.new_group(backend="gloo")
    return DataGroup(world, rank, dev, host)


def pad_batch_to_multiple(batch_size: int, n_shards: int) -> int:
    """The global batch must divide evenly across shards; round up."""
    return ((batch_size + n_shards - 1) // n_shards) * n_shards


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(group: DataGroup, tree):
    """This rank's rows [rank * b, (rank + 1) * b) of every array (numpy or
    tensor) in a global batch whose leading size B = world * b."""
    def rows(x):
        b, rem = divmod(x.shape[0], group.world)
        if rem:
            raise ValueError(f"global batch {x.shape[0]} does not divide "
                             f"over {group.world} ranks")
        return x[group.rank * b:(group.rank + 1) * b]

    return _map(rows, tree)


def replicate(group: DataGroup, tree):
    """Rank 0's value of every tensor (in place), module (parameters and
    buffers) or other picklable leaf of `tree` on every rank."""
    if not dist.is_initialized():
        return tree

    def bcast(x):
        if isinstance(x, torch.nn.Module):
            with torch.no_grad():
                for t in list(x.parameters()) + list(x.buffers()):
                    dist.broadcast(t.data, src=0)
            return x
        if isinstance(x, torch.Tensor):
            dist.broadcast(x, src=0)
            return x
        box = [x]
        dist.broadcast_object_list(box, src=0, group=group.host_group)
        return box[0]

    return _map(bcast, tree)


def all_sum(group: Optional[DataGroup], t: torch.Tensor) -> torch.Tensor:
    """t summed over the ranks (in place; on the device's backend)."""
    if group is not None and dist.is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def agree_max(group: Optional[DataGroup], value: int) -> int:
    """The largest of the ranks' host integers (a stop flag, a count),
    over `group`'s host-side group (the default group for None)."""
    if not dist.is_initialized():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX,
                    group=group.host_group if group is not None else None)
    return int(t.item())


def agree_min(group: Optional[DataGroup], value: int) -> int:
    return -agree_max(group, -int(value))


def gather_objects(group: Optional[DataGroup], obj) -> List[Any]:
    """Every rank's picklable `obj`, in rank order, on every rank."""
    if group is None or not dist.is_initialized():
        return [obj]
    out: List[Any] = [None] * group.world
    dist.all_gather_object(out, obj, group=group.host_group)
    return out


def gather_to_main(group: Optional[DataGroup], obj) -> Optional[List[Any]]:
    """Every rank's picklable `obj`, in rank order, on rank 0 alone (None
    on the others): one copy of the whole, where gather_objects holds
    one on every rank."""
    if group is None or not dist.is_initialized():
        return [obj]
    out: Optional[List[Any]] = [None] * group.world if group.is_main \
        else None
    dist.gather_object(obj, out, dst=0, group=group.host_group)
    return out


def barrier(group: Optional[DataGroup],
            timeout: Optional[datetime.timedelta] = None) -> None:
    """Wait for every rank. With `timeout`, a gloo monitored barrier that
    waits that long instead of the group's own timeout (for a peer doing
    long work alone, such as rank 0 fitting the PK maps)."""
    if group is None or not dist.is_initialized():
        return
    if timeout is None:
        dist.barrier(group=group.host_group)
    else:
        dist.monitored_barrier(group=group.host_group, timeout=timeout)
