"""The data-parallel mesh (counterpart of stf_unet_tpu/core/mesh.py).

The JAX package shards the batch axis over a 1-D `Mesh(('data',))` and
lets GSPMD insert the collectives. The port stands in for the mesh in two
ways:

  * Training and evaluation run one process per device: a `DataGroup`
    (world size, this process's rank, its device). Each rank holds its
    rows of the global batch (`shard_batch`), the model starts from rank
    0's weights (`replicate`, which DistributedDataParallel also does),
    and the reductions that XLA inserted are explicit calls: DDP's
    gradient all-reduce, the synced BN statistics
    (models/blocks.convert_sync_batchnorm), the metric sums
    (train/loop.evaluate), the agreed stop (train/preempt.py). Outside a
    process group each helper is the one-process identity.
  * Inference runs in one process over a device list
    (`inference_devices`): one replica of the model per device
    (`replicate_module`), the padded batch split into equal shards
    (`split_rows`), each shard's forward on its replica under
    `device_scope`, every device's work enqueued before any result is
    read. Nothing is reduced across devices, so no process group is
    needed (serve/engine.py, serve/tiled.py, pk/fit.py).
"""

from __future__ import annotations

import contextlib
import copy
import datetime
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from stf_unet_tpu_torch.core.config import resolve_device

DATA_AXIS = "data"
# The second axis of a 2-D group (parallel/spatial.py): image rows.
SPACE_AXIS = "space"


@dataclass(frozen=True)
class DataGroup:
    """This process's place in the data-parallel group: `world` ranks,
    this one `rank`, computing on `device`. `host_group` carries the
    host-side flags, objects and barriers: a gloo group beside an NCCL
    one (so agreeing on a stop never waits for the device), None where
    the default group is gloo already.

    A 2-D (data x space) group (`create_2d_mesh`) has n_space > 1: rank
    r is data index r // n_space, space index r % n_space; `space_group`
    is the process group of this rank's data index (the ranks that hold
    row shards of the same images: halos, row sums) and `data_group` the
    one of its space index. The world still spans every rank: DDP, the
    synced BN and the loss normalizer reduce over all of them."""

    world: int
    rank: int
    device: torch.device
    host_group: Any = None
    n_space: int = 1
    space_group: Any = None
    data_group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def n_data(self) -> int:
        return self.world // self.n_space

    @property
    def data_index(self) -> int:
        """The batch shard this rank holds (its loader and draw shard)."""
        return self.rank // self.n_space

    @property
    def space_index(self) -> int:
        """The row shard this rank holds of its data shard's images."""
        return self.rank % self.n_space


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


def mesh_2d_shape(n_space: int, data_parallel: int = 0,
                  device="cuda") -> Tuple[int, int]:
    """(n_data, n_space) of `--spatial-parallel n_space [--data-parallel
    data_parallel]`, the JAX trainer's rule: n_data = data_parallel when
    > 1, else every visible GPU over n_space (at least 1; one on the
    CPU, where gloo ranks share the host). On CUDA the mesh must fit the
    visible GPUs (create_2d_mesh's error), never shrinking quietly."""
    dev = torch.device(device)
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    n_data = (data_parallel if data_parallel > 1
              else max(count // n_space, 1))
    need = n_data * n_space
    if dev.type == "cuda" and need > count:
        raise ValueError(f"mesh {n_data}x{n_space} needs {need} devices, "
                         f"have {count}")
    return n_data, n_space


def create_2d_mesh(n_data: int, n_space: int, device="cuda") -> DataGroup:
    """This process's place in a (data x space) group of the process
    group it joined, whose world must be n_data * n_space: rank r is
    (data r // n_space, space r % n_space). Every rank creates every
    subgroup, in the same order (torch.distributed.new_group's rule).
    Outside a process group only the 1 x 1 mesh exists."""
    need = n_data * n_space
    if not dist.is_initialized():
        if need > 1:
            raise ValueError(
                f"mesh {n_data}x{n_space} needs {need} processes: join a "
                "process group first (core/distributed.initialize, or "
                "cli/train --spatial-parallel)")
        return DataGroup(1, 0, torch.device(device))
    base = create_mesh(0, device)
    if base.world != need:
        raise ValueError(f"mesh {n_data}x{n_space} needs {need} devices, "
                         f"have {base.world} processes")
    space = [dist.new_group(list(range(d * n_space, (d + 1) * n_space)))
             for d in range(n_data)]
    data = [dist.new_group(list(range(s, need, n_space)))
            for s in range(n_space)]
    return DataGroup(base.world, base.rank, base.device, base.host_group,
                     n_space, space[base.rank // n_space],
                     data[base.rank % n_space])


def inference_devices(n_data: int = 0, device="cuda") -> List[torch.device]:
    """The devices of `--data-parallel n_data` for one inference process:
    the first n_data visible GPUs, all of them for 0; more than are
    visible raises, never shrinking the list quietly. On an explicit CPU
    device, n_data CPU entries (one for 0): replicas that share the host,
    the counterpart of the JAX tests' simulated devices."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * max(n_data, 1)
    count = torch.cuda.device_count()
    n = count if n_data <= 0 else n_data
    if n > count:
        raise ValueError(f"--data-parallel {n_data} asks for {n} GPUs but "
                         f"{count} are visible")
    return [torch.device("cuda", i) for i in range(n)]


def replicate_module(model: torch.nn.Module,
                     devices: Sequence[torch.device]
                     ) -> List[torch.nn.Module]:
    """One eval-mode replica of `model` per device: `model` itself on
    devices[0] (moved there in place if it is elsewhere), a deep copy on
    each other device. Wrappers come along whole (ops/tta.FlipTTAModel,
    ops/quant.QuantizedModel, whose conv table is rebuilt over the
    copy's own convs)."""
    model.to(devices[0])
    return [model] + [copy.deepcopy(model).to(dev).eval()
                      for dev in devices[1:]]


def split_rows(x, n: int) -> list:
    """x's rows in n equal consecutive shards (numpy or tensor)."""
    b, rem = divmod(x.shape[0], n)
    if rem:
        raise ValueError(f"batch {x.shape[0]} does not divide over {n} "
                         f"devices")
    return [x[i * b:(i + 1) * b] for i in range(n)]


def device_scope(dev: torch.device):
    """`torch.cuda.device(dev)` on a GPU; nothing on the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


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
    """This rank's rows [d * b, (d + 1) * b) of every array (numpy or
    tensor) in a global batch whose leading size B = n_data * b, d its
    data index (its rank in a 1-D group)."""
    def rows(x):
        b, rem = divmod(x.shape[0], group.n_data)
        if rem:
            raise ValueError(f"global batch {x.shape[0]} does not divide "
                             f"over {group.n_data} ranks")
        return x[group.data_index * b:(group.data_index + 1) * b]

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
