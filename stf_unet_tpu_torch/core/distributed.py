"""Process-group bootstrap (counterpart of stf_unet_tpu/core/distributed.py).

Data parallelism in the port is one process per device, joined by a
`torch.distributed` process group: NCCL between CUDA devices, gloo on the
CPU. `cli/train --multihost` joins the group that torchrun (or any
launcher) describes in the environment (MASTER_ADDR, MASTER_PORT, RANK,
WORLD_SIZE, LOCAL_RANK); `--data-parallel N` spawns N local processes
that join one on a free localhost port. The group then carries the
gradient all-reduce (DistributedDataParallel), the synced BatchNorm
statistics (models/blocks.py), the metric sums of a sharded evaluation
(train/loop.evaluate) and the stop every rank agrees on
(train/preempt.py); each rank loads its own shard of the dataset
(data/loader.HostLoader host_index / num_hosts).
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import tempfile
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

# A rank that dies mid-collective fails its peers after this long instead
# of torch's default of 30 minutes.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


def _device(device) -> torch.device:
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        return (torch.device("cuda", local) if torch.cuda.is_available()
                else torch.device("cpu"))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device=None, backend: Optional[str] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Join the process group (the user asked for several processes, so a
    failure RAISES rather than degrading to independent processes).

    Unset arguments come from torchrun's environment: the coordinator
    from MASTER_ADDR:MASTER_PORT, the world from WORLD_SIZE, this
    process's rank from RANK. `device` (default cuda:LOCAL_RANK when a GPU
    is visible, else the CPU) picks the backend: NCCL on CUDA, gloo on the
    CPU; `backend` overrides it for library callers (gloo also carries
    CUDA tensors). Returns True when more than one process takes part."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        if not addr:
            raise RuntimeError(
                "no coordinator: pass coordinator_address or set "
                "MASTER_ADDR / MASTER_PORT (torchrun does)")
        port = os.environ.get("MASTER_PORT", "29500")
        coordinator_address = f"{addr}:{port}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    dev = _device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id), timeout=timeout)
    return dist.get_world_size() > 1


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, **kwargs) -> bool:
    """Best-effort variant for tooling (NOT --multihost): tries only when
    a coordinator is given or MASTER_ADDR is set, and degrades to one
    process on failure."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if not (coordinator_address or os.environ.get("MASTER_ADDR")):
        return False
    try:
        return initialize(coordinator_address, num_processes, process_id,
                          **kwargs)
    except Exception as e:  # noqa: BLE001 - reported, then one process
        print(f"torch.distributed initialization skipped: {e}")
        return False


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_main_process() -> bool:
    return host_info()[0] == 0


def host_info() -> Tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group. Feed it into
    HostLoader for per-rank dataset sharding."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def free_port() -> int:
    """A free localhost TCP port for a spawned group's coordinator."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_group(fn: Callable, world: int, device, *args):
    """Run fn(*args, group=<this rank's core/mesh.DataGroup>) in `world`
    spawned local processes joined by a process group on a free
    localhost port, rank r on cuda:r (or the CPU, gloo); returns rank 0's
    result. A rank that raises takes the others down (SIGTERM, then
    SIGKILL) and the error is raised here. `fn` must be importable (a
    module-level function) for the spawn start method."""
    import torch.multiprocessing as mp

    port = free_port()
    print(f"data parallelism: spawning {world} processes "
          f"(coordinator localhost:{port})", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.pkl")
        mp.start_processes(_spawned_rank,
                           args=(fn, world, port, str(torch.device(device)),
                                 out, args),
                           nprocs=world, start_method="spawn")
        with open(out, "rb") as f:
            return pickle.load(f)


def _spawned_rank(rank: int, fn: Callable, world: int, port: int,
                  device: str, out: str, args) -> None:
    """One spawned rank: its device (cuda:rank, or the CPU with one
    thread, as the ranks share the host), the group, fn; rank 0 pickles
    fn's result to `out`. The group is left on the way out, error or
    not."""
    from stf_unet_tpu_torch.core import mesh as mesh_lib

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
    initialize(f"localhost:{port}", world, rank, device=dev)
    try:
        result = fn(*args, group=mesh_lib.create_mesh(world, dev))
    finally:
        shutdown()
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(result, f)
