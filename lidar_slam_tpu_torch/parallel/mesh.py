"""The rank mesh (port of lidar_slam_tpu/parallel/mesh.py).

The JAX package runs one program over a `jax.sharding.Mesh` of devices.
The port runs SPMD over ranks of `torch.distributed`, one process each:
a `Mesh` is this rank's view of the process group (its rank, the world
size, the backend and its explicit device). Under NCCL rank r runs on
`cuda:r`; under gloo the caller names the device (the CPU, or two ranks
sharing one card). `launch.launch` starts the ranks.

A process with no process group may still make a one-rank `Mesh`: its
collectives return their input, so a sharded function runs there as its
unsharded form.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from .. import device as _default_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh: the data axis every sharded function
    of this package splits (points, keyframes, edges, voxel slabs, node
    blocks) runs over the ranks of the default process group in rank
    order."""

    rank: int
    size: int
    device: torch.device
    backend: str  # "nccl", "gloo", or "none" (one rank, no process group)

    @property
    def distributed(self) -> bool:
        return self.backend != "none"


def distributed_init_from_env(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join a process group across hosts from arguments or the environment:

      SLAM_COORDINATOR_ADDRESS  host:port of rank 0
      SLAM_NUM_PROCESSES        world size
      SLAM_PROCESS_ID           this process's rank

    Each process calls this before any collective; `make_mesh()` then spans
    every rank (NCCL, one card a rank). Returns True once the group is
    initialized, False when no coordinator and no world size is configured
    (a single process: nothing to do)."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("SLAM_COORDINATOR_ADDRESS")
    env_np = os.environ.get("SLAM_NUM_PROCESSES")
    env_pid = os.environ.get("SLAM_PROCESS_ID")
    if num_processes is None and env_np is not None:
        num_processes = int(env_np)
    if process_id is None and env_pid is not None:
        process_id = int(env_pid)
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs a coordinator address, a world size and a rank")
    dist.init_process_group(
        "nccl", init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id
    )
    return True


def device_count() -> int:
    """CUDA cards on this host: the most ranks an NCCL mesh here can span."""
    return torch.cuda.device_count()


def process_count() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """This rank's mesh over the whole process group. `n_devices`, when
    given, must be the world size (the port shards over every rank).
    `device`: under NCCL it defaults to `cuda:rank`; under gloo it is the
    caller's (the port's default, the first card, when not given). Without
    a process group the mesh has one rank on `device`."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a {n_devices}-rank mesh needs a process group (launch.launch starts one)")
        return Mesh(rank=0, size=1, device=_default_device(device), backend="none")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices not in (None, size):
        raise ValueError(f"mesh of {n_devices} ranks asked in a world of {size}")
    backend = dist.get_backend()
    if device is None and backend == "nccl":
        dev = torch.device("cuda", rank)
    else:
        dev = _default_device(device)
    return Mesh(rank=rank, size=size, device=dev, backend=backend)
