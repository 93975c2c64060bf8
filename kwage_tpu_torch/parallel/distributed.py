"""Multi-process wiring: torch.distributed init + search meshes that span
processes (PyTorch port of kwage_tpu/parallel/distributed.py).

The reference scales with MPI ranks (maestro master/worker, SriRachA SPMD;
SURVEY.md section 5.8). The port's counterparts:

- device-side: one global mesh over every device of every process; the
  signature matrix shards along "filters", query batches along "data".
  The search kernels need NO collective on the hot path (outputs stay
  sharded on both axes); ``sharded_search.to_host`` all-gathers the shards
  a process does not hold (gloo for CPU tensors, NCCL for CUDA tensors),
  so every process returns the global result. "filters" is innermost, so
  a process's devices hold adjacent filter shards.
- host-side: the maestro work queue stays per-process (accessions are
  embarrassingly parallel); run one maestro per host over a disjoint
  inventory shard (``shard_inventory``).

All functions degrade gracefully to single-process use. NCCL refuses two
ranks on one card, so on a one-card machine the multi-process route runs
on gloo and CPU tensors only.
"""

from __future__ import annotations

import os

import torch

from .maestro import shard_inventory  # noqa: F401  (re-exported: one definition)
from .mesh import SearchMesh, default_devices


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize torch.distributed from args or the environment
    (KWAGE_COORDINATOR_ADDRESS / KWAGE_NUM_PROCESSES / KWAGE_PROCESS_ID).
    The backend is NCCL when the device paths run on CUDA, gloo when
    KWAGE_TORCH_DEVICE names the CPU. Returns True when a multi-process
    runtime was started, False for single-process runs."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("KWAGE_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("KWAGE_NUM_PROCESSES"):
        num_processes = int(os.environ["KWAGE_NUM_PROCESSES"])
    if process_id is None and os.environ.get("KWAGE_PROCESS_ID"):
        process_id = int(os.environ["KWAGE_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator's address, the number "
                         "of processes and this process's id")
    on_cuda = torch.device(os.environ.get("KWAGE_TORCH_DEVICE", "cuda")).type == "cuda"
    dist.init_process_group(
        backend="nccl" if on_cuda else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )
    return True


def make_global_search_mesh(num_data: int | None = None, local_devices=None) -> SearchMesh:
    """A ("data", "filters") mesh over every device of every process of the
    (possibly multi-process) runtime. ``local_devices`` (default:
    ``default_devices()``; list a device several times for logical shards)
    are this process's; every process must bring equally many. "filters"
    is laid out innermost, process by process, so each process's devices
    hold adjacent filter shards."""
    import torch.distributed as dist

    local = (default_devices() if local_devices is None
             else [torch.device(d) for d in local_devices])
    world, rank = 1, 0
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    n = len(local) * world
    if num_data is None:
        num_data = world if n % world == 0 else 1
    if n % num_data:
        raise ValueError(f"{n} devices not divisible into {num_data} data shards")
    # Slot i of the row-major grid belongs to process i // len(local). A
    # slot of another process carries the device its owner would name at
    # the same place: only the owner uses it.
    n_shards = n // num_data
    flat_devices = [local[i % len(local)] for i in range(n)]
    flat_owners = [i // len(local) for i in range(n)]
    return SearchMesh(
        [flat_devices[d * n_shards:(d + 1) * n_shards] for d in range(num_data)],
        [flat_owners[d * n_shards:(d + 1) * n_shards] for d in range(num_data)],
        rank,
    )
