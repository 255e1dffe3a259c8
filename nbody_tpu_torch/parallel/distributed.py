"""Multi-process initialization helpers.

PyTorch counterpart of ``nbody_tpu/parallel/distributed.py``, on
``torch.distributed``: NCCL on CUDA, gloo on the CPU. A ``Mesh``
(``parallel/mesh.py``) spans the devices of ONE process; a mesh across
processes (one rank per card, the counterpart of ``jax.distributed``
across hosts) is not built on this yet. Single-process use needs nothing.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize the default process group from the arguments or the
    standard environment (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). Returns True once a group is up, False for the
    single-process case (no address and no process count). Idempotent."""
    import torch.distributed as dist

    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if coordinator_address is None and num_processes is None:
        return False  # single process
    if dist.is_initialized():
        return True
    world = num_processes if num_processes is not None else int(
        env.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    dist.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=rank,
    )
    return True


def global_device_info() -> dict:
    """The JAX package's keys: this process's index and the count of
    processes, its CUDA cards, and the cards of all processes (each
    process is taken to hold as many as this one)."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    index = dist.get_rank() if up else 0
    count = dist.get_world_size() if up else 1
    local = torch.cuda.device_count()
    return {
        "process_index": index,
        "process_count": count,
        "local_devices": local,
        "global_devices": local * count,
    }
