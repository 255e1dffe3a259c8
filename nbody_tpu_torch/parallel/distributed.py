"""Multi-process initialization helpers.

PyTorch counterpart of ``nbody_tpu/parallel/distributed.py``, on
``torch.distributed``: one rank per CUDA card, NCCL between cards, gloo
on the CPU or where the caller asks for it (NCCL refuses two ranks of one
communicator on one card). Once ``initialize_distributed`` has run in
every process, ``parallel.mesh.make_mesh`` spans the processes, as the
JAX package's mesh spans hosts after ``jax.distributed.initialize``.
Single-process use needs nothing.

Launch one process per card with ``torchrun --nproc-per-node N``, each
calling ``initialize_distributed()`` (it reads torchrun's environment);
``run_ranks`` is a smaller launcher of local ranks with a deadline, for
tests and the smoke run.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import time
from typing import Optional, Sequence

import torch

DEFAULT_TIMEOUT_S = 600.0


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    timeout: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Initialize the default process group from the arguments or the
    standard environment (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``). Returns True once a group is up, False for
    the single-process case (no address and no process count).
    Idempotent.

    ``backend`` defaults to NCCL when CUDA is available, else gloo; a
    failed NCCL initialization raises (there is no fallback to gloo).
    ``timeout`` (seconds) bounds the rendezvous and every collective. On
    CUDA this rank's card becomes the current device: ``LOCAL_RANK``, else
    the process id, modulo the visible cards (gloo may put several ranks
    on one card)."""
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
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        card = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(card % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout),
    )
    return True


def process_world() -> tuple:
    """(rank, world size) of the default group; (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    """Wait for every process of the default group (nothing without
    one)."""
    import torch.distributed as dist

    if process_world()[1] > 1:
        dist.barrier()


def local_cards() -> list:
    """The CUDA cards this process drives: in a group of several
    processes, its own card (one rank per card, the current device that
    ``initialize_distributed`` set); alone, every visible card."""
    if not torch.cuda.is_available():
        return []
    if process_world()[1] > 1:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def global_device_info() -> dict:
    """The JAX package's keys: this process's index and the count of
    processes, its CUDA cards (``local_cards``), and the cards of all
    processes, each process's own count all-gathered and summed (a
    collective when a group is up). Ranks that share a card (gloo, as on
    one card) count it once each: ``global_devices`` is the positions a
    mesh of one per card can take, not the machine's distinct cards."""
    from nbody_tpu_torch.parallel.mesh import all_gather_ints

    rank, world = process_world()
    local = len(local_cards())
    return {
        "process_index": rank,
        "process_count": world,
        "local_devices": local,
        "global_devices": sum(all_gather_ints(local)),
    }


def _free_port() -> int:
    """A free TCP port on the loopback interface (bound once to port 0,
    then released for the caller to pass on)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv: Sequence[str], world: int, *, timeout: float,
              env: Optional[dict] = None) -> None:
    """Run ``world`` processes of ``argv`` on this host with torchrun's
    environment (``MASTER_ADDR`` 127.0.0.1 and a free ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) added
    to ``env`` (default: this process's), and wait for them. When a rank
    exits with a non-zero code, or ``timeout`` seconds pass, every rank
    still running is killed and ``RuntimeError`` names the ranks at
    fault."""
    base = dict(os.environ if env is None else env)
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    procs = []
    deadline = time.monotonic() + timeout
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                list(argv), env={**base, "RANK": str(r),
                                 "LOCAL_RANK": str(r)}))
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes)
                   if c is not None and c != 0]
            if bad:
                raise RuntimeError(
                    "rank failed: " + ", ".join(f"rank {r} exit code {c}"
                                                for r, c in bad))
            if all(c == 0 for c in codes):
                return
            if time.monotonic() > deadline:
                late = [r for r, c in enumerate(codes) if c is None]
                raise RuntimeError(
                    f"ranks {late} still running after {timeout:g} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
