"""Sharding-preserving checkpoints of a simulation state.

PyTorch counterpart of ``nbody_tpu/utils/orbax_io.py``, which saves the
state pytree with orbax and restores it straight onto a device mesh: the
scale path for multi-card runs too big to funnel through one host, where
the ``.nbody`` file (``utils/serialization.py``) is the interchange
format. This module needs no orbax. ``directory/<step>/`` holds:

  manifest.json       format, version, step, rows N and positions P
  time.npy            the simulation time, a 0-d array
  <field>.<q>.npy     position q's N/P rows of pos, vel, acc (N/P, 3)
                      and mass (N/P,)

A ``ShardedState`` is saved by every process of its mesh, each writing its
own positions' rows; a ``ParticleState`` is one position, written by rank
0. The files go to ``directory/.tmp-<step>``, rank 0 writes the manifest
once every rank has written, and the step becomes visible by one
``os.replace`` of that finished directory, as orbax commits: a save cut
short leaves no step. Restoring reads plain ``.npy`` arrays (never a
pickle), memory-mapped, so each process reads only its positions' rows.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from nbody_tpu_torch.errors import SerializationError
from nbody_tpu_torch.parallel.distributed import barrier, process_world
from nbody_tpu_torch.parallel.mesh import ShardedState
from nbody_tpu_torch.state import ParticleState

FORMAT = "nbody_tpu_torch.checkpoint"
VERSION = 1
MANIFEST = "manifest.json"
FIELDS = ("pos", "vel", "acc", "mass")

State = Union[ParticleState, ShardedState]


def save_checkpoint(directory: str, state: State, step: int = 0) -> None:
    """Write ``state`` as ``directory/<step>/`` (module docstring). With a
    ``ShardedState`` on a mesh across processes every process calls it.
    Raises ``SerializationError`` when the step exists."""
    root = Path(os.path.abspath(directory))
    final, tmp = root / str(int(step)), root / f".tmp-{int(step)}"
    if final.exists():
        raise SerializationError(f"Checkpoint step {step} exists in "
                                 f"{directory}")
    if isinstance(state, ShardedState):
        mesh = state.mesh
        rank, positions = mesh.rank, mesh.size
        blocks = list(zip(mesh.local, state.shards))
    else:
        rank, positions = process_world()[0], 1
        blocks = [(0, state)] if rank == 0 else []
    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
    barrier()
    for q, shard in blocks:
        for f in FIELDS:
            np.save(tmp / f"{f}.{q}.npy",
                    getattr(shard, f).detach().cpu().numpy())
    barrier()
    if rank == 0:
        rows = blocks[0][1].n * positions
        np.save(tmp / "time.npy", state.time.detach().cpu().numpy())
        (tmp / MANIFEST).write_text(json.dumps(
            {"format": FORMAT, "version": VERSION, "step": int(step),
             "rows": rows, "positions": positions}))
        os.replace(tmp, final)
    barrier()


def latest_step(directory: str) -> Optional[int]:
    """The largest committed step under ``directory``, None without
    one."""
    root = Path(directory)
    if not root.is_dir():
        return None
    steps = [int(p.name) for p in root.iterdir()
             if p.name.isdigit() and (p / MANIFEST).is_file()]
    return max(steps, default=None)


def _manifest(path: Path) -> dict:
    try:
        m = json.loads((path / MANIFEST).read_text())
        rows, positions = int(m["rows"]), int(m["positions"])
        ok = (m["format"] == FORMAT and m["version"] == VERSION
              and positions > 0 and rows % positions == 0)
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise SerializationError(f"Unreadable checkpoint manifest in {path}:"
                                 f" {e}") from e
    if not ok:
        raise SerializationError(f"Unsupported checkpoint manifest in {path}:"
                                 f" {m}")
    return {"rows": rows, "positions": positions}


def _load(path: Path) -> np.ndarray:
    try:
        return np.load(path, mmap_mode="r", allow_pickle=False)
    except (OSError, ValueError) as e:
        raise SerializationError(f"Unreadable checkpoint array {path}: {e}"
                                 ) from e


def _rows(path: Path, field: str, block: int, start: int,
          stop: int) -> torch.Tensor:
    """Rows [start, stop) of ``field``, read from the position files that
    hold them."""
    parts = []
    for q in range(start // block, -(-stop // block)):
        arr = _load(path / f"{field}.{q}.npy")
        if arr.shape[0] != block:
            raise SerializationError(
                f"{path / f'{field}.{q}.npy'} holds {arr.shape[0]} rows, "
                f"not {block}")
        lo, hi = max(start - q * block, 0), min(stop - q * block, block)
        parts.append(np.array(arr[lo:hi]))
    return torch.from_numpy(np.concatenate(parts))


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       template: Optional[State] = None) -> State:
    """The checkpoint of ``step`` (default: the latest). With a sharded
    ``template`` (of the saved row count; its values are not read): a
    ``ShardedState`` on the template's mesh, which may have another
    number of positions than the writer's as long as it divides the rows,
    each process reading only its positions' rows; with a
    ``ParticleState`` template, the global rows on its device; without
    one, the global rows on the CPU. Raises ``SerializationError`` when
    the directory or step is missing or the checkpoint is unreadable."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise SerializationError(f"No checkpoints found in {directory}")
    path = Path(directory) / str(int(step))
    if not path.is_dir():
        raise SerializationError(f"No checkpoint step {step} in {directory}")
    m = _manifest(path)
    n, block = m["rows"], m["rows"] // m["positions"]
    time = torch.from_numpy(np.array(_load(path / "time.npy")))
    if template is not None and template.n != n:
        raise SerializationError(
            f"Checkpoint holds {n} rows; the template {template.n}")

    def state(start, stop, device):
        return ParticleState(
            **{f: _rows(path, f, block, start, stop).to(device)
               for f in FIELDS},
            time=time.to(device))

    if isinstance(template, ShardedState):
        mesh = template.mesh
        if n % mesh.size:
            raise SerializationError(
                f"{n} rows do not split over {mesh.size} positions")
        c = n // mesh.size
        return ShardedState([state(q * c, (q + 1) * c, dev)
                             for q, dev in zip(mesh.local, mesh.devices)],
                            mesh)
    return state(0, n, "cpu" if template is None else template.device)
