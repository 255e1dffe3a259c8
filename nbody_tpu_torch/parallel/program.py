"""A sharded step as a fixed sequence of stages split at the collectives.

PyTorch counterpart of the ``jax.jit`` around the JAX package's sharded
step and its n-step scan (``nbody_tpu/parallel/step.py``), where one SPMD
program holds every collective. Here ``parallel/mesh.py``'s collectives
are the only code that moves data between positions or processes, so a
sharded force or step is written as a tuple of ops:

  * a ``Stage`` is per-position work, ``fn(i, q, carry) -> {name: tensor}``
    on this process's i-th position (global index q), reading that
    position's carry of named tensors and returning the new values of
    some of them;
  * a ``Collective`` runs between two stages, ``fn(carries, mesh) ->
    [{name: tensor}]``: it reads every local position's carry and returns
    each position's new values, through the collectives of ``mesh.py``.

The sequence depends only on the config and the mesh, never on the data,
so every process of a mesh runs the same collectives in the same order,
as ``mesh.py`` requires.

``ShardedGraphs`` runs such a program. Each distinct device of this
process holds one ``ops.step_graph.SegmentGraphs``, whose buffers are the
carries of the positions on that device (named ``"<i>/<name>"``); a stage
is one segment there, running the stage for each of those positions.
Graphed (on the card), a segment is captured after its first eager use
and replayed after that, and the collectives run between replays: they
read the carry buffers and their results are loaded into the buffers the
next segment reads, so no collective (a host-staged gloo transfer, an
NCCL call, a cross-device copy) is ever inside a capture. A failed
capture raises (``SegmentGraphs``); nothing steps eagerly in its place.
With ``graphed=False`` the same stages and collectives run eagerly on the
current values: the CPU path, and the reference the graphs are held to.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from nbody_tpu_torch.ops.step_graph import SegmentGraphs
from nbody_tpu_torch.parallel.mesh import ShardedState
from nbody_tpu_torch.state import ParticleState

STATE_FIELDS = ("pos", "vel", "acc", "mass", "time")


@dataclasses.dataclass(frozen=True)
class Stage:
    """Per-position work: ``fn(i, q, carry) -> {name: tensor}``."""

    name: str
    fn: Callable


@dataclasses.dataclass(frozen=True)
class Collective:
    """Work across positions: ``fn(carries, mesh) -> [{name: tensor}]``,
    one dict per local position."""

    name: str
    fn: Callable


class Carry:
    """Position i's values in ``values`` (keys ``"<i>/<name>"``), read by
    name, with the tensors of ``over`` laid on top."""

    def __init__(self, values: dict, i: int, over: dict | None = None):
        self._values, self._i, self._over = values, i, over or {}

    def __getitem__(self, name: str) -> torch.Tensor:
        if name in self._over:
            return self._over[name]
        return self._values[f"{self._i}/{name}"]

    def over(self, values: dict) -> "Carry":
        """This carry with ``values`` laid on top."""
        return Carry(self._values, self._i, {**self._over, **values})


def fuse_first(stage: Stage, pre: Callable) -> Stage:
    """``pre(i, q, carry) -> values`` and ``stage`` as one stage, ``stage``
    reading ``pre``'s values."""

    def fn(i, q, c):
        new = pre(i, q, c)
        return {**new, **stage.fn(i, q, c.over(new))}

    return Stage(f"drift, {stage.name}", fn)


def fuse_last(stage: Stage, post: Callable) -> Stage:
    """``stage`` and ``post(i, q, carry) -> values`` as one stage, ``post``
    reading ``stage``'s outputs; it returns ``post``'s values only."""

    def fn(i, q, c):
        return post(i, q, c.over(stage.fn(i, q, c)))

    return Stage(f"{stage.name}, kick", fn)


def device_key(dev) -> torch.device:
    """``dev`` with its index filled in (the current card for a bare
    "cuda"), so that one card has one key."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class ShardedGraphs:
    """The program ``ops`` on the positions of ``mesh`` held by this
    process (module docstring): ``load(i, **values)`` sets position i's
    carry, ``run()`` applies every op once, ``get(i, name)`` hands out a
    copy, ``__call__(state, n)`` is ``n`` runs on a ``ShardedState``
    (``pos``, ``vel``, ``acc``, ``mass``, ``time`` in and out).

    ``sets`` maps each distinct device to its ``SegmentGraphs``;
    ``segments`` and ``collectives`` count the program's stages and
    collectives (a run's segments and collectives); ``captures``,
    ``replays``, ``capture_ms`` and ``pool_bytes`` sum the sets'."""

    def __init__(self, ops: Sequence, mesh, graphed: bool = True):
        names = [op.name for op in ops]
        if len(set(names)) != len(names):
            raise ValueError(f"op names must be unique: {names}")
        self.ops, self.mesh = tuple(ops), mesh
        self.sets: dict = {}
        self._on = []      # each local position's device key
        self._mine = {}    # device key -> its positions (i, global q)
        for (i, q), dev in zip(enumerate(mesh.local), mesh.devices):
            key = device_key(dev)
            self.sets.setdefault(key, SegmentGraphs(graphed))
            self._on.append(key)
            self._mine.setdefault(key, []).append((i, q))

    # ---- the carries ----------------------------------------------------

    def load(self, i: int, **values) -> None:
        """Set position i's values, each on that position's device."""
        key = self._on[i]
        for name, t in values.items():
            if device_key(t.device) != key:
                raise ValueError(f"position {i}'s {name} on {t.device}, its "
                                 f"segments on {key}")
        self.sets[key].load(**{f"{i}/{k}": v for k, v in values.items()})

    def carry(self, i: int) -> Carry:
        return Carry(self.sets[self._on[i]].buffers, i)

    def get(self, i: int, name: str) -> torch.Tensor:
        return self.sets[self._on[i]].get(f"{i}/{name}")

    # ---- running --------------------------------------------------------

    def run(self) -> None:
        """One pass of the program: each stage as a segment of every set,
        each collective between them."""
        for op in self.ops:
            self.apply(op)

    def apply(self, op) -> None:
        """One op of the program: a stage as a segment of every set, a
        collective across them."""
        if isinstance(op, Stage):
            self._stage(op)
        else:
            self._collective(op)

    def _stage(self, op: Stage) -> None:
        for key, g in self.sets.items():
            def fn(bufs, mine=self._mine[key]):
                out = {}
                for i, q in mine:
                    res = op.fn(i, q, Carry(bufs, i))
                    out.update({f"{i}/{k}": v for k, v in res.items()})
                return out

            if key.type == "cuda":
                with torch.cuda.device(key):
                    g.run(op.name, fn)
            else:
                g.run(op.name, fn)

    def _collective(self, op: Collective) -> None:
        outs = op.fn([self.carry(i) for i in range(len(self._on))],
                     self.mesh)
        for i, out in enumerate(outs):
            self.load(i, **out)

    def __call__(self, state, n_steps: int):
        """``n_steps`` runs of a step program on the ``ShardedState``
        ``state`` (the input is never written); returns a new one."""
        if state.mesh != self.mesh:
            raise ValueError("the state's mesh is not the program's")
        if n_steps <= 0:
            return state
        for i, s in enumerate(state.shards):
            self.load(i, **{f: getattr(s, f) for f in STATE_FIELDS})
        for _ in range(n_steps):
            self.run()
        return ShardedState([
            ParticleState(**{f: self.get(i, f) if f != "mass" else s.mass
                             for f in STATE_FIELDS})
            for i, s in enumerate(state.shards)
        ], self.mesh)

    # ---- readings -------------------------------------------------------

    @property
    def segments(self) -> int:
        return sum(isinstance(op, Stage) for op in self.ops)

    @property
    def collectives(self) -> int:
        return len(self.ops) - self.segments

    @property
    def captures(self) -> int:
        return sum(g.captures for g in self.sets.values())

    @property
    def replays(self) -> int:
        return sum(s.replays for g in self.sets.values()
                   for s in g.segments.values())

    @property
    def capture_ms(self) -> float:
        return sum(s.capture_ms for g in self.sets.values()
                   for s in g.segments.values())

    @property
    def pool_bytes(self) -> int:
        return sum(g.pool_bytes for g in self.sets.values())


def run_forces(ops: Sequence, pos, mass, mesh, outputs=("force",)):
    """The force program ``ops`` run eagerly on the sharded ``pos`` and
    ``mass``: each of ``outputs`` as a list of one tensor per local
    position (the last program's ``force`` is the accelerations)."""
    g = ShardedGraphs(ops, mesh, graphed=False)
    for i, (x, m) in enumerate(zip(pos, mass)):
        g.load(i, pos=x, mass=m)
    g.run()
    return [[g.get(i, name) for i in range(len(pos))] for name in outputs]
