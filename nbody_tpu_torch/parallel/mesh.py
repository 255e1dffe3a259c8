"""The device mesh, state sharding and the collectives.

PyTorch counterpart of ``nbody_tpu/parallel/mesh.py``. The JAX package
shards in one process: a 1-D ``jax.sharding.Mesh`` over ``jax.devices()``
and ``shard_map`` running the body on each device. Here a ``Mesh`` is a
tuple of torch devices, one per mesh position, in one process; a
sharded tensor is a list holding one tensor per position, each on that
position's device. A device may repeat: its positions are virtual shards,
each holding its own slice of the state, as the JAX tests' 8 virtual CPU
devices do.

The collectives (``psum``, ``pmin``, ``pmax``, ``all_to_all``,
``ppermute``, ``all_gather``) take such a list and return one, each result
on its position's device. They move data with PyTorch's cross-device
``.to()``, which orders itself against both devices' current streams: a
peer copy between cards, a device-local copy on one card. No other module
of the package moves data between positions. Tensors held by a sharded
value are never written in place, so positions on one device may share a
reduction's result.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from nbody_tpu_torch.errors import ValidationError
from nbody_tpu_torch.state import ParticleState

PARTICLE_AXIS = "p"


def sharded_device_count(requested: Optional[int] = None) -> int:
    """The visible CUDA cards, or ``requested`` when that many exist
    (raises ``ValidationError`` naming both counts when not)."""
    avail = torch.cuda.device_count()
    if requested is None or requested <= 0:
        return avail
    if requested > avail:
        raise ValidationError(
            f"Requested {requested} devices but only {avail} available"
        )
    return requested


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the particle axis: ``devices[q]`` holds position
    q's shard."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``n_devices`` positions: the first of ``devices`` (an
    explicit sequence of torch devices; a repeated device holds virtual
    shards), or by default the visible CUDA cards."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if n_devices is not None and n_devices > 0:
            if n_devices > len(devs):
                raise ValidationError(
                    f"Requested {n_devices} devices but only {len(devs)} "
                    "available"
                )
            devs = devs[:n_devices]
    else:
        n = sharded_device_count(n_devices)
        devs = tuple(torch.device("cuda", i) for i in range(n))
    if not devs:
        raise ValidationError("Requested a mesh but no device is available")
    return Mesh(devs)


# ---- sharded tensors -------------------------------------------------------


def split(x: torch.Tensor, mesh: Mesh) -> list:
    """Rows of ``x`` in ``mesh.size`` equal blocks, block q copied to
    position q's device (N must divide evenly)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValidationError(
            f"Particle count {n} not divisible by {mesh.size} devices; "
            "pad with zero-mass particles"
        )
    b = n // mesh.size
    return [x[q * b:(q + 1) * b].to(dev, copy=True)
            for q, dev in enumerate(mesh.devices)]


def gather(xs: Sequence[torch.Tensor], n: Optional[int] = None,
           device=None) -> torch.Tensor:
    """The blocks joined in position order on ``device`` (position 0's by
    default), trimmed to the first ``n`` rows."""
    dev = xs[0].device if device is None else torch.device(device)
    out = torch.cat([x.to(dev) for x in xs], dim=0)
    return out if n is None else out[:n]


# ---- collectives -------------------------------------------------------------


def _reduce(xs, mesh: Mesh, op) -> list:
    """``op`` folded over the positions in position order, once per
    distinct device (so two calls are bit-equal), the result on every
    position's device."""
    done = {}
    out = []
    for dev in mesh.devices:
        if dev not in done:
            acc = xs[0].to(dev)
            for x in xs[1:]:
                acc = op(acc, x.to(dev))
            done[dev] = acc
        out.append(done[dev])
    return out


def psum(xs, mesh: Mesh) -> list:
    return _reduce(xs, mesh, torch.add)


def pmin(xs, mesh: Mesh) -> list:
    return _reduce(xs, mesh, torch.minimum)


def pmax(xs, mesh: Mesh) -> list:
    return _reduce(xs, mesh, torch.maximum)


def all_to_all(xs, mesh: Mesh) -> list:
    """``xs[p]`` has a leading axis of ``mesh.size``; position q receives
    ``stack([xs[p][q] for p])``."""
    return [torch.stack([x[q].to(dev) for x in xs])
            for q, dev in enumerate(mesh.devices)]


def ppermute(xs, mesh: Mesh, shift: int) -> list:
    """Rotate along the ring: position q receives position
    (q − shift) mod P's tensor (``shift=1``: data flows q − 1 → q)."""
    p = mesh.size
    return [xs[(q - shift) % p].to(dev, copy=True)
            for q, dev in enumerate(mesh.devices)]


def all_gather(xs, mesh: Mesh) -> list:
    """Every position's rows joined in position order, on every
    position's device."""
    return [gather(xs, device=dev) for dev in mesh.devices]


# ---- sharded state -----------------------------------------------------------


@dataclasses.dataclass
class ShardedState:
    """A ``ParticleState`` sharded over the particle axis: ``shards[q]``
    holds position q's rows (time replicated). ``pos``, ``vel``, ``acc``
    and ``mass`` are the global tensors, gathered on position 0's
    device."""

    shards: list

    @property
    def n(self) -> int:
        return sum(s.n for s in self.shards)

    @property
    def time(self) -> torch.Tensor:
        return self.shards[0].time

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def _global(self, name: str) -> torch.Tensor:
        return gather([getattr(s, name) for s in self.shards])

    @property
    def pos(self) -> torch.Tensor:
        return self._global("pos")

    @property
    def vel(self) -> torch.Tensor:
        return self._global("vel")

    @property
    def acc(self) -> torch.Tensor:
        return self._global("acc")

    @property
    def mass(self) -> torch.Tensor:
        return self._global("mass")


def shard_state(state: ParticleState, mesh: Mesh) -> ShardedState:
    """The state's rows split over the mesh (N must divide the device
    count: pad upstream with zero-mass particles, which exert and receive
    nothing), time replicated on every position."""
    parts = {f: split(getattr(state, f), mesh)
             for f in ("pos", "vel", "acc", "mass")}
    return ShardedState([
        ParticleState(pos=parts["pos"][q], vel=parts["vel"][q],
                      acc=parts["acc"][q], mass=parts["mass"][q],
                      time=state.time.to(dev, copy=True))
        for q, dev in enumerate(mesh.devices)
    ])


def gather_state(state: ShardedState, n: Optional[int] = None) -> ParticleState:
    """The sharded state on position 0's device, trimmed to its first
    ``n`` (logical) rows."""
    sh = state.shards
    return ParticleState(
        pos=gather([s.pos for s in sh], n), vel=gather([s.vel for s in sh], n),
        acc=gather([s.acc for s in sh], n), mass=gather([s.mass for s in sh], n),
        time=state.time,
    )


def pad_to_devices(state: ParticleState, n_devices: int) -> ParticleState:
    """Pad with zero-mass particles at the origin so N divides the device
    count."""
    rem = state.n % n_devices
    if rem == 0:
        return state
    pad = n_devices - rem

    def rows(t):
        return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])

    return ParticleState(pos=rows(state.pos), vel=rows(state.vel),
                         acc=rows(state.acc), mass=rows(state.mass),
                         time=state.time)
