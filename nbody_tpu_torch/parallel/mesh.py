"""The device mesh, state sharding and the collectives.

PyTorch counterpart of ``nbody_tpu/parallel/mesh.py``. The JAX package
shards with a 1-D ``jax.sharding.Mesh`` over ``jax.devices()``, which
spans every process once ``jax.distributed`` is up, and ``shard_map``
runs the body on each device. Here a ``Mesh`` is P positions, each on a
torch device. Without a process group they are all this process's: a
tuple of devices, where a repeated device holds virtual shards, each with
its own slice of the state, as the JAX tests' 8 virtual CPU devices do.
With a group of W processes (``parallel/distributed.py``) the positions
are ordered rank-major: rank r holds positions [r·L, (r + 1)·L), L = P/W,
on its own devices. A sharded tensor is a list holding one tensor per
position of THIS process, each on that position's device; in one process
that is every position.

The collectives (``psum``, ``pmin``, ``pmax``, ``all_to_all``,
``ppermute``, ``all_gather``) take such a list and return one, each result
on its position's device; every process of the mesh calls each of them in
the same order. No other module of the package moves data between
positions or processes. Within a process they move data with PyTorch's
cross-device ``.to()``, which orders itself against both devices' current
streams. Between processes they use ``torch.distributed``:

  * ``psum``/``pmin``/``pmax`` all-gather every position's tensor and
    fold them in position order on each device, as one process does, so
    a mesh across processes gives the one-process mesh's result bit for
    bit wherever the per-position work is deterministic. The price: each
    process receives all P tensors, P times the bytes a ring all-reduce
    moves (for the Barnes-Hut finest moments, 10.5 MB a position at
    d = 64, so 4 × 10.5 MB into each of 4 ranks a force call);
  * ``all_to_all`` is one ``all_to_all_single`` over the equal-sized
    blocks;
  * ``ppermute`` is paired ``isend``/``irecv`` (``batch_isend_irecv``);
  * ``all_gather`` is one ``all_gather``.

On gloo, card tensors go through host memory, staged here (``_wire``)
and nowhere else; NCCL takes them on the card. Tensors held by a sharded
value are never written in place, so positions on one device may share a
reduction's result.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from nbody_tpu_torch.errors import ValidationError
from nbody_tpu_torch.parallel.distributed import (
    global_device_info,
    local_cards,
    process_world,
)
from nbody_tpu_torch.state import ParticleState

PARTICLE_AXIS = "p"


def _unavailable(requested: int, avail: int) -> ValidationError:
    return ValidationError(
        f"Requested {requested} devices but only {avail} available")


def sharded_device_count(requested: Optional[int] = None) -> int:
    """The CUDA cards of every process (``global_device_info``: a
    collective when a group is up), or ``requested`` when that many exist
    (raises ``ValidationError`` naming both counts when not)."""
    avail = global_device_info()["global_devices"]
    if requested is None or requested <= 0:
        return avail
    if requested > avail:
        raise _unavailable(requested, avail)
    return requested


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the particle axis: ``devices`` are this process's
    positions' devices, ``rank`` and ``world`` its place among the
    processes the mesh spans (0 and 1 for a one-process mesh). Global
    position q belongs to rank q // len(devices)."""

    devices: tuple
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        """P, the positions of every process."""
        return len(self.devices) * self.world

    @property
    def local(self) -> range:
        """The global indices of this process's positions."""
        n = len(self.devices)
        return range(self.rank * n, (self.rank + 1) * n)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``n_devices`` positions: the first of ``devices`` (an
    explicit sequence of torch devices; a repeated device holds virtual
    shards), or by default the visible CUDA cards.

    With a group of W processes up, every process calls it: the mesh
    spans them, ``devices`` (default: this rank's card) being each
    process's own, and each process holds n/W positions on the first n/W
    of them. ``n_devices`` is checked against the devices of all
    processes and must split over them evenly."""
    rank, world = process_world()
    own = (tuple(torch.device(d) for d in devices) if devices is not None
           else tuple(local_cards()))
    counts = all_gather_ints(len(own))
    avail = sum(counts)
    n = avail if n_devices is None or n_devices <= 0 else n_devices
    if n > avail:
        raise _unavailable(n, avail)
    if not n:
        raise ValidationError("Requested a mesh but no device is available")
    if n % world:
        raise ValidationError(
            f"A mesh across {world} processes needs a multiple of {world} "
            f"positions, not {n}")
    if n // world > min(counts):
        raise ValidationError(
            f"Requested {n} devices over {world} processes but one holds "
            f"only {min(counts)}")
    return Mesh(own[:n // world], rank, world)


# ---- between processes -------------------------------------------------------


def _staged() -> bool:
    """Whether card tensors go through host memory (the gloo backend)."""
    import torch.distributed as dist

    return dist.get_backend() == "gloo"


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous on the device the backend sends from."""
    if x.is_cuda and _staged():
        return x.cpu()
    return x.contiguous()


def _wire_empty(like: torch.Tensor) -> torch.Tensor:
    """An uninitialized receive buffer of ``like``'s shape and dtype on the
    device the backend receives on."""
    dev = "cpu" if like.is_cuda and _staged() else like.device
    return torch.empty(like.shape, dtype=like.dtype, device=dev)


def all_gather_ints(value: int) -> list:
    """``value`` of every process, in rank order (``[value]`` alone)."""
    import torch.distributed as dist

    world = process_world()[1]
    if world == 1:
        return [int(value)]
    dev = "cpu" if _staged() else torch.device(
        "cuda", torch.cuda.current_device())
    mine = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    out = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(out, mine)
    return [int(t) for t in out]


def _positions(xs, mesh: Mesh) -> list:
    """Every position's tensor in position order: ``xs`` itself in one
    process, else all-gathered (on the wire's device)."""
    if mesh.world == 1:
        return list(xs)
    import torch.distributed as dist

    mine = torch.stack([_wire(x) for x in xs])
    bufs = [torch.empty_like(mine) for _ in range(mesh.world)]
    dist.all_gather(bufs, mine)
    return [b[i] for b in bufs for i in range(len(xs))]


# ---- sharded tensors -------------------------------------------------------


def split(x: torch.Tensor, mesh: Mesh) -> list:
    """Rows of ``x`` in ``mesh.size`` equal blocks, this process's blocks
    copied to their positions' devices (N must divide evenly)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValidationError(
            f"Particle count {n} not divisible by {mesh.size} devices; "
            "pad with zero-mass particles"
        )
    b = n // mesh.size
    return [x[q * b:(q + 1) * b].to(dev, copy=True)
            for q, dev in zip(mesh.local, mesh.devices)]


def gather(xs: Sequence[torch.Tensor], n: Optional[int] = None,
           device=None) -> torch.Tensor:
    """The blocks joined in list order on ``device`` (the first block's by
    default), trimmed to the first ``n`` rows."""
    dev = xs[0].device if device is None else torch.device(device)
    out = torch.cat([x.to(dev) for x in xs], dim=0)
    return out if n is None else out[:n]


def gather_global(xs, mesh: Mesh, n: Optional[int] = None) -> torch.Tensor:
    """Every position's rows joined in position order on this process's
    first position's device, trimmed to ``n`` rows: a collective when the
    mesh spans processes."""
    return gather(_positions(xs, mesh), n, device=mesh.devices[0])


# ---- collectives -------------------------------------------------------------


def _reduce(xs, mesh: Mesh, op) -> list:
    """``op`` folded over all positions in position order, once per
    distinct device of this process (so two calls are bit-equal, and a
    mesh across processes equals the one-process mesh), the result on
    every position's device."""
    xs = _positions(xs, mesh)
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
    if mesh.world == 1:
        return [torch.stack([x[q].to(dev) for x in xs])
                for q, dev in enumerate(mesh.devices)]
    import torch.distributed as dist

    n = len(xs)
    # (P, L, ...): the rows for rank s are positions [s·L, (s + 1)·L)
    send = torch.stack([_wire(x) for x in xs], dim=1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    # recv[r·L + j, i] = rank r's position i's block for our position j
    recv = recv.reshape(mesh.world, n, n, *send.shape[2:])
    return [recv[:, j].reshape(mesh.size, *send.shape[2:]).to(dev)
            for j, dev in enumerate(mesh.devices)]


def ppermute(xs, mesh: Mesh, shift: int) -> list:
    """Rotate along the ring: position q receives position
    (q − shift) mod P's tensor (``shift=1``: data flows q − 1 → q)."""
    import torch.distributed as dist

    p, n, first = mesh.size, len(xs), mesh.local.start
    out, ops, recvs = [None] * n, [], []
    for i, q in enumerate(mesh.local):
        src, dst = (q - shift) % p, (q + shift) % p
        if src in mesh.local:
            out[i] = xs[src - first].to(mesh.devices[i], copy=True)
        else:
            buf = _wire_empty(xs[i])
            ops.append(dist.P2POp(dist.irecv, buf, src // n, tag=q))
            recvs.append((i, buf))
        if dst not in mesh.local:
            ops.append(dist.P2POp(dist.isend, _wire(xs[i]), dst // n,
                                  tag=dst))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    for i, buf in recvs:
        out[i] = buf.to(mesh.devices[i])
    return out


def all_gather(xs, mesh: Mesh) -> list:
    """Every position's rows joined in position order, on every
    position's device."""
    allp = _positions(xs, mesh)
    return [gather(allp, device=dev) for dev in mesh.devices]


# ---- sharded state -----------------------------------------------------------


@dataclasses.dataclass
class ShardedState:
    """A ``ParticleState`` sharded over the particle axis of ``mesh``:
    ``shards[i]`` holds the rows of this process's i-th position (time
    replicated). ``pos``, ``vel``, ``acc`` and ``mass`` are the global
    tensors on the first position's device: collectives every process of
    the mesh calls when it spans processes."""

    shards: list
    mesh: Mesh

    @property
    def n(self) -> int:
        """Rows of all positions (the blocks are equal)."""
        return self.shards[0].n * self.mesh.size

    @property
    def time(self) -> torch.Tensor:
        return self.shards[0].time

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def _global(self, name: str) -> torch.Tensor:
        return gather_global([getattr(s, name) for s in self.shards],
                             self.mesh)

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
    """This process's rows of the global ``state`` (which every process
    holds, as each builds it from the seed), split over the mesh (N must
    divide the position count: pad upstream with zero-mass particles,
    which exert and receive nothing), time replicated on every
    position."""
    parts = {f: split(getattr(state, f), mesh)
             for f in ("pos", "vel", "acc", "mass")}
    return ShardedState([
        ParticleState(pos=parts["pos"][i], vel=parts["vel"][i],
                      acc=parts["acc"][i], mass=parts["mass"][i],
                      time=state.time.to(dev, copy=True))
        for i, dev in enumerate(mesh.devices)
    ], mesh)


def gather_state(state: ShardedState, n: Optional[int] = None) -> ParticleState:
    """The global state on the first position's device, trimmed to its
    first ``n`` (logical) rows: a collective when the mesh spans
    processes."""
    sh, mesh = state.shards, state.mesh
    return ParticleState(
        **{f: gather_global([getattr(s, f) for s in sh], mesh, n)
           for f in ("pos", "vel", "acc", "mass")},
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
