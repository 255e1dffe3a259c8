"""Sharded simulation step and energy.

PyTorch counterpart of ``nbody_tpu/parallel/step.py``: the Velocity Verlet
step of a particle-sharded state (``ShardedState``, ``parallel/mesh.py``).
Kick and drift run on each position's own rows; the force comes from the
ring (direct), the slab-routed tree and hash paths (``parallel/tree.py``)
when the grid splits over the mesh, or, as the fallback, the whole
single-device program replicated on every position; energies reduce with
``psum``, the potential by kernel K5's main form on each block and its
cross form on each pair of blocks once, over a ring. Each process
runs its own positions; on a mesh across processes every process calls
these functions together and gets the same energies.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable

import torch

from nbody_tpu_torch.ops.direct import (
    pairwise_potential,
    pairwise_potential_cross,
)
from nbody_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedState,
    all_gather,
    ppermute,
    psum,
)
from nbody_tpu_torch.parallel.ring import ring_direct_forces
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.types import ForceMethod, SimulationConfig

# force_fn(pos blocks, mass blocks) -> acc blocks, one per position of this
# process
ShardedForceFn = Callable[[list, list], list]


class ReplicatedFallbackWarning(RuntimeWarning):
    """The sharded force fell back to REPLICATED per-position compute.

    Results stay exact, but every position runs the full single-device
    program — O(N·devices) redundant work, no scaling. Issued so a user
    who configured a mesh learns that the designed distributed path
    (parallel/tree.py) was not selected; fix by choosing a grid that
    divides the mesh (BH: 2^bh_max_level % n_devices == 0; hash:
    hash_max_grid_dim % n_devices == 0)."""


def _tag(force_fn, distribution: str):
    """Name the selected strategy on the closure (read by
    ``ParticleSystem.diagnostics``)."""
    force_fn.distribution = distribution
    return force_fn


def make_sharded_force_fn(config: SimulationConfig, mesh: Mesh,
                          pos_hint=None) -> ShardedForceFn:
    """``force_fn(pos blocks, mass blocks) -> acc blocks`` for the config,
    tagged ``distribution``: ``"ring"`` (direct), ``"tree-slabs"`` (BH,
    2^bh_max_level % P == 0), ``"hash-slabs"`` (hash, hash_max_grid_dim %
    P == 0) or ``"replicated-fallback"``, which issues
    ``ReplicatedFallbackWarning``. ``pos_hint`` feeds the fallback's
    engine choice, as in the single-device factory."""
    G, eps = config.G, config.softening
    if config.force_method == ForceMethod.DIRECT_N2:

        def force_fn(pos, mass):
            return ring_direct_forces(pos, mass, mesh, G, eps)

        return _tag(force_fn, "ring")

    n_dev = mesh.size
    if config.force_method == ForceMethod.BARNES_HUT:
        d = 1 << config.bh_max_level
        if d % n_dev == 0:
            from nbody_tpu_torch.parallel.tree import sharded_barnes_hut_forces

            occ = config.particle_count / float(d**3)
            raw = occ + 5.0 * math.sqrt(occ + 1.0)
            near_k = int(min(64, max(8, -(-raw // 8) * 8)))

            def force_fn(pos, mass):
                return sharded_barnes_hut_forces(
                    pos, mass, mesh, G, eps, config.barnes_hut_theta,
                    levels=config.bh_max_level, near_k=near_k)

            return _tag(force_fn, "tree-slabs")
    elif config.force_method == ForceMethod.SPATIAL_HASH:
        if config.hash_max_grid_dim % n_dev == 0:
            from nbody_tpu_torch.parallel.tree import (
                sharded_spatial_hash_forces,
            )

            def force_fn(pos, mass):
                return sharded_spatial_hash_forces(
                    pos, mass, mesh, G, eps,
                    cutoff=config.spatial_hash_cutoff,
                    cell_size=config.spatial_hash_cell_size,
                    cap=config.hash_max_grid_dim,
                    max_per_cell=config.hash_max_per_cell)

            return _tag(force_fn, "hash-slabs")

    warnings.warn(
        f"sharded {config.force_method.cli_name}: grid does not divide the "
        f"{n_dev}-device mesh "
        f"(BH d={1 << config.bh_max_level} / hash cap="
        f"{config.hash_max_grid_dim}) — falling back to REPLICATED "
        "per-device compute (exact, but O(N*devices) redundant work, no "
        "scaling). Pick a grid that divides the mesh to get the designed "
        "distributed path.",
        ReplicatedFallbackWarning,
        stacklevel=2,
    )
    from nbody_tpu_torch.ops.forces import make_force_fn

    # the hint is read on the host by the engine choice
    if isinstance(pos_hint, torch.Tensor):
        pos_hint = pos_hint.detach().cpu().numpy()
    inner = make_force_fn(config, pos_hint=pos_hint)

    def force_fn(pos, mass):
        full_pos, full_mass = all_gather(pos, mesh), all_gather(mass, mesh)
        out = []
        for i, q in enumerate(mesh.local):
            n_l = pos[i].shape[0]
            out.append(inner(full_pos[i], full_mass[i])[q * n_l:(q + 1) * n_l])
        return out

    return _tag(force_fn, "replicated-fallback")


def sharded_verlet_step(state: ShardedState, force_fn: ShardedForceFn,
                        dt) -> ShardedState:
    """``ops.integrator.verlet_step`` on every position's rows, the force
    through the sharded closure."""
    sh = state.shards
    pos = [s.pos + s.vel * dt + (0.5 * dt * dt) * s.acc for s in sh]
    acc = force_fn(pos, [s.mass for s in sh])
    return ShardedState([
        ParticleState(pos=p, vel=s.vel + (0.5 * dt) * (s.acc + a), acc=a,
                      mass=s.mass, time=s.time + dt)
        for s, p, a in zip(sh, pos, acc)
    ], state.mesh)


def sharded_initialize_forces(state: ShardedState,
                              force_fn: ShardedForceFn) -> ShardedState:
    """a(t=0) of a sharded state."""
    sh = state.shards
    acc = force_fn([s.pos for s in sh], [s.mass for s in sh])
    return ShardedState([
        ParticleState(pos=s.pos, vel=s.vel, acc=a, mass=s.mass, time=s.time)
        for s, a in zip(sh, acc)
    ], state.mesh)


def sharded_multi_step(force_fn: ShardedForceFn, dt: float, n_steps: int):
    """``n_steps`` sharded Verlet steps with ``force_fn``."""

    def multi(state: ShardedState) -> ShardedState:
        for _ in range(n_steps):
            state = sharded_verlet_step(state, force_fn, dt)
        return state

    return multi


def make_sharded_step(config: SimulationConfig, mesh: Mesh, pos_hint=None):
    """``step(ShardedState) -> ShardedState``: one Verlet step."""
    force_fn = make_sharded_force_fn(config, mesh, pos_hint=pos_hint)

    def step(state: ShardedState) -> ShardedState:
        return sharded_verlet_step(state, force_fn, config.dt)

    return step


def make_sharded_multi_step(config: SimulationConfig, mesh: Mesh,
                            n_steps: int, pos_hint=None):
    """``n_steps`` sharded Verlet steps (the JAX package fuses them into
    one program; here they queue on the devices without a host read)."""
    force_fn = make_sharded_force_fn(config, mesh, pos_hint=pos_hint)
    return sharded_multi_step(force_fn, config.dt, n_steps)


def sharded_energy(state: ShardedState, mesh: Mesh, G: float = 1.0,
                   softening: float = 0.1):
    """(KE, PE) as float32 scalars on this process's first position's
    device, the same on every process. KE: each position's ½Σ m|v|², then
    ``psum``. PE = Σ_p main(A_p) + 2·Σ_{p<q} cross(A_p, A_q) over the
    blocks A_p, on P(P+1)/2 launches of kernel K5 instead of P²: hop 0
    runs K5's main form on each position's own block; after hop h's
    ``ppermute`` (every position takes part) each position runs the cross
    form against the block h positions back, weight 2, for h < P/2; for
    even P the hop h = P/2 pairs p with p + P/2, so only positions
    p < P/2 run it. Raw r² == 0 is excluded as in K5; each position sums
    in float64, then ``psum`` in position order; zero-mass padding carries
    no energy."""
    sh = state.shards
    ke = psum([0.5 * torch.sum(s.mass * torch.sum(s.vel * s.vel, dim=-1))
               for s in sh], mesh)
    pos, mass = [s.pos for s in sh], [s.mass for s in sh]
    pe = [pairwise_potential(x, m, G, softening).double()
          for x, m in zip(pos, mass)]
    pj, mj = list(pos), list(mass)
    size = mesh.size
    for hop in range(1, size // 2 + 1):
        pj, mj = ppermute(pj, mesh, 1), ppermute(mj, mesh, 1)
        for i, q in enumerate(mesh.local):
            if 2 * hop == size and q >= hop:
                continue  # (q, q − P/2) is (q − P/2, q), taken there
            pe[i] = pe[i] + 2.0 * pairwise_potential_cross(
                pos[i], mass[i], pj[i], mj[i], G, softening).double()
    pe = psum(pe, mesh)
    return ke[0], pe[0].to(torch.float32)
