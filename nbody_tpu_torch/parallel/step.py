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

Each force is a program of stages split at its collectives
(``parallel/program.py``); a step is that program with the drift fused
into its first stage and the kick into its last (``verlet_ops``). Where
the JAX package jits the step and scans n of them in one SPMD program,
``sharded_multi_step`` on the card runs the step's stages as captured
CUDA graphs (``program.ShardedGraphs``), replayed with the collectives
between them; on the CPU, and with ``graphed=False``, the same stages run
eagerly. ``sharded_energy`` stays eager: its P(P+1)/2 K5 launches and two
``psum``s are ~14 launches a call at P = 4.
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
from nbody_tpu_torch.parallel.program import (
    Collective,
    ShardedGraphs,
    Stage,
    fuse_first,
    fuse_last,
    run_forces,
)
from nbody_tpu_torch.parallel.ring import ring_ops
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


def _tag(ops, mesh: Mesh, distribution: str) -> ShardedForceFn:
    """``force_fn(pos blocks, mass blocks) -> acc blocks``, the force
    program ``ops`` run eagerly, carrying ``ops`` and the selected
    strategy's name ``distribution`` (read by
    ``ParticleSystem.diagnostics``)."""

    def force_fn(pos, mass):
        return run_forces(ops, pos, mass, mesh)[0]

    force_fn.ops = ops
    force_fn.distribution = distribution
    return force_fn


def _fallback_ops(inner) -> tuple:
    """The replicated fallback as a force program: every position's rows
    gathered, the single-device force ``inner`` on all of them, the
    position's own rows kept."""

    def gather(cs, mesh):
        full_pos = all_gather([c["pos"] for c in cs], mesh)
        full_mass = all_gather([c["mass"] for c in cs], mesh)
        return [{"full_pos": a, "full_mass": b}
                for a, b in zip(full_pos, full_mass)]

    def force(i, q, c):
        n_l = c["pos"].shape[0]
        acc = inner(c["full_pos"], c["full_mass"])
        return {"force": acc[q * n_l:(q + 1) * n_l]}

    return (Collective("all_gather", gather), Stage("force", force))


def make_sharded_force_fn(config: SimulationConfig, mesh: Mesh,
                          pos_hint=None) -> ShardedForceFn:
    """``force_fn(pos blocks, mass blocks) -> acc blocks`` for the config,
    tagged ``distribution``: ``"ring"`` (direct), ``"tree-slabs"`` (BH,
    2^bh_max_level % P == 0), ``"hash-slabs"`` (hash, hash_max_grid_dim %
    P == 0) or ``"replicated-fallback"``, which issues
    ``ReplicatedFallbackWarning``; its force program is ``force_fn.ops``.
    ``pos_hint`` feeds the fallback's engine choice, as in the
    single-device factory."""
    G, eps = config.G, config.softening
    if config.force_method == ForceMethod.DIRECT_N2:
        return _tag(ring_ops(mesh, G, eps), mesh, "ring")

    n_dev = mesh.size
    if config.force_method == ForceMethod.BARNES_HUT:
        d = 1 << config.bh_max_level
        if d % n_dev == 0:
            from nbody_tpu_torch.parallel.tree import tree_slab_ops

            occ = config.particle_count / float(d**3)
            raw = occ + 5.0 * math.sqrt(occ + 1.0)
            near_k = int(min(64, max(8, -(-raw // 8) * 8)))
            return _tag(tree_slab_ops(mesh, G, eps, config.barnes_hut_theta,
                                      levels=config.bh_max_level,
                                      near_k=near_k), mesh, "tree-slabs")
    elif config.force_method == ForceMethod.SPATIAL_HASH:
        if config.hash_max_grid_dim % n_dev == 0:
            from nbody_tpu_torch.parallel.tree import hash_slab_ops

            return _tag(hash_slab_ops(
                mesh, G, eps, cutoff=config.spatial_hash_cutoff,
                cell_size=config.spatial_hash_cell_size,
                cap=config.hash_max_grid_dim,
                max_per_cell=config.hash_max_per_cell), mesh, "hash-slabs")

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
    return _tag(_fallback_ops(inner), mesh, "replicated-fallback")


def verlet_ops(force_fn: ShardedForceFn, dt) -> tuple:
    """One Verlet step as a program: the drift fused into the force
    program's first stage, the kick into its last (carries ``pos``,
    ``vel``, ``acc``, ``mass``, ``time``)."""
    def drift(i, q, c):
        return {"pos": c["pos"] + c["vel"] * dt + (0.5 * dt * dt) * c["acc"]}

    def kick(i, q, c):
        a = c["force"]
        return {"vel": c["vel"] + (0.5 * dt) * (c["acc"] + a), "acc": a,
                "time": c["time"] + dt}

    ops = list(force_fn.ops)
    if isinstance(ops[0], Stage):
        ops[0] = fuse_first(ops[0], drift)
    else:
        ops.insert(0, Stage("drift", drift))
    if isinstance(ops[-1], Stage):
        ops[-1] = fuse_last(ops[-1], kick)
    else:
        ops.append(Stage("kick", kick))
    return tuple(ops)


def sharded_verlet_step(state: ShardedState, force_fn: ShardedForceFn,
                        dt) -> ShardedState:
    """``ops.integrator.verlet_step`` on every position's rows, the force
    through the sharded program, eagerly."""
    return ShardedGraphs(verlet_ops(force_fn, dt), state.mesh,
                         graphed=False)(state, 1)


def sharded_initialize_forces(state: ShardedState,
                              force_fn: ShardedForceFn) -> ShardedState:
    """a(t=0) of a sharded state (eager)."""
    sh = state.shards
    acc = force_fn([s.pos for s in sh], [s.mass for s in sh])
    return ShardedState([
        ParticleState(pos=s.pos, vel=s.vel, acc=a, mass=s.mass, time=s.time)
        for s, a in zip(sh, acc)
    ], state.mesh)


def sharded_multi_step(force_fn: ShardedForceFn, dt: float, n_steps: int,
                       graphed=None):
    """``multi(state) -> state``: ``n_steps`` sharded Verlet steps with
    ``force_fn``. On the card (``graphed`` None or True) the step's stages
    are captured CUDA graphs, made at the first call and replayed at every
    later one (``multi.graphs``), the collectives between replays; a
    failed capture raises. ``graphed=False`` (and every state on the CPU)
    runs the same stages eagerly: the reference the graphs are held to."""
    ops = verlet_ops(force_fn, dt)

    def multi(state: ShardedState) -> ShardedState:
        on_card = state.device.type == "cuda"
        if graphed is False or not on_card:
            return ShardedGraphs(ops, state.mesh, graphed=False)(state,
                                                                 n_steps)
        if multi.graphs is None:
            multi.graphs = ShardedGraphs(ops, state.mesh)
        return multi.graphs(state, n_steps)

    multi.graphs = None
    return multi


def make_sharded_step(config: SimulationConfig, mesh: Mesh, pos_hint=None):
    """``step(ShardedState) -> ShardedState``: one Verlet step
    (``sharded_multi_step`` of one step: its captured segments on the
    card, where the JAX package jits the step)."""
    force_fn = make_sharded_force_fn(config, mesh, pos_hint=pos_hint)
    return sharded_multi_step(force_fn, config.dt, 1)


def make_sharded_multi_step(config: SimulationConfig, mesh: Mesh,
                            n_steps: int, pos_hint=None):
    """``n_steps`` sharded Verlet steps (``sharded_multi_step``: the JAX
    package fuses them into one program; here on the card each step
    replays its captured stages, the collectives between them)."""
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
