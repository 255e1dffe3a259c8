"""The sharded step's stages are capture-safe and its schedule is fixed
(CPU).

On the card the mesh's ``update()``, ``run_steps`` and
``sharded_multi_step`` replay the sharded step as captured segments, one
a stage, with the collectives run between replays
(``nbody_tpu_torch/parallel/program.py``). Here, on 4 virtual CPU shards:

  * every stage of the ring, tree-slabs, hash-slabs and the replicated
    fallback runs under the guards of ``tests/capture_guards.py`` after a
    warm run, on the carry an eager step gives it, and gives the
    unguarded values bit for bit (one intra-op thread);
  * the sequence of segments and collectives of one step is the same for
    every position and for two scenes, and its counts are those the
    program's ``ShardedGraphs`` reports;
  * ``make_sharded_step`` and ``make_sharded_multi_step`` are the step
    program run once and n times;
  * the tree-slabs facade agrees with the JAX facade sharded over 4.

The graphs themselves are held to the eager stages on the card
(``tests/test_torch_cuda.py -k sharded_graph``, ``chip_smoke.py`` phases 8
and 9).
"""

import functools
import warnings

import numpy as np
import pytest
import torch

import nbody_tpu as jnb
from capture_guards import guards, one_thread  # noqa: F401 (a fixture)
from nbody_tpu.state import SimulationState as JSnapshot
from nbody_tpu_torch import ParticleSystem
from nbody_tpu_torch.parallel import make_mesh, mesh as M
from nbody_tpu_torch.parallel.program import (
    Carry,
    Collective,
    ShardedGraphs,
    Stage,
)
from nbody_tpu_torch.parallel.step import (
    ReplicatedFallbackWarning,
    make_sharded_force_fn,
    make_sharded_multi_step,
    make_sharded_step,
    sharded_initialize_forces,
    sharded_verlet_step,
    verlet_ops,
)
from nbody_tpu_torch.state import ParticleState, SimulationState
from nbody_tpu_torch.types import ForceMethod, SimulationConfig

P = 4
DT = 1e-3
# distribution -> (config, the step's segments in order)
DISTRIBUTIONS = {
    "ring": (dict(force_method=ForceMethod.DIRECT_N2),
             ("drift, hop 0", "hop 1", "hop 2", "hop 3, kick")),
    "tree-slabs": (dict(force_method=ForceMethod.BARNES_HUT, bh_max_level=3),
                   ("drift, bounds", "moments", "far field", "slab tiles",
                    "slab sweep", "route back, kick")),
    "hash-slabs": (dict(force_method=ForceMethod.SPATIAL_HASH,
                        hash_max_grid_dim=8, hash_max_per_cell=16,
                        spatial_hash_cell_size=1.5, spatial_hash_cutoff=1.5),
                   ("drift, bounds", "coords", "slab tiles", "slab sweep",
                    "route back, kick")),
    # a grid of 10 does not split over 4
    "replicated-fallback": (dict(force_method=ForceMethod.SPATIAL_HASH,
                                 hash_max_grid_dim=10, hash_engine="tiles"),
                            ("drift", "force, kick")),
}
CASES = [(dist, seg) for dist, (_, segs) in DISTRIBUTIONS.items()
         for seg in segs]


def _ball(n, radius, seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = u * radius * np.cbrt(rng.uniform(size=(n, 1)))
    return (pos.astype(np.float32),
            rng.normal(0.0, 0.3, (n, 3)).astype(np.float32),
            rng.uniform(0.5, 1.5, n).astype(np.float32))


def _program(dist, radius=4.0, seed=13, n=256):
    """(the step's ops, the mesh, the sharded state with a(0)) of ``dist``
    on a ball of ``n`` rows."""
    kw, _ = DISTRIBUTIONS[dist]
    cfg = SimulationConfig(particle_count=n, dt=DT, **kw)
    mesh = make_mesh(P, devices=["cpu"] * P)
    pos, vel, mass = _ball(n, radius, seed)
    with warnings.catch_warnings():
        # the fallback warns by design
        warnings.simplefilter("ignore", ReplicatedFallbackWarning)
        force = make_sharded_force_fn(cfg, mesh, pos_hint=pos)
    assert force.distribution == dist
    st = M.shard_state(ParticleState.from_numpy(pos, vel, mass=mass,
                                                device="cpu"), mesh)
    return verlet_ops(force, DT), mesh, sharded_initialize_forces(st, force)


@functools.cache
def _carries(dist):
    """Each stage of one eager step of ``dist`` with the carry it runs on:
    {name: (stage, {key: tensor})}."""
    ops, mesh, st = _program(dist)
    g = ShardedGraphs(ops, mesh, graphed=False)
    for i, s in enumerate(st.shards):
        g.load(i, **{f: getattr(s, f) for f in ("pos", "vel", "acc",
                                                 "mass", "time")})
    (carry,) = g.sets.values()
    out = {}
    for op in ops:
        if isinstance(op, Stage):
            out[op.name] = (op, {k: v.clone()
                                 for k, v in carry.buffers.items()})
        g.apply(op)
    return mesh, out


@pytest.mark.parametrize("dist,segment", CASES,
                         ids=[f"{d}: {s}" for d, s in CASES])
def test_stage_is_capture_safe(dist, segment, monkeypatch, one_thread):
    """The stage runs under the guards after a warm run, on every
    position, and gives the unguarded values bit for bit (each run on its
    own copy of the carry)."""
    mesh, cases = _carries(dist)
    assert tuple(cases) == DISTRIBUTIONS[dist][1]
    stage, carry = cases[segment]

    def run():
        bufs = {k: v.clone() for k, v in carry.items()}
        return [stage.fn(i, q, Carry(bufs, i))
                for i, q in enumerate(mesh.local)]

    run()
    want = run()
    with guards(monkeypatch):
        got = run()
    for g, w in zip(got, want):
        assert set(g) == set(w) and g
        for k, v in w.items():
            assert torch.equal(g[k], v), f"{dist} {segment}: {k} differs"


def _schedule(dist, radius, seed):
    """Each position's (kind, name) sequence of one step of ``dist`` on a
    ball, recorded by wrapping every op, and the program's counts."""
    ops, mesh, st = _program(dist, radius=radius, seed=seed)
    seen = [[] for _ in mesh.local]

    def stage(op):
        def fn(i, q, c):
            seen[i].append(("segment", op.name))
            return op.fn(i, q, c)
        return Stage(op.name, fn)

    def collective(op):
        def fn(cs, mesh):
            for s in seen:
                s.append(("collective", op.name))
            return op.fn(cs, mesh)
        return Collective(op.name, fn)

    wrapped = [stage(op) if isinstance(op, Stage) else collective(op)
               for op in ops]
    g = ShardedGraphs(wrapped, mesh, graphed=False)
    g(st, 1)
    return seen, (g.segments, g.collectives)


@pytest.mark.parametrize("dist", list(DISTRIBUTIONS))
def test_schedule_is_fixed(dist, one_thread):
    """One step's segments and collectives: the same sequence on every
    position and for two scenes (another radius and seed), its segments
    the expected ones, and as many of each as ``ShardedGraphs`` counts."""
    a, counts = _schedule(dist, 4.0, 13)
    b, _ = _schedule(dist, 2.5, 99)
    assert all(s == a[0] for s in a + b)
    segs = [name for kind, name in a[0] if kind == "segment"]
    assert tuple(segs) == DISTRIBUTIONS[dist][1]
    assert counts == (len(segs), len(a[0]) - len(segs))
    kinds = [kind for kind, _ in a[0]]
    # a collective never ends the step: the kick is a segment
    assert kinds[0] == kinds[-1] == "segment"


@pytest.mark.parametrize("dist", ["ring", "tree-slabs"])
def test_make_sharded_step_is_one_step_of_the_program(dist, one_thread):
    """``make_sharded_step`` and ``make_sharded_multi_step`` are the step
    program run once and n times (eagerly on the CPU): equal to
    ``sharded_verlet_step`` applied in turn, bit for bit."""
    kw, _ = DISTRIBUTIONS[dist]
    cfg = SimulationConfig(particle_count=256, dt=DT, **kw)
    ops, mesh, st = _program(dist)
    force = make_sharded_force_fn(cfg, mesh)
    want = st
    for _ in range(3):
        want = sharded_verlet_step(want, force, DT)
    one = make_sharded_step(cfg, mesh)
    got = one(one(one(st)))
    three = make_sharded_multi_step(cfg, mesh, 3)(st)
    for out in (got, three):
        for a, b in zip(out.shards, want.shards):
            for f in ("pos", "vel", "acc", "mass", "time"):
                assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_tree_slabs_facade_matches_jax_facade():
    """Both facades sharded over 4 on tree-slabs (Barnes-Hut at
    bh_max_level 3) from one shared state, then run_steps(2): pos and vel
    within atol 1e-5."""
    rng = np.random.default_rng(17)
    pos = rng.uniform(-3, 3, (200, 3)).astype(np.float32)
    vel = rng.normal(0, 0.2, (200, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, 200).astype(np.float32)
    common = dict(dt=DT, G=1.0, softening=0.1)
    js = jnb.ParticleSystem()
    js._config = jnb.SimulationConfig(shard_devices=P, bh_max_level=3)
    js.set_state(JSnapshot(pos=pos, vel=vel, mass=mass,
                           force_method=jnb.ForceMethod.BARNES_HUT, **common))
    ts = ParticleSystem()
    ts._config = SimulationConfig(shard_devices=P, bh_max_level=3)
    ts.set_state(SimulationState(pos=pos, vel=vel, mass=mass,
                                 force_method=ForceMethod.BARNES_HUT,
                                 **common), device="cpu")
    assert ts.diagnostics()["force_distribution"] == "tree-slabs"
    assert js.diagnostics()["force_distribution"] == "tree-slabs"
    js.run_steps(2)
    ts.run_steps(2)
    np.testing.assert_allclose(ts.positions(), js.positions(), atol=1e-5)
    np.testing.assert_allclose(ts.velocities(), js.velocities(), atol=1e-5)
