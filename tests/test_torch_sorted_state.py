"""Sorted-state stepping of nbody_tpu_torch against the JAX package (CPU):
``SortedState``, ``sorted_state_from``, ``to_particle_state``,
``sorted_verlet_step`` on both payload routes and
``make_sorted_multi_step(route_extra=...)``, on the spatial hash's tiles
engine (JAX: its XLA tiles path) with the payload riding the engine's sort
as ``extra``; then, port only, the two routes bit for bit on the hash and
Barnes-Hut tiles engines.

Tolerances as the JAX package's own sorted-vs-plain gate: positions rtol
2e-4 / atol 1e-5, velocities and accelerations rtol 2e-3 / atol 1e-4 (f32
summation order inside cells); masses, tags and the permutation exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import integrator as jint
from nbody_tpu.ops import spatial_hash as jsh
from nbody_tpu.state import ParticleState as JState
from nbody_tpu_torch.ops import barnes_hut as tbh
from nbody_tpu_torch.ops import integrator as tint
from nbody_tpu_torch.ops import spatial_hash as tsh
from nbody_tpu_torch.state import ParticleState

N, D, K, CELL, CUT, EPS, DT, STEPS = 2000, 16, 16, 1.0, 2.0, 0.1, 1e-2, 3


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(11)
    return dict(
        pos=rng.uniform(-7.0, 7.0, (N, 3)).astype(np.float32),
        vel=rng.normal(0.0, 0.5, (N, 3)).astype(np.float32),
        acc=rng.normal(0.0, 0.1, (N, 3)).astype(np.float32),
        mass=rng.uniform(0.5, 1.5, N).astype(np.float32),
    )


def _jax_force(pos, mass, extra=None):
    return jsh.spatial_hash_forces_tiles_sorted(
        pos, mass, 1.0, EPS, cutoff=CUT, cell_size=CELL, d=D, k=K,
        impl="xla", extra=extra)


def _torch_force(pos, mass, extra=None):
    return tsh.spatial_hash_forces_tiles_sorted(
        pos, mass, 1.0, EPS, cutoff=CUT, cell_size=CELL, d=D, k=K,
        extra=extra)


def _jstate(s):
    return JState(pos=jnp.asarray(s["pos"]), vel=jnp.asarray(s["vel"]),
                  acc=jnp.asarray(s["acc"]), mass=jnp.asarray(s["mass"]),
                  time=jnp.zeros((), jnp.float32))


def _tstate(s):
    return ParticleState.from_numpy(s["pos"], s["vel"], s["acc"], s["mass"],
                                    0.0, device="cpu")


def _assert_close(got, want, *, exact_order):
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel),
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got.acc.numpy(), np.asarray(want.acc),
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_array_equal(got.mass.numpy(), np.asarray(want.mass))
    if exact_order:
        np.testing.assert_array_equal(got.to_orig.numpy(),
                                      np.asarray(want.to_orig))
    assert abs(float(got.time) - float(want.time)) < 1e-6


@pytest.fixture(scope="module")
def jax_steps(scene):
    """The JAX package's sorted steps (separate-gather route) and its
    readout."""
    s = jint.sorted_state_from(_jstate(scene))
    for _ in range(STEPS):
        s = jint.sorted_verlet_step(s, _jax_force, DT)
    return s, jint.to_particle_state(s)


@pytest.mark.parametrize("route_extra", [False, True])
def test_sorted_verlet_step_matches_jax(scene, jax_steps, route_extra):
    """Three ``sorted_verlet_step``s from ``sorted_state_from`` on the hash
    tiles engine, then ``to_particle_state``: the sorted rows, their tags
    and the original-order readout against JAX's."""
    want_s, want = jax_steps
    s = tint.sorted_state_from(_tstate(scene))
    assert s.to_orig.dtype == torch.int32
    for _ in range(STEPS):
        s = tint.sorted_verlet_step(s, _torch_force, DT,
                                    route_extra=route_extra)
    _assert_close(s, want_s, exact_order=True)
    out = tint.to_particle_state(s)
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(want.pos),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(want.vel),
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_array_equal(out.mass.numpy(), scene["mass"])


def test_make_sorted_multi_step_route_extra_matches_jax(scene, jax_steps):
    """``make_sorted_multi_step(route_extra=True)``: JAX's packed carry
    with [vel | tag] riding the sort against the port's routed payload."""
    jout = jint.make_sorted_multi_step(_jax_force, DT, STEPS,
                                       route_extra=True)(_jstate(scene))
    out = tint.make_sorted_multi_step(_torch_force, DT, STEPS,
                                      route_extra=True)(_tstate(scene))
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(jout.pos),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(jout.vel),
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(out.acc.numpy(), np.asarray(jout.acc),
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_array_equal(out.mass.numpy(), scene["mass"])
    # the JAX package's two routes agree with each other as well
    np.testing.assert_allclose(np.asarray(jout.pos),
                               np.asarray(jax_steps[1].pos), rtol=2e-4,
                               atol=1e-5)


def test_to_particle_state_inverts_any_permutation(scene):
    """``to_particle_state`` of a state in an arbitrary row permutation is
    the JAX package's readout of the same state, bit for bit."""
    perm = np.random.default_rng(2).permutation(N).astype(np.int32)
    rows = {k: scene[k][perm] for k in ("pos", "vel", "acc", "mass")}
    got = tint.to_particle_state(tint.SortedState(
        **{k: torch.from_numpy(v) for k, v in rows.items()},
        to_orig=torch.from_numpy(perm), time=torch.tensor(0.5)))
    want = jint.to_particle_state(jint.SortedState(
        **{k: jnp.asarray(v) for k, v in rows.items()},
        to_orig=jnp.asarray(perm), time=jnp.asarray(0.5, jnp.float32)))
    for k in ("pos", "vel", "acc", "mass"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
        np.testing.assert_array_equal(getattr(got, k).numpy(), scene[k])
    with pytest.raises(AttributeError):
        tint.sorted_state_from(_tstate(scene)).pos = None  # frozen


def _bh_force():
    def force(pos, mass, extra=None):
        return tbh.barnes_hut_forces_sorted(pos, mass, 1.0, EPS, 0.5,
                                            levels=3, near_k=16, extra=extra)
    return force


@pytest.mark.parametrize("engine", ["hash", "bh"])
def test_routes_bit_equal(scene, engine):
    """The payload riding the sort and the separate gathers give the same
    state bit for bit, step by step and through ``make_sorted_multi_step``
    (the same arithmetic; only the gather differs)."""
    force = _torch_force if engine == "hash" else _bh_force()
    a = b = tint.sorted_state_from(_tstate(scene))
    for _ in range(STEPS):
        a = tint.sorted_verlet_step(a, force, DT, route_extra=False)
        b = tint.sorted_verlet_step(b, force, DT, route_extra=True)
        for f in ("pos", "vel", "acc", "mass", "to_orig", "time"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    st = _tstate(scene)
    m0 = tint.make_sorted_multi_step(force, DT, STEPS, route_extra=False)(st)
    m1 = tint.make_sorted_multi_step(force, DT, STEPS, route_extra=True)(st)
    want = tint.to_particle_state(a)
    for f in ("pos", "vel", "acc", "mass"):
        assert torch.equal(getattr(m0, f), getattr(want, f)), f
        assert torch.equal(getattr(m1, f), getattr(want, f)), f


def test_route_extra_defers_to_the_closure(scene, monkeypatch):
    """``route_extra=None`` reads the closure's attribute (the engine
    factories set False, as the JAX factories do); at 2²⁴ rows and above
    the routed payload takes the separate gathers, since a float32 tag is
    exact only below."""
    from nbody_tpu_torch.types import ForceMethod, SimulationConfig

    seen = []

    def force(pos, mass, extra=None):
        seen.append(extra is not None)
        return _torch_force(pos, mass, extra)

    st = _tstate(scene)
    tint.make_sorted_multi_step(force, DT, 1)(st)
    force.route_extra = True
    tint.make_sorted_multi_step(force, DT, 1)(st)
    monkeypatch.setattr(tint, "_F32_EXACT_ROWS", N)
    tint.make_sorted_multi_step(force, DT, 1)(st)
    assert seen == [False, True, False]
    bh = SimulationConfig(particle_count=N, bh_max_level=3,
                          force_method=ForceMethod.BARNES_HUT)
    hsh = SimulationConfig(particle_count=N, hash_engine="tiles",
                           force_method=ForceMethod.SPATIAL_HASH)
    assert tbh.make_barnes_hut_forces_sorted(bh).route_extra is False
    assert tsh.make_spatial_hash_forces_sorted(hsh).route_extra is False
