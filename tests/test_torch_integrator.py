"""nbody_tpu_torch integrator and energies against the JAX package (CPU).

The sorted multi-step runs the port's whole Barnes-Hut step in cell-sorted
order; the JAX side runs plain stepping with its XLA tiles forces.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.models import two_body_orbit
from nbody_tpu.ops.barnes_hut import _barnes_hut_forces as jax_bh
from nbody_tpu.ops.integrator import initialize_forces as jax_init_forces
from nbody_tpu.ops.integrator import kinetic_energy as jax_ke
from nbody_tpu.ops.integrator import make_multi_step as jax_multi
from nbody_tpu.ops.integrator import potential_energy as jax_pe
from nbody_tpu.state import ParticleState as JState
from nbody_tpu_torch.ops.barnes_hut import (
    barnes_hut_forces,
    barnes_hut_forces_sorted,
)
from nbody_tpu_torch.ops.direct import direct_forces_kernel
from nbody_tpu_torch.ops.integrator import (
    initialize_forces,
    kinetic_energy,
    make_multi_step,
    make_sorted_multi_step,
    potential_energy,
    sampled_potential_energy,
    verlet_step,
)
from nbody_tpu_torch.state import ParticleState


def _np_state(n, radius, seed, vel_scale=0.0):
    rng = np.random.default_rng(seed)
    r = np.cbrt(rng.uniform(size=n)) * radius
    v = rng.normal(size=(n, 3))
    pos = (v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None])
    return dict(
        pos=pos.astype(np.float32),
        vel=(rng.normal(size=(n, 3)) * vel_scale).astype(np.float32),
        mass=rng.uniform(0.5, 1.5, n).astype(np.float32),
    )


def test_sorted_multi_step_matches_jax_plain_stepping():
    """The port's cell-sorted stepping (n = 800, levels = 3, k = 16, 2
    steps) vs JAX plain stepping with XLA tiles forces. Tolerances as the
    JAX package's own sorted-vs-plain gate: pos rtol 2e-4 / atol 1e-5, vel
    rtol 2e-3 / atol 1e-4 (f32 summation order inside cells)."""
    n, levels, steps, dt = 800, 3, 2, 1e-3
    s = _np_state(n, 5.0, seed=7)

    def jforce(pos, mass):
        return jax_bh(pos, mass, 1.0, 0.1, 0.5, levels=levels, window=2048,
                      near_engine="tiles", near_k=16, multipole_order=2,
                      near_impl="xla")

    js = JState(pos=jnp.asarray(s["pos"]), vel=jnp.asarray(s["vel"]),
                acc=jnp.zeros((n, 3), jnp.float32),
                mass=jnp.asarray(s["mass"]), time=jnp.zeros((), jnp.float32))
    jout = jax_multi(jforce, dt, steps)(jax_init_forces(js, jforce))

    def force(pos, mass):
        return barnes_hut_forces(pos, mass, 1.0, 0.1, 0.5, levels=levels,
                                 near_k=16)

    def sorted_force(pos, mass):
        return barnes_hut_forces_sorted(pos, mass, 1.0, 0.1, 0.5,
                                        levels=levels, near_k=16)

    ts = initialize_forces(
        ParticleState.from_numpy(s["pos"], s["vel"], None, s["mass"], 0.0,
                                 device="cpu"), force)
    out = make_sorted_multi_step(sorted_force, dt, steps)(ts)
    np.testing.assert_array_equal(out.mass.numpy(), s["mass"])
    assert abs(float(out.time) - float(jout.time)) < 1e-6
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(jout.pos),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(jout.vel),
                               rtol=2e-3, atol=1e-4)
    # and the port's own plain stepping agrees with its sorted stepping
    plain = make_multi_step(force, dt, steps)(ts)
    np.testing.assert_allclose(out.pos.numpy(), plain.pos.numpy(),
                               rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("accumulate", ["f32", "kahan", "f64"])
def test_energies_match_jax(accumulate):
    """KE rel 1e-6; PE rel 1e-5 in every accumulation mode (f32 sums of
    ~n² one-signed terms in another order)."""
    s = _np_state(512, 3.0, seed=9, vel_scale=0.3)
    js = JState(pos=jnp.asarray(s["pos"]), vel=jnp.asarray(s["vel"]),
                acc=jnp.zeros((512, 3), jnp.float32),
                mass=jnp.asarray(s["mass"]), time=jnp.zeros((), jnp.float32))
    ts = ParticleState.from_numpy(s["pos"], s["vel"], None, s["mass"],
                                  device="cpu")
    np.testing.assert_allclose(float(kinetic_energy(ts)), float(jax_ke(js)),
                               rtol=1e-6)
    want = float(jax_pe(js.pos, js.mass, 1.0, 0.1, accumulate=accumulate))
    got = float(potential_energy(ts.pos, ts.mass, 1.0, 0.1,
                                 accumulate=accumulate))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if accumulate == "f32":
        full = sampled_potential_energy(ts.pos, ts.mass, 1.0, 0.1,
                                        samples=10_000)
        np.testing.assert_allclose(float(full), want, rtol=1e-5)


def _two_body_drift(dtype):
    """|ΔE/E| (energies in float64) of the JAX package's two-body circular
    orbit after 100 Verlet steps at dt = 1e-3, integrated in ``dtype``."""
    G, eps, dt = 1.0, 0.1, 1e-3
    j = two_body_orbit(separation=2.0, softening=eps)
    s = ParticleState(
        *(torch.tensor(np.asarray(a), dtype=dtype)
          for a in (j.pos, j.vel, j.acc, j.mass, j.time)))

    def force(pos, mass):
        return direct_forces_kernel(pos, mass, G, eps)

    def energy(st):
        return float(kinetic_energy(st).double()) + float(potential_energy(
            st.pos.double(), st.mass.double(), G, eps, accumulate="f64"))

    s = initialize_forces(s, force)
    e0 = energy(s)
    for _ in range(100):
        s = verlet_step(s, force, dt)
    assert abs(float(s.time) - 0.1) < 1e-6
    return abs(energy(s) - e0) / abs(e0)


def test_two_body_energy_drift():
    """The integrator holds |ΔE/E| < 1e-6 over 100 steps when the state is
    float64. In float32 state the trajectory's own rounding sets the drift
    (1.36e-6 for the JAX package on the same scene): the port's float32
    drift must match the JAX package's within 10%."""
    assert _two_body_drift(torch.float64) < 1e-6

    from nbody_tpu.ops.direct import direct_forces as jax_direct
    from nbody_tpu.ops.integrator import verlet_step as jax_verlet

    G, eps, dt = 1.0, 0.1, 1e-3
    j = two_body_orbit(separation=2.0, softening=eps)

    def jforce(pos, mass):
        return jax_direct(pos, mass, G, eps)

    def jenergy(st):
        v = np.asarray(st.vel, np.float64)
        m = np.asarray(st.mass, np.float64)
        pe = jax_pe(jnp.asarray(np.asarray(st.pos, np.float64)),
                    jnp.asarray(m), G, eps, accumulate="f64")
        return 0.5 * float((m * (v * v).sum(-1)).sum()) + float(pe)

    j = jax_init_forces(j, jforce)
    e0 = jenergy(j)
    for _ in range(100):
        j = jax_verlet(j, jforce, dt)
    jax_drift = abs(jenergy(j) - e0) / abs(e0)
    drift = _two_body_drift(torch.float32)
    assert drift < 1e-5
    assert abs(drift - jax_drift) <= 0.1 * jax_drift
