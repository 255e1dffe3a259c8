"""The energy-drift measurement (``nbody_tpu_torch.drift.run_drift``, the
loop of ``scripts/measure_drift_torch.py``) against the same sequence built
from the JAX package on the same numpy state (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops.barnes_hut import barnes_hut_forces as jax_bh
from nbody_tpu.ops.barnes_hut import bh_engine_params as jax_bh_params
from nbody_tpu.ops.direct import pairwise_potential_pallas
from nbody_tpu.ops.integrator import initialize_forces as jax_init_forces
from nbody_tpu.ops.integrator import kinetic_energy as jax_ke
from nbody_tpu.ops.integrator import make_multi_step as jax_multi
from nbody_tpu.state import ParticleState as JState
from nbody_tpu.types import ForceMethod as JForceMethod
from nbody_tpu.types import SimulationConfig as JConfig
from nbody_tpu_torch.drift import drift_config, drift_metric, run_drift
from nbody_tpu_torch.state import ParticleState

N, LEVELS, STEPS = 1024, 3, 50


def _henon_state():
    """The measurement's scene from numpy: a uniform sphere of radius 10
    with total mass 1, at rest."""
    rng = np.random.default_rng(42)
    r = np.cbrt(rng.uniform(size=N)) * 10.0
    v = rng.normal(size=(N, 3))
    pos = (v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None])
    return pos.astype(np.float32), np.full(N, 1.0 / N, np.float32)


def _jax_sequence(pos, mass):
    """E at step 0, then E and the state after STEPS steps: JAX
    ``make_multi_step`` with the XLA Barnes-Hut forces and the engine the
    config selects; E = KE + the Pallas all-pairs PE in interpret mode."""
    jc = JConfig(particle_count=N, force_method=JForceMethod.BARNES_HUT,
                 bh_max_level=LEVELS, dt=1e-3)
    p = jax_bh_params(jc)

    def force(x, m):
        return jax_bh(x, m, jc.G, jc.softening, jc.barnes_hut_theta,
                      levels=p["levels"], window=p["window"],
                      near_engine=p["near_engine"], near_k=p["near_k"],
                      multipole_order=p["multipole_order"], near_impl="xla")

    def energy(s):
        return float(jax_ke(s)) + float(pairwise_potential_pallas(
            s.pos, s.mass, jc.G, jc.softening, interpret=True))

    s = JState(pos=jnp.asarray(pos), vel=jnp.zeros((N, 3), jnp.float32),
               acc=jnp.zeros((N, 3), jnp.float32), mass=jnp.asarray(mass),
               time=jnp.zeros((), jnp.float32))
    # E does not read a(t=0): one program for a(t=0) and the steps
    multi = jax_multi(force, jc.dt, STEPS)
    end = jax.jit(lambda st: multi(jax_init_forces(st, force)))(s)
    return energy(s), energy(end), end


def test_drift_matches_jax_sequence(monkeypatch):
    """One chunk of 50 steps at N = 1024, levels 3: E at both checkpoints
    within relative 1e-5 of the JAX sequence (two float32 trajectories
    through different Barnes-Hut engines and potential sums), |ΔE/E| of
    both below the 1e-4 target, and the records and final line shaped as
    the JAX script prints them.

    From rest, 50 steps move E by ~1e-6 relative (KE ≈ 9.6e-8 against |E|
    ≈ 0.06), so E alone cannot tell a chunk that stepped from one that did
    not, or that stepped with flipped forces. The state each energy reads
    is therefore held against the JAX state too: KE > 0, KE within
    relative 1e-3 and velocities within 1e-3·max|v| (they agree to ~1e-7
    and ~3e-7; the room is for the two engines' f32 summation order)."""
    import nbody_tpu_torch.drift as drift

    seen = []

    def spy(state):
        seen.append(state)
        return ke(state)

    ke = drift.kinetic_energy
    monkeypatch.setattr(drift, "kinetic_energy", spy)
    pos, mass = _henon_state()
    state = ParticleState.from_numpy(pos, np.zeros((N, 3)), None, mass,
                                     device="cpu")
    recs = list(run_drift(N, STEPS, STEPS, device="cpu", levels=LEVELS,
                          state=state))
    assert len(seen) == 2
    assert [r["step"] for r in recs] == [0, STEPS]
    assert set(recs[0]) == {"step", "E", "rel_drift", "pe_secs"}
    assert set(recs[1]) == {"step", "E", "rel_drift", "pe_secs",
                            "steps_per_sec"}
    want0, want1, jend = _jax_sequence(pos, mass)
    np.testing.assert_allclose(recs[0]["E"], want0, rtol=1e-5)
    np.testing.assert_allclose(recs[1]["E"], want1, rtol=1e-5)
    got_ke, want_ke = float(ke(seen[1])), float(jax_ke(jend))
    assert got_ke > 0.0 and want_ke > 0.0
    np.testing.assert_allclose(got_ke, want_ke, rtol=1e-3)
    vel, jvel = seen[1].vel.numpy(), np.asarray(jend.vel)
    assert np.abs(vel - jvel).max() <= 1e-3 * np.abs(jvel).max()
    np.testing.assert_allclose(float(seen[1].time), float(jend.time),
                               rtol=1e-6)
    jax_drift = abs((want1 - want0) / want0)
    assert recs[1]["rel_drift"] < 1e-4 and jax_drift < 1e-4
    line = drift_metric(N, STEPS, recs[-1])
    assert line == {"metric": "abs_rel_energy_drift_1k_bh_50steps",
                    "value": recs[1]["rel_drift"], "target": 1e-4,
                    "pass": True}


def test_drift_config_follows_the_jax_script():
    """bh_max_level 6 above 300k particles, else 5; dt 1e-3; Barnes-Hut."""
    assert drift_config(1_000_000).bh_max_level == 6
    assert drift_config(300_000).bh_max_level == 5
    cfg = drift_config(1024, levels=3)
    assert (cfg.bh_max_level, cfg.dt, cfg.force_method.name) == (
        3, 1e-3, "BARNES_HUT")


def test_run_drift_defaults_to_the_card():
    """With no device the measurement means the card: without one it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        next(run_drift(64, 1, 1))
