"""Re-sort cadence and audited re-sort stepping of nbody_tpu_torch against
the JAX package's ``make_resort_multi_step`` / ``make_adaptive_multi_step``
(CPU).

Both packages step the same toy sorted engine with the frozen-grid
contract, written once for each in float64: softened direct forces; rows
sorted (stably) by their cell id on a fixed 8³ binning of cell 1.0; the
frozen form evaluates the moved rows in place and audits the rows whose
cell id changed. Then, port only, the identities between the integrators
and the facade's choice among them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import integrator as jint
from nbody_tpu.ops.sorted_window import FrozenGridMeta as JMeta
from nbody_tpu.state import ParticleState as JState
from nbody_tpu_torch import ParticleSystem
from nbody_tpu_torch.ops import integrator as tint
from nbody_tpu_torch.ops.sorted_window import FrozenGridMeta as TMeta
from nbody_tpu_torch.state import ParticleState as TState
from nbody_tpu_torch.types import ForceMethod, SimulationConfig

N, D, CELL, LO, EPS2, DT = 256, 8, 1.0, -4.0, 0.01, 1e-2


def _np_state(seed=5):
    rng = np.random.default_rng(seed)
    return dict(pos=rng.uniform(-3.5, 3.5, (N, 3)),
                vel=rng.normal(0.0, 0.6, (N, 3)),
                mass=rng.uniform(0.5, 1.5, N) * 1e-3)


def _jax_engine():
    def ids_of(pos):
        c = jnp.clip(jnp.floor((pos - LO) / CELL).astype(jnp.int32), 0,
                     D - 1)
        return (c[:, 0] * D + c[:, 1]) * D + c[:, 2]

    def forces(pos, mass):
        dv = pos[None, :, :] - pos[:, None, :]
        w = mass[None, :] * ((dv * dv).sum(-1) + EPS2) ** -1.5
        return (w[..., None] * dv).sum(1)

    def with_meta(pos, mass):
        ids = ids_of(pos)
        order = jnp.argsort(ids)
        psort = jnp.concatenate([pos, mass[:, None]], axis=-1)[order]
        meta = JMeta(ids=ids[order], rank=jnp.zeros(N, jnp.int32),
                     lo=jnp.full(3, LO), cell=jnp.asarray(CELL))
        return forces(psort[:, :3], psort[:, 3]), psort, order, meta

    def sorted_fn(pos, mass, extra=None):
        return with_meta(pos, mass)[:3]

    def frozen(psort, meta, with_audit=False):
        acc = forces(psort[:, :3], psort[:, 3])
        if not with_audit:
            return acc
        return acc, jnp.sum(ids_of(psort[:, :3]) != meta.ids)

    sorted_fn.with_meta, sorted_fn.frozen = with_meta, frozen
    return sorted_fn


def _torch_engine():
    def ids_of(pos):
        c = torch.clamp(torch.floor((pos - LO) / CELL).to(torch.int32), 0,
                        D - 1)
        return (c[:, 0] * D + c[:, 1]) * D + c[:, 2]

    def forces(pos, mass):
        dv = pos[None, :, :] - pos[:, None, :]
        w = mass[None, :] * ((dv * dv).sum(-1) + EPS2) ** -1.5
        return (w[..., None] * dv).sum(1)

    def with_meta(pos, mass):
        ids = ids_of(pos)
        order = torch.argsort(ids, stable=True)
        psort = torch.cat([pos, mass[:, None]], dim=-1)[order]
        meta = TMeta(ids=ids[order], rank=torch.zeros(N, dtype=torch.int32),
                     lo=torch.full((3,), LO, dtype=torch.float64),
                     cell=torch.tensor(CELL, dtype=torch.float64),
                     cell_start=None)
        return forces(psort[:, :3], psort[:, 3]), psort, order, meta

    def sorted_fn(pos, mass):
        return with_meta(pos, mass)[:3]

    def frozen(psort, meta, with_audit=False):
        acc = forces(psort[:, :3], psort[:, 3])
        if not with_audit:
            return acc
        return acc, (ids_of(psort[:, :3]) != meta.ids).sum()

    sorted_fn.with_meta, sorted_fn.frozen = with_meta, frozen
    return sorted_fn


def _states():
    s = _np_state()
    jf, tf = _jax_engine(), _torch_engine()
    jpos, jmass = jnp.asarray(s["pos"]), jnp.asarray(s["mass"])
    acc0 = jf.with_meta(jpos, jmass)[0][jnp.argsort(jf(jpos, jmass)[2])]
    js = JState(pos=jpos, vel=jnp.asarray(s["vel"]), acc=acc0, mass=jmass,
                time=jnp.asarray(0.0))
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    ts = TState(pos=t["pos"], vel=t["vel"], acc=torch.from_numpy(
        np.array(acc0)), mass=t["mass"],
        time=torch.tensor(0.0, dtype=torch.float64))
    return jf, js, tf, ts


def _close(t, j, what):
    """States within rtol 1e-12 / atol 1e-12·max|x| (float64; XLA and
    torch may order the force sums differently)."""
    for f in ("pos", "vel", "acc", "mass"):
        want = np.asarray(getattr(j, f))
        np.testing.assert_allclose(
            getattr(t, f).numpy(), want, rtol=1e-12,
            atol=1e-12 * float(np.abs(want).max()), err_msg=f"{what}: {f}")
    assert float(t.time) == pytest.approx(float(j.time), abs=1e-15)


@pytest.mark.parametrize("steps,cadence", [(11, 4), (8, 1), (3, 5)])
def test_resort_multi_step_matches_jax(steps, cadence):
    """Chunks of ``cadence`` (⌊n/c⌋ and a remainder), each starting with a
    sorted step, as the JAX integrator runs them."""
    jf, js, tf, ts = _states()
    want = jax.jit(jint.make_resort_multi_step(jf, DT, steps, cadence))(js)
    got = tint.make_resort_multi_step(tf, DT, steps, cadence)(ts)
    _close(got, want, f"resort {steps}/{cadence}")


@pytest.mark.parametrize("frac,cap", [(0.02, 16), (0.0, 3), (0.05, 4)])
def test_adaptive_trace_matches_jax(frac, cap):
    """The audited re-sort (with its one-step lag) gives the JAX trace
    exactly — stale counts and re-sort flags — and the same state."""
    jf, js, tf, ts = _states()
    steps = 14
    want, (jst, jre) = jax.jit(jint.make_adaptive_multi_step(
        jf, DT, steps, max_stale_frac=frac, max_cadence=cap,
        with_trace=True))(js)
    got, (tst, tre) = tint.make_adaptive_multi_step(
        tf, DT, steps, max_stale_frac=frac, max_cadence=cap,
        with_trace=True)(ts)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tre.numpy(), np.asarray(jre))
    assert tre.any() and (~tre).any(), (tst, tre)
    assert tst.dtype == torch.int32 and tre.dtype == torch.bool
    _close(got, want, f"adaptive {frac}/{cap}")


def _equal(a, b):
    for f in ("pos", "vel", "acc", "mass", "time"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_cadence_one_is_sorted_stepping():
    _, _, tf, ts = _states()
    _equal(tint.make_resort_multi_step(tf, DT, 7, 1)(ts),
           tint.make_sorted_multi_step(tf, DT, 7)(ts))


def test_adaptive_max_cadence_one_is_cadence_one():
    _, _, tf, ts = _states()
    _equal(tint.make_adaptive_multi_step(tf, DT, 7, max_stale_frac=0.0,
                                         max_cadence=1)(ts),
           tint.make_resort_multi_step(tf, DT, 7, 1)(ts))


def test_stale_frac_one_is_fixed_cadence():
    """Staleness never triggers: the fixed cadence ``max_cadence``, bit
    for bit (the audited frozen step computes the same forces)."""
    _, _, tf, ts = _states()
    _equal(tint.make_adaptive_multi_step(tf, DT, 11, max_stale_frac=1.0,
                                         max_cadence=3)(ts),
           tint.make_resort_multi_step(tf, DT, 11, 3)(ts))


def test_bad_parameters_raise():
    _, _, tf, _ = _states()
    with pytest.raises(ValueError, match="resort_every"):
        tint.make_resort_multi_step(tf, DT, 4, 0)
    with pytest.raises(ValueError, match="max_stale_frac"):
        tint.make_adaptive_multi_step(tf, DT, 4, max_stale_frac=1.5)
    with pytest.raises(ValueError, match="max_cadence"):
        tint.make_adaptive_multi_step(tf, DT, 4, max_cadence=0)
    with pytest.raises(ValueError, match="frozen-grid contract"):
        tint.make_resort_multi_step(lambda p, m: None, DT, 4, 2)


def _hash_config(**kw):
    return SimulationConfig(
        particle_count=256, force_method=ForceMethod.SPATIAL_HASH,
        spatial_hash_cell_size=2.0, spatial_hash_cutoff=2.0,
        hash_engine="tiles", hash_max_grid_dim=8, hash_tile_k=8, dt=1e-3,
        seed=11, **kw)


@pytest.mark.parametrize(
    "knobs,integrator",
    [(dict(resort_every=4), "make_resort_multi_step"),
     (dict(resort_stale_frac=0.01), "make_adaptive_multi_step"),
     (dict(resort_stale_frac=0.01, resort_every=3),
      "make_adaptive_multi_step"),
     (dict(), "make_sorted_multi_step")],
    ids=["cadence", "stale_frac", "stale_frac_capped", "every_step"])
def test_facade_runs_the_integrator_the_jax_rule_names(knobs, integrator):
    """On the hash tiles engine (d 8, k 8: the frozen contract holds) the
    facade takes the audited re-sort when ``resort_stale_frac > 0`` (cap
    ``resort_every``, else 16), else the cadence when ``resort_every > 1``,
    else a sort every step — the JAX facade's rule off the TPU."""
    ps = ParticleSystem()
    ps.initialize(_hash_config(**knobs), device="cpu")
    assert hasattr(ps._sorted_force, "frozen")
    assert hasattr(ps._sorted_force, "with_meta")
    assert ps._multi_step(5).__qualname__.startswith(integrator + ".")


@pytest.mark.parametrize(
    "knobs,direct",
    [(dict(resort_every=4),
      lambda sf: tint.make_resort_multi_step(sf, 1e-3, 5, 4)),
     (dict(resort_stale_frac=0.01),
      lambda sf: tint.make_adaptive_multi_step(
          sf, 1e-3, 5, max_stale_frac=0.01, max_cadence=16))],
    ids=["cadence", "stale_frac"])
def test_facade_steps_as_a_direct_call(knobs, direct):
    """run_steps(5) on the hash tiles engine equals a direct call of the
    integrator the rule names, bit for bit (a chunk of 4 and a remainder
    chunk; the audited re-sort at cap ⌊0.01·256⌋ = 2 rows)."""
    ps = ParticleSystem()
    ps.initialize(_hash_config(**knobs), device="cpu")
    want = direct(ps._sorted_force)(ps.state)
    ps.run_steps(5)
    _equal(ps.state, want)


def test_resort_repair_still_raises():
    with pytest.raises(NotImplementedError, match="resort_repair"):
        ParticleSystem().initialize(_hash_config(resort_repair=True),
                                    device="cpu")
