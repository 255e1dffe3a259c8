"""nbody_tpu_torch facade, initializers and package boundary (CPU)."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu as jnb
import nbody_tpu_torch as tnb
from nbody_tpu_torch.errors import validate_resource_requirements
from nbody_tpu.state import SimulationState as JSnapshot
from nbody_tpu_torch.models.distributions import init_spherical, init_uniform
from nbody_tpu_torch.state import SimulationState, config_from_reference
from nbody_tpu_torch.types import (
    ForceMethod,
    InitDistribution,
    SimulationConfig,
    SphericalDistParams,
    UniformDistParams,
)

REPO = Path(__file__).resolve().parents[1]


def _uniform_snapshot(n, half, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-half, half, (n, 3)).astype(np.float32)
    vel = rng.normal(0.0, 0.05, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return pos, vel, mass


def test_facade_matches_jax_facade():
    """Both facades from one shared uniform state (n = 500 at levels = 2:
    no cell overflows its k slots), then 2 × update() and run_steps(2): the
    JAX facade steps plainly with XLA forces on CPU, the port steps
    cell-sorted in run_steps. Tolerances as the sorted-vs-plain gate of
    the JAX package (pos rtol 2e-4 / atol 1e-5, vel rtol 2e-3 / atol
    1e-4)."""
    pos, vel, mass = _uniform_snapshot(500, 4.0, seed=21)
    kw = dict(particle_count=500, dt=1e-3, G=1.0, softening=0.1)
    jcfg = jnb.SimulationConfig(force_method=jnb.ForceMethod.BARNES_HUT,
                                bh_max_level=2, **kw)
    js = jnb.ParticleSystem()
    js.initialize(jcfg)
    js.set_state(JSnapshot(pos=pos, vel=vel, mass=mass,
                           force_method=jnb.ForceMethod.BARNES_HUT, **{
                               "dt": 1e-3, "G": 1.0, "softening": 0.1}))
    ts = tnb.ParticleSystem()
    ts.initialize(config_from_reference(jcfg), device="cpu")
    ts.set_state(SimulationState(pos=pos, vel=vel, mass=mass,
                                 force_method=ForceMethod.BARNES_HUT,
                                 dt=1e-3, G=1.0, softening=0.1))
    from nbody_tpu_torch.ops.barnes_hut import bh_engine_params, bin_particles
    from nbody_tpu_torch.ops.sorted_window import cell_ids

    coords = bin_particles(torch.from_numpy(pos), 2)[2]
    occupancy = torch.bincount(cell_ids(coords, 4)).max()
    assert occupancy <= bh_engine_params(ts.config)["near_k"]
    for s in (js, ts):
        s.update()
        s.update()
        s.run_steps(2)
    assert abs(ts.simulation_time - js.simulation_time) < 1e-6
    np.testing.assert_allclose(ts.positions(), js.positions(),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(ts.velocities(), js.velocities(),
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(ts.compute_kinetic_energy(),
                               js.compute_kinetic_energy(), rtol=1e-4)
    np.testing.assert_allclose(ts.compute_potential_energy(),
                               js.compute_potential_energy(), rtol=1e-5)


def _ball_snapshot(n, radius, seed):
    rng = np.random.default_rng(seed)
    r = np.cbrt(rng.uniform(size=n)) * radius
    v = rng.normal(size=(n, 3))
    pos = (v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None])
    vel = rng.normal(0.0, 0.05, (n, 3))
    mass = rng.uniform(0.5, 1.5, n)
    return (pos.astype(np.float32), vel.astype(np.float32),
            mass.astype(np.float32))


def _assert_jax_audit(audit, want, n):
    """The port's audit holds the JAX facade's keys at the JAX facade's
    values but for the window engine's window: every row, ``n``, at
    ``hash_window`` 0, where the JAX facade's 1024 covers these scenes (its
    overflow 0), so both sweep the same pairs. The window engine adds the
    block (the JAX package's) and no row dropped since the state was
    set."""
    if want.get("engine") == "window":
        assert want["overflow"] == 0
        want = {**want, "window": n}
    assert {k: audit[k] for k in want} == want
    extra = {k: v for k, v in audit.items() if k not in want}
    if want.get("engine") == "window":
        assert extra == {"block": 128 if n <= 150_000 else 256,
                         "window_overflow_rows": 0}
    else:
        assert extra == {}


@pytest.mark.parametrize(
    "scene,cell,engine",
    [(lambda: _ball_snapshot(4096, 2.5, seed=31), 1.0, "window"),
     (lambda: _uniform_snapshot(4096, 8.0, seed=32), 2.0, "tiles")],
    ids=["dense", "sparse"])
def test_hash_facade_matches_jax_facade(scene, cell, engine):
    """The spatial hash through both facades from one numpy state at
    n = 4096 (``hash_engine="auto"`` resolves window on the dense ball,
    tiles on the sparse cube): run_steps(5) in sorted order on both,
    positions within rtol 2e-4 / atol 1e-5 and velocities within rtol 2e-3
    / atol 1e-4 (the sorted-vs-plain gate of the JAX package), and
    audit_short_range() dicts equal but for the window engine's window and
    the port's added keys (``_assert_jax_audit``: engine, overflow, window /
    tile_d, tile_k)."""
    pos, vel, mass = scene()
    kw = dict(particle_count=4096, dt=1e-3, G=1.0, softening=0.1)
    jcfg = jnb.SimulationConfig(force_method=jnb.ForceMethod.SPATIAL_HASH,
                                spatial_hash_cell_size=cell, **kw)
    js = jnb.ParticleSystem()
    js.initialize(jcfg)
    js.set_state(JSnapshot(pos=pos, vel=vel, mass=mass,
                           force_method=jnb.ForceMethod.SPATIAL_HASH,
                           dt=1e-3, G=1.0, softening=0.1))
    ts = tnb.ParticleSystem()
    ts.initialize(config_from_reference(jcfg), device="cpu")
    ts.set_state(SimulationState(pos=pos, vel=vel, mass=mass,
                                 force_method=ForceMethod.SPATIAL_HASH,
                                 dt=1e-3, G=1.0, softening=0.1))
    for s in (js, ts):
        s.run_steps(5)
    assert abs(ts.simulation_time - js.simulation_time) < 1e-6
    np.testing.assert_allclose(ts.positions(), js.positions(),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(ts.velocities(), js.velocities(),
                               rtol=2e-3, atol=1e-4)
    audit = ts.audit_short_range()
    _assert_jax_audit(audit, js.audit_short_range(), 4096)
    assert audit["engine"] == engine


def test_barnes_hut_window_engine_through_the_facade():
    """BH at n = 20000, bh_max_level = 3 (occupancy 39 > 24: the window
    near engine): a(t=0) from set_state within atol 2e-5·max|a| of the
    JAX package's ``barnes_hut_forces(near_engine="window")`` (XLA path)
    on every row, the audit's keys as the JAX facade's with no window
    overflow at W 2048, and run_steps(2) stepping in original order (no
    sorted contract)."""
    from nbody_tpu.ops import barnes_hut as jbh

    pos, vel, mass = _ball_snapshot(20000, 6.0, seed=33)
    ts = tnb.ParticleSystem()
    ts.initialize(SimulationConfig(particle_count=100,
                                   force_method=ForceMethod.BARNES_HUT,
                                   bh_max_level=3), device="cpu")
    ts.set_state(SimulationState(pos=pos, vel=vel, mass=mass,
                                 force_method=ForceMethod.BARNES_HUT,
                                 dt=1e-3, G=1.0, softening=0.1))
    want = np.asarray(jbh.barnes_hut_forces(
        jnp.asarray(pos), jnp.asarray(mass), 1.0, 0.1, 0.5, levels=3,
        window=2048, near_engine="window", near_impl="xla"))
    np.testing.assert_allclose(ts.state.acc.numpy(), want, rtol=0,
                               atol=2e-5 * float(np.abs(want).max()))
    assert ts.audit_short_range() == {
        "method": "barnes-hut", "overflow": 0, "window": 2048,
        "near_engine": "window"}
    assert ts._sorted_force is None
    ts.run_steps(2)
    assert abs(ts.simulation_time - 2e-3) < 1e-7
    assert np.isfinite(ts.positions()).all()


def test_bare_initialize_means_the_card():
    """``ParticleSystem().initialize(cfg)`` and a first ``set_state`` with
    no device target CUDA: without a card they raise, never run quietly on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    cfg = SimulationConfig(particle_count=64)
    with pytest.raises(RuntimeError, match="cuda"):
        tnb.ParticleSystem().initialize(cfg)
    pos, vel, mass = _uniform_snapshot(64, 1.0, seed=34)
    with pytest.raises(RuntimeError, match="cuda"):
        tnb.ParticleSystem().set_state(SimulationState(
            pos=pos, vel=vel, mass=mass, force_method=ForceMethod.DIRECT_N2,
            dt=1e-3, G=1.0, softening=0.1))
    with pytest.raises(RuntimeError):
        validate_resource_requirements(64)


def test_pause_resume_reset_and_state_round_trip():
    cfg = SimulationConfig(particle_count=300,
                           force_method=ForceMethod.BARNES_HUT,
                           bh_max_level=3)
    s = tnb.ParticleSystem()
    s.initialize(cfg, device="cpu")
    p0 = s.positions()
    s.pause()
    s.update()
    s.run_steps(3)
    assert s.is_paused and s.simulation_time == 0.0
    np.testing.assert_array_equal(s.positions(), p0)
    s.resume()
    s.run_steps(2)
    s.update()
    assert abs(s.simulation_time - 3e-3) < 1e-7
    snap = s.get_state()
    assert snap == s.get_state() and snap.particle_count == 300
    s.reset()
    assert s.simulation_time == 0.0
    np.testing.assert_array_equal(s.positions(), p0)
    s.set_state(snap)
    np.testing.assert_array_equal(s.positions(), snap.pos)
    assert abs(s.simulation_time - 3e-3) < 1e-7
    assert np.isfinite(s.compute_total_energy())


def test_requires_initialize():
    s = tnb.ParticleSystem()
    with pytest.raises(tnb.ValidationError):
        s.update()


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        tnb.ParticleSystem().initialize(SimulationConfig(particle_count=10),
                                        device="cuda")


@pytest.mark.parametrize(
    "change,sharded",
    [(dict(shard_devices=2), True),
     (dict(init_distribution=InitDistribution.DISK), False)],
    ids=["shard", "disk"],
)
def test_shard_and_disk_initialize_on_cpu(change, sharded):
    """``shard_devices=2`` on the CPU builds a mesh of 2 virtual shards
    (finite a(t=0) on the 64 logical rows); the disk distribution builds
    its state on the CPU (a unit-thickness disk of radius 10, finite
    a(t=0))."""
    cfg = SimulationConfig(particle_count=64, **change)
    s = tnb.ParticleSystem()
    s.initialize(cfg, device="cpu")
    if sharded:
        assert s.is_sharded and s.mesh.size == 2
        assert s.particle_count == s.state.n == 64
        assert torch.isfinite(s.state.acc).all()
        assert s.diagnostics()["shard_devices"] == 2
        return
    pos = s.positions()
    assert pos.shape == (64, 3) and np.abs(pos[:, 2]).max() <= 0.5
    assert np.hypot(pos[:, 0], pos[:, 1]).max() <= 10.0 * (1 + 1e-6)
    assert torch.isfinite(s.state.acc).all()


@pytest.mark.parametrize(
    "change",
    [dict(force_method=ForceMethod.SPATIAL_HASH, resort_repair=True),
     dict(resort_every=4, resort_repair=True),
     dict(resort_stale_frac=0.1, resort_repair=True),
     dict(resort_repair=True)],
    ids=["hash", "resort_every", "stale_frac", "repair"],
)
def test_resort_repair_configs_match_the_jax_facade(change):
    """``resort_repair``, alone or with a cadence or a stale fraction, on
    either method, is accepted. On the CPU the facade takes the JAX
    facade's off-accelerator route (table stepping runs on the card only)
    and gives its state: both facades from one numpy state (n = 64, the
    config's defaults otherwise), run_steps(3), positions within rtol 2e-4
    / atol 1e-5 and velocities within rtol 2e-3 / atol 1e-4 (the
    sorted-vs-plain gate, as the facade tests above)."""
    pos, vel, mass = _uniform_snapshot(64, 4.0, seed=35)
    tcfg = SimulationConfig(particle_count=64, **change)
    ts = tnb.ParticleSystem()
    ts.initialize(tcfg, device="cpu")
    assert ts._table_params is None
    jcfg = jnb.SimulationConfig(particle_count=64, **{
        k: (jnb.ForceMethod.SPATIAL_HASH if k == "force_method" else v)
        for k, v in change.items()})
    assert config_from_reference(jcfg) == tcfg
    js = jnb.ParticleSystem()
    js.initialize(jcfg)
    snap = dict(pos=pos, vel=vel, mass=mass, dt=1e-3, G=1.0, softening=0.1)
    js.set_state(JSnapshot(force_method=jcfg.force_method, **snap))
    ts.set_state(SimulationState(force_method=tcfg.force_method, **snap))
    for s in (js, ts):
        s.run_steps(3)
    assert abs(ts.simulation_time - js.simulation_time) < 1e-6
    np.testing.assert_allclose(ts.positions(), js.positions(), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ts.velocities(), js.velocities(), rtol=2e-3,
                               atol=1e-4)


def test_config_defaults_match_jax():
    """Every field of the JAX default config maps onto the port's default."""
    assert config_from_reference(jnb.SimulationConfig()) == SimulationConfig()
    j = jnb.SimulationConfig(
        force_method=jnb.ForceMethod.BARNES_HUT, particle_count=7,
        dist_params=jnb.SphericalDistParams(radius=3.0))
    t = config_from_reference(j)
    assert t.force_method == ForceMethod.BARNES_HUT
    assert t.dist_params == SphericalDistParams(radius=3.0)


def _ks_uniform(u):
    """Kolmogorov-Smirnov distance of samples u from U[0, 1]."""
    u = np.sort(u)
    n = u.size
    grid = np.arange(1, n + 1) / n
    return max(np.max(grid - u), np.max(u - (grid - 1.0 / n)))


def test_spherical_statistics():
    """Radii within R, (r/R)³ uniform (KS distance < 0.015 at n = 20000:
    the 1% critical value is 1.63/√n = 0.0115), centre of mass near 0."""
    g = torch.Generator()
    g.manual_seed(1)
    R = 5.0
    s = init_spherical(g, 20_000, SphericalDistParams(radius=R))
    pos = s.pos.numpy().astype(np.float64)
    r = np.linalg.norm(pos, axis=1)
    assert r.max() <= R * (1 + 1e-6)
    assert _ks_uniform((r / R) ** 3) < 0.015
    assert np.abs(pos.mean(axis=0)).max() < 0.05 * R
    assert (s.vel.numpy() == 0).all() and (s.mass.numpy() == 1).all()


def test_uniform_statistics_and_seed():
    g = torch.Generator()
    g.manual_seed(2)
    params = UniformDistParams(min_bounds=(-1.0, 0.0, 2.0),
                               max_bounds=(1.0, 4.0, 3.0),
                               min_mass=0.5, max_mass=2.0)
    s = init_uniform(g, 20_000, params)
    pos = s.pos.numpy().astype(np.float64)
    lo, hi = np.array(params.min_bounds), np.array(params.max_bounds)
    assert (pos >= lo).all() and (pos <= hi).all()
    for ax in range(3):
        assert _ks_uniform((pos[:, ax] - lo[ax]) / (hi[ax] - lo[ax])) < 0.015
    m = s.mass.numpy()
    assert m.min() >= 0.5 and m.max() <= 2.0
    g2 = torch.Generator()
    g2.manual_seed(2)
    assert torch.equal(init_uniform(g2, 20_000, params).pos, s.pos)


def test_package_imports_neither_jax_nor_reference():
    """Importing every module of nbody_tpu_torch leaves jax and nbody_tpu
    out of sys.modules (checked in a fresh interpreter)."""
    mods = [m.name for m in pkgutil.walk_packages(tnb.__path__,
                                                  "nbody_tpu_torch.")]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'nbody_tpu' or m.startswith('nbody_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 15


def test_profile_phase_records_and_propagates_errors():
    """A phase is recorded once per exit; an ImportError raised inside the
    body reaches the caller as itself (one yield path) and records nothing."""
    from nbody_tpu_torch.utils.profiling import PhaseProfiler, profile_phase

    prof = PhaseProfiler()
    for _ in range(2):
        with profile_phase("p", device="cpu", profiler=prof):
            pass
    with pytest.raises(ImportError, match="inner"):
        with profile_phase("q", profiler=prof):
            raise ImportError("inner")
    snap = prof.consume()
    assert snap["p"].samples == 2 and "q" not in snap
    assert prof.consume() == {}


def _setter_pair(method, scene, **cfg):
    """Both facades from one numpy state (n = 256). The JAX facade takes
    its config straight from ``set_state`` (its ``initialize`` would only
    compile a state that is replaced)."""
    pos, vel, mass = scene
    snap = dict(pos=pos, vel=vel, mass=mass, dt=1e-3, G=1.0, softening=0.1)
    jcfg = jnb.SimulationConfig(particle_count=256,
                                force_method=jnb.ForceMethod[method], **cfg)
    js = jnb.ParticleSystem()
    js._config = jcfg
    js.set_state(JSnapshot(force_method=jcfg.force_method, **snap))
    ts = tnb.ParticleSystem()
    ts.initialize(config_from_reference(jcfg), device="cpu")
    ts.set_state(SimulationState(force_method=ForceMethod[method], **snap))
    return js, ts


SETTERS = [
    ("DIRECT_N2", "set_gravitational_constant", 2.0),
    ("DIRECT_N2", "set_softening", 0.05),
    ("DIRECT_N2", "set_theta", 0.9),
    ("DIRECT_N2", "set_force_method", "SPATIAL_HASH"),
    ("DIRECT_N2", "set_time_step", 2e-3),
    ("SPATIAL_HASH", "set_cell_size", 0.75),
    ("SPATIAL_HASH", "set_cutoff", 1.5),
    ("SPATIAL_HASH", "set_force_method", "DIRECT_N2"),
]


@pytest.mark.parametrize("method,setter,value", SETTERS,
                         ids=[f"{m}-{f}" for m, f, _ in SETTERS])
def test_setters_match_the_jax_facade(method, setter, value):
    """Each live setter on both facades from one state (n = 256: direct,
    the dense hash: a ball of radius 2.5, auto → window): the same config
    after it, a(t) right after it within
    1e-5·max|a| (recomputed by ``set_force_method``, kept by the parameter
    setters), then run_steps(3): positions within rtol 2e-4 / atol 1e-5 and
    velocities within rtol 2e-3 / atol 1e-4, the facade tests' tolerance."""
    js, ts = _setter_pair(method, _ball_snapshot(256, 2.5, seed=36))
    acc0 = ts.state.acc.clone()
    arg = value
    if setter == "set_force_method":
        getattr(js, setter)(jnb.ForceMethod[value])
        arg = ForceMethod[value]
    else:
        getattr(js, setter)(value)
    getattr(ts, setter)(arg)
    assert config_from_reference(js.config) == ts.config
    want = np.asarray(js.state.acc)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(ts.state.acc.numpy(), want, rtol=0,
                               atol=1e-5 * scale)
    if setter == "set_force_method":
        assert not torch.equal(ts.state.acc, acc0)
    else:
        assert torch.equal(ts.state.acc, acc0)
    for s in (js, ts):
        s.run_steps(3)
    assert abs(ts.simulation_time - js.simulation_time) < 1e-6
    np.testing.assert_allclose(ts.positions(), js.positions(), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ts.velocities(), js.velocities(), rtol=2e-3,
                               atol=1e-4)
    if ts.config.force_method == ForceMethod.SPATIAL_HASH:
        _assert_jax_audit(ts.audit_short_range(), js.audit_short_range(),
                          ts.particle_count)


def test_setters_validate_like_jax():
    s = tnb.ParticleSystem()
    s.initialize(SimulationConfig(particle_count=32), device="cpu")
    for setter, bad in (("set_gravitational_constant", 0.0),
                        ("set_softening", -1.0), ("set_theta", 3.0),
                        ("set_cell_size", 0.0), ("set_cutoff", -2.0),
                        ("set_time_step", 5.0)):
        with pytest.raises(tnb.ValidationError):
            getattr(s, setter)(bad)
    assert s.config == SimulationConfig(particle_count=32)


def test_save_load_state_and_diagnostics(tmp_path):
    """save_state then load_state on another system: pos, vel, mass bit
    for bit, the file's scalars, a(t) recomputed; the file loads in the
    JAX facade; ``diagnostics()`` has the JAX facade's keys."""
    pos, vel, mass = _uniform_snapshot(128, 3.0, seed=37)
    s = tnb.ParticleSystem()
    s.initialize(SimulationConfig(particle_count=128), device="cpu")
    s.set_state(SimulationState(pos=pos, vel=vel, mass=mass,
                                force_method=ForceMethod.DIRECT_N2,
                                dt=2e-3, G=1.5, softening=0.2))
    s.run_steps(2)
    path = str(tmp_path / "s.nbody")
    s.save_state(path)
    t = tnb.ParticleSystem()
    t.load_state(path, device="cpu")
    for a, b in ((t.state.pos, s.state.pos), (t.state.vel, s.state.vel),
                 (t.state.mass, s.state.mass)):
        assert torch.equal(a, b)
    assert (t.config.dt, t.config.G, t.config.softening) == (
        pytest.approx(2e-3), 1.5, pytest.approx(0.2))
    assert t.particle_count == 128 and abs(t.simulation_time - 4e-3) < 1e-6
    np.testing.assert_allclose(t.state.acc.numpy(), s.state.acc.numpy(),
                               rtol=1e-5, atol=1e-6)
    js = jnb.ParticleSystem()
    js.load_state(path)
    np.testing.assert_array_equal(js.positions(), s.positions())
    d = t.diagnostics()
    assert d.keys() == js.diagnostics().keys()
    assert (d["backend"], d["devices"], d["force_distribution"],
            d["particle_count"], d["state_bytes"]) == (
        "cpu", 1, "single-device", 128, 128 * 40)
