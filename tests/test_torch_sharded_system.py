"""``shard_devices`` through the nbody_tpu_torch facade and CLI (CPU).

The port's counterpart of tests/test_sharded_system.py: ``ParticleSystem``
with ``shard_devices`` P > 1 on ``device="cpu"`` runs on P virtual shards
of the CPU, and must match a single-device system as the JAX facade's
tests hold it (pos and vel within atol 1e-5 on direct N², energies within
1e-4 relative), with the padding invisible. One case holds the sharded
facade against the JAX package's sharded facade on the conftest's virtual
devices, from one shared state.
"""

import numpy as np
import pytest

import nbody_tpu as jnb
from nbody_tpu.state import SimulationState as JSnapshot
from nbody_tpu_torch import app as tapp
from nbody_tpu_torch import cli as tcli
from nbody_tpu_torch.state import SimulationState
from nbody_tpu_torch.system import ParticleSystem
from nbody_tpu_torch.types import ForceMethod, SimulationConfig
from nbody_tpu_torch.utils.serialization import Serializer


def _run(devices: int, n: int = 256, steps: int = 5,
         **kw) -> ParticleSystem:
    s = ParticleSystem()
    s.initialize(SimulationConfig(particle_count=n, dt=1e-3,
                                  shard_devices=devices, seed=7, **kw),
                 device="cpu")
    s.run_steps(steps)
    return s


@pytest.fixture(scope="module")
def single():
    """Single-device systems, by (n, steps)."""
    return {(n, steps): _run(1, n=n, steps=steps)
            for n, steps in ((256, 5), (250, 2))}


def test_initialize_builds_mesh():
    s = _run(8, steps=0)
    assert s.is_sharded and s.mesh.size == 8
    assert all(d.type == "cpu" for d in s.mesh.devices)
    diag = s.diagnostics()
    assert diag["shard_devices"] == 8
    assert diag["force_distribution"] == "ring"
    assert not _run(1, steps=0).is_sharded


@pytest.mark.parametrize("devices", [2, 4, 8])
def test_run_steps_matches_single_device(devices, single):
    s, s1 = _run(devices), single[(256, 5)]
    assert s.mesh.size == devices
    np.testing.assert_allclose(s.positions(), s1.positions(), atol=1e-5)
    np.testing.assert_allclose(s.velocities(), s1.velocities(), atol=1e-5)
    assert abs(s.simulation_time - s1.simulation_time) < 1e-7


def test_update_matches_single_device():
    s8, s1 = _run(8, steps=0), _run(1, steps=0)
    for _ in range(3):
        s8.update()
        s1.update()
    np.testing.assert_allclose(s8.positions(), s1.positions(), atol=1e-5)
    np.testing.assert_allclose(s8.velocities(), s1.velocities(), atol=1e-5)


def test_padding_is_invisible():
    """N = 250 on 8 shards pads to 256 inside; every public surface
    reports the 250 logical rows."""
    s = _run(8, n=250, steps=2)
    assert s.particle_count == 250
    assert s.positions().shape == (250, 3)
    assert s.velocities().shape == (250, 3)
    assert s.state.n == 256
    snap = s.get_state()
    assert snap.particle_count == 250 and snap.mass.shape == (250,)


def test_energy_matches_single_device(single):
    s8, s1 = _run(8, n=250, steps=2), single[(250, 2)]
    e8, e1 = s8.compute_total_energy(), s1.compute_total_energy()
    assert abs(e8 - e1) / abs(e1) < 1e-4
    ke8, ke1 = s8.compute_kinetic_energy(), s1.compute_kinetic_energy()
    assert abs(ke8 - ke1) <= 1e-5 * max(1.0, abs(ke1))
    pe8, pe1 = s8.compute_potential_energy(), s1.compute_potential_energy()
    assert abs(pe8 - pe1) / abs(pe1) < 1e-5


def test_save_load_stays_sharded(tmp_path):
    """save/load run sharded; the file holds the logical rows only."""
    path = str(tmp_path / "sharded.nbody")
    s8 = _run(8, n=250, steps=2)
    s8.save_state(path)
    assert Serializer.load(path).particle_count == 250
    fresh = ParticleSystem()
    fresh._config = SimulationConfig(shard_devices=8)
    fresh.load_state(path, device="cpu")
    assert fresh.is_sharded and fresh.particle_count == 250
    np.testing.assert_allclose(fresh.positions(), s8.positions(), atol=1e-6)


def test_reset_stays_sharded():
    s = _run(4, steps=2)
    s.reset()
    assert s.is_sharded and s.particle_count == 256
    assert s.simulation_time == 0.0


def test_audit_matches_single_device():
    """The audit runs on the gathered logical rows with the single-device
    engines and counts what the single-device audit counts."""
    cfg = dict(particle_count=256, force_method=ForceMethod.SPATIAL_HASH,
               hash_max_grid_dim=8, seed=7)
    a = []
    for p in (8, 1):
        s = ParticleSystem()
        s.initialize(SimulationConfig(shard_devices=p, **cfg), device="cpu")
        a.append(s.audit_short_range())
    assert a[0]["method"] == "spatial-hash"
    assert a[0] == a[1]


def test_tree_slabs_through_the_facade():
    """Barnes-Hut at bh_max_level 3 over 4 shards runs the tree-slabs
    path; two steps match the single-device tiles engine (its cell-sorted
    stepping) within atol 1e-5, and the set_theta rebuild stays
    sharded."""
    kw = dict(n=200, steps=2, force_method=ForceMethod.BARNES_HUT,
              bh_max_level=3)
    s4, s1 = _run(4, **kw), _run(1, **kw)
    assert s4.diagnostics()["force_distribution"] == "tree-slabs"
    np.testing.assert_allclose(s4.positions(), s1.positions(), atol=1e-5)
    np.testing.assert_allclose(s4.velocities(), s1.velocities(), atol=1e-5)
    s4.set_theta(0.7)
    assert s4.diagnostics()["force_distribution"] == "tree-slabs"


def test_sharded_facade_matches_jax_facade():
    """Both facades sharded over 4 from one shared state (set_state), then
    run_steps(3) of direct N² (the JAX ring and the port's ring on K1's
    twin): pos and vel within atol 1e-5, energies within 1e-5."""
    rng = np.random.default_rng(17)
    pos = rng.uniform(-3, 3, (200, 3)).astype(np.float32)
    vel = rng.normal(0, 0.2, (200, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, 200).astype(np.float32)
    common = dict(dt=1e-3, G=1.0, softening=0.1)
    js = jnb.ParticleSystem()
    js._config = jnb.SimulationConfig(shard_devices=4)
    js.set_state(JSnapshot(pos=pos, vel=vel, mass=mass,
                           force_method=jnb.ForceMethod.DIRECT_N2, **common))
    ts = ParticleSystem()
    ts._config = SimulationConfig(shard_devices=4)
    ts.set_state(SimulationState(pos=pos, vel=vel, mass=mass,
                                 force_method=ForceMethod.DIRECT_N2,
                                 **common), device="cpu")
    assert js.is_sharded and ts.is_sharded
    js.run_steps(3)
    ts.run_steps(3)
    np.testing.assert_allclose(ts.positions(), js.positions(), atol=1e-5)
    np.testing.assert_allclose(ts.velocities(), js.velocities(), atol=1e-5)
    np.testing.assert_allclose(ts.compute_total_energy(),
                               js.compute_total_energy(), rtol=1e-5)
    assert ts.state.n == js.state.n == 200


class TestShardedCli:
    def _app(self, argv):
        return tapp.Application(tcli.parse_app_cli_options(argv),
                                device="cpu")

    def test_devices_match_single_through_the_cli(self, capsys, tmp_path):
        """``--devices 4`` and ``--devices 1`` export the same physics."""
        paths = {}
        for dev in (4, 1):
            paths[dev] = str(tmp_path / f"s{dev}.nbody")
            app = self._app(["--particles", "250", "--method", "direct-n2",
                             "--devices", str(dev), "--benchmark",
                             "--benchmark-steps", "3", "--export",
                             paths[dev]])
            assert app.run() == 0
            capsys.readouterr()
        a, b = Serializer.load(paths[4]), Serializer.load(paths[1])
        assert a.particle_count == b.particle_count == 250
        np.testing.assert_allclose(a.pos, b.pos, atol=1e-5)
        np.testing.assert_allclose(a.vel, b.vel, atol=1e-5)
