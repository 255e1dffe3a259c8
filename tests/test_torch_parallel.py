"""nbody_tpu_torch.parallel against nbody_tpu.parallel and against the
port's single-device engines (CPU).

The JAX side runs on a 4-device mesh of the conftest's 8 virtual CPU
devices, each function jitted once per module (module-scoped fixtures);
the port runs on a mesh of 4 virtual CPU shards (a repeated device), its
kernels' plain twins. Both get the same numpy inputs. Tolerances:
1e-4·max|a| on forces (f32 sums in another order), 1e-5 relative on
energies.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu.parallel as jpar
import nbody_tpu_torch.parallel as tpar
from nbody_tpu.state import ParticleState as JState
from nbody_tpu.types import SimulationConfig as JConfig
from nbody_tpu_torch.errors import ValidationError
from nbody_tpu_torch.ops.barnes_hut import barnes_hut_forces
from nbody_tpu_torch.ops.direct import (
    direct_forces_reference,
    pairwise_potential_cross,
    pairwise_potential_plain,
)
from nbody_tpu_torch.ops.spatial_hash import spatial_hash_forces
from nbody_tpu_torch.ops.tile_near import (
    tile_sweep_plane_plain,
    tile_sweep_slab,
)
from nbody_tpu_torch.parallel import distributed, mesh as M
from nbody_tpu_torch.parallel.step import (
    ReplicatedFallbackWarning,
    make_sharded_force_fn,
)
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.types import ForceMethod, SimulationConfig

N = 256
BH_KW = dict(G=1.0, softening=0.1, theta=0.5, levels=3, near_k=8)
HASH_KW = dict(G=1.0, softening=0.1, cutoff=1.5, cell_size=1.5, cap=8,
               max_per_cell=16)


def _ball(n, radius, seed):
    """A uniform ball: (pos, vel, mass) float32 numpy."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = u * radius * np.cbrt(rng.uniform(size=(n, 1)))
    vel = rng.normal(0.0, 0.3, (n, 3))
    mass = rng.uniform(0.5, 1.5, n)
    return (pos.astype(np.float32), vel.astype(np.float32),
            mass.astype(np.float32))


@pytest.fixture(scope="module")
def scene():
    return _ball(N, 4.0, seed=13)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 4, "conftest should fake 8 CPU devices"
    return jpar.make_mesh(4)


@pytest.fixture(scope="module")
def tmesh():
    return tpar.make_mesh(4, devices=["cpu"] * 4)


def _split(a, mesh):
    return M.split(torch.from_numpy(np.ascontiguousarray(a)), mesh)


def _gather(blocks):
    return M.gather(blocks).numpy()


def _close(got, want, rel=1e-4):
    np.testing.assert_allclose(
        got, want, rtol=0, atol=rel * float(np.abs(want).max()))


# ---- against the JAX package ------------------------------------------------


@pytest.fixture(scope="module")
def jax_ring(scene, jmesh):
    pos, _, mass = scene
    return np.asarray(jax.jit(lambda p, m: jpar.ring_direct_forces(
        p, m, jmesh, 1.0, 0.1))(jnp.asarray(pos), jnp.asarray(mass)))


def test_ring_matches_jax(scene, jax_ring, tmesh):
    pos, _, mass = scene
    got = tpar.ring_direct_forces(_split(pos, tmesh), _split(mass, tmesh),
                                  tmesh, 1.0, 0.1)
    _close(_gather(got), jax_ring)


@pytest.fixture(scope="module", params=[1, 2], ids=["order1", "order2"])
def jax_bh(request, scene, jmesh):
    pos, _, mass = scene
    order = request.param
    acc, over = jax.jit(lambda p, m: jpar.sharded_barnes_hut_forces(
        p, m, jmesh, multipole_order=order, return_overflow=True, **BH_KW))(
        jnp.asarray(pos), jnp.asarray(mass))
    return order, np.asarray(acc), int(over)


def test_barnes_hut_matches_jax(scene, jax_bh, tmesh):
    """Order 1 and 2 at levels 3 (d 8 over 4 slabs of 2 planes), near_k 8:
    no overflow on either side."""
    pos, _, mass = scene
    order, want, want_over = jax_bh
    got, over = tpar.sharded_barnes_hut_forces(
        _split(pos, tmesh), _split(mass, tmesh), tmesh, multipole_order=order,
        return_overflow=True, **BH_KW)
    assert int(over) == want_over == 0
    _close(_gather(got), want)


@pytest.fixture(scope="module")
def jax_hash(scene, jmesh):
    pos, _, mass = scene
    acc, over = jax.jit(lambda p, m: jpar.sharded_spatial_hash_forces(
        p, m, jmesh, return_overflow=True, **HASH_KW))(
        jnp.asarray(pos), jnp.asarray(mass))
    return np.asarray(acc), int(over)


def test_spatial_hash_matches_jax(scene, jax_hash, tmesh):
    pos, _, mass = scene
    want, want_over = jax_hash
    got, over = tpar.sharded_spatial_hash_forces(
        _split(pos, tmesh), _split(mass, tmesh), tmesh, return_overflow=True,
        **HASH_KW)
    assert int(over) == want_over == 0
    _close(_gather(got), want)


def _jstate(scene):
    pos, vel, mass = scene
    return JState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                  acc=jnp.zeros_like(jnp.asarray(pos)),
                  mass=jnp.asarray(mass), time=jnp.zeros((), jnp.float32))


def _tstate(scene, mesh):
    pos, vel, mass = scene
    st = ParticleState.from_numpy(pos, vel, mass=mass, device="cpu")
    return M.shard_state(st, mesh)


def test_energy_matches_jax(scene, jmesh, tmesh):
    jst = jpar.shard_state(_jstate(scene), jmesh)
    ke_j, pe_j = jpar.sharded_energy(jst, jmesh, 1.0, 0.1)
    ke, pe = tpar.sharded_energy(_tstate(scene, tmesh), tmesh, 1.0, 0.1)
    np.testing.assert_allclose(float(ke), float(ke_j), rtol=1e-5)
    np.testing.assert_allclose(float(pe), float(pe_j), rtol=1e-5)


@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_energy_on_block_pairs_matches_jax(p):
    """``sharded_energy`` at P = 2, 3, 4, 8 (264 rows; a coincident pair
    across two blocks, a zero-mass row): KE and PE match JAX's ring (all
    P² block pairs) and the twin at relative 1e-5, from P(P+1)/2 calls of
    K5 (its plain twin here): P of the main form, the rest cross."""
    pos, vel, mass = _ball(264, 3.0, seed=p)
    pos[5] = pos[200]
    mass[17] = 0.0
    scene = (pos, vel, mass)
    jm = jpar.make_mesh(p)
    ke_j, pe_j = jpar.sharded_energy(jpar.shard_state(_jstate(scene), jm),
                                     jm, 1.0, 0.1)
    tm = tpar.make_mesh(p, devices=["cpu"] * p)
    st = _tstate(scene, tm)
    calls = pairwise_potential_plain.calls
    ke, pe = tpar.sharded_energy(st, tm, 1.0, 0.1)
    assert pairwise_potential_plain.calls - calls == p * (p + 1) // 2
    twin = float(pairwise_potential_plain(torch.from_numpy(pos),
                                          torch.from_numpy(mass)))
    np.testing.assert_allclose(float(ke), float(ke_j), rtol=1e-5)
    np.testing.assert_allclose(float(pe), float(pe_j), rtol=1e-5)
    np.testing.assert_allclose(float(pe), twin, rtol=1e-5)


def test_multi_step_matches_jax(scene, jmesh, tmesh):
    """Three ring-force Verlet steps from a(t=0) on both meshes: pos and
    vel within atol 1e-5."""
    cfg = dict(particle_count=N, dt=1e-3)
    jcfg, tcfg = JConfig(**cfg), SimulationConfig(**cfg)
    jforce = jpar.step.make_sharded_force_fn(jcfg, jmesh)
    jst = jpar.shard_state(_jstate(scene), jmesh)
    from nbody_tpu.ops.integrator import initialize_forces

    jst = jpar.make_sharded_multi_step(jcfg, jmesh, 3)(
        jax.jit(lambda s: initialize_forces(s, jforce))(jst))
    tforce = make_sharded_force_fn(tcfg, tmesh)
    tst = tpar.step.sharded_initialize_forces(_tstate(scene, tmesh), tforce)
    tst = tpar.make_sharded_multi_step(tcfg, tmesh, 3)(tst)
    np.testing.assert_allclose(tst.pos.numpy(), np.asarray(jst.pos),
                               atol=1e-5)
    np.testing.assert_allclose(tst.vel.numpy(), np.asarray(jst.vel),
                               atol=1e-5)
    assert abs(float(tst.time) - 3e-3) < 1e-7


def test_public_names_match_jax():
    assert sorted(tpar.__all__) == sorted(jpar.__all__)
    for name in tpar.__all__:
        assert callable(getattr(tpar, name))


# ---- against the port's single-device engines ---------------------------------


def test_chained_halo_eight_thin_slabs(scene):
    """P = 8 at d = 8: slabs of one plane, and θ = 0.25 gives ws = 2 > S,
    so the halo comes by a chain of two ppermutes a side, the planes past
    the edges inert. Matches the single-device BH (order 2)."""
    pos, _, mass = scene
    mesh = tpar.make_mesh(8, devices=["cpu"] * 8)
    kw = dict(BH_KW, theta=0.25, near_k=16)
    got, over = tpar.sharded_barnes_hut_forces(
        _split(pos, mesh), _split(mass, mesh), mesh, return_overflow=True,
        **kw)
    want = barnes_hut_forces(torch.from_numpy(pos), torch.from_numpy(mass),
                             **kw)
    assert int(over) == 0
    _close(_gather(got), want.numpy())


def test_padding_is_inert():
    """N = 250 padded to 256 on P = 8: the padding rows have mass 0 at the
    origin; the ring's forces on the logical rows and the energies equal
    the unpadded single-device ones."""
    pos, vel, mass = _ball(250, 3.0, seed=5)
    st = ParticleState.from_numpy(pos, vel, mass=mass, device="cpu")
    padded = M.pad_to_devices(st, 8)
    assert padded.n == 256 and float(padded.mass[250:].abs().sum()) == 0.0
    assert float(padded.pos[250:].abs().sum()) == 0.0
    mesh = tpar.make_mesh(8, devices=["cpu"] * 8)
    sh = M.shard_state(padded, mesh)
    acc = tpar.ring_direct_forces([s.pos for s in sh.shards],
                                  [s.mass for s in sh.shards], mesh)
    want = direct_forces_reference(st.pos, st.mass, 1.0, 0.1)
    _close(M.gather(acc, 250).numpy(), want.numpy())
    ke, pe = tpar.sharded_energy(sh, mesh, 1.0, 0.1)
    np.testing.assert_allclose(
        float(pe), float(pairwise_potential_plain(st.pos, st.mass)),
        rtol=1e-5)
    np.testing.assert_allclose(
        float(ke), 0.5 * float((st.mass * (st.vel ** 2).sum(1)).sum()),
        rtol=1e-6)
    back = M.gather_state(sh, 250)
    assert torch.equal(back.pos, st.pos) and back.n == 250


def test_routing_overflow_is_counted(scene, tmesh):
    """A capacity of 4 rows per destination cannot hold the ball's
    central slabs: the overflow is counted, and the rows routed within
    capacity keep the single-device hash force."""
    pos, _, mass = scene
    _, over = tpar.sharded_spatial_hash_forces(
        _split(pos, tmesh), _split(mass, tmesh), tmesh, capacity=4,
        return_overflow=True, **HASH_KW)
    assert int(over) > 0
    got, over = tpar.sharded_spatial_hash_forces(
        _split(pos, tmesh), _split(mass, tmesh), tmesh, return_overflow=True,
        **HASH_KW)
    want = spatial_hash_forces(
        torch.from_numpy(pos), torch.from_numpy(mass), 1.0, 0.1, cutoff=1.5,
        cell_size=1.5, cap=8, window=512)
    assert int(over) == 0
    _close(_gather(got), want.numpy())


def test_fallback_warns_and_matches_single_device(scene, tmesh):
    """hash_max_grid_dim 10 does not split over 4: the replicated fallback
    warns, names itself and gives the single-device engine's force."""
    pos, _, mass = scene
    cfg = SimulationConfig(particle_count=N,
                           force_method=ForceMethod.SPATIAL_HASH,
                           hash_max_grid_dim=10, hash_engine="tiles")
    with pytest.warns(ReplicatedFallbackWarning):
        force_fn = make_sharded_force_fn(cfg, tmesh, pos_hint=pos)
    assert force_fn.distribution == "replicated-fallback"
    from nbody_tpu_torch.ops.forces import make_force_fn

    want = make_force_fn(cfg, pos_hint=pos)(torch.from_numpy(pos),
                                            torch.from_numpy(mass))
    got = force_fn(_split(pos, tmesh), _split(mass, tmesh))
    np.testing.assert_allclose(_gather(got), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("cfg,want", [
    (SimulationConfig(particle_count=128), "ring"),
    (SimulationConfig(particle_count=128,
                      force_method=ForceMethod.BARNES_HUT, bh_max_level=3),
     "tree-slabs"),
    (SimulationConfig(particle_count=128,
                      force_method=ForceMethod.SPATIAL_HASH,
                      hash_max_grid_dim=8), "hash-slabs"),
], ids=["ring", "tree-slabs", "hash-slabs"])
def test_designed_paths_selected_without_warning(cfg, want, tmesh):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert make_sharded_force_fn(cfg, tmesh).distribution == want


# ---- mesh, collectives, kernels' plain forms ----------------------------------


def test_mesh_validation():
    """More shards than devices raise ValidationError naming both counts."""
    with pytest.raises(ValidationError, match="1000"):
        tpar.make_mesh(1000)
    with pytest.raises(ValidationError, match="3 devices but only 2"):
        tpar.make_mesh(3, devices=["cpu", "cpu"])
    assert tpar.make_mesh(2, devices=["cpu"] * 4).size == 2
    with pytest.raises(ValidationError, match="not divisible"):
        M.shard_state(ParticleState.from_numpy(np.zeros((10, 3)),
                                               np.zeros((10, 3)),
                                               device="cpu"),
                      tpar.make_mesh(4, devices=["cpu"] * 4))


def test_collectives(tmesh):
    """psum folds in position order (bit-equal over calls), pmin/pmax
    elementwise, all_to_all transposes the leading axis, ppermute rotates
    by the shift, all_gather joins in position order."""
    rng = np.random.default_rng(2)
    xs = [torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
          for _ in range(4)]
    s1, s2 = M.psum(xs, tmesh), M.psum(xs, tmesh)
    want = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    assert all(torch.equal(a, want) and torch.equal(a, b)
               for a, b in zip(s1, s2))
    assert torch.equal(M.pmin(xs, tmesh)[3], torch.stack(xs).amin(0))
    assert torch.equal(M.pmax(xs, tmesh)[1], torch.stack(xs).amax(0))
    a2a = M.all_to_all(xs, tmesh)
    assert all(torch.equal(a2a[q][p], xs[p][q])
               for q in range(4) for p in range(4))
    assert torch.equal(M.ppermute(xs, tmesh, 1)[0], xs[3])
    assert torch.equal(M.ppermute(xs, tmesh, -1)[0], xs[1])
    assert torch.equal(M.all_gather(xs, tmesh)[2], torch.cat(xs))


def test_k4_slab_form_is_the_cube_form_on_its_planes():
    """K4's slab form (plain twin): the slab holding the whole grid is the
    cube form; a slab of planes [x0 − ws, x0 + S + ws) — wrapped planes
    past the grid's edge with no live slot — gives the cube form's planes
    [x0, x0 + S), bit for bit, at ws 1 and 2 with the cutoff."""
    d, k = 6, 4
    rng = np.random.default_rng(8)
    tiles = torch.from_numpy(np.concatenate(
        [rng.uniform(0, 3, (d, 3, k, d * d)), rng.uniform(0, 1, (d, 1, k,
                                                                 d * d))],
        1).astype(np.float32))
    counts = torch.from_numpy(rng.integers(0, k + 2, d ** 3).astype(
        np.float32))
    for ws, cutoff2 in ((1, None), (2, 1.2)):
        kw = dict(k=k, d=d, ws=ws, eps=0.1, cutoff2=cutoff2)
        cube = tile_sweep_plane_plain(tiles, counts=counts, **kw)
        assert torch.equal(tile_sweep_slab(tiles, counts, x0=0, planes=d,
                                           **kw), cube)
        for x0, s in ((0, 2), (2, 2), (4, 2), (1, 3)):
            planes = range(x0 - ws, x0 + s + ws)
            inside = [x for x in planes if 0 <= x < d]
            slab = torch.zeros((len(planes), 4, k, d * d))
            cnt = torch.zeros((len(planes), d * d))
            for i, x in enumerate(planes):
                if 0 <= x < d:
                    slab[i] = tiles[x]
                    cnt[i] = counts.reshape(d, d * d)[x]
            assert inside
            got = tile_sweep_slab(slab, cnt.reshape(-1), x0=ws, planes=s,
                                  **kw)
            assert torch.equal(got, cube[x0:x0 + s]), (ws, x0)


def test_k5_cross_form_sums_to_the_main_form():
    """K5's cross form (plain twin) over the 4 × 4 blocks of a set sums
    to the main form (rel 1e-6); a pair of the two sets at one point
    (raw r² == 0) is excluded, as the self pair is."""
    pos, _, mass = _ball(200, 3.0, seed=4)
    pos[7] = pos[150]                  # coincident across two blocks
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    blocks = [(p[i:i + 50], m[i:i + 50]) for i in range(0, 200, 50)]
    total = sum(float(pairwise_potential_cross(a, b, c, e, 1.0, 0.1))
                for a, b in blocks for c, e in blocks)
    np.testing.assert_allclose(total, float(pairwise_potential_plain(p, m)),
                               rtol=1e-6)
    one = pairwise_potential_cross(p[7:8], m[7:8], p[150:151], m[150:151])
    assert float(one) == 0.0


# ---- distributed ----------------------------------------------------------------


class TestDistributed:
    def test_single_process_is_noop(self, monkeypatch):
        for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(var, raising=False)
        assert distributed.initialize_distributed() is False

    def test_env_drives_initialization(self, monkeypatch):
        import torch.distributed as dist

        calls = {}

        def fake_init(backend, init_method, world_size, rank, timeout=None,
                      device_id=None):
            calls.update(backend=backend, init=init_method, world=world_size,
                         rank=rank)

        monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
        monkeypatch.setenv("MASTER_PORT", "1234")
        monkeypatch.setattr(dist, "is_initialized", lambda: False)
        monkeypatch.setattr(dist, "init_process_group", fake_init)
        assert distributed.initialize_distributed(
            num_processes=4, process_id=2) is True
        assert calls == {"backend": "gloo", "init": "tcp://10.0.0.1:1234",
                         "world": 4, "rank": 2}

    def test_already_initialized_is_idempotent(self, monkeypatch):
        import torch.distributed as dist

        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        assert distributed.initialize_distributed(
            coordinator_address="x:1", num_processes=2, process_id=0) is True

    def test_global_device_info(self):
        info = distributed.global_device_info()
        assert set(info) == {"process_index", "process_count",
                             "local_devices", "global_devices"}
        assert info["process_count"] == 1 and info["process_index"] == 0
