"""The spatial-hash slice of nbody_tpu_torch (both engines) against the JAX
package's ``nbody_tpu.ops.spatial_hash`` on the same numpy inputs, and
against a float64 brute force with the same predicate (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import spatial_hash as jsh
from nbody_tpu.types import SimulationConfig as JConfig
from nbody_tpu_torch.ops import spatial_hash as tsh
from nbody_tpu_torch.state import config_from_reference

G, EPS, CUT = 1.0, 0.1, 2.0


def _dense(n=4096, radius=2.5, seed=7):
    """A ball at ~60 rows per 1.0 cell: "auto" resolves to the window
    engine."""
    rng = np.random.default_rng(seed)
    r = np.cbrt(rng.uniform(size=n)) * radius
    v = rng.normal(size=(n, 3))
    pos = v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None]
    return pos.astype(np.float32), rng.uniform(0.5, 1.5, n).astype(np.float32)


def _sparse(n=4096, side=16.0, seed=8):
    """A uniform cube at ~8 rows per 2.0 cell (bench.py's sparse scene,
    cut down): "auto" resolves to the tiles engine."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-side / 2, side / 2, (n, 3)).astype(np.float32)
    return pos, rng.uniform(0.5, 1.5, n).astype(np.float32)


def _close(got, want, rel=2e-5, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rel * float(np.abs(want).max()))


def _brute(pos, mass, coords, cutoff):
    """float64 all pairs with the hash predicate: cells within Chebyshev
    distance 1 (the 27-cell sweep), raw r² ≤ cutoff² and r² > 0."""
    p, m = pos.astype(np.float64), mass.astype(np.float64)
    out = []
    for i in range(0, len(p), 512):  # 512 targets at a time: ~50 MB temps
        dvec = p[None, :, :] - p[i:i + 512, None, :]
        r2 = (dvec * dvec).sum(-1)
        cheb = np.abs(coords[None, :, :] - coords[i:i + 512, None, :]).max(-1)
        keep = (cheb <= 1) & (r2 <= cutoff * cutoff) & (r2 > 0)
        w = np.where(keep, m[None, :] * (r2 + EPS * EPS) ** -1.5, 0.0)
        out.append(G * np.einsum("ij,ijd->id", w, dvec))
    return np.concatenate(out)


@pytest.mark.parametrize("scene,cell,engine",
                         [(_dense, 1.0, "window"), (_sparse, 2.0, "tiles")],
                         ids=["dense", "sparse"])
def test_engine_params_match_jax(scene, cell, engine):
    """The same engine, tile_d, tile_k and block from the same positions
    (and without a probe), at ≤ 150K and 1M particles; the window, at
    ``hash_window`` 0, is every row where the JAX package's is 1024 or
    2048 (``hash_window_defaults``)."""
    pos, _ = scene()
    for n in (pos.shape[0], 1_000_000):
        jc = JConfig(particle_count=n, spatial_hash_cell_size=cell)
        tc = config_from_reference(jc)
        for hint in (pos, None):
            want = jsh.hash_engine_params(jc, hint)
            got = tsh.hash_engine_params(
                tc, None if hint is None else torch.from_numpy(hint))
            for key in ("engine", "tile_d", "tile_k", "block",
                        "occupancy"):
                assert got[key] == want[key], key
            assert got["window"] == n
    assert tsh.hash_engine_params(tc, pos)["engine"] == engine


def test_window_engine_matches_jax_and_brute_force():
    """spatial_hash_forces (window engine, cap 16, W 1024, B 128) against
    the JAX XLA path: rtol 1e-4, atol 2e-5·max|a|, equal overflow (0);
    against the f64 brute force on the engine's own cells: the same
    tolerance (f32 sums of ~10² terms)."""
    pos, mass = _dense()
    kw = dict(cutoff=CUT, cell_size=1.0, cap=16, window=1024, block_size=128,
              return_overflow=True)
    got, over = tsh.spatial_hash_forces(torch.from_numpy(pos),
                                        torch.from_numpy(mass), G, EPS, **kw)
    want, over_j = jsh.spatial_hash_forces(jnp.asarray(pos),
                                           jnp.asarray(mass), G, EPS,
                                           impl="xla", **kw)
    assert int(over) == int(over_j) == 0
    _close(got.numpy(), want)
    coords = tsh.hash_bin(torch.from_numpy(pos), 1.0, 16)[2].numpy()
    _close(got.numpy(), _brute(pos, mass, coords, CUT))


@pytest.mark.parametrize("k", [32, 8])
def test_tiles_engine_matches_jax_and_brute_force(k):
    """spatial_hash_forces_tiles (d 16) against the JAX XLA path: rtol
    1e-4, atol 2e-5·max|a|, equal overflow. At k 32 nothing overflows and
    every row matches the f64 brute force; at k 8 rows past the cap read
    zero in both packages (and are missing as sources, so the brute force
    no longer applies)."""
    pos, mass = _sparse()
    kw = dict(cutoff=CUT, cell_size=2.0, d=16, k=k, return_overflow=True)
    got, over = tsh.spatial_hash_forces_tiles(
        torch.from_numpy(pos), torch.from_numpy(mass), G, EPS, **kw)
    want, over_j = jsh.spatial_hash_forces_tiles(
        jnp.asarray(pos), jnp.asarray(mass), G, EPS, impl="xla", **kw)
    assert int(over) == int(over_j)
    _close(got.numpy(), want)
    coords = tsh.tiles_bin(torch.from_numpy(pos), 2.0, 16)[1]
    if k == 32:
        assert int(over) == 0
        _close(got.numpy(), _brute(pos, mass, coords.numpy(), CUT))
    else:
        ids = tsh.cell_index(coords, 16).numpy()
        counts = np.bincount(ids)
        assert int(over) == int(np.maximum(counts - k, 0).sum()) > 0
        assert (np.abs(got.numpy()).max(1) == 0).sum() == int(over)


@pytest.mark.parametrize("engine", ["window", "tiles"])
def test_sorted_variants_match_jax(engine):
    """The sorted variants: a bit-equal ``order`` and ``psort``, and
    ``acc_sorted`` within rtol 1e-4, atol 2e-5·max|a| of the JAX package's;
    unsorting gives the unsorted forces."""
    if engine == "window":
        pos, mass = _dense()
        kw = dict(cutoff=CUT, cell_size=1.0, cap=16, window=1024,
                  block_size=128)
        tfn, jfn = (tsh.spatial_hash_forces_window_sorted,
                    jsh.spatial_hash_forces_window_sorted)
        plain = tsh.spatial_hash_forces
    else:
        pos, mass = _sparse()
        kw = dict(cutoff=CUT, cell_size=2.0, d=16, k=16)
        tfn, jfn = (tsh.spatial_hash_forces_tiles_sorted,
                    jsh.spatial_hash_forces_tiles_sorted)
        plain = tsh.spatial_hash_forces_tiles
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    acc, psort, order = tfn(tp, tm, G, EPS, **kw)
    j_acc, j_psort, j_order = jfn(jnp.asarray(pos), jnp.asarray(mass), G, EPS,
                                  impl="xla", **kw)
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(psort.numpy(), np.asarray(j_psort))
    _close(acc.numpy(), j_acc)
    unsorted = torch.empty_like(acc)
    unsorted[order] = acc
    np.testing.assert_array_equal(unsorted.numpy(),
                                  plain(tp, tm, G, EPS, **kw).numpy())


def test_momentum_conservation():
    """Pair forces are antisymmetric: |Σ m·a| < 1e-5·Σ |m·a| (window
    engine, no overflow)."""
    pos, mass = _dense(n=3000, radius=3.0, seed=11)
    acc = tsh.spatial_hash_forces(torch.from_numpy(pos),
                                  torch.from_numpy(mass), G, EPS,
                                  cutoff=1.0, cell_size=1.0, cap=16,
                                  window=1024, block_size=128).numpy()
    ma = mass[:, None].astype(np.float64) * acc
    assert np.abs(ma.sum(0)).max() < 1e-5 * np.abs(ma).sum()


def test_build_spatial_grid_and_cell_audit():
    """The reference's cell-list audit: every particle in exactly one cell,
    all N covered; ``order``, counts, starts and overflow equal to the JAX
    package's; the K cap is counted; cell_index math."""
    pos, _ = _dense(n=500, radius=5.0, seed=12)
    g = tsh.build_spatial_grid(torch.from_numpy(pos), cell_size=1.0, cap=16,
                               max_per_cell=64)
    jg = jsh.build_spatial_grid(jnp.asarray(pos), cell_size=1.0, cap=16,
                                max_per_cell=64)
    assert tsh.verify_cell_assignment(pos, g, cap=16)
    for name in ("order", "cell_ids", "cell_start", "cell_count", "dims"):
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      np.asarray(getattr(jg, name)), name)
    assert int(g.overflow) == int(jg.overflow) == 0
    g.order[1] = g.order[0]  # a particle listed twice, another lost
    assert not tsh.verify_cell_assignment(pos, g, cap=16)
    pile = (np.zeros((100, 3)) + np.linspace(0, 0.01, 100)[:, None])
    g2 = tsh.build_spatial_grid(torch.from_numpy(pile.astype(np.float32)),
                                cell_size=1.0, cap=8, max_per_cell=16)
    assert int(g2.overflow) == 100 - 16
    c = torch.tensor([[0, 0, 0], [1, 2, 3], [7, 7, 7]], dtype=torch.int32)
    assert tsh.cell_index(c, 8).tolist() == [0, (1 * 8 + 2) * 8 + 3, 511]


# A ball where the JAX package's window at ≤ 150K particles, (1024, 128),
# drops pairs: ~1240 rows for the busiest (block, offset).
_CROWDED = dict(n=2048, radius=0.9, seed=21)


def _facade(pos, mass, **cfg):
    from nbody_tpu_torch import ParticleSystem, SimulationState
    from nbody_tpu_torch.types import ForceMethod, SimulationConfig

    ps = ParticleSystem()
    ps.initialize(SimulationConfig(
        particle_count=pos.shape[0], force_method=ForceMethod.SPATIAL_HASH,
        **cfg), device="cpu")
    ps.set_state(SimulationState(
        pos=pos, vel=np.zeros_like(pos), mass=mass, dt=1e-3, G=G,
        softening=EPS, force_method=ForceMethod.SPATIAL_HASH))
    return ps


def _window_overflow(pos, mass, window, block):
    return int(tsh.spatial_hash_forces(
        torch.as_tensor(pos), torch.as_tensor(mass), G, EPS, cutoff=CUT,
        cell_size=1.0, window=window, block_size=block,
        return_overflow=True)[1])


def test_the_default_window_drops_nothing_where_the_jax_default_does():
    """On a ball the JAX package's (1024, 128) overflows, the port's window
    at ``hash_window`` 0 is every row (the other keys the JAX package's);
    through the facade its a(0) drops nothing, equals the f64 brute force
    and the benchmark's plain reference (``portbench/reference/hash.py``)
    within rtol 1e-4, atol 2e-5·max|a|, and the audit and the diagnostics
    read it all."""
    from portbench.reference import hash as hash_ref

    pos, mass = _dense(**_CROWDED)
    n = pos.shape[0]
    jc = JConfig(particle_count=n, spatial_hash_cell_size=1.0)
    want = jsh.hash_engine_params(jc, pos)
    got = tsh.hash_engine_params(config_from_reference(jc),
                                 torch.from_numpy(pos))
    assert (want["engine"], want["window"], want["block"]) == (
        "window", 1024, 128)
    assert _window_overflow(pos, mass, 1024, 128) > 0
    assert got["window"] == n
    for key in ("engine", "block", "tile_d", "tile_k", "occupancy"):
        assert got[key] == want[key], key

    ps = _facade(pos, mass)
    audit = ps.audit_short_range()
    assert audit == {"method": "spatial-hash", "overflow": 0, "window": n,
                     "engine": "window", "block": 128,
                     "window_overflow_rows": 0}
    diag = ps.diagnostics()
    assert (diag["window"], diag["block"], diag["window_overflow_rows"]) == (
        n, 128, 0)
    acc = ps.state.acc.numpy()
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    coords = tsh.hash_bin(tp, 1.0, 64)[2].numpy()
    _close(acc, _brute(pos, mass, coords, CUT))
    sim = {"spatial_hash_cell_size": 1.0, "spatial_hash_cutoff": CUT,
           "softening": EPS, "G": G}
    ref = hash_ref.accelerations(tp, tm, torch.arange(n), sim)[0]
    _close(acc, ref.numpy())


def test_the_default_window_follows_a_scene_that_crowds():
    """A heavy ball collapsing under its own short-range pull: a window of
    384 rows covers it at step 0 and drops pairs 10 steps on; the default
    window drops nothing through those steps (the counter
    ``hash.window_overflow_rows`` reads 0) and a(t) equals the f64 brute
    force."""
    from nbody_tpu_torch.utils.profiling import read_counter

    pos, _ = _dense(n=1024, radius=2.0, seed=21)
    mass = np.full(pos.shape[0], 20.0, np.float32)
    assert _window_overflow(pos, mass, 384, 128) == 0
    ps = _facade(pos, mass)
    ps.run_steps(10)
    st = ps.state
    now = st.pos.numpy()
    assert _window_overflow(now, mass, 384, 128) > 0
    assert read_counter("hash.window_overflow_rows") == 0
    assert ps.audit_short_range()["window_overflow_rows"] == 0
    coords = tsh.hash_bin(st.pos, 1.0, 64)[2].numpy()
    _close(st.acc.numpy(), _brute(now, mass, coords, CUT))


def test_an_explicit_window_is_honoured_and_counted():
    """An explicit ``hash_window`` too small for the scene runs as given:
    a(0)'s dropped rows are counted (the counter
    ``hash.window_overflow_rows`` and the audit), each step adds its own,
    the window stays, and a later state starts its count afresh."""
    from nbody_tpu_torch.utils.profiling import read_counter

    pos, mass = _dense(**_CROWDED)
    ps = _facade(pos, mass, hash_window=256)
    p = ps._force_fn.engine_params
    assert (p["window"], p["block"]) == (256, 256)
    rows = _window_overflow(pos, mass, 256, 256)
    assert rows > 0
    assert read_counter("hash.window_overflow_rows") == rows
    audit = ps.audit_short_range()
    assert (audit["window"], audit["overflow"],
            audit["window_overflow_rows"]) == (256, rows, rows)
    ps.run_steps(2)
    assert ps._force_fn.engine_params == p
    total = read_counter("hash.window_overflow_rows")
    assert total > rows
    assert ps.audit_short_range()["window_overflow_rows"] == total
    ps.set_state(ps.get_state())
    again = _window_overflow(ps.positions(), mass, 256, 256)
    assert ps.audit_short_range()["window_overflow_rows"] == again > 0
