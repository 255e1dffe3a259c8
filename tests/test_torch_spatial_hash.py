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
    """The same engine, tile_d, tile_k, window and block from the same
    positions (and without a probe), at ≤ 150K and 1M particles."""
    pos, _ = scene()
    for n in (pos.shape[0], 1_000_000):
        jc = JConfig(particle_count=n, spatial_hash_cell_size=cell)
        tc = config_from_reference(jc)
        for hint in (pos, None):
            want = jsh.hash_engine_params(jc, hint)
            got = tsh.hash_engine_params(
                tc, None if hint is None else torch.from_numpy(hint))
            for key in ("engine", "tile_d", "tile_k", "window", "block",
                        "occupancy"):
                assert got[key] == want[key], key
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
