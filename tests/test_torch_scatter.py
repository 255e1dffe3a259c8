"""nbody_tpu_torch sort + placement/moments (kernel K2's plain twin)
against the JAX package's fused build on the same scene (CPU).

The JAX side runs its Pallas scatter kernel in interpret mode, as its own
tests do. n = 1500 at d = 8, k = 8 overflows the slot cap in the dense
core, so the rank ≥ k path (moments still exact, slots capped) is covered.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops.barnes_hut import pyramid_geometry as jax_geometry
from nbody_tpu.ops.sorted_window import (
    build_sorted_grid as jax_build_sorted_grid,
)
from nbody_tpu.ops.tile_sweep import tile_build_pallas
from nbody_tpu_torch.ops.barnes_hut import bin_particles
from nbody_tpu_torch.ops.scatter import tile_scatter, tile_scatter_plain
from nbody_tpu_torch.ops.sorted_window import build_sorted_grid, sorted_ranks
from nbody_tpu_torch.ops.tile_sweep import tile_build

N, LEVELS, K = 1500, 3, 8
D = 1 << LEVELS


def spherical(n, radius, seed):
    """Uniform-in-volume sphere from numpy (float32)."""
    rng = np.random.default_rng(seed)
    r = np.cbrt(rng.uniform(size=n)) * radius
    th = rng.uniform(size=n) * 2 * np.pi
    cp = rng.uniform(size=n) * 2 - 1
    sp = np.sqrt(1 - cp * cp)
    pos = np.stack([sp * np.cos(th), sp * np.sin(th), cp], -1) * r[:, None]
    return pos.astype(np.float32), np.ones(n, np.float32)


@pytest.fixture(scope="module")
def both():
    pos, mass = spherical(N, 4.0, seed=1)
    jp, jm = jnp.asarray(pos), jnp.asarray(mass)
    lo, cell = jax_geometry(jnp.min(jp, axis=0), jnp.max(jp, axis=0), LEVELS)
    coords = jnp.clip(((jp - lo) / cell).astype(jnp.int32), 0, D - 1)
    jgrid = jax_build_sorted_grid(jp, jm, coords, D, with_cell_start=False,
                                  with_csort=False)
    jtb = tile_build_pallas(jgrid, lo, cell, d=D, k=K,
                            impl="pallas_interpret", with_moments=True)
    tlo, tcell, tcoords = bin_particles(torch.from_numpy(pos), LEVELS)
    grid = build_sorted_grid(torch.from_numpy(pos), torch.from_numpy(mass),
                             tcoords, D)
    tb = tile_build(grid, tlo, tcell, d=D, k=K)
    return dict(jgrid=jgrid, jtb=jtb, grid=grid, tb=tb, cell=float(cell),
                jcoords=np.asarray(coords), coords=tcoords.numpy(),
                lo=tlo, tcell=tcell)


def test_binning_and_sort_match_jax_exactly(both):
    """Same cell coords, the same stable order, ids, rows and ranks."""
    np.testing.assert_array_equal(both["coords"], both["jcoords"])
    g, jg = both["grid"], both["jgrid"]
    np.testing.assert_array_equal(g.order.numpy(), np.asarray(jg.order))
    np.testing.assert_array_equal(g.ids.numpy(), np.asarray(jg.ids))
    np.testing.assert_array_equal(g.psort.numpy(), np.asarray(jg.psort))
    rank = both["tb"].rank_sorted.numpy()
    np.testing.assert_array_equal(rank, np.asarray(both["jtb"].rank_sorted))
    np.testing.assert_array_equal(sorted_ranks(g.ids).numpy(), rank)


def test_placed_slots_bit_exact_and_fillers(both):
    """Placed slots are the rows themselves (bit-exact); filler slots are
    the cell centre with mass 0 (atol 1e-6·cube: the centre's rounding)."""
    tiles = both["tb"].tiles_plane.numpy()
    jt = np.asarray(both["jtb"].tiles_plane)
    assert tiles.shape == jt.shape == (D, 4, K, D * D)
    counts = both["tb"].counts.numpy().reshape(D, D * D)
    live = np.arange(K)[None, :, None] < counts[:, None, :]   # (d, k, d²)
    live4 = np.broadcast_to(live[:, None], tiles.shape)
    np.testing.assert_array_equal(tiles[live4], jt[live4])
    dead = ~live4
    assert (tiles[:, 3][~live] == 0.0).all()
    np.testing.assert_allclose(tiles[dead], jt[dead], rtol=0,
                               atol=1e-6 * both["cell"] * D)


def test_moments_counts_and_overflow(both):
    """Moments rtol 1e-5 (summation order differs; an atol of 1e-6 of each
    channel's largest value covers the centred channels that cancel to ~0);
    counts and overflow equal, and the scene does overflow."""
    mom = both["tb"].moments.numpy()
    jm = np.asarray(both["jtb"].moments)
    assert mom.shape == jm.shape == (11, D ** 3)
    np.testing.assert_array_equal(mom[10], jm[10])
    for ch in range(10):
        np.testing.assert_allclose(
            mom[ch], jm[ch], rtol=1e-5,
            atol=1e-6 * float(np.abs(jm[ch]).max()))
    assert int(both["tb"].overflow) == int(both["jtb"].overflow) > 0


def test_wrapper_takes_plain_twin_on_cpu(both):
    """On CPU tensors the K2 wrapper is its plain twin, launch count
    untouched."""
    g = both["grid"]
    before = tile_scatter.launches
    a = tile_scatter(g.psort, g.cell_start, both["lo"], both["tcell"],
                     d=D, k=K)
    b = tile_scatter_plain(g.psort, g.cell_start, both["lo"], both["tcell"],
                           d=D, k=K)
    assert tile_scatter.launches == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))
