"""nbody_tpu_torch sort + placement/moments (kernel K2's plain twin)
against the JAX package's fused build on the same scene (CPU).

The JAX side runs its Pallas scatter kernel in interpret mode, as its own
tests do. n = 1500 at d = 8, k = 8 overflows the slot cap in the dense
core, so the rank ≥ k path (moments still exact, slots capped) is covered.
K2's coverage / extra-channel rank form and its dest form are held against
``monotone_scatter_tiles(..., with_coverage=True, extra=...)`` called as
the JAX table stepping calls it, its output relaid into the plane layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops.barnes_hut import pyramid_geometry as jax_geometry
from nbody_tpu.ops.sorted_window import (
    build_sorted_grid as jax_build_sorted_grid,
)
from nbody_tpu.ops.pallas_scatter import monotone_scatter_tiles
from nbody_tpu.ops.sorted_window import sorted_ranks as jax_sorted_ranks
from nbody_tpu.ops.table_step import (
    TableParams,
    _chunk_bookkeeping,
    _mover_bookkeeping,
    _relayout_plane,
)
from nbody_tpu.ops.tile_sweep import tile_build_pallas
from nbody_tpu_torch.ops.barnes_hut import bin_particles
from nbody_tpu_torch.ops.scatter import (
    SENTINEL_DEST,
    tile_place,
    tile_place_plain,
    tile_scatter,
    tile_scatter_plain,
)
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
                lo=tlo, tcell=tcell, jlo=lo, jcell=cell)


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


def test_plain_twin_float64_sums(both):
    """``accumulate="f64"``: the same tiles, the same per-row terms summed
    in float64 (returned as float64) — within the JAX moments' tolerance
    above and within 1e-6·max|channel| of the float32 sums; an unknown
    mode raises."""
    g = both["grid"]
    args = (g.psort, g.cell_start, both["lo"], both["tcell"])
    t32, m32 = tile_scatter_plain(*args, d=D, k=K)
    t64, m64 = tile_scatter_plain(*args, d=D, k=K, accumulate="f64")
    assert m64.dtype == torch.float64 and torch.equal(t32, t64)
    jm = np.asarray(both["jtb"].moments)
    for ch in range(11):
        scale = float(np.abs(jm[ch]).max())
        np.testing.assert_allclose(m64[ch].numpy(), jm[ch], rtol=1e-5,
                                   atol=1e-6 * scale)
        np.testing.assert_allclose(m32[ch].double().numpy(),
                                   m64[ch].numpy(), rtol=0,
                                   atol=1e-6 * scale)
    with pytest.raises(ValueError, match="accumulate"):
        tile_scatter_plain(*args, d=D, k=K, accumulate="f16")


E = 3  # extra channels: the velocities the table stepping places


def _plane(tiles_cm, nch, p, g):
    """The JAX kernel's slot-major chunk output → plane layout (d, C, k,
    d²) (its relayout pads lanes to 128; the pad is cut)."""
    return np.asarray(_relayout_plane(tiles_cm, nch, p, g))[..., :D * D]


@pytest.fixture(scope="module")
def forms(both):
    """K2's two table forms on the shared scene, JAX and port: the rank
    form with moments, coverage and E extra channels (as
    ``table_step._sort_build`` calls it) and the dest form with coverage
    and E extra channels on a mover set built as ``_repair_step`` builds
    it (targets concentrated on 64 cells, so arrivals above k are denied
    and their sentinel ids interleave with the placed ones)."""
    rng = np.random.default_rng(7)
    jg, g = both["jgrid"], both["grid"]
    p = TableParams(mode="bh", d=D, k=K, G=1.0, softening=0.1, ws=1,
                    impl="pallas_interpret", levels=LEVELS)
    extra = rng.normal(size=(N, E)).astype(np.float32)
    bk = _chunk_bookkeeping(jg.ids, jax_sorted_ranks(jg.ids), p)
    j6, jmom, jx = monotone_scatter_tiles(
        jg.psort, bk["dest"], bk["starts"], both["jlo"], both["jcell"], k=K,
        d=D, r=bk["r"], w=bk["w"], q=bk["q"], nonempty=bk["nonempty"],
        nwin=bk["nwin"], interpret=True, with_moments=True, cell_ids=jg.ids,
        with_coverage=True, extra=jnp.asarray(extra))
    rank = dict(jax=(_plane(j6, 6, p, bk["g"]), np.asarray(jmom),
                     _plane(jx, E, p, bk["g"])),
                port=tile_scatter(g.psort, g.cell_start, both["lo"],
                                  both["tcell"], d=D, k=K,
                                  with_coverage=True,
                                  extra=torch.from_numpy(extra)))

    # the dest form: 300 rows of that table, each moved to a slot above its
    # target cell's high-water mark (targets on 64 cells, so arrivals
    # past k are denied: sentinel ids interleave with the placed ones)
    m = 300
    tiles, _, cov, ext = rank["port"]
    counts = both["tb"].counts.numpy().astype(np.int64)
    occ = torch.nonzero(cov.reshape(-1))[:, 0]            # plane order
    src = occ[torch.from_numpy(rng.choice(occ.numel(), m, replace=False))]
    tgt = rng.integers(0, 64, size=m)
    ordm = np.argsort(tgt, kind="stable")
    tgt_s, src = tgt[ordm], src[torch.from_numpy(ordm)]
    slot = (np.minimum(counts, K)[tgt_s]
            + np.asarray(jax_sorted_ranks(jnp.asarray(tgt_s, jnp.int32))))
    fits = slot < K
    dest = np.where(fits, tgt_s * K + slot, SENTINEL_DEST).astype(np.int32)
    fx, fr, fyz = src // (K * D * D), (src // (D * D)) % K, src % (D * D)
    rows, xs = tiles[fx, :, fr, fyz].numpy(), ext[fx, :, fr, fyz].numpy()
    mb = _mover_bookkeeping(jnp.asarray(tgt_s, jnp.int32), p, 256)
    i6, ix = monotone_scatter_tiles(
        jnp.asarray(rows), jnp.asarray(dest), mb["starts"], both["jlo"],
        both["jcell"], k=K, d=D, r=mb["r"], w=256, q=mb["q"],
        nonempty=mb["nonempty"], nwin=mb["nwin"], interpret=True,
        with_coverage=True, extra=jnp.asarray(xs))
    # the port moves them inside a copy of the table, with its bookkeeping
    sid = ((fx * D * D + fyz) * K + fr).to(torch.int32)     # old slot ids
    occ_ids = ((occ // (K * D * D) * D * D + occ % (D * D)) * K
               + (occ // (D * D)) % K)
    slot_row = torch.full((D ** 3 * K,), -1, dtype=torch.int32)
    slot_row[occ_ids] = torch.arange(occ.numel(), dtype=torch.int32)
    table = dict(tiles=tiles.clone(), cov=cov.clone(), ext=ext.clone(),
                 live=torch.from_numpy(np.minimum(counts, K).astype(
                     np.float32)),
                 slot_row=slot_row, idx_ext=occ_ids.to(torch.int32))
    rid = slot_row[sid.long()].clone()
    tile_place(*table.values(), src.to(torch.int32), torch.from_numpy(dest),
               both["lo"], both["tcell"], d=D, k=K)
    dest_form = dict(
        jax=(_plane(i6, 6, p, mb["g"]), _plane(ix, E, p, mb["g"])),
        port=table, fits=fits, dest=dest, src=(fx, fr, fyz), rid=rid,
        cov0=cov)
    return dict(rank=rank, dest=dest_form)


def test_coverage_extra_rank_form_matches_jax(forms, both):
    """The rank form with coverage and E extra channels: placed slots,
    the coverage plane and the extra planes (0.0 in empty slots)
    bit-equal to the JAX kernel's; filler at 1e-6·cube; moments and
    counts as the plain form's."""
    (j6, jmom, jx), (tiles, mom, cov, ext) = forms["rank"].values()
    cov = cov.numpy()
    live = cov[:, 0] > 0                                   # (d, k, d²)
    counts = both["tb"].counts.numpy().reshape(D, D * D)
    np.testing.assert_array_equal(
        live, np.arange(K)[None, :, None] < counts[:, None, :])
    np.testing.assert_array_equal(cov, j6[:, 5:6])
    t = tiles.numpy()
    live4 = np.broadcast_to(live[:, None], t.shape)
    np.testing.assert_array_equal(t[live4], j6[:, :4][live4])
    np.testing.assert_allclose(t[~live4], j6[:, :4][~live4], rtol=0,
                               atol=1e-6 * both["cell"] * D)
    np.testing.assert_array_equal(ext.numpy(), jx)
    assert (ext.numpy()[np.broadcast_to(~live[:, None], ext.shape)]
            == 0.0).all()
    plain = both["tb"]
    assert torch.equal(tiles, plain.tiles_plane)
    assert torch.equal(mom, plain.moments)
    np.testing.assert_array_equal(mom[10].numpy(), jmom[10])


def test_dest_form_matches_jax(forms, both):
    """The dest form on a repair-built mover set: every slot the JAX kernel
    places (coverage 1) holds the same row and extra channels bit for bit
    in the port's moved table, with coverage 1; denied rows (sentinel ids)
    stay where they were; a moved row's old slot holds the filler (within
    1e-6·cube of the JAX filler, cov 0, extra 0); the bookkeeping follows
    the rows and the high-water marks are the moved table's."""
    f = forms["dest"]
    (i6, ix), t = f["jax"], f["port"]
    fits = f["fits"]
    assert fits.any() and (~fits).any()
    placed = i6[:, 5] > 0                                   # (d, k, d²)
    assert placed.sum() == fits.sum()
    cov = t["cov"].numpy()
    assert (cov[:, 0][placed] == 1.0).all()
    tiles, ext = t["tiles"].numpy(), t["ext"].numpy()
    p4 = np.broadcast_to(placed[:, None], tiles.shape)
    np.testing.assert_array_equal(tiles[p4], i6[:, :4][p4])
    p3 = np.broadcast_to(placed[:, None], ext.shape)
    np.testing.assert_array_equal(ext[p3], ix[p3])
    fx, fr, fyz = (a[torch.from_numpy(fits)] for a in f["src"])
    assert (cov[fx, 0, fr, fyz] == 0.0).all()
    assert (tiles[fx, 3, fr, fyz] == 0.0).all()
    assert (ext[fx, :, fr, fyz] == 0.0).all()
    cube = both["cell"] * D
    centre = np.asarray(both["lo"]) + (np.stack(
        [fx.numpy(), fyz.numpy() // D, fyz.numpy() % D], -1) + 0.5) * (
        both["cell"])
    np.testing.assert_allclose(tiles[fx, :3, fr, fyz], centre, rtol=0,
                               atol=1e-6 * cube)
    # nothing lands where the JAX kernel places nothing
    assert not (~placed & (f["cov0"].numpy()[:, 0] == 0)
                & (cov[:, 0] > 0)).any()
    rid = f["rid"][torch.from_numpy(fits)].long()
    dest = torch.from_numpy(f["dest"][fits]).long()
    assert torch.equal(t["slot_row"][dest].long(), rid)
    assert torch.equal(t["idx_ext"][rid].long(), dest)
    slot1 = np.arange(1, K + 1)[None, :, None]
    hwm = np.where(cov[:, 0] > 0, slot1, 0).max(axis=1).reshape(-1)
    touched = np.concatenate([(fx * D * D + fyz).numpy(),
                              dest.numpy() // K])
    np.testing.assert_array_equal(t["live"].numpy()[touched], hwm[touched])


def test_table_forms_take_plain_twins_on_cpu(both):
    """On CPU tensors both table forms are their plain twins, launch
    counts untouched; the rank form takes no arity but the table form's."""
    g = both["grid"]
    ex = torch.ones((N, 3))
    before = (tile_scatter.launches, tile_place.launches)
    a = tile_scatter(g.psort, g.cell_start, both["lo"], both["tcell"], d=D,
                     k=K, with_coverage=True, extra=ex)
    b = tile_scatter_plain(g.psort, g.cell_start, both["lo"], both["tcell"],
                           d=D, k=K, with_coverage=True, extra=ex)
    assert len(a) == 4
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    tiles, mom, cov, ext = a
    occ = torch.nonzero(cov.reshape(-1))[:2, 0].to(torch.int32)
    free = torch.nonzero(cov[:, 0].permute(0, 2, 1).reshape(-1) == 0)[:1, 0]
    dest = torch.cat([free.to(torch.int32),
                      torch.tensor([SENTINEL_DEST], dtype=torch.int32)])
    outs = []
    for fn in (tile_place, tile_place_plain):
        t = (tiles.clone(), cov.clone(), ext.clone(),
             torch.clamp(mom[10], max=K), torch.zeros(D ** 3 * K,
                                                      dtype=torch.int32),
             torch.zeros(N, dtype=torch.int32))
        fn(*t, occ, dest, both["lo"], both["tcell"], d=D, k=K)
        outs.append(t)
    assert (tile_scatter.launches, tile_place.launches) == before
    assert all(torch.equal(u, v) for u, v in zip(*outs))
    assert float(outs[0][1].sum()) == float(cov.sum())
    with pytest.raises(ValueError, match="table form"):
        tile_scatter(g.psort, g.cell_start, both["lo"], both["tcell"], d=D,
                     k=K, with_coverage=True, extra=torch.ones((N, 5)))
