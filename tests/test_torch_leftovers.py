"""The engine leftovers of nbody_tpu_torch against the JAX package (CPU):
Morton codes, the ``extra`` payload riding the sort gather
(``build_sorted_grid`` and the hash and Barnes-Hut sorted forces), the full
segment index rule, ``window_sweep(pair_weight=)``, the pyramid checks,
Barnes-Hut tiles at near_k 40 (the 4M flagship's occupancy band) and the
package-level re-exports."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu
import nbody_tpu.ops
import nbody_tpu_torch
import nbody_tpu_torch.ops
from nbody_tpu.ops import barnes_hut as jbh
from nbody_tpu.ops import morton as jm
from nbody_tpu.ops import sorted_window as jsw
from nbody_tpu.ops import spatial_hash as jsh
from nbody_tpu.types import ForceMethod as JForceMethod
from nbody_tpu.types import SimulationConfig as JConfig
from nbody_tpu_torch.ops import barnes_hut as tbh
from nbody_tpu_torch.ops import morton as tm
from nbody_tpu_torch.ops import sorted_window as tsw
from nbody_tpu_torch.ops import spatial_hash as tsh
from nbody_tpu_torch.state import config_from_reference


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sphere(n, radius, seed):
    rng = np.random.default_rng(seed)
    r = np.cbrt(rng.uniform(size=n)) * radius
    v = rng.normal(size=(n, 3))
    pos = (v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None])
    return (pos.astype(np.float32),
            rng.uniform(0.5, 1.5, n).astype(np.float32),
            rng.normal(size=(n, 4)).astype(np.float32))


# --- Morton codes (bit for bit) --------------------------------------------


def test_morton_known_values():
    """tests/test_morton.py's known values: (1,0,0) → bit 2, (0,1,0) → bit
    1, (0,0,1) → bit 0; the diagonal is monotone in Z order."""
    c = torch.tensor([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]],
                     dtype=torch.int32)
    assert tm.morton_encode(c).tolist() == [0, 4, 2, 1, 7]
    diag = torch.arange(64, dtype=torch.int32)[:, None].expand(64, 3)
    assert bool((torch.diff(tm.morton_encode(diag).long()) > 0).all())
    assert tm.MORTON_BITS == jm.MORTON_BITS


def test_morton_codes_equal_jax():
    """Encode, decode, expand/compact and the position mapping equal the
    JAX package's uint32 codes exactly, on every corner of the 10-bit
    range too."""
    rng = np.random.default_rng(4)
    coords = rng.integers(0, 1024, (1000, 3)).astype(np.int32)
    coords[:2] = [[1023, 1023, 1023], [0, 1023, 0]]
    want = np.asarray(jm.morton_encode(jnp.asarray(coords)))
    got = tm.morton_encode(torch.from_numpy(coords))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    back = tm.morton_decode(got).numpy()
    np.testing.assert_array_equal(back, coords)
    np.testing.assert_array_equal(
        back, np.asarray(jm.morton_decode(jnp.asarray(want))))
    v = rng.integers(0, 1 << 20, 500).astype(np.int32)
    np.testing.assert_array_equal(
        tm.expand_bits(torch.from_numpy(v)).numpy(),
        np.asarray(jm.expand_bits(jnp.asarray(v))).astype(np.int64))
    np.testing.assert_array_equal(
        tm.compact_bits(torch.from_numpy(v)).numpy(),
        np.asarray(jm.compact_bits(jnp.asarray(v))).astype(np.int64))
    pos = rng.uniform(-5.0, 5.0, (500, 3)).astype(np.float32)
    lo, ext = pos.min(0), np.float32((pos.max(0) - pos.min(0)).max())
    want = np.asarray(jm.morton_codes_for_positions(
        jnp.asarray(pos), jnp.asarray(lo), jnp.asarray(ext)))
    got = tm.morton_codes_for_positions(torch.from_numpy(pos),
                                        torch.from_numpy(lo), float(ext))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(got.max()) < (1 << 30)


# --- the extra payload on the sort gather ----------------------------------


@pytest.mark.parametrize("with_cell_start,rows",
                         [(True, "own"), (False, "own"), (True, "views")],
                         ids=["True", "False", "views"])
def test_build_sorted_grid_extra_matches_jax(with_cell_start, rows):
    """``extra`` rides the payload gather: order, psort, ids and
    ``SortedGrid.extra`` equal JAX's exactly; ``with_cell_start=False``
    leaves the segment index unbuilt in both, and built it is JAX's.
    CPU tensors take the payload gather's plain twin, never the kernel;
    with ``rows="views"`` positions and masses are views of one (N, 4)
    table (the sorted step's carried rows) and the cell coordinates are
    built too, all equal to JAX's."""
    from nbody_tpu_torch.ops.payload_gather import (
        payload_gather,
        payload_gather_plain,
    )

    d = 8
    pos, mass, extra = _sphere(600, 4.0, 1)
    coords = np.clip(((pos - pos.min(0)) / 1.0).astype(np.int32), 0, d - 1)
    with_csort = rows == "views"
    want = jsw.build_sorted_grid(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(coords), d,
        with_cell_start=with_cell_start, extra=jnp.asarray(extra))
    tpos, tmass = torch.from_numpy(pos), torch.from_numpy(mass)
    if rows == "views":
        table = torch.cat([tpos, tmass[:, None]], dim=-1)
        tpos, tmass = table[:, :3], table[:, 3]
    calls, launches = payload_gather_plain.calls, payload_gather.launches
    got = tsw.build_sorted_grid(
        tpos, tmass, torch.from_numpy(coords), d,
        with_cell_start=with_cell_start, extra=torch.from_numpy(extra),
        with_csort=with_csort)
    assert payload_gather_plain.calls == calls + 1
    assert payload_gather.launches == launches
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.psort.numpy(), np.asarray(want.psort))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.extra.numpy(), np.asarray(want.extra))
    assert got.psort.is_contiguous()
    if with_csort:
        np.testing.assert_array_equal(got.csort.numpy(),
                                      np.asarray(want.csort))
    else:
        assert got.csort is None
    if with_cell_start:
        np.testing.assert_array_equal(got.cell_start.numpy(),
                                      np.asarray(want.cell_start))
    else:
        assert got.cell_start is None and want.cell_start is None
    plain = tsw.build_sorted_grid(tpos, tmass, torch.from_numpy(coords), d)
    assert plain.extra is None and torch.equal(plain.psort, got.psort)


def test_full_cell_start_rule_matches_jax():
    assert tsw.FULL_CELL_START_MAX_CELLS == jsw.FULL_CELL_START_MAX_CELLS
    for cells in (1, 64 ** 3, 1 << 19, (1 << 19) + 1, 128 ** 3):
        assert tsw.use_full_cell_start(cells) == jsw.use_full_cell_start(cells)


def test_hash_tiles_sorted_extra_matches_jax():
    """The hash tiles engine with ``extra``: ``(acc, psort, order,
    extra_sorted)`` against JAX's XLA tiles path (acc atol 2e-5·max|a|,
    the rest exact), the forces unchanged by the payload, and with the
    frozen-grid meta appended last."""
    pos, mass, extra = _sphere(1500, 6.0, 2)
    kw = dict(cutoff=2.0, cell_size=1.0, d=16, k=16)
    want = jsh.spatial_hash_forces_tiles_sorted(
        jnp.asarray(pos), jnp.asarray(mass), 1.0, 0.1, impl="xla",
        extra=jnp.asarray(extra), **kw)
    tp, tmass, tex = map(torch.from_numpy, (pos, mass, extra))
    got = tsh.spatial_hash_forces_tiles_sorted(tp, tmass, 1.0, 0.1,
                                               extra=tex, **kw)
    assert len(got) == len(want) == 4
    scale = float(np.abs(np.asarray(want[0])).max())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=2e-5 * scale)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    bare = tsh.spatial_hash_forces_tiles_sorted(tp, tmass, 1.0, 0.1, **kw)
    assert len(bare) == 3 and torch.equal(bare[0], got[0])
    meta = tsh.spatial_hash_forces_tiles_sorted(
        tp, tmass, 1.0, 0.1, extra=tex, with_grid_meta=True, **kw)
    assert len(meta) == 5 and isinstance(meta[4], tsw.FrozenGridMeta)
    assert torch.equal(meta[3], got[3])


def test_hash_window_sorted_extra_matches_jax():
    """The hash window engine's sorted form with ``extra``: order, psort
    and ``extra_sorted`` exact against JAX's XLA window path, acc atol
    2e-5·max|a|, and the forces unchanged by the payload."""
    pos, mass, extra = _sphere(800, 3.0, 9)
    kw = dict(cutoff=2.0, cell_size=1.0, cap=16, window=512, block_size=64)
    want = jsh.spatial_hash_forces_window_sorted(
        jnp.asarray(pos), jnp.asarray(mass), 1.0, 0.1, impl="xla",
        extra=jnp.asarray(extra), **kw)
    tp, tmass, tex = map(torch.from_numpy, (pos, mass, extra))
    got = tsh.spatial_hash_forces_window_sorted(tp, tmass, 1.0, 0.1,
                                                extra=tex, **kw)
    assert len(got) == len(want) == 4
    scale = float(np.abs(np.asarray(want[0])).max())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=2e-5 * scale)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    bare = tsh.spatial_hash_forces_window_sorted(tp, tmass, 1.0, 0.1, **kw)
    assert len(bare) == 3 and torch.equal(bare[0], got[0])


def test_bh_sorted_extra_matches_jax_grid():
    """The Barnes-Hut tiles sorted force with ``extra``: the payload comes
    back as JAX's ``grid.extra`` on the JAX binning of the same rows
    (exact), and the forces equal the call without it bit for bit. (JAX's
    own sorted force needs interpret-mode kernels on the CPU: minutes.)"""
    levels, d = 3, 8
    pos, mass, extra = _sphere(800, 5.0, 3)
    jp = jnp.asarray(pos)
    lo, cell = jbh.pyramid_geometry(jp.min(0), jp.max(0), levels)
    coords = jnp.clip(((jp - lo) / cell).astype(jnp.int32), 0, d - 1)
    want = jsw.build_sorted_grid(jp, jnp.asarray(mass), coords, d,
                                 with_cell_start=False,
                                 extra=jnp.asarray(extra))
    tp, tmass, tex = map(torch.from_numpy, (pos, mass, extra))
    kw = dict(levels=levels, near_k=16)
    acc, psort, order, ex = tbh.barnes_hut_forces_sorted(
        tp, tmass, 1.0, 0.1, 1.0, extra=tex, **kw)
    np.testing.assert_array_equal(ex.numpy(), np.asarray(want.extra))
    np.testing.assert_array_equal(order.numpy(), np.asarray(want.order))
    bare = tbh.barnes_hut_forces_sorted(tp, tmass, 1.0, 0.1, 1.0, **kw)
    assert len(bare) == 3
    assert torch.equal(bare[0], acc) and torch.equal(bare[1], psort)
    with_meta = tbh.barnes_hut_forces_sorted(
        tp, tmass, 1.0, 0.1, 1.0, extra=tex, with_grid_meta=True, **kw)
    assert len(with_meta) == 5 and torch.equal(with_meta[3], ex)


# --- window_sweep(pair_weight=) ---------------------------------------------


def _window_case(n, d, radius, seed):
    pos, mass, _ = _sphere(n, radius, seed)
    lo = pos.min(0)
    cell = np.float32(max(float((pos.max(0) - lo).max()), 1e-6)
                      * 1.00001 / d)
    coords = np.clip(((pos - lo) / cell).astype(np.int32), 0, d - 1)
    jg = jsw.build_sorted_grid(jnp.asarray(pos), jnp.asarray(mass),
                               jnp.asarray(coords), d)
    tg = tsw.build_sorted_grid(torch.from_numpy(pos), torch.from_numpy(mass),
                               torch.from_numpy(coords), d, with_csort=True)
    return jg, tg


@pytest.mark.parametrize("case", ["ws1", "ws2", "overflow"])
def test_window_sweep_pair_weight_matches_jax(case):
    """The custom-closure sweep against JAX's XLA path on the closures of
    tests/test_short_range_engines.py: softened gravity at ws 1 and 2
    (rtol 1e-5, atol 1e-6·max|a|), and the constant weight with a window
    too small (overflow equal, acc as above)."""
    if case == "overflow":
        n, d, radius, ws, window, block = 2000, 8, 1.0, 1, 64, 64

        def jpw(r2, mj):
            return mj * 0.0 + 1.0
        tpw = jpw
    else:
        n, d, radius, ws, window, block = 300, 8, 4.0, int(case[-1]), 512, 64

        def jpw(r2, mj):
            inv = jax.lax.rsqrt(r2 + 0.01)
            return mj * inv * inv * inv

        def tpw(r2, mj):
            inv = torch.rsqrt(r2 + 0.01)
            return mj * inv * inv * inv
    jg, tg = _window_case(n, d, radius, 5)
    kw = dict(d=d, xy_offsets=tsw.xy_ball(ws), z_halfwidth=ws, window=window,
              block_size=block)
    ja, jo = jsw.window_sweep(jg, pair_weight=jpw, **kw)
    ta, to = tsw.window_sweep(tg, pair_weight=tpw, **kw)
    assert int(to) == int(jo)
    assert (int(to) > 0) == (case == "overflow")
    scale = float(np.abs(np.asarray(ja)).max())
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-6 * scale)
    ts, _ = tsw.window_sweep(tg, pair_weight=tpw, sorted_output=True, **kw)
    np.testing.assert_array_equal(tsw.unsort_rows(ts, tg.order).numpy(),
                                  ta.numpy())


def test_window_sweep_needs_exactly_one_weight():
    jg, tg = _window_case(100, 4, 2.0, 6)
    kw = dict(d=4, xy_offsets=tsw.xy_ball(1), z_halfwidth=1, window=256,
              block_size=64)
    for extra in (dict(eps=0.1, pair_weight=lambda r2, m: m),  dict()):
        with pytest.raises(ValueError):
            tsw.window_sweep(tg, **extra, **kw)
        with pytest.raises(ValueError):
            jsw.window_sweep(jg, **extra, **kw)


# --- pyramid checks ----------------------------------------------------------


def test_verify_pyramid_matches_jax():
    """``verify_mass_conservation`` and ``verify_pyramid_structure`` on the
    port's pyramid pass, and fail on a broken one, as JAX's do on the same
    masses."""
    pos, mass, _ = _sphere(500, 3.0, 7)
    pyr = tbh.build_pyramid(torch.from_numpy(pos), torch.from_numpy(mass), 3)
    total = float(mass.astype(np.float64).sum())

    def as_jax(masses):
        return types.SimpleNamespace(
            masses=tuple(jnp.asarray(m.numpy()) for m in masses))

    assert tbh.verify_mass_conservation(pyr, total)
    assert tbh.verify_pyramid_structure(pyr)
    assert jbh.verify_mass_conservation(as_jax(pyr.masses), total)
    assert jbh.verify_pyramid_structure(as_jax(pyr.masses))
    assert not tbh.verify_mass_conservation(pyr, total * 1.01)
    broken = list(pyr.masses)
    broken[1] = broken[1].clone()
    broken[1][0, 0, 0] += 5.0
    bad = tbh.Pyramid(tuple(broken), pyr.lo, pyr.cell)
    for verify in (tbh.verify_mass_conservation, tbh.verify_pyramid_structure):
        args = (total,) if verify is tbh.verify_mass_conservation else ()
        assert not verify(bad, *args)
    assert not jbh.verify_pyramid_structure(as_jax(broken))
    assert not jbh.verify_mass_conservation(as_jax(broken), total)


# --- Barnes-Hut tiles at near_k 40 ------------------------------------------


@pytest.mark.parametrize("n,level", [(4_000_000, 6), (15 * 8 ** 3, 3)])
def test_engine_params_at_flagship_occupancy(n, level):
    """Occupancy 15.26 (4M at d 64) and 15 (7680 at d 8) give near_k 40 in
    both packages."""
    jc = JConfig(particle_count=n, force_method=JForceMethod.BARNES_HUT,
                 bh_max_level=level)
    p = tbh.bh_engine_params(config_from_reference(jc))
    assert p == jbh.bh_engine_params(jc)
    assert (p["near_engine"], p["near_k"]) == ("tiles", 40)


def test_bh_tiles_k40_matches_jax():
    """Barnes-Hut tiles at k 40 (N = 15·8³, ``bh_max_level`` 3, θ = 1)
    against JAX's XLA tiles path: rows within the cap atol 2e-5·max|a|
    (f32 order of the near and far sums); rows past it (if any) get the
    far A of their cell, the fused path's fallback."""
    n, levels, k = 15 * 8 ** 3, 3, 40
    pos, mass, _ = _sphere(n, 4.0, 8)
    tp, tmass = torch.from_numpy(pos), torch.from_numpy(mass)
    got = tbh.barnes_hut_forces(tp, tmass, 1.0, 0.1, 1.0, levels=levels,
                                near_k=k).numpy()
    want = np.asarray(jbh.barnes_hut_forces(
        jnp.asarray(pos), jnp.asarray(mass), 1.0, 0.1, 1.0, levels=levels,
        near_engine="tiles", near_k=k, multipole_order=2, near_impl="xla"))
    lo, cell, coords = tbh.bin_particles(tp, levels)
    grid = tsw.build_sorted_grid(tp, tmass, coords, 1 << levels)
    over = tsw.unsort_rows((tsw.sorted_ranks(grid.ids) >= k)[:, None],
                           grid.order)[:, 0].numpy()
    assert over.sum() < n // 100
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got[~over], want[~over], rtol=0,
                               atol=2e-5 * scale)


# --- package-level names ----------------------------------------------------


def test_reexports_match_jax():
    """Every public name of ``nbody_tpu`` and ``nbody_tpu.ops`` is exported
    by the port's package under the same name (the port adds
    ``SerializationError`` and ``config_from_reference``)."""
    assert set(nbody_tpu.__all__) <= set(nbody_tpu_torch.__all__)
    assert set(nbody_tpu_torch.__all__) - set(nbody_tpu.__all__) == {
        "SerializationError", "config_from_reference"}
    assert list(nbody_tpu_torch.ops.__all__) == list(nbody_tpu.ops.__all__)
    for name in nbody_tpu_torch.__all__ + nbody_tpu_torch.ops.__all__:
        mod = (nbody_tpu_torch.ops if name in nbody_tpu_torch.ops.__all__
               else nbody_tpu_torch)
        assert getattr(mod, name) is not None
    assert nbody_tpu_torch.ColorMode.DENSITY.name == "DENSITY"
    with pytest.raises(nbody_tpu_torch.NBodyError):
        nbody_tpu_torch.validate_time_step(-1.0)
