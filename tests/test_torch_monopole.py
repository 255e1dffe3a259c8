"""Monopole (order-1) Barnes-Hut: nbody_tpu_torch against the JAX package
on one shared numpy scene (CPU) — the pyramid, the COM far field, the
forces on the tiles engine (against the JAX XLA path; the JAX sorted
path is in test_torch_monopole_sorted.py) and on the window engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import barnes_hut as jbh
from nbody_tpu.ops import sorted_window as jsw
from nbody_tpu.ops.direct import direct_forces_reference
from nbody_tpu_torch.ops import barnes_hut as tbh
from nbody_tpu_torch.ops.sorted_window import (
    build_sorted_grid,
    sorted_ranks,
    unsort_rows,
)

N, LEVELS, K, G, EPS = 1500, 3, 8, 1.0, 0.1
D = 1 << LEVELS


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(11)
    r = np.cbrt(rng.uniform(size=N)) * 4.0
    v = rng.normal(size=(N, 3))
    pos = (v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None])
    pos = pos.astype(np.float32)
    mass = rng.uniform(0.5, 1.5, N).astype(np.float32)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    lo, cell, coords = tbh.bin_particles(tp, LEVELS)
    grid = build_sorted_grid(tp, tm, coords, D, with_csort=True)
    over = unsort_rows((sorted_ranks(grid.ids) >= K)[:, None],
                       grid.order)[:, 0].numpy()
    return dict(pos=pos, mass=mass, tp=tp, tm=tm, lo=lo, cell=cell,
                coords=coords, grid=grid, over=over,
                jp=jnp.asarray(pos), jm=jnp.asarray(mass))


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("route", ["scatter", "segment_sum"])
def test_pyramid_matches_jax(scene, route):
    """Order-1 masses and absolute Σ m·x per level, from the scatter-add
    (``build_pyramid``) or from the sorted rows' segment sum (the monopole
    tiles path): atol 1e-6·max per level (f32 sums in another order)."""
    want = jbh.build_pyramid(scene["jp"], scene["jm"], LEVELS, order=1)
    if route == "scatter":
        got = tbh.build_pyramid(scene["tp"], scene["tm"], LEVELS, order=1)
    else:
        packed = tbh._sorted_finest_moments(scene["grid"], D)
        got = tbh.pyramid_from_packed(packed, scene["lo"], scene["cell"],
                                      LEVELS, order=1)
    assert got.quads == () and got.srels == ()
    assert len(got.masses) == len(got.msums) == LEVELS + 1
    for g, w in zip(got.masses + got.msums, want.masses + want.msums):
        _close(g.numpy(), w, 1e-6)


def test_sorted_finest_moments_match_jax_segment_sum(scene):
    """The finest [m, m·x] moments of the monopole tiles path against the
    JAX package's own sorted route (its segment-sum kernel in interpret
    mode on its own sorted grid): atol 1e-6·max, empty cells exactly 0."""
    got = tbh._sorted_finest_moments(scene["grid"], D).numpy()
    coords = jnp.asarray(scene["coords"].numpy())
    jgrid = jsw.build_sorted_grid(scene["jp"], scene["jm"], coords, D)
    want = np.asarray(jbh._sorted_finest_moments(
        jgrid, jgrid.ids, jnp.asarray(scene["lo"].numpy()),
        jnp.asarray(scene["cell"].numpy()), D, 1, interpret=True))
    assert got.shape == want.shape == (D, D, D, 4)
    assert (want[..., 0] == 0).any(), "the scene must leave empty cells"
    assert (got[want[..., 0] == 0] == 0).all()
    _close(got, want, 1e-6)


def test_far_field_matches_jax(scene):
    """The COM far field (ws 2) on the JAX pyramid's own grids: A and J6
    atol 2e-6·max (f32 sums over offsets and source children in another
    order); no Hessian at order 1."""
    jp = jbh.build_pyramid(scene["jp"], scene["jm"], LEVELS, order=1)
    pyr = tbh.Pyramid(
        masses=tuple(torch.tensor(np.asarray(m)) for m in jp.masses),
        lo=torch.tensor(np.asarray(jp.lo)),
        cell=torch.tensor(np.asarray(jp.cell)),
        msums=tuple(torch.tensor(np.asarray(s)) for s in jp.msums))
    ja, jj, jh = jax.jit(
        lambda p: jbh.far_field_grid(p, 2, G, EPS, LEVELS))(jp)
    ta, tj, th = tbh.far_field_grid(pyr, 2, G, EPS, LEVELS)
    assert jh is None and th is None
    _close(ta.numpy(), ja, 2e-6)
    _close(tj.numpy(), jj, 2e-6)


@pytest.fixture(scope="module")
def forces(scene):
    """The port's monopole tiles forces (θ 0.5 → ws 2) and the JAX XLA
    path's (``near_impl="xla"``)."""
    got = tbh.barnes_hut_forces(scene["tp"], scene["tm"], G, EPS, 0.5,
                                levels=LEVELS, near_k=K,
                                multipole_order=1).numpy()
    want = np.asarray(jbh.barnes_hut_forces(
        scene["jp"], scene["jm"], G, EPS, 0.5, levels=LEVELS,
        near_engine="tiles", near_k=K, multipole_order=1, near_impl="xla"))
    return got, want


def test_forces_match_jax_xla(scene, forces):
    """Every row, those past the k cap included: atol 2e-5·max|a|."""
    got, want = forces
    assert scene["over"].sum() > 0, "the scene must overflow the k cap"
    _close(got, want, 2e-5)


def test_overflow_rows_read_the_far_field_only(scene, forces):
    """Rows past the k cap get zero near field, so their force is the far
    expansion A + J·δ of their cell alone (atol 1e-6·max|a|)."""
    got, _ = forces
    pyr = tbh.build_pyramid(scene["tp"], scene["tm"], LEVELS, order=1)
    a_far, j_far, _ = tbh.far_field_grid(pyr, 2, G, EPS, LEVELS)
    c = scene["coords"].to(torch.int64)[torch.from_numpy(scene["over"])]
    pos = scene["tp"][torch.from_numpy(scene["over"])]
    delta = pos - (scene["lo"] + (c.to(pos.dtype) + 0.5) * scene["cell"])
    far = a_far[c[:, 0], c[:, 1], c[:, 2]] + tbh.sym_matvec(
        j_far[c[:, 0], c[:, 1], c[:, 2]], delta)
    np.testing.assert_allclose(got[scene["over"]], far.numpy(), rtol=0,
                               atol=1e-6 * float(np.abs(got).max()))


def test_error_against_f64_direct(scene, forces):
    """Median relative error vs the f64 direct sum < 0.05 (the JAX
    package's Barnes-Hut bound)."""
    got, _ = forces
    exact = np.asarray(direct_forces_reference(
        scene["jp"], scene["jm"], G, EPS, dtype=jnp.float64))
    rel = (np.linalg.norm(got - exact, axis=1)
           / np.maximum(np.linalg.norm(exact, axis=1), 1e-30))
    assert np.median(rel) < 0.05


def test_sorted_equals_unsorted(scene, forces):
    """The sorted monopole call is the same computation: unsorting its
    output gives the unsorted forces exactly; psort = [pos | mass][order]."""
    acc_s, psort, order = tbh.barnes_hut_forces_sorted(
        scene["tp"], scene["tm"], G, EPS, 0.5, levels=LEVELS, near_k=K,
        multipole_order=1)
    np.testing.assert_array_equal(unsort_rows(acc_s, order).numpy(),
                                  forces[0])
    np.testing.assert_array_equal(
        psort.numpy(),
        torch.cat([scene["tp"], scene["tm"][:, None]], 1)[order].numpy())


def test_window_engine_matches_jax(scene):
    """Order 1 on the window near engine (scatter-add pyramid, COM far
    field, the sorted-window sweep at ws 2) against the JAX package's
    window engine: atol 2e-5·max|a|."""
    kw = dict(levels=LEVELS, near_engine="window", window=2048,
              multipole_order=1)
    got = tbh.barnes_hut_forces(scene["tp"], scene["tm"], G, EPS, 0.5, **kw)
    want = jbh.barnes_hut_forces(scene["jp"], scene["jm"], G, EPS, 0.5,
                                 near_impl="xla", **kw)
    _close(got.numpy(), want, 2e-5)
