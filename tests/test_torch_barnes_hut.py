"""The Barnes-Hut slice as a whole: nbody_tpu_torch forces against the
JAX package's XLA tiles path and the f64 direct sum (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import barnes_hut as jbh
from nbody_tpu.ops.direct import direct_forces_reference
from nbody_tpu.types import ForceMethod as JForceMethod
from nbody_tpu.types import SimulationConfig as JConfig
from nbody_tpu_torch.ops import barnes_hut as tbh
from nbody_tpu_torch.ops.sorted_window import (
    build_sorted_grid,
    sorted_ranks,
    unsort_rows,
)
from nbody_tpu_torch.ops.tile_sweep import tile_build
from nbody_tpu_torch.state import config_from_reference

N, LEVELS, K, G, EPS, THETA = 1200, 3, 8, 1.0, 0.1, 0.5


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    r = np.cbrt(rng.uniform(size=N)) * 4.0
    v = rng.normal(size=(N, 3))
    pos = (v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None])
    pos = pos.astype(np.float32)
    mass = rng.uniform(0.5, 1.5, N).astype(np.float32)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    got = tbh.barnes_hut_forces(tp, tm, G, EPS, THETA, levels=LEVELS,
                                near_k=K).numpy()
    want = np.asarray(jbh.barnes_hut_forces(
        jnp.asarray(pos), jnp.asarray(mass), G, EPS, THETA, levels=LEVELS,
        near_engine="tiles", near_k=K, multipole_order=2, near_impl="xla"))
    lo, cell, coords = tbh.bin_particles(tp, LEVELS)
    grid = build_sorted_grid(tp, tm, coords, 1 << LEVELS)
    over = unsort_rows((sorted_ranks(grid.ids) >= K)[:, None],
                       grid.order)[:, 0].numpy()
    return dict(pos=pos, mass=mass, got=got, want=want, over=over,
                coords=coords.numpy())


def test_non_overflow_rows_match_jax(scene):
    """Rows within the k-slot cap: atol 2e-5·max|a| (f32 order of the
    near and far sums differs)."""
    over = scene["over"]
    assert over.sum() > 0, "the scene must exercise the overflow fallback"
    scale = float(np.abs(scene["want"]).max())
    np.testing.assert_allclose(scene["got"][~over], scene["want"][~over],
                               rtol=0, atol=2e-5 * scale)


def test_overflow_rows_get_far_a_of_their_cell(scene):
    """Rows past the cap lose their near term and receive exactly G·A of
    their cell (the fused path's fallback); the far field itself is held
    against the JAX package in test_torch_far_taps.py."""
    tp = torch.from_numpy(scene["pos"])
    lo, cell, coords = tbh.bin_particles(tp, LEVELS)
    packed = tile_build(
        build_sorted_grid(tp, torch.from_numpy(scene["mass"]), coords,
                          1 << LEVELS), lo, cell, d=1 << LEVELS, k=K,
    ).moments[:10].T.reshape((1 << LEVELS,) * 3 + (10,))
    pyr = tbh.pyramid_from_packed(packed, lo, cell, LEVELS)
    a_far = tbh.far_field_grid(pyr, tbh.theta_to_ws(THETA, order=2), 1.0,
                               EPS, LEVELS)[0].numpy()
    c = scene["coords"][scene["over"]]
    np.testing.assert_array_equal(scene["got"][scene["over"]],
                                  G * a_far[c[:, 0], c[:, 1], c[:, 2]])


def test_error_against_f64_direct(scene):
    """Median relative error vs the f64 direct sum < 0.05 (the JAX
    package's bound)."""
    exact = np.asarray(direct_forces_reference(
        jnp.asarray(scene["pos"]), jnp.asarray(scene["mass"]), G, EPS,
        dtype=jnp.float64))
    rel = (np.linalg.norm(scene["got"] - exact, axis=1)
           / np.maximum(np.linalg.norm(exact, axis=1), 1e-30))
    assert np.median(rel) < 0.05


def test_sorted_equals_unsorted(scene):
    """The sorted pipeline is the same computation: unsorting its output
    gives the unsorted forces exactly, and psort = [pos | mass][order]."""
    tp = torch.from_numpy(scene["pos"])
    tm = torch.from_numpy(scene["mass"])
    acc_s, psort, order = tbh.barnes_hut_forces_sorted(
        tp, tm, G, EPS, THETA, levels=LEVELS, near_k=K)
    np.testing.assert_array_equal(unsort_rows(acc_s, order).numpy(),
                                  scene["got"])
    np.testing.assert_array_equal(
        psort.numpy(), torch.cat([tp, tm[:, None]], 1)[order].numpy())


@pytest.mark.parametrize(
    "n,level,theta", [(1_000_000, 6, 0.5), (5000, 3, 0.5), (800, 3, 0.3),
                      (100_000, 4, 1.0)])
def test_engine_params_match_jax(n, level, theta):
    jc = JConfig(particle_count=n, force_method=JForceMethod.BARNES_HUT,
                 bh_max_level=level, barnes_hut_theta=theta)
    assert tbh.bh_engine_params(config_from_reference(jc)) == \
        jbh.bh_engine_params(jc)


def test_window_engine_raises_not_implemented():
    """Occupancy above 24 per finest cell selects the window engine. It is
    ported now: neither factory raises any longer; the plain factory runs
    the window engine and the sorted factory returns None (no sorted
    contract, as in the JAX package), so run_steps steps unsorted."""
    jc = JConfig(particle_count=100_000, force_method=JForceMethod.BARNES_HUT,
                 bh_max_level=3)
    cfg = config_from_reference(jc)
    assert tbh.bh_engine_params(cfg)["near_engine"] == "window"
    assert callable(tbh.make_barnes_hut_forces(cfg))
    assert tbh.make_barnes_hut_forces_sorted(cfg) is None
    assert jbh.make_barnes_hut_forces_sorted(jc) is None
