"""nbody_tpu_torch far field (kernel K3's plain twin, the tap matrices,
the pyramid and the whole far_field_grid) against the JAX package (CPU).

Tolerance 2e-5·max|out| throughout: every quantity is an f32 sum of up to
27·80 products taken in another order than XLA's HIGHEST-precision dots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import barnes_hut as jbh
from nbody_tpu.ops.pallas_far_taps import far_taps_pallas
from nbody_tpu_torch.ops import barnes_hut as tbh
from nbody_tpu_torch.ops.far_taps import far_taps

LEVELS, WS, EPS = 3, 1, 0.1


def _close(got, want, rel=2e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=rel * max(float(np.abs(want).max()), 1e-30))


@pytest.fixture(scope="module")
def pyramids():
    rng = np.random.default_rng(5)
    n = 2000
    pos = rng.normal(0.0, 2.0, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    jp, jm = jnp.asarray(pos), jnp.asarray(mass)
    d = 1 << LEVELS
    lo, cell = jbh.pyramid_geometry(jnp.min(jp, axis=0),
                                    jnp.max(jp, axis=0), LEVELS)
    coords = jnp.clip(((jp - lo) / cell).astype(jnp.int32), 0, d - 1)
    packed = jax.jit(jbh.scatter_finest_moments, static_argnums=(5, 6))(
        jp, jm, coords, lo, cell, d, 2)
    jpyr = jax.jit(jbh.pyramid_from_packed, static_argnums=(3, 4))(
        packed, lo, cell, LEVELS, 2)
    tpyr = tbh.pyramid_from_packed(
        torch.tensor(np.asarray(packed)), torch.tensor(np.asarray(lo)),
        torch.tensor(float(cell)), LEVELS)
    return jpyr, tpyr


def test_pyramid_matches_jax(pyramids):
    jpyr, tpyr = pyramids
    for lvl in range(LEVELS + 1):
        _close(tpyr.masses[lvl], jpyr.masses[lvl])
        _close(tpyr.srels[lvl], jpyr.srels[lvl])
        _close(tpyr.quads[lvl], jpyr.quads[lvl])


def test_tap_matrices_match_jax():
    """Vectorized tap-matrix build vs the JAX per-entry build on random
    displacements (rel 2e-5 of each matrix entry's largest magnitude)."""
    rng = np.random.default_rng(6)
    dvec = rng.uniform(-3.0, 3.0, (200, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jbh._conv_taps_kernel(v, EPS))(
        jnp.asarray(dvec)))
    got = tbh._conv_taps_kernel(torch.from_numpy(dvec), EPS).numpy()
    assert got.shape == want.shape == (200, 19, 10)
    _close(got, want)


@pytest.mark.parametrize("lvl", [1, 2, 3])
def test_far_conv_level_matches_jax_xla(pyramids, lvl):
    """One level's (A, J, H) through the port's tap sum vs JAX's XLA scan
    at HIGHEST precision."""
    jpyr, tpyr = pyramids
    want = jax.jit(lambda pyr: jbh._far_conv_level(
        pyr, lvl, WS, EPS, LEVELS, impl="xla"))(jpyr)
    got = tbh._far_conv_level(tpyr, lvl, WS, EPS, LEVELS)
    for g, w in zip(got, want):
        _close(g, w)


def test_far_taps_plain_matches_pallas_interpret():
    """The plain tap sum vs the JAX Pallas kernel in interpret mode at
    p = 4 on random moments and tap matrices."""
    rng = np.random.default_rng(7)
    p = 4
    mom = rng.normal(size=(80, p, p, p)).astype(np.float32)
    taps = rng.normal(size=(27, 152, 80)).astype(np.float32)
    want = far_taps_pallas(jnp.asarray(mom), jnp.asarray(taps), p=p, ws=1,
                           interpret=True)
    got = far_taps(torch.from_numpy(mom).reshape(80, p ** 3),
                   torch.from_numpy(taps), p=p, ws=1)
    _close(got, want)


def test_far_field_grid_matches_jax(pyramids):
    """The whole far field (all levels + the downward translation)."""
    jpyr, tpyr = pyramids
    want = jax.jit(lambda pyr: jbh.far_field_grid(
        pyr, WS, 1.0, EPS, LEVELS))(jpyr)
    got = tbh.far_field_grid(tpyr, WS, 1.0, EPS, LEVELS)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)
