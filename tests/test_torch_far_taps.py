"""nbody_tpu_torch far field (kernel K3's plain twin, the tap matrices,
the pyramid and the whole far_field_grid) against the JAX package (CPU),
and the downward pass's plain twin against the torch composition.

Tolerance 2e-5·max|out| against JAX: every quantity is an f32 sum of up to
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
from nbody_tpu_torch.ops.far_down import far_down, far_down_plain
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


def _random_pyramid(levels, seed):
    """A pyramid from random finest order-2 moments at d = 2^levels."""
    rng = np.random.default_rng(seed)
    d = 1 << levels
    packed = rng.normal(0.0, 0.1, (d, d, d, 10)).astype(np.float32)
    packed[..., 0] = rng.uniform(0.0, 1.0, (d, d, d))
    packed = torch.from_numpy(packed)
    lo, cell = torch.tensor([-1.0, -2.0, 0.5]), torch.tensor(0.37)
    return packed, lo, cell, tbh.pyramid_from_packed(packed, lo, cell, levels)


@pytest.mark.parametrize("levels", [2, 3, 4, 5, 6])
def test_far_down_plain_equals_the_composition(levels):
    """The downward pass's plain twin, on K3's outputs of every level, is
    bit for bit the far plane of far_field_grid, cat, reshape, permute and
    contiguous."""
    _, _, cell, pyr = _random_pyramid(levels, 30 + levels)
    d = 1 << levels
    a_far, j_far, h_far = tbh.far_field_grid(pyr, WS, 1.0, EPS, levels)
    want = (torch.cat([a_far, j_far, h_far], dim=-1)
            .reshape(d, d * d, 19).permute(0, 2, 1).contiguous())
    got = far_down_plain(tbh._far_taps_levels(pyr, WS, EPS, levels), cell)
    assert got.shape == (d, 19, d * d) and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("levels", [2, 3, 4, 5, 6])
def test_far_plane_grid_takes_the_twin_on_cpu(levels):
    """far_plane_grid on CPU tensors runs the twin once and launches
    nothing."""
    packed, lo, cell, pyr = _random_pyramid(levels, 40 + levels)
    launches, calls = far_down.launches, far_down_plain.calls
    got = tbh.far_plane_grid(packed, lo, cell, levels=levels, ws=WS, eps=EPS)
    assert far_down.launches == launches
    assert far_down_plain.calls == calls + 1
    want = far_down_plain(tbh._far_taps_levels(pyr, WS, EPS, levels), cell)
    assert torch.equal(got, want)
