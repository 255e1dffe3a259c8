"""nbody_tpu_torch near sweep (kernel K4's plain twin) against the JAX
Pallas sweep in interpret mode and against a numpy re-computation (CPU).

Tolerance 2e-5·max|out|: f32 pair sums over 27·k sources in another
order. Versions differ by design on dead slots (the TPU kernel writes
zeros or filler values, the port zeros), which are never picked up, so the
JAX comparison is on live slots only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops.pallas_tile_near import tile_sweep_pallas_plane
from nbody_tpu_torch.ops.barnes_hut import bin_particles
from nbody_tpu_torch.ops.sorted_window import build_sorted_grid
from nbody_tpu_torch.ops.tile_near import (
    tile_sweep_plane,
    tile_sweep_plane_plain,
)
from nbody_tpu_torch.ops.tile_sweep import tile_build


def reference_sweep(tiles_plane, ws, eps, cutoff2=None):
    """float64 numpy sweep over (d, 4, k, d²) tiles, every slot live."""
    d, _, k, _ = tiles_plane.shape
    t = tiles_plane.astype(np.float64).reshape(d, 4, k, d, d)
    t = t.transpose(2, 1, 0, 3, 4)                      # (k, 4, d, d, d)
    pad = np.zeros((k, 4) + (d + 2 * ws,) * 3)
    pad[:, :, ws:ws + d, ws:ws + d, ws:ws + d] = t
    acc = np.zeros((k, 3, d, d, d))
    r = range(2 * ws + 1)
    for xo in r:
        for yo in r:
            for zo in r:
                s = pad[:, :, xo:xo + d, yo:yo + d, zo:zo + d]
                for kt in range(k):
                    dx = s[:, 0] - t[kt, 0]
                    dy = s[:, 1] - t[kt, 1]
                    dz = s[:, 2] - t[kt, 2]
                    r2 = dx * dx + dy * dy + dz * dz
                    with np.errstate(divide="ignore", invalid="ignore"):
                        w = s[:, 3] * (r2 + eps * eps) ** -1.5
                    if cutoff2 is not None:
                        w = np.where(r2 <= cutoff2, w, 0.0)
                    w = np.where(r2 == 0.0, 0.0, w)
                    acc[kt, 0] += (w * dx).sum(0)
                    acc[kt, 1] += (w * dy).sum(0)
                    acc[kt, 2] += (w * dz).sum(0)
    return acc.reshape(k, 3, d, d * d).transpose(2, 1, 0, 3)


def _close(got, want, rel=2e-5):
    np.testing.assert_allclose(
        got, want, rtol=0, atol=rel * max(float(np.abs(want).max()), 1e-30))


def _random_tiles(d, k, seed, n_live=2):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 8.0, (d, 3, k, d * d)).astype(np.float32)
    mass = rng.uniform(0.0, 1.0, (d, 1, k, d * d)).astype(np.float32)
    mass[:, :, n_live:] = 0.0                           # empty slots
    return np.concatenate([pos, mass], axis=1)


def test_sweep_with_far_seed_matches_pallas_interpret():
    """Realistic slot tiles (a spherical scene at d = 8, k = 8 built by
    the port) with a random 19-channel far expansion: the port's sweep vs
    the JAX Pallas kernel in interpret mode, on live slots."""
    d, k, ws, eps = 8, 8, 1, 0.1
    rng = np.random.default_rng(11)
    n = 1500
    r = np.cbrt(rng.uniform(size=n)) * 4.0
    v = rng.normal(size=(n, 3))
    pos = (v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None])
    pos = pos.astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    lo, cell, coords = bin_particles(tp, 3)
    tb = tile_build(build_sorted_grid(tp, tm, coords, d), lo, cell, d=d, k=k)
    far = rng.normal(0.0, 1.0, (d, 19, d * d)).astype(np.float32)

    got = tile_sweep_plane(
        tb.tiles_plane, k=k, d=d, ws=ws, eps=eps,
        far_plane=torch.from_numpy(far), lo=lo, cell=cell, counts=tb.counts,
    ).numpy()
    want = np.asarray(tile_sweep_pallas_plane(
        jnp.asarray(tb.tiles_plane.numpy()), k=k, d=d, ws=ws, eps=eps,
        far_plane=jnp.asarray(far), lo=jnp.asarray(lo.numpy()),
        cell=jnp.asarray(float(cell)), interpret=True,
    ))[..., :d * d]
    live = np.arange(k)[None, :, None] < tb.counts.numpy().reshape(d, 1, -1)
    live3 = np.broadcast_to(live[:, None], got.shape)
    assert live3.sum() == 3 * n - 3 * int(tb.overflow)
    _close(got[live3], want[live3], rel=2e-5)
    assert (got[~live3] == 0.0).all()


@pytest.mark.parametrize(
    "ws,eps,cutoff2",
    [(1, 0.1, 1.2 ** 2), (1, 0.0, None), (2, 0.05, None),
     (1, 1e-13, None), (1, 1e-6, None)],
    ids=["cutoff2", "eps0", "ws2", "eps1e-13", "eps1e-6"],
)
def test_sweep_matches_numpy_reference(ws, eps, cutoff2):
    """Every slot live (no counts): the raw-r² cutoff tested before
    softening, the ε = 0 self-pair guard, a wider window, and the
    self-pair guard at ε = 1e-13 and 1e-6 (on either side of the least ε²
    of the CUDA kernel's loop without the guard, 1e-12), where a guard
    that let the self pair through would give 0·inf."""
    d, k = 6, 4
    tiles = _random_tiles(d, k, seed=12)
    want = reference_sweep(tiles, ws, eps, cutoff2)
    got = tile_sweep_plane(torch.from_numpy(tiles), k=k, d=d, ws=ws,
                           eps=eps, cutoff2=cutoff2).numpy()
    assert np.isfinite(got).all()
    _close(got, want)


def test_counts_mark_dead_slots():
    """With counts, slots at or past a cell's count read exactly 0 and
    dead sources are ignored; live slots equal the all-live sweep when the
    dead slots carry no mass."""
    d, k, ws = 6, 4, 1
    tiles = _random_tiles(d, k, seed=13, n_live=2)
    counts = np.full(d ** 3, 2.0, np.float32)
    t = torch.from_numpy(tiles)
    got = tile_sweep_plane_plain(t, k=k, d=d, ws=ws, eps=0.1,
                                 counts=torch.from_numpy(counts)).numpy()
    full = tile_sweep_plane_plain(t, k=k, d=d, ws=ws, eps=0.1).numpy()
    assert (got[:, :, 2:] == 0.0).all()
    np.testing.assert_array_equal(got[:, :, :2], full[:, :, :2])

