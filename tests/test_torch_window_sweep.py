"""Kernel K7's plain twin and the sorted-window engine of nbody_tpu_torch
against the JAX package's ``window_sweep`` (XLA path) and
``window_sweep_pallas`` (interpret mode), on the same numpy inputs (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import sorted_window as jsw
from nbody_tpu.ops.pallas_window_sweep import window_sweep_pallas
from nbody_tpu_torch.ops import sorted_window as tsw
from nbody_tpu_torch.ops.barnes_hut import bin_particles
from nbody_tpu_torch.ops.window_sweep import (
    block_rows,
    window_starts,
    window_sweep_kernel,
    window_sweep_plain,
)


def _sphere(n, radius, seed):
    rng = np.random.default_rng(seed)
    r = np.cbrt(rng.uniform(size=n)) * radius
    v = rng.normal(size=(n, 3))
    pos = v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None]
    return pos.astype(np.float32), rng.uniform(0.5, 1.5, n).astype(np.float32)


def _grids(n, levels, radius, seed):
    """The same numpy scene binned and sorted by both packages (coords,
    order and cell_start must agree exactly)."""
    pos, mass = _sphere(n, radius, seed)
    d = 1 << levels
    coords = bin_particles(torch.from_numpy(pos), levels)[2]
    tg = tsw.build_sorted_grid(torch.from_numpy(pos), torch.from_numpy(mass),
                               coords, d, with_csort=True)
    jg = jsw.build_sorted_grid(jnp.asarray(pos), jnp.asarray(mass),
                               jnp.asarray(coords.numpy()), d)
    np.testing.assert_array_equal(tg.order.numpy(), np.asarray(jg.order))
    np.testing.assert_array_equal(tg.csort.numpy(), np.asarray(jg.csort))
    np.testing.assert_array_equal(tg.cell_start.numpy(),
                                  np.asarray(jg.cell_start))
    return tg, jg, d


def _close(got, want, rel=2e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def test_plain_matches_jax_xla_and_pallas():
    """The hash form (cutoff 1.2, z_hw 1, 9 offsets) at n 1500, d 8,
    W 1024, B 256 (the scene of test_pallas_kernels'
    test_window_sweep_pallas_matches_xla): atol 2e-5·max|a| against both
    JAX forms (f32 summation order differs), overflow 0 in all three."""
    tg, jg, d = _grids(1500, 3, 4.0, seed=1)
    kw = dict(d=d, xy_offsets=tsw.xy_ball(1), z_halfwidth=1, window=1024,
              block_size=256, eps=0.1, cutoff2=1.2 * 1.2)
    got, over = tsw.window_sweep(tg, **kw)
    want, over_x = jsw.window_sweep(jg, impl="xla", **kw)
    starts, nch, over_p = jsw._window_starts(
        jg, d=d, xy_offsets=jsw.xy_ball(1), z_halfwidth=1, window=1024,
        block_size=256)
    acc_p = window_sweep_pallas(
        jg.psort, jg.csort, starts, nch, offsets=jsw.xy_ball(1),
        block_size=256, window=1024, z_hw=1, eps=0.1, cut2=1.2 * 1.2,
        interpret=True)
    acc_p = jsw.unsort_rows(acc_p[:1500], jg.order)
    assert int(over) == int(over_x) == int(over_p) == 0
    assert np.abs(np.asarray(want)).max() > 0
    _close(got.numpy(), want)
    _close(got.numpy(), acc_p)


@pytest.mark.parametrize("ws", [1, 2])
def test_barnes_hut_form_matches_jax(ws):
    """The BH near-field form: no cutoff, z_hw = ws, (2ws+1)² offsets, a
    ragged tail block (n 2300, B 256): atol 2e-5·max|a|, overflow 0."""
    tg, jg, d = _grids(2300, 3, 5.0, seed=2)
    kw = dict(d=d, xy_offsets=tsw.xy_ball(ws), z_halfwidth=ws, window=2048,
              block_size=256, eps=0.1)
    got, over = tsw.window_sweep(tg, **kw)
    want, over_x = jsw.window_sweep(jg, impl="xla", **kw)
    assert int(over) == int(over_x) == 0
    _close(got.numpy(), want)


def test_overflow_counts_match_jax_xla():
    """A too-small window (W 64, B 64, a dense ball as
    test_short_range_engines' test_window_overflow_counted): the same
    overflow count as the JAX XLA path, and the same partial sums (both
    cover [win_start, win_start + W))."""
    tg, jg, d = _grids(2000, 3, 1.0, seed=3)
    kw = dict(d=d, xy_offsets=tsw.xy_ball(1), z_halfwidth=1, window=64,
              block_size=64, eps=0.1)
    got, over = tsw.window_sweep(tg, sorted_output=True, **kw)
    want, over_x = jsw.window_sweep(jg, impl="xla", sorted_output=True, **kw)
    assert int(over) == int(over_x) > 0
    _close(got.numpy(), want)


def test_target_blocks_and_window_starts():
    """A subset of target blocks gives those rows of the full sweep (to
    1e-6·max|a|: a chunk pads its rows to its own longest span, which
    changes the f32 reduction tree); the windows' overflow is the sum the
    sweep reports."""
    tg, _, d = _grids(1000, 3, 3.0, seed=4)
    kw = dict(d=d, offsets=tsw.xy_ball(1), z_hw=1, window=128,
              block_size=64, eps=0.1, cutoff2=2.0)
    full, over = window_sweep_plain(tg.psort, tg.csort, tg.cell_start, **kw)
    blocks = torch.tensor([0, 5, 15])  # 15 is the ragged tail (1000 = 15·64 + 40)
    part, _ = window_sweep_plain(tg.psort, tg.csort, tg.cell_start,
                                 target_blocks=blocks, **kw)
    rows = block_rows(blocks, 1000, 64)
    assert rows.shape[0] == 2 * 64 + 40
    _close(part.numpy(), full[rows].numpy(), rel=1e-6)
    ws0, end, over_w = window_starts(tg.csort, tg.cell_start, d=d,
                                     offsets=tsw.xy_ball(1), z_hw=1,
                                     window=128, block_size=64)
    assert ws0.shape == end.shape == (16, 9)
    assert bool((end >= ws0).all()) and int(over_w) == int(over)


def test_wrapper_takes_plain_twin_only_on_cpu():
    """CPU tensors run the plain twin (its call count moves, the kernel's
    launch count does not); a tensor on another device is refused."""
    tg, _, d = _grids(300, 2, 2.0, seed=5)
    kw = dict(d=d, offsets=tsw.xy_ball(1), z_hw=1, window=256,
              block_size=128, eps=0.1)
    calls, launches = window_sweep_plain.calls, window_sweep_kernel.launches
    window_sweep_kernel(tg.psort, tg.csort, tg.cell_start, **kw)
    assert window_sweep_plain.calls == calls + 1
    assert window_sweep_kernel.launches == launches
    meta = [t.to("meta") for t in (tg.psort, tg.csort, tg.cell_start)]
    with pytest.raises(ValueError, match="not supported"):
        window_sweep_kernel(*meta, **kw)
