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
    window_spans,
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


def _span_sum(psort, lo, hi, eps, cutoff2=None):
    """The pair sum over exactly the rows of each target's spans, with no
    coordinate predicate: f32 terms rounded as the twin rounds them,
    summed in float64 → (N, 3)."""
    n, n_off = lo.shape
    length = (hi - lo).reshape(-1)
    tgt = torch.repeat_interleave(
        torch.arange(n).repeat_interleave(n_off), length)
    first = torch.cumsum(length, 0) - length
    src = (torch.repeat_interleave(lo.reshape(-1) - first, length)
           + torch.arange(int(length.sum())))
    dvec = psort[src, :3] - psort[tgt, :3]
    dx, dy, dz = dvec.unbind(-1)
    r2 = dx * dx + dy * dy + dz * dz
    inv = torch.rsqrt(r2 + eps * eps)
    w = psort[src, 3] * (inv * inv * inv)
    keep = r2 > 0.0
    if cutoff2 is not None:
        keep = keep & (r2 <= cutoff2)
    w = torch.where(keep, w, torch.zeros_like(w))
    return torch.zeros((n, 3), dtype=torch.float64).index_add_(
        0, tgt, (w[:, None] * dvec).double())


def _tgrid(pos, mass, d):
    """Torch-only sorted grid of float32 positions on a d³ grid of unit
    cells at the origin (coords clipped into the grid)."""
    pos = torch.from_numpy(pos)
    coords = torch.clamp(pos.floor().to(torch.int32), 0, d - 1)
    return tsw.build_sorted_grid(pos, torch.from_numpy(mass), coords, d,
                                 with_csort=True)


def _check_spans(g, **kw):
    """window_spans against the twin: the span pair sum equals the sweep
    to 1e-6·max|a| and the overflow is the same → (lo, hi, overflow)."""
    want, over = window_sweep_plain(g.psort, g.csort, g.cell_start, **kw)
    lo, hi, over_s = window_spans(
        g.csort, g.cell_start, d=kw["d"], offsets=kw["offsets"],
        z_hw=kw["z_hw"], window=kw["window"], block_size=kw["block_size"])
    assert bool((hi >= lo).all())
    assert int(over_s) == int(over)
    got = _span_sum(g.psort, lo, hi, kw["eps"], kw.get("cutoff2"))
    assert float(want.abs().max()) > 0
    _close(got.numpy(), want.numpy(), rel=1e-6)
    return lo, hi, over


@pytest.mark.parametrize(
    "form,ws", [("hash", 1), ("bh", 1), ("bh", 2)],
    ids=["hash-cutoff", "bh-ws1", "bh-ws2"])
def test_window_spans_are_the_sweep(form, ws):
    """Kernel K7's spans on the scenes of the parity tests above: the hash
    form with the cutoff (n 1500, d 8, W 1024, B 256) and the BH form at
    ws 1 and 2 (n 2300, ragged tail block)."""
    if form == "hash":
        tg, _, d = _grids(1500, 3, 4.0, seed=1)
        kw = dict(window=1024, cutoff2=1.2 * 1.2)
    else:
        tg, _, d = _grids(2300, 3, 5.0, seed=2)
        kw = dict(window=2048)
    _check_spans(tg, d=d, offsets=tsw.xy_ball(ws), z_hw=ws, block_size=256,
                 eps=0.1, **kw)


def test_window_spans_keep_the_overflow():
    """The W 64 fixture of test_overflow_counts_match_jax_xla: spans
    clipped by the window, the same overflow (> 0) and the same sums."""
    tg, _, d = _grids(2000, 3, 1.0, seed=3)
    lo, hi, over = _check_spans(tg, d=d, offsets=tsw.xy_ball(1), z_hw=1,
                                window=64, block_size=64, eps=0.1)
    assert int(over) > 0


def test_window_spans_are_empty_past_the_grid_edge():
    """A uniform cube filling a d = 4 grid, so every edge cell has rows
    in the column its ids would wrap into: those spans are empty, and a
    span taken from the wrapped id (the unguarded formula) would add
    pairs the sweep does not have."""
    rng = np.random.default_rng(11)
    d = 4
    pos = rng.uniform(0.0, d, (1200, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, 1200).astype(np.float32)
    g = _tgrid(pos, mass, d)
    offs = tsw.xy_ball(1)
    kw = dict(d=d, offsets=offs, z_hw=1, window=2048, block_size=128,
              eps=0.1)
    lo, hi, _ = _check_spans(g, **kw)
    c = g.csort.to(torch.int64)
    off = torch.tensor(offs)
    nx, ny = c[:, 0:1] + off[:, 0], c[:, 1:2] + off[:, 1]
    outside = (nx < 0) | (nx >= d) | (ny < 0) | (ny >= d)
    assert bool(outside.any()) and bool((hi[outside] == lo[outside]).all())
    # the wrapped id's z-run: in range and occupied for some edge targets
    col = (nx * d + ny) * d
    ok = outside & (col >= 0) & (col + d <= d ** 3)
    z0 = torch.clamp(c[:, 2:3] - 1, min=0)
    z1 = torch.clamp(c[:, 2:3] + 1, max=d - 1) + 1
    cs = g.cell_start.to(torch.int64)
    wrapped = torch.where(ok, cs[torch.where(ok, col + z1, 0)]
                          - cs[torch.where(ok, col + z0, 0)], 0)
    assert int(wrapped.sum()) > 0


def test_window_spans_of_a_cell_across_blocks():
    """One cell of 600 rows across blocks of 128 whose windows differ
    (W 650 clips the first block's window, anchored on an earlier cell,
    inside the cell's own z-run, and not the next block's): its targets' spans
    differ by block, and each block's sums and overflow are the sweep's."""
    rng = np.random.default_rng(12)
    d = 4
    big = rng.uniform(1.0, 2.0, (600, 3)).astype(np.float32)
    rest = rng.uniform(0.0, d, (500, 3)).astype(np.float32)
    pos = np.concatenate([big, rest])
    mass = rng.uniform(0.5, 1.5, pos.shape[0]).astype(np.float32)
    g = _tgrid(pos, mass, d)
    kw = dict(d=d, offsets=tsw.xy_ball(1), z_hw=1, window=650,
              block_size=128, eps=0.1)
    lo, hi, over = _check_spans(g, **kw)
    cell = (1 * d + 1) * d + 1
    rows = torch.nonzero(g.ids == cell).reshape(-1)
    assert rows.shape[0] >= 600
    blocks = torch.unique(rows // 128)
    assert blocks.shape[0] >= 5
    spans = {tuple(torch.cat([lo[r], hi[r]]).tolist()) for r in rows}
    assert len(spans) > 1 and int(over) > 0


@pytest.mark.parametrize("form", ["kernel", "closure"])
def test_overflow_out_accumulates_across_calls(form):
    """``overflow_out`` takes each call's overflow added to what it holds
    and comes back as the overflow; the accelerations are those of a call
    without it, bit for bit (the kernel's wrapper and the custom-closure
    sweep alike)."""
    tg, _, d = _grids(1500, 3, 4.0, seed=2)
    kw = dict(d=d, xy_offsets=tsw.xy_ball(1), z_halfwidth=1, window=64,
              block_size=128)
    if form == "kernel":
        kw.update(eps=0.1, cutoff2=1.44)
    else:
        kw.update(pair_weight=lambda r2, m: m / (r2 + 0.01))
    acc, over = tsw.window_sweep(tg, **kw)
    assert int(over) > 0
    total = torch.full((), 5, dtype=torch.int64)
    for k in (1, 2):
        acc_k, got = tsw.window_sweep(tg, overflow_out=total, **kw)
        assert got is total and int(total) == 5 + k * int(over)
        assert torch.equal(acc_k, acc)
