"""Dense cell-tile near-field engine: build, sweep and pickup phases.

PyTorch counterpart of the fused path of ``nbody_tpu/ops/tile_sweep.py``
(``tile_build_pallas`` → ``tile_sweep_pick`` → ``_slot_pickup_raw``). Each
finest cell holds at most k particles in a static slot array; particles
beyond k in a cell lose their near-field term and are counted in
``overflow``. When the far-field expansion is folded into the sweep
(Barnes-Hut), those overflow rows receive G·A of their cell (the
expansion at the cell centre) instead — the fused path's audited
fallback, which this package keeps; without it (the spatial hash's tiles
engine, ``tile_near_field``) they read zero.

The JAX package's ``tile_engine_fused`` gate encodes TPU lane arithmetic;
here the fused path applies to every (d, k). The gate survives only as the
condition of the frozen-grid contract (``tile_engine_fused``), so that both
packages choose the same stepping for the same config.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from nbody_tpu_torch.ops.scatter import tile_scatter
from nbody_tpu_torch.ops.sorted_window import SortedGrid, unsort_rows
from nbody_tpu_torch.ops.tile_near import tile_sweep_plane
from nbody_tpu_torch.utils.profiling import profile_phase


def tile_engine_fused(d: int, k: int) -> bool:
    """The JAX package's ``tile_engine_fused(d, k, "pallas")``: whole
    z-column scatter chunks of 128-lane blocks, 8-sublane slot groups and
    f32-exact dest ids (d³·k < 2²⁴). None of it limits the kernels here;
    this copy is kept so that both packages attach the frozen-grid contract
    (``with_meta``/``frozen``), and so choose the same stepping, for the
    same (d, k)."""
    g = 128 // math.gcd(d * k, 128)
    return (d % g == 0 and g * d * k <= 4096 and (k <= 8 or k % 8 == 0)
            and d * d * d * k < (1 << 24))


@dataclasses.dataclass
class TileBuild:
    """Dense slot tiles plus the per-row bookkeeping of the pickup.

    tiles_plane: (d, 4, k, d²) plane-major slot tensor
    rank_sorted: (N,) int32 rank within cell, sorted order
    overflow:    () int32 rows beyond the k-slot cap (device tensor)
    moments:     (11, d³) [m, m·xr(3), m·xr⊗xr(6), count] per cell
    """

    tiles_plane: torch.Tensor
    rank_sorted: torch.Tensor
    overflow: torch.Tensor
    moments: torch.Tensor

    @property
    def counts(self) -> torch.Tensor:
        """(d³,) exact per-cell occupancy (float)."""
        return self.moments[10]


def tile_build(grid: SortedGrid, lo, cell, *, d: int, k: int,
               rank_sorted=None) -> TileBuild:
    """Placement + moments (kernel K2) from a cell-sorted grid, ranks from
    the segment index (or ``rank_sorted``, cached by a frozen-grid caller:
    it depends only on the frozen ids), and the overflow audit from the
    exact counts."""
    rank = rank_sorted
    if rank is None:
        n = grid.psort.shape[0]
        rank = (
            torch.arange(n, dtype=torch.int32, device=grid.ids.device)
            - grid.cell_start[grid.ids]
        )
    tiles, moments = tile_scatter(
        grid.psort, grid.cell_start, lo, cell, d=d, k=k
    )
    overflow = torch.clamp(moments[10] - float(k), min=0.0).sum().to(
        torch.int32
    )
    return TileBuild(tiles_plane=tiles, rank_sorted=rank, overflow=overflow,
                     moments=moments)


def tile_sweep_pick(tb: TileBuild, grid: SortedGrid, lo, cell, far_plane,
                    *, d: int, ws: int, k: int, G: float, eps: float,
                    sorted_output: bool = False):
    """Sweep (kernel K4) seeded with the far expansion ``far_plane``
    (d, 19, d², unscaled by G) + pickup: G·(far + near) per row, in
    cell-sorted order when ``sorted_output`` else in original order."""
    dev = tb.tiles_plane.device
    with profile_phase("bh.sweep", device=dev):
        acc_raw = tile_sweep_plane(
            tb.tiles_plane, k=k, d=d, ws=ws, eps=eps, far_plane=far_plane,
            lo=lo, cell=cell, counts=tb.counts,
        )
    with profile_phase("bh.pickup", device=dev):
        far_a = far_plane[:, 0:3, :].permute(0, 2, 1).reshape(d * d * d, 3)
        return _slot_pickup_raw(acc_raw, grid, tb.rank_sorted, far_a, d, k,
                                G, sorted_output=sorted_output)


def tile_near_field(grid: SortedGrid, lo, cell, *, d: int, ws: int, k: int,
                    G: float, eps: float, cutoff2: float | None = None,
                    sorted_output: bool = False, rank_sorted=None):
    """Exact near field within the (2ws+1)³ cell ball on k-slot tiles
    (kernels K2 and K4), no far field: with ``cutoff2`` (raw r² ≤ cutoff²,
    tested before softening) this is the spatial hash's sparse-regime
    engine; without it, the Barnes-Hut monopole path's near field. Rows
    past the k cap read zero and are counted (``TileBuild.overflow``).
    Returns ``(acc, TileBuild)``, acc G-scaled in original order, or in the
    grid's cell-sorted order with ``sorted_output=True``. ``lo`` (3,) and
    ``cell`` are device tensors; ``rank_sorted`` as in ``tile_build``; the
    phases are timed as ``near.placement``, ``near.sweep`` and
    ``near.pickup``."""
    dev = grid.psort.device
    with profile_phase("near.placement", device=dev):
        tb = tile_build(grid, lo, cell, d=d, k=k, rank_sorted=rank_sorted)
    with profile_phase("near.sweep", device=dev):
        acc_raw = tile_sweep_plane(
            tb.tiles_plane, k=k, d=d, ws=ws, eps=eps, cutoff2=cutoff2,
            lo=lo, cell=cell, counts=tb.counts,
        )
    with profile_phase("near.pickup", device=dev):
        acc = _slot_pickup_raw(acc_raw, grid, tb.rank_sorted, None, d, k, G,
                               sorted_output=sorted_output)
    return acc, tb


def _slot_pickup_raw(acc_raw, grid: SortedGrid, rank_sorted, overflow_rows,
                     d: int, k: int, G: float, sorted_output: bool = False):
    """Per-particle pickup from the sweep's (d, 3, k, d²) output: one
    relayout to (cell·k + slot, 3) rows, then ONE row gather. Rows past the
    k cap are redirected by index to ``overflow_rows[cell]`` (d³, 3) — the
    far A of their cell — appended to the table; with ``overflow_rows``
    None they read one appended zero row."""
    ids = grid.ids.to(torch.int64)
    rank = rank_sorted.to(torch.int64)
    acc_t = (
        acc_raw.reshape(d, 3, k, d, d)       # (x, ch, slot, y, z)
        .permute(0, 3, 4, 2, 1)              # (x, y, z, slot, ch)
        .reshape(d * d * d * k, 3)
    )
    if overflow_rows is None:
        overflow_rows = acc_t.new_zeros((1, 3))
        spill = torch.zeros_like(ids)
    else:
        spill = ids
    table = torch.cat([acc_t, overflow_rows], dim=0)
    idx = torch.where(rank < k, ids * k + rank, d * d * d * k + spill)
    acc_sorted = G * table[idx]
    if sorted_output:
        return acc_sorted
    return unsort_rows(acc_sorted, grid.order)
