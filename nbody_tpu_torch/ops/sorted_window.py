"""Cell-sorted particle arrays and the sorted-window sweep engine.

PyTorch counterpart of ``nbody_tpu/ops/sorted_window.py``: bin, stable
argsort by linear cell id, one payload gather with the sorted ids and the
per-row cell coordinates (``ops/payload_gather.py``; a caller's ``extra``
columns ride it), the per-cell segment index; and ``window_sweep``, the
short-range engine shared by the spatial hash and the Barnes-Hut "window"
near field (kernel K7, ``ops/window_sweep.py``; a caller's
``pair_weight`` closure runs on its plain sweep). Cell ids stay int32
throughout (the JAX package's f32 id columns, bitcast routes and
recomputed ids exist for TPU reasons and are not ported).

The sweep: rows sorted by row-major cell id (x major, z fastest) make the
sources of any contiguous z-run of cells contiguous, so a block of sorted
targets finds every source of one (dx, dy) offset in one run of rows. Pair
validity is exact cell-coordinate equality, so a misplaced window can only
MISS pairs, never double count; misses are counted in ``overflow`` (raise
``window`` until it reads 0).
"""

from __future__ import annotations

import dataclasses

import torch

from nbody_tpu_torch.ops.payload_gather import payload_gather
from nbody_tpu_torch.ops.window_sweep import (
    window_sweep_kernel,
    window_sweep_plain,
)


@dataclasses.dataclass
class SortedGrid:
    """Cell-sorted particle arrays + segment index.

    order:      (N,) int64 sort permutation (sorted row i is original row
                order[i])
    psort:      (N, 4) x, y, z, mass in sorted order
    ids:        (N,) int32 linear cell ids in sorted order (non-decreasing)
    cell_start: (C + 1,) int32 first sorted index of each linear cell id
                (empty cells point at the next occupied one; N at the end),
                None when built with ``with_cell_start=False``
    csort:      (N, 3) int32 cell coordinates in sorted order, derived from
                the ids with their own stride d (None when built with
                ``with_csort=False``: only the window sweep reads them)
    extra:      (N, E) the caller's payload rows in sorted order, carried
                by the same gather as ``psort`` (None without ``extra``)
    """

    order: torch.Tensor
    psort: torch.Tensor
    ids: torch.Tensor
    cell_start: torch.Tensor | None
    csort: torch.Tensor | None = None
    extra: torch.Tensor | None = None


@dataclasses.dataclass
class FrozenGridMeta:
    """What a cell-sorted tiles engine derives from its sort, cached so a
    FROZEN-GRID step (``integrator.make_resort_multi_step``) can skip the
    sort and the payload gather: the rows keep the last re-sort's order
    and cell assignment while their positions move. Counterpart of the JAX
    package's ``FrozenGridMeta``.

    ids:        (N,) int32 non-decreasing cell ids (sorted order)
    rank:       (N,) int32 rank within the cell run
    lo:         (3,) grid origin at the last re-sort (the frozen binning)
    cell:       () cell size
    cell_start: (d³ + 1,) int32 segment index of ``ids`` (kernel K2 reads
                it; frozen with the ids)
    """

    ids: torch.Tensor
    rank: torch.Tensor
    lo: torch.Tensor
    cell: torch.Tensor
    cell_start: torch.Tensor


def cell_ids(coords: torch.Tensor, d: int) -> torch.Tensor:
    """(N, 3) int cell coords → (N,) int32 row-major ids (z fastest)."""
    return ((coords[:, 0] * d + coords[:, 1]) * d + coords[:, 2]).to(
        torch.int32
    )


def build_sorted_grid(
    pos: torch.Tensor, mass: torch.Tensor, coords: torch.Tensor, d: int,
    with_csort: bool = False, with_cell_start: bool = True,
    extra: torch.Tensor | None = None,
) -> SortedGrid:
    """Stable sort by cell id and ONE payload gather (``payload_gather``:
    kernel ``csrc/payload_gather.cu`` on the card, the torch composition on
    the CPU). ``jnp.argsort`` is stable too, so ``order``, ids and ranks
    match the JAX package's ``build_sorted_grid`` exactly on the same ids.
    ``d`` is the ids' stride (the hash window engine bins into ``dims`` ≤
    cap cells per axis but strides its ids by the static cap).

    ``extra`` (N, E) rides the same gather as [pos | mass] and comes back
    as ``SortedGrid.extra``. ``with_cell_start=False`` leaves the full
    (d³ + 1,) segment index unbuilt (``cell_start`` None): the window sweep
    and kernel K2 read it, so their engines keep the default."""
    ids = cell_ids(coords, d)
    order = torch.argsort(ids, stable=True)
    psort, ids_sorted, csort, extra_sorted = payload_gather(
        pos, mass, ids, order, d,
        extra=None if extra is None else extra.to(pos.dtype),
        with_csort=with_csort)
    cell_start = None
    if with_cell_start:
        cells = torch.arange(d * d * d + 1, dtype=torch.int32,
                             device=pos.device)
        cell_start = cell_starts_at(ids_sorted, cells)
    return SortedGrid(
        order=order,
        psort=psort,
        ids=ids_sorted,
        cell_start=cell_start,
        csort=csort,
        extra=extra_sorted,
    )


# The JAX package's bound for the full segment index of a caller that
# indexes it per cell (the window engine): above 2¹⁹ cells it builds light.
FULL_CELL_START_MAX_CELLS = 1 << 19


def use_full_cell_start(num_cells: int) -> bool:
    """Whether a grid of ``num_cells`` cells takes the full (d³ + 1,)
    segment index, by the JAX package's rule (``num_cells ≤ 2¹⁹``)."""
    return num_cells <= FULL_CELL_START_MAX_CELLS


def sorted_outputs(acc, grid: SortedGrid, extra, *rest) -> tuple:
    """The sorted-stepping contract's tuple: ``(acc_sorted, psort,
    order)``, then ``extra_sorted`` when the caller passed ``extra``, then
    ``rest`` (a frozen-grid meta)."""
    out = (acc, grid.psort, grid.order)
    if extra is not None:
        out += (grid.extra,)
    return out + rest


def sorted_ranks(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Per-row rank within its cell run, from sorted cell ids: a running
    max of the run-start indices."""
    n = sorted_ids.shape[0]
    arange = torch.arange(n, dtype=torch.int32, device=sorted_ids.device)
    boundary = torch.ones(n, dtype=torch.bool, device=sorted_ids.device)
    boundary[1:] = sorted_ids[1:] != sorted_ids[:-1]
    run_start = torch.cummax(
        torch.where(boundary, arange, torch.zeros_like(arange)), dim=0
    ).values
    return arange - run_start


def cell_starts_at(sorted_ids: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """First sorted index with id ≥ cell, for each queried cell id."""
    return torch.searchsorted(
        sorted_ids, cells.to(sorted_ids.dtype), side="left", out_int32=True
    )


def unsort_rows(rows_sorted: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Undo a sort permutation on row data with one index store
    (``out[order] = rows``); the JAX package uses a gather by
    ``argsort(order)`` because TPU scatters are slow, which a GPU's are
    not."""
    out = torch.empty_like(rows_sorted)
    out[order] = rows_sorted
    return out


def xy_ball(ws: int):
    """All (2ws+1)² xy offsets of the Chebyshev ball."""
    r = range(-ws, ws + 1)
    return tuple((x, y) for x in r for y in r)


def window_sweep(grid: SortedGrid, *, d: int, xy_offsets, z_halfwidth: int,
                 window: int = 1024, block_size: int = 256,
                 eps: float | None = None, cutoff2: float | None = None,
                 pair_weight=None, sorted_output: bool = False,
                 overflow_out=None):
    """Σ_j w(r², m_j)·(x_j − x_i) over the neighbour windows, with one of
    two weights:

      * ``eps`` (+ ``cutoff2``): softened gravity m_j·(r² + ε²)^{-3/2},
        with the raw-r² cutoff when ``cutoff2`` is given (kernel K7 on
        the card);
      * ``pair_weight(r2_raw, m_j)``: a caller's closure on tensors of
        pairs, evaluated by the plain sweep on every device (the JAX
        package's "XLA only" form; the kernel hardcodes the gravity law).

    Passing both, or neither, raises ``ValueError``, as in the JAX package.
    Self and coincident pairs (r² = 0) are masked either way.

    Returns ``(acc (N, 3) un-scaled by G, overflow () int64)``, acc in
    ORIGINAL row order, or in the grid's CELL-SORTED order with
    ``sorted_output=True`` (the sorted-stepping contract). The grid needs
    ``csort`` (``build_sorted_grid(..., with_csort=True)``).
    ``overflow_out`` (0-d int64, on the grid's device) has the overflow
    added to it and comes back as ``overflow``."""
    if (eps is None) == (pair_weight is None):
        raise ValueError(
            "window_sweep: pass exactly one of eps= (gravity kernel) or "
            "pair_weight= (custom closure, plain sweep only)")
    kw = dict(d=d, offsets=xy_offsets, z_hw=z_halfwidth, window=window,
              block_size=block_size)
    if pair_weight is not None:
        acc, overflow = window_sweep_plain(
            grid.psort, grid.csort, grid.cell_start, eps=0.0,
            pair_weight=pair_weight, **kw)
        if overflow_out is not None:
            overflow = overflow_out.add_(overflow)
    else:
        acc, overflow = window_sweep_kernel(
            grid.psort, grid.csort, grid.cell_start, eps=eps,
            cutoff2=cutoff2, overflow_out=overflow_out, **kw)
    if sorted_output:
        return acc, overflow
    return unsort_rows(acc, grid.order), overflow
