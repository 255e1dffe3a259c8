"""Cell-sorted particle arrays.

PyTorch counterpart of the sort machinery of
``nbody_tpu/ops/sorted_window.py`` that the Barnes-Hut tiles path uses:
bin, stable argsort by linear cell id, one payload gather, and the per-cell
segment index. Cell ids stay int32 throughout (the JAX package's f32 id
columns and bitcast routes exist for TPU reasons and are not ported). The
window sweep engine is a later port.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SortedGrid:
    """Cell-sorted particle arrays + segment index.

    order:      (N,) int64 sort permutation (sorted row i is original row
                order[i])
    psort:      (N, 4) x, y, z, mass in sorted order
    ids:        (N,) int32 linear cell ids in sorted order (non-decreasing)
    cell_start: (C + 1,) int32 first sorted index of each linear cell id
                (empty cells point at the next occupied one; N at the end)
    """

    order: torch.Tensor
    psort: torch.Tensor
    ids: torch.Tensor
    cell_start: torch.Tensor


def cell_ids(coords: torch.Tensor, d: int) -> torch.Tensor:
    """(N, 3) int cell coords → (N,) int32 row-major ids (z fastest)."""
    return ((coords[:, 0] * d + coords[:, 1]) * d + coords[:, 2]).to(
        torch.int32
    )


def build_sorted_grid(
    pos: torch.Tensor, mass: torch.Tensor, coords: torch.Tensor, d: int
) -> SortedGrid:
    """Stable sort by cell id and ONE (N, 4) payload gather. ``jnp.argsort``
    is stable too, so ``order``, ids and ranks match the JAX package's
    ``build_sorted_grid`` exactly on the same ids."""
    ids = cell_ids(coords, d)
    order = torch.argsort(ids, stable=True)
    psort = torch.cat([pos, mass[:, None]], dim=-1)[order]
    ids_sorted = ids[order]
    cells = torch.arange(d * d * d + 1, dtype=torch.int32, device=pos.device)
    return SortedGrid(
        order=order,
        psort=psort,
        ids=ids_sorted,
        cell_start=cell_starts_at(ids_sorted, cells),
    )


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
