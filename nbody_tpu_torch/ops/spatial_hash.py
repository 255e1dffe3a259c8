"""Spatial-hash short-range forces — O(N) with a cutoff.

PyTorch counterpart of ``nbody_tpu/ops/spatial_hash.py`` (itself the
counterpart of the reference's ``force_spatial_hash.cu``): the same pair
predicate — the cutoff² test on the RAW squared distance BEFORE softening,
the self pair skipped, exactly the 3×3×3 neighbour cells — on one of two
acceleration structures:

  * the WINDOW engine (dense scenes): bbox-dependent grid ``dims`` ≤ cap
    per axis, cell ids with the STATIC stride cap, one stable sort, and
    the sorted-window sweep (kernel K7, ``sorted_window.window_sweep``);
  * the TILES engine (sparse scenes): a static d-per-axis grid of k-slot
    tiles, built by kernel K2 and swept by kernel K4 with the cutoff
    (``tile_sweep.tile_near_field``).

``hash_engine_params`` picks between them with the JAX package's rule, so
both packages run the same engine, d, k and window on the same positions.
The binning stays on the device (``floor((pos − lo)/cell_size)`` clipped to
``dims`` or d); only the engine choice reads positions on the host, once,
when a strategy is built.

The tiles engine also has the frozen-grid contract of
``integrator.make_resort_multi_step`` (``with_grid_meta=True``,
``spatial_hash_forces_tiles_frozen``), attached to its sorted factory where
``tile_sweep.tile_engine_fused`` holds, as in the JAX package; the window
engine has none.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from nbody_tpu_torch.ops.sorted_window import (
    FrozenGridMeta,
    SortedGrid,
    build_sorted_grid,
    cell_ids,
    cell_starts_at,
    sorted_outputs,
    window_sweep,
    xy_ball,
)
from nbody_tpu_torch.ops.tile_sweep import tile_engine_fused, tile_near_field
from nbody_tpu_torch.types import SimulationConfig
from nbody_tpu_torch.utils.profiling import profile_phase


@dataclasses.dataclass
class GridData:
    """The sorted-grid structure of the reference (spatial_hash_grid.hpp).

    order:      (N,) permutation sorting particles by cell id
    cell_ids:   (N,) int32 cell id per ORIGINAL particle index
    sorted_ids: (N,) int32 cell id per sorted slot
    cell_start: (cap³,) int32 first sorted slot of each cell
    cell_count: (cap³,) int32 particles in each cell
    dims:       (3,) int32 grid dims (≤ cap)
    lo:         (3,) bbox lower corner
    overflow:   () slots beyond ``max_per_cell`` in any cell
    """

    order: torch.Tensor
    cell_ids: torch.Tensor
    sorted_ids: torch.Tensor
    cell_start: torch.Tensor
    cell_count: torch.Tensor
    dims: torch.Tensor
    lo: torch.Tensor
    overflow: torch.Tensor


def cell_index(coords: torch.Tensor, cap: int) -> torch.Tensor:
    """Row-major cell id with the static stride ``cap``."""
    return (coords[..., 0] * cap + coords[..., 1]) * cap + coords[..., 2]


def hash_bin(pos, cell_size: float, cap: int):
    """(lo, dims, coords): bbox corner, per-axis dims clipped to [1, cap]
    and each row's cell coordinates clipped to dims − 1 (device tensors)."""
    lo = torch.min(pos, dim=0).values
    hi = torch.max(pos, dim=0).values
    dims = torch.clamp(torch.ceil((hi - lo) / cell_size).to(torch.int32),
                       1, cap)
    coords = torch.clamp(torch.floor((pos - lo) / cell_size).to(torch.int32),
                         min=torch.zeros_like(dims), max=dims - 1)
    return lo, dims, coords


def tiles_bin(pos, cell_size: float, d: int, lo=None):
    """(lo, coords) on the tiles engine's static d-per-axis grid, with its
    origin at the bbox corner or at ``lo`` when given (a frozen binning)."""
    if lo is None:
        lo = torch.min(pos, dim=0).values
    coords = torch.clamp(torch.floor((pos - lo) / cell_size).to(torch.int32),
                         0, d - 1)
    return lo, coords


def build_spatial_grid(pos, *, cell_size: float, cap: int = 64,
                       max_per_cell: int = 64) -> GridData:
    """The reference's cell lists (force_spatial_hash.cu:235-303) as one
    stable sort plus two searchsorted passes over the cap³ cells."""
    lo, dims, coords = hash_bin(pos, cell_size, cap)
    ids = cell_index(coords, cap).to(torch.int32)
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    cells = torch.arange(cap ** 3, dtype=torch.int32, device=pos.device)
    cell_start = cell_starts_at(sorted_ids, cells)
    cell_end = torch.searchsorted(sorted_ids, cells, side="right",
                                  out_int32=True)
    cell_count = cell_end - cell_start
    overflow = torch.clamp(cell_count - max_per_cell, min=0).sum()
    return GridData(order=order, cell_ids=ids, sorted_ids=sorted_ids,
                    cell_start=cell_start, cell_count=cell_count, dims=dims,
                    lo=lo, overflow=overflow)


def verify_cell_assignment(pos, grid: GridData, cap: int) -> bool:
    """Every particle appears in exactly one cell and all N are covered
    (the reference's verifyCellAssignment, force_spatial_hash.cu:336-362)."""
    n = pos.shape[0]
    order = grid.order.cpu().numpy()
    start = grid.cell_start.cpu().numpy()
    count = grid.cell_count.cpu().numpy()
    ids = grid.cell_ids.cpu().numpy()
    if sorted(order.tolist()) != list(range(n)):
        return False
    covered = np.zeros(n, dtype=bool)
    for c in np.unique(ids):
        members = order[start[c]:start[c] + count[c]]
        if covered[members].any() or not (ids[members] == c).all():
            return False
        covered[members] = True
    return bool(covered.all())


def _window_forces(pos, mass, G, softening, *, cutoff, cell_size, cap,
                   window, block_size, sorted_output, extra=None):
    dev = pos.device
    with profile_phase("hash.sort", device=dev):
        _lo, _dims, coords = hash_bin(pos, cell_size, cap)
        grid = build_sorted_grid(pos, mass, coords, cap, with_csort=True,
                                 extra=extra)
    with profile_phase("hash.window", device=dev):
        acc, overflow = window_sweep(
            grid, d=cap, xy_offsets=xy_ball(1), z_halfwidth=1, window=window,
            block_size=block_size, eps=softening, cutoff2=cutoff * cutoff,
            sorted_output=sorted_output,
        )
    return G * acc, overflow, grid


def spatial_hash_forces(pos, mass, G: float = 1.0, softening: float = 0.1, *,
                        cutoff: float = 2.0, cell_size: float = 1.0,
                        cap: int = 64, window: int = 2048,
                        block_size: int = 256, return_overflow: bool = False):
    """Window-engine short-range forces in original row order (9 xy
    offsets × contiguous z-run windows, kernel K7)."""
    acc, overflow, _ = _window_forces(
        pos, mass, G, softening, cutoff=cutoff, cell_size=cell_size, cap=cap,
        window=window, block_size=block_size, sorted_output=False)
    return (acc, overflow) if return_overflow else acc


def spatial_hash_forces_window_sorted(pos, mass, G=1.0, softening=0.1, *,
                                      cutoff=2.0, cell_size=1.0, cap=64,
                                      window=2048, block_size=256,
                                      extra=None):
    """The window engine in CELL-SORTED row order →
    ``(acc_sorted, psort, order)`` (the sorted-stepping contract), with
    ``extra_sorted`` appended when ``extra`` (N, E) rides the sort."""
    acc, _, grid = _window_forces(
        pos, mass, G, softening, cutoff=cutoff, cell_size=cell_size, cap=cap,
        window=window, block_size=block_size, sorted_output=True,
        extra=extra)
    return sorted_outputs(acc, grid, extra)


def _tiles_forces(pos, mass, G, softening, *, cutoff, cell_size, d, k,
                  sorted_output, with_grid_meta=False, extra=None):
    if with_grid_meta:
        _require_frozen_contract(d, k)
    with profile_phase("hash.sort", device=pos.device):
        lo, coords = tiles_bin(pos, cell_size, d)
        grid = build_sorted_grid(pos, mass, coords, d, extra=extra)
    cell = torch.full((), float(cell_size), dtype=pos.dtype,
                      device=pos.device)
    acc, tb = tile_near_field(
        grid, lo, cell, d=d, ws=1, k=k, G=G, eps=softening,
        cutoff2=float(cutoff) * float(cutoff), sorted_output=sorted_output)
    # the engine's own ids, ranks and segment index: frozen(fresh meta)
    # runs the same ops on the same inputs, bit for bit
    meta = FrozenGridMeta(ids=grid.ids, rank=tb.rank_sorted, lo=lo,
                          cell=cell, cell_start=grid.cell_start)
    return acc, tb.overflow, grid, meta


def _require_frozen_contract(d: int, k: int) -> None:
    if not tile_engine_fused(d, k):
        raise ValueError("frozen-grid stepping requires the fused tiles "
                         f"path (d={d}, k={k})")


def spatial_hash_forces_tiles(pos, mass, G: float = 1.0,
                              softening: float = 0.1, *, cutoff: float = 2.0,
                              cell_size: float = 1.0, d: int = 64, k: int = 8,
                              return_overflow: bool = False):
    """Tiles-engine short-range forces in original row order: the same
    predicate on a static (d³, k) slot grid (kernels K2, K4). Rows beyond k
    in a cell lose their short-range term and are counted."""
    acc, overflow, _, _ = _tiles_forces(
        pos, mass, G, softening, cutoff=cutoff, cell_size=cell_size, d=d,
        k=k, sorted_output=False)
    return (acc, overflow) if return_overflow else acc


def spatial_hash_forces_tiles_sorted(pos, mass, G=1.0, softening=0.1, *,
                                     cutoff=2.0, cell_size=1.0, d=64, k=8,
                                     extra=None, with_grid_meta=False):
    """The tiles engine in CELL-SORTED row order →
    ``(acc_sorted, psort, order)``; ``extra`` (N, E) rides the engine's
    own sort gather and ``extra_sorted`` is appended; ``with_grid_meta=True``
    appends (last) the ``FrozenGridMeta`` that
    ``spatial_hash_forces_tiles_frozen`` steps on (raises where
    ``tile_engine_fused`` does not hold)."""
    acc, _, grid, meta = _tiles_forces(
        pos, mass, G, softening, cutoff=cutoff, cell_size=cell_size, d=d,
        k=k, sorted_output=True, with_grid_meta=with_grid_meta, extra=extra)
    rest = (meta,) if with_grid_meta else ()
    return sorted_outputs(acc, grid, extra, *rest)


def spatial_hash_forces_tiles_frozen(psort, meta: FrozenGridMeta, G=1.0,
                                     softening=0.1, *, cutoff=2.0,
                                     cell_size=1.0, d=64, k=8,
                                     with_audit=False):
    """Tiles-engine forces on a FROZEN cell assignment (the contract and
    error class of ``barnes_hut.barnes_hut_forces_frozen``): placement
    (K2), sweep with the cutoff (K4) and pickup of ``psort``'s current
    rows with the cached ids, ranks, segment index and origin. Returns
    ``acc_sorted``, or ``(acc_sorted, n_stale)`` with ``with_audit``: the
    rows whose cell under the frozen binning differs from ``meta.ids``."""
    _require_frozen_contract(d, k)
    # order is unused under sorted_output=True
    grid = SortedGrid(order=None, psort=psort, ids=meta.ids,
                      cell_start=meta.cell_start)
    acc, _tb = tile_near_field(
        grid, meta.lo, meta.cell, d=d, ws=1, k=k, G=G, eps=softening,
        cutoff2=float(cutoff) * float(cutoff), sorted_output=True,
        rank_sorted=meta.rank)
    if not with_audit:
        return acc
    coords = tiles_bin(psort[:, :3], cell_size, d, lo=meta.lo)[1]
    return acc, (cell_ids(coords, d) != meta.ids).sum()


def hash_window_defaults(config: SimulationConfig):
    """(window, block) of the sorted-window sweep: (1024, 128) at ≤ 150K
    particles, (2048, 256) above; an explicit ``hash_window`` takes block
    512 from 1536 up. The windows, and so the overflow audit, depend on
    the block, so it stays the JAX package's."""
    if config.hash_window > 0:
        window = config.hash_window
        return window, (512 if window >= 1536 else 256)
    n = config.particle_count
    return (1024, 128) if n <= 150_000 else (2048, 256)


def hash_engine_params(config: SimulationConfig, pos=None) -> dict:
    """Engine selection — the JAX package's rule, so both packages pick the
    same engine, ``tile_d``, ``tile_k``, window and block on the same
    positions. ``pos`` (array-like, read on the host once) enables the
    density probe; without it "auto" takes the window engine.

    Returns engine ("window"/"tiles"), window, block, tile_d, tile_k,
    occupancy (mean rows per occupied cell, None without a probe)."""
    engine = config.hash_engine
    window, block = hash_window_defaults(config)
    k = config.hash_tile_k
    tile_d = config.hash_max_grid_dim
    occupancy = None
    if pos is not None:
        if isinstance(pos, torch.Tensor):
            pos = pos.detach().cpu().numpy()
        p = np.asarray(pos)
        lo = p.min(axis=0)
        ext = float((p.max(axis=0) - lo).max())
        cell = config.spatial_hash_cell_size
        need_d = max(4, int(math.ceil(ext / cell + 1e-6)) + 1)
        # Smallest multiple-of-8 grid covering the box, bounded so that
        # d³·k stays below 2²⁴ (the JAX package's f32 dest-id limit; kept
        # so both packages size the same grid).
        d = -(-need_d // 8) * 8
        while d > 8 and d * d * d * max(k, 8) >= (1 << 24):
            d -= 8
        tile_d = d
        covers = d >= need_d
        coords = np.clip(np.floor((p - lo) / cell).astype(np.int64), 0, d - 1)
        ids = (coords[:, 0] * d + coords[:, 1]) * d + coords[:, 2]
        occupancy = p.shape[0] / max(len(np.unique(ids)), 1)
        # k ≈ 2·occupancy, a multiple of 8, at most 32
        k = int(min(32, max(k, -(-int(2.0 * occupancy) // 8) * 8)))
        if d * d * d * k >= (1 << 24):
            k = max(8, ((1 << 24) - 1) // (d * d * d) // 8 * 8)
        if engine == "auto":
            # tiles while the slot cap is affordable (occupancy ≤ 16) and
            # the grid covers the box
            engine = "tiles" if covers and occupancy <= 16.0 else "window"
    if engine == "auto":
        engine = "window"
    return {
        "engine": engine,
        "window": window,
        "block": block,
        "tile_d": tile_d,
        "tile_k": k,
        "occupancy": occupancy,
    }


def make_spatial_hash_forces(config: SimulationConfig, pos_hint=None):
    """``force_fn(pos, mass) -> acc`` (original row order) for the engine
    ``hash_engine_params`` resolves; the resolved parameters ride on the
    closure as ``engine_params`` (read by ``audit_short_range``)."""
    G, eps = config.G, config.softening
    cutoff, cell = config.spatial_hash_cutoff, config.spatial_hash_cell_size
    cap = config.hash_max_grid_dim
    p = hash_engine_params(config, pos_hint)
    if p["engine"] == "tiles":

        def force_fn(pos, mass):
            return spatial_hash_forces_tiles(
                pos, mass, G, eps, cutoff=cutoff, cell_size=cell,
                d=p["tile_d"], k=p["tile_k"])

    else:

        def force_fn(pos, mass):
            return spatial_hash_forces(
                pos, mass, G, eps, cutoff=cutoff, cell_size=cell, cap=cap,
                window=p["window"], block_size=p["block"])

    force_fn.engine_params = p
    return force_fn


def make_spatial_hash_forces_sorted(config: SimulationConfig, pos_hint=None):
    """``sorted_force_fn(pos, mass, extra=None) -> (acc_sorted, psort,
    order[, extra_sorted])``; both engines have the sorted contract. The
    tiles engine's closure carries the frozen-grid contract (``with_meta``,
    ``frozen``) where ``tile_engine_fused`` holds, as the JAX factory
    does."""
    G, eps = config.G, config.softening
    cutoff, cell = config.spatial_hash_cutoff, config.spatial_hash_cell_size
    cap = config.hash_max_grid_dim
    p = hash_engine_params(config, pos_hint)
    if p["engine"] == "tiles":
        kw = dict(cutoff=cutoff, cell_size=cell, d=p["tile_d"],
                  k=p["tile_k"])

        def sorted_force_fn(pos, mass, extra=None):
            return spatial_hash_forces_tiles_sorted(pos, mass, G, eps,
                                                    extra=extra, **kw)

        if tile_engine_fused(p["tile_d"], p["tile_k"]):

            def with_meta(pos, mass):
                return spatial_hash_forces_tiles_sorted(
                    pos, mass, G, eps, with_grid_meta=True, **kw)

            def frozen(psort, meta, with_audit=False):
                return spatial_hash_forces_tiles_frozen(
                    psort, meta, G, eps, with_audit=with_audit, **kw)

            sorted_force_fn.with_meta = with_meta
            sorted_force_fn.frozen = frozen

    else:

        def sorted_force_fn(pos, mass, extra=None):
            return spatial_hash_forces_window_sorted(
                pos, mass, G, eps, cutoff=cutoff, cell_size=cell, cap=cap,
                window=p["window"], block_size=p["block"], extra=extra)

    sorted_force_fn.engine_params = p
    # the integrator's payload takes its own gather by default, as the JAX
    # factory sets it (``make_sorted_multi_step(route_extra=True)`` sends it
    # through the engine's sort instead)
    sorted_force_fn.route_extra = False
    return sorted_force_fn
