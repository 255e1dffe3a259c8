"""Slot placement + finest-level order-2 moments (kernel K2).

Counterpart of ``nbody_tpu/ops/pallas_scatter.py``'s
``monotone_scatter_tiles`` in the forms its callers use. The rank form
(``tile_scatter``; the Barnes-Hut tiles path calls it with moments, the
table-resident stepping of ``ops/table_step.py`` with coverage and extra
channels too) produces from the cell-sorted rows and the per-cell segment
index

  * ``tiles``   (d, 4, k, d²): the near sweep's plane-major slot tensor —
    the row of rank r < k in cell (x, y, z) at ``[x, :, r, y·d + z]``,
    every other slot the cell centre with mass 0;
  * ``moments`` (11, d³): [m, m·xr(3), m·xr⊗xr(6), count] about each cell
    centre over ALL its rows (rows past the k cap included), the
    ``pyramid_from_packed`` order-2 layout plus an exact count.

and, in the table re-sort's form, an exact coverage plane (1.0 where a row
was placed) and the rows' 3 velocity channels placed at the same slots
(0.0 in empty ones). The dest form (``tile_place``, the table repair step)
moves rows to explicit slot ids inside the step's own table and refills
the slots they leave. ``tile_scatter`` and
``tile_place`` are the wrappers of ``csrc/scatter.cu``;
``tile_scatter_plain`` and ``tile_place_plain`` are their plain PyTorch
twins.

Beside it, the sorted segment sum (kernel K6, ``monotone_segment_sum``):
``segment_sum`` sums C ≤ 15 channels of rows sorted by destination into
(C, num_dest) — the Barnes-Hut monopole path's finest moments — and
``segment_sum_plain`` is its twin (``index_add_``).
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.ops import _build


def cell_centers(lo, cell, d: int) -> torch.Tensor:
    """(d³, 3) centres lo + (c + 0.5)·cell of the row-major cells."""
    ar = torch.arange(d, device=lo.device, dtype=lo.dtype)
    gx, gy, gz = torch.meshgrid(ar, ar, ar, indexing="ij")
    g = torch.stack([gx, gy, gz], dim=-1).reshape(d * d * d, 3)
    return lo + (g + 0.5) * cell


def _filler_tiles(lo, cell, d: int, k: int, dtype, dev):
    """(d, 4, k, d²) every slot its cell centre with mass 0."""
    nc = d * d * d
    tiles = torch.cat(
        [cell_centers(lo, cell, d), torch.zeros((nc, 1), dtype=dtype,
                                                device=dev)], dim=-1
    )                                                        # (d³, 4)
    return (
        tiles.reshape(d, d * d, 4).permute(0, 2, 1)[:, :, None, :]
        .expand(d, 4, k, d * d).contiguous()
    )


def tile_scatter_plain(psort, cell_start, lo, cell, *, d: int, k: int,
                       with_coverage: bool = False, extra=None):
    """Plain twin of kernel K2's rank form → (tiles (d, 4, k, d²), moments
    (11, d³)), then with ``with_coverage`` and ``extra`` (N, 3) the cov
    plane (d, 1, k, d²) and the extra planes (d, 3, k, d²)."""
    tile_scatter_plain.calls += 1
    table = _table_form(with_coverage, extra, psort.shape[0])
    n = psort.shape[0]
    nc = d * d * d
    dev = psort.device
    counts = (cell_start[1:] - cell_start[:-1]).to(torch.int64)
    ids = torch.repeat_interleave(
        torch.arange(nc, device=dev), counts, output_size=n
    )
    rank = torch.arange(n, device=dev) - cell_start[ids].to(torch.int64)
    ctr = cell_centers(lo, cell, d)                          # (d³, 3)

    tiles = _filler_tiles(lo, cell, d, k, psort.dtype, dev)
    placed = rank < k
    pid = ids[placed]
    x, r, yz = pid // (d * d), rank[placed], pid % (d * d)
    tiles[x, :, r, yz] = psort[placed]

    xr = psort[:, :3] - ctr[ids]
    m = psort[:, 3:4]
    x3, y3, z3 = xr[:, 0:1], xr[:, 1:2], xr[:, 2:3]
    vals = torch.cat(
        [m, m * x3, m * y3, m * z3,
         m * (x3 * x3), m * (y3 * y3), m * (z3 * z3),
         m * (x3 * y3), m * (x3 * z3), m * (y3 * z3),
         torch.ones_like(m)],
        dim=-1,
    )                                                        # (N, 11)
    moments = torch.zeros((nc, 11), dtype=psort.dtype, device=dev)
    moments.index_add_(0, ids, vals)
    if not table:
        return tiles, moments.T.contiguous()
    cov = torch.zeros((d, 1, k, d * d), dtype=psort.dtype, device=dev)
    cov[x, 0, r, yz] = 1.0
    ext = torch.zeros((d, 3, k, d * d), dtype=psort.dtype, device=dev)
    ext[x, :, r, yz] = extra[placed]
    return tiles, moments.T.contiguous(), cov, ext


tile_scatter_plain.calls = 0


def _table_form(with_coverage: bool, extra, n: int) -> bool:
    """Whether a rank-form call asks for the table form; raises on any
    other combination (no caller needs one)."""
    if extra is None and not with_coverage:
        return False
    if not with_coverage or extra is None or tuple(extra.shape) != (n, 3):
        raise ValueError(
            "tile_scatter: the table form takes with_coverage=True and "
            f"extra (N, 3); got with_coverage={with_coverage}, extra "
            f"{None if extra is None else tuple(extra.shape)}")
    return True


def tile_scatter(psort, cell_start, lo, cell, *, d: int, k: int,
                 with_coverage: bool = False, extra=None):
    """Kernel K2's rank form (``csrc/scatter.cu``, one thread per cell):
    placement, moments and counts in one pass with no atomics →
    ``(tiles, moments)``. The table form, ``with_coverage=True`` and
    ``extra`` (N, 3), appends cov (d, 1, k, d²), 1.0 where a row was placed,
    and the extra rows placed at their slots (d, 3, k, d²), 0.0 in empty
    slots (the JAX kernel's ``with_coverage``/``extra`` forms at the one
    arity its callers' velocities need; its dest-id channel, which no
    caller reads, is not produced). ``lo`` (3,) and ``cell`` (scalar) are
    device tensors, so the step never syncs with the host. CPU tensors take
    the plain twin; CUDA tensors launch the kernel or raise."""
    if psort.device.type == "cpu":
        return tile_scatter_plain(psort, cell_start, lo, cell, d=d, k=k,
                                  with_coverage=with_coverage, extra=extra)
    _build.require_cuda(psort, "tile_scatter")
    dev = psort.device
    nc = d * d * d
    if nc * 4 * k >= (1 << 31):
        raise ValueError(f"d³·4·k = {nc * 4 * k} overflows int32 indexing")
    cell = cell.reshape(())
    n = psort.shape[0]
    table = _table_form(with_coverage, extra, n)
    _build.check(psort, "psort", (n, 4), dev)
    if psort.data_ptr() % 16:
        raise ValueError("psort: rows must be 16-byte aligned (float4 loads)")
    _build.check(cell_start, "cell_start", (nc + 1,), dev, torch.int32)
    _build.check(lo, "lo", (3,), dev)
    _build.check(cell, "cell", (), dev)
    tiles = torch.empty((d, 4, k, d * d), dtype=torch.float32, device=dev)
    moments = torch.empty((11, nc), dtype=torch.float32, device=dev)
    if not table:
        _build.launch(
            "nbt_tile_scatter", dev, psort.data_ptr(), cell_start.data_ptr(),
            lo.data_ptr(), cell.data_ptr(), tiles.data_ptr(),
            moments.data_ptr(), d, k,
        )
        tile_scatter.launches += 1
        return tiles, moments
    _build.check(extra, "extra", (n, 3), dev)
    cov = torch.empty((d, 1, k, d * d), dtype=torch.float32, device=dev)
    ext = torch.empty((d, 3, k, d * d), dtype=torch.float32, device=dev)
    _build.launch(
        "nbt_tile_scatter_ext", dev, psort.data_ptr(), extra.data_ptr(),
        cell_start.data_ptr(), lo.data_ptr(), cell.data_ptr(),
        tiles.data_ptr(), moments.data_ptr(), cov.data_ptr(), ext.data_ptr(),
        d, k,
    )
    tile_scatter.launches += 1
    return tiles, moments, cov, ext


tile_scatter.launches = 0


def _plane_index(f, d: int, k: int):
    """Flat (d, k, d²) slot indices (x·k + r)·d² + yz → (x, r, yz)."""
    return f // (k * d * d), (f // (d * d)) % k, f % (d * d)


def tile_place_plain(tiles, cov, ext, live, slot_row, idx_ext, src, dest,
                     lo, cell, *, d: int, k: int) -> None:
    """Plain twin of kernel K2's dest form, in place on the same tensors."""
    tile_place_plain.calls += 1
    d2, nck = d * d, d * d * d * k
    ok = (dest >= 0) & (dest < nck) & (src >= 0) & (src < nck)
    f, t = src[ok].to(torch.int64), dest[ok].to(torch.int64)
    fx, fr, fyz = _plane_index(f, d, k)
    tc = t // k
    tx, tr, tyz = tc // d2, t % k, tc % d2
    tiles[tx, :, tr, tyz] = tiles[fx, :, fr, fyz]
    ext[tx, :, tr, tyz] = ext[fx, :, fr, fyz]
    cov[tx, 0, tr, tyz] = 1.0
    g = torch.stack([fx, fyz // d, fyz % d], dim=-1)
    ctr = lo + (g.to(lo.dtype) + 0.5) * cell
    tiles[fx, :, fr, fyz] = torch.cat([ctr, torch.zeros_like(ctr[:, :1])],
                                      dim=-1)
    ext[fx, :, fr, fyz] = 0.0
    cov[fx, 0, fr, fyz] = 0.0
    fid = (fx * d2 + fyz) * k + fr
    rid = slot_row[fid].to(torch.int64)
    slot_row[fid] = -1
    slot_row[t] = rid.to(slot_row.dtype)
    idx_ext[rid[rid >= 0]] = t[rid >= 0].to(idx_ext.dtype)
    cells = torch.cat([fx * d2 + fyz, tc])
    slot1 = torch.arange(1, k + 1, dtype=torch.int64, device=cov.device)
    occ = cov[cells // d2, 0, :, cells % d2] > 0.0            # (2M, k)
    live[cells] = torch.where(occ, slot1, 0).amax(dim=1).to(live.dtype)


tile_place_plain.calls = 0


def tile_place(tiles, cov, ext, live, slot_row, idx_ext, src, dest, lo,
               cell, *, d: int, k: int) -> None:
    """Kernel K2's dest form (``csrc/scatter.cu``: a thread per mover, then
    a thread per touched cell), in place on one table: mover j's row — its
    4 channels of ``tiles`` (d, 4, k, d²) and 3 of ``ext`` (d, 3, k, d²) —
    moves from slot ``src[j]``, a flat index (x·k + r)·d² + yz of the
    (d, k, d²) slot grid (the audit's order), to slot id ``dest[j]`` =
    cell·k + slot, with ``cov`` (d, 1, k, d²) 1 there; its old slot gets
    the filler (its cell centre, mass 0, cov 0, extra 0); the bookkeeping
    follows (``slot_row`` (d³·k,) the row of each slot id, −1 when empty;
    ``idx_ext`` the slot id of each row); and ``live`` (d³,), K4's count,
    becomes the high-water mark of each cell a row left or entered. dest
    ids outside [0, d³·k), such as ``SENTINEL_DEST`` (a denied arrival),
    move nothing; the valid sources and destinations are distinct slots.
    The JAX kernel called with explicit ``dest``, ``with_coverage=True``
    and ``extra`` places the movers' rows into a dense filler table that
    its caller merges; moving them inside the table makes the cost that of
    the movers. CPU tensors take the plain twin; CUDA tensors launch the
    kernel or raise."""
    if tiles.device.type == "cpu":
        return tile_place_plain(tiles, cov, ext, live, slot_row, idx_ext,
                                src, dest, lo, cell, d=d, k=k)
    _build.require_cuda(tiles, "tile_place")
    dev = tiles.device
    nc = d * d * d
    if nc * 4 * k >= (1 << 31):
        raise ValueError(f"d³·4·k = {nc * 4 * k} overflows int32 indexing")
    cell = cell.reshape(())
    m = src.shape[0]
    _build.check(tiles, "tiles", (d, 4, k, d * d), dev)
    _build.check(cov, "cov", (d, 1, k, d * d), dev)
    _build.check(ext, "ext", (d, 3, k, d * d), dev)
    _build.check(live, "live", (nc,), dev)
    _build.check(slot_row, "slot_row", (nc * k,), dev, torch.int32)
    _build.check(idx_ext, "idx_ext", tuple(idx_ext.shape), dev, torch.int32)
    _build.check(src, "src", (m,), dev, torch.int32)
    _build.check(dest, "dest", (m,), dev, torch.int32)
    _build.check(lo, "lo", (3,), dev)
    _build.check(cell, "cell", (), dev)
    _build.launch(
        "nbt_tile_place", dev, src.data_ptr(), dest.data_ptr(), m,
        lo.data_ptr(), cell.data_ptr(), tiles.data_ptr(), cov.data_ptr(),
        ext.data_ptr(), live.data_ptr(), slot_row.data_ptr(),
        idx_ext.data_ptr(), d, k,
    )
    tile_place.launches += 1


tile_place.launches = 0

# Destination ids at or above this are sentinel rows: they may interleave
# with the sorted real ids and add nothing (``monotone_segment_sum``).
SENTINEL_DEST = 1 << 24


def segment_sum_plain(vals, dest, num_dest: int):
    """Plain twin of kernel K6: ``index_add_`` of the rows with
    0 ≤ dest < num_dest → (C, num_dest)."""
    segment_sum_plain.calls += 1
    ok = (dest >= 0) & (dest < num_dest)
    out = torch.zeros((num_dest, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    out.index_add_(0, dest[ok].to(torch.int64), vals[ok])
    return out.T.contiguous()


segment_sum_plain.calls = 0


def segment_sum(vals, dest, num_dest: int):
    """Kernel K6 (``csrc/segment_sum.cu``: chunks of rows reduced in
    parallel, the partial sums of runs that cross chunks
    joined in chunk order, every segment written once, empty ones as 0;
    no float atomics):
    per-segment sums (C, num_dest) of ``vals`` (N, C ≤ 15) over the
    non-decreasing int32 ``dest`` (N,); rows with dest ≥ 2²⁴ may
    interleave and add nothing. CPU tensors take the plain twin; CUDA
    tensors launch the kernel or raise."""
    if vals.device.type == "cpu":
        return segment_sum_plain(vals, dest, num_dest)
    _build.require_cuda(vals, "segment_sum")
    dev = vals.device
    n, c = vals.shape
    if not 1 <= c <= 15:
        raise ValueError(f"segment_sum takes 1..15 channels, got {c}")
    if not 0 <= num_dest <= SENTINEL_DEST:
        raise ValueError(f"num_dest {num_dest} outside [0, 2^24]")
    _build.check(vals, "vals", (n, c), dev)
    if c == 4 and vals.data_ptr() % 16:
        raise ValueError("vals: rows must be 16-byte aligned (float4 loads)")
    _build.check(dest, "dest", (n,), dev, torch.int32)
    # one allocation, sized by the kernel library: the output, then the
    # kernel's per-chunk (key, partial sum) side buffer
    floats = _build.library().nbt_segment_sum_buffer_floats(c, n, num_dest)
    buf = torch.empty(floats, dtype=torch.float32, device=dev)
    _build.launch("nbt_segment_sum", dev, vals.data_ptr(), c, n,
                  dest.data_ptr(), num_dest, buf.data_ptr(), buf.numel())
    segment_sum.launches += 1
    return buf.as_strided((c, num_dest), (num_dest, 1))


segment_sum.launches = 0
