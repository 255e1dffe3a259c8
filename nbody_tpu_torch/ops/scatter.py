"""Slot placement + finest-level order-2 moments (kernel K2).

Counterpart of ``nbody_tpu/ops/pallas_scatter.py`` as the Barnes-Hut tiles
path calls it (``monotone_scatter_tiles(..., with_moments=True)``). From the
cell-sorted rows and the per-cell segment index it produces

  * ``tiles``   (d, 4, k, d²): the near sweep's plane-major slot tensor —
    the row of rank r < k in cell (x, y, z) at ``[x, :, r, y·d + z]``,
    every other slot the cell centre with mass 0;
  * ``moments`` (11, d³): [m, m·xr(3), m·xr⊗xr(6), count] about each cell
    centre over ALL its rows (rows past the k cap included), the
    ``pyramid_from_packed`` order-2 layout plus an exact count.

``tile_scatter`` is the wrapper of ``csrc/scatter.cu``; ``tile_scatter_plain``
is its plain PyTorch twin.

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


def tile_scatter_plain(psort, cell_start, lo, cell, *, d: int, k: int):
    """Plain twin of kernel K2 → (tiles (d, 4, k, d²), moments (11, d³))."""
    tile_scatter_plain.calls += 1
    n = psort.shape[0]
    nc = d * d * d
    dev = psort.device
    counts = (cell_start[1:] - cell_start[:-1]).to(torch.int64)
    ids = torch.repeat_interleave(
        torch.arange(nc, device=dev), counts, output_size=n
    )
    rank = torch.arange(n, device=dev) - cell_start[ids].to(torch.int64)
    ctr = cell_centers(lo, cell, d)                          # (d³, 3)

    tiles = torch.cat(
        [ctr, torch.zeros((nc, 1), dtype=psort.dtype, device=dev)], dim=-1
    )                                                        # (d³, 4)
    tiles = (
        tiles.reshape(d, d * d, 4).permute(0, 2, 1)[:, :, None, :]
        .expand(d, 4, k, d * d).contiguous()
    )
    placed = rank < k
    pid = ids[placed]
    tiles[pid // (d * d), :, rank[placed], pid % (d * d)] = psort[placed]

    xr = psort[:, :3] - ctr[ids]
    m = psort[:, 3:4]
    x, y, z = xr[:, 0:1], xr[:, 1:2], xr[:, 2:3]
    vals = torch.cat(
        [m, m * x, m * y, m * z,
         m * (x * x), m * (y * y), m * (z * z),
         m * (x * y), m * (x * z), m * (y * z),
         torch.ones_like(m)],
        dim=-1,
    )                                                        # (N, 11)
    moments = torch.zeros((nc, 11), dtype=psort.dtype, device=dev)
    moments.index_add_(0, ids, vals)
    return tiles, moments.T.contiguous()


tile_scatter_plain.calls = 0


def tile_scatter(psort, cell_start, lo, cell, *, d: int, k: int):
    """Kernel K2 (``csrc/scatter.cu``, one thread per cell): placement,
    moments and counts in one pass with no atomics. ``lo`` (3,) and
    ``cell`` (scalar) are device tensors, so the step never syncs with the
    host. CPU tensors take the plain twin; CUDA tensors launch the kernel
    or raise."""
    if psort.device.type == "cpu":
        return tile_scatter_plain(psort, cell_start, lo, cell, d=d, k=k)
    _build.require_cuda(psort, "tile_scatter")
    dev = psort.device
    nc = d * d * d
    if nc * 4 * k >= (1 << 31):
        raise ValueError(f"d³·4·k = {nc * 4 * k} overflows int32 indexing")
    cell = cell.reshape(())
    _build.check(psort, "psort", (psort.shape[0], 4), dev)
    if psort.data_ptr() % 16:
        raise ValueError("psort: rows must be 16-byte aligned (float4 loads)")
    _build.check(cell_start, "cell_start", (nc + 1,), dev, torch.int32)
    _build.check(lo, "lo", (3,), dev)
    _build.check(cell, "cell", (), dev)
    tiles = torch.empty((d, 4, k, d * d), dtype=torch.float32, device=dev)
    moments = torch.empty((11, nc), dtype=torch.float32, device=dev)
    _build.launch(
        "nbt_tile_scatter", dev, psort.data_ptr(), cell_start.data_ptr(),
        lo.data_ptr(), cell.data_ptr(), tiles.data_ptr(), moments.data_ptr(),
        d, k,
    )
    tile_scatter.launches += 1
    return tiles, moments


tile_scatter.launches = 0

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
