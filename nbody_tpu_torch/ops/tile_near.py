"""Near-field slot sweep seeded with the far expansion (kernel K4).

Counterpart of ``nbody_tpu/ops/pallas_tile_near.py``
(``tile_sweep_pallas_plane``, raw output layout). For every live slot of
the plane-major tiles (d, 4, k, d²): the far-field local expansion
A + J·δ + ½(H·δ)·δ at the slot's own position (when ``far_plane`` is
given) plus the softened pair sum over the (2ws+1)³ neighbour cells × k
source slots — NOT scaled by G. Output (d, 3, k, d²).

Liveness: with ``counts`` (d³,) — the per-cell occupancy that kernel K2
emits — slots s ≥ min(count, k) are dead and read 0. Without it every slot
is computed. The TPU kernel marks liveness by mass instead and writes
zeros or filler values for dead slots; no version's dead slots are ever
picked up, so comparisons across versions use live slots only.

The SLAB form (``tile_sweep_slab``; the near sweep of the sharded paths,
``parallel/tree.py``) takes the nx x-planes of a halo'd slab (nx, 4, k, d²)
with their counts (nx·d²), sweeps the target planes [x0, x0 + planes)
against every plane of the slab, with no cell past the slab's x-extent or
the grid's y, z extent, and no far seed → (planes, 3, k, d²).

``tile_sweep_plane`` and ``tile_sweep_slab`` are the wrappers of
``csrc/tile_near.cu``; ``tile_sweep_plane_plain`` is the plain twin of
both (``slab=(x0, planes)`` for the slab form).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nbody_tpu_torch.ops import _build


def far_eval(far, dx, dy, dz):
    """A + J·δ (+ ½(H·δ)·δ when 19 channels) for (C, ...) channel-leading
    ``far``; component orders as ``barnes_hut.sym_matvec`` /
    ``sym3_matvec``."""
    f = far
    fx = f[0] + (f[3] * dx + f[6] * dy + f[7] * dz)
    fy = f[1] + (f[6] * dx + f[4] * dy + f[8] * dz)
    fz = f[2] + (f[7] * dx + f[8] * dy + f[5] * dz)
    if f.shape[0] > 9:
        hxx = f[9] * dx + f[12] * dy + f[13] * dz
        hyy = f[14] * dx + f[10] * dy + f[15] * dz
        hzz = f[16] * dx + f[17] * dy + f[11] * dz
        hxy = f[12] * dx + f[14] * dy + f[18] * dz
        hxz = f[13] * dx + f[18] * dy + f[16] * dz
        hyz = f[18] * dx + f[15] * dy + f[17] * dz
        fx = fx + 0.5 * (hxx * dx + hxy * dy + hxz * dz)
        fy = fy + 0.5 * (hxy * dx + hyy * dy + hyz * dz)
        fz = fz + 0.5 * (hxz * dx + hyz * dy + hzz * dz)
    return fx, fy, fz


def _live_mask(counts, cells: int, k: int, device):
    """(k, cells) bool: slot s of cell c is live iff s < counts[c]."""
    s = torch.arange(k, device=device)[:, None]
    return s < counts.reshape(1, cells)


def tile_sweep_plane_plain(tiles_plane, *, k: int, d: int, ws: int,
                           eps: float, cutoff2: float | None = None,
                           far_plane=None, lo=None, cell=None, counts=None,
                           slab=None):
    """Plain twin of kernel K4 (dense, every slot pair of every offset).
    ``slab=(x0, planes)``: the slab form, ``tiles_plane`` (nx, 4, k, d²)
    with ``counts`` (nx·d²), targets in planes [x0, x0 + planes), no far
    seed → (planes, 3, k, d²)."""
    tile_sweep_plane_plain.calls += 1
    nx = tiles_plane.shape[0]
    x0, planes = (0, d) if slab is None else slab
    if slab is not None and (counts is None or far_plane is not None):
        raise ValueError("the slab form takes counts and no far plane")
    pc = planes * d * d
    dev = tiles_plane.device
    # (nx, 4, k, d²) → slot-leading (k, 4, nx, d, d), zero-padded by ws
    tiles_t = tiles_plane.reshape(nx, 4, k, d, d).permute(2, 1, 0, 3, 4)
    tgt = tiles_t[:, :, x0:x0 + planes].reshape(k, 4, pc)
    pad = F.pad(tiles_t, [ws] * 6)
    if counts is not None:
        live_all = _live_mask(counts, nx * d * d, k, dev).to(
            tiles_plane.dtype).reshape(k, nx, d, d)
        live = live_all[:, x0:x0 + planes].reshape(k, pc)
        live_pad = F.pad(live_all, [ws] * 6)
    eps2 = eps * eps

    if far_plane is not None:
        g = torch.arange(d, device=dev, dtype=tiles_plane.dtype)
        gx, gy, gz = torch.meshgrid(g, g, g, indexing="ij")
        cw = cell.reshape(())
        ctr = [(lo[i] + (gg.reshape(pc) + 0.5) * cw) for i, gg in
               enumerate((gx, gy, gz))]
        far = far_plane.permute(1, 0, 2).reshape(far_plane.shape[1], 1, pc)
        ax, ay, az = far_eval(far, tgt[:, 0] - ctr[0], tgt[:, 1] - ctr[1],
                              tgt[:, 2] - ctr[2])
        acc = torch.stack([ax, ay, az], dim=1)               # (k, 3, pc)
    else:
        acc = torch.zeros((k, 3, pc), dtype=tiles_plane.dtype, device=dev)

    w1 = 2 * ws + 1
    for ox in range(x0, x0 + w1):
        for oy in range(w1):
            for oz in range(w1):
                src = pad[:, :, ox:ox + planes, oy:oy + d,
                          oz:oz + d].reshape(k, 4, pc)
                sm = src[:, 3]
                if counts is not None:
                    sm = sm * live_pad[:, ox:ox + planes, oy:oy + d,
                                       oz:oz + d].reshape(k, pc)
                # every (target slot, source slot) pair at once:
                # (k_t, k_s, pc)
                dx = src[None, :, 0] - tgt[:, None, 0]
                dy = src[None, :, 1] - tgt[:, None, 1]
                dz = src[None, :, 2] - tgt[:, None, 2]
                r2 = dx * dx + dy * dy + dz * dz
                inv = torch.rsqrt(r2 + eps2)
                w = sm[None] * (inv * inv * inv)
                if cutoff2 is not None:
                    w = torch.where(r2 <= cutoff2, w, 0.0)
                w = torch.where(r2 == 0.0, 0.0, w)
                acc = acc + torch.stack(
                    [(w * dx).sum(1), (w * dy).sum(1), (w * dz).sum(1)],
                    dim=1)
    if counts is not None:
        acc = acc * live[:, None, :]
    # (k, 3, planes·d²) → (planes, 3, k, d²)
    return acc.reshape(k, 3, planes, d * d).permute(2, 1, 0, 3).contiguous()


tile_sweep_plane_plain.calls = 0


@_build.counted
def tile_sweep_plane(tiles_plane, *, k: int, d: int, ws: int, eps: float,
                     cutoff2: float | None = None, far_plane=None, lo=None,
                     cell=None, counts=None):
    """Kernel K4 (``csrc/tile_near.cu``, one block per brick of cells,
    sources staged in shared memory). ``far_plane`` (d, 9 | 19, d²) needs
    ``lo`` (3,) and ``cell`` (scalar) device tensors. CPU tensors take
    the plain twin; CUDA tensors launch the kernel or raise."""
    if tiles_plane.device.type == "cpu":
        return tile_sweep_plane_plain(
            tiles_plane, k=k, d=d, ws=ws, eps=eps, cutoff2=cutoff2,
            far_plane=far_plane, lo=lo, cell=cell, counts=counts,
        )
    _build.require_cuda(tiles_plane, "tile_sweep_plane")
    dev = tiles_plane.device
    d2 = d * d
    if d * 4 * k * d2 >= (1 << 31):
        raise ValueError("tiles too large for int32 indexing")
    _build.check(tiles_plane, "tiles_plane", (d, 4, k, d2), dev)
    n_far = 0
    if far_plane is not None:
        n_far = far_plane.shape[1]
        if n_far not in (9, 19):
            raise ValueError(f"far_plane needs 9 or 19 channels, got {n_far}")
        cell = cell.reshape(())
        _build.check(far_plane, "far_plane", (d, n_far, d2), dev)
        _build.check(lo, "lo", (3,), dev)
        _build.check(cell, "cell", (), dev)
    if counts is not None:
        _build.check(counts, "counts", (d * d2,), dev)
    out = torch.empty((d, 3, k, d2), dtype=torch.float32, device=dev)
    _build.launch(
        "nbt_tile_near", dev, tiles_plane.data_ptr(), _build.ptr(far_plane),
        n_far, _build.ptr(counts),
        _build.ptr(lo) if n_far else None,
        _build.ptr(cell) if n_far else None,
        out.data_ptr(), d, k, ws, float(eps) ** 2,
        0.0 if cutoff2 is None else float(cutoff2),
        0 if cutoff2 is None else 1,
    )
    tile_sweep_plane.launches += 1
    return out


@_build.counted
def tile_sweep_slab(tiles, counts, *, k: int, d: int, ws: int, eps: float,
                    x0: int, planes: int, cutoff2: float | None = None):
    """Kernel K4's slab form (``csrc/tile_near.cu``, ``nbt_tile_near_slab``):
    the sweep of target planes [x0, x0 + planes) of the halo'd slab
    ``tiles`` (nx, 4, k, d²) against all its planes, ``counts`` (nx·d²)
    marking the live slots, no far seed → (planes, 3, k, d²), unscaled by
    G. CPU tensors take the plain twin; CUDA tensors launch the kernel or
    raise."""
    if tiles.device.type == "cpu":
        return tile_sweep_plane_plain(
            tiles, k=k, d=d, ws=ws, eps=eps, cutoff2=cutoff2, counts=counts,
            slab=(x0, planes))
    _build.require_cuda(tiles, "tile_sweep_slab")
    dev = tiles.device
    nx, d2 = tiles.shape[0], d * d
    if not (0 <= x0 and 1 <= planes and x0 + planes <= nx):
        raise ValueError(f"target planes [{x0}, {x0 + planes}) outside the "
                         f"slab's {nx}")
    if nx * 4 * k * d2 >= (1 << 31):
        raise ValueError("tiles too large for int32 indexing")
    _build.check(tiles, "tiles", (nx, 4, k, d2), dev)
    _build.check(counts, "counts", (nx * d2,), dev)
    out = torch.empty((planes, 3, k, d2), dtype=torch.float32, device=dev)
    _build.launch(
        "nbt_tile_near_slab", dev, tiles.data_ptr(), counts.data_ptr(),
        out.data_ptr(), nx, x0, planes, d, k, ws, float(eps) ** 2,
        0.0 if cutoff2 is None else float(cutoff2),
        0 if cutoff2 is None else 1,
    )
    tile_sweep_slab.launches += 1
    return out
