"""Plain reference of the spatial hash's short-range accelerations.

The published predicate, recomputed from positions and masses alone: a
pair counts when its rows lie in neighbouring cells of the hash grid (the
3×3×3 cells around the target's) and its RAW squared distance is at most
cutoff² (tested before softening); the self pair is skipped; each counted
pair adds G·m·d/(r² + ε²)^{3/2}. The grid (bounding-box corner, cell
edge, dims clipped to the cap) is the program's float32 binning rule on
the same device, an integer decision; the sum runs in float64, or in the
control's lower precision (``precision="tf32"``: positions and masses
rounded to TF32, the arithmetic in float32).

A pair whose r² lies within ``BAND`` (relative) of cutoff² may fall on
either side of the cutoff in float32; ``accelerations`` returns, per
target, the summed magnitude of such pairs' terms, by which the comparison
lets the program's result move.
"""

from __future__ import annotations

import torch

from portbench.reference.bh import tf32

BAND = 1e-5
BLOCK = 512  # targets a block


def geometry(pos, cell_size: float, cap: int):
    lo = torch.min(pos, dim=0).values
    hi = torch.max(pos, dim=0).values
    dims = torch.clamp(torch.ceil((hi - lo) / cell_size).to(torch.int32),
                       1, cap)
    coords = torch.clamp(torch.floor((pos - lo) / cell_size).to(torch.int32),
                         min=torch.zeros_like(dims), max=dims - 1)
    return dims.to(torch.int64), coords.to(torch.int64)


def accelerations(pos, mass, targets, sim: dict, precision: str = "f64",
                  grid_pos=None):
    """Accelerations of the rows ``targets`` → (acc (S, 3), comparable
    (S,) all True, band (S,), counts (cells,)). ``grid_pos``: the
    positions the cells were assigned from, where that is not ``pos``."""
    cs = float(sim.get("spatial_hash_cell_size", 1.0))
    cutoff = float(sim.get("spatial_hash_cutoff", 2.0))
    cap = int(sim.get("hash_max_grid_dim", 64))
    eps, G = float(sim.get("softening", 0.1)), float(sim.get("G", 1.0))
    dev = pos.device
    dims, coords = geometry(pos if grid_pos is None else grid_pos, cs, cap)
    nx, ny, nz = (int(v) for v in dims)
    cid = (coords[:, 0] * ny + coords[:, 1]) * nz + coords[:, 2]
    counts = torch.bincount(cid, minlength=nx * ny * nz)
    order = torch.argsort(cid, stable=True)
    start = torch.cumsum(counts, 0) - counts
    if precision == "f64":
        dt, p, m = torch.float64, pos.to(torch.float64), mass.to(torch.float64)
    else:
        dt, p, m = torch.float32, tf32(pos), tf32(mass)
    ps, ms = p[order], m[order]
    r = torch.arange(-1, 2, device=dev)
    off = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(27, 3)
    c2 = cutoff * cutoff
    hi_band, lo_band = c2 * (1 + BAND), c2 * (1 - BAND)
    accs, bands = [], []
    for b0 in range(0, targets.shape[0], BLOCK):
        t = targets[b0:b0 + BLOCK]
        nb = coords[t][:, None, :] + off[None]
        lim = torch.stack([dims.new_tensor(nx), dims.new_tensor(ny),
                           dims.new_tensor(nz)]).to(dev)
        inside = ((nb >= 0) & (nb < lim)).all(-1)
        nid = (nb[..., 0] * ny + nb[..., 1]) * nz + nb[..., 2]
        nid = torch.where(inside, nid, torch.zeros_like(nid))
        cnt = torch.where(inside, counts[nid], torch.zeros_like(nid))
        width = int(cnt.max())
        slot = torch.arange(width, device=dev)
        live = slot[None, None, :] < cnt[..., None]
        idx = torch.clamp(start[nid][..., None] + slot, max=pos.shape[0] - 1)
        dvec = ps[idx] - p[t][:, None, None, :]
        r2 = (dvec * dvec).sum(-1)
        ok = live & (r2 != 0.0)
        inv = torch.rsqrt(r2 + eps * eps)
        term = ms[idx] * inv * inv * inv
        inner = ok & (r2 <= c2)
        w = torch.where(inner, term, torch.zeros((), dtype=dt, device=dev))
        accs.append(G * (w[..., None] * dvec).sum(dim=(1, 2)))
        edge = ok & (r2 >= lo_band) & (r2 <= hi_band)
        mag = torch.where(edge, term * torch.sqrt(r2),
                          torch.zeros((), dtype=dt, device=dev))
        bands.append(G * mag.sum(dim=(1, 2)))
    acc = torch.cat(accs)
    return (acc, torch.ones(acc.shape[0], dtype=torch.bool, device=dev),
            torch.cat(bands), counts)
