"""Distributed Barnes-Hut and spatial-hash forces over the device mesh.

PyTorch counterpart of ``nbody_tpu/parallel/tree.py``, with its
communication patterns:

  1. **psum-combined pyramid** (far field): every position scatter-adds
     its own rows' moments into the full finest grid, and ONE ``psum``
     gives each the exact global moments. The upward pass and the
     per-level far sweeps (kernel K3 at order 2) run replicated, on every
     position: the grid work is independent of N.
  2. **slab routing** (near field): rows go to the owner of their x-slab
     (d/P planes a position) by ONE ``all_to_all`` with a fixed capacity
     per destination and a sink column; overflow is counted, never
     dropped silently.
  3. **halo exchange**: each slab owner builds k-slot cell tiles for its
     planes and receives the ±ws boundary planes from its ring neighbours
     by ``ppermute`` — a chain of them when ws > S — with the planes
     wrapped past the grid's edge made inert (no live slot). The sweep is
     kernel K4's slab form (``ops/tile_near.tile_sweep_slab``) with the
     per-cell live counts the build computes; the JAX package's
     ``_slab_sweep`` is XLA.
  4. **inverse routing**: the accelerations ride the mirror
     ``all_to_all`` home, to the (position, slot) coordinates of the
     outbound trip.

Functions take and return sharded tensors: lists of one block per
position of this process (``parallel/mesh.py``). Each loop runs over this
process's positions with q the GLOBAL position index, which picks the
slab and the halo's edge planes; the replicated far field and the slab
sweep run per local position on its device.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.ops.barnes_hut import (
    _far_pickup,
    far_field_grid,
    pyramid_from_packed,
    pyramid_geometry,
    scatter_finest_moments,
    theta_to_ws,
)
from nbody_tpu_torch.ops.sorted_window import unsort_rows
from nbody_tpu_torch.ops.tile_near import tile_sweep_slab
from nbody_tpu_torch.parallel.mesh import (
    Mesh,
    all_to_all,
    pmax,
    pmin,
    ppermute,
    psum,
)


def _route_to_slabs(pos_l, mass_l, dest, n_dev: int, capacity: int):
    """One position's send buffer (P, C, 5) of rows [x, y, z, m, valid]
    for its slab owners, sorted stably by destination, with the rows past
    a destination's capacity sent to a sink column that is sliced away.
    Returns (send, route_back, overflow), ``route_back(acc_back (P, C,
    3)) -> (n_local, 3)`` undoing the routing for the accelerations."""
    n_l, c, dev = pos_l.shape[0], capacity, pos_l.device
    order = torch.argsort(dest, stable=True)
    dest_s = dest[order]
    start = torch.searchsorted(dest_s, torch.arange(n_dev, device=dev))
    rank = torch.arange(n_l, device=dev) - start[dest_s]
    overflow = (rank >= c).sum()
    rows = torch.cat([pos_l, mass_l[:, None], pos_l.new_ones((n_l, 1))],
                     dim=-1)[order]
    send = pos_l.new_zeros((n_dev * (c + 1), 5))
    send[dest_s * (c + 1) + torch.clamp(rank, max=c)] = rows
    send = send.reshape(n_dev, c + 1, 5)[:, :c]

    def route_back(acc_back):
        flat = acc_back.reshape(n_dev * c, 3)
        acc_s = flat[dest_s * c + torch.clamp(rank, max=c - 1)]
        acc_s = torch.where((rank < c)[:, None], acc_s, 0.0)
        return unsort_rows(acc_s, order)

    return send, route_back, overflow


def _build_slab_tiles(recv, coords, valid, q: int, s: int, d: int, k: int,
                      lo, cell):
    """Place position q's routed rows in its slab's k-slot tiles.

    recv (M, 5) routed rows, coords (M, 3) their global cell coords.
    Returns (tiles (S, 4, k, d²) plane-major, counts (S·d²) rows a cell,
    lid_s, rank_s, order, overflow): slots in stable order of the rows'
    cell, empty slots at their cell centres with mass 0, invalid rows and
    rows past k counted out through sink slots that are sliced away."""
    m, dev, dt = recv.shape[0], recv.device, recv.dtype
    num_cells = s * d * d
    lid = ((coords[:, 0].long() - q * s) * d + coords[:, 1]) * d + coords[:, 2]
    lid = torch.where(valid, lid, num_cells)
    order = torch.argsort(lid, stable=True)
    lid_s = lid[order]
    rank_s = torch.arange(m, device=dev) - torch.searchsorted(lid_s, lid_s)
    overflow = ((rank_s >= k) & (lid_s < num_cells)).sum()
    counts = torch.zeros(num_cells + 1, dtype=dt, device=dev).index_add_(
        0, lid, torch.ones(m, dtype=dt, device=dev))[:num_cells]

    xs = (q * s + torch.arange(s, dtype=dt, device=dev) + 0.5) * cell + lo[0]
    ys = (torch.arange(d, dtype=dt, device=dev) + 0.5) * cell + lo[1]
    zs = (torch.arange(d, dtype=dt, device=dev) + 0.5) * cell + lo[2]
    centres = torch.stack(torch.meshgrid(xs, ys, zs, indexing="ij"), dim=-1)
    slots = torch.cat(
        [centres.reshape(num_cells, 1, 3).expand(num_cells, k + 1, 3),
         recv.new_zeros((num_cells, k + 1, 1))], dim=-1)
    # one extra sink cell for the invalid rows
    slots = torch.cat([slots, recv.new_zeros((1, k + 1, 4))]).reshape(-1, 4)
    slots[lid_s * (k + 1) + torch.clamp(rank_s, max=k)] = recv[order, :4]
    tiles = (slots[:num_cells * (k + 1)].reshape(s, d * d, k + 1, 4)[:, :, :k]
             .permute(0, 3, 2, 1).contiguous())
    return tiles, counts, lid_s, rank_s, order, overflow


def _halo_slabs(tiles, counts, mesh: Mesh, s: int, ws: int):
    """Each position's slab with its ±ws halo planes, (S + 2ws, 4, k, d²),
    and their counts ((S + 2ws)·d²). When ws > S the halo spans ⌈ws/S⌉
    ring neighbours: hop j delivers position q ∓ j's whole slab, from which
    the planes needed are taken. Planes wrapped past the grid's edge get
    no live slot, so the sweep reads none of their rows."""
    p = mesh.size
    counts = [c.reshape(s, -1) for c in counts]
    left = [[] for _ in tiles]
    right = [[] for _ in tiles]
    cur_l, cur_r = (tiles, counts), (tiles, counts)
    rem = ws
    for j in range(1, -(-ws // s) + 1):
        cur_l = tuple(ppermute(x, mesh, 1) for x in cur_l)    # from q - j
        cur_r = tuple(ppermute(x, mesh, -1) for x in cur_r)   # from q + j
        take = min(s, rem)
        for i, q in enumerate(mesh.local):
            lt, lc = cur_l[0][i][s - take:], cur_l[1][i][s - take:]
            rt, rc = cur_r[0][i][:take], cur_r[1][i][:take]
            if q < j:
                lc = torch.zeros_like(lc)
            if q >= p - j:
                rc = torch.zeros_like(rc)
            left[i].insert(0, (lt, lc))
            right[i].append((rt, rc))
        rem -= take
    out = []
    for i in range(len(tiles)):
        parts = left[i] + [(tiles[i], counts[i])] + right[i]
        out.append((torch.cat([t for t, _ in parts]),
                    torch.cat([c for _, c in parts]).reshape(-1)))
    return out


def _sharded_near_field(pos, mass, coords, lo, cell, mesh: Mesh, *, d: int,
                        ws: int, k: int, capacity: int, eps: float,
                        cutoff2, coords_fn):
    """Slab-routed exact near field. ``coords_fn(i, pos) -> (M, 3)`` must
    reproduce the cell assignment of this process's i-th position exactly
    (routed rows re-derive their cell on the receiver). Returns (acc per
    position (n_l, 3) unscaled by G, overflow: routing plus tile overflow,
    psum'd)."""
    p = mesh.size
    s = d // p
    routed = [
        _route_to_slabs(pos[i], mass[i],
                        torch.clamp(torch.div(coords[i][:, 0].long(), s,
                                              rounding_mode="floor"),
                                    0, p - 1), p, capacity)
        for i in range(len(pos))
    ]
    recv = [r.reshape(p * capacity, 5)
            for r in all_to_all([r[0] for r in routed], mesh)]
    builds = [
        _build_slab_tiles(recv[i], coords_fn(i, recv[i][:, :3]),
                          recv[i][:, 4] > 0.5, q, s, d, k, lo[i], cell[i])
        for i, q in enumerate(mesh.local)
    ]
    slabs = _halo_slabs([b[0] for b in builds], [b[1] for b in builds],
                        mesh, s, ws)
    acc_recv = []
    for i, (tiles, counts) in enumerate(slabs):
        _, _, lid_s, rank_s, order, _ = builds[i]
        out = tile_sweep_slab(tiles, counts, k=k, d=d, ws=ws, eps=eps,
                              x0=ws, planes=s, cutoff2=cutoff2)
        # pickup per routed row (cell-sorted order) → receive order
        acc_t = out.permute(0, 3, 2, 1).reshape(s * d * d * k, 3)
        idx = (torch.clamp(lid_s, max=s * d * d - 1) * k
               + torch.clamp(rank_s, max=k - 1))
        ok = (rank_s < k) & (lid_s < s * d * d)
        picked = torch.where(ok[:, None], acc_t[idx], 0.0)
        acc_recv.append(unsort_rows(picked, order).reshape(p, capacity, 3))
    acc_back = all_to_all(acc_recv, mesh)
    acc = [r[1](a) for r, a in zip(routed, acc_back)]
    overflow = psum([r[2] + b[5] for r, b in zip(routed, builds)], mesh)
    return acc, overflow[0]


def _bounds(pos, mesh: Mesh):
    lo = pmin([torch.min(x, dim=0).values for x in pos], mesh)
    hi = pmax([torch.max(x, dim=0).values for x in pos], mesh)
    return lo, hi


def sharded_barnes_hut_forces(pos, mass, mesh: Mesh, G: float = 1.0,
                              softening: float = 0.1, theta: float = 0.5, *,
                              levels: int = 6, near_k: int = 16,
                              multipole_order: int = 2, capacity: int = 0,
                              return_overflow: bool = False):
    """Barnes-Hut with the particle axis sharded over ``mesh``: the
    psum-combined pyramid's far field, picked up at each row's own
    position, plus the slab-routed exact near field (module docstring).
    Matches the single-device ``barnes_hut_forces`` to f32 reduction-order
    tolerance on every row within the k cap. d = 2^levels must split over
    the mesh evenly. ``capacity`` is the routing capacity per destination
    (0 → N/P, which cannot overflow); overflowed rows lose their near field
    only and are counted (``return_overflow=True`` → (acc, overflow))."""
    p = mesh.size
    d = 1 << levels
    if d % p:
        raise ValueError(f"finest grid {d}^3 must split over {p} devices "
                         "evenly")
    ws = theta_to_ws(theta, order=multipole_order)
    cap = capacity if capacity > 0 else pos[0].shape[0]
    lo_hi = _bounds(pos, mesh)
    blocks = range(len(pos))
    geo = [pyramid_geometry(lo_hi[0][i], lo_hi[1][i], levels) for i in blocks]
    lo, cell = [g[0] for g in geo], [g[1] for g in geo]

    def coords_fn(i, x):
        return torch.clamp(((x - lo[i]) / cell[i]).to(torch.int32), 0, d - 1)

    coords = [coords_fn(i, pos[i]) for i in blocks]
    packed = psum([
        scatter_finest_moments(pos[i], mass[i], coords[i], lo[i], cell[i], d,
                               multipole_order)
        for i in blocks
    ], mesh)
    picks = []
    for i in blocks:
        # replicated on every position, as in the JAX package
        pyr = pyramid_from_packed(packed[i], lo[i], cell[i], levels,
                                  multipole_order)
        far = [f for f in far_field_grid(pyr, ws, G, softening, levels)
               if f is not None]
        far = torch.cat(far, dim=-1).reshape(d ** 3, -1)
        c = coords[i].long()
        delta = pos[i] - (lo[i] + (coords[i].to(pos[i].dtype) + 0.5)
                          * cell[i])
        picks.append(_far_pickup(far[(c[:, 0] * d + c[:, 1]) * d + c[:, 2]],
                                 delta))
    near, overflow = _sharded_near_field(
        pos, mass, coords, lo, cell, mesh, d=d, ws=ws, k=near_k,
        capacity=cap, eps=softening, cutoff2=None, coords_fn=coords_fn)
    acc = [G * a + pk for a, pk in zip(near, picks)]
    return (acc, overflow) if return_overflow else acc


def sharded_spatial_hash_forces(pos, mass, mesh: Mesh, G: float = 1.0,
                                softening: float = 0.1, *,
                                cutoff: float = 2.0, cell_size: float = 1.0,
                                cap: int = 64, max_per_cell: int = 64,
                                capacity: int = 0,
                                return_overflow: bool = False):
    """Spatial-hash short-range forces with the particle axis sharded over
    ``mesh``: the single-device pair predicate (cutoff² tested on the raw
    squared distance, before softening) over the 27-cell neighbourhood as
    the ws = 1 slab sweep. ``cap`` (the static grid dim) must split over
    the mesh evenly; ``capacity`` and ``return_overflow`` as in
    ``sharded_barnes_hut_forces``."""
    p = mesh.size
    if cap % p:
        raise ValueError(f"grid cap {cap} must split over {p} devices evenly")
    capacity_ = capacity if capacity > 0 else pos[0].shape[0]
    lo, hi = _bounds(pos, mesh)
    dims = [torch.clamp(torch.ceil((b - a) / cell_size).to(torch.int32), 1,
                        cap) for a, b in zip(lo, hi)]

    def coords_fn(i, x):
        c = torch.floor((x - lo[i]) / cell_size).to(torch.int32)
        return torch.minimum(torch.clamp(c, min=0), dims[i] - 1)

    coords = [coords_fn(i, x) for i, x in enumerate(pos)]
    cell = [torch.tensor(cell_size, dtype=x.dtype, device=x.device)
            for x in pos]
    acc, overflow = _sharded_near_field(
        pos, mass, coords, lo, cell, mesh, d=cap, ws=1, k=max_per_cell,
        capacity=capacity_, eps=softening, cutoff2=cutoff * cutoff,
        coords_fn=coords_fn)
    acc = [G * a for a in acc]
    return (acc, overflow) if return_overflow else acc
