"""Distributed Barnes-Hut and spatial-hash forces over the device mesh.

PyTorch counterpart of ``nbody_tpu/parallel/tree.py``, with its
communication patterns:

  1. **psum-combined pyramid** (far field): every position sums its own
     rows' moments into the full finest grid, and ONE ``psum`` gives each
     the exact global moments. The upward pass and the per-level far
     sweeps (kernel K3 at order 2) run replicated, on every position: the
     grid work is independent of N. A position's finest moments are its
     rows sorted by cell and summed by kernel K6 (``ops/scatter.
     segment_sum``), which writes every cell once in row order, where the
     JAX package scatter-adds: float atomics (``index_add_``) would make
     two runs of the same step differ in the last bits.
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

Each force is a program of stages split at those collectives
(``parallel/program.py``), every tensor one stage leaves for a later one
named in the position's carry:

  * tree-slabs: bounds | pmin, pmax | geometry, coords, finest moments |
    psum | pyramid, far field (K3 each level), far pickup, routing |
    all_to_all | slab tiles | halo hop 1 … ⌈ws/S⌉ | halo concat, K4's slab
    form, pickup into receive order | all_to_all | route back + far
    pickup;
  * hash-slabs: the same without the far field (bounds | pmin, pmax |
    coords, routing | …).

Functions take and return sharded tensors: lists of one block per
position of this process (``parallel/mesh.py``). q is the GLOBAL
position index, which picks the slab and the halo's edge planes.
"""

from __future__ import annotations

import functools

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
from nbody_tpu_torch.parallel.program import (
    Collective,
    Stage,
    device_key,
    run_forces,
)


def _route_rows(pos_l, mass_l, dest, n_dev: int, capacity: int):
    """One position's send buffer (P, C, 5) of rows [x, y, z, m, valid]
    for its slab owners, sorted stably by destination, with the rows past
    a destination's capacity sent to a sink column that is sliced away.
    Returns (send, order, dest_s, rank, overflow): the sort, each sorted
    row's destination and rank there, for ``_route_back``."""
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
    return send, order, dest_s, rank, overflow


def _route_back(acc_back, order, dest_s, rank):
    """The routing undone for the accelerations ``acc_back`` (P, C, 3):
    (n_local, 3), zero for the rows past capacity."""
    n_dev, c = acc_back.shape[:2]
    flat = acc_back.reshape(n_dev * c, 3)
    acc_s = flat[dest_s * c + torch.clamp(rank, max=c - 1)]
    acc_s = torch.where((rank < c)[:, None], acc_s, 0.0)
    return unsort_rows(acc_s, order)


def _route_to_slabs(pos_l, mass_l, dest, n_dev: int, capacity: int):
    """``_route_rows`` as (send, route_back, overflow), ``route_back(
    acc_back (P, C, 3)) -> (n_local, 3)``."""
    send, order, dest_s, rank, overflow = _route_rows(
        pos_l, mass_l, dest, n_dev, capacity)
    return (send, functools.partial(_route_back, order=order, dest_s=dest_s,
                                    rank=rank), overflow)


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


# ---- the stages and collectives both forces share ------------------------


def _bounds():
    def fn(i, q, c):
        x = c["pos"]
        return {"lo_l": torch.min(x, dim=0).values,
                "hi_l": torch.max(x, dim=0).values}

    return Stage("bounds", fn)


def _pmin_pmax():
    def fn(cs, mesh):
        lo = pmin([c["lo_l"] for c in cs], mesh)
        hi = pmax([c["hi_l"] for c in cs], mesh)
        return [{"lo": a, "hi": b} for a, b in zip(lo, hi)]

    return Collective("pmin, pmax", fn)


def _exchange(src: str, dst: str):
    """``all_to_all`` of each position's ``src`` into its ``dst``."""
    def fn(cs, mesh):
        return [{dst: x} for x in all_to_all([c[src] for c in cs], mesh)]

    return Collective(f"all_to_all {dst}", fn)


def _route(p: int, s: int, capacity: int):
    """``fn(c, coords) -> values``: the routing of a position's rows by
    the x-slab of ``coords`` (capacity 0 → N/P, which cannot overflow)."""

    def fn(c, coords):
        x = c["pos"]
        dest = torch.clamp(torch.div(coords[:, 0].long(), s,
                                     rounding_mode="floor"), 0, p - 1)
        send, order, dest_s, rank, over = _route_rows(
            x, c["mass"], dest, p, capacity or x.shape[0])
        return {"send": send, "route_order": order, "dest_s": dest_s,
                "rank": rank, "route_over": over}

    return fn


def _tiles(p: int, s: int, d: int, k: int, coords_fn, cell_fn):
    """The slab build of the rows a position received:
    ``coords_fn(c, x)`` their cells, ``cell_fn(c)`` the cell edge."""

    def fn(i, q, c):
        recv = c["recv"].reshape(-1, 5)
        tiles, counts, lid_s, rank_s, order, over = _build_slab_tiles(
            recv, coords_fn(c, recv[:, :3]), recv[:, 4] > 0.5, q, s, d, k,
            c["lo"], cell_fn(c))
        return {"tiles": tiles, "counts": counts, "lid_s": lid_s,
                "rank_s": rank_s, "tile_order": order, "tile_over": over}

    return Stage("slab tiles", fn)


def _halo_hops(s: int, ws: int) -> list:
    """The halo's ppermute chain: hop j delivers position q − j's slab as
    ``left<j>`` and q + j's as ``right<j>`` (tiles and counts), from
    which ``_near`` takes the planes it needs."""

    def hop(j):
        def fn(cs, mesh):
            out = [{} for _ in cs]
            for side, shift in (("left", 1), ("right", -1)):
                for part in ("tiles", "counts"):
                    src = part if j == 1 else f"{side}{j - 1}_{part}"
                    got = ppermute([c[src] for c in cs], mesh, shift)
                    for o, x in zip(out, got):
                        o[f"{side}{j}_{part}"] = x
            return out

        return Collective(f"halo hop {j}", fn)

    return [hop(j) for j in range(1, -(-ws // s) + 1)]


def _near(p: int, s: int, d: int, k: int, ws: int, eps: float, cutoff2):
    """Each position's slab with its ±ws halo planes (planes wrapped past
    the grid's edge get no live slot, so the sweep reads none of their
    rows), K4's slab form over its own planes, and the pickup of every
    routed row in receive order."""

    def fn(i, q, c):
        left, right, rem = [], [], ws
        for j in range(1, -(-ws // s) + 1):
            take = min(s, rem)
            lt = c[f"left{j}_tiles"][s - take:]
            lc = c[f"left{j}_counts"].reshape(s, -1)[s - take:]
            rt = c[f"right{j}_tiles"][:take]
            rc = c[f"right{j}_counts"].reshape(s, -1)[:take]
            if q < j:
                lc = torch.zeros_like(lc)
            if q >= p - j:
                rc = torch.zeros_like(rc)
            left.insert(0, (lt, lc))
            right.append((rt, rc))
            rem -= take
        parts = left + [(c["tiles"], c["counts"].reshape(s, -1))] + right
        tiles = torch.cat([t for t, _ in parts])
        counts = torch.cat([n for _, n in parts]).reshape(-1)
        out = tile_sweep_slab(tiles, counts, k=k, d=d, ws=ws, eps=eps,
                              x0=ws, planes=s, cutoff2=cutoff2)
        # pickup per routed row (cell-sorted order) → receive order
        acc_t = out.permute(0, 3, 2, 1).reshape(s * d * d * k, 3)
        lid_s, rank_s = c["lid_s"], c["rank_s"]
        idx = (torch.clamp(lid_s, max=s * d * d - 1) * k
               + torch.clamp(rank_s, max=k - 1))
        ok = (rank_s < k) & (lid_s < s * d * d)
        picked = torch.where(ok[:, None], acc_t[idx], 0.0)
        return {"acc_recv": unsort_rows(picked, c["tile_order"])
                .reshape(p, -1, 3)}

    return Stage("slab sweep", fn)


def _home(G: float, far: bool):
    """The routing undone, times G, plus the far pickup when ``far``."""

    def fn(i, q, c):
        near = _route_back(c["acc_back"], c["route_order"], c["dest_s"],
                           c["rank"])
        return {"force": G * near + c["pick"] if far else G * near}

    return Stage("route back", fn)


def _overflow():
    """The routing plus the tile overflow, psum'd (``return_overflow``)."""

    def fn(cs, mesh):
        total = psum([c["route_over"] + c["tile_over"] for c in cs], mesh)
        return [{"overflow": t} for t in total]

    return Collective("psum overflow", fn)


# ---- the programs ---------------------------------------------------------


def tree_slab_ops(mesh: Mesh, G: float = 1.0, softening: float = 0.1,
                  theta: float = 0.5, *, levels: int = 6, near_k: int = 16,
                  multipole_order: int = 2, capacity: int = 0,
                  return_overflow: bool = False) -> tuple:
    """Tree-slabs as a force program (module docstring): carries ``pos``
    and ``mass`` in, ``force`` out (and ``overflow`` when
    ``return_overflow``)."""
    p = mesh.size
    d = 1 << levels
    if d % p:
        raise ValueError(f"finest grid {d}^3 must split over {p} devices "
                         "evenly")
    s = d // p
    ws = theta_to_ws(theta, order=multipole_order)

    def coords_fn(c, x):
        return torch.clamp(((x - c["lo"]) / c["cell"]).to(torch.int32), 0,
                           d - 1)

    def moments(i, q, c):
        lo, cell = pyramid_geometry(c["lo"], c["hi"], levels)
        coords = torch.clamp(((c["pos"] - lo) / cell).to(torch.int32), 0,
                             d - 1)
        return {"cell": cell, "coords": coords,
                "packed_l": scatter_finest_moments(
                    c["pos"], c["mass"], coords, lo, cell, d,
                    multipole_order)}

    def reduce(cs, mesh):
        return [{"packed": x}
                for x in psum([c["packed_l"] for c in cs], mesh)]

    route = _route(p, s, capacity)

    def far(i, q, c):
        # replicated on every position, as in the JAX package
        lo, cell, x, coords = c["lo"], c["cell"], c["pos"], c["coords"]
        pyr = pyramid_from_packed(c["packed"], lo, cell, levels,
                                  multipole_order)
        f = [t for t in far_field_grid(pyr, ws, G, softening, levels)
             if t is not None]
        f = torch.cat(f, dim=-1).reshape(d ** 3, -1)
        cl = coords.long()
        delta = x - (lo + (coords.to(x.dtype) + 0.5) * cell)
        pick = _far_pickup(f[(cl[:, 0] * d + cl[:, 1]) * d + cl[:, 2]], delta)
        return {"pick": pick, **route(c, coords)}

    ops = [_bounds(), _pmin_pmax(), Stage("moments", moments),
           Collective("psum moments", reduce), Stage("far field", far),
           _exchange("send", "recv"),
           _tiles(p, s, d, near_k, coords_fn, lambda c: c["cell"]),
           *_halo_hops(s, ws), _near(p, s, d, near_k, ws, softening, None),
           _exchange("acc_recv", "acc_back"), _home(G, far=True)]
    return tuple(ops + [_overflow()] if return_overflow else ops)


def hash_slab_ops(mesh: Mesh, G: float = 1.0, softening: float = 0.1, *,
                  cutoff: float = 2.0, cell_size: float = 1.0, cap: int = 64,
                  max_per_cell: int = 64, capacity: int = 0,
                  return_overflow: bool = False) -> tuple:
    """Hash-slabs as a force program (module docstring): carries ``pos``
    and ``mass`` in, ``force`` out (and ``overflow`` when
    ``return_overflow``)."""
    p = mesh.size
    if cap % p:
        raise ValueError(f"grid cap {cap} must split over {p} devices evenly")
    s = cap // p
    # the cell edge on each device, made once: a tensor made from host data
    # inside the step would be a host-to-device copy
    cells = {}
    for dev in mesh.devices:
        cells.setdefault(device_key(dev), torch.full(
            (), float(cell_size), dtype=torch.float32, device=dev))
    route = _route(p, s, capacity)

    def coords_fn(c, x):
        cc = torch.floor((x - c["lo"]) / cell_size).to(torch.int32)
        return torch.minimum(torch.clamp(cc, min=0), c["dims"] - 1)

    def coords(i, q, c):
        dims = torch.clamp(torch.ceil((c["hi"] - c["lo"]) / cell_size).to(
            torch.int32), 1, cap)
        c = c.over({"dims": dims})
        return {"dims": dims, **route(c, coords_fn(c, c["pos"]))}

    ops = [_bounds(), _pmin_pmax(), Stage("coords", coords),
           _exchange("send", "recv"),
           _tiles(p, s, cap, max_per_cell, coords_fn,
                  lambda c: cells[c["lo"].device]),
           *_halo_hops(s, 1),
           _near(p, s, cap, max_per_cell, 1, softening, cutoff * cutoff),
           _exchange("acc_recv", "acc_back"), _home(G, far=False)]
    return tuple(ops + [_overflow()] if return_overflow else ops)


def _forces(ops, pos, mass, mesh, return_overflow):
    if not return_overflow:
        return run_forces(ops, pos, mass, mesh)[0]
    acc, over = run_forces(ops, pos, mass, mesh, ("force", "overflow"))
    return acc, over[0]


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
    ops = tree_slab_ops(mesh, G, softening, theta, levels=levels,
                        near_k=near_k, multipole_order=multipole_order,
                        capacity=capacity, return_overflow=return_overflow)
    return _forces(ops, pos, mass, mesh, return_overflow)


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
    ops = hash_slab_ops(mesh, G, softening, cutoff=cutoff,
                        cell_size=cell_size, cap=cap,
                        max_per_cell=max_per_cell, capacity=capacity,
                        return_overflow=return_overflow)
    return _forces(ops, pos, mass, mesh, return_overflow)
