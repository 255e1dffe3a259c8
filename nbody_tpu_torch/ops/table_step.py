"""Table-resident frozen-grid stepping: Verlet steps that keep the
integration state in the near sweep's slot layout between re-sorts.

PyTorch counterpart of ``nbody_tpu/ops/table_step.py``. The row-space
cadence (``integrator.make_resort_multi_step``) skips the sort on a frozen
step but still pays the slot placement (kernel K2) and the pickup gather
every step, because its state returns to row layout between steps. Here the
state LIVES in the sweep's plane-major slot layout (d, C, k, d²):

    pos_t: (d, 4, k, d²) [x, y, z, mass], the sweep's input
    vel_t: (d, 3, k, d²)
    acc_t: (d, 3, k, d²), G-scaled, the sweep's output layout
    cov_t: (d, 1, k, d²), 1.0 where a row lives

A frozen step is then: drift (one pass, ``table_drift``) → the finest
moments from the table (one reduction over the slot axis; Barnes-Hut only)
→ pyramid + far grids (kernel K3) → sweep (kernel K4, on pos_t itself) →
kick (one pass, ``table_kick``). No sort, no placement, no pickup. A
re-sort extracts the rows (one gather), sorts them and rebuilds the table
with K2's rank form, with the coverage plane and the velocities as extra
channels. ``table_drift`` and ``table_kick`` are the wrappers of
``csrc/table_step.cu``, with plain twins.

Empty slots are inert: K2 parks them at their cell centre with mass 0 (they
exert nothing), and the exact coverage plane masks their velocity and
acceleration to zero so they never move. K4's liveness is a per-cell slot
count (``TableState.live``): min(count, k) after a build, the high-water
mark of the occupied slots after a repair; holes below it are filler, inert
as sources and masked by cov as targets.

Rows past the k-slot cap (the Poisson tail of dense cells) ride a side
buffer rebuilt at each re-sort from K2's exact per-cell counts, integrate
with the far expansion's A at their frozen cell centre (the row engines'
overflow fallback) and add their mass to the finest moments. Every such row
gets a side row, on one host read of the overflow count at each re-sort: a
collapsing scene's overflow grows far past any static size (the 1M
Barnes-Hut cold collapse holds ~1.5·10⁵ rows past k = 16 by step 30), and
the JAX package's static buffer lets the rows beyond it read the state of
another row's slot. The drivers keep the buffer's length in a bucket, so
its shapes stay put between re-sorts: a power of two of at least the
count and at least ``SIDE_MIN`` rows, doubled when a re-sort's count
exceeds it, never shrunk within a driver's graphs. ``side_valid`` marks
the live rows; the padding rows have zero mass, stay still, feed no moment,
are never audited and are never read out (no row's ``idx_ext`` points at
one).

Row identities never pass through floats. ``tag`` (N,) int32 holds each
row's original index in the last re-sort's row order, ``idx_ext`` (N,)
int32 each row's slot (cell·k + slot, or d³·k + j for side row j) and
``slot_row`` (d³·k,) int32 each slot's row (−1 when empty); the readout is
one gather by ``idx_ext`` and one index store by ``tag``, a permutation by
construction. (The JAX package carries the tags as f32 table channels and
reads out by an argsort of the gathered tags, which misorders rows whose
state is read from a shared slot past its static side buffer.) Masses never change, so each row's mass
is kept in row order and read back from there.

Three drivers: the fixed cadence (``make_table_multi_step``), the audited
adaptive re-sort (``make_table_adaptive_multi_step``: the staleness audit
runs on the drifted positions BEFORE the force, so no frozen step above the
threshold is taken) and the exact incremental repair
(``make_table_repair_multi_step``: every step re-homes exactly the rows whose
cell changed through K2's dest form, stored in place so a repair costs what
its movers cost, and rebuilds only past ``repair_cap`` movers or
``max_cadence`` steps). Each ``lax.cond`` of the JAX drivers is a
host decision here, on at most one read of a device count per step (and one
more on a re-sort, the side buffer's count). Their steps are segments of an
``ops.step_graph.SegmentGraphs`` on the TableState as its carry (``entry``,
``drift`` / ``drift_audit``, ``sort``, ``build`` per side bucket, ``tail``,
``repair``): captured CUDA graphs replayed between the host reads when the
caller hands one in (the facade on the card), else run eagerly. A drift
leaves the drifted table and the half-kicked velocities in the carry's
``pos_t`` and ``vel_t`` (the step's start is not needed again), and the
next segment of the step finishes it.

The TPU layout machinery of the JAX module (the lane padding L, chunk and
mover bookkeeping for the one-hot placement, the plane relayout) has no
counterpart: K2 writes the sweep's layout directly. The reference re-sorts
every step (Thrust, force_barnes_hut.cu:276-280); this stepping has no
reference counterpart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.ops.barnes_hut import (
    bin_particles,
    far_plane_grid,
    theta_to_ws,
)
from nbody_tpu_torch.ops.scatter import (
    SENTINEL_DEST,
    cell_centers,
    segment_sum,
    tile_place,
    tile_scatter,
)
from nbody_tpu_torch.ops.sorted_window import build_sorted_grid, sorted_ranks
from nbody_tpu_torch.ops.spatial_hash import tiles_bin
from nbody_tpu_torch.ops.step_graph import SegmentGraphs, stack_trace
from nbody_tpu_torch.ops.tile_near import tile_sweep_plane
from nbody_tpu_torch.ops.tile_sweep import tile_engine_fused
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.utils.profiling import profile_phase


@dataclasses.dataclass(frozen=True)
class TableParams:
    """Static configuration of a table-resident engine."""

    mode: str                 # "bh" | "hash"
    d: int
    k: int
    G: float
    softening: float
    ws: int
    levels: int = 0           # bh only
    cutoff2: float | None = None  # hash only
    cell_size: float | None = None  # hash only (fixed cell width)

    @property
    def near(self) -> str:
        """Phase prefix of the near field, as the row engines name it."""
        return "bh" if self.mode == "bh" else "near"

    @property
    def sort_phase(self) -> str:
        return "bh.sort" if self.mode == "bh" else "hash.sort"


@dataclasses.dataclass
class TableState:
    """Integration state in plane-major slot layout plus the side buffer
    and the row bookkeeping (module docstring)."""

    pos_t: torch.Tensor      # (d, 4, k, d²) [x, y, z, m]
    vel_t: torch.Tensor      # (d, 3, k, d²)
    acc_t: torch.Tensor      # (d, 3, k, d²) G-scaled
    cov_t: torch.Tensor      # (d, 1, k, d²) 1.0 where occupied
    live: torch.Tensor       # (d³,) f32 K4's live slots per cell
    slot_row: torch.Tensor   # (d³·k,) i32 row of each slot, −1 empty
    idx_ext: torch.Tensor    # (N,) i32 slot (or d³·k + side row) of a row
    tag: torch.Tensor        # (N,) i32 original index of each row
    mass: torch.Tensor       # (N,) each row's mass
    side: torch.Tensor       # (cap, 7) [x, y, z, m, vx, vy, vz]
    side_cell: torch.Tensor  # (cap,) i32 frozen cell id
    side_acc: torch.Tensor   # (cap, 3) G-scaled
    side_valid: torch.Tensor  # (cap,) bool a live side row (not padding)
    lo: torch.Tensor         # (3,) grid origin at the last re-sort
    cell: torch.Tensor       # () cell width at the last re-sort
    time: torch.Tensor       # ()


# The side buffer's least bucket (rows)
SIDE_MIN = 1024


def side_bucket(total: int, cap: int = 0) -> int:
    """The side buffer's length for ``total`` overflow rows: ``cap`` while
    it holds them, else the least power of two ≥ max(total, SIDE_MIN)."""
    need = max(total, SIDE_MIN)
    return cap if cap >= need else 1 << (need - 1).bit_length()


# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------


def _coord(v, lo_i, cell, p: TableParams):
    if p.mode == "bh":
        c = ((v - lo_i) / cell).to(torch.int32)
    else:
        c = torch.floor((v - lo_i) / p.cell_size).to(torch.int32)
    return torch.clamp(c, 0, p.d - 1)


def _bin_ids(x, y, z, lo, cell, p: TableParams):
    """Linear cell ids of coordinates ``x, y, z`` (any shape) by each
    engine's own binning formula, bit for bit: truncation for Barnes-Hut
    (``barnes_hut.bin_particles``), floor for the hash
    (``spatial_hash.tiles_bin``)."""
    d = p.d
    return ((_coord(x, lo[0], cell, p) * d + _coord(y, lo[1], cell, p)) * d
            + _coord(z, lo[2], cell, p))


def _grid_geometry(pos, p: TableParams):
    """(lo, cell, coords): the engine's own geometry and binning of rows."""
    if p.mode == "bh":
        return bin_particles(pos, p.levels)
    lo, coords = tiles_bin(pos, p.cell_size, p.d)
    cell = torch.full((), float(p.cell_size), dtype=pos.dtype,
                      device=pos.device)
    return lo, cell, coords


def _static_cell_ids(p: TableParams, device):
    """Each slot's own linear cell id, (d, 1, d²) int32."""
    d = p.d
    x = torch.arange(d, dtype=torch.int32, device=device) * (d * d)
    yz = torch.arange(d * d, dtype=torch.int32, device=device)
    return x[:, None, None] + yz[None, None, :]


def _centres(lo, cell, p: TableParams):
    """Cell-centre coordinates broadcastable over (d, k, d²): x per plane,
    y and z per lane, rounded as ``scatter.cell_centers``."""
    d = p.d
    g = torch.arange(d, dtype=lo.dtype, device=lo.device)
    lane = torch.arange(d * d, device=lo.device)
    cx = lo[0] + (g + 0.5) * cell
    cy = lo[1] + (g[lane // d] + 0.5) * cell
    cz = lo[2] + (g[lane % d] + 0.5) * cell
    return cx[:, None, None], cy[None, None, :], cz[None, None, :]


def _slot_coords(s, p: TableParams):
    """Slot ids cell·k + slot → (x, slot, yz) int64 plane indices."""
    s = s.to(torch.int64)
    c, r = s // p.k, s % p.k
    return c // (p.d * p.d), r, c % (p.d * p.d)


def _read_rows(ts: TableState, planes, side, p: TableParams):
    """(N, C) per row, in the last re-sort's row order: the channels of
    ``planes`` (each (d, C_i, k, d²)) at the row's slot ``idx_ext``, or its
    side row's ``side`` (cap, C)."""
    nck = p.d ** 3 * p.k
    x, r, yz = _slot_coords(torch.clamp(ts.idx_ext, max=nck - 1), p)
    rows = torch.cat([pl[x, :, r, yz] for pl in planes], dim=1)
    if side.shape[0] > 0:
        j = torch.clamp(ts.idx_ext.to(torch.int64) - nck, 0, side.shape[0] - 1)
        rows = torch.where((ts.idx_ext >= nck)[:, None], side[j], rows)
    return rows


# ---------------------------------------------------------------------------
# core phases
# ---------------------------------------------------------------------------


def _table_moments(pos_d_t, ts: TableState, side_pd, p: TableParams):
    """Finest-level order-2 moments (d, d, d, 10) of the current table
    positions about the FROZEN cell centres, channel order [m, m·xr(3),
    m·xr²(3), m·xy, m·xz, m·yz] as K2's, plus the side rows' (so the far
    field keeps every row's mass): the frozen step's stand-in for K2's
    fused moments."""
    d = p.d
    nc = d * d * d
    cx, cy, cz = _centres(ts.lo, ts.cell, p)
    m = pos_d_t[:, 3]
    xr, yr, zr = pos_d_t[:, 0] - cx, pos_d_t[:, 1] - cy, pos_d_t[:, 2] - cz
    chans = (m, m * xr, m * yr, m * zr, m * (xr * xr), m * (yr * yr),
             m * (zr * zr), m * (xr * yr), m * (xr * zr), m * (yr * zr))
    # empty slots: mass 0, so they add zeros
    mom = torch.stack([c.sum(dim=1) for c in chans], dim=-1)  # (d, d², 10)
    mom = mom.reshape(nc, 10)
    if ts.side.shape[0] > 0:
        sc = ts.side_cell.to(torch.int64)
        ctr = cell_centers(ts.lo, ts.cell, d)[sc]
        sm = side_pd[:, 3:4]
        sx = side_pd[:, 0:3] - ctr
        x, y, z = sx[:, 0:1], sx[:, 1:2], sx[:, 2:3]
        svals = torch.cat([sm, sm * sx, sm * (sx * sx), sm * (x * y),
                           sm * (x * z), sm * (y * z)], dim=-1)
        # per-cell sums in a fixed order, by kernel K6 on the rows sorted by
        # cell (an index_add_ on the card adds with atomics in no fixed
        # order, and the audit that picks the re-sort steps would then vary
        # from run to run); padding rows go past every cell, adding nothing
        dest = torch.where(ts.side_valid, ts.side_cell, SENTINEL_DEST)
        order = torch.argsort(dest, stable=True)
        mom = mom + segment_sum(svals[order].contiguous(), dest[order],
                                nc).T
    return mom.reshape(d, d, d, 10)


def _far_grids(packed, lo, cell, p: TableParams):
    """(far_plane (d, 19, d²) unscaled, far_a (d³, 3)) for Barnes-Hut;
    (None, None) for the hash."""
    if p.mode != "bh":
        return None, None
    far_plane = far_plane_grid(packed, lo, cell, levels=p.levels, ws=p.ws,
                               eps=p.softening)
    far_a = far_plane[:, 0:3, :].permute(0, 2, 1).reshape(p.d ** 3, 3)
    return far_plane, far_a


def _sweep(pos_t, far_plane, lo, cell, live, p: TableParams):
    with profile_phase(f"{p.near}.sweep", device=pos_t.device):
        return tile_sweep_plane(
            pos_t, k=p.k, d=p.d, ws=p.ws, eps=p.softening, cutoff2=p.cutoff2,
            far_plane=far_plane, lo=lo, cell=cell, counts=live,
        )  # (d, 3, k, d²) unscaled


def _side_kick(side_pd, side_cell, side_valid, far_a, dt, p: TableParams):
    """Side rows after the force: (side (cap, 7), side_acc (cap, 3)), with
    G·A of their frozen cell (zero for the hash and the padding rows)."""
    if far_a is None:
        sacc = torch.zeros_like(side_pd[:, 0:3])
    else:
        sacc = torch.where(side_valid[:, None],
                           p.G * far_a[side_cell.to(torch.int64)], 0.0)
    svel = side_pd[:, 4:7] + (0.5 * dt) * sacc
    return torch.cat([side_pd[:, 0:4], svel], dim=-1), sacc


def table_drift_plain(pos_t, vel_t, acc_t, cov_t, lo, cell, dt,
                      p: TableParams, audit: bool = False):
    """Plain twin of ``table_drift``."""
    table_drift_plain.calls += 1
    pos_d3 = pos_t[:, 0:3] + vel_t * dt + (0.5 * dt * dt) * acc_t
    pos_d_t = torch.cat([pos_d3, pos_t[:, 3:4]], dim=1)
    vel_h = vel_t + (0.5 * dt) * acc_t
    if not audit:
        return pos_d_t, vel_h, None, None
    ids_now = _bin_ids(pos_d_t[:, 0], pos_d_t[:, 1], pos_d_t[:, 2], lo, cell,
                       p)
    stale = (ids_now != _static_cell_ids(p, ids_now.device)) & (
        cov_t[:, 0] > 0.0)
    return (pos_d_t, vel_h, torch.where(stale, ids_now, -1),
            stale.sum().to(torch.int32))


table_drift_plain.calls = 0


@_build.counted
def table_drift(pos_t, vel_t, acc_t, cov_t, lo, cell, dt, p: TableParams,
                audit: bool = False):
    """Position drift and first half-kick of a table, one pass
    (``csrc/table_step.cu``), with the row steppers' arithmetic (empty
    slots have vel = acc = 0 and stay at their cell centres) →
    ``(pos_d_t (d, 4, k, d²), vel_h (d, 3, k, d²), mover, n_stale)``. With
    ``audit``, ``mover`` (d, k, d²) int32 is each occupied slot's cell under
    the frozen binning (``_bin_ids``) of its drifted position where that
    cell is not the slot's own, else −1, and ``n_stale`` () int32 the count
    of such slots; else both are None. CPU tensors take the plain twin;
    CUDA tensors launch the kernel or raise."""
    if pos_t.device.type == "cpu":
        return table_drift_plain(pos_t, vel_t, acc_t, cov_t, lo, cell, dt, p,
                                 audit)
    _build.require_cuda(pos_t, "table_drift")
    dev = pos_t.device
    d, k, d2 = p.d, p.k, p.d * p.d
    cell = cell.reshape(())
    _build.check(pos_t, "pos_t", (d, 4, k, d2), dev)
    _build.check(vel_t, "vel_t", (d, 3, k, d2), dev)
    _build.check(acc_t, "acc_t", (d, 3, k, d2), dev)
    _build.check(cov_t, "cov_t", (d, 1, k, d2), dev)
    _build.check(lo, "lo", (3,), dev)
    _build.check(cell, "cell", (), dev)
    pos_d_t = torch.empty_like(pos_t)
    vel_h = torch.empty_like(vel_t)
    mover = n_stale = None
    if audit:
        mover = torch.empty((d, k, d2), dtype=torch.int32, device=dev)
        n_stale = torch.empty((), dtype=torch.int32, device=dev)
    # the hash bins as PyTorch divides by a host scalar: times its f32
    # reciprocal
    inv = (float(np.float32(1.0) / np.float32(p.cell_size))
           if p.mode == "hash" else 0.0)
    _build.launch(
        "nbt_table_drift", dev, pos_t.data_ptr(), vel_t.data_ptr(),
        acc_t.data_ptr(), cov_t.data_ptr(), lo.data_ptr(), cell.data_ptr(),
        inv, (1 if p.mode == "bh" else 2) if audit else 0, d, k, dt,
        0.5 * dt * dt, 0.5 * dt, pos_d_t.data_ptr(), vel_h.data_ptr(),
        _build.ptr(mover), _build.ptr(n_stale),
    )
    table_drift.launches += 1
    return pos_d_t, vel_h, mover, n_stale


def table_kick_plain(raw, cov_t, vel_h, G: float, dt):
    """Plain twin of ``table_kick``, in place too."""
    table_kick_plain.calls += 1
    acc_t = raw.mul_(cov_t).mul_(G)
    return acc_t, vel_h.add_(acc_t * (0.5 * dt))


table_kick_plain.calls = 0


@_build.counted
def table_kick(raw, cov_t, vel_h, G: float, dt):
    """Second half-kick of a table, one pass (``csrc/table_step.cu``), in
    place: ``raw`` (d, 3, k, d²), the sweep's unscaled output, becomes
    acc = G·cov·raw (empty slots 0) and ``vel_h`` gets vel_h + dt/2·acc →
    ``(acc_t, vel_t)``, the same two tensors. CPU tensors take the plain
    twin; CUDA tensors launch the kernel or raise."""
    if raw.device.type == "cpu":
        return table_kick_plain(raw, cov_t, vel_h, G, dt)
    _build.require_cuda(raw, "table_kick")
    dev = raw.device
    d, c3, k, d2 = raw.shape
    _build.check(raw, "raw", (d, 3, k, d2), dev)
    _build.check(cov_t, "cov_t", (d, 1, k, d2), dev)
    _build.check(vel_h, "vel_h", (d, 3, k, d2), dev)
    _build.launch("nbt_table_kick", dev, raw.data_ptr(), cov_t.data_ptr(),
                  vel_h.data_ptr(), G, 0.5 * dt, d, k)
    table_kick.launches += 1
    return raw, vel_h


def _drift(ts: TableState, dt, p: TableParams, audit: bool = False):
    """The table's drift and first half-kick (``table_drift``) and the side
    rows' → (pos_d_t, vel_h, side_pd (cap, 7), mover, n_stale)."""
    pos_d_t, vel_h, mover, n_stale = table_drift(
        ts.pos_t, ts.vel_t, ts.acc_t, ts.cov_t, ts.lo, ts.cell, dt, p, audit)
    s = ts.side
    sp = s[:, 0:3] + s[:, 4:7] * dt + (0.5 * dt * dt) * ts.side_acc
    svh = s[:, 4:7] + (0.5 * dt) * ts.side_acc
    return (pos_d_t, vel_h, torch.cat([sp, s[:, 3:4], svh], dim=-1), mover,
            n_stale)


def _audit(n_table, side_pd, ts: TableState, p: TableParams):
    """Stale count () of the DRIFTED positions against the frozen binning
    before the force, the adaptive driver's trigger: ``n_table`` (the
    table's, from ``table_drift``) plus the side rows'."""
    if ts.side.shape[0] == 0:
        return n_table
    with profile_phase("table.audit", device=side_pd.device):
        ids = _bin_ids(side_pd[:, 0], side_pd[:, 1], side_pd[:, 2], ts.lo,
                       ts.cell, p)
        return n_table + ((ids != ts.side_cell) & ts.side_valid).sum()


def _extract(ts: TableState, pos_d_t, vel_h, side_pd, p: TableParams):
    """Drifted table + side → the rows in the last re-sort's row order:
    (pos4 (N, 4) [pos_d, m], vel_h (N, 3)). Paid on re-sort steps only."""
    with profile_phase("table.extract", device=pos_d_t.device):
        rows = _read_rows(ts, [pos_d_t[:, 0:3], vel_h], torch.cat(
            [side_pd[:, 0:3], side_pd[:, 4:7]], dim=1), p)
        pos4 = torch.cat([rows[:, 0:3], ts.mass[:, None]], dim=-1)
        return pos4, rows[:, 3:6].contiguous()


def _frozen_force_and_kick(ts: TableState, pos_d_t, vel_h, side_pd, dt,
                           p: TableParams) -> TableState:
    """Force on the frozen assignment + second half-kick: the frozen
    step's tail after ``_drift``."""
    packed = None
    if p.mode == "bh":
        with profile_phase("table.moments", device=pos_d_t.device):
            packed = _table_moments(pos_d_t, ts, side_pd, p)
    far_plane, far_a = _far_grids(packed, ts.lo, ts.cell, p)
    raw = _sweep(pos_d_t, far_plane, ts.lo, ts.cell, ts.live, p)
    acc_t, vel_t = table_kick(raw, ts.cov_t, vel_h, p.G, dt)
    side, sacc = _side_kick(side_pd, ts.side_cell, ts.side_valid, far_a, dt,
                            p)
    return dataclasses.replace(
        ts, pos_t=pos_d_t, vel_t=vel_t, acc_t=acc_t, side=side,
        side_acc=sacc, time=ts.time + dt,
    )


def _sort_rows(pos4, vel, tag, p: TableParams) -> dict:
    """A re-sort up to its host read: drifted rows ``pos4`` (N, 4) [pos_d,
    m] and half-kicked ``vel`` (N, 3), ``tag`` their original indices (N,)
    int32 → the engine's binning, stable sort and payload gather, and K2's
    rank form with coverage and the velocities as extra channels; with
    ``total`` () the rows past the k cap, the count the side buffer is
    sized by. Returns the values ``_build_table`` reads, by carry name."""
    d, k = p.d, p.k
    n = pos4.shape[0]
    dev = pos4.device
    with profile_phase(p.sort_phase, device=dev):
        lo, cell, coords = _grid_geometry(pos4[:, 0:3], p)
        grid = build_sorted_grid(pos4[:, 0:3], pos4[:, 3], coords, d)
        vel_s = vel[grid.order]
        tag_s = tag[grid.order]
        rank = (torch.arange(n, dtype=torch.int32, device=dev)
                - grid.cell_start[grid.ids])

    with profile_phase(f"{p.near}.placement", device=dev):
        pos_t, moments, cov_t, vel_h_t = tile_scatter(
            grid.psort, grid.cell_start, lo, cell, d=d, k=k,
            with_coverage=True, extra=vel_s,
        )
        total = torch.clamp(moments[10] - float(k), min=0.0).to(
            torch.int64).sum()
    return dict(psort=grid.psort, vel_s=vel_s, tag=tag_s, ids=grid.ids,
                rank=rank, cell_start=grid.cell_start, pos_t=pos_t,
                moments=moments, cov_t=cov_t, vel_t=vel_h_t, lo=lo,
                cell=cell, total=total)


def _build_table(b, cap: int, dt, p: TableParams) -> TableState:
    """A re-sort after its host read: ``_sort_rows``' values ``b`` (and
    ``b["time"]``, the time before the step) → a fresh TableState with a
    side buffer of ``cap`` rows (at least the overflow count ``total``):
    side row j < total is the (j − before)-th overflow row of its cell
    (from the exact counts), the rows past ``total`` are padding; then far
    grids, sweep and the second half-kick."""
    d, k = p.d, p.k
    nc = d * d * d
    psort, vel_s, cell_start = b["psort"], b["vel_s"], b["cell_start"]
    ids_s, rank, moments = b["ids"], b["rank"], b["moments"]
    n = psort.shape[0]
    dev = psort.device
    with profile_phase(f"{p.near}.placement", device=dev):
        counts = moments[10]
        ovf = torch.clamp(counts - float(k), min=0.0).to(torch.int64)
        inc = torch.cumsum(ovf, dim=0)
        j = torch.arange(cap, dtype=torch.int64, device=dev)
        side_valid = j < inc[-1]
        cellj = torch.clamp(torch.searchsorted(inc, j, right=True),
                            max=nc - 1)
        side_row = torch.where(side_valid, cell_start[cellj].to(torch.int64)
                               + k + (j - (inc[cellj] - ovf[cellj])), 0)
        side_pd = torch.where(side_valid[:, None], torch.cat(
            [psort[side_row], vel_s[side_row]], dim=-1), 0.0)
        side_cell = cellj.to(torch.int32)

        # a row's slot, or side row j at d³·k + j (the padding rows' writes
        # land on a spare entry past the N rows)
        within = rank < k
        idx_ext = torch.cat([ids_s * k + rank, rank.new_zeros(1)])
        idx_ext[torch.where(side_valid, side_row, n)] = (
            nc * k + j).to(torch.int32)
        slot_row = torch.full((nc * k + 1,), -1, dtype=torch.int32,
                              device=dev)
        slot_row[torch.where(within, ids_s * k + rank, nc * k).long()] = (
            torch.arange(n, dtype=torch.int32, device=dev))
        live = torch.clamp(counts, max=float(k))

    packed = moments[:10].T.reshape(d, d, d, 10) if p.mode == "bh" else None
    lo, cell = b["lo"], b["cell"]
    far_plane, far_a = _far_grids(packed, lo, cell, p)
    raw = _sweep(b["pos_t"], far_plane, lo, cell, live, p)
    acc_t, vel_t = table_kick(raw, b["cov_t"], b["vel_t"], p.G, dt)
    side, sacc = _side_kick(side_pd, side_cell, side_valid, far_a, dt, p)
    return TableState(
        pos_t=b["pos_t"], vel_t=vel_t, acc_t=acc_t, cov_t=b["cov_t"],
        live=live, slot_row=slot_row[:nc * k], idx_ext=idx_ext[:n],
        tag=b["tag"], mass=psort[:, 3].contiguous(), side=side,
        side_cell=side_cell, side_acc=sacc, side_valid=side_valid, lo=lo,
        cell=cell, time=b["time"] + dt,
    )


def _row_drift(state: ParticleState, dt):
    """Row-space drift and half-kick (``state.acc`` holds a(t)), the
    arithmetic of the row steppers' sorted step → (pos4, vel_h, tag)."""
    pos_d = state.pos + state.vel * dt + (0.5 * dt * dt) * state.acc
    vel_h = state.vel + (0.5 * dt) * state.acc
    tag = torch.arange(state.n, dtype=torch.int32, device=state.pos.device)
    return torch.cat([pos_d, state.mass[:, None]], dim=-1), vel_h, tag


def _entry(state: ParticleState, dt, p: TableParams) -> TableState:
    """First step: drift in row space then sort + build, with a side
    buffer of exactly the overflow rows (one host read)."""
    b = _sort_rows(*_row_drift(state, dt), p)
    b["time"] = state.time
    return _build_table(b, int(b["total"]), dt, p)


def _repair_step(ts: TableState, pos_d_t, vel_h, side_pd, mover,
                 n_movers: int, dt, p: TableParams) -> TableState:
    """EXACT-assignment incremental step: move only the rows whose cell
    changed (``mover`` ≥ 0 holds their new cells, from ``table_drift``'s
    audit), leave everything else in place, then the frozen force and kick.
    The movers are compacted into a set of the static length ``n_movers``
    (at least their count) by a prefix sum and a binary search, sorted by
    target cell and ranked, and take the slots above each target cell's
    high-water mark (``live``), so they never land on a staying row; the
    entries past the count get a target beyond every cell, sort last and
    move nothing (``SENTINEL_DEST``). K2's dest form moves the movers inside
    the drifted table, refills the slots they leave, updates the row
    bookkeeping and recomputes the high-water marks of the cells they
    touched, in one call: work in the movers, not in the table.

    Degradations, as in the JAX package (all audited, all self-correcting):
    arrivals to a cell whose high-water mark reaches k are DENIED (the row
    keeps its old slot, stays stale and retries next step, pushing the
    audit toward a rebuild); freed slots are not compacted (the high-water
    mark only falls when the top slot empties); side rows never join the
    table, their frozen cell id is re-binned so the far field stays
    mass-exact (Barnes-Hut only: nothing else reads it).

    ``ts``'s coverage, liveness and row bookkeeping (``cov_t``, ``live``,
    ``slot_row``, ``idx_ext``) and ``pos_d_t`` and ``vel_h`` are updated in
    place; the drivers never read a state twice."""
    d, k = p.d, p.k
    nc = d * d * d
    dev = pos_d_t.device
    with profile_phase("table.repair", device=dev):
        if p.mode == "bh" and ts.side.shape[0] > 0:
            side_cell = _bin_ids(side_pd[:, 0], side_pd[:, 1], side_pd[:, 2],
                                 ts.lo, ts.cell, p)
        else:
            side_cell = ts.side_cell
        if n_movers > 0:
            # the j-th stale slot (plane order) is where the running count
            # first reaches j
            flat = mover.reshape(-1)
            csum = torch.cumsum(flat >= 0, dim=0)
            j = torch.arange(1, n_movers + 1, dtype=csum.dtype, device=dev)
            mov = torch.clamp(torch.searchsorted(csum, j),
                              max=flat.shape[0] - 1)
            tgt = torch.where(j <= csum[-1], flat[mov], nc)
            ordm = torch.argsort(tgt, stable=True)
            mov, tgt = mov[ordm], tgt[ordm]
            slot = ts.live[torch.clamp(tgt, max=nc - 1).to(torch.int64)].to(
                torch.int32) + sorted_ranks(tgt)
            dest = torch.where((slot < k) & (tgt < nc), tgt * k + slot,
                               SENTINEL_DEST)
            tile_place(pos_d_t, ts.cov_t, vel_h, ts.live, ts.slot_row,
                       ts.idx_ext, mov.to(torch.int32), dest.to(torch.int32),
                       ts.lo, ts.cell, d=d, k=k)
    return _frozen_force_and_kick(dataclasses.replace(ts, side_cell=side_cell),
                                  pos_d_t, vel_h, side_pd, dt, p)


def table_to_particle_state(ts: TableState, p: TableParams) -> ParticleState:
    """Readout in original row order: one gather of each row's slot (or
    side row) and one index store by its original index."""
    n = ts.tag.shape[0]
    rows = _read_rows(
        ts, [ts.pos_t[:, 0:3], ts.vel_t, ts.acc_t],
        torch.cat([ts.side[:, [0, 1, 2, 4, 5, 6]], ts.side_acc], dim=-1), p)
    tag = ts.tag.long()
    out = torch.empty_like(rows)
    out[tag] = rows
    mass = torch.empty_like(ts.mass)
    mass[tag] = ts.mass
    return ParticleState(pos=out[:, 0:3].contiguous(),
                         vel=out[:, 3:6].contiguous(),
                         acc=out[:, 6:9].contiguous(), mass=mass,
                         time=ts.time)


def _validate(p: TableParams, resort_every: int = 1) -> None:
    if p.mode not in ("bh", "hash"):
        raise ValueError(f"unknown table mode {p.mode!r}")
    if not tile_engine_fused(p.d, p.k):
        raise ValueError("table-resident stepping requires the fused tiles "
                         f"path (d={p.d}, k={p.k})")
    if p.mode == "bh" and (1 << p.levels) != p.d:
        raise ValueError("bh mode needs d == 2^levels")
    if resort_every < 1:
        raise ValueError("resort_every must be >= 1")


# ---------------------------------------------------------------------------
# step drivers
# ---------------------------------------------------------------------------


def _table(b) -> TableState:
    return TableState(**{f.name: b[f.name]
                         for f in dataclasses.fields(TableState)})


class _Segments:
    """The table drivers' segments on a ``SegmentGraphs`` carry (the
    TableState's fields by name, ``_sort_rows``' values and the drift's
    audit), and the steps made of them. The side bucket lives in the
    carry's host state (``side_cap``; ``side_grows`` counts its growths)."""

    def __init__(self, p: TableParams, dt: float, repair_cap: int = 0):
        self.p, self.dt, self.repair_cap = p, dt, repair_cap

    def entry(self, b):
        st = ParticleState(pos=b["in_pos"], vel=b["in_vel"], acc=b["in_acc"],
                           mass=b["in_mass"], time=b["in_time"])
        return {**_sort_rows(*_row_drift(st, self.dt), self.p),
                "time": b["in_time"]}

    def drift(self, b):
        return self._drift(b, False)

    def drift_audit(self, b):
        return self._drift(b, True)

    def _drift(self, b, audit):
        """The drifted table and side rows into the carry (+ the movers,
        the table's stale count ``n_table`` and with the side rows'
        ``n_stale``, with ``audit``)."""
        ts = _table(b)
        pos_d_t, vel_h, side_pd, mover, n_table = _drift(ts, self.dt, self.p,
                                                         audit)
        out = dict(pos_t=pos_d_t, vel_t=vel_h, side=side_pd)
        if audit:
            out.update(mover=mover, n_table=n_table,
                       n_stale=_audit(n_table, side_pd, ts, self.p))
        return out

    def sort(self, b):
        """A re-sort of the drifted carry up to its host read."""
        ts = _table(b)
        return _sort_rows(*_extract(ts, ts.pos_t, ts.vel_t, ts.side, self.p),
                          ts.tag, self.p)

    def tail(self, b):
        """The frozen step's force and second half-kick."""
        ts = _table(b)
        return vars(_frozen_force_and_kick(ts, ts.pos_t, ts.vel_t, ts.side,
                                           self.dt, self.p))

    def repair(self, b):
        ts = _table(b)
        return vars(_repair_step(ts, ts.pos_t, ts.vel_t, ts.side, b["mover"],
                                 self.repair_cap, self.dt, self.p))

    def enter(self, g: SegmentGraphs, state: ParticleState) -> None:
        g.load(in_pos=state.pos, in_vel=state.vel, in_acc=state.acc,
               in_mass=state.mass, in_time=state.time)
        g.run("entry", self.entry)
        self.build(g)

    def resort(self, g: SegmentGraphs) -> None:
        g.run("sort", self.sort)
        self.build(g)

    def build(self, g: SegmentGraphs) -> None:
        """The re-sort after its host read of the overflow count: the side
        buffer at the bucket, grown (and every segment captured again on
        its next use) when the count exceeds it."""
        cap = g.state.get("side_cap", 0)
        new = side_bucket(g.read("total"), cap)
        if new != cap:
            if cap:
                g.state["side_grows"] = g.state.get("side_grows", 0) + 1
            g.state["side_cap"] = new
        g.run(("build", new),
              lambda b: vars(_build_table(b, new, self.dt, self.p)))

    def readout(self, g: SegmentGraphs) -> ParticleState:
        with profile_phase("graph.readout", device=g.buffers["pos_t"].device,
                           timed=False):
            out = table_to_particle_state(_table(g.buffers), self.p)
        return dataclasses.replace(out, time=g.get("time"))


def _carry(graphs: SegmentGraphs | None) -> SegmentGraphs:
    return graphs if graphs is not None else SegmentGraphs(graphed=False)


def make_table_multi_step(p: TableParams, dt: float, n_steps: int,
                          resort_every: int = 1, *,
                          graphs: SegmentGraphs | None = None):
    """``n_steps`` Verlet steps, table-resident between re-sorts at a FIXED
    cadence: step s (from 0) re-sorts when s is a multiple of
    ``resort_every`` (the chunks of ``integrator.make_resort_multi_step``),
    the others are frozen. The steps are segments of ``graphs`` (captured
    CUDA graphs; the one host read is a re-sort's overflow count), or run
    eagerly without it. Returns ``multi(state) -> state``, original row
    order in and out; ``state.acc`` must hold a(t)."""
    _validate(p, resort_every)
    seg = _Segments(p, dt)

    def multi(state: ParticleState) -> ParticleState:
        if n_steps < 1:
            return state
        g = _carry(graphs)
        seg.enter(g, state)
        for s in range(1, n_steps):
            g.run("drift", seg.drift)
            if s % resort_every == 0:
                seg.resort(g)
            else:
                g.run("tail", seg.tail)
        return seg.readout(g)

    return multi


def make_table_adaptive_multi_step(
    p: TableParams, dt: float, n_steps: int, *, max_stale_frac: float = 0.01,
    max_cadence: int = 16, with_trace: bool = False,
    graphs: SegmentGraphs | None = None,
):
    """``n_steps`` Verlet steps that re-sort when the scene asks: after the
    first (sorted) step, each step audits its DRIFTED positions against the
    frozen binning before its force and re-sorts when the stale count
    exceeds ⌊max_stale_frac·N⌋ or ``max_cadence`` steps have run since the
    last sort (``since ≥ max_cadence − 1``), so no frozen step above the
    threshold is taken. The count is read on the host, once per step and
    only when the cadence cap does not already decide and a count could
    exceed the cap at all. ``graphs``: as ``make_table_multi_step``.
    ``with_trace=True`` also returns the per-step ``(stale_counts,
    resorted)`` tensors (n_steps − 1,), first step excluded."""
    _validate(p)
    if not 0.0 <= max_stale_frac <= 1.0:
        raise ValueError("max_stale_frac must be in [0, 1]")
    if max_cadence < 1:
        raise ValueError("max_cadence must be >= 1")
    seg = _Segments(p, dt)

    def multi(state: ParticleState):
        n = state.n
        stale_cap = int(max_stale_frac * n)
        stales, flags = [], []
        g = _carry(graphs)
        if n_steps >= 1:
            seg.enter(g, state)
        since = 0
        for _ in range(n_steps - 1):
            by_cadence = since >= max_cadence - 1
            by_audit = not by_cadence and stale_cap < n
            audit = with_trace or by_audit
            if audit:
                g.run("drift_audit", seg.drift_audit)
                stale = g.read("n_stale") if by_audit else g.get("n_stale")
            else:
                g.run("drift", seg.drift)
                stale = 0
            resort = by_cadence or (by_audit and stale > stale_cap)
            if resort:
                seg.resort(g)
                since = 0
            else:
                g.run("tail", seg.tail)
                since += 1
            stales.append(stale)
            flags.append(resort)
        out = seg.readout(g) if n_steps >= 1 else state
        if with_trace:
            return out, stack_trace(stales, flags, state.pos.device)
        return out

    return multi


def make_table_repair_multi_step(
    p: TableParams, dt: float, n_steps: int, *, repair_cap: int = 32768,
    max_cadence: int = 64, with_trace: bool = False,
    graphs: SegmentGraphs | None = None,
):
    """``n_steps`` Verlet steps with EXACT cell assignments at incremental
    cost: every step re-homes the rows whose cell changed
    (``_repair_step``, on a mover set of ``repair_cap`` entries); a full
    rebuild runs only when the mover count exceeds ``repair_cap`` or
    ``max_cadence`` expires (bounding the fragmentation and the frozen grid
    geometry). The count is read on the host once per step, except on a
    step the cadence cap rebuilds. ``graphs``: as ``make_table_multi_step``.
    The physics matches re-sort-every-step up to slot summation order, the
    frozen grid geometry between rebuilds and the audited denials.
    ``with_trace=True`` also returns the per-step ``(stale_counts,
    rebuilt)`` tensors (n_steps − 1,), first step excluded; a count is the
    table rows that left their cell."""
    _validate(p)
    if repair_cap < 128:
        raise ValueError("repair_cap must be >= 128")
    if max_cadence < 1:
        raise ValueError("max_cadence must be >= 1")
    seg = _Segments(p, dt, repair_cap)

    def multi(state: ParticleState):
        stales, flags = [], []
        g = _carry(graphs)
        if n_steps >= 1:
            seg.enter(g, state)
        since = 0
        for _ in range(n_steps - 1):
            g.run("drift_audit", seg.drift_audit)
            rebuild = since >= max_cadence - 1
            if rebuild:
                n_stale = g.get("n_table")
            else:
                n_stale = g.read("n_table")
                rebuild = n_stale > repair_cap
            if rebuild:
                seg.resort(g)
                since = 0
            else:
                g.run("repair", seg.repair)
                since += 1
            stales.append(n_stale)
            flags.append(rebuild)
        out = seg.readout(g) if n_steps >= 1 else state
        if with_trace:
            return out, stack_trace(stales, flags, state.pos.device)
        return out

    return multi


# ---------------------------------------------------------------------------
# engine parameter builders
# ---------------------------------------------------------------------------


def bh_table_params(G=1.0, softening=0.1, theta=0.5, *, levels=6,
                    near_k=16) -> TableParams:
    """TableParams for the Barnes-Hut fused tiles engine (the knobs of
    ``barnes_hut.make_barnes_hut_forces_sorted``; multipole order 2)."""
    return TableParams(
        mode="bh", d=1 << levels, k=near_k, G=float(G),
        softening=float(softening), ws=theta_to_ws(theta, order=2),
        levels=levels,
    )


def hash_table_params(G=1.0, softening=0.1, *, cutoff=2.0, cell_size=1.0,
                      d=64, k=8) -> TableParams:
    """TableParams for the spatial-hash tiles engine (the knobs of
    ``spatial_hash.spatial_hash_forces_tiles_sorted``; ws = 1, the cutoff²
    pair predicate, no far field: side rows get zero force, the engine's
    k-cap contract)."""
    return TableParams(
        mode="hash", d=d, k=k, G=float(G), softening=float(softening), ws=1,
        cutoff2=float(cutoff) * float(cutoff), cell_size=float(cell_size),
    )
