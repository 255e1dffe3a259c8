"""Barnes-Hut gravity on a dense multipole grid pyramid.

PyTorch counterpart of ``nbody_tpu/ops/barnes_hut.py``, with order-2
(quadrupole) sources on either near-field engine ``bh_engine_params``
selects, or with order-1 (COM monopole) sources when the caller asks for
``multipole_order=1``.

The fused TILES path (finest cells hold ≤ 24 particles on average) runs:

  1. bin + stable argsort by finest cell id + one payload gather
     (``sorted_window.build_sorted_grid``);
  2. slot placement + finest order-2 moments + exact counts (kernel K2,
     ``scatter.tile_scatter``);
  3. the pyramid by 2× reductions (``pyramid_from_packed``);
  4. a far-field local expansion per finest cell (``far_field_grid``): per
     level, the multipole-to-local tap sum (kernel K3, ``far_taps.far_taps``)
     and the exact downward translation;
  5. the near sweep seeded with the far expansion (kernel K4,
     ``tile_near.tile_sweep_plane``);
  6. the pickup gather, with rows past the k-slot cap redirected to G·A of
     their cell (``tile_sweep._slot_pickup_raw``).

The WINDOW path (denser cells) is the JAX package's non-fast branch: the
finest moments by one scatter-add (``build_pyramid``), the same far field,
the exact near field over the (2ws+1)³ cell ball by the sorted-window
sweep (kernel K7, ``_near_field``), and the far pickup in original order.
It has no sorted-stepping contract.

FROZEN-GRID steps (``barnes_hut_forces_frozen``, the contract of
``integrator.make_resort_multi_step``) run steps 2-6 of the tiles path
against the cell assignment cached by the last sort
(``sorted_window.FrozenGridMeta``): no bin, sort, payload gather or rank
pass. As in the JAX package only the order-2 tiles path has the contract,
and only where ``tile_sweep.tile_engine_fused`` holds.

The MONOPOLE tiles path (``multipole_order=1``, ws = ceil(1/θ)) is the JAX
package's non-fused sorted branch: the same sort, the finest [m, m·x]
moments by the segment sum (kernel K6, ``_sorted_finest_moments``), the
order-1 pyramid and COM-monopole far field (plain torch, as the JAX
package leaves it to XLA), the near field on K2 + K4 with no far plane,
and the far pickup A + J·δ. The window engine takes order 1 too.

A cell accepted at level ℓ has its parent inside the well-separation
window (Chebyshev distance ≤ ws) but is itself outside it; every source
cell is accepted at exactly one level or lands in the exact near field.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from nbody_tpu_torch.ops.far_taps import far_taps
from nbody_tpu_torch.ops.scatter import segment_sum
from nbody_tpu_torch.ops.sorted_window import (
    FrozenGridMeta,
    SortedGrid,
    build_sorted_grid,
    cell_ids,
    unsort_rows,
    window_sweep,
    xy_ball,
)
from nbody_tpu_torch.ops.tile_sweep import (
    tile_build,
    tile_engine_fused,
    tile_near_field,
    tile_sweep_pick,
)
from nbody_tpu_torch.types import SimulationConfig
from nbody_tpu_torch.utils.profiling import profile_phase


def theta_to_ws(theta: float, max_ws: int = 16, order: int = 1) -> int:
    """Opening angle θ → well-separation width ws (ceil(1/(2θ)) with
    quadrupole sources, ceil(1/θ) with monopoles)."""
    if theta <= 0:
        return max_ws
    denom = 2.0 if order >= 2 else 1.0
    return max(1, min(max_ws, math.ceil(1.0 / (denom * theta))))


@dataclasses.dataclass
class Pyramid:
    """Multipole grids per level, coarse → fine: ``masses[ℓ]`` (2^ℓ)³;
    order 2: ``srels[ℓ]`` (2^ℓ)³×3 centre-relative dipoles Σ m·(x − ctr)
    and ``quads[ℓ]`` (2^ℓ)³×6 second moments about the cell centre
    [xx, yy, zz, xy, xz, yz]; order 1: ``msums[ℓ]`` (2^ℓ)³×3 absolute
    Σ m·x (COM = msum / m). ``lo``/``cell``: finest-level geometry. (The
    JAX package's order-2 pyramid also carries absolute msums; no order-2
    path here reads them, so they are not built.)"""

    masses: tuple
    lo: torch.Tensor
    cell: torch.Tensor
    srels: tuple = ()
    quads: tuple = ()
    msums: tuple = ()


def pyramid_geometry(lo: torch.Tensor, hi: torch.Tensor, levels: int):
    """(lo, cell) of the cube grid enclosing [lo, hi] at 2^levels per axis."""
    d = 1 << levels
    cube = torch.clamp(torch.max(hi - lo), min=1e-6) * (1.0 + 1e-5)
    return lo, cube / d


def pyramid_from_packed(packed, lo, cell, levels: int,
                        order: int = 2) -> Pyramid:
    """Upward pass: packed finest moments → the full pyramid. Order 2:
    (d, d, d, 10) [m, s3, q6], by the parallel-axis translation
    q_p = Σ_c [q_c + δ⊗s_c + s_c⊗δ + m_c δ⊗δ], δ = ±(child edge)/2.
    Order 1: (d, d, d, 4) [m, m·x], by plain 2× sums."""
    if order < 2:
        masses, msums = [packed[..., 0]], [packed[..., 1:4]]
        for _ in range(levels):
            dm = masses[-1].shape[0] // 2
            masses.append(
                masses[-1].reshape(dm, 2, dm, 2, dm, 2).sum(dim=(1, 3, 5)))
            msums.append(
                msums[-1].reshape(dm, 2, dm, 2, dm, 2, 3).sum(dim=(1, 3, 5)))
        return Pyramid(tuple(reversed(masses)), lo, cell,
                       msums=tuple(reversed(msums)))
    dtype = packed.dtype
    masses = [packed[..., 0]]
    srels = [packed[..., 1:4]]
    quads = [packed[..., 4:10]]
    for lvl in range(levels):
        dm = masses[-1].shape[0] // 2
        m_c = masses[-1].reshape(dm, 2, dm, 2, dm, 2)
        masses.append(m_c.sum(dim=(1, 3, 5)))
        e = cell * (1 << lvl) * 0.5
        par = torch.tensor([-0.5, 0.5], dtype=dtype, device=packed.device)
        par = par * 2.0 * e
        dx = par.reshape(1, 2, 1, 1, 1, 1)
        dy = par.reshape(1, 1, 1, 2, 1, 1)
        dz = par.reshape(1, 1, 1, 1, 1, 2)
        s_c = srels[-1].reshape(dm, 2, dm, 2, dm, 2, 3)
        q_c = quads[-1].reshape(dm, 2, dm, 2, dm, 2, 6)
        sx, sy, sz = s_c[..., 0], s_c[..., 1], s_c[..., 2]
        q_p = torch.stack(
            [
                q_c[..., 0] + 2 * dx * sx + m_c * dx * dx,
                q_c[..., 1] + 2 * dy * sy + m_c * dy * dy,
                q_c[..., 2] + 2 * dz * sz + m_c * dz * dz,
                q_c[..., 3] + dx * sy + dy * sx + m_c * dx * dy,
                q_c[..., 4] + dx * sz + dz * sx + m_c * dx * dz,
                q_c[..., 5] + dy * sz + dz * sy + m_c * dy * dz,
            ],
            dim=-1,
        )
        quads.append(q_p.sum(dim=(1, 3, 5)))
        s_p = s_c + m_c[..., None] * torch.stack(
            [dx.expand(m_c.shape), dy.expand(m_c.shape), dz.expand(m_c.shape)],
            dim=-1,
        )
        srels.append(s_p.sum(dim=(1, 3, 5)))
    masses.reverse()
    srels.reverse()
    quads.reverse()
    return Pyramid(tuple(masses), lo, cell, srels=tuple(srels),
                   quads=tuple(quads))


def _moment_rows(pos, mass, ctr, order: int):
    """Per-row finest moments: order 2 → (N, 10) [m, m·xr, m·xr⊗xr] with
    xr = pos − ctr (the cell centre); order 1 → (N, 4) [m, m·x] absolute."""
    m = mass[:, None]
    if order < 2:
        return torch.cat([m, m * pos], dim=-1)
    xr = pos - ctr
    x, y, z = xr[:, 0:1], xr[:, 1:2], xr[:, 2:3]
    return torch.cat([m, m * xr, m * (x * x), m * (y * y), m * (z * z),
                      m * (x * y), m * (x * z), m * (y * z)], dim=-1)


def scatter_finest_moments(pos, mass, coords, lo, cell, d: int,
                           order: int = 2):
    """Packed finest moments by ONE scatter-add (``index_add_``; the JAX
    package leaves this scatter to XLA): order 2 → (d, d, d, 10)
    [m, m·xr, m·xr⊗xr] about each cell centre; order 1 → (d, d, d, 4)
    [m, m·x] absolute."""
    cid = ((coords[:, 0] * d + coords[:, 1]) * d + coords[:, 2]).to(
        torch.int64)
    ctr = lo + (coords.to(pos.dtype) + 0.5) * cell if order >= 2 else None
    vals = _moment_rows(pos, mass, ctr, order)
    out = torch.zeros((d * d * d, vals.shape[1]), dtype=pos.dtype,
                      device=pos.device)
    out.index_add_(0, cid, vals)
    return out.reshape(d, d, d, vals.shape[1])


def _sorted_finest_moments(grid, d: int):
    """Packed order-1 finest moments (d, d, d, 4) [m, m·x] from the
    CELL-SORTED rows by the segment sum (kernel K6) over the sorted ids.
    Order 2 takes the fused K2 path instead."""
    psort = grid.psort
    vals = _moment_rows(psort[:, :3], psort[:, 3], None, 1)
    packed = segment_sum(vals.contiguous(), grid.ids, d * d * d)
    return packed.T.reshape(d, d, d, 4)


def build_pyramid(pos, mass, levels: int, order: int = 2) -> Pyramid:
    """Scatter-add the finest level, then 2× reductions up to the root
    (order 2: quadrupole pyramid; order 1: monopoles [m, Σ m·x])."""
    lo, cell, coords = bin_particles(pos, levels)
    packed = scatter_finest_moments(pos, mass, coords, lo, cell, 1 << levels,
                                    order)
    return pyramid_from_packed(packed, lo, cell, levels, order)


_KIDS = np.array(
    [(x, y, z) for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.int32
)


def _window_offsets_and_masks(ws: int):
    """Parent-window offsets po (n, 3) and 8×8 child accept masks
    accept[p, kt, ks] (child cells Chebyshev-separated by more than ws)."""
    rng = np.arange(-ws, ws + 1)
    po = np.array(
        [(x, y, z) for x in rng for y in rng for z in rng], np.int32
    )
    delta = (
        2 * po[:, None, None, :]
        + _KIDS[None, None, :, :]
        - _KIDS[None, :, None, :]
    )  # (n, 8t, 8s, 3)
    accept = np.abs(delta).max(axis=-1) > ws
    return po, accept


def _tap_table():
    """(19, 10) gather index into the derivative bank [T1(3) | T2(9) |
    T3(27) | T4(81) | 0] and the coefficient of each entry, for rows
    [A3, J6, H10] × columns [m, s3, q6] of ``_conv_taps_kernel``."""
    sym6 = [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]
    sym10 = [
        (0, 0, 0), (1, 1, 1), (2, 2, 2), (0, 0, 1), (0, 0, 2),
        (0, 1, 1), (1, 1, 2), (0, 2, 2), (1, 2, 2), (0, 1, 2),
    ]
    q_mult = [1.0, 1.0, 1.0, 2.0, 2.0, 2.0]

    def t1(i):
        return i

    def t2(i, j):
        return 3 + 3 * i + j

    def t3(i, j, k):
        return 12 + 9 * i + 3 * j + k

    def t4(i, j, k, l):
        return 39 + 27 * i + 9 * j + 3 * k + l

    zero = 120
    idx, coef = [], []
    for i in range(3):
        idx.append([t1(i)] + [t2(i, j) for j in range(3)]
                   + [t3(i, *sym6[c]) for c in range(6)])
        coef.append([1.0] * 4 + [0.5 * q_mult[c] for c in range(6)])
    for (i, j) in sym6:
        idx.append([t2(i, j)] + [t3(i, j, k) for k in range(3)]
                   + [t4(i, j, *sym6[c]) for c in range(6)])
        coef.append([-1.0] * 4 + [-0.5 * q_mult[c] for c in range(6)])
    for (i, j, k) in sym10:
        idx.append([t3(i, j, k)] + [t4(i, j, k, l) for l in range(3)]
                   + [zero] * 6)
        coef.append([1.0] * 4 + [0.0] * 6)
    return np.array(idx, np.int64), np.array(coef, np.float64)


_TAP_IDX, _TAP_COEF = _tap_table()


def _conv_taps_kernel(dvec: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-tap multipole-to-local translation matrices.

    dvec (…, 3) source-centre − target-centre displacements → (…, 19, 10):
    rows [A3, J6, H10], columns [m, s3, q6], built from the Plummer-kernel
    derivative tensors T1..T4 of T1_i(D) = D_i·u^{-3/2}, u = |D|² + ε²:

      A_i = m·T1_i + s_j·T2_ij + ½ q_jk·T3_ijk
      J_ij = −(m·T2_ij + s_k·T3_ijk + ½ q_kl·T4_ijkl)
      H_ijk = m·T3_ijk + s_l·T4_ijkl              (q·T5 truncated)

    The same entries as the JAX package's ``_conv_taps_kernel``, built as
    a handful of broadcast tensor ops (one bank gather) instead of one
    scalar expression per entry.
    """
    lead = dvec.shape[:-1]
    D = dvec.reshape(-1, 3)
    dev, dt = D.device, D.dtype
    u = D[:, 0] ** 2 + D[:, 1] ** 2 + D[:, 2] ** 2 + eps * eps
    u = torch.clamp(u, min=1e-30)
    u3 = u ** -1.5
    u5 = u3 / u
    u7 = u5 / u
    u9 = u7 / u
    eye = torch.eye(3, dtype=dt, device=dev)

    def col(x, nd):
        return x.reshape((-1,) + (1,) * nd)

    t1 = D * col(u3, 1)
    di, dj = D[:, :, None], D[:, None, :]
    t2 = eye * col(u3, 2) - 3.0 * di * dj * col(u5, 2)
    di, dj, dk = D[:, :, None, None], D[:, None, :, None], D[:, None, None, :]
    term3 = eye[:, :, None] * dk + eye[:, None, :] * dj + eye[None, :, :] * di
    t3 = -3.0 * term3 * col(u5, 3) + 15.0 * di * dj * dk * col(u7, 3)
    di = D[:, :, None, None, None]
    dj = D[:, None, :, None, None]
    dk = D[:, None, None, :, None]
    dl = D[:, None, None, None, :]
    i_ij, i_kl = eye[:, :, None, None], eye[None, None, :, :]
    i_ik, i_jl = eye[:, None, :, None], eye[None, :, None, :]
    i_jk, i_il = eye[None, :, :, None], eye[:, None, None, :]
    term4a = i_ij * i_kl + i_ik * i_jl + i_jk * i_il
    term4b = (
        i_ij * dk * dl + i_ik * dj * dl + i_jk * di * dl
        + i_kl * di * dj + i_jl * di * dk + i_il * dj * dk
    )
    t4 = (
        -3.0 * term4a * col(u5, 4)
        + 15.0 * term4b * col(u7, 4)
        - 105.0 * di * dj * dk * dl * col(u9, 4)
    )
    n = D.shape[0]
    bank = torch.cat(
        [t1, t2.reshape(n, 9), t3.reshape(n, 27), t4.reshape(n, 81),
         torch.zeros((n, 1), dtype=dt, device=dev)],
        dim=1,
    )  # (n, 121)
    idx = torch.as_tensor(_TAP_IDX, device=dev)
    coef = torch.as_tensor(_TAP_COEF, dtype=dt, device=dev)
    out = bank[:, idx.reshape(-1)].reshape(n, 19, 10) * coef
    return out.reshape(lead + (19, 10))


def level_tap_matrices(cell, ws: int, eps: float, levels: int,
                       lvls=None) -> torch.Tensor:
    """Tap matrices (len(lvls), T, 8·19, 8·10) of the listed levels
    (default 1..levels), telescoping acceptance folded in. Rebuilt every
    force evaluation, because ``cell`` follows the particles."""
    lvls = list(range(1, levels + 1)) if lvls is None else list(lvls)
    po, accept = _window_offsets_and_masks(ws)
    t = po.shape[0]
    delta_int = (
        2 * po[:, None, None, :] + _KIDS[None, None, :, :]
        - _KIDS[None, :, None, :]
    ).reshape(t * 64, 3)
    dev, dt = cell.device, cell.dtype
    scale = torch.tensor([float(1 << (levels - lvl)) for lvl in lvls],
                         dtype=dt, device=dev)
    s_l = (cell.reshape(()) * scale).reshape(-1, 1, 1)
    dvec = torch.as_tensor(delta_int, dtype=dt, device=dev) * s_l
    k = _conv_taps_kernel(dvec, eps)                     # (L, T·64, 19, 10)
    mask = torch.as_tensor(accept.reshape(t * 64), dtype=dt, device=dev)
    k = k * mask[:, None, None]
    return (
        k.reshape(len(lvls), t, 8, 8, 19, 10)
        .permute(0, 1, 2, 4, 3, 5)
        .reshape(len(lvls), t, 8 * 19, 8 * 10)
    )


def level_moments(pyr: Pyramid, lvl: int) -> torch.Tensor:
    """Child-major moment channels (80, p³) of level ``lvl``, channel =
    kid·10 + [m, s3, q6] (the column order of the tap matrices)."""
    p = (1 << lvl) // 2

    def cm(x, c):
        return (
            x.reshape(p, 2, p, 2, p, 2, c)
            .permute(1, 3, 5, 6, 0, 2, 4)
            .reshape(8, c, p * p * p)
        )

    return torch.cat(
        [cm(pyr.masses[lvl][..., None], 1), cm(pyr.srels[lvl], 3),
         cm(pyr.quads[lvl], 6)],
        dim=1,
    ).reshape(80, p * p * p).contiguous()


def _far_conv_level(pyr: Pyramid, lvl: int, ws: int, eps: float,
                    levels: int, tap_mat=None):
    """One level's accepted far-field contributions through kernel K3:
    (A (8, 3, p³), J (8, 6, p³), H (8, 10, p³)) per target child."""
    p = (1 << lvl) // 2
    if tap_mat is None:
        tap_mat = level_tap_matrices(pyr.cell, ws, eps, levels, [lvl])[0]
    out = far_taps(level_moments(pyr, lvl), tap_mat.contiguous(), p=p, ws=ws)
    out = out.reshape(8, 19, p * p * p)
    return out[:, 0:3], out[:, 3:9], out[:, 9:19]


def sym_matvec(j6: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(…, 6) symmetric matrix [xx,yy,zz,xy,xz,yz] times (…, 3) vector."""
    jx = j6[..., 0] * v[..., 0] + j6[..., 3] * v[..., 1] + j6[..., 4] * v[..., 2]
    jy = j6[..., 3] * v[..., 0] + j6[..., 1] * v[..., 1] + j6[..., 5] * v[..., 2]
    jz = j6[..., 4] * v[..., 0] + j6[..., 5] * v[..., 1] + j6[..., 2] * v[..., 2]
    return torch.stack([jx, jy, jz], dim=-1)


def sym3_matvec(h10: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(…, 10) symmetric 3-tensor [xxx,yyy,zzz,xxy,xxz,xyy,yyz,xzz,yzz,xyz]
    contracted with (…, 3) → the (…, 6) symmetric matrix (H·v)_ij."""
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    xxx, yyy, zzz = h10[..., 0], h10[..., 1], h10[..., 2]
    xxy, xxz, xyy = h10[..., 3], h10[..., 4], h10[..., 5]
    yyz, xzz, yzz = h10[..., 6], h10[..., 7], h10[..., 8]
    xyz = h10[..., 9]
    return torch.stack(
        [
            xxx * vx + xxy * vy + xxz * vz,  # xx
            xyy * vx + yyy * vy + yyz * vz,  # yy
            xzz * vx + yzz * vy + zzz * vz,  # zz
            xxy * vx + xyy * vy + xyz * vz,  # xy
            xxz * vx + xyz * vy + xzz * vz,  # xz
            xyz * vx + yyz * vy + yzz * vz,  # yz
        ],
        dim=-1,
    )


# Pair terms (target child × offset × source child × cell) one chunk of
# parent offsets of the monopole far field evaluates at once.
MONOPOLE_CHUNK_TERMS = 1 << 26


@functools.lru_cache(maxsize=None)
def _monopole_tables(p: int, ws: int, dev: torch.device, dt: torch.dtype):
    """Static tables of one monopole level on ``dev``, made once: the
    source cell of each (parent offset, target parent) in the ws-padded
    grid, flattened (T, p³); the accept masks (8t, 8s, T); and the target
    child centres in cell units, 2q + kid + ½, (3, 8t, p³)."""
    pp = p + 2 * ws
    po, accept = _window_offsets_and_masks(ws)                # (T,3), (T,8,8)
    q = np.stack(np.meshgrid(*(np.arange(p),) * 3, indexing="ij"),
                 -1).reshape(p ** 3, 3)
    src = q[None, :, :] + po[:, None, :] + ws                  # (T, p³, 3)
    idx = (src[..., 0] * pp + src[..., 1]) * pp + src[..., 2]
    ctr = 2.0 * q.T[:, None, :] + _KIDS.T[:, :, None] + 0.5    # (3, 8, p³)

    def on(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    return (on(idx.astype(np.int64)), on(accept.transpose(1, 2, 0), dt),
            on(ctr, dt))


def _far_monopole_level(pyr: Pyramid, lvl: int, ws: int, eps: float,
                        levels: int):
    """One level's accepted COM monopoles as an order-1 local expansion
    about each target child's centre: (A (8, 3, p³), J6 (8, 6, p³)), with
    a += w·d and ∇a = w·(3·d⊗d/u − I), w = m/u^{3/2}, u = |d|² + ε².

    The JAX package scans the (2ws+1)³ parent offsets and loops over the 8
    target children inside; here chunks of offsets are evaluated for all
    (target child, source child) pairs at once as (8t, 8s·offsets, p³)
    tensors, so a level takes a handful of chunks of ~35 tensor ops
    (``MONOPOLE_CHUNK_TERMS`` bounds a chunk's temporaries). Empty cells
    stay inert: m = 0 ⇒ w = 0."""
    p = (1 << lvl) // 2
    pc = p * p * p
    pp = p + 2 * ws
    s_l = pyr.cell.reshape(()) * (1 << (levels - lvl))
    dev, dt = pyr.masses[0].device, pyr.masses[0].dtype
    idx_all, acc_all, grid_ctr = _monopole_tables(p, ws, dev, dt)
    m = (pyr.masses[lvl].reshape(p, 2, p, 2, p, 2)
         .permute(1, 3, 5, 0, 2, 4).reshape(8, p, p, p))
    s = (pyr.msums[lvl].reshape(p, 2, p, 2, p, 2, 3)
         .permute(1, 3, 5, 6, 0, 2, 4).reshape(8, 3, p, p, p))
    com = s * (1.0 / torch.clamp(m, min=1e-30))[:, None]
    # padded source grids, cells flattened: (8, pp³), (3, 8, pp³)
    m_pad = torch.nn.functional.pad(m, [ws] * 6).reshape(8, pp ** 3)
    com_pad = (torch.nn.functional.pad(com, [ws] * 6)
               .permute(1, 0, 2, 3, 4).reshape(3, 8, pp ** 3))
    # target child centres (3, 8t, 1, pc)
    ctr = (pyr.lo.reshape(3, 1, 1) + grid_ctr * s_l)[:, :, None, :]
    eps2 = eps * eps
    chunk = max(1, MONOPOLE_CHUNK_TERMS // (64 * pc))
    a_out = torch.zeros((3, 8, pc), dtype=dt, device=dev)
    j_raw = torch.zeros((6, 8, pc), dtype=dt, device=dev)  # Σ w·d⊗d/u
    w_sum = torch.zeros((8, pc), dtype=dt, device=dev)
    for t0 in range(0, idx_all.shape[0], chunk):
        idx = idx_all[t0:t0 + chunk]                            # (To, pc)
        to = idx.shape[0]
        # sources along one axis, (source child, offset): (8t, 8s·To, pc)
        mw = (m_pad[:, idx].reshape(1, 8 * to, pc)
              * acc_all[:, :, t0:t0 + to].reshape(8, 8 * to, 1))
        src = com_pad[:, :, idx].reshape(3, 1, 8 * to, pc)
        dx, dy, dz = (src[i] - ctr[i] for i in range(3))
        inv = (dx * dx).addcmul_(dy, dy).addcmul_(dz, dz).add_(eps2)
        inv = inv.clamp_(min=1e-30).rsqrt_()
        inv2 = inv * inv
        w = mw.mul_(inv2 * inv)
        t = inv2.mul_(w)
        w_sum += w.sum(1)
        for i, dv in enumerate((dx, dy, dz)):
            a_out[i] += (w * dv).sum(1)
        tdx, tdy = t * dx, t * dy
        for i, prod in enumerate((tdx * dx, tdy * dy, t.mul_(dz) * dz,
                                  tdx * dy, tdx.mul_(dz), tdy.mul_(dz))):
            j_raw[i] += prod.sum(1)
    j_out = 3.0 * j_raw
    j_out[:3] -= w_sum
    return a_out.permute(1, 0, 2), j_out.permute(1, 0, 2)


def far_field_grid(pyr: Pyramid, ws: int, G: float, eps: float, levels: int):
    """Far field as a LOCAL EXPANSION per finest cell about cell centres,
    with the exact downward translation to child centres.

    Order-2 pyramids → (A (d,d,d,3), J6 (d,d,d,6), H10 (d,d,d,10)): each
    level's taps through kernel K3; A_child = A + J·δ + ½δᵀHδ,
    J_child = J + H·δ, H_child = H. Order-1 pyramids (``msums``, no
    ``quads``) → (A, J6, None): COM monopoles per level
    (``_far_monopole_level``; the JAX package computes them outside any
    Pallas kernel too); A_child = A + J·δ, J_child = J."""
    quad = len(pyr.quads) > 0
    taps = level_tap_matrices(pyr.cell, ws, eps, levels) if quad else None
    dtype = pyr.masses[0].dtype
    dev = pyr.masses[0].device
    acc = jac = hes = hes_lvl = None
    for lvl in range(1, levels + 1):
        dl = 1 << lvl
        p = dl // 2
        s_l = pyr.cell * (1 << (levels - lvl))
        if quad:
            acc_pm, jac_pm, hes_pm = _far_conv_level(
                pyr, lvl, ws, eps, levels, tap_mat=taps[lvl - 1]
            )
        else:
            acc_pm, jac_pm = _far_monopole_level(pyr, lvl, ws, eps, levels)

        def to_grid(a, c, p=p, dl=dl):
            return (
                a.reshape(2, 2, 2, c, p, p, p)
                .permute(4, 0, 5, 1, 6, 2, 3)
                .reshape(dl, dl, dl, c)
            )

        acc_lvl = to_grid(acc_pm, 3)
        jac_lvl = to_grid(jac_pm, 6)
        if quad:
            hes_lvl = to_grid(hes_pm, 10)
        if acc is not None:

            def rep8(x):
                return (
                    x.repeat_interleave(2, 0).repeat_interleave(2, 1)
                    .repeat_interleave(2, 2)
                )

            a_rep, j_rep = rep8(acc), rep8(jac)
            par = (torch.arange(dl, device=dev) % 2).to(dtype) - 0.5
            px, py, pz = torch.meshgrid(par, par, par, indexing="ij")
            delta = torch.stack([px, py, pz], dim=-1) * s_l
            acc_lvl = acc_lvl + a_rep + sym_matvec(j_rep, delta)
            jac_lvl = jac_lvl + j_rep
            if quad:
                h_rep = rep8(hes)
                hd6 = sym3_matvec(h_rep, delta)
                acc_lvl = acc_lvl + 0.5 * sym_matvec(hd6, delta)
                jac_lvl = jac_lvl + hd6
                hes_lvl = hes_lvl + h_rep
        acc, jac, hes = acc_lvl, jac_lvl, hes_lvl
    return G * acc, G * jac, (G * hes if quad else None)


def bh_engine_params(config: SimulationConfig) -> dict:
    """Engine selection for a config (the JAX package's rule, unchanged):
    levels, multipole_order, ws, near_engine, near_k, window."""
    levels = config.bh_max_level
    multipole_order = 2
    ws = theta_to_ws(config.barnes_hut_theta, order=multipole_order)
    window = max(2048, 8 * config.hash_max_per_cell)
    occ = config.particle_count / float(8**levels)
    if occ <= 24.0:
        near_engine = "tiles"
        raw = occ + 5.0 * math.sqrt(occ + 1.0)
        near_k = int(min(64, max(8, -(-raw // 8) * 8)))
    else:
        near_engine = "window"
        near_k = 16
    return {
        "levels": levels,
        "multipole_order": multipole_order,
        "ws": ws,
        "near_engine": near_engine,
        "near_k": near_k,
        "window": window,
    }


def far_plane_grid(packed, lo, cell, *, levels: int, ws: int, eps: float):
    """Packed finest order-2 moments (d, d, d, 10) → the far expansion
    [A3 | J6 | H10] of every finest cell as the sweep's seed (d, 19, d²),
    unscaled by G: the pyramid (phase ``bh.pyramid``) and the far field
    (``bh.far``)."""
    d = 1 << levels
    dev = packed.device
    with profile_phase("bh.pyramid", device=dev):
        pyr = pyramid_from_packed(packed, lo, cell, levels)
    with profile_phase("bh.far", device=dev):
        a_far, j_far, h_far = far_field_grid(pyr, ws, 1.0, eps, levels)
        return (
            torch.cat([a_far, j_far, h_far], dim=-1)
            .reshape(d, d * d, 19).permute(0, 2, 1).contiguous()
        )


def _fused_bh_force_from_grid(grid, lo, cell, *, d, levels, ws, near_k, G,
                              softening, sorted_output, rank_sorted=None):
    """Everything downstream of the cell sort: placement + moments (K2),
    pyramid, far expansion (K3 per level), near sweep seeded with the far
    expansion (K4) and the pickup. ``rank_sorted``: the ranks a frozen
    step reuses. Returns ``(acc, TileBuild)``."""
    dev = grid.psort.device
    with profile_phase("bh.placement", device=dev):
        tb = tile_build(grid, lo, cell, d=d, k=near_k,
                        rank_sorted=rank_sorted)
    far_plane = far_plane_grid(tb.moments[:10].T.reshape(d, d, d, 10), lo,
                               cell, levels=levels, ws=ws, eps=softening)
    acc = tile_sweep_pick(
        tb, grid, lo, cell, far_plane, d=d, ws=ws, k=near_k, G=G,
        eps=softening, sorted_output=sorted_output,
    )
    return acc, tb


def bin_particles(pos, levels: int):
    """(lo, cell, coords): the finest grid geometry and each row's
    clipped int32 cell coordinates."""
    d = 1 << levels
    lo, cell = pyramid_geometry(
        torch.min(pos, dim=0).values, torch.max(pos, dim=0).values, levels
    )
    coords = torch.clamp(((pos - lo) / cell).to(torch.int32), 0, d - 1)
    return lo, cell, coords


def _near_field(pos, mass, lo, cell, G: float, eps: float, ws: int,
                levels: int, window: int, block_size: int = 256):
    """Exact pair forces within the (2ws+1)³ finest-cell ball by the
    sorted-window sweep (kernel K7; ``xy_ball(ws)``, z half-width ws, no
    cutoff) → ``(G·acc (N, 3) original order, overflow, coords)``."""
    d = 1 << levels
    coords = torch.clamp(((pos - lo) / cell).to(torch.int32), 0, d - 1)
    grid = build_sorted_grid(pos, mass, coords, d, with_csort=True)
    acc, overflow = window_sweep(
        grid, d=d, xy_offsets=xy_ball(ws), z_halfwidth=ws, window=window,
        block_size=block_size, eps=eps,
    )
    return G * acc, overflow, coords


def _far_pickup(far_cells, delta):
    """The far expansion A + J·δ (+ ½(H·δ)·δ with 19 channels) at offsets
    ``delta`` (N, 3) from the cell centres, ``far_cells`` (N, 9 | 19) the
    packed [A3 | J6 (| H10)] of each row's cell."""
    pick = far_cells[:, :3] + sym_matvec(far_cells[:, 3:9], delta)
    if far_cells.shape[1] > 9:
        pick = pick + 0.5 * sym_matvec(
            sym3_matvec(far_cells[:, 9:19], delta), delta)
    return pick


def _window_bh_forces(pos, mass, G, softening, ws, *, levels, window,
                      order=2):
    """The window engine: pyramid by scatter-add, far expansion (K3 per
    level at order 2, COM monopoles at order 1), near field (K7), and the
    far pickup in original row order."""
    dev = pos.device
    with profile_phase("bh.pyramid", device=dev):
        pyr = build_pyramid(pos, mass, levels, order)
    with profile_phase("bh.far", device=dev):
        far = [f for f in far_field_grid(pyr, ws, G, softening, levels)
               if f is not None]
    with profile_phase("bh.window", device=dev):
        a_near, _over, coords = _near_field(pos, mass, pyr.lo, pyr.cell, G,
                                            softening, ws, levels, window)
    with profile_phase("bh.pickup", device=dev):
        d = 1 << levels
        packed = torch.cat(far, dim=-1).reshape(d ** 3, -1)
        cid = ((coords[:, 0] * d + coords[:, 1]) * d + coords[:, 2]).to(
            torch.int64)
        delta = pos - (pyr.lo + (coords.to(pos.dtype) + 0.5) * pyr.cell)
        return a_near + _far_pickup(packed[cid], delta)


def _monopole_bh_force_from_grid(grid, lo, cell, *, d, levels, ws, near_k,
                                 G, softening, sorted_output):
    """The monopole (order-1) tiles path downstream of the cell sort, the
    JAX package's non-fused sorted branch: finest [m, m·x] moments by the
    segment sum (K6), the order-1 pyramid and far field, the exact near
    field on k-slot tiles (K2 + K4, no far plane: rows past the k cap read
    zero near field, counted by the audit), then the far pickup A + J·δ at
    the sorted rows' cell centres. Returns acc in cell-sorted order when
    ``sorted_output``, else in original order."""
    dev = grid.psort.device
    with profile_phase("bh.moments", device=dev):
        packed = _sorted_finest_moments(grid, d)
    with profile_phase("bh.pyramid", device=dev):
        pyr = pyramid_from_packed(packed, lo, cell, levels, order=1)
    with profile_phase("bh.far", device=dev):
        a_far, j_far, _ = far_field_grid(pyr, ws, G, softening, levels)
    a_near, _tb = tile_near_field(grid, lo, cell, d=d, ws=ws, k=near_k,
                                  G=G, eps=softening, sorted_output=True)
    with profile_phase("bh.pickup", device=dev):
        psort = grid.psort
        far = torch.cat([a_far, j_far], dim=-1).reshape(d ** 3, 9)
        delta = psort[:, :3] - (lo + (grid.csort.to(psort.dtype) + 0.5)
                                * cell)
        acc = a_near + _far_pickup(far[grid.ids.to(torch.int64)], delta)
    if sorted_output:
        return acc
    return unsort_rows(acc, grid.order)


def _require_frozen_contract(d: int, near_k: int, multipole_order: int):
    if not (tile_engine_fused(d, near_k) and multipole_order >= 2):
        raise ValueError(
            "frozen-grid stepping requires the fused order-2 tiles path "
            f"(d={d}, near_k={near_k}, multipole_order={multipole_order})")


def _barnes_hut_forces(pos, mass, G, softening, theta, *, levels, near_k,
                       near_engine="tiles", window=2048, multipole_order=2,
                       sorted_output=False, with_grid_meta=False):
    ws = theta_to_ws(theta, order=multipole_order)
    if near_engine == "window":
        if sorted_output:
            raise ValueError("the window near engine has no sorted contract")
        return _window_bh_forces(pos, mass, G, softening, ws, levels=levels,
                                 window=window, order=multipole_order)
    d = 1 << levels
    monopole = multipole_order < 2
    if with_grid_meta:
        _require_frozen_contract(d, near_k, multipole_order)
    with profile_phase("bh.sort", device=pos.device):
        lo, cell, coords = bin_particles(pos, levels)
        grid = build_sorted_grid(pos, mass, coords, d, with_csort=monopole)
    kw = dict(d=d, levels=levels, ws=ws, near_k=near_k, G=G,
              softening=softening, sorted_output=sorted_output)
    if monopole:
        acc = _monopole_bh_force_from_grid(grid, lo, cell, **kw)
    else:
        acc, tb = _fused_bh_force_from_grid(grid, lo, cell, **kw)
    if with_grid_meta:
        # the engine's own ids, ranks and segment index: frozen(fresh
        # meta) runs the same ops on the same inputs, bit for bit
        meta = FrozenGridMeta(ids=grid.ids, rank=tb.rank_sorted, lo=lo,
                              cell=cell, cell_start=grid.cell_start)
        return acc, grid.psort, grid.order, meta
    if sorted_output:
        return acc, grid.psort, grid.order
    return acc


def stale_count(psort, meta: FrozenGridMeta, d: int) -> torch.Tensor:
    """Rows whose cell under the frozen binning (``meta.lo``,
    ``meta.cell``, the Barnes-Hut formula of ``bin_particles``) differs
    from the cached ``meta.ids`` → () int64."""
    coords = torch.clamp(
        ((psort[:, :3] - meta.lo) / meta.cell).to(torch.int32), 0, d - 1)
    return (cell_ids(coords, d) != meta.ids).sum()


def barnes_hut_forces_frozen(psort, meta: FrozenGridMeta, G: float = 1.0,
                             softening: float = 0.1, theta: float = 0.5, *,
                             levels: int = 6, near_k: int = 16,
                             multipole_order: int = 2,
                             with_audit: bool = False):
    """BH forces on a FROZEN cell assignment, the stale-sort step of the
    re-sort cadence: ``psort`` (N, 4) holds the current [pos | mass] in the
    last re-sort's row order, ``meta`` the assignment that re-sort cached
    (``barnes_hut_forces_sorted(..., with_grid_meta=True)``). Placement +
    moments (K2), pyramid, far field (K3), sweep (K4) and pickup run on the
    current positions with the cached ids, ranks, segment index and grid
    geometry; a row that crossed a cell boundary since is evaluated in its
    old cell. Returns ``acc_sorted`` (the rows of ``psort``), or
    ``(acc_sorted, n_stale)`` with ``with_audit`` (``stale_count``).
    Order 1 raises ``ValueError``, as in the JAX package."""
    d = 1 << levels
    _require_frozen_contract(d, near_k, multipole_order)
    # order is unused under sorted_output=True
    grid = SortedGrid(order=None, psort=psort, ids=meta.ids,
                      cell_start=meta.cell_start)
    acc, _tb = _fused_bh_force_from_grid(
        grid, meta.lo, meta.cell, d=d, levels=levels,
        ws=theta_to_ws(theta, order=multipole_order), near_k=near_k, G=G,
        softening=softening, sorted_output=True, rank_sorted=meta.rank)
    if not with_audit:
        return acc
    return acc, stale_count(psort, meta, d)


def barnes_hut_forces(pos, mass, G: float = 1.0, softening: float = 0.1,
                      theta: float = 0.5, *, levels: int = 6,
                      near_k: int = 16, near_engine: str = "tiles",
                      window: int = 2048, multipole_order: int = 2):
    """Full BH acceleration (N, 3) in original row order: pyramid far
    field + exact near field, on k-slot tiles (``near_engine="tiles"``) or
    by the sorted-window sweep with ``window`` rows per offset
    (``"window"``). ``multipole_order`` 2: quadrupole sources at
    ws = ceil(1/(2θ)); 1: COM monopoles at ws = ceil(1/θ)."""
    return _barnes_hut_forces(pos, mass, G, softening, theta, levels=levels,
                              near_k=near_k, near_engine=near_engine,
                              window=window, multipole_order=multipole_order)


def barnes_hut_forces_sorted(pos, mass, G: float = 1.0,
                             softening: float = 0.1, theta: float = 0.5, *,
                             levels: int = 6, near_k: int = 16,
                             multipole_order: int = 2,
                             with_grid_meta: bool = False):
    """The tiles engine's forces in its CELL-SORTED row order →
    ``(acc_sorted, psort, order)``: ``psort`` (N, 4) = [pos | mass][order],
    ``acc_sorted`` aligned with it (the sorted-stepping contract);
    ``with_grid_meta=True`` appends the ``FrozenGridMeta`` that
    ``barnes_hut_forces_frozen`` steps on."""
    return _barnes_hut_forces(pos, mass, G, softening, theta, levels=levels,
                              near_k=near_k, multipole_order=multipole_order,
                              sorted_output=True,
                              with_grid_meta=with_grid_meta)


def make_barnes_hut_forces(config: SimulationConfig):
    """``force_fn(pos, mass) -> acc`` for the config (original row order),
    on the near engine ``bh_engine_params`` selects."""
    p = bh_engine_params(config)
    G, eps, theta = config.G, config.softening, config.barnes_hut_theta

    def force_fn(pos, mass):
        return _barnes_hut_forces(pos, mass, G, eps, theta,
                                  levels=p["levels"], near_k=p["near_k"],
                                  near_engine=p["near_engine"],
                                  window=p["window"],
                                  multipole_order=p["multipole_order"])

    return force_fn


def make_barnes_hut_forces_sorted(config: SimulationConfig):
    """``sorted_force_fn(pos, mass) -> (acc_sorted, psort, order)``, or
    None when the config selects the window engine (no sorted contract:
    callers step in original order). As in the JAX package the closure
    carries the frozen-grid contract of ``integrator.make_resort_multi_step``:
    ``with_meta(pos, mass)`` (the sorted step plus its ``FrozenGridMeta``;
    raises where ``tile_engine_fused`` does not hold), ``frozen(psort, meta,
    with_audit=False)`` and ``stale_count(psort, meta)``."""
    p = bh_engine_params(config)
    if p["near_engine"] != "tiles":
        return None
    G, eps, theta = config.G, config.softening, config.barnes_hut_theta
    kw = dict(levels=p["levels"], near_k=p["near_k"],
              multipole_order=p["multipole_order"])

    def sorted_force_fn(pos, mass):
        return _barnes_hut_forces(pos, mass, G, eps, theta,
                                  sorted_output=True, **kw)

    def with_meta(pos, mass):
        return _barnes_hut_forces(pos, mass, G, eps, theta,
                                  sorted_output=True, with_grid_meta=True,
                                  **kw)

    def frozen(psort, meta, with_audit=False):
        return barnes_hut_forces_frozen(psort, meta, G, eps, theta,
                                        with_audit=with_audit, **kw)

    sorted_force_fn.with_meta = with_meta
    sorted_force_fn.frozen = frozen
    sorted_force_fn.stale_count = (
        lambda psort, meta: stale_count(psort, meta, 1 << p["levels"]))
    return sorted_force_fn
