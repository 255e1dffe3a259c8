"""Plain reference of the Barnes-Hut tiles engine's accelerations.

A frozen copy, in plain torch, of the arithmetic that defines the engine's
result (the order-2 multipole grid pyramid, the multipole-to-local taps
with telescoping acceptance, the exact downward translation, the local
expansion evaluated at each row, and the exact softened pair sum over the
(2ws+1)^3 finest-cell ball), recomputed from positions and masses alone.
It imports nothing of the program and takes nothing it made.

The engine's binning is an integer decision, not a precision: the bounding
cube, the cell edge and each row's cell are computed with the program's
float32 rule on the same device, so both sides put every row in the same
cell. Everything after that runs in float64 (or in the control's lower
precision, ``precision="tf32"``: float32 with the far-field products'
operands rounded to TF32, the step a kernel would take by dropping the
3xTF32 split).

Rows past the k-slot cap of a cell drop out of the engine's near field
(as sources and targets) and read their cell's far field alone; which rows
those are depends on the order the rows had when they were sorted, which
the cell-sorted stepping carries from step to step. So ``accelerations``
returns a mask of the targets whose result does not depend on that order:
those whose (2ws+1)^3 ball holds no cell above the cap.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_KIDS = np.array([(x, y, z) for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                 np.int32)


def engine_params(sim: dict) -> dict:
    """levels, ws and near_k of the tiles engine for a configuration's
    ``simulation`` block (the published selection rule)."""
    levels = int(sim.get("bh_max_level", 6))
    theta = float(sim.get("barnes_hut_theta", 0.5))
    ws = 16 if theta <= 0 else max(1, min(16, math.ceil(1.0 / (2.0 * theta))))
    occ = int(sim["particle_count"]) / float(8 ** levels)
    if occ > 24.0:
        raise ValueError("the reference covers the tiles engine only")
    raw = occ + 5.0 * math.sqrt(occ + 1.0)
    near_k = int(min(64, max(8, -(-raw // 8) * 8)))
    return {"levels": levels, "ws": ws, "near_k": near_k, "d": 1 << levels}


def geometry(pos: torch.Tensor, levels: int):
    """(lo, cell, coords) by the engine's float32 rule: the bounding cube
    widened by 1e-5, 2^levels cells an axis, coordinates truncated and
    clipped."""
    d = 1 << levels
    lo = torch.min(pos, dim=0).values
    hi = torch.max(pos, dim=0).values
    cube = torch.clamp(torch.max(hi - lo), min=1e-6) * (1.0 + 1e-5)
    cell = cube / d
    coords = torch.clamp(((pos - lo) / cell).to(torch.int32), 0, d - 1)
    return lo, cell, coords.to(torch.int64)


def centres(lo, cell, coords_or_grid: torch.Tensor) -> torch.Tensor:
    """Cell centres lo + (c + 0.5)·cell in float32, the engine's rounding."""
    return lo + (coords_or_grid.to(torch.float32) + 0.5) * cell


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties
    away from zero), as the tensor cores read a TF32 operand."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


def finest_moments(pos, mass, coords, lo, cell, d: int, dtype) -> torch.Tensor:
    """(d, d, d, 10) [m, m·xr, m·xr⊗xr] about each cell centre, every row
    of a cell included."""
    cid = (coords[:, 0] * d + coords[:, 1]) * d + coords[:, 2]
    xr = (pos.to(dtype) - centres(lo, cell, coords).to(dtype))
    m = mass.to(dtype)[:, None]
    x, y, z = xr[:, 0:1], xr[:, 1:2], xr[:, 2:3]
    vals = torch.cat([m, m * xr, m * (x * x), m * (y * y), m * (z * z),
                      m * (x * y), m * (x * z), m * (y * z)], dim=-1)
    out = torch.zeros((d ** 3, 10), dtype=dtype, device=pos.device)
    out.index_add_(0, cid, vals)
    return out.reshape(d, d, d, 10)


def pyramid(packed, cell, levels: int):
    """Upward pass by the parallel-axis translation → (masses, srels,
    quads), coarse → fine."""
    dt, dev = packed.dtype, packed.device
    masses, srels, quads = [packed[..., 0]], [packed[..., 1:4]], \
        [packed[..., 4:10]]
    half = torch.tensor([-0.5, 0.5], dtype=dt, device=dev)
    for lvl in range(levels):
        dm = masses[-1].shape[0] // 2
        m_c = masses[-1].reshape(dm, 2, dm, 2, dm, 2)
        masses.append(m_c.sum(dim=(1, 3, 5)))
        par = half * 2.0 * (cell * (1 << lvl) * 0.5)
        dx = par.reshape(1, 2, 1, 1, 1, 1)
        dy = par.reshape(1, 1, 1, 2, 1, 1)
        dz = par.reshape(1, 1, 1, 1, 1, 2)
        s_c = srels[-1].reshape(dm, 2, dm, 2, dm, 2, 3)
        q_c = quads[-1].reshape(dm, 2, dm, 2, dm, 2, 6)
        sx, sy, sz = s_c[..., 0], s_c[..., 1], s_c[..., 2]
        q_p = torch.stack([
            q_c[..., 0] + 2 * dx * sx + m_c * dx * dx,
            q_c[..., 1] + 2 * dy * sy + m_c * dy * dy,
            q_c[..., 2] + 2 * dz * sz + m_c * dz * dz,
            q_c[..., 3] + dx * sy + dy * sx + m_c * dx * dy,
            q_c[..., 4] + dx * sz + dz * sx + m_c * dx * dz,
            q_c[..., 5] + dy * sz + dz * sy + m_c * dy * dz,
        ], dim=-1)
        quads.append(q_p.sum(dim=(1, 3, 5)))
        s_p = s_c + m_c[..., None] * torch.stack(
            [dx.expand(m_c.shape), dy.expand(m_c.shape),
             dz.expand(m_c.shape)], dim=-1)
        srels.append(s_p.sum(dim=(1, 3, 5)))
    return masses[::-1], srels[::-1], quads[::-1]


def _window(ws: int):
    """Parent offsets (T, 3) and the child accept masks (T, 8t, 8s):
    children Chebyshev-separated by more than ws."""
    rng = np.arange(-ws, ws + 1)
    po = np.array([(x, y, z) for x in rng for y in rng for z in rng],
                  np.int32)
    delta = 2 * po[:, None, None, :] + _KIDS[None, None] - _KIDS[None, :, None]
    return po, np.abs(delta).max(axis=-1) > ws


def _tap_table():
    """(19, 10) gather index into the derivative bank [T1 | T2 | T3 | T4 |
    0] and coefficients: rows [A3, J6, H10], columns [m, s3, q6]."""
    sym6 = [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]
    sym10 = [(0, 0, 0), (1, 1, 1), (2, 2, 2), (0, 0, 1), (0, 0, 2),
             (0, 1, 1), (1, 1, 2), (0, 2, 2), (1, 2, 2), (0, 1, 2)]
    q_mult = [1.0, 1.0, 1.0, 2.0, 2.0, 2.0]

    def t2(i, j):
        return 3 + 3 * i + j

    def t3(i, j, k):
        return 12 + 9 * i + 3 * j + k

    def t4(i, j, k, m):
        return 39 + 27 * i + 9 * j + 3 * k + m

    idx, coef = [], []
    for i in range(3):
        idx.append([i] + [t2(i, j) for j in range(3)]
                   + [t3(i, *sym6[c]) for c in range(6)])
        coef.append([1.0] * 4 + [0.5 * q_mult[c] for c in range(6)])
    for (i, j) in sym6:
        idx.append([t2(i, j)] + [t3(i, j, k) for k in range(3)]
                   + [t4(i, j, *sym6[c]) for c in range(6)])
        coef.append([-1.0] * 4 + [-0.5 * q_mult[c] for c in range(6)])
    for (i, j, k) in sym10:
        idx.append([t3(i, j, k)] + [t4(i, j, k, m) for m in range(3)]
                   + [120] * 6)
        coef.append([1.0] * 4 + [0.0] * 6)
    return np.array(idx, np.int64), np.array(coef, np.float64)


def tap_kernel(dvec: torch.Tensor, eps: float) -> torch.Tensor:
    """(…, 3) source − target centre displacements → (…, 19, 10) local
    expansion matrices from the Plummer-kernel derivatives T1..T4 of
    D·u^{-3/2}, u = |D|² + ε² (the quadrupole's T5 term truncated)."""
    lead = dvec.shape[:-1]
    D = dvec.reshape(-1, 3)
    dev, dt = D.device, D.dtype
    u = torch.clamp((D * D).sum(-1) + eps * eps, min=1e-30)
    u3 = u ** -1.5
    u5, u7 = u3 / u, u3 / (u * u)
    u9 = u7 / u
    eye = torch.eye(3, dtype=dt, device=dev)

    def col(x, nd):
        return x.reshape((-1,) + (1,) * nd)

    t1 = D * col(u3, 1)
    di, dj = D[:, :, None], D[:, None, :]
    t2 = eye * col(u3, 2) - 3.0 * di * dj * col(u5, 2)
    di, dj, dk = D[:, :, None, None], D[:, None, :, None], D[:, None, None, :]
    term3 = eye[:, :, None] * dk + eye[:, None, :] * dj + eye[None] * di
    t3 = -3.0 * term3 * col(u5, 3) + 15.0 * di * dj * dk * col(u7, 3)
    di, dj = D[:, :, None, None, None], D[:, None, :, None, None]
    dk, dl = D[:, None, None, :, None], D[:, None, None, None, :]
    i_ij, i_kl = eye[:, :, None, None], eye[None, None, :, :]
    i_ik, i_jl = eye[:, None, :, None], eye[None, :, None, :]
    i_jk, i_il = eye[None, :, :, None], eye[:, None, None, :]
    t4 = (-3.0 * (i_ij * i_kl + i_ik * i_jl + i_jk * i_il) * col(u5, 4)
          + 15.0 * (i_ij * dk * dl + i_ik * dj * dl + i_jk * di * dl
                    + i_kl * di * dj + i_jl * di * dk + i_il * dj * dk)
          * col(u7, 4)
          - 105.0 * di * dj * dk * dl * col(u9, 4))
    n = D.shape[0]
    bank = torch.cat([t1, t2.reshape(n, 9), t3.reshape(n, 27),
                      t4.reshape(n, 81), torch.zeros((n, 1), dtype=dt,
                                                     device=dev)], dim=1)
    idx, coef = _tap_table()
    out = bank[:, torch.as_tensor(idx.reshape(-1), device=dev)].reshape(
        n, 19, 10) * torch.as_tensor(coef, dtype=dt, device=dev)
    return out.reshape(lead + (19, 10))


def level_taps(cell, ws: int, eps: float, levels: int, lvl: int):
    """(T, 8·19, 8·10) tap matrices of level ``lvl``, acceptance folded in."""
    po, accept = _window(ws)
    dev, dt = cell.device, cell.dtype
    dint = (2 * po[:, None, None, :] + _KIDS[None, None] - _KIDS[None, :, None]
            ).reshape(-1, 3)
    dvec = torch.as_tensor(dint, dtype=dt, device=dev) * (
        cell * float(1 << (levels - lvl)))
    k = tap_kernel(dvec, eps) * torch.as_tensor(
        accept.reshape(-1), dtype=dt, device=dev)[:, None, None]
    t = po.shape[0]
    return k.reshape(t, 8, 8, 19, 10).permute(0, 1, 3, 2, 4).reshape(
        t, 8 * 19, 8 * 10)


def level_moments(masses, srels, quads, lvl: int) -> torch.Tensor:
    """(80, p³) child-major moment channels, channel = kid·10 + [m, s3, q6]."""
    p = (1 << lvl) // 2

    def cm(x, c):
        return x.reshape(p, 2, p, 2, p, 2, c).permute(1, 3, 5, 6, 0, 2, 4
                                                      ).reshape(8, c, p ** 3)

    return torch.cat([cm(masses[lvl][..., None], 1), cm(srels[lvl], 3),
                      cm(quads[lvl], 6)], dim=1).reshape(80, p ** 3)


def tap_sum(mom, taps, p: int, ws: int, precision: str) -> torch.Tensor:
    """Σ over parent offsets of taps[t] @ shifted moments → (152, p³); with
    ``precision="tf32"`` both operands of every product are TF32."""
    pc = p ** 3
    if precision == "tf32":
        mom, taps = tf32(mom), tf32(taps)
    pad = torch.nn.functional.pad(mom.reshape(80, p, p, p), [ws] * 6)
    acc = torch.zeros((taps.shape[1], pc), dtype=mom.dtype, device=mom.device)
    r = range(-ws, ws + 1)
    offs = [(x, y, z) for x in r for y in r for z in r]
    for t, (ox, oy, oz) in enumerate(offs):
        src = pad[:, ox + ws:ox + ws + p, oy + ws:oy + ws + p,
                  oz + ws:oz + ws + p].reshape(80, pc)
        acc = acc + taps[t] @ src
    return acc


def _sym(j6, v):
    return torch.stack([
        j6[..., 0] * v[..., 0] + j6[..., 3] * v[..., 1] + j6[..., 4] * v[..., 2],
        j6[..., 3] * v[..., 0] + j6[..., 1] * v[..., 1] + j6[..., 5] * v[..., 2],
        j6[..., 4] * v[..., 0] + j6[..., 5] * v[..., 1] + j6[..., 2] * v[..., 2],
    ], dim=-1)


def _sym3(h, v):
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        h[..., 0] * vx + h[..., 3] * vy + h[..., 4] * vz,
        h[..., 5] * vx + h[..., 1] * vy + h[..., 6] * vz,
        h[..., 7] * vx + h[..., 8] * vy + h[..., 2] * vz,
        h[..., 3] * vx + h[..., 5] * vy + h[..., 9] * vz,
        h[..., 4] * vx + h[..., 9] * vy + h[..., 7] * vz,
        h[..., 9] * vx + h[..., 6] * vy + h[..., 8] * vz,
    ], dim=-1)


def far_field(packed, cell, *, levels: int, ws: int, eps: float,
              precision: str) -> torch.Tensor:
    """(d, d, d, 19) far expansion [A3 | J6 | H10] about each finest cell
    centre (unscaled by G): each level's accepted taps, then
    A_child = A + J·δ + ½δᵀHδ, J_child = J + H·δ, H_child = H."""
    masses, srels, quads = pyramid(packed, cell, levels)
    dt, dev = packed.dtype, packed.device
    acc = jac = hes = None
    for lvl in range(1, levels + 1):
        dl, p = 1 << lvl, (1 << lvl) // 2
        taps = level_taps(cell, ws, eps, levels, lvl)
        out = tap_sum(level_moments(masses, srels, quads, lvl), taps, p, ws,
                      precision).reshape(8, 19, p ** 3)

        def grid(a, c):
            return a.reshape(2, 2, 2, c, p, p, p).permute(
                4, 0, 5, 1, 6, 2, 3).reshape(dl, dl, dl, c)

        a_l, j_l, h_l = grid(out[:, 0:3], 3), grid(out[:, 3:9], 6), \
            grid(out[:, 9:19], 10)
        if acc is not None:
            def rep(x):
                return (x.repeat_interleave(2, 0).repeat_interleave(2, 1)
                        .repeat_interleave(2, 2))

            a_r, j_r, h_r = rep(acc), rep(jac), rep(hes)
            par = (torch.arange(dl, device=dev) % 2).to(dt) - 0.5
            px, py, pz = torch.meshgrid(par, par, par, indexing="ij")
            delta = torch.stack([px, py, pz], dim=-1) * (
                cell * (1 << (levels - lvl)))
            hd6 = _sym3(h_r, delta)
            a_l = a_l + a_r + _sym(j_r, delta) + 0.5 * _sym(hd6, delta)
            j_l = j_l + j_r + hd6
            h_l = h_l + h_r
        acc, jac, hes = a_l, j_l, h_l
    return torch.cat([acc, jac, hes], dim=-1)


def far_eval(f, dx, dy, dz):
    """A + J·δ + ½(H·δ)·δ for (…, 19) expansions and offsets δ."""
    fx = f[..., 0] + (f[..., 3] * dx + f[..., 6] * dy + f[..., 7] * dz)
    fy = f[..., 1] + (f[..., 6] * dx + f[..., 4] * dy + f[..., 8] * dz)
    fz = f[..., 2] + (f[..., 7] * dx + f[..., 8] * dy + f[..., 5] * dz)
    hxx = f[..., 9] * dx + f[..., 12] * dy + f[..., 13] * dz
    hyy = f[..., 14] * dx + f[..., 10] * dy + f[..., 15] * dz
    hzz = f[..., 16] * dx + f[..., 17] * dy + f[..., 11] * dz
    hxy = f[..., 12] * dx + f[..., 14] * dy + f[..., 18] * dz
    hxz = f[..., 13] * dx + f[..., 18] * dy + f[..., 16] * dz
    hyz = f[..., 18] * dx + f[..., 15] * dy + f[..., 17] * dz
    fx = fx + 0.5 * (hxx * dx + hxy * dy + hxz * dz)
    fy = fy + 0.5 * (hxy * dx + hyy * dy + hyz * dz)
    fz = fz + 0.5 * (hxz * dx + hyz * dy + hzz * dz)
    return torch.stack([fx, fy, fz], dim=-1)


def accelerations(pos, mass, targets, sim: dict, precision: str = "f64",
                  grid_pos=None):
    """Accelerations of the rows ``targets`` (S,) → (acc (S, 3) in the
    working dtype, comparable (S,) bool, band (S,) zeros, counts (d³,)).
    ``precision``: "f64" (the reference) or "tf32" (the control).
    ``grid_pos``: the positions the cells were assigned from, where that
    is not ``pos`` (a frozen-grid step: the bounding cube and each row's
    cell are those of the last sort, the moments and pairs are taken at
    the current positions)."""
    p = engine_params(sim)
    levels, ws, k, d = p["levels"], p["ws"], p["near_k"], p["d"]
    eps, G = float(sim.get("softening", 0.1)), float(sim.get("G", 1.0))
    dt = torch.float64 if precision == "f64" else torch.float32
    dev = pos.device
    lo, cell, coords = geometry(pos if grid_pos is None else grid_pos,
                                levels)
    packed = finest_moments(pos, mass, coords, lo, cell, d, dt)
    far = far_field(packed, cell.to(dt), levels=levels, ws=ws, eps=eps,
                    precision=precision).reshape(d ** 3, 19)
    cid = (coords[:, 0] * d + coords[:, 1]) * d + coords[:, 2]
    counts = torch.bincount(cid, minlength=d ** 3)
    order = torch.argsort(cid, stable=True)
    start = torch.cumsum(counts, 0) - counts
    w1 = 2 * ws + 1
    r = torch.arange(-ws, ws + 1, device=dev)
    off = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(
        w1 ** 3, 3)
    tc = coords[targets]                                    # (S, 3)
    nb = tc[:, None, :] + off[None]                         # (S, W, 3)
    inside = ((nb >= 0) & (nb < d)).all(-1)
    nid = (nb[..., 0] * d + nb[..., 1]) * d + nb[..., 2]
    nid = torch.where(inside, nid, torch.zeros_like(nid))
    ncount = torch.where(inside, counts[nid], torch.zeros_like(nid))
    comparable = (ncount <= k).all(-1)
    slot = torch.arange(k, device=dev)
    live = slot[None, None, :] < torch.clamp(ncount, max=k)[..., None]
    rows = order[torch.clamp(start[nid][..., None] + slot, max=pos.shape[0]
                             - 1)]                          # (S, W, k)
    tx = pos[targets].to(dt)
    sx = pos[rows].to(dt)
    sm = torch.where(live, mass[rows].to(dt), torch.zeros((), dtype=dt,
                                                          device=dev))
    dvec = sx - tx[:, None, None, :]
    r2 = (dvec * dvec).sum(-1)
    inv = torch.rsqrt(r2 + eps * eps)
    wgt = torch.where(r2 == 0.0, torch.zeros((), dtype=dt, device=dev),
                      sm * inv * inv * inv)
    near = (wgt[..., None] * dvec).sum(dim=(1, 2))
    ctr = centres(lo, cell, tc).to(dt)
    rel = tx - ctr
    farv = far_eval(far[cid[targets]], rel[:, 0], rel[:, 1], rel[:, 2])
    acc = G * (farv + near)
    return acc, comparable, torch.zeros(targets.shape[0], dtype=dt,
                                        device=dev), counts
