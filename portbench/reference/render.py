"""Plain reference of the viewer's frame: the points projected through the
orbit camera, culled, sized and coloured, splatted as discs with a
quadratic falloff and additive blending, clamped and stored as uint8
(img·255 truncated).

Recomputed from positions alone, in plain torch. The camera's matrices
are glm's lookAt and perspective in float64; each homogeneous product is
summed ((x·m0 + y·m1) + z·m2) + m3, which places every point exactly as
the published renderer does. The splat sums each pixel's float32 terms from 0 in
ascending point index with two fused multiply-adds, as the published
native splat does, so the frame is exact: equal, value for value, to a
renderer that follows the published order. With ``precision="f32"`` (the
control) the projection runs in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CULL_NDC = 1.2
SIZE_SCALE = 30.0
MIN_DEPTH = 0.1
MIN_SIZE, MAX_SIZE = 0.5, 16.0
MAX_RADIUS = 8
WARM, COOL = (1.0, 0.65, 0.3), (0.3, 0.45, 1.0)
FLAT_RANGE = 1e-12


def camera_matrices(distance, azimuth, elevation, aspect, fov_deg=45.0,
                    near=0.1, far=2000.0):
    """(projection·view, view) 4×4 float64 of an orbit camera about the
    origin."""
    ce, se = math.cos(elevation), math.sin(elevation)
    ca, sa = math.cos(azimuth), math.sin(azimuth)
    eye = np.array([ce * ca, se, ce * sa]) * distance
    fwd = -eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = right, up, -fwd
    view[0, 3], view[1, 3], view[2, 3] = -right @ eye, -up @ eye, fwd @ eye
    f = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = f / aspect, f
    proj[2, 2] = (far + near) / (near - far)
    proj[2, 3] = 2.0 * far * near / (near - far)
    proj[3, 2] = -1.0
    return proj @ view, view, near


def _row(x, y, z, m):
    return x * m[0] + y * m[1] + z * m[2] + m[3]


def _round_half_away(v):
    v = v.to(torch.float64)
    return (torch.sign(v) * torch.floor(v.abs() + 0.5)).to(torch.int64)


def fma32(a, b, c):
    """fma(a, b, c) of float32 tensors, rounded once to float32: a·b is
    exact in float64, the float64 sum is stepped to its round-to-odd value
    with TwoSum's error, and round-to-odd at 53 bits then nearest at 24 is
    the correctly rounded sum."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)
    bump = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.copysign(torch.full_like(s, float("inf")), err)
    return torch.where(bump, torch.nextafter(s, toward), s).to(torch.float32)


def _disc(r: int):
    """Offsets (dy, dx) of radius r's disc (d² ≤ r²), row-major, the
    sprite's α = min(1, 1.5/r²) and each offset's falloff
    fma(−(0.6·d²), 1/r², 1), in float32."""
    f32 = np.float32
    alpha = min(f32(1.0), f32(1.5) / f32(r * r))
    inv_r2 = f32(1.0) / f32(r * r)
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    keep = dy * dy + dx * dx <= r * r
    dy, dx = dy[keep], dx[keep]
    d2 = (dy * dy + dx * dx).astype(f32)
    fall = fma32(torch.from_numpy(-(f32(0.6) * d2)),
                 torch.full(d2.shape, inv_r2), torch.ones(d2.shape)).numpy()
    return dy, dx, alpha, fall.astype(f32)


def _splat_ordered(cx, cy, radius, rgb, width: int, height: int):
    """Each pixel the float32 sum, from 0, of its sprites' terms in
    ascending point index, each added as fma(c, fall, acc) with
    c = rgb·α rounded on its own → (H·W, 3)."""
    dev = cx.device
    m = cx.shape[0]
    alpha = torch.tensor([0.0] + [_disc(r)[2] for r in range(
        1, MAX_RADIUS + 1)], dtype=torch.float32, device=dev)
    c = rgb * alpha[radius][:, None]
    pix, pt, fall = [], [], []
    for r in range(1, MAX_RADIUS + 1):
        j = torch.nonzero(radius == r).squeeze(1)
        if j.numel() == 0:
            continue
        dy, dx, _, f = _disc(r)
        uy = cy[j][:, None] + torch.from_numpy(dy).to(dev)[None, :]
        ux = cx[j][:, None] + torch.from_numpy(dx).to(dev)[None, :]
        ok = (ux >= 0) & (ux < width) & (uy >= 0) & (uy < height)
        pix.append((uy * width + ux)[ok])
        pt.append(j[:, None].expand(ok.shape)[ok])
        fall.append(torch.from_numpy(f).to(dev)[None, :].expand(ok.shape)[ok])
    acc = torch.zeros((height * width, 3), dtype=torch.float32, device=dev)
    if not pix:
        return acc
    pix, pt, fall = torch.cat(pix), torch.cat(pt), torch.cat(fall)
    order = torch.argsort(pix * m + pt)
    pix_s = pix[order]
    at = torch.arange(pix_s.numel(), device=dev)
    first = torch.ones_like(pix_s, dtype=torch.bool)
    first[1:] = pix_s[1:] != pix_s[:-1]
    rank = at - torch.cummax(torch.where(first, at, 0), 0).values
    order = order[torch.argsort(rank, stable=True)]
    start = 0
    for k in torch.bincount(rank).tolist():
        g = order[start:start + k]
        p = pix[g]
        acc[p] = fma32(c[pt[g]], fall[g][:, None], acc[p])
        start += k
    return acc


def frame(pos, traffic: dict, precision: str = "f64") -> torch.Tensor:
    """(H, W, 3) uint8 frame of ``pos`` in DEPTH colours for the viewer's
    ``traffic`` (width, height, point_size, camera)."""
    if traffic.get("color_mode", "DEPTH") != "DEPTH":
        raise ValueError("the reference renders DEPTH colours only")
    w, h = int(traffic["width"]), int(traffic["height"])
    cam = traffic["camera"]
    pv, view, near = camera_matrices(cam["distance"], cam["azimuth"],
                                     cam["elevation"], w / h)
    pv, view = pv.tolist(), view.tolist()
    dt = torch.float64 if precision == "f64" else torch.float32
    p = pos.to(dt)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    wq = _row(x, y, z, pv[3])
    front = wq > near * 0.5
    wq = torch.where(front, wq, torch.ones_like(wq))
    nx, ny = _row(x, y, z, pv[0]) / wq, _row(x, y, z, pv[1]) / wq
    vz = -_row(x, y, z, view[2])
    vis = front & (nx.abs() < CULL_NDC) & (ny.abs() < CULL_NDC)
    nx, ny, vz = (t[vis].to(torch.float64) for t in (nx, ny, vz))
    lo, hi = vz.min(), vz.max()
    span = hi - lo
    t = torch.where(span < FLAT_RANGE, torch.zeros_like(vz),
                    (vz - lo) / span).clamp(0.0, 1.0)[:, None]
    a = torch.tensor(WARM, dtype=torch.float64, device=pos.device)
    b = torch.tensor(COOL, dtype=torch.float64, device=pos.device)
    rgb = (a * (1.0 - t) + b * t).to(torch.float32)
    px = ((nx * 0.5 + 0.5) * (w - 1)).to(torch.float32)
    py = ((1.0 - (ny * 0.5 + 0.5)) * (h - 1)).to(torch.float32)
    size = (torch.full_like(vz, float(traffic["point_size"]) * SIZE_SCALE)
            / vz.clamp(min=MIN_DEPTH)).clamp(MIN_SIZE, MAX_SIZE).to(
                torch.float32)
    cx, cy = _round_half_away(px), _round_half_away(py)
    radius = _round_half_away(size * 0.5).clamp(min=1)
    img = _splat_ordered(cx, cy, radius, rgb, w, h)
    img = img.to(torch.float32).clamp(0.0, 1.0).reshape(h, w, 3)
    return (img * 255).to(torch.uint8)


def image_gap(image, pos, traffic: dict) -> float:
    """Largest per-channel difference, in steps of 255, between ``image``
    and the reference frame of ``pos``."""
    ref = frame(pos, traffic)
    got = image.to(ref.device).to(torch.int32)
    return float((got - ref.to(torch.int32)).abs().max())
