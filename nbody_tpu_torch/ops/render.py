"""Point-sprite splat of a frame (kernel R1).

Counterpart of the JAX package's host renderer: the NumPy projection,
culling, sizing and colouring of ``nbody_tpu/render/renderer.py``
(``PointRenderer.render``) and the C++ splat loop ``nbody_splat_points``
of ``native/rasterizer.cpp``. No TPU kernel does this work: a TPU cannot
share buffers with a display, so the JAX package copies the points to the
host every frame. Here the frame is made on the card and only the image
leaves it.

Semantics, shared by the kernel and its twin:

1. project in float64 (``Camera.project``'s order); a point is visible
   when in front of the eye and |ndc x|, |ndc y| < 1.2;
2. px = (ndc x·0.5 + 0.5)·(W − 1), py = (1 − (ndc y·0.5 + 0.5))·(H − 1),
   size = clip(point_size·30 / max(view z, 0.1), 0.5, 16), each in
   float64, then cast to float32;
3. the colour key (view z in float64 for DEPTH; for VELOCITY |v| in
   float32, as NumPy's norm of the float32 velocities; none for DENSITY)
   normalised by its min and max over the visible points (in the key's
   precision), the ramp interpolated in float64 and cast to float32
   (``render/color.py``);
4. a disc of radius r = max(1, round(size/2)) around (round(px),
   round(py)), rounding half away from zero, adds c·fall to each pixel
   inside the image, c = rgb·α, α = min(1, 1.5/r²), fall = 1 −
   0.6·d²·(1/r²), in float32. Each pixel sums its terms from 0 in
   ascending point index, as ``nbody_splat_points`` does, with that
   library's two FMAs: fall = fma(−(0.6·d²), 1/r², 1) and acc = fma(c,
   fall, acc);
5. the image clamped to [0, 1]; optionally a uint8 copy, (img·255)
   truncated.

``render_points`` is the wrapper of ``csrc/render.cu``. It bins the
sprites to screen tiles and sums each pixel in point order, so its image
equals ``render_points_plain(..., accumulate="ordered")`` bit for bit, and
so the JAX renderer's with its native splat, on every call. The twin's
"f32" and "f64" sums (the float32 terms added with ``index_put_``, or in
float64) stay as yardsticks within 1e-5, the JAX package's own tolerance
between its NumPy and native splats.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.types import ColorMode

CULL_NDC = 1.2     # |ndc| bound of a visible point
SIZE_SCALE = 30.0  # point size·SIZE_SCALE / depth = sprite diameter, px
MIN_DEPTH = 0.1
MIN_SIZE, MAX_SIZE = 0.5, 16.0
MAX_RADIUS = 8     # round(MAX_SIZE / 2)
MAX_SIDE = 16384   # the kernel's largest image side (int16 sprite centres)
TILE = 8           # R1's screen tile side, pixels (render.cu's kTile)
MAX_CHUNKS = 64    # index-range chunks a tile's list is cut in, at most


class Rendered(NamedTuple):
    """One frame: ``image`` (H, W, 3) float32 in [0, 1]; ``image_u8`` its
    (img·255)-truncated uint8 copy when asked for; ``sprites`` when asked
    for: (px, py, size) (N,) float32 and rgb (N, 3) float32 per point,
    all 0 for a point that is not visible (a visible size is ≥ 0.5)."""

    image: torch.Tensor
    image_u8: Optional[torch.Tensor]
    sprites: Optional[tuple]


def _round_half_away(v: torch.Tensor) -> torch.Tensor:
    """C's ``lround`` of float32 values, exactly: in float64 |v| + 0.5 is
    exact, so floor gives the nearest integer, ties away from zero."""
    v = v.to(torch.float64)
    return (torch.sign(v) * torch.floor(v.abs() + 0.5)).to(torch.int64)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) of float32 tensors, rounded once to float32 as a fused
    multiply-add rounds it. a·b is exact in float64; the float64 sum is
    turned into its round-to-odd value with TwoSum's error (stepped one
    ulp toward the error where the error is not 0 and the last bit is
    even), and round-to-odd at 53 bits then round-to-nearest at 24 is the
    correctly rounded sum (a plain float64 sum then a cast rounds twice
    and can miss by an ulp)."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)
    bump = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.copysign(torch.full_like(s, float("inf")), err)
    return torch.where(bump, torch.nextafter(s, toward), s).to(torch.float32)


def _disc(r: int, fused: bool = False):
    """The offsets (dy, dx) of radius ``r``'s disc (d² ≤ r²), row-major,
    and each one's weight α·(1 − 0.6·d²·(1/r²)), rounded in float32 one
    operation at a time; with ``fused`` the falloff is rounded as the
    shipped ``native/libnbody_native.so`` and kernel R1 round it,
    fma(−(0.6·d²), 1/r², 1) with 0.6·d² rounded on its own."""
    f32 = np.float32
    alpha = min(f32(1.0), f32(1.5) / f32(r * r))
    inv_r2 = f32(1.0) / f32(r * r)
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    keep = dy * dy + dx * dx <= r * r
    dy, dx = dy[keep], dx[keep]
    d2 = (dy * dy + dx * dx).astype(f32)
    if fused:
        fall = fma32(torch.from_numpy(-(f32(0.6) * d2)),
                     torch.full(d2.shape, inv_r2),
                     torch.ones(d2.shape)).numpy()
    else:
        fall = f32(1.0) - (f32(0.6) * d2) * inv_r2
    return dy, dx, alpha, fall.astype(f32)


def _splat_ordered(cx, cy, radius, rgb, width: int, height: int):
    """The splat of ``nbody_splat_points`` and R1: each pixel the float32
    sum, from 0, of its terms in ascending point index, each added as
    fma(c, fall, acc) with c = rgb·α rounded on its own → (H·W, 3)
    float32. The (pixel, point) pairs are sorted by pixel then point;
    each pair's rank within its pixel orders the loop, so one pass adds
    the rank-k term of every pixel at once."""
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
        dy, dx, _, f = _disc(r, fused=True)
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


def _splat_indexed(cx, cy, radius, rgb, width: int, height: int, acc_t):
    """The splat with each float32 term rgb·α·fall rounded on its own and
    added with ``index_put_`` in an ``acc_t`` image → (H·W, 3)."""
    dev = cx.device
    img = torch.zeros((height * width, 3), dtype=acc_t, device=dev)
    for r in range(1, MAX_RADIUS + 1):
        sel = radius == r
        dy, dx, alpha, fall = _disc(r)
        cr = rgb[sel] * torch.tensor(alpha, device=dev)
        val = cr[:, None, :] * torch.from_numpy(fall).to(dev)[None, :, None]
        uy = cy[sel][:, None] + torch.from_numpy(dy).to(dev)[None, :]
        ux = cx[sel][:, None] + torch.from_numpy(dx).to(dev)[None, :]
        ok = (ux >= 0) & (ux < width) & (uy >= 0) & (uy < height)
        img.index_put_(((uy * width + ux)[ok],), val[ok].to(acc_t),
                       accumulate=True)
    return img


def render_points_plain(pos, vel, camera, *, width: int, height: int,
                        point_size: float, mode: ColorMode,
                        uint8: bool = False, sprites: bool = False,
                        accumulate: str = "f32") -> Rendered:
    """Plain twin of kernel R1. ``camera`` gives ``project``; ``vel`` may
    be None (zeros). ``accumulate`` is the splat's sum: "ordered" (each
    pixel's terms in point order with the kernel's two float32 FMAs: R1's
    and the JAX renderer's native image, bit for bit), "f32" (the float32
    terms added with ``index_put_``) or "f64" (those terms summed in
    float64, then cast)."""
    from nbody_tpu_torch.render.color import ColorMapper

    render_points_plain.calls += 1
    if accumulate not in ("ordered", "f32", "f64"):
        raise ValueError(f"accumulate must be 'ordered', 'f32' or 'f64', "
                         f"got {accumulate!r}")
    dev, n = pos.device, pos.shape[0]
    ndc, view_z, in_front = camera.project(pos)
    vis = (in_front & (ndc[:, 0].abs() < CULL_NDC)
           & (ndc[:, 1].abs() < CULL_NDC))
    ndc, view_z = ndc[vis], view_z[vis]
    v = (vel[vis] if vel is not None
         else torch.zeros((ndc.shape[0], 3), dtype=pos.dtype, device=dev))
    rgb = ColorMapper(mode)(view_z, v).to(torch.float32)
    px = ((ndc[:, 0] * 0.5 + 0.5) * (width - 1)).to(torch.float32)
    py = ((1.0 - (ndc[:, 1] * 0.5 + 0.5)) * (height - 1)).to(torch.float32)
    size = (torch.full_like(view_z, point_size * SIZE_SCALE)
            / view_z.clamp(min=MIN_DEPTH)).clamp(MIN_SIZE, MAX_SIZE)
    size = size.to(torch.float32)

    cx, cy = _round_half_away(px), _round_half_away(py)
    radius = _round_half_away(size * 0.5).clamp(min=1)
    if accumulate == "ordered":
        img = _splat_ordered(cx, cy, radius, rgb, width, height)
    else:
        acc_t = torch.float64 if accumulate == "f64" else torch.float32
        img = _splat_indexed(cx, cy, radius, rgb, width, height, acc_t)
    img = img.to(torch.float32).clamp(0.0, 1.0).reshape(height, width, 3)
    u8 = (img * 255).to(torch.uint8) if uint8 else None
    out_sprites = None
    if sprites:
        full = torch.zeros((3, n), dtype=torch.float32, device=dev)
        full[:, vis] = torch.stack([px, py, size])
        full_rgb = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        full_rgb[vis] = rgb
        out_sprites = (full[0], full[1], full[2], full_rgb)
    return Rendered(img, u8, out_sprites)


render_points_plain.calls = 0


def tile_counts(px, py, size, *, width: int, height: int) -> torch.Tensor:
    """R1's list length of each ``TILE``-pixel screen tile, (tiles_y,
    tiles_x) int64, for sprites (px, py, size; size 0 = not visible): a
    visible sprite enters each tile that its disc's bounding box, clipped
    to the image, touches. The sum is the list entries of a call."""
    tx_n, ty_n = -(-width // TILE), -(-height // TILE)
    vis = size > 0
    cx, cy = _round_half_away(px[vis]), _round_half_away(py[vis])
    r = _round_half_away(size[vis] * 0.5).clamp(min=1)
    x0, x1 = (cx - r).clamp(min=0), (cx + r).clamp(max=width - 1)
    y0, y1 = (cy - r).clamp(min=0), (cy + r).clamp(max=height - 1)
    hit = (x0 <= x1) & (y0 <= y1)
    x0, x1, y0, y1 = (a[hit] // TILE for a in (x0, x1, y0, y1))
    counts = torch.zeros(ty_n * tx_n, dtype=torch.int64, device=px.device)
    side = (2 * MAX_RADIUS - 1) // TILE + 2  # tiles a box spans, at most
    for dy in range(side):
        for dx in range(side):
            ok = (y0 + dy <= y1) & (x0 + dx <= x1)
            counts.index_add_(0, ((y0 + dy) * tx_n + x0 + dx)[ok],
                              torch.ones_like(x0[ok]))
    return counts.reshape(ty_n, tx_n)


@_build.counted
def render_points(pos, vel, camera, *, width: int, height: int,
                  point_size: float, mode: ColorMode, uint8: bool = False,
                  sprites: bool = False) -> Rendered:
    """Kernel R1 (``csrc/render.cu``): a pass over the points that
    projects, culls and sizes them, reduces the colour key's range and
    counts each screen tile's sprites by index chunk; a scan of the
    counts; a pass that colours each visible point and lists it in every
    tile it touches; a block per tile that sorts its list by point index
    in shared memory and sums each pixel's terms in that order (a second
    kernel takes the lists longer than shared memory holds), then writes
    the clamped image and the uint8 copy once. The image equals
    ``render_points_plain(..., accumulate="ordered")`` bit for bit. ``vel``
    is read in VELOCITY mode only (may be None otherwise). CPU tensors
    take that plain twin; CUDA tensors launch the kernel or raise."""
    if pos.device.type == "cpu":
        return render_points_plain(pos, vel, camera, width=width,
                                   height=height, point_size=point_size,
                                   mode=mode, uint8=uint8, sprites=sprites,
                                   accumulate="ordered")
    _build.require_cuda(pos, "render_points")
    dev, n = pos.device, pos.shape[0]
    _build.check(pos, "pos", (n, 3), dev)
    mode = ColorMode(mode)
    if mode == ColorMode.VELOCITY:
        _build.check(vel, "vel", (n, 3), dev)
    if not (1 <= width <= MAX_SIDE and 1 <= height <= MAX_SIDE):
        raise ValueError(f"image size {width}x{height}")
    if n >= 1 << 27:
        raise ValueError(f"render_points: {n} points, at most 2^27 - 1")
    # P·V, then V, row-major: the kernel reads the clip rows x, y, w and
    # the view row z
    view = camera.view_matrix
    mats = np.ascontiguousarray(np.concatenate(
        [(camera.projection_matrix @ view).ravel(), view.ravel()]),
        dtype=np.float64)
    img = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    u8 = (torch.empty((height, width, 3), dtype=torch.uint8, device=dev)
          if uint8 else None)
    pts = torch.empty((3, n), dtype=torch.float32, device=dev)
    key = torch.empty(n, dtype=torch.float64, device=dev)
    rgb = (torch.empty((n, 3), dtype=torch.float32, device=dev)
           if sprites else None)
    rec = torch.empty((n, 4), dtype=torch.float32, device=dev)
    n_tiles = -(-width // TILE) * -(-height // TILE)
    chunks = list_chunks(n_tiles)
    # the key range and the tiles' counts, first entries and fill cursors
    meta = torch.empty(_scratch(chunks, n_tiles, 1), dtype=torch.int32,
                       device=dev)
    # the tiles' lists, and the long-list kernel's partition of them: sized
    # from n alone (no count read back, so a call can be graph-captured),
    # n·9 int32 each; the second is touched only by a list past 2048
    lists = torch.empty((2, n * _scratch(chunks, 1, 0)), dtype=torch.int32,
                        device=dev)
    _build.launch(
        "nbt_render_points", dev, pos.data_ptr(),
        vel.data_ptr() if mode == ColorMode.VELOCITY else None, n,
        mats.ctypes.data, camera.near * 0.5, point_size * SIZE_SCALE,
        int(mode), width, height, chunks, img.data_ptr(),
        _build.ptr(u8), pts.data_ptr(), key.data_ptr(), _build.ptr(rgb),
        rec.data_ptr(), meta.data_ptr(), lists[0].data_ptr(),
        lists[1].data_ptr(),
    )
    render_points.launches += 1
    out_sprites = (pts[0], pts[1], pts[2], rgb) if sprites else None
    return Rendered(img, u8, out_sprites)


def list_chunks(n_tiles: int) -> int:
    """R1's index-range chunks a tile: ``MAX_CHUNKS``, halved while the
    counters (tiles × chunks) pass 2^20. A tile's list is then the runs of
    its chunks in chunk order, each sorted alone."""
    chunks = MAX_CHUNKS
    while chunks > 1 and n_tiles * chunks > 1 << 20:
        chunks //= 2
    return chunks


def _scratch(chunks: int, n_tiles: int, field: int) -> int:
    """The library's scratch size (``nbt_render_scratch``): list entries
    a sprite makes at most (field 0) or the meta buffer's ints (field 1),
    cached."""
    at = (chunks, n_tiles, field)
    if at not in _scratch.cache:
        got = _build.library().nbt_render_scratch(*at)
        if got < 0:
            raise ValueError(f"render_points: {chunks} chunks, {n_tiles} "
                             f"tiles")
        _scratch.cache[at] = got
    return _scratch.cache[at]


_scratch.cache = {}
