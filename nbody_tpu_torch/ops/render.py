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
3. the colour key (view z for DEPTH, |v| for VELOCITY, none for DENSITY)
   normalised by its min and max over the visible points, the ramp
   interpolated in float64 and cast to float32 (``render/color.py``);
4. a disc of radius r = max(1, round(size/2)) around (round(px),
   round(py)), rounding half away from zero, adds rgb·α·(1 − 0.6·d²/r²)
   to each pixel inside the image, α = min(1, 1.5/r²), in float32;
5. the image clamped to [0, 1]; optionally a uint8 copy, (img·255)
   truncated.

``render_points`` is the wrapper of ``csrc/render.cu``; its float atomics
add in no fixed order, so it is held to ``render_points_plain`` run with
``accumulate="f64"`` (the same float32 terms summed in float64, then
cast) within 1e-5, the JAX package's own tolerance between its NumPy and
native splats; coordinates, sizes and colours are held bit for bit.
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


def _disc(r: int):
    """The offsets (dy, dx) of radius ``r``'s disc (d² ≤ r²), row-major,
    and each one's weight α·(1 − 0.6·d²·(1/r²)), rounded in float32 one
    operation at a time as the C++ and CUDA splats round them."""
    f32 = np.float32
    alpha = min(f32(1.0), f32(1.5) / f32(r * r))
    inv_r2 = f32(1.0) / f32(r * r)
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    keep = dy * dy + dx * dx <= r * r
    dy, dx = dy[keep], dx[keep]
    d2 = (dy * dy + dx * dx).astype(f32)
    fall = f32(1.0) - (f32(0.6) * d2) * inv_r2
    return dy, dx, alpha, fall.astype(f32)


def render_points_plain(pos, vel, camera, *, width: int, height: int,
                        point_size: float, mode: ColorMode,
                        uint8: bool = False, sprites: bool = False,
                        accumulate: str = "f32") -> Rendered:
    """Plain twin of kernel R1. ``camera`` gives ``project``; ``vel`` may
    be None (zeros). ``accumulate`` is the splat's sum type: "f32" or
    "f64" (the reference the kernel is held to)."""
    from nbody_tpu_torch.render.color import ColorMapper

    render_points_plain.calls += 1
    if accumulate not in ("f32", "f64"):
        raise ValueError(f"accumulate must be 'f32' or 'f64', got "
                         f"{accumulate!r}")
    dev, n = pos.device, pos.shape[0]
    acc_t = torch.float64 if accumulate == "f64" else torch.float32
    img = torch.zeros((height * width, 3), dtype=acc_t, device=dev)
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


def render_points(pos, vel, camera, *, width: int, height: int,
                  point_size: float, mode: ColorMode, uint8: bool = False,
                  sprites: bool = False) -> Rendered:
    """Kernel R1 (``csrc/render.cu``): a pass over the points that
    projects, culls and sizes them and reduces the colour key's range, a
    pass that colours each visible point and splats its disc with float
    atomics, and a pass that clamps the image (and writes the uint8 copy).
    ``vel`` is read in VELOCITY mode only (may be None otherwise).
    CPU tensors take the plain twin; CUDA tensors launch the kernel or
    raise."""
    if pos.device.type == "cpu":
        return render_points_plain(pos, vel, camera, width=width,
                                   height=height, point_size=point_size,
                                   mode=mode, uint8=uint8, sprites=sprites)
    _build.require_cuda(pos, "render_points")
    dev, n = pos.device, pos.shape[0]
    _build.check(pos, "pos", (n, 3), dev)
    mode = ColorMode(mode)
    if mode == ColorMode.VELOCITY:
        _build.check(vel, "vel", (n, 3), dev)
    if width < 1 or height < 1:
        raise ValueError(f"image size {width}x{height}")
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
    key_range = torch.empty(2, dtype=torch.int64, device=dev)
    _build.launch(
        "nbt_render_points", dev, pos.data_ptr(),
        vel.data_ptr() if mode == ColorMode.VELOCITY else None, n,
        mats.ctypes.data, camera.near * 0.5, point_size * SIZE_SCALE,
        int(mode), width, height, img.data_ptr(), _build.ptr(u8),
        pts.data_ptr(), key.data_ptr(), _build.ptr(rgb),
        key_range.data_ptr(),
    )
    render_points.launches += 1
    out_sprites = (pts[0], pts[1], pts[2], rgb) if sprites else None
    return Rendered(img, u8, out_sprites)


render_points.launches = 0
