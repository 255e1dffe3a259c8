"""Point-sprite renderer.

PyTorch-package counterpart of ``nbody_tpu/render/renderer.py``: the same
image, made where the points are. A CUDA tensor is projected, coloured and
splatted on the card by kernel R1 (``ops/render.py``,
``csrc/render.cu``); a CPU tensor goes through R1's plain twin. Perspective
point size ``point_size·30 / max(view z, 0.1)``, circular sprites with a
quadratic falloff, additive blending, the three ``ColorMapper`` modes.

``save_png`` writes a frame with the standard library alone (``zlib``,
``struct``, ``binascii``): 8-bit RGB, filter 0 on every row.
"""

from __future__ import annotations

import binascii
import dataclasses
import struct
import zlib

import numpy as np
import torch

from nbody_tpu_torch.ops import render as render_ops
from nbody_tpu_torch.render.camera import Camera
from nbody_tpu_torch.render.color import ColorMapper
from nbody_tpu_torch.types import ColorMode, RenderConfig
from nbody_tpu_torch.utils.profiling import profile_phase


def _as_points(a, device=None) -> torch.Tensor:
    """(N, 3) float32 tensor (the simulation's type) of an array or
    tensor, on ``device`` when given, else where it lies."""
    t = torch.as_tensor(a, device=device).to(torch.float32)
    return t.reshape(-1, 3).contiguous()


class PointRenderer:
    """Renders particles to an (H, W, 3) image through an orbit camera."""

    def __init__(self, config: RenderConfig = RenderConfig(),
                 camera: Camera | None = None):
        self.config = config
        self.camera = camera or Camera()
        self.camera.aspect = config.window_width / config.window_height
        self.color_mapper = ColorMapper(config.color_mode)

    def set_color_mode(self, mode: ColorMode) -> None:
        self.config = dataclasses.replace(self.config, color_mode=mode)
        self.color_mapper.mode = mode

    def on_resize(self, width: int, height: int) -> None:
        self.config = dataclasses.replace(self.config, window_width=width,
                                          window_height=height)
        self.camera.aspect = width / height
        self.camera._dirty()

    def _splat(self, positions, velocities, uint8: bool):
        pos = _as_points(positions)
        vel = (torch.zeros_like(pos) if velocities is None
               else _as_points(velocities, pos.device))
        c = self.config
        return render_ops.render_points(
            pos, vel, self.camera, width=c.window_width,
            height=c.window_height, point_size=c.point_size,
            mode=self.color_mapper.mode, uint8=uint8)

    def render(self, positions, velocities=None) -> torch.Tensor:
        """Points (N, 3), tensors or arrays, cast to float32 → (H, W, 3)
        float32 image in [0, 1] on the points' device."""
        return self._splat(positions, velocities, False).image

    def frame(self, positions, velocities=None) -> torch.Tensor:
        """The uint8 image ``save_png`` writes for ``render``'s image,
        (img·255) truncated, made on the points' device (the phase
        ``render.frame``)."""
        with profile_phase("render.frame",
                           device=getattr(positions, "device", None)):
            return self._splat(positions, velocities, True).image_u8

    @staticmethod
    def save_png(img, path: str) -> None:
        """Write an (H, W, 3) image as an 8-bit RGB PNG: a float image in
        [0, 1] as (img·255) truncated, a uint8 image as it is."""
        write_png(path, png_rows(img))


def png_rows(img) -> np.ndarray:
    """The PNG scanlines of an (H, W, 3) image: (H, 1 + 3·W) uint8, each
    row filter byte 0 then the row's RGB bytes; a float image in [0, 1]
    as (img·255) truncated. A copy: the image may be reused at once."""
    a = img.cpu().numpy() if isinstance(img, torch.Tensor) else img
    a = np.asarray(a)
    if a.dtype != np.uint8:
        a = (a * 255).astype(np.uint8)
    h, w, _ = a.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)
    rows[:, 1:] = a.reshape(h, 3 * w)
    return rows


def write_png(path: str, rows: np.ndarray) -> None:
    """Compress ``png_rows``' scanlines and write the PNG file."""
    h, w = rows.shape[0], (rows.shape[1] - 1) // 3

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", binascii.crc32(kind + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                             0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))
