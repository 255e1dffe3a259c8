"""Color mapping for particle rendering.

PyTorch-package counterpart of ``nbody_tpu/render/color.py``: three modes,
DEPTH (warm → cool with camera distance), VELOCITY (blue → red with
speed) and DENSITY (sparse → dense gradient), on float64 tensors on the
inputs' device. The gradient endpoints are the JAX package's; the splat
kernel (``csrc/render.cu``) carries the same constants and arithmetic.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.types import ColorMode

# Gradient endpoints: (start, end) of each mode's ramp.
WARM = (1.0, 0.65, 0.3)
COOL = (0.3, 0.45, 1.0)
SLOW = (0.2, 0.35, 1.0)
FAST = (1.0, 0.25, 0.15)
SPARSE = (0.25, 0.65, 0.35)
DENSE = (1.0, 0.95, 0.4)

# Below this key range every row takes the ramp's start.
FLAT_RANGE = 1e-12


def _lerp(a, b, t: torch.Tensor) -> torch.Tensor:
    """a·(1 − t) + b·t per row, t clipped to [0, 1] → (N, 3) float64
    (1 − t in t's precision, the rest in float64)."""
    t = t.clamp(0.0, 1.0)[:, None]
    a = torch.tensor(a, dtype=torch.float64, device=t.device)
    b = torch.tensor(b, dtype=torch.float64, device=t.device)
    return a[None, :] * (1.0 - t) + b[None, :] * t


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """(v − min) / (max − min) over the rows given; zeros when the range
    is below ``FLAT_RANGE``. No host read. A float32 key is normalised in
    float32 as NumPy does it with Python-float bounds (the range taken in
    float64, then rounded to float32 for the division); any other in
    float64."""
    if v.dtype != torch.float32:
        v = v.to(torch.float64)
    if v.numel() == 0:
        return v
    lo, hi = v.min(), v.max()
    span = hi.to(torch.float64) - lo.to(torch.float64)
    return torch.where(span < FLAT_RANGE, torch.zeros_like(v),
                       (v - lo) / span.to(v.dtype))


def speed(velocities: torch.Tensor) -> torch.Tensor:
    """|v| in the velocities' precision, as ``np.linalg.norm`` gives it
    (float32 for the simulation's float32 state, else float64), summed
    in the kernel's order: √((x² + y²) + z²)."""
    v = velocities
    if v.dtype != torch.float32:
        v = v.to(torch.float64)
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    # float32: the square root taken in float64 and rounded once is the
    # correctly rounded one (PyTorch's CPU float32 sqrt is not, always)
    return torch.sqrt((x * x + y * y + z * z).to(torch.float64)).to(v.dtype)


class ColorMapper:
    """Gradient mapping of per-point keys to RGB."""

    def __init__(self, mode: ColorMode = ColorMode.DEPTH):
        self.mode = mode

    def map_depth(self, view_z: torch.Tensor) -> torch.Tensor:
        """Close = warm, far = cool."""
        return _lerp(WARM, COOL, _normalize(view_z))

    def map_velocity(self, velocities: torch.Tensor) -> torch.Tensor:
        """Slow = blue, fast = red."""
        return _lerp(SLOW, FAST, _normalize(speed(velocities)))

    def map_density(self, density_proxy: torch.Tensor) -> torch.Tensor:
        return _lerp(SPARSE, DENSE, _normalize(density_proxy))

    def __call__(self, view_z: torch.Tensor, velocities: torch.Tensor,
                 density: torch.Tensor | None = None) -> torch.Tensor:
        """RGB (N, 3) float64 by the current mode. DENSITY without a
        density input maps every row to the ramp's start, as the JAX
        package does."""
        if self.mode == ColorMode.VELOCITY:
            return self.map_velocity(velocities)
        if self.mode == ColorMode.DENSITY:
            d = density if density is not None else torch.zeros_like(view_z)
            return self.map_density(d)
        return self.map_depth(view_z)
