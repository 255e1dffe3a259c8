"""Orbit camera.

PyTorch-package counterpart of ``nbody_tpu/render/camera.py``: a
spherical-coordinate orbit with the gimbal clamp, pan, zoom clamped to
[1, 1000], reset, and lazily cached view and projection matrices (float64
NumPy on the host, glm's lookAt / perspective conventions).

``project`` takes NumPy arrays or tensors. A tensor is projected on its own
device in float64, each homogeneous product summed in index order
((x·m0 + y·m1) + z·m2) + m3, every operation rounded on its own; the
splat kernel (``csrc/render.cu``) repeats that order, so the two place a
point identically.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MIN_DISTANCE = 1.0
_MAX_DISTANCE = 1000.0
_GIMBAL_EPS = 0.01


def _row(x, y, z, m):
    """((x·m0 + y·m1) + z·m2) + m3 for one matrix row ``m`` (Python
    floats), the order of ``hom @ m`` with hom = (x, y, z, 1)."""
    return x * m[0] + y * m[1] + z * m[2] + m[3]


class Camera:
    """Orbit camera around a target point."""

    def __init__(
        self,
        distance: float = 50.0,
        azimuth: float = 0.0,
        elevation: float = 0.3,
        target=(0.0, 0.0, 0.0),
        fov_deg: float = 45.0,
        aspect: float = 16.0 / 9.0,
        near: float = 0.1,
        far: float = 2000.0,
    ):
        self._init = (distance, azimuth, elevation, tuple(target))
        self.distance = distance
        self.azimuth = azimuth
        self.elevation = elevation
        self.target = np.asarray(target, np.float64)
        self.fov_deg = fov_deg
        self.aspect = aspect
        self.near = near
        self.far = far
        self._view = None
        self._proj = None

    # ---- controls ----------------------------------------------------------

    def rotate(self, d_azimuth: float, d_elevation: float) -> None:
        """Orbit, the elevation clamped short of the poles."""
        self.azimuth = (self.azimuth + d_azimuth) % (2.0 * math.pi)
        self.elevation = float(
            np.clip(
                self.elevation + d_elevation,
                -math.pi / 2 + _GIMBAL_EPS,
                math.pi / 2 - _GIMBAL_EPS,
            )
        )
        self._dirty()

    def pan(self, dx: float, dy: float) -> None:
        """Translate the target in the view plane."""
        right, up, _ = self._basis()
        scale = self.distance * 0.002
        self.target = self.target + (-dx * right + dy * up) * scale
        self._dirty()

    def zoom(self, delta: float) -> None:
        """Dolly, the distance clamped to [1, 1000]."""
        self.distance = float(
            np.clip(
                self.distance * math.exp(-delta * 0.1),
                _MIN_DISTANCE,
                _MAX_DISTANCE,
            )
        )
        self._dirty()

    def reset(self) -> None:
        d, a, e, t = self._init
        self.distance, self.azimuth, self.elevation = d, a, e
        self.target = np.asarray(t, np.float64)
        self._dirty()

    # ---- matrices (lazily cached) ------------------------------------------

    @property
    def position(self) -> np.ndarray:
        ce, se = math.cos(self.elevation), math.sin(self.elevation)
        ca, sa = math.cos(self.azimuth), math.sin(self.azimuth)
        offset = np.array([ce * ca, se, ce * sa]) * self.distance
        return self.target + offset

    def _basis(self):
        eye = self.position
        fwd = self.target - eye
        fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
        world_up = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, world_up)
        nr = np.linalg.norm(right)
        if nr < 1e-9:
            right = np.array([1.0, 0.0, 0.0])
        else:
            right = right / nr
        up = np.cross(right, fwd)
        return right, up, fwd

    def _dirty(self):
        self._view = None
        self._proj = None

    @property
    def view_matrix(self) -> np.ndarray:
        """Right-handed lookAt (glm convention)."""
        if self._view is None:
            eye = self.position
            right, up, fwd = self._basis()
            m = np.eye(4)
            m[0, :3] = right
            m[1, :3] = up
            m[2, :3] = -fwd
            m[0, 3] = -right @ eye
            m[1, 3] = -up @ eye
            m[2, 3] = fwd @ eye
            self._view = m
        return self._view

    @property
    def projection_matrix(self) -> np.ndarray:
        """Right-handed perspective (glm convention, -1..1 clip z)."""
        if self._proj is None:
            f = 1.0 / math.tan(math.radians(self.fov_deg) / 2.0)
            m = np.zeros((4, 4))
            m[0, 0] = f / self.aspect
            m[1, 1] = f
            m[2, 2] = (self.far + self.near) / (self.near - self.far)
            m[2, 3] = 2.0 * self.far * self.near / (self.near - self.far)
            m[3, 2] = -1.0
            self._proj = m
        return self._proj

    def project(self, points):
        """World → (ndc xy, view-space depth, in-front mask) of (N, 3)
        points: NumPy in, NumPy out; a tensor in, float64 tensors on its
        device out."""
        if not isinstance(points, torch.Tensor):
            ndc, view_z, in_front = self.project(
                torch.from_numpy(np.asarray(points)))
            return ndc.numpy(), view_z.numpy(), in_front.numpy()
        pv = (self.projection_matrix @ self.view_matrix).tolist()
        view = self.view_matrix.tolist()
        p = points.to(torch.float64)
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        w = _row(x, y, z, pv[3])
        in_front = w > self.near * 0.5
        w_safe = torch.where(in_front, w, torch.ones_like(w))
        ndc = torch.stack([_row(x, y, z, pv[0]) / w_safe,
                           _row(x, y, z, pv[1]) / w_safe], dim=1)
        view_z = -_row(x, y, z, view[2])  # positive depth in front
        return ndc, view_z, in_front
