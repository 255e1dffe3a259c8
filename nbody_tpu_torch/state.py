"""Simulation state containers.

``ParticleState`` is the device-side state: a dataclass of (N, 3)/(N,)
float32 tensors and a 0-d float32 time, all on one device.
``SimulationState`` is the host-side snapshot (numpy arrays), with the same
tolerant equality as the JAX package's.

The carry-across helpers (``ParticleState.from_numpy``/``to_numpy`` and
``config_from_reference``) move a state or a configuration between this
package and any object shaped like the JAX package's, without importing
it: the tests feed both packages the same inputs through them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from nbody_tpu_torch.types import (
    DiskDistParams,
    ForceMethod,
    InitDistribution,
    PlummerDistParams,
    SimulationConfig,
    SphericalDistParams,
    UniformDistParams,
)


@dataclasses.dataclass
class ParticleState:
    """Device-side particle state.

    Attributes:
      pos:  (N, 3) float32 positions
      vel:  (N, 3) float32 velocities
      acc:  (N, 3) float32 accelerations at the current time
      mass: (N,)   float32 masses
      time: ()     float32 simulation time
    """

    pos: torch.Tensor
    vel: torch.Tensor
    acc: torch.Tensor
    mass: torch.Tensor
    time: torch.Tensor

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    @staticmethod
    def from_numpy(
        pos, vel, acc=None, mass=None, time=0.0, *, device: torch.device | str
    ) -> "ParticleState":
        """Build a state on ``device`` from host arrays (float32)."""
        pos = np.asarray(pos, np.float32).reshape(-1, 3)
        n = pos.shape[0]

        def t(a, shape):
            return torch.tensor(
                np.asarray(a, np.float32).reshape(shape), device=device
            )

        return ParticleState(
            pos=t(pos, (n, 3)),
            vel=t(vel, (n, 3)),
            acc=t(np.zeros((n, 3)) if acc is None else acc, (n, 3)),
            mass=t(np.ones((n,)) if mass is None else mass, (n,)),
            time=t(time, ()),
        )

    def to_numpy(self) -> dict:
        """Host copy: ``dict(pos, vel, acc, mass, time)`` with float32
        arrays and a float time — the keyword arguments of ``from_numpy``."""
        return dict(
            pos=self.pos.detach().cpu().numpy(),
            vel=self.vel.detach().cpu().numpy(),
            acc=self.acc.detach().cpu().numpy(),
            mass=self.mass.detach().cpu().numpy(),
            time=float(self.time),
        )


@dataclasses.dataclass
class SimulationState:
    """Host-side snapshot for checkpoint and interchange (accelerations are
    not stored: resuming recomputes forces, which is exact for Verlet)."""

    pos: np.ndarray
    vel: np.ndarray
    mass: np.ndarray
    particle_count: int = 0
    simulation_time: float = 0.0
    dt: float = 1e-3
    G: float = 1.0
    softening: float = 0.1
    force_method: ForceMethod = ForceMethod.DIRECT_N2

    def __post_init__(self):
        self.pos = np.asarray(self.pos, dtype=np.float32).reshape(-1, 3)
        self.vel = np.asarray(self.vel, dtype=np.float32).reshape(-1, 3)
        self.mass = np.asarray(self.mass, dtype=np.float32).reshape(-1)
        if self.particle_count == 0:
            self.particle_count = self.pos.shape[0]

    _SCALAR_TOL = 1e-6
    _ARRAY_TOL = 1e-6

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, SimulationState):
            return NotImplemented
        if self.particle_count != other.particle_count:
            return False
        if self.force_method != other.force_method:
            return False
        for a, b in (
            (self.simulation_time, other.simulation_time),
            (self.dt, other.dt),
            (self.G, other.G),
            (self.softening, other.softening),
        ):
            if abs(a - b) > self._SCALAR_TOL:
                return False
        for a, b in ((self.pos, other.pos), (self.vel, other.vel),
                     (self.mass, other.mass)):
            if a.shape != b.shape:
                return False
            if a.size and not np.allclose(a, b, atol=self._ARRAY_TOL, rtol=0):
                return False
        return True

    def __hash__(self):
        return id(self)

    def to_particle_state(
        self, device: torch.device | str, acc: Optional[np.ndarray] = None
    ) -> ParticleState:
        return ParticleState.from_numpy(
            self.pos, self.vel, acc, self.mass, self.simulation_time,
            device=device,
        )

    @staticmethod
    def from_particle_state(
        state: ParticleState,
        dt: float,
        G: float,
        softening: float,
        force_method: ForceMethod,
    ) -> "SimulationState":
        h = state.to_numpy()
        return SimulationState(
            pos=h["pos"],
            vel=h["vel"],
            mass=h["mass"],
            particle_count=state.n,
            simulation_time=h["time"],
            dt=dt,
            G=G,
            softening=softening,
            force_method=force_method,
        )


_DIST_PARAMS = {
    cls.__name__: cls
    for cls in (UniformDistParams, SphericalDistParams, DiskDistParams,
                PlummerDistParams)
}
_ENUMS = {"force_method": ForceMethod, "init_distribution": InitDistribution}


def config_from_reference(obj) -> SimulationConfig:
    """This package's ``SimulationConfig`` from any object carrying the
    JAX package's config attribute names (duck-typed: nothing of the JAX
    package is imported). Enums map by ``.name``; ``dist_params`` maps by
    class name onto this package's distribution parameter types."""
    kw = {}
    for f in dataclasses.fields(SimulationConfig):
        if not hasattr(obj, f.name):
            continue
        v = getattr(obj, f.name)
        if f.name in _ENUMS:
            v = _ENUMS[f.name][v.name]
        elif f.name == "dist_params" and v is not None:
            cls = _DIST_PARAMS[type(v).__name__]
            v = cls(**{g.name: getattr(v, g.name)
                       for g in dataclasses.fields(cls)})
        kw[f.name] = v
    return SimulationConfig(**kw)
