"""nbody_tpu_torch — the N-body engine on PyTorch and hand-written CUDA
kernels for NVIDIA Hopper (H100).

A port of ``nbody_tpu`` (JAX on TPU), which stays beside it as the
reference. This package imports ``torch`` and never ``jax`` or
``nbody_tpu``. Ported so far: the configuration and state types, the
uniform and spherical initializers, direct N², Barnes-Hut (tiles and
window near engines; quadrupole, or monopole sources on request) and
spatial-hash (window and tiles engines) forces, Velocity Verlet with
cell-sorted stepping and the frozen-grid re-sort cadence and audited
re-sort, energies (the exact all-pairs potential), the energy-drift
measurement (``drift.run_drift``), the bitonic sort (``ops.sort``) and the
``ParticleSystem`` core. The CUDA kernels (``csrc/``) build on first use;
see ``ops/_build.py``.
"""

from nbody_tpu_torch.errors import ResourceError, ValidationError
from nbody_tpu_torch.state import (
    ParticleState,
    SimulationState,
    config_from_reference,
)
from nbody_tpu_torch.system import ParticleSystem
from nbody_tpu_torch.types import (
    ForceMethod,
    InitDistribution,
    SimulationConfig,
    SphericalDistParams,
    UniformDistParams,
)

__all__ = [
    "ForceMethod",
    "InitDistribution",
    "ParticleState",
    "ParticleSystem",
    "ResourceError",
    "SimulationConfig",
    "SimulationState",
    "SphericalDistParams",
    "UniformDistParams",
    "ValidationError",
    "config_from_reference",
]
