"""nbody_tpu_torch — the N-body engine on PyTorch and hand-written CUDA
kernels for NVIDIA Hopper (H100).

A port of ``nbody_tpu`` (JAX on TPU), which stays beside it as the
reference. This package imports ``torch`` and never ``jax`` or
``nbody_tpu``. Ported so far: the configuration and state types, the
uniform, spherical, disk and Plummer initializers and the composite scenes
(``models``), direct N², Barnes-Hut (tiles and window near engines;
quadrupole, or monopole sources on request) and spatial-hash (window and
tiles engines) forces, Velocity Verlet with cell-sorted, frozen-grid and
table-resident stepping, energies (the exact all-pairs potential), the
energy-drift measurement (``drift.run_drift``), the bitonic sort
(``ops.sort``), the ``ParticleSystem`` facade with its live setters,
``.nbody`` and HDF5 state IO (``utils``), rendering on the card
(``render``: camera, colours, the point renderer, the point stream, the
terminal view), and the application entry point (``python -m
nbody_tpu_torch.cli``, ``app.Application``). The CUDA
kernels (``csrc/``) build on first use; see ``ops/_build.py``.
"""

__version__ = "0.1.0"

from nbody_tpu_torch.errors import (
    ResourceError,
    SerializationError,
    ValidationError,
)
from nbody_tpu_torch.state import (
    ParticleState,
    SimulationState,
    config_from_reference,
)
from nbody_tpu_torch.system import ParticleSystem
from nbody_tpu_torch.types import (
    DiskDistParams,
    ForceMethod,
    InitDistribution,
    PlummerDistParams,
    SimulationConfig,
    SphericalDistParams,
    UniformDistParams,
)

__all__ = [
    "DiskDistParams",
    "ForceMethod",
    "InitDistribution",
    "ParticleState",
    "ParticleSystem",
    "PlummerDistParams",
    "ResourceError",
    "SerializationError",
    "SimulationConfig",
    "SimulationState",
    "SphericalDistParams",
    "UniformDistParams",
    "ValidationError",
    "config_from_reference",
]
