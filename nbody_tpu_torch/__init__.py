"""nbody_tpu_torch — the N-body engine on PyTorch and hand-written CUDA
kernels for NVIDIA Hopper (H100).

A port of ``nbody_tpu`` (JAX on TPU), which stays beside it as the
reference. This package imports ``torch`` and never ``jax`` or
``nbody_tpu``. It ports all of it: the configuration and state types, the
uniform, spherical, disk and Plummer initializers and the composite scenes
(``models``), direct N², Barnes-Hut (tiles and window near engines;
quadrupole, or monopole sources on request) and spatial-hash (window and
tiles engines) forces, Velocity Verlet with cell-sorted, frozen-grid and
table-resident stepping, energies (the exact all-pairs potential), the
energy-drift measurement (``drift.run_drift``), the bitonic sort
(``ops.sort``), the ``ParticleSystem`` facade with its live setters,
``.nbody`` and HDF5 state IO (``utils``), rendering on the card
(``render``: camera, colours, the point renderer, the point stream, the
terminal view), the application entry point (``python -m
nbody_tpu_torch.cli``, ``app.Application``), sharding (``parallel``),
checkpoints, sorted-state stepping (``ops.integrator.SortedState``) and
Morton codes (``ops.morton``); the examples are in ``examples_torch/``.
The CUDA kernels (``csrc/``) build on first use; see ``ops/_build.py``.
"""

__version__ = "0.1.0"

from nbody_tpu_torch.errors import (
    NBodyError,
    ResourceError,
    SerializationError,
    ValidationError,
    validate_config,
    validate_particle_count,
    validate_softening,
    validate_theta,
    validate_time_step,
)
from nbody_tpu_torch.state import (
    ParticleState,
    SimulationState,
    config_from_reference,
)
from nbody_tpu_torch.system import ParticleSystem
from nbody_tpu_torch.types import (
    ColorMode,
    DiskDistParams,
    ForceMethod,
    InitDistribution,
    PlummerDistParams,
    RenderConfig,
    SimulationConfig,
    SphericalDistParams,
    UniformDistParams,
)

__all__ = [
    "ColorMode",
    "DiskDistParams",
    "ForceMethod",
    "InitDistribution",
    "NBodyError",
    "ParticleState",
    "ParticleSystem",
    "PlummerDistParams",
    "RenderConfig",
    "ResourceError",
    "SerializationError",
    "SimulationConfig",
    "SimulationState",
    "SphericalDistParams",
    "UniformDistParams",
    "ValidationError",
    "config_from_reference",
    "validate_config",
    "validate_particle_count",
    "validate_softening",
    "validate_theta",
    "validate_time_step",
    "__version__",
]
