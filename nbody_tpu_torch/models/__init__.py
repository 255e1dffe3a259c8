"""Particle initializers and composite scenes."""

from nbody_tpu_torch.models.distributions import (
    init_disk,
    init_from_config,
    init_plummer,
    init_spherical,
    init_uniform,
    zero_accelerations,
    zero_velocities,
)
from nbody_tpu_torch.models.scenes import (
    galaxy_collision,
    spiral_galaxy,
    two_body_orbit,
)

__all__ = [
    "galaxy_collision",
    "init_disk",
    "init_from_config",
    "init_plummer",
    "init_spherical",
    "init_uniform",
    "spiral_galaxy",
    "two_body_orbit",
    "zero_accelerations",
    "zero_velocities",
]
