"""Particle initializers."""

from nbody_tpu_torch.models.distributions import (
    init_from_config,
    init_spherical,
    init_uniform,
)

__all__ = ["init_from_config", "init_spherical", "init_uniform"]
