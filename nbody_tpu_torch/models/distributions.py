"""Particle initializers.

PyTorch counterpart of ``nbody_tpu/models/distributions.py`` for the
uniform box and the uniform-in-volume sphere. Each initializer draws from
an explicit ``torch.Generator``, so a run is deterministic by seed; the
bits differ from ``jax.random``'s, so the two packages agree in
distribution, not value by value. All initializers return a state with
zero accelerations.
"""

from __future__ import annotations

import math

import torch

from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.types import (
    InitDistribution,
    SimulationConfig,
    SphericalDistParams,
    UniformDistParams,
)


def _uniform(generator, shape, device):
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=device)


def _mass(generator, n, min_mass, max_mass, device):
    if min_mass == max_mass:
        return torch.full((n,), min_mass, dtype=torch.float32, device=device)
    return _uniform(generator, (n,), device) * (max_mass - min_mass) + min_mass


def _finish(pos, vel, mass) -> ParticleState:
    return ParticleState(
        pos=pos,
        vel=vel,
        acc=torch.zeros_like(pos),
        mass=mass,
        time=torch.zeros((), dtype=torch.float32, device=pos.device),
    )


def _device(generator: torch.Generator, device) -> torch.device:
    device = torch.device(device) if device is not None else generator.device
    if device.type != generator.device.type:
        raise ValueError(
            f"generator lives on {generator.device}, tensors requested on "
            f"{device}: create the generator on the target device"
        )
    return device


def init_uniform(
    generator: torch.Generator,
    n: int,
    params: UniformDistParams = UniformDistParams(),
    *,
    device: torch.device | str | None = None,
) -> ParticleState:
    """Uniform box: positions ~ U[min_bounds, max_bounds], v = 0."""
    device = _device(generator, device)
    lo = torch.tensor(params.min_bounds, dtype=torch.float32, device=device)
    hi = torch.tensor(params.max_bounds, dtype=torch.float32, device=device)
    pos = _uniform(generator, (n, 3), device) * (hi - lo) + lo
    vel = torch.zeros((n, 3), dtype=torch.float32, device=device)
    mass = _mass(generator, n, params.min_mass, params.max_mass, device)
    return _finish(pos, vel, mass)


def init_spherical(
    generator: torch.Generator,
    n: int,
    params: SphericalDistParams = SphericalDistParams(),
    *,
    device: torch.device | str | None = None,
) -> ParticleState:
    """Uniform-in-volume sphere: r = cbrt(u)·R, isotropic angles, v = 0."""
    device = _device(generator, device)
    u = _uniform(generator, (n,), device)
    r = torch.pow(u, 1.0 / 3.0) * params.radius
    theta = _uniform(generator, (n,), device) * (2.0 * math.pi)
    cos_phi = _uniform(generator, (n,), device) * 2.0 - 1.0
    sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
    center = torch.tensor(params.center, dtype=torch.float32, device=device)
    pos = center + r[:, None] * torch.stack(
        [sin_phi * torch.cos(theta), sin_phi * torch.sin(theta), cos_phi],
        dim=-1,
    )
    vel = torch.zeros((n, 3), dtype=torch.float32, device=device)
    mass = _mass(generator, n, params.min_mass, params.max_mass, device)
    return _finish(pos, vel, mass)


_PARAM_TYPES = {
    InitDistribution.UNIFORM: UniformDistParams,
    InitDistribution.SPHERICAL: SphericalDistParams,
}


def init_from_config(
    config: SimulationConfig, *, device: torch.device | str
) -> ParticleState:
    """Dispatch on ``config.init_distribution`` with a generator seeded
    from ``config.seed`` on ``device``, honoring ``config.dist_params``."""
    from nbody_tpu_torch.errors import ValidationError

    dist = config.init_distribution
    if dist not in _PARAM_TYPES:
        raise NotImplementedError(
            f"init distribution {dist.name} is not ported to "
            "nbody_tpu_torch yet (ROADMAP A4)"
        )
    want = _PARAM_TYPES[dist]
    params = config.dist_params if config.dist_params is not None else want()
    if not isinstance(params, want):
        raise ValidationError(
            f"dist_params type {type(params).__name__} does not match "
            f"init distribution {dist.name} (expected {want.__name__})"
        )
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(config.seed)
    n = config.particle_count
    if dist == InitDistribution.UNIFORM:
        return init_uniform(gen, n, params, device=device)
    return init_spherical(gen, n, params, device=device)
