"""Particle initializers.

PyTorch counterpart of ``nbody_tpu/models/distributions.py``: the uniform
box, the uniform-in-volume sphere, the rotating disk and the Plummer
sphere. Each initializer draws from
an explicit ``torch.Generator``, so a run is deterministic by seed; the
bits differ from ``jax.random``'s, so the two packages agree in
distribution, not value by value. All initializers return a state with
zero accelerations.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.types import (
    DiskDistParams,
    InitDistribution,
    PlummerDistParams,
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


def init_disk(
    generator: torch.Generator,
    n: int,
    params: DiskDistParams = DiskDistParams(),
    *,
    device: torch.device | str | None = None,
) -> ParticleState:
    """Rotating disk: r = sqrt(u)·R (uniform surface density), z uniform
    over the thickness, tangential velocity v = rotation_speed·sqrt(r)."""
    device = _device(generator, device)
    r = torch.sqrt(_uniform(generator, (n,), device)) * params.radius
    theta = _uniform(generator, (n,), device) * (2.0 * math.pi)
    z = (_uniform(generator, (n,), device) - 0.5) * params.thickness
    center = torch.tensor(params.center, dtype=torch.float32, device=device)
    ct, st = torch.cos(theta), torch.sin(theta)
    pos = center + torch.stack([r * ct, r * st, z], dim=-1)
    v = params.rotation_speed * torch.sqrt(r)
    vel = torch.stack([-v * st, v * ct, torch.zeros_like(v)], dim=-1)
    mass = _mass(generator, n, params.min_mass, params.max_mass, device)
    return _finish(pos, vel, mass)


def _iso_dirs(generator, n, device):
    cos_phi = _uniform(generator, (n,), device) * 2.0 - 1.0
    sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
    th = _uniform(generator, (n,), device) * (2.0 * math.pi)
    return torch.stack(
        [sin_phi * torch.cos(th), sin_phi * torch.sin(th), cos_phi], dim=-1)


# Candidates per particle of the Plummer speed draw (acceptance ≈ 0.1 /
# 0.0927 bound, so all 32 fail with probability < 1e-15).
PLUMMER_CANDIDATES = 32


def init_plummer(
    generator: torch.Generator,
    n: int,
    params: PlummerDistParams = PlummerDistParams(),
    G: float = 1.0,
    *,
    device: torch.device | str | None = None,
) -> ParticleState:
    """Plummer sphere with self-consistent isotropic velocities.

    Radius from the inverse CDF r = a·(u^{-2/3} − 1)^{-1/2}, u ~ U[1e-6, 1),
    truncated at ``max_radius_factor``·a; speed q·v_esc(r) with q drawn from
    pdf ∝ q²(1 − q²)^{7/2} (Aarseth-Hénon-Wielen) by a fixed draw of
    ``PLUMMER_CANDIDATES`` candidates a particle: the first accepted one,
    0.5 where none is. Equal masses summing to ``total_mass``."""
    device = _device(generator, device)
    a = params.scale_radius
    u = _uniform(generator, (n,), device) * (1.0 - 1e-6) + 1e-6
    r = a / torch.sqrt(u ** (-2.0 / 3.0) - 1.0)
    r = torch.clamp(r, max=a * params.max_radius_factor)
    center = torch.tensor(params.center, dtype=torch.float32, device=device)
    pos = center + r[:, None] * _iso_dirs(generator, n, device)

    v_esc = math.sqrt(2.0 * G * params.total_mass) * (r * r + a * a) ** -0.25
    q = _uniform(generator, (n, PLUMMER_CANDIDATES), device)
    y = _uniform(generator, (n, PLUMMER_CANDIDATES), device) * 0.1
    accept = y < q * q * (1.0 - q * q) ** 3.5
    first = torch.argmax(accept.to(torch.uint8), dim=1)  # first True
    q_sel = torch.where(accept.any(dim=1),
                        q.gather(1, first[:, None])[:, 0],
                        torch.full_like(r, 0.5))
    vel = (q_sel * v_esc)[:, None] * _iso_dirs(generator, n, device)
    mass = torch.full((n,), params.total_mass / n, dtype=torch.float32,
                      device=device)
    return _finish(pos, vel, mass)


def zero_velocities(state: ParticleState) -> ParticleState:
    return dataclasses.replace(state, vel=torch.zeros_like(state.vel))


def zero_accelerations(state: ParticleState) -> ParticleState:
    return dataclasses.replace(state, acc=torch.zeros_like(state.acc))


_PARAM_TYPES = {
    InitDistribution.UNIFORM: UniformDistParams,
    InitDistribution.SPHERICAL: SphericalDistParams,
    InitDistribution.DISK: DiskDistParams,
    InitDistribution.PLUMMER: PlummerDistParams,
}


def init_from_config(
    config: SimulationConfig, *, device: torch.device | str
) -> ParticleState:
    """Dispatch on ``config.init_distribution`` with a generator seeded
    from ``config.seed`` on ``device``, honoring ``config.dist_params``
    (the Plummer sphere takes ``config.G``)."""
    from nbody_tpu_torch.errors import ValidationError

    dist = config.init_distribution
    if dist not in _PARAM_TYPES:
        raise ValidationError(f"Unknown init distribution: {dist}")
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
    if dist == InitDistribution.SPHERICAL:
        return init_spherical(gen, n, params, device=device)
    if dist == InitDistribution.DISK:
        return init_disk(gen, n, params, device=device)
    return init_plummer(gen, n, params, G=config.G, device=device)
