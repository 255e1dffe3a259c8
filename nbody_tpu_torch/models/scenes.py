"""Composite initial-condition scenes.

PyTorch counterpart of ``nbody_tpu/models/scenes.py``:
  * ``two_body_orbit`` — an analytic circular two-body orbit, the
    energy-conservation fidelity gate (no randomness);
  * ``spiral_galaxy`` — bulge + logarithmic arms + orbital velocities;
  * ``galaxy_collision`` — two rotating disks on an approach trajectory.

The random scenes draw from an explicit ``torch.Generator``, so they agree
with the JAX package's in distribution, not value by value.
"""

from __future__ import annotations

import math

import torch

from nbody_tpu_torch.models.distributions import (
    _device,
    _finish,
    _uniform,
    init_disk,
)
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.types import DiskDistParams


def two_body_orbit(
    separation: float = 2.0,
    mass: float = 1.0,
    G: float = 1.0,
    softening: float = 0.0,
    *,
    device: torch.device | str = "cpu",
) -> ParticleState:
    """Two equal masses on a circular orbit about their barycenter, with
    the speed of the softened force law, v² = G·m·d² / (2·(d² + ε²)^{3/2}),
    so the orbit is circular under the discrete dynamics."""
    d = separation
    v = math.sqrt(G * mass * d * d / (2.0 * (d * d + softening * softening)
                                      ** 1.5))

    def t(rows):
        return torch.tensor(rows, dtype=torch.float32, device=device)

    pos = t([[-d / 2, 0.0, 0.0], [d / 2, 0.0, 0.0]])
    vel = t([[0.0, -v, 0.0], [0.0, v, 0.0]])
    return _finish(pos, vel, t([mass, mass]))


def spiral_galaxy(
    generator: torch.Generator,
    n: int,
    radius: float = 10.0,
    arms: int = 2,
    arm_tightness: float = 0.5,
    bulge_fraction: float = 0.2,
    thickness: float = 0.5,
    rotation_speed: float = 1.0,
    center=(0.0, 0.0, 0.0),
    bulk_velocity=(0.0, 0.0, 0.0),
    *,
    device: torch.device | str | None = None,
) -> ParticleState:
    """Spiral galaxy: a uniform bulge ball of 0.15·R holding
    ``bulge_fraction`` of the particles, and logarithmic spiral arms
    (r = sqrt(u)·R, θ = arm phase + log1p(r/(tightness·R))/tightness +
    N(0, 0.15), z ~ N(0, thickness/2)); every particle moves tangentially
    at rotation_speed·sqrt(r_xy), plus ``bulk_velocity``. Unit masses."""
    device = _device(generator, device)
    n_bulge = int(n * bulge_fraction)
    n_arms = n - n_bulge

    u = _uniform(generator, (n_bulge, 3), device) * 2.0 - 1.0
    norm = torch.linalg.norm(u, dim=-1, keepdim=True) + 1e-9
    rad = torch.pow(_uniform(generator, (n_bulge, 1), device), 1.0 / 3.0)
    bulge_pos = u / norm * rad * (0.15 * radius)

    r = torch.sqrt(_uniform(generator, (n_arms,), device)) * radius
    arm_id = torch.randint(0, arms, (n_arms,), generator=generator,
                           device=device)
    base = arm_id.to(torch.float32) * (2.0 * math.pi / arms)
    wind = torch.log1p(r / (arm_tightness * radius)) / arm_tightness
    scatter = torch.randn((n_arms,), generator=generator, device=device) * 0.15
    theta = base + wind + scatter
    z = torch.randn((n_arms,), generator=generator, device=device) * (
        thickness * 0.5)
    arm_pos = torch.stack([r * torch.cos(theta), r * torch.sin(theta), z],
                          dim=-1)

    pos = torch.cat([bulge_pos, arm_pos], dim=0)
    r_xy = torch.linalg.norm(pos[:, :2], dim=-1) + 1e-6
    v = rotation_speed * torch.sqrt(r_xy)
    tang = torch.stack([-pos[:, 1] / r_xy, pos[:, 0] / r_xy,
                        torch.zeros_like(r_xy)], dim=-1)
    bulk = torch.tensor(bulk_velocity, dtype=torch.float32, device=device)
    vel = v[:, None] * tang + bulk
    mass = torch.ones((n,), dtype=torch.float32, device=device)
    off = torch.tensor(center, dtype=torch.float32, device=device)
    return _finish(pos + off, vel, mass)


def galaxy_collision(
    generator: torch.Generator,
    n: int,
    separation: float = 30.0,
    approach_speed: float = 0.5,
    radius: float = 10.0,
    *,
    device: torch.device | str | None = None,
) -> ParticleState:
    """Two rotating disks (⌊n/2⌋ and the rest, centred at (∓sep/2, 0, 0)
    and (sep/2, 0, 2)) approaching each other at ±``approach_speed``
    along x."""
    device = _device(generator, device)
    n1 = n // 2
    g1 = init_disk(generator, n1, DiskDistParams(
        center=(-separation / 2, 0.0, 0.0), radius=radius), device=device)
    g2 = init_disk(generator, n - n1, DiskDistParams(
        center=(separation / 2, 0.0, 2.0), radius=radius), device=device)
    push = torch.tensor([approach_speed, 0.0, 0.0], dtype=torch.float32,
                        device=device)
    return _finish(
        torch.cat([g1.pos, g2.pos]),
        torch.cat([g1.vel + push, g2.vel - push]),
        torch.cat([g1.mass, g2.mass]),
    )
