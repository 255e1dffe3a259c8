"""A uniform-in-volume ball at rest with equal masses: ``radius``,
``total_mass``."""

import math

import torch


def make(n: int, seed: int, device, radius: float = 10.0,
         total_mass: float = 1.0):
    """(pos (n, 3), vel (n, 3), mass (n,)) float32 on ``device``: one
    generator on the device, seeded from ``seed``, one draw."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    u = torch.rand((3, n), generator=g, dtype=torch.float32, device=device)
    r = torch.pow(u[0], 1.0 / 3.0) * radius
    theta = u[1] * (2.0 * math.pi)
    cos_phi = u[2] * 2.0 - 1.0
    sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
    pos = r[:, None] * torch.stack(
        [sin_phi * torch.cos(theta), sin_phi * torch.sin(theta), cos_phi], -1)
    mass = torch.full((n,), total_mass / n, dtype=torch.float32,
                      device=device)
    return pos.contiguous(), torch.zeros_like(pos), mass
