"""nbody_tpu_torch disk and Plummer initializers and the composite scenes
(CPU). The generators' bits differ from ``jax.random``'s, so the
distributions are held by their statistics, each with its tolerance, and
``two_body_orbit`` (no randomness) value by value."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import nbody_tpu as jnb
from nbody_tpu.models.distributions import init_plummer as jax_plummer
from nbody_tpu.models.scenes import two_body_orbit as jax_two_body
from nbody_tpu_torch.models import (
    galaxy_collision,
    init_disk,
    init_from_config,
    init_plummer,
    spiral_galaxy,
    two_body_orbit,
    zero_accelerations,
    zero_velocities,
)
from nbody_tpu_torch.state import config_from_reference
from nbody_tpu_torch.types import (
    DiskDistParams,
    InitDistribution,
    PlummerDistParams,
    SimulationConfig,
)

N = 20_000


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_disk_statistics():
    """r ≤ R; |z − c_z| ≤ thickness/2 (+1e-6 for the centre's rounding);
    |v| = rotation_speed·√r per row to 1e-6 relative, tangential; mean(r²)/R²
    within 0.01 of 0.5 (uniform surface density; its standard error at
    n = 20000 is 0.002); masses in [min, max]."""
    p = DiskDistParams(center=(0.0, 0.0, 2.0), radius=8.0, thickness=0.5,
                       min_mass=0.5, max_mass=1.5, rotation_speed=2.0)
    s = init_disk(_gen(3), N, p)
    pos = s.pos.numpy().astype(np.float64)
    vel = s.vel.numpy().astype(np.float64)
    r = np.hypot(pos[:, 0], pos[:, 1])
    assert r.max() <= p.radius * (1 + 1e-6)
    assert np.abs(pos[:, 2] - 2.0).max() <= p.thickness / 2 + 1e-6
    np.testing.assert_allclose(np.linalg.norm(vel, axis=1),
                               p.rotation_speed * np.sqrt(r), rtol=1e-6)
    assert np.abs((pos[:, :2] * vel[:, :2]).sum(1)).max() <= 1e-5 * (
        r * np.linalg.norm(vel, axis=1)).max()
    assert (vel[:, 2] == 0).all()
    assert abs((r * r).mean() / p.radius**2 - 0.5) < 0.01
    m = s.mass.numpy()
    assert m.min() >= 0.5 and m.max() <= 1.5
    assert (s.acc.numpy() == 0).all() and float(s.time) == 0.0


def _virial(pos, vel, mass, rows=4096):
    """2K/|W| of the whole sample estimated from its first ``rows`` rows
    (float64, ε = 0): K scaled by N/S, W by N(N−1)/(S(S−1))."""
    n = pos.shape[0]
    p = pos[:rows].astype(np.float64)
    v = vel[:rows].astype(np.float64)
    m = mass[:rows].astype(np.float64)
    kin = 0.5 * np.sum(m * np.sum(v * v, axis=1)) * n / rows
    w = 0.0
    for i in range(0, rows, 512):
        d = p[None] - p[i:i + 512, None]
        r = np.sqrt((d * d).sum(-1))
        with np.errstate(divide="ignore"):
            e = np.where(r > 0, m[i:i + 512, None] * m[None] / r, 0.0)
        w += e.sum()
    w *= -0.5 * n * (n - 1.0) / (rows * (rows - 1.0))
    return 2.0 * kin / abs(w)


def test_plummer_statistics():
    """Σm = total_mass to 1e-6; r ≤ 10a (+1e-6); the half-mass radius
    within 3 % of a·(2^{2/3} − 1)^{-1/2}; the virial ratio 2K/|W| from the
    first 4096 rows within 0.05 of the same statistic of the JAX
    initializer's sample (seed 0 in both; the statistic varies by ~0.02
    seed to seed)."""
    p = PlummerDistParams(scale_radius=1.0, total_mass=1.0)
    s = init_plummer(_gen(0), N, p)
    pos, vel, mass = s.pos.numpy(), s.vel.numpy(), s.mass.numpy()
    assert abs(mass.astype(np.float64).sum() - 1.0) <= 1e-6
    r = np.linalg.norm(pos.astype(np.float64), axis=1)
    assert r.max() <= 10.0 * (1 + 1e-6)
    want = (2.0 ** (2.0 / 3.0) - 1.0) ** -0.5
    assert abs(np.median(r) / want - 1.0) < 0.03
    j = jax_plummer(jax.random.PRNGKey(0), N,
                    jnb.types.PlummerDistParams(), 1.0)
    q_jax = _virial(np.asarray(j.pos), np.asarray(j.vel), np.asarray(j.mass))
    q = _virial(pos, vel, mass)
    assert abs(q - q_jax) < 0.05, (q, q_jax)
    assert 0.9 < q < 1.1


def test_plummer_takes_g_and_params_from_the_config():
    """``init_from_config`` passes G to the Plummer speeds (v ∝ √G) and the
    dist params through; the disk and Plummer params carry across from
    the JAX config."""
    jcfg = jnb.SimulationConfig(
        particle_count=500, init_distribution=jnb.InitDistribution.PLUMMER,
        dist_params=jnb.types.PlummerDistParams(center=(1.0, 0.0, 0.0),
                                                scale_radius=2.0,
                                                total_mass=3.0))
    cfg = config_from_reference(jcfg)
    assert cfg.dist_params == PlummerDistParams(center=(1.0, 0.0, 0.0),
                                                scale_radius=2.0,
                                                total_mass=3.0)
    s1 = init_from_config(cfg, device="cpu")
    s4 = init_from_config(cfg.replace(G=4.0), device="cpu")
    assert torch.equal(s1.pos, s4.pos)
    np.testing.assert_allclose(s4.vel.numpy(), 2.0 * s1.vel.numpy(),
                               rtol=1e-6)
    assert abs(float(s1.mass.sum()) - 3.0) < 1e-5
    jd = jnb.SimulationConfig(
        init_distribution=jnb.InitDistribution.DISK,
        dist_params=jnb.types.DiskDistParams(radius=3.0, thickness=0.2))
    assert config_from_reference(jd).dist_params == DiskDistParams(
        radius=3.0, thickness=0.2)
    disk = init_from_config(SimulationConfig(
        particle_count=64, init_distribution=InitDistribution.DISK),
        device="cpu")
    assert float(disk.pos[:, 2].abs().max()) <= 0.5


def test_zeroing_helpers():
    s = init_disk(_gen(1), 100)
    s = dataclasses.replace(s, acc=torch.ones_like(s.acc))
    z = zero_velocities(s)
    assert (z.vel == 0).all() and torch.equal(z.pos, s.pos)
    assert (zero_accelerations(s).acc == 0).all()


@pytest.mark.parametrize("softening", [0.0, 0.3])
def test_two_body_orbit_equals_jax(softening):
    t = two_body_orbit(3.0, 2.0, 1.5, softening)
    j = jax_two_body(3.0, 2.0, 1.5, softening)
    for f in ("pos", "vel", "mass", "acc"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-6,
                                   atol=1e-6)


def test_random_scenes():
    """Shapes, unit masses summing to n, the bulge fraction inside
    0.15·R, and the collision's two disks centred ±sep/2 approaching."""
    s = spiral_galaxy(_gen(5), 2001, center=(1.0, 2.0, 3.0))
    assert s.pos.shape == (2001, 3) and s.vel.shape == (2001, 3)
    assert float(s.mass.sum()) == 2001.0
    rel = s.pos[:400] - torch.tensor([1.0, 2.0, 3.0])
    assert float(rel.norm(dim=1).max()) <= 1.5 * (1 + 1e-5)
    c = galaxy_collision(_gen(6), 2001, separation=30.0, approach_speed=0.5)
    assert c.pos.shape == (2001, 3) and float(c.mass.sum()) == 2001.0
    left, right = c.pos[:1000], c.pos[1000:]
    assert float(left[:, 0].mean()) < -10 and float(right[:, 0].mean()) > 10
    assert float(c.vel[:1000, 0].mean()) > 0 > float(c.vel[1000:, 0].mean())
    assert torch.isfinite(c.vel).all() and torch.isfinite(s.vel).all()
