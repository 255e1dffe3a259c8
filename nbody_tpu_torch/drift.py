"""Energy-drift measurement: |ΔE/E| of Barnes-Hut Velocity Verlet.

The loop of ``scripts/measure_drift.py`` (the JAX package's physics gate:
|ΔE/E| < 1e-4 over 10k steps of 1M-particle Barnes-Hut) on this package,
with every setting taken from that script:

  * ``SimulationConfig(particle_count=n, force_method=BARNES_HUT,
    bh_max_level=6 if n > 300_000 else 5, dt=1e-3)``;
  * ``init_spherical`` of radius 10 with masses 1/n each (total mass 1,
    the Hénon normalization: the crossing time is ~30 time units, so 10k
    steps at dt = 1e-3 are a resolved window), from a seeded generator;
  * ``initialize_forces``, then plain unsorted stepping in chunks
    (``make_multi_step(force_fn, dt, chunk)``);
  * E = ``kinetic_energy`` + the exact all-pairs potential (kernel K5,
    ``direct.pairwise_potential``) at step 0 and after every chunk.

``scripts/measure_drift_torch.py`` prints what ``run_drift`` yields;
``chip_smoke.py`` and the tests call it directly.
"""

from __future__ import annotations

import time

import torch

from nbody_tpu_torch.models.distributions import init_spherical
from nbody_tpu_torch.ops.direct import pairwise_potential
from nbody_tpu_torch.ops.forces import make_force_fn
from nbody_tpu_torch.ops.integrator import (
    initialize_forces,
    kinetic_energy,
    make_multi_step,
)
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.types import (
    ForceMethod,
    SimulationConfig,
    SphericalDistParams,
)

TARGET = 1e-4


def drift_config(n: int, levels: int | None = None) -> SimulationConfig:
    """The measurement's configuration; ``levels`` overrides the script's
    ``bh_max_level`` rule (6 above 300k particles, else 5)."""
    if levels is None:
        levels = 6 if n > 300_000 else 5
    return SimulationConfig(particle_count=n,
                            force_method=ForceMethod.BARNES_HUT,
                            bh_max_level=levels, dt=1e-3)


def henon_sphere(n: int, device, seed: int = 42) -> ParticleState:
    """The uniform sphere of radius 10 with total mass 1, at rest."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = SphericalDistParams(radius=10.0, min_mass=1.0 / n,
                                 max_mass=1.0 / n)
    return init_spherical(gen, n, params, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_drift(n: int, steps: int, chunk: int, device="cuda", *,
              levels: int | None = None, state: ParticleState | None = None):
    """Yield one record per checkpoint: step 0, then after every ``chunk``
    steps until ``steps`` are done — ``{"step", "E", "rel_drift",
    "pe_secs"}`` plus ``"steps_per_sec"`` (the chunk's steps over its
    stepping time, the energy evaluation excluded) after step 0.
    ``state`` replaces the Hénon sphere (the tests hand both packages one
    state); it runs on the card unless ``device="cpu"``."""
    device = torch.device(device)
    config = drift_config(n, levels)
    force_fn = make_force_fn(config)
    if state is None:
        state = henon_sphere(n, device)
    state = initialize_forces(state, force_fn)

    def energy():
        _sync(device)
        t0 = time.perf_counter()
        e = float(kinetic_energy(state) + pairwise_potential(
            state.pos, state.mass, config.G, config.softening))
        return e, time.perf_counter() - t0

    e0, pe_secs = energy()
    yield {"step": 0, "E": e0, "rel_drift": 0.0, "pe_secs": pe_secs}
    multi = make_multi_step(force_fn, config.dt, chunk)
    done = 0
    while done < steps:
        t0 = time.perf_counter()
        state = multi(state)
        _sync(device)
        step_secs = time.perf_counter() - t0
        e, pe_secs = energy()
        done += chunk
        yield {"step": done, "E": e, "rel_drift": abs((e - e0) / e0),
               "pe_secs": pe_secs, "steps_per_sec": chunk / step_secs}


def drift_metric(n: int, steps: int, last: dict) -> dict:
    """The final line of ``scripts/measure_drift.py``: the last
    checkpoint's |ΔE/E| against the 1e-4 target."""
    drift = last["rel_drift"]
    return {"metric": f"abs_rel_energy_drift_{n // 1000}k_bh_{steps}steps",
            "value": drift, "target": TARGET, "pass": bool(drift < TARGET)}
