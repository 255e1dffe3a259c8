"""Velocity Verlet integrator + energy observability.

PyTorch counterpart of ``nbody_tpu/ops/integrator.py``. A ``lax.scan`` of
steps becomes a Python loop; each step is a handful of tensor ops around
one force evaluation, queued on the device without host synchronization.
"""

from __future__ import annotations

from typing import Callable

import torch

from nbody_tpu_torch.state import ParticleState

# force_fn(pos (N,3), mass (N,)) -> acc (N,3)
ForceFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# sorted_force_fn(pos, mass) -> (acc_sorted (N,3), psort (N,4), order (N,))
SortedForceFn = Callable[..., tuple]


def verlet_step(state: ParticleState, force_fn: ForceFn, dt) -> ParticleState:
    """One Velocity Verlet step:

      x(t+dt) = x(t) + v(t)·dt + ½·a(t)·dt²
      a(t+dt) = F(x(t+dt)) / m
      v(t+dt) = v(t) + ½·(a(t) + a(t+dt))·dt
    """
    pos = state.pos + state.vel * dt + (0.5 * dt * dt) * state.acc
    acc = force_fn(pos, state.mass)
    vel = state.vel + (0.5 * dt) * (state.acc + acc)
    return ParticleState(pos=pos, vel=vel, acc=acc, mass=state.mass,
                         time=state.time + dt)


def make_verlet_step(force_fn: ForceFn, dt: float):
    """``step(state) -> state`` closure."""

    def step(state: ParticleState) -> ParticleState:
        return verlet_step(state, force_fn, dt)

    return step


def make_multi_step(force_fn: ForceFn, dt: float, n_steps: int):
    """``n_steps`` Verlet steps."""

    def multi(state: ParticleState) -> ParticleState:
        for _ in range(n_steps):
            state = verlet_step(state, force_fn, dt)
        return state

    return multi


def initialize_forces(state: ParticleState, force_fn: ForceFn) -> ParticleState:
    """Compute a(t=0) so the first Verlet step is correct."""
    return ParticleState(pos=state.pos, vel=state.vel,
                         acc=force_fn(state.pos, state.mass),
                         mass=state.mass, time=state.time)


def make_sorted_multi_step(sorted_force_fn: SortedForceFn, dt: float,
                           n_steps: int):
    """``n_steps`` Verlet steps in the force engine's cell-sorted row order.

    Each step the engine returns its accelerations, rows and permutation
    in sorted order; the half-kicked velocity and an int32 original-row
    tag follow the permutation by gather, and the original order is
    restored ONCE at readout with an index store (``out[tag] = rows``).
    The same arithmetic as ``verlet_step`` per component. Returns
    ``multi(state) -> state``, original row order in and out.
    """

    def multi(state: ParticleState) -> ParticleState:
        pos, vel, acc, mass, t = (state.pos, state.vel, state.acc,
                                  state.mass, state.time)
        tag = torch.arange(state.n, dtype=torch.int32, device=pos.device)
        for _ in range(n_steps):
            pos_d = pos + vel * dt + (0.5 * dt * dt) * acc
            vel_h = vel + (0.5 * dt) * acc
            acc, psort, order = sorted_force_fn(pos_d, mass)
            vel = vel_h[order] + (0.5 * dt) * acc
            tag = tag[order]
            pos, mass = psort[:, :3], psort[:, 3]
            t = t + dt

        def unsort(rows):
            out = torch.empty_like(rows)
            out[tag] = rows
            return out

        return ParticleState(pos=unsort(pos), vel=unsort(vel),
                             acc=unsort(acc), mass=unsort(mass), time=t)

    return multi


# ---------------------------------------------------------------------------
# Energy observability
# ---------------------------------------------------------------------------


def kinetic_energy(state: ParticleState) -> torch.Tensor:
    """KE = ½ Σ m·|v|²."""
    return 0.5 * torch.sum(state.mass * torch.sum(state.vel * state.vel, dim=-1))


def _pair_terms(pb, mb, ps, ms, eps2):
    d = ps[None, :, :] - pb[:, None, :]                  # (b, chunk, 3)
    r2_raw = torch.sum(d * d, dim=-1)
    inv_r = torch.rsqrt(r2_raw + eps2)
    e = mb[:, None] * ms[None, :] * inv_r
    return torch.where(r2_raw == 0.0, torch.zeros_like(e), e)


def _kahan_add(s, c, x):
    y = x - c
    t = s + y
    return t, (t - s) - y


def potential_energy(pos, mass, G=1.0, softening=0.1, *,
                     block_size: int = 256,
                     accumulate: str = "f32") -> torch.Tensor:
    """PE = −G Σ_{i<j} m_i·m_j / √(r² + ε²), as half the full (i ≠ j)
    double sum, blocked over i. ``accumulate``:

      * ``"f32"``   — plain f32 sums;
      * ``"kahan"`` — compensated: Kahan over source blocks per row, then
        over the block partials (error ~ε_machine, independent of N);
      * ``"f64"``   — pair terms summed in float64.
    """
    if accumulate not in ("f32", "kahan", "f64"):
        raise ValueError(f"unknown accumulate mode {accumulate!r}")
    n = pos.shape[0]
    b = min(block_size, max(n, 1))
    eps2 = softening * softening
    starts = range(0, n, b)

    if accumulate == "f64":
        total = torch.zeros((), dtype=torch.float64, device=pos.device)
        for i in starts:
            e = _pair_terms(pos[i:i + b], mass[i:i + b], pos, mass, eps2)
            total = total + e.to(torch.float64).sum()
        return (-0.5 * G * total).to(pos.dtype)

    if accumulate == "kahan":
        zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
        total, comp = zero, zero
        for i in starts:
            pb, mb = pos[i:i + b], mass[i:i + b]
            s = torch.zeros(pb.shape[0], dtype=pos.dtype, device=pos.device)
            c = torch.zeros_like(s)
            for j in starts:
                e = _pair_terms(pb, mb, pos[j:j + b], mass[j:j + b], eps2)
                s, c = _kahan_add(s, c, e.sum(dim=1))
            total, comp = _kahan_add(total, comp, s.sum())
        return -0.5 * G * total

    per_row = [
        _pair_terms(pos[i:i + b], mass[i:i + b], pos, mass, eps2).sum(dim=1)
        for i in starts
    ]
    return -0.5 * G * torch.cat(per_row).sum()


def sampled_potential_energy(pos, mass, G=1.0, softening=0.1, *,
                             samples: int = 16384,
                             generator: torch.Generator | None = None):
    """Unbiased O(S²) Monte-Carlo PE estimate from a uniform random
    S-subset, scaled by N(N−1)/(S(S−1)); exact when S ≥ N."""
    n = pos.shape[0]
    s = min(samples, n)
    if s == n:
        return potential_energy(pos, mass, G, softening)
    if generator is None:
        generator = torch.Generator(device=pos.device)
        generator.manual_seed(0)
    idx = torch.randperm(n, generator=generator, device=pos.device)[:s]
    pe_s = potential_energy(pos[idx], mass[idx], G, softening)
    return pe_s * ((n * (n - 1.0)) / (s * (s - 1.0)))
