"""Velocity Verlet integrator + energy observability.

PyTorch counterpart of ``nbody_tpu/ops/integrator.py``. A ``lax.scan`` of
steps becomes a Python loop; each step is a handful of tensor ops around
one force evaluation, queued on the device without host synchronization
(the adaptive re-sort reads one count per frozen step: see
``make_adaptive_multi_step``). The frozen-grid drivers run their steps as
segments of an ``ops.step_graph.SegmentGraphs``: captured CUDA graphs
when the caller hands one in (the facade on the card), else eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from nbody_tpu_torch.ops.direct import pairwise_potential
from nbody_tpu_torch.ops.sorted_window import FrozenGridMeta
from nbody_tpu_torch.ops.step_graph import SegmentGraphs, stack_trace
from nbody_tpu_torch.state import ParticleState

# force_fn(pos (N,3), mass (N,)) -> acc (N,3)
ForceFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# sorted_force_fn(pos, mass[, extra (N,E)]) -> (acc_sorted (N,3), psort
# (N,4), order (N,)[, extra_sorted (N,E) — iff extra was given])
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


@dataclasses.dataclass(frozen=True)
class SortedState:
    """Integration state whose rows live in an arbitrary permutation of the
    original particle order (the force engine's last cell-sorted order):
    ``to_orig[i]`` (int32) is row i's original index. The carry of every
    cell-sorted and frozen-grid stepper here; ``to_particle_state``
    restores the original order."""

    pos: torch.Tensor      # (N, 3)
    vel: torch.Tensor      # (N, 3)
    acc: torch.Tensor      # (N, 3)
    mass: torch.Tensor     # (N,)
    to_orig: torch.Tensor  # (N,) int32
    time: torch.Tensor     # ()


def sorted_state_from(state: ParticleState) -> SortedState:
    """ParticleState → SortedState with the identity permutation
    (``state.acc`` must already hold a(t), see ``initialize_forces``)."""
    to_orig = torch.arange(state.n, dtype=torch.int32,
                           device=state.pos.device)
    return SortedState(pos=state.pos, vel=state.vel, acc=state.acc,
                       mass=state.mass, to_orig=to_orig, time=state.time)


def to_particle_state(s: SortedState) -> ParticleState:
    """SortedState → ParticleState in ORIGINAL row order, restored with one
    index store per field (``out[to_orig] = rows``; the JAX package
    gathers by ``argsort(to_orig)``, since TPU scatters are slow)."""

    def unsort(rows):
        out = torch.empty_like(rows)
        out[s.to_orig] = rows
        return out

    return ParticleState(pos=unsort(s.pos), vel=unsort(s.vel),
                         acc=unsort(s.acc), mass=unsort(s.mass), time=s.time)


# Row tags ride a float32 column exactly below 2²⁴ rows; above, the routed
# payload takes the separate gather (as in the JAX package).
_F32_EXACT_ROWS = 1 << 24


def _sorted_step(s: SortedState, force, dt, route_extra: bool = False):
    """One Verlet step through a sorting force ``force(pos, mass[, extra])
    -> (acc_sorted, psort, order[, extra_sorted], *rest)``. The half-kicked
    velocity and the tag follow the permutation by their own gathers, or,
    with ``route_extra`` (and fewer than 2²⁴ rows), ride the force's sort
    gather as a 4-column ``extra`` [vel_h | tag as float32]: the same
    values, so both routes give the same state bit for bit. Returns
    ``(state, rest)``."""
    pos_d = s.pos + s.vel * dt + (0.5 * dt * dt) * s.acc
    vel_h = s.vel + (0.5 * dt) * s.acc
    if route_extra and s.pos.shape[0] < _F32_EXACT_ROWS:
        ext = torch.cat([vel_h, s.to_orig.to(vel_h.dtype)[:, None]], dim=-1)
        acc, psort, order, pay, *rest = force(pos_d, s.mass, ext)
        vel_s, to_orig = pay[:, :3], pay[:, 3].to(torch.int32)
    else:
        acc, psort, order, *rest = force(pos_d, s.mass)
        vel_s, to_orig = vel_h[order], s.to_orig[order]
    return SortedState(psort[:, :3], vel_s + (0.5 * dt) * acc, acc,
                       psort[:, 3], to_orig, s.time + dt), rest


def sorted_verlet_step(s: SortedState, sorted_force_fn: SortedForceFn, dt,
                       route_extra: bool = False) -> SortedState:
    """One Velocity Verlet step entirely in sorted space: the engine
    returns its accelerations, rows and permutation in its cell-sorted
    order, and the half-kicked velocity and the original-row tag follow
    that permutation. ``route_extra=False``: by their own gathers;
    ``True``: riding the engine's sort gather as ``extra`` (the closure
    must take ``extra``). Same arithmetic per component as
    ``verlet_step``; the two routes are bit-equal."""
    return _sorted_step(s, sorted_force_fn, dt, route_extra)[0]


def _frozen_step(r: SortedState, frozen, meta, dt, with_audit: bool = False):
    """One Verlet step on a frozen cell assignment: the rows stay in place
    (no permutation, no gather), with the sorted step's kick arithmetic.
    Returns ``(rows, n_stale)`` (None without the audit)."""
    pos_d = r.pos + r.vel * dt + (0.5 * dt * dt) * r.acc
    vel_h = r.vel + (0.5 * dt) * r.acc
    psort = torch.cat([pos_d, r.mass[:, None]], dim=-1)
    out = frozen(psort, meta, with_audit=with_audit)
    acc, n_stale = out if with_audit else (out, None)
    return SortedState(psort[:, :3], vel_h + (0.5 * dt) * acc, acc, r.mass,
                       r.to_orig, r.time + dt), n_stale


def make_sorted_multi_step(sorted_force_fn: SortedForceFn, dt: float,
                           n_steps: int, route_extra: bool | None = None):
    """``n_steps`` Verlet steps in the force engine's cell-sorted row order
    (``sorted_verlet_step`` from ``sorted_state_from``).

    Each step the engine returns its accelerations, rows and permutation
    in sorted order; the half-kicked velocity and an int32 original-row
    tag follow the permutation, and the original order is restored ONCE at
    readout with an index store (``to_particle_state``). ``route_extra``
    picks how they follow it (see ``sorted_verlet_step``); None defers to
    the closure's own ``route_extra`` attribute (the engine factories set
    False), defaulting to the separate gathers. Returns ``multi(state) ->
    state``, original row order in and out.
    """
    if route_extra is None:
        route_extra = bool(getattr(sorted_force_fn, "route_extra", False))

    def multi(state: ParticleState) -> ParticleState:
        s = sorted_state_from(state)
        for _ in range(n_steps):
            s = sorted_verlet_step(s, sorted_force_fn, dt, route_extra)
        return to_particle_state(s)

    return multi


def _frozen_contract(sorted_force_fn):
    with_meta = getattr(sorted_force_fn, "with_meta", None)
    frozen = getattr(sorted_force_fn, "frozen", None)
    if with_meta is None or frozen is None:
        raise ValueError(
            "sorted_force_fn has no frozen-grid contract "
            "(with_meta/frozen attributes) — use make_sorted_multi_step")
    return with_meta, frozen


# The row-space frozen-grid drivers' carry: a SortedState and the last
# sort's FrozenGridMeta, as named buffers of a SegmentGraphs
_ROWS = tuple(f.name for f in dataclasses.fields(SortedState))
_META = tuple(f.name for f in dataclasses.fields(FrozenGridMeta))


def _rows(b) -> SortedState:
    return SortedState(**{k: b[k] for k in _ROWS})


def _row_segments(sorted_force_fn, dt):
    """The row-space drivers' segments on their carry: ``sort`` (the
    sorted step through ``with_meta``, its meta written into the carry),
    ``frozen`` and ``frozen_audit`` (the frozen step on the carried meta,
    the latter writing its stale count ``n_stale``)."""
    with_meta, frozen = _frozen_contract(sorted_force_fn)

    def sort(b):
        r, (meta,) = _sorted_step(_rows(b), with_meta, dt)
        return {**vars(r), **{k: getattr(meta, k) for k in _META}}

    def frozen_step(audit):
        def seg(b):
            meta = FrozenGridMeta(**{k: b[k] for k in _META})
            r, n_stale = _frozen_step(_rows(b), frozen, meta, dt, audit)
            return {**vars(r), **({"n_stale": n_stale} if audit else {})}
        return seg

    return {"sort": sort, "frozen": frozen_step(False),
            "frozen_audit": frozen_step(True)}


def _row_readout(g: SegmentGraphs) -> ParticleState:
    """The carry in original row order, sharing no buffer."""
    return to_particle_state(dataclasses.replace(_rows(g.buffers),
                                                 time=g.get("time")))


def make_resort_multi_step(sorted_force_fn: SortedForceFn, dt: float,
                           n_steps: int, resort_every: int, *,
                           graphs: SegmentGraphs | None = None):
    """``n_steps`` Verlet steps that re-sort once every ``resort_every``.

    The steps go in chunks of ``resort_every`` (⌊n/c⌋ chunks, then a
    remainder chunk): each chunk's first step sorts through
    ``sorted_force_fn.with_meta`` and caches the cell assignment
    (``FrozenGridMeta``); its other steps run ``sorted_force_fn.frozen``
    against it, with no sort and no payload gather. A frozen step with a
    fresh meta is the sorted step bit for bit; later, rows that crossed a
    cell boundary keep exact positions in a stale cell, so how far a
    cadence can go depends on the scene (audit it with
    ``frozen(..., with_audit=True)`` or step with
    ``make_adaptive_multi_step``). ``resort_every=1`` is
    ``make_sorted_multi_step``. Needs the engine's frozen-grid contract
    (the Barnes-Hut and hash tiles factories). The steps are the segments
    ``sort`` and ``frozen`` of ``graphs`` (captured CUDA graphs, replayed
    with no host read), or run eagerly without it. Returns ``multi(state)
    -> state``, original row order in and out; the int32 row tag takes any
    N.
    """
    if resort_every < 1:
        raise ValueError("resort_every must be >= 1")
    segs = _row_segments(sorted_force_fn, dt)

    def multi(state: ParticleState) -> ParticleState:
        g = graphs if graphs is not None else SegmentGraphs(graphed=False)
        g.load(**vars(sorted_state_from(state)))
        for start in range(0, n_steps, resort_every):
            g.run("sort", segs["sort"])
            for _ in range(min(resort_every, n_steps - start) - 1):
                g.run("frozen", segs["frozen"])
        return _row_readout(g)

    return multi


def make_adaptive_multi_step(sorted_force_fn: SortedForceFn, dt: float,
                             n_steps: int, *, max_stale_frac: float = 0.01,
                             max_cadence: int = 16, with_trace: bool = False,
                             graphs: SegmentGraphs | None = None):
    """``n_steps`` Verlet steps that re-sort when the scene asks.

    The first step sorts. Every frozen step audits itself
    (``frozen(..., with_audit=True)``), and step s+1 re-sorts when step
    s's stale count exceeded ⌊max_stale_frac·N⌋ or when ``max_cadence``
    steps have run since the last sort (``since ≥ max_cadence − 1``); the
    trigger lags the audit by one step, as in the JAX package. The JAX
    package decides on the device (``lax.cond``); here the count is read
    on the host, one device→host synchronization per frozen step, and
    only when a count could exceed the cap at all (the cap below N) and
    the cadence cap does not already decide. ``max_cadence=1`` is
    cadence-1 stepping and ``max_stale_frac=1`` the fixed ``max_cadence``
    cadence, both bit for bit. The steps are the segments ``sort`` and
    ``frozen_audit`` of ``graphs`` (captured CUDA graphs; the count read
    between two replays), or run eagerly without it.

    Returns ``multi(state) -> state``, or with ``with_trace=True``
    ``multi(state) -> (state, (stale_counts, resorted))``: int32 and bool
    tensors (n_steps − 1,), the stale count after each step after the
    first (0 after a sort) and whether that step sorted."""
    if not 0.0 <= max_stale_frac <= 1.0:
        raise ValueError("max_stale_frac must be in [0, 1]")
    if max_cadence < 1:
        raise ValueError("max_cadence must be >= 1")
    segs = _row_segments(sorted_force_fn, dt)

    def multi(state: ParticleState):
        n = state.n
        stale_cap = int(max_stale_frac * n)
        g = graphs if graphs is not None else SegmentGraphs(graphed=False)
        g.load(**vars(sorted_state_from(state)))
        g.run("sort", segs["sort"])
        since, audited = 0, False
        stales, resorted = [], []
        for _ in range(n_steps - 1):
            # a count is read only after an audited (frozen) step
            resort = since >= max_cadence - 1 or (
                audited and stale_cap < n and g.read("n_stale") > stale_cap)
            if resort:
                g.run("sort", segs["sort"])
                since, audited = 0, False
                stales.append(0)
            else:
                g.run("frozen_audit", segs["frozen_audit"])
                since, audited = since + 1, True
                stales.append(g.get("n_stale") if with_trace else 0)
            resorted.append(resort)
        out = _row_readout(g)
        if not with_trace:
            return out
        return out, stack_trace(stales, resorted, state.pos.device)

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


def exact_potential_energy(pos, mass, G=1.0, softening=0.1) -> torch.Tensor:
    """The exact all-pairs PE where ``pos`` lives: kernel K5
    (``direct.pairwise_potential``, float64 sums) on a CUDA tensor, the
    plain blocked loop ``potential_energy`` on a CPU tensor."""
    if pos.device.type == "cuda":
        return pairwise_potential(pos, mass, G, softening)
    return potential_energy(pos, mass, G, softening)


def total_energy(state: ParticleState, G=1.0, softening=0.1) -> torch.Tensor:
    """KE + exact PE (``exact_potential_energy``)."""
    return kinetic_energy(state) + exact_potential_energy(
        state.pos, state.mass, G, softening)


def sampled_potential_energy(pos, mass, G=1.0, softening=0.1, *,
                             samples: int = 16384,
                             generator: torch.Generator | None = None):
    """Unbiased O(S²) Monte-Carlo PE estimate from a uniform random
    S-subset, scaled by N(N−1)/(S(S−1)); exact when S ≥ N. The subset's
    PE is ``exact_potential_energy``."""
    n = pos.shape[0]
    s = min(samples, n)
    if s == n:
        return exact_potential_energy(pos, mass, G, softening)
    if generator is None:
        generator = torch.Generator(device=pos.device)
        generator.manual_seed(0)
    idx = torch.randperm(n, generator=generator, device=pos.device)[:s]
    pe_s = exact_potential_energy(pos[idx], mass[idx], G, softening)
    return pe_s * ((n * (n - 1.0)) / (s * (s - 1.0)))


def sampled_total_energy(state: ParticleState, G=1.0, softening=0.1, *,
                         samples: int = 16384,
                         generator: torch.Generator | None = None):
    """KE (exact, O(N)) + sampled PE — the at-scale diagnostics path."""
    return kinetic_energy(state) + sampled_potential_energy(
        state.pos, state.mass, G, softening, samples=samples,
        generator=generator)
