"""ParticleSystem facade.

PyTorch counterpart of the core of ``nbody_tpu/system.py``: validate →
initialize → compute initial forces; ``update()`` is one Verlet step,
``run_steps(n)`` the scale path (cell-sorted stepping for Barnes-Hut, as
``bench.py`` measures on the TPU, with the re-sort cadence
``resort_every``, the audited re-sort ``resort_stale_frac`` or the exact
repair ``resort_repair``: on the card through table-resident stepping
where it was measured to beat row space, ``TABLE_ROUTES``, else in row
space); pause/resume/reset; state get/set;
energy queries; ``audit_short_range`` for the short-range engines'
capacity audits. Every tensor lives on the device given to
``initialize``: the CUDA card unless the caller passes ``device="cpu"``.

Not ported yet, and rejected with ``NotImplementedError`` rather than run
some other path: sharding (``shard_devices > 1``) and the distributions
other than uniform and spherical. Instances are not thread-safe.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nbody_tpu_torch.errors import (
    ValidationError,
    validate_config,
    validate_particle_count,
    validate_resource_requirements,
)
from nbody_tpu_torch.models.distributions import init_from_config
from nbody_tpu_torch.ops.forces import (
    make_force_fn,
    make_sorted_force_fn,
    make_table_step_params,
)
from nbody_tpu_torch.ops.integrator import (
    initialize_forces,
    kinetic_energy,
    make_adaptive_multi_step,
    make_multi_step,
    make_resort_multi_step,
    make_sorted_multi_step,
    make_verlet_step,
    potential_energy,
)
from nbody_tpu_torch.ops.table_step import (
    make_table_adaptive_multi_step,
    make_table_multi_step,
    make_table_repair_multi_step,
)
from nbody_tpu_torch.state import ParticleState, SimulationState
from nbody_tpu_torch.types import ForceMethod, SimulationConfig
from nbody_tpu_torch.utils.profiling import profile_phase


# The (engine, knob) pairs that step table-resident on the card: those
# whose table driver beat the row-space driver there in every call of
# chip_smoke.py's routing comparison (PERF.md §5-6; the 1M sparse hash and
# 1M Barnes-Hut tiles scenes). The hash's audited re-sort and repair win;
# its fixed cadence ties, and Barnes-Hut, host-bound and re-sorted every
# step on its cold collapse, loses or ties on all three knobs, so those
# keep the row-space choice. The JAX facade sends every pair to its table
# drivers on its accelerator.
TABLE_ROUTES = frozenset({("hash", "stale_frac"), ("hash", "repair")})


def _resort_knob(config: SimulationConfig) -> Optional[str]:
    """The frozen-grid knob the JAX facade's table routing reads first."""
    if config.resort_repair:
        return "repair"
    if config.resort_stale_frac > 0.0:
        return "stale_frac"
    return "cadence" if config.resort_every > 1 else None


def _require_ported(config: SimulationConfig) -> None:
    if config.shard_devices > 1:
        raise NotImplementedError(
            "shard_devices > 1: not ported to nbody_tpu_torch yet "
            "(ROADMAP A10 multi-device)"
        )


def _resolve_device(device) -> torch.device:
    """``device``, or the CUDA card when it is None; raises without one."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


class ParticleSystem:
    """Simulation facade."""

    def __init__(self):
        self._config: Optional[SimulationConfig] = None
        self._state: Optional[ParticleState] = None
        self._device: Optional[torch.device] = None
        self._force_fn = None
        self._sorted_force = None
        self._table_params = None
        self._step = None
        self._paused = False
        self._initialized = False

    # ---- lifecycle -------------------------------------------------------

    def initialize(self, config: SimulationConfig, device=None) -> None:
        """Validate, build the state on ``device`` (default: the CUDA
        card; ``device="cpu"`` for the plain twins) and the force
        strategy, compute a(t=0)."""
        validate_config(config)
        _require_ported(config)
        device = _resolve_device(device)
        validate_resource_requirements(config.particle_count, device)
        self._config = config
        self._device = device
        self._install_state(init_from_config(config, device=device))
        self._paused = False
        self._initialized = True

    def _install_state(self, state: ParticleState) -> None:
        """Build the force strategy for ``state`` (both the plain and the
        sorted force, once per strategy) and compute a(t)."""
        cfg = self._config
        # The hash's engine choice reads positions on the host: once here,
        # never inside a timed run_steps.
        hint = None
        if cfg.force_method == ForceMethod.SPATIAL_HASH:
            hint = state.pos.detach().cpu().numpy()
        self._force_fn = make_force_fn(cfg, pos_hint=hint)
        self._sorted_force = make_sorted_force_fn(cfg, pos_hint=hint)
        self._table_params = None
        knob = _resort_knob(cfg)
        if knob is not None:
            tp = make_table_step_params(cfg, device=self._device,
                                        pos_hint=hint)
            if tp is not None and (tp.mode, knob) in TABLE_ROUTES:
                self._table_params = tp
        self._step = make_verlet_step(self._force_fn, cfg.dt)
        self._state = initialize_forces(state, self._force_fn)

    def _require_init(self):
        if not self._initialized:
            raise ValidationError("ParticleSystem is not initialized")

    # ---- stepping --------------------------------------------------------

    def update(self, dt: Optional[float] = None) -> None:
        """One Velocity Verlet step; no-op while paused."""
        self._require_init()
        if self._paused:
            return
        with profile_phase("simulation.update", device=self._device):
            if dt is not None and dt != self._config.dt:
                self.set_time_step(dt)
            self._state = self._step(self._state)

    def run_steps(self, n_steps: int) -> None:
        """``n_steps`` Verlet steps — cell-sorted stepping when the force
        engine has the sorted contract (Barnes-Hut tiles, both hash
        engines), plain steps otherwise. No-op while paused."""
        self._require_init()
        if self._paused or n_steps <= 0:
            return
        with profile_phase("simulation.run_steps", device=self._device):
            self._state = self._multi_step(n_steps)(self._state)

    def _multi_step(self, n_steps: int):
        """The JAX facade's choice. Where table-resident stepping applies
        (``make_table_step_params``: the card, the fused tiles engines,
        N < 2²⁴) and the engine and knob are in ``TABLE_ROUTES``:
        ``resort_repair`` takes the repair driver (cadence cap
        ``resort_every``, 64 when unset), else ``resort_stale_frac > 0``
        the audited table re-sort (cap ``resort_every``, 16 when unset),
        else the table cadence ``resort_every``. Otherwise, as the JAX
        facade off its accelerator: plain steps without a sorted contract;
        with the engine's frozen-grid contract and N < 2²⁴, the audited
        re-sort when ``resort_stale_frac > 0`` (the same caps), else the
        fixed cadence when ``resort_every > 1``; else a sort every step
        (``resort_repair`` alone included)."""
        cfg, sf, tp = self._config, self._sorted_force, self._table_params
        cadence = cfg.resort_every
        if tp is not None:
            if cfg.resort_repair:
                return make_table_repair_multi_step(
                    tp, cfg.dt, n_steps,
                    max_cadence=cadence if cadence > 1 else 64)
            if cfg.resort_stale_frac > 0.0:
                return make_table_adaptive_multi_step(
                    tp, cfg.dt, n_steps, max_stale_frac=cfg.resort_stale_frac,
                    max_cadence=cadence if cadence > 1 else 16)
            return make_table_multi_step(tp, cfg.dt, n_steps, cadence)
        if sf is None:
            return make_multi_step(self._force_fn, cfg.dt, n_steps)
        frozen = hasattr(sf, "frozen") and self._state.n < (1 << 24)
        if frozen and cfg.resort_stale_frac > 0.0:
            return make_adaptive_multi_step(
                sf, cfg.dt, n_steps, max_stale_frac=cfg.resort_stale_frac,
                max_cadence=cadence if cadence > 1 else 16)
        if frozen and cadence > 1:
            return make_resort_multi_step(sf, cfg.dt, n_steps, cadence)
        return make_sorted_multi_step(sf, cfg.dt, n_steps)

    def pause(self) -> None:
        self._require_init()
        self._paused = True

    def resume(self) -> None:
        self._require_init()
        self._paused = False

    @property
    def is_paused(self) -> bool:
        return self._paused

    def reset(self) -> None:
        """Re-initialize particles from the stored config and device."""
        self._require_init()
        self.initialize(self._config, device=self._device)

    def set_time_step(self, dt: float) -> None:
        self._require_init()
        cfg = self._config.replace(dt=float(dt))
        validate_config(cfg)
        self._config = cfg
        self._step = make_verlet_step(self._force_fn, cfg.dt)

    # ---- accessors -------------------------------------------------------

    @property
    def config(self) -> SimulationConfig:
        self._require_init()
        return self._config

    @property
    def state(self) -> ParticleState:
        """Device-side state (read-only by convention)."""
        self._require_init()
        return self._state

    @property
    def simulation_time(self) -> float:
        self._require_init()
        return float(self._state.time)

    def positions(self) -> np.ndarray:
        self._require_init()
        return self._state.pos.detach().cpu().numpy()

    def velocities(self) -> np.ndarray:
        self._require_init()
        return self._state.vel.detach().cpu().numpy()

    # ---- state snapshot --------------------------------------------------

    def get_state(self) -> SimulationState:
        self._require_init()
        return SimulationState.from_particle_state(
            self._state,
            dt=self._config.dt,
            G=self._config.G,
            softening=self._config.softening,
            force_method=self._config.force_method,
        )

    def set_state(self, snapshot: SimulationState, device=None) -> None:
        """Full re-init: validate → rebuild the strategy for the
        snapshot's parameters → recompute forces. ``device`` defaults to the
        current one (or the CUDA card before ``initialize``)."""
        validate_particle_count(snapshot.particle_count)
        base = self._config if self._config is not None else SimulationConfig()
        config = base.replace(
            particle_count=snapshot.particle_count,
            dt=snapshot.dt,
            G=snapshot.G,
            softening=snapshot.softening,
            force_method=snapshot.force_method,
        )
        validate_config(config)
        _require_ported(config)
        if device is None:
            device = self._device
        self._device = _resolve_device(device)
        self._config = config
        self._install_state(snapshot.to_particle_state(self._device))
        self._initialized = True

    # ---- energy ----------------------------------------------------------

    def compute_kinetic_energy(self) -> float:
        self._require_init()
        return float(kinetic_energy(self._state))

    def compute_potential_energy(self) -> float:
        self._require_init()
        return float(potential_energy(
            self._state.pos, self._state.mass, self._config.G,
            self._config.softening,
        ))

    def compute_total_energy(self) -> float:
        return self.compute_kinetic_energy() + self.compute_potential_energy()

    def audit_short_range(self) -> dict:
        """Capacity audit of the active short-range structure: the rows or
        pair-windows the static-shape engines could not hold (non-zero
        overflow means forces are being dropped — raise ``hash_window``
        (hash window engine), or change ``bh_max_level`` (Barnes-Hut)).
        The hash audit reads the engine parameters resolved on the live
        closure, so it measures the configuration that runs. Keys as the
        JAX package's ``audit_short_range``."""
        self._require_init()
        cfg = self._config
        pos, mass = self._state.pos, self._state.mass
        out = {"method": cfg.force_method.cli_name, "overflow": 0}
        if cfg.force_method == ForceMethod.SPATIAL_HASH:
            from nbody_tpu_torch.ops.spatial_hash import (
                spatial_hash_forces,
                spatial_hash_forces_tiles,
            )

            p = self._force_fn.engine_params
            common = dict(cutoff=cfg.spatial_hash_cutoff,
                          cell_size=cfg.spatial_hash_cell_size,
                          return_overflow=True)
            if p["engine"] == "tiles":
                _, overflow = spatial_hash_forces_tiles(
                    pos, mass, cfg.G, cfg.softening, d=p["tile_d"],
                    k=p["tile_k"], **common)
                out["tile_d"] = p["tile_d"]
                out["tile_k"] = p["tile_k"]
            else:
                _, overflow = spatial_hash_forces(
                    pos, mass, cfg.G, cfg.softening,
                    cap=cfg.hash_max_grid_dim, window=p["window"],
                    block_size=p["block"], **common)
                out["window"] = p["window"]
            out["overflow"] = int(overflow)
            out["engine"] = p["engine"]
        elif cfg.force_method == ForceMethod.BARNES_HUT:
            from nbody_tpu_torch.ops.barnes_hut import (
                _near_field,
                bh_engine_params,
                bin_particles,
            )
            from nbody_tpu_torch.ops.sorted_window import build_sorted_grid
            from nbody_tpu_torch.ops.tile_sweep import tile_build

            p = bh_engine_params(cfg)
            levels, ws = p["levels"], p["ws"]
            lo, cell, coords = bin_particles(pos, levels)
            if p["near_engine"] == "tiles":
                # rows past the k cap, from the exact per-cell counts
                d = 1 << levels
                grid = build_sorted_grid(pos, mass, coords, d)
                overflow = tile_build(grid, lo, cell, d=d,
                                      k=p["near_k"]).overflow
                out["near_k"] = p["near_k"]
            else:
                _, overflow, _ = _near_field(pos, mass, lo, cell, cfg.G,
                                             cfg.softening, ws, levels,
                                             p["window"])
                out["window"] = p["window"]
            out["overflow"] = int(overflow)
            out["near_engine"] = p["near_engine"]
        return out

    def synchronize(self) -> None:
        """Wait for outstanding device work (timing helper)."""
        self._require_init()
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
