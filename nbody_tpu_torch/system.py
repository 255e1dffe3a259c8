"""ParticleSystem facade.

PyTorch counterpart of ``nbody_tpu/system.py``: validate → initialize →
compute initial forces; ``update()`` is one Verlet step, ``run_steps(n)``
the scale path (cell-sorted stepping for Barnes-Hut, as ``bench.py``
measures on the TPU, with the re-sort cadence ``resort_every``, the
audited re-sort ``resort_stale_frac`` or the exact repair
``resort_repair``: on the card through table-resident stepping where it
was measured to beat row space, ``TABLE_ROUTES``, else in row space);
pause/resume/reset; the live setters (force method, G, ε, θ, cell size,
cutoff, dt), which rebuild the whole strategy; state get/set and
``.nbody`` save/load; energy queries (the exact potential on kernel K5
on the card); ``audit_short_range`` for the short-range engines' capacity
audits; ``diagnostics``. Every tensor lives on the device given to
``initialize``: the CUDA card unless the caller passes ``device="cpu"``.

On the card ``update()`` and ``run_steps`` are one device program, as the
JAX facade's jitted step and fused n-step program are: ONE Verlet step
captured as a CUDA graph and replayed once a step (``ops/step_graph.py``),
the plain step for ``update()`` and for engines without the sorted
contract, the cell-sorted step (``sorted_verlet_step`` on a
``SortedState``) for ``run_steps`` on the others; the frozen-grid drivers
(the fixed cadence, the audited re-sort and the repair, in row space or
table-resident) replay their captured segments (``SegmentGraphs``) in the
order their schedule picks, with their few host reads between replays; on
a mesh, ``update()`` and ``run_steps`` replay the sharded step's captured
stages, one segment set per card, with the collectives (device-local
copies, gloo's host staging, NCCL calls) run between replays
(``parallel/program.ShardedGraphs``). A strategy's graphs are captured on
their first call and kept for every n; they are dropped whenever what
they close over changes: a live setter, ``reset``, ``set_time_step``,
``set_state`` and ``load_state``. Every path on the CPU steps eagerly. On
the card a(t) (once a strategy), the energies and the audit stay eager:
``sharded_energy`` is ~14 launches a call at P = 4, with no host overhead
a graph would remove.

With ``shard_devices`` P > 1 the state is padded with zero-mass rows to a
multiple of P and sharded over a mesh of P positions
(``parallel/``): P virtual shards of the CPU with ``device="cpu"``, else
the first P visible CUDA cards (more than exist raises
``ValidationError``). Steps, energies and a(t) then run the sharded
programs; the padding never shows in positions, velocities, masses,
``get_state`` or ``save_state``. Instances are not thread-safe.

With a process group up (``parallel.initialize_distributed``, one rank
per card), the mesh spans the processes: every rank runs the same calls
on the same config, builds the same state from the seed and keeps its own
positions' rows. State reads (``positions``, ``velocities``,
``get_state``, the energies, ``audit_short_range``, ``diagnostics``) are
then collectives that return the same values on every rank, and
``save_state`` writes the file on rank 0 only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nbody_tpu_torch.errors import (
    STATE_BYTES_PER_PARTICLE,
    ValidationError,
    validate_config,
    validate_gravitational_constant,
    validate_particle_count,
    validate_resource_requirements,
    validate_softening,
    validate_theta,
)
from nbody_tpu_torch.models.distributions import init_from_config
from nbody_tpu_torch.ops.forces import (
    make_force_fn,
    make_sorted_force_fn,
    make_table_step_params,
)
from nbody_tpu_torch.ops.integrator import (
    exact_potential_energy,
    initialize_forces,
    kinetic_energy,
    make_adaptive_multi_step,
    make_multi_step,
    make_resort_multi_step,
    make_sorted_multi_step,
    make_verlet_step,
    sorted_state_from,
    sorted_verlet_step,
    to_particle_state,
)
from nbody_tpu_torch.ops.step_graph import SegmentGraphs, StepGraph
from nbody_tpu_torch.ops.table_step import (
    make_table_adaptive_multi_step,
    make_table_multi_step,
    make_table_repair_multi_step,
)
from nbody_tpu_torch.parallel.distributed import (
    barrier,
    global_device_info,
    process_world,
)
from nbody_tpu_torch.parallel.mesh import (
    gather_state,
    make_mesh,
    pad_to_devices,
    shard_state,
)
from nbody_tpu_torch.parallel.program import ShardedGraphs
from nbody_tpu_torch.parallel.step import (
    make_sharded_force_fn,
    sharded_energy,
    sharded_initialize_forces,
    sharded_multi_step,
    sharded_verlet_step,
    verlet_ops,
)
from nbody_tpu_torch.state import ParticleState, SimulationState
from nbody_tpu_torch.types import ForceMethod, SimulationConfig
from nbody_tpu_torch.utils.profiling import profile_phase
from nbody_tpu_torch.utils.serialization import Serializer


# The (engine, knob) pairs that step table-resident on the card: those
# whose table driver beat the row-space driver there, both on captured
# graphs, by more than the spread of the turns (the larger interquartile
# range of their runs) in chip_smoke.py's routing comparison (PERF.md §5-6;
# the 1M sparse hash and 1M Barnes-Hut tiles scenes). Only the hash's
# repair wins; its audited re-sort and fixed cadence tie, and Barnes-Hut,
# re-sorted every step on its cold collapse, loses on all three knobs, so
# those keep the row-space choice. The JAX facade sends every pair to its
# table drivers on its accelerator.
TABLE_ROUTES = frozenset({("hash", "repair")})


def _resort_knob(config: SimulationConfig) -> Optional[str]:
    """The frozen-grid knob the JAX facade's table routing reads first."""
    if config.resort_repair:
        return "repair"
    if config.resort_stale_frac > 0.0:
        return "stale_frac"
    return "cadence" if config.resort_every > 1 else None


def _make_mesh(config: SimulationConfig, device: torch.device):
    """The mesh of ``config.shard_devices`` positions for the facade's
    device: virtual shards of the CPU, or the visible CUDA cards; with a
    process group up, positions spread evenly over the processes."""
    if device.type == "cpu":
        return make_mesh(config.shard_devices,
                         devices=[device] * config.shard_devices)
    return make_mesh(config.shard_devices)


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
        self._sorted_step = None
        # the captured steps on the card, by kind (``step_graphs``)
        self._graphs: dict = {}
        self._paused = False
        self._initialized = False
        # shard_devices > 1: the mesh, and the logical particle count (the
        # sharded state carries zero-mass padding rows)
        self._mesh = None
        self._n_logical: Optional[int] = None

    # ---- lifecycle -------------------------------------------------------

    def initialize(self, config: SimulationConfig, device=None) -> None:
        """Validate, build the state on ``device`` (default: the CUDA
        card; ``device="cpu"`` for the plain twins) and the force
        strategy, compute a(t=0)."""
        validate_config(config)
        device = _resolve_device(device)
        validate_resource_requirements(config.particle_count, device)
        self._config = config
        self._device = device
        self._install_state(init_from_config(config, device=device))
        self._paused = False
        self._initialized = True

    def _install_state(self, state: ParticleState) -> None:
        """Shard ``state`` when ``shard_devices > 1``, build the force
        strategy for it and compute a(t)."""
        self._n_logical = state.n
        self._mesh = None
        if self._config.shard_devices > 1:
            self._mesh = _make_mesh(self._config, self._device)
        self._rebuild_strategy(state.pos)
        if self._mesh is not None:
            state = shard_state(pad_to_devices(state, self._mesh.size),
                                self._mesh)
        self._state = state
        self._initialize_forces()

    @property
    def mesh(self):
        """The device mesh when running sharded, else None."""
        return self._mesh

    @property
    def is_sharded(self) -> bool:
        return self._mesh is not None

    def _logical_state(self) -> ParticleState:
        """The state on one device without the sharding's padding rows."""
        if self._mesh is None:
            return self._state
        return gather_state(self._state, self._n_logical)

    def _rebuild_strategy(self, pos: torch.Tensor) -> None:
        """Build everything the config selects, once per strategy: the
        plain and the sorted force, the table route and the Verlet step.
        ``pos`` feeds the hash's ``hash_engine="auto"`` choice, so a live
        setter re-resolves it from the current state."""
        cfg = self._config
        self._graphs = {}
        # The hash's engine choice reads positions on the host: here,
        # never inside a timed run_steps.
        hint = None
        if cfg.force_method == ForceMethod.SPATIAL_HASH:
            hint = pos.detach().cpu().numpy()
        if self._mesh is not None:
            self._force_fn = make_sharded_force_fn(cfg, self._mesh,
                                                   pos_hint=hint)
            self._sorted_force = self._table_params = None
            self._step, self._sorted_step = self._make_steps(cfg.dt)
            return
        self._force_fn = make_force_fn(cfg, pos_hint=hint)
        self._sorted_force = make_sorted_force_fn(cfg, pos_hint=hint)
        self._table_params = None
        knob = _resort_knob(cfg)
        if knob is not None:
            tp = make_table_step_params(cfg, device=self._device,
                                        pos_hint=hint)
            if tp is not None and (tp.mode, knob) in TABLE_ROUTES:
                self._table_params = tp
        self._step, self._sorted_step = self._make_steps(cfg.dt)

    def _make_steps(self, dt: float):
        """One Verlet step with the current force (sharded or not), and
        one cell-sorted step on a ``SortedState`` where the force has the
        sorted contract (else None): the steps the card's graphs capture.
        The payload takes the route the engine's closure names, as in
        ``make_sorted_multi_step``."""
        force_fn, sf = self._force_fn, self._sorted_force
        if self._mesh is not None:
            return (lambda state: sharded_verlet_step(state, force_fn, dt),
                    None)
        sorted_step = None
        if sf is not None:
            route = bool(getattr(sf, "route_extra", False))

            def sorted_step(s):
                return sorted_verlet_step(s, sf, dt, route)

        return make_verlet_step(force_fn, dt), sorted_step

    def _graph(self, kind: str) -> StepGraph:
        """The card's captured step of ``kind`` ("plain" or "sorted"),
        made on first use (captured on its first call)."""
        g = self._graphs.get(kind)
        if g is None:
            g = StepGraph(self._step if kind == "plain" else
                          self._sorted_step)
            self._graphs[kind] = g
        return g

    def _sharded_graphs(self) -> ShardedGraphs:
        """The card's captured stages of the sharded step, made on first
        use (each stage captured after its first eager use)."""
        g = self._graphs.get("sharded")
        if g is None:
            g = ShardedGraphs(verlet_ops(self._force_fn, self._config.dt),
                              self._mesh)
            self._graphs["sharded"] = g
        return g

    def _segments(self, kind: str, graphed: bool):
        """The card's captured segments of the frozen-grid driver ``kind``
        when ``graphed``, made on first use; else None (eager)."""
        if not graphed:
            return None
        return self._graphs.setdefault(kind, SegmentGraphs())

    @property
    def step_graphs(self) -> dict:
        """The captured steps made so far for the current strategy and dt,
        by kind: "plain" (``update()`` and plain ``run_steps``) and
        "sorted" (cell-sorted ``run_steps``), each an
        ``ops.step_graph.StepGraph`` (captured once its first call has
        run); "cadence" and "adaptive" (the row-space frozen-grid
        drivers), "table cadence", "table adaptive" and "table repair",
        each an ``ops.step_graph.SegmentGraphs`` (its ``segments``,
        ``host_reads``, ``pool_bytes`` and side bucket ``state``); on a
        mesh "sharded" (``update()`` and ``run_steps``), a
        ``parallel.program.ShardedGraphs`` (``segments`` and
        ``collectives`` a step, ``captures``, ``replays``, ``capture_ms``,
        ``pool_bytes``, a ``SegmentGraphs`` a card in ``sets``). Empty off
        the card."""
        return dict(self._graphs)

    def _graphed(self) -> bool:
        return self._device.type == "cuda"

    def _initialize_forces(self) -> None:
        """a(t) of the current state with the current strategy."""
        if self._mesh is not None:
            self._state = sharded_initialize_forces(self._state,
                                                    self._force_fn)
        else:
            self._state = initialize_forces(self._state, self._force_fn)

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
            if self._graphed() and self._mesh is not None:
                self._state = self._sharded_graphs()(self._state, 1)
            elif self._graphed():
                self._state = self._graph("plain")(self._state, 1)
            else:
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

    def _multi_step(self, n_steps: int, graphed: Optional[bool] = None):
        """``multi(state) -> state``, the JAX facade's choice. Where
        table-resident stepping applies
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
        (``resort_repair`` alone included).

        On the card (``graphed`` None or True) every one of them replays
        the strategy's captured graphs: the plain steps and the sort every
        step one captured step (``StepGraph``: n replays, the first call's
        first step eager and the capture after it), the frozen-grid
        drivers their captured segments (``SegmentGraphs``: each
        segment's first use eager, then captured), with their host reads
        between replays; on a mesh the sharded step's captured stages
        (``_sharded_graphs``), the collectives between replays;
        ``graphed=False`` gives the eager multi-step function of the same
        force and driver, the reference the graphs are held to."""
        cfg, sf, tp = self._config, self._sorted_force, self._table_params
        if graphed is None:
            graphed = self._graphed()
        if self._mesh is not None:
            if graphed:
                g = self._sharded_graphs()
                return lambda state: g(state, n_steps)
            return sharded_multi_step(self._force_fn, cfg.dt, n_steps,
                                      graphed=False)
        cadence = cfg.resort_every
        if tp is not None:
            if cfg.resort_repair:
                return make_table_repair_multi_step(
                    tp, cfg.dt, n_steps,
                    max_cadence=cadence if cadence > 1 else 64,
                    graphs=self._segments("table repair", graphed))
            if cfg.resort_stale_frac > 0.0:
                return make_table_adaptive_multi_step(
                    tp, cfg.dt, n_steps, max_stale_frac=cfg.resort_stale_frac,
                    max_cadence=cadence if cadence > 1 else 16,
                    graphs=self._segments("table adaptive", graphed))
            return make_table_multi_step(
                tp, cfg.dt, n_steps, cadence,
                graphs=self._segments("table cadence", graphed))
        if sf is None:
            if graphed:
                g = self._graph("plain")
                return lambda state: g(state, n_steps)
            return make_multi_step(self._force_fn, cfg.dt, n_steps)
        frozen = hasattr(sf, "frozen") and self._state.n < (1 << 24)
        if frozen and cfg.resort_stale_frac > 0.0:
            return make_adaptive_multi_step(
                sf, cfg.dt, n_steps, max_stale_frac=cfg.resort_stale_frac,
                max_cadence=cadence if cadence > 1 else 16,
                graphs=self._segments("adaptive", graphed))
        if frozen and cadence > 1:
            return make_resort_multi_step(
                sf, cfg.dt, n_steps, cadence,
                graphs=self._segments("cadence", graphed))
        if graphed:
            g = self._graph("sorted")
            return lambda state: to_particle_state(
                g(sorted_state_from(state), n_steps))
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

    # ---- runtime setters ---------------------------------------------------

    def set_force_method(self, method: ForceMethod) -> None:
        """Switch the force method and recompute a(t) with it, so the next
        step kicks with the new strategy's accelerations."""
        self._require_init()
        cfg = self._config.replace(force_method=method)
        validate_config(cfg)
        self._config = cfg
        self._rebuild_strategy(self._logical_state().pos)
        self._initialize_forces()

    def set_time_step(self, dt: float) -> None:
        """The multi-step drivers read ``dt`` from the config on every
        ``run_steps``, so only the single steps are rebuilt, and the
        captured ones dropped (dt is a launch argument)."""
        self._require_init()
        cfg = self._config.replace(dt=float(dt))
        validate_config(cfg)
        self._config = cfg
        self._step, self._sorted_step = self._make_steps(cfg.dt)
        self._graphs = {}

    def _set_param(self, **kw) -> None:
        """Rebuild the strategy for the new parameters. a(t) is kept, as
        in the JAX facade: the next step's first half-kick uses the
        accelerations of the old parameters."""
        self._require_init()
        cfg = self._config.replace(**kw)
        validate_config(cfg)
        self._config = cfg
        self._rebuild_strategy(self._logical_state().pos)

    def set_gravitational_constant(self, G: float) -> None:
        validate_gravitational_constant(G)
        self._set_param(G=float(G))

    def set_softening(self, eps: float) -> None:
        validate_softening(eps)
        self._set_param(softening=float(eps))

    def set_theta(self, theta: float) -> None:
        # validated whatever the active method, as in the JAX facade
        validate_theta(theta)
        self._set_param(barnes_hut_theta=float(theta))

    def set_cell_size(self, cell_size: float) -> None:
        if not (cell_size > 0):
            raise ValidationError("Spatial hash cell size must be positive")
        self._set_param(spatial_hash_cell_size=float(cell_size))

    def set_cutoff(self, cutoff: float) -> None:
        if not (cutoff > 0):
            raise ValidationError("Spatial hash cutoff must be positive")
        self._set_param(spatial_hash_cutoff=float(cutoff))

    # ---- accessors -------------------------------------------------------

    @property
    def config(self) -> SimulationConfig:
        self._require_init()
        return self._config

    @property
    def particle_count(self) -> int:
        """The logical particle count (without sharding padding)."""
        self._require_init()
        return self._n_logical

    @property
    def state(self):
        """Device-side state (read-only by convention): a
        ``ParticleState``, or when sharded a ``parallel.mesh.ShardedState``
        with its padding rows."""
        self._require_init()
        return self._state

    @property
    def simulation_time(self) -> float:
        self._require_init()
        return float(self._state.time)

    def positions(self) -> np.ndarray:
        self._require_init()
        return self._logical_state().pos.detach().cpu().numpy()

    def velocities(self) -> np.ndarray:
        self._require_init()
        return self._logical_state().vel.detach().cpu().numpy()

    # ---- state snapshot --------------------------------------------------

    def get_state(self) -> SimulationState:
        self._require_init()
        return SimulationState.from_particle_state(
            self._logical_state(),
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
        if device is None:
            device = self._device
        self._device = _resolve_device(device)
        self._config = config
        self._install_state(snapshot.to_particle_state(self._device))
        self._initialized = True

    def save_state(self, filename: str) -> None:
        """Write the state as a ``.nbody`` file (no accelerations). On a
        mesh across processes rank 0 writes it and every rank returns once
        it is written."""
        snapshot = self.get_state()
        if self._mesh is None or self._mesh.world == 1:
            Serializer.save(filename, snapshot)
            return
        if self._mesh.rank == 0:
            Serializer.save(filename, snapshot)
        barrier()

    def load_state(self, filename: str, device=None) -> None:
        """``set_state`` from a ``.nbody`` file: a(t) is recomputed."""
        self.set_state(Serializer.load(filename), device=device)

    # ---- energy ----------------------------------------------------------

    def compute_kinetic_energy(self) -> float:
        self._require_init()
        if self._mesh is not None:
            return self._sharded_energy()[0]
        return float(kinetic_energy(self._state))

    def compute_potential_energy(self) -> float:
        """Exact all-pairs PE: kernel K5 on the card, the plain blocked
        loop on the CPU (``exact_potential_energy``); sharded, the ring of
        K5's cross form (``parallel.step.sharded_energy``)."""
        self._require_init()
        if self._mesh is not None:
            return self._sharded_energy()[1]
        return float(exact_potential_energy(
            self._state.pos, self._state.mass, self._config.G,
            self._config.softening,
        ))

    def _sharded_energy(self) -> tuple:
        ke, pe = sharded_energy(self._state, self._mesh, self._config.G,
                                self._config.softening)
        return float(ke), float(pe)

    def compute_total_energy(self) -> float:
        if self._mesh is not None:
            ke, pe = self._sharded_energy()
            return ke + pe
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
        # sharded: the logical rows, gathered, with the single-device
        # engines
        state = self._logical_state()
        pos, mass = state.pos, state.mass
        out = {"method": cfg.force_method.cli_name, "overflow": 0}
        if cfg.force_method == ForceMethod.SPATIAL_HASH:
            from nbody_tpu_torch.ops.spatial_hash import (
                hash_engine_params,
                spatial_hash_forces,
                spatial_hash_forces_tiles,
            )

            p = getattr(self._force_fn, "engine_params", None)
            if p is None:
                p = hash_engine_params(cfg, pos)
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
        """Wait for outstanding device work (timing helper; the JAX
        facade's ``block_until_ready``)."""
        self._require_init()
        if self._mesh is not None:
            for dev in set(self._mesh.devices):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        elif self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def diagnostics(self) -> dict:
        """Runtime diagnostics, keyed as the JAX facade's: ``backend`` is
        the torch device type, ``devices`` the CUDA cards of every process
        (``global_device_info``; a collective with a process group up),
        on the CPU the processes, and ``force_distribution`` the sharded
        strategy (``parallel.step.make_sharded_force_fn``) or
        "single-device"."""
        self._require_init()
        n = self.particle_count
        cuda = self._device.type == "cuda"
        sharded = self._mesh is not None
        return {
            "particle_count": n,
            "shard_devices": self._mesh.size if sharded else 1,
            "force_distribution": (self._force_fn.distribution if sharded
                                   else "single-device"),
            "force_method": self._config.force_method.cli_name,
            "simulation_time": float(self._state.time),
            "paused": self._paused,
            "dt": self._config.dt,
            "G": self._config.G,
            "softening": self._config.softening,
            "state_bytes": n * STATE_BYTES_PER_PARTICLE,
            "backend": self._device.type,
            "devices": (global_device_info()["global_devices"] if cuda
                        else process_world()[1]),
        }
