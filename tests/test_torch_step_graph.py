"""The facade's one-step functions and the frozen-grid drivers' segments
are capture-safe (CPU).

On the card ``ParticleSystem.update`` and ``run_steps`` replay ONE captured
Verlet step, or a frozen-grid driver's captured segments
(``nbody_tpu_torch/ops/step_graph.py``). A capture cannot
hold a host read: a ``.item()``, a ``nonzero``, boolean-mask indexing (a
``nonzero`` inside) or a tensor made from host data. Here, for each step
engine, the step the facade would capture runs once more after a warm step
under the guards of ``tests/capture_guards.py`` (host data, host reads
and boolean-mask indexing refused, the kernels' plain twins exempt: they
never run on the card), and must give the unguarded step's state bit for
bit (one intra-op thread). So must every segment of the row-space and
table drivers (``test_segment_is_capture_safe``), on the carry the eager
drivers give it.

That the same CPU facade still agrees with the JAX facade is held by
``tests/test_torch_system.py`` (BH tiles, both hash engines, the BH window
engine, the setters) and ``tests/test_torch_sorted_state.py``; the graphed
steps themselves are held to the eager ones on the card
(``tests/test_torch_cuda.py -k step_graph``, ``chip_smoke.py`` phase 11).
"""

import functools

import numpy as np
import pytest
import torch

from capture_guards import guards, one_thread  # noqa: F401 (a fixture)
from nbody_tpu_torch import ParticleSystem
from nbody_tpu_torch.ops.barnes_hut import barnes_hut_forces_sorted
from nbody_tpu_torch.ops.integrator import (
    sorted_state_from,
    sorted_verlet_step,
)
from nbody_tpu_torch.state import ParticleState, SimulationState
from nbody_tpu_torch.types import ForceMethod, SimulationConfig

BH = dict(force_method=ForceMethod.BARNES_HUT, bh_max_level=3,
          barnes_hut_theta=1.0)
HASH = dict(force_method=ForceMethod.SPATIAL_HASH, hash_max_grid_dim=16,
            spatial_hash_cell_size=2.0)
# engine -> (rows, config, kind): kind "sorted" is the cell-sorted step
# run_steps captures, "plain" the Verlet step of update() and of the
# engines without the sorted contract, "monopole" the order-1 BH tiles
# path under the sorted step (a path the facade never selects).
ENGINES = {
    "bh tiles order 2": (400, BH, "sorted"),
    "bh tiles order 1": (400, BH, "monopole"),
    # the window engine needs > 24 rows a finest cell: 1600 rows on 4³
    "bh window": (1600, dict(BH, bh_max_level=2), "plain"),
    "hash window": (400, dict(HASH, hash_engine="window"), "sorted"),
    "hash tiles": (400, dict(HASH, hash_engine="tiles"), "sorted"),
    "direct": (300, dict(force_method=ForceMethod.DIRECT_N2), "plain"),
}


def _system(n, kw):
    rng = np.random.default_rng(17)
    pos = rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    vel = rng.normal(0.0, 0.1, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    cfg = SimulationConfig(particle_count=n, dt=1e-3, **kw)
    ps = ParticleSystem()
    ps.initialize(cfg, device="cpu")
    ps.set_state(SimulationState(pos=pos, vel=vel, mass=mass,
                                 force_method=cfg.force_method, dt=cfg.dt,
                                 G=cfg.G, softening=cfg.softening))
    return ps


@pytest.mark.parametrize("engine", list(ENGINES))
def test_step_is_capture_safe(engine, monkeypatch, one_thread):
    n, kw, kind = ENGINES[engine]
    ps = _system(n, kw)
    cfg = ps.config
    if kind == "plain":
        step, state = ps._step, ps.state
    else:
        state = sorted_state_from(ps.state)
        step = ps._sorted_step
        if kind == "monopole":
            def step(s):
                return sorted_verlet_step(
                    s, lambda p, m: barnes_hut_forces_sorted(
                        p, m, cfg.G, cfg.softening, cfg.barnes_hut_theta,
                        levels=cfg.bh_max_level, near_k=8,
                        multipole_order=1), cfg.dt)
    assert step is not None, f"{engine}: the facade has no such step"
    if engine.startswith("bh"):
        from nbody_tpu_torch.ops.barnes_hut import bh_engine_params

        want = "window" if engine == "bh window" else "tiles"
        assert bh_engine_params(cfg)["near_engine"] == want
    if engine.startswith("hash"):
        p = getattr(ps._sorted_force, "engine_params")
        assert p["engine"] == engine.split()[1]
    state = step(state)  # the warm step: fills the device tables
    want = step(state)
    with guards(monkeypatch):
        got = step(state)
    for k, v in vars(want).items():
        assert torch.equal(getattr(got, k), v), f"{engine}: {k} differs"


# ---- the frozen-grid drivers' segments (ops/integrator.py,
# ops/table_step.py), on the card captured and replayed between host reads

def _hot_scene(n, kw):
    """``n`` rows in [-6, 6]³ at 60·N(0, 1) velocities (a few percent of
    rows cross a cell a step) with a(t) from the config's force."""
    from nbody_tpu_torch.ops.integrator import initialize_forces

    rng = np.random.default_rng(23)
    cfg = SimulationConfig(particle_count=n, dt=1e-3, **kw)
    ps = ParticleSystem()
    ps.initialize(cfg, device="cpu")
    pos = rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    st = ParticleState(pos=torch.from_numpy(pos),
                       vel=torch.from_numpy(
                           (60.0 * rng.normal(size=(n, 3))).astype(
                               np.float32)),
                       acc=torch.zeros(n, 3),
                       mass=torch.from_numpy(
                           rng.uniform(0.5, 1.5, n).astype(np.float32)),
                       time=torch.zeros(()))
    return cfg, initialize_forces(st, ps._force_fn), pos


SEGMENT_ENGINES = {"bh tiles": ENGINES["bh tiles order 2"][1],
                   "hash tiles": dict(HASH, hash_engine="tiles")}
ROW_SEGMENTS = ("sort", "frozen", "frozen_audit")
TABLE_SEGMENTS = ("entry", "drift", "drift_audit", "sort", "build", "tail",
                  "repair")


@functools.cache
def _segment_cases(engine):
    """Each segment of the row-space and table drivers on this engine,
    with the carry it runs on: {name: (fn, carry)}. The carries come from
    the eager drivers' own segments on the hot scene; ``build`` runs at a
    side bucket above the overflow count (padding rows), ``repair`` on a
    mover set longer than the movers (padding entries)."""
    from nbody_tpu_torch.ops import table_step as T
    from nbody_tpu_torch.ops.forces import (
        make_sorted_force_fn,
        make_table_step_params,
    )
    from nbody_tpu_torch.ops.integrator import _row_segments
    from nbody_tpu_torch.ops.step_graph import SegmentGraphs

    cfg, st, pos = _hot_scene(400, SEGMENT_ENGINES[engine])
    sf = make_sorted_force_fn(cfg, pos_hint=pos)
    cases = {}

    def snap(g):
        return {k: v.clone() for k, v in g.buffers.items()}

    rows = _row_segments(sf, cfg.dt)
    g = SegmentGraphs(graphed=False)
    g.load(**vars(sorted_state_from(st)))
    cases["row sort"] = (rows["sort"], snap(g))
    g.run("sort", rows["sort"])
    for name in ROW_SEGMENTS[1:]:
        cases[f"row {name}"] = (rows[name], snap(g))

    tp = make_table_step_params(cfg, device="cuda", pos_hint=pos)
    seg = T._Segments(tp, cfg.dt, repair_cap=256)
    g = SegmentGraphs(graphed=False)
    g.load(in_pos=st.pos, in_vel=st.vel, in_acc=st.acc, in_mass=st.mass,
           in_time=st.time)
    cases["table entry"] = (seg.entry, snap(g))
    g.run("entry", seg.entry)
    total = int(g.buffers["total"])
    cap = T.side_bucket(total)
    assert cap > total
    cases["table build"] = (
        lambda b: vars(T._build_table(b, cap, cfg.dt, tp)), snap(g))
    seg.build(g)
    cases["table drift"] = (seg.drift, snap(g))
    cases["table drift_audit"] = (seg.drift_audit, snap(g))
    g.run("drift_audit", seg.drift_audit)
    assert 0 < int(g.buffers["n_table"]) < seg.repair_cap
    for name in ("sort", "tail", "repair"):
        cases[f"table {name}"] = (getattr(seg, name), snap(g))
    return cases


@pytest.mark.parametrize("segment",
                         [f"row {s}" for s in ROW_SEGMENTS]
                         + [f"table {s}" for s in TABLE_SEGMENTS])
@pytest.mark.parametrize("engine", list(SEGMENT_ENGINES))
def test_segment_is_capture_safe(engine, segment, monkeypatch, one_thread):
    """Every segment the frozen-grid drivers capture runs under the guards
    after a warm run of it, and gives the unguarded segment's values bit
    for bit (each run on its own copy of the carry: segments update some
    buffers in place)."""
    fn, carry = _segment_cases(engine)[segment]

    def run():
        return fn({k: v.clone() for k, v in carry.items()})

    run()
    want = run()
    with guards(monkeypatch):
        got = run()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), f"{engine} {segment}: {k} differs"
