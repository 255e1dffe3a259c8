"""Table-resident stepping of nbody_tpu_torch (``ops/table_step.py``) on the
CPU, where K2, K3 and K4 run their plain twins.

The table drivers are held to the port's own row-space drivers, which the
table stepping must reproduce (positions bit for bit on the same schedule,
velocities within 1e-6·max|v|: the frozen steps sum the finest moments in
another order, the JAX package's own bound), and to the JAX package's
stepping on the same numpy inputs. The JAX cadence and table drivers run
their Pallas kernels in interpret mode only (minutes on this CPU), so the
JAX reference is its XLA stepping with XLA forces, which re-bins every
step: re-sort-every-step physics. Scenes as tests/test_table_step.py's: N =
512 at d = 8, k = 8; a 128-row cluster for the readout.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import barnes_hut as jbh
from nbody_tpu.ops import integrator as jint
from nbody_tpu.ops import spatial_hash as jsh
from nbody_tpu.ops import table_step as jts
from nbody_tpu.state import ParticleState as JState
from nbody_tpu_torch import ParticleSystem
from nbody_tpu_torch.ops import barnes_hut as tbh
from nbody_tpu_torch.ops import integrator as tint
from nbody_tpu_torch.ops import table_step as T
from nbody_tpu_torch.ops.forces import make_table_step_params
from nbody_tpu_torch.ops.spatial_hash import make_spatial_hash_forces_sorted
from nbody_tpu_torch.ops.step_graph import SegmentGraphs
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.types import ForceMethod, SimulationConfig

N, DT = 512, 1e-3
BH_CFG = SimulationConfig(particle_count=N,
                          force_method=ForceMethod.BARNES_HUT,
                          bh_max_level=3, dt=DT)
HASH_CFG = SimulationConfig(particle_count=N,
                            force_method=ForceMethod.SPATIAL_HASH,
                            spatial_hash_cell_size=2.0,
                            spatial_hash_cutoff=2.0, dt=DT)
BH_P = T.bh_table_params(levels=3, near_k=8)
HASH_P = T.hash_table_params(cutoff=2.0, cell_size=2.0, d=8, k=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here hold a few hundred rows: torch's intra-op threads
    only add overhead, and in a run with several test workers they
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sphere(seed, radius=5.0, vel=0.0):
    rng = np.random.default_rng(seed)
    r = np.cbrt(rng.uniform(size=N)) * radius
    v = rng.normal(size=(N, 3))
    pos = v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None]
    return (pos.astype(np.float32),
            (vel * rng.normal(size=(N, 3))).astype(np.float32))


def _cube(seed, half=6.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-half, half, (N, 3)).astype(np.float32),
            np.zeros((N, 3), np.float32))


def _state(sf, pos, vel, mass=None):
    """The port's state with a(t) from its sorted force ``sf``."""
    p = torch.from_numpy(pos)
    m = torch.ones(N) if mass is None else torch.from_numpy(mass)
    acc_s, _, order = sf(p, m)[:3]
    acc = torch.empty_like(acc_s)
    acc[order] = acc_s
    return ParticleState(pos=p, vel=torch.from_numpy(vel), acc=acc, mass=m,
                         time=torch.tensor(0.0))


def _bh_engine():
    """The Barnes-Hut tiles engine at levels 3, k = 8 (the table's k; the
    config's rule would take 16) with its frozen-grid contract."""
    kw = dict(levels=3, near_k=8)

    def sf(pos, mass):
        return tbh.barnes_hut_forces_sorted(pos, mass, **kw)

    sf.with_meta = lambda pos, mass: tbh.barnes_hut_forces_sorted(
        pos, mass, with_grid_meta=True, **kw)
    sf.frozen = lambda psort, meta, with_audit=False: (
        tbh.barnes_hut_forces_frozen(psort, meta, with_audit=with_audit,
                                     **kw))
    sf.stale_count = lambda psort, meta: tbh.stale_count(psort, meta, 8)
    return sf


def _hash_engine(pos):
    sf = make_spatial_hash_forces_sorted(HASH_CFG, pos_hint=pos)
    assert (sf.engine_params["tile_d"], sf.engine_params["tile_k"]) == (8, 8)
    return sf


@functools.cache
def _jax_step(force):
    return jax.jit(jint.make_verlet_step(force, DT))


def _jax_steps(force, st: ParticleState, steps):
    """The JAX package's XLA Verlet steps from the port's state (one jitted
    step per force, compiled once for the module)."""
    step = _jax_step(force)
    js = JState(pos=jnp.asarray(st.pos.numpy()),
                vel=jnp.asarray(st.vel.numpy()),
                acc=jnp.asarray(st.acc.numpy()),
                mass=jnp.asarray(st.mass.numpy()), time=jnp.float32(0.0))
    for _ in range(steps):
        js = step(js)
    return js


def _jax_bh(p, m):
    return jbh.barnes_hut_forces(p, m, 1.0, 0.1, 0.5, levels=3, near_k=8,
                                 near_impl="xla")


def _jax_hash(p, m):
    return jsh.spatial_hash_forces_tiles(p, m, 1.0, 0.1, cutoff=2.0,
                                         cell_size=2.0, d=8, k=8,
                                         impl="xla")


def _same_physics(tab: ParticleState, row: ParticleState):
    """Table vs row-space on one schedule: positions and masses bit-equal,
    velocities within 1e-6·max|v|."""
    assert torch.equal(tab.pos, row.pos)
    assert torch.equal(tab.mass, row.mass)
    scale = float(row.vel.abs().max()) or 1.0
    np.testing.assert_allclose(tab.vel.numpy(), row.vel.numpy(), rtol=0,
                               atol=1e-6 * scale)
    assert bool(torch.isfinite(tab.acc).all())


def _close_to_jax(tab: ParticleState, js):
    """The JAX package's sorted-vs-plain gate (positions rtol 2e-4 / atol
    1e-5, velocities rtol 2e-3 / atol 1e-4), the facade tests' tolerance."""
    np.testing.assert_allclose(tab.pos.numpy(), np.asarray(js.pos),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(tab.vel.numpy(), np.asarray(js.vel),
                               rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("engine", ["bh", "hash"])
def test_fixed_cadence_matches_row_space_and_jax(engine):
    """Cadence 3 over 5 steps (the entry sort, two frozen steps, a re-sort,
    a frozen step): the port's row-space ``make_resort_multi_step`` on the
    same engine, and the JAX XLA stepping."""
    if engine == "bh":
        pos, vel = _sphere(3)
        sf, p, jforce = _bh_engine(), BH_P, _jax_bh
    else:
        pos, vel = _cube(4)
        sf, p, jforce = _hash_engine(pos), HASH_P, _jax_hash
    st = _state(sf, pos, vel)
    tab = T.make_table_multi_step(p, DT, 5, 3)(st)
    _same_physics(tab, tint.make_resort_multi_step(sf, DT, 5, 3)(st))
    _close_to_jax(tab, _jax_steps(jforce, st, 5))
    assert abs(float(tab.time) - 5 * DT) < 1e-7


def _replay(sf, st, resorted):
    """The port's row-space steps on a given schedule: the first step and
    those flagged sort, the others are frozen on the last sort's cells.
    Returns (state, the pre-force stale count of each step after the
    first)."""
    r, (meta,) = tint._sorted_step(tint.sorted_state_from(st),
                                   sf.with_meta, DT)
    counts = []
    for resort in resorted:
        pos_d = r.pos + r.vel * DT + (0.5 * DT * DT) * r.acc
        counts.append(int(sf.stale_count(
            torch.cat([pos_d, r.mass[:, None]], dim=-1), meta)))
        if resort:
            r, (meta,) = tint._sorted_step(r, sf.with_meta, DT)
        else:
            r, _ = tint._frozen_step(r, sf.frozen, meta, DT)
    return tint.to_particle_state(r), counts


def test_adaptive_resorts_exactly_on_stale_steps():
    """``max_stale_frac=0``: a step re-sorts exactly when its pre-force
    audit (the drifted positions against the frozen cells, table and side
    rows) is > 0; the audit equals the row-space recount on the drifted
    rows; the 6-step trace has shape (5,); and the state is the row-space
    replay of that schedule."""
    pos, vel = _sphere(5, vel=1.5)
    sf = _bh_engine()
    st = _state(sf, pos, vel)
    out, (stale, resorted) = T.make_table_adaptive_multi_step(
        BH_P, DT, 6, max_stale_frac=0.0, max_cadence=16, with_trace=True)(st)
    assert stale.shape == resorted.shape == (5,)
    assert stale.dtype == torch.int32 and resorted.dtype == torch.bool
    assert torch.equal(resorted, stale > 0)
    assert resorted.any() and (~resorted).any(), (stale, resorted)
    row, counts = _replay(sf, st, resorted.tolist())
    assert stale.tolist() == counts
    _same_physics(out, row)


@pytest.fixture(scope="module")
def hot():
    """The hot scene of tests/test_table_step.py: the radius-5 sphere with
    60·N(0, 1) velocities, so a few percent of rows cross cells a step;
    the repair run and the JAX XLA every-step reference."""
    pos, vel = _sphere(9, vel=60.0)
    st = _state(_bh_engine(), pos, vel)
    rep, trace = T.make_table_repair_multi_step(
        BH_P, DT, 6, repair_cap=512, max_cadence=64, with_trace=True)(st)
    return st, rep, trace, _jax_steps(_jax_bh, st, 6)


def test_repair_matches_every_step_sorting(hot):
    """Repair stepping (exact incremental re-homing) tracks the JAX XLA
    every-step binning within 1e-4·max|pos| (the JAX package's own bound:
    the far field of the frozen grid geometry differs), masses restored
    exactly, with live movers and no rebuild; and the port's row-space
    every-step sorting within the same bound."""
    st, rep, (stale, rebuilt), js = hot
    assert int(stale.max()) > 0 and not bool(rebuilt.any())
    want = np.asarray(js.pos)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(rep.pos.numpy(), want, rtol=0,
                               atol=1e-4 * scale)
    row = tint.make_sorted_multi_step(_bh_engine(), DT, 6)(st)
    np.testing.assert_allclose(rep.pos.numpy(), row.pos.numpy(), rtol=0,
                               atol=1e-4 * scale)
    assert torch.equal(rep.mass, st.mass)
    assert bool(torch.isfinite(rep.vel).all())


def test_repair_rebuild_trigger():
    """Mover counts beyond ``repair_cap`` (128; velocities 600·N(0, 1))
    force a full rebuild; the run stays finite and restores the masses."""
    pos, vel = _sphere(11, vel=600.0)
    st = _state(_bh_engine(), pos, vel)
    rep, (stale, rebuilt) = T.make_table_repair_multi_step(
        BH_P, DT, 5, repair_cap=128, max_cadence=64, with_trace=True)(st)
    assert bool(rebuilt.any())
    assert torch.equal(rebuilt, stale > 128)
    assert bool(torch.isfinite(rep.pos).all())
    assert torch.equal(rep.mass, st.mass)


def _cluster():
    """128 rows of distinct masses, at rest: 96 in one cell of the d = 8
    grid, far from cell (0, 0, 0), the other 32 spread over [-8, 8]³."""
    rng = np.random.default_rng(7)
    pos = np.concatenate([5.0 + 0.1 * rng.uniform(size=(96, 3)),
                          rng.uniform(-8.0, 8.0, size=(32, 3))])
    pos = pos.astype(np.float32)
    n = pos.shape[0]
    return ParticleState(
        pos=torch.from_numpy(pos), vel=torch.zeros(n, 3),
        acc=torch.zeros(n, 3),
        mass=torch.from_numpy((1.0 + np.arange(n) / 256.0).astype(
            np.float32)),
        time=torch.tensor(0.0))


def _own_cells(ts, pos, p):
    return T._bin_ids(pos[:, 0], pos[:, 1], pos[:, 2], ts.lo, ts.cell, p)


def _within(ts, p):
    """Per row of the last re-sort's order: whether it lives in its own
    slot or side row (not read from a shared slot)."""
    nck = p.d ** 3 * p.k
    idx = ts.idx_ext.long()
    own = ts.slot_row[idx.clamp(max=nck - 1)] == torch.arange(
        idx.shape[0], dtype=torch.int32)
    return (idx >= nck) | own


def test_readout_is_a_permutation_beyond_the_side_buffer():
    """k = 8 slots for a 96-row cell: the 88 rows past the k cap ride the
    side buffer, sized at the re-sort to every one of them. The readout is
    a permutation at entry and after a repair step that empties slot k-1
    of that cell (its row moves two cells away): every original row
    appears once (the tags are a permutation and the distinct masses come
    back row for row) and keeps its own state (the drift of its own
    position), side rows included. (The JAX package's static side buffer
    lets the rows beyond it read slot k-1's state, tag included, and its
    argsort readout then duplicates a tag.)"""
    st = _cluster()
    n = st.n
    p = T.bh_table_params(levels=3, near_k=8)
    ts = T._entry(st, DT, p)
    assert ts.side.shape[0] == 96 - 8
    cells = _own_cells(ts, st.pos, p)
    assert int(cells[:96].unique().numel()) == 1
    assert int(cells[0]) != 0

    def check(ts, want_pos):
        assert torch.equal(torch.sort(ts.tag).values,
                           torch.arange(n, dtype=torch.int32))
        assert bool(_within(ts, p).all())
        out = T.table_to_particle_state(ts, p)
        assert torch.equal(out.mass, st.mass)
        side = torch.zeros(n, dtype=torch.bool)
        side[ts.tag.long()] = ts.idx_ext >= p.d ** 3 * p.k
        assert int(side.sum()) == 96 - 8
        assert torch.equal(out.pos, want_pos)
        assert bool(torch.isfinite(out.vel).all())

    check(ts, st.pos)

    # the row in slot k-1 of the cluster cell moves two cells down in x
    c = int(cells[0])
    d2 = p.d * p.d
    x, yz = c // d2, c % d2
    assert float(ts.cov_t[x, 0, p.k - 1, yz]) == 1.0
    vel_t = ts.vel_t.clone()
    vel_t[x, 0, p.k - 1, yz] = -4.0 / DT
    ts = dataclasses.replace(ts, vel_t=vel_t)
    base = T.table_to_particle_state(ts, p)
    want = base.pos + base.vel * DT + (0.5 * DT * DT) * base.acc
    pos_d_t, vel_h, side_pd, mover, n_stale = T._drift(ts, DT, p, audit=True)
    assert int(mover[x, p.k - 1, yz]) >= 0
    ts2 = T._repair_step(ts, pos_d_t, vel_h, side_pd, mover, int(n_stale),
                         DT, p)
    assert float(ts2.cov_t[x, 0, p.k - 1, yz]) == 0.0
    assert float(ts2.live[c]) == p.k - 1
    check(ts2, want)


def test_exact_side_buffer_holds_every_overflow_row():
    """The side buffer is sized at each re-sort to every row past the k
    cap: on the 96-row cell no row reads a shared slot, and the cadence-3
    table run equals the row-space cadence on the same engine (positions
    and masses bit for bit, velocities within 1e-6·max|v|)."""
    st = _cluster()
    p = T.bh_table_params(levels=3, near_k=8)
    ts = T._entry(st, DT, p)
    assert ts.side.shape[0] == 96 - 8
    assert bool(_within(ts, p).all())
    sf = _bh_engine()
    _same_physics(T.make_table_multi_step(p, DT, 5, 3)(st),
                  tint.make_resort_multi_step(sf, DT, 5, 3)(st))


def test_side_bucket_grows_and_drivers_match_jax_tables(monkeypatch):
    """A collapsing cube (256 rows in [-4, 4]³ at velocity −150·x) whose
    rows past k = 8 grow from 22 at entry to 139 and 248 at the re-sorts:
    with the least bucket cut to 16 rows the side buffer starts at 32 and
    grows once, to 256, between re-sorts (padding rows at entry and after
    the growth). The port's fixed cadence (2, 5 steps) and audited re-sort
    (0.05, cap 4, 5 steps, with its trace) equal the JAX package's table
    drivers run with a static ``side_cap`` of 256 (every overflow row a
    side row) within the facade tests' tolerance, the traces equal."""
    monkeypatch.setattr(T, "SIDE_MIN", 16)
    n = 256
    rng = np.random.default_rng(13)
    pos = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    vel = (-150.0 * pos).astype(np.float32)
    st = ParticleState(pos=torch.from_numpy(pos), vel=torch.from_numpy(vel),
                       acc=torch.zeros(n, 3), mass=torch.ones(n),
                       time=torch.tensor(0.0))
    js = JState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                acc=jnp.zeros((n, 3), jnp.float32),
                mass=jnp.ones((n,), jnp.float32), time=jnp.float32(0.0))
    jp = jts.hash_table_params(cutoff=2.0, cell_size=2.0, d=8, k=8,
                               side_cap=256, impl="pallas_interpret")

    g = SegmentGraphs(graphed=False)
    tab = T.make_table_multi_step(HASH_P, DT, 5, 2, graphs=g)(st)
    assert g.state == {"side_cap": 256, "side_grows": 1}
    assert g.host_reads == 3
    _close_to_jax(tab, jax.jit(jts.make_table_multi_step(jp, DT, 5, 2))(js))

    g = SegmentGraphs(graphed=False)
    ada, (stale, resorted) = T.make_table_adaptive_multi_step(
        HASH_P, DT, 5, max_stale_frac=0.05, max_cadence=4, with_trace=True,
        graphs=g)(st)
    assert g.state["side_grows"] >= 1
    jout, (jstale, jresorted) = jax.jit(jts.make_table_adaptive_multi_step(
        jp, DT, 5, max_stale_frac=0.05, max_cadence=4, with_trace=True))(js)
    _close_to_jax(ada, jout)
    assert stale.tolist() == np.asarray(jstale).tolist()
    assert resorted.tolist() == np.asarray(jresorted).tolist()


def test_make_table_step_params():
    """None on the CPU; parameters on a CUDA device for Barnes-Hut tiles
    and hash tiles (from the config's knobs); None for direct N² and for
    N ≥ 2²⁴ (the JAX bridge's rules)."""
    assert make_table_step_params(BH_CFG, device="cpu") is None
    tp = make_table_step_params(BH_CFG, device="cuda")
    assert (tp.mode, tp.d, tp.k, tp.levels, tp.ws) == ("bh", 8, 16, 3, 1)
    assert (tp.G, tp.softening) == (BH_CFG.G, BH_CFG.softening)
    pos = _cube(4, half=8.0)[0]
    hp = make_table_step_params(HASH_CFG.replace(hash_engine="tiles"),
                                device="cuda", pos_hint=pos)
    assert hp.mode == "hash" and hp.d == 16 and hp.k == 8
    assert hp.cutoff2 == pytest.approx(4.0)
    assert hp.cell_size == pytest.approx(2.0)
    assert make_table_step_params(
        BH_CFG.replace(force_method=ForceMethod.DIRECT_N2),
        device="cuda") is None
    assert make_table_step_params(BH_CFG.replace(particle_count=1 << 24),
                                  device="cuda") is None


def test_bad_parameters_raise():
    with pytest.raises(ValueError, match="mode"):
        T.make_table_multi_step(dataclasses.replace(BH_P, mode="nope"), DT, 2)
    with pytest.raises(ValueError, match="2\\^levels"):
        T.make_table_multi_step(dataclasses.replace(BH_P, levels=2), DT, 2)
    with pytest.raises(ValueError, match="resort_every"):
        T.make_table_multi_step(BH_P, DT, 2, 0)
    with pytest.raises(ValueError, match="max_stale_frac"):
        T.make_table_adaptive_multi_step(BH_P, DT, 2, max_stale_frac=2.0)
    with pytest.raises(ValueError, match="repair_cap"):
        T.make_table_repair_multi_step(BH_P, DT, 2, repair_cap=64)
    with pytest.raises(ValueError, match="fused"):
        T.make_table_multi_step(dataclasses.replace(HASH_P, k=12), DT, 2)


@pytest.mark.parametrize(
    "knobs,direct,row",
    [(dict(resort_every=3),
      lambda p: T.make_table_multi_step(p, DT, 4, 3),
      lambda sf: tint.make_resort_multi_step(sf, DT, 4, 3)),
     (dict(resort_stale_frac=0.01),
      lambda p: T.make_table_adaptive_multi_step(
          p, DT, 4, max_stale_frac=0.01, max_cadence=16),
      lambda sf: tint.make_adaptive_multi_step(
          sf, DT, 4, max_stale_frac=0.01, max_cadence=16)),
     (dict(resort_repair=True, resort_every=3),
      lambda p: T.make_table_repair_multi_step(p, DT, 4, max_cadence=3),
      lambda sf: tint.make_resort_multi_step(sf, DT, 4, 3))],
    ids=["cadence", "stale_frac", "repair"])
def test_facade_runs_the_table_driver_where_params_exist(monkeypatch, knobs,
                                                         direct, row):
    """Where ``make_table_step_params`` gives parameters (the card; here
    forced on the CPU) and ``TABLE_ROUTES`` holds the engine and knob,
    ``run_steps`` takes the table driver the JAX facade's rule names, with
    its caps, and equals a direct call of it bit for bit; without the
    route it takes the row-space choice (for repair with a cadence, the
    cadence)."""
    import nbody_tpu_torch.system as system

    monkeypatch.setattr(system, "make_table_step_params",
                        lambda cfg, device, pos_hint=None: BH_P)
    knob = system._resort_knob(BH_CFG.replace(**knobs))
    for routes, want_table in ((system.TABLE_ROUTES | {("bh", knob)}, True),
                               (frozenset(), False)):
        monkeypatch.setattr(system, "TABLE_ROUTES", routes)
        ps = ParticleSystem()
        ps.initialize(BH_CFG.replace(**knobs), device="cpu")
        assert (ps._table_params is not None) == want_table
        want = (direct(ps._table_params) if want_table
                else row(ps._sorted_force))(ps.state)
        ps.run_steps(4)
        for f in ("pos", "vel", "acc", "mass", "time"):
            assert torch.equal(getattr(ps.state, f), getattr(want, f)), f
