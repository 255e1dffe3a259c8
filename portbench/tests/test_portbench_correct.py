"""The comparison that decides ``correct``, on the CPU at small sizes: the
references against brute force, the control (the reference in the nearest
lower precision) failing each cell's limit, and a run with its timed path
broken underneath coming out not correct, once for each fault a cell can
have."""

import dataclasses
import time

import pytest
import torch

from portbench import check, control, core
from portbench.reference import bh, hash as hash_ref, render

SMALL = {"bh1m-sphere": {"particle_count": 4096, "bh_max_level": 3}}
SPHERE = {"kind": "sphere", "radius": 10.0, "total_mass": 1.0}


def _direct(pos, mass, targets, eps, G=1.0):
    p, m = pos.double(), mass.double()
    d = p[None, :, :] - p[targets][:, None, :]
    r2 = (d * d).sum(-1)
    w = torch.where(r2 == 0, 0.0, m[None] * (r2 + eps * eps) ** -1.5)
    return G * (w[..., None] * d).sum(1)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 3 * 2 ** -11)])
    assert bh.tf32(x).tolist() == [1 + 2 ** -10, 1.0, -(1 + 2 ** -9)]


def test_bh_reference_is_barnes_hut_of_the_direct_sum():
    sim = {"particle_count": 3000, "bh_max_level": 3, "softening": 0.1}
    pos, _, mass = core.make_scene(SPHERE, 3000, 5, "cpu")
    t = torch.arange(0, 3000, 7)
    acc, ok, band, counts = bh.accelerations(pos, mass, t, sim)
    exact = _direct(pos, mass, t, 0.1)
    rel = ((acc - exact).norm(dim=1) / exact.norm(dim=1))[ok]
    assert ok.float().mean() > 0.5 and int(counts.sum()) == 3000
    assert float(rel.median()) < 5e-3 and float(rel.max()) < 0.05
    assert float(band.abs().max()) == 0.0


def test_hash_reference_is_the_published_pair_predicate():
    sim = {"spatial_hash_cell_size": 1.0, "spatial_hash_cutoff": 2.0,
           "softening": 0.1, "G": 1.0}
    pos, _, mass = core.make_scene({**SPHERE, "radius": 3.0}, 2000, 6, "cpu")
    t = torch.arange(0, 2000, 3)
    acc, _, band, _ = hash_ref.accelerations(pos, mass, t, sim)
    _, coords = hash_ref.geometry(pos, 1.0, 64)
    near = ((coords[None, :, :] - coords[t][:, None, :]).abs() <= 1).all(-1)
    p = pos.double()
    d = p[None] - p[t][:, None]
    r2 = (d * d).sum(-1)
    keep = near & (r2 <= 4.0) & (r2 > 0)
    w = torch.where(keep, mass.double()[None] * (r2 + 0.01) ** -1.5, 0.0)
    exact = (w[..., None] * d).sum(1)
    assert torch.allclose(acc, exact, rtol=1e-12, atol=1e-15)
    assert float(band.max()) >= 0.0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_accelerations_are_not_correct(seed):
    """The reference's accelerations with TF32 far-field products read
    above the BH cells' acc_gap limit (at 1M on the card 6.7e-5 or more,
    here ~1e-4)."""
    cfg = core.load_json("configs", "bh1m-sphere")
    n = 262144
    sim = {**cfg["simulation"], "bh_max_level": 5, "particle_count": n}
    pos, _, mass = core.make_scene(cfg["scene"], n, seed, "cpu")
    t = check.sample_rows(n, seed, 4096)
    ref = check.follow({"pos": pos, "vel": torch.zeros_like(pos),
                        "acc": torch.zeros_like(pos)}, pos, mass, t, sim,
                       "bh", ["fresh"], True)
    ctrl = check.follow({"pos": pos, "vel": torch.zeros_like(pos),
                         "acc": torch.zeros_like(pos)}, pos, mass, t, sim,
                        "bh", ["fresh"], True, control=True)
    gap = check.gaps(ctrl, ref, float(sim["dt"]))[0]["acc_gap"]
    assert gap > core.load_json("limits", "bh1m-sphere.run")["acc_gap"][
        "limit"]


def _cells():
    return [(c["name"], c["config"]) for c in core.manifest()["workloads"]]


@pytest.mark.parametrize("workload,config", _cells())
def test_the_control_over_the_probe_is_not_correct(workload, config):
    """The control in the program's place over the cell's probe (TF32
    far field, state in bfloat16) fails the positions' limit, while the
    program's run is correct."""
    rec = control.readings(workload, 2 ** 31 + 7, 0.01, time.perf_counter(),
                           device="cpu", sim_override=SMALL[config])
    limits = core.load_json("limits", workload)
    assert rec["correct"] is True
    assert rec["control_pos_gap"] > limits["pos_gap"]["limit"]


def test_a_frozen_probe_step_takes_the_sorting_steps_cells():
    """A frozen step's reference bins by the positions its sort drifted
    to: at a state whose rows then cross cells, its accelerations differ
    from the same step's binned anew."""
    cfg = core.load_json("configs", "bh1m-sphere")
    n = 4096
    sim = {**cfg["simulation"], **SMALL["bh1m-sphere"]}
    pos, _, mass = core.make_scene(cfg["scene"], n, 3, "cpu")
    vel = torch.randn(pos.shape, generator=torch.Generator().manual_seed(3))
    s0 = {"pos": pos, "vel": vel * 100.0, "acc": torch.zeros_like(pos)}
    end = check.drift32(check.drift32(pos, s0["vel"], s0["acc"], 1e-3),
                        s0["vel"], s0["acc"], 1e-3)
    t = torch.arange(n)
    frozen = check.follow(s0, end, mass, t, sim, "bh", ["fresh", "frozen"],
                          False)
    fresh = check.follow(s0, end, mass, t, sim, "bh", ["fresh", "fresh"],
                         False)
    ok = frozen["ok"] & fresh["ok"]
    assert not torch.equal(frozen["acc"][ok], fresh["acc"][ok])


def _wrap_forces(system, fn):
    """Rebuild the facade's steps on its force closures passed through
    ``fn(kind, call)``: the timed path broken underneath the facade."""
    system._force_fn = fn("plain", system._force_fn)
    sf = system._sorted_force
    if sf is not None:
        new = fn("sorted", sf)
        for attr, kind in (("with_meta", "sorted"), ("frozen", "frozen")):
            if hasattr(sf, attr):
                setattr(new, attr, fn(kind, getattr(sf, attr)))
        new.route_extra = sf.route_extra
        system._sorted_force = new
    system._step, system._sorted_step = system._make_steps(system.config.dt)


def _half_sources(system):
    """Half of the particles left out of every force evaluation."""
    def fn(kind, call):
        if kind == "frozen":
            def frozen(psort, meta, with_audit=False):
                psort = psort.clone()
                psort[1::2, 3] = 0.0
                return call(psort, meta, with_audit=with_audit)
            return frozen

        def force(pos, mass, *a, **k):
            mass = mass.clone()
            mass[1::2] = 0.0
            return call(pos, mass, *a, **k)
        return force
    _wrap_forces(system, fn)


def _altered(system):
    """Every acceleration altered by one part in a thousand where it is
    produced."""
    def fn(kind, call):
        def force(*a, **k):
            out = call(*a, **k)
            if kind == "plain":
                return out * 1.001
            if isinstance(out, tuple):
                return (out[0] * 1.001,) + tuple(out[1:])
            return out * 1.001
        return force
    _wrap_forces(system, fn)


def _unchanged(system):
    """Every step returns the state it was given."""
    system.run_steps = lambda n: None
    system.update = lambda dt=None: None


def _after_each_call(system, fn):
    """``fn(before, after) -> state`` on each call's state."""
    def wrap(call):
        def wrapped(*a, **k):
            before = system.state
            call(*a, **k)
            system._state = fn(before, system.state)
        return wrapped
    system.run_steps = wrap(system.run_steps)
    system.update = wrap(system.update)


def _frozen_state(system):
    """Positions and velocities left as they were, while the time and the
    accelerations advance."""
    _after_each_call(system, lambda b, a: dataclasses.replace(
        a, pos=b.pos, vel=b.vel))


def _wrong_kick(system):
    """The last half-kick taken twice: the velocities off by ½·dt·a."""
    dt = system.config.dt
    _after_each_call(system, lambda b, a: dataclasses.replace(
        a, vel=a.vel + (0.5 * dt) * a.acc))


FAULTS = {"unchanged": _unchanged, "half_sources": _half_sources,
          "altered": _altered, "frozen_state": _frozen_state,
          "wrong_kick": _wrong_kick}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload,config", _cells())
def test_a_broken_timed_path_is_not_correct(workload, config, fault):
    out, _ = core.run(workload, 2 ** 31 + 5, 0.01, False,
                      time.perf_counter(), device="cpu",
                      sim_override=SMALL[config], on_system=FAULTS[fault])
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_an_altered_frame_is_not_correct(monkeypatch):
    from nbody_tpu_torch.ops import render as render_ops

    real = render_ops.render_points

    def altered(*a, **k):
        out = real(*a, **k)
        u8 = out.image_u8.clone()
        u8[360, 640, 0] ^= 1
        return out._replace(image_u8=u8)

    monkeypatch.setattr(render_ops, "render_points", altered)
    out, _ = core.run("bh1m-sphere.frames", 2 ** 31 + 6, 0.01, False,
                      time.perf_counter(), device="cpu",
                      sim_override=SMALL["bh1m-sphere"])
    assert out["correct"] is False
    assert out["checks"]["image_gap"]["value"] == 1.0


def test_the_frame_reference_matches_a_frame_by_hand():
    # one point straight ahead of the camera: a disc at the image centre
    traffic = {"width": 64, "height": 36, "point_size": 2.0,
               "color_mode": "DEPTH",
               "camera": {"distance": 45.0, "azimuth": 0.0,
                          "elevation": 0.0}}
    img = render.frame(torch.zeros((1, 3)), traffic)
    lit = (img.sum(-1) > 0).nonzero().tolist()
    # size 2·30/45 = 1.33 px → radius 1: the centre and its 4 neighbours
    assert sorted(lit) == [[17, 32], [18, 31], [18, 32], [18, 33], [19, 32]]
    assert img[18, 32].tolist() == [255, 165, 76]
