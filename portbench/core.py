"""The harness: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, driver,
per-layer metric or kernel count is a file of its own, found by the name
the manifest gives it:

  configs/<config>.json     sizes, scene, reference (what is simulated)
  scenes/<kind>.py          ``make(n, seed, device, **sizes)``: the inputs
  traffic/<traffic>.json    the mix: its driver and that driver's knobs
  drivers/<driver>.py       the closed loop that drives the program
  metrics/<metric>.py       ``read(ctx)`` → a per-layer value or None
  kernels/<kernel>.py       a kernel's operations and bytes (rooflines)
  limits/<workload>.json    the limit of each number ``correct`` compares

A run: the inputs made on the card from the seed and handed to
``nbody_tpu_torch.ParticleSystem``; the traffic driver's warm-up (captures,
first launches); the window of ``--seconds`` (traced for its
``trace_iters`` iterations after ``trace_lead`` more with ``--trace 1``);
the peak memory; the probe (``check``: a step or two more through the
window's own call); the program's state freed; the comparison with the
plain reference; one JSON line.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "nbody_tpu"})


class Refused(Exception):
    """The run cannot be made here (no card, an unknown cell)."""


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` (names may hold dots and dashes)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(man: dict, workload: str) -> dict:
    for c in man["workloads"]:
        if c["name"] == workload:
            return c
    raise Refused(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(man: dict, key: str, workload: str) -> list:
    """The ``key`` ("end_to_end" or "per_layer") metrics this cell reports."""
    return [m for m in man[key]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def simulation_config(sim: dict):
    """``nbody_tpu_torch.SimulationConfig`` of a ``simulation`` block."""
    from nbody_tpu_torch import ForceMethod, SimulationConfig

    kw = dict(sim)
    if "force_method" in kw:
        kw["force_method"] = ForceMethod.parse(kw["force_method"])
    return SimulationConfig(**kw)


def make_scene(scene: dict, n: int, seed: int, device):
    """The inputs a configuration's ``scene`` block describes:
    ``scenes/<kind>.py``'s ``make(n, seed, device, **sizes)``."""
    kw = {k: v for k, v in scene.items() if k != "kind"}
    return load_module("scenes", scene["kind"]).make(n, seed, device, **kw)


class Context:
    """What a driver, a check and a metric reader see of a run."""

    def __init__(self, workload, cell, config, traffic, seed, device):
        self.workload, self.cell = workload, cell
        self.config, self.traffic = config, traffic
        self.sim = {**config["simulation"], **traffic.get("simulation", {})}
        self.seed, self.device = seed, device
        self.trace = None        # trace.Trace of a traced run
        self.final = None        # dict(pos, vel, acc, mass, time, steps)
        #                          as the window left it


def build_system(ctx: Context):
    """The program's facade holding the benchmark's inputs → (system,
    inputs, start_gap). ``initialize`` then ``set_state``: the CLI's
    ``--import`` path, so the program takes the benchmark's state."""
    from nbody_tpu_torch import ParticleSystem, SimulationState

    from portbench import check

    cfg = simulation_config(ctx.sim)
    pos, vel, mass = make_scene(ctx.config["scene"], cfg.particle_count,
                                ctx.seed, ctx.device)
    system = ParticleSystem()
    system.initialize(cfg, device=ctx.device)
    system.set_state(SimulationState(
        pos=pos.cpu().numpy(), vel=vel.cpu().numpy(),
        mass=mass.cpu().numpy(), dt=cfg.dt, G=cfg.G,
        softening=cfg.softening, force_method=cfg.force_method),
        device=ctx.device)
    st = system.state
    given = {"pos": pos, "vel": vel, "mass": mass}
    gap = check.start_gap({"pos": st.pos, "vel": st.vel, "mass": st.mass},
                          given)
    return system, given, gap


def run(workload: str, seed: int, seconds: float, traced: bool,
        t_start: float, device=None, sim_override: dict | None = None,
        on_system=None, on_final=None):
    """One run → (the result dict, the last line's object, with ``checks``
    last; notes for standard error). ``device``,
    ``sim_override`` and ``on_system`` serve the tests: a CPU
    run at a small size, with a hook that can break the program, and
    ``on_final(ctx, given, targets, s1)`` one that sees the states and the
    rows compared (the control)."""
    man = manifest()
    cell = cell_of(man, workload)
    config = load_json("configs", cell["config"])
    traffic = load_json("traffic", cell["traffic"])
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is False: this "
                          "benchmark runs on CUDA cards only")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise Refused(f"{workload} needs {cell['chips']} cards, "
                          f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if sim_override:
        config = {**config, "simulation": {**config["simulation"],
                                           **sim_override}}
    ctx = Context(workload, cell, config, traffic, seed, device)
    driver_mod = load_module("drivers", traffic["driver"])
    from portbench import check, trace

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    phases = {"imports": time.perf_counter() - t_start}
    system, given, gap0 = build_system(ctx)
    phases["state"] = time.perf_counter() - t_start
    if on_system is not None:
        on_system(system)
    drv = driver_mod.Driver(system, ctx)
    drv.warm()
    sync()

    events = None
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    units = iters = 0
    traced_units = 0
    if traced:
        with trace.profiled() as events:
            # the lead keeps the device busy as the traced window opens
            for _ in range(int(traffic["trace_lead"])):
                units += drv.step()
                iters += 1
            with trace.span("window"):
                for _ in range(int(traffic["trace_iters"])):
                    units += drv.step()
                    iters += 1
                units += drv.finish()
        traced_units = units
    while time.perf_counter() - t0 < seconds:
        units += drv.step()
        iters += 1
    units += drv.finish()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    kinds = list(traffic["probe"])
    s0 = drv.final()
    drv.probe(len(kinds))
    s1 = drv.final()
    ctx.final = s0
    e2e = drv.end_to_end(units, window_s)
    del drv, system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    targets = check.sample_rows(s0["pos"].shape[0], seed).to(device)
    start_known = traffic["last_step"] == "fresh"
    ref = check.follow(s0, s1["pos"], given["mass"], targets, ctx.sim,
                       config["reference"], kinds, start_known)
    got = {"acc0": s0["acc"][targets] if start_known else None,
           **{k: s1[k][targets] for k in ("pos", "vel", "acc")}}
    numbers, compared = check.gaps(got, ref, float(ctx.sim["dt"]))
    if on_final is not None:
        on_final(ctx, given, targets, s1)
    numbers["start_gap"] = gap0
    numbers["steps_gap"] = check.steps_gap(s1["time"], s1["steps"],
                                           ctx.sim["dt"])
    if "image" in s0:
        from portbench.reference import render

        numbers["image_gap"] = render.image_gap(s0["image"], s0["pos"],
                                                traffic)
    judged = check.judge(numbers, load_json("limits", workload))
    check_s = time.perf_counter() - t_check
    correct = all(v <= lim for _, v, lim in judged)

    if traced:
        ctx.trace = trace.reduce(events, traced_units)
        del events
        wanted = metrics_of(man, "per_layer", workload)
    else:
        wanted = metrics_of(man, "end_to_end", workload)
    metrics = {}
    for m in wanted:
        if m["name"] == "setup_s":
            value = setup_s
        elif traced:
            value = load_module("metrics", m["name"]).read(ctx)
        else:
            value = e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    out = {
        "correct": bool(correct),
        "attempted": int(units),
        "failed": 0 if correct else int(units),
        "metrics": metrics,
        "device": device_info,
    }
    if traced:
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        out["breakdown"] = ctx.trace.breakdown()
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in judged}
    return out, {"compared_rows": compared, "window_s": window_s,
                 "iterations": iters, "setup_phases_s": phases,
                 "check_s": check_s}
