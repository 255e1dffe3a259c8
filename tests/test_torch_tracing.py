"""The profiling switch's trace setting
(``nbody_tpu_torch/utils/profiling.py``), on the CPU.

With the setting off or on a step opens no ``nbody.*`` span and launches
no phase mark; in the trace setting a Barnes-Hut step's phases are flat
spans in the step's order. Marks are launched on CUDA devices only: here
their order is checked through a recorder in place of the launch, and
``phase_times`` reads them from synthetic trace events; the card's own
marks inside graph replays are checked by ``tests/test_torch_cuda.py -k
phase_marks``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nbody_tpu_torch import ParticleSystem
from nbody_tpu_torch.ops import integrator as tint
from nbody_tpu_torch.ops.step_graph import SegmentGraphs
from nbody_tpu_torch.state import SimulationState
from nbody_tpu_torch.types import ForceMethod, SimulationConfig
from nbody_tpu_torch.utils import profiling as tprof

PKG = Path(tprof.__file__).resolve().parent.parent
BH_PHASES = ("bh.sort", "bh.placement", "bh.pyramid", "bh.far", "bh.sweep",
             "bh.pickup")


@pytest.fixture
def setting():
    """Restores the process's profiling setting after the test."""
    before = tprof.profiling_enabled()
    yield tprof.set_profiling_enabled
    tprof.set_profiling_enabled(before)


@pytest.fixture(scope="module")
def steps():
    """One step of each kind on 400 rows of the BH tiles engine (d 8),
    each after a warm step: the cell-sorted step ``run_steps`` captures,
    the frozen step of the cadence driver on the sorted step's cells, and
    the plain step of ``update()``."""
    rng = np.random.default_rng(17)
    n = 400
    cfg = SimulationConfig(particle_count=n, dt=1e-3,
                           force_method=ForceMethod.BARNES_HUT,
                           bh_max_level=3, barnes_hut_theta=1.0)
    ps = ParticleSystem()
    ps.initialize(cfg, device="cpu")
    ps.set_state(SimulationState(
        pos=rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32),
        vel=rng.normal(0.0, 0.1, (n, 3)).astype(np.float32),
        mass=rng.uniform(0.5, 1.5, n).astype(np.float32),
        force_method=cfg.force_method, dt=cfg.dt, G=cfg.G,
        softening=cfg.softening))
    sorted0 = tint.sorted_state_from(ps.state)
    segs = tint._row_segments(ps._sorted_force, cfg.dt)
    carry = SegmentGraphs(graphed=False)
    carry.load(**vars(sorted0))
    carry.run("sort", segs["sort"])
    cases = {
        "sorted": lambda: ps._sorted_step(sorted0),
        "frozen": lambda: carry.run("frozen", segs["frozen"]),
        "plain": lambda: ps._step(ps.state),
    }
    for run in cases.values():
        run()
    return cases


WANT = {
    "sorted": ("step.drift", *BH_PHASES, "step.kick"),
    "frozen": ("step.drift", *BH_PHASES[1:], "step.kick"),
    "plain": ("step.drift", *BH_PHASES, "step.kick"),
}


def _spans(run) -> list:
    """The ``nbody.*`` spans one call of ``run`` opens: (start, end, phase)
    in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return sorted((e.time_range.start, e.time_range.end,
                   e.name[len(tprof.SPAN_PREFIX):])
                  for e in prof.events()
                  if e.name.startswith(tprof.SPAN_PREFIX))


def _no_mark(*args):
    raise AssertionError(f"a phase mark was launched: {args}")


def _fake_card(monkeypatch):
    """A CUDA device's phase here: no capture, marks loaded."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(tprof, "_load_marks", lambda device: None)


@pytest.mark.parametrize("kind", list(WANT))
@pytest.mark.parametrize("value", [False, True])
def test_outside_the_trace_setting_a_step_opens_no_span(
        steps, setting, monkeypatch, kind, value):
    monkeypatch.setattr(tprof, "_mark", _no_mark)
    setting(value)
    assert _spans(steps[kind]) == []


@pytest.mark.parametrize("kind", list(WANT))
def test_trace_setting_spans_each_phase_flat_in_order(steps, setting, kind):
    setting("trace")
    spans = _spans(steps[kind])
    assert tuple(name for _, _, name in spans) == WANT[kind]
    for (_, end, _), (start, _, _) in zip(spans, spans[1:]):
        assert end <= start, f"{kind}: nested spans {spans}"


def test_marks_bracket_each_listed_phase_on_a_cuda_device(setting,
                                                          monkeypatch):
    """While a profiler records, a listed phase on a CUDA device launches
    its entry mark before the block and its exit mark after; a nested
    phase's marks lie inside; a phase the table does not list launches
    none, nor does a phase on the CPU. The recorder stands in for the
    launch (no card here); ``timed=False`` records no events."""
    marks = []
    _fake_card(monkeypatch)
    monkeypatch.setattr(tprof, "_mark",
                        lambda dev, p, e: marks.append((tprof.PHASES[p], e)))
    setting("trace")
    with profile(activities=[ProfilerActivity.CPU]):
        with tprof.profile_phase("step.drift", device="cuda", timed=False):
            marks.append("body")
            with tprof.profile_phase("graph.copy_back", device="cuda:0",
                                     timed=False):
                pass
            with tprof.profile_phase("not.listed", device="cuda",
                                     timed=False):
                pass
        with tprof.profile_phase("bh.far", device="cpu", timed=False):
            pass
    assert marks == [("step.drift", 0), "body", ("graph.copy_back", 0),
                     ("graph.copy_back", 1), ("step.drift", 1)]


def test_no_span_while_no_profiler_records(setting, monkeypatch):
    """In the trace setting with no profiler recording a phase opens no
    span, and on the CPU launches nothing."""
    monkeypatch.setattr(tprof, "_mark", _no_mark)
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    setting("trace")
    with tprof.profile_phase("bh.far", device="cpu", timed=False):
        pass
    with tprof.host_span("graph.replay"):
        pass
    assert opened == []


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_an_exception_inside_a_phase_propagates_unchanged(
        setting, monkeypatch, device):
    """In the trace setting an error raised inside a phase reaches the
    caller as itself; the span closes, the exit mark is not launched and
    nothing is timed."""
    marks = []
    _fake_card(monkeypatch)
    monkeypatch.setattr(tprof, "_mark", lambda dev, p, e: marks.append(e))
    setting("trace")
    p = tprof.PhaseProfiler()
    err = ImportError("inner")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ImportError) as got:
            with tprof.profile_phase("bh.far", device=device, profiler=p,
                                     timed=device == "cpu"):
                raise err
    assert got.value is err
    assert marks == ([0] if device == "cuda" else [])
    assert p.consume() == {}
    assert [e.name for e in prof.events()
            if e.name.startswith(tprof.SPAN_PREFIX)] == ["nbody.bh.far"]


def test_host_span_only_in_the_trace_setting(setting):
    for value, want in ((False, []), (True, []),
                        ("trace", ["nbody.graph.replay"])):
        setting(value)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tprof.host_span("graph.replay"):
                pass
        assert [e.name for e in prof.events()
                if e.name.startswith(tprof.SPAN_PREFIX)] == want


def test_setting_values_and_environment(setting):
    for value in (False, True, "trace"):
        setting(value)
        assert tprof.profiling_enabled() == value
    with pytest.raises(ValueError, match="profiling setting"):
        setting("on")
    assert tprof._setting_of("0") is False
    assert tprof._setting_of("1") is True
    assert tprof._setting_of("trace") == "trace"


class _Event:
    """A CUDA event stand-in: complete or not; waiting on one that is not
    complete fails the test."""

    def __init__(self, done: bool):
        self.done = done

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        assert self.done, "waited on an unfinished event"

    def elapsed_time(self, end) -> float:
        return 2.0


def test_record_events_past_the_limit_waits_on_no_unfinished_event():
    """Past ``MAX_PENDING`` pairs ``record_events`` resolves the pairs up to
    the first whose end event has not completed and waits on none; the
    rest stay pending until ``snapshot``, which waits."""
    p = tprof.PhaseProfiler()
    done = 10
    pairs = [(_Event(True), _Event(i < done))
             for i in range(tprof.MAX_PENDING + 5)]
    for start, end in pairs:
        p.record_events("render.copy", start, end)
    assert len(p._pending) == len(pairs) - done
    for _, end in pairs:
        end.done = True
    snap = p.snapshot()
    assert snap["render.copy"].samples == len(pairs)
    assert snap["render.copy"].total_ms == 2.0 * len(pairs)
    assert p._pending == []


def _ev(name, ts, dur, stream=7, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": stream, "args": {"device": 0, "stream": stream}}


def _mark(phase, edge, ts, stream=7):
    return _ev(f"void nbody_phase_mark<{tprof.PHASES.index(phase)}, "
               f"{edge}>()", ts, 2.0, stream)


def test_phase_times_reads_the_marks():
    """Each device operation counts in the innermost phase open on its
    stream at its start, a mark in its own phase; an exit closes the
    phases entered after its entry; operations in no phase, before any
    mark or on an unmarked stream, count under None; host events and an
    exit with no entry (a trace begun inside a phase) change nothing."""
    events = [
        _ev("a_kernel_before_any_mark", 0.0, 5.0),
        _mark("graph.copy_back", 1, 6.0),
        _mark("simulation.run_steps", 0, 10.0),
        _ev("Memcpy DtoD", 12.0, 3.0, cat="gpu_memcpy"),
        _mark("step.drift", 0, 20.0),
        _ev("elementwise", 22.0, 10.0),
        _mark("step.drift", 1, 40.0),
        _mark("bh.sort", 0, 50.0),
        _mark("bh.placement", 0, 52.0),  # never exited: closed by bh.sort's
        _ev("gather", 55.0, 20.0),
        _mark("bh.sort", 1, 80.0),
        _ev("Memset", 90.0, 1.0, cat="gpu_memset"),
        _mark("simulation.run_steps", 1, 100.0),
        _ev("after", 110.0, 4.0),
        _ev("side_copy", 30.0, 7.0, stream=9, cat="gpu_memcpy"),
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 21.0,
         "dur": 50.0},
        {"ph": "X", "cat": "user_annotation", "name": "nbody.step.drift",
         "ts": 19.0, "dur": 30.0},
    ]
    got = tprof.phase_times(events)
    want = {None: (5.0 + 4.0 + 7.0) / 1e3,
            "graph.copy_back": 2.0 / 1e3,
            "simulation.run_steps": (2.0 + 3.0 + 1.0 + 2.0) / 1e3,
            "step.drift": (2.0 + 10.0 + 2.0) / 1e3,
            "bh.sort": (2.0 + 2.0) / 1e3,
            "bh.placement": (2.0 + 20.0) / 1e3}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k
    assert sum(got.values()) == pytest.approx(
        sum(e["dur"] for e in events if e["cat"] in tprof.DEVICE_CATS) / 1e3)
    assert tprof.phase_times([_ev("k", 0.0, 1.0)]) == {None: 1e-3}


def _sources(pattern: str) -> set:
    found = set()
    for path in PKG.rglob("*.py"):
        found.update(re.findall(pattern, path.read_text(), re.S))
    return found


def test_every_device_phase_has_a_mark():
    """Each phase the package opens with a device (a literal name, or the
    table engines' names built from their prefix) is in ``PHASES``, the
    table fits the marks ``csrc/phase_mark.cu`` holds, and the mark kernel
    is a ``__global__`` of the package's sources (a port kernel, as the
    benchmark's kernel list reads them)."""
    named = _sources(r'profile_phase\(\s*"([^"]+)",\s*device=')
    assert {"step.drift", "step.kick", "graph.copy_back", "graph.copy_in",
            "graph.clone_out", "graph.readout", "render.frame",
            *BH_PHASES} <= named
    table = {f"{near}.{part}" for near in ("bh", "near")
             for part in ("sweep", "placement")} | {"bh.sort", "hash.sort"}
    assert named | table <= set(tprof.PHASES)
    assert len(set(tprof.PHASES)) == len(tprof.PHASES)
    cu = (PKG / "csrc" / "phase_mark.cu").read_text()
    slots = int(re.search(r"kMaxPhases = (\d+);", cu).group(1))
    assert len(tprof.PHASES) <= slots
    assert re.search(r"__global__\s+void\s+nbody_phase_mark\s*\(", cu)
