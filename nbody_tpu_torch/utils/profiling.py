"""Phase-scoped profiling, phase marks in device traces, and JSON
benchmark records.

PyTorch counterpart of ``nbody_tpu/utils/profiling.py``: a lock-guarded
``PhaseProfiler`` accumulating (total_ms, samples) per named phase, the
``profile_phase(name)`` context manager, and ``BenchmarkRunRecord``
serialized to the JAX package's JSON schema (``{"benchmark_runs":
[...]}``). One switch, ``set_profiling_enabled`` or the environment's
``NBODY_TPU_PROFILING``, has three settings: off (False, ``0``), on (True,
the default) and trace (``"trace"``).

On: a phase is timed. On a CUDA device with a pair of CUDA events
recorded on the current stream, so it measures device time without
synchronizing the step; once more than ``MAX_PENDING`` pairs are
outstanding the pairs whose end event has completed are resolved, and only
``snapshot`` and ``consume`` wait for the rest. On the CPU it uses the
host clock. While the current CUDA stream captures a graph a phase records
no events (a replay does not record them again), so on the card, where the
facade steps by replaying captured graphs (``ops/step_graph.py``), a CLI
record's ``phase_timings`` hold the facade's own phases,
``simulation.run_steps`` and ``simulation.update``.

Trace: as on, and each phase on a CUDA device launches a phase mark on
the current stream at its entry and at its exit: the one-thread kernel
``nbody_phase_mark<p, e>()`` of ``csrc/phase_mark.cu``, p the phase's
index in ``PHASES``, e 0 at the entry and 1 at the exit. Inside a graph
capture the marks are always launched, so a captured step holds its
phases' marks as kernel nodes and every replay launches them again: a
``torch.profiler`` trace of the graphed path names the phase of each
device operation, the innermost phase entered and not yet exited on its
stream when it starts (``phase_times`` reads it). While a
``torch.profiler`` records, each phase also opens a host span
``nbody.<name>`` (a ``torch.profiler.record_function``) and launches its
marks outside captures too; with no profiler recording neither is made,
so the setting costs the captured marks alone. A phase that ``PHASES``
does not list gets its span and no mark.
``host_span`` opens a span alone, for host work that launches nothing
(``graph.replay``, ``graph.capture``, ``graph.read``, ``kernels.build``,
``profiling.resolve``).

A phase made with ``timed=False`` (the integrator's drift and kick, the
captured graphs' copies, the readout) exists only in the trace setting;
off and on it costs one check of the setting, as every phase does off.

Counters (``set_counter``, ``read_counter``), beside the phases and
whatever the setting: named figures the program publishes as it runs, each
a host number or a 0-d device tensor that the program keeps adding to
(inside captured steps too), resolved to a number only when read. The
facade publishes ``hash.window_overflow_rows``: the rows the spatial hash
window engine could not cover since the state was set; the latest facade
to publish a name holds it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional

import torch

MAX_PENDING = 1024

SPAN_PREFIX = "nbody."

# The phases that launch marks; a mark names its phase by the index here
# (csrc/phase_mark.cu holds marks for 64). Append only: a trace is read
# with the table of the program that wrote it.
PHASES = (
    "step.drift", "step.kick",
    "bh.sort", "bh.placement", "bh.pyramid", "bh.far", "bh.sweep",
    "bh.pickup", "bh.window", "bh.moments", "bh.audit",
    "near.placement", "near.sweep", "near.pickup",
    "hash.sort", "hash.window",
    "table.audit", "table.extract", "table.moments", "table.repair",
    "graph.copy_in", "graph.copy_back", "graph.clone_out", "graph.readout",
    "simulation.update", "simulation.run_steps",
    "render.frame", "render.copy",
)
_PHASE_INDEX = {name: i for i, name in enumerate(PHASES)}

# A mark's kernel as a trace names it: nbody_phase_mark<phase, edge>
MARK_NAME = re.compile(r"\bnbody_phase_mark<\s*(\d+)\s*,\s*(\d+)\s*>")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _setting_of(value: str):
    return {"0": False, "trace": "trace"}.get(value, True)


_SETTING = _setting_of(os.environ.get("NBODY_TPU_PROFILING", "1"))
_NULL = contextlib.nullcontext()


def set_profiling_enabled(enabled) -> None:
    """False (off), True (on: phases timed) or ``"trace"`` (on, with the
    spans and phase marks of the module docstring)."""
    global _SETTING
    if enabled not in (False, True, "trace"):
        raise ValueError(f"profiling setting {enabled!r}: False, True or "
                         f"'trace'")
    _SETTING = enabled if enabled == "trace" else bool(enabled)


def profiling_enabled():
    """The setting: False, True or ``"trace"`` (truthy)."""
    return _SETTING


@dataclasses.dataclass
class PhaseStats:
    total_ms: float = 0.0
    samples: int = 0


class PhaseProfiler:
    """Accumulates named phase durations under a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._phases: Dict[str, PhaseStats] = {}
        self._pending: list = []  # (name, start_event, end_event)

    def record(self, name: str, ms: float) -> None:
        with self._lock:
            self._add(name, ms)

    def record_events(self, name: str, start, end) -> None:
        """Queue an event pair; past ``MAX_PENDING`` resolve the leading
        pairs that have completed, waiting for none."""
        with self._lock:
            self._pending.append((name, start, end))
            if len(self._pending) > MAX_PENDING:
                self._resolve(wait=False)

    def _add(self, name: str, ms: float) -> None:
        st = self._phases.setdefault(name, PhaseStats())
        st.total_ms += ms
        st.samples += 1

    def _resolve(self, wait: bool = True) -> None:
        """Add the pending pairs' times: every pair, waiting for each end
        event (``wait``), or the pairs up to the first whose end event has
        not completed."""
        with host_span("profiling.resolve"):
            done = 0
            for name, start, end in self._pending:
                if wait:
                    end.synchronize()
                elif not end.query():
                    break
                self._add(name, start.elapsed_time(end))
                done += 1
            del self._pending[:done]

    def snapshot(self) -> Dict[str, PhaseStats]:
        """Resolve pending event pairs, then return a copy (no drain)."""
        with self._lock:
            self._resolve()
            return {k: PhaseStats(v.total_ms, v.samples)
                    for k, v in self._phases.items()}

    def consume(self) -> Dict[str, PhaseStats]:
        """Resolve pending event pairs, then drain and return."""
        with self._lock:
            self._resolve()
            snap = self._phases
            self._phases = {}
            return snap

    def reset(self) -> None:
        """Drop every phase and every pending event pair."""
        with self._lock:
            self._phases = {}
            self._pending = []


_GLOBAL = PhaseProfiler()


def get_global_profiler() -> PhaseProfiler:
    return _GLOBAL


def consume_global_phase_snapshot() -> Dict[str, PhaseStats]:
    return _GLOBAL.consume()


def profile_phase(name: str, device: torch.device | str | None = None,
                  profiler: Optional[PhaseProfiler] = None, *,
                  timed: bool = True):
    """The enclosed block as phase ``name``: timed while profiling is on
    (``timed``; with CUDA events on the current stream when ``device`` is
    a CUDA device, else with the host clock), and in the trace setting
    also a span and, on a CUDA device, marks (module docstring). An
    exception from the block propagates unchanged, and the partial phase
    is not timed."""
    if _SETTING == "trace":
        return _traced_phase(name, device, profiler, timed)
    if _SETTING and timed:
        return _timed_phase(name, device, profiler)
    return _NULL


def host_span(name: str):
    """The host span ``nbody.<name>`` in the trace setting while a
    profiler records, else nothing: for host work that launches nothing
    (no mark, no timing)."""
    if _SETTING == "trace" and _recording():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NULL


def _recording() -> bool:
    """Whether a ``torch.profiler`` records, in any thread."""
    return torch.autograd.profiler._is_profiler_enabled


@contextlib.contextmanager
def _timed_phase(name, device, profiler):
    prof = profiler or _GLOBAL
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda":
        if torch.cuda.is_current_stream_capturing():
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(device))
        yield
        end.record(torch.cuda.current_stream(device))
        prof.record_events(name, start, end)
    else:
        t0 = time.perf_counter()
        yield
        prof.record(name, (time.perf_counter() - t0) * 1e3)


@contextlib.contextmanager
def _traced_phase(name, device, profiler, timed):
    device = torch.device(device) if device is not None else None
    recording = _recording()
    phase = None
    if device is not None and device.type == "cuda":
        capturing = torch.cuda.is_current_stream_capturing()
        if not capturing:
            _load_marks(device)
        if recording or capturing:
            phase = _PHASE_INDEX.get(name)
    with torch.profiler.record_function(SPAN_PREFIX + name) \
            if recording else _NULL:
        if phase is not None:
            _mark(device, phase, 0)
        with _timed_phase(name, device, profiler) if timed else _NULL:
            yield
        if phase is not None:
            _mark(device, phase, 1)


_MARKS_LOADED: set = set()  # device indices whose marks are loaded


def _load_marks(device: torch.device) -> None:
    """Load the marks on ``device``'s card once, outside any capture: with
    lazy module loading a mark first launched inside a capture would load
    there."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index in _MARKS_LOADED:
        return
    from nbody_tpu_torch.ops import _build  # ops import this module

    lib = _build.library()
    with torch.cuda.device(index):
        err = lib.nbt_phase_mark_load(len(PHASES))
    if err != 0:
        raise RuntimeError(f"nbt_phase_mark_load: CUDA error {err} "
                           f"({lib.nbt_error_string(err).decode()})")
    _MARKS_LOADED.add(index)


def _mark(device: torch.device, phase: int, edge: int) -> None:
    from nbody_tpu_torch.ops import _build

    _build.launch("nbt_phase_mark", device, phase, edge)


_COUNTERS: Dict[str, Any] = {}
_COUNTERS_LOCK = threading.Lock()


def set_counter(name: str, value) -> None:
    """Publish ``value`` (a number, or a 0-d tensor read when the counter
    is) under ``name``."""
    with _COUNTERS_LOCK:
        _COUNTERS[name] = value


def read_counter(name: str) -> Optional[float]:
    """The counter's value now (a device tensor is copied to the host
    here, so this waits for the work that adds to it), or None when
    nothing published it."""
    with _COUNTERS_LOCK:
        value = _COUNTERS.get(name)
    if isinstance(value, torch.Tensor):
        with host_span("profiling.resolve"):
            return value.item()
    return value


def phase_times(events: list) -> Dict[Optional[str], float]:
    """Device ms by phase in the events of a ``torch.profiler`` Chrome
    trace (``export_chrome_trace``'s ``traceEvents``) taken in the trace
    setting. Each device operation (kernel, memcpy, memset) counts in the
    innermost phase entered and not exited on its stream when it starts,
    as the marks there say, a mark in its own phase; an exit closes the
    phases entered after its entry too. The key None holds the operations
    in no phase."""
    streams: Dict[Any, list] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            args = e.get("args", {})
            key = (args.get("device", e.get("pid")),
                   args.get("stream", e.get("tid")))
            streams.setdefault(key, []).append(e)
    out: Dict[Optional[str], float] = {}
    for ops in streams.values():
        stack: list = []
        for e in sorted(ops, key=lambda e: float(e["ts"])):
            m = MARK_NAME.search(e.get("name", "")) \
                if e.get("cat") == "kernel" else None
            if m is not None:
                p = int(m.group(1))
                name = PHASES[p] if p < len(PHASES) else f"phase {p}"
                if m.group(2) == "0":
                    stack.append(name)
                elif name in stack:
                    del stack[len(stack) - 1 - stack[::-1].index(name):]
            else:
                name = stack[-1] if stack else None
            out[name] = out.get(name, 0.0) + float(e.get("dur", 0.0)) / 1e3
    return out


@dataclasses.dataclass
class BenchmarkRunRecord:
    """One benchmark run, in the JAX package's JSON schema."""

    name: str
    method: str
    particle_count: int
    iterations: int
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    params: Dict[str, str] = dataclasses.field(default_factory=dict)
    phase_timings: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict
    )

    def attach_phase_snapshot(self, snapshot: Dict[str, PhaseStats]) -> None:
        for name, st in sorted(snapshot.items()):
            self.phase_timings[name] = {
                "total_ms": st.total_ms,
                "samples": st.samples,
                "mean_ms": st.total_ms / max(st.samples, 1),
            }

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "method": self.method,
            "particle_count": self.particle_count,
            "iterations": self.iterations,
            "metrics": self.metrics,
            "params": self.params,
            "phase_timings": self.phase_timings,
        }


def serialize_benchmark_run_records(records: List[BenchmarkRunRecord]) -> str:
    """``{"benchmark_runs": [...]}``, indented as the JAX package's."""
    return json.dumps(
        {"benchmark_runs": [r.to_dict() for r in records]}, indent=2
    )
