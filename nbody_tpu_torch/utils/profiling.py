"""Phase-scoped profiling and JSON benchmark records.

PyTorch counterpart of ``nbody_tpu/utils/profiling.py``: a lock-guarded
``PhaseProfiler`` accumulating (total_ms, samples) per named phase, the
``profile_phase(name)`` context manager, and ``BenchmarkRunRecord``
serialized to the JAX package's JSON schema (``{"benchmark_runs":
[...]}``). Profiling is on by default; ``set_profiling_enabled(False)``
or ``NBODY_TPU_PROFILING=0`` turns ``profile_phase`` into a no-op.

On a CUDA device a phase is timed with a pair of CUDA events recorded on
the current stream, so it measures device time without synchronizing the
step; the pairs are resolved (waiting for their end events) when the
profiler is drained, or once more than ``MAX_PENDING`` are outstanding. On
the CPU it uses the host clock.

While the current CUDA stream is capturing a graph, a CUDA phase records
nothing: an event recorded during a capture is not recorded again when
the graph is replayed, so its time would be stale or unreadable. On the
card the facade steps by replaying one captured step
(``ops/step_graph.py``), so the inner phases of a step (``bh.far``,
``bh.sweep``, ``hash.window``, ``near.*``, ...) are timed only where a
step runs eagerly: the multi-step functions of ``ops/integrator.py``
called directly, as ``chip_smoke.py`` and
``scripts/profile_torch_paths.py`` do. A CLI record's ``phase_timings``
on the card hold the facade's phases, ``simulation.run_steps`` and
``simulation.update``, which wrap the replays: the JAX package's only
step phases.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

MAX_PENDING = 1024

_ENABLED = os.environ.get("NBODY_TPU_PROFILING", "1") != "0"


def set_profiling_enabled(enabled: bool) -> None:
    global _ENABLED
    _ENABLED = enabled


def profiling_enabled() -> bool:
    return _ENABLED


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
        with self._lock:
            self._pending.append((name, start, end))
            if len(self._pending) > MAX_PENDING:
                self._resolve()

    def _add(self, name: str, ms: float) -> None:
        st = self._phases.setdefault(name, PhaseStats())
        st.total_ms += ms
        st.samples += 1

    def _resolve(self) -> None:
        for name, start, end in self._pending:
            end.synchronize()
            self._add(name, start.elapsed_time(end))
        self._pending = []

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


@contextlib.contextmanager
def profile_phase(name: str, device: torch.device | str | None = None,
                  profiler: Optional[PhaseProfiler] = None):
    """Time the enclosed block as phase ``name`` — with CUDA events on the
    current stream when ``device`` is a CUDA device, else with the host
    clock. One yield on every path: an exception from the block propagates
    unchanged, and the partial phase is not recorded. A no-op while
    profiling is disabled, and on a CUDA device while the current stream
    is capturing a graph."""
    if not _ENABLED:
        yield
        return
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
