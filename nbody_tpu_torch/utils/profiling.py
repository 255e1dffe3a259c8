"""Phase-scoped profiling.

PyTorch counterpart of ``nbody_tpu/utils/profiling.py``'s phase profiler:
a lock-guarded ``PhaseProfiler`` accumulating (total_ms, samples) per named
phase, and the ``profile_phase(name)`` context manager.

On a CUDA device a phase is timed with a pair of CUDA events recorded on
the current stream, so it measures device time without synchronizing the
step; the pairs are resolved (waiting for their end events) when the
profiler is drained, or once more than ``MAX_PENDING`` are outstanding. On
the CPU it uses the host clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Optional

import torch

MAX_PENDING = 1024


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

    def consume(self) -> Dict[str, PhaseStats]:
        """Resolve pending event pairs, then drain and return."""
        with self._lock:
            self._resolve()
            snap = self._phases
            self._phases = {}
            return snap


_GLOBAL = PhaseProfiler()


def consume_global_phase_snapshot() -> Dict[str, PhaseStats]:
    return _GLOBAL.consume()


@contextlib.contextmanager
def profile_phase(name: str, device: torch.device | str | None = None,
                  profiler: Optional[PhaseProfiler] = None):
    """Time the enclosed block as phase ``name`` — with CUDA events on the
    current stream when ``device`` is a CUDA device, else with the host
    clock. One yield on every path: an exception from the block propagates
    unchanged, and the partial phase is not recorded."""
    prof = profiler or _GLOBAL
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda":
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
