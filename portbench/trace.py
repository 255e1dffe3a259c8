"""The traced window: torch.profiler over a few driver iterations, reduced
to what the per-layer metrics read.

The harness marks its own spans (``span(name)``, a ``record_function``
labelled ``portbench.<name>``) around each call into the program and
around the traced window itself. The profiler starts a lead of
iterations before the window opens, so that the device is already busy
when it does. After the window the trace is exported to a file under
``TMPDIR``, read and deleted. Device operations are the trace's kernels,
memcpys and memsets. The per-step readings take every device operation
of the trace (the lead's and the window's) over every step traced; the
busy time is the union of their intervals inside the window, and each
idle stretch there is named by the innermost harness span the host was
in when it began ("loop" when none: the harness between two calls).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "portbench."


def span(name: str):
    """A harness span; free when no profiler runs."""
    return torch.profiler.record_function(PREFIX + name)


@dataclasses.dataclass
class Trace:
    """One traced window, times in seconds from the window's start."""

    window_s: float
    ops: list          # (name, cat, start, dur) device operations, all
    gaps: list         # (span name, start, dur) idle stretches in the window
    units: int         # steps or frames the traced iterations completed

    @property
    def busy_s(self) -> float:
        return self.window_s - sum(g[2] for g in self.gaps)

    def kernels(self) -> list:
        return [o for o in self.ops if o[1] == "kernel"]

    def breakdown(self, top: int = 10) -> dict:
        by_op, by_gap = {}, {}
        for name, _, _, dur in self.ops:
            by_op[name] = by_op.get(name, 0.0) + dur
        for name, _, dur in self.gaps:
            by_gap[name] = by_gap.get(name, 0.0) + dur
        return {
            "device_ops": [[k, v] for k, v in sorted(
                by_op.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(
                by_gap.items(), key=lambda kv: -kv[1])[:top]],
        }


@contextlib.contextmanager
def profiled():
    """Profile the body; yields a list that holds the raw events after."""
    from torch.profiler import ProfilerActivity, profile

    out = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield out
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out.extend(json.load(f)["traceEvents"])
    finally:
        os.unlink(path)


def reduce(events: list, units: int) -> Trace:
    """The ``Trace`` of ``events``: every device operation, and the idle
    stretches inside the span ``portbench.window``."""
    spans, ops = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        t0, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            ops.append((name, cat, t0, dur))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], t0, dur))
    win = [s for s in spans if s[0] == "window"]
    if not win:
        raise RuntimeError("the trace holds no portbench.window span")
    _, w0, wdur = win[0]
    w1 = w0 + wdur
    inner = sorted((s for s in spans if s[0] != "window"),
                   key=lambda s: s[1])
    starts = [s[1] for s in inner]
    kept = []
    for name, cat, t0, dur in sorted(ops, key=lambda o: o[2]):
        a, b = max(t0, w0), min(t0 + dur, w1)
        if b > a:
            kept.append((name, cat, a, b - a))
    gaps, end = [], w0
    for _, _, a, d in kept + [("", "", w1, 0.0)]:
        if a > end:
            gaps.append((_host_span(inner, starts, end), end, a - end))
        end = max(end, a + d)
    us = 1e-6
    return Trace(
        window_s=wdur * us,
        ops=[(n, c, (a - w0) * us, d * us) for n, c, a, d in ops],
        gaps=[(n, (a - w0) * us, d * us) for n, a, d in gaps],
        units=units,
    )


def _host_span(spans: list, starts: list, t: float) -> str:
    """The harness span the host was in at ``t``: the last one begun by
    then, if it had not ended (the harness's spans inside the window do
    not nest)."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t < spans[i][1] + spans[i][2]:
        return spans[i][0]
    return "loop"
