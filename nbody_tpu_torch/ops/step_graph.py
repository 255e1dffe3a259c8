"""Verlet steps captured as CUDA graphs and replayed.

PyTorch counterpart of the ``jax.jit`` around the JAX facade's stepping
(``nbody_tpu/system.py``): there ``update()`` is one compiled step and
``run_steps(n)`` n steps fused into one device program, whichever driver
the facade picks. On the card one device program is a CUDA graph, or a
few graphs replayed in the order a driver's schedule picks.

``StepGraph`` captures ONE step of a functional step function on static
buffers, and n steps are n replays, one graph launch a step instead of
every kernel and tensor op issued from Python. The graph does not depend
on n. The first call runs one real step eagerly on the state it is given,
and that step counts towards n: it builds the kernels at first use
(``ops/_build.py``), sets their function attributes, runs their plan
queries and fills the device tables that are made once, none of which a
capture may hold. Its result seeds the static buffers; one step on them is
captured, ending with the copy of its outputs back into them so that
replays iterate, and the graph is replayed n − 1 times. A later call
copies the caller's state into the buffers once and replays n times.

``SegmentGraphs`` serves the frozen-grid drivers, whose steps are not all
alike (a sorting step, a frozen step, an audited drift, a repair): it
holds named segments captured on ONE carry of named static buffers, each
segment a function of the buffers returning the new values of some of
them, copied back into them at its end. A driver runs its segments in the
order its schedule picks, and reads a count on the host between two
replays where the JAX driver has a ``lax.cond`` (``read``; counted in
``host_reads``). Every value one segment passes to another lives in a
buffer allocated outside capture, so the graphs' temporaries die with each
replay and the segments share one memory pool, whatever order they run
in. A segment's first use runs eagerly on the buffers, then it is
captured; an output of a new name, or of a new shape, gets a buffer
allocated there, and a new shape drops every captured segment (they read
the old buffer): each is captured again at its next use. Built with
``graphed=False`` the same object runs every segment eagerly on the
current values (the eager reference of a driver, and every driver on the
CPU), with the same host reads.

Both keep torch's default capture-error mode: a step that reads the host
(``.item()``, ``nonzero``, a tensor made from host data) fails the
capture, which raises; nothing here carries on eagerly. In that mode
another thread's unsafe CUDA call also fails the capture, so a caller
captures before it starts threads that make CUDA calls (the render loop's
side-stream copies run on the capturing thread, and its PNG writer thread
makes none). A graph's private memory pool holds its temporaries for as
long as the graph lives (``pool_bytes``): drop the object to free it.
Callers hand out fresh tensors, never the buffers, so a caller may hold a
state (a side-stream copy of a frame, a reference state) while later calls
run.

The kernel wrappers count their launches (``_build.COUNTED``); a replay
calls no wrapper, so the launches a capture recorded are taken off the
counters (the capture ran nothing) and added back once per replay.

With the profiling switch at trace (``utils/profiling.py``) the copies are
phases, ``graph.copy_in``, ``graph.copy_back`` (captured with its marks)
and ``graph.clone_out``, and a capture, a call's replays and a host read
are the spans ``graph.capture``, ``graph.replay`` and ``graph.read``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.utils.profiling import host_span, profile_phase


def _fields(state) -> dict:
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def _copy_back(bufs: dict, out: dict) -> int:
    """Copy each output of ``out`` into the buffer of its name in ``bufs``
    (an output that is its own buffer stays), as the phase
    ``graph.copy_back``; returns the copies made by a kernel (strided
    outputs; the others are memcpy nodes). An output that views a buffer
    this copy-back writes would be overwritten before it is copied:
    raises."""
    pending = [(k, bufs[k], o) for k, o in out.items() if o is not bufs[k]]
    written = {buf.untyped_storage().data_ptr() for _, buf, _ in pending}
    for k, buf, o in pending:
        if (o.shape, o.dtype) != (buf.shape, buf.dtype):
            raise ValueError(f"the step's {k} is {tuple(o.shape)} {o.dtype}, "
                             f"its buffer {tuple(buf.shape)} {buf.dtype}")
        if o.untyped_storage().data_ptr() in written:
            raise ValueError(f"the step's {k} views a buffer it writes")
    if pending:
        with profile_phase("graph.copy_back", device=pending[0][1].device,
                           timed=False):
            for _, buf, o in pending:
                buf.copy_(o)
    return sum(not o.is_contiguous() for _, _, o in pending)


class _Capture:
    """One captured segment ``fn(bufs) -> outputs`` on the buffers
    ``bufs``, ending with the outputs' copy-back, and its readings."""

    def __init__(self):
        self.graph = None        # the torch.cuda.CUDAGraph once captured
        self.captures = 0
        self.replays = 0
        self.capture_ms = 0.0    # host ms of the capture, cache release and
                                 # instantiation in
        self.pool_bytes = 0      # device memory the capture reserved
        self.copy_kernels = 0    # kernels of the copy-back (strided outputs)
        self._launches: tuple = ()

    def capture(self, fn: Callable, bufs: dict, dev, pool=None) -> None:
        before = [f.launches for f in _build.COUNTED]
        # torch.cuda.graph releases the allocator's cache on entry, which
        # can take far longer than the capture: it counts in capture_ms
        t0 = time.perf_counter()
        with host_span("graph.capture"):
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            try:
                with torch.cuda.graph(graph, pool=pool):
                    self.copy_kernels = _copy_back(bufs, fn(bufs))
                graph.instantiate()
            finally:
                # the launches the capture recorded; it ran none of them
                launches = []
                for f, n in zip(_build.COUNTED, before):
                    if f.launches != n:
                        launches.append((f, f.launches - n))
                        f.launches = n
            torch.cuda.synchronize(dev)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self._launches = tuple(launches)
        self.graph = graph
        self.captures += 1

    def replay(self, n: int = 1) -> None:
        with host_span("graph.replay"):
            for _ in range(n):
                self.graph.replay()
        self.replays += n
        for f, count in self._launches:
            f.launches += count * n


class StepGraph(_Capture):
    """``step(state) -> state``, a functional step on a dataclass of
    tensors (``ParticleState`` or ``integrator.SortedState``) on one CUDA
    device, captured once and replayed: ``graph(state, n_steps)`` is
    ``n_steps`` applications of ``step``, bit for bit."""

    def __init__(self, step: Callable):
        super().__init__()
        self._step = step
        self._kind = None
        self._static: dict = {}

    def __call__(self, state, n_steps: int):
        if n_steps <= 0:
            return state
        dev = state.pos.device
        if dev.type != "cuda":
            raise ValueError(f"StepGraph: state on {dev}, expected CUDA")
        with torch.cuda.device(dev):
            if self.graph is None:
                state = self._step(state)
                self._kind = type(state)
                self._static = {k: t.clone()
                                for k, t in _fields(state).items()}
                self.capture(
                    lambda bufs: _fields(self._step(self._kind(**bufs))),
                    self._static, dev)
                n_steps -= 1
            else:
                self._copy_in(state)
            self.replay(n_steps)
            with profile_phase("graph.clone_out", device=dev, timed=False):
                return self._kind(**{k: v.clone()
                                     for k, v in self._static.items()})

    def _copy_in(self, state) -> None:
        if type(state) is not self._kind:
            raise TypeError(f"StepGraph: a {type(state).__name__}, captured "
                            f"on a {self._kind.__name__}")
        with profile_phase("graph.copy_in", device=state.pos.device,
                           timed=False):
            for k, t in _fields(state).items():
                buf = self._static[k]
                if (t.shape, t.dtype, t.device) != (buf.shape, buf.dtype,
                                                    buf.device):
                    raise ValueError(
                        f"StepGraph: {k} {tuple(t.shape)} {t.dtype} on "
                        f"{t.device}, captured on {tuple(buf.shape)} "
                        f"{buf.dtype} on {buf.device}")
                buf.copy_(t)


class SegmentGraphs:
    """Named segments on one carry of named buffers (module docstring):
    ``load(**values)`` sets buffers, ``run(key, fn)`` applies a segment
    ``fn(bufs) -> {name: new value}`` (captured after its first use, then
    replayed), ``read(name)`` reads a () buffer on the host, ``get(name)``
    hands out a copy. ``graphed=False``: every segment runs eagerly on the
    current values, nothing is copied. ``segments`` maps each key to its
    captured segment (``captures``, ``replays``, ``capture_ms``,
    ``pool_bytes``, ``graph``); ``captures`` counts every capture made,
    those of dropped segments too."""

    def __init__(self, graphed: bool = True):
        self.graphed = graphed
        self.buffers: dict = {}
        self.segments: dict = {}
        self.host_reads = 0
        self.captures = 0         # every capture made, dropped ones too
        self.pool_bytes = 0       # device memory they reserved (one pool)
        self.state: dict = {}     # a driver's host-side state (side bucket)
        self._pool = None

    def load(self, **values) -> None:
        """Set buffers to ``values``: copied into a buffer of the same
        shape and dtype, else into a new one (graphed); taken as they are
        (eager)."""
        if not self.graphed:
            self.buffers.update(values)
            return
        dev = next(iter(values.values())).device if values else None
        with profile_phase("graph.copy_in", device=dev, timed=False):
            for k, t in values.items():
                buf = self.buffers.get(k)
                if buf is not None and (buf.shape, buf.dtype, buf.device) == (
                        t.shape, t.dtype, t.device):
                    buf.copy_(t)
                else:
                    self._allocate(k, t.clone())

    def _allocate(self, name: str, t: torch.Tensor) -> None:
        if self.buffers:
            dev = next(iter(self.buffers.values())).device
            if t.device != dev:
                # a capture on one card cannot launch on another
                raise ValueError(f"buffer {name} on {t.device}, the "
                                 f"others on {dev}")
        if name in self.buffers:
            # every captured segment may read the old buffer
            self.segments = {}
        self.buffers[name] = t

    def run(self, key, fn: Callable) -> None:
        """One application of the segment ``key`` (``fn``: the buffers →
        their new values by name)."""
        if not self.graphed:
            self.buffers.update(fn(self.buffers))
            return
        seg = self.segments.get(key)
        if seg is not None:
            seg.replay()
            return
        dev = next(iter(self.buffers.values())).device
        with torch.cuda.device(dev):
            out = fn(self.buffers)
            fresh = {k: o for k, o in out.items()
                     if k not in self.buffers or (
                         self.buffers[k].shape, self.buffers[k].dtype)
                     != (o.shape, o.dtype)}
            for k, o in fresh.items():
                self._allocate(k, o.clone())
            _copy_back(self.buffers,
                       {k: o for k, o in out.items() if k not in fresh})
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            seg = _Capture()
            seg.capture(fn, self.buffers, dev, self._pool)
            self.segments[key] = seg
            self.captures += 1
            self.pool_bytes += seg.pool_bytes

    def read(self, name: str) -> int:
        """The () buffer ``name`` on the host: one device→host read."""
        self.host_reads += 1
        with host_span("graph.read"):
            return int(self.buffers[name])

    def get(self, name: str) -> torch.Tensor:
        """A copy of buffer ``name`` (graphed; eager: the value itself,
        which no later segment changes in place)."""
        t = self.buffers[name]
        if not self.graphed:
            return t
        with profile_phase("graph.clone_out", device=t.device, timed=False):
            return t.clone()


def stack_trace(counts, flags, device):
    """A driver's per-step trace ``(counts (S,) int32, flags (S,) bool)``
    from per-step device counts or host ints, with no host read."""
    c = torch.stack([torch.as_tensor(v, device=device).reshape(())
                     .to(torch.int32) for v in counts]) if counts else (
        torch.zeros((0,), dtype=torch.int32, device=device))
    return c, torch.tensor(flags, dtype=torch.bool, device=device)
