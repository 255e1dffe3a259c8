"""One Verlet step captured as a CUDA graph, replayed for every step.

PyTorch counterpart of the ``jax.jit`` around the JAX facade's stepping
(``nbody_tpu/system.py``): there ``update()`` is one compiled step and
``run_steps(n)`` n steps fused into one device program. On the card one
device program is a CUDA graph: ``StepGraph`` captures ONE step of a
functional step function on static buffers, and n steps are n replays, one
graph launch a step instead of every kernel and tensor op issued from
Python. The graph does not depend on n.

The first call runs one real step eagerly on the state it is given, and
that step counts towards n: it builds the kernels at first use
(``ops/_build.py``), sets their function attributes, runs their plan
queries and fills the device tables that are made once, none of which a
capture may hold. Its result seeds the static buffers; one step on them is
captured, ending with the copy of its outputs back into them so that
replays iterate, and the graph is replayed n − 1 times. A later call
copies the caller's state into the buffers once and replays n times. Every
call returns fresh tensors: a state handed out never aliases the buffers,
so a caller may hold it (a side-stream copy of a frame, a reference state)
while later calls run.

The capture keeps torch's default capture-error mode: a step that reads
the host (``.item()``, ``nonzero``, a tensor made from host data) fails
the capture, which raises; nothing here carries on eagerly. In that mode
another thread's unsafe CUDA call also fails the capture, so a caller
captures before it starts threads that make CUDA calls (the render loop's
side-stream copies run on the capturing thread, and its PNG writer thread
makes none). The graph's private memory pool holds one step's
temporaries for as long as the graph lives (``pool_bytes``): drop the
``StepGraph`` to free it.

The kernel wrappers count their launches (``_build.COUNTED``); a replay
calls no wrapper, so the launches a capture recorded are taken off the
counters (the capture ran nothing) and added back once per replay.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from nbody_tpu_torch.ops import _build


def _fields(state) -> dict:
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


class StepGraph:
    """``step(state) -> state``, a functional step on a dataclass of
    tensors (``ParticleState`` or ``integrator.SortedState``) on one CUDA
    device, captured once and replayed: ``graph(state, n_steps)`` is
    ``n_steps`` applications of ``step``, bit for bit."""

    def __init__(self, step: Callable):
        self._step = step
        self._kind = None
        self._static: dict = {}
        self._launches: tuple = ()
        self.graph = None        # the torch.cuda.CUDAGraph once captured
        self.captures = 0
        self.replays = 0
        self.capture_ms = 0.0    # host ms of the capture, cache release and
                                 # instantiation in
        self.pool_bytes = 0      # device memory the capture reserved
        self.copy_kernels = 0    # kernels of the copy-back (strided outputs)

    def __call__(self, state, n_steps: int):
        if n_steps <= 0:
            return state
        dev = state.pos.device
        if dev.type != "cuda":
            raise ValueError(f"StepGraph: state on {dev}, expected CUDA")
        with torch.cuda.device(dev):
            if self.graph is None:
                state = self._step(state)
                self._capture(state)
                n_steps -= 1
            else:
                self._copy_in(state)
            for _ in range(n_steps):
                self.graph.replay()
            self.replays += n_steps
            for fn, count in self._launches:
                fn.launches += count * n_steps
            return self._kind(**{k: v.clone()
                                 for k, v in self._static.items()})

    def _copy_in(self, state) -> None:
        if type(state) is not self._kind:
            raise TypeError(f"StepGraph: a {type(state).__name__}, captured "
                            f"on a {self._kind.__name__}")
        for k, t in _fields(state).items():
            buf = self._static[k]
            if (t.shape, t.dtype, t.device) != (buf.shape, buf.dtype,
                                                buf.device):
                raise ValueError(
                    f"StepGraph: {k} {tuple(t.shape)} {t.dtype} on "
                    f"{t.device}, captured on {tuple(buf.shape)} "
                    f"{buf.dtype} on {buf.device}")
            buf.copy_(t)

    def _capture(self, state) -> None:
        """Static buffers from ``state``, then one step on them captured,
        its outputs copied back into them."""
        dev = state.pos.device
        self._kind = type(state)
        self._static = {k: t.clone() for k, t in _fields(state).items()}
        before = [fn.launches for fn in _build.COUNTED]
        # torch.cuda.graph releases the allocator's cache on entry, which
        # can take far longer than the capture: it counts in capture_ms
        t0 = time.perf_counter()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.cuda.graph(graph):
                out = _fields(self._step(self._kind(**self._static)))
                self.copy_kernels = self._copy_back(out)
            graph.instantiate()
        finally:
            # the launches the capture recorded; it ran none of them
            launches = []
            for fn, n in zip(_build.COUNTED, before):
                if fn.launches != n:
                    launches.append((fn, fn.launches - n))
                    fn.launches = n
        torch.cuda.synchronize(dev)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self._launches = tuple(launches)
        self.graph = graph
        self.captures += 1

    def _copy_back(self, out: dict) -> int:
        """Copy each output that is not its own buffer into it; returns
        the copies made by a kernel (strided outputs; the others are
        memcpy nodes). An output viewing another buffer would be
        overwritten before it is copied: raises."""
        bufs = {t.untyped_storage().data_ptr() for t in self._static.values()}
        pending = []
        for k, buf in self._static.items():
            o = out[k]
            if o is buf:
                continue
            if (o.shape, o.dtype) != (buf.shape, buf.dtype):
                raise ValueError(f"StepGraph: the step's {k} is "
                                 f"{tuple(o.shape)} {o.dtype}, its input "
                                 f"{tuple(buf.shape)} {buf.dtype}")
            if o.untyped_storage().data_ptr() in bufs:
                raise ValueError(f"StepGraph: the step's {k} views an input")
            pending.append((buf, o))
        for buf, o in pending:
            buf.copy_(o)
        return sum(not o.is_contiguous() for _, o in pending)
