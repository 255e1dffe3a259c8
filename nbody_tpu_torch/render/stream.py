"""Asynchronous device→host copies: the point stream and the frame copies.

PyTorch-package counterpart of ``nbody_tpu/render/stream.py``. The JAX
package copies every point to the host each frame because a TPU cannot
share buffers with a display; its ``PointStream`` keeps that copy off the
simulation's critical path. Here the frame is rendered on the card
(``PointRenderer``), so the app's loop moves only images (or the terminal
view's count grid) through the same double buffer; ``PointStream`` keeps
the JAX API for callers that want the points on the host.

``HostDoubleBuffer.put`` copies CUDA tensors into one of two sets of
pinned host buffers, ``non_blocking``, on a side CUDA stream that first
waits on an event recorded on the compute stream, then records a copy
event; ``HostCopy.wait`` waits on that event alone. The sources are marked
``record_stream(side)``: the step is functional, so the state a copy reads
is dropped at the next step, and without the mark the caching allocator
could hand its memory to that step while the side stream still reads it.
A copy's host buffers are reused two ``put`` calls later. CPU tensors are
cloned.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nbody_tpu_torch.utils.profiling import profile_phase


class HostCopy:
    """One device→host copy in flight: ``wait()`` → the host tensors."""

    def __init__(self, tensors: tuple, event):
        self._tensors = tensors
        self._event = event

    def wait(self) -> tuple:
        if self._event is not None:
            self._event.synchronize()
        return self._tensors


class HostDoubleBuffer:
    """Two pinned host slots, used in turn, filled on a side stream."""

    def __init__(self):
        self._slots = [None, None]
        self._turn = 0
        self._side = None

    def put(self, *tensors: torch.Tensor) -> HostCopy:
        """Start copying ``tensors`` to the host after the work queued so
        far on the current stream; returns the copy."""
        dev = tensors[0].device
        if dev.type != "cuda":
            return HostCopy(tuple(t.detach().clone() for t in tensors), None)
        if self._side is None:
            self._side = torch.cuda.Stream(device=dev)
        slot = self._slots[self._turn]
        if slot is None or [(h.shape, h.dtype) for h in slot] != [
                (t.shape, t.dtype) for t in tensors]:
            slot = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in tensors)
            self._slots[self._turn] = slot
        self._turn ^= 1
        ready = torch.cuda.current_stream(dev).record_event()
        with torch.cuda.stream(self._side):
            self._side.wait_event(ready)
            with profile_phase("render.copy", device=dev):
                for h, t in zip(slot, tensors):
                    t.record_stream(self._side)
                    h.copy_(t, non_blocking=True)
            done = self._side.record_event()
        return HostCopy(slot, done)


@dataclasses.dataclass
class PointSnapshot:
    positions: np.ndarray  # (M, 3) float32
    velocities: np.ndarray  # (M, 3) float32
    sim_time: float
    frame_id: int


class PointStream:
    """Double-buffered device→host particle stream: ``request()`` starts
    a copy of the (decimated) state without waiting for the device;
    ``latest()`` waits for the last requested copy only. A snapshot's
    arrays stay valid until the second ``request()`` after it."""

    def __init__(self, system, max_points: int = 2_000_000):
        self._system = system
        self._max_points = max_points
        self._buffer = HostDoubleBuffer()
        self._pending = None  # (HostCopy, frame id)
        self._frame = 0

    def _decimate(self, arr):
        n = arr.shape[0]
        if n <= self._max_points:
            return arr
        stride = -(-n // self._max_points)
        return arr[::stride]

    def request(self) -> None:
        """Start a copy of the current state (no host wait)."""
        with profile_phase("interop.update"):
            st = self._system.state
            copy = self._buffer.put(self._decimate(st.pos),
                                    self._decimate(st.vel), st.time)
            self._pending = (copy, self._frame)
            self._frame += 1

    def latest(self) -> PointSnapshot:
        """The last requested snapshot (requests one first if none is
        pending); waits only for its copy."""
        if self._pending is None:
            self.request()
        copy, frame = self._pending
        self._pending = None
        pos, vel, t = copy.wait()
        return PointSnapshot(positions=pos.numpy(), velocities=vel.numpy(),
                             sim_time=float(t), frame_id=frame)

    def verify_data_integrity(self) -> bool:
        """The snapshot read back equals the state on the device."""
        snap = self.latest()
        pos = self._decimate(self._system.state.pos).cpu().numpy()
        return bool(np.allclose(snap.positions, pos, atol=1e-6))
