"""The CPU guards of the capture-safety tests (not a test module).

On the card the facade replays captured CUDA graphs (``nbody_tpu_torch/
ops/step_graph.py``, ``parallel/program.py``), and a capture cannot hold a
host read: a ``.item()``, a ``nonzero``, boolean-mask indexing (a
``nonzero`` inside) or a tensor made from host data. ``guards`` turns each
of them into an error while a step or a segment runs on the CPU:
``torch.tensor`` / ``torch.as_tensor`` / ``torch.from_numpy`` patched to
raise, and a dispatch mode that fails on ``aten._local_scalar_dense``,
``aten.nonzero``, ``aten.lift_fresh`` and indexing by a boolean mask, with
the kernels' plain twins exempt from both (they never run on the card).
"""

import contextlib

import pytest
import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _disable_current_modes,
)

from nbody_tpu_torch.ops import direct, far_taps, scatter, table_step
from nbody_tpu_torch.ops import tile_near, window_sweep

aten = torch.ops.aten
# (a tensor made from host data, as a list index, is lifted into the graph
# by aten.lift_fresh: a host-to-device copy on the card)
HOST_READS = (aten._local_scalar_dense.default, aten.nonzero.default,
              aten.lift_fresh.default)
# indexing ops whose boolean index takes a nonzero inside the kernel,
# below the dispatch mode
INDEXING = (aten.index.Tensor, aten.index_put.default,
            aten.index_put_.default)
# (module, name) of the plain twin each CPU wrapper calls
PLAIN_TWINS = ((scatter, "tile_scatter_plain"), (scatter, "segment_sum_plain"),
               (tile_near, "tile_sweep_plane_plain"),
               (far_taps, "far_taps_plain"),
               (window_sweep, "window_sweep_plain"),
               (direct, "direct_forces"), (scatter, "tile_place_plain"),
               (table_step, "table_drift_plain"),
               (table_step, "table_kick_plain"))
HOST_DATA = ("tensor", "as_tensor", "from_numpy")


class NoHostReads(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in HOST_READS:
            raise AssertionError(f"host read in the step: {func}")
        if func in INDEXING and any(
                t is not None and t.dtype in (torch.bool, torch.uint8)
                for t in args[1]):
            raise AssertionError(f"boolean-mask indexing in the step: {func}")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def guards(monkeypatch):
    """The two guards, with every plain twin exempt from both."""
    exempt = [0]

    def refuse(name, real):
        def call(*args, **kwargs):
            if exempt[0]:
                return real(*args, **kwargs)
            raise AssertionError(f"torch.{name} in the step")
        return call

    def twin(real):
        def call(*args, **kwargs):
            exempt[0] += 1
            try:
                with _disable_current_modes():
                    return real(*args, **kwargs)
            finally:
                exempt[0] -= 1
        call.calls = 0
        return call

    for name in HOST_DATA:
        monkeypatch.setattr(torch, name, refuse(name, getattr(torch, name)))
    for module, name in PLAIN_TWINS:
        monkeypatch.setattr(module, name, twin(getattr(module, name)))
    try:
        with NoHostReads():
            yield
    finally:
        monkeypatch.undo()


@pytest.fixture
def one_thread():
    """One intra-op thread, so that two runs of a CPU step are bit-equal."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
