"""The facade's one-step functions are capture-safe (CPU).

On the card ``ParticleSystem.update`` and ``run_steps`` replay ONE captured
Verlet step (``nbody_tpu_torch/ops/step_graph.py``). A capture cannot
hold a host read: a ``.item()``, a ``nonzero``, boolean-mask indexing (a
``nonzero`` inside) or a tensor made from host data. Here, for each step
engine, the step the facade would capture runs once more after a warm step
under two guards, ``torch.tensor`` / ``torch.as_tensor`` /
``torch.from_numpy`` patched to raise and a dispatch mode that fails on
``aten._local_scalar_dense``, ``aten.nonzero`` and indexing by a boolean
mask, with the kernels' plain twins exempt (they never run on the card),
and must give the unguarded step's state bit for bit (one intra-op
thread).

That the same CPU facade still agrees with the JAX facade is held by
``tests/test_torch_system.py`` (BH tiles, both hash engines, the BH window
engine, the setters) and ``tests/test_torch_sorted_state.py``; the graphed
steps themselves are held to the eager ones on the card
(``tests/test_torch_cuda.py -k step_graph``, ``chip_smoke.py`` phase 11).
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _disable_current_modes,
)

from nbody_tpu_torch import ParticleSystem
from nbody_tpu_torch.ops import direct, far_taps, scatter, tile_near
from nbody_tpu_torch.ops import window_sweep
from nbody_tpu_torch.ops.barnes_hut import barnes_hut_forces_sorted
from nbody_tpu_torch.ops.integrator import (
    sorted_state_from,
    sorted_verlet_step,
)
from nbody_tpu_torch.state import SimulationState
from nbody_tpu_torch.types import ForceMethod, SimulationConfig

aten = torch.ops.aten
HOST_READS = (aten._local_scalar_dense.default, aten.nonzero.default)
# indexing ops whose boolean index takes a nonzero inside the kernel,
# below the dispatch mode
INDEXING = (aten.index.Tensor, aten.index_put.default,
            aten.index_put_.default)
# (module, name) of the plain twin each CPU wrapper calls
PLAIN_TWINS = ((scatter, "tile_scatter_plain"), (scatter, "segment_sum_plain"),
               (tile_near, "tile_sweep_plane_plain"),
               (far_taps, "far_taps_plain"),
               (window_sweep, "window_sweep_plain"),
               (direct, "direct_forces"))
HOST_DATA = ("tensor", "as_tensor", "from_numpy")

BH = dict(force_method=ForceMethod.BARNES_HUT, bh_max_level=3,
          barnes_hut_theta=1.0)
HASH = dict(force_method=ForceMethod.SPATIAL_HASH, hash_max_grid_dim=16,
            spatial_hash_cell_size=2.0)
# engine -> (rows, config, kind): kind "sorted" is the cell-sorted step
# run_steps captures, "plain" the Verlet step of update() and of the
# engines without the sorted contract, "monopole" the order-1 BH tiles
# path under the sorted step (a path the facade never selects).
ENGINES = {
    "bh tiles order 2": (400, BH, "sorted"),
    "bh tiles order 1": (400, BH, "monopole"),
    # the window engine needs > 24 rows a finest cell: 1600 rows on 4³
    "bh window": (1600, dict(BH, bh_max_level=2), "plain"),
    "hash window": (400, dict(HASH, hash_engine="window"), "sorted"),
    "hash tiles": (400, dict(HASH, hash_engine="tiles"), "sorted"),
    "direct": (300, dict(force_method=ForceMethod.DIRECT_N2), "plain"),
}


class _NoHostReads(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in HOST_READS:
            raise AssertionError(f"host read in the step: {func}")
        if func in INDEXING and any(
                t is not None and t.dtype in (torch.bool, torch.uint8)
                for t in args[1]):
            raise AssertionError(f"boolean-mask indexing in the step: {func}")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _guards(monkeypatch):
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
        with _NoHostReads():
            yield
    finally:
        monkeypatch.undo()


def _system(n, kw):
    rng = np.random.default_rng(17)
    pos = rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    vel = rng.normal(0.0, 0.1, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    cfg = SimulationConfig(particle_count=n, dt=1e-3, **kw)
    ps = ParticleSystem()
    ps.initialize(cfg, device="cpu")
    ps.set_state(SimulationState(pos=pos, vel=vel, mass=mass,
                                 force_method=cfg.force_method, dt=cfg.dt,
                                 G=cfg.G, softening=cfg.softening))
    return ps


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_step_is_capture_safe(engine, monkeypatch, one_thread):
    n, kw, kind = ENGINES[engine]
    ps = _system(n, kw)
    cfg = ps.config
    if kind == "plain":
        step, state = ps._step, ps.state
    else:
        state = sorted_state_from(ps.state)
        step = ps._sorted_step
        if kind == "monopole":
            def step(s):
                return sorted_verlet_step(
                    s, lambda p, m: barnes_hut_forces_sorted(
                        p, m, cfg.G, cfg.softening, cfg.barnes_hut_theta,
                        levels=cfg.bh_max_level, near_k=8,
                        multipole_order=1), cfg.dt)
    assert step is not None, f"{engine}: the facade has no such step"
    if engine.startswith("bh"):
        from nbody_tpu_torch.ops.barnes_hut import bh_engine_params

        want = "window" if engine == "bh window" else "tiles"
        assert bh_engine_params(cfg)["near_engine"] == want
    if engine.startswith("hash"):
        p = getattr(ps._sorted_force, "engine_params")
        assert p["engine"] == engine.split()[1]
    state = step(state)  # the warm step: fills the device tables
    want = step(state)
    with _guards(monkeypatch):
        got = step(state)
    for k, v in vars(want).items():
        assert torch.equal(getattr(got, k), v), f"{engine}: {k} differs"
