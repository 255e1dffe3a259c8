"""Application shell: CLI options → simulation → benchmark or step loop.

PyTorch-package counterpart of ``nbody_tpu/app.py``. Benchmark mode runs
the JAX package's flow: initialize (and import) → one warm chunk → the
timed chunks → optional export → the ``BenchmarkRunRecord`` JSON on stdout
(and in ``--benchmark-output``), with the phase timings. The step loop is
the JAX loop without rendering: key controls through the ``UIPanel``
handshake, per-second stats on stderr, and a final JSON summary.

Everything runs on the CUDA card unless the caller passes ``device="cpu"``
(the tests do); without a card ``Application`` raises, apart from
``--diagnostics``, which only reports. ``--render`` and ``--live`` are not
ported (ROADMAP A7) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time

import torch

from nbody_tpu_torch.cli import AppCliOptions
from nbody_tpu_torch.ops.integrator import sampled_total_energy
from nbody_tpu_torch.render.ui import UIPanel
from nbody_tpu_torch.system import ParticleSystem
from nbody_tpu_torch.types import ColorMode, ForceMethod, RenderConfig
from nbody_tpu_torch.utils.hdf5_io import HAVE_HDF5, HDF5IO
from nbody_tpu_torch.utils.profiling import (
    BenchmarkRunRecord,
    consume_global_phase_snapshot,
    serialize_benchmark_run_records,
)

# Key → action: Space pause/resume, r reset, 1/2/3 force method, c color
# mode cycle, p panel toggle, q/Esc quit; h/l orbit azimuth, j/k orbit
# elevation, +/- zoom, 0 camera reset (camera keys act once a renderer's
# camera exists).
_CAM_STEP = 0.15  # radians per keypress
KEY_ACTIONS = {
    " ": "toggle_pause",
    "r": "reset",
    "1": "method:direct-n2",
    "2": "method:barnes-hut",
    "3": "method:spatial-hash",
    "c": "cycle_color",
    "p": "toggle_panel",
    "h": "camera:orbit:-1:0",
    "l": "camera:orbit:1:0",
    "j": "camera:orbit:0:-1",
    "k": "camera:orbit:0:1",
    "+": "camera:zoom:1",
    "=": "camera:zoom:1",
    "-": "camera:zoom:-1",
    "0": "camera:reset",
    "q": "quit",
    "\x1b": "quit",
}

# Particles up to which the loop's summary reports the exact energy (the
# sampled estimate above).
EXACT_ENERGY_MAX_N = 100_000


def apply_camera_action(camera, action: str) -> bool:
    """Apply a ``camera:...`` action to a camera with ``rotate``, ``zoom``
    and ``reset``; True if it was a camera action."""
    if camera is None or not action or not action.startswith("camera:"):
        return False
    parts = action.split(":")
    if parts[1] == "orbit":
        camera.rotate(float(parts[2]) * _CAM_STEP, float(parts[3]) * _CAM_STEP)
    elif parts[1] == "zoom":
        camera.zoom(float(parts[2]))
    elif parts[1] == "reset":
        camera.reset()
    return True


def key_to_action(key: str):
    """The action of one key (None for an unmapped key)."""
    return KEY_ACTIONS.get(key.lower() if key != "\x1b" else key)


def _poll_keys():
    """Non-blocking read of pending single-key inputs from stdin (POSIX)."""
    import select

    keys = []
    try:
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if not ch:
                break
            keys.append(ch)
    except (OSError, ValueError):
        pass
    return keys


class Application:
    """The CLI's application: ``Application(options).run()``. ``device``
    None means the CUDA card."""

    def __init__(self, options: AppCliOptions, device=None):
        self.options = options
        self.device = device
        self.system = ParticleSystem()
        self.render_config = RenderConfig()

    # ---- top-level dispatch ------------------------------------------------

    def run(self) -> int:
        o = self.options
        if o.list_algorithms:
            from nbody_tpu_torch.ops.forces import list_algorithms

            print("Available force methods:")
            for name, desc in list_algorithms():
                print(f"  {name:14s} {desc}")
            return 0

        if o.show_diagnostics:
            self._print_diagnostics()
            return 0

        if o.benchmark_mode:
            return self.run_benchmark_mode()

        return self.run_interactive()

    def _print_diagnostics(self) -> None:
        import nbody_tpu_torch

        print(f"nbody-tpu-torch {nbody_tpu_torch.__version__}")
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                props = torch.cuda.get_device_properties(i)
                print(f"  device {i}: {props.name}, memory "
                      f"{props.total_memory / 2**30:.1f} GiB")
        else:
            print("  no CUDA device present")
        print(f"hdf5 support: {HAVE_HDF5}")

    # ---- shared init --------------------------------------------------------

    def _initialize_system(self) -> None:
        o = self.options
        self.system.initialize(o.to_config(), device=self.device)
        if o.import_path:
            if o.import_path.endswith((".h5", ".hdf5")):
                self.system.set_state(HDF5IO.import_from_file(o.import_path))
            else:
                self.system.load_state(o.import_path)

    def _export_if_requested(self) -> None:
        o = self.options
        if not o.export_path:
            return
        if o.export_format == "hdf5" or o.export_path.endswith((".h5", ".hdf5")):
            HDF5IO.export_to_file(o.export_path, self.system.get_state())
        else:
            self.system.save_state(o.export_path)

    def _check_finite(self, where: str) -> None:
        """``--debug-nans``: raise ``FloatingPointError`` if the state holds
        a NaN or an infinity (one host read)."""
        st = self.system.state
        if not all(bool(torch.isfinite(t).all())
                   for t in (st.pos, st.vel, st.acc)):
            raise FloatingPointError(
                f"non-finite particle state after {where} (--debug-nans)")

    # ---- benchmark mode -----------------------------------------------------

    def run_benchmark_mode(self) -> int:
        """Timed headless run. Steps go in equal chunks of
        min(steps, 50) through ``run_steps``, the step count rounded up to
        whole chunks (and reported); one chunk runs first, untimed, to
        build the kernels. With ``--debug-nans`` the state is checked once
        a chunk, so the run stops at the first chunk that produced a NaN,
        not at the operation (the JAX package's ``jax_debug_nans`` stops
        at the operation). ``--trace DIR`` writes a ``torch.profiler``
        Chrome trace of the timed chunks to ``DIR/trace.json``."""
        o = self.options
        self._initialize_system()
        consume_global_phase_snapshot()

        chunk = max(1, min(o.benchmark_steps, 50))
        n_chunks = -(-o.benchmark_steps // chunk)
        steps = n_chunks * chunk
        self.system.run_steps(chunk)
        if o.debug_nans:
            self._check_finite("the warm-up chunk")
        self.system.synchronize()

        prof = None
        if o.trace_dir:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.system.state.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
        with prof if prof is not None else contextlib.nullcontext():
            t0 = time.perf_counter()
            for i in range(n_chunks):
                self.system.run_steps(chunk)
                if o.debug_nans:
                    self._check_finite(f"timed chunk {i}")
            self.system.synchronize()
            wall = time.perf_counter() - t0
        if prof is not None:
            os.makedirs(o.trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(o.trace_dir, "trace.json"))

        self._export_if_requested()

        record = BenchmarkRunRecord(
            name="app.benchmark",
            method=o.force_method.cli_name,
            particle_count=o.particle_count,
            iterations=steps,
            metrics={
                "wall_time_ms": wall * 1e3,
                "wall_time_ms_per_step": wall * 1e3 / steps,
                "steps_per_sec": steps / wall,
            },
            params={
                "dt": str(o.dt),
                "G": str(o.G),
                "softening": str(o.softening),
                "theta": str(o.barnes_hut_theta),
                "cell_size": str(o.spatial_hash_cell_size),
                "cutoff": str(o.spatial_hash_cutoff),
                "init": o.init_distribution.name.lower(),
                "devices": str(o.devices),
                "resort_every": str(o.resort_every),
                "resort_stale_frac": str(o.resort_stale_frac),
            },
        )
        record.attach_phase_snapshot(consume_global_phase_snapshot())
        out = serialize_benchmark_run_records([record])
        print(out)
        if o.benchmark_output_path:
            with open(o.benchmark_output_path, "w") as f:
                f.write(out + "\n")
        return 0

    # ---- step loop ----------------------------------------------------------

    def run_interactive(self) -> int:
        """``--steps`` steps (1000 when unset) of ``update()``, with the
        panel's flags consumed before each step (pause/resume, reset, a
        method switch), key controls read from a TTY, per-second stats on
        stderr, and a JSON summary at the end: the exact total energy up
        to ``EXACT_ENERGY_MAX_N`` particles, the sampled estimate above."""
        o = self.options
        if o.render or o.live:
            raise NotImplementedError(
                "--render / --live: the renderer is not ported to "
                "nbody_tpu_torch yet (ROADMAP A7)")
        self._initialize_system()

        panel = UIPanel()
        steps = o.steps if o.steps > 0 else 1000
        fps_t0 = time.perf_counter()
        fps_frames = 0
        interactive_tty = sys.stdin.isatty()
        for frame in range(steps):
            if interactive_tty:
                for key in _poll_keys():
                    action = key_to_action(key)
                    if action == "quit":
                        self.system.synchronize()
                        self._export_if_requested()
                        print(json.dumps({"steps": frame, "quit": True}))
                        return 0
                    if action == "toggle_pause":
                        panel.click_pause()
                    elif action == "reset":
                        panel.click_reset()
                    elif action and action.startswith("method:"):
                        panel.select_method(
                            ForceMethod.parse(action.split(":", 1)[1]))
                    elif action == "cycle_color":
                        mode = self.render_config.color_mode
                        self.render_config = dataclasses.replace(
                            self.render_config,
                            color_mode=ColorMode((mode + 1) % len(ColorMode)))
                    elif action == "toggle_panel":
                        panel.toggle_visibility()
            if panel.consume_pause_clicked():
                if self.system.is_paused:
                    self.system.resume()
                else:
                    self.system.pause()
            if panel.consume_reset_clicked():
                self.system.reset()
            new_method = panel.consume_method_change()
            if new_method is not None:
                self.system.set_force_method(new_method)
            self.system.update()
            if o.debug_nans:
                self._check_finite(f"step {frame}")
            fps_frames += 1
            now = time.perf_counter()
            if now - fps_t0 >= 1.0:
                self.system.synchronize()
                fps = fps_frames / (now - fps_t0)
                method = self.system.config.force_method.cli_name
                panel.set_stats(
                    fps=fps,
                    particle_count=self.system.particle_count,
                    method=method,
                    sim_time=self.system.simulation_time,
                )
                print(f"t={self.system.simulation_time:.3f} "
                      f"N={self.system.particle_count} {method} "
                      f"{fps:.1f} steps/s", file=sys.stderr)
                fps_t0, fps_frames = now, 0

        self.system.synchronize()
        self._export_if_requested()
        if self.system.particle_count <= EXACT_ENERGY_MAX_N:
            energy = self.system.compute_total_energy()
            energy_kind = "exact"
        else:
            cfg = self.system.config
            energy = float(sampled_total_energy(self.system.state, cfg.G,
                                                cfg.softening))
            energy_kind = "sampled"
        summary = {
            "steps": steps,
            "final_time": self.system.simulation_time,
            "total_energy": energy,
            "energy_kind": energy_kind,
        }
        print(json.dumps(summary))
        return 0
