"""Application shell: CLI options → simulation → benchmark or step loop.

PyTorch-package counterpart of ``nbody_tpu/app.py``. Benchmark mode runs
the JAX package's flow: initialize (and import) → one warm chunk → the
timed chunks → optional export → the ``BenchmarkRunRecord`` JSON on stdout
(and in ``--benchmark-output``), with the phase timings. The step loop is
the JAX loop: key controls through the ``UIPanel`` handshake, per-second
stats, a final JSON summary, and with ``--render`` / ``--live`` the frames
rendered on the card (``nbody_tpu_torch.render``), written as the JAX
app's PNG files or drawn in the terminal.

Everything runs on the CUDA card unless the caller passes ``device="cpu"``
(the tests do); without a card ``Application`` raises, apart from
``--diagnostics``, which only reports.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import sys
import time

import torch

from nbody_tpu_torch.cli import AppCliOptions
from nbody_tpu_torch.ops.integrator import sampled_total_energy
from nbody_tpu_torch.render.camera import Camera
from nbody_tpu_torch.render.renderer import PointRenderer, png_rows, write_png
from nbody_tpu_torch.render.stream import HostDoubleBuffer
from nbody_tpu_torch.render.terminal import TerminalView
from nbody_tpu_torch.render.ui import UIPanel
from nbody_tpu_torch.system import ParticleSystem
from nbody_tpu_torch.types import ColorMode, ForceMethod, RenderConfig
from nbody_tpu_torch.utils.hdf5_io import HAVE_HDF5, HDF5IO
from nbody_tpu_torch.utils.profiling import (
    BenchmarkRunRecord,
    consume_global_phase_snapshot,
    profile_phase,
    profiling_enabled,
    serialize_benchmark_run_records,
    set_profiling_enabled,
)

# Key → action: Space pause/resume, r reset, 1/2/3 force method, c color
# mode cycle, p panel toggle, q/Esc quit; h/l orbit azimuth, j/k orbit
# elevation, +/- zoom, 0 camera reset (the camera keys act once --render or
# --live made a camera).
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
        # the step loop's controls and views (set by run_interactive)
        self.panel = UIPanel()
        self.camera = self.renderer = self.live_view = None
        self._stats_line = ""
        self._write = None  # the PNG write in flight

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
        Chrome trace of the timed chunks to ``DIR/trace.json``, with the
        profiling switch at "trace" from the start (before the warm-up
        chunk captures the step): the trace holds each phase's span and,
        on the card, its marks inside every replay
        (``utils/profiling.py``)."""
        o = self.options
        setting = profiling_enabled()
        if o.trace_dir:
            set_profiling_enabled("trace")
        try:
            return self._benchmark(o)
        finally:
            set_profiling_enabled(setting)

    def _benchmark(self, o) -> int:
        """``run_benchmark_mode`` under the switch it set."""
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

    def _apply_action(self, action) -> bool:
        """Act on one key's action between steps; True for quit. The panel
        takes pause, reset, a method switch and its visibility; ``c``
        cycles the renderer's color mode once a renderer exists; the
        camera keys move the loop's camera."""
        if action == "quit":
            return True
        if action == "toggle_pause":
            self.panel.click_pause()
        elif action == "reset":
            self.panel.click_reset()
        elif action and action.startswith("method:"):
            self.panel.select_method(
                ForceMethod.parse(action.split(":", 1)[1]))
        elif action == "cycle_color":
            if self.renderer is not None:
                mode = self.renderer.config.color_mode
                self.renderer.set_color_mode(
                    ColorMode((mode + 1) % len(ColorMode)))
        elif action == "toggle_panel":
            self.panel.toggle_visibility()
        else:
            apply_camera_action(self.camera, action)
        return False

    def _start_frame(self, copies: HostDoubleBuffer):
        """Render the current state where it lies and start copying what
        the host needs of it: the uint8 image when frames are written, the
        terminal view's count grid when live. None when nothing is
        copied."""
        st, out = self.system.state, []
        if self.renderer is not None:
            image = self.renderer.frame(st.pos, st.vel)
            if self.options.render_output:
                out.append(image)
        if self.live_view is not None:
            out.append(self.live_view.raster(st.pos))
        return copies.put(*out) if out else None

    def _finish_frame(self, copy, frame: int, writer) -> None:
        """Frame ``frame`` from its copy: its PNG handed to ``writer`` (one
        write in flight: the previous one is waited for first), and drawn
        live."""
        host = copy.wait()
        if self.renderer is not None and self.options.render_output:
            rows = png_rows(host[0])
            self._wait_write()
            self._write = writer.submit(
                self._encode, os.path.join(self.options.render_output,
                                           f"frame_{frame:05d}.png"), rows)
        if self.live_view is not None:
            self.live_view.show(self.live_view.frame(host[-1],
                                                     self._stats_line))

    @staticmethod
    def _encode(path: str, rows) -> None:
        with profile_phase("render.encode"):
            write_png(path, rows)

    def _wait_write(self) -> None:
        """Wait for the PNG write in flight, raising its error."""
        if self._write is not None:
            write, self._write = self._write, None
            write.result()

    def run_interactive(self) -> int:
        """``--steps`` steps (1000 when unset) of ``update()``, with the
        panel's flags consumed before each step (pause/resume, reset, a
        method switch), key controls read from a TTY, per-second stats
        (on stderr unless the live view shows them), and a JSON summary at
        the end: the exact total energy up to ``EXACT_ENERGY_MAX_N``
        particles, the sampled estimate above.

        ``--render`` renders each state but the last right after its
        update, where the state lies (kernel R1 on the card), and with
        ``--render-output`` copies its uint8 image to the host on a side
        stream; the previous frame's PNG is compressed and written by a
        writer thread while the loop launches the next step. ``--live``
        draws the same frames in the terminal (only the count grid crosses
        to the host). Frame k is the state after k + 1 updates, and the
        last state is not drawn, as in the JAX app (which draws each
        update's snapshot after the next update)."""
        o = self.options
        self._initialize_system()

        if o.render or o.live:
            self.camera = Camera(distance=45.0, azimuth=0.7, elevation=0.75)
            if o.render:
                self.renderer = PointRenderer(self.render_config, self.camera)
            if o.live:
                self.live_view = TerminalView(camera=self.camera)
        if o.render_output:
            os.makedirs(o.render_output, exist_ok=True)
        copies = HostDoubleBuffer()
        pending = None  # (copy, frame) of the last state rendered
        steps = o.steps if o.steps > 0 else 1000
        fps_t0 = time.perf_counter()
        fps_frames = 0
        interactive_tty = sys.stdin.isatty()
        # the loop to its last device work, on the host clock; the PNG
        # files are compressed and written by one thread beside it (zlib
        # releases the interpreter lock), so the steps never wait on them
        with profile_phase("app.loop"), \
                concurrent.futures.ThreadPoolExecutor(1) as writer:
            for frame in range(steps):
                if interactive_tty:
                    for key in _poll_keys():
                        if self._apply_action(key_to_action(key)):
                            self.system.synchronize()
                            self._wait_write()
                            if self.live_view is not None:
                                self.live_view.close()
                            self._export_if_requested()
                            print(json.dumps({"steps": frame, "quit": True}))
                            return 0
                if self.panel.consume_pause_clicked():
                    if self.system.is_paused:
                        self.system.resume()
                    else:
                        self.system.pause()
                if self.panel.consume_reset_clicked():
                    self.system.reset()
                new_method = self.panel.consume_method_change()
                if new_method is not None:
                    self.system.set_force_method(new_method)
                self.system.update()
                if o.debug_nans:
                    self._check_finite(f"step {frame}")
                fps_frames += 1
                shown = None
                if (self.renderer or self.live_view) and frame < steps - 1:
                    shown = self._start_frame(copies)
                if pending is not None:
                    self._finish_frame(*pending, writer)
                pending = None if shown is None else (shown, frame)
                now = time.perf_counter()
                if now - fps_t0 >= 1.0:
                    self.system.synchronize()
                    fps = fps_frames / (now - fps_t0)
                    method = self.system.config.force_method.cli_name
                    self.panel.set_stats(
                        fps=fps,
                        particle_count=self.system.particle_count,
                        method=method,
                        sim_time=self.system.simulation_time,
                    )
                    self._stats_line = (
                        f"t={self.system.simulation_time:.3f} "
                        f"N={self.system.particle_count} {method} "
                        f"{fps:.1f} steps/s")
                    if self.live_view is None:
                        print(self._stats_line, file=sys.stderr)
                    fps_t0, fps_frames = now, 0

            self.system.synchronize()
            self._wait_write()
        if self.live_view is not None:
            self.live_view.close()
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
