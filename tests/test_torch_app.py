"""nbody_tpu_torch ``Application`` against the JAX package's (CPU, with
``device="cpu"``): the benchmark record, export/import, the step loop's
summary, the key controls and the panel handshake, the rendered frames
and the live view, and what is refused."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import nbody_tpu.app as japp
import nbody_tpu.cli as jcli
import nbody_tpu.render.camera as jcam
import nbody_tpu.render.ui as jui
import nbody_tpu.types as jtypes
import nbody_tpu.utils.profiling as jprof
import nbody_tpu.utils.serialization as jser
import nbody_tpu_torch.app as tapp
import nbody_tpu_torch.cli as tcli
import nbody_tpu_torch.render.ui as tui
import nbody_tpu_torch.utils.profiling as tprof
from nbody_tpu_torch.ops.integrator import initialize_forces
from nbody_tpu_torch.types import ColorMode, ForceMethod
from nbody_tpu_torch.utils import serialization as tser


def _run(pkg, argv, capsys):
    """Run ``argv`` through the package's Application; returns (rc, the
    JSON it printed last, the application)."""
    if pkg == "jax":
        app = japp.Application(jcli.parse_app_cli_options(argv))
    else:
        app = tapp.Application(tcli.parse_app_cli_options(argv),
                               device="cpu")
    rc = app.run()
    out = capsys.readouterr().out
    return rc, json.loads(out[out.index("{"):]), app


def test_benchmark_record_matches_jax(capsys, tmp_path):
    """N = 512 direct-n2, 7 steps (chunks of 7): the record's keys, its
    params and its iterations equal the JAX Application's, the metrics
    positive, the output file the printed JSON."""
    argv = ["--particles", "512", "--benchmark-steps", "7", "--init",
            "disk", "--benchmark-output", str(tmp_path / "b.json")]
    rc_j, doc_j, _ = _run("jax", argv, capsys)
    rc_t, doc_t, app = _run("torch", argv, capsys)
    assert rc_j == rc_t == 0
    (rj,), (rt,) = doc_j["benchmark_runs"], doc_t["benchmark_runs"]
    assert rt.keys() == rj.keys()
    assert rt["params"] == rj["params"]
    assert rt["metrics"].keys() == rj["metrics"].keys()
    for k in ("name", "method", "particle_count", "iterations"):
        assert rt[k] == rj[k]
    assert rt["iterations"] == 7 and rt["metrics"]["steps_per_sec"] > 0
    assert rt["phase_timings"]["simulation.run_steps"]["samples"] == 2
    assert json.loads((tmp_path / "b.json").read_text()) == doc_t
    assert abs(app.system.simulation_time - 14e-3) < 1e-6


def test_record_schema_matches_jax():
    """The same record and phase snapshot serialize to the same text."""
    recs = []
    for prof in (jprof, tprof):
        r = prof.BenchmarkRunRecord(name="x", method="direct-n2",
                                    particle_count=3, iterations=4,
                                    metrics={"steps_per_sec": 2.5},
                                    params={"dt": "0.001"})
        r.attach_phase_snapshot({"b": prof.PhaseStats(3.0, 2),
                                 "a": prof.PhaseStats(1.0, 0)})
        recs.append(prof.serialize_benchmark_run_records([r, r]))
    assert recs[0] == recs[1]


def test_profiling_switch_and_snapshot():
    p = tprof.PhaseProfiler()
    try:
        tprof.set_profiling_enabled(False)
        assert not tprof.profiling_enabled()
        with tprof.profile_phase("off", profiler=p):
            pass
        assert p.snapshot() == {}
    finally:
        tprof.set_profiling_enabled(True)
    with tprof.profile_phase("on", device="cpu", profiler=p):
        pass
    assert p.snapshot()["on"].samples == 1
    assert p.snapshot()["on"].samples == 1  # a snapshot does not drain
    p.reset()
    assert p.consume() == {}
    assert tprof.get_global_profiler() is tprof.get_global_profiler()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_export_then_import_restores_the_state(capsys, tmp_path, writer):
    """``--export`` after a benchmark, then ``--import`` in the port: pos,
    vel and mass bit-equal to the file (written by either package), the
    time and method from the file, a(t) equal to ``initialize_forces`` on
    the imported state."""
    path = str(tmp_path / "s.nbody")
    _run(writer, ["--particles", "300", "--method", "direct-n2",
                  "--benchmark-steps", "3", "--export", path], capsys)
    saved = jser.Serializer.load(path)
    app = tapp.Application(tcli.parse_app_cli_options(
        ["--particles", "64", "--method", "hash", "--import", path]),
        device="cpu")
    app._initialize_system()
    st = app.system.state
    np.testing.assert_array_equal(st.pos.numpy(), saved.pos)
    np.testing.assert_array_equal(st.vel.numpy(), saved.vel)
    np.testing.assert_array_equal(st.mass.numpy(), saved.mass)
    assert app.system.particle_count == 300
    assert app.system.config.force_method == ForceMethod.DIRECT_N2
    assert abs(app.system.simulation_time - 6e-3) < 1e-6
    want = initialize_forces(st, app.system._force_fn).acc
    assert torch.equal(st.acc, want)


def test_hdf5_export_import(capsys, tmp_path):
    pytest.importorskip("h5py")
    path = str(tmp_path / "s.h5")
    _, _, first = _run("torch", ["--particles", "200", "--benchmark-steps",
                                 "2", "--export", path], capsys)
    app = tapp.Application(tcli.parse_app_cli_options(
        ["--particles", "10", "--import", path]), device="cpu")
    app._initialize_system()
    assert torch.equal(app.system.state.pos, first.system.state.pos)
    assert torch.equal(app.system.state.vel, first.system.state.vel)


def test_step_loop_summary_matches_jax(capsys):
    """``--steps 3``: the summary's keys equal the JAX loop's, with the
    same step count, kind and time; its energy is the facade's
    ``compute_total_energy`` (to 1e-6 relative). The two scenes agree in
    distribution only, so each energy is held within 15 % of the uniform
    ball's −(3/5)·G·M²/R."""
    argv = ["--particles", "400", "--steps", "3"]
    _, sj, _ = _run("jax", argv, capsys)
    _, st, app = _run("torch", argv, capsys)
    assert st.keys() == sj.keys()
    assert (st["steps"], st["energy_kind"]) == (sj["steps"],
                                                sj["energy_kind"]) == (
        3, "exact")
    assert abs(st["final_time"] - sj["final_time"]) < 1e-6
    assert abs(st["total_energy"] - app.system.compute_total_energy()) <= (
        1e-6 * abs(st["total_energy"]))
    ball = -0.6 * 400**2 / 10.0
    assert abs(st["total_energy"] / ball - 1) < 0.15
    assert abs(sj["total_energy"] / ball - 1) < 0.15


def test_key_actions_and_camera_match_jax():
    assert tapp.KEY_ACTIONS == japp.KEY_ACTIONS
    for key in list(japp.KEY_ACTIONS) + ["R", "Q", "z", "\x1b"]:
        assert tapp.key_to_action(key) == japp.key_to_action(key)

    class Cam:
        def __init__(self):
            self.log = []

        def rotate(self, a, e):
            self.log.append(("rotate", a, e))

        def zoom(self, z):
            self.log.append(("zoom", z))

        def reset(self):
            self.log.append(("reset",))

    cams = Cam(), Cam()
    for action in ["camera:orbit:1:0", "camera:orbit:0:-1", "camera:zoom:1",
                   "camera:reset", "reset", "", None]:
        got = tapp.apply_camera_action(cams[0], action)
        assert got == japp.apply_camera_action(cams[1], action)
    assert cams[0].log == cams[1].log and len(cams[0].log) == 4
    assert not tapp.apply_camera_action(None, "camera:zoom:1")


def test_ui_panel_handshake_matches_jax():
    """The same sequence of inputs gives the same consumed flags, stats
    and text in both panels."""
    out = []
    for ui, fm in ((jui, jtypes.ForceMethod), (tui, ForceMethod)):
        p = ui.UIPanel()
        log = [p.consume_pause_clicked(), p.consume_method_change()]
        p.click_pause()
        p.click_reset()
        p.select_method(fm.BARNES_HUT)
        log += [p.consume_pause_clicked(), p.consume_pause_clicked(),
                p.consume_reset_clicked(), p.consume_reset_clicked(),
                p.consume_method_change().name, p.consume_method_change()]
        p.set_stats(fps=50.0, particle_count=7, method="bh", sim_time=0.5,
                    kinetic_energy=1.5, unknown=3)
        log.append(p.render_text())
        p.toggle_visibility()
        log += [p.visible, p.render_text(), p.stats.frame_time_ms]
        out.append(log)
    assert out[0] == out[1]


@pytest.mark.parametrize("argv", [
    ["--devices", "2", "--benchmark", "--benchmark-steps", "4"],
    ["--devices", "2", "--steps", "1"],
], ids=["benchmark", "steps"])
def test_devices_flag_runs_sharded(argv, capsys):
    """``--devices 2`` runs the benchmark mode and the step loop on a mesh
    of 2 virtual CPU shards: the record names the devices, the summary
    is finite."""
    app = tapp.Application(tcli.parse_app_cli_options(
        ["--particles", "32", "--method", "direct-n2"] + argv), device="cpu")
    assert app.run() == 0
    assert app.system.is_sharded and app.system.mesh.size == 2
    assert app.system.diagnostics()["force_distribution"] == "ring"
    out = capsys.readouterr().out
    if "--benchmark" in argv:
        rec = json.loads(out)["benchmark_runs"][0]
        assert rec["params"]["devices"] == "2"
        assert rec["particle_count"] == 32
        assert rec["metrics"]["steps_per_sec"] > 0
    else:
        summary = json.loads(out.strip().splitlines()[-1])
        assert summary["steps"] == 1
        assert np.isfinite(summary["total_energy"])


RENDER_ARGV = ["--particles", "2000", "--method", "direct-n2", "--render",
               "--steps", "3"]


def test_render_output_writes_the_jax_frames(capsys, tmp_path):
    """``--render --render-output DIR --steps 3`` writes the JAX app's file
    names (frame k = the state after k + 1 updates; the last state is not
    drawn), each a 720×1280 RGB PNG with something drawn; the summary
    follows."""
    names = []
    for pkg in ("jax", "torch"):
        out = tmp_path / pkg
        rc, summary, _ = _run(pkg, RENDER_ARGV + ["--render-output",
                                                  str(out)], capsys)
        assert rc == 0 and summary["steps"] == 3
        names.append(sorted(p.name for p in out.iterdir()))
    assert names[0] == names[1] == ["frame_00000.png", "frame_00001.png"]
    for name in names[1]:
        img = np.asarray(Image.open(tmp_path / "torch" / name))
        assert img.shape == (720, 1280, 3) and img.max() > 0


def test_render_alone_writes_no_files(capsys, tmp_path, monkeypatch):
    """``--render`` without an output renders every state but the last and
    writes nothing, as the JAX app."""
    monkeypatch.chdir(tmp_path)
    frames = []
    real = tapp.PointRenderer.frame

    def frame(self, *a):
        frames.append(1)
        return real(self, *a)

    monkeypatch.setattr(tapp.PointRenderer, "frame", frame)
    rc, summary, app = _run("torch", RENDER_ARGV, capsys)
    assert rc == 0 and summary["energy_kind"] == "exact"
    assert len(frames) == 2 and list(tmp_path.iterdir()) == []
    assert app.renderer is not None and app.live_view is None


def test_live_view_draws_steps_minus_one_frames(capsys):
    """``--live --steps 4``: one screen clear, 3 frames redrawn in place
    (36 rows and a stats line each), the cursor restored, then the JSON
    summary last; no stats on stderr (the live view carries them)."""
    app = tapp.Application(tcli.parse_app_cli_options(
        ["--particles", "500", "--method", "direct-n2", "--live", "--steps",
         "4"]), device="cpu")
    assert app.run() == 0
    assert app.renderer is None and app.live_view is not None
    out = capsys.readouterr()
    text = out.out
    assert text.count("\x1b[2J") == 1 and text.count("\x1b[H") == 3
    assert text.count("\x1b[?25h") == 1
    frames = text.split("\x1b[H")[1:]
    assert all(f.count("\n") >= 37 for f in frames)
    assert json.loads(text.strip().splitlines()[-1])["steps"] == 4
    assert "steps/s" not in out.err


def test_color_key_cycles_the_renderer():
    """``c`` cycles the renderer's color mode DEPTH → VELOCITY → DENSITY →
    DEPTH once a renderer exists, and does nothing before."""
    app = tapp.Application(tcli.parse_app_cli_options(["--render"]),
                           device="cpu")
    assert not app._apply_action(tapp.key_to_action("c"))
    app.renderer = tapp.PointRenderer(app.render_config)
    seen = []
    for _ in range(3):
        assert not app._apply_action(tapp.key_to_action("C"))
        seen.append(app.renderer.config.color_mode)
    assert seen == [ColorMode.VELOCITY, ColorMode.DENSITY, ColorMode.DEPTH]
    assert app.renderer.color_mapper.mode == ColorMode.DEPTH
    assert app._apply_action(tapp.key_to_action("q"))


def test_loop_keys_reach_the_panel_and_the_camera():
    """The loop's handler: space, r, 2 and p set the panel's flags; the
    camera keys move the loop's camera as the JAX camera moves."""
    app = tapp.Application(tcli.parse_app_cli_options(["--live"]),
                           device="cpu")
    for key in " r2p":
        app._apply_action(tapp.key_to_action(key))
    assert app.panel.consume_pause_clicked()
    assert app.panel.consume_reset_clicked()
    assert app.panel.consume_method_change() == ForceMethod.BARNES_HUT
    assert not app.panel.visible
    app.camera = tapp.Camera(distance=45.0, azimuth=0.7, elevation=0.75)
    ref = jcam.Camera(distance=45.0, azimuth=0.7, elevation=0.75)
    for key in "hlkk+-=0j":
        app._apply_action(tapp.key_to_action(key))
        japp.apply_camera_action(ref, japp.key_to_action(key))
        np.testing.assert_array_equal(app.camera.view_matrix,
                                      ref.view_matrix)


def test_application_needs_the_card(capsys):
    """``Application(options)`` means the card: without one it raises,
    apart from ``--diagnostics``, which reports that there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    opts = tcli.parse_app_cli_options(["--particles", "32", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        tapp.Application(opts).run()
    opts = tcli.parse_app_cli_options(["--diagnostics"])
    assert tapp.Application(opts).run() == 0
    assert "no CUDA device present" in capsys.readouterr().out


def test_debug_nans_and_trace(capsys, tmp_path):
    """``--debug-nans`` raises ``FloatingPointError`` at the first chunk
    whose state is not finite (here from an imported NaN); ``--trace DIR``
    leaves a Chrome trace of the timed chunks in DIR, taken with the
    profiling switch at trace (the step's phases are spans there) and the
    switch restored after."""
    snap = tser.load_bytes(tser.save_bytes(tser.SimulationState(
        pos=np.zeros((3, 3)) + np.arange(3)[:, None], vel=np.zeros((3, 3)),
        mass=np.ones(3))))
    snap.pos[1, 0] = np.nan
    path = str(tmp_path / "nan.nbody")
    tser.Serializer.save(path, snap)
    app = tapp.Application(tcli.parse_app_cli_options(
        ["--import", path, "--benchmark-steps", "2", "--debug-nans"]),
        device="cpu")
    with pytest.raises(FloatingPointError, match="warm-up chunk"):
        app.run()
    trace = tmp_path / "tr"
    setting = tprof.profiling_enabled()
    rc, _, _ = _run("torch", ["--particles", "64", "--benchmark-steps", "2",
                              "--trace", str(trace), "--debug-nans"], capsys)
    assert rc == 0
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    spans = {e["name"] for e in events
             if e.get("name", "").startswith(tprof.SPAN_PREFIX)}
    assert {"nbody.simulation.run_steps", "nbody.step.drift",
            "nbody.step.kick"} <= spans
    assert tprof.profiling_enabled() == setting
