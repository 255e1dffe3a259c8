"""nbody_tpu_torch rendering against the JAX package's (CPU): the camera's
matrices and projection, the color ramps, the point renderer (R1's plain
twin) against the JAX renderer with its native splat and with its NumPy
fallback, the terminal view's raster and text, the PNG writer and the
point stream."""

import io

import numpy as np
import pytest
import torch
from PIL import Image

import nbody_tpu.render.camera as jcam
import nbody_tpu.render.color as jcol
import nbody_tpu.render.renderer as jren
import nbody_tpu.render.terminal as jterm
import nbody_tpu.types as jtypes
from nbody_tpu_torch import ParticleSystem
from nbody_tpu_torch.ops.render import (
    _round_half_away,
    render_points,
    render_points_plain,
)
from nbody_tpu_torch.render import (
    Camera,
    ColorMapper,
    PointRenderer,
    PointStream,
    TerminalView,
)
from nbody_tpu_torch.render.stream import HostDoubleBuffer
from nbody_tpu_torch.types import ColorMode, RenderConfig, SimulationConfig

# The app's camera (every sprite at radius 1) and a close one inside the
# radius-10 cloud (radii 2-8, points behind the eye and off screen).
CAMERAS = {"app": dict(distance=45.0, azimuth=0.7, elevation=0.75),
           "close": dict(distance=5.0, azimuth=0.7, elevation=0.75)}
W, H = 320, 180


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(n=4000, seed=3):
    """A radius-10 ball (the spherical scene's extent) and velocities, as
    float32 arrays — the simulation's type."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3))
    r = np.cbrt(rng.uniform(size=n)) * 10.0
    pos = v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None]
    vel = rng.standard_normal((n, 3))
    return pos.astype(np.float32), vel.astype(np.float32)


def _moves(cam):
    cam.rotate(0.4, -0.2)
    cam.zoom(1.5)
    cam.pan(12.0, -7.0)
    cam.rotate(-1.3, 3.0)  # past the gimbal clamp
    cam.zoom(-40.0)        # past the far clamp


def test_camera_matrices_and_controls_match_jax():
    """The same rotate/zoom/pan sequence, then reset: every matrix and
    control value equal to the JAX camera's."""
    kw = dict(distance=20.0, azimuth=0.3, elevation=0.2, target=(1, 2, 3),
              aspect=1.5)
    t, j = Camera(**kw), jcam.Camera(**kw)
    for step in (lambda c: None, _moves, lambda c: c.reset()):
        step(t)
        step(j)
        np.testing.assert_array_equal(t.view_matrix, j.view_matrix)
        np.testing.assert_array_equal(t.projection_matrix,
                                      j.projection_matrix)
        np.testing.assert_array_equal(t.position, j.position)
        assert (t.distance, t.azimuth, t.elevation) == (
            j.distance, j.azimuth, j.elevation)


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_camera_project_matches_jax(cam):
    """``project`` on a float64 tensor and on an array: ndc and depth
    within 1e-12 of the JAX camera's, the same in-front mask."""
    pos = np.random.default_rng(0).standard_normal((500, 3)) * 8.0
    t, j = Camera(**CAMERAS[cam]), jcam.Camera(**CAMERAS[cam])
    want = j.project(pos)
    got_t = [a.numpy() for a in t.project(torch.from_numpy(pos))]
    got_n = t.project(pos)
    assert not want[2].all() or cam == "app"
    for got in (got_t, got_n):
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", list(ColorMode), ids=lambda m: m.name)
@pytest.mark.parametrize("flat", [False, True], ids=["spread", "constant"])
def test_color_mapper_matches_jax(mode, flat):
    rng = np.random.default_rng(1)
    z = np.full(64, 3.0) if flat else rng.uniform(1, 50, 64)
    v = np.tile([1.0, 2.0, 2.0], (64, 1)) if flat else rng.normal(
        size=(64, 3))
    d = None if mode != ColorMode.DENSITY else (np.full(64, 0.5) if flat
                                               else rng.uniform(size=64))
    want = jcol.ColorMapper(jtypes.ColorMode(int(mode)))(z, v, d)
    got = ColorMapper(mode)(torch.from_numpy(z), torch.from_numpy(v),
                            None if d is None else torch.from_numpy(d))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    if mode == ColorMode.DENSITY:  # no density input: the ramp's start
        got = ColorMapper(mode)(torch.from_numpy(z), torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(),
                                      np.tile(jcol._SPARSE, (64, 1)))


def _pair(mode, cam, size=(W, H)):
    cfg = dict(window_width=size[0], window_height=size[1])
    t = PointRenderer(RenderConfig(color_mode=mode, **cfg),
                      Camera(**CAMERAS[cam]))
    j = jren.PointRenderer(
        jtypes.RenderConfig(color_mode=jtypes.ColorMode(int(mode)), **cfg),
        jcam.Camera(**CAMERAS[cam]))
    return t, j


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("cam", sorted(CAMERAS))
@pytest.mark.parametrize("mode", list(ColorMode), ids=lambda m: m.name)
def test_renderer_matches_jax(mode, cam, native):
    """``PointRenderer.render`` on CPU tensors (R1's twin) within 1e-5 of
    the JAX renderer on the same float32 points, with its C++ splat and
    with its NumPy fallback (the JAX package's own tolerance between the
    two); the app's camera draws every point at radius 1, the close one
    at radii 2-8."""
    pos, vel = _cloud()
    t, j = _pair(mode, cam)
    if native:
        assert j._native is not None, "native/libnbody_native.so not loaded"
    else:
        j._native = None
    want = j.render(pos, vel)
    got = t.render(torch.from_numpy(pos), torch.from_numpy(vel))
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert want.max() > 0
    np.testing.assert_array_equal(t.render(pos, vel).numpy(), got.numpy())
    sp = render_points_plain(
        torch.from_numpy(pos), None, t.camera, width=W, height=H,
        point_size=2.0, mode=mode, sprites=True).sprites
    radius = _round_half_away(sp[2][sp[2] > 0] * 0.5).clamp(min=1)
    assert set(radius.tolist()) == (set(range(2, 9)) if cam == "close"
                                    else {1})
    assert (sp[2] == 0).any() == (cam == "close")  # culled points


@pytest.mark.parametrize("what", ["empty", "off screen", "behind"])
def test_renderer_draws_nothing_without_visible_points(what):
    t, j = _pair(ColorMode.DEPTH, "app")
    pos = {"empty": np.zeros((0, 3), np.float32),
           "off screen": np.full((10, 3), 1e6, np.float32),
           "behind": np.tile(2 * t.camera.position, (10, 1)).astype(
               np.float32)}[what]
    got = t.render(torch.from_numpy(pos))
    assert got.shape == (H, W, 3) and float(got.abs().max()) == 0.0
    np.testing.assert_array_equal(got.numpy(), j.render(pos))


def test_plain_twin_accumulations_and_outputs():
    """f32 and f64 accumulation within 1e-6 of each other; the uint8 copy
    is (img·255) truncated; ``render_points`` on CPU tensors is the twin;
    sprite rows of culled points are 0."""
    pos, vel = (torch.from_numpy(a) for a in _cloud())
    cam = Camera(**CAMERAS["close"])
    kw = dict(width=W, height=H, point_size=2.0, mode=ColorMode.VELOCITY,
              uint8=True, sprites=True)
    a = render_points_plain(pos, vel, cam, **kw)
    b = render_points_plain(pos, vel, cam, accumulate="f64", **kw)
    calls = render_points_plain.calls
    c = render_points(pos, vel, cam, **kw)
    assert render_points_plain.calls == calls + 1
    assert float((a.image - b.image).abs().max()) <= 1e-6
    assert torch.equal(a.image_u8, (a.image * 255).to(torch.uint8))
    for x, y in zip(a.sprites, c.sprites):
        assert torch.equal(x, y)
    off = a.sprites[2] == 0
    assert off.any() and float(a.sprites[3][off].abs().max()) == 0.0
    with pytest.raises(ValueError, match="accumulate"):
        render_points_plain(pos, vel, cam, accumulate="f16", **kw)


def test_round_half_away_is_lround():
    v = torch.tensor([-2.5, -1.5, -0.5, -0.3, 0.0, 0.3, 0.5, 1.5, 2.5,
                      np.float32(0.49999997), 639.5], dtype=torch.float32)
    assert _round_half_away(v).tolist() == [-3, -2, -1, 0, 0, 0, 1, 2, 3, 0,
                                            640]


def test_save_png_decodes_like_the_jax_file(tmp_path):
    """The stdlib writer's file decodes (PIL) to (img·255) truncated, equal
    to the JAX ``save_png`` file decoded; a uint8 image is written as it
    is."""
    t, _ = _pair(ColorMode.DEPTH, "app")
    img = t.render(*_cloud())
    img[0, 0] = torch.tensor([1.0, 0.5, 0.999])
    ours, theirs = tmp_path / "t.png", tmp_path / "j.png"
    PointRenderer.save_png(img, str(ours))
    jren.PointRenderer.save_png(img.numpy(), str(theirs))
    got = np.asarray(Image.open(ours))
    assert got.shape == (H, W, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, (img.numpy() * 255).astype(np.uint8))
    np.testing.assert_array_equal(got, np.asarray(Image.open(theirs)))
    PointRenderer.save_png((img * 255).to(torch.uint8), str(ours))
    np.testing.assert_array_equal(np.asarray(Image.open(ours)), got)


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_terminal_view_matches_jax(cam):
    """The raster's counts equal the JAX view's and ``compose`` gives the
    same string, points behind the eye and off screen included."""
    pos, _ = _cloud(3000)
    behind = np.tile(2 * jcam.Camera(**CAMERAS[cam]).position, (7, 1))
    pos = np.concatenate([pos, behind.astype(np.float32)])
    t = TerminalView(Camera(**CAMERAS[cam]), width=60, height=20)
    j = jterm.TerminalView(jcam.Camera(**CAMERAS[cam]), width=60, height=20)
    grid = t.raster(torch.from_numpy(pos))
    assert grid.dtype == torch.int32
    np.testing.assert_array_equal(grid.numpy(), j.raster(pos))
    assert t.compose(torch.from_numpy(pos), "stats") == j.compose(pos,
                                                                  "stats")
    assert t.compose(np.zeros((0, 3)), "x") == j.compose(np.zeros((0, 3)),
                                                         "x")


def test_terminal_view_draw_and_close():
    out_t, out_j = io.StringIO(), io.StringIO()
    t = TerminalView(width=30, height=8, out=out_t)
    j = jterm.TerminalView(width=30, height=8, out=out_j)
    pos, _ = _cloud(500)
    for v in (t, j):
        v.draw(pos, "a")
        v.draw(pos[:100], "b")
        v.close()
    assert out_t.getvalue() == out_j.getvalue()
    assert out_t.getvalue().count("\x1b[2J") == 1


@pytest.mark.parametrize("max_points", [2_000_000, 300])
def test_point_stream_on_cpu(max_points):
    """The snapshot is the state at request time (decimated by
    ceil(n / max_points) above the cap), later steps leave it as it was,
    and ``verify_data_integrity`` holds."""
    ps = ParticleSystem()
    ps.initialize(SimulationConfig(particle_count=1000), device="cpu")
    stream = PointStream(ps, max_points=max_points)
    want = ps.state.pos[::-(-1000 // max_points)].clone()
    stream.request()
    ps.update()
    snap = stream.latest()
    assert snap.frame_id == 0 and snap.sim_time == 0.0
    assert snap.positions.shape == (want.shape[0], 3)
    np.testing.assert_array_equal(snap.positions, want.numpy())
    assert snap.velocities.dtype == np.float32
    assert stream.verify_data_integrity()
    stream.request()
    assert stream.latest().frame_id == 2  # the check requested frame 1


def test_host_double_buffer_on_cpu_copies():
    buf = HostDoubleBuffer()
    a = torch.arange(6.0)
    copy = buf.put(a, a * 2)
    a += 1
    x, y = copy.wait()
    assert x.tolist() == [0, 1, 2, 3, 4, 5] and y[-1] == 10
