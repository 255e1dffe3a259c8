"""nbody_tpu_torch rendering against the JAX package's (CPU): the camera's
matrices and projection, the color ramps, the point renderer (R1's plain
twin) against the JAX renderer with its native splat and with its NumPy
fallback, the terminal view's raster and text, the PNG writer and the
point stream."""

import io
from fractions import Fraction

import numpy as np
import pytest
import torch
from PIL import Image

import nbody_tpu.render.camera as jcam
import nbody_tpu.render.color as jcol
import nbody_tpu.render.renderer as jren
import nbody_tpu.native.rasterizer as jnative
import nbody_tpu.render.terminal as jterm
import nbody_tpu.types as jtypes
from nbody_tpu_torch import ParticleSystem
from nbody_tpu_torch.ops.render import (
    TILE,
    _round_half_away,
    _splat_ordered,
    fma32,
    render_points,
    render_points_plain,
    tile_counts,
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


@pytest.mark.parametrize("cam", sorted(CAMERAS))
@pytest.mark.parametrize("mode", list(ColorMode), ids=lambda m: m.name)
def test_ordered_twin_equals_jax_native(mode, cam):
    """The point-order sum with the native library's two FMAs (R1's sum):
    ``render_points_plain(..., accumulate="ordered")`` and
    ``PointRenderer.render`` on CPU tensors give the JAX renderer's image
    with its native splat, bit for bit, in each mode and at both cameras
    (VELOCITY's key is |v| in float32, as NumPy's norm gives it)."""
    pos, vel = _cloud()
    t, j = _pair(mode, cam)
    assert j._native is not None, "native/libnbody_native.so not loaded"
    want = j.render(pos, vel)
    got = render_points_plain(
        torch.from_numpy(pos), torch.from_numpy(vel), t.camera, width=W,
        height=H, point_size=2.0, mode=mode, accumulate="ordered").image
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        t.render(torch.from_numpy(pos), torch.from_numpy(vel)).numpy(), want)
    assert want.max() > 0


def _f32_exact(x: Fraction) -> np.float32:
    """The float32 nearest the rational ``x``, ties to even."""
    r = np.float32(float(x))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    dist = [abs(Fraction(float(c)) - x) for c in cands]
    best = min(dist)
    near = [c for c, d in zip(cands, dist) if d == best]
    return min(near, key=lambda c: int(c.view(np.int32)) & 1)


def test_fma32_rounds_once():
    """``fma32`` against the exact a·b + c rounded once (``Fraction``), on
    operands where rounding in float64 then in float32 gives another
    value (the sum lands a hair below a float32 midpoint whose even
    neighbour is above it), their negations and scalings, and random
    float32 triples."""
    f32 = np.float32
    a, b = f32(1 + 2.0 ** -23), f32(2.0 ** -24 - 2.0 ** -47)
    c = f32(1 + 2.0 ** -23)
    cases = []
    for k in (0, -20, 7, 40):
        s = f32(2.0 ** k)
        for sa, sc in ((1, 1), (-1, -1)):
            cases.append((f32(sa * a * s), b, f32(sc * c * s)))
    rng = np.random.default_rng(11)
    rand = rng.standard_normal((3, 2000)).astype(f32) * f32(1e3) ** \
        rng.integers(-3, 4, (3, 2000)).astype(f32)
    cases += list(zip(*rand))
    x, y, z = (np.array(v, dtype=f32) for v in zip(*cases))
    got = fma32(*(torch.from_numpy(v) for v in (x, y, z))).numpy()
    want = np.array([_f32_exact(Fraction(float(p)) * Fraction(float(q))
                                + Fraction(float(r)))
                     for p, q, r in zip(x, y, z)], dtype=f32)
    np.testing.assert_array_equal(got, want)
    twice = (x.astype(np.float64) * y + z).astype(f32)
    assert (twice[:8] != want[:8]).all()  # the constructed cases do differ


@pytest.mark.parametrize("case", ["ragged", "stacked"])
def test_ordered_splat_equals_native_rasterizer(case):
    """``_splat_ordered`` (R1's sum) against
    ``nbody_tpu.native.rasterizer.splat`` on the same sprites, bit for bit:
    a ragged set of every size, partly off the 64×48 image, and a stack
    of 3000 sprites on a few pixels (long per-pixel sums)."""
    rng = np.random.default_rng(4 if case == "ragged" else 5)
    n, w, h = 3000, 64, 48
    if case == "ragged":
        px = rng.uniform(-12, w + 12, n)
        py = rng.uniform(-12, h + 12, n)
    else:
        px = rng.choice([10.0, 10.4, 11.5, 40.0], n)
        py = rng.choice([20.0, 20.6, 47.0], n)
    px, py = px.astype(np.float32), py.astype(np.float32)
    size = rng.uniform(0.5, 16.0, n).astype(np.float32)
    rgb = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    want = np.zeros((h, w, 3), np.float32)
    jnative.splat(want, px, py, size, rgb)
    cx, cy = (_round_half_away(torch.from_numpy(v)) for v in (px, py))
    r = _round_half_away(torch.from_numpy(size) * 0.5).clamp(min=1)
    got = _splat_ordered(cx, cy, r, torch.from_numpy(rgb), w, h)
    got = got.clamp(0.0, 1.0).reshape(h, w, 3).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0).sum() > 100


@pytest.mark.parametrize("w, h", [(53, 37), (64, 40)])
def test_tile_counts_match_the_boxes(w, h):
    """Each tile's list length: every visible sprite counted once in each
    tile its clipped bounding box touches (a loop over the sprites), with
    the image ragged and a whole number of tiles."""
    rng = np.random.default_rng(9)
    n = 400
    px = torch.from_numpy(rng.uniform(-10, w + 10, n).astype(np.float32))
    py = torch.from_numpy(rng.uniform(-10, h + 10, n).astype(np.float32))
    size = torch.from_numpy(rng.uniform(0.5, 16, n).astype(np.float32))
    size[::7] = 0  # not visible
    got = tile_counts(px, py, size, width=w, height=h)
    want = np.zeros(got.shape, np.int64)
    for x, y, s in zip(px.tolist(), py.tolist(), size.tolist()):
        if s == 0:
            continue
        r = max(1, int(_round_half_away(torch.tensor([s * 0.5]))[0]))
        cx, cy = (int(_round_half_away(torch.tensor([v]))[0])
                  for v in (x, y))
        x0, x1 = max(0, cx - r), min(w - 1, cx + r)
        y0, y1 = max(0, cy - r), min(h - 1, cy + r)
        if x0 <= x1 and y0 <= y1:
            want[y0 // TILE:y1 // TILE + 1, x0 // TILE:x1 // TILE + 1] += 1
    np.testing.assert_array_equal(got.numpy(), want)


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
    assert torch.equal(c.image, render_points_plain(
        pos, vel, cam, accumulate="ordered", **kw).image)
    assert float((c.image - b.image).abs().max()) <= 1e-6
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
