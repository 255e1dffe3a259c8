#!/usr/bin/env python3
"""Time kernel R1 (the point splat, csrc/render.cu) at the 1M shapes of
``chip_smoke.py``'s r1 on one CUDA card, today's index chunks against one
chunk a tile, per kernel; optionally time an earlier render.cu beside
today's.

    PYTHONPATH=. python3 scripts/profile_render_torch.py \
        [--baseline OLD_RENDER_CU]

The scene is the 1M Barnes-Hut step-0 state (chip_smoke's ``1M BH
tiles`` configuration) at 1280x720 with the uint8 copy, the app's call
form, at the app's camera and the close one, in each colour mode. At
each:

  * the tiles' list entries and longest list (``ops.render.tile_counts``);
  * R1 at today's ``ops.render.MAX_CHUNKS`` against one index chunk a
    tile (one counter a tile, each list sorted whole): the images
    bit-equal, then their device times (CUDA graph replay,
    ``chip_smoke.graph_ms``) in the order A, B, B, A three times over
    (``profile_tile_near_torch.ab``);
  * the device time of each of R1's kernels, from ``torch.profiler`` over
    10 calls.

``--baseline`` names a render.cu whose ``nbt_render_points`` has the
earlier C signature (pos, vel, n, mats, half_near, ps30, mode, width,
height, img, u8, pts, key, rgb, range, stream), such as the float-atomic
splat of an earlier commit saved from version control to a file. It is
built with the package's nvcc flags; its image is held to today's within
1e-5 (its atomics add in no fixed order) and timed against today's in
turns. Needs a card.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np
import torch

from chip_smoke import APP_CAMERA, CLOSE_CAMERA, path_configs
from profile_tile_near_torch import ab

WIDTH, HEIGHT = 1280, 720


def load_baseline(path):
    """Build the render.cu at ``path`` into a shared library (the package's
    nvcc flags) and bind its ``nbt_render_points`` (earlier signature)."""
    from nbody_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / "render_baseline.so"
    out = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
         str(path)], capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(f"nvcc failed for {path}:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.nbt_render_points.argtypes = [P, P, I, P, D, D, I, I, I, P, P, P, P,
                                      P, P, P]
    lib.nbt_render_points.restype = ctypes.c_int
    return lib


def baseline_call(lib, pos, vel, cam, mode):
    """One call of the baseline's splat in the app's form → uint8 copy and
    image."""
    from nbody_tpu_torch.ops.render import SIZE_SCALE
    from nbody_tpu_torch.types import ColorMode

    dev, n = pos.device, pos.shape[0]
    view = cam.view_matrix
    mats = np.ascontiguousarray(np.concatenate(
        [(cam.projection_matrix @ view).ravel(), view.ravel()]),
        dtype=np.float64)
    img = torch.empty((HEIGHT, WIDTH, 3), dtype=torch.float32, device=dev)
    u8 = torch.empty((HEIGHT, WIDTH, 3), dtype=torch.uint8, device=dev)
    pts = torch.empty((3, n), dtype=torch.float32, device=dev)
    key = torch.empty(n, dtype=torch.float64, device=dev)
    rng = torch.empty(2, dtype=torch.int64, device=dev)
    err = lib.nbt_render_points(
        pos.data_ptr(), vel.data_ptr(), n, mats.ctypes.data, cam.near * 0.5,
        2.0 * SIZE_SCALE, int(ColorMode(mode)), WIDTH, HEIGHT,
        img.data_ptr(), u8.data_ptr(), pts.data_ptr(), key.data_ptr(), None,
        rng.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index or 0))
    if err != 0:
        sys.exit(f"baseline nbt_render_points: CUDA error {err}")
    return img


def kernel_times(call):
    """{kernel name: mean device ms a call} over 10 calls (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        if t > 0:
            name = re.search(r"\w+_kernel|Memset", ev.key)
            name = name.group(0) if name else ev.key[:40]
            out[name] = round(out.get(name, 0.0) + t / 10 / 1e3, 4)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", metavar="RENDER_CU",
                        help="an earlier render.cu to time beside today's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from nbody_tpu_torch.models.distributions import init_from_config
    from nbody_tpu_torch.ops import render as R
    from nbody_tpu_torch.render import Camera
    from nbody_tpu_torch.types import ColorMode

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    dev = torch.device("cuda")
    base = load_baseline(args.baseline) if args.baseline else None
    scene = init_from_config(path_configs()["1M BH tiles"], device=dev)
    pos, vel = scene.pos, scene.vel
    today = R.MAX_CHUNKS

    def at(chunks, cam, mode):
        def call():
            R.MAX_CHUNKS = chunks
            try:
                return R.render_points(pos, vel, cam, width=WIDTH,
                                       height=HEIGHT, point_size=2.0,
                                       mode=mode, uint8=True)
            finally:
                R.MAX_CHUNKS = today
        return call

    for cam_name, cam_kw in (("app", APP_CAMERA), ("close", CLOSE_CAMERA)):
        cam = Camera(**cam_kw)
        for mode in ColorMode:
            label = f"R1 {cam_name} camera, {mode.name}"
            sp = R.render_points(pos, vel, cam, width=WIDTH, height=HEIGHT,
                                 point_size=2.0, mode=mode,
                                 sprites=True).sprites
            lists = R.tile_counts(*sp[:3], width=WIDTH, height=HEIGHT)
            print(f"{label}: {int((sp[2] > 0).sum())} visible; "
                  f"{R.TILE}x{R.TILE} tiles: {int(lists.sum())} list "
                  f"entries, longest list {int(lists.max())}", flush=True)
            a = at(today, cam, mode)
            want = a().image
            b = at(1, cam, mode)
            if not torch.equal(b().image, want):
                sys.exit(f"{label}: 1 chunk differs from {today}")
            ab(label, f"{today} chunks", a, "1 chunk", b, smi)
            print(f"{label}, {today} chunks: device ms a call by kernel "
                  f"{kernel_times(a)}", flush=True)
            if base is not None:
                old = baseline_call(base, pos, vel, cam, mode)
                e = float((old - want).abs().max())
                print(f"{label}: baseline image max|diff| {e:.3e} against "
                      f"today's (tol 1e-5)", flush=True)
                if not e <= 1e-5:
                    sys.exit(f"{label}: baseline and today differ")
                ab(label, "baseline", lambda: baseline_call(
                    base, pos, vel, cam, mode), f"{today} chunks", a, smi)


if __name__ == "__main__":
    main()
