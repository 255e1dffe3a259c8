"""4M-particle flagship on one CUDA card: the PyTorch/CUDA counterpart of
``scripts/flagship_4m.py`` (BASELINE.json config #5 at scale), at its full
size.

Two parts:

  1. bh-4m — 4M-particle Barnes-Hut on the dense spherical bench scene
     (``init_spherical``, radius 10, seed 42 from a generator on the
     device), ``bh_max_level`` 6 → d 64, occupancy 15.26 → near_k 40, ws 1,
     quadrupole sources, dt 1e-3: cell-sorted stepping through
     ``make_sorted_multi_step`` (kernels K2, K3 ×6, K4 a step), 15 steps a
     run, timed from the initial state, best of 3 after a warm run. Prints
     steps/s, the engine parameters, the audit's overflow rows and the
     median relative error of 4096 sampled rows against the direct kernel
     K1 over all sources (gate: < 0.05).
  2. galaxy-4m — two 2M-particle disks on an approach trajectory
     (``galaxy_collision``, seed 7, separation 30, approach 0.8), dt 5e-3,
     softening 0.2, ``bh_max_level`` 6, stepped in sorted chunks of 5 and
     rendered through kernel R1 (``PointRenderer``, 960×540, camera
     distance 70, azimuth 0.6, elevation 0.6) from every ``N // 1_000_000``-th
     row, frame 0 and 6 more, each written as a PNG. Prints steps/s with
     the per-chunk host work, R1's time a frame and the audit's overflow
     rows, and the BH error against K1 as a reading (not gated: the disks
     overflow the occupancy-chosen k).

It ends with the JAX script's one-line JSON of results.

Usage: python scripts/flagship_4m_torch.py [out_dir] [--n N] [--frames F]
       [--device cpu]
Env: NBODY_FLAGSHIP_N (default 4_000_000), NBODY_FLAGSHIP_FRAMES (6).
The card unless ``--device cpu`` (the plain twins; use a small N there).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

N = int(os.environ.get("NBODY_FLAGSHIP_N", 4_000_000))
FRAMES = int(os.environ.get("NBODY_FLAGSHIP_FRAMES", 6))
STEPS_PER_FRAME = 5
BH_STEPS = 15
LEVELS = 6
DT = 1e-3
GATE = 0.05
SAMPLES = 4096


def resolve_device(name=None) -> torch.device:
    """``name``, or the CUDA card; raises when the card is asked for and
    absent (no fallback to the CPU)."""
    dev = torch.device(name or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu for the plain "
                         "twins")
    return dev


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generator(dev, seed: int) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def bh_config(n: int):
    from nbody_tpu_torch.types import ForceMethod, SimulationConfig

    return SimulationConfig(particle_count=n,
                            force_method=ForceMethod.BARNES_HUT,
                            bh_max_level=LEVELS, dt=DT)


def galaxy_config(n: int):
    return bh_config(n).replace(dt=5e-3, softening=0.2)


def bh_scene(n: int, dev):
    """Part 1's scene: the spherical bench scene, radius 10, seed 42."""
    from nbody_tpu_torch.models.distributions import init_spherical
    from nbody_tpu_torch.types import SphericalDistParams

    return init_spherical(generator(dev, 42), n,
                          SphericalDistParams(radius=10.0), device=dev)


def galaxy_scene(n: int, dev):
    """Part 2's scene: two disks, separation 30, approach 0.8, seed 7."""
    from nbody_tpu_torch.models.scenes import galaxy_collision

    return galaxy_collision(generator(dev, 7), n, separation=30.0,
                            approach_speed=0.8, device=dev)


def with_forces(state, sf):
    """``state`` with a(t) from the sorted force (unsorted by its
    permutation)."""
    from nbody_tpu_torch.ops.integrator import initialize_forces
    from nbody_tpu_torch.ops.sorted_window import unsort_rows

    def force(pos, mass):
        acc, _psort, order = sf(pos, mass)[:3]
        return unsort_rows(acc, order)

    return initialize_forces(state, force)


def overflow_rows(cfg, pos) -> int:
    """The audit's overflow: rows past the k-slot cap of their finest cell
    (``ParticleSystem.audit_short_range`` on the tiles engine), from the
    exact per-cell counts."""
    from nbody_tpu_torch.ops.barnes_hut import bh_engine_params, bin_particles
    from nbody_tpu_torch.ops.sorted_window import cell_ids

    p = bh_engine_params(cfg)
    d = 1 << p["levels"]
    _lo, _cell, coords = bin_particles(pos, p["levels"])
    counts = torch.bincount(cell_ids(coords, d).long(), minlength=d ** 3)
    return int(torch.clamp(counts - p["near_k"], min=0).sum())


def bh_error(cfg, state, sf) -> dict:
    """Relative error of the BH force on ``SAMPLES`` sampled rows (a
    seeded permutation) against K1 over all sources: median, p90, max."""
    from nbody_tpu_torch.ops.direct import direct_forces_kernel
    from nbody_tpu_torch.ops.sorted_window import unsort_rows

    pos, mass = state.pos, state.mass
    acc_s, _psort, order = sf(pos, mass)[:3]
    acc = unsort_rows(acc_s, order)
    n = pos.shape[0]
    idx = torch.randperm(n, generator=generator(pos.device, 0),
                         device=pos.device)[:min(SAMPLES, n)]
    ref = direct_forces_kernel(pos, mass, cfg.G, cfg.softening,
                               targets=pos[idx].contiguous())
    rel = (acc[idx] - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30)
    return dict(median=float(rel.median()),
                p90=float(rel.quantile(0.9)), max=float(rel.max()))


def timed_steps(multi, state, steps, dev, runs=3):
    """Warm run, then ``runs`` runs from the same initial state (the JAX
    script's and bench.py's protocol), host clock to a synchronize and a
    scalar read → (best steps/s, last result)."""
    out = multi(state)
    sync(dev)
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        out = multi(state)
        chk = float(out.pos[0].sum())
        best = min(best, time.perf_counter() - t0)
    if chk != chk:
        raise RuntimeError("bh-4m: NaN after the timed steps")
    return steps / best, out


def run_bh(n: int, dev, log=print) -> dict:
    """Part 1 (bh-4m). Returns its readings with the config, the sorted
    force, the initial state (a(0) set) and the last run's state."""
    from nbody_tpu_torch.ops.barnes_hut import bh_engine_params
    from nbody_tpu_torch.ops.forces import make_sorted_force_fn
    from nbody_tpu_torch.ops.integrator import make_sorted_multi_step

    cfg = bh_config(n)
    params = bh_engine_params(cfg)
    log(f"bh engine params: {params}")
    state = bh_scene(n, dev)
    sf = make_sorted_force_fn(cfg, pos_hint=state.pos)
    if sf is None:
        raise RuntimeError(f"bh-4m: no sorted engine for {params}")
    state = with_forces(state, sf)
    sps, out = timed_steps(make_sorted_multi_step(sf, DT, BH_STEPS), state,
                           BH_STEPS, dev)
    if not bool(torch.isfinite(out.pos).all()):
        raise RuntimeError("bh-4m: non-finite positions")
    overflow = overflow_rows(cfg, out.pos)
    err = bh_error(cfg, state, sf)
    log(f"bh-4m dense sphere: {sps:.3f} steps/s ({BH_STEPS} steps a run, "
        f"best of 3 from the initial state); audit overflow {overflow} rows "
        f"after {BH_STEPS} steps; vs direct ({min(SAMPLES, n)} sampled rows,"
        f" all {n} sources): median rel err {err['median']:.4e}, p90 "
        f"{err['p90']:.4e}, max {err['max']:.4e} (gate: median < {GATE})")
    if not err["median"] < GATE:
        raise RuntimeError(f"bh-4m: median relative error {err['median']} "
                           f">= {GATE}")
    return dict(sps=sps, params=params, overflow=overflow, error=err,
                cfg=cfg, sf=sf, state0=state, out=out)


def timer(dev):
    """``stop()`` after ``start()`` → ms: CUDA events on the card, the host
    clock on the CPU."""
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()

        def stop():
            b.record()
            b.synchronize()
            return a.elapsed_time(b)
        return stop
    t0 = time.perf_counter()
    return lambda: (time.perf_counter() - t0) * 1e3


def renderer_for_frames():
    from nbody_tpu_torch.render import Camera, PointRenderer
    from nbody_tpu_torch.types import RenderConfig

    return PointRenderer(RenderConfig(window_width=960, window_height=540),
                         camera=Camera(distance=70.0, azimuth=0.6,
                                       elevation=0.6))


def frame_points(state):
    """The rows a frame draws: every ``N // 1_000_000``-th (≤ 1M points),
    as the JAX script decimates."""
    decim = max(1, state.n // 1_000_000)
    return (state.pos[::decim].contiguous(),
            state.vel[::decim].contiguous())


def run_galaxy(n: int, frames: int, out_dir, dev, log=print) -> dict:
    """Part 2 (galaxy-4m): frame 0, then ``frames`` chunks of
    ``STEPS_PER_FRAME`` sorted steps, each followed by an R1 frame written
    as a PNG. Returns the readings, the config, the sorted force, the last
    state and the frame paths."""
    from nbody_tpu_torch.ops.forces import make_sorted_force_fn
    from nbody_tpu_torch.ops.integrator import make_sorted_multi_step

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = galaxy_config(n)
    state = galaxy_scene(n, dev)
    sf = make_sorted_force_fn(cfg, pos_hint=state.pos)
    if sf is None:
        raise RuntimeError("galaxy-4m: no sorted engine")
    state = with_forces(state, sf)
    chunk = make_sorted_multi_step(sf, cfg.dt, STEPS_PER_FRAME)
    renderer = renderer_for_frames()
    sync(dev)
    t_steps, r1_ms, paths = 0.0, [], []
    for f in range(frames + 1):  # frame 0 = the initial state
        if f > 0:
            t0 = time.perf_counter()
            state = chunk(state)
            float(state.time)
            t_steps += time.perf_counter() - t0
        stop = timer(dev)
        img = renderer.frame(*frame_points(state))
        r1_ms.append(stop())
        path = out_dir / f"frame_{f:04d}.png"
        renderer.save_png(img, str(path))
        paths.append(path)
        log(f"frame {f}/{frames} t={float(state.time):.3f} R1 "
            f"{r1_ms[-1]:.4f} ms")
    if not bool(torch.isfinite(state.pos).all()):
        raise RuntimeError("galaxy-4m: non-finite positions")
    sps = frames * STEPS_PER_FRAME / t_steps if frames else 0.0
    overflow = overflow_rows(cfg, state.pos)
    err = bh_error(cfg, state, sf)
    frame_ms = sorted(r1_ms)[len(r1_ms) // 2]
    log(f"galaxy-4m flagship: {sps:.3f} steps/s (incl. per-chunk dispatch "
        f"and the host read; frames in {out_dir}); R1 median {frame_ms:.4f} "
        f"ms a frame of {frame_points(state)[0].shape[0]} points; audit "
        f"overflow {overflow} rows; vs direct: median rel err "
        f"{err['median']:.4e} (reading; the disks overflow k, not gated)")
    return dict(sps=sps, r1_ms=r1_ms, overflow=overflow, error=err, cfg=cfg,
                sf=sf, out=state, paths=paths, renderer=renderer)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?",
                    default=str(REPO / "build" / "flagship_4m"))
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the plain twins")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device={name} N={args.n}", flush=True)
    log = lambda s: print(s, flush=True)  # noqa: E731
    bh = run_bh(args.n, dev, log)
    results = {"bh-4m": round(bh["sps"], 2)}
    del bh
    galaxy = run_galaxy(args.n, args.frames, args.out_dir, dev, log)
    results["galaxy-4m"] = round(galaxy["sps"], 2)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
