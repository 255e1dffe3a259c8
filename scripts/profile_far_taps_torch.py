#!/usr/bin/env python3
"""Time kernel K3 (the far-field tap sum, csrc/far_taps.cu) at every level
of one 1M Barnes-Hut tiles step on one CUDA card.

    PYTHONPATH=. python3 scripts/profile_far_taps_torch.py

The inputs are those of ``chip_smoke.py``'s K3 check: the 1M spherical
scene (radius 10, seed 42, θ = 0.5, ``bh_max_level`` 6: d = 64, ws = 1)
at step 0, its moment pyramid and each level's tap matrices. For each
level p = 32 .. 1 it prints the median time of one call (CUDA events
around each of 21 calls, after 3 warm calls) and the kernel's device time
per call (``torch.profiler`` over 20 calls), then both summed over the
six levels. Needs a card.
"""

import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

CALLS = 20


def one_call_ms(fn, reps=21, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if "far_taps" in e.key) / CALLS / 1e3


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from chip_smoke import path_configs
    from nbody_tpu_torch.models.distributions import init_from_config
    from nbody_tpu_torch.ops.barnes_hut import (
        bh_engine_params,
        bin_particles,
        level_moments,
        level_tap_matrices,
        pyramid_from_packed,
    )
    from nbody_tpu_torch.ops.far_taps import far_taps
    from nbody_tpu_torch.ops.scatter import tile_scatter
    from nbody_tpu_torch.ops.sorted_window import build_sorted_grid

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda")
    cfg = path_configs()["1M BH tiles"]
    scene = init_from_config(cfg, device=dev)
    p = bh_engine_params(cfg)
    levels, k, ws, eps = p["levels"], p["near_k"], p["ws"], cfg.softening
    d = 1 << levels
    lo, cell, coords = bin_particles(scene.pos, levels)
    grid = build_sorted_grid(scene.pos, scene.mass, coords, d)
    _, mk = tile_scatter(grid.psort, grid.cell_start, lo, cell, d=d, k=k)
    pyr = pyramid_from_packed(mk[:10].T.reshape(d, d, d, 10), lo, cell,
                              levels)
    print(f"K3 per level, 1M BH tiles step 0 (ws = {ws}); {smi}", flush=True)
    tot_one = tot_dev = 0.0
    for lvl in range(levels, 0, -1):
        pp = (1 << lvl) // 2
        mom = level_moments(pyr, lvl)
        taps = level_tap_matrices(cell, ws, eps, levels, [lvl])[0].contiguous()

        def run():
            return far_taps(mom, taps, p=pp, ws=ws)

        one, dv = one_call_ms(run), device_ms(run)
        tot_one, tot_dev = tot_one + one, tot_dev + dv
        print(f"p = {pp:2d}: one call {one:.4f} ms, device {dv:.4f} ms",
              flush=True)
    print(f"six levels: one call each {tot_one:.4f} ms, device "
          f"{tot_dev:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
