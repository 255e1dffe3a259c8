#!/usr/bin/env python3
"""Time kernel K7 (the window sweep, csrc/window_sweep.cu) at its two 1M
shapes with each of its two pair loops, on one CUDA card.

    PYTHONPATH=. python3 scripts/profile_window_sweep_torch.py

The inputs are those of ``chip_smoke.py``'s K7 check (``k7_shapes``): the
1M spherical scene at step 0, sorted for the dense hash (d 64, cutoff 2)
and for the Barnes-Hut window engine (d 32). K7 picks its pair loop by
ε²: with ε² ≥ FLT_MIN (here ε = 0.1) the loop without the r² > 0 test,
on ``rsqrt.approx.ftz``; otherwise (here ε = 0) the loop that keeps the
test and ``rsqrtf``. Both walk the same rows of the same spans, so their
times on the same inputs compare the two loop bodies. Each shape is timed
in the order soft, plain, plain, soft, three times over: the device time
of one call by CUDA graph replay (``chip_smoke.graph_ms``). Prints every
time, the medians and their ratio. Needs a card.
"""

import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

ROUNDS = 3


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from chip_smoke import graph_ms, k7_shapes, path_configs
    from nbody_tpu_torch.models.distributions import init_from_config
    from nbody_tpu_torch.ops.window_sweep import window_sweep_kernel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda")
    scene = init_from_config(path_configs()["1M BH tiles"], device=dev)
    for label, g, kw in k7_shapes(scene.pos, scene.mass):
        args = (g.psort, g.csort, g.cell_start)
        loops = {
            "soft": lambda kw=kw: window_sweep_kernel(*args, **kw),
            "plain": lambda kw=kw: window_sweep_kernel(
                *args, **{**kw, "eps": 0.0}),
        }
        times = {"soft": [], "plain": []}
        for _ in range(ROUNDS):
            for name in ("soft", "plain", "plain", "soft"):
                times[name].append(graph_ms(loops[name], reps=3))
        med = {k: statistics.median(v) for k, v in times.items()}
        for name, ts in times.items():
            print(f"K7 {label}, {name} loop: device ms per call "
                  f"{[round(t, 4) for t in ts]}, median {med[name]:.4f}")
        print(f"K7 {label}: soft / plain = {med['soft'] / med['plain']:.4f} "
              f"({smi})")
        del g


if __name__ == "__main__":
    main()
