#!/usr/bin/env python3
"""The first step at which each 1M Barnes-Hut driver turns non-finite on
the cold collapse.

    python3 scripts/collapse_nonfinite_torch.py [--steps 60]

From the root of a checkout, on a machine with one CUDA card. The scene is
``chip_smoke.py``'s 1M Barnes-Hut tiles scene (the spherical scene, radius
10, seed 42, dt 1e-3, d 64, k 16), which collapses: at unit masses its
free-fall time is ~35 steps. From its initial state (a(0) included) each
driver below runs k steps, for the k a bisection over [1, ``--steps``]
picks, and the first k whose state holds a non-finite position or
velocity is printed with the largest |pos| and |v| of step k − 1 (a run
that never turns non-finite prints "finite"); the state every 8 steps is
checked too, which the bisection assumes stays non-finite once it is:

  * the table-resident cadence 8 (``ops/table_step.make_table_multi_step``)
    on captured segments and eagerly;
  * the row-space cadence 8 (``ops/integrator.make_resort_multi_step``) on
    captured segments and eagerly;
  * the cell-sorted step every step on a ``StepGraph`` (the facade's
    ``run_steps`` on this scene).

Equal steps across the drivers say the scene turns non-finite; a driver
alone, or a graph alone, would be a port fault. Needs a card; exits
non-zero without one.
"""

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from chip_smoke import BH_RESORT, path_configs, row_multi, table_multi
    from nbody_tpu_torch import ParticleSystem
    from nbody_tpu_torch.ops.forces import make_table_step_params
    from nbody_tpu_torch.ops.step_graph import SegmentGraphs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    cfg = path_configs()[BH_RESORT]
    ps = ParticleSystem()
    ps.initialize(cfg)
    state0, sf = ps.state, ps._sorted_force
    tp = make_table_step_params(cfg, device=state0.pos.device,
                                pos_hint=state0.pos)

    def drivers():
        """label -> (n -> multi(state) -> state), each keeping its graphs
        over its runs."""
        tg, rg = SegmentGraphs(), SegmentGraphs()
        return {
            "table cadence 8, graphed": lambda n: table_multi(
                tp, cfg, "cadence", n, graphs=tg),
            "table cadence 8, eager": lambda n: table_multi(
                tp, cfg, "cadence", n, graphs=SegmentGraphs(graphed=False)),
            "row cadence 8, graphed": lambda n: row_multi(
                sf, cfg, "cadence", n, graphs=rg),
            "row cadence 8, eager": lambda n: row_multi(
                sf, cfg, "cadence", n, graphs=SegmentGraphs(graphed=False)),
            "sorted every step, graphed (StepGraph)": lambda n: row_multi(
                sf, cfg.replace(resort_every=1), "repair", n,
                graphs=SegmentGraphs()),
        }

    def finite(st) -> bool:
        return bool(torch.isfinite(st.pos).all()
                    and torch.isfinite(st.vel).all())

    def extent(st) -> str:
        return (f"max|pos| {float(st.pos.abs().max()):.4e}, max|v| "
                f"{float(st.vel.abs().max()):.4e}")

    firsts = {}
    for label, make in drivers().items():
        def run(k, make=make):
            out = make(k)(state0)
            torch.cuda.synchronize()
            return out

        marks = {k: finite(run(k)) for k in range(8, args.steps + 1, 8)}
        end = run(args.steps)
        if finite(end):
            firsts[label] = None
            print(f"{label}: finite through {args.steps} steps ({extent(end)}"
                  f"); every 8 steps finite: {all(marks.values())}")
            continue
        lo, hi = 0, args.steps  # finite after lo steps, not after hi
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if finite(run(mid)):
                lo = mid
            else:
                hi = mid
        firsts[label] = hi
        before = run(lo) if lo else state0
        bad = run(hi)
        what = [f for f in ("pos", "vel")
                if not bool(torch.isfinite(getattr(bad, f)).all())]
        print(f"{label}: first non-finite after step {hi} ({', '.join(what)}"
              f" non-finite); after step {lo}: {extent(before)}; every 8 "
              f"steps: {marks}")
        del before, bad, end
        torch.cuda.empty_cache()
    same = len(set(firsts.values())) == 1
    print(f"first non-finite step by driver: {firsts}; "
          f"{'the same step for every driver' if same else 'DRIVERS DIFFER'}"
          f" ({smi})")


if __name__ == "__main__":
    main()
