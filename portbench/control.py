"""Readings for the limits of ``correct``: the program's numbers and the
control's, seed by seed, in one process.

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--out <file.jsonl>]

For each seed, one run of the cell as ``run.py`` makes it (window of
``--seconds``), then the control put in the program's place over the same
probe: the plain reference one precision below the configuration's
float32 (``check.follow(..., control=True)``: the far field's products on
TF32 operands, the state held in bfloat16). Prints one JSON line a seed
with every number compared and the control's (``control_<name>``); the
benchmark's own runs never run the control. Needs a CUDA card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import check, core  # noqa: E402


def readings(workload: str, seed: int, seconds: float, t_start: float,
             **kw) -> dict:
    """One run's compared numbers and the control's (``control_<name>``)."""
    got = {}

    def on_final(ctx, given, targets, s1):
        s0, sim = ctx.final, ctx.sim
        kinds = list(ctx.traffic["probe"])
        start_known = ctx.traffic["last_step"] == "fresh"
        args = (s0, s1["pos"], given["mass"], targets, sim,
                ctx.config["reference"], kinds, start_known)
        ref = check.follow(*args)
        ctrl = check.follow(*args, control=True)
        nums, _ = check.gaps(ctrl, ref, float(sim["dt"]))
        got.update({f"control_{k}": v for k, v in nums.items()})
        if "image" in s0:
            from portbench.reference import render

            got["control_image_gap"] = render.image_gap(
                render.frame(s0["pos"], ctx.traffic, "f32"), s0["pos"],
                ctx.traffic)

    out, notes = core.run(workload, seed, seconds, False, t_start,
                          on_final=on_final, **kw)
    rec = {"workload": workload, "seed": seed, "correct": out["correct"],
           **{k: v["value"] for k, v in out["checks"].items()}, **got,
           **notes, "metrics": {k: v["value"]
                                for k, v in out["metrics"].items()}}
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    t = T_START
    for seed in args.seeds:
        rec = readings(args.workload, seed, args.seconds, t)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
