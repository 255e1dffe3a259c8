"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with CUDA cards. Prints, as its
last line on standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``, then ``checks``: each number compared with its limit, which
are also the last lines on standard error. Exits 2 without a CUDA card (or
with fewer cards than the cell asks for), 1 when the program cannot be
imported or a run loaded JAX or the JAX package, and prints no result then.
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

from portbench import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out, notes = core.run(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START)
    except core.Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = core.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 1
    print(f"portbench: {json.dumps(notes)}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
