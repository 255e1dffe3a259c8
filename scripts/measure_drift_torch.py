#!/usr/bin/env python3
"""Energy drift |ΔE/E| of 1M-particle Barnes-Hut Velocity Verlet on one
CUDA card, with the PyTorch port (nbody_tpu_torch): the port of
``scripts/measure_drift.py``, with the same command line and output.

    python3 scripts/measure_drift_torch.py [N] [STEPS] [CHUNK]

Defaults 1000000 10000 1000. Prints one JSON line at step 0 and after
every CHUNK steps ({"step", "E", "rel_drift", "pe_secs", "steps_per_sec"};
a killed run still leaves its checkpoints), then the final line
{"metric", "value", "target": 1e-4, "pass"}. The settings and the loop are
``nbody_tpu_torch.drift.run_drift``; the potential energy is the exact
all-pairs sum of kernel K5. Needs a card.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    argv = sys.argv[1:]
    n = int(argv[0]) if len(argv) > 0 else 1_000_000
    steps = int(argv[1]) if len(argv) > 1 else 10_000
    chunk = int(argv[2]) if len(argv) > 2 else 1_000

    from nbody_tpu_torch.drift import drift_metric, run_drift

    last = None
    for rec in run_drift(n, steps, chunk):
        print(json.dumps(rec), flush=True)
        last = rec
    print(json.dumps(drift_metric(n, steps, last)), flush=True)


if __name__ == "__main__":
    main()
