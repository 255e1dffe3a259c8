"""Energy-conservation study: two-body circular orbit, long-horizon drift
tracking with CSV output and a dt sweep (reference:
examples/example_energy_conservation.cpp:91-213).

Counterpart of examples/example_energy_conservation.py on the PyTorch/CUDA
port: the direct force is kernel K1 on the card.

Usage: python examples_torch/example_energy_conservation.py [steps]
       [sweep_steps] [--device cpu] [--out CSV]
"""

import csv
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples_torch._common import parse  # noqa: E402
from nbody_tpu_torch.models import two_body_orbit  # noqa: E402
from nbody_tpu_torch.ops.direct import direct_forces_kernel  # noqa: E402
from nbody_tpu_torch.ops.integrator import (  # noqa: E402
    initialize_forces,
    make_multi_step,
    total_energy,
)


def drift_run(dt: float, steps: int, device, chunk: int = 1000):
    """``steps`` Verlet steps of the orbit in chunks of ``chunk`` →
    (E0, [(step, E, relative drift) per chunk])."""
    G, eps = 1.0, 0.1
    chunk = max(1, min(chunk, steps))
    state = two_body_orbit(separation=2.0, softening=eps, device=device)

    def force_fn(pos, mass):
        return direct_forces_kernel(pos, mass, G, eps)

    state = initialize_forces(state, force_fn)
    e0 = float(total_energy(state, G, eps))
    multi = make_multi_step(force_fn, dt, chunk)
    rows = []
    for c in range(steps // chunk):
        state = multi(state)
        e = float(total_energy(state, G, eps))
        rows.append(((c + 1) * chunk, e, (e - e0) / e0))
    return e0, rows


def main(argv=None):
    args = parse(argv, __doc__, [
        ("steps", int, 100_000, "steps at dt 1e-4"),
        ("sweep_steps", int, 10_000, "steps of each dt of the sweep")],
        out_name="energy_conservation.csv")
    print(f"two-body orbit, dt=1e-4, {args.steps} steps")
    e0, rows = drift_run(1e-4, args.steps, args.device)
    with open(args.out, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["step", "total_energy", "relative_drift"])
        writer.writerows(rows)
    print(f"E0 = {e0:.6f}; final drift = {rows[-1][2]:.3e}; CSV: {args.out}")

    print(f"\ndt sweep ({args.sweep_steps} steps each):")
    for dt in (1e-3, 5e-4, 1e-4):
        _, r = drift_run(dt, args.sweep_steps, args.device)
        print(f"  dt={dt:g}: |drift| = {abs(r[-1][2]):.3e}")


if __name__ == "__main__":
    main()
