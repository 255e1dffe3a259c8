"""Custom initial conditions: spiral galaxy scene (reference:
examples/example_custom_distribution.cpp:21-50).

Counterpart of examples/example_custom_distribution.py on the
PyTorch/CUDA port: 20000 particles, 10 frames of 20 Barnes-Hut steps
(``NBODY_EXAMPLE_FAST=1``: 2000 and 2, as the original).

Usage: python examples_torch/example_custom_distribution.py [N] [frames]
       [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from examples_torch._common import generator, parse  # noqa: E402
from nbody_tpu_torch.models import spiral_galaxy  # noqa: E402
from nbody_tpu_torch.ops.forces import make_force_fn  # noqa: E402
from nbody_tpu_torch.ops.integrator import (  # noqa: E402
    initialize_forces,
    make_verlet_step,
)
from nbody_tpu_torch.types import ForceMethod, SimulationConfig  # noqa: E402


# the Barnes-Hut finest level (d = 2^LEVELS cells an axis)
LEVELS = 5


def main(argv=None):
    fast = os.environ.get("NBODY_EXAMPLE_FAST") == "1"  # CI smoke
    args = parse(argv, __doc__, [
        ("particles", int, 2_000 if fast else 20_000, "particle count"),
        ("frames", int, 2 if fast else 10, "frames of 20 steps")])
    n = args.particles
    state = spiral_galaxy(generator(args.device, 1), n, radius=10.0, arms=3,
                          bulge_fraction=0.25, device=args.device)
    config = SimulationConfig(
        particle_count=n,
        force_method=ForceMethod.BARNES_HUT,
        bh_max_level=LEVELS,
        dt=5e-4,
    )
    force_fn = make_force_fn(config)
    state = initialize_forces(state, force_fn)
    step = make_verlet_step(force_fn, config.dt)

    for _ in range(args.frames):
        for _ in range(20):
            state = step(state)
        pos = state.pos.double()
        r = torch.linalg.norm(pos[:, :2], dim=-1)
        print(f"t={float(state.time):.3f}  r_median={float(r.median()):.2f}  "
              f"z_rms={float(pos[:, 2].std(correction=0)):.3f}")

    print("galaxy evolved; use --render in the CLI to produce frames")


if __name__ == "__main__":
    main()
