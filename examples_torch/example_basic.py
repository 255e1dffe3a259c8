"""Basic usage: config → init → 1000 steps → save/load round trip.

Counterpart of examples/example_basic.py (reference:
examples/example_basic.cpp) on the PyTorch/CUDA port.

Usage: python examples_torch/example_basic.py [N] [steps] [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples_torch._common import parse  # noqa: E402
from nbody_tpu_torch import (  # noqa: E402
    ForceMethod,
    InitDistribution,
    ParticleSystem,
    SimulationConfig,
)


def main(argv=None):
    args = parse(argv, __doc__, [
        ("particles", int, 5000, "particle count"),
        ("steps", int, 1000, "steps")], out_name="example_basic.nbody")
    config = SimulationConfig(
        particle_count=args.particles,
        init_distribution=InitDistribution.SPHERICAL,
        force_method=ForceMethod.DIRECT_N2,
        dt=1e-3,
    )
    system = ParticleSystem()
    system.initialize(config, device=args.device)
    print(f"Initialized {system.particle_count} particles on {args.device}")
    e0 = system.compute_total_energy()

    every = max(1, args.steps // 5)
    for step in range(args.steps):
        system.update()
        if (step + 1) % every == 0:
            print(f"step {step + 1}: t={system.simulation_time:.3f}")

    e1 = system.compute_total_energy()
    print(f"energy drift over {args.steps} steps: {(e1 - e0) / e0:.2e}")

    system.save_state(args.out)
    restored = ParticleSystem()
    restored.load_state(args.out, device=args.device)
    assert restored.get_state() == system.get_state()
    print(f"checkpoint round trip OK ({args.out})")


if __name__ == "__main__":
    main()
