"""Galaxy collision: two disks on an approach trajectory, rendered frames
(BASELINE.json config #5, scaled to one card).

Counterpart of examples/example_galaxy_collision.py on the PyTorch/CUDA
port: Barnes-Hut steps in chunks of 10, each frame drawn by kernel R1 and
written as a PNG.

Usage: python examples_torch/example_galaxy_collision.py [N] [frames]
       [--device cpu] [--out DIR]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples_torch._common import generator, parse  # noqa: E402
from nbody_tpu_torch.models import galaxy_collision  # noqa: E402
from nbody_tpu_torch.ops.forces import make_force_fn  # noqa: E402
from nbody_tpu_torch.ops.integrator import (  # noqa: E402
    initialize_forces,
    make_multi_step,
)
from nbody_tpu_torch.render import Camera, PointRenderer  # noqa: E402
from nbody_tpu_torch.types import (  # noqa: E402
    ForceMethod,
    RenderConfig,
    SimulationConfig,
)


# the Barnes-Hut finest level (d = 2^LEVELS cells an axis)
LEVELS = 5


def main(argv=None):
    fast = os.environ.get("NBODY_EXAMPLE_FAST") == "1"  # CI smoke
    args = parse(argv, __doc__, [
        ("particles", int, 2_000 if fast else 50_000, "particle count"),
        ("frames", int, 2 if fast else 30, "frames of 10 steps")],
        out_name="galaxy_collision")
    n, frames = args.particles, args.frames
    os.makedirs(args.out, exist_ok=True)

    state = galaxy_collision(generator(args.device, 7), n, separation=30.0,
                             approach_speed=0.8, device=args.device)
    config = SimulationConfig(
        particle_count=n,
        force_method=ForceMethod.BARNES_HUT,
        bh_max_level=LEVELS,
        dt=5e-3,
        softening=0.2,
    )
    force_fn = make_force_fn(config)
    state = initialize_forces(state, force_fn)
    chunk = make_multi_step(force_fn, config.dt, 10)

    camera = Camera(distance=70.0, azimuth=0.6, elevation=0.6)
    renderer = PointRenderer(
        RenderConfig(window_width=960, window_height=540), camera=camera)

    for f in range(frames):
        state = chunk(state)
        img = renderer.frame(state.pos, state.vel)
        renderer.save_png(img, f"{args.out}/frame_{f:04d}.png")
        if (f + 1) % 10 == 0:
            print(f"frame {f + 1}/{frames}, t={float(state.time):.2f}")
    print(f"frames written to {args.out}")


if __name__ == "__main__":
    main()
