"""Three-way force method comparison: accuracy against the exact reference
and timing (reference: examples/example_force_methods.cpp:34-66).

Counterpart of examples/example_force_methods.py on the PyTorch/CUDA port:
direct N² (kernel K1), Barnes-Hut θ = 0.5 (K2, K3, K4) and the spatial
hash (K7), each timed on one evaluation after a warm one, against the
float64 direct sum.

Usage: python examples_torch/example_force_methods.py [N] [--device cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from examples_torch._common import generator, parse, sync  # noqa: E402
from nbody_tpu_torch.models import init_spherical  # noqa: E402
from nbody_tpu_torch.ops.barnes_hut import barnes_hut_forces  # noqa: E402
from nbody_tpu_torch.ops.direct import (  # noqa: E402
    direct_forces_kernel,
    direct_forces_reference,
)
from nbody_tpu_torch.ops.spatial_hash import spatial_hash_forces  # noqa: E402
from nbody_tpu_torch.types import SphericalDistParams  # noqa: E402


# the Barnes-Hut finest level (d = 2^LEVELS cells an axis)
LEVELS = 5


def main(argv=None):
    args = parse(argv, __doc__, [("particles", int, 5000, "particle count")])
    dev = args.device
    s = init_spherical(generator(dev, 42), args.particles,
                       SphericalDistParams(radius=10.0), device=dev)
    G, eps = 1.0, 0.1

    golden = direct_forces_reference(s.pos, s.mass, G, eps,
                                     dtype=torch.float64)
    gm = torch.linalg.norm(golden, dim=-1)

    methods = {
        "direct-n2": lambda: direct_forces_kernel(s.pos, s.mass, G, eps),
        "barnes-hut θ=0.5": lambda: barnes_hut_forces(
            s.pos, s.mass, G, eps, 0.5, levels=LEVELS),
        "spatial-hash": lambda: spatial_hash_forces(
            s.pos, s.mass, G, eps, cutoff=2.0, cell_size=1.0),
    }

    print(f"{'method':20s} {'ms/eval':>10s} {'median rel err':>15s}")
    for name, fn in methods.items():
        fn()
        sync(dev)
        t0 = time.perf_counter()
        acc = fn()
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        err = torch.linalg.norm(acc.double() - golden, dim=-1) / (gm + 1e-12)
        note = "(cutoff truncates far field)" if "hash" in name else ""
        print(f"{name:20s} {ms:10.2f} {float(err.median()):15.4%} {note}")


if __name__ == "__main__":
    main()
