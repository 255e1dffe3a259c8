"""Force kernels, their plain PyTorch twins, and the integrator.

Every hand-written CUDA kernel (``csrc/*.cu``) has a wrapper here with a
``launches`` counter and a plain twin in the same module; the wrapper runs
the twin only for CPU tensors.
"""

from nbody_tpu_torch.ops.forces import make_force_fn
from nbody_tpu_torch.ops.integrator import (
    kinetic_energy,
    make_verlet_step,
    potential_energy,
    total_energy,
    verlet_step,
)

__all__ = [
    "make_force_fn",
    "make_verlet_step",
    "verlet_step",
    "kinetic_energy",
    "potential_energy",
    "total_energy",
]
