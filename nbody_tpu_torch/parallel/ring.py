"""Ring-rotated all-pairs forces over the device mesh.

PyTorch counterpart of ``nbody_tpu/parallel/ring.py``. Each position owns
an i-block and the j-blocks (positions + masses) rotate around the ring by
``ppermute``: after P hops every (i, j) pair has been evaluated once. Each
process loops over its own positions; on a mesh across processes
``ppermute`` passes the blocks between them. A hop is kernel K1's
``targets=`` form (``ops/direct.direct_forces_kernel``, ``csrc/direct.cu``),
the local block as the targets and the rotated block as the sources, where
the JAX package runs its XLA block ``_pairwise_acc_block``: P launches of
(N/P) × (N/P) on each position a force call. Self and coincident pairs give 0; zero-mass padding exerts
nothing.
"""

from __future__ import annotations

from nbody_tpu_torch.ops.direct import direct_forces_kernel
from nbody_tpu_torch.parallel.mesh import Mesh, ppermute


def ring_direct_forces(pos, mass, mesh: Mesh, G: float = 1.0,
                       softening: float = 0.1) -> list:
    """All-pairs gravity of the sharded rows: ``pos`` and ``mass`` hold one
    block per position of this process; returns the accelerations, one
    block per position."""
    acc = [None] * len(pos)
    pj, mj = list(pos), list(mass)
    for hop in range(mesh.size):
        for i in range(len(pos)):
            a = direct_forces_kernel(pj[i], mj[i], 1.0, softening,
                                     targets=pos[i])
            acc[i] = a if acc[i] is None else acc[i] + a
        if hop + 1 < mesh.size:
            pj, mj = ppermute(pj, mesh, 1), ppermute(mj, mesh, 1)
    return [G * a for a in acc]
