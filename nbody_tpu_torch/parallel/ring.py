"""Ring-rotated all-pairs forces over the device mesh.

PyTorch counterpart of ``nbody_tpu/parallel/ring.py``. Each position owns
an i-block and the j-blocks (positions + masses) rotate around the ring by
``ppermute``: after P hops every (i, j) pair has been evaluated once. Each
process loops over its own positions; on a mesh across processes
``ppermute`` passes the blocks between them. A hop is kernel K1's
``targets=`` form (``ops/direct.direct_forces_kernel``, ``csrc/direct.cu``),
the local block as the targets and the rotated block as the sources, where
the JAX package runs its XLA block ``_pairwise_acc_block``: P launches of
(N/P) × (N/P) on each position a force call. Self and coincident pairs
give 0; zero-mass padding exerts nothing.

As a program (``parallel/program.py``): P stages, one a hop, with the
rotation's ``ppermute`` between two of them (P − 1 collectives).
"""

from __future__ import annotations

from nbody_tpu_torch.ops.direct import direct_forces_kernel
from nbody_tpu_torch.parallel.mesh import Mesh, ppermute
from nbody_tpu_torch.parallel.program import Collective, Stage, run_forces


def ring_ops(mesh: Mesh, G: float = 1.0, softening: float = 0.1) -> tuple:
    """The ring as a force program: carries ``pos`` and ``mass`` in,
    ``force`` out (the accelerations)."""
    p = mesh.size

    def hop(h):
        def fn(i, q, c):
            src = ("pos", "mass") if h == 0 else ("pj", "mj")
            a = direct_forces_kernel(c[src[0]], c[src[1]], 1.0, softening,
                                     targets=c["pos"])
            acc = a if h == 0 else c["acc_ring"] + a
            return {"force": G * acc} if h == p - 1 else {"acc_ring": acc}

        return Stage(f"hop {h}", fn)

    def rotate(h):
        def fn(cs, mesh):
            src = ("pos", "mass") if h == 0 else ("pj", "mj")
            pj = ppermute([c[src[0]] for c in cs], mesh, 1)
            mj = ppermute([c[src[1]] for c in cs], mesh, 1)
            return [{"pj": a, "mj": b} for a, b in zip(pj, mj)]

        return Collective(f"ppermute {h + 1}", fn)

    ops = []
    for h in range(p):
        ops.append(hop(h))
        if h + 1 < p:
            ops.append(rotate(h))
    return tuple(ops)


def ring_direct_forces(pos, mass, mesh: Mesh, G: float = 1.0,
                       softening: float = 0.1) -> list:
    """All-pairs gravity of the sharded rows: ``pos`` and ``mass`` hold one
    block per position of this process; returns the accelerations, one
    block per position."""
    return run_forces(ring_ops(mesh, G, softening), pos, mass, mesh)[0]
