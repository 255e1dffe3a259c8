"""Direct O(N²) all-pairs gravity.

PyTorch counterpart of ``nbody_tpu/ops/direct.py``:

  * ``direct_forces_reference`` — small-N broadcast version, the test
    golden reference, optionally in float64;
  * ``direct_forces`` — the plain blocked version (i-blocks against the
    full j axis), the plain twin of the kernel;
  * ``direct_forces_kernel`` — the wrapper of the hand-written CUDA kernel
    ``csrc/direct.cu`` (kernel K1, replacing ``direct_forces_pallas``).

Physics: a_i = G · Σ_j m_j · (x_j − x_i) / (|x_j − x_i|² + ε²)^{3/2}, with
self/coincident pairs contributing exactly zero.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.ops import _build


def _pairwise_acc_block(pos_i, pos_j, mass_j, softening):
    """Acceleration of pos_i (B, 3) due to pos_j (M, 3) / mass_j (M,),
    un-scaled by G. Coincident pairs contribute zero."""
    dx = pos_j[None, :, :] - pos_i[:, None, :]          # (B, M, 3)
    r2_raw = torch.sum(dx * dx, dim=-1)                  # (B, M)
    inv_r = torch.rsqrt(r2_raw + softening * softening)
    w = mass_j[None, :] * (inv_r * inv_r * inv_r)
    w = torch.where(r2_raw == 0.0, torch.zeros_like(w), w)
    return torch.einsum("bm,bmd->bd", w, dx)


def direct_forces_reference(pos, mass, G=1.0, softening=0.1, dtype=None):
    """Small-N exact broadcast implementation (test golden reference);
    ``dtype=torch.float64`` evaluates every pair in double precision."""
    if dtype is not None:
        pos = pos.to(dtype)
        mass = mass.to(dtype)
    acc = _pairwise_acc_block(pos, pos, mass, softening)
    return (G * acc).to(torch.float32)


def direct_forces(pos, mass, G=1.0, softening=0.1, *, block_size: int = 256,
                  targets=None):
    """Plain blocked all-pairs forces on any device. ``targets`` (T, 3)
    evaluates those points against all ``pos`` sources instead of every
    row (a coincident target/source pair contributes zero)."""
    direct_forces.calls += 1
    tgt = pos if targets is None else targets
    out = [
        _pairwise_acc_block(tgt[i:i + block_size], pos, mass, softening)
        for i in range(0, tgt.shape[0], block_size)
    ]
    if not out:
        return torch.zeros_like(tgt)
    return G * torch.cat(out, dim=0)


direct_forces.calls = 0


def direct_forces_kernel(pos, mass, G=1.0, softening=0.1, *, targets=None):
    """Kernel K1 (``csrc/direct.cu``): all-pairs forces, one thread per
    target with shared-memory source tiles. CPU tensors take the plain
    ``direct_forces``; CUDA tensors launch the kernel or raise."""
    if pos.device.type == "cpu":
        return direct_forces(pos, mass, G, softening, targets=targets)
    _build.require_cuda(pos, "direct_forces_kernel")
    dev = pos.device
    n = pos.shape[0]
    tgt = pos if targets is None else targets
    nt = tgt.shape[0]
    _build.check(pos, "pos", (n, 3), dev)
    _build.check(mass, "mass", (n,), dev)
    _build.check(tgt, "targets", (nt, 3), dev)
    acc = torch.empty((nt, 3), dtype=torch.float32, device=dev)
    _build.launch(
        "nbt_direct_forces", dev, tgt.data_ptr(), nt, pos.data_ptr(),
        mass.data_ptr(), n, float(G), float(softening) ** 2, acc.data_ptr(),
    )
    direct_forces_kernel.launches += 1
    return acc


direct_forces_kernel.launches = 0
