"""Morton (Z-order) codes — vectorized bit interleaving.

PyTorch counterpart of ``nbody_tpu/ops/morton.py`` (itself the counterpart
of the reference's Morton kernels, force_barnes_hut.cu:23-38, 113-127):
30-bit codes, 10 bits per axis, built by parallel bit expansion. The JAX
package works in ``uint32``; torch's ``uint32`` has few operations, so the
bit tricks run in ``int64`` and the codes come back as ``int32`` (30 bits
fit), equal to the JAX codes bit for bit.

No engine here needs Morton order (the grid pyramid's sweeps are dense);
the codes are kept for interop and debugging parity with the reference.
"""

from __future__ import annotations

import torch

MORTON_BITS = 10  # per axis → 30-bit codes (reference: 10 bits/axis)


def expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so each lands at 3× its position
    (reference: expandBits, force_barnes_hut.cu:23-30) → int32."""
    v = v.to(torch.int64) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v.to(torch.int32)


def compact_bits(v: torch.Tensor) -> torch.Tensor:
    """Inverse of ``expand_bits``: gather every 3rd bit back together."""
    v = v.to(torch.int64) & 0x09249249
    v = (v | (v >> 2)) & 0x030C30C3
    v = (v | (v >> 4)) & 0x0300F00F
    v = (v | (v >> 8)) & 0x030000FF
    v = (v | (v >> 16)) & 0x000003FF
    return v.to(torch.int32)


def morton_encode(coords: torch.Tensor) -> torch.Tensor:
    """(N, 3) int cell coords (each < 2^10) → (N,) int32 Morton codes
    (reference: computeMortonCode, force_barnes_hut.cu:33-38)."""
    x = expand_bits(coords[..., 0]).to(torch.int64)
    y = expand_bits(coords[..., 1]).to(torch.int64)
    z = expand_bits(coords[..., 2]).to(torch.int64)
    return ((x << 2) | (y << 1) | z).to(torch.int32)


def morton_decode(codes: torch.Tensor) -> torch.Tensor:
    """(N,) Morton codes → (N, 3) int32 cell coords."""
    c = codes.to(torch.int64) & 0x3FFFFFFF
    return torch.stack(
        [compact_bits(c >> 2), compact_bits(c >> 1), compact_bits(c)],
        dim=-1)


def morton_codes_for_positions(pos: torch.Tensor, lo, extent) -> torch.Tensor:
    """Positions → Morton codes over a normalized 1024³ grid
    (reference: computeMortonCodesKernel, force_barnes_hut.cu:113-127)."""
    extent = torch.as_tensor(extent, dtype=pos.dtype, device=pos.device)
    scale = (1 << MORTON_BITS) / torch.clamp(extent, min=1e-30)
    coords = torch.clamp(((pos - lo) * scale).to(torch.int32), 0,
                         (1 << MORTON_BITS) - 1)
    return morton_encode(coords)
