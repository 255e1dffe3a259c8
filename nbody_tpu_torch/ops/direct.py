"""Direct O(N²) all-pairs gravity.

PyTorch counterpart of ``nbody_tpu/ops/direct.py``:

  * ``direct_forces_reference`` — small-N broadcast version, the test
    golden reference, optionally in float64;
  * ``direct_forces`` — the plain blocked version (i-blocks against the
    full j axis), the plain twin of the kernel;
  * ``direct_forces_kernel`` — the wrapper of the hand-written CUDA kernel
    ``csrc/direct.cu`` (kernel K1, replacing ``direct_forces_pallas``);
  * ``pairwise_potential`` — the all-pairs potential energy, wrapper of
    ``csrc/pair_potential.cu`` (kernel K5, replacing
    ``pairwise_potential_pallas``), ``pairwise_potential_cross``, its
    cross form (targets against a separate source set: the energy of
    ``parallel/step.py``), ``pairwise_potential_plain``, the plain twin
    of both, and ``pair_tile_schedule``, a plain mirror of K5's walk over
    tile pairs.

Physics: a_i = G · Σ_j m_j · (x_j − x_i) / (|x_j − x_i|² + ε²)^{3/2}, with
self/coincident pairs contributing exactly zero.
"""

from __future__ import annotations

import functools
import math

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


@functools.lru_cache(maxsize=64)
def _source_range(index: int, nt: int, n: int) -> int:
    """Rows of each source range K1 takes for ``nt`` targets against ``n``
    sources on card ``index`` (its plan, from the SM count)."""
    rows = _build.library().nbt_direct_forces_range(index, nt, n)
    if rows < 0:
        raise RuntimeError("nbt_direct_forces_range: CUDA error")
    return rows


@_build.counted
def direct_forces_kernel(pos, mass, G=1.0, softening=0.1, *, targets=None):
    """Kernel K1 (``csrc/direct.cu``): all-pairs forces, four targets a
    thread against shared-memory source tiles, the source axis split over
    blocks (partial sums joined in a fixed order) when the targets alone
    would leave SMs idle. CPU tensors take the plain ``direct_forces``;
    CUDA tensors launch the kernel or raise."""
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
    index = torch.cuda.current_device() if dev.index is None else dev.index
    rows = _source_range(index, nt, n)
    ranges = -(-n // rows)
    floats = 3 * ranges * nt if ranges > 1 else 0
    scratch = (torch.empty((floats,), dtype=torch.float32, device=dev)
               if floats else None)
    _build.launch(
        "nbt_direct_forces", dev, tgt.data_ptr(), nt, pos.data_ptr(),
        mass.data_ptr(), n, rows, float(G), float(softening) ** 2,
        acc.data_ptr(), _build.ptr(scratch), floats,
    )
    direct_forces_kernel.launches += 1
    return acc


# Pair terms one row block of the plain potential evaluates at once (2048
# rows at N = 131072: a few hundred launches, ~1 GB per temporary).
PE_BLOCK_TERMS = 1 << 28


def pairwise_potential_plain(pos, mass, G=1.0, softening=0.1, *,
                             sources=None):
    """Plain twin of kernel K5: PE = −½G Σ_{i≠j} m_i·m_j/√(r² + ε²), pairs
    with raw r² == 0 excluded, over row blocks of ``PE_BLOCK_TERMS`` pair
    terms, each block's terms summed in float64. ``sources=(pos_s,
    mass_s)``: the cross form, −½G Σ_i Σ_j m_i·m_j/√(r_ij² + ε²) of the
    rows of ``pos`` against those sources, raw r² == 0 excluded. Returns a
    float32 scalar tensor."""
    pairwise_potential_plain.calls += 1
    spos, smass = (pos, mass) if sources is None else sources
    n, ns = pos.shape[0], spos.shape[0]
    b = max(1, min(n, PE_BLOCK_TERMS // max(ns, 1)))
    eps2 = float(softening) ** 2
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    sx, sy, sz = spos[:, 0], spos[:, 1], spos[:, 2]
    total = torch.zeros((), dtype=torch.float64, device=pos.device)
    for i in range(0, n, b):
        dx = sx[None, :] - x[i:i + b, None]
        dy = sy[None, :] - y[i:i + b, None]
        dz = sz[None, :] - z[i:i + b, None]
        r2 = dx * dx + dy * dy + dz * dz
        e = (mass[i:i + b, None] * smass[None, :]) * torch.rsqrt(r2 + eps2)
        total = total + torch.where(r2 == 0.0, 0.0, e).sum(
            dtype=torch.float64)
    return (-0.5 * G * total).to(torch.float32)


pairwise_potential_plain.calls = 0


# Rows of a K5 tile, on both axes (``kTile`` of ``csrc/pair_potential.cu``),
# for the mirror of its walk below.
PE_TILE = 256


def _row_start(i: int, nt: int) -> int:
    """Tile pairs of the upper triangle of ``nt`` tiles before tile row
    ``i`` (the kernel's ``row_start``)."""
    return i * nt - i * (i - 1) // 2


def _tile_row(k: int, nt: int) -> int:
    """The tile row of flat index ``k`` of the main form's row-major walk
    of the upper triangle of ``nt`` tiles: the root of
    ``_row_start(I) = k`` in double, corrected by whole rows (the kernel's
    ``tile_row``)."""
    b = 2.0 * nt + 1.0
    i = int(math.floor((b - math.sqrt(b * b - 8.0 * k)) * 0.5))
    i = max(0, min(i, nt - 1))
    while i > 0 and _row_start(i, nt) > k:
        i -= 1
    while i + 1 < nt and _row_start(i + 1, nt) <= k:
        i += 1
    return i


def pair_tile_schedule(n: int, tile: int = PE_TILE, run: int = 1, *,
                       ns: int | None = None) -> list:
    """Kernel K5's walk, block by block: a list with, for each block, the
    ``(I, J, diagonal)`` tile pairs it takes, in order. The main form
    (``ns`` None) walks the upper triangle (I ≤ J) of the tiles of ``n``
    rows row-major, a diagonal pair taking only j > i; the cross form all
    ``n``-row target tiles against ``ns``-row source tiles. Block b takes
    ``run`` consecutive pairs from b·run on. A plain mirror of the index
    arithmetic of ``csrc/pair_potential.cu``, for the CPU tests."""
    nt = -(-n // tile)
    nts = nt if ns is None else -(-ns // tile)
    total = nt * (nt + 1) // 2 if ns is None else nt * nts
    blocks = []
    for k0 in range(0, total, run):
        if ns is None:
            i = _tile_row(k0, nt)
            j = i + (k0 - _row_start(i, nt))
        else:
            i, j = divmod(k0, nts)
        walk = []
        for _ in range(min(run, total - k0)):
            walk.append((i, j, ns is None and i == j))
            j += 1
            if j == nts:
                i += 1
                j = i if ns is None else 0
        blocks.append(walk)
    return blocks


def _pe_launch(name, pos, mass, src, softening) -> torch.Tensor:
    """Launch K5's entry point ``name`` (the cross form when ``src`` holds
    the sources' (pos, mass)); returns the float64 sum of its block
    partials, as many as the kernel's own plan makes."""
    dev = pos.device
    index = torch.cuda.current_device() if dev.index is None else dev.index
    nt = pos.shape[0]
    ns = nt if src is None else src[0].shape[0]
    count = _build.library().nbt_pair_potential_partials(
        index, nt, ns, int(src is not None))
    if count < 0:
        raise RuntimeError("nbt_pair_potential_partials: CUDA error")
    partial = torch.empty((count,), dtype=torch.float64, device=dev)
    args = (pos.data_ptr(), mass.data_ptr(), nt)
    if src is not None:
        args += (src[0].data_ptr(), src[1].data_ptr(), ns)
    _build.launch(name, dev, *args, float(softening) ** 2, partial.data_ptr(),
                  count)
    return partial.sum()


@_build.counted
def pairwise_potential(pos, mass, G=1.0, softening=0.1):
    """Kernel K5 (``csrc/pair_potential.cu``): the all-pairs potential,
    each unordered pair once over the upper triangle of 256-row tile pairs
    (``pair_tile_schedule``), cut into equal runs that fill the card, four
    targets a thread; float64 partials, one a block, summed here and scaled
    by −G. Returns a float32 scalar tensor. CPU tensors take the plain
    twin; CUDA tensors launch the kernel or raise."""
    if pos.device.type == "cpu":
        return pairwise_potential_plain(pos, mass, G, softening)
    _build.require_cuda(pos, "pairwise_potential")
    dev = pos.device
    n = pos.shape[0]
    _build.check(pos, "pos", (n, 3), dev)
    _build.check(mass, "mass", (n,), dev)
    if n == 0:
        return torch.zeros((), dtype=torch.float32, device=dev)
    total = _pe_launch("nbt_pair_potential", pos, mass, None, softening)
    pairwise_potential.launches += 1
    return (-G * total).to(torch.float32)


@_build.counted
def pairwise_potential_cross(pos, mass, src_pos, src_mass, G=1.0,
                             softening=0.1):
    """Kernel K5's cross form (``csrc/pair_potential.cu``,
    ``nbt_pair_potential_cross``): −½G Σ_i Σ_j m_i·m_j/√(r_ij² + ε²) of the
    targets ``pos``/``mass`` against the sources ``src_pos``/``src_mass``,
    pairs at one point (raw r² == 0) excluded: every target tile against
    every source tile, in the main form's equal runs, float64 partials.
    Returns a float32 scalar tensor. CPU tensors take the plain twin; CUDA
    tensors launch the kernel or raise."""
    if pos.device.type == "cpu":
        return pairwise_potential_plain(pos, mass, G, softening,
                                        sources=(src_pos, src_mass))
    _build.require_cuda(pos, "pairwise_potential_cross")
    dev = pos.device
    n, ns = pos.shape[0], src_pos.shape[0]
    _build.check(pos, "pos", (n, 3), dev)
    _build.check(mass, "mass", (n,), dev)
    _build.check(src_pos, "src_pos", (ns, 3), dev)
    _build.check(src_mass, "src_mass", (ns,), dev)
    if n == 0 or ns == 0:
        return torch.zeros((), dtype=torch.float32, device=dev)
    total = _pe_launch("nbt_pair_potential_cross", pos, mass,
                       (src_pos, src_mass), softening)
    pairwise_potential_cross.launches += 1
    return (-0.5 * G * total).to(torch.float32)
