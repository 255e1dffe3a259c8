"""The far field's downward pass: each level's accepted local expansions,
translated down to the finest cells.

Counterpart of the level loop of ``nbody_tpu/ops/barnes_hut.py``
``far_field_grid``, which XLA runs as elementwise ops: per level ℓ the
target children's expansions (kernel K3's output, or the monopole far
field's) plus the parent's translated by δ = ±½ the child's edge,

    A_child = A_ℓ + A + J·δ + ½(H·δ)·δ,  J_child = J_ℓ + J + H·δ,
    H_child = H_ℓ + H.

``down_pass`` is that recurrence in torch, to cell-major grids, for either
order; ``far_field_grid`` calls it for every engine. ``far_down`` is the
wrapper of ``csrc/far_down.cu``: the order-2 pass from K3's per-level
outputs straight to the sweep's far plane (d, 19, d²) in one launch, bit
for bit the plane of ``far_down_plain``, its plain twin (``down_pass``,
then ``cat`` / ``permute`` / ``contiguous``).
"""

from __future__ import annotations

import numpy as np
import torch

from nbody_tpu_torch.ops import _build

# Levels the kernel takes (its array of level pointers; d ≤ 1024).
MAX_LEVELS = 10


def sym_matvec(j6: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(…, 6) symmetric matrix [xx,yy,zz,xy,xz,yz] times (…, 3) vector."""
    jx = j6[..., 0] * v[..., 0] + j6[..., 3] * v[..., 1] + j6[..., 4] * v[..., 2]
    jy = j6[..., 3] * v[..., 0] + j6[..., 1] * v[..., 1] + j6[..., 5] * v[..., 2]
    jz = j6[..., 4] * v[..., 0] + j6[..., 5] * v[..., 1] + j6[..., 2] * v[..., 2]
    return torch.stack([jx, jy, jz], dim=-1)


def sym3_matvec(h10: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(…, 10) symmetric 3-tensor [xxx,yyy,zzz,xxy,xxz,xyy,yyz,xzz,yzz,xyz]
    contracted with (…, 3) → the (…, 6) symmetric matrix (H·v)_ij."""
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    xxx, yyy, zzz = h10[..., 0], h10[..., 1], h10[..., 2]
    xxy, xxz, xyy = h10[..., 3], h10[..., 4], h10[..., 5]
    yyz, xzz, yzz = h10[..., 6], h10[..., 7], h10[..., 8]
    xyz = h10[..., 9]
    return torch.stack(
        [
            xxx * vx + xxy * vy + xxz * vz,  # xx
            xyy * vx + yyy * vy + yyz * vz,  # yy
            xzz * vx + yzz * vy + zzz * vz,  # zz
            xxy * vx + xyy * vy + xyz * vz,  # xy
            xxz * vx + xyz * vy + xzz * vz,  # xz
            xyz * vx + yyz * vy + yzz * vz,  # yz
        ],
        dim=-1,
    )


def split_level(out: torch.Tensor):
    """K3's output of one level (152, p³) → views (A (8, 3, p³),
    J (8, 6, p³), H (8, 10, p³)) per target child."""
    o = out.reshape(8, 19, -1)
    return o[:, 0:3], o[:, 3:9], o[:, 9:19]


def down_pass(per_level, cell):
    """Per level ℓ = 1..L, the target children's (A (8, 3, p³),
    J (8, 6, p³), H (8, 10, p³) or None), p = 2^(ℓ−1), kid = 4kx + 2ky + kz
    → the finest cell-major (A (d,d,d,3), J6 (d,d,d,6), H10 (d,d,d,10) or
    None), d = 2^L. ``cell``: the finest edge (0-d tensor). Without H
    (order 1): A_child = A_ℓ + A + J·δ, J_child = J_ℓ + J."""
    levels = len(per_level)
    acc = jac = hes = hes_lvl = None
    for lvl, (acc_pm, jac_pm, hes_pm) in enumerate(per_level, 1):
        quad = hes_pm is not None
        dtype, dev = acc_pm.dtype, acc_pm.device
        dl = 1 << lvl
        p = dl // 2
        s_l = cell * (1 << (levels - lvl))

        def to_grid(a, c, p=p, dl=dl):
            return (
                a.reshape(2, 2, 2, c, p, p, p)
                .permute(4, 0, 5, 1, 6, 2, 3)
                .reshape(dl, dl, dl, c)
            )

        acc_lvl = to_grid(acc_pm, 3)
        jac_lvl = to_grid(jac_pm, 6)
        if quad:
            hes_lvl = to_grid(hes_pm, 10)
        if acc is not None:

            def rep8(x):
                return (
                    x.repeat_interleave(2, 0).repeat_interleave(2, 1)
                    .repeat_interleave(2, 2)
                )

            a_rep, j_rep = rep8(acc), rep8(jac)
            par = (torch.arange(dl, device=dev) % 2).to(dtype) - 0.5
            px, py, pz = torch.meshgrid(par, par, par, indexing="ij")
            delta = torch.stack([px, py, pz], dim=-1) * s_l
            acc_lvl = acc_lvl + a_rep + sym_matvec(j_rep, delta)
            jac_lvl = jac_lvl + j_rep
            if quad:
                h_rep = rep8(hes)
                hd6 = sym3_matvec(h_rep, delta)
                acc_lvl = acc_lvl + 0.5 * sym_matvec(hd6, delta)
                jac_lvl = jac_lvl + hd6
                hes_lvl = hes_lvl + h_rep
        acc, jac, hes = acc_lvl, jac_lvl, hes_lvl
    return acc, jac, hes


def far_down_plain(outs, cell) -> torch.Tensor:
    """Plain twin of ``far_down`` → the far plane (d, 19, d²)."""
    far_down_plain.calls += 1
    acc, jac, hes = down_pass([split_level(o) for o in outs], cell)
    d = acc.shape[0]
    return (
        torch.cat([acc, jac, hes], dim=-1)
        .reshape(d, d * d, 19).permute(0, 2, 1).contiguous()
    )


far_down_plain.calls = 0


@_build.counted
def far_down(outs, cell) -> torch.Tensor:
    """The order-2 downward pass (``csrc/far_down.cu``): K3's outputs of
    levels 1..L, ``outs[ℓ − 1]`` (152, p³), and the finest edge ``cell``
    (one element) → the far plane (d, 19, d²), plane[x, c, y·d + z] the
    unscaled [A3 | J6 | H10] of finest cell (x, y, z); one thread a
    finest cell walking its ancestors, one launch.
    CPU tensors take the plain twin; CUDA tensors launch the kernel or
    raise."""
    outs = list(outs)
    if not outs:
        raise ValueError("far_down: no levels")
    if all(t.device.type == "cpu" for t in (*outs, cell)):
        return far_down_plain(outs, cell)
    _build.require_cuda(outs[0], "far_down")
    levels = len(outs)
    if levels > MAX_LEVELS:
        raise ValueError(f"far_down: {levels} levels, the kernel takes at "
                         f"most {MAX_LEVELS}")
    dev = outs[0].device
    for lvl, o in enumerate(outs, 1):
        p = 1 << (lvl - 1)
        _build.check(o, f"outs[{lvl - 1}]", (152, p * p * p), dev)
    if cell.numel() != 1:
        raise ValueError(f"cell: shape {tuple(cell.shape)}, expected one "
                         f"element")
    _build.check(cell.reshape(()), "cell", (), dev)
    d = 1 << levels
    plane = torch.empty((d, 19, d * d), dtype=torch.float32, device=dev)
    ptrs = np.array([o.data_ptr() for o in outs], dtype=np.uint64)
    _build.launch("nbt_far_down", dev, ptrs.ctypes.data, levels,
                  cell.data_ptr(), plane.data_ptr())
    far_down.launches += 1
    return plane
