"""Multipole-to-local tap sum of one pyramid level (kernel K3).

Counterpart of ``nbody_tpu/ops/pallas_far_taps.py``:

    out(152, p³) = Σ_t tap_mat[t] (152×80) · mom shifted by offset t

over the (2ws+1)³ parent offsets t in (x, y, z) order, with zero outside
the p³ grid. ``mom`` is (80, p³): 8 source children × [m, srel3, quad6];
``out`` is 8 target children × [A3, J6, H10].

``far_taps`` is the wrapper of ``csrc/far_taps.cu``: an implicit GEMM on
the tensor cores in 3xTF32 (each operand split into two TF32 parts, three
products accumulated in FP32), whose products are FP32-accurate up to a
dropped lo·lo term of ~2⁻²² of each; it is held to the FP32 twin at
2e-5·max|out|, as the FP32 kernel before it was. ``far_taps_plain`` is its
plain twin, the per-tap matrix products that XLA ran in the JAX package
(``torch.matmul``; TF32 must stay off on the card,
``torch.backends.cuda.matmul.allow_tf32 = False``, for it to be FP32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nbody_tpu_torch.ops import _build


def _offsets(ws: int):
    r = range(-ws, ws + 1)
    return [(x, y, z) for x in r for y in r for z in r]


def far_taps_plain(mom, tap_mat, *, p: int, ws: int):
    """Plain twin of kernel K3 → (152, p³)."""
    far_taps_plain.calls += 1
    pc = p * p * p
    mom_pad = F.pad(mom.reshape(80, p, p, p), [ws] * 6)
    acc = torch.zeros((tap_mat.shape[1], pc), dtype=mom.dtype,
                      device=mom.device)
    for t, (ox, oy, oz) in enumerate(_offsets(ws)):
        src = mom_pad[:, ox + ws:ox + ws + p, oy + ws:oy + ws + p,
                      oz + ws:oz + ws + p].reshape(80, pc)
        acc = acc + tap_mat[t] @ src
    return acc


far_taps_plain.calls = 0


@_build.counted
def far_taps(mom, tap_mat, *, p: int, ws: int):
    """Kernel K3 (``csrc/far_taps.cu``): bricks of parent cells against
    a range of the 152 outputs per block, (tap, 40-channel) stages of
    moments and tap rows in a ring in shared memory, 3xTF32 ``mma.sync``
    products.
    CPU tensors take the plain twin; CUDA tensors launch the kernel or
    raise."""
    if mom.device.type == "cpu":
        return far_taps_plain(mom, tap_mat, p=p, ws=ws)
    _build.require_cuda(mom, "far_taps")
    dev = mom.device
    pc = p * p * p
    t = (2 * ws + 1) ** 3
    _build.check(mom, "mom", (80, pc), dev)
    _build.check(tap_mat, "tap_mat", (t, 152, 80), dev)
    if tap_mat.data_ptr() % 16:
        raise ValueError("tap_mat: the kernel copies its rows 16 bytes at a "
                         "time and needs a 16-byte aligned tensor")
    out = torch.empty((152, pc), dtype=torch.float32, device=dev)
    _build.launch(
        "nbt_far_taps", dev, mom.data_ptr(), tap_mat.data_ptr(),
        out.data_ptr(), p, ws,
    )
    far_taps.launches += 1
    return out
