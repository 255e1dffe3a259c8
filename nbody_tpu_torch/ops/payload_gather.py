"""The sort's row permutation: the cell-sorted rows of
``sorted_window.build_sorted_grid``.

``payload_gather`` is the wrapper of ``csrc/payload_gather.cu``: for each
sorted row i, with j = order[i], it writes [pos[j] | mass[j]] as one
16-byte row, ids[j], optionally the cell coordinates of ids[j] at stride
``d`` and a caller's extra columns extra[j], in one launch.
``payload_gather_plain`` is its plain twin, the torch composition of the
JAX package's ``build_sorted_grid`` (cat, row gathers, ``//``, ``%`` and
``stack``). Both copy rows and do integer arithmetic on them, so they
agree bit for bit.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.ops import _build


def payload_gather_plain(pos, mass, ids, order, d, extra=None,
                         with_csort=False):
    """Plain twin of ``payload_gather``: ONE (N, 4 + E) row gather of
    [pos | mass | extra], split after it, and the ids' gather."""
    payload_gather_plain.calls += 1
    parts = [pos, mass[:, None]]
    if extra is not None:
        parts.append(extra)
    payload = torch.cat(parts, dim=-1)[order]
    ids_sorted = ids[order]
    csort = None
    if with_csort:
        cyx = ids_sorted // d
        csort = torch.stack([cyx // d, cyx % d, ids_sorted % d], dim=-1)
    if extra is None:
        return payload, ids_sorted, csort, None
    return payload[:, :4].contiguous(), ids_sorted, csort, payload[:, 4:]


payload_gather_plain.calls = 0


@_build.counted
def payload_gather(pos, mass, ids, order, d: int, extra=None,
                   with_csort: bool = False):
    """The rows of a stable sort by cell id (``csrc/payload_gather.cu``):
    ``pos`` (N, 3) and ``mass`` (N,) float32, ``ids`` (N,) int32 cell ids
    at stride ``d``, ``order`` (N,) int64 the sort permutation, ``extra``
    (N, E) float32 or None → ``(psort (N, 4), ids_sorted (N,), csort
    (N, 3) int32 or None, extra_sorted (N, E) or None)`` in sorted order;
    ``csort`` only ``with_csort``. ``pos``, ``mass`` and ``extra`` may be
    strided views (the innermost stride 1). CPU tensors take the plain
    twin; CUDA tensors launch the kernel or raise."""
    ins = (pos, mass, ids, order) + (() if extra is None else (extra,))
    if all(t.device.type == "cpu" for t in ins):
        return payload_gather_plain(pos, mass, ids, order, d, extra,
                                    with_csort)
    _build.require_cuda(pos, "payload_gather")
    dev = pos.device
    n = order.shape[0]
    pos_stride = _build.check(pos, "pos", (n, 3), dev, strided_rows=True)
    mass_stride = _build.check(mass, "mass", (n,), dev, strided_rows=True)
    _build.check(ids, "ids", (n,), dev, torch.int32)
    _build.check(order, "order", (n,), dev, torch.int64)
    e, extra_stride = 0, 0
    if extra is not None:
        if extra.dim() != 2 or extra.shape[1] < 1:
            raise ValueError(f"extra: shape {tuple(extra.shape)}, expected "
                             f"(N, E) with E ≥ 1")
        e = extra.shape[1]
        extra_stride = _build.check(extra, "extra", (n, e), dev,
                                    strided_rows=True)
    if with_csort and d < 1:
        raise ValueError(f"payload_gather: stride d {d} < 1")
    psort = torch.empty((n, 4), dtype=torch.float32, device=dev)
    ids_sorted = torch.empty((n,), dtype=torch.int32, device=dev)
    csort = (torch.empty((n, 3), dtype=torch.int32, device=dev)
             if with_csort else None)
    extra_sorted = (None if extra is None else
                    torch.empty((n, e), dtype=torch.float32, device=dev))
    if n:
        _build.launch("nbt_payload_gather", dev, order.data_ptr(), n,
                      pos.data_ptr(), pos_stride, mass.data_ptr(),
                      mass_stride, ids.data_ptr(), d, _build.ptr(extra),
                      extra_stride, e, psort.data_ptr(),
                      ids_sorted.data_ptr(), _build.ptr(csort),
                      _build.ptr(extra_sorted))
        payload_gather.launches += 1
    return psort, ids_sorted, csort, extra_sorted
