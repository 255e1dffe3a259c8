"""Sorted-window short-range sweep (kernel K7).

Counterpart of ``nbody_tpu/ops/pallas_window_sweep.py``
(``window_sweep_pallas``) and of the gravity form of the XLA path of
``nbody_tpu/ops/sorted_window.py`` (``window_sweep``). For each
cell-sorted target and each (dx, dy) offset it sums the softened pair
force over the sources of that offset's window whose cell coordinates
match exactly (same x + dx, same y + dy, z within ``z_hw``), with the
optional raw-r² cutoff and r² > 0. Output (N, 3) in sorted order, NOT
scaled by G, plus the overflow audit — the XLA path's definition: rows
covered are ``[win_start, win_start + window)`` and every (block, offset)
adds ``max(needed_end − win_start − window, 0)``.

``window_sweep_kernel`` is the wrapper of ``csrc/window_sweep.cu``;
``window_sweep_plain`` is its plain twin; ``window_starts`` is the
per-(block, offset) window bookkeeping both share (the kernel computes the
same anchoring itself from ``cell_start``). ``window_spans`` mirrors the
kernel's per-target spans: the rows a target's cell needs for each offset,
clipped to its block's window, where the coordinate predicate always holds.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.ops import _build

# Target coordinates of the padded tail: never equal to a real cell
# coordinate shifted by an offset (as the JAX package's sentinel).
_SENTINEL = -(1 << 20)
# Pair elements (targets × span rows) the plain twin evaluates at once.
_MAX_ELEMS = 1 << 22


def window_starts(csort, cell_start, *, d: int, offsets, z_hw: int,
                  window: int, block_size: int):
    """Per-(block, offset) windows of the sweep →
    ``(win_start (nb, n_off), needed_end (nb, n_off), overflow ())``.

    Anchored on the first and the last real target of each block of
    ``block_size`` sorted rows (``sorted_window.py`` ``one_block``): the
    sources a block needs for offset (dx, dy) are the rows
    ``[win_start, needed_end)``; the sweep covers at most ``window`` of
    them and the rest are counted in ``overflow`` (int64)."""
    n = csort.shape[0]
    b = min(block_size, max(n, 1))
    nb = -(-n // b)
    num_cells = d * d * d
    starts = torch.arange(nb, device=csort.device) * b
    first = csort[starts].to(torch.int64)                      # (nb, 3)
    last = csort[torch.clamp(starts + b, max=n) - 1].to(torch.int64)
    off = torch.as_tensor(offsets, dtype=torch.int64,
                          device=csort.device).reshape(-1, 2)
    dx, dy = off[:, 0], off[:, 1]
    base0 = (((first[:, 0:1] + dx) * d + first[:, 1:2] + dy) * d
             + torch.clamp(first[:, 2:3] - z_hw, min=0))
    base1 = (((last[:, 0:1] + dx) * d + last[:, 1:2] + dy) * d
             + torch.clamp(last[:, 2:3] + z_hw, max=d - 1) + 1)
    cs = cell_start.to(torch.int64)
    win_start = cs[torch.clamp(base0, 0, num_cells)]
    needed_end = cs[torch.clamp(base1, 0, num_cells)]
    overflow = torch.clamp(needed_end - win_start - window, min=0).sum()
    return win_start, needed_end, overflow


def window_spans(csort, cell_start, *, d: int, offsets, z_hw: int,
                 window: int, block_size: int):
    """Each sorted target's source span per offset, as kernel K7 walks it
    → ``(lo (N, n_off), hi (N, n_off), overflow ())`` int64 with
    ``hi ≥ lo`` and the overflow of ``window_starts``.

    The rows of column ``col = ((cx + dx)·d + cy + dy)·d`` from z
    ``max(cz − z_hw, 0)`` to ``min(cz + z_hw, d − 1)``, clipped to the
    block's window ``[win_start, min(needed_end, win_start + window))``,
    empty where ``cx + dx`` or ``cy + dy`` leaves the grid. Every row of
    such a span passes the twin's coordinate predicate and no other window
    row does, so a pair sum over the spans alone is the sweep's."""
    n = csort.shape[0]
    b = min(block_size, max(n, 1))
    win_start, needed_end, overflow = window_starts(
        csort, cell_start, d=d, offsets=offsets, z_hw=z_hw, window=window,
        block_size=block_size)
    blk = torch.arange(n, device=csort.device) // b
    w_lo = win_start[blk]                                      # (N, n_off)
    w_hi = torch.minimum(needed_end, win_start + window)[blk]
    off = torch.as_tensor(offsets, dtype=torch.int64,
                          device=csort.device).reshape(-1, 2)
    c = csort.to(torch.int64)
    nx = c[:, 0:1] + off[:, 0]
    ny = c[:, 1:2] + off[:, 1]
    inside = (nx >= 0) & (nx < d) & (ny >= 0) & (ny < d)
    col = (torch.clamp(nx, 0, d - 1) * d + torch.clamp(ny, 0, d - 1)) * d
    cs = cell_start.to(torch.int64)
    z_lo = cs[col + torch.clamp(c[:, 2:3] - z_hw, min=0)]
    z_hi = cs[col + torch.clamp(c[:, 2:3] + z_hw, max=d - 1) + 1]
    lo = torch.maximum(z_lo, w_lo)
    hi = torch.where(inside, torch.maximum(torch.minimum(z_hi, w_hi), lo), lo)
    return lo, hi, overflow


def block_rows(blocks, n: int, block_size: int):
    """Sorted row indices of the listed target blocks, in block order
    (rows past ``n`` in the tail block dropped)."""
    b = min(block_size, max(n, 1))
    rows = (blocks[:, None] * b
            + torch.arange(b, device=blocks.device)).reshape(-1)
    return rows[rows < n]


def window_sweep_plain(psort, csort, cell_start, *, d: int, offsets,
                       z_hw: int, window: int, block_size: int, eps: float,
                       cutoff2: float | None = None, target_blocks=None,
                       pair_weight=None):
    """Plain twin of kernel K7 → ``(acc (N, 3) sorted order, overflow)``.

    The same arithmetic in torch, vectorized over chunks of target blocks:
    per offset, the chunk gathers the rows of its live spans
    ``[win_start, min(needed_end, win_start + window))`` (padded to the
    chunk's longest span and masked) and evaluates every (target, row)
    pair. ``target_blocks`` (1-D int tensor) computes only those blocks
    and returns their rows in ``block_rows`` order. ``pair_weight(r2,
    m_j)``, when given, replaces the softened weight (``eps`` unused): the
    custom-closure form of ``sorted_window.window_sweep``."""
    window_sweep_plain.calls += 1
    n = psort.shape[0]
    dev = psort.device
    b = min(block_size, max(n, 1))
    nb = -(-n // b)
    win_start, needed_end, overflow = window_starts(
        csort, cell_start, d=d, offsets=offsets, z_hw=z_hw, window=window,
        block_size=block_size)
    live_end = torch.minimum(needed_end, win_start + window)
    span = torch.clamp(live_end - win_start, min=0)
    blocks = (torch.arange(nb, device=dev) if target_blocks is None
              else target_blocks.to(device=dev, dtype=torch.int64))
    if n == 0:
        return torch.zeros((0, 3), dtype=psort.dtype, device=dev), overflow
    n_pad = nb * b
    tpos = torch.zeros((n_pad, 3), dtype=psort.dtype, device=dev)
    tpos[:n] = psort[:, :3]
    tcrd = torch.full((n_pad, 3), _SENTINEL, dtype=torch.int64, device=dev)
    tcrd[:n] = csort
    tpos = tpos.reshape(nb, b, 3)
    tcrd = tcrd.reshape(nb, b, 3)
    eps2 = eps * eps
    max_span = max(int(span.max()), 1) if span.numel() else 1
    chunk = max(1, _MAX_ELEMS // (b * max_span))
    out = []
    for c0 in range(0, blocks.shape[0], chunk):
        blk = blocks[c0:c0 + chunk]
        tp, tc = tpos[blk], tcrd[blk]                        # (c, b, 3)
        acc = torch.zeros_like(tp)
        for o, (dx, dy) in enumerate(offsets):
            s0 = win_start[blk, o]
            length = int(span[blk, o].max())
            if length == 0:
                continue
            idx = s0[:, None] + torch.arange(length, device=dev)
            valid = idx < live_end[blk, o][:, None]            # (c, L)
            idx = torch.clamp(idx, max=n - 1)
            sp, sc = psort[idx], csort[idx].to(torch.int64)  # (c, L, ·)
            match = (
                valid[:, None, :]
                & (sc[:, None, :, 0] == tc[:, :, None, 0] + dx)
                & (sc[:, None, :, 1] == tc[:, :, None, 1] + dy)
                & ((sc[:, None, :, 2] - tc[:, :, None, 2]).abs() <= z_hw)
            )                                                  # (c, b, L)
            dvec = sp[:, None, :, :3] - tp[:, :, None, :]      # (c, b, L, 3)
            dx_, dy_, dz_ = dvec.unbind(-1)
            r2 = dx_ * dx_ + dy_ * dy_ + dz_ * dz_  # the kernel's rounding
            if pair_weight is None:
                inv = torch.rsqrt(r2 + eps2)
                w = sp[:, None, :, 3] * (inv * inv * inv)
            else:
                w = pair_weight(r2, sp[:, None, :, 3])
            keep = match & (r2 > 0.0)
            if cutoff2 is not None:
                keep = keep & (r2 <= cutoff2)
            w = torch.where(keep, w, torch.zeros_like(w))
            acc = acc + (w[..., None] * dvec).sum(2)
        out.append(acc.reshape(-1, 3))
    acc = torch.cat(out) if out else torch.zeros((0, 3), device=dev)
    rows = (blocks[:, None] * b + torch.arange(b, device=dev)).reshape(-1)
    return acc[rows < n], overflow  # the rows of block_rows(blocks, ...)


window_sweep_plain.calls = 0

_offsets_cache: dict = {}


def _offsets_on(offsets, dev) -> torch.Tensor:
    """(n_off·2,) int32 device copy of the static offsets, made once per
    (offsets, device)."""
    key = (tuple(map(tuple, offsets)), str(dev))
    t = _offsets_cache.get(key)
    if t is None:
        t = torch.tensor(key[0], dtype=torch.int32, device=dev).reshape(-1)
        _offsets_cache[key] = t
    return t


@_build.counted
def window_sweep_kernel(psort, csort, cell_start, *, d: int, offsets,
                        z_hw: int, window: int, block_size: int, eps: float,
                        cutoff2: float | None = None):
    """Kernel K7 (``csrc/window_sweep.cu``, one CUDA block per
    ``block_size`` sorted targets, one thread per target walking its
    ``window_spans``) → ``(acc (N, 3) sorted order, overflow () int64)``.
    CPU tensors take the plain twin; CUDA tensors launch the kernel or
    raise."""
    kw = dict(d=d, offsets=offsets, z_hw=z_hw, window=window,
              block_size=block_size, eps=eps, cutoff2=cutoff2)
    if psort.device.type == "cpu":
        return window_sweep_plain(psort, csort, cell_start, **kw)
    _build.require_cuda(psort, "window_sweep_kernel")
    dev = psort.device
    n = psort.shape[0]
    b = min(block_size, max(n, 1))
    if b > 512:
        raise ValueError(f"block_size {block_size} > 512 threads")
    if d * d * d >= (1 << 31) // 2:
        raise ValueError(f"d = {d}: cell ids overflow int32")
    _build.check(psort, "psort", (n, 4), dev)
    if psort.data_ptr() % 16:
        raise ValueError("psort: rows must be 16-byte aligned (float4 loads)")
    _build.check(csort, "csort", (n, 3), dev, torch.int32)
    _build.check(cell_start, "cell_start", (d * d * d + 1,), dev, torch.int32)
    offs = _offsets_on(offsets, dev)
    acc = torch.empty((n, 3), dtype=torch.float32, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    if n == 0:
        return acc, overflow
    _build.launch(
        "nbt_window_sweep", dev, psort.data_ptr(), csort.data_ptr(),
        cell_start.data_ptr(), n, d, offs.data_ptr(), offs.numel() // 2,
        z_hw, window, float(eps) ** 2,
        0.0 if cutoff2 is None else float(cutoff2),
        0 if cutoff2 is None else 1, acc.data_ptr(), overflow.data_ptr(), b,
    )
    window_sweep_kernel.launches += 1
    return acc, overflow
