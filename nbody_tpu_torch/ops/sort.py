"""Bitonic sort of int32 (key, value) pairs (kernel K8).

Counterpart of ``nbody_tpu/ops/pallas_sort.py`` (``bitonic_sort_pairs``,
``bitonic_argsort``): int32 keys and values in and out, ascending by key,
not stable. N is padded to the next power of two, at least 1024, and the
network is the canonical one — element i meets its partner i ^ 2^j in
pass j of stage k, in the direction of bit k of i, and the two swap only
on strict inequality — so the order of equal keys, and with it the
permutation, is a fixed function of the input and equals the JAX
function's.

Unlike the JAX function, a pad compares greater than a real key equal to
INT_MAX (the comparison is on (key, pad)), so ``bitonic_argsort`` returns
a permutation for any int32 input; on keys below INT_MAX nothing changes.

Like the JAX package, the port keeps the stable ``torch.argsort`` on every
stepping path (``sorted_window.build_sorted_grid``): this sort is unstable
and runs only where it is asked for (``scripts/profile_sort_torch.py``).

``bitonic_sort_pairs`` is the wrapper of ``csrc/bitonic_sort.cu``;
``bitonic_sort_pairs_plain`` is its plain twin, one vectorised
compare-exchange per pass. ``launch_plan`` is the kernel's schedule: which
passes each of its launches runs. The wrapper hands it to the kernel's
entry point, which runs those launches and nothing else, so the count of
CUDA launches is ``kernel_launches(n)`` by construction.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nbody_tpu_torch.ops import _build

INT_MAX = (1 << 31) - 1
MIN_LOG2 = 10      # the JAX function pads to at least 1024 elements
TILE_LOG2 = 13     # elements per shared-memory tile of csrc/bitonic_sort.cu
GROUP = 4          # device-memory passes fused into one launch (kGroup)
_MAX_LOG2 = 30     # int32 indexing in the kernel


def padded_log2(n: int) -> int:
    """m with 2^m the padded length: the next power of two ≥ n, ≥ 1024."""
    return max(MIN_LOG2, (n - 1).bit_length())


def launch_plan(n: int) -> list[list[tuple[int, int]]]:
    """The passes (k, j) each CUDA launch of one sort of ``n`` keys runs,
    in order — the schedule ``nbt_bitonic_sort`` runs: one launch for stages
    1..t of every 2^t tile (t = min(m, TILE_LOG2)); then for each stage
    k > t its passes j = k−1..t over device memory, ``GROUP`` to a launch,
    and one launch for its passes j = t−1..0 tile by tile."""
    m = padded_log2(n)
    t = min(m, TILE_LOG2)
    plan = [[(k, j) for k in range(1, t + 1) for j in range(k - 1, -1, -1)]]
    for k in range(t + 1, m + 1):
        above = [(k, j) for j in range(k - 1, t - 1, -1)]
        plan += [above[i:i + GROUP] for i in range(0, len(above), GROUP)]
        plan.append([(k, j) for j in range(t - 1, -1, -1)])
    return plan


def kernel_launches(n: int) -> int:
    """CUDA kernels one sort of ``n`` keys queues (18 at n = 1M)."""
    return len(launch_plan(n))


@functools.lru_cache(maxsize=None)
def _plan_words(m: int):
    """``launch_plan`` for 2^m keys as the entry point takes it: a C int
    array of (k, j) of each launch's first pass, then of its last."""
    words = [w for launch in launch_plan(1 << m)
             for w in (*launch[0], *launch[-1])]
    return (ctypes.c_int * len(words))(*words), len(words) // 4


def bitonic_sort_pairs_plain(keys, vals):
    """Plain twin of kernel K8: the same network, one pass at a time, on
    (key, pad) compared as the int64 2·key + pad."""
    bitonic_sort_pairs_plain.calls += 1
    n = keys.shape[0]
    m = padded_log2(n)
    n_pad = 1 << m
    dev = keys.device
    k = torch.full((n_pad,), 2 * INT_MAX + 1, dtype=torch.int64, device=dev)
    k[:n] = 2 * keys.to(torch.int64)
    v = torch.zeros((n_pad,), dtype=torch.int32, device=dev)
    v[:n] = vals
    for stage in range(1, m + 1):
        for j in range(stage - 1, -1, -1):
            kv, vv = k.view(-1, 2, 1 << j), v.view(-1, 2, 1 << j)
            # pair block b holds rows b·2^(j+1) + [0, 2^(j+1)); bit `stage`
            # of its rows is bit stage − j − 1 of b
            b = torch.arange(kv.shape[0], device=dev)
            desc = (((b >> (stage - j - 1)) & 1) == 1)[:, None]
            a_k, b_k = kv[:, 0], kv[:, 1]
            swap = torch.where(desc, a_k < b_k, a_k > b_k)
            for x in (kv, vv):
                lo = torch.where(swap, x[:, 1], x[:, 0])
                hi = torch.where(swap, x[:, 0], x[:, 1])
                x[:, 0], x[:, 1] = lo, hi
    return (k[:n] >> 1).to(torch.int32), v[:n]


bitonic_sort_pairs_plain.calls = 0


@_build.counted
def bitonic_sort_pairs(keys, vals):
    """Kernel K8 (``csrc/bitonic_sort.cu``): sort int32 ``(keys, vals)``
    (N,) by key → ``(keys_sorted, vals_sorted)``. CPU tensors take the
    plain twin; CUDA tensors launch the kernel or raise."""
    if keys.device.type == "cpu":
        return bitonic_sort_pairs_plain(keys, vals)
    _build.require_cuda(keys, "bitonic_sort_pairs")
    dev = keys.device
    n = keys.shape[0]
    _build.check(keys, "keys", (n,), dev, torch.int32)
    _build.check(vals, "vals", (n,), dev, torch.int32)
    m = padded_log2(n)
    if m > _MAX_LOG2:
        raise ValueError(f"bitonic_sort_pairs: {n} keys overflow int32 "
                         "indexing")
    plan, n_launches = _plan_words(m)
    # (key, row) of each padded element, 8 bytes apiece
    work = torch.empty((2 << m,), dtype=torch.int32, device=dev)
    out_k = torch.empty((n,), dtype=torch.int32, device=dev)
    out_v = torch.empty((n,), dtype=torch.int32, device=dev)
    _build.launch("nbt_bitonic_sort", dev, keys.data_ptr(), vals.data_ptr(),
                  n, m, ctypes.addressof(plan), n_launches, work.data_ptr(),
                  out_k.data_ptr(), out_v.data_ptr())
    bitonic_sort_pairs.launches += 1
    return out_k, out_v


def bitonic_argsort(keys):
    """``(sorted_keys, perm)`` with ``keys[perm] == sorted_keys``, perm
    int32 — kernel K8 on the pairs (key, row index)."""
    vals = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    return bitonic_sort_pairs(keys, vals)
