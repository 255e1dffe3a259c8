"""The bitonic sort of nbody_tpu_torch (K8's plain twin on the CPU) against
the JAX package's ``bitonic_argsort`` / ``bitonic_sort_pairs`` in interpret
mode, on the cases of tests/test_pallas_sort.py: keys and values equal bit
for bit, ties included (both run the canonical network, whose tie order is
a fixed function of the input)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu.ops.pallas_sort as ps
from nbody_tpu_torch.ops.sort import (
    INT_MAX,
    bitonic_argsort,
    bitonic_sort_pairs,
    kernel_launches,
    _plan_words,
    launch_plan,
    padded_log2,
)


def _same_as_jax(keys, vals=None):
    if vals is None:
        vals = np.arange(keys.shape[0], dtype=np.int32)
        got = bitonic_argsort(torch.from_numpy(keys))
    else:
        got = bitonic_sort_pairs(torch.from_numpy(keys),
                                 torch.from_numpy(vals))
    # traced anew on every call: the block size is read when the function
    # is traced, and JAX's cache may hold a trace made at another one
    want = jax.jit(lambda k, v: ps.bitonic_sort_pairs.__wrapped__(
        k, v, interpret=True))(jnp.asarray(keys), jnp.asarray(vals))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(got[0].numpy(), np.sort(keys))


@pytest.mark.parametrize("n", [1000, 1024, 2048])
def test_single_block_matches_jax(n):
    rng = np.random.default_rng(0)
    _same_as_jax(rng.integers(0, 5000, size=n).astype(np.int32))


def test_duplicate_keys_match_jax():
    """1500 keys in 0..6: the permutation's tie order is the JAX one."""
    rng = np.random.default_rng(1)
    _same_as_jax(rng.integers(0, 7, size=1500).astype(np.int32))


def test_sort_pairs_carries_values_as_jax():
    rng = np.random.default_rng(3)
    _same_as_jax(rng.integers(0, 100, size=1024).astype(np.int32),
                 rng.integers(0, 1 << 30, size=1024).astype(np.int32))


@pytest.mark.parametrize("n", [2048, 5000])
def test_multi_block_route_matches_jax(n, monkeypatch):
    """The JAX cross-block and merge kernels (block size shrunk to 2¹⁰)
    give the same network's result."""
    monkeypatch.setattr(ps, "_BLOCK_LOG2", 10)
    rng = np.random.default_rng(2)
    _same_as_jax(rng.integers(0, 3000, size=n).astype(np.int32))


def test_int_max_keys_still_give_a_permutation():
    """Keys equal to INT_MAX tie with the JAX function's pads, whose
    permutation then repeats row 0; the port's pads compare greater, so
    the result is a sorting permutation (port only)."""
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 10, size=1000).astype(np.int32)
    keys[rng.choice(1000, 40, replace=False)] = INT_MAX
    ks, perm = bitonic_argsort(torch.from_numpy(keys))
    perm = perm.numpy()
    assert np.array_equal(np.sort(perm), np.arange(1000))
    assert np.array_equal(keys[perm], ks.numpy())
    assert np.array_equal(ks.numpy(), np.sort(keys))


def test_kernel_launch_count():
    """One launch sorts every 2¹³ tile; above the tile each stage fuses
    its device-memory passes four to a launch and merges its tiles in one
    more: 18 launches at 1M, 1 up to 2¹³, 3 and then 5 for the first
    sizes above it."""
    assert kernel_launches(1_000_000) == 18 <= 20
    assert kernel_launches(1000) == kernel_launches(8192) == 1
    assert kernel_launches(8193) == kernel_launches(1 << 14) == 3
    assert kernel_launches((1 << 14) + 1) == 5
    # 2^18 padded: stages 14..18 fuse 1, 1, 1, 1 and 2 groups
    assert kernel_launches((1 << 17) + 3) == 1 + 6 + 5


@pytest.mark.parametrize(
    "n", [1000, 1024, 8191, 8193, 1 << 14, 100_000, 1 << 17, (1 << 17) + 3,
          1 << 20, (1 << 20) + 1])
def test_launch_plan_is_the_canonical_network(n):
    """Laid end to end, the launches run exactly the canonical passes in
    order (k = 1..m, j = k−1..0 each), and no device-memory launch runs
    more than four passes."""
    m = padded_log2(n)
    plan = launch_plan(n)
    assert [kj for launch in plan for kj in launch] == [
        (k, j) for k in range(1, m + 1) for j in range(k - 1, -1, -1)]
    assert len(plan) == kernel_launches(n)
    for launch in plan[1:]:
        if launch[-1][1] > 0:   # a group above the tile
            assert 1 <= len(launch) <= 4
            assert launch[-1][1] >= min(m, 13)


@pytest.mark.parametrize("n", [1000, 8193, (1 << 17) + 3, 1 << 20])
def test_plan_words_are_the_launch_plan(n):
    """What the wrapper hands the kernel's entry point is ``launch_plan``:
    each launch as its first and last pass, from which the canonical
    sequence gives back every pass in between."""
    m = padded_log2(n)
    words, count = _plan_words(m)
    plan = launch_plan(n)
    assert count == len(plan) == kernel_launches(n)
    canon = [(k, j) for k in range(1, m + 1) for j in range(k - 1, -1, -1)]
    at = {kj: i for i, kj in enumerate(canon)}
    spans = [canon[at[tuple(words[4 * i:4 * i + 2])]:
                   at[tuple(words[4 * i + 2:4 * i + 4])] + 1]
             for i in range(count)]
    assert spans == plan
