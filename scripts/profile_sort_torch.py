"""Benchmark the port's bitonic sort (kernel K8) against torch.sort on one
CUDA card — the PyTorch counterpart of scripts/profile_sort.py.

Usage: python scripts/profile_sort_torch.py [N]

The same input as scripts/profile_sort.py (N keys below 2^18 from numpy's
default_rng(0), N = 1M by default). Correctness first: the keys come out
sorted, ``keys[perm] == sorted`` and perm is a permutation. Then each
sort runs REPS times with a data dependency between runs (the next keys
are derived from both outputs), timed by the host clock to a device
readback, best of three timed runs after a warm one, and once more as the
median time of one sort (CUDA events around each of 21 sorts);
``torch.sort`` is the library yardstick (the port never calls it). Then
each K8 kernel's device time per sort (torch.profiler). Last, the case of
scripts/profile_bh5.py: the finest cell ids (d = 64) of the Barnes-Hut
scene (the default spherical scene, radius 10, seed 42, as chip_smoke.py
builds it), by K8 and by the stable ``torch.argsort`` the stepping path
uses. Needs a card.
"""

import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

N = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
REPS = 10


def bench(name, fn, x):
    def run(c):
        for _ in range(REPS):
            k, v = fn(c)
            # true data dependency: next keys derived from BOTH outputs
            c = (k >> 1) ^ (v & 0x3FFFF)
        return c

    run(x)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        c = run(x)
        chk = float((c[:128] % 97).sum())
        best = min(best, time.perf_counter() - t0)
    one = []
    for _ in range(21):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(x)
        b.record()
        b.synchronize()
        one.append(a.elapsed_time(b))
    print(f"{name:40s} {best / REPS * 1000:8.4f} ms/iter (chk {chk:.0f}); "
          f"one sort {statistics.median(one):.4f} ms (median of 21)",
          flush=True)


def kernel_times(fn, sorts=10):
    """Device time of each kernel of one K8 sort, by name and launch, from
    torch.profiler over ``sorts`` sorts."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(sorts):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_time_total > 0]
    total = sum(e.device_time_total for e in rows) / sorts / 1e3
    print(f"device time by kernel, per sort ({sorts} sorts): {total:.4f} ms",
          flush=True)
    for e in sorted(rows, key=lambda e: -e.device_time_total):
        print(f"    {e.device_time_total / sorts / 1e3:8.4f} ms  "
              f"{e.count / sorts:5.1f} launches  {e.key[:70]}", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from nbody_tpu_torch import SimulationConfig
    from nbody_tpu_torch.models.distributions import init_from_config
    from nbody_tpu_torch.ops.barnes_hut import bin_particles
    from nbody_tpu_torch.ops.sort import (
        bitonic_argsort,
        kernel_launches,
        launch_plan,
    )
    from nbody_tpu_torch.ops.sorted_window import cell_ids
    from nbody_tpu_torch.types import ForceMethod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda")
    plan = launch_plan(N)
    print(f"backend=cuda N={N} ({smi}); K8 queues {kernel_launches(N)} "
          f"kernels per sort, passes per launch {[len(x) for x in plan]}",
          flush=True)
    rng = np.random.default_rng(0)
    keys_np = rng.integers(0, 1 << 18, size=N).astype(np.int32)
    keys = torch.from_numpy(keys_np).to(dev)

    # correctness first (on the card)
    ks, perm = bitonic_argsort(keys)
    ks_np, perm_np = ks.cpu().numpy(), perm.cpu().numpy()
    assert (ks_np == np.sort(keys_np)).all(), "sorted keys mismatch"
    assert (keys_np[perm_np] == ks_np).all(), "perm mismatch"
    assert np.array_equal(np.sort(perm_np), np.arange(N)), "not a permutation"
    print("correctness OK", flush=True)

    def torch_sort(k):
        s = torch.sort(k)
        return s.values, s.indices.to(torch.int32)

    bench("bitonic_argsort (K8)", bitonic_argsort, keys)
    bench("torch.sort", torch_sort, keys)
    kernel_times(lambda: bitonic_argsort(keys))

    # scripts/profile_bh5.py's case: the 1M scene's finest cell ids
    scene = init_from_config(SimulationConfig(
        particle_count=N, force_method=ForceMethod.BARNES_HUT,
        bh_max_level=6), device=dev)
    ids0 = cell_ids(bin_particles(scene.pos, 6)[2], 64)

    def stable_argsort(k):
        return k, torch.argsort(k, stable=True).to(torch.int32)

    bench("cell ids d=64: bitonic_argsort (K8)",
          lambda c: bitonic_argsort(ids0 + c[0]), torch.zeros_like(ids0))
    bench("cell ids d=64: torch.argsort stable",
          lambda c: stable_argsort(ids0 + c[0]), torch.zeros_like(ids0))


if __name__ == "__main__":
    main()
