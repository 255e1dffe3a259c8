#!/usr/bin/env python3
"""Time kernels K4 (the near slot sweep, csrc/tile_near.cu) and K1 (direct
forces, csrc/direct.cu) with each of their two pair loops, at the shapes
their paths give them, on one CUDA card; optionally time an earlier K1
source beside today's, and hold K4's cube form and K5's main form to
earlier sources bit for bit.

    PYTHONPATH=. python3 scripts/profile_tile_near_torch.py \
        [--k1-baseline OLD_DIRECT_CU] [--k4-baseline OLD_TILE_NEAR_CU] \
        [--k5-baseline OLD_PAIR_POTENTIAL_CU]

The inputs are those of ``chip_smoke.py``'s checks: K4 at its three 1M
shapes (``k4_inputs``: BH tiles, the monopole path at ws 2, the sparse
hash) and K1 at its three (``k1_inputs``: N = 16384, the 100K direct
scene, 4096 targets against the 1M scene). Both kernels pick their pair
loop by ε²: with ε² ≥ 1e-12 (here ε = 0.1) the lean loop, without the
r² == 0 test, on ``rsqrt.approx.ftz``; otherwise (here ε = 0) the loop
that keeps the test and ``rsqrtf``. Both loops walk the same pairs, so
their times on the same inputs compare the two loop bodies.

``--k1-baseline`` names a direct.cu with the one-pass C interface
``nbt_direct_forces(tgt, nt, spos, smass, ns, G, eps2, acc, stream)``
(one thread a target, no source split), for example the source before
the split was added, saved from version control to a file. It is built
with the package's nvcc flags and timed against today's kernel at each
K1 shape; the max|diff| of each to the plain twin is printed beside the
twin's tolerance, 1e-5·max|a|.

``--k4-baseline`` and ``--k5-baseline`` name an earlier tile_near.cu and
pair_potential.cu with today's C interface of ``nbt_tile_near`` and
``nbt_pair_potential`` (for example the sources before the slab and cross
forms were added). Each is built alone and called on the same inputs as
today's: K4's cube form at its three 1M shapes and K5's main form at
N = 131072 on the BH scene's first rows. The script stops unless today's
output equals the baseline's bit for bit, then times the two in turns.

Every pair of versions is timed in the order A, B, B, A, three times
over: the device time of one call by CUDA graph replay
(``chip_smoke.graph_ms``). Prints every time, the medians and their
ratio, and the SM clock and power that nvidia-smi reads while A runs.
Needs a card.
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from chip_smoke import graph_ms, k1_inputs, k4_inputs, path_configs

ROUNDS = 3


def under_load(fn, calls=200):
    """nvidia-smi's SM clock and power read while ``calls`` calls of
    ``fn`` run on the card."""
    for _ in range(calls):
        fn()
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    torch.cuda.synchronize()
    return q


def ab(label, a_name, a, b_name, b, smi):
    """Time ``a`` and ``b`` in turns; print the times and ratio a / b."""
    fns = {a_name: a, b_name: b}
    times = {a_name: [], b_name: []}
    for _ in range(ROUNDS):
        for name in (a_name, b_name, b_name, a_name):
            times[name].append(graph_ms(fns[name], reps=3))
    med = {k: statistics.median(v) for k, v in times.items()}
    for name, ts in times.items():
        print(f"{label}, {name}: device ms per call "
              f"{[round(t, 4) for t in ts]}, median {med[name]:.4f}")
    print(f"{label}: {a_name} / {b_name} = {med[a_name] / med[b_name]:.4f} "
          f"({smi}; SM clock, power under {a_name}: {under_load(a)})",
          flush=True)


def load_baseline(path, name, argtypes):
    """Build the source at ``path`` into a shared library (the package's
    nvcc flags) and bind its entry point ``name``."""
    from nbody_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / f"{name}_baseline.so"
    out = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
         str(path)], capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(f"nvcc failed for {path}:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def raw_stream():
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def k4_baseline_call(fn, tk, kw):
    """One call of a baseline ``nbt_tile_near`` build (cube form)."""
    from nbody_tpu_torch.ops import _build

    far = kw.get("far_plane")
    n_far = 0 if far is None else far.shape[1]
    d, k = kw["d"], kw["k"]
    out = torch.empty((d, 3, k, d * d), dtype=torch.float32, device=tk.device)
    cutoff2 = kw.get("cutoff2")
    err = fn(tk.data_ptr(), _build.ptr(far), n_far, _build.ptr(kw["counts"]),
             _build.ptr(kw["lo"]) if n_far else None,
             _build.ptr(kw["cell"].reshape(())) if n_far else None,
             out.data_ptr(), d, k, kw["ws"], float(kw["eps"]) ** 2,
             0.0 if cutoff2 is None else float(cutoff2),
             0 if cutoff2 is None else 1, raw_stream())
    if err != 0:
        sys.exit(f"baseline K4: CUDA error {err}")
    return out


def k5_baseline_call(fn, p, m, G, eps):
    """One call of a baseline ``nbt_pair_potential`` build (main form)."""
    partial = torch.empty((-(-p.shape[0] // 256),), dtype=torch.float64,
                          device=p.device)
    err = fn(p.data_ptr(), m.data_ptr(), p.shape[0], float(eps) ** 2,
             partial.data_ptr(), raw_stream())
    if err != 0:
        sys.exit(f"baseline K5: CUDA error {err}")
    return (-0.5 * G * partial.sum()).to(torch.float32)


def same_or_exit(label, today, baseline):
    if not torch.equal(today, baseline):
        sys.exit(f"{label}: today's output differs from the baseline's")
    print(f"{label}: today's output equals the baseline's bit for bit",
          flush=True)


def baseline_call(fn, pos, mass, G, eps, targets):
    """One call of the baseline K1 build's ``nbt_direct_forces``."""
    tgt = pos if targets is None else targets
    acc = torch.empty_like(tgt)
    err = fn(
        tgt.data_ptr(), tgt.shape[0], pos.data_ptr(), mass.data_ptr(),
        pos.shape[0], G, eps * eps, acc.data_ptr(), raw_stream())
    if err != 0:
        sys.exit(f"baseline K1: CUDA error {err}")
    return acc


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--k1-baseline", metavar="DIRECT_CU",
                        help="an earlier direct.cu to time beside K1")
    parser.add_argument("--k4-baseline", metavar="TILE_NEAR_CU",
                        help="an earlier tile_near.cu K4's cube form must "
                        "equal")
    parser.add_argument("--k5-baseline", metavar="PAIR_POTENTIAL_CU",
                        help="an earlier pair_potential.cu K5's main form "
                        "must equal")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from nbody_tpu_torch.models.distributions import init_from_config
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops.direct import (
        direct_forces,
        direct_forces_kernel,
        pairwise_potential,
    )
    from nbody_tpu_torch.ops.tile_near import tile_sweep_plane

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda")
    cfgs = path_configs()
    cfg = cfgs["1M BH tiles"]
    scene = init_from_config(cfg, device=dev)
    sparse = init_from_config(cfgs["1M sparse hash"], device=dev)
    base = (load_baseline(args.k1_baseline, "nbt_direct_forces",
                          [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                           ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
            if args.k1_baseline else None)
    k4_base = (load_baseline(args.k4_baseline, "nbt_tile_near",
                             _build.SIGNATURES["nbt_tile_near"])
               if args.k4_baseline else None)
    if args.k5_baseline:
        k5_base = load_baseline(args.k5_baseline, "nbt_pair_potential",
                                _build.SIGNATURES["nbt_pair_potential"])
        n = 131072
        p, m = scene.pos[:n].contiguous(), scene.mass[:n].contiguous()

        def k5_old():
            return k5_baseline_call(k5_base, p, m, cfg.G, cfg.softening)

        def k5_new():
            return pairwise_potential(p, m, cfg.G, cfg.softening)

        same_or_exit(f"K5 main form at N = {n}", k5_new(), k5_old())
        ab(f"K5 main form at N = {n}", "baseline", k5_old, "today", k5_new,
           smi)
    for label, tk, kw in k4_inputs(scene.pos, scene.mass, cfg, sparse.pos,
                                   sparse.mass):
        if k4_base is not None:
            def k4_old(tk=tk, kw=kw):
                return k4_baseline_call(k4_base, tk, kw)

            def k4_new(tk=tk, kw=kw):
                return tile_sweep_plane(tk, **kw)

            same_or_exit(f"K4 cube form {label}", k4_new(), k4_old())
            ab(f"K4 cube form {label}", "baseline", k4_old, "today", k4_new,
               smi)
        ab(f"K4 {label}",
           "lean loop", lambda tk=tk, kw=kw: tile_sweep_plane(tk, **kw),
           "exact loop",
           lambda tk=tk, kw=kw: tile_sweep_plane(tk, **{**kw, "eps": 0.0}),
           smi)
    for label, p, m, tgt in k1_inputs(scene.pos, scene.mass, cfg, dev):
        def k1(eps, p=p, m=m, tgt=tgt):
            return direct_forces_kernel(p, m, cfg.G, eps, targets=tgt)

        ab(f"K1 {label}", "lean loop", lambda: k1(cfg.softening),
           "exact loop", lambda: k1(0.0), smi)
        if base is None:
            continue

        def old(p=p, m=m, tgt=tgt):
            return baseline_call(base, p, m, cfg.G, cfg.softening, tgt)

        want = direct_forces(p, m, cfg.G, cfg.softening, targets=tgt)
        tol = 1e-5 * float(want.abs().max())
        for name, got in (("baseline", old()), ("today", k1(cfg.softening))):
            e = float((got - want).abs().max())
            print(f"K1 {label}: {name} max|diff| to the plain twin {e:.3e} "
                  f"({'within' if e <= tol else 'over'} 1e-5*max|a| = "
                  f"{tol:.3e})")
        ab(f"K1 {label}", "baseline", old, "today",
           lambda: k1(cfg.softening), smi)


if __name__ == "__main__":
    main()
