#!/usr/bin/env python3
"""Time kernels K4 (the near slot sweep, csrc/tile_near.cu) and K1 (direct
forces, csrc/direct.cu) with each of their two pair loops, at the shapes
their paths give them, on one CUDA card; optionally time an earlier K1
source beside today's, hold K4's cube form to an earlier source bit for
bit, and time K5's two forms against an earlier source.

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

``--k4-baseline`` names an earlier tile_near.cu with today's C interface
of ``nbt_tile_near`` (for example the source before the slab form was
added). It is built alone and called on the same inputs as today's, K4's
cube form at its three 1M shapes; the script stops unless today's output
equals the baseline's bit for bit, then times the two in turns.

``--k5-baseline`` names an earlier pair_potential.cu with the one-thread-
a-row C interface ``nbt_pair_potential(pos, mass, n, eps2, partial,
stream)`` and ``nbt_pair_potential_cross(tpos, tmass, nt, spos, smass,
ns, eps2, partial, stream)``, one float64 partial per 256 targets (the
source before each unordered pair was taken once). It is built alone and
called with that signature on the same inputs as today's: the main form
on the 16384 rows the app's sampled estimate draws, the 100K direct scene
(the facade's ``compute_potential_energy``), the BH scene's first 131072
rows and the drift gate's 1M Hénon sphere; the cross form on the BH
scene's rows [0, 250000) against [250000, 500000). Today's kernel sums
each unordered pair once, in another order, so the script stops unless
the two agree to relative 1e-6 (not bit for bit), then times them in
turns (one call a graph replay at 1M). Today's K5 also picks its pair
loop by ε² (``rsqrt.approx.ftz`` at ε² ≥ 1e-12, ``rsqrtf`` below), so
at each of those shapes it is timed at the shape's ε against ε = 0 as
well: the same pairs through the two loop bodies.

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


def ab(label, a_name, a, b_name, b, smi, reps=3, load_calls=200):
    """Time ``a`` and ``b`` in turns (``reps`` calls a graph replay);
    print the times and ratio a / b, and the clock and power under
    ``load_calls`` calls of ``a``."""
    fns = {a_name: a, b_name: b}
    times = {a_name: [], b_name: []}
    for _ in range(ROUNDS):
        for name in (a_name, b_name, b_name, a_name):
            times[name].append(graph_ms(fns[name], reps=reps))
    med = {k: statistics.median(v) for k, v in times.items()}
    for name, ts in times.items():
        print(f"{label}, {name}: device ms per call "
              f"{[round(t, 4) for t in ts]}, median {med[name]:.4f}")
    print(f"{label}: {a_name} / {b_name} = {med[a_name] / med[b_name]:.4f} "
          f"({smi}; SM clock, power under {a_name}: "
          f"{under_load(a, load_calls)})",
          flush=True)


def load_baseline(path, name, argtypes, *more):
    """Build the source at ``path`` into a shared library (the package's
    nvcc flags) and bind its entry point ``name``; with ``more`` (further
    name, argtypes pairs) a tuple of every entry point bound."""
    from nbody_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / f"{name}_baseline.so"
    out = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
         str(path)], capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(f"nvcc failed for {path}:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(so))
    fns = []
    for fname, types in ((name, argtypes), *zip(more[::2], more[1::2])):
        fn = getattr(lib, fname)
        fn.argtypes = list(types)
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns[0] if not more else tuple(fns)


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


# The one-thread-a-row K5's C interface (main and cross form).
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
K5_OLD = ("nbt_pair_potential", (_P, _P, _I, _F, _P, _P),
          "nbt_pair_potential_cross", (_P, _P, _I, _P, _P, _I, _F, _P, _P))


def k5_baseline_call(fn, p, m, G, eps, src=None):
    """One call of a baseline ``nbt_pair_potential`` build: the main form,
    or with ``src=(pos, mass)`` its cross form (one partial per 256
    targets, −½G applied to their sum)."""
    partial = torch.empty((-(-p.shape[0] // 256),), dtype=torch.float64,
                          device=p.device)
    args = (p.data_ptr(), m.data_ptr(), p.shape[0])
    if src is not None:
        args += (src[0].data_ptr(), src[1].data_ptr(), src[0].shape[0])
    err = fn(*args, float(eps) ** 2, partial.data_ptr(), raw_stream())
    if err != 0:
        sys.exit(f"baseline K5: CUDA error {err}")
    return (-0.5 * G * partial.sum()).to(torch.float32)


def close_or_exit(label, today, baseline, rtol):
    rel = abs(float(today) - float(baseline)) / abs(float(baseline))
    if not rel <= rtol:
        sys.exit(f"{label}: today's {float(today):.9e} differs from the "
                 f"baseline's {float(baseline):.9e} by {rel:.3e} > {rtol}")
    print(f"{label}: today's {float(today):.9e}, the baseline's "
          f"{float(baseline):.9e}, rel diff {rel:.3e} (tol {rtol})",
          flush=True)


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


def k5_ab(path, scene, cfg, cfgs, dev, smi):
    """K5's main form at its four shapes and its cross form at 250000 ×
    250000, today's against the baseline build at ``path``: held to
    relative 1e-6, then timed in turns."""
    from nbody_tpu_torch.drift import drift_config, henon_sphere
    from nbody_tpu_torch.models.distributions import init_from_config
    from nbody_tpu_torch.ops.direct import (
        pairwise_potential,
        pairwise_potential_cross,
    )

    old_main, old_cross = load_baseline(path, *K5_OLD)
    n = scene.pos.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)  # sampled_potential_energy's default draw
    idx = torch.randperm(n, generator=gen, device=dev)[:16384]
    direct = init_from_config(cfgs["100K direct"], device=dev)
    h = henon_sphere(n, dev)
    dcfg = drift_config(n)
    shapes = (
        ("N = 16384 (sampled estimate)", scene.pos[idx], scene.mass[idx],
         cfg),
        ("N = 100000 (facade)", direct.pos, direct.mass,
         cfgs["100K direct"]),
        ("N = 131072", scene.pos[:131072].contiguous(),
         scene.mass[:131072].contiguous(), cfg),
        (f"N = {n} (drift gate)", h.pos, h.mass, dcfg),
    )
    for label, p, m, c in shapes:
        def k5_old(p=p, m=m, c=c):
            return k5_baseline_call(old_main, p, m, c.G, c.softening)

        def k5_new(p=p, m=m, c=c):
            return pairwise_potential(p, m, c.G, c.softening)

        close_or_exit(f"K5 main form at {label}", k5_new(), k5_old(), 1e-6)
        more = (1, 5) if p.shape[0] > 500_000 else ()
        ab(f"K5 main form at {label}", "baseline", k5_old, "today", k5_new,
           smi, *more)
        ab(f"K5 main form at {label}", "lean loop", k5_new, "exact loop",
           lambda p=p, m=m, c=c: pairwise_potential(p, m, c.G, 0.0), smi,
           *more)
    del h
    a = (scene.pos[:250_000], scene.mass[:250_000])
    b = (scene.pos[250_000:500_000], scene.mass[250_000:500_000])

    def cross_old():
        return k5_baseline_call(old_cross, *a, cfg.G, cfg.softening, src=b)

    def cross_new():
        return pairwise_potential_cross(*a, *b, cfg.G, cfg.softening)

    label = "K5 cross form at 250000 x 250000"
    close_or_exit(label, cross_new(), cross_old(), 1e-6)
    ab(label, "baseline", cross_old, "today", cross_new, smi)
    ab(label, "lean loop", cross_new, "exact loop",
       lambda: pairwise_potential_cross(*a, *b, cfg.G, 0.0), smi)


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
        k5_ab(args.k5_baseline, scene, cfg, cfgs, dev, smi)
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
