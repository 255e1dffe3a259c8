#!/usr/bin/env python3
"""Time kernel K2 (slot placement, csrc/scatter.cu) in each of its three
forms, and the table step's two passes, at the 1M shapes of their paths,
on one CUDA card; optionally time an earlier scatter.cu's rank forms
beside today's.

    PYTHONPATH=. python3 scripts/profile_scatter_torch.py \
        [--baseline OLD_SCATTER_CU]

The shapes are those of ``chip_smoke.py``'s K2 checks: the Barnes-Hut
tiles main path (the 1M spherical scene, d 64, k 16) at step 0 and after
the path's 30 steps through the facade (the cold collapse: long runs in
the centre), and the 1M sparse hash (the uniform cube, cell 2.0, d 56,
k 16). Each shape's occupancy is printed first: the longest cell run and
z-row of cells, the rows past k, and the cells and z-rows longer than
K2's thresholds. At each, the device time of one call by CUDA graph
replay (``chip_smoke.graph_ms``) of:

  * the main form (placement, moments, counts: every sorted step of the
    tiles engines);
  * the rank form with coverage and 3 extra channels (a table re-sort);
  * at step 0 only: the dest form moving 32768 rows inside that table (a
    table repair step's mover set, ``chip_smoke.mover_set``; each replay
    moves the same slots again, the same memory traffic), and the table
    step's drift with the audit and its kick (``csrc/table_step.cu``) on
    that table.

``--baseline`` names a scatter.cu with the same ``nbt_tile_scatter``,
``nbt_tile_scatter_ext`` and ``nbt_tile_place`` C entries (for example an
earlier commit's, saved from version control to a file). It is built with
the package's nvcc flags and held to today's kernel: in the rank forms
placed slots, filler, counts, coverage and extra planes bit-equal, moments
within chip_smoke's 1e-5·|x| + 1e-6·max|channel| (a long run's sum may be
taken in another order; the largest moment difference is printed); the
dest form's table, high-water marks and bookkeeping bit-equal. Each form
is then timed against today's in the order A, B, B, A, three times over
(``profile_tile_near_torch.ab``). Needs a card.
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch

from chip_smoke import REPAIR_CAP, graph_ms, mover_set, path_configs
from profile_tile_near_torch import ab

COLLAPSE_STEPS = 30  # chip_smoke's timed steps on the BH tiles path


def load_baseline(path):
    """Build the scatter.cu at ``path`` into a shared library (the
    package's nvcc flags) and bind the entries of its three forms."""
    from nbody_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / "scatter_baseline.so"
    out = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
         str(path)], capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(f"nvcc failed for {path}:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(so))
    for name in ("nbt_tile_scatter", "nbt_tile_scatter_ext",
                 "nbt_tile_place"):
        getattr(lib, name).argtypes = list(_build.SIGNATURES[name])
        getattr(lib, name).restype = ctypes.c_int
    return lib


def collapsed_bh(dev):
    """The 1M BH tiles path's state after its ``COLLAPSE_STEPS`` steps
    through the facade → (pos, mass)."""
    from nbody_tpu_torch import ParticleSystem

    ps = ParticleSystem()
    ps.initialize(path_configs()["1M BH tiles"], device=dev)
    ps.run_steps(COLLAPSE_STEPS)
    ps.synchronize()
    return ps.state.pos, ps.state.mass


def shapes(dev):
    """[(label, sorted grid, lo, cell, d, k, step 0)] at K2's 1M shapes."""
    from nbody_tpu_torch.models.distributions import init_from_config
    from nbody_tpu_torch.ops.barnes_hut import bin_particles
    from nbody_tpu_torch.ops.sorted_window import build_sorted_grid
    from nbody_tpu_torch.ops.spatial_hash import tiles_bin

    cfgs = path_configs()
    bh = init_from_config(cfgs["1M BH tiles"], device=dev)
    lo, cell, coords = bin_particles(bh.pos, 6)
    out = [("1M BH tiles", build_sorted_grid(bh.pos, bh.mass, coords, 64),
            lo, cell, 64, 16, True)]
    pos, mass = collapsed_bh(dev)
    lo, cell, coords = bin_particles(pos, 6)
    out.append((f"1M BH tiles after {COLLAPSE_STEPS} steps",
                build_sorted_grid(pos, mass, coords, 64), lo, cell, 64, 16,
                False))
    sp = init_from_config(cfgs["1M sparse hash"], device=dev)
    lo, coords = tiles_bin(sp.pos, 2.0, 56)
    cell = torch.full((), 2.0, device=dev)
    out.append(("1M sparse hash",
                build_sorted_grid(sp.pos, sp.mass, coords, 56), lo, cell, 56,
                16, True))
    return out


def occupancy(cell_start, d, k):
    """One line on the runs K2 reads: the longest cell and z-row, rows
    past k, and cells / z-rows past the kernel's thresholds."""
    from nbody_tpu_torch.ops.scatter import k2_plan

    plan = k2_plan()
    cs = cell_start.long()
    counts = cs[1:] - cs[:-1]
    zrow = cs[d::d] - cs[:-1:d]
    return (f"longest cell {int(counts.max())} rows, longest z-row "
            f"{int(zrow.max())} rows, {int((counts - k).clamp(min=0).sum())}"
            f" rows past k, {int((counts > plan['long_run']).sum())} cells "
            f"past {plan['long_run']} rows (summed by slices), "
            f"{int((zrow > plan['chunk_rows']).sum())} z-rows past one "
            f"chunk of {plan['chunk_rows']} rows")


def held(label, got, want):
    """Today's rank form against the baseline's: every output but the
    moments bit-equal, moments within chip_smoke's tolerance → the largest
    moment difference."""
    tiles, mom = got[0], got[1]
    check = torch.equal(tiles, want[0]) and torch.equal(mom[10], want[1][10])
    check = check and all(torch.equal(a, b) for a, b in zip(got[2:],
                                                            want[2:]))
    err = (mom - want[1]).abs()
    tol = 1e-5 * want[1].abs() + 1e-6 * want[1].abs().amax(dim=1,
                                                           keepdim=True)
    ok = check and bool((err <= tol).all())
    print(f"K2 {label}: baseline and today: slots, counts"
          f"{', coverage and extra' if len(got) > 2 else ''} bit-equal "
          f"{check}; moments max|diff| {float(err.max()):.3e}, largest "
          f"|diff| / tol {float((err / tol).max()):.3e}", flush=True)
    if not ok:
        sys.exit(f"K2 {label}: baseline and today's kernel differ")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", metavar="SCATTER_CU",
                        help="an earlier scatter.cu to time beside today's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from nbody_tpu_torch.ops import table_step as T
    from nbody_tpu_torch.ops.scatter import tile_place, tile_scatter

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    dev = torch.device("cuda")
    base = load_baseline(args.baseline) if args.baseline else None
    stream = torch._C._cuda_getCurrentRawStream
    for label, g, lo, cell, d, k, step0 in shapes(dev):
        n, nc = g.psort.shape[0], d ** 3
        print(f"K2 {label}: {occupancy(g.cell_start, d, k)}", flush=True)
        a = (g.psort, g.cell_start, lo, cell)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        ex = torch.randn(n, 3, generator=gen, device=dev)
        tk, mk = tile_scatter(*a, d=d, k=k)
        table = tile_scatter(*a, d=d, k=k, with_coverage=True, extra=ex)
        forms = {
            "main form": lambda: tile_scatter(*a, d=d, k=k),
            "coverage + 3 extra": lambda: tile_scatter(
                *a, d=d, k=k, with_coverage=True, extra=ex),
        }
        if step0:
            tt, mt, ct, xt = table
            src, dest, _, fresh = mover_set(tt, ct, xt, mt[10], d, k,
                                            REPAIR_CAP, gen)
            moved = fresh()
            tp = (T.bh_table_params(levels=6, near_k=k) if d == 64 else
                  T.hash_table_params(cutoff=2.0, cell_size=2.0, d=d, k=k))
            vel = xt * 20.0
            acc = torch.randn(vel.shape, generator=gen, device=dev) * ct
            raw, vh = torch.randn_like(vel), vel.clone()
            forms.update({
                f"dest form, {REPAIR_CAP} movers": lambda: tile_place(
                    *moved, src, dest, lo, cell, d=d, k=k),
                "table_drift with the audit": lambda: T.table_drift(
                    tt, vel, acc, ct, lo, cell, 1e-3, tp, True),
                "table_kick": lambda: T.table_kick(raw, ct, vh, 1.0, 1e-3),
            })
        for name, fn in forms.items():
            ts = [graph_ms(fn, reps=10) for _ in range(3)]
            print(f"K2 {label}, {name}: device ms per call "
                  f"{[round(t, 4) for t in ts]}, median "
                  f"{statistics.median(ts):.4f}", flush=True)
        if base is None:
            continue

        def old():
            tiles = torch.empty((d, 4, k, d * d), device=dev)
            mom = torch.empty((11, nc), device=dev)
            err = base.nbt_tile_scatter(
                g.psort.data_ptr(), g.cell_start.data_ptr(), lo.data_ptr(),
                cell.reshape(()).data_ptr(), tiles.data_ptr(), mom.data_ptr(),
                d, k, stream(dev.index or 0))
            if err != 0:
                sys.exit(f"baseline K2: CUDA error {err}")
            return tiles, mom

        def old_table():
            tiles = torch.empty((d, 4, k, d * d), device=dev)
            mom = torch.empty((11, nc), device=dev)
            cov = torch.empty((d, 1, k, d * d), device=dev)
            ext = torch.empty((d, 3, k, d * d), device=dev)
            err = base.nbt_tile_scatter_ext(
                g.psort.data_ptr(), ex.data_ptr(), g.cell_start.data_ptr(),
                lo.data_ptr(), cell.reshape(()).data_ptr(), tiles.data_ptr(),
                mom.data_ptr(), cov.data_ptr(), ext.data_ptr(), d, k,
                stream(dev.index or 0))
            if err != 0:
                sys.exit(f"baseline K2 table form: CUDA error {err}")
            return tiles, mom, cov, ext

        held(f"{label} main form", (tk, mk), old())
        held(f"{label} coverage + 3 extra", table, old_table())
        ab(f"K2 {label} main form", "baseline", old, "today",
           forms["main form"], smi)
        ab(f"K2 {label} coverage + 3 extra", "baseline", old_table, "today",
           forms["coverage + 3 extra"], smi)
        if not step0:
            continue

        def old_place(t):
            err = base.nbt_tile_place(
                src.data_ptr(), dest.data_ptr(), src.shape[0], lo.data_ptr(),
                cell.reshape(()).data_ptr(), *(x.data_ptr() for x in t), d, k,
                stream(dev.index or 0))
            if err != 0:
                sys.exit(f"baseline K2 dest form: CUDA error {err}")

        got, want = fresh(), fresh()
        tile_place(*got, src, dest, lo, cell, d=d, k=k)
        old_place(want)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        print(f"K2 {label} dest form: baseline and today: table, high-water "
              f"marks and bookkeeping bit-equal {same}", flush=True)
        if not same:
            sys.exit(f"K2 {label}: baseline and today's dest form differ")
        moved_old = fresh()
        ab(f"K2 {label} dest form, {REPAIR_CAP} movers", "baseline",
           lambda: old_place(moved_old), "today",
           forms[f"dest form, {REPAIR_CAP} movers"], smi)


if __name__ == "__main__":
    main()
