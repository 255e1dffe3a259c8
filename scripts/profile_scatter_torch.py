#!/usr/bin/env python3
"""Time kernel K2 (slot placement, csrc/scatter.cu) in each of its three
forms, and the table step's two passes, at the 1M shapes of their paths,
on one CUDA card; optionally time an earlier scatter.cu's main form beside
today's.

    PYTHONPATH=. python3 scripts/profile_scatter_torch.py \
        [--baseline OLD_SCATTER_CU]

The shapes are those of ``chip_smoke.py``'s K2 checks: the Barnes-Hut
tiles main path (the 1M spherical scene, d 64, k 16) and the 1M sparse hash
(the uniform cube, cell 2.0, d 56, k 16). At each, the device time of one
call by CUDA graph replay (``chip_smoke.graph_ms``) of:

  * the main form (placement, moments, counts: every sorted step of the
    tiles engines);
  * the rank form with coverage and 3 extra channels (a table re-sort);
  * the dest form moving 32768 rows inside that table (a table repair
    step's mover set, ``chip_smoke.mover_set``; each replay moves the same
    slots again, the same memory traffic);
  * the table step's drift with the audit and its kick
    (``csrc/table_step.cu``) on that table.

``--baseline`` names a scatter.cu with the same ``nbt_tile_scatter`` C
entry (for example the source before the table forms were added, saved
from version control to a file). It is built with the package's nvcc flags
and its main form is timed against today's in the order A, B, B, A, three
times over (``profile_tile_near_torch.ab``), after a check that both give
the same tiles and moments bit for bit. Needs a card.
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


def load_baseline(path):
    """Build the scatter.cu at ``path`` into a shared library (the
    package's nvcc flags) and bind its ``nbt_tile_scatter``."""
    from nbody_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / "scatter_baseline.so"
    out = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
         str(path)], capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(f"nvcc failed for {path}:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.nbt_tile_scatter.argtypes = [P, P, P, P, P, P, I, I, P]
    lib.nbt_tile_scatter.restype = ctypes.c_int
    return lib


def shapes(dev):
    """[(label, sorted grid, lo, cell, d, k)] at K2's two 1M shapes."""
    from nbody_tpu_torch.models.distributions import init_from_config
    from nbody_tpu_torch.ops.barnes_hut import bin_particles
    from nbody_tpu_torch.ops.sorted_window import build_sorted_grid
    from nbody_tpu_torch.ops.spatial_hash import tiles_bin

    cfgs = path_configs()
    bh = init_from_config(cfgs["1M BH tiles"], device=dev)
    lo, cell, coords = bin_particles(bh.pos, 6)
    out = [("1M BH tiles", build_sorted_grid(bh.pos, bh.mass, coords, 64),
            lo, cell, 64, 16)]
    sp = init_from_config(cfgs["1M sparse hash"], device=dev)
    lo, coords = tiles_bin(sp.pos, 2.0, 56)
    cell = torch.full((), 2.0, device=dev)
    out.append(("1M sparse hash",
                build_sorted_grid(sp.pos, sp.mass, coords, 56), lo, cell, 56,
                16))
    return out


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
    for label, g, lo, cell, d, k in shapes(dev):
        n, nc = g.psort.shape[0], d ** 3
        a = (g.psort, g.cell_start, lo, cell)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        ex = torch.randn(n, 3, generator=gen, device=dev)
        tk, mk = tile_scatter(*a, d=d, k=k)
        tt, mt, ct, xt = tile_scatter(*a, d=d, k=k, with_coverage=True,
                                      extra=ex)
        src, dest, _, table = mover_set(tt, ct, xt, mt[10], d, k,
                                        REPAIR_CAP, gen)
        moved = table()
        tp = (T.bh_table_params(levels=6, near_k=k) if d == 64 else
              T.hash_table_params(cutoff=2.0, cell_size=2.0, d=d, k=k))
        vel = xt * 20.0
        acc = torch.randn(vel.shape, generator=gen, device=dev) * ct
        raw, vh = torch.randn_like(vel), vel.clone()
        forms = {
            "main form": lambda: tile_scatter(*a, d=d, k=k),
            "coverage + 3 extra": lambda: tile_scatter(
                *a, d=d, k=k, with_coverage=True, extra=ex),
            f"dest form, {REPAIR_CAP} movers": lambda: tile_place(
                *moved, src, dest, lo, cell, d=d, k=k),
            "table_drift with the audit": lambda: T.table_drift(
                tt, vel, acc, ct, lo, cell, 1e-3, tp, True),
            "table_kick": lambda: T.table_kick(raw, ct, vh, 1.0, 1e-3),
        }
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
                d, k, torch._C._cuda_getCurrentRawStream(dev.index or 0))
            if err != 0:
                sys.exit(f"baseline K2: CUDA error {err}")
            return tiles, mom

        to, mo = old()
        same = torch.equal(to, tk) and torch.equal(mo, mk)
        print(f"K2 {label}: baseline and today's main form bit-equal: "
              f"{same}", flush=True)
        if not same:
            sys.exit(f"K2 {label}: baseline and today's main form differ")
        ab(f"K2 {label} main form", "baseline", old, "today",
           forms["main form"], smi)


if __name__ == "__main__":
    main()
