#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nbody_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card and nvcc:

  1. prints the card (nvidia-smi name and power limit) and builds the
     hand-written kernels from ``nbody_tpu_torch/csrc`` (build time shown);
  2. at the main path's shapes — the 1M-particle spherical scene (radius 10,
     seed 42), Barnes-Hut θ = 0.5 at d = 64, k = 16, ws = 1 — holds every
     kernel against its plain PyTorch twin on the same inputs, with the
     tolerance stated beside it, and times both (median of 7 calls after
     warm-up, CUDA events);
  3. drives the main path through the facade: ``ParticleSystem.initialize``
     with the benchmark config, ``run_steps(30)`` warm, ``reset()``, then
     ``run_steps(30)`` timed; prints steps/s, the per-phase device-time
     breakdown and the launch counts, and checks that every kernel of the
     path launched the expected number of times and no plain twin ran;
  4. checks positions and velocities are finite;
  5. holds the step-0 Barnes-Hut forces against the direct kernel over a
     4096-row sample with all 1M sources (median relative error < 0.05).

It stops at the first failed check with a non-zero exit. It needs one CUDA
card and exits non-zero without one. The last two lines of its output are
the kernels' JSON record and the device JSON line.
"""

import json
import statistics
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def time_ms(fn, reps: int = 7, warm: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_checks(pos, mass, cfg):
    """Phase 2: each kernel against its plain twin at main-path shapes.
    Returns {name: {max_abs_err, ms, plain_ms}} and the step-0 overflow."""
    import torch

    from nbody_tpu_torch.ops.barnes_hut import (
        bh_engine_params,
        bin_particles,
        far_field_grid,
        level_moments,
        level_tap_matrices,
        pyramid_from_packed,
    )
    from nbody_tpu_torch.ops.direct import direct_forces, direct_forces_kernel
    from nbody_tpu_torch.ops.far_taps import far_taps, far_taps_plain
    from nbody_tpu_torch.ops.scatter import tile_scatter, tile_scatter_plain
    from nbody_tpu_torch.ops.sorted_window import build_sorted_grid
    from nbody_tpu_torch.ops.tile_near import (
        tile_sweep_plane,
        tile_sweep_plane_plain,
    )

    p = bh_engine_params(cfg)
    levels, k, ws = p["levels"], p["near_k"], p["ws"]
    d = 1 << levels
    eps, G = cfg.softening, cfg.G
    print(f"main path: N={pos.shape[0]} levels={levels} d={d} k={k} ws={ws} "
          f"near_engine={p['near_engine']}")
    lo, cell, coords = bin_particles(pos, levels)
    grid = build_sorted_grid(pos, mass, coords, d)
    res = {}

    # K2: placement + moments + counts
    args = (grid.psort, grid.cell_start, lo, cell)
    tk, mk = tile_scatter(*args, d=d, k=k)
    tp, mp = tile_scatter_plain(*args, d=d, k=k)
    counts = mp[10]
    check(torch.equal(mk[10], counts), "K2 counts differ from plain")
    live = (torch.arange(k, device=pos.device)[:, None]
            < counts.reshape(1, -1)).reshape(k, d, d * d).permute(1, 0, 2)
    live = live[:, None].expand(d, 4, k, d * d)
    check(torch.equal(tk[live], tp[live]), "K2 placed slots not bit-equal")
    cube = float(cell) * d
    fill_err = float((tk[~live] - tp[~live]).abs().max())
    check(fill_err <= 1e-6 * cube, f"K2 filler centres off by {fill_err}")
    mom_err = (mk - mp).abs()
    mom_tol = 1e-5 * mp.abs() + 1e-6 * mp.abs().amax(dim=1, keepdim=True)
    check(bool((mom_err <= mom_tol).all()),
          f"K2 moments differ by {float(mom_err.max())}")
    err = max(fill_err, float(mom_err.max()))
    overflow = int(torch.clamp(counts - k, min=0).sum())
    print(f"K2 tile_scatter: placed slots bit-equal, filler max|diff| "
          f"{fill_err:.3e} (tol 1e-6*cube = {1e-6 * cube:.3e}), moments max"
          f"|diff| {float(mom_err.max()):.3e} (tol 1e-5*|x| + 1e-6*max|ch|),"
          f" counts equal; step-0 overflow {overflow} rows")
    res["tile_scatter"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: tile_scatter(*args, d=d, k=k)),
        plain_ms=time_ms(lambda: tile_scatter_plain(*args, d=d, k=k)),
    )

    # K3: far taps at the two finest levels (p = 16, 32)
    pyr = pyramid_from_packed(mk[:10].T.reshape(d, d, d, 10), lo, cell,
                              levels)
    k3_err = 0.0
    for lvl in (levels - 1, levels):
        pp = (1 << lvl) // 2
        mom = level_moments(pyr, lvl)
        taps = level_tap_matrices(cell, ws, eps, levels, [lvl])[0].contiguous()
        ok_, op_ = far_taps(mom, taps, p=pp, ws=ws), far_taps_plain(
            mom, taps, p=pp, ws=ws)
        e = float((ok_ - op_).abs().max())
        tol = 2e-5 * float(op_.abs().max())
        check(e <= tol, f"K3 far_taps p={pp} max|diff| {e} > {tol}")
        k3_err = max(k3_err, e)
        ms = time_ms(lambda: far_taps(mom, taps, p=pp, ws=ws))
        pms = time_ms(lambda: far_taps_plain(mom, taps, p=pp, ws=ws))
        print(f"K3 far_taps p={pp}: max|diff| {e:.3e} (tol 2e-5*max|out| = "
              f"{tol:.3e}); kernel {ms:.4f} ms, plain {pms:.4f} ms")
    res["far_taps"] = dict(max_abs_err=k3_err, ms=ms, plain_ms=pms)

    # K4: near sweep seeded with the far expansion
    a_f, j_f, h_f = far_field_grid(pyr, ws, 1.0, eps, levels)
    far_plane = (torch.cat([a_f, j_f, h_f], dim=-1).reshape(d, d * d, 19)
                 .permute(0, 2, 1).contiguous())
    kw = dict(k=k, d=d, ws=ws, eps=eps, far_plane=far_plane, lo=lo,
              cell=cell, counts=counts)
    ok_ = tile_sweep_plane(tk, **kw)
    op_ = tile_sweep_plane_plain(tk, **kw)
    e = float((ok_ - op_).abs().max())
    tol = 2e-5 * float(op_.abs().max())
    check(e <= tol, f"K4 tile_sweep_plane max|diff| {e} > {tol}")
    print(f"K4 tile_sweep_plane: max|diff| {e:.3e} (tol 2e-5*max|out| = "
          f"{tol:.3e}; dead slots are 0 in both)")
    res["tile_sweep_plane"] = dict(
        max_abs_err=e,
        ms=time_ms(lambda: tile_sweep_plane(tk, **kw)),
        plain_ms=time_ms(lambda: tile_sweep_plane_plain(tk, **kw), reps=5,
                         warm=1),
    )

    # K1: direct forces at N = 16384
    n1 = 16384
    p1, m1 = pos[:n1].contiguous(), mass[:n1].contiguous()
    ok_ = direct_forces_kernel(p1, m1, G, eps)
    op_ = direct_forces(p1, m1, G, eps)
    e = float((ok_ - op_).abs().max())
    tol = 1e-5 * float(op_.abs().max())
    check(e <= tol, f"K1 direct max|diff| {e} > {tol}")
    print(f"K1 direct_forces N={n1}: max|diff| {e:.3e} (tol 1e-5*max|a| = "
          f"{tol:.3e})")
    res["direct_forces"] = dict(
        max_abs_err=e,
        ms=time_ms(lambda: direct_forces_kernel(p1, m1, G, eps)),
        plain_ms=time_ms(lambda: direct_forces(p1, m1, G, eps)),
    )
    for name, r in res.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    return res, overflow


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    try:
        import nbody_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import nbody_tpu_torch ({e}): run from a checkout")
    from nbody_tpu_torch import ParticleSystem, SimulationConfig
    from nbody_tpu_torch.models.distributions import init_spherical
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops.barnes_hut import bh_engine_params
    from nbody_tpu_torch.ops.direct import direct_forces, direct_forces_kernel
    from nbody_tpu_torch.ops.far_taps import far_taps, far_taps_plain
    from nbody_tpu_torch.ops.forces import make_force_fn
    from nbody_tpu_torch.ops.scatter import tile_scatter, tile_scatter_plain
    from nbody_tpu_torch.ops.tile_near import (
        tile_sweep_plane,
        tile_sweep_plane_plain,
    )
    from nbody_tpu_torch.types import ForceMethod, SphericalDistParams
    from nbody_tpu_torch.utils.profiling import consume_global_phase_snapshot

    # Every matmul on the card in FP32 (the plain far-taps twin).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"nvidia-smi: {smi.stdout.strip().splitlines()[0]}")
    dev = torch.device("cuda", 0)
    print(f"torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.last_build['seconds']:.2f} s, "
          f"built={_build.last_build['built']})")
    for line in _build.last_build["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    n = 1_000_000
    cfg = SimulationConfig(particle_count=n,
                           force_method=ForceMethod.BARNES_HUT,
                           bh_max_level=6, dt=1e-3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    scene = init_spherical(gen, n, SphericalDistParams(radius=10.0),
                           device=dev)
    pos0, mass0 = scene.pos, scene.mass

    res, overflow = kernel_checks(pos0, mass0, cfg)

    # Phase 3: the main path through the facade.
    wrappers = {
        "direct_forces": direct_forces_kernel,
        "tile_scatter": tile_scatter,
        "far_taps": far_taps,
        "tile_sweep_plane": tile_sweep_plane,
    }
    plains = [direct_forces, tile_scatter_plain, far_taps_plain,
              tile_sweep_plane_plain]
    steps = 30
    ps = ParticleSystem()
    ps.initialize(cfg, device=dev)
    ps.run_steps(steps)
    ps.synchronize()
    ps.reset()
    ps.synchronize()
    for f in wrappers.values():
        f.launches = 0
    for f in plains:
        f.calls = 0
    consume_global_phase_snapshot()
    t0 = time.perf_counter()
    ps.run_steps(steps)
    ps.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: f.launches for name, f in wrappers.items()}
    phases = consume_global_phase_snapshot()
    print(f"main path: {steps} steps in {wall:.4f} s = "
          f"{steps / wall:.3f} steps/s (1M BH, {smi.stdout.strip()})")
    for name, st in sorted(phases.items()):
        print(f"  phase {name}: {st.total_ms / steps:.4f} ms/step "
              f"({st.samples} samples)")
    print(f"  launches: {launches}")
    levels = bh_engine_params(cfg)["levels"]
    want = {"tile_scatter": steps, "far_taps": steps * levels,
            "tile_sweep_plane": steps, "direct_forces": 0}
    check(launches == want, f"launch counts {launches} != expected {want}")
    check(all(f.calls == 0 for f in plains),
          "a plain twin ran on the main path")

    # Phase 4
    st = ps.state
    check(bool(torch.isfinite(st.pos).all()), "non-finite positions")
    check(bool(torch.isfinite(st.vel).all()), "non-finite velocities")
    check(abs(ps.simulation_time - steps * cfg.dt) < 1e-6,
          "simulation time did not advance")
    print(f"state after {steps} steps: finite, t = {ps.simulation_time:.6f}")

    # Phase 5: BH at step 0 against the direct kernel (ground truth).
    acc_bh = make_force_fn(cfg)(pos0, mass0)
    sgen = torch.Generator(device=dev)
    sgen.manual_seed(0)
    idx = torch.randperm(n, generator=sgen, device=dev)[:4096]
    acc_dir = direct_forces_kernel(pos0, mass0, cfg.G, cfg.softening,
                                   targets=pos0[idx].contiguous())
    rel = ((acc_bh[idx] - acc_dir).norm(dim=1)
           / acc_dir.norm(dim=1).clamp(min=1e-30))
    med = float(rel.median())
    print(f"BH vs direct (4096 sampled rows, all {n} sources): median rel "
          f"err {med:.4e}, p90 {float(rel.quantile(0.9)):.4e}, max "
          f"{float(rel.max()):.4e} (gate: median < 0.05)")
    check(med < 0.05, f"BH median relative error {med} >= 0.05")

    sources = {
        "direct_forces": ("nbody_tpu_torch/csrc/direct.cu",
                          "nbody_tpu/ops/direct.py:157"),
        "tile_scatter": ("nbody_tpu_torch/csrc/scatter.cu",
                         "nbody_tpu/ops/pallas_scatter.py:605"),
        "far_taps": ("nbody_tpu_torch/csrc/far_taps.cu",
                     "nbody_tpu/ops/pallas_far_taps.py:143"),
        "tile_sweep_plane": ("nbody_tpu_torch/csrc/tile_near.cu",
                             "nbody_tpu/ops/pallas_tile_near.py:473"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **res[name]}
        for name, (src, rep) in sources.items()
    ]
    print(f"step-0 overflow rows: {overflow}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
