#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nbody_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card and nvcc:

  1. prints the card (nvidia-smi name and power limit) and builds the
     hand-written kernels from ``nbody_tpu_torch/csrc`` (one nvcc per
     source, all in parallel; build time shown);
  2. holds every kernel against its plain PyTorch twin on the same inputs
     at the shapes its path gives it, with the tolerance stated beside it,
     and times both (median of 7 calls after warm-up, CUDA events): K1
     (direct forces) at N = 16384, on the 100K direct path's own scene and
     at the Barnes-Hut accuracy gates' 4096 sampled targets against all 1M
     rows, two calls bit-equal, with its device time by graph replay; K2
     and K3 at the Barnes-Hut tiles main path (the 1M spherical scene,
     radius 10, seed 42, θ = 0.5 at d = 64, k = 16, ws = 1); K4 at the
     three 1M shapes that run it (BH tiles with the 19-channel far plane,
     the monopole path at ws = 2 with none, the sparse hash with cutoff² 4
     at d = 56, k = 16; ``k4_inputs``), two calls bit-equal, with its
     device time by graph replay; K2 at the 1M sparse hash (uniform cube,
     cell 2.0, d = 56, k = 16); K2's two table forms at both 1M shapes
     (``k2_table_checks``: the rank form with coverage and 3 extra
     channels, and ``tile_place``, the dest form, moving a repair-sized
     set of 32768 rows inside that table; coverage and extra planes and
     placed slots bit-equal to the twins) and the table step's
     ``table_drift`` (with the audit) and ``table_kick`` on that table, bit
     for bit, K7 (the
     window sweep) at the 1M dense hash (cap 64, W 2048, B 256, cutoff
     2.0) and the 1M Barnes-Hut window engine (d = 32, W 2048, B 256,
     ws = 1), K5 (the all-pairs potential) on the drift gate's own 1M
     input (the twin run once) and at N = 131072 on the scene's first
     rows (kernel: median of 3 after 1 warm-up), K6 (the segment sum) at
     the monopole path's (1M, 4) → (4, 262144), K8 (the bitonic sort) on
     the sort benchmark's 1M keys below 2^18 (numpy seed 0), on the 1M
     Barnes-Hut scene's finest cell ids (d = 64) and at n = 1000, 2^11 + 1
     and 2^17 + 3 (keys and values bit for bit, and the kernels of one
     sort counted in a captured CUDA graph against ``launch_plan``;
     ``torch.sort`` is its library yardstick); K3 at p = 32 and 16 (two calls bit-equal too,
     ``conv3d`` with TF32 off its yardstick at both) and timed at every
     level of a step, with their sum; then frozen(fresh meta) against the
     sorted step, bit for bit, at 1M for Barnes-Hut tiles and the sparse
     hash, and each audit against a host recount after a move;
     prints each kernel's bound (the larger of its operations over their
     peak rate and its bytes over 3.35 TB/s, counted from this run's
     inputs: FP32 operations at 67 TFLOP/s, but K3's multiply-adds as three
     TF32 tensor-core products at 495 TFLOP/s, its FP32-pipe bound printed
     beside it; for K7 the pairs of each target's 27-cell ball, with a
     model of its pair tests and its warps' lane slots from
     ``window_spans`` printed beside them) and, where one PyTorch call
     computes the same function, that call's time; K1, K4, K6 and K7 also
     give bit-equal output over two calls, and their device time per call
     (CUDA graph replay) is printed beside;
  3. drives the paths, each with every launch count set to 0 just before
     it and read just after, checking that the path's kernels launched as
     expected and that no plain twin ran. These go through the facade
     (``path_configs``): ``initialize``, ``run_steps`` warm, ``reset()``,
     ``run_steps`` timed:
       a. 1M Barnes-Hut, tiles engine (bh_max_level 6): 30 steps;
       b. 1M dense spatial hash (the spherical scene, cell 1.0, cutoff 2.0,
          "auto" → window engine): 30 steps;
       c. 1M sparse spatial hash (uniform cube of side 100, cell 2.0,
          "auto" → tiles engine, d 56, k 16): 30 steps;
       d. 1M Barnes-Hut, window engine (bh_max_level 5): 10 steps;
       e. 100K direct N² (the spherical scene): 10 steps;
       g-j, and their mirrors: the frozen-grid knobs on the two tiles
          scenes, 30 steps each: g. the 1M sparse hash with
          ``resort_every=8``; h. 1M Barnes-Hut tiles with
          ``resort_stale_frac=0.01``; i. the 1M sparse hash with
          ``resort_repair``; j. 1M Barnes-Hut tiles with
          ``resort_repair``; then the sparse hash with
          ``resort_stale_frac=0.01`` and Barnes-Hut tiles with
          ``resort_every=8``. Each runs through the facade (table-resident
          stepping, ``ops/table_step.py``, where ``system.TABLE_ROUTES``
          holds the engine and knob, else the row-space driver), then the
          other driver of the same knob is called directly from the same
          state, launches counted for both (the table drivers: K2's rank
          form on sorted steps only, its dest form on repair steps with
          movers, K4 and ``table_kick`` every step, ``table_drift`` every
          step after the first); the two are held to each other (the
          cadence, and the audited re-sort against the row-space steps on
          the table's schedule, within 1e-6 of max|pos| and max|v| on the
          hash and 1e-5 on Barnes-Hut, whose frozen table steps sum the
          moments in another order; repair against sorting every step
          within 1e-4·max|pos|, the JAX package's bound), the traces printed (stale counts,
          re-sorts, rebuilds), and the two timed in turns; on h also the
          row-space audited re-sort's trace and the cost of its host read
          of the audit count;
     f. 1M Barnes-Hut monopole (the tiles scene with
     ``multipole_order=1``: ws 2, K6 moments, no far taps), which the
     facade never selects: ``barnes_hut_forces_sorted(multipole_order=1)``
     under ``make_sorted_multi_step``, 10 steps warm, then 10 timed from
     the initial state; and the sort benchmark (K8 through
     ``bitonic_argsort`` on its two 1M inputs, the path of
     ``scripts/profile_sort_torch.py``). Each prints steps/s beside the
     card, the phase times and the launches, and checks the state is
     finite;
  4. ground truth at step 0: Barnes-Hut (both engines and the monopole
     path) against the direct kernel over 4096 sampled rows and all 1M
     sources (median relative error < 0.05); the hash (both engines)
     against a float64 brute force over 4096 sampled rows and all 1M
     sources with the same 27-cell and raw-r² cutoff predicate (max |diff|
     ≤ 1e-4·max|a|);
  5. the energy-drift gate, cut to 300 steps: ``run_drift(1_000_000, 300,
     100)`` (``nbody_tpu_torch.drift``, the loop of
     ``scripts/measure_drift_torch.py``), printing E at every checkpoint
     and |ΔE/E| beside the 1e-4 target (the pass flag is printed, not
     enforced), checking every E is finite and K5 launched once per
     checkpoint.

It stops at the first failed check with a non-zero exit. It needs one CUDA
card and exits non-zero without one. The last two lines of its output are
the kernels' JSON record (per kernel: its numbers at its first shape, each
shape's under ``shapes``, the launches summed over the timed paths and
each path's own under ``launches_by_path``) and the device JSON line.
"""

import json
import statistics
import subprocess
import sys
import time

N = 1_000_000
FP32_OPS = 67e12   # H100 SXM FP32 outside the tensor cores, op/s
TF32_OPS = 495e12  # H100 SXM TF32 on the tensor cores, dense, op/s
HBM_BYTES = 3.35e12  # H100 SXM HBM3, byte/s
PAIR_OPS = 20      # FP32 operations of one softened pair test


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


def graph_kernels(fn) -> int:
    """The kernels one call of ``fn`` queues: the kernel nodes of a CUDA
    graph captured from a call after a warm one, counted through the
    driver API. (torch.profiler loses kernel records in a long process:
    on the H100 machine its count of one 1M sort fell by one kernel every
    ~15 s of process time, padding the trace window or not.)"""
    import ctypes

    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0,
          "cuGraphGetNodes failed")
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    del graph
    return kernels


def graph_ms(fn, reps: int = 10) -> float:
    """Device time (ms) of one call of ``fn`` with no host in it: ``reps``
    calls captured in one CUDA graph, the replay timed with CUDA events
    (median of 5 replays) and divided by ``reps``."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(times)


def bound(ops: float, nbytes: float, rate: float = FP32_OPS) -> dict:
    """The least time the card could take: the larger of the operations
    over their peak rate (FP32 outside the tensor cores unless given) and
    the bytes over the memory rate."""
    t_ops, t_bytes = ops / rate * 1e3, nbytes / HBM_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def path_configs() -> dict:
    """The paths this script drives and ``scripts/profile_torch_paths.py``
    profiles, as ``{label: SimulationConfig}``: the scenes ``bench.py``
    builds for each method at full width and scale."""
    from nbody_tpu_torch import SimulationConfig
    from nbody_tpu_torch.types import (
        ForceMethod,
        InitDistribution,
        UniformDistParams,
    )

    bh = SimulationConfig(particle_count=N, force_method=ForceMethod.BARNES_HUT,
                          bh_max_level=6, dt=1e-3)
    hash_ = SimulationConfig(particle_count=N,
                             force_method=ForceMethod.SPATIAL_HASH, dt=1e-3)
    half = max(10.0, N ** (1.0 / 3.0)) / 2.0
    sparse = hash_.replace(
        spatial_hash_cell_size=2.0,
        init_distribution=InitDistribution.UNIFORM,
        dist_params=UniformDistParams(min_bounds=(-half,) * 3,
                                      max_bounds=(half,) * 3))
    return {
        "1M BH tiles": bh,
        "1M dense hash": hash_,
        "1M sparse hash": sparse,
        "1M BH window": bh.replace(bh_max_level=5),
        "100K direct": SimulationConfig(
            particle_count=N // 10, force_method=ForceMethod.DIRECT_N2,
            dt=1e-3),
        SPARSE_RESORT: sparse.replace(resort_every=8),
        BH_ADAPTIVE: bh.replace(resort_stale_frac=0.01),
        SPARSE_REPAIR: sparse.replace(resort_repair=True),
        BH_REPAIR: bh.replace(resort_repair=True),
        SPARSE_ADAPTIVE: sparse.replace(resort_stale_frac=0.01),
        BH_RESORT: bh.replace(resort_every=8),
    }


MONOPOLE = "1M BH monopole"
SPARSE_RESORT = "1M sparse hash, resort_every 8"
BH_ADAPTIVE = "1M BH tiles, resort_stale_frac 0.01"
SPARSE_REPAIR = "1M sparse hash, resort_repair"
BH_REPAIR = "1M BH tiles, resort_repair"
SPARSE_ADAPTIVE = "1M sparse hash, resort_stale_frac 0.01"
BH_RESORT = "1M BH tiles, resort_every 8"
# the frozen-grid paths: (label, engine mode) in the order they run
FROZEN_PATHS = ((SPARSE_RESORT, "hash"), (BH_ADAPTIVE, "bh"),
                (SPARSE_REPAIR, "hash"), (BH_REPAIR, "bh"),
                (SPARSE_ADAPTIVE, "hash"), (BH_RESORT, "bh"))
REPAIR_CAP = 32768  # make_table_repair_multi_step's default mover cap
SORT_PATH = "1M sort benchmark"


def monopole_forces(cfg):
    """``(force_fn, sorted_force_fn)`` of the monopole path on ``cfg``'s
    scene: ``barnes_hut_forces(_sorted)(..., multipole_order=1)`` at the
    config's levels and k (ws = ceil(1/θ) = 2 at θ = 0.5)."""
    from nbody_tpu_torch.ops.barnes_hut import (
        barnes_hut_forces,
        barnes_hut_forces_sorted,
        bh_engine_params,
    )

    p = bh_engine_params(cfg)
    args = (cfg.G, cfg.softening, cfg.barnes_hut_theta)
    kw = dict(levels=p["levels"], near_k=p["near_k"], multipole_order=1)
    return (lambda pos, mass: barnes_hut_forces(pos, mass, *args, **kw),
            lambda pos, mass: barnes_hut_forces_sorted(pos, mass, *args,
                                                       **kw))


def add_shape(res: dict, name: str, label: str, rec: dict) -> None:
    """Record one kernel's numbers at one path's shapes: the first shape
    recorded gives the kernel's top-level keys, every shape is kept under
    ``shapes``."""
    if name not in res:
        res[name] = dict(rec, shape=label, shapes={})
    res[name]["shapes"][label] = rec


def k2_check(res, label, grid, lo, cell, *, d, k):
    """K2 against its plain twin → (tiles, moments, step-0 overflow)."""
    import torch

    from nbody_tpu_torch.ops.scatter import tile_scatter, tile_scatter_plain

    n = grid.psort.shape[0]
    args = (grid.psort, grid.cell_start, lo, cell)
    tk, mk = tile_scatter(*args, d=d, k=k)
    tp, mp = tile_scatter_plain(*args, d=d, k=k)
    counts = mp[10]
    check(torch.equal(mk[10], counts), f"K2 {label}: counts differ from plain")
    live = (torch.arange(k, device=counts.device)[:, None]
            < counts.reshape(1, -1)).reshape(k, d, d * d).permute(1, 0, 2)
    live = live[:, None].expand(d, 4, k, d * d)
    check(torch.equal(tk[live], tp[live]),
          f"K2 {label}: placed slots not bit-equal")
    cube = float(cell) * d
    fill_err = float((tk[~live] - tp[~live]).abs().max())
    check(fill_err <= 1e-6 * cube,
          f"K2 {label}: filler centres off by {fill_err}")
    mom_err = (mk - mp).abs()
    mom_tol = 1e-5 * mp.abs() + 1e-6 * mp.abs().amax(dim=1, keepdim=True)
    check(bool((mom_err <= mom_tol).all()),
          f"K2 {label}: moments differ by {float(mom_err.max())}")
    overflow = int(torch.clamp(counts - k, min=0).sum())
    nc = d ** 3
    rec = dict(
        max_abs_err=max(fill_err, float(mom_err.max())),
        ms=time_ms(lambda: tile_scatter(*args, d=d, k=k)),
        plain_ms=time_ms(lambda: tile_scatter_plain(*args, d=d, k=k)),
        # psort in, cell_start in, tiles + moments out; ~20 ops per row
        **bound(20 * n, 16 * n + 4 * (nc + 1) + 16 * k * nc + 44 * nc),
        library_ms=None,
    )
    add_shape(res, "tile_scatter", label, rec)
    print(f"K2 tile_scatter {label} (d={d}, k={k}): placed slots bit-equal, "
          f"filler max|diff| {fill_err:.3e} (tol 1e-6*cube = "
          f"{1e-6 * cube:.3e}), moments max|diff| {float(mom_err.max()):.3e}"
          f" (tol 1e-5*|x| + 1e-6*max|ch|), counts equal; step-0 overflow "
          f"{overflow} rows; kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})")
    return tk, mk, overflow


def mover_set(tiles, cov, ext, counts, d, k, m, gen):
    """A repair-sized move on a fresh table (K2's table form: ``tiles``,
    ``cov``, ``ext``, per-cell ``counts``): ``m`` occupied slots (plane
    order), each sent one cell up in x (clamped) and ranked above the
    target's high-water mark, as ``table_step._repair_step`` places movers,
    so arrivals to full cells are denied → (src, dest, fits, table), where
    ``table()`` gives a fresh copy of the table with its liveness and a row
    bookkeeping of its occupied slots: ``tile_place``'s in-place
    arguments."""
    import torch

    from nbody_tpu_torch.ops.scatter import SENTINEL_DEST
    from nbody_tpu_torch.ops.sorted_window import sorted_ranks

    dev, d2, nc = cov.device, d * d, d ** 3
    occ = torch.nonzero(cov.reshape(-1))[:, 0]                # plane order
    src = occ[torch.randperm(occ.numel(), generator=gen, device=dev)[:m]]
    tgt = torch.clamp((src // (k * d2)) * d2 + src % d2 + d2,
                      max=nc - 1).to(torch.int32)
    ordm = torch.argsort(tgt, stable=True)
    src, tgt = src[ordm].to(torch.int32), tgt[ordm]
    slot = torch.clamp(counts, max=k).to(torch.int32)[tgt.long()] + (
        sorted_ranks(tgt))
    fits = slot < k
    dest = torch.where(fits, tgt * k + slot, SENTINEL_DEST).to(torch.int32)
    ids = ((occ // (k * d2)) * d2 + occ % d2) * k + (occ // d2) % k
    slot_row = torch.full((nc * k,), -1, dtype=torch.int32, device=dev)
    slot_row[ids] = torch.arange(occ.numel(), dtype=torch.int32, device=dev)

    def table():
        return (tiles.clone(), cov.clone(), ext.clone(),
                torch.clamp(counts, max=k), slot_row.clone(),
                ids.to(torch.int32))

    return src, dest, fits, table


def k2_table_checks(res, label, grid, lo, cell, tp):
    """K2's two table forms and the table step's two passes against their
    twins at a path's 1M shape (``tp`` its table parameters): the rank form
    with coverage and the 3 velocity channels (as ``table_step._sort_build``
    places them; N(0, 1) here); the dest form on a repair-sized mover set
    (``REPAIR_CAP`` rows each sent one cell up in x and ranked above the
    target's high-water mark, as ``table_step._repair_step`` places them,
    so arrivals to full cells are denied), moved inside that table with
    its row bookkeeping and high-water marks; then ``table_drift`` with the
    audit (velocities 20·N(0, 1), so a few percent of rows change cell)
    and ``table_kick`` on that table. Coverage and extra planes bit-equal,
    placed slots bit-equal, filler centres within 1e-6·cube; moments as
    ``k2_check``; the drift (tables, mover ids, stale count) and the kick
    bit for bit."""
    import torch

    from nbody_tpu_torch.ops import table_step as T
    from nbody_tpu_torch.ops.scatter import (
        tile_place,
        tile_place_plain,
        tile_scatter,
        tile_scatter_plain,
    )

    d, k = tp.d, tp.k
    n, nc = grid.psort.shape[0], d ** 3
    dev = grid.psort.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ex = torch.randn(n, 3, generator=gen, device=dev)
    args = (grid.psort, grid.cell_start, lo, cell)
    kw = dict(d=d, k=k, with_coverage=True, extra=ex)
    tk, mk, ck, xk = tile_scatter(*args, **kw)
    tp_, mp, cp, xp = tile_scatter_plain(*args, **kw)
    cube = float(cell) * d

    def slots(got, want, cov, what):
        placed = (cov[:, 0] > 0)[:, None].expand_as(got)
        check(torch.equal(got[placed], want[placed]),
              f"{what}: placed slots not bit-equal")
        err = float((got[~placed] - want[~placed]).abs().max())
        check(err <= 1e-6 * cube, f"{what}: filler centres off by {err}")
        return err

    what = f"K2 tile_scatter {label}, coverage + 3 extra"
    check(torch.equal(ck, cp) and torch.equal(xk, xp),
          f"{what}: coverage or extra planes differ from plain")
    check(torch.equal(mk[10], mp[10]), f"{what}: counts differ from plain")
    mom_err = (mk - mp).abs()
    mom_tol = 1e-5 * mp.abs() + 1e-6 * mp.abs().amax(dim=1, keepdim=True)
    check(bool((mom_err <= mom_tol).all()),
          f"{what}: moments differ by {float(mom_err.max())}")
    fill = slots(tk, tp_, ck, what)
    rec = dict(
        max_abs_err=max(fill, float(mom_err.max())),
        ms=time_ms(lambda: tile_scatter(*args, **kw)),
        plain_ms=time_ms(lambda: tile_scatter_plain(*args, **kw)),
        # psort + extra + cell_start in; tiles, cov, extra planes and
        # moments out; ~20 ops per row
        **bound(20 * n, 16 * n + 12 * n + 4 * (nc + 1)
                + (4 + 1 + 3) * 4 * k * nc + 44 * nc),
        library_ms=None,
    )
    add_shape(res, "tile_scatter", f"{label}, coverage + 3 extra", rec)
    print(f"{what} (d={d}, k={k}): placed slots, coverage and extra planes "
          f"bit-equal to plain, filler max|diff| {fill:.3e}, moments "
          f"max|diff| {float(mom_err.max()):.3e}; kernel {rec['ms']:.4f} "
          f"ms, plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} "
          f"ms ({rec['bound_by']})")

    # the dest form: REPAIR_CAP occupied slots moved one cell up in x
    m = REPAIR_CAP
    src, dest, fits, table = mover_set(tk, ck, xk, mk[10], d, k, m, gen)
    pargs = (src, dest, lo, cell)
    got, want = table(), table()
    tile_place(*got, *pargs, d=d, k=k)
    tile_place_plain(*want, *pargs, d=d, k=k)
    what = f"K2 tile_place {label}, {m} movers"
    check(all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])),
          f"{what}: coverage, extra planes, high-water marks or "
          "bookkeeping differ from plain")
    placed = int(fits.sum())
    check(int(got[1].sum()) == int(ck.sum()),
          f"{what}: {int(got[1].sum())} occupied after the moves")
    fill = slots(got[0], want[0], got[1], what)
    # each timed call moves a fresh copy's rows (the copy is not timed)
    fresh = [table() for _ in range(9)]
    fresh_p = [table() for _ in range(9)]
    rec = dict(
        max_abs_err=fill,
        ms=time_ms(lambda: tile_place(*fresh.pop(), *pargs, d=d, k=k)),
        plain_ms=time_ms(lambda: tile_place_plain(*fresh_p.pop(), *pargs,
                                                  d=d, k=k)),
        # src + dest in; a moved row's slot read (4 + 1 + 3 floats), its
        # new and old slot written, 3 bookkeeping ints, the k cov values
        # of its two cells read and their live counts written
        **bound(0, 8 * m + placed * (32 * 3 + 12 + 2 * (4 * k + 4))),
        library_ms=None,
    )
    add_shape(res, "tile_place", f"{label}, {m} movers", rec)
    print(f"{what} (d={d}, k={k}; {placed} moved, {m - placed} denied): "
          f"placed slots, coverage, extra planes, high-water marks and "
          f"bookkeeping equal to plain, filler max|diff| {fill:.3e}; kernel "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")

    # the table step's passes on this table
    vel = xk * 20.0
    acc = torch.randn(vel.shape, generator=gen, device=dev) * ck
    dargs = (tk, vel, acc, ck, lo, cell, 1e-3, tp, True)
    dk = T.table_drift(*dargs)
    dp = T.table_drift_plain(*dargs)
    what = f"table_drift {label}"
    check(all(torch.equal(a, b) for a, b in zip(dk, dp)),
          f"{what}: not bit-equal to plain")
    slots_n = nc * k
    rec = dict(
        max_abs_err=0.0, ms=time_ms(lambda: T.table_drift(*dargs)),
        plain_ms=time_ms(lambda: T.table_drift_plain(*dargs)),
        # pos 4 + vel 3 + acc 3 + cov 1 floats in; pos 4 + vel 3 + mover 1
        # out, a slot each; ~40 ops a slot
        **bound(40 * slots_n, (11 + 8) * 4 * slots_n), library_ms=None,
    )
    add_shape(res, "table_drift", label, rec)
    print(f"{what} (d={d}, k={k}, audit): tables, mover ids and stale count "
          f"{int(dk[3])} bit-equal to plain; kernel {rec['ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})")
    raw = torch.randn(vel.shape, generator=gen, device=dev)
    ka = T.table_kick(raw.clone(), ck, dk[1].clone(), 1.0, 1e-3)
    kb = T.table_kick_plain(raw.clone(), ck, dk[1].clone(), 1.0, 1e-3)
    what = f"table_kick {label}"
    check(torch.equal(ka[0], kb[0]) and torch.equal(ka[1], kb[1]),
          f"{what}: not bit-equal to plain")
    bufs = (raw.clone(), dk[1].clone())
    rec = dict(
        max_abs_err=0.0,
        # in place: each timed call kicks the same buffers once more
        ms=time_ms(lambda: T.table_kick(bufs[0], ck, bufs[1], 1.0, 1e-3)),
        plain_ms=time_ms(lambda: T.table_kick_plain(bufs[0], ck, bufs[1],
                                                    1.0, 1e-3)),
        # raw 3 + cov 1 + vel 3 in, acc 3 + vel 3 out; 12 ops a slot
        **bound(12 * slots_n, (7 + 6) * 4 * slots_n), library_ms=None,
    )
    add_shape(res, "table_kick", label, rec)
    print(f"{what} (d={d}, k={k}): bit-equal to plain; kernel "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")


def k4_inputs(pos, mass, cfg, sp_pos, sp_mass):
    """K4's inputs at the three 1M shapes that run it, as
    ``[(label, tiles, tile_sweep_plane kwargs)]``: the BH tiles step (the
    spherical scene, d 64, k 16, ws 1, seeded by the 19-channel far
    plane), the monopole path (the same tiles at ws 2, no far plane) and
    the sparse hash (the uniform cube, cell 2.0, d 56, k 16, cutoff² 4).
    The tiles and counts come from K2, the far plane from the pyramid."""
    import torch

    from nbody_tpu_torch.ops.barnes_hut import (
        bh_engine_params,
        bin_particles,
        far_field_grid,
        pyramid_from_packed,
        theta_to_ws,
    )
    from nbody_tpu_torch.ops.scatter import tile_scatter
    from nbody_tpu_torch.ops.sorted_window import build_sorted_grid
    from nbody_tpu_torch.ops.spatial_hash import tiles_bin

    p = bh_engine_params(cfg)
    levels, k, ws = p["levels"], p["near_k"], p["ws"]
    d = 1 << levels
    eps = cfg.softening
    lo, cell, coords = bin_particles(pos, levels)
    grid = build_sorted_grid(pos, mass, coords, d)
    tk, mk = tile_scatter(grid.psort, grid.cell_start, lo, cell, d=d, k=k)
    pyr = pyramid_from_packed(mk[:10].T.reshape(d, d, d, 10), lo, cell,
                              levels)
    a_f, j_f, h_f = far_field_grid(pyr, ws, 1.0, eps, levels)
    far_plane = (torch.cat([a_f, j_f, h_f], dim=-1).reshape(d, d * d, 19)
                 .permute(0, 2, 1).contiguous())
    bh = dict(k=k, d=d, ws=ws, eps=eps, lo=lo, cell=cell, counts=mk[10])
    sd = 56
    sp_lo, sp_coords = tiles_bin(sp_pos, 2.0, sd)
    sg = build_sorted_grid(sp_pos, sp_mass, sp_coords, sd)
    sp_cell = torch.full((), 2.0, dtype=sp_pos.dtype, device=sp_pos.device)
    st, sm = tile_scatter(sg.psort, sg.cell_start, sp_lo, sp_cell, d=sd,
                          k=16)
    return [
        ("1M BH tiles", tk, dict(bh, far_plane=far_plane)),
        (MONOPOLE, tk, dict(
            bh, ws=theta_to_ws(cfg.barnes_hut_theta, order=1))),
        ("1M sparse hash", st, dict(k=16, d=sd, ws=1, eps=0.1, lo=sp_lo,
                                    cell=sp_cell, counts=sm[10],
                                    cutoff2=4.0)),
    ]


def k4_checks(res, pos, mass, cfg, sp_pos, sp_mass):
    """K4 against its plain twin at its three 1M shapes (``k4_inputs``;
    2e-5·max|out|), two calls bit-equal, timed (one call, and its device
    time by graph replay)."""
    import torch
    import torch.nn.functional as F

    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops.tile_near import (
        tile_sweep_plane,
        tile_sweep_plane_plain,
    )

    for label, tk, kw in k4_inputs(pos, mass, cfg, sp_pos, sp_mass):
        d, k, ws, counts = kw["d"], kw["k"], kw["ws"], kw["counts"]
        ok_ = tile_sweep_plane(tk, **kw)
        op_ = tile_sweep_plane_plain(tk, **kw)
        e = float((ok_ - op_).abs().max())
        tol = 2e-5 * float(op_.abs().max())
        check(e <= tol, f"K4 tile_sweep_plane {label}: max|diff| {e} > {tol}")
        check(torch.equal(ok_, tile_sweep_plane(tk, **kw)),
              f"K4 tile_sweep_plane {label}: two calls differ")
        w1 = 2 * ws + 1
        slots = torch.clamp(counts, max=k).reshape(1, 1, d, d, d).double()
        neigh = F.avg_pool3d(slots, w1, stride=1, padding=ws,
                             count_include_pad=True) * w1 ** 3
        pairs = float((slots * neigh).sum())
        far_plane = kw.get("far_plane")
        n_far = 0 if far_plane is None else far_plane.shape[1]
        rec = dict(
            max_abs_err=e,
            ms=time_ms(lambda: tile_sweep_plane(tk, **kw)),
            device_ms=graph_ms(lambda: tile_sweep_plane(tk, **kw), reps=5),
            plain_ms=time_ms(lambda: tile_sweep_plane_plain(tk, **kw),
                             reps=5, warm=1),
            # live slot pairs of the (2ws+1)³ ball + ~80 ops of far
            # expansion per live slot when seeded; tiles, far plane,
            # counts in, slots out
            **bound(PAIR_OPS * pairs
                    + (80 * float(slots.sum()) if n_far else 0),
                    4 * (d * 4 * k * d * d + d * n_far * d * d + d ** 3
                         + d * 3 * k * d * d)),
            library_ms=None,
        )
        add_shape(res, "tile_sweep_plane", label, rec)
        plan = [_build.library().nbt_tile_near_plan(d, k, ws, f)
                for f in range(3)]
        print(f"K4 tile_sweep_plane {label} (d={d}, k={k}, ws={ws}, "
              f"cutoff2={kw.get('cutoff2')}, far plane "
              f"{'on' if n_far else 'off'}; bz, rows_cap, group_cols = "
              f"{plan}): max|diff| {e:.3e} (tol "
              f"2e-5*max|out| = {tol:.3e}; dead slots are 0 in both); two "
              f"calls bit-equal; live slot pairs {pairs:.0f}; kernel "
              f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f} ms, "
              f"{pairs / rec['device_ms'] * 1e3:.4e} pairs/s), plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})")


def k1_inputs(pos, mass, cfg, dev):
    """K1's inputs at its three shapes, as ``[(label, pos, mass,
    targets)]``: N = 16384 all pairs (the first rows of the 1M scene), the
    100K direct path's own scene all pairs, and the Barnes-Hut accuracy
    gates' 4096 sampled targets (``bh_vs_direct``) against all 1M rows."""
    import torch

    from nbody_tpu_torch.models.distributions import init_from_config

    n1 = 16384
    s100 = init_from_config(path_configs()["100K direct"], device=dev)
    sgen = torch.Generator(device=pos.device)
    sgen.manual_seed(0)
    idx = torch.randperm(pos.shape[0], generator=sgen,
                         device=pos.device)[:4096]
    return [
        (f"N = {n1}", pos[:n1].contiguous(), mass[:n1].contiguous(), None),
        (f"N = {s100.pos.shape[0]} (100K direct)", s100.pos, s100.mass,
         None),
        (f"4096 x {pos.shape[0]} (accuracy gate)", pos, mass,
         pos[idx].contiguous()),
    ]


def k1_checks(res, pos, mass, cfg, dev):
    """K1 against its plain twin at its three shapes (``k1_inputs``;
    1e-5·max|a|), two calls bit-equal, timed (one call, and its device
    time by graph replay)."""
    import torch

    from nbody_tpu_torch.ops.direct import direct_forces, direct_forces_kernel

    G, eps = cfg.G, cfg.softening
    for label, p1, m1, tgt in k1_inputs(pos, mass, cfg, dev):
        def kern():
            return direct_forces_kernel(p1, m1, G, eps, targets=tgt)

        def plain():
            return direct_forces(p1, m1, G, eps, targets=tgt)

        ok_, op_ = kern(), plain()
        e = float((ok_ - op_).abs().max())
        tol = 1e-5 * float(op_.abs().max())
        check(e <= tol, f"K1 direct {label}: max|diff| {e} > {tol}")
        check(torch.equal(ok_, kern()), f"K1 direct {label}: two calls "
              "differ")
        n, nt = p1.shape[0], ok_.shape[0]
        rec = dict(
            max_abs_err=e, ms=time_ms(kern), device_ms=graph_ms(kern, reps=3),
            plain_ms=time_ms(plain, reps=3, warm=1),
            # nt·n pairs; targets, sources (pos + mass) in, acc out
            **bound(PAIR_OPS * nt * n, 12 * nt + 16 * n + 12 * nt),
            library_ms=None,
        )
        add_shape(res, "direct_forces", label, rec)
        print(f"K1 direct_forces {label}: max|diff| {e:.3e} (tol "
              f"1e-5*max|a| = {tol:.3e}); two calls bit-equal; kernel "
              f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f} ms, "
              f"{nt * n / rec['device_ms'] * 1e3:.4e} pairs/s), plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})")


def kernel_checks(res, pos, mass, cfg):
    """Phase 2: K2 and K3 against their plain twins at the BH tiles
    main-path shapes. Returns the step-0 overflow."""
    import torch
    import torch.nn.functional as F

    from nbody_tpu_torch.ops.barnes_hut import (
        bh_engine_params,
        bin_particles,
        level_moments,
        level_tap_matrices,
        pyramid_from_packed,
    )
    from nbody_tpu_torch.ops import table_step as T
    from nbody_tpu_torch.ops.far_taps import far_taps, far_taps_plain
    from nbody_tpu_torch.ops.sorted_window import build_sorted_grid

    label = "1M BH tiles"
    p = bh_engine_params(cfg)
    levels, k, ws = p["levels"], p["near_k"], p["ws"]
    d = 1 << levels
    eps = cfg.softening
    print(f"main path: N={pos.shape[0]} levels={levels} d={d} k={k} ws={ws} "
          f"near_engine={p['near_engine']}")
    lo, cell, coords = bin_particles(pos, levels)
    grid = build_sorted_grid(pos, mass, coords, d)

    # K2: placement + moments + counts; the table forms
    tk, mk, overflow = k2_check(res, label, grid, lo, cell, d=d, k=k)
    k2_table_checks(res, label, grid, lo, cell,
                    T.bh_table_params(cfg.G, cfg.softening,
                                      cfg.barnes_hut_theta, levels=levels,
                                      near_k=k))

    # K3: far taps at every level of one step; p = 32 and 16 (the two
    # finest) against the twin and conv3d, and K3 called twice there
    pyr = pyramid_from_packed(mk[:10].T.reshape(d, d, d, 10), lo, cell,
                              levels)
    k3_sum = 0.0
    for lvl in range(levels, 0, -1):
        pp = (1 << lvl) // 2
        mom = level_moments(pyr, lvl)
        taps = level_tap_matrices(cell, ws, eps, levels, [lvl])[0].contiguous()
        ms = time_ms(lambda: far_taps(mom, taps, p=pp, ws=ws))
        k3_sum += ms
        if pp < 16:
            print(f"K3 far_taps p={pp}: kernel {ms:.4f} ms")
            continue
        ok_, op_ = far_taps(mom, taps, p=pp, ws=ws), far_taps_plain(
            mom, taps, p=pp, ws=ws)
        e = float((ok_ - op_).abs().max())
        tol = 2e-5 * float(op_.abs().max())
        check(e <= tol, f"K3 far_taps p={pp} max|diff| {e} > {tol}")
        check(torch.equal(ok_, far_taps(mom, taps, p=pp, ws=ws)),
              f"K3 far_taps p={pp}: two calls differ")
        pms = time_ms(lambda: far_taps_plain(mom, taps, p=pp, ws=ws))
        # The same function as ONE library call: a 3-D convolution of the
        # 80 moment channels into 152 output channels, zero padding ws.
        w1 = 2 * ws + 1
        weight = (taps.reshape(w1, w1, w1, 152, 80).permute(3, 4, 0, 1, 2)
                  .contiguous())
        x5 = mom.reshape(1, 80, pp, pp, pp)
        conv = F.conv3d(x5, weight, padding=ws).reshape(152, pp ** 3)
        e_conv = float((conv - op_).abs().max())
        check(e_conv <= 2e-5 * float(op_.abs().max()),
              f"K3 conv3d yardstick disagrees by {e_conv}")
        lib_ms = time_ms(lambda: F.conv3d(x5, weight, padding=ws))
        # 2 ops per multiply-add over the (cell, tap) pairs whose source
        # cell is in the grid: w1·p − ws(ws + 1) of them per axis
        macs = 152 * 80 * (w1 * pp - ws * (ws + 1)) ** 3
        nbytes = 4 * (80 * pp ** 3 + w1 ** 3 * 152 * 80 + 152 * pp ** 3)
        fp32 = bound(2 * macs, nbytes)
        rec = dict(max_abs_err=e, ms=ms, plain_ms=pms,
                   **bound(2 * macs, nbytes, TF32_OPS / 3),
                   fp32_pipe_bound_ms=fp32["bound_ms"], library_ms=lib_ms)
        add_shape(res, "far_taps", f"{label} p = {pp}", rec)
        print(f"K3 far_taps p={pp}: max|diff| {e:.3e} (tol 2e-5*max|out| = "
              f"{tol:.3e}), two calls bit-equal; kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, conv3d (TF32 off) {lib_ms:.4f} ms (max|diff| "
              f"vs plain {e_conv:.3e}); bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}: {macs:.4e} multiply-adds as 3 TF32 "
              f"products at 495 TFLOP/s), FP32-pipe bound "
              f"{fp32['bound_ms']:.4f} ms")
    print(f"K3 far_taps over the {levels} levels of one BH tiles step: "
          f"{k3_sum:.4f} ms (sum of per-level medians)")

    return overflow


def k5_check(res, pos, mass, cfg):
    """K5 (the all-pairs potential) against its plain twin at relative
    1e-5 (rsqrtf and torch.rsqrt differ by ulps on each term, the sums are
    float64 in both): first on the drift gate's own step-0 input (the
    Hénon sphere at N = 1M; the twin run once, ~1 min), then at N = 131072
    on the BH scene's first rows. Kernel times are medians of 3 calls
    after 1 warm-up."""
    import torch

    from nbody_tpu_torch.drift import drift_config, henon_sphere
    from nbody_tpu_torch.ops.direct import (
        pairwise_potential,
        pairwise_potential_plain,
    )

    def held(label, p, m, G, eps, plain_reps):
        n = p.shape[0]
        got = float(pairwise_potential(p, m, G, eps))
        if plain_reps:
            want = float(pairwise_potential_plain(p, m, G, eps))
            plain_ms = time_ms(lambda: pairwise_potential_plain(p, m, G, eps),
                               reps=plain_reps, warm=1)
        else:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = pairwise_potential_plain(p, m, G, eps)
            b.record()
            b.synchronize()
            want, plain_ms = float(out), a.elapsed_time(b)
        rel = abs(got - want) / abs(want)
        check(rel <= 1e-5, f"K5 pairwise_potential {label}: rel diff {rel}")
        rec = dict(
            max_abs_err=abs(got - want),
            ms=time_ms(lambda: pairwise_potential(p, m, G, eps), reps=3,
                       warm=1),
            plain_ms=plain_ms,
            # n² pair terms; pos + mass in, one partial per 256 rows out
            **bound(PAIR_OPS * n * n, 16 * n + 8 * (n // 256)),
            library_ms=None,
        )
        add_shape(res, "pairwise_potential", label, rec)
        print(f"K5 pairwise_potential {label}: kernel {got:.9e}, plain "
              f"{want:.9e}, rel diff {rel:.3e} (tol 1e-5); kernel "
              f"{rec['ms']:.4f} ms (median of 3), plain {plain_ms:.4f} ms "
              f"({'median of %d' % plain_reps if plain_reps else 'one call'}"
              f"), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")

    n = pos.shape[0]
    dcfg = drift_config(n)
    h = henon_sphere(n, pos.device)
    held(f"N = {n} (drift gate)", h.pos, h.mass, dcfg.G, dcfg.softening, 0)
    del h
    n1 = 131072
    held(f"N = {n1}", pos[:n1].contiguous(), mass[:n1].contiguous(), cfg.G,
         cfg.softening, 3)


def k6_check(res, pos, mass, cfg):
    """K6 (the segment sum) against its plain twin at the monopole path's
    shapes: the sorted rows' [m, m·x] (1M, 4) into the d³ = 262144 finest
    cells, max |diff| <= 1e-6·max|out| against the twin on float64 copies
    of the rows (the float32 twin's ``index_add_`` adds with atomics in no
    fixed order; its difference is printed beside), and two calls
    bit-equal; ``index_add_`` of the same rows is the library yardstick."""
    import torch

    from nbody_tpu_torch.ops.barnes_hut import bh_engine_params, bin_particles
    from nbody_tpu_torch.ops.scatter import segment_sum, segment_sum_plain
    from nbody_tpu_torch.ops.sorted_window import build_sorted_grid

    levels = bh_engine_params(cfg)["levels"]
    d = 1 << levels
    nc = d ** 3
    _lo, _cell, coords = bin_particles(pos, levels)
    g = build_sorted_grid(pos, mass, coords, d, with_csort=True)
    m = g.psort[:, 3:4]
    vals = torch.cat([m, m * g.psort[:, :3]], dim=-1).contiguous()
    ids = g.ids
    got = segment_sum(vals, ids, nc)
    want = segment_sum_plain(vals.double(), ids, nc)
    e = float((got.double() - want).abs().max())
    tol = 1e-6 * float(want.abs().max())
    check(e <= tol, f"K6 segment_sum: max|diff| {e} > {tol}")
    e32 = float((got - segment_sum_plain(vals, ids, nc)).abs().max())
    check(torch.equal(got, segment_sum(vals, ids, nc)),
          "K6 segment_sum: two calls differ")
    ids64 = ids.to(torch.int64)

    def library():
        return torch.zeros((nc, 4), device=pos.device).index_add_(
            0, ids64, vals)

    n = vals.shape[0]
    rec = dict(
        max_abs_err=e,
        ms=time_ms(lambda: segment_sum(vals, ids, nc)),
        device_ms=graph_ms(lambda: segment_sum(vals, ids, nc), reps=20),
        plain_ms=time_ms(lambda: segment_sum_plain(vals, ids, nc)),
        # ~4 adds per row; vals + dest in, (4, d³) out
        **bound(4 * n, 16 * n + 4 * n + 16 * nc),
        library_ms=time_ms(library),
        library_device_ms=graph_ms(library, reps=20),
    )
    add_shape(res, "segment_sum", MONOPOLE, rec)
    print(f"K6 segment_sum {MONOPOLE} ({n}, 4) -> (4, {nc}): max|diff| "
          f"{e:.3e} against the float64 twin (tol 1e-6*max|out| = "
          f"{tol:.3e}), {e32:.3e} against the float32 twin; two calls "
          f"bit-equal; kernel "
          f"{rec['ms']:.4f} ms a call ({rec['device_ms']:.4f} ms of device "
          f"time, CUDA graph replay), plain {rec['plain_ms']:.4f} ms, library "
          f"(zeros + index_add_) {rec['library_ms']:.4f} ms a call "
          f"({rec['library_device_ms']:.4f} ms of device time), bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")


def sort_inputs(pos, cfg):
    """K8's inputs at the shapes its path gives it, as ``{label: keys}``:
    the sort benchmark's N keys below 2^18 (numpy default_rng(0), as
    scripts/profile_sort.py), the BH scene's finest cell ids, and two small
    shapes — n = 1000 and 2^11 + 1 (one tile with pads, many ties in the
    second) and 2^17 + 3 (pads past whole tiles, a stage of a full
    device-memory group and a group of one)."""
    import numpy as np
    import torch

    from nbody_tpu_torch.ops.barnes_hut import bh_engine_params, bin_particles
    from nbody_tpu_torch.ops.sorted_window import cell_ids

    n, dev = pos.shape[0], pos.device
    levels = bh_engine_params(cfg)["levels"]
    rng = np.random.default_rng(0)
    small = np.random.default_rng(1)

    def on(a):
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    return {
        f"{n} keys < 2^18": on(rng.integers(0, 1 << 18, size=n)),
        f"{n} BH cell ids (d = {1 << levels})": cell_ids(
            bin_particles(pos, levels)[2], 1 << levels),
        "n = 1000": on(small.integers(0, 5000, size=1000)),
        "n = 2^11 + 1": on(small.integers(0, 7, size=(1 << 11) + 1)),
        "n = 2^17 + 3": on(small.integers(0, 50, size=(1 << 17) + 3)),
    }


def k8_checks(res, inputs):
    """K8 (the bitonic sort) against its plain twin on each input, keys
    and values bit for bit, the result a sorting permutation, and the
    kernels one sort queues (counted in a captured CUDA graph) as many as
    ``launch_plan`` lists; the kernel, the twin (median of 3 at the large
    shapes) and ``torch.sort`` (the library yardstick) are timed."""
    import math

    import torch

    from nbody_tpu_torch.ops.sort import (
        bitonic_sort_pairs,
        bitonic_sort_pairs_plain,
        kernel_launches,
    )

    for label, keys in inputs.items():
        n = keys.shape[0]
        vals = torch.arange(n, dtype=torch.int32, device=keys.device)
        ks, vs = bitonic_sort_pairs(keys, vals)
        kp, vp = bitonic_sort_pairs_plain(keys, vals)
        check(torch.equal(ks, kp) and torch.equal(vs, vp),
              f"K8 {label}: kernel and twin differ")
        check(torch.equal(ks, torch.sort(keys).values)
              and torch.equal(keys[vs.long()], ks)
              and torch.equal(torch.sort(vs).values, vals),
              f"K8 {label}: not a sorting permutation")
        # the wrapper only allocates besides its launch, so every kernel
        # node of a captured sort is K8's
        queued = graph_kernels(lambda: bitonic_sort_pairs(keys, vals))
        check(queued == kernel_launches(n),
              f"K8 {label}: {queued} kernels queued a sort, launch_plan "
              f"has {kernel_launches(n)}")
        check(n > 1 << 20 or queued <= 20,
              f"K8 {label}: {queued} kernels a sort")
        big = n >= 1 << 16
        rec = dict(
            max_abs_err=0.0,
            ms=time_ms(lambda: bitonic_sort_pairs(keys, vals)),
            plain_ms=time_ms(lambda: bitonic_sort_pairs_plain(keys, vals),
                             reps=3 if big else 7, warm=1),
            # keys + values read once and written once; n·log2(n)
            # comparisons, the least a comparison sort makes
            **bound(n * math.log2(n), 16 * n),
            library_ms=time_ms(lambda: torch.sort(keys)),
        )
        add_shape(res, "bitonic_sort", label, rec)
        print(f"K8 bitonic_sort {label}: keys and values bit-equal to the "
              f"twin, a sorting permutation; {queued} kernels a sort "
              f"(CUDA graph; launch_plan {kernel_launches(n)}); kernel "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              f"torch.sort {rec['library_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")


def frozen_checks(pos, mass, bh_cfg, sp_pos, sp_mass, sp_cfg):
    """The frozen-grid contract at 1M: frozen(psort, fresh meta) equals
    the sorted step bit for bit and audits 0 stale rows, for Barnes-Hut
    tiles and the sparse hash (tiles engine); after a move of 0.02·N(0, 1)
    per coordinate the audit equals a recount on the host."""
    import torch

    from nbody_tpu_torch.ops.barnes_hut import (
        barnes_hut_forces_frozen,
        barnes_hut_forces_sorted,
        bh_engine_params,
    )
    from nbody_tpu_torch.ops.spatial_hash import (
        hash_engine_params,
        spatial_hash_forces_tiles_frozen,
        spatial_hash_forces_tiles_sorted,
    )

    p = bh_engine_params(bh_cfg)
    bkw = dict(levels=p["levels"], near_k=p["near_k"])
    args = (bh_cfg.G, bh_cfg.softening, bh_cfg.barnes_hut_theta)
    h = hash_engine_params(sp_cfg, sp_pos)
    hkw = dict(cutoff=sp_cfg.spatial_hash_cutoff,
               cell_size=sp_cfg.spatial_hash_cell_size, d=h["tile_d"],
               k=h["tile_k"])
    cases = [
        ("BH tiles", 1 << p["levels"], lambda x: x.to(torch.int32),
         barnes_hut_forces_sorted(pos, mass, *args, with_grid_meta=True,
                                  **bkw),
         lambda q, meta: barnes_hut_forces_frozen(q, meta, *args,
                                                  with_audit=True, **bkw)),
        ("sparse hash", h["tile_d"], lambda x: torch.floor(x).to(torch.int32),
         spatial_hash_forces_tiles_sorted(sp_pos, sp_mass, sp_cfg.G,
                                          sp_cfg.softening,
                                          with_grid_meta=True, **hkw),
         lambda q, meta: spatial_hash_forces_tiles_frozen(
             q, meta, sp_cfg.G, sp_cfg.softening, with_audit=True, **hkw)),
    ]
    for label, d, bins, (acc, psort, _order, meta), frozen in cases:
        acc_f, stale = frozen(psort, meta)
        check(torch.equal(acc_f, acc),
              f"frozen {label}: fresh meta not bit-equal to the sorted step")
        check(int(stale) == 0, f"frozen {label}: fresh audit {int(stale)}")
        gen = torch.Generator(device=psort.device)
        gen.manual_seed(0)
        moved = psort.clone()
        moved[:, :3] += 0.02 * torch.randn(moved.shape[0], 3, generator=gen,
                                           device=psort.device)
        _, stale = frozen(moved, meta)
        c = torch.clamp(bins((moved[:, :3].cpu() - meta.lo.cpu())
                             / meta.cell.cpu()), 0, d - 1)
        ids = (c[:, 0] * d + c[:, 1]) * d + c[:, 2]
        recount = int((ids != meta.ids.cpu()).sum())
        check(int(stale) == recount,
              f"frozen {label}: audit {int(stale)} != host {recount}")
        print(f"frozen {label} (N={psort.shape[0]}, d={d}): fresh meta "
              f"bit-equal to the sorted step, audit 0; after a move of "
              f"0.02*N(0,1) audit {int(stale)} = host recount")


def sparse_tile_checks(res, pos, mass):
    """Phase 2 for the 1M sparse hash: K2 (the main form and the two table
    forms) and the table step's passes against their plain twins at the tiles engine's d = 56, k = 16 on
    the uniform cube, cell 2.0."""
    import torch

    from nbody_tpu_torch.ops.sorted_window import build_sorted_grid
    from nbody_tpu_torch.ops.spatial_hash import tiles_bin
    from nbody_tpu_torch.ops.table_step import hash_table_params

    label, d, k = "1M sparse hash", 56, 16
    lo, coords = tiles_bin(pos, 2.0, d)
    grid = build_sorted_grid(pos, mass, coords, d)
    cell = torch.full((), 2.0, dtype=pos.dtype, device=pos.device)
    k2_check(res, label, grid, lo, cell, d=d, k=k)
    k2_table_checks(res, label, grid, lo, cell,
                    hash_table_params(cutoff=2.0, cell_size=2.0, d=d, k=k))


def k7_shapes(pos, mass):
    """K7's inputs at the two 1M shapes that run it, from the 1M scene's
    positions: ``[(label, sorted grid, window_sweep kwargs)]`` for the
    dense hash (d 64, cutoff 2) and the BH window engine (d 32)."""
    from nbody_tpu_torch.ops.barnes_hut import bin_particles
    from nbody_tpu_torch.ops.sorted_window import build_sorted_grid, xy_ball
    from nbody_tpu_torch.ops.spatial_hash import hash_bin

    coords_h = hash_bin(pos, 1.0, 64)[2]
    coords_b = bin_particles(pos, 5)[2]
    return [
        ("1M dense hash", build_sorted_grid(pos, mass, coords_h, 64,
                                            with_csort=True),
         dict(d=64, offsets=xy_ball(1), z_hw=1, window=2048,
              block_size=256, eps=0.1, cutoff2=2.0 * 2.0)),
        ("1M BH window", build_sorted_grid(pos, mass, coords_b, 32,
                                           with_csort=True),
         dict(d=32, offsets=xy_ball(1), z_hw=1, window=2048,
              block_size=256, eps=0.1)),
    ]


def k7_checks(res, pos, mass):
    """Phase 2 for K7: the window sweep against its plain twin at the
    dense-hash and BH-window shapes of the 1M scene, and two calls
    bit-equal. The bound counts the pair tests the function needs, each
    target against its 27-cell ball; a model of the kernel's work from
    ``window_spans`` (its pair tests, the rows of each target's per-cell
    spans, and the lane slots its warps would issue) is printed beside it,
    outside the kernels' record."""
    import torch
    import torch.nn.functional as F

    from nbody_tpu_torch.ops.window_sweep import (
        block_rows,
        window_spans,
        window_sweep_kernel,
        window_sweep_plain,
    )

    n = pos.shape[0]
    for label, g, kw in k7_shapes(pos, mass):
        args = (g.psort, g.csort, g.cell_start)
        acc_k, over_k = window_sweep_kernel(*args, **kw)
        b, d = kw["block_size"], kw["d"]
        nb = -(-n // b)
        sub = torch.arange(0, nb, 8, device=pos.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc_sub, over_p = window_sweep_plain(*args, target_blocks=sub, **kw)
        torch.cuda.synchronize()
        est = 8 * (time.perf_counter() - t0)
        if est <= 30.0:
            acc_p, _ = window_sweep_plain(*args, **kw)
            got, note = acc_k, "all target blocks"
        else:
            acc_p = acc_sub
            got = acc_k[block_rows(sub, n, b)]
            note = f"every 8th target block (full plain ~{est:.0f} s)"
        e = float((got - acc_p).abs().max())
        tol = 2e-5 * float(acc_p.abs().max())
        check(e <= tol, f"K7 {label}: max|diff| {e} > {tol}")
        check(int(over_k) == int(over_p),
              f"K7 {label}: overflow {int(over_k)} != plain {int(over_p)}")
        # pairs the predicate needs: each target against the occupancy of
        # its 27-cell ball (the pair-rows the overflow drops are counted
        # too: at most overflow × B of them)
        cnt = (g.cell_start[1:] - g.cell_start[:-1]).double().reshape(
            1, 1, d, d, d)
        ball = F.avg_pool3d(cnt, 3, stride=1, padding=1,
                            count_include_pad=True) * 27
        needed = float((cnt * ball).sum())
        # A model of the kernel's work, not a count taken from it: the pair
        # tests are the rows of every target's span (window_spans, the CPU
        # mirror of the kernel's spans); the lane slots assume the targets
        # of a warp (32 consecutive rows of a block) walk their spans side
        # by side, so that a warp takes as long as its longest lane's span
        lo, hi, _ = window_spans(g.csort, g.cell_start, d=d,
                                 offsets=kw["offsets"], z_hw=kw["z_hw"],
                                 window=kw["window"], block_size=b)
        span = hi - lo
        tested = float(span.sum())
        row = torch.arange(n, device=pos.device)
        warp = (row // b) * -(-b // 32) + (row % b) // 32
        wmax = torch.zeros((int(warp[-1]) + 1, span.shape[1]),
                           dtype=span.dtype, device=pos.device)
        wmax.scatter_reduce_(0, warp[:, None].expand_as(span), span, "amax")
        slots = 32.0 * float(wmax.sum())
        del lo, hi, span, row, warp, wmax
        acc_k2, over_k2 = window_sweep_kernel(*args, **kw)
        check(torch.equal(acc_k, acc_k2) and int(over_k) == int(over_k2),
              f"K7 {label}: two calls differ")
        ms = time_ms(lambda: window_sweep_kernel(*args, **kw))
        dms = graph_ms(lambda: window_sweep_kernel(*args, **kw), reps=3)
        reps = 7 if est <= 2.0 else (3 if est <= 10.0 else 1)
        pms = time_ms(lambda: window_sweep_plain(*args, **kw), reps=reps,
                      warm=0) if est <= 30.0 else None
        rec = dict(
            max_abs_err=e, ms=ms, device_ms=dms, plain_ms=pms,
            # psort, csort, cell_start in; acc + overflow out
            **bound(PAIR_OPS * needed,
                    16 * n + 12 * n + 4 * g.cell_start.numel() + 12 * n + 8),
            library_ms=None,
        )
        add_shape(res, "window_sweep", label, rec)
        print(f"K7 window_sweep {label}: max|diff| {e:.3e} (tol "
              f"2e-5*max|a| = {tol:.3e}, compared on {note}); overflow "
              f"{int(over_k)} = plain; two calls bit-equal; 27-cell pairs "
              f"needed {needed:.4e}; modelled from window_spans (not counted "
              f"in the kernel): pair tests {tested:.4e} "
              f"({tested / needed:.3f}x), warp lane slots "
              f"{slots:.4e} ({slots / needed:.3f}x); kernel {ms:.4f} ms "
              f"(device {dms:.4f} ms), "
              f"plain {pms} ms (median of {reps}), bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")


def ground_truth_hash(pos, mass, acc, coords, cutoff, eps, G, *,
                      exclude=None, source_ok=None, samples=4096):
    """Step-0 hash forces on ``samples`` random rows against a float64
    brute force over all sources with the engine's predicate: cells within
    Chebyshev distance 1, raw r² ≤ cutoff², r² > 0 (sources restricted to
    ``source_ok`` rows; sampled rows in ``exclude`` skipped). The predicate
    is decided on the f32 r² the kernels compute (dx² + dy² + dz², each
    step rounded), so a pair within an ulp of the cutoff counts on both
    sides or on neither; the sum is in float64. Returns (max |diff|,
    max |a_ref|, median rel err, rows held)."""
    import torch

    n = pos.shape[0]
    gen = torch.Generator(device=pos.device)
    gen.manual_seed(0)
    idx = torch.randperm(n, generator=gen, device=pos.device)[:samples]
    if exclude is not None:
        idx = idx[~exclude[idx]]
    src_p = pos.double()
    src_m = mass.double()
    src_c = coords
    if source_ok is not None:
        src_p, src_m, src_c = src_p[source_ok], src_m[source_ok], \
            src_c[source_ok]
    ref = []
    src_p32 = src_p.float()
    for i in range(0, idx.shape[0], 32):
        t = idx[i:i + 32]
        d32 = src_p32[None] - pos[t][:, None]
        r2_32 = (d32[..., 0] * d32[..., 0] + d32[..., 1] * d32[..., 1]
                 + d32[..., 2] * d32[..., 2])
        dvec = src_p[None] - pos[t].double()[:, None]
        r2 = (dvec * dvec).sum(-1)
        cheb = (src_c[None] - coords[t][:, None]).abs().amax(-1)
        keep = (cheb <= 1) & (r2_32 <= cutoff * cutoff) & (r2_32 > 0)
        w = torch.where(keep, src_m[None] * (r2 + eps * eps) ** -1.5,
                        torch.zeros_like(r2))
        ref.append(G * (w[..., None] * dvec).sum(1))
    ref = torch.cat(ref)
    got = acc[idx].double()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    rel = (got - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30)
    return err, scale, float(rel.median()), int(idx.shape[0])


def bh_vs_direct(pos, mass, acc_bh, cfg, label):
    """BH at step 0 against the direct kernel (ground truth) on 4096
    sampled rows with all sources: median relative error < 0.05."""
    import torch

    from nbody_tpu_torch.ops.direct import direct_forces_kernel

    n = pos.shape[0]
    sgen = torch.Generator(device=pos.device)
    sgen.manual_seed(0)
    idx = torch.randperm(n, generator=sgen, device=pos.device)[:4096]
    acc_dir = direct_forces_kernel(pos, mass, cfg.G, cfg.softening,
                                   targets=pos[idx].contiguous())
    rel = ((acc_bh[idx] - acc_dir).norm(dim=1)
           / acc_dir.norm(dim=1).clamp(min=1e-30))
    med = float(rel.median())
    print(f"{label} vs direct (4096 sampled rows, all {n} sources): median "
          f"rel err {med:.4e}, p90 {float(rel.quantile(0.9)):.4e}, max "
          f"{float(rel.max()):.4e} (gate: median < 0.05)")
    check(med < 0.05, f"{label} median relative error {med} >= 0.05")


def counted_run(label, steps, run, want, wrappers, plains, smi):
    """Every count set to 0, ``run()`` timed (host clock to a synchronize),
    the counts read: checks the launches and that no plain twin ran,
    prints steps/s, phases and launches. Returns (launches, run's
    result, phases)."""
    import torch

    from nbody_tpu_torch.utils.profiling import consume_global_phase_snapshot

    for f in wrappers.values():
        f.launches = 0
    for f in plains:
        f.calls = 0
    consume_global_phase_snapshot()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: f.launches for name, f in wrappers.items()}
    plain_calls = sum(f.calls for f in plains)
    phases = consume_global_phase_snapshot()
    print(f"{label}: {steps} steps in {wall:.4f} s = "
          f"{steps / wall:.3f} steps/s ({smi})")
    for name, st in sorted(phases.items()):
        print(f"  phase {name}: {st.total_ms / steps:.4f} ms/step "
              f"({st.samples} samples)")
    print(f"  launches: {launches}")
    check(launches == want,
          f"{label}: launch counts {launches} != expected {want}")
    check(plain_calls == 0, f"{label}: a plain twin ran on the path")
    return launches, out, phases


def check_finite(label, st) -> None:
    import torch

    check(bool(torch.isfinite(st.pos).all()), f"{label}: non-finite pos")
    check(bool(torch.isfinite(st.vel).all()), f"{label}: non-finite vel")


def run_path(label, cfg, steps, want, wrappers, plains, smi, dev,
             expect=None):
    """Drive one path through the facade: warm run, reset, then the timed
    run under ``counted_run``; checks a finite state that advanced and
    prints the audit. ``expect(ps, state0) -> (launches, info)`` adds the
    launches of a path whose schedule depends on the scene, read from a
    traced run of the same steps from the same state before the timed one.
    Returns (launches, phases, the system, the state the timed run started
    from, info)."""
    from nbody_tpu_torch import ParticleSystem

    ps = ParticleSystem()
    ps.initialize(cfg, device=dev)
    ps.run_steps(steps)
    ps.synchronize()
    ps.reset()
    ps.synchronize()
    state0 = ps.state
    info = None
    if expect is not None:
        more, info = expect(ps, state0)
        want = {**want, **more}
    launches, _, phases = counted_run(
        label, steps, lambda: ps.run_steps(steps), want, wrappers, plains,
        smi)
    check_finite(label, ps.state)
    check(abs(ps.simulation_time - steps * cfg.dt) < 1e-6,
          f"{label}: simulation time did not advance")
    print(f"  audit_short_range: {ps.audit_short_range()}")
    return launches, phases, ps, state0, info


def table_multi(tp, cfg, knob, steps, trace=False):
    """The table driver the facade's rule names for ``cfg``'s knob, with
    its caps (repair: ``REPAIR_CAP`` movers, cadence cap ``resort_every``
    or 64; audited: cap ``resort_every`` or 16)."""
    from nbody_tpu_torch.ops import table_step as T

    cad = cfg.resort_every
    if knob == "repair":
        return T.make_table_repair_multi_step(
            tp, cfg.dt, steps, repair_cap=REPAIR_CAP,
            max_cadence=cad if cad > 1 else 64, with_trace=trace)
    if knob == "stale_frac":
        return T.make_table_adaptive_multi_step(
            tp, cfg.dt, steps, max_stale_frac=cfg.resort_stale_frac,
            max_cadence=cad if cad > 1 else 16, with_trace=trace)
    return T.make_table_multi_step(tp, cfg.dt, steps, cad)


def row_multi(sf, cfg, knob, steps):
    """The row-space driver of the same knob: the cadence, the lagged
    audited re-sort (cap 16), or for repair a sort every step (the JAX
    facade's choice off its accelerator, and what repair is exact to)."""
    from nbody_tpu_torch.ops import integrator as I

    if knob == "cadence":
        return I.make_resort_multi_step(sf, cfg.dt, steps, cfg.resort_every)
    if knob == "stale_frac":
        return I.make_adaptive_multi_step(
            sf, cfg.dt, steps, max_stale_frac=cfg.resort_stale_frac,
            max_cadence=16)
    return I.make_sorted_multi_step(sf, cfg.dt, steps)


def table_launches(tp, cfg, knob, state0, steps, far):
    """A table run's launches, and its trace where the driver has one (a
    traced run of the same steps from the same state): K2's rank form on
    the entry and every re-sort or rebuild, its dest form on every repair
    step with movers, K4 and the kick on every step, the drift on every
    step after the first, K3 ``far`` times a step → (want, (out, stale,
    flags) or None)."""
    want = dict(tile_sweep_plane=steps, far_taps=far * steps,
                table_drift=steps - 1, table_kick=steps)
    if knob == "cadence":
        want["tile_scatter"] = 1 + (steps - 1) // cfg.resort_every
        return want, None
    out, (stale, flags) = table_multi(tp, cfg, knob, steps, True)(state0)
    want["tile_scatter"] = 1 + int(flags.sum())
    if knob == "repair":
        want["tile_place"] = int(((~flags) & (stale > 0)).sum())
    return want, (out, stale, flags)


def compare_states(label, got, want, pos_rel, vel_rel, what):
    """``got`` against ``want`` (same rows): positions within
    pos_rel·max|pos|, velocities within vel_rel·max|v| (None: printed
    only), masses bit-equal, every state finite."""
    import torch

    dp = float((got.pos - want.pos).abs().max())
    sp = float(want.pos.abs().max())
    dv = float((got.vel - want.vel).abs().max())
    sv = float(want.vel.abs().max())
    print(f"  {label} vs {what}: max|dpos| {dp:.4e} ({dp / sp:.3e} of "
          f"max|pos|, tol {pos_rel}), max|dvel| {dv:.4e} ({dv / sv:.3e} of "
          f"max|v|, tol {vel_rel}); positions bit-equal: "
          f"{torch.equal(got.pos, want.pos)}")
    check(dp <= pos_rel * sp, f"{label}: positions off {what} by {dp}")
    check(vel_rel is None or dv <= vel_rel * sv,
          f"{label}: velocities off {what} by {dv}")
    check(torch.equal(got.mass, want.mass), f"{label}: masses not restored")
    check_finite(label, got)


def replay(sf, state0, flags, dt):
    """The row-space steps on a given schedule: the first step and those
    flagged sort, the others frozen on the last sort's cells."""
    from nbody_tpu_torch.ops import integrator as I

    r, (meta,) = I._sorted_step(I._rows_from(state0), sf.with_meta, dt)
    for resort in flags:
        if resort:
            r, (meta,) = I._sorted_step(r, sf.with_meta, dt)
        else:
            r, _ = I._frozen_step(r, sf.frozen, meta, dt)
    return I._state_from(r)


def repair_report(label, got, row, state0, trace, steps):
    """A repair run after its timed run: the per-step stale counts and
    rebuild flags of the traced run, and the state ``got`` against sorting
    every step from the same state (``row``): positions within
    1e-4·max|pos| (the JAX package's own bound for repair against
    every-step binning, and the card test's: the two runs bin on other
    grids between rebuilds, and k-cap overflow and denied arrivals differ
    row by row), with the quantiles of |Δx| and of |Δx| / displacement
    printed; masses row for row."""
    import torch

    _, stale, flags = trace
    repairs = int(((~flags) & (stale > 0)).sum())
    print(f"  trace: stale counts after steps 2..{steps}: {stale.tolist()}; "
          f"rebuilt at steps {(torch.nonzero(flags)[:, 0] + 2).tolist()} "
          f"(cap {REPAIR_CAP}); {repairs} repairs with movers")
    disp = (row.pos - state0.pos).norm(dim=1)
    diff = (got.pos - row.pos).norm(dim=1)
    rel = diff / disp.clamp(min=1e-30)
    print(f"  {label}: |dx|/|x - x0| median {float(rel.median()):.4e}, p99 "
          f"{float(rel.quantile(0.99)):.4e}; |dx| p99 "
          f"{float(diff.quantile(0.99)):.4e}; median displacement "
          f"{float(disp.median()):.4e}")
    compare_states(label, got, row, 1e-4, None, "sorting every step")


def turns(label, table, row, state0, steps, routed, smi):
    """The table and row-space drivers of one knob timed from the same
    state in turns (table, row, row, table, after a warm run of each):
    medians of 2 runs each, steps/s, beside whether the facade routes the
    pair to the table."""
    import torch

    walls = {"table": [], "row": []}
    runs = {"table": table, "row": row}
    for f in runs.values():
        f(state0)
    for name in ("table", "row", "row", "table"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name](state0)
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    rate = {name: steps / statistics.median(w) for name, w in walls.items()}
    print(f"  routing {label}: table {rate['table']:.3f} steps/s, row space "
          f"{rate['row']:.3f} (medians of 2 in turns; {smi}); the facade "
          f"routes it to the {'table' if routed else 'row-space'} driver")
    return rate


def frozen_grid_path(label, mode, steps, far, drive, drive_row, smi, dev):
    """One frozen-grid path: through the facade (table-resident where
    ``TABLE_ROUTES`` holds the engine and knob, else in row space), then
    the other driver of the same knob called directly from the same state,
    both with their launches counted; the two held to each other, the
    traces printed, and the two timed in turns. Returns the rates."""
    import torch

    from nbody_tpu_torch.ops.forces import make_table_step_params
    from nbody_tpu_torch.system import TABLE_ROUTES, _resort_knob

    cfg = path_configs()[label]
    knob = _resort_knob(cfg)
    routed = (mode, knob) in TABLE_ROUTES
    row_want = dict(tile_scatter=steps, tile_sweep_plane=steps,
                    far_taps=far * steps)
    info = {}

    def expect(ps, state0):
        tp = make_table_step_params(
            cfg, device=dev, pos_hint=state0.pos if mode == "hash" else None)
        check(tp is not None and tp.mode == mode,
              f"{label}: no {mode} table parameters on the card")
        info["tp"] = tp
        if not routed:
            return {}, None
        want, trace = table_launches(tp, cfg, knob, state0, steps, far)
        info["want"] = want
        return want, trace

    _, phases, ps, state0, trace = drive(
        label, steps, expect=expect, **({} if routed else row_want))
    check((ps._table_params is not None) == routed,
          f"{label}: the facade's routing is not TABLE_ROUTES'")
    tp, sf = info["tp"], ps._sorted_force
    table, row = table_multi(tp, cfg, knob, steps), row_multi(sf, cfg, knob,
                                                              steps)
    if routed:
        tab_out, tab_phases = ps.state, phases
        row_out, row_phases = drive_row(f"{label}, row-space driver", steps,
                                        row, state0, **row_want)
    else:
        row_out, row_phases = ps.state, phases
        want, trace = table_launches(tp, cfg, knob, state0, steps, far)
        info["want"] = want
        tab_out, tab_phases = drive_row(f"{label}, table driver", steps,
                                        table, state0, **want)
    sorts = info["want"]["tile_scatter"]
    check(tab_phases[tp.sort_phase].samples == sorts,
          f"{label}: {tab_phases[tp.sort_phase].samples} table sorts timed, "
          f"{sorts} expected")
    if trace is not None:
        check(torch.equal(trace[0].pos, tab_out.pos),
              f"{label}: traced table run and timed run differ")
    # Barnes-Hut's frozen table steps sum the finest moments in another
    # order than K2's per-cell loop, so its far field moves in the last
    # bits; the hash has no far field and stays bit-equal
    tol = 1e-6 if mode == "hash" else 1e-5
    if knob == "cadence":
        print(f"  table: {sorts} sorted steps of {steps}")
        compare_states(label, tab_out, row_out, tol, tol,
                       "the row-space cadence")
    elif knob == "stale_frac":
        _, stale, flags = trace
        print(f"  table trace: {sorts} sorted steps of {steps} (the first "
              f"and re-sorts at steps "
              f"{(torch.nonzero(flags)[:, 0] + 2).tolist()}); pre-force "
              f"stale counts after steps 2..{steps}: {stale.tolist()} (cap "
              f"{int(cfg.resort_stale_frac * state0.n)})")
        compare_states(label, tab_out, replay(sf, state0, flags.tolist(),
                                              cfg.dt),
                       tol, tol, "the row-space steps on its schedule")
        if mode == "bh":
            adaptive_report(sf, cfg, state0, steps, row_phases)
    else:
        repair_report(label, tab_out, row_out, state0, trace, steps)
    return turns(label, table, row, state0, steps, routed, smi)


def adaptive_report(sf, cfg, state0, steps, phases):
    """The row-space adaptive path after its timed run: the trace of the
    same steps from the same state (``with_trace=True``), whose re-sorts
    must match the timed run's ``bh.sort`` samples; then the host read of
    the audit count,
    timed as the difference between the stale cap N − 1 (read after every
    frozen step, never exceeded) and N (never read) over the same steps,
    both at cap 16: medians of 4 runs each, in turns (the host-bound step
    varies between runs by more than a read costs); and the host's wait
    inside each read, on audited frozen force evaluations in a row."""
    import torch

    from nbody_tpu_torch.ops.integrator import make_adaptive_multi_step

    n = state0.n
    _, (stale, resorted) = make_adaptive_multi_step(
        sf, cfg.dt, steps, max_stale_frac=cfg.resort_stale_frac,
        max_cadence=16, with_trace=True)(state0)
    print(f"  {BH_ADAPTIVE}, row-space driver:")
    sorts = 1 + int(resorted.sum())
    print(f"  trace: {sorts} sorted steps of {steps} (the first and "
          f"{int(resorted.sum())} re-sorts at steps "
          f"{(torch.nonzero(resorted)[:, 0] + 2).tolist()}); stale counts "
          f"after steps 2..{steps}: {stale.tolist()} (cap "
          f"{int(cfg.resort_stale_frac * n)})")
    check(phases["bh.sort"].samples == sorts,
          f"adaptive: {phases['bh.sort'].samples} sorts timed, trace {sorts}")

    multis = {frac: make_adaptive_multi_step(sf, cfg.dt, steps,
                                             max_stale_frac=frac,
                                             max_cadence=16)
              for frac in ((n - 1) / n, 1.0)}
    walls = {frac: [] for frac in multis}
    for frac in multis:
        multis[frac](state0)
    for turn in range(8):
        frac = list(multis)[(turn + turn // 2) % 2]  # r n n r r n n r
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multis[frac](state0)
        torch.cuda.synchronize()
        walls[frac].append((time.perf_counter() - t0) * 1e3)
    # reads: frozen steps followed by a decision the cadence cap does not
    # already make (since < 15)
    reads = sum(1 for s in range(1, steps) if 0 < (s - 1) % 16 < 15)
    t_read, t_none = (statistics.median(w) for w in walls.values())
    spread = "; ".join(f"{min(w):.3f}-{max(w):.3f}" for w in walls.values())
    print(f"  audit read: {steps} steps with {reads} host reads of the "
          f"count {t_read:.3f} ms, without reads {t_none:.3f} ms (medians "
          f"of 4; ranges {spread} ms): {(t_read - t_none) / reads:.4f} ms "
          "a read")
    # the wait inside a read: the host clock around each read of the count
    # after an audited frozen evaluation (the host idles while the device
    # finishes what it queued)
    _, psort, _, meta = sf.with_meta(state0.pos, state0.mass)
    int(sf.frozen(psort, meta, with_audit=True)[1])
    waits, t0 = [], time.perf_counter()
    for _ in range(reads):
        count = sf.frozen(psort, meta, with_audit=True)[1]
        t1 = time.perf_counter()
        int(count)
        waits.append((time.perf_counter() - t1) * 1e3)
    per = (time.perf_counter() - t0) * 1e3 / reads
    print(f"  host wait in a read: median {statistics.median(waits):.4f} ms "
          f"(range {min(waits):.4f}-{max(waits):.4f}) of {reads} reads, each "
          f"after one audited frozen force evaluation ({per:.3f} ms with "
          "its read)")


def sort_path(inputs, want, wrappers, plains, smi):
    """K8's path: ``bitonic_argsort`` (the entry point of
    scripts/profile_sort_torch.py) on the sort benchmark's two 1M inputs,
    each result checked sorted. Returns launches."""
    import torch

    from nbody_tpu_torch.ops.sort import bitonic_argsort

    big = [k for k in inputs.values() if k.shape[0] == N]

    def run():
        return [bitonic_argsort(k) for k in big]

    launches, outs, _ = counted_run(SORT_PATH, len(big), run, want,
                                    wrappers, plains, smi)
    for k, (ks, perm) in zip(big, outs):
        check(torch.equal(ks, k[perm.long()]) and bool((ks[1:] >= ks[:-1])
                                                       .all()),
              f"{SORT_PATH}: a result is not sorted")
    return launches


def run_monopole(cfg, scene, steps, want, wrappers, plains, smi):
    """The monopole path: ``make_sorted_multi_step`` over
    ``barnes_hut_forces_sorted(multipole_order=1)`` from the scene with
    a(t=0), ``steps`` warm, then ``steps`` timed from the same initial
    state under ``counted_run``. Prints the step-0 overflow (rows past the
    k cap, whose near field reads zero). Returns launches."""
    import torch

    from nbody_tpu_torch.ops.barnes_hut import bh_engine_params, bin_particles
    from nbody_tpu_torch.ops.integrator import (
        initialize_forces,
        make_sorted_multi_step,
    )

    force_fn, sorted_fn = monopole_forces(cfg)
    state0 = initialize_forces(scene, force_fn)
    multi = make_sorted_multi_step(sorted_fn, cfg.dt, steps)
    multi(state0)
    torch.cuda.synchronize()
    launches, st, _ = counted_run(MONOPOLE, steps, lambda: multi(state0),
                                  want, wrappers, plains, smi)
    check_finite(MONOPOLE, st)
    check(abs(float(st.time) - steps * cfg.dt) < 1e-6,
          f"{MONOPOLE}: simulation time did not advance")
    p = bh_engine_params(cfg)
    d, k = 1 << p["levels"], p["near_k"]
    coords = bin_particles(scene.pos, p["levels"])[2]
    ids = (coords[:, 0] * d + coords[:, 1]) * d + coords[:, 2]
    counts = torch.bincount(ids.to(torch.int64), minlength=d ** 3)
    print(f"  step-0 overflow (rows past k = {k}): "
          f"{int(torch.clamp(counts - k, min=0).sum())}")
    return launches


def drift_phase(steps, chunk, want, wrappers, plains, smi, dev):
    """Phase 5: the energy-drift gate cut to ``steps`` steps at 1M: prints
    every checkpoint and |ΔE/E| beside the 1e-4 target (printed, not
    enforced); checks every E is finite. Returns launches."""
    import math

    from nbody_tpu_torch.drift import drift_metric, run_drift

    label = "1M drift gate"
    launches, recs, _ = counted_run(
        label, steps, lambda: list(run_drift(N, steps, chunk, dev)), want,
        wrappers, plains, smi)
    for rec in recs:
        print(f"  {json.dumps(rec)}")
        check(math.isfinite(rec["E"]), f"{label}: E not finite at "
              f"step {rec['step']}")
    line = drift_metric(N, steps, recs[-1])
    print(f"  {json.dumps(line)} (|dE/E| after {recs[-1]['step']} steps "
          f"{line['value']:.4e} against the target 1e-4; {smi})")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    try:
        import nbody_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import nbody_tpu_torch ({e}): run from a checkout")
    from nbody_tpu_torch.models.distributions import init_from_config
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops.barnes_hut import bh_engine_params
    from nbody_tpu_torch.ops.direct import (
        direct_forces,
        direct_forces_kernel,
        pairwise_potential,
        pairwise_potential_plain,
    )
    from nbody_tpu_torch.ops.far_taps import far_taps, far_taps_plain
    from nbody_tpu_torch.ops import table_step as T
    from nbody_tpu_torch.ops.forces import make_force_fn
    from nbody_tpu_torch.ops.scatter import (
        segment_sum,
        segment_sum_plain,
        tile_place,
        tile_place_plain,
        tile_scatter,
        tile_scatter_plain,
    )
    from nbody_tpu_torch.ops.sort import (
        bitonic_sort_pairs,
        bitonic_sort_pairs_plain,
    )
    from nbody_tpu_torch.ops.sorted_window import (
        build_sorted_grid,
        sorted_ranks,
        xy_ball,
    )
    from nbody_tpu_torch.ops.spatial_hash import (
        cell_index,
        hash_bin,
        hash_engine_params,
        tiles_bin,
    )
    from nbody_tpu_torch.ops.tile_near import (
        tile_sweep_plane,
        tile_sweep_plane_plain,
    )
    from nbody_tpu_torch.ops.window_sweep import (
        window_starts,
        window_sweep_kernel,
        window_sweep_plain,
    )

    # Every matmul and convolution on the card in FP32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi_run = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi_run.returncode == 0,
          f"nvidia-smi failed: {smi_run.stderr.strip()}")
    smi = smi_run.stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    dev = torch.device("cuda")
    print(f"torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.last_build['seconds']:.2f} s, "
          f"built={_build.last_build['built']})")
    for line in _build.last_build["log"].splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    cfgs = path_configs()
    bh_cfg, hash_cfg = cfgs["1M BH tiles"], cfgs["1M dense hash"]
    sparse_cfg, bhw_cfg = cfgs["1M sparse hash"], cfgs["1M BH window"]
    scene = init_from_config(bh_cfg, device=dev)
    pos0, mass0 = scene.pos, scene.mass
    sparse = init_from_config(sparse_cfg, device=dev)
    sp_pos, sp_mass = sparse.pos, sparse.mass

    # Phase 2
    res = {}
    k1_checks(res, pos0, mass0, bh_cfg, dev)
    overflow = kernel_checks(res, pos0, mass0, bh_cfg)
    sparse_tile_checks(res, sp_pos, sp_mass)
    k4_checks(res, pos0, mass0, bh_cfg, sp_pos, sp_mass)
    k7_checks(res, pos0, mass0)
    k5_check(res, pos0, mass0, bh_cfg)
    k6_check(res, pos0, mass0, bh_cfg)
    sorts = sort_inputs(pos0, bh_cfg)
    k8_checks(res, sorts)
    frozen_checks(pos0, mass0, bh_cfg, sp_pos, sp_mass, sparse_cfg)
    for name, r in res.items():
        for label, s in r["shapes"].items():
            print(f"  {name} at {label}: kernel {s['ms']:.4f} ms, plain "
                  f"{s['plain_ms']} ms, bound {s['bound_ms']:.4f} ms "
                  f"({s['bound_by']}), library {s['library_ms']} ms")

    # Phase 3
    wrappers = {
        "direct_forces": direct_forces_kernel,
        "tile_scatter": tile_scatter,
        "tile_place": tile_place,
        "far_taps": far_taps,
        "tile_sweep_plane": tile_sweep_plane,
        "window_sweep": window_sweep_kernel,
        "pairwise_potential": pairwise_potential,
        "segment_sum": segment_sum,
        "bitonic_sort": bitonic_sort_pairs,
        "table_drift": T.table_drift,
        "table_kick": T.table_kick,
    }
    plains = [direct_forces, tile_scatter_plain, tile_place_plain,
              far_taps_plain, tile_sweep_plane_plain, window_sweep_plain,
              pairwise_potential_plain, segment_sum_plain,
              bitonic_sort_pairs_plain, T.table_drift_plain,
              T.table_kick_plain]
    none = {name: 0 for name in wrappers}
    by_path = {name: {} for name in wrappers}

    def keep(label, got):
        for name, c in got.items():
            if c:
                by_path[name][label] = c

    def drive(label, steps, expect=None, **want):
        got = run_path(label, cfgs[label], steps, {**none, **want}, wrappers,
                       plains, smi, dev, expect)
        keep(label, got[0])
        return got

    def drive_row(label, steps, multi, state0, **want):
        launches, out, phases = counted_run(label, steps,
                                            lambda: multi(state0),
                                            {**none, **want}, wrappers,
                                            plains, smi)
        keep(label, launches)
        check_finite(label, out)
        return out, phases

    levels = bh_engine_params(bh_cfg)["levels"]
    drive("1M BH tiles", 30, tile_scatter=30, far_taps=30 * levels,
          tile_sweep_plane=30)
    drive("1M dense hash", 30, window_sweep=30)
    drive("1M sparse hash", 30, tile_scatter=30, tile_sweep_plane=30)
    check(bh_engine_params(bhw_cfg)["near_engine"] == "window",
          "bh_max_level 5 at 1M must select the window engine")
    drive("1M BH window", 10, window_sweep=10, far_taps=10 * 5)
    drive("100K direct", 10, direct_forces=10)
    keep(MONOPOLE, run_monopole(
        bh_cfg, scene, 10,
        {**none, "segment_sum": 10, "tile_scatter": 10,
         "tile_sweep_plane": 10}, wrappers, plains, smi))
    # g-j and the two knobs' mirrors on the other scene
    rates = {}
    for label, mode in FROZEN_PATHS:
        rates[label] = frozen_grid_path(
            label, mode, 30, levels if mode == "bh" else 0, drive, drive_row,
            smi, dev)
    print(f"routing: {json.dumps(rates)}")
    keep(SORT_PATH, sort_path(sorts, {**none, "bitonic_sort": 2}, wrappers,
                              plains, smi))

    # Phase 4: ground truth at step 0
    bh_vs_direct(pos0, mass0, make_force_fn(bh_cfg)(pos0, mass0), bh_cfg,
                 "BH tiles")
    bh_vs_direct(pos0, mass0, make_force_fn(bhw_cfg)(pos0, mass0), bhw_cfg,
                 "BH window")
    bh_vs_direct(pos0, mass0, monopole_forces(bh_cfg)[0](pos0, mass0),
                 bh_cfg, "BH monopole")

    p = hash_engine_params(hash_cfg, pos0)
    check(p["engine"] == "window", f"dense hash engine {p['engine']}")
    acc = make_force_fn(hash_cfg, pos_hint=pos0)(pos0, mass0)
    coords = hash_bin(pos0, 1.0, 64)[2]
    # rows of target blocks whose windows overflowed miss pairs by
    # contract (counted by the audit); the check holds the others
    g = build_sorted_grid(pos0, mass0, coords, 64, with_csort=True)
    ws0, end, over = window_starts(
        g.csort, g.cell_start, d=64, offsets=xy_ball(1), z_hw=1,
        window=p["window"], block_size=p["block"])
    bad_blocks = ((end - ws0) > p["window"]).any(1)
    exclude = torch.zeros(N, dtype=torch.bool, device=dev)
    exclude[g.order] = bad_blocks.repeat_interleave(p["block"])[:N]
    err, scale, med, held = ground_truth_hash(
        pos0, mass0, acc, coords, 2.0, 0.1, 1.0, exclude=exclude)
    print(f"dense hash vs f64 brute force (27 cells, raw r² ≤ 4; {held} "
          f"sampled rows, all {N} sources; step-0 window overflow "
          f"{int(over)}, {int(exclude.sum())} rows in overflowing blocks "
          f"excluded): max|diff| {err:.4e}, max|a| {scale:.4e}, median rel "
          f"err {med:.3e} (tol 1e-4*max|a|: f32 sums of ~10^4 terms)")
    check(err <= 1e-4 * scale, f"dense hash ground truth {err} > 1e-4*max")

    p = hash_engine_params(sparse_cfg, sp_pos)
    check((p["engine"], p["tile_d"], p["tile_k"]) == ("tiles", 56, 16),
          f"sparse hash engine params {p}")
    acc = make_force_fn(sparse_cfg, pos_hint=sp_pos)(sp_pos, sp_mass)
    coords = tiles_bin(sp_pos, 2.0, 56)[1]
    ids = cell_index(coords, 56).to(torch.int32)
    order = torch.argsort(ids, stable=True)
    rank = torch.empty_like(order)
    rank[order] = sorted_ranks(ids[order]).to(order.dtype)
    within = rank < p["tile_k"]
    err, scale, med, held = ground_truth_hash(
        sp_pos, sp_mass, acc, coords, 2.0, 0.1, 1.0, exclude=~within,
        source_ok=within)
    print(f"sparse hash vs f64 brute force (27 cells, raw r² ≤ 4; {held} "
          f"sampled rows within the k = {p['tile_k']} cap, the {N} sources "
          f"minus {int((~within).sum())} past it): max|diff| {err:.4e}, "
          f"max|a| {scale:.4e}, median rel err {med:.3e} (tol 1e-4*max|a|)")
    check(err <= 1e-4 * scale, f"sparse hash ground truth {err} > 1e-4*max")

    # Phase 5: the drift gate, 300 steps in chunks of 100 (one K5 launch
    # per checkpoint; the BH tiles kernels once more for a(t=0))
    steps, chunk = 300, 100
    keep("1M drift gate", drift_phase(
        steps, chunk,
        {**none, "pairwise_potential": 1 + steps // chunk,
         "tile_scatter": steps + 1, "far_taps": (steps + 1) * levels,
         "tile_sweep_plane": steps + 1}, wrappers, plains, smi, dev))
    print(f"launches by path: {by_path}")

    sources = {
        "direct_forces": ("nbody_tpu_torch/csrc/direct.cu",
                          "nbody_tpu/ops/direct.py:157"),
        "tile_scatter": ("nbody_tpu_torch/csrc/scatter.cu",
                         "nbody_tpu/ops/pallas_scatter.py:605"),
        "tile_place": ("nbody_tpu_torch/csrc/scatter.cu",
                       "nbody_tpu/ops/pallas_scatter.py:605"),
        "far_taps": ("nbody_tpu_torch/csrc/far_taps.cu",
                     "nbody_tpu/ops/pallas_far_taps.py:143"),
        "tile_sweep_plane": ("nbody_tpu_torch/csrc/tile_near.cu",
                             "nbody_tpu/ops/pallas_tile_near.py:473"),
        "window_sweep": ("nbody_tpu_torch/csrc/window_sweep.cu",
                         "nbody_tpu/ops/pallas_window_sweep.py:223"),
        "pairwise_potential": ("nbody_tpu_torch/csrc/pair_potential.cu",
                               "nbody_tpu/ops/direct.py:257"),
        "segment_sum": ("nbody_tpu_torch/csrc/segment_sum.cu",
                        "nbody_tpu/ops/pallas_scatter.py:416"),
        "bitonic_sort": ("nbody_tpu_torch/csrc/bitonic_sort.cu",
                         "nbody_tpu/ops/pallas_sort.py:192,217,232"),
        # no TPU kernel: XLA fusions of the JAX table step
        "table_drift": ("nbody_tpu_torch/csrc/table_step.cu",
                        "nbody_tpu/ops/table_step.py:324 (XLA fusion)"),
        "table_kick": ("nbody_tpu_torch/csrc/table_step.cu",
                       "nbody_tpu/ops/table_step.py:399 (XLA fusion)"),
    }
    for name in sources:
        check(bool(by_path[name]), f"{name} never launched on a timed path")
    # launches: the sum over the timed paths; launches_by_path: each
    # path's own count, read just after that path's run
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(by_path[name].values()),
         "launches_by_path": by_path[name], **res[name]}
        for name, (src, rep) in sources.items()
    ]
    print(f"step-0 BH tiles overflow rows: {overflow}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
