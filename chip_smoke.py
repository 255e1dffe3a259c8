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
     (direct forces) at N = 16384, on the 100K direct path's own scene,
     at the Barnes-Hut accuracy gates' 4096 sampled targets against all 1M
     rows and on phase 6's 10K Plummer sphere, two calls bit-equal, with
     its device time by graph replay; K2 (every slot, placed and filler,
     and the counts bit-equal, moments within 1e-5·|x| + 1e-6·max|channel|
     of the twin's terms summed in float64, two calls bit-equal, device
     time by graph replay) and K3 at the Barnes-Hut tiles main path (the
     1M spherical scene, radius 10, seed 42, θ = 0.5 at d = 64, k = 16,
     ws = 1); K4 at the
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
     input (the twin run once), at N = 131072 on the scene's first rows
     and on the 16384 rows the app's sampled estimate draws (kernel:
     median of 3 after 1 warm-up; two calls bit-equal, device time by
     graph replay; bound over the N(N−1)/2 pairs the function needs), K6 (the segment sum) at
     the monopole path's (1M, 4) → (4, 262144), K8 (the bitonic sort) on
     the sort benchmark's 1M keys below 2^18 (numpy seed 0), on the 1M
     Barnes-Hut scene's finest cell ids (d = 64) and at n = 1000, 2^11 + 1
     and 2^17 + 3 (keys and values bit for bit, and the kernels of one
     sort counted in a captured CUDA graph against ``launch_plan``;
     ``torch.sort`` is its library yardstick); K3 at p = 32 and 16 (two calls bit-equal too,
     ``conv3d`` with TF32 off its yardstick at both) and timed at every
     level of a step, with their sum; the far field's downward pass on
     those levels' outputs (``far_down``, bit-equal to its twin, both
     timed with their device times by graph replay); the sort's row
     permutation (``payload_gather``) at the 1M BH tiles rows in the
     scene's order, in sorted order and with the cell coordinates,
     bit-equal to its twin, timed beside it and torch's row gather, each
     with its device time by graph replay; then frozen(fresh meta) against the
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
       a. 1M Barnes-Hut, tiles engine (bh_max_level 6): 30 steps, then
          K2's main form held to its twin at the state they reach (the
          cold collapse: long runs in the centre cells);
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
          holds the engine and knob, else the row-space driver; captured
          segments replayed), then the other driver of the same knob is
          called directly from the same state on captured segments,
          launches counted for both (the table drivers: K2's rank form on
          sorted steps only, its dest form on every repair step, K4 and
          ``table_kick`` every step, ``table_drift`` every step after the
          first, on Barnes-Hut K6 on every step that does not re-sort);
          the two are held to each other (the
          cadence, and the audited re-sort against the row-space steps on
          the table's schedule, within 1e-6 of max|pos| and max|v| on the
          hash and 1e-5 on Barnes-Hut, whose frozen table steps sum the
          moments in another order; repair against sorting every step
          within 1e-4·max|pos|, the JAX package's bound), the traces printed (stale counts,
          re-sorts, rebuilds), and the two, both graphed, timed in turns
          (4 runs each; ``routing measured``: the pairs whose table wins
          by more than the spread of the turns, against
          ``TABLE_ROUTES``); on h also the row-space audited re-sort's
          trace and the cost of its host read of the audit count between
          two replays;
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
     checkpoint;
  6. the CLI entry point (``nbody_tpu_torch.cli``, ``cli_phase``), each
     run counted as the paths of 3 are (its launches: a(t=0), the warm
     chunk and the timed chunks):
       k1. ``python -m nbody_tpu_torch.cli`` with ``--list-algorithms``,
           ``--diagnostics`` and ``--help`` as subprocesses, each to exit 0;
       k2. ``--particles 10000 --method direct-n2 --init plummer
           --benchmark --benchmark-steps 100`` through ``cli.main``: K1
           only, the record printed;
       k3. ``--particles 1000000 --method barnes-hut --benchmark
           --benchmark-steps 30 --export s.nbody``: K2, K3 ×6, K4, steps/s
           of its record beside path a's;
       k4. ``--import s.nbody``: pos, vel and mass bit-equal to k3's final
           state, a(t) bit-equal to ``initialize_forces``;
       k5. ``--init disk`` and ``--init plummer`` at 1M through Barnes-Hut
           tiles, 10 timed steps each: a finite state, and as readings
           (not enforced) ``audit_short_range()``, ms a step and the median
           relative error against K1 (``bh_vs_direct``); K2 held to its
           twin at each final state (``collapse_check``); then
           ``--method spatial-hash --benchmark-steps 30`` at 1M (K7),
           steps/s beside path b's;
       k6. ``HAVE_HDF5``: without h5py, ``--export x.h5`` must exit non-zero
           with the ``SerializationError`` text and write nothing; with it,
           a round trip;
       k7. ``ParticleSystem.compute_potential_energy`` at 100K: one K5
           launch and no twin, K5 held to its twin there (``k5_held``);
  7. rendering (``render_phase``):
       r1. R1 (``render_points``, the point splat) against its twin on the
           1M Barnes-Hut step-0 scene at 1280x720, at the app's camera and
           a close one (distance 5: radii 2-8, points behind the eye and
           off screen), in each color mode: px, py, size and colours bit
           for bit, the image and its uint8 copy bit for bit against the
           twin's point-order sum and against a second call, within 1e-5
           of the twin's terms summed in float64; call and graph-replay
           time, kernels a call, the byte bound, the tiles' list entries
           and the longest list;
       r2. ``python -m nbody_tpu_torch.cli --particles 1000000 --method
           barnes-hut --render --render-output DIR --steps 30`` as a
           subprocess: exit 0 and exactly frame_00000..frame_00028.png,
           each decoded with the standard library to 720x1280x3 with
           something drawn; the same run in this process, counted (R1 29
           times), then ``--render`` alone and the plain loop: frames/s of
           each loop and ms a frame for the step, R1, the copy and the PNG
           write; the last frame equal in every value to R1's on the
           state after 29 updates made again here;
       r3. ``--live --steps 10`` as a subprocess: one clear and 9 frames;
           ``TerminalView.compose`` on the card equals it on the host copy;
       r4. ``PointStream`` on the card: a request then two steps, and
           ``latest()`` is the state at request time bit for bit;
           ``verify_data_integrity``;
  8. the sharded paths (``nbody_tpu_torch.parallel``, ``sharded_phase``)
     on ``make_mesh(4, devices=[card] * 4)``: four virtual shards of the
     one card, NOT a scaling number (the card does every position's work
     in turn, 4x the replicated far field, and the collectives are
     device-local copies). s1-s3 each step through
     ``sharded_multi_step`` on the step's captured segments (one a stage,
     each captured after its first eager use, the collectives run between
     replays, ``parallel/program.py``) and through the same stages
     eagerly, 10 steps from one state: after an eager warm run the graphed
     first call is counted as the paths of 3 are (one capture a segment,
     its replays adding the launches), it and a replay-only call are held
     to two eager runs bit for bit (and those to each other), and both
     are timed in turns (median of 3), with the segments and collectives
     a step, the capture ms and the pool:
       s1. 100K direct through the ring (K1's ``targets=`` form, P² = 16
           launches a force call, 4 on each position): a(0) within
           2e-4·max|a| of single-device K1, then 10 steps;
       s2. tree-slabs, the 1M Barnes-Hut headline scene (d 64, S 16,
           near_k 16, ws 1): at step 0 the routing overflow 0 (from the
           routing alone at the default capacity N/P), the tile overflow
           equal to the single-device ``audit_short_range()``, the rows
           within k within 1e-4·max|a| of the single-device tiles engine,
           and the 0.05 accuracy gate against K1 (``bh_vs_direct``); then
           10 steps (K3 6 × 4, K4's slab form 4 and K6 4 a force call: each
           position's finest moments over its cell-sorted rows);
       s4. ``sharded_energy`` on s2's state after its steps: K5's main
           form 4 times and its cross form 6 (each block pair once), KE
           and PE within 1e-6 relative of
           ``kinetic_energy`` and K5's main form on the gathered state;
       s3. hash-slabs, the 1M sparse hash scene (cube of side 100, cell
           2.0, cutoff 2.0, grid 64, 64 a cell): overflow 0, 4096 sampled
           rows within 1e-4·max|a| of the float64 brute force with phase
           4's predicate, then 10 steps;
       s5. K4's slab form at one position's slab of s2 and of s3 (the
           inputs of the path's own call, ``capture_slabs``) and K5's
           cross form at one (N/P) × (N/P) block pair of s4, each against
           its twin, two calls bit-equal, timed (graph replay too), with
           its bound;
       s6. ``shard_devices=2`` on one card raises ``ValidationError``
           naming both counts and ``cli.main([... "--devices", "2",
           "--benchmark"])`` returns 2, and the cross-card graphed run is
           reported skipped; with 2 or more cards instead, the facade on
           ``shard_devices=min(4, count)`` (a segment set a card, the
           cross-card copies between replays) graphed against eager on
           1M BH, bit for bit and timed, then the 1M BH benchmark through
           ``--devices min(4, count)``.
  9. the mesh across processes (``rank_phase``): after the parent built
     the kernels, 4 ranks on the one card (``python3 chip_smoke.py --rank
     OUT gloo``, started by ``parallel.distributed.run_ranks`` with a
     deadline; any rank's failure kills the others and fails the phase),
     a gloo group on a free loopback port, each rank running
     ``ParticleSystem`` with ``shard_devices=4`` on a mesh across them,
     one position a rank — 4 ranks on one card: not a scaling number.
     m1-m3 run ``run_steps`` on the facade's captured segments on every
     rank, the collectives (through host memory on gloo) between replays;
     the first call's launches are counted and checked on every rank, it
     and a replay-only call are held to an eager run of the same ranks
     bit for bit, and both are timed in turns (median of 3); rank 0
     prints graphed / eager steps/s, ms a step and each rank's launches;
     this process then checks the ranks' outputs (in a temporary
     directory, removed afterwards):
       m1. 100K direct, ring: a(0) bit-equal to phase 8's s1 and within
           2e-4·max|a| of single-device K1, then 10 steps;
       m2. the 1M BH headline scene: at step 0 routing overflow 0, the
           tile overflow equal to the single-device audit, the rows within
           k within 1e-4·max|a| of the tiles engine, the 0.05 gate against
           K1; then 5 steps;
       m3. the 1M sparse hash, hash-slabs (grid 64, k 64): overflow 0 on
           every rank, 4096 rows within 1e-4·max|a| of the float64 brute
           force, then 5 steps;
       m4. ``sharded_energy`` on m2's state after its steps (K5's main
           form once a rank, its cross form twice on ranks 0 and 1 and
           once on 2 and 3): KE and PE the same on every rank, within 1e-6
           relative of
           ``kinetic_energy`` and K5's main form;
       m5. ``save_checkpoint`` of that state at step 5 by the ranks,
           restored across them with their state as template, here without
           a template and onto a 2-position one-process mesh, all bit-
           equal.
     With 4 or more cards the phase runs again on NCCL, one rank a card;
     on one card it says that run is skipped.
 10. the 4M flagship (``flagship_phase``) through the functions of
     ``scripts/flagship_4m_torch.py``, each part counted:
       f1. bh-4m: 4M spherical scene, d 64, near_k 40, sorted stepping (a
           warm run and the best of 3 runs of 15 steps), the audit's
           overflow, BH against K1 on 4096 sampled rows (median < 0.05);
       f2-f4. at its initial state K2 at k 40 (``k2_check``), K3 at every
           level (``k3_checks``), K4 at k 40 with the far seed (bricks of 3
           cells; ``k4_check``) and K1 at the gate's 4096 × 4M
           (``k1_check``) against their twins;
       f5. galaxy-4m: 7 R1 frames (960×540, every 4th row) around 6
           chunks of 5 sorted steps, written as PNGs in a temporary
           directory; the last frame rendered twice (checksums equal),
           equal to its PNG and bit-equal to R1's ordered twin, timed;
       f7. ``sorted_verlet_step`` with ``route_extra`` False and True for
           10 steps of 1M BH tiles and of the 1M sparse hash, both bit-
           equal to ``make_sorted_multi_step`` from the same state.
 11. one-program stepping (``graph_phase``): on the card the facade's
     ``run_steps`` and ``update()`` replay one captured CUDA graph of the
     step (``ops/step_graph.py``). For 1M BH tiles, 1M BH monopole (a
     ``StepGraph`` of its sorted step: the facade never selects it), the
     1M dense and sparse hash, 1M BH window and 100K direct, 10 steps of
     the graphed function (its first call: an eager step, the capture,
     replays; then a replay-only call) against the eager multi-step
     function of the same force from one state and two eager runs, all
     bit for bit; both timed in turns (median of 3); the
     capture time and memory pool; the graph's kernel nodes equal to an
     eager step's kernels plus the copy-back's. Then ``update()`` x10 on
     1M BH tiles (bit-equal, ms an update: the render loop's step), the
     cache (a second ``run_steps`` captures nothing; ``set_time_step`` and
     ``set_softening`` each force one capture and equal a fresh eager run;
     a state handed out earlier is unchanged); the ten frozen-grid
     drivers (``frozen_graph_phase``: the row-space cadence 8 and audited
     re-sort 0.01, the table cadence, audited re-sort and repair, on 1M
     Barnes-Hut tiles and the 1M sparse hash, 30 steps) on captured
     segments against the same driver eager from one state, state and
     trace bit for bit, host reads a run equal, timed in turns, with
     their captures, shared pool and side bucket (on the Barnes-Hut cold
     collapse the side bucket must grow: every segment captured again,
     still equal); the facade's cache of those graphs; and bh-4m through
     the graphed facade against its eager stepping (bit-equal, best of
     3).

Launch counts on graphed paths: a replay calls no wrapper, so the captured
step adds the launches its capture recorded once per replay
(``_build.COUNTED``) and the capture itself counts none; the counts and
their expectations are the kernel launches that ran, as before. ``run_path``
calls ``reset()`` between the warm and the timed run, which drops the
graph: the timed run's first step is eager, then the capture (its time
printed) and the replays.

It stops at the first failed check with a non-zero exit. It needs one CUDA
card and exits non-zero without one. The last two lines of its output are
the kernels' JSON record (per kernel: its numbers at its first shape, each
shape's under ``shapes``, the launches summed over the timed paths and
each path's own under ``launches_by_path``) and the device JSON line.
"""

import contextlib
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
N = 1_000_000
FP32_OPS = 67e12   # H100 SXM FP32 outside the tensor cores, op/s
TF32_OPS = 495e12  # H100 SXM TF32 on the tensor cores, dense, op/s
HBM_BYTES = 3.35e12  # H100 SXM HBM3, byte/s
PAIR_OPS = 20      # FP32 operations of one softened pair test
# H100 SXM rsqrt rate of the MUFU: 16 a clock an SM, 132 SMs at 1.98 GHz
MUFU_RSQRT = 132 * 16 * 1.98e9


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
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    kernels = kernel_nodes(graph)
    del graph
    return kernels


def kernel_nodes(graph) -> int:
    """The kernel nodes of a captured ``torch.cuda.CUDAGraph`` made with
    ``keep_graph=True``, counted through the driver API."""
    import ctypes

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
    """K2 against its plain twin → (tiles, moments, overflow): every slot
    (placed and filler) and the counts bit-equal, moments within
    1e-5·|x| + 1e-6·max|channel| of the twin's terms summed in float64
    (``accumulate="f64"``: a float32 sum of a run of ~10³ rows, in the
    twin's order or any other, is off by more than that), two calls
    bit-equal; kernel, plain (float32 sums) and device (graph replay)
    times."""
    import torch

    from nbody_tpu_torch.ops.scatter import tile_scatter, tile_scatter_plain

    n = grid.psort.shape[0]
    args = (grid.psort, grid.cell_start, lo, cell)
    tk, mk = tile_scatter(*args, d=d, k=k)
    tp, mp = tile_scatter_plain(*args, d=d, k=k, accumulate="f64")
    counts = mp[10].float()
    check(torch.equal(mk[10], counts), f"K2 {label}: counts differ from plain")
    live = (torch.arange(k, device=counts.device)[:, None]
            < counts.reshape(1, -1)).reshape(k, d, d * d).permute(1, 0, 2)
    live = live[:, None].expand(d, 4, k, d * d)
    check(torch.equal(tk[live], tp[live]),
          f"K2 {label}: placed slots not bit-equal")
    fill_err = float((tk[~live] - tp[~live]).abs().max())
    check(fill_err == 0.0, f"K2 {label}: filler centres off by {fill_err}")
    mom_err = (mk.double() - mp).abs()
    mom_tol = 1e-5 * mp.abs() + 1e-6 * mp.abs().amax(dim=1, keepdim=True)
    share = float((mom_err / mom_tol.clamp(min=1e-300)).max())
    check(bool((mom_err <= mom_tol).all()),
          f"K2 {label}: moments differ by {float(mom_err.max())}, "
          f"{share:.3f} of the tolerance")
    again = tile_scatter(*args, d=d, k=k)
    check(torch.equal(again[0], tk) and torch.equal(again[1], mk),
          f"K2 {label}: two calls differ")
    overflow = int(torch.clamp(counts - k, min=0).sum())
    nc = d ** 3
    rec = dict(
        max_abs_err=max(fill_err, float(mom_err.max())),
        ms=time_ms(lambda: tile_scatter(*args, d=d, k=k)),
        device_ms=graph_ms(lambda: tile_scatter(*args, d=d, k=k)),
        plain_ms=time_ms(lambda: tile_scatter_plain(*args, d=d, k=k)),
        # psort in, cell_start in, tiles + moments out; ~20 ops per row
        **bound(20 * n, 16 * n + 4 * (nc + 1) + 16 * k * nc + 44 * nc),
        library_ms=None,
    )
    add_shape(res, "tile_scatter", label, rec)
    print(f"K2 tile_scatter {label} (d={d}, k={k}): slots (placed and "
          f"filler) bit-equal, moments max|diff| {float(mom_err.max()):.3e}"
          f", {share:.4f} of the tolerance "
          f"(1e-5*|x| + 1e-6*max|ch| of the f64 sum), counts equal, two calls "
          f"bit-equal; overflow {overflow} rows, longest cell "
          f"{int(counts.max())} rows; kernel {rec['ms']:.4f} ms, device "
          f"{rec['device_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return tk, mk, overflow


def collapse_check(res, state, cfg, label):
    """K2's main form (``k2_check``) at a Barnes-Hut tiles state after
    its timed steps, recorded as K2's shape ``label``: the BH tiles path's
    cold collapse, whose centre cells hold long runs (up to ~10² rows,
    ~1.3·10⁵ rows past k), and the disk and Plummer scenes of phase 6."""
    from nbody_tpu_torch.ops.barnes_hut import bh_engine_params, bin_particles
    from nbody_tpu_torch.ops.sorted_window import build_sorted_grid

    p = bh_engine_params(cfg)
    d = 1 << p["levels"]
    lo, cell, coords = bin_particles(state.pos, p["levels"])
    grid = build_sorted_grid(state.pos, state.mass, coords, d)
    k2_check(res, label, grid, lo, cell, d=d, k=p["near_k"])


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
    with coverage and the 3 velocity channels (as ``table_step._sort_rows``
    places them; N(0, 1) here); the dest form on a repair-sized mover set
    (``REPAIR_CAP`` rows each sent one cell up in x and ranked above the
    target's high-water mark, as ``table_step._repair_step`` places them,
    so arrivals to full cells are denied), moved inside that table with
    its row bookkeeping and high-water marks; then ``table_drift`` with the
    audit (velocities 20·N(0, 1), so a few percent of rows change cell)
    and ``table_kick`` on that table. Coverage and extra planes bit-equal,
    placed slots bit-equal, filler centres bit-equal in the rank form and
    within 1e-6·cube after the moves; moments and two calls as
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
    check(fill == 0.0, f"{what}: filler centres off by {fill}")
    check(all(torch.equal(a, b) for a, b in
              zip(tile_scatter(*args, **kw), (tk, mk, ck, xk))),
          f"{what}: two calls differ")
    rec = dict(
        max_abs_err=max(fill, float(mom_err.max())),
        ms=time_ms(lambda: tile_scatter(*args, **kw)),
        device_ms=graph_ms(lambda: tile_scatter(*args, **kw)),
        plain_ms=time_ms(lambda: tile_scatter_plain(*args, **kw)),
        # psort + extra + cell_start in; tiles, cov, extra planes and
        # moments out; ~20 ops per row
        **bound(20 * n, 16 * n + 12 * n + 4 * (nc + 1)
                + (4 + 1 + 3) * 4 * k * nc + 44 * nc),
        library_ms=None,
    )
    add_shape(res, "tile_scatter", f"{label}, coverage + 3 extra", rec)
    print(f"{what} (d={d}, k={k}): slots (placed and filler), coverage "
          f"and extra planes bit-equal to plain, moments max|diff| "
          f"{float(mom_err.max()):.3e}, two calls bit-equal; kernel "
          f"{rec['ms']:.4f} ms, device {rec['device_ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})")

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
    """K4 against its plain twin at its three 1M shapes (``k4_inputs``)."""
    for label, tk, kw in k4_inputs(pos, mass, cfg, sp_pos, sp_mass):
        k4_check(res, label, tk, kw)


def k4_check(res, label, tk, kw):
    """K4 against its plain twin at one shape (2e-5·max|out|), two calls
    bit-equal, timed (one call, and its device time by graph replay)."""
    import torch
    import torch.nn.functional as F

    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops.tile_near import (
        tile_sweep_plane,
        tile_sweep_plane_plain,
    )

    d, k, ws, counts = kw["d"], kw["k"], kw["ws"], kw["counts"]
    ok_ = tile_sweep_plane(tk, **kw)
    op_ = tile_sweep_plane_plain(tk, **kw)
    e = float((ok_ - op_).abs().max())
    tol = 2e-5 * float(op_.abs().max())
    del op_
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
            for f in range(4)]
    print(f"K4 tile_sweep_plane {label} (d={d}, k={k}, ws={ws}, "
          f"cutoff2={kw.get('cutoff2')}, far plane "
          f"{'on' if n_far else 'off'}; bz, rows_cap, group_cols, smem = "
          f"{plan}): max|diff| {e:.3e} (tol "
          f"2e-5*max|out| = {tol:.3e}; dead slots are 0 in both); two "
          f"calls bit-equal; live slot pairs {pairs:.0f}; kernel "
          f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f} ms, "
          f"{pairs / rec['device_ms'] * 1e3:.4e} pairs/s), plain "
          f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})")
    return plan


def k1_inputs(pos, mass, cfg, dev):
    """K1's inputs at its four shapes, as ``[(label, pos, mass,
    targets)]``: N = 16384 all pairs (the first rows of the 1M scene), the
    100K direct path's own scene all pairs, the Barnes-Hut accuracy
    gates' 4096 sampled targets (``bh_vs_direct``) against all 1M rows,
    and the 10K Plummer sphere of phase 6's k2 (``K2_ARGV``)."""
    import torch

    from nbody_tpu_torch.cli import parse_app_cli_options
    from nbody_tpu_torch.models.distributions import init_from_config

    n1 = 16384
    s100 = init_from_config(path_configs()["100K direct"], device=dev)
    s10 = init_from_config(parse_app_cli_options(K2_ARGV).to_config(),
                           device=dev)
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
        (f"N = {s10.pos.shape[0]} (k2 CLI Plummer)", s10.pos, s10.mass, None),
    ]


def k1_checks(res, pos, mass, cfg, dev):
    """K1 against its plain twin at its four shapes (``k1_inputs``)."""
    for label, p1, m1, tgt in k1_inputs(pos, mass, cfg, dev):
        k1_check(res, label, p1, m1, tgt, cfg.G, cfg.softening)


def k1_check(res, label, p1, m1, tgt, G, eps, block_size=256):
    """K1 against its plain twin at one shape (1e-5·max|a|; the twin
    blocked by ``block_size`` targets), two calls bit-equal, timed (one
    call, and its device time by graph replay)."""
    import torch

    from nbody_tpu_torch.ops.direct import direct_forces, direct_forces_kernel

    def kern():
        return direct_forces_kernel(p1, m1, G, eps, targets=tgt)

    def plain():
        return direct_forces(p1, m1, G, eps, targets=tgt,
                             block_size=block_size)

    ok_, op_ = kern(), plain()
    e = float((ok_ - op_).abs().max())
    tol = 1e-5 * float(op_.abs().max())
    check(e <= tol, f"K1 direct {label}: max|diff| {e} > {tol}")
    check(torch.equal(ok_, kern()), f"K1 direct {label}: two calls differ")
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
    from nbody_tpu_torch.ops.barnes_hut import (
        bh_engine_params,
        bin_particles,
        pyramid_from_packed,
    )
    from nbody_tpu_torch.ops import table_step as T
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
    payload_gather_check(res, label, pos, mass, coords, grid, d)

    # K2: placement + moments + counts; the table forms
    tk, mk, overflow = k2_check(res, label, grid, lo, cell, d=d, k=k)
    k2_table_checks(res, label, grid, lo, cell,
                    T.bh_table_params(cfg.G, cfg.softening,
                                      cfg.barnes_hut_theta, levels=levels,
                                      near_k=k))

    pyr = pyramid_from_packed(mk[:10].T.reshape(d, d, d, 10), lo, cell,
                              levels)
    k3_checks(res, label, pyr, cell, ws=ws, eps=eps, levels=levels)
    far_down_check(res, label, pyr, cell, ws=ws, eps=eps, levels=levels)

    return overflow


def payload_gather_check(res, label, pos, mass, coords, grid, d):
    """The sort's row permutation at the 1M shapes of ``build_sorted_grid``
    on ``label``'s rows: the scene's own order (a full permutation, the
    plain step), the sorted rows as views of ``grid.psort`` (the sorted
    step's carried state: the identity) and those with the cell
    coordinates (the hash's form). The kernel against its plain twin bit
    for bit, two calls bit-equal; kernel, twin and torch's one-call row
    gather of the [pos | mass] table (``index``, the library yardstick)
    timed, each with its device time by graph replay; recorded as
    ``payload_gather``'s shapes. Bound: order, pos, mass and the ids read
    and psort, ids (and the cell coordinates) written once."""
    import torch

    from nbody_tpu_torch.ops.payload_gather import (
        payload_gather,
        payload_gather_plain,
    )
    from nbody_tpu_torch.ops.sorted_window import cell_ids

    sp, sm = grid.psort[:, :3], grid.psort[:, 3]
    forms = (("scene order", pos, mass, coords, False),
             ("sorted rows", sp, sm, coords[grid.order], False),
             ("sorted rows, cell coordinates", sp, sm, coords[grid.order],
              True))
    for form, p, m, c, with_csort in forms:
        ids = cell_ids(c, d)
        order = torch.argsort(ids, stable=True)
        args = (p, m, ids, order, d, None, with_csort)
        got = payload_gather(*args)
        want = payload_gather_plain(*args)
        check(all((g is None and w is None) or torch.equal(g, w)
                  for g, w in zip(got, want)),
              f"payload_gather ({form}): kernel and plain twin differ")
        check(all(g is None or torch.equal(g, a)
                  for g, a in zip(got, payload_gather(*args))),
              f"payload_gather ({form}): two calls differ")
        table = torch.cat([p, m[:, None]], dim=-1)
        n = ids.shape[0]
        nbytes = n * (8 + 12 + 4 + 4 + 16 + 4 + (12 if with_csort else 0))
        rec = dict(
            max_abs_err=0.0, ms=time_ms(lambda: payload_gather(*args)),
            device_ms=graph_ms(lambda: payload_gather(*args)),
            plain_ms=time_ms(lambda: payload_gather_plain(*args)),
            plain_device_ms=graph_ms(lambda: payload_gather_plain(*args)),
            **bound(0, nbytes),
            library_ms=time_ms(lambda: table[order]),
            library_device_ms=graph_ms(lambda: table[order]),
            identity_rows=int((order == torch.arange(
                n, device=order.device)).sum()),
        )
        add_shape(res, "payload_gather", f"{label}, {form}", rec)
        print(f"payload_gather {label}, {form} (N={n}, "
              f"{rec['identity_rows']} rows in place): bit-equal to the plain "
              f"twin, two calls bit-equal; kernel {rec['ms']:.4f} ms (device "
              f"{rec['device_ms']:.4f} ms), plain {rec['plain_ms']:.4f} ms "
              f"(device {rec['plain_device_ms']:.4f} ms), torch index "
              f"{rec['library_ms']:.4f} ms (device "
              f"{rec['library_device_ms']:.4f} ms), bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")


def k3_checks(res, label, pyr, cell, *, ws, eps, levels):
    """K3 (far taps) at every level of one BH tiles step on the pyramid
    ``pyr``: timed at each level; at p = 32 and 16 (the two finest)
    against the twin and ``conv3d`` and called twice, recorded as K3's
    shapes ``label p = ...``."""
    import torch
    import torch.nn.functional as F

    from nbody_tpu_torch.ops.barnes_hut import (
        level_moments,
        level_tap_matrices,
    )
    from nbody_tpu_torch.ops.far_taps import far_taps, far_taps_plain

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
    print(f"K3 far_taps over the {levels} levels of one {label} step: "
          f"{k3_sum:.4f} ms (sum of per-level medians)")


def far_down_check(res, label, pyr, cell, *, ws, eps, levels):
    """The far field's downward pass on K3's outputs of every level of
    one BH tiles step: the kernel against its plain twin (the torch
    composition) bit for bit, two calls bit-equal; both timed, each with
    its device time by graph replay; recorded as ``far_down``'s shape
    ``label``. Bound: the finest level's K3 output read and the plane
    written once."""
    import torch

    from nbody_tpu_torch.ops.barnes_hut import _far_taps_levels
    from nbody_tpu_torch.ops.far_down import far_down, far_down_plain

    outs = _far_taps_levels(pyr, ws, eps, levels)
    got = far_down(outs, cell)
    check(torch.equal(got, far_down_plain(outs, cell)),
          "far_down: kernel and plain twin differ")
    check(torch.equal(got, far_down(outs, cell)), "far_down: two calls differ")
    rec = dict(
        max_abs_err=0.0, ms=time_ms(lambda: far_down(outs, cell)),
        device_ms=graph_ms(lambda: far_down(outs, cell)),
        plain_ms=time_ms(lambda: far_down_plain(outs, cell)),
        plain_device_ms=graph_ms(lambda: far_down_plain(outs, cell), reps=3),
        **bound(0, 4 * (outs[-1].numel() + got.numel())), library_ms=None,
    )
    add_shape(res, "far_down", label, rec)
    print(f"far_down levels={levels} d={got.shape[0]}: bit-equal to the "
          f"plain twin, two calls bit-equal; kernel {rec['ms']:.4f} ms "
          f"(device {rec['device_ms']:.4f} ms), plain {rec['plain_ms']:.4f} "
          f"ms (device {rec['plain_device_ms']:.4f} ms), bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")


def k5_held(res, label, p, m, G, eps, plain_reps):
    """K5 (the all-pairs potential) against its plain twin on (p, m) at
    relative 1e-5 (rsqrtf and torch.rsqrt differ by ulps on each term, the
    sums are float64 in both), two calls bit-equal, recorded as K5's shape
    ``label``: kernel time the median of 3 calls after 1 warm-up, device
    time by graph replay, the twin's the median of ``plain_reps`` calls
    (one call when 0). The bound counts the N(N−1)/2 pairs the function
    needs; the N² figure of the kernel that took every pair twice, and the
    MUFU's rsqrt ceiling for those pairs, are kept beside it."""
    import torch

    from nbody_tpu_torch.ops.direct import (
        pairwise_potential,
        pairwise_potential_plain,
    )

    n = p.shape[0]
    out = pairwise_potential(p, m, G, eps)
    got = float(out)
    check(torch.equal(out, pairwise_potential(p, m, G, eps)),
          f"K5 pairwise_potential {label}: two calls differ")
    if plain_reps:
        want = float(pairwise_potential_plain(p, m, G, eps))
        plain_ms = time_ms(lambda: pairwise_potential_plain(p, m, G, eps),
                           reps=plain_reps, warm=1)
    else:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        twin = pairwise_potential_plain(p, m, G, eps)
        b.record()
        b.synchronize()
        want, plain_ms = float(twin), a.elapsed_time(b)
    rel = abs(got - want) / abs(want)
    check(rel <= 1e-5, f"K5 pairwise_potential {label}: rel diff {rel}")
    pairs = n * (n - 1) / 2
    # pos + mass in, one partial a block out (at most one a tile pair)
    nbytes = 16 * n + 8 * -(-n // 256)
    rec = dict(
        max_abs_err=abs(got - want),
        ms=time_ms(lambda: pairwise_potential(p, m, G, eps), reps=3,
                   warm=1),
        device_ms=graph_ms(lambda: pairwise_potential(p, m, G, eps),
                           reps=1 if n > 500_000 else 10),
        plain_ms=plain_ms,
        **bound(PAIR_OPS * pairs, nbytes),
        bound_n2_ms=bound(PAIR_OPS * n * n, nbytes)["bound_ms"],
        mufu_ms=pairs / MUFU_RSQRT * 1e3,
        library_ms=None,
    )
    add_shape(res, "pairwise_potential", label, rec)
    print(f"K5 pairwise_potential {label}: kernel {got:.9e}, plain "
          f"{want:.9e}, rel diff {rel:.3e} (tol 1e-5); two calls bit-equal; "
          f"kernel {rec['ms']:.4f} ms (median of 3; device "
          f"{rec['device_ms']:.4f} ms), plain {plain_ms:.4f} ms "
          f"({'median of %d' % plain_reps if plain_reps else 'one call'}"
          f"), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; N(N-1)/2 "
          f"= {pairs:.0f} pairs; the N² figure {rec['bound_n2_ms']:.4f} ms), "
          f"MUFU rsqrt ceiling {rec['mufu_ms']:.4f} ms")
    return got


def k5_check(res, pos, mass, cfg):
    """K5 (``k5_held``) on the drift gate's own step-0 input (the Hénon
    sphere at N = 1M; the twin run once, ~1 min), at N = 131072 on the BH
    scene's first rows, and at the app's sampled estimate: the 16384 rows
    ``sampled_potential_energy`` draws from the BH scene."""
    import torch

    from nbody_tpu_torch.drift import drift_config, henon_sphere

    n = pos.shape[0]
    dcfg = drift_config(n)
    h = henon_sphere(n, pos.device)
    k5_held(res, f"N = {n} (drift gate)", h.pos, h.mass, dcfg.G,
            dcfg.softening, 0)
    del h
    n1 = 131072
    k5_held(res, f"N = {n1}", pos[:n1].contiguous(), mass[:n1].contiguous(),
            cfg.G, cfg.softening, 3)
    gen = torch.Generator(device=pos.device)
    gen.manual_seed(0)  # sampled_potential_energy's default draw
    idx = torch.randperm(n, generator=gen, device=pos.device)[:16384]
    k5_held(res, "N = 16384 (sampled estimate)", pos[idx], mass[idx],
            cfg.G, cfg.softening, 7)


def k6_check(res, pos, mass, cfg):
    """K6 (the segment sum) against its plain twin at the shapes its paths
    give it: the monopole path's sorted rows' [m, m·x] (1M, 4) into the
    d³ = 262144 finest cells, and the BH window engine's order-2 rows
    [m, m·xr, m·xr⊗xr] (1M, 10) into its 32768 (``bh_max_level`` 5).
    Each within max |diff| <= 1e-6·max|out| of the twin on float64 copies
    of the rows (the float32 twin's ``index_add_`` adds with atomics in no
    fixed order; its difference is printed beside), two calls bit-equal;
    ``index_add_`` of the same rows is the library yardstick."""
    import torch

    from nbody_tpu_torch.ops.barnes_hut import (
        _moment_rows,
        bh_engine_params,
        bin_particles,
    )
    from nbody_tpu_torch.ops.scatter import segment_sum, segment_sum_plain
    from nbody_tpu_torch.ops.sorted_window import build_sorted_grid

    for label, levels, order in (
            (MONOPOLE, bh_engine_params(cfg)["levels"], 1),
            ("1M BH window", 5, 2)):
        d = 1 << levels
        nc = d ** 3
        lo, cell, coords = bin_particles(pos, levels)
        g = build_sorted_grid(pos, mass, coords, d, with_csort=True)
        ctr = lo + (g.csort.to(pos.dtype) + 0.5) * cell
        vals = _moment_rows(g.psort[:, :3], g.psort[:, 3], ctr,
                            order).contiguous()
        ch = vals.shape[1]
        ids = g.ids
        got = segment_sum(vals, ids, nc)
        want = segment_sum_plain(vals.double(), ids, nc)
        e = float((got.double() - want).abs().max())
        tol = 1e-6 * float(want.abs().max())
        check(e <= tol, f"K6 segment_sum {label}: max|diff| {e} > {tol}")
        e32 = float((got - segment_sum_plain(vals, ids, nc)).abs().max())
        check(torch.equal(got, segment_sum(vals, ids, nc)),
              f"K6 segment_sum {label}: two calls differ")
        ids64 = ids.to(torch.int64)

        def library():
            return torch.zeros((nc, ch), device=pos.device).index_add_(
                0, ids64, vals)

        n = vals.shape[0]
        rec = dict(
            max_abs_err=e,
            ms=time_ms(lambda: segment_sum(vals, ids, nc)),
            device_ms=graph_ms(lambda: segment_sum(vals, ids, nc), reps=20),
            plain_ms=time_ms(lambda: segment_sum_plain(vals, ids, nc)),
            # ~ch adds per row; vals + dest in, (ch, d³) out
            **bound(ch * n, 4 * ch * n + 4 * n + 4 * ch * nc),
            library_ms=time_ms(library),
            library_device_ms=graph_ms(library, reps=20),
        )
        add_shape(res, "segment_sum", label, rec)
        print(f"K6 segment_sum {label} ({n}, {ch}) -> ({ch}, {nc}): "
              f"max|diff| {e:.3e} against the float64 twin (tol "
              f"1e-6*max|out| = {tol:.3e}), {e32:.3e} against the float32 "
              f"twin; two calls bit-equal; kernel {rec['ms']:.4f} ms a call "
              f"({rec['device_ms']:.4f} ms of device time, CUDA graph "
              f"replay), plain {rec['plain_ms']:.4f} ms, library (zeros + "
              f"index_add_) {rec['library_ms']:.4f} ms a call "
              f"({rec['library_device_ms']:.4f} ms of device time), bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        del g, vals, got, want


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


def bh_vs_direct(pos, mass, acc_bh, cfg, label, gate=True):
    """BH against the direct kernel (ground truth) on 4096 sampled rows
    with all sources: median relative error < 0.05, enforced when
    ``gate``, else printed as a reading. Returns the median."""
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
          f"{float(rel.max()):.4e} ("
          f"{'gate: median < 0.05' if gate else 'reading; 0.05 not enforced'})")
    if gate:
        check(med < 0.05, f"{label} median relative error {med} >= 0.05")
    return med


# steps/s of every counted run, by label
RATES = {}


def counted_run(label, steps, run, want, wrappers, plains, smi):
    """Every count set to 0, ``run()`` timed (host clock to a synchronize),
    the counts read: checks the launches and that no plain twin ran,
    prints steps/s (kept in ``RATES``), phases and launches. Returns
    (launches, run's result, phases)."""
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
    RATES[label] = steps / wall
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
    for kind, g in ps.step_graphs.items():
        # reset() dropped the warm run's graphs: the timed run captured them
        print(f"  {kind}: {describe_graphs(g)}")
    check_finite(label, ps.state)
    check(abs(ps.simulation_time - steps * cfg.dt) < 1e-6,
          f"{label}: simulation time did not advance")
    print(f"  audit_short_range: {ps.audit_short_range()}")
    return launches, phases, ps, state0, info


def describe_graphs(g) -> str:
    """One line on a facade's captured step (``StepGraph``) or a frozen-
    grid driver's captured segments (``SegmentGraphs``)."""
    from nbody_tpu_torch.ops.step_graph import SegmentGraphs

    if not isinstance(g, SegmentGraphs):
        return (f"one step captured in {g.capture_ms:.1f} ms (after its "
                f"eager first step), then {g.replays} replays; pool "
                f"{g.pool_bytes / 2**20:.1f} MiB")
    segs = "; ".join(f"{key} {s.capture_ms:.1f} ms, {s.replays} replays"
                     for key, s in g.segments.items())
    return (f"{g.captures} segment captures ({segs}); shared pool "
            f"{g.pool_bytes / 2**20:.1f} MiB; {g.host_reads} host reads; "
            f"side bucket {g.state or None}")


def table_multi(tp, cfg, knob, steps, trace=False, graphs=None):
    """The table driver the facade's rule names for ``cfg``'s knob, with
    its caps (repair: ``REPAIR_CAP`` movers, cadence cap ``resort_every``
    or 64; audited: cap ``resort_every`` or 16), on ``graphs`` (captured
    segments) or eager."""
    from nbody_tpu_torch.ops import table_step as T

    cad = cfg.resort_every
    if knob == "repair":
        return T.make_table_repair_multi_step(
            tp, cfg.dt, steps, repair_cap=REPAIR_CAP,
            max_cadence=cad if cad > 1 else 64, with_trace=trace,
            graphs=graphs)
    if knob == "stale_frac":
        return T.make_table_adaptive_multi_step(
            tp, cfg.dt, steps, max_stale_frac=cfg.resort_stale_frac,
            max_cadence=cad if cad > 1 else 16, with_trace=trace,
            graphs=graphs)
    return T.make_table_multi_step(tp, cfg.dt, steps, cad, graphs=graphs)


def row_multi(sf, cfg, knob, steps, trace=False, graphs=None):
    """The row-space driver of the same knob: the cadence, the lagged
    audited re-sort (cap 16), on ``graphs`` (captured segments) or eager;
    or for repair a sort every step (the JAX facade's choice off its
    accelerator, and what repair is exact to), on a ``StepGraph`` of the
    sorted step where ``graphs`` is given."""
    from nbody_tpu_torch.ops import integrator as I
    from nbody_tpu_torch.ops.step_graph import StepGraph

    if knob == "cadence":
        return I.make_resort_multi_step(sf, cfg.dt, steps, cfg.resort_every,
                                        graphs=graphs)
    if knob == "stale_frac":
        return I.make_adaptive_multi_step(
            sf, cfg.dt, steps, max_stale_frac=cfg.resort_stale_frac,
            max_cadence=16, with_trace=trace, graphs=graphs)
    if graphs is None:
        return I.make_sorted_multi_step(sf, cfg.dt, steps)
    g = StepGraph(lambda s: I.sorted_verlet_step(s, sf, cfg.dt))
    return lambda st: I.to_particle_state(g(I.sorted_state_from(st), steps))


def table_launches(tp, cfg, knob, state0, steps, far):
    """A table run's launches, and its trace where the driver has one (an
    eager traced run of the same steps from the same state): K2's rank
    form on the entry and every re-sort or rebuild, its dest form on every
    repair step (on the static mover set, movers or not), K4 and the kick
    on every step, the drift on every step after the first, K3 ``far``
    times a step and with a far field (Barnes-Hut) K6 on every step that
    does not re-sort (the side rows' moments) → (want, (out, stale, flags)
    or None)."""
    want = dict(tile_sweep_plane=steps, far_taps=far * steps,
                far_down=steps if far else 0,
                table_drift=steps - 1, table_kick=steps)
    trace = None
    if knob == "cadence":
        sorts = 1 + (steps - 1) // cfg.resort_every
    else:
        out, (stale, flags) = table_multi(tp, cfg, knob, steps, True)(state0)
        trace = (out, stale, flags)
        sorts = 1 + int(flags.sum())
    want["tile_scatter"] = want["payload_gather"] = sorts
    if far:
        want["segment_sum"] = steps - sorts
    if knob == "repair":
        want["tile_place"] = steps - sorts
    return want, trace


def row_sorts(sf, cfg, knob, state0, steps):
    """The sorts (payload gathers) of the row-space driver of ``knob``
    over ``steps`` steps from ``state0``: one a step for repair, one a
    chunk of the cadence, and for stale_frac the first step's and the
    re-sorts of an eager traced run of the same steps (the schedule of the
    captured run, bit for bit)."""
    from nbody_tpu_torch.ops.integrator import make_adaptive_multi_step

    if knob == "repair":
        return steps
    if knob == "cadence":
        return len(range(0, steps, cfg.resort_every))
    _, (_, resorted) = make_adaptive_multi_step(
        sf, cfg.dt, steps, max_stale_frac=cfg.resort_stale_frac,
        max_cadence=16, with_trace=True)(state0)
    return 1 + int(resorted.sum())


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

    r, (meta,) = I._sorted_step(I.sorted_state_from(state0), sf.with_meta, dt)
    for resort in flags:
        if resort:
            r, (meta,) = I._sorted_step(r, sf.with_meta, dt)
        else:
            r, _ = I._frozen_step(r, sf.frozen, meta, dt)
    return I.to_particle_state(r)


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


ROUTE_TURNS = 4  # runs of each driver in the routing's turns


def turns(label, table, row, state0, steps, routed, smi):
    """The graphed table and row-space drivers of one knob timed from the
    same state in turns (table, row, row, table, ... ``ROUTE_TURNS`` runs
    each, after a warm run of each, which captures): medians, steps/s, and
    whether the table wins by more than the spread of the turns (the
    larger distance between the quartiles of the two drivers' runs),
    beside whether the facade routes the pair to the table."""
    import torch

    walls = {"table": [], "row": []}
    runs = {"table": table, "row": row}
    for f in runs.values():
        f(state0)
    order = ("table", "row", "row", "table") * (ROUTE_TURNS // 2)
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name](state0)
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    rates = {name: [steps / w for w in ws] for name, ws in walls.items()}
    rate = {name: statistics.median(r) for name, r in rates.items()}
    spread = max(q[2] - q[0] for q in (statistics.quantiles(r, n=4)
                                        for r in rates.values()))
    wins = rate["table"] - rate["row"] > spread
    print(f"  routing {label}: table {rate['table']:.3f} steps/s, row space "
          f"{rate['row']:.3f} (graphed both; medians of {ROUTE_TURNS} in "
          f"turns, spread {spread:.3f}; {smi}): the table "
          f"{'wins' if wins else 'does not win'} by more than the spread; "
          f"the facade routes it to the "
          f"{'table' if routed else 'row-space'} driver")
    return {**rate, "spread": spread, "table wins": wins}


def frozen_grid_path(label, mode, steps, far, drive, drive_row, smi, dev):
    """One frozen-grid path: through the facade (table-resident where
    ``TABLE_ROUTES`` holds the engine and knob, else in row space; its
    captured segments), then the other driver of the same knob called
    directly from the same state on captured segments, both with their
    launches counted; the two held to each other, the traces printed, and
    the two timed in turns. Returns the routing's readings."""
    import torch

    from nbody_tpu_torch.ops.forces import make_table_step_params
    from nbody_tpu_torch.ops.step_graph import SegmentGraphs
    from nbody_tpu_torch.system import TABLE_ROUTES, _resort_knob

    cfg = path_configs()[label]
    knob = _resort_knob(cfg)
    routed = (mode, knob) in TABLE_ROUTES
    row_want = dict(tile_scatter=steps, tile_sweep_plane=steps,
                    far_taps=far * steps, far_down=steps if far else 0)
    info = {}

    def expect(ps, state0):
        tp = make_table_step_params(
            cfg, device=dev, pos_hint=state0.pos if mode == "hash" else None)
        check(tp is not None and tp.mode == mode,
              f"{label}: no {mode} table parameters on the card")
        info["tp"] = tp
        row_want["payload_gather"] = row_sorts(ps._sorted_force, cfg, knob,
                                               state0, steps)
        if not routed:
            return {"payload_gather": row_want["payload_gather"]}, None
        want, trace = table_launches(tp, cfg, knob, state0, steps, far)
        info["want"] = want
        return want, trace

    _, _, ps, state0, trace = drive(
        label, steps, expect=expect, **({} if routed else row_want))
    check((ps._table_params is not None) == routed,
          f"{label}: the facade's routing is not TABLE_ROUTES'")
    tp, sf = info["tp"], ps._sorted_force

    def table():
        return table_multi(tp, cfg, knob, steps, graphs=SegmentGraphs())

    def row():
        return row_multi(sf, cfg, knob, steps, graphs=SegmentGraphs())

    if routed:
        tab_out = ps.state
        row_out, _ = drive_row(f"{label}, row-space driver", steps, row(),
                               state0, **row_want)
    else:
        row_out = ps.state
        want, trace = table_launches(tp, cfg, knob, state0, steps, far)
        info["want"] = want
        tab_out, _ = drive_row(f"{label}, table driver", steps, table(),
                               state0, **want)
    sorts = info["want"]["tile_scatter"]
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
            adaptive_report(sf, cfg, state0, steps, row_out)
    else:
        repair_report(label, tab_out, row_out, state0, trace, steps)
    return turns(label, table(), row(), state0, steps, routed, smi)


def adaptive_report(sf, cfg, state0, steps, timed):
    """The row-space adaptive path after its timed run: the trace of the
    same steps from the same state (``with_trace=True``, eager), whose
    state must equal the timed run's ``timed`` bit for bit (so its
    schedule is the timed run's); then the host read of the
    audit count between two replays of the captured segments, timed as
    the difference between the stale cap N − 1 (read after every frozen
    step, never exceeded) and N (never read) over the same steps, both at
    cap 16 and graphed: medians of 4 runs each, in turns; and the host's
    wait inside each read, on audited frozen force evaluations in a row
    (eager)."""
    import torch

    from nbody_tpu_torch.ops.integrator import make_adaptive_multi_step
    from nbody_tpu_torch.ops.step_graph import SegmentGraphs

    n = state0.n
    out, (stale, resorted) = make_adaptive_multi_step(
        sf, cfg.dt, steps, max_stale_frac=cfg.resort_stale_frac,
        max_cadence=16, with_trace=True)(state0)
    print(f"  {BH_ADAPTIVE}, row-space driver:")
    sorts = 1 + int(resorted.sum())
    print(f"  trace: {sorts} sorted steps of {steps} (the first and "
          f"{int(resorted.sum())} re-sorts at steps "
          f"{(torch.nonzero(resorted)[:, 0] + 2).tolist()}); stale counts "
          f"after steps 2..{steps}: {stale.tolist()} (cap "
          f"{int(cfg.resort_stale_frac * n)})")
    check(all(torch.equal(getattr(out, k), getattr(timed, k))
              for k in STATE_FIELDS),
          "adaptive: the traced eager run differs from the timed run")

    carries = {frac: SegmentGraphs() for frac in ((n - 1) / n, 1.0)}
    multis = {frac: make_adaptive_multi_step(sf, cfg.dt, steps,
                                             max_stale_frac=frac,
                                             max_cadence=16, graphs=g)
              for frac, g in carries.items()}
    walls = {frac: [] for frac in multis}
    for frac in multis:
        multis[frac](state0)
    before = {frac: g.host_reads for frac, g in carries.items()}
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
    made = {frac: (g.host_reads - before[frac]) / 4
            for frac, g in carries.items()}
    check(list(made.values()) == [reads, 0],
          f"adaptive: host reads a run {made}, expected {reads} and 0")
    t_read, t_none = (statistics.median(w) for w in walls.values())
    spread = "; ".join(f"{min(w):.3f}-{max(w):.3f}" for w in walls.values())
    print(f"  audit read between replays: {steps} steps with {reads} host "
          f"reads of the count {t_read:.3f} ms, without reads "
          f"{t_none:.3f} ms (graphed; medians of 4; ranges {spread} ms): "
          f"{(t_read - t_none) / reads:.4f} ms a read")
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


CLI_MODULE = "nbody_tpu_torch.cli"
# k2: BASELINE.json's first configuration ("Direct N², 10K particles,
# Plummer-sphere init, Velocity Verlet, headless")
K2_ARGV = ["--particles", "10000", "--method", "direct-n2", "--init",
           "plummer", "--benchmark", "--benchmark-steps", "100"]
# The keys of the JAX CLI's BenchmarkRunRecord and of its params
# (nbody_tpu/utils/profiling.py, nbody_tpu/app.py run_benchmark_mode)
RECORD_KEYS = ["name", "method", "particle_count", "iterations", "metrics",
               "params", "phase_timings"]
PARAM_KEYS = ["dt", "G", "softening", "theta", "cell_size", "cutoff", "init",
              "devices", "resort_every", "resort_stale_frac"]


def cli_subprocess(args, timeout=300):
    """``python -m nbody_tpu_torch.cli ARGS`` from the checkout's root."""
    return subprocess.run([sys.executable, "-m", CLI_MODULE, *args],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


def captured(fn):
    """``fn()`` with its standard output captured: (result, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def cli_bench(label, argv, want, wrappers, plains, smi, keep, via_main=False):
    """One benchmark-mode command line under ``counted_run``: through
    ``cli.main(argv)`` when ``via_main``, else through
    ``Application(parse_app_cli_options(argv)).run()`` (``main`` without
    its exit-code mapping, so the system stays readable). ``want`` counts
    a(t=0), the warm chunk and the timed chunks. Checks exit 0 and the
    record's keys against the JAX CLI's, prints the record. Returns (the
    application, None through ``main``; the record)."""
    from nbody_tpu_torch.app import Application
    from nbody_tpu_torch.cli import main as cli_main
    from nbody_tpu_torch.cli import parse_app_cli_options

    opts = parse_app_cli_options(argv)
    steps = opts.benchmark_steps
    chunk = min(steps, 50)
    steps = -(-steps // chunk) * chunk + chunk
    app = None if via_main else Application(opts)
    run = (lambda: cli_main(argv)) if via_main else app.run
    launches, (rc, text), _ = counted_run(
        f"{label} (a(0), {chunk} warm + {steps - chunk} timed steps)",
        steps, lambda: captured(run), want, wrappers, plains, smi)
    keep(label, launches)
    check(rc == 0, f"{label}: exit code {rc}")
    doc = json.loads(text[text.index("{"):])
    (rec,) = doc["benchmark_runs"]
    check(list(rec) == RECORD_KEYS and list(rec["params"]) == PARAM_KEYS,
          f"{label}: record keys {list(rec)} / {list(rec['params'])}")
    check(rec["iterations"] == steps - chunk, f"{label}: iterations")
    print(f"  record: {json.dumps(rec)}")
    return app, rec


def cli_phase(res, wrappers, plains, none, keep, smi, dev, levels):
    """Phase 6 (k): the CLI entry point, each run with the counts set to
    0 just before it and read just after. Returns the readings."""
    import torch

    from nbody_tpu_torch import ParticleSystem
    from nbody_tpu_torch.app import Application
    from nbody_tpu_torch.cli import parse_app_cli_options
    from nbody_tpu_torch.ops.integrator import initialize_forces
    from nbody_tpu_torch.utils.hdf5_io import HAVE_HDF5, HDF5IO

    def bh_want(evals):
        return {**none, "tile_scatter": evals, "far_taps": evals * levels,
                "far_down": evals, "tile_sweep_plane": evals,
                "payload_gather": evals}

    def bench(label, argv, want, via_main=False):
        return cli_bench(label, argv, want, wrappers, plains, smi, keep,
                         via_main)

    readings = {}
    # k1
    for flag in ("--list-algorithms", "--diagnostics", "--help"):
        out = cli_subprocess([flag])
        check(out.returncode == 0, f"k1 {flag}: exit {out.returncode}: "
              f"{out.stderr[-2000:]}")
        lines = out.stdout.strip().splitlines()
        shown = lines if flag != "--help" else lines[:1]
        print(f"k1 python -m {CLI_MODULE} {flag}: exit 0")
        for line in shown:
            print(f"  {line}")

    # k2: BASELINE's first configuration, through cli.main
    bench("k2 CLI 10K direct Plummer", K2_ARGV,
          {**none, "direct_forces": 151}, via_main=True)

    with tempfile.TemporaryDirectory() as tmp:
        # k3: the 1M Barnes-Hut benchmark with an export
        path = str(Path(tmp) / "s.nbody")
        app, rec = bench(
            "k3 CLI 1M BH",
            ["--particles", str(N), "--method", "barnes-hut", "--benchmark",
             "--benchmark-steps", "30", "--export", path], bh_want(61))
        check_finite("k3 CLI 1M BH", app.system.state)
        rate = rec["metrics"]["steps_per_sec"]
        readings["k3 CLI 1M BH steps/s"] = rate
        print(f"k3 CLI 1M BH: {rate:.3f} steps/s (its record) beside path "
              f"a's facade {RATES['1M BH tiles']:.3f} steps/s ({smi})")

        # k4: --import restores the state
        imp = Application(parse_app_cli_options(
            ["--method", "barnes-hut", "--import", path]))
        imp._initialize_system()
        got, want = imp.system.state, app.system.state
        for f in ("pos", "vel", "mass"):
            check(torch.equal(getattr(got, f), getattr(want, f)),
                  f"k4: imported {f} not bit-equal to the exported state")
        again = initialize_forces(got, imp.system._force_fn).acc
        check(torch.equal(got.acc, again),
              f"k4: a(t) differs from initialize_forces by "
              f"{float((got.acc - again).abs().max())}")
        print(f"k4 --import {Path(path).name} ({Path(path).stat().st_size} "
              f"bytes): pos, vel, mass bit-equal to the exported state, "
              f"a(t) bit-equal to initialize_forces, t = "
              f"{imp.system.simulation_time:.6f}")
        del app, imp, got, want, again

    # k5: the disk and Plummer scenes at 1M through Barnes-Hut tiles
    for dist in ("disk", "plummer"):
        label = f"k5 CLI 1M BH {dist}"
        app, rec = bench(label, ["--particles", str(N), "--method",
                                 "barnes-hut", "--init", dist, "--benchmark",
                                 "--benchmark-steps", "10"], bh_want(21))
        st, cfg = app.system.state, app.system.config
        check_finite(label, st)
        audit = app.system.audit_short_range()
        med = bh_vs_direct(st.pos, st.mass, st.acc, cfg, label, gate=False)
        collapse_check(res, st, cfg, f"1M BH {dist} after 20 steps")
        ms = rec["metrics"]["wall_time_ms_per_step"]
        readings[f"k5 1M BH {dist}"] = dict(
            overflow=audit["overflow"], median_rel_err_vs_k1=med,
            ms_per_step=ms)
        print(f"k5 1M BH {dist}: audit_short_range {audit}, median rel err "
              f"vs K1 {med:.4e}, {ms:.4f} ms a step ({smi})")
        del app, st
    app, rec = bench("k5 CLI 1M spatial hash",
                     ["--particles", str(N), "--method", "spatial-hash",
                      "--benchmark", "--benchmark-steps", "30"],
                     {**none, "window_sweep": 61, "payload_gather": 61})
    check_finite("k5 CLI 1M spatial hash", app.system.state)
    rate = rec["metrics"]["steps_per_sec"]
    readings["k5 CLI 1M spatial hash steps/s"] = rate
    audit = app.system.audit_short_range()
    check(audit["window_overflow_rows"] == 0,
          f"k5 CLI 1M spatial hash dropped pairs: {audit}")
    print(f"k5 CLI 1M spatial hash: {rate:.3f} steps/s (its record) beside "
          f"path b's facade {RATES['1M dense hash']:.3f} steps/s; "
          f"audit_short_range {audit} ({smi})")
    del app

    # k6: HDF5
    print(f"k6 HAVE_HDF5: {HAVE_HDF5}")
    with tempfile.TemporaryDirectory() as tmp:
        h5 = Path(tmp) / "x.h5"
        if not HAVE_HDF5:
            out = cli_subprocess(["--particles", "1000", "--benchmark",
                                  "--benchmark-steps", "1", "--export",
                                  str(h5)])
            msg = "HDF5 support unavailable: h5py is not installed"
            check(out.returncode != 0 and msg in out.stderr,
                  f"k6: --export x.h5 without h5py: exit {out.returncode}, "
                  f"{out.stderr[-2000:]}")
            check(not h5.exists(), "k6: a file was written without h5py")
            print(f"k6 --export x.h5: exit {out.returncode}, "
                  f"SerializationError: {msg}; no file written")
        else:
            ps = ParticleSystem()
            ps.initialize(path_configs()["100K direct"], device=dev)
            HDF5IO.export_to_file(str(h5), ps.get_state())
            back = HDF5IO.import_from_file(str(h5))
            check(back == ps.get_state(), "k6: HDF5 round trip differs")
            print("k6 HDF5 round trip at 100K: equal")

    # k7: the facade's exact potential energy on K5
    cfg = path_configs()["100K direct"]
    ps = ParticleSystem()
    ps.initialize(cfg, device=dev)
    label = "k7 compute_potential_energy 100K"
    launches, pe, _ = counted_run(label, 1, ps.compute_potential_energy,
                                  {**none, "pairwise_potential": 1},
                                  wrappers, plains, smi)
    keep(label, launches)
    got = k5_held(res, f"N = {cfg.particle_count} (facade)", ps.state.pos,
                  ps.state.mass, cfg.G, cfg.softening, 3)
    check(pe == got, f"k7: facade PE {pe} != K5's {got}")
    print(f"k7 compute_potential_energy: {pe:.9e} from one K5 launch")
    return readings


# Phase 7 (r): rendering. The CLI's render path: its defaults (the
# spherical scene, BH tiles at d 64, k 16) at 1M, 30 steps.
RENDER_ARGV = ["--particles", str(N), "--method", "barnes-hut", "--steps",
               "30"]
APP_CAMERA = dict(distance=45.0, azimuth=0.7, elevation=0.75)
CLOSE_CAMERA = dict(distance=5.0, azimuth=0.7, elevation=0.75)


def read_png(path):
    """An 8-bit RGB PNG with filter 0 on every row (the port's writer),
    decoded with the standard library → (H, W, 3) uint8 array."""
    import binascii
    import struct
    import zlib

    import numpy as np

    data = Path(path).read_bytes()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    at, idat, size = 8, b"", None
    while at < len(data):
        (length,) = struct.unpack(">I", data[at:at + 4])
        kind, body = data[at + 4:at + 8], data[at + 8:at + 8 + length]
        (crc,) = struct.unpack(">I", data[at + 8 + length:at + 12 + length])
        check(binascii.crc32(kind + body) == crc, f"{path}: bad {kind} CRC")
        if kind == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            check((depth, ctype) == (8, 2), f"{path}: not 8-bit RGB")
            size = (h, w)
        elif kind == b"IDAT":
            idat += body
        at += 12 + length
    h, w = size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(bool((raw[:, 0] == 0).all()), f"{path}: a row filter is not 0")
    return raw[:, 1:].reshape(h, w, 3)


def r1_checks(res, scene):
    """r1: R1 against its twin on the 1M BH step-0 scene at 1280×720, at
    the app's camera and a close one (inside the cloud: radii 2-8, points
    behind the eye and off screen), in each color mode. px, py, size and
    colours bit-equal; the image and its uint8 copy bit-equal to the
    twin's point-order sum (``accumulate="ordered"``) and to a second
    call; the image within 1e-5 of the twin's float32 terms summed in
    float64; the uint8 copy (img·255) truncated. Times the app's call
    form (with the uint8 copy); prints the tiles' list entries and the
    longest list (``tile_counts``)."""
    import torch

    from nbody_tpu_torch.ops.render import (
        TILE,
        render_points,
        render_points_plain,
        tile_counts,
    )
    from nbody_tpu_torch.render import Camera
    from nbody_tpu_torch.types import ColorMode

    pos, vel = scene.pos, scene.vel
    n, width, height = pos.shape[0], 1280, 720
    for cam_name, cam_kw in (("app", APP_CAMERA), ("close", CLOSE_CAMERA)):
        cam = Camera(**cam_kw)
        for mode in ColorMode:
            label = f"{cam_name} camera, {mode.name}"
            kw = dict(width=width, height=height, point_size=2.0, mode=mode)
            got = render_points(pos, vel, cam, uint8=True, sprites=True, **kw)
            again = render_points(pos, vel, cam, uint8=True, **kw)
            check(torch.equal(got.image, again.image)
                  and torch.equal(got.image_u8, again.image_u8),
                  f"R1 {label}: two calls differ")
            want = render_points_plain(pos, vel, cam, accumulate="ordered",
                                       uint8=True, sprites=True, **kw)
            for name, g, w in zip(("px", "py", "size", "rgb"), got.sprites,
                                  want.sprites):
                check(torch.equal(g, w), f"R1 {label}: {name} differs from "
                      f"the twin's")
            bad = int((got.image != want.image).sum())
            check(bad == 0, f"R1 {label}: {bad} image values differ from "
                  f"the ordered twin's")
            check(torch.equal(got.image_u8, want.image_u8),
                  f"R1 {label}: uint8 copy differs from the ordered twin's")
            f64 = render_points_plain(pos, vel, cam, accumulate="f64", **kw)
            e = float((got.image - f64.image).abs().max())
            del f64, want
            check(e <= 1e-5, f"R1 {label}: image max|diff| {e} > 1e-5 "
                  f"against the float64 sum")
            check(torch.equal(got.image_u8,
                              (got.image * 255).to(torch.uint8)),
                  f"R1 {label}: uint8 copy is not (img*255) truncated")
            size = got.sprites[2]
            vis = int((size > 0).sum())
            radii = torch.bincount(torch.round(size[size > 0] * 0.5).clamp(
                min=1).long(), minlength=9)[1:].tolist()
            lists = tile_counts(*got.sprites[:3], width=width, height=height)

            def call():
                return render_points(pos, vel, cam, uint8=True, **kw)

            # points read once (velocities in VELOCITY mode), the float32
            # image and its uint8 copy written once
            nbytes = (12 + 12 * (mode == ColorMode.VELOCITY)) * n + (
                width * height * 3 * 5)
            rec = dict(
                max_abs_err=e,
                ms=time_ms(call),
                device_ms=graph_ms(call),
                kernels_per_call=graph_kernels(call),
                plain_ms=time_ms(lambda: render_points_plain(
                    pos, vel, cam, uint8=True, accumulate="ordered", **kw),
                    reps=3, warm=1),
                **bound(0, nbytes),
                library_ms=None,
                visible=vis, tile=TILE, entries=int(lists.sum()),
                longest_list=int(lists.max()),
            )
            add_shape(res, "render_points", label, rec)
            print(f"R1 render_points {label} (N = {n}, {width}x{height}): "
                  f"{vis} visible, sprites per radius 1-8 {radii}; px, py, "
                  f"size, rgb bit-equal to the twin, image and uint8 copy "
                  f"bit-equal to the ordered twin and across two calls, "
                  f"max|diff| {e:.3e} against the twin summed in float64 "
                  f"(tol 1e-5); {TILE}x{TILE} tiles: {rec['entries']} list "
                  f"entries, longest list {rec['longest_list']}; kernel "
                  f"{rec['ms']:.4f} ms a call ({rec['device_ms']:.4f} ms of "
                  f"device time, {rec['kernels_per_call']} kernels a call, "
                  f"CUDA graph), ordered twin {rec['plain_ms']:.4f} ms, "
                  f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
                  f"{nbytes} B)")


def app_run(label, argv, want, wrappers, plains, smi, keep):
    """``Application(parse_app_cli_options(argv)).run()`` in this process
    under ``counted_run`` (stdout captured); returns the app's phases,
    whose ``app.loop`` is the step loop to its last device work."""
    from nbody_tpu_torch.app import Application
    from nbody_tpu_torch.cli import parse_app_cli_options

    app = Application(parse_app_cli_options(argv))
    launches, (rc, text), phases = counted_run(
        label, 30, lambda: captured(app.run), want, wrappers, plains, smi)
    keep(label, launches)
    check(rc == 0, f"{label}: exit code {rc}")
    summary = json.loads(text.strip().splitlines()[-1])
    check(summary["steps"] == 30, f"{label}: summary {summary}")
    loop = phases["app.loop"].total_ms / 1e3
    print(f"  {label}: step loop {loop:.4f} s = {30 / loop:.3f} frames/s "
          f"({smi})")
    return phases, 30 / loop


def render_phase(res, scene, wrappers, plains, none, keep, smi, dev, levels):
    """Phase 7 (r): R1 against its twin (r1); the CLI's render path at 1M
    as a subprocess and in this process, counted (r2); the live view
    (r3); ``PointStream`` on the card (r4). Returns the readings."""
    import torch

    from nbody_tpu_torch import ParticleSystem
    from nbody_tpu_torch.cli import parse_app_cli_options
    from nbody_tpu_torch.render import Camera, PointStream, TerminalView
    from nbody_tpu_torch.render.renderer import PointRenderer

    r1_checks(res, scene)
    frames = [f"frame_{k:05d}.png" for k in range(29)]
    bh = {**none, "tile_scatter": 31, "far_taps": 31 * levels,
          "far_down": 31, "tile_sweep_plane": 31, "pairwise_potential": 1,
          "payload_gather": 31}
    readings = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "cli"
        t0 = time.perf_counter()
        run = cli_subprocess(RENDER_ARGV + ["--render", "--render-output",
                                            str(out)])
        wall = time.perf_counter() - t0
        check(run.returncode == 0, f"r2 CLI --render: exit "
              f"{run.returncode}: {run.stderr[-2000:]}")
        got = sorted(p.name for p in out.iterdir())
        check(got == frames, f"r2: files {got[:3]}...{got[-3:]} "
              f"({len(got)}), expected frame_00000..frame_00028.png")
        for name in frames:
            img = read_png(out / name)
            check(img.shape == (720, 1280, 3) and img.max() > 0,
                  f"r2 {name}: shape {img.shape}, max {img.max()}")
        print(f"r2 python -m {CLI_MODULE} {' '.join(RENDER_ARGV)} --render "
              f"--render-output DIR: exit 0 in {wall:.2f} s, 29 PNG files "
              f"frame_00000..frame_00028, each 720x1280x3 with something "
              f"drawn; stderr: {run.stderr.strip().splitlines()[-2:]}")

        own = Path(tmp) / "own"
        phases, fps = app_run(
            "r2 app 1M BH --render --render-output",
            RENDER_ARGV + ["--render", "--render-output", str(own)],
            {**bh, "render_points": 29}, wrappers, plains, smi, keep)
        readings["frames/s, --render --render-output"] = fps
        # update: device span of a step; render: of R1's call; copy: on
        # the side stream; encode: host clock (PNG encode + write)
        split = {k: phases[k].total_ms / phases[k].samples
                 for k in ("simulation.update", "render.frame",
                           "render.copy", "render.encode") if k in phases}
        readings["ms a frame"] = split
        print(f"  ms a frame: {json.dumps(split)} ({smi})")
        _, fps = app_run("r2 app 1M BH --render", RENDER_ARGV + ["--render"],
                         {**bh, "render_points": 29}, wrappers, plains, smi,
                         keep)
        readings["frames/s, --render"] = fps
        _, fps = app_run("r2 app 1M BH, no render", RENDER_ARGV, bh,
                         wrappers, plains, smi, keep)
        readings["frames/s, step loop"] = fps

        # the last frame (the state after 29 updates) made again here
        ps = ParticleSystem()
        ps.initialize(parse_app_cli_options(RENDER_ARGV).to_config(),
                      device=dev)
        for _ in range(29):
            ps.update()
        st = ps.state
        again = PointRenderer(camera=Camera(**APP_CAMERA)).frame(
            st.pos, st.vel).cpu().numpy().astype(int)
        for where in (out, own):
            diff = abs(read_png(where / frames[-1]).astype(int) - again)
            check(int(diff.max()) == 0, f"r2 {where.name} {frames[-1]}: "
                  f"{int((diff > 0).sum())} values differ, by at most "
                  f"{int(diff.max())}, from R1 on the state after 29 "
                  f"updates made here")
            print(f"r2 {where.name}/{frames[-1]} equals R1's uint8 frame of "
                  f"the state after 29 updates made here in every value "
                  f"(the step and R1 are deterministic)")

    run = cli_subprocess(RENDER_ARGV[:4] + ["--live", "--steps", "10"])
    check(run.returncode == 0, f"r3 --live: exit {run.returncode}: "
          f"{run.stderr[-2000:]}")
    text = run.stdout
    clears, homes = text.count("\x1b[2J"), text.count("\x1b[H")
    check((clears, homes) == (1, 9), f"r3 --live --steps 10: {clears} "
          f"clears, {homes} frames (expected 1, 9)")
    summary = json.loads(text.strip().splitlines()[-1])
    check(summary["steps"] == 10, f"r3: summary {summary}")
    view = TerminalView(Camera(**APP_CAMERA))
    check(view.compose(st.pos, "s") == view.compose(st.pos.cpu().numpy(),
                                                    "s"),
          "r3: compose on the card differs from compose on the host copy")
    print(f"r3 --live --steps 10: exit 0, 1 clear, 9 frames, summary "
          f"{json.dumps(summary)}; compose on the card == on the host copy "
          f"(grid sum {int(view.raster(st.pos).sum())})")

    stream = PointStream(ps)
    want = ps.state.pos.cpu()
    stream.request()
    ps.update()
    ps.update()
    snap = stream.latest()
    check(torch.equal(torch.from_numpy(snap.positions), want),
          "r4: the snapshot is not the state at request time")
    check(stream.verify_data_integrity(), "r4: verify_data_integrity")
    print("r4 PointStream: request, 2 steps, latest() = the positions at "
          "request time bit for bit; verify_data_integrity True")
    return readings


# Phase 8: the sharded paths on a mesh of four virtual shards of the card
SHARDS = 4
SHARD_NOTE = ("4 virtual shards on one card: not a scaling number (the card "
              "does each position's work in turn, 4x the replicated far "
              "field, and the collectives are device-local copies)")


def in_contract(pos, levels, k):
    """Rows within the k-slot cap of their finest cell (rank by row order
    in the cell, as both the single-device tiles engine and the slab
    build place them) under the BH binning of ``pos``."""
    import torch

    from nbody_tpu_torch.ops.barnes_hut import bin_particles
    from nbody_tpu_torch.ops.sorted_window import cell_ids, sorted_ranks

    ids = cell_ids(bin_particles(pos, levels)[2], 1 << levels)
    order = torch.argsort(ids, stable=True)
    rank = torch.empty_like(order)
    rank[order] = sorted_ranks(ids[order]).to(order.dtype)
    return rank < k


def capture_slabs(call):
    """The K4 slab-form inputs of every position in one ``call()``, as
    [(tiles, counts, kwargs)]: ``tile_sweep_slab`` wrapped in a recorder
    for the call."""
    from nbody_tpu_torch.parallel import tree

    seen, orig = [], tree.tile_sweep_slab

    def record(tiles, counts, **kw):
        seen.append((tiles, counts, kw))
        return orig(tiles, counts, **kw)

    tree.tile_sweep_slab = record
    try:
        call()
    finally:
        tree.tile_sweep_slab = orig
    return seen


def slab_check(res, label, tiles, counts, kw):
    """K4's slab form against its twin at one position's slab (2e-5·max
    |out|), two calls bit-equal, timed (one call and graph replay), the
    bound from this slab's live slot pairs."""
    import torch
    import torch.nn.functional as F

    from nbody_tpu_torch.ops.tile_near import (
        tile_sweep_plane_plain,
        tile_sweep_slab,
    )

    d, k, ws = kw["d"], kw["k"], kw["ws"]
    x0, planes = kw["x0"], kw["planes"]
    nx = tiles.shape[0]

    def plain():
        return tile_sweep_plane_plain(
            tiles, k=k, d=d, ws=ws, eps=kw["eps"], cutoff2=kw["cutoff2"],
            counts=counts, slab=(x0, planes))

    got, want = tile_sweep_slab(tiles, counts, **kw), plain()
    e = float((got - want).abs().max())
    tol = 2e-5 * float(want.abs().max())
    check(e <= tol, f"K4 slab {label}: max|diff| {e} > {tol}")
    check(torch.equal(got, tile_sweep_slab(tiles, counts, **kw)),
          f"K4 slab {label}: two calls differ")
    w1 = 2 * ws + 1
    live = torch.clamp(counts, max=k).reshape(1, 1, nx, d, d).double()
    neigh = F.avg_pool3d(live, w1, stride=1, padding=ws,
                         count_include_pad=True) * w1 ** 3
    pairs = float((live * neigh)[:, :, x0:x0 + planes].sum())
    rec = dict(
        max_abs_err=e,
        ms=time_ms(lambda: tile_sweep_slab(tiles, counts, **kw)),
        device_ms=graph_ms(lambda: tile_sweep_slab(tiles, counts, **kw),
                           reps=5),
        plain_ms=time_ms(plain, reps=3, warm=1),
        # live slot pairs of the targets' (2ws+1)³ balls; slab tiles and
        # counts in, the target planes' slots out
        **bound(PAIR_OPS * pairs,
                4 * (nx * 4 * k * d * d + nx * d * d + planes * 3 * k * d * d)),
        library_ms=None,
    )
    add_shape(res, "tile_sweep_slab", label, rec)
    print(f"K4 slab {label} (slab {nx} planes, targets [{x0}, {x0 + planes})"
          f", d={d}, k={k}, ws={ws}, cutoff2={kw['cutoff2']}): max|diff| "
          f"{e:.3e} (tol 2e-5*max|out| = {tol:.3e}); two calls bit-equal; "
          f"live slot pairs {pairs:.0f}; kernel {rec['ms']:.4f} ms (device "
          f"{rec['device_ms']:.4f} ms), plain {rec['plain_ms']:.4f} ms, "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")


def cross_check(res, label, a, b, G, eps):
    """K5's cross form against its twin on blocks ``a`` × ``b`` (relative
    1e-5, float64 sums in both), two calls bit-equal, timed (median of 3
    calls and graph replay), the twin once."""
    import torch

    from nbody_tpu_torch.ops.direct import (
        pairwise_potential_cross,
        pairwise_potential_plain,
    )

    got = pairwise_potential_cross(*a, *b, G, eps)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    want = pairwise_potential_plain(*a, G, eps, sources=b)
    t1.record()
    t1.synchronize()
    rel = abs(float(got) - float(want)) / abs(float(want))
    check(rel <= 1e-5, f"K5 cross {label}: rel diff {rel}")
    check(torch.equal(got, pairwise_potential_cross(*a, *b, G, eps)),
          f"K5 cross {label}: two calls differ")
    nt, ns = a[0].shape[0], b[0].shape[0]
    rec = dict(
        max_abs_err=abs(float(got) - float(want)),
        ms=time_ms(lambda: pairwise_potential_cross(*a, *b, G, eps), reps=3,
                   warm=1),
        device_ms=graph_ms(lambda: pairwise_potential_cross(*a, *b, G, eps),
                           reps=2),
        plain_ms=t0.elapsed_time(t1),
        # nt·ns pair terms; both blocks in, one partial per 256 rows out
        **bound(PAIR_OPS * nt * ns, 16 * (nt + ns) + 8 * -(-nt // 256)),
        mufu_ms=nt * ns / MUFU_RSQRT * 1e3,
        library_ms=None,
    )
    add_shape(res, "pairwise_potential_cross", label, rec)
    print(f"K5 cross {label}: kernel {float(got):.9e}, plain "
          f"{float(want):.9e}, rel diff {rel:.3e} (tol 1e-5); two calls "
          f"bit-equal; kernel {rec['ms']:.4f} ms (median of 3; device "
          f"{rec['device_ms']:.4f} ms), plain {rec['plain_ms']:.4f} ms (one "
          f"call), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
          f"MUFU rsqrt ceiling {rec['mufu_ms']:.4f} ms")


def sharded_phase(res, cfgs, scene, sparse, wrappers, plains, none, keep,
                  smi, dev, levels):
    """Phase 8 (s1-s6): the sharded paths (``nbody_tpu_torch.parallel``) on
    ``make_mesh(4, devices=[card] * 4)``, each timed run under
    ``counted_run``. Returns the readings."""
    import torch

    from nbody_tpu_torch import ParticleSystem, SimulationConfig
    from nbody_tpu_torch.cli import main as cli_main
    from nbody_tpu_torch.errors import ValidationError
    from nbody_tpu_torch.models.distributions import init_from_config
    from nbody_tpu_torch.ops.direct import (
        direct_forces_kernel,
        pairwise_potential,
    )
    from nbody_tpu_torch.ops.barnes_hut import bh_engine_params, bin_particles
    from nbody_tpu_torch.ops.forces import make_force_fn
    from nbody_tpu_torch.ops.integrator import kinetic_energy
    from nbody_tpu_torch.parallel import make_mesh, mesh as M, tree
    from nbody_tpu_torch.parallel.step import (
        make_sharded_force_fn,
        sharded_energy,
        sharded_initialize_forces,
        sharded_multi_step,
    )

    mesh = make_mesh(SHARDS, devices=[dev] * SHARDS)
    p2 = SHARDS * SHARDS
    print(f"phase 8 mesh: {SHARDS} positions on {mesh.devices[0]} "
          f"({SHARD_NOTE})")
    readings = {}

    def timed(label, cfg, force_fn, state0, steps, want):
        """The step's captured segments (``sharded_multi_step``) against
        the same stages eagerly, ``steps`` steps from ``state0``: the
        graphed first call (each stage eager at its first use, then
        captured; replays after) counted, it and a replay-only call held
        to two eager runs bit for bit, then both timed in turns."""
        graphed = sharded_multi_step(force_fn, cfg.dt, steps)
        eager = sharded_multi_step(force_fn, cfg.dt, steps, graphed=False)
        eager(state0)  # warm
        launches, first, _ = counted_run(
            f"{label} [{SHARD_NOTE}], graphed first call", steps,
            lambda: graphed(state0), {**none, **want}, wrappers, plains,
            smi)
        keep(label, launches)
        g = graphed.graphs
        check(g.captures == g.segments
              and g.replays == g.segments * (steps - 1),
              f"{label}: {g.captures} captures, {g.replays} replays of "
              f"{g.segments} segments after the first call")
        again = graphed(state0)
        check(g.captures == g.segments, f"{label}: a second call captured")
        eagers = [eager(state0) for _ in range(2)]
        for what, out in (("second eager run", eagers[1]),
                          ("graphed first call", first),
                          ("graphed replay-only call", again)):
            check_finite(f"{label} {what}", M.gather_state(out))
            same = all(torch.equal(getattr(a, f), getattr(b, f))
                       for a, b in zip(out.shards, eagers[0].shards)
                       for f in STATE_FIELDS)
            check(same, f"{label}: the {what} differs from the eager run")
        del again, eagers
        tg, te = [], []
        for _ in range(GRAPH_TURNS):
            tg.append(wall_s(lambda: graphed(state0)))
            te.append(wall_s(lambda: eager(state0)))
        rec = {"steps/s graphed": steps / statistics.median(tg),
               "steps/s eager": steps / statistics.median(te),
               "segments a step": g.segments,
               "collectives a step": g.collectives,
               "capture ms": g.capture_ms, "pool MiB": g.pool_bytes / 2**20}
        readings[label] = rec
        print(f"{label}: graphed {rec['steps/s graphed']:.3f} / eager "
              f"{rec['steps/s eager']:.3f} steps/s ({steps} steps a run, "
              f"median of {GRAPH_TURNS} in turns; {SHARD_NOTE}; {smi}); "
              f"{g.segments} segments and {g.collectives} collectives a "
              f"step; capture {g.capture_ms:.1f} ms, pool "
              f"{rec['pool MiB']:.1f} MiB; graph == eager bit for bit (two "
              f"eager runs bit-equal)")
        return first

    # s1: the ring, 100K direct
    cfg = cfgs["100K direct"]
    st = init_from_config(cfg, device=dev)
    force = make_sharded_force_fn(cfg, mesh)
    check(force.distribution == "ring", f"s1 distribution {force.distribution}")
    sh = sharded_initialize_forces(M.shard_state(st, mesh), force)
    want = direct_forces_kernel(st.pos, st.mass, cfg.G, cfg.softening)
    err = float((sh.acc - want).abs().max())
    scale = float(want.abs().max())
    print(f"s1 ring (100K direct) a(0) vs single-device K1: max|diff| "
          f"{err:.4e}, max|a| {scale:.4e} (tol 2e-4*max|a|)")
    check(err <= 2e-4 * scale, f"s1 ring a(0) {err} > 2e-4*max|a|")
    timed("s1 100K direct, ring", cfg, force, sh, 10,
          {"direct_forces": 10 * p2})
    del st, sh, want

    # s2: tree-slabs, the 1M Barnes-Hut headline scene
    cfg = cfgs["1M BH tiles"]
    force = make_sharded_force_fn(cfg, mesh)
    check(force.distribution == "tree-slabs",
          f"s2 distribution {force.distribution}")
    pos, mass = scene.pos, scene.mass
    ps, ms = M.split(pos, mesh), M.split(mass, mesh)
    k = bh_engine_params(cfg)["near_k"]  # the sharded factory's rule
    kw = dict(levels=cfg.bh_max_level, near_k=k, return_overflow=True)
    got = {}
    slabs = capture_slabs(lambda: got.update(r=tree.sharded_barnes_hut_forces(
        ps, ms, mesh, cfg.G, cfg.softening, cfg.barnes_hut_theta, **kw)))
    acc_l, overflow = got["r"]
    acc = M.gather(acc_l)
    # the routing alone, at the default capacity N/P: the slab owner of
    # each row from the global binning (pmin/pmax of the blocks' bounds
    # are the global bounds)
    s = (1 << cfg.bh_max_level) // SHARDS
    dest = M.split(torch.div(bin_particles(pos, cfg.bh_max_level)[2][:, 0]
                             .long(), s, rounding_mode="floor"), mesh)
    route = sum(int(tree._route_to_slabs(ps[q], ms[q], dest[q], SHARDS,
                                         ps[q].shape[0])[2])
                for q in range(SHARDS))
    ps1 = ParticleSystem()
    ps1.initialize(cfg, device=dev)
    audit = ps1.audit_short_range()
    del ps1
    tile_over = int(overflow) - route
    print(f"s2 tree-slabs step 0: routing overflow {route} (capacity N/P = "
          f"{N // SHARDS}), tile overflow {tile_over} rows past k = {k}, "
          f"single-device audit_short_range() {audit}")
    check(route == 0, f"s2 routing overflow {route}")
    check(tile_over == audit["overflow"],
          f"s2 tile overflow {tile_over} != audit {audit['overflow']}")
    single = make_force_fn(cfg)(pos, mass)
    ok = in_contract(pos, cfg.bh_max_level, k)
    err = float((acc[ok] - single[ok]).abs().max())
    scale = float(single[ok].abs().max())
    print(f"s2 tree-slabs vs single-device tiles engine on the "
          f"{int(ok.sum())} rows within k: max|diff| {err:.4e}, max|a| "
          f"{scale:.4e} (tol 1e-4*max|a|)")
    check(err <= 1e-4 * scale, f"s2 vs single device {err} > 1e-4*max|a|")
    bh_vs_direct(pos, mass, acc, cfg, "s2 BH tree-slabs")
    check(len(slabs) == SHARDS, f"s2 K4 slab calls {len(slabs)}")
    slab_check(res, "s2 1M BH tree-slabs, position 1", *slabs[1])
    del single, acc, acc_l, slabs
    sh = sharded_initialize_forces(M.shard_state(scene, mesh), force)
    sh = timed("s2 1M BH tree-slabs", cfg, force, sh, 10,
               {"far_taps": 10 * levels * SHARDS,
                "tile_sweep_slab": 10 * SHARDS, "segment_sum": 10 * SHARDS})

    # s4: energy on s2's state after its timed steps (at step 0 every
    # velocity is 0)
    cfg_e = cfgs["1M BH tiles"]
    launches, (ke, pe), _ = counted_run(
        "s4 1M sharded_energy (one call; steps/s = calls/s)", 1,
        lambda: sharded_energy(sh, mesh, cfg_e.G, cfg_e.softening),
        {**none, "pairwise_potential": SHARDS,
         "pairwise_potential_cross": SHARDS * (SHARDS - 1) // 2},
        wrappers, plains, smi)
    keep("s4 1M sharded_energy", launches)
    st = M.gather_state(sh)
    ke_1 = float(kinetic_energy(st))
    pe_1 = float(pairwise_potential(st.pos, st.mass, cfg_e.G,
                                    cfg_e.softening))
    rk = abs(float(ke) - ke_1) / abs(ke_1)
    rp = abs(float(pe) - pe_1) / abs(pe_1)
    print(f"s4 sharded_energy: KE {float(ke):.9e} vs {ke_1:.9e} (rel "
          f"{rk:.3e}), PE {float(pe):.9e} vs K5's main form {pe_1:.9e} (rel "
          f"{rp:.3e}); tol 1e-6")
    check(rk <= 1e-6 and rp <= 1e-6, f"s4 energies rel {rk}, {rp}")
    b = [(x.pos, x.mass) for x in sh.shards]
    cross_check(res, "s4 1M, one block pair (N/P x N/P)", b[0], b[1],
                cfg_e.G, cfg_e.softening)
    del sh, st, b

    # s3: hash-slabs, the 1M sparse hash scene, k = 64
    cfg = cfgs["1M sparse hash"]
    check((cfg.hash_max_grid_dim, cfg.hash_max_per_cell,
           cfg.spatial_hash_cutoff, cfg.spatial_hash_cell_size)
          == (64, 64, 2.0, 2.0), "s3 config")
    force = make_sharded_force_fn(cfg, mesh)
    check(force.distribution == "hash-slabs",
          f"s3 distribution {force.distribution}")
    pos, mass = sparse.pos, sparse.mass
    ps, ms = M.split(pos, mesh), M.split(mass, mesh)
    got = {}
    cut, cs = cfg.spatial_hash_cutoff, cfg.spatial_hash_cell_size
    slabs = capture_slabs(lambda: got.update(r=tree.sharded_spatial_hash_forces(
        ps, ms, mesh, cfg.G, cfg.softening, cutoff=cut, cell_size=cs,
        cap=cfg.hash_max_grid_dim, max_per_cell=cfg.hash_max_per_cell,
        return_overflow=True)))
    acc_l, overflow = got["r"]
    check(int(overflow) == 0, f"s3 overflow {int(overflow)}")
    acc = M.gather(acc_l)
    lo, hi = pos.min(0).values, pos.max(0).values
    dims = torch.clamp(torch.ceil((hi - lo) / cs).to(torch.int32), 1,
                       cfg.hash_max_grid_dim)
    coords = torch.minimum(torch.clamp(torch.floor((pos - lo) / cs).to(
        torch.int32), min=0), dims - 1)
    err, scale, med, held = ground_truth_hash(pos, mass, acc, coords, cut,
                                              cfg.softening, cfg.G)
    print(f"s3 hash-slabs step 0: overflow {int(overflow)}; vs f64 brute "
          f"force (27 cells, "
          f"raw r² ≤ {cut * cut:g}; {held} sampled rows, all {N} sources): "
          f"max|diff| "
          f"{err:.4e}, max|a| {scale:.4e}, median rel err {med:.3e} (tol "
          f"1e-4*max|a|)")
    check(err <= 1e-4 * scale, f"s3 ground truth {err} > 1e-4*max|a|")
    slab_check(res, "s3 1M sparse hash-slabs, position 1", *slabs[1])
    del acc, acc_l, slabs
    sh = sharded_initialize_forces(M.shard_state(sparse, mesh), force)
    timed("s3 1M sparse hash-slabs", cfg, force, sh, 10,
          {"tile_sweep_slab": 10 * SHARDS})
    del sh

    # s6: the facade and the CLI
    count = torch.cuda.device_count()
    if count == 1:
        try:
            ParticleSystem().initialize(
                SimulationConfig(particle_count=4096, shard_devices=2),
                device=dev)
            fail("s6: shard_devices=2 on one card did not raise")
        except ValidationError as e:
            print(f"s6 facade shard_devices=2 on 1 card: ValidationError "
                  f"({e})")
            check("2 devices but only 1" in str(e), f"s6 message: {e}")
        err_buf = io.StringIO()
        with contextlib.redirect_stderr(err_buf):
            rc, _ = captured(lambda: cli_main(
                ["--particles", "4096", "--devices", "2", "--benchmark"]))
        print(f"s6 cli --devices 2 --benchmark on 1 card: rc {rc}, stderr "
              f"{err_buf.getvalue().strip()[:160]!r}")
        check(rc == 2 and "devices" in err_buf.getvalue().lower(),
              f"s6 cli rc {rc}")
        print("s6 the facade's --devices path graphed against eager across "
              "cards needs 2 cards: skipped")
    else:
        p = min(4, count)
        ps = ParticleSystem()
        ps.initialize(cfgs["1M BH tiles"].replace(shard_devices=p),
                      device=dev)
        check(len({str(d) for d in ps.mesh.devices}) == p,
              f"s6 mesh devices {ps.mesh.devices}")
        state0, steps = ps.state, 10
        graphed = ps._multi_step(steps)
        eager = ps._multi_step(steps, graphed=False)
        want = eager(state0)
        got = graphed(state0)
        g = ps.step_graphs["sharded"]
        check(len(g.sets) == p and g.captures == g.segments * p,
              f"s6: {len(g.sets)} segment sets, {g.captures} captures")
        for a, b in zip(got.shards, want.shards):
            for f in STATE_FIELDS:
                check(torch.equal(getattr(a, f), getattr(b, f)),
                      f"s6 --devices {p}: the graphed {f} differs")
        tg, te = [], []
        for _ in range(GRAPH_TURNS):
            tg.append(wall_s(lambda: graphed(state0)))
            te.append(wall_s(lambda: eager(state0)))
        readings[f"s6 facade 1M BH on {p} cards"] = {
            "steps/s graphed": steps / statistics.median(tg),
            "steps/s eager": steps / statistics.median(te)}
        print(f"s6 facade 1M BH on {p} cards (a segment set a card): "
              f"graphed {steps / statistics.median(tg):.3f} / eager "
              f"{steps / statistics.median(te):.3f} steps/s, bit for bit "
              f"({smi})")
        del ps, state0, got, want
        rc, text = captured(lambda: cli_main(
            ["--particles", str(N), "--method", "barnes-hut", "--devices",
             str(p), "--benchmark", "--benchmark-steps", "10"]))
        check(rc == 0, f"s6 cli --devices {p}: rc {rc}")
        rec = json.loads(text[text.index("{"):])["benchmark_runs"][0]
        readings[f"s6 CLI 1M BH --devices {p}"] = \
            rec["metrics"]["steps_per_sec"]
        print(f"s6 cli --devices {p}: {json.dumps(rec)} ({smi})")
    return readings


# Phase 9: the mesh across processes, 4 ranks on the one card
RANKS = 4
RANK_TIMEOUT = 480  # s: the ranks' join, their rendezvous and collectives
RANK_FIELDS = ("pos", "vel", "acc", "mass", "time")
M1 = "m1 100K direct, ring"
M2 = "m2 1M BH tree-slabs"
M3 = "m3 1M sparse hash-slabs"
M4 = "m4 1M sharded_energy"
CKPT_STEP = 5


def rank_note(backend: str) -> str:
    """The label of phase 9's numbers on ``backend`` on this machine."""
    import torch

    if backend == "nccl":
        return f"{RANKS} cards, one rank a card, NCCL"
    if torch.cuda.device_count() == 1:
        return f"{RANKS} ranks on one card: not a scaling number"
    return (f"{RANKS} gloo ranks, collectives through host memory: not a "
            "scaling number")


def kernel_wrappers():
    """The kernels' wrappers by name (each counts its launches in
    ``launches``) and the plain twins (each counts its calls in
    ``calls``), which no timed path may run."""
    from nbody_tpu_torch.ops import table_step as T
    from nbody_tpu_torch.ops.direct import (
        direct_forces,
        direct_forces_kernel,
        pairwise_potential,
        pairwise_potential_cross,
        pairwise_potential_plain,
    )
    from nbody_tpu_torch.ops.far_down import far_down, far_down_plain
    from nbody_tpu_torch.ops.far_taps import far_taps, far_taps_plain
    from nbody_tpu_torch.ops.payload_gather import (
        payload_gather,
        payload_gather_plain,
    )
    from nbody_tpu_torch.ops.render import render_points, render_points_plain
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
    from nbody_tpu_torch.ops.tile_near import (
        tile_sweep_plane,
        tile_sweep_plane_plain,
        tile_sweep_slab,
    )
    from nbody_tpu_torch.ops.window_sweep import (
        window_sweep_kernel,
        window_sweep_plain,
    )

    wrappers = {
        "direct_forces": direct_forces_kernel,
        "tile_scatter": tile_scatter,
        "tile_place": tile_place,
        "far_taps": far_taps,
        "far_down": far_down,
        "tile_sweep_plane": tile_sweep_plane,
        "window_sweep": window_sweep_kernel,
        "pairwise_potential": pairwise_potential,
        "segment_sum": segment_sum,
        "bitonic_sort": bitonic_sort_pairs,
        "table_drift": T.table_drift,
        "table_kick": T.table_kick,
        "render_points": render_points,
        "tile_sweep_slab": tile_sweep_slab,
        "pairwise_potential_cross": pairwise_potential_cross,
        "payload_gather": payload_gather,
    }
    plains = [direct_forces, tile_scatter_plain, tile_place_plain,
              far_taps_plain, far_down_plain, tile_sweep_plane_plain,
              window_sweep_plain, pairwise_potential_plain,
              segment_sum_plain, bitonic_sort_pairs_plain,
              T.table_drift_plain, T.table_kick_plain, render_points_plain,
              payload_gather_plain]
    return wrappers, plains


def rank_main(out_dir: str, backend: str) -> None:
    """One rank of phase 9, ``python3 chip_smoke.py --rank OUT BACKEND``,
    as ``run_ranks`` starts it (torchrun's environment): the card, the
    group on ``backend``, the library the parent built (a rank that would
    build fails), then ``rank_body`` on the card."""
    import torch

    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.parallel import distributed

    if not torch.cuda.is_available():
        fail("rank: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize_distributed(backend=backend, timeout=RANK_TIMEOUT)
    rank = distributed.process_world()[0]
    _build.library()
    check(not _build.last_build["built"],
          f"rank {rank} built the kernels: the parent must build them")
    rank_body(out_dir, torch.device("cuda", torch.cuda.current_device()))


def rank_body(out_dir: str, dev) -> None:
    """m1-m5 through ``ParticleSystem`` with ``shard_devices=4`` on a mesh
    across the ranks (one position a rank), each timed run's launches
    counted and checked on every rank; writes ``OUT/rank<r>.json`` (the
    rates, launches, overflows, energies) and, on rank 0, ``OUT/rank0.pt``
    with the tensors the parent holds to its references."""
    import torch
    import torch.distributed as dist

    from nbody_tpu_torch import ParticleSystem
    from nbody_tpu_torch.ops.barnes_hut import bh_engine_params, bin_particles
    from nbody_tpu_torch.parallel import distributed, mesh as M, tree
    from nbody_tpu_torch.parallel.step import sharded_energy
    from nbody_tpu_torch.utils import restore_checkpoint, save_checkpoint

    rank = distributed.process_world()[0]
    wrappers, plains = kernel_wrappers()
    none = {name: 0 for name in wrappers}
    cfgs = path_configs()
    rec = {"rank": rank, "launches": {}, "rates": {}}
    tensors = {}

    def timed(label, steps, run, want):
        for f in wrappers.values():
            f.launches = 0
        for f in plains:
            f.calls = 0
        distributed.barrier()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        distributed.barrier()
        wall = time.perf_counter() - t0
        launches = {name: f.launches for name, f in wrappers.items()}
        check(launches == {**none, **want},
              f"rank {rank} {label}: launch counts {launches} != {want}")
        check(sum(f.calls for f in plains) == 0,
              f"rank {rank} {label}: a plain twin ran on the path")
        rec["launches"][label] = {k: c for k, c in launches.items() if c}
        rec["rates"][label] = {"steps_per_s": steps / wall,
                               "ms_per_step": 1e3 * wall / steps}

    def wall(run) -> float:
        distributed.barrier()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        distributed.barrier()
        return time.perf_counter() - t0

    def stepped(label, ps, steps, want):
        """``run_steps`` on the facade's captured segments, the first call
        (each stage eager at its first use, then captured) counted by
        ``timed``; it and a replay-only call held to an eager run of the
        same steps from the same state, bit for bit on this rank's
        position; then the replay-only call and the eager run timed in
        turns (median of GRAPH_TURNS; barriers around each)."""
        state0 = ps.state
        graphed = ps._multi_step(steps)
        eager = ps._multi_step(steps, graphed=False)
        ref = eager(state0)
        timed(label, steps, lambda: ps.run_steps(steps), want)
        g = ps.step_graphs["sharded"]
        check(g.captures == g.segments
              and g.replays == g.segments * (steps - 1),
              f"rank {rank} {label}: {g.captures} captures, {g.replays} "
              f"replays of {g.segments} segments")
        for what, out in (("first call", ps.state),
                          ("replay-only call", graphed(state0))):
            check(all(torch.equal(getattr(out.shards[0], f),
                                  getattr(ref.shards[0], f))
                      for f in RANK_FIELDS),
                  f"rank {rank} {label}: the graphed {what} differs from "
                  "the eager run")
        tg, te = [], []
        for _ in range(GRAPH_TURNS):
            tg.append(wall(lambda: graphed(state0)))
            te.append(wall(lambda: eager(state0)))
        r = rec["rates"][label]
        r.update(first_call_steps_per_s=r["steps_per_s"],
                 steps_per_s=steps / statistics.median(tg),
                 ms_per_step=1e3 * statistics.median(tg) / steps,
                 eager_steps_per_s=steps / statistics.median(te),
                 segments=g.segments, collectives=g.collectives,
                 capture_ms=g.capture_ms, pool_mib=g.pool_bytes / 2**20)

    def system(cfg, distribution):
        ps = ParticleSystem()
        ps.initialize(cfg.replace(shard_devices=RANKS), device=dev)
        check(ps.mesh.size == RANKS and list(ps.mesh.local) == [rank],
              f"rank {rank}: mesh positions {list(ps.mesh.local)}")
        got = ps.diagnostics()["force_distribution"]
        check(got == distribution, f"rank {rank}: distribution {got}")
        return ps

    # m1: the ring
    ps = system(cfgs["100K direct"], "ring")
    acc0 = ps.state.acc
    if rank == 0:
        tensors["m1_acc0"] = acc0.cpu()
    stepped(M1, ps, 10, {"direct_forces": 10 * RANKS})
    del ps, acc0

    # m2: tree-slabs; the step-0 overflows from the path's own call
    cfg = cfgs["1M BH tiles"]
    ps = system(cfg, "tree-slabs")
    st, mesh = ps.state, ps.mesh
    pos_l, mass_l = [x.pos for x in st.shards], [x.mass for x in st.shards]
    eng = bh_engine_params(cfg)
    _, overflow = tree.sharded_barnes_hut_forces(
        pos_l, mass_l, mesh, cfg.G, cfg.softening, cfg.barnes_hut_theta,
        levels=cfg.bh_max_level, near_k=eng["near_k"], return_overflow=True)
    pos = st.pos
    s = (1 << cfg.bh_max_level) // RANKS
    dest = M.split(torch.div(bin_particles(pos, cfg.bh_max_level)[2][:, 0]
                             .long(), s, rounding_mode="floor"), mesh)
    route = sum(int(tree._route_to_slabs(p, m, d, RANKS, p.shape[0])[2])
                for p, m, d in zip(pos_l, mass_l, dest))
    rec["m2_overflow"] = int(overflow)
    rec["m2_route"] = sum(M.all_gather_ints(route))
    acc0 = st.acc
    if rank == 0:
        tensors["m2_pos0"], tensors["m2_acc0"] = pos.cpu(), acc0.cpu()
    del st, pos_l, mass_l, pos, dest, acc0
    stepped(M2, ps, 5, {"far_taps": 5 * eng["levels"],
                        "tile_sweep_slab": 5, "segment_sum": 5})

    # m4: the energy of m2's state after its steps
    got = {}
    # K5's main form on the rank's own block, its cross form at hops
    # 1..P/2 (hop P/2 only on positions below P/2)
    cross = sum(1 for h in range(1, RANKS // 2 + 1)
                if not (2 * h == RANKS and rank >= h))
    timed(M4, 1, lambda: got.update(e=sharded_energy(
        ps.state, ps.mesh, cfg.G, cfg.softening)),
          {"pairwise_potential": 1, "pairwise_potential_cross": cross})
    rec["ke"], rec["pe"] = float(got["e"][0]), float(got["e"][1])

    # m5: checkpoint m2's state, restore it across the ranks
    ckpt = str(Path(out_dir) / "ckpt")
    t0 = time.perf_counter()
    save_checkpoint(ckpt, ps.state, step=CKPT_STEP)
    rec["m5_save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = restore_checkpoint(ckpt, template=ps.state)
    torch.cuda.synchronize()
    rec["m5_restore_s"] = time.perf_counter() - t0
    same = all(torch.equal(getattr(a, f), getattr(b, f))
               for a, b in zip(back.shards, ps.state.shards)
               for f in RANK_FIELDS)
    check(same, f"rank {rank} m5: restored shards differ from the state")
    final = M.gather_state(ps.state)
    if rank == 0:
        tensors["m2_state"] = {f: getattr(final, f).cpu()
                               for f in RANK_FIELDS}
    del ps, back, final
    torch.cuda.empty_cache()

    # m3: hash-slabs
    cfg = cfgs["1M sparse hash"]
    ps = system(cfg, "hash-slabs")
    st, mesh = ps.state, ps.mesh
    _, overflow = tree.sharded_spatial_hash_forces(
        [x.pos for x in st.shards], [x.mass for x in st.shards], mesh,
        cfg.G, cfg.softening, cutoff=cfg.spatial_hash_cutoff,
        cell_size=cfg.spatial_hash_cell_size, cap=cfg.hash_max_grid_dim,
        max_per_cell=cfg.hash_max_per_cell, return_overflow=True)
    rec["m3_overflow"] = int(overflow)
    pos, acc0 = st.pos, st.acc
    if rank == 0:
        tensors["m3_pos0"], tensors["m3_acc0"] = pos.cpu(), acc0.cpu()
    del st, pos, acc0
    stepped(M3, ps, 5, {"tile_sweep_slab": 5})
    del ps

    recs = [None] * RANKS
    dist.all_gather_object(recs, rec)
    if rank == 0:
        for label, r in recs[0]["rates"].items():
            note = rank_note(dist.get_backend())
            if "eager_steps_per_s" in r:
                print(f"{label} [{note}]: graphed {r['steps_per_s']:.3f} / "
                      f"eager {r['eager_steps_per_s']:.3f} steps/s (median "
                      f"of {GRAPH_TURNS} in turns; first graphed call "
                      f"{r['first_call_steps_per_s']:.3f}), "
                      f"{r['ms_per_step']:.4f} ms/step graphed; "
                      f"{r['segments']} segments and {r['collectives']} "
                      f"collectives a step, capture {r['capture_ms']:.1f} "
                      f"ms, pool {r['pool_mib']:.1f} MiB; graph == eager "
                      "bit for bit on every rank (rank 0)")
            else:
                print(f"{label} [{note}]: {r['steps_per_s']:.3f} steps/s, "
                      f"{r['ms_per_step']:.4f} ms/step (rank 0)")
            for other in recs:
                print(f"  rank {other['rank']} launches: "
                      f"{other['launches'][label]}")
        torch.save(tensors, Path(out_dir) / "rank0.pt")
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(rec))
    sys.stdout.flush()
    distributed.barrier()
    dist.destroy_process_group()


def rank_run(out_dir: str, backend: str) -> None:
    """Launch the RANKS ranks of phase 9 on ``backend`` (they load the
    library this process built); fails when a rank fails or the deadline
    passes."""
    from nbody_tpu_torch.parallel.distributed import run_ranks

    t0 = time.perf_counter()
    try:
        run_ranks([sys.executable, str(REPO / "chip_smoke.py"), "--rank",
                   out_dir, backend], RANKS, timeout=RANK_TIMEOUT)
    except RuntimeError as e:
        fail(f"phase 9 ({backend}): {e}")
    print(f"phase 9 ({backend}): {RANKS} ranks ran m1-m5 in "
          f"{time.perf_counter() - t0:.1f} s (start-up included)")


def rank_checks(out_dir, backend, cfgs, scene, sparse, keep, smi, dev):
    """Phase 9's checks, in this process, of the ranks' outputs in
    ``out_dir`` against the one-process and single-device references;
    returns the readings (steps/s, rank 0)."""
    import torch

    from nbody_tpu_torch import ParticleSystem
    from nbody_tpu_torch.models.distributions import init_from_config
    from nbody_tpu_torch.ops.barnes_hut import bh_engine_params
    from nbody_tpu_torch.ops.direct import (
        direct_forces_kernel,
        pairwise_potential,
    )
    from nbody_tpu_torch.ops.forces import make_force_fn
    from nbody_tpu_torch.ops.integrator import kinetic_energy
    from nbody_tpu_torch.parallel import make_mesh, mesh as M
    from nbody_tpu_torch.parallel.step import (
        make_sharded_force_fn,
        sharded_initialize_forces,
    )
    from nbody_tpu_torch.state import ParticleState
    from nbody_tpu_torch.utils import restore_checkpoint

    out = Path(out_dir)
    recs = [json.loads((out / f"rank{r}.json").read_text())
            for r in range(RANKS)]
    ten = torch.load(out / "rank0.pt", weights_only=True)
    tag = f"{backend}, {rank_note(backend)}"
    readings = {}
    for label in recs[0]["launches"]:
        total = {}
        for r in recs:
            for name, c in r["launches"][label].items():
                total[name] = total.get(name, 0) + c
        keep(f"{label} [{backend}]", total)
        if label != M4:
            r = recs[0]["rates"][label]
            readings[f"{label} [{tag}]"] = {
                "steps/s graphed": r["steps_per_s"],
                "steps/s eager": r["eager_steps_per_s"],
                "steps/s graphed first call": r["first_call_steps_per_s"]}

    # m1 against phase 8's s1 (4 virtual shards, the same hop order) and
    # against single-device K1
    cfg = cfgs["100K direct"]
    st = init_from_config(cfg, device=dev)
    mesh = make_mesh(SHARDS, devices=[dev] * SHARDS)
    s1 = sharded_initialize_forces(M.shard_state(st, mesh),
                                   make_sharded_force_fn(cfg, mesh)).acc
    got = ten["m1_acc0"].to(dev)
    d = float((got - s1).abs().max())
    print(f"m1 a(0) vs phase 8's s1 (4 virtual shards of the card): "
          f"{'bit-equal' if torch.equal(got, s1) else 'NOT bit-equal'}, "
          f"max|diff| {d:.4e}")
    check(torch.equal(got, s1), "m1 a(0) is not bit-equal to s1's")
    want = direct_forces_kernel(st.pos, st.mass, cfg.G, cfg.softening)
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    print(f"m1 a(0) vs single-device K1: max|diff| {err:.4e}, max|a| "
          f"{scale:.4e} (tol 2e-4*max|a|)")
    check(err <= 2e-4 * scale, f"m1 a(0) {err} > 2e-4*max|a|")
    del st, s1, got, want

    # m2 at step 0
    cfg = cfgs["1M BH tiles"]
    pos, mass = scene.pos, scene.mass
    check(torch.equal(ten["m2_pos0"].to(dev), pos),
          "m2: the ranks' scene differs from this process's")
    route, over = recs[0]["m2_route"], recs[0]["m2_overflow"]
    check(all(r["m2_route"] == route and r["m2_overflow"] == over
              for r in recs), "m2: the ranks' overflow counts differ")
    ps1 = ParticleSystem()
    ps1.initialize(cfg, device=dev)
    audit = ps1.audit_short_range()
    del ps1
    k = bh_engine_params(cfg)["near_k"]
    print(f"m2 tree-slabs step 0: routing overflow {route} (capacity N/P = "
          f"{N // RANKS}), tile overflow {over - route} rows past k = {k}, "
          f"single-device audit_short_range() {audit}")
    check(route == 0, f"m2 routing overflow {route}")
    check(over - route == audit["overflow"],
          f"m2 tile overflow {over - route} != audit {audit['overflow']}")
    acc = ten["m2_acc0"].to(dev)
    single = make_force_fn(cfg)(pos, mass)
    ok = in_contract(pos, cfg.bh_max_level, k)
    err = float((acc[ok] - single[ok]).abs().max())
    scale = float(single[ok].abs().max())
    print(f"m2 tree-slabs vs single-device tiles engine on the "
          f"{int(ok.sum())} rows within k: max|diff| {err:.4e}, max|a| "
          f"{scale:.4e} (tol 1e-4*max|a|)")
    check(err <= 1e-4 * scale, f"m2 vs single device {err} > 1e-4*max|a|")
    bh_vs_direct(pos, mass, acc, cfg, "m2 BH tree-slabs, 4 ranks")
    del acc, single, ok

    # m3 at step 0
    cfg = cfgs["1M sparse hash"]
    pos, mass = sparse.pos, sparse.mass
    check(torch.equal(ten["m3_pos0"].to(dev), pos),
          "m3: the ranks' scene differs from this process's")
    over = [r["m3_overflow"] for r in recs]
    cut, cs = cfg.spatial_hash_cutoff, cfg.spatial_hash_cell_size
    lo, hi = pos.min(0).values, pos.max(0).values
    dims = torch.clamp(torch.ceil((hi - lo) / cs).to(torch.int32), 1,
                       cfg.hash_max_grid_dim)
    coords = torch.minimum(torch.clamp(torch.floor((pos - lo) / cs).to(
        torch.int32), min=0), dims - 1)
    err, scale, med, held = ground_truth_hash(
        pos, mass, ten["m3_acc0"].to(dev), coords, cut, cfg.softening, cfg.G)
    print(f"m3 hash-slabs step 0: overflow by rank {over}; vs f64 brute "
          f"force ({held} sampled rows, all {N} sources): max|diff| "
          f"{err:.4e}, max|a| {scale:.4e}, median rel err {med:.3e} (tol "
          f"1e-4*max|a|)")
    check(over == [0] * RANKS, f"m3 overflow {over}")
    check(err <= 1e-4 * scale, f"m3 ground truth {err} > 1e-4*max|a|")

    # m5: the checkpoint here, without a template and on 2 positions; m4
    # against the restored state
    ckpt = str(out / "ckpt")
    want = ten["m2_state"]
    back = restore_checkpoint(ckpt)
    for f in RANK_FIELDS:
        check(torch.equal(getattr(back, f), want[f]),
              f"m5: restored {f} differs from the gathered state")
    st = ParticleState(**{f: want[f].to(dev) for f in RANK_FIELDS})
    mesh2 = make_mesh(2, devices=[dev] * 2)
    two = M.gather_state(restore_checkpoint(
        ckpt, template=M.shard_state(st, mesh2)))
    for f in RANK_FIELDS:
        check(torch.equal(getattr(two, f), getattr(st, f)),
              f"m5: {f} restored on 2 positions differs")
    print(f"m5 checkpoint of m2's state at step {CKPT_STEP}: restored "
          f"across the {RANKS} ranks (their state as template), here "
          f"without a template and onto 2 one-process positions, all "
          f"bit-equal; save {recs[0]['m5_save_s']:.3f} s, restore "
          f"{recs[0]['m5_restore_s']:.3f} s on rank 0")
    cfg = cfgs["1M BH tiles"]
    ke, pe = recs[0]["ke"], recs[0]["pe"]
    check(all((r["ke"], r["pe"]) == (ke, pe) for r in recs),
          "m4: the ranks' energies differ")
    ke_1 = float(kinetic_energy(st))
    pe_1 = float(pairwise_potential(st.pos, st.mass, cfg.G, cfg.softening))
    rk, rp = abs(ke - ke_1) / abs(ke_1), abs(pe - pe_1) / abs(pe_1)
    print(f"m4 sharded_energy: KE {ke:.9e} vs {ke_1:.9e} (rel {rk:.3e}), PE "
          f"{pe:.9e} vs K5's main form {pe_1:.9e} (rel {rp:.3e}); tol 1e-6")
    check(rk <= 1e-6 and rp <= 1e-6, f"m4 energies rel {rk}, {rp}")
    print(f"phase 9 readings (steps/s; {tag}): {json.dumps(readings)} "
          f"({smi})")
    return readings


def rank_phase(cfgs, scene, sparse, keep, smi, dev):
    """Phase 9 (m1-m5): the ranks on gloo, 4 on the one card; with 4 or
    more cards also on NCCL, one rank a card."""
    import torch

    torch.cuda.empty_cache()
    readings = {}
    backends = ["gloo"]
    if torch.cuda.device_count() >= RANKS:
        backends.append("nccl")
    else:
        print(f"phase 9: the NCCL run (one rank per card) needs {RANKS} "
              f"cards; this machine has {torch.cuda.device_count()}: "
              "skipped")
    for backend in backends:
        with tempfile.TemporaryDirectory(
                prefix=f"nbody_ranks_{backend}_") as out:
            rank_run(out, backend)
            readings.update(rank_checks(out, backend, cfgs, scene, sparse,
                                        keep, smi, dev))
    return readings


FLAGSHIP_N = 4_000_000
ROUTE_STEPS = 10
ROUTE_PATHS = ("1M BH tiles", "1M sparse hash")


def flagship_module():
    """``scripts/flagship_4m_torch.py``, imported from the checkout."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "flagship_4m_torch", REPO / "scripts" / "flagship_4m_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flagship_bh(res, F, wrappers, plains, none, keep, smi, dev, levels):
    """f1-f4: the flagship's part 1 (bh-4m) through its own function,
    counted; then at its initial state K2 at k 40, K3 at each level and K4
    at k 40 against their twins, and K1 at the gate's 4096 targets × 4M
    rows."""
    import torch

    from nbody_tpu_torch.ops.barnes_hut import (
        bin_particles,
        far_field_grid,
        pyramid_from_packed,
    )
    from nbody_tpu_torch.ops.scatter import tile_scatter
    from nbody_tpu_torch.ops.sorted_window import build_sorted_grid

    n = FLAGSHIP_N
    label = f"f1. 4M BH tiles, flagship bh-4m ({4 * F.BH_STEPS} steps)"
    # a(0), the warm run, 3 timed runs and the gate's force
    forces = 2 + 4 * F.BH_STEPS
    launches, bh, _ = counted_run(
        label, 4 * F.BH_STEPS, lambda: F.run_bh(n, dev),
        {**none, "tile_scatter": forces, "far_taps": forces * levels,
         "far_down": forces, "tile_sweep_plane": forces,
         "direct_forces": 1, "payload_gather": forces},
        wrappers, plains, smi)
    keep(label, launches)
    p = bh["params"]
    check((p["levels"], p["near_engine"], p["near_k"], p["ws"])
          == (6, "tiles", 40, 1), f"bh-4m engine params {p}")
    check_finite(label, bh["out"])
    print(f"  f1 readings: {bh['sps']:.4f} steps/s (best of 3 runs of "
          f"{F.BH_STEPS} from the initial state, {smi}); overflow "
          f"{bh['overflow']} rows; median rel err {bh['error']['median']:.4e}"
          f" (gate < {F.GATE}, held)")

    cfg, state = bh["cfg"], bh["state0"]
    d, k, ws = 1 << p["levels"], p["near_k"], p["ws"]
    shape = "4M BH tiles, k 40 (flagship)"
    lo, cell, coords = bin_particles(state.pos, p["levels"])
    grid = build_sorted_grid(state.pos, state.mass, coords, d)
    k2_check(res, shape, grid, lo, cell, d=d, k=k)
    tk, mk = tile_scatter(grid.psort, grid.cell_start, lo, cell, d=d, k=k)
    del grid
    pyr = pyramid_from_packed(mk[:10].T.reshape(d, d, d, 10), lo, cell,
                              p["levels"])
    k3_checks(res, shape, pyr, cell, ws=ws, eps=cfg.softening,
              levels=p["levels"])
    far = torch.cat(far_field_grid(pyr, ws, 1.0, cfg.softening, p["levels"]),
                    dim=-1).reshape(d, d * d, 19).permute(0, 2, 1)
    plan = k4_check(res, shape, tk, dict(
        k=k, d=d, ws=ws, eps=cfg.softening, lo=lo, cell=cell, counts=mk[10],
        far_plane=far.contiguous()))
    check(plan[0] == 128 // k * ws * ws, f"K4 plan at k {k}: {plan}")
    del tk, mk, pyr, far
    idx = torch.randperm(n, generator=F.generator(dev, 0), device=dev)
    tgt = state.pos[idx[:F.SAMPLES]].contiguous()
    k1_check(res, f"4096 x {n} (flagship gate)", state.pos, state.mass, tgt,
             cfg.G, cfg.softening, block_size=64)
    return bh["sps"]


def flagship_galaxy(res, F, wrappers, plains, none, keep, smi, dev, levels):
    """f5-f6: the flagship's part 2 (galaxy-4m) through its own function,
    counted, its frames written to a temporary directory; then R1 at a
    frame's shape: two renders of the last frame equal (checksums
    printed), equal to its PNG as written, and bit-equal to the ordered
    twin, timed."""
    import torch

    from nbody_tpu_torch.ops.render import render_points, render_points_plain

    n, frames = FLAGSHIP_N, F.FRAMES
    label = (f"f5. 4M galaxy collision, flagship galaxy-4m ({frames} frames "
             f"of {F.STEPS_PER_FRAME} steps)")
    forces = 2 + frames * F.STEPS_PER_FRAME  # a(0), the chunks, the reading
    with tempfile.TemporaryDirectory() as out:
        launches, gal, _ = counted_run(
            label, frames * F.STEPS_PER_FRAME,
            lambda: F.run_galaxy(n, frames, out, dev),
            {**none, "tile_scatter": forces, "far_taps": forces * levels,
             "far_down": forces, "tile_sweep_plane": forces,
             "direct_forces": 1, "payload_gather": forces,
             "render_points": frames + 1},
            wrappers, plains, smi)
        keep(label, launches)
        check_finite(label, gal["out"])
        check(len(gal["paths"]) == frames + 1
              and all(p.is_file() for p in gal["paths"]),
              f"{label}: {len(gal['paths'])} frames written")
        last = read_png(gal["paths"][-1])
    renderer = gal["renderer"]
    pos, vel = F.frame_points(gal["out"])
    a, b = renderer.frame(pos, vel), renderer.frame(pos, vel)
    sums = [int(x.to(torch.int64).sum()) for x in (a, b)]
    check(torch.equal(a, b), f"R1 galaxy-4m frame: two renders differ "
          f"(checksums {sums})")
    check(bool((a.cpu().numpy() == last).all()),
          "R1 galaxy-4m frame: the PNG written differs from the frame")
    r1_ms = gal["r1_ms"]
    print(f"  f5 readings: {gal['sps']:.4f} steps/s with the per-chunk host "
          f"work ({smi}); R1 a frame {min(r1_ms):.4f}-{max(r1_ms):.4f} ms "
          f"(median {sorted(r1_ms)[len(r1_ms) // 2]:.4f}); overflow "
          f"{gal['overflow']} rows; BH median rel err "
          f"{gal['error']['median']:.4e} (reading, not gated); last frame "
          f"checksum {sums[0]} twice, equal to its PNG")
    c = renderer.config
    cam = renderer.camera
    kw = dict(width=c.window_width, height=c.window_height,
              point_size=c.point_size, mode=renderer.color_mapper.mode,
              uint8=True)
    got = render_points(pos, vel, cam, **kw)
    want = render_points_plain(pos, vel, cam, accumulate="ordered", **kw)
    check(torch.equal(got.image, want.image)
          and torch.equal(got.image_u8, want.image_u8),
          "R1 galaxy-4m frame: differs from the ordered twin")
    m = pos.shape[0]

    def call():
        return render_points(pos, vel, cam, **kw)

    rec = dict(
        max_abs_err=0.0, ms=time_ms(call), device_ms=graph_ms(call),
        plain_ms=time_ms(lambda: render_points_plain(
            pos, vel, cam, accumulate="ordered", **kw), reps=3, warm=1),
        **bound(0, 12 * m + c.window_width * c.window_height * 3 * 5),
        library_ms=None,
    )
    add_shape(res, "render_points", f"galaxy-4m frame ({m} of {n} rows, "
              f"{c.window_width}x{c.window_height})", rec)
    print(f"R1 render_points galaxy-4m frame ({m} points): bit-equal to the "
          f"ordered twin; kernel {rec['ms']:.4f} ms, device "
          f"{rec['device_ms']:.4f} ms, twin {rec['plain_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return gal["sps"]


def route_checks(F, cfgs, dev, smi):
    """f7: ``sorted_verlet_step`` with the payload on its own gathers and
    riding the engine's sort (``route_extra``), ``ROUTE_STEPS`` steps of
    the 1M BH tiles and 1M sparse hash scenes from a(0): both bit-equal to
    ``make_sorted_multi_step`` from the same state, each timed."""
    import torch

    from nbody_tpu_torch.models.distributions import init_from_config
    from nbody_tpu_torch.ops import integrator as I
    from nbody_tpu_torch.ops.forces import make_sorted_force_fn

    for label in ROUTE_PATHS:
        cfg = cfgs[label]
        state = init_from_config(cfg, device=dev)
        sf = make_sorted_force_fn(cfg, pos_hint=state.pos)
        state = F.with_forces(state, sf)
        want = I.make_sorted_multi_step(sf, cfg.dt, ROUTE_STEPS)(state)
        secs = {}
        for route in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = I.sorted_state_from(state)
            for _ in range(ROUTE_STEPS):
                s = I.sorted_verlet_step(s, sf, cfg.dt, route_extra=route)
            got = I.to_particle_state(s)
            torch.cuda.synchronize()
            secs[route] = time.perf_counter() - t0
            for f in ("pos", "vel", "acc", "mass", "time"):
                check(torch.equal(getattr(got, f), getattr(want, f)),
                      f"f7 {label}: route_extra={route} {f} differs from "
                      f"make_sorted_multi_step")
        print(f"f7 {label}: sorted_verlet_step x {ROUTE_STEPS}, "
              f"route_extra False and True, bit-equal to "
              f"make_sorted_multi_step; {ROUTE_STEPS / secs[False]:.3f} and "
              f"{ROUTE_STEPS / secs[True]:.3f} steps/s ({smi}; one run each, "
              f"a reading)")


def flagship_phase(res, cfgs, wrappers, plains, none, keep, smi, dev,
                   levels):
    """Phase 10 (f): the 4M flagship's two parts through
    ``scripts/flagship_4m_torch.py``'s own functions, the kernels at its
    shapes, and the sorted-state routes at 1M."""
    import torch

    F = flagship_module()
    torch.cuda.empty_cache()
    readings = {
        "bh-4m": flagship_bh(res, F, wrappers, plains, none, keep, smi, dev,
                             levels),
        "galaxy-4m": flagship_galaxy(res, F, wrappers, plains, none, keep,
                                     smi, dev, levels),
    }
    torch.cuda.empty_cache()
    route_checks(F, cfgs, dev, smi)
    return readings


# Phase 11 (g): one-program stepping, the facade's captured step
GRAPH_STEPS = 10
GRAPH_TURNS = 3
GRAPH_PATHS = ("1M BH tiles", MONOPOLE, "1M dense hash", "1M sparse hash",
               "1M BH window", "100K direct")
STATE_FIELDS = ("pos", "vel", "acc", "mass", "time")


def wall_s(fn) -> float:
    """Host seconds of ``fn()`` to a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def state_diff(a, b) -> dict:
    return {k: float((getattr(a, k) - getattr(b, k)).abs().max())
            for k in STATE_FIELDS}


def hold_to_eager(label, outs, eagers) -> None:
    """The eager runs ``eagers`` (≥ 2, from the same state) bit-equal to
    each other, and each of ``outs`` bit-equal to them."""
    import torch

    for what, out in [(f"eager run {i + 2}", e)
                      for i, e in enumerate(eagers[1:])] + list(outs):
        check_finite(f"{label} {what}", out)
        same = [k for k in STATE_FIELDS
                if torch.equal(getattr(out, k), getattr(eagers[0], k))]
        check(len(same) == len(STATE_FIELDS),
              f"{label}: the {what} differs from the first eager run in "
              f"{set(STATE_FIELDS) - set(same)}: "
              f"{state_diff(out, eagers[0])}")


def graph_path(label, graph, graphed, eager, step_kernels, state0, steps,
               smi):
    """One path: ``graphed`` (through the captured step ``graph``) and
    ``eager`` (the multi-step function of the same force), ``steps``
    steps each from ``state0``. The graph's first call (its eager step,
    the capture, replays) and a replay-only call held to two eager runs (``hold_to_eager``); both timed in turns (host clock to a
    synchronize, median of ``GRAPH_TURNS``); the graph's kernel nodes held
    to one eager step's kernels (``step_kernels()``) plus the copy-back's.
    Returns the readings."""
    import torch

    first = graphed(state0)
    torch.cuda.synchronize()
    check(graph.captures == 1 and graph.replays == steps - 1,
          f"{label}: {graph.captures} captures, {graph.replays} replays "
          f"after the first call of {steps} steps")
    again = graphed(state0)
    check(graph.captures == 1, f"{label}: a second call captured again")
    eagers = [eager(state0) for _ in range(2)]
    hold_to_eager(label, [("first call", first),
                          ("replay-only call", again)], eagers)
    del first, again, eagers
    tg, te = [], []
    for _ in range(GRAPH_TURNS):
        tg.append(wall_s(lambda: graphed(state0)))
        te.append(wall_s(lambda: eager(state0)))
    nodes, per_step = kernel_nodes(graph.graph), step_kernels()
    check(nodes == per_step + graph.copy_kernels,
          f"{label}: the graph holds {nodes} kernels, one eager step "
          f"queues {per_step} (+ {graph.copy_kernels} copy-back)")
    rec = {
        "steps/s graphed": steps / statistics.median(tg),
        "steps/s eager": steps / statistics.median(te),
        "capture ms": graph.capture_ms,
        "pool MiB": graph.pool_bytes / 2**20,
        "kernels a step": nodes,
        "eager kernels a step": per_step,
        "copy-back kernels": graph.copy_kernels,
    }
    print(f"g {label}: graphed {rec['steps/s graphed']:.3f} steps/s, eager "
          f"{rec['steps/s eager']:.3f} steps/s ({steps} steps a run, median "
          f"of {GRAPH_TURNS} in turns; {smi}); capture {graph.capture_ms:.1f}"
          f" ms, pool {rec['pool MiB']:.1f} MiB; {nodes} kernels a step in "
          f"the graph = {per_step} of an eager step + {graph.copy_kernels} "
          "copy-back; graph == eager bit for bit")
    return rec


def facade_graph_path(label, cfg, steps, smi, dev):
    """``graph_path`` through a facade on ``cfg``: its ``run_steps``
    function on the card and ``_multi_step(..., graphed=False)``. Returns
    (readings, the system)."""
    from nbody_tpu_torch import ParticleSystem
    from nbody_tpu_torch.ops.integrator import sorted_state_from

    ps = ParticleSystem()
    ps.initialize(cfg, device=dev)
    state0 = ps.state
    kind = "plain" if ps._sorted_step is None else "sorted"
    graphed = ps._multi_step(steps)
    eager = ps._multi_step(steps, graphed=False)
    graph = ps.step_graphs[kind]
    if kind == "sorted":
        s0, step = sorted_state_from(state0), ps._sorted_step
    else:
        s0, step = state0, ps._step
    rec = graph_path(label, graph, graphed, eager,
                     lambda: graph_kernels(lambda: step(s0)), state0, steps,
                     smi)
    rec["step"] = kind
    return rec, ps


def update_check(ps, smi) -> dict:
    """``update()`` ×GRAPH_STEPS through the facade's plain-step graph
    against the eager plain step from the same state, bit for bit, and
    ms an update of each (median of GRAPH_TURNS runs in turns): the
    render loop's step."""
    import torch

    from nbody_tpu_torch.ops.integrator import make_multi_step

    n = GRAPH_STEPS
    s0 = ps.state
    eager = make_multi_step(ps._force_fn, ps.config.dt, n)
    want = eager(s0)
    for _ in range(n):
        ps.update()
    g = ps.step_graphs["plain"]
    check((g.captures, g.replays) == (1, n - 1),
          f"update: {g.captures} captures, {g.replays} replays")
    for k in STATE_FIELDS:
        check(torch.equal(getattr(ps.state, k), getattr(want, k)),
              f"update x{n}: {k} differs from the eager step")

    def updates():
        for _ in range(n):
            ps.update()

    tg, te = [], []
    for _ in range(GRAPH_TURNS):
        tg.append(wall_s(updates))
        te.append(wall_s(lambda: eager(s0)))
    nodes, per_step = kernel_nodes(g.graph), graph_kernels(
        lambda: ps._step(s0))
    check(nodes == per_step + g.copy_kernels,
          f"update: {nodes} graph kernels, {per_step} eager "
          f"+ {g.copy_kernels}")
    rec = {"ms an update graphed": statistics.median(tg) / n * 1e3,
           "ms an update eager": statistics.median(te) / n * 1e3,
           "capture ms": g.capture_ms, "kernels a step": nodes}
    print(f"g update() x{n} on 1M BH tiles (the render loop's step): bit-"
          f"equal to the eager plain step; {rec['ms an update graphed']:.3f}"
          f" ms an update graphed, {rec['ms an update eager']:.3f} eager "
          f"({smi}); capture {g.capture_ms:.1f} ms, {nodes} kernels a step "
          f"= {per_step} + {g.copy_kernels} copy-back")
    return rec


def cache_checks(ps) -> None:
    """On a graphed facade that has run: a second run_steps captures
    nothing; set_time_step and set_softening each drop the graph and the
    next run captures once and equals a fresh eager run at the new
    parameter bit for bit; a state handed out earlier is unchanged after
    all of it."""
    import torch

    g = ps.step_graphs["sorted"]
    caps = g.captures
    ps.run_steps(2)
    check(ps.step_graphs["sorted"] is g and g.captures == caps,
          "a second run_steps captured again")
    held = ps.state
    copy = {k: getattr(held, k).clone() for k in STATE_FIELDS}
    for name, change in (("set_time_step(2e-3)",
                          lambda: ps.set_time_step(2e-3)),
                         ("set_softening(0.2)",
                          lambda: ps.set_softening(0.2))):
        change()
        check(ps.step_graphs == {}, f"{name} kept the graph")
        start = ps.state
        want = ps._multi_step(3, graphed=False)(start)
        ps.run_steps(3)
        g = ps.step_graphs["sorted"]
        check(g.captures == 1, f"after {name}: {g.captures} captures")
        for k in STATE_FIELDS:
            check(torch.equal(getattr(ps.state, k), getattr(want, k)),
                  f"after {name}: {k} differs from a fresh eager run")
    ps.update()
    torch.cuda.synchronize()
    for k in STATE_FIELDS:
        check(torch.equal(getattr(held, k), copy[k]),
              f"a held state's {k} changed under later calls")
    print("g cache: a second run_steps captures nothing; set_time_step and "
          "set_softening each drop the graph, one capture after each, equal "
          "to a fresh eager run at the new parameter bit for bit; a state "
          "handed out earlier unchanged after later run_steps and update()")


def flagship_graph(F, smi, dev) -> dict:
    """bh-4m (``F.bh_config`` at ``FLAGSHIP_N``, the facade's own scene)
    through the graphed facade against the eager sorted step: one run
    each held bit for bit, then the best of 3 runs of ``F.BH_STEPS`` steps
    each, in turns."""
    import torch

    from nbody_tpu_torch import ParticleSystem

    ps = ParticleSystem()
    ps.initialize(F.bh_config(FLAGSHIP_N), device=dev)
    state0 = ps.state
    steps = F.BH_STEPS
    graphed = ps._multi_step(steps)
    eager = ps._multi_step(steps, graphed=False)
    got, want = graphed(state0), eager(state0)
    for k in STATE_FIELDS:
        check(torch.equal(getattr(got, k), getattr(want, k)),
              f"bh-4m: the graph's {k} differs from the eager run")
    del got, want
    g = ps.step_graphs["sorted"]
    tg, te = [], []
    for _ in range(3):
        tg.append(wall_s(lambda: graphed(state0)))
        te.append(wall_s(lambda: eager(state0)))
    rec = {"steps/s graphed": steps / min(tg),
           "steps/s eager": steps / min(te), "capture ms": g.capture_ms,
           "pool MiB": g.pool_bytes / 2**20,
           "kernels a step": kernel_nodes(g.graph)}
    print(f"g bh-4m through the graphed facade: {rec['steps/s graphed']:.3f}"
          f" steps/s graphed, {rec['steps/s eager']:.3f} eager (best of 3 "
          f"runs of {steps} steps in turns; {smi}), bit-equal; capture "
          f"{g.capture_ms:.1f} ms, pool {rec['pool MiB']:.1f} MiB, "
          f"{rec['kernels a step']} kernels a step")
    return rec


FROZEN_GRAPH_STEPS = 30


def split_run(out):
    """(state, trace or None) of a driver's result."""
    return out if isinstance(out, tuple) else (out, None)


def frozen_graph_path(label, space, cfg, state0, sf, tp, steps, smi):
    """One frozen-grid driver (``space`` "row" or "table", ``cfg``'s knob)
    on captured segments against the same driver run eagerly, ``steps``
    steps from ``state0``: the first call (each segment's first use eager,
    then captured) and a replay-only call held to two eager runs
    (``hold_to_eager``), traces equal, host reads a run equal to the eager
    driver's; both timed in turns (median of ``GRAPH_TURNS``). Returns
    the readings and the carry."""
    from nbody_tpu_torch.ops.step_graph import SegmentGraphs
    from nbody_tpu_torch.system import _resort_knob

    import torch

    knob = _resort_knob(cfg)
    traced = knob != "cadence"

    def run(g):
        if space == "table":
            return table_multi(tp, cfg, knob, steps, traced, g)(state0)
        return row_multi(sf, cfg, knob, steps, traced, g)(state0)

    graphs = SegmentGraphs()
    first = split_run(run(graphs))
    reads = graphs.host_reads
    # a side bucket's growth in the first call drops every segment, the
    # entry after its use: the second call may capture it again
    again = split_run(run(graphs))
    captures = graphs.captures
    carries = [SegmentGraphs(graphed=False) for _ in range(2)]
    eagers = [split_run(run(g)) for g in carries]
    check(reads == graphs.host_reads - reads == carries[0].host_reads,
          f"{label}: host reads a run {reads}, "
          f"{graphs.host_reads - reads} (graphed), eager "
          f"{carries[0].host_reads}")
    if traced:
        for what, (_, tr) in (("first call", first), ("replay-only call",
                                                      again)):
            check(all(torch.equal(a, b) for a, b in zip(tr, eagers[0][1])),
                  f"{label}: the graph's {what} trace differs from eager")
    hold_to_eager(label, [("first call", first[0]),
                          ("replay-only call", again[0])],
                  [e[0] for e in eagers])
    del first, again, eagers
    tg, te = [], []
    for _ in range(GRAPH_TURNS):
        tg.append(wall_s(lambda: run(graphs)))
        te.append(wall_s(lambda: run(SegmentGraphs(graphed=False))))
    check(graphs.captures == captures,
          f"{label}: a call after the second captured again")
    rec = {
        "steps/s graphed": steps / statistics.median(tg),
        "steps/s eager": steps / statistics.median(te),
        "captures": graphs.captures,
        "capture ms": sum(g.capture_ms for g in graphs.segments.values()),
        "pool MiB": graphs.pool_bytes / 2**20,
        "host reads a run": reads,
        "side bucket": graphs.state.get("side_cap"),
        "side grows": graphs.state.get("side_grows", 0),
    }
    print(f"g {label}, {space} driver: graphed {rec['steps/s graphed']:.3f} "
          f"steps/s, eager {rec['steps/s eager']:.3f} ({steps} steps a run, "
          f"median of {GRAPH_TURNS} in turns; {smi}); "
          f"{describe_graphs(graphs)}"
          "; graph == eager bit for bit"
          + (", traces equal" if traced else ""))
    return rec, graphs


def frozen_graph_phase(cfgs, smi, dev) -> dict:
    """The ten frozen-grid drivers at 1M on the phase-3 scenes (the row-
    space cadence and audited re-sort, the table cadence, audited re-sort
    and repair, on Barnes-Hut tiles and the sparse hash; 30 steps,
    ``frozen_graph_path``), the Barnes-Hut table drivers on the cold
    collapse, whose side bucket must grow (every segment captured again
    after each growth, still equal to eager), then the facade's cache of
    these graphs."""
    import torch

    from nbody_tpu_torch import ParticleSystem
    from nbody_tpu_torch.ops.forces import make_table_step_params
    from nbody_tpu_torch.system import _resort_knob

    readings = {}
    for label, mode in FROZEN_PATHS:
        cfg = cfgs[label]
        ps = ParticleSystem()
        ps.initialize(cfg, device=dev)
        state0, sf = ps.state, ps._sorted_force
        tp = make_table_step_params(cfg, device=dev, pos_hint=state0.pos)
        spaces = ("table",) if _resort_knob(cfg) == "repair" else (
            "row", "table")
        for space in spaces:
            rec, graphs = frozen_graph_path(label, space, cfg, state0, sf,
                                            tp, FROZEN_GRAPH_STEPS, smi)
            readings[f"{label}, {space}"] = rec
            if (mode, space) == ("bh", "table"):
                check(rec["side grows"] >= 1
                      and graphs.captures > len(graphs.segments),
                      f"{label}: the side bucket did not grow on the "
                      f"collapse ({graphs.state}, {graphs.captures} "
                      f"captures of {len(graphs.segments)} segments)")
                print(f"g {label}, the collapse: the side bucket grew "
                      f"{rec['side grows']} times to {rec['side bucket']} "
                      f"rows; {graphs.captures} captures, "
                      f"{len(graphs.segments)} segments kept (the rest "
                      "dropped at a growth and captured again at their "
                      "next use); equal to eager")
            del graphs
            torch.cuda.empty_cache()
        del ps, state0
    ps = ParticleSystem()
    ps.initialize(cfgs[BH_RESORT], device=dev)
    frozen_cache_checks(ps)
    del ps
    torch.cuda.empty_cache()
    return readings


def frozen_cache_checks(ps) -> None:
    """On a graphed facade on a frozen-grid knob: a second ``run_steps``
    captures nothing and equals the eager driver; ``set_time_step`` drops
    the graphs, and the next run captures again and equals a fresh eager
    run at the new dt bit for bit; a state handed out earlier is unchanged
    after all of it."""
    import torch

    start = ps.state
    want = ps._multi_step(5, graphed=False)(start)
    ps.run_steps(5)
    (kind, g), = ps.step_graphs.items()
    caps = g.captures
    for k in STATE_FIELDS:
        check(torch.equal(getattr(ps.state, k), getattr(want, k)),
              f"frozen cache: {k} differs from the eager driver")
    held = ps.state
    copy = {k: getattr(held, k).clone() for k in STATE_FIELDS}
    ps.run_steps(3)
    check(ps.step_graphs[kind] is g and g.captures == caps,
          "frozen cache: a second run_steps captured again")
    ps.set_time_step(2e-3)
    check(ps.step_graphs == {}, "set_time_step kept the frozen graphs")
    start = ps.state
    want = ps._multi_step(3, graphed=False)(start)
    ps.run_steps(3)
    for k in STATE_FIELDS:
        check(torch.equal(getattr(ps.state, k), getattr(want, k)),
              f"frozen cache after set_time_step: {k} differs")
    torch.cuda.synchronize()
    for k in STATE_FIELDS:
        check(torch.equal(getattr(held, k), copy[k]),
              f"frozen cache: a held state's {k} changed")
    print(f"g frozen cache ({kind}): a second run_steps captures nothing; "
          "set_time_step drops the graphs, the next run equals a fresh "
          "eager run bit for bit; a state handed out earlier unchanged")


def graph_phase(cfgs, scene, smi, dev) -> dict:
    """Phase 11 (g): one-program stepping. The facade's captured step
    against the eager multi-step functions of the same force on the 1M
    paths and 100K direct (``graph_path``), the monopole path on a
    ``StepGraph`` of its sorted step (the facade never selects it),
    ``update()`` (``update_check``), the cache and aliasing checks
    (``cache_checks``) and bh-4m (``flagship_graph``). Returns the
    readings."""
    import torch

    from nbody_tpu_torch.ops.integrator import (
        initialize_forces,
        make_sorted_multi_step,
        sorted_state_from,
        sorted_verlet_step,
        to_particle_state,
    )
    from nbody_tpu_torch.ops.step_graph import StepGraph

    readings = {}
    for label in GRAPH_PATHS:
        if label == MONOPOLE:
            cfg = cfgs["1M BH tiles"]
            force_fn, sorted_fn = monopole_forces(cfg)
            state0 = initialize_forces(scene, force_fn)

            def step(s, sorted_fn=sorted_fn, dt=cfg.dt):
                return sorted_verlet_step(s, sorted_fn, dt)

            graph = StepGraph(step)
            s0 = sorted_state_from(state0)
            readings[label] = graph_path(
                label, graph,
                lambda st: to_particle_state(
                    graph(sorted_state_from(st), GRAPH_STEPS)),
                make_sorted_multi_step(sorted_fn, cfg.dt, GRAPH_STEPS),
                lambda: graph_kernels(lambda: step(s0)), state0,
                GRAPH_STEPS, smi)
            del graph, state0, s0
        else:
            rec, ps = facade_graph_path(label, cfgs[label], GRAPH_STEPS,
                                        smi, dev)
            readings[label] = rec
            if label == "1M BH tiles":
                readings["update() x10, 1M BH tiles"] = update_check(ps, smi)
                cache_checks(ps)
            del ps
        torch.cuda.empty_cache()
    readings.update(frozen_graph_phase(cfgs, smi, dev))
    readings["bh-4m"] = flagship_graph(flagship_module(), smi, dev)
    torch.cuda.empty_cache()
    return readings


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
    from nbody_tpu_torch.ops.forces import make_force_fn
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
    from nbody_tpu_torch.ops.window_sweep import window_starts
    from nbody_tpu_torch.system import TABLE_ROUTES, _resort_knob

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
    wrappers, plains = kernel_wrappers()
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
        launches, out, _ = counted_run(label, steps, lambda: multi(state0),
                                       {**none, **want}, wrappers, plains,
                                       smi)
        keep(label, launches)
        check_finite(label, out)
        return out, launches

    levels = bh_engine_params(bh_cfg)["levels"]
    bh_run = drive("1M BH tiles", 30, tile_scatter=30, far_taps=30 * levels,
                   far_down=30, tile_sweep_plane=30, payload_gather=30)
    collapse_check(res, bh_run[2].state, bh_cfg, "1M BH tiles after 30 steps")
    drive("1M dense hash", 30, window_sweep=30, payload_gather=30)
    drive("1M sparse hash", 30, tile_scatter=30, tile_sweep_plane=30,
          payload_gather=30)
    check(bh_engine_params(bhw_cfg)["near_engine"] == "window",
          "bh_max_level 5 at 1M must select the window engine")
    drive("1M BH window", 10, window_sweep=10, far_taps=10 * 5,
          segment_sum=10, payload_gather=10)
    drive("100K direct", 10, direct_forces=10)
    keep(MONOPOLE, run_monopole(
        bh_cfg, scene, 10,
        {**none, "segment_sum": 10, "tile_scatter": 10,
         "tile_sweep_plane": 10, "payload_gather": 10}, wrappers, plains,
        smi))
    # g-j and the two knobs' mirrors on the other scene
    rates = {}
    for label, mode in FROZEN_PATHS:
        rates[label] = frozen_grid_path(
            label, mode, 30, levels if mode == "bh" else 0, drive, drive_row,
            smi, dev)
    print(f"routing: {json.dumps(rates)}")
    measured = sorted((mode, _resort_knob(cfgs[label]))
                      for label, mode in FROZEN_PATHS
                      if rates[label]["table wins"])
    print(f"routing measured (the table wins by more than the spread): "
          f"{measured}; system.TABLE_ROUTES {sorted(TABLE_ROUTES)}: "
          f"{'agree' if set(measured) == TABLE_ROUTES else 'DISAGREE'}")
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
    check((p["window"], p["block"]) == (N, 256),
          f"dense hash window {p['window']} at block {p['block']}")
    print(f"dense hash window: every row, {p['window']}, at block "
          f"{p['block']} (the JAX package's default: 2048 at block 256)")
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
    check(int(over) == 0, f"dense hash: the window {p['window']} drops "
          f"{int(over)} rows at step 0")

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
         "far_down": steps + 1, "tile_sweep_plane": steps + 1,
         "payload_gather": steps + 1}, wrappers, plains, smi, dev))

    # Phase 6 (k): the CLI entry point
    readings = cli_phase(res, wrappers, plains, none, keep, smi, dev, levels)
    print(f"cli readings: {json.dumps(readings)} ({smi})")

    # Phase 7 (r): rendering
    readings = render_phase(res, scene, wrappers, plains, none, keep, smi,
                            dev, levels)
    print(f"render readings: {json.dumps(readings)} ({smi})")

    # Phase 8 (s): the sharded paths on four virtual shards of the card
    readings = sharded_phase(res, cfgs, scene, sparse, wrappers, plains,
                             none, keep, smi, dev, levels)
    print(f"sharded readings (steps/s; {SHARD_NOTE}): "
          f"{json.dumps(readings)} ({smi})")

    # Phase 9 (m): the mesh across processes, 4 ranks on the card
    rank_phase(cfgs, scene, sparse, keep, smi, dev)

    # Phase 10 (f): the 4M flagship and the sorted-state routes
    readings = flagship_phase(res, cfgs, wrappers, plains, none, keep, smi,
                              dev, levels)
    print(f"flagship readings (steps/s): {json.dumps(readings)} ({smi})")

    # Phase 11 (g): one-program stepping
    readings = graph_phase(cfgs, scene, smi, dev)
    print(f"graph readings: {json.dumps(readings)} ({smi})")
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
        # no TPU kernel: XLA ops of the JAX far field's downward pass
        "far_down": ("nbody_tpu_torch/csrc/far_down.cu",
                     "nbody_tpu/ops/barnes_hut.py:549 (far_field_grid's "
                     "level loop, XLA ops)"),
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
        # no TPU kernel: the JAX package renders on the host
        "render_points": ("nbody_tpu_torch/csrc/render.cu",
                          "native/rasterizer.cpp:23 + "
                          "nbody_tpu/render/renderer.py:77 (host code, no "
                          "TPU kernel)"),
        # the sharded paths' forms; the JAX package runs both in XLA
        "tile_sweep_slab": ("nbody_tpu_torch/csrc/tile_near.cu",
                            "nbody_tpu/ops/pallas_tile_near.py:473 (K4; its "
                            "slab form replaces the XLA slab sweep "
                            "nbody_tpu/parallel/tree.py:145)"),
        "pairwise_potential_cross": (
            "nbody_tpu_torch/csrc/pair_potential.cu",
            "nbody_tpu/ops/direct.py:257 (K5; its cross form replaces the "
            "XLA ring energy nbody_tpu/parallel/step.py:201)"),
        # no TPU kernel: the XLA gather of the JAX cell sort
        "payload_gather": ("nbody_tpu_torch/csrc/payload_gather.cu",
                           "nbody_tpu/ops/sorted_window.py:130 "
                           "(build_sorted_grid's payload gather, XLA ops)"),
    }
    names = {"tile_sweep_slab": "K4 slab",
             "pairwise_potential_cross": "K5 cross"}
    for name in sources:
        check(bool(by_path[name]), f"{name} never launched on a timed path")
    # launches: the sum over the timed paths; launches_by_path: each
    # path's own count, read just after that path's run
    kernels = [
        {"name": names.get(name, name), "route": "cuda", "source": src,
         "replaces": rep,
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
    if sys.argv[1:2] == ["--rank"]:
        rank_main(*sys.argv[2:4])
    else:
        main()
