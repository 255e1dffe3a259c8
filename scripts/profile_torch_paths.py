#!/usr/bin/env python3
"""Where a step's time goes on the card, for each 1M path of the PyTorch port.

    python3 scripts/profile_torch_paths.py [--steps 10]
        [--out build/profile_torch_paths.json] [--paths LABEL ...]

From the root of a checkout, on a machine with one CUDA card. For each path
that ``chip_smoke.py`` drives — the facade paths of
``chip_smoke.path_configs`` (1M Barnes-Hut tiles, 1M dense hash, 1M
sparse hash, 1M Barnes-Hut window engine, 100K direct, and the six
frozen-grid paths: the re-sort cadence, the audited re-sort and repair on
the sparse hash and Barnes-Hut tiles, each as the facade routes it), through
the facade's eager multi-step function (``ParticleSystem._multi_step(...,
graphed=False)``, what ``run_steps`` ran before it replayed captured
graphs) and through the graphed ``run_steps`` function as well (label
"... (graphed)": one captured step, or on the frozen-grid paths the
driver's captured segments, ``ops/step_graph.py``), the 1M Barnes-Hut
monopole path
(``chip_smoke.monopole_forces`` under ``make_sorted_multi_step``) and the
4M flagship's two step paths (``scripts/flagship_4m_torch.py``'s scenes
and configs under ``make_sorted_multi_step``, and each of these three on a
``StepGraph`` of its sorted step as well, "... (graphed)") and the sharded
paths of ``chip_smoke.py`` phase 8 on 4 virtual shards of the card
(``SHARDED_PATHS``: s1 the ring, s2 tree-slabs, s3 hash-slabs, through
``parallel.step.sharded_multi_step`` eagerly and on its captured
segments, "... (graphed)"; not scaling numbers); ``--paths`` picks
labels —
it takes a warm run of ``steps`` steps from the initial state, then:

  * times ``steps`` steps from the initial state with no profiler (host
    clock around ``synchronize``) → ms/step;
  * traces the same steps under ``torch.profiler`` (CPU + CUDA
    activity) → device kernels per step, device busy ms/step (the union of
    the kernel intervals of the exported trace) and the device time of
    each kernel name per step;
  * reports the idle share as 1 − busy / unprofiled ms/step;
  * on a graphed path, also the kernel nodes of the captured step
    (``chip_smoke.kernel_nodes``), the kernels a replay launches; on a
    frozen-grid path those of each captured segment, and the host reads
    of a run; on a sharded path those of each captured segment, and the
    segments and collectives a step.

Prints one summary line per path and writes everything as JSON to
``--out`` (the trace is written beside it and removed). Needs a card;
exits non-zero without one.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


FLAGSHIP_BH = "4M BH tiles (flagship bh-4m)"
FLAGSHIP_GALAXY = "4M galaxy collision (flagship galaxy-4m)"
# label -> chip_smoke.path_configs() key, run on 4 virtual shards of the card
SHARDED_PATHS = {"s1 100K direct, ring (4 virtual shards)": "100K direct",
                 "s2 1M BH tree-slabs (4 virtual shards)": "1M BH tiles",
                 "s3 1M sparse hash-slabs (4 virtual shards)":
                     "1M sparse hash"}


def busy_ms(trace_path: str) -> tuple[float, int, dict]:
    """(union of kernel intervals in ms, kernel count, ms by kernel name)
    from a chrome trace exported by torch.profiler."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans, by_name = [], {}
    for e in events:
        if e.get("cat") == "kernel" and e.get("ph") == "X":
            spans.append((e["ts"], e["ts"] + e["dur"]))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    spans.sort()
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3, len(spans), by_name


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default="build/profile_torch_paths.json")
    ap.add_argument("--paths", nargs="+", default=None,
                    help="the labels to profile (default: all)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from chip_smoke import (
        MONOPOLE,
        flagship_module,
        kernel_nodes,
        monopole_forces,
        path_configs,
    )
    from nbody_tpu_torch import ParticleSystem
    from nbody_tpu_torch.models.distributions import init_from_config
    from nbody_tpu_torch.ops.forces import make_sorted_force_fn
    from nbody_tpu_torch.ops.integrator import (
        initialize_forces,
        make_sorted_multi_step,
        sorted_state_from,
        sorted_verlet_step,
        to_particle_state,
    )
    from nbody_tpu_torch.ops.step_graph import SegmentGraphs, StepGraph
    from nbody_tpu_torch.parallel import make_mesh, mesh as M
    from nbody_tpu_torch.parallel.program import ShardedGraphs
    from nbody_tpu_torch.parallel.step import (
        make_sharded_force_fn,
        sharded_initialize_forces,
        sharded_multi_step,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    steps = args.steps
    paths = path_configs()
    report = {"card": smi, "steps": steps, "paths": {}}
    out_dir = os.path.dirname(args.out) or "."
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, "profile_trace.json")
    def sync():
        torch.cuda.synchronize()

    def measure(label, run, reset, graph=None):
        """``run()`` takes ``steps`` steps from the initial state after
        ``reset()``; ``graph``: the captured step ``run`` replays."""
        run()
        sync()
        reset()
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        step_ms = (time.perf_counter() - t0) / steps * 1e3
        reset()
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            sync()
            prof_ms = (time.perf_counter() - t0) / steps * 1e3
        prof.export_chrome_trace(trace)
        busy, count, by_name = busy_ms(trace)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        rec = {
            "ms_per_step": step_ms,
            "ms_per_step_profiled": prof_ms,
            "kernels_per_step": count / steps,
            "busy_ms_per_step": busy / steps,
            "idle_share": 1.0 - (busy / steps) / step_ms,
            "top_kernels_ms_per_step": {k: v / steps for k, v in top},
        }
        note = ""
        if isinstance(graph, ShardedGraphs):
            rec["segment_kernels"] = {
                str(k): kernel_nodes(seg.graph)
                for g in graph.sets.values() for k, seg in g.segments.items()}
            rec["segments_a_step"] = graph.segments
            rec["collectives_a_step"] = graph.collectives
            note = (f", segments' kernels {rec['segment_kernels']}, "
                    f"{graph.collectives} collectives a step")
        elif isinstance(graph, SegmentGraphs):
            rec["segment_kernels"] = {str(k): kernel_nodes(g.graph)
                                      for k, g in graph.segments.items()}
            rec["host_reads_per_run"] = graph.host_reads / 3
            note = (f", segments' kernels {rec['segment_kernels']}, "
                    f"{rec['host_reads_per_run']:g} host reads a run")
        elif graph is not None:
            rec["graph_kernels_per_step"] = kernel_nodes(graph.graph)
            note = f", {rec['graph_kernels_per_step']} kernels in the graph"
        report["paths"][label] = rec
        print(f"{label}: {step_ms:.3f} ms/step unprofiled "
              f"({prof_ms:.3f} profiled), {count / steps:.1f} kernels/step, "
              f"device busy {busy / steps:.3f} ms/step, idle share "
              f"{rec['idle_share']:.3f}{note} ({smi})")
        for k, v in top:
            print(f"    {v / steps:8.4f} ms/step  {k[:90]}")

    def wanted(label):
        return args.paths is None or label in args.paths

    def sorted_paths(label, sf, dt, state0):
        """The eager sorted stepping and the same step on a
        ``StepGraph``."""
        if wanted(label):
            multi = make_sorted_multi_step(sf, dt, steps)
            measure(label, lambda: multi(state0), lambda: None)
        if wanted(f"{label} (graphed)"):
            graph = StepGraph(lambda s: sorted_verlet_step(s, sf, dt))
            measure(f"{label} (graphed)", lambda: to_particle_state(
                graph(sorted_state_from(state0), steps)), lambda: None, graph)

    for label, cfg in paths.items():
        if not wanted(label) and not wanted(f"{label} (graphed)"):
            continue
        ps = ParticleSystem()
        ps.initialize(cfg)
        state0 = ps.state
        eager = ps._multi_step(steps, graphed=False)
        graphed = ps._multi_step(steps)
        if wanted(label):
            measure(label, lambda: eager(state0), lambda: None)
        if ps.step_graphs and wanted(f"{label} (graphed)"):
            graph, = ps.step_graphs.values()
            measure(f"{label} (graphed)", lambda: graphed(state0),
                    lambda: None, graph)
        del ps, eager, graphed
        torch.cuda.empty_cache()

    if wanted(MONOPOLE) or wanted(f"{MONOPOLE} (graphed)"):
        bh = paths["1M BH tiles"]
        force_fn, sorted_fn = monopole_forces(bh)
        state0 = initialize_forces(init_from_config(bh, device="cuda"),
                                   force_fn)
        sorted_paths(MONOPOLE, sorted_fn, bh.dt, state0)

    # the 4M flagship's two step paths (scripts/flagship_4m_torch.py), its
    # sorted stepping alone (no rendering)
    F = flagship_module()
    for label, config, scene in (
            (FLAGSHIP_BH, F.bh_config(F.N), F.bh_scene),
            (FLAGSHIP_GALAXY, F.galaxy_config(F.N), F.galaxy_scene)):
        if not wanted(label) and not wanted(f"{label} (graphed)"):
            continue
        state = scene(F.N, torch.device("cuda"))
        sf = make_sorted_force_fn(config, pos_hint=state.pos)
        state0 = F.with_forces(state, sf)
        sorted_paths(label, sf, config.dt, state0)
        del state, state0, sf
        torch.cuda.empty_cache()
    mesh = make_mesh(4, devices=[torch.device("cuda")] * 4)
    for label, key in SHARDED_PATHS.items():
        if not wanted(label) and not wanted(f"{label} (graphed)"):
            continue
        cfg = paths[key]
        force = make_sharded_force_fn(cfg, mesh)
        state0 = sharded_initialize_forces(
            M.shard_state(init_from_config(cfg, device="cuda"), mesh), force)
        eager = sharded_multi_step(force, cfg.dt, steps, graphed=False)
        graphed = sharded_multi_step(force, cfg.dt, steps)
        if wanted(label):
            measure(label, lambda: eager(state0), lambda: None)
        if wanted(f"{label} (graphed)"):
            graphed(state0)  # the captures, before measure reads the graphs
            measure(f"{label} (graphed)", lambda: graphed(state0),
                    lambda: None, graphed.graphs)
        del force, state0, eager, graphed
        torch.cuda.empty_cache()
    if os.path.exists(trace):
        os.remove(trace)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
