"""The harness's plumbing on the CPU: the manifest resolves, nothing loads
JAX or the JAX package, the kernel counts and the trace readers give what
a small case counts by hand, and a run prints the contract's keys."""

import ast
import json
import math
import time
from pathlib import Path

import pytest
import torch

from portbench import core, roofline, trace
from portbench.reference import bh

BENCH = Path(core.BENCH)
SMALL = {"bh1m-sphere": {"particle_count": 4096, "bh_max_level": 3}}


def cells():
    return [c["name"] for c in core.manifest()["workloads"]]


@pytest.mark.parametrize("workload", cells())
def test_cell_resolves_its_files(workload):
    man = core.manifest()
    cell = core.cell_of(man, workload)
    config = core.load_json("configs", cell["config"])
    traffic = core.load_json("traffic", cell["traffic"])
    assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
    assert config["name"] == cell["config"]
    assert (BENCH / "scenes" / f"{config['scene']['kind']}.py").is_file()
    assert (BENCH / "reference" / f"{config['reference']}.py").is_file()
    limits = core.load_json("limits", workload)
    assert {"start_gap", "steps_gap", "acc_gap", "pos_gap",
            "vel_gap"} <= set(limits)
    assert traffic["probe"][0] == "fresh" and len(traffic["probe"]) <= 2
    assert traffic["last_step"] in ("fresh", "frozen")
    for key in ("end_to_end", "per_layer"):
        for m in core.metrics_of(man, key, workload):
            if key == "per_layer":
                assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    cfg_entry = [c for c in man["configs"] if c["name"] == cell["config"]][0]
    assert (core.ROOT / cfg_entry["file"]).is_file()


def test_manifest_metrics_report_what_they_move():
    man = core.manifest()
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for m in man["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"]
        if m["name"].endswith("_roofline"):
            kernel = m["name"][:-len("_roofline")]
            assert (BENCH / "kernels" / f"{kernel}.py").is_file()


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in core.FORBIDDEN, (path, name)
            if "reference" in path.parts:
                assert top != "nbody_tpu_torch", (path, name)


def test_forbidden_modules_compare_whole_names():
    import sys

    assert "nbody_tpu_torch" not in core.forbidden_modules()
    sys.modules["nbody_tpu.fake"] = object()
    try:
        assert core.forbidden_modules() == ["nbody_tpu"]
    finally:
        del sys.modules["nbody_tpu.fake"]


class _Ctx:
    def __init__(self, pos, sim, traffic=None, tr=None):
        self.final = {"pos": pos}
        self.sim = sim
        self.traffic = traffic or {"driver": "run"}
        self.trace = tr


def _bh_points():
    # a 4-cell grid (levels 2) of edge 1.00001 from (0,0,0) to (4,4,4):
    # cell (0,0,0) holds 4 rows, (1,1,1) one, (3,3,3) two
    return torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.1, 0.1], [0.2, 0.2, 0.2],
                         [0.3, 0.3, 0.3], [1.5, 1.5, 1.5], [3.9, 3.9, 3.9],
                         [4.0, 4.0, 4.0]])


def test_k4_counts_live_slot_pairs_by_hand():
    sim = {"particle_count": 7, "bh_max_level": 2, "barnes_hut_theta": 0.5}
    assert bh.engine_params(sim)["near_k"] == 8
    sets, least = core.load_module("kernels", "k4").least_time(
        _Ctx(_bh_points(), sim))
    # pairs: 4·(4 + 1) + 1·(4 + 1) + 2·2 = 29; far seeds 80 a live slot
    ops = 20 * 29 + 80 * 7
    nbytes = 4 * (4 * 4 * 8 * 16 + 4 * 19 * 16 + 64 + 4 * 3 * 8 * 16)
    assert sets == 1
    assert least == pytest.approx(max(ops / 67e12, nbytes / 3.35e12))


def test_k7_counts_pairs_of_the_cell_ball_by_hand():
    pos = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [1.5, 0.0, 0.0],
                        [3.5, 0.0, 0.0]])
    sim = {"spatial_hash_cell_size": 1.0, "hash_max_grid_dim": 64}
    _, least = core.load_module("kernels", "k7").least_time(_Ctx(pos, sim))
    # cells x = 0 (2 rows), 1 (1), 3 (1): 2·3 + 1·3 + 1·1 = 10 pairs
    nbytes = 16 * 4 + 12 * 4 + 4 * (64 ** 3 + 1) + 12 * 4 + 8
    assert least == pytest.approx(max(20 * 10 / 67e12, nbytes / 3.35e12))


def test_k2_and_k3_counts():
    sim = {"particle_count": 7, "bh_max_level": 1, "barnes_hut_theta": 0.5}
    ctx = _Ctx(_bh_points(), sim)
    sets, least = core.load_module("kernels", "k2").least_time(ctx)
    k, nc = bh.engine_params(sim)["near_k"], 8
    assert least == pytest.approx(
        max(20 * 7 / 67e12, (16 * 7 + 4 * (nc + 1) + 16 * k * nc + 44 * nc)
            / 3.35e12))
    sets, least = core.load_module("kernels", "k3").least_time(ctx)
    # one level, p = 1: one (cell, tap) pair in the grid, 152 × 80 MACs
    nbytes = 4 * (80 + 27 * 152 * 80 + 152)
    assert sets == 1
    assert least == pytest.approx(max(2 * 152 * 80 / (495e12 / 3),
                                      nbytes / 3.35e12))


def _canned_events():
    def x(name, cat, t0, t1):
        return {"ph": "X", "cat": cat, "name": name, "ts": t0, "dur": t1 - t0}

    return [
        x("portbench.run_steps", "user_annotation", -300, -250),
        x("void at::native::vectorized_elementwise_kernel<4>()", "kernel",
          -200, -100),
        x("portbench.window", "user_annotation", 0, 1000),
        x("portbench.run_steps", "user_annotation", 0, 100),
        x("portbench.run_steps", "user_annotation", 500, 600),
        x("void (anonymous namespace)::tile_near_kernel<false, true>(float "
          "const*)", "kernel", 100, 300),
        x("void cub::DeviceRadixSortOnesweepKernel<int>(int*)", "kernel",
          300, 350),
        x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 350, 400),
        x("void at::native::vectorized_elementwise_kernel<4>()", "kernel",
          600, 900),
    ]


def test_trace_reduction_and_the_readers_on_a_canned_trace():
    # the lead (one step) before the window, two in it: per-step readings
    # take every operation, the idle share the window's alone
    tr = trace.reduce(_canned_events(), units=4)
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(600e-6)
    gaps = {}
    for name, _, dur in tr.gaps:
        gaps[name] = gaps.get(name, 0.0) + dur
    assert gaps == pytest.approx({"run_steps": 100e-6, "loop": 300e-6})
    ctx = _Ctx(_bh_points(), {"particle_count": 7, "bh_max_level": 2,
                              "barnes_hut_theta": 0.5}, tr=tr)

    def read(name):
        return core.load_module("metrics", name).read(ctx)

    assert read("idle_share.run") == pytest.approx(40.0)
    assert read("idle_share.frames") is None
    assert read("kernels_per_step.run") == pytest.approx(1.0)
    assert read("sort_ms.run") == pytest.approx(0.0125)
    assert read("glue_ms.run") == pytest.approx(0.1125)
    assert read("k7_roofline") is None
    _, least = core.load_module("kernels", "k4").least_time(ctx)
    assert read("k4_roofline") == pytest.approx(100 * least / 200e-6)
    bd = tr.breakdown()
    assert bd["device_ops"][0][1] == pytest.approx(400e-6)
    assert len(bd["device_ops"]) == 4 and len(bd["idle_gaps"]) == 2


def test_port_kernels_are_read_from_the_program_sources():
    names = roofline.port_kernels(core.ROOT)
    assert {"tile_scatter_kernel", "far_taps_mma_kernel", "tile_near_kernel",
            "window_sweep_kernel", "splat_kernel"} <= set(names)
    for kernel in ("k2", "k3", "k4", "k7", "r1"):
        assert set(core.load_module("kernels", kernel).NAMES) <= set(names)


def test_roofline_matcher_takes_the_port_kernels_only():
    hit = roofline.matcher(("fill_kernel", "tile_near_kernel"))
    assert hit("void (anonymous namespace)::tile_near_kernel<true>(int)")
    assert hit("(anonymous namespace)::fill_kernel(int, int)")
    assert not hit("void at::native::fill_kernel_cuda(float)")
    assert not hit("void at::native::(anonymous namespace)::fill_kernel()")


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", cells())
def test_a_cpu_run_prints_the_contract_keys(workload, traced):
    cfg = core.cell_of(core.manifest(), workload)["config"]
    out, notes = core.run(workload, 2 ** 31 + 11, 0.01, traced,
                          time.perf_counter(), device="cpu",
                          sim_override=SMALL[cfg])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    want = "per_layer" if traced else "end_to_end"
    names = {m["name"] for m in core.metrics_of(core.manifest(), want,
                                                workload)}
    assert set(out["metrics"]) <= names
    if not traced:
        assert set(out["metrics"]) == names
    json.dumps(out)
