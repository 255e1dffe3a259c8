"""``hash1m-sphere.run`` on the CPU at a small size (``conftest.SMALL``):
the cell reads correct through the program's normal path, where the
window engine's window covers every row, and reads not correct where a
forced small ``hash_window`` drops pairs. The window engine's overflow
counter and ``window_overflow.run`` read what the run dropped."""

import time

from portbench import core

CELL = "hash1m-sphere.run"
SEED = 2 ** 31 + 13


def test_the_hash_cell_is_correct_and_drops_nothing(hash_small):
    from nbody_tpu_torch.utils.profiling import read_counter

    out, _ = core.run(CELL, SEED, 0.01, False, time.perf_counter(),
                      device="cpu", sim_override=hash_small)
    assert out["correct"] is True, out["checks"]
    assert read_counter("hash.window_overflow_rows") == 0


def test_dropped_pairs_read_not_correct_and_are_counted(hash_small):
    """A forced small ``hash_window`` runs as given and drops the pairs
    past it: the accelerations fail their limit, and the per-layer reader
    gives the counter's rows over every step asked, the probe's included;
    None where the program publishes no counter."""
    from nbody_tpu_torch.utils import profiling

    seen = {}

    def on_final(ctx, given, targets, s1):
        seen["ctx"] = ctx

    out, _ = core.run(CELL, SEED, 0.01, False, time.perf_counter(),
                      device="cpu", sim_override={**hash_small,
                                                  "hash_window": 32},
                      on_final=on_final)
    assert out["correct"] is False
    acc = out["checks"]["acc_gap"]
    assert acc["value"] > acc["limit"]
    reader = core.load_module("metrics", "window_overflow.run")
    ctx = seen["ctx"]
    rows = profiling.read_counter("hash.window_overflow_rows")
    steps = ctx.final["steps"] + len(ctx.traffic["probe"])
    assert rows > 0 and reader.read(ctx) == rows / steps
    saved = dict(profiling._COUNTERS)
    try:
        profiling._COUNTERS.clear()
        assert reader.read(ctx) is None
    finally:
        profiling._COUNTERS.update(saved)
