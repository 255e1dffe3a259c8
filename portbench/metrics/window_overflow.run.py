"""Rows a step that the spatial hash's window engine could not cover, over
every step of the run: the program's counter ``hash.window_overflow_rows``
(``nbody_tpu_torch.utils.profiling``: the rows past the window summed over
every force evaluation since the state was set, a(0) included) over the
steps the harness asked for, warm-up and probe included. Every row counted
is a row-window whose pairs the step dropped, so it reads 0 where the
program is right. None where the program publishes no such counter (one
without it, or one that runs no spatial hash). Moves ``steps_per_s``."""


def read(ctx):
    try:
        from nbody_tpu_torch.utils.profiling import read_counter
    except ImportError:
        return None
    rows = read_counter("hash.window_overflow_rows")
    steps = ctx.final["steps"] + len(ctx.traffic["probe"])
    if rows is None or steps <= 0:
        return None
    return float(rows) / steps
