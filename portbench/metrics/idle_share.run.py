"""Device idle share of the headless window, in %: 1 − (union of the
device operations' intervals) ÷ the traced window, from the same trace.
Moves ``steps_per_s``."""


def read(ctx):
    if ctx.traffic["driver"] != "run" or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
