"""Device kernels a step in the headless window (the captured graphs'
kernel nodes and whatever runs between replays), from the trace's kernel
records ÷ the steps traced. Moves ``steps_per_s``."""


def read(ctx):
    if ctx.traffic["driver"] != "run" or ctx.trace.units == 0:
        return None
    return len(ctx.trace.kernels()) / ctx.trace.units
