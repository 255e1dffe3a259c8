"""Device ms a frame in R1's kernels (csrc/render.cu), from the trace.
Moves ``frames_per_s``."""

from portbench import core, roofline


def read(ctx):
    if ctx.traffic["driver"] != "frames" or ctx.trace.units == 0:
        return None
    hit = roofline.matcher(core.load_module("kernels", "r1").NAMES)
    ms = sum(o[3] for o in ctx.trace.kernels() if hit(o[0])) * 1e3
    return ms / ctx.trace.units if ms > 0 else None
