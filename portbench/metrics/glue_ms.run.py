"""Device ms a step in the stepping's and the engines' torch operations:
every device operation of the trace (kernels, memcpys, memsets) that is
neither one of the port's own kernels (``roofline.port_kernels``: read
from the program's sources) nor the sort's (``sort_ms.run``): elementwise
ops, gathers, copies. Moves ``steps_per_s``."""

from portbench import core, roofline


def read(ctx):
    if ctx.traffic["driver"] != "run" or ctx.trace.units == 0:
        return None
    port = roofline.matcher(roofline.port_kernels(core.ROOT))
    is_sort = core.load_module("metrics", "sort_ms.run").is_sort
    ms = sum(o[3] for o in ctx.trace.ops
             if not port(o[0]) and not is_sort(o[0])) * 1e3
    return ms / ctx.trace.units
