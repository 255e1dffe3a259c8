"""Device ms a step in the sort of ``build_sorted_grid`` (torch's stable
argsort of the cell ids: CUB's radix sort kernels, or torch's own sort
kernels at small sizes), from the trace. The payload gather and the cell
starts are counted as glue (``glue_ms.run``). Moves ``steps_per_s``."""

import re

SORT = re.compile(r"RadixSort|radix_sort|sortKeyValueInplace|bitonicSort"
                  r"|segmented_sort|sort_postprocess|SortCommon|mergesort",
                  re.IGNORECASE)


def is_sort(name: str) -> bool:
    return SORT.search(name) is not None


def read(ctx):
    if ctx.traffic["driver"] != "run" or ctx.trace.units == 0:
        return None
    ms = sum(o[3] for o in ctx.trace.kernels() if is_sort(o[0])) * 1e3
    return ms / ctx.trace.units
