"""K2 (``tile_scatter_kernel``, csrc/scatter.cu): slot placement, finest
order-2 moments and counts of the Barnes-Hut tiles engine, one launch a
step. Bytes: the sorted rows and cell starts in, the slot tiles and the
moments out; ~20 FP32 operations a row."""

from portbench import roofline
from portbench.reference.bh import engine_params

NAMES = ("tile_scatter_kernel",)


def least_time(ctx):
    p = engine_params(ctx.sim)
    n, d, k = ctx.final["pos"].shape[0], p["d"], p["near_k"]
    nc = d ** 3
    nbytes = 16 * n + 4 * (nc + 1) + 16 * k * nc + 44 * nc
    return 1, roofline.least_time(20 * n, nbytes)
