"""K3 (``far_taps_mma_kernel``, csrc/far_taps.cu): the multipole-to-local
tap sum of each pyramid level, one launch a level, levels 1..L a step.
Operations: the (cell, tap) multiply-adds whose source cell lies in the
grid, 152 × 80 a pair, counted once at the 3xTF32 rate (the fastest
float32-exact rate of the card: TF32 peak / 3); bytes: the moments and the
tap matrices in, the expansions out."""

from portbench import roofline
from portbench.reference.bh import engine_params

NAMES = ("far_taps_mma_kernel",)


def least_time(ctx):
    p = engine_params(ctx.sim)
    ws, w1 = p["ws"], 2 * p["ws"] + 1
    total = 0.0
    for lvl in range(1, p["levels"] + 1):
        pp = (1 << lvl) // 2
        macs = 152 * 80 * (w1 * pp - ws * (ws + 1)) ** 3
        nbytes = 4 * (80 * pp ** 3 + w1 ** 3 * 152 * 80 + 152 * pp ** 3)
        total += roofline.least_time(2 * macs, nbytes,
                                     roofline.TF32_OPS / 3)
    return p["levels"], total
