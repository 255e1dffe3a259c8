"""K4's share of its roofline in %, over the traced window: the least
time of kernels/k4.py ÷ its device time in the trace. Moves
``steps_per_s``."""

from portbench import roofline


def read(ctx):
    return roofline.share(ctx, "k4")
