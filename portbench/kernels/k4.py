"""K4 (``tile_near_kernel``, csrc/tile_near.cu): the near sweep of the
Barnes-Hut tiles engine seeded with the far expansion, one launch a step.
Operations: 20 a live slot pair of each cell's (2ws+1)³ ball (a cell's
live slots are its rows up to the cap k), plus ~80 to evaluate the far
expansion at each live slot; bytes: the tiles, the far plane and the
counts in, the slot accelerations out."""

import torch
import torch.nn.functional as F

from portbench import roofline
from portbench.reference.bh import engine_params, geometry

NAMES = ("tile_near_kernel",)


def least_time(ctx):
    p = engine_params(ctx.sim)
    d, k, ws = p["d"], p["near_k"], p["ws"]
    _, _, coords = geometry(ctx.final["pos"], p["levels"])
    cid = (coords[:, 0] * d + coords[:, 1]) * d + coords[:, 2]
    counts = torch.bincount(cid, minlength=d ** 3)
    w1 = 2 * ws + 1
    slots = torch.clamp(counts, max=k).reshape(1, 1, d, d, d).double()
    ball = F.avg_pool3d(F.pad(slots, [ws] * 6), w1, stride=1) * w1 ** 3
    pairs = float((slots * ball).sum())
    ops = roofline.PAIR_OPS * pairs + 80 * float(slots.sum())
    nbytes = 4 * (d * 4 * k * d * d + d * 19 * d * d + d ** 3
                  + d * 3 * k * d * d)
    return 1, roofline.least_time(ops, nbytes)
