"""K7 (``window_sweep_kernel``, csrc/window_sweep.cu): the spatial hash's
window engine, one launch a step. Operations: 20 for every pair the
predicate has to test, each row against every row of its 3×3×3 cell ball
on the hash grid (the configuration's cell edge from the bounding-box
corner); bytes: sorted rows, cell ids and cell starts (the cap³ + 1 of the
static stride) in, accelerations and the overflow count out."""

import torch
import torch.nn.functional as F

from portbench import roofline
from portbench.reference.hash import geometry

NAMES = ("window_sweep_kernel",)


def least_time(ctx):
    sim = ctx.sim
    cap = int(sim.get("hash_max_grid_dim", 64))
    pos = ctx.final["pos"]
    n = pos.shape[0]
    dims, coords = geometry(pos, float(sim.get("spatial_hash_cell_size",
                                               1.0)), cap)
    nx, ny, nz = (int(v) for v in dims)
    cid = (coords[:, 0] * ny + coords[:, 1]) * nz + coords[:, 2]
    cnt = torch.bincount(cid, minlength=nx * ny * nz).double().reshape(
        1, 1, nx, ny, nz)
    ball = F.avg_pool3d(F.pad(cnt, [1] * 6), 3, stride=1) * 27
    pairs = float((cnt * ball).sum())
    nbytes = 16 * n + 12 * n + 4 * (cap ** 3 + 1) + 12 * n + 8
    return 1, roofline.least_time(roofline.PAIR_OPS * pairs, nbytes)
