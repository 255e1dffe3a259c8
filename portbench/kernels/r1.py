"""R1 (csrc/render.cu: project, bin, scan, fill, splat kernels): one frame
of the point renderer, 6 kernels and a memset a frame. Bytes only: the
positions in (the velocities too in VELOCITY mode), the float32 image and
its uint8 copy out; the splat's additions are not counted."""

from portbench import roofline

NAMES = ("project_kernel", "block_sum_kernel", "scan_kernel", "fill_kernel",
         "splat_kernel", "splat_long_kernel")


def least_time(ctx):
    t = ctx.traffic
    n = ctx.final["pos"].shape[0]
    vel = 12 * n if t.get("color_mode") == "VELOCITY" else 0
    nbytes = 12 * n + vel + int(t["width"]) * int(t["height"]) * 3 * 5
    return len(NAMES), roofline.least_time(0, nbytes)
