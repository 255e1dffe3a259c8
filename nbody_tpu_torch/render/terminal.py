"""Live terminal view: the point cloud as an ANSI density map, redrawn in
place.

PyTorch-package counterpart of ``nbody_tpu/render/terminal.py``. The points
are projected through the same ``Camera`` as the PNG renderer and binned
to a (2·height, width) count grid where they lie (on the card for a CUDA
tensor); only that grid crosses to the host, where ``frame`` builds the
same escape-coded string as the JAX view: a 256-color heat map, half-block
glyphs for 2 vertical cells per character row, and a stats line.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from nbody_tpu_torch.render.camera import Camera

# 256-color "inferno-like" ramp for density (dark → bright).
_RAMP = (16, 53, 90, 126, 162, 198, 204, 210, 216, 222, 228, 231)
_HOME = "\x1b[H"
_CLEAR = "\x1b[2J"
_HIDE = "\x1b[?25l"
_SHOW = "\x1b[?25h"
_RESET = "\x1b[0m"


class TerminalView:
    """ANSI live view: density raster + stats, redrawn in place."""

    def __init__(self, camera: Camera | None = None, width: int = 100,
                 height: int = 36, out=None):
        self.camera = camera or Camera(distance=45.0, azimuth=0.7,
                                       elevation=0.75)
        self.width = int(width)
        self.height = int(height)  # character rows (2 cells each)
        self.out = out if out is not None else sys.stdout
        self._first = True

    # -- rasterization ----------------------------------------------------

    def raster(self, positions) -> torch.Tensor:
        """(N, 3) world points (cast to float32) → (2·height, width) int32
        counts on the points' device."""
        pts = torch.as_tensor(positions).to(torch.float32).reshape(-1, 3)
        h2, w = 2 * self.height, self.width
        if pts.shape[0] == 0:
            return torch.zeros((h2, w), dtype=torch.int32, device=pts.device)
        ndc, _z, in_front = self.camera.project(pts)
        ndc = ndc[in_front]
        ndc = ndc[(ndc[:, 0].abs() <= 1.0) & (ndc[:, 1].abs() <= 1.0)]
        xs = ((ndc[:, 0] + 1.0) * 0.5 * (w - 1)).to(torch.int32)
        ys = ((1.0 - ndc[:, 1]) * 0.5 * (h2 - 1)).to(torch.int32)
        cells = ys.clamp(0, h2 - 1).long() * w + xs.clamp(0, w - 1).long()
        counts = torch.bincount(cells, minlength=h2 * w)
        return counts.to(torch.int32).reshape(h2, w)

    def frame(self, grid, stats: str = "") -> str:
        """One frame as a string (ANSI colors + trailing stats line) from a
        count grid (a host array or tensor)."""
        grid = np.asarray(grid.cpu() if isinstance(grid, torch.Tensor)
                          else grid)
        peak = max(int(grid.max()), 1)
        # log scale: terminal dynamic range is tiny vs a 1M-point core
        lv = (np.log1p(grid) / np.log1p(peak) * (len(_RAMP) - 1)).astype(
            np.int32
        )
        top, bot = lv[0::2], lv[1::2]
        occ_t, occ_b = grid[0::2] > 0, grid[1::2] > 0
        lines = []
        for r in range(self.height):
            row = []
            prev = None
            for c in range(self.width):
                t_on, b_on = bool(occ_t[r, c]), bool(occ_b[r, c])
                if not (t_on or b_on):
                    code = ("bg",)
                    ch = " "
                elif t_on and b_on:
                    code = (_RAMP[top[r, c]], _RAMP[bot[r, c]])
                    ch = "▀"  # upper half block: fg=top, bg=bottom
                elif t_on:
                    code = (_RAMP[top[r, c]], None)
                    ch = "▀"
                else:
                    code = (_RAMP[bot[r, c]], None)
                    ch = "▄"  # lower half block
                if code != prev:
                    if code == ("bg",):
                        row.append(_RESET)
                    elif code[1] is None:
                        row.append(f"\x1b[0m\x1b[38;5;{code[0]}m")
                    else:
                        row.append(
                            f"\x1b[38;5;{code[0]}m\x1b[48;5;{code[1]}m"
                        )
                    prev = code
                row.append(ch)
            row.append(_RESET)
            lines.append("".join(row))
        lines.append(stats[: self.width].ljust(self.width))
        return "\n".join(lines)

    def compose(self, positions, stats: str = "") -> str:
        """One frame of ``positions`` as a string."""
        return self.frame(self.raster(positions), stats)

    # -- live redraw -------------------------------------------------------

    def show(self, frame: str) -> None:
        """Write one composed frame in place (the first clears the
        screen and hides the cursor)."""
        prefix = (_CLEAR + _HIDE) if self._first else ""
        self._first = False
        self.out.write(prefix + _HOME + frame + "\n")
        self.out.flush()

    def draw(self, positions, stats: str = "") -> None:
        self.show(self.compose(positions, stats))

    def close(self) -> None:
        if not self._first:
            self.out.write(_SHOW + _RESET + "\n")
            self.out.flush()
