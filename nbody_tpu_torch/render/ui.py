"""Diagnostics panel state machine.

PyTorch-package counterpart of ``nbody_tpu/render/ui.py``: pure flag and
state logic. The interactive loop's key controls set its flags and the
loop consumes them, once a step, before stepping.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from nbody_tpu_torch.types import ForceMethod


@dataclasses.dataclass
class UIStats:
    fps: float = 0.0
    frame_time_ms: float = 0.0
    particle_count: int = 0
    method: str = ""
    sim_time: float = 0.0
    kinetic_energy: Optional[float] = None
    potential_energy: Optional[float] = None


class UIPanel:
    """Flag-polling diagnostics panel."""

    def __init__(self):
        self.visible = True
        self.stats = UIStats()
        self._pause_clicked = False
        self._reset_clicked = False
        self._method_changed = False
        self._selected_method: Optional[ForceMethod] = None

    # ---- inputs from the app --------------------------------------------

    def set_stats(self, **kw) -> None:
        for k, v in kw.items():
            if hasattr(self.stats, k):
                setattr(self.stats, k, v)
        if self.stats.fps > 0:
            self.stats.frame_time_ms = 1000.0 / self.stats.fps

    def toggle_visibility(self) -> None:
        """Show or hide the panel."""
        self.visible = not self.visible

    # ---- simulated user interactions ------------------------------------

    def click_pause(self) -> None:
        self._pause_clicked = True

    def click_reset(self) -> None:
        self._reset_clicked = True

    def select_method(self, method: ForceMethod) -> None:
        """Method selection with a changed-flag handshake."""
        self._selected_method = method
        self._method_changed = True

    # ---- flag polling (handshake back to the app) ------------------------

    def consume_pause_clicked(self) -> bool:
        v = self._pause_clicked
        self._pause_clicked = False
        return v

    def consume_reset_clicked(self) -> bool:
        v = self._reset_clicked
        self._reset_clicked = False
        return v

    def consume_method_change(self) -> Optional[ForceMethod]:
        if not self._method_changed:
            return None
        self._method_changed = False
        return self._selected_method

    # ---- text rendering (terminal diagnostics overlay) -------------------

    def render_text(self) -> str:
        if not self.visible:
            return ""
        s = self.stats
        lines = [
            f"FPS: {s.fps:.1f} ({s.frame_time_ms:.2f} ms)",
            f"Particles: {s.particle_count}",
            f"Method: {s.method}",
            f"Sim time: {s.sim_time:.4f}",
        ]
        if s.kinetic_energy is not None:
            lines.append(f"KE: {s.kinetic_energy:.4e}")
        if s.potential_energy is not None:
            lines.append(f"PE: {s.potential_energy:.4e}")
        return "\n".join(lines)
