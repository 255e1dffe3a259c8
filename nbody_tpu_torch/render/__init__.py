"""Rendering: orbit camera, color mapping, the point-sprite renderer (kernel
R1 on the card), the asynchronous device→host copies, the live terminal
view and the diagnostics panel."""

from nbody_tpu_torch.render.camera import Camera
from nbody_tpu_torch.render.color import ColorMapper
from nbody_tpu_torch.render.renderer import PointRenderer
from nbody_tpu_torch.render.stream import PointStream
from nbody_tpu_torch.render.terminal import TerminalView
from nbody_tpu_torch.render.ui import UIPanel

__all__ = [
    "Camera",
    "ColorMapper",
    "PointRenderer",
    "PointStream",
    "TerminalView",
    "UIPanel",
]
