"""Rooflines of the port's kernels from the traced window.

A kernel's share of its roofline is its least time (the larger of its
operations over the peak rate and its bytes over the memory rate) over its
device time in the trace, as a percentage. The least time comes from
``kernels/<kernel>.py``, which counts the work from the run's final
positions and the configuration's own grid rule in plain torch: the same
work whatever implements the kernel. The peaks are NVIDIA's published
H100 SXM figures (dense), at the full 700 W power limit.
"""

from __future__ import annotations

import re

FP32_OPS = 67e12          # FP32 outside the tensor cores, op/s
TF32_OPS = 495e12         # TF32 on the tensor cores, op/s
HBM_BYTES = 3.35e12       # HBM3, byte/s
PAIR_OPS = 20             # FP32 operations of one softened pair


def least_time(ops: float, nbytes: float, rate: float = FP32_OPS) -> float:
    return max(ops / rate, nbytes / HBM_BYTES)


def matcher(names):
    """A predicate on trace kernel names: one of the port's kernel functions
    ``names`` (global or in an anonymous namespace, templated or not)."""
    rx = re.compile(r"^(void )?(\(anonymous namespace\)::)?(" +
                    "|".join(map(re.escape, names)) + r")\b")
    return lambda name: rx.search(name) is not None


_CUDA = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\("
                   r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)")


def port_kernels(root) -> tuple:
    """The names of the program's own kernels, read from its sources: each
    ``__global__`` function of ``nbody_tpu_torch/csrc/*.cu`` and each
    ``@triton.jit`` function of the package, so that a kernel a later
    change adds is found without a list to keep."""
    pkg = root / "nbody_tpu_torch"
    names = set()
    for path in sorted(pkg.glob("csrc/*.cu")):
        names.update(_CUDA.findall(path.read_text()))
    for path in sorted(pkg.rglob("*.py")):
        text = path.read_text()
        if "triton" in text:
            names.update(_TRITON.findall(text))
    return tuple(sorted(names))


def share(ctx, kernel: str):
    """``kernel``'s roofline share in % over the traced window, or None
    where the trace ran none of it."""
    from portbench import core

    mod = core.load_module("kernels", kernel)
    hit = matcher(mod.NAMES)
    times = [o[3] for o in ctx.trace.kernels() if hit(o[0])]
    if not times or ctx.trace.units == 0:
        return None
    launches_per_set, least = mod.least_time(ctx)
    sets = len(times) / launches_per_set
    return 100.0 * least * sets / sum(times)
