"""Force-strategy factory.

PyTorch counterpart of ``nbody_tpu/ops/forces.py``: a plain
``force_fn(pos, mass) -> acc`` picked by ``config.force_method``. On CUDA
tensors the force functions launch this package's kernels; on CPU tensors
they run the kernels' plain twins.
"""

from __future__ import annotations

from nbody_tpu_torch.errors import ValidationError
from nbody_tpu_torch.types import ForceMethod, SimulationConfig


def make_force_fn(config: SimulationConfig, *, pos_hint=None):
    """Build the force function for ``config.force_method``. ``pos_hint``
    (positions, read on the host once) lets the spatial hash's
    ``hash_engine="auto"`` pick window or tiles from the scene's density."""
    method = config.force_method
    G, eps = config.G, config.softening
    if method == ForceMethod.DIRECT_N2:
        from nbody_tpu_torch.ops.direct import direct_forces_kernel

        def force_fn(pos, mass):
            return direct_forces_kernel(pos, mass, G, eps)

        return force_fn
    if method == ForceMethod.BARNES_HUT:
        from nbody_tpu_torch.ops.barnes_hut import make_barnes_hut_forces

        return make_barnes_hut_forces(config)
    if method == ForceMethod.SPATIAL_HASH:
        from nbody_tpu_torch.ops.spatial_hash import make_spatial_hash_forces

        return make_spatial_hash_forces(config, pos_hint=pos_hint)
    raise ValidationError(f"Unknown force method: {method}")


def make_sorted_force_fn(config: SimulationConfig, *, pos_hint=None):
    """Sorted-pipeline force ``(pos, mass) -> (acc_sorted, psort, order)``,
    or None when the method has no sorted contract: direct N² (its row
    order never changes, so sorted stepping would only add gathers) and
    the Barnes-Hut window engine. Both spatial-hash engines have it."""
    if config.force_method == ForceMethod.BARNES_HUT:
        from nbody_tpu_torch.ops.barnes_hut import make_barnes_hut_forces_sorted

        return make_barnes_hut_forces_sorted(config)
    if config.force_method == ForceMethod.SPATIAL_HASH:
        from nbody_tpu_torch.ops.spatial_hash import (
            make_spatial_hash_forces_sorted,
        )

        return make_spatial_hash_forces_sorted(config, pos_hint=pos_hint)
    return None
