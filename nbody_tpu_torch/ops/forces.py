"""Force-strategy factory.

PyTorch counterpart of ``nbody_tpu/ops/forces.py``: a plain
``force_fn(pos, mass) -> acc`` picked by ``config.force_method``, the
sorted-pipeline force, and the table-resident stepping parameters. On CUDA
tensors the force functions launch this package's kernels; on CPU tensors
they run the kernels' plain twins.
"""

from __future__ import annotations

import torch

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


def make_table_step_params(config: SimulationConfig, *, device,
                           pos_hint=None):
    """``TableParams`` for ``config``'s engine when table-resident stepping
    (``ops/table_step.py``) applies, else None: on a CUDA ``device``, for
    the fused tiles engines (Barnes-Hut tiles of multipole order 2, hash
    tiles) where ``tile_engine_fused`` holds and N < 2²⁴, as the JAX
    package applies it on its accelerator. Elsewhere None, as the JAX
    package returns None off the TPU, so the caller keeps row-space
    stepping. ``pos_hint`` resolves the hash engine as in
    ``make_sorted_force_fn``."""
    if torch.device(device).type != "cuda":
        return None
    if config.particle_count >= (1 << 24):
        return None
    from nbody_tpu_torch.ops.tile_sweep import tile_engine_fused

    if config.force_method == ForceMethod.BARNES_HUT:
        from nbody_tpu_torch.ops.barnes_hut import bh_engine_params
        from nbody_tpu_torch.ops.table_step import bh_table_params

        p = bh_engine_params(config)
        if p["near_engine"] != "tiles" or p["multipole_order"] < 2:
            return None
        tp = bh_table_params(
            G=config.G, softening=config.softening,
            theta=config.barnes_hut_theta, levels=p["levels"],
            near_k=p["near_k"],
        )
    elif config.force_method == ForceMethod.SPATIAL_HASH:
        from nbody_tpu_torch.ops.spatial_hash import hash_engine_params
        from nbody_tpu_torch.ops.table_step import hash_table_params

        hp = hash_engine_params(config, pos_hint)
        if hp["engine"] != "tiles":
            return None
        tp = hash_table_params(
            G=config.G, softening=config.softening,
            cutoff=config.spatial_hash_cutoff,
            cell_size=config.spatial_hash_cell_size,
            d=hp["tile_d"], k=hp["tile_k"],
        )
    else:
        return None
    if not tile_engine_fused(tp.d, tp.k):
        return None
    return tp


def list_algorithms():
    """(cli name, description) of each force method, for
    ``--list-algorithms``."""
    return [
        (ForceMethod.DIRECT_N2.cli_name,
         "Exact O(N²) all-pairs (CUDA kernel)"),
        (ForceMethod.BARNES_HUT.cli_name,
         "O(N log N) hierarchical multipole approximation"),
        (ForceMethod.SPATIAL_HASH.cli_name,
         "O(N) short-range with cutoff (sorted grid)"),
    ]
