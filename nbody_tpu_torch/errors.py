"""Exception taxonomy and validation rules.

PyTorch counterpart of ``nbody_tpu/errors.py``: the same rules
(N ∈ (0, 100M], dt ∈ (0, 1], ε ≥ 0, θ ∈ [0, 2], block ∈ [1, 1024], G > 0,
all values finite) and a device-memory pre-check against 80% of the
card's free memory.
"""

from __future__ import annotations

import math

import torch

from nbody_tpu_torch.types import MAX_PARTICLE_COUNT, ForceMethod, SimulationConfig


class NBodyError(Exception):
    """Base class for all nbody_tpu_torch errors."""


class ValidationError(NBodyError, ValueError):
    """Invalid configuration or input value."""


class ResourceError(NBodyError, RuntimeError):
    """Insufficient device resources."""

    def __init__(self, message: str, required_bytes: int, available_bytes: int):
        super().__init__(
            f"{message} (required {required_bytes} bytes, "
            f"available {available_bytes} bytes)"
        )
        self.required_bytes = required_bytes
        self.available_bytes = available_bytes


class SerializationError(NBodyError, RuntimeError):
    """Corrupt, truncated, or unsupported checkpoint data."""


def _require_finite(value: float, name: str) -> None:
    if math.isnan(value) or math.isinf(value):
        raise ValidationError(f"{name} must be a finite number")


def validate_particle_count(count: int) -> None:
    if count <= 0:
        raise ValidationError("Particle count must be greater than 0")
    if count > MAX_PARTICLE_COUNT:
        raise ValidationError("Particle count exceeds maximum supported (100M)")


def validate_time_step(dt: float) -> None:
    _require_finite(dt, "Time step")
    if dt <= 0:
        raise ValidationError("Time step must be positive")
    if dt > 1.0:
        raise ValidationError("Time step is too large (max 1.0)")


def validate_softening(eps: float) -> None:
    _require_finite(eps, "Softening parameter")
    if eps < 0:
        raise ValidationError("Softening parameter must be non-negative")


def validate_theta(theta: float) -> None:
    _require_finite(theta, "Barnes-Hut theta")
    if theta < 0 or theta > 2.0:
        raise ValidationError("Barnes-Hut theta must be between 0 and 2")


def validate_gravitational_constant(G: float) -> None:
    if math.isnan(G) or math.isinf(G) or G <= 0:
        raise ValidationError("Gravitational constant must be positive and finite")


def validate_config(config: SimulationConfig) -> None:
    """Full config validation (the JAX package's rules, unchanged)."""
    validate_particle_count(config.particle_count)
    validate_time_step(config.dt)
    validate_softening(config.softening)
    validate_gravitational_constant(config.G)

    if config.force_method == ForceMethod.BARNES_HUT:
        validate_theta(config.barnes_hut_theta)

    if config.force_method == ForceMethod.SPATIAL_HASH:
        for value, name in (
            (config.spatial_hash_cell_size, "Spatial hash cell size"),
            (config.spatial_hash_cutoff, "Spatial hash cutoff"),
        ):
            if math.isnan(value) or math.isinf(value) or value <= 0:
                raise ValidationError(f"{name} must be positive and finite")

    if config.block_size <= 0 or config.block_size > 1024:
        raise ValidationError("Block size must be between 1 and 1024")

    if config.hash_max_per_cell <= 0:
        raise ValidationError("hash_max_per_cell must be positive")
    if config.hash_max_grid_dim <= 0:
        raise ValidationError("hash_max_grid_dim must be positive")
    if config.hash_engine not in ("auto", "window", "tiles"):
        raise ValidationError(
            "hash_engine must be one of auto | window | tiles"
        )
    if not (1 <= config.hash_tile_k <= 64):
        raise ValidationError("hash_tile_k must be in [1, 64]")
    if not (0 < config.bh_max_level <= 10):
        raise ValidationError("bh_max_level must be in [1, 10]")
    if config.shard_devices <= 0:
        raise ValidationError("shard_devices must be positive")
    if config.resort_every <= 0:
        raise ValidationError("resort_every must be positive")
    if not 0.0 <= config.resort_stale_frac <= 1.0:
        raise ValidationError("resort_stale_frac must be in [0, 1]")


# Bytes per particle in device state: pos/vel/acc (3×3 f32) + mass (1 f32).
STATE_BYTES_PER_PARTICLE = 10 * 4


def validate_resource_requirements(
    particle_count: int, device: torch.device | str | None = None
) -> None:
    """Device-memory pre-check: state bytes × 2 (acceleration-structure
    overhead) against 80% of the card's free memory, read with
    ``torch.cuda.mem_get_info``, on ``device`` (default: the CUDA card,
    as ``ParticleSystem`` resolves it). A CPU device has no such limit
    here."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False"
        )
    required = particle_count * STATE_BYTES_PER_PARTICLE * 2
    free, _total = torch.cuda.mem_get_info(device)
    available = int(free * 0.8)
    if required > available:
        raise ResourceError("Insufficient device memory", required, available)
