"""Core enums and configuration types.

PyTorch counterpart of ``nbody_tpu/types.py``. Enum integer values match
the JAX package (and the reference's ``.nbody`` checkpoint header), so a
configuration or snapshot means the same thing in both packages.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class ForceMethod(enum.IntEnum):
    """Force-calculation algorithm."""

    DIRECT_N2 = 0     # exact O(N²) all-pairs
    BARNES_HUT = 1    # O(N log N) hierarchical multipole approximation
    SPATIAL_HASH = 2  # O(N) short-range with cutoff

    @classmethod
    def parse(cls, name: str) -> "ForceMethod":
        """Parse a CLI-style method name (the JAX package's aliases)."""
        key = name.strip().lower().replace("_", "-")
        table = {
            "direct-n2": cls.DIRECT_N2,
            "direct": cls.DIRECT_N2,
            "n2": cls.DIRECT_N2,
            "barnes-hut": cls.BARNES_HUT,
            "bh": cls.BARNES_HUT,
            "spatial-hash": cls.SPATIAL_HASH,
            "hash": cls.SPATIAL_HASH,
        }
        if key not in table:
            from nbody_tpu_torch.errors import ValidationError

            raise ValidationError(
                f"Unknown force method: {name!r} "
                "(expected direct-n2 | barnes-hut | spatial-hash)"
            )
        return table[key]

    @property
    def cli_name(self) -> str:
        return {
            ForceMethod.DIRECT_N2: "direct-n2",
            ForceMethod.BARNES_HUT: "barnes-hut",
            ForceMethod.SPATIAL_HASH: "spatial-hash",
        }[self]


class InitDistribution(enum.IntEnum):
    """Initial particle distribution (values shared with the JAX package)."""

    UNIFORM = 0
    SPHERICAL = 1
    DISK = 2
    PLUMMER = 3

    @classmethod
    def parse(cls, name: str) -> "InitDistribution":
        key = name.strip().lower().replace("_", "-")
        table = {
            "uniform": cls.UNIFORM,
            "spherical": cls.SPHERICAL,
            "sphere": cls.SPHERICAL,
            "disk": cls.DISK,
            "plummer": cls.PLUMMER,
        }
        if key not in table:
            from nbody_tpu_torch.errors import ValidationError

            raise ValidationError(f"Unknown init distribution: {name!r}")
        return table[key]


class ColorMode(enum.IntEnum):
    """Particle coloring mode."""

    DEPTH = 0
    VELOCITY = 1
    DENSITY = 2


# Hard validation cap shared with the serializer.
MAX_PARTICLE_COUNT = 100_000_000


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    """Simulation configuration, field for field the JAX package's
    ``SimulationConfig`` with the same defaults. Knobs whose code paths
    are not in this package yet are validated by ``errors.validate_config``
    and rejected with ``NotImplementedError`` where they would select such
    a path (``ops.forces``, ``system``)."""

    particle_count: int = 10_000
    init_distribution: InitDistribution = InitDistribution.SPHERICAL
    force_method: ForceMethod = ForceMethod.DIRECT_N2
    dt: float = 1e-3
    G: float = 1.0
    softening: float = 0.1
    barnes_hut_theta: float = 0.5
    spatial_hash_cell_size: float = 1.0
    spatial_hash_cutoff: float = 2.0
    block_size: int = 256
    seed: int = 42
    hash_max_per_cell: int = 64
    hash_max_grid_dim: int = 64
    hash_window: int = 0
    hash_engine: str = "auto"
    hash_tile_k: int = 8
    # Barnes-Hut multipole grid: finest level (2^level cells per axis).
    bh_max_level: int = 6
    shard_devices: int = 1
    resort_every: int = 1
    resort_stale_frac: float = 0.0
    resort_repair: bool = False
    # One of the *DistParams dataclasses matching init_distribution, or
    # None for that distribution's defaults.
    dist_params: "object" = None

    def replace(self, **kw) -> "SimulationConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Rendering configuration: the frame size, the point size and the
    color mode of ``render.PointRenderer``."""

    window_width: int = 1280
    window_height: int = 720
    point_size: float = 2.0
    color_mode: ColorMode = ColorMode.DEPTH
    show_stats: bool = True


Vec3Like = Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class UniformDistParams:
    """Uniform box distribution."""

    min_bounds: Vec3Like = (-10.0, -10.0, -10.0)
    max_bounds: Vec3Like = (10.0, 10.0, 10.0)
    min_mass: float = 1.0
    max_mass: float = 1.0


@dataclasses.dataclass(frozen=True)
class SphericalDistParams:
    """Uniform-in-volume sphere."""

    center: Vec3Like = (0.0, 0.0, 0.0)
    radius: float = 10.0
    min_mass: float = 1.0
    max_mass: float = 1.0


@dataclasses.dataclass(frozen=True)
class DiskDistParams:
    """Rotating disk."""

    center: Vec3Like = (0.0, 0.0, 0.0)
    radius: float = 10.0
    thickness: float = 1.0
    min_mass: float = 1.0
    max_mass: float = 1.0
    rotation_speed: float = 1.0


@dataclasses.dataclass(frozen=True)
class PlummerDistParams:
    """Plummer sphere: density ρ(r) ∝ (1 + r²/a²)^(-5/2), truncated at
    ``max_radius_factor`` scale radii, isotropic velocities."""

    center: Vec3Like = (0.0, 0.0, 0.0)
    scale_radius: float = 1.0
    total_mass: float = 1.0
    max_radius_factor: float = 10.0  # truncate at this many scale radii
