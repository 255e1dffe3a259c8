"""CLI parsing and the application entry point.

PyTorch-package counterpart of ``nbody_tpu/cli.py``: the same flags, the
same parse-time validation and the same exit codes (0, 2 for a bad flag
or value, 130 on interrupt):

  --particles N --method NAME --dt V --gravity V --softening V --theta V
  --cell-size V --cutoff V --benchmark --benchmark-steps N
  --benchmark-output P --export P --export-format FMT --import P
  --list-algorithms --diagnostics --help  + bare positional count
  --init DIST and its scoped distribution flags, --hash-engine, --seed,
  --render, --render-output, --live, --devices N, --resort-every N,
  --resort-stale-frac F, --resort-repair, --steps N, --debug-nans,
  --trace DIR

    python -m nbody_tpu_torch.cli --particles 1000000 --method barnes-hut \
        --benchmark --benchmark-steps 30

runs on the CUDA card (``app.Application``); without one it raises.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional

from nbody_tpu_torch.errors import ValidationError
from nbody_tpu_torch.types import ForceMethod, InitDistribution, SimulationConfig


@dataclasses.dataclass
class AppCliOptions:
    """Parsed command line."""

    particle_count: int = 10_000
    force_method: ForceMethod = ForceMethod.DIRECT_N2
    init_distribution: InitDistribution = InitDistribution.SPHERICAL
    dt: float = 1e-3
    G: float = 1.0
    softening: float = 0.1
    barnes_hut_theta: float = 0.5
    spatial_hash_cell_size: float = 1.0
    spatial_hash_cutoff: float = 2.0
    hash_engine: str = "auto"
    seed: int = 42
    benchmark_mode: bool = False
    benchmark_steps: int = 100
    benchmark_output_path: str = ""
    export_path: str = ""
    export_format: str = "checkpoint"
    import_path: str = ""
    list_algorithms: bool = False
    show_diagnostics: bool = False
    show_help: bool = False
    render: bool = False
    render_output: str = ""
    live: bool = False  # ANSI terminal live view
    devices: int = 1
    resort_every: int = 1  # amortized re-sort cadence (fused runs)
    resort_stale_frac: float = 0.0  # adaptive audit-driven re-sort (>0)
    resort_repair: bool = False  # exact incremental re-sort (table)
    steps: int = 0  # 0 = run until interrupted (interactive)
    debug_nans: bool = False  # raise at the first non-finite state
    trace_dir: str = ""  # deep-trace output dir (torch.profiler)
    # Distribution parameters (None = that distribution's default).
    radius: Optional[float] = None
    center: Optional[tuple] = None
    thickness: Optional[float] = None
    rotation_speed: Optional[float] = None
    min_mass: Optional[float] = None
    max_mass: Optional[float] = None
    min_bounds: Optional[tuple] = None
    max_bounds: Optional[tuple] = None
    total_mass: Optional[float] = None

    def _dist_params(self):
        """Build the *DistParams override for init_distribution, or None.

        Flags that do not apply to the selected distribution raise (each
        field is scoped to one parameter type).
        """
        from nbody_tpu_torch.types import (
            DiskDistParams,
            PlummerDistParams,
            SphericalDistParams,
            UniformDistParams,
        )

        # CLI field -> per-distribution param-struct field (None = N/A).
        table = {
            InitDistribution.UNIFORM: (
                UniformDistParams,
                {
                    "min_bounds": "min_bounds",
                    "max_bounds": "max_bounds",
                    "min_mass": "min_mass",
                    "max_mass": "max_mass",
                },
            ),
            InitDistribution.SPHERICAL: (
                SphericalDistParams,
                {
                    "center": "center",
                    "radius": "radius",
                    "min_mass": "min_mass",
                    "max_mass": "max_mass",
                },
            ),
            InitDistribution.DISK: (
                DiskDistParams,
                {
                    "center": "center",
                    "radius": "radius",
                    "thickness": "thickness",
                    "min_mass": "min_mass",
                    "max_mass": "max_mass",
                    "rotation_speed": "rotation_speed",
                },
            ),
            InitDistribution.PLUMMER: (
                PlummerDistParams,
                {
                    "center": "center",
                    "radius": "scale_radius",  # --radius = scale radius
                    "total_mass": "total_mass",
                },
            ),
        }
        all_fields = (
            "radius",
            "center",
            "thickness",
            "rotation_speed",
            "min_mass",
            "max_mass",
            "min_bounds",
            "max_bounds",
            "total_mass",
        )
        cls, mapping = table[self.init_distribution]
        kw = {}
        for f in all_fields:
            v = getattr(self, f)
            if v is None:
                continue
            if f not in mapping:
                raise ValidationError(
                    f"--{f.replace('_', '-')} does not apply to "
                    f"--init {self.init_distribution.name.lower()}"
                )
            kw[mapping[f]] = v
        return cls(**kw) if kw else None

    def to_config(self) -> SimulationConfig:
        return SimulationConfig(
            dist_params=self._dist_params(),
            particle_count=self.particle_count,
            init_distribution=self.init_distribution,
            force_method=self.force_method,
            dt=self.dt,
            G=self.G,
            softening=self.softening,
            barnes_hut_theta=self.barnes_hut_theta,
            spatial_hash_cell_size=self.spatial_hash_cell_size,
            spatial_hash_cutoff=self.spatial_hash_cutoff,
            hash_engine=self.hash_engine,
            seed=self.seed,
            shard_devices=self.devices,
            resort_every=self.resort_every,
            resort_stale_frac=self.resort_stale_frac,
            resort_repair=self.resort_repair,
        )


def _parse_int(value: str, flag: str) -> int:
    try:
        return int(value)
    except ValueError:
        raise ValidationError(f"Invalid numeric value for {flag}: {value}")


def _parse_float(value: str, flag: str) -> float:
    try:
        return float(value)
    except ValueError:
        raise ValidationError(f"Invalid numeric value for {flag}: {value}")


def _parse_vec3(value: str, flag: str) -> tuple:
    parts = value.split(",")
    if len(parts) != 3:
        raise ValidationError(f"Expected X,Y,Z for {flag}: {value}")
    return tuple(_parse_float(p, flag) for p in parts)


def parse_app_cli_options(argv: List[str]) -> AppCliOptions:
    """Parse argv (no program name)."""
    o = AppCliOptions()
    i = 0

    def need_value(flag: str) -> str:
        nonlocal i
        i += 1
        if i >= len(argv):
            raise ValidationError(f"Missing value for {flag}")
        return argv[i]

    while i < len(argv):
        a = argv[i]
        if a in ("--help", "-h"):
            o.show_help = True
        elif a == "--particles":
            o.particle_count = _parse_int(need_value(a), a)
        elif a == "--method":
            o.force_method = ForceMethod.parse(need_value(a))
        elif a == "--init":
            o.init_distribution = InitDistribution.parse(need_value(a))
        elif a == "--dt":
            o.dt = _parse_float(need_value(a), a)
        elif a == "--gravity":
            o.G = _parse_float(need_value(a), a)
        elif a == "--softening":
            o.softening = _parse_float(need_value(a), a)
        elif a == "--theta":
            o.barnes_hut_theta = _parse_float(need_value(a), a)
        elif a == "--cell-size":
            o.spatial_hash_cell_size = _parse_float(need_value(a), a)
        elif a == "--cutoff":
            o.spatial_hash_cutoff = _parse_float(need_value(a), a)
        elif a == "--hash-engine":
            o.hash_engine = need_value(a)
        elif a == "--seed":
            o.seed = _parse_int(need_value(a), a)
        elif a == "--radius":
            o.radius = _parse_float(need_value(a), a)
        elif a == "--center":
            o.center = _parse_vec3(need_value(a), a)
        elif a == "--thickness":
            o.thickness = _parse_float(need_value(a), a)
        elif a == "--rotation-speed":
            o.rotation_speed = _parse_float(need_value(a), a)
        elif a == "--min-mass":
            o.min_mass = _parse_float(need_value(a), a)
        elif a == "--max-mass":
            o.max_mass = _parse_float(need_value(a), a)
        elif a == "--min-bounds":
            o.min_bounds = _parse_vec3(need_value(a), a)
        elif a == "--max-bounds":
            o.max_bounds = _parse_vec3(need_value(a), a)
        elif a == "--total-mass":
            o.total_mass = _parse_float(need_value(a), a)
        elif a == "--benchmark":
            o.benchmark_mode = True
        elif a == "--benchmark-steps":
            o.benchmark_steps = _parse_int(need_value(a), a)
            o.benchmark_mode = True
        elif a == "--benchmark-output":
            o.benchmark_output_path = need_value(a)
            o.benchmark_mode = True
        elif a == "--export":
            o.export_path = need_value(a)
        elif a == "--export-format":
            o.export_format = need_value(a)
        elif a == "--import":
            o.import_path = need_value(a)
        elif a == "--list-algorithms":
            o.list_algorithms = True
        elif a == "--diagnostics":
            o.show_diagnostics = True
        elif a == "--render":
            o.render = True
        elif a == "--render-output":
            o.render_output = need_value(a)
            o.render = True
        elif a == "--live":
            o.live = True
        elif a == "--devices":
            o.devices = _parse_int(need_value(a), a)
        elif a == "--resort-every":
            o.resort_every = _parse_int(need_value(a), a)
        elif a == "--resort-stale-frac":
            o.resort_stale_frac = _parse_float(need_value(a), a)
        elif a == "--resort-repair":
            o.resort_repair = True
        elif a == "--debug-nans":
            o.debug_nans = True
        elif a == "--trace":
            o.trace_dir = need_value(a)
        elif a == "--steps":
            o.steps = _parse_int(need_value(a), a)
        elif a.startswith("-"):
            raise ValidationError(f"Unknown argument: {a}")
        else:
            o.particle_count = _parse_int(a, "particle count")
        i += 1

    # parse-time validation
    from nbody_tpu_torch.errors import (
        validate_particle_count,
        validate_softening,
        validate_theta,
        validate_time_step,
    )

    validate_particle_count(o.particle_count)
    validate_time_step(o.dt)
    validate_softening(o.softening)
    validate_theta(o.barnes_hut_theta)
    if o.G <= 0:
        raise ValidationError("Gravitational constant must be positive")
    if o.spatial_hash_cell_size <= 0:
        raise ValidationError("Spatial hash cell size must be positive")
    if o.spatial_hash_cutoff <= 0:
        raise ValidationError("Spatial hash cutoff must be positive")
    if o.hash_engine not in ("auto", "window", "tiles"):
        raise ValidationError(
            f"Unknown hash engine: {o.hash_engine} (auto | window | tiles)"
        )
    if o.benchmark_steps <= 0:
        raise ValidationError("Benchmark steps must be greater than zero")
    if o.export_format not in ("checkpoint", "hdf5"):
        raise ValidationError(
            f"Unknown export format: {o.export_format} (checkpoint | hdf5)"
        )
    for flag, v in (
        ("--radius", o.radius),
        ("--thickness", o.thickness),
        ("--total-mass", o.total_mass),
        ("--min-mass", o.min_mass),
        ("--max-mass", o.max_mass),
    ):
        if v is not None and v <= 0:
            raise ValidationError(f"{flag} must be positive")
    if (
        o.min_mass is not None
        and o.max_mass is not None
        and o.min_mass > o.max_mass
    ):
        raise ValidationError("--min-mass must not exceed --max-mass")
    if o.min_bounds is not None and o.max_bounds is not None:
        if any(lo >= hi for lo, hi in zip(o.min_bounds, o.max_bounds)):
            raise ValidationError("--min-bounds must be below --max-bounds")
    o._dist_params()  # raises per-distribution if fields are inapplicable
    return o


def app_cli_usage() -> str:
    """The usage text ``--help`` prints."""
    return """Usage: nbody-tpu-torch [particle_count] [options]

Simulation options:
  --particles N          Number of particles to simulate
  --method NAME          Force algorithm: direct-n2 | barnes-hut | spatial-hash
  --init NAME            uniform | spherical | disk | plummer
  --dt VALUE             Verlet integration time step
  --gravity VALUE        Gravitational constant G
  --softening VALUE      Plummer softening length
  --theta VALUE          Barnes-Hut opening angle
  --cell-size VALUE      Spatial-hash grid cell edge
  --cutoff VALUE         Spatial-hash interaction cutoff
  --hash-engine NAME     auto | window | tiles (short-range engine)
  --seed N               Set initializer RNG seed
  --steps N              Step count for interactive/render mode

Distribution parameters (scoped to --init; defaults per distribution):
  --radius VALUE         Sphere/disk radius; Plummer scale radius
  --center X,Y,Z         Distribution center (spherical/disk/plummer)
  --thickness VALUE      Disk thickness
  --rotation-speed VALUE Disk tangential speed factor (v = w*sqrt(r))
  --min-mass VALUE       Minimum particle mass (uniform/spherical/disk)
  --max-mass VALUE       Maximum particle mass (uniform/spherical/disk)
  --min-bounds X,Y,Z     Uniform box lower corner
  --max-bounds X,Y,Z     Uniform box upper corner
  --total-mass VALUE     Plummer total mass
  --devices N            Shard particles over N CUDA cards (a mesh in
                         one process)
  --resort-every N       Re-derive the cell sort every N fused steps
                         (1 = every step; >1 amortizes the sort, stale
                         boundary rows are audited)
  --resort-stale-frac F  Adaptive re-sort: take frozen steps until the
                         audited stale fraction exceeds F (cap
                         --resort-every steps), 0 disables
  --resort-repair        Exact incremental re-sort: re-home only the
                         rows whose cell changed each step (table
                         stepping on the card where it is routed; full
                         rebuild on audit or cadence triggers)
  --benchmark            Headless timed run; emits a JSON record
  --benchmark-steps N    Steps per benchmark run
  --benchmark-output P   Benchmark JSON destination file

Data export/import:
  --export PATH          Write the particle state to PATH
  --export-format FMT    Export format: checkpoint (default) | hdf5
  --import PATH          Load a particle state from PATH

Rendering (on the card; PNG frames or the terminal view):
  --render               Render frames while stepping
  --render-output DIR    Write PNG frames to DIR
  --live                 Live ANSI terminal view (in-place redraw)

Diagnostics:
  --list-algorithms      Print the force methods and exit
  --diagnostics          Print device/config diagnostics
  --debug-nans           Raise at the first benchmark chunk (loop step)
                         whose state is not finite
  --trace DIR            Write a device trace of the benchmark loop to
                         DIR/trace.json (torch.profiler Chrome trace;
                         open in Perfetto), each phase a span and, on
                         the card, marked inside the graph replays
  --help                 Print this usage text
"""


def main(argv: Optional[List[str]] = None) -> int:
    from nbody_tpu_torch.app import Application

    try:
        options = parse_app_cli_options(
            list(sys.argv[1:]) if argv is None else list(argv)
        )
    except ValidationError as e:
        print(f"error: {e}", file=sys.stderr)
        print(app_cli_usage(), file=sys.stderr)
        return 2

    if options.show_help:
        print(app_cli_usage())
        return 0

    try:
        return Application(options).run()
    except ValidationError as e:
        print(f"validation error: {e}", file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        print("\ninterrupted")
        return 130


if __name__ == "__main__":
    sys.exit(main())
