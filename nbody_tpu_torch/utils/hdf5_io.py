"""HDF5 interchange format.

PyTorch-package counterpart of ``nbody_tpu/utils/hdf5_io.py``, the same
schema, so files interoperate with the JAX package and with
h5py/ParaView/MATLAB:

  /particles/position  (N, 3) float32
  /particles/velocity  (N, 3) float32
  /particles/mass      (N,)   float32
  /metadata            attrs: time, dt, G, softening, force_method,
                       particle_count

``h5py`` is optional and imported on first use. Without it
``HAVE_HDF5`` is False and export and import raise ``SerializationError``;
no other format is written in its place.
"""

from __future__ import annotations

import importlib.util

import numpy as np

from nbody_tpu_torch.errors import SerializationError, ValidationError
from nbody_tpu_torch.state import SimulationState
from nbody_tpu_torch.types import MAX_PARTICLE_COUNT, ForceMethod

HAVE_HDF5 = importlib.util.find_spec("h5py") is not None


def _h5py():
    if not HAVE_HDF5:
        raise SerializationError(
            "HDF5 support unavailable: h5py is not installed"
        )
    import h5py

    return h5py


class HDF5IO:
    """Static export/import/validate API."""

    @staticmethod
    def export_to_file(filename: str, state: SimulationState) -> None:
        h5py = _h5py()
        with h5py.File(filename, "w") as f:
            g = f.create_group("particles")
            g.create_dataset("position", data=np.asarray(state.pos, np.float32))
            g.create_dataset("velocity", data=np.asarray(state.vel, np.float32))
            g.create_dataset("mass", data=np.asarray(state.mass, np.float32))
            meta = f.create_group("metadata")
            meta.attrs["time"] = np.float32(state.simulation_time)
            meta.attrs["dt"] = np.float32(state.dt)
            meta.attrs["G"] = np.float32(state.G)
            meta.attrs["softening"] = np.float32(state.softening)
            meta.attrs["force_method"] = np.uint32(int(state.force_method))
            meta.attrs["particle_count"] = np.uint64(state.particle_count)

    @staticmethod
    def import_from_file(filename: str) -> SimulationState:
        h5py = _h5py()
        try:
            f = h5py.File(filename, "r")
        except OSError as e:
            raise SerializationError(
                f"Failed to open HDF5 file: {filename}"
            ) from e
        with f:
            try:
                pos = np.asarray(f["particles/position"], np.float32)
                vel = np.asarray(f["particles/velocity"], np.float32)
                mass = np.asarray(f["particles/mass"], np.float32)
                meta = f["metadata"].attrs
                count = int(meta.get("particle_count", pos.shape[0]))
            except KeyError as e:
                raise SerializationError(
                    f"Invalid HDF5 schema in {filename}: missing {e}"
                ) from e
            if count > MAX_PARTICLE_COUNT:
                raise ValidationError(
                    f"Particle count ({count}) exceeds maximum allowed"
                )
            if pos.shape != (count, 3) or vel.shape != (count, 3):
                raise SerializationError(
                    "Invalid HDF5 data: dataset shapes do not match count"
                )
            return SimulationState(
                pos=pos,
                vel=vel,
                mass=mass,
                particle_count=count,
                simulation_time=float(meta.get("time", 0.0)),
                dt=float(meta.get("dt", 1e-3)),
                G=float(meta.get("G", 1.0)),
                softening=float(meta.get("softening", 0.1)),
                force_method=ForceMethod(int(meta.get("force_method", 0))),
            )

    @staticmethod
    def validate_file(filename: str) -> bool:
        """True for a readable file with the particle and metadata groups;
        False otherwise, and False without ``h5py``."""
        if not HAVE_HDF5:
            return False
        h5py = _h5py()
        try:
            with h5py.File(filename, "r") as f:
                return "particles/position" in f and "metadata" in f
        except OSError:
            return False
