"""Versioned binary checkpoint serializer — the `.nbody` format.

PyTorch-package counterpart of ``nbody_tpu/utils/serialization.py``, byte
for byte the same format, so a file written by either package loads in
the other:

  header (56 bytes, little-endian, the C++ struct layout with its 4 bytes
  of tail padding):
    u32 magic      = 0x4E424F44 ("NBOD")
    u32 version    = 1
    u64 particle_count   (capped at 100M against corrupt files)
    f32 simulation_time, dt, G, softening
    u32 force_method
    u32 reserved[4] = 0
    4 bytes struct padding
  payload: pos_x, pos_y, pos_z, vel_x, vel_y, vel_z, mass — each
  particle_count float32s.

Accelerations are not stored: loading recomputes forces, which is exact
for Velocity Verlet since a(t) is a function of x(t). The snapshot is the
host-side ``SimulationState`` (numpy arrays); nothing here touches torch.
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO, Union

import numpy as np

from nbody_tpu_torch.errors import SerializationError, ValidationError
from nbody_tpu_torch.state import SimulationState
from nbody_tpu_torch.types import MAX_PARTICLE_COUNT, ForceMethod
from nbody_tpu_torch.utils.profiling import profile_phase

NBODY_MAGIC = 0x4E424F44
NBODY_VERSION = 1

# C++ FileHeader layout: u32 u32 | u64 | f32×4 | u32 | u32×4 | pad → 56 B.
_HEADER = struct.Struct("<IIQffffI4I4x")
HEADER_SIZE = _HEADER.size
assert HEADER_SIZE == 56

PathOrStream = Union[str, BinaryIO]


class Serializer:
    """Static save/load API."""

    @staticmethod
    def save(target: PathOrStream, state: SimulationState) -> None:
        with profile_phase("serialization.save"):
            if isinstance(target, str):
                with open(target, "wb") as f:
                    Serializer._save_stream(f, state)
            else:
                Serializer._save_stream(target, state)

    @staticmethod
    def load(source: PathOrStream) -> SimulationState:
        with profile_phase("serialization.load"):
            if isinstance(source, str):
                try:
                    f = open(source, "rb")
                except OSError as e:
                    raise SerializationError(
                        f"Failed to open file for reading: {source}"
                    ) from e
                with f:
                    return Serializer._load_stream(f)
            return Serializer._load_stream(source)

    @staticmethod
    def validate_file(filename: str) -> bool:
        try:
            with open(filename, "rb") as f:
                return Serializer.validate_stream(f)
        except OSError:
            return False

    @staticmethod
    def validate_stream(stream: BinaryIO) -> bool:
        try:
            Serializer._read_header(stream)
            return True
        except SerializationError:
            return False

    # ---- internals ----

    @staticmethod
    def _save_stream(out: BinaryIO, state: SimulationState) -> None:
        out.write(
            _HEADER.pack(
                NBODY_MAGIC,
                NBODY_VERSION,
                state.particle_count,
                float(state.simulation_time),
                float(state.dt),
                float(state.G),
                float(state.softening),
                int(state.force_method),
                0,
                0,
                0,
                0,
            )
        )
        pos = np.ascontiguousarray(state.pos, dtype="<f4")
        vel = np.ascontiguousarray(state.vel, dtype="<f4")
        mass = np.ascontiguousarray(state.mass, dtype="<f4")
        for arr in (pos[:, 0], pos[:, 1], pos[:, 2],
                    vel[:, 0], vel[:, 1], vel[:, 2], mass):
            out.write(np.ascontiguousarray(arr).tobytes())

    @staticmethod
    def _read_header(stream: BinaryIO):
        raw = stream.read(HEADER_SIZE)
        if len(raw) != HEADER_SIZE:
            raise SerializationError(
                "Failed to read file header: file may be truncated or corrupted"
            )
        (magic, version, count, sim_time, dt, G, eps, method, *_res) = (
            _HEADER.unpack(raw)
        )
        if magic != NBODY_MAGIC:
            raise SerializationError("Invalid file format: wrong magic number")
        if version != NBODY_VERSION:
            raise SerializationError("Unsupported file version")
        return count, sim_time, dt, G, eps, method

    @staticmethod
    def _read_float_array(stream: BinaryIO, count: int) -> np.ndarray:
        raw = stream.read(count * 4)
        if len(raw) != count * 4:
            raise SerializationError(
                "Failed to read particle data: file may be truncated or corrupted"
            )
        return np.frombuffer(raw, dtype="<f4").copy()

    @staticmethod
    def _load_stream(stream: BinaryIO) -> SimulationState:
        count, sim_time, dt, G, eps, method = Serializer._read_header(stream)
        if count > MAX_PARTICLE_COUNT:
            raise ValidationError(
                f"Particle count ({count}) exceeds maximum allowed "
                f"({MAX_PARTICLE_COUNT})"
            )
        cols = [Serializer._read_float_array(stream, count) for _ in range(7)]
        return SimulationState(
            pos=np.stack(cols[0:3], axis=-1) if count else np.zeros((0, 3)),
            vel=np.stack(cols[3:6], axis=-1) if count else np.zeros((0, 3)),
            mass=cols[6],
            particle_count=count,
            simulation_time=sim_time,
            dt=dt,
            G=G,
            softening=eps,
            force_method=ForceMethod(method),
        )


def save_bytes(state: SimulationState) -> bytes:
    buf = io.BytesIO()
    Serializer.save(buf, state)
    return buf.getvalue()


def load_bytes(data: bytes) -> SimulationState:
    return Serializer.load(io.BytesIO(data))
