"""nbody_tpu_torch state IO against the JAX package's (CPU): `.nbody`
bytes identical for the same state, each package loading the other's
files bit for bit, the same rejections, and the HDF5 schema both ways."""

import io
import struct

import numpy as np
import pytest

import nbody_tpu.state as jstate
import nbody_tpu.types as jtypes
import nbody_tpu.utils.serialization as jser
import nbody_tpu_torch.utils.hdf5_io as thdf
from nbody_tpu_torch.errors import SerializationError, ValidationError
from nbody_tpu_torch.state import SimulationState
from nbody_tpu_torch.types import ForceMethod
from nbody_tpu_torch.utils import serialization as tser


def _arrays(n, seed):
    rng = np.random.default_rng(seed)
    return dict(pos=rng.standard_normal((n, 3)).astype(np.float32),
                vel=rng.standard_normal((n, 3)).astype(np.float32),
                mass=rng.uniform(0.5, 2.0, n).astype(np.float32))


def _pair(n, seed, method="BARNES_HUT"):
    """The same snapshot in both packages."""
    scal = dict(simulation_time=1.25, dt=2e-3, G=1.5, softening=0.05)
    a = _arrays(n, seed)
    return (SimulationState(force_method=ForceMethod[method], **a, **scal),
            jstate.SimulationState(force_method=jtypes.ForceMethod[method],
                                   **a, **scal))


def _same(got, want):
    """Arrays bit-equal, scalars equal as the float32 the files store,
    the count and method equal."""
    for f in ("pos", "vel", "mass"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in ("simulation_time", "dt", "G", "softening"):
        assert np.float32(getattr(got, f)) == np.float32(getattr(want, f))
    assert got.particle_count == want.particle_count
    assert got.force_method.name == want.force_method.name


@pytest.mark.parametrize("n,method", [(0, "DIRECT_N2"), (1, "SPATIAL_HASH"),
                                      (257, "BARNES_HUT")])
def test_bytes_identical_to_jax(n, method):
    t, j = _pair(n, seed=n, method=method)
    raw = tser.save_bytes(t)
    assert raw == jser.save_bytes(j)
    assert len(raw) == tser.HEADER_SIZE + 7 * 4 * n == 56 + 28 * n
    assert struct.unpack_from("<II", raw) == (0x4E424F44, 1)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_files_load_in_the_other_package(tmp_path, writer):
    t, j = _pair(300, seed=5)
    path = str(tmp_path / "s.nbody")
    if writer == "jax":
        jser.Serializer.save(path, j)
        _same(tser.Serializer.load(path), j)
        assert tser.Serializer.validate_file(path)
    else:
        tser.Serializer.save(path, t)
        _same(jser.Serializer.load(path), t)
        assert jser.Serializer.validate_file(path)
    _same(tser.load_bytes(tser.save_bytes(t)), t)


def _garbage():
    return b"not an nbody file at all, just some bytes" * 3


def _truncated():
    raw = tser.save_bytes(_pair(100, seed=1)[0])
    return raw[: len(raw) // 2]


def _short_header():
    return tser.save_bytes(_pair(4, seed=2)[0])[:40]


def _bad_magic():
    raw = bytearray(tser.save_bytes(_pair(4, seed=3)[0]))
    raw[0] ^= 0xFF
    return bytes(raw)


def _bad_version():
    raw = bytearray(tser.save_bytes(_pair(4, seed=4)[0]))
    struct.pack_into("<I", raw, 4, 99)
    return bytes(raw)


@pytest.mark.parametrize("make", [_garbage, _truncated, _short_header,
                                  _bad_magic, _bad_version],
                         ids=lambda f: f.__name__.strip("_"))
def test_corrupt_data_raises_as_in_jax(make, tmp_path):
    """Each package refuses the same bytes with its own
    ``SerializationError`` and the same message."""
    raw = make()
    with pytest.raises(jser.SerializationError) as jexc:
        jser.load_bytes(raw)
    with pytest.raises(SerializationError) as texc:
        tser.load_bytes(raw)
    assert str(texc.value) == str(jexc.value)
    path = tmp_path / "bad.nbody"
    path.write_bytes(raw)
    with pytest.raises(SerializationError):
        tser.Serializer.load(str(path))
    with pytest.raises(SerializationError, match="open"):
        tser.Serializer.load(str(tmp_path / "missing.nbody"))


def test_count_cap_and_validate():
    header = struct.pack("<IIQffffI4I4x", 0x4E424F44, 1, 200_000_000,
                         0.0, 1e-3, 1.0, 0.1, 0, 0, 0, 0, 0)
    with pytest.raises(ValidationError, match="exceeds maximum"):
        tser.load_bytes(header)
    assert not tser.Serializer.validate_stream(io.BytesIO(b"junk"))
    assert tser.Serializer.validate_stream(io.BytesIO(header))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_hdf5_round_trip_both_ways(tmp_path, writer):
    pytest.importorskip("h5py")
    from nbody_tpu.utils.hdf5_io import HDF5IO as JIO

    t, j = _pair(257, seed=9, method="SPATIAL_HASH")
    path = str(tmp_path / "s.h5")
    if writer == "jax":
        JIO.export_to_file(path, j)
        got, want = thdf.HDF5IO.import_from_file(path), j
    else:
        thdf.HDF5IO.export_to_file(path, t)
        got, want = JIO.import_from_file(path), t
    _same(got, want)
    assert thdf.HDF5IO.validate_file(path) and JIO.validate_file(path)
    bad = tmp_path / "bad.h5"
    bad.write_bytes(_garbage())
    assert not thdf.HDF5IO.validate_file(str(bad))
    with pytest.raises(SerializationError, match="open"):
        thdf.HDF5IO.import_from_file(str(bad))


def test_hdf5_without_h5py_raises(tmp_path, monkeypatch):
    """Without h5py every export and import raises the JAX package's
    message, and nothing is written in another format."""
    monkeypatch.setattr(thdf, "HAVE_HDF5", False)
    path = tmp_path / "s.h5"
    with pytest.raises(SerializationError,
                       match="HDF5 support unavailable: h5py is not installed"):
        thdf.HDF5IO.export_to_file(str(path), _pair(8, seed=1)[0])
    with pytest.raises(SerializationError, match="h5py is not installed"):
        thdf.HDF5IO.import_from_file(str(path))
    assert not path.exists()
    assert not thdf.HDF5IO.validate_file(str(path))
