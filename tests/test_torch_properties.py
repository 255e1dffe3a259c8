"""Randomized property tests (hypothesis) of nbody_tpu_torch: the port's
counterpart of each property class of tests/test_properties.py (the
reference's RapidCheck suite), plus one cross-property with the JAX
package: a ``.nbody`` file written by either package loads in the other
to the same arrays.

Budget: at most 15 examples a property, tiny N, the torch side on one
thread and the CPU (the plain twins), no deadline.
"""

import io
import math

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from nbody_tpu.utils import serialization as jser
from nbody_tpu.state import SimulationState as JSimState
from nbody_tpu.types import ForceMethod as JForceMethod
from nbody_tpu_torch.errors import ValidationError, validate_config
from nbody_tpu_torch.models.distributions import (
    init_disk,
    init_spherical,
    init_uniform,
)
from nbody_tpu_torch.models.scenes import two_body_orbit
from nbody_tpu_torch.ops.direct import direct_forces
from nbody_tpu_torch.ops.integrator import (
    initialize_forces,
    kinetic_energy,
    make_verlet_step,
    potential_energy,
)
from nbody_tpu_torch.state import SimulationState
from nbody_tpu_torch.types import (
    DiskDistParams,
    ForceMethod,
    SimulationConfig,
    SphericalDistParams,
    UniformDistParams,
)
from nbody_tpu_torch.utils.serialization import (
    SerializationError,
    Serializer,
    load_bytes,
    save_bytes,
)

PROP = settings(max_examples=15, deadline=None,
                suppress_health_check=[HealthCheck.too_slow,
                                       HealthCheck.function_scoped_fixture])

finite_f = st.floats(min_value=-1e6, max_value=1e6, allow_nan=False,
                     allow_infinity=False)
pos_f = st.floats(min_value=1e-3, max_value=1e3, allow_nan=False,
                  allow_infinity=False)
seeds = st.integers(min_value=0, max_value=2**31 - 1)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gen(seed):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


class TestDistributionBounds:
    """Every generated particle respects its distribution's bounds for
    random parameters (tests/test_properties.py:64-130)."""

    @PROP
    @given(lo=st.tuples(finite_f, finite_f, finite_f),
           extent=st.tuples(pos_f, pos_f, pos_f), m_lo=pos_f,
           m_extent=st.floats(min_value=0.0, max_value=1e3), seed=seeds)
    def test_uniform_bounds(self, lo, extent, m_lo, m_extent, seed):
        hi = tuple(a + b for a, b in zip(lo, extent))
        params = UniformDistParams(min_bounds=lo, max_bounds=hi,
                                   min_mass=m_lo, max_mass=m_lo + m_extent)
        s = init_uniform(_gen(seed), 64, params)
        p = s.pos.double().numpy()
        tol = 1e-3 * (1.0 + np.abs(np.asarray(hi) + np.asarray(lo)))
        assert (p >= np.asarray(lo) - tol).all()
        assert (p <= np.asarray(hi) + tol).all()
        m = s.mass.double().numpy()
        assert (m >= m_lo * (1 - 1e-5) - 1e-6).all()
        assert (m <= (m_lo + m_extent) * (1 + 1e-5) + 1e-6).all()

    @PROP
    @given(center=st.tuples(finite_f, finite_f, finite_f), radius=pos_f,
           seed=seeds)
    def test_spherical_bounds(self, center, radius, seed):
        s = init_spherical(_gen(seed), 64,
                           SphericalDistParams(center=center, radius=radius))
        d = np.linalg.norm(s.pos.double().numpy() - np.asarray(center),
                           axis=1)
        # f32 stores center + r·dir: the roundoff floor scales with the
        # coordinate magnitude, not the radius
        ulp = 1.2e-7 * (np.abs(np.asarray(center)).max() + radius)
        assert (d <= radius * (1 + 1e-4) + 1e-3 + 8 * ulp).all()

    @PROP
    @given(center=st.tuples(finite_f, finite_f, finite_f), radius=pos_f,
           thickness=pos_f, seed=seeds)
    def test_disk_bounds(self, center, radius, thickness, seed):
        s = init_disk(_gen(seed), 64, DiskDistParams(
            center=center, radius=radius, thickness=thickness))
        rel = s.pos.double().numpy() - np.asarray(center)
        radial = np.hypot(rel[:, 0], rel[:, 1])
        ulp = 1.2e-7 * (np.abs(np.asarray(center)).max() + radius
                        + thickness)
        assert (radial <= radius * (1 + 1e-4) + 1e-3 + 8 * ulp).all()
        assert (np.abs(rel[:, 2])
                <= thickness / 2 * (1 + 1e-4) + 1e-3 + 8 * ulp).all()


def _random_state(n, seed, t=0.0, dt=1e-3, method=ForceMethod.DIRECT_N2):
    rng = np.random.default_rng(seed)
    return SimulationState(
        pos=rng.normal(size=(n, 3)).astype(np.float32),
        vel=rng.normal(size=(n, 3)).astype(np.float32),
        mass=rng.uniform(0.1, 10.0, size=n).astype(np.float32),
        simulation_time=t, dt=dt, force_method=method)


class TestSerializationProperties:
    """Round trip, garbage and truncation of the ``.nbody`` format
    (tests/test_properties.py:137-195), and the cross-package files."""

    @PROP
    @given(n=st.integers(min_value=1, max_value=200),
           t=st.floats(min_value=0, max_value=1e6),
           dt=st.floats(min_value=1e-6, max_value=1.0),
           method=st.sampled_from(list(ForceMethod)), seed=seeds)
    def test_roundtrip_random_state(self, n, t, dt, method, seed):
        state = _random_state(n, seed, t, dt, method)
        loaded = load_bytes(save_bytes(state))
        assert loaded.particle_count == n
        assert loaded.force_method == method
        np.testing.assert_array_equal(loaded.pos, state.pos)
        np.testing.assert_array_equal(loaded.vel, state.vel)
        np.testing.assert_array_equal(loaded.mass, state.mass)
        assert math.isclose(loaded.dt, dt, rel_tol=1e-6)
        assert math.isclose(loaded.simulation_time, t, rel_tol=1e-6,
                            abs_tol=1e-6)

    @PROP
    @given(garbage=st.binary(min_size=0, max_size=512))
    def test_garbage_rejected_or_invalid(self, garbage):
        """Random bytes never load silently."""
        assert not Serializer.validate_stream(io.BytesIO(garbage))
        with pytest.raises((SerializationError, ValidationError)):
            load_bytes(garbage)

    @PROP
    @given(n=st.integers(min_value=2, max_value=64),
           cut=st.integers(min_value=1, max_value=100), seed=seeds)
    def test_truncation_rejected(self, n, cut, seed):
        """Any strict prefix of a valid file fails loudly."""
        blob = save_bytes(_random_state(n, seed))
        cut_at = min(len(blob) - 1, max(1, len(blob) * cut // 101))
        with pytest.raises(SerializationError):
            load_bytes(blob[:cut_at])

    @PROP
    @given(n=st.integers(min_value=1, max_value=100),
           t=st.floats(min_value=0, max_value=1e6),
           dt=st.floats(min_value=1e-6, max_value=1.0),
           method=st.sampled_from(list(ForceMethod)), seed=seeds)
    def test_files_cross_between_packages(self, n, t, dt, method, seed):
        """Bytes the port writes load in the JAX package to the same
        arrays and header, and the JAX package's bytes load in the port;
        both packages write the same bytes for the same state."""
        state = _random_state(n, seed, t, dt, method)
        theirs = jser.load_bytes(save_bytes(state))
        assert theirs.particle_count == n
        assert int(theirs.force_method) == int(method)
        for f in ("pos", "vel", "mass"):
            np.testing.assert_array_equal(getattr(theirs, f),
                                          getattr(state, f))
        assert theirs.dt == np.float32(dt)
        jstate = JSimState(pos=state.pos, vel=state.vel, mass=state.mass,
                           simulation_time=t, dt=dt,
                           force_method=JForceMethod(int(method)))
        blob = jser.save_bytes(jstate)
        assert blob == save_bytes(state)
        ours = load_bytes(blob)
        assert ours.force_method == method
        for f in ("pos", "vel", "mass"):
            np.testing.assert_array_equal(getattr(ours, f),
                                          getattr(state, f))
        assert math.isclose(ours.simulation_time, theirs.simulation_time,
                            rel_tol=0, abs_tol=0)


class TestValidationProperties:
    """Accept and reject under fuzzed config values
    (tests/test_properties.py:201-250)."""

    @PROP
    @given(n=st.integers(min_value=1, max_value=10**6),
           dt=st.floats(min_value=1e-9, max_value=1.0, exclude_min=True),
           eps=st.floats(min_value=0.0, max_value=1e3),
           theta=st.floats(min_value=1e-6, max_value=2.0, exclude_max=True),
           G=pos_f)
    def test_valid_configs_accepted(self, n, dt, eps, theta, G):
        validate_config(SimulationConfig(particle_count=n, dt=dt,
                                         softening=eps,
                                         barnes_hut_theta=theta, G=G))

    @PROP
    @given(field=st.sampled_from(["dt", "softening", "barnes_hut_theta",
                                  "G"]),
           bad=st.sampled_from([float("nan"), float("inf"), -float("inf"),
                                -1.0, 0.0]))
    def test_nonfinite_or_nonpositive_rejected(self, field, bad):
        # softening 0 is valid (non-negative rule); θ is validated under
        # Barnes-Hut only, where θ = 0 (exact opening) is allowed
        if field == "softening" and bad == 0.0:
            validate_config(SimulationConfig(**{field: bad}))
            return
        kwargs = {field: bad}
        if field == "barnes_hut_theta":
            kwargs["force_method"] = ForceMethod.BARNES_HUT
            if bad == 0.0:
                validate_config(SimulationConfig(**kwargs))
                return
        with pytest.raises(ValidationError):
            validate_config(SimulationConfig(**kwargs))

    @PROP
    @given(n=st.integers(max_value=0, min_value=-(10**9)))
    def test_nonpositive_count_rejected(self, n):
        with pytest.raises(ValidationError):
            validate_config(SimulationConfig(particle_count=n))


class TestOrbitDriftProperty:
    """A two-body circular orbit conserves energy for random orbit
    parameters: 40 Verlet steps at N = 2, |ΔE| ≤ 1e-2·|E0| + 1e-9
    (tests/test_properties.py:255-305)."""

    @PROP
    @given(separation=st.floats(min_value=0.5, max_value=20.0),
           mass=st.floats(min_value=0.1, max_value=50.0),
           eps=st.floats(min_value=0.0, max_value=0.3))
    def test_energy_drift_bounded(self, separation, mass, eps):
        G = 1.0
        # dt scaled to the orbit so the gate is uniform across parameters
        v = math.sqrt(G * mass * separation ** 2
                      / (2.0 * (separation ** 2 + eps ** 2) ** 1.5))
        dt = 1e-3 * separation / max(v, 1e-9)

        def force_fn(p, m):
            return direct_forces(p, m, G, eps)

        def energy(s):
            return float(kinetic_energy(s)) + float(
                potential_energy(s.pos, s.mass, G, eps))

        s = initialize_forces(
            two_body_orbit(separation=separation, mass=mass, G=G,
                           softening=eps), force_fn)
        e0 = energy(s)
        step = make_verlet_step(force_fn, dt)
        for _ in range(40):
            s = step(s)
        assert abs(energy(s) - e0) <= 1e-2 * abs(e0) + 1e-9
