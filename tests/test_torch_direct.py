"""nbody_tpu_torch direct N² forces against the JAX package (CPU).

Inputs are made with numpy from a seed (float32) and handed to both
packages. On CPU tensors the kernel wrapper runs its plain twin; the card
comparison of the CUDA kernel itself is in chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops.direct import direct_forces as jax_direct_forces
from nbody_tpu.ops.direct import (
    direct_forces_reference as jax_direct_reference,
)
from nbody_tpu_torch.ops.direct import (
    direct_forces,
    direct_forces_kernel,
    direct_forces_reference,
)


def _scene(n, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-5.0, 5.0, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return pos, mass


@pytest.mark.parametrize("n", [1, 37, 300])
def test_direct_matches_jax_f32(n):
    """Blocked f32 forces vs the JAX blocked f32 forces; atol 1e-5·max|a|
    (f32 sums over n terms in another order)."""
    pos, mass = _scene(n)
    want = np.asarray(jax_direct_forces(jnp.asarray(pos), jnp.asarray(mass),
                                        1.0, 0.1))
    got = direct_forces_kernel(torch.from_numpy(pos), torch.from_numpy(mass),
                               1.0, 0.1).numpy()
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


def test_direct_matches_jax_f64_reference():
    """Against the JAX f64 reference: rel 1e-4 (f32 rounding of ~300-term
    sums stays far below it)."""
    pos, mass = _scene(300, seed=1)
    want = np.asarray(jax_direct_reference(
        jnp.asarray(pos), jnp.asarray(mass), 1.0, 0.1, dtype=jnp.float64))
    got = direct_forces(torch.from_numpy(pos), torch.from_numpy(mass),
                        1.0, 0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    ref64 = direct_forces_reference(torch.from_numpy(pos),
                                    torch.from_numpy(mass), 1.0, 0.1,
                                    dtype=torch.float64).numpy()
    np.testing.assert_allclose(ref64, want, rtol=1e-6, atol=1e-6)


def test_two_body_analytic():
    """|a| = G m r / (r² + ε²)^{3/2} along the separation, equal and
    opposite; the self pair contributes exactly zero (rel 1e-6)."""
    G, eps, r = 2.0, 0.1, 2.0
    pos = torch.tensor([[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    mass = torch.tensor([1.0, 3.0])
    acc = direct_forces_kernel(pos, mass, G, eps).numpy().astype(np.float64)
    mag = G * r / (r * r + eps * eps) ** 1.5
    np.testing.assert_allclose(acc[0], [3.0 * mag, 0, 0], rtol=1e-6)
    np.testing.assert_allclose(acc[1], [-1.0 * mag, 0, 0], rtol=1e-6)


def test_targets_subset_and_coincident_rows():
    """A target subset equals the matching rows of the full evaluation,
    and coincident particles exert exactly zero on each other."""
    pos, mass = _scene(64, seed=2)
    pos[5] = pos[4]
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    full = direct_forces_kernel(p, m, 1.0, 0.0)
    assert torch.isfinite(full).all()
    sub = direct_forces_kernel(p, m, 1.0, 0.0, targets=p[[4, 9, 63]])
    np.testing.assert_allclose(sub.numpy(), full[[4, 9, 63]].numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("eps", [1e-13, 1e-6])
def test_small_softening_coincident_rows_match_jax(eps):
    """Coincident rows at ε = 1e-13 and 1e-6 (on either side of the least
    ε² of the CUDA kernel's loop without the r² == 0 select, 1e-12):
    finite forces, atol 1e-5·max|a| against the JAX blocked f32 forces."""
    pos, mass = _scene(300, seed=3)
    pos[5] = pos[4]
    pos[200] = pos[17]
    want = np.asarray(jax_direct_forces(jnp.asarray(pos), jnp.asarray(mass),
                                        1.0, eps))
    got = direct_forces_kernel(torch.from_numpy(pos), torch.from_numpy(mass),
                               1.0, eps).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_wrapper_counts_launches_only_on_cuda():
    """CPU tensors take the plain twin and never count as a launch."""
    pos, mass = _scene(8)
    before = direct_forces_kernel.launches
    calls = direct_forces.calls
    direct_forces_kernel(torch.from_numpy(pos), torch.from_numpy(mass))
    assert direct_forces_kernel.launches == before
    assert direct_forces.calls == calls + 1
