"""The all-pairs potential (kernel K5's plain twin) against the JAX
package's Pallas kernel in interpret mode and its float64 blocked sum
(CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops.direct import pairwise_potential_pallas
from nbody_tpu.ops.integrator import potential_energy as jax_pe
from nbody_tpu_torch.ops import direct
from nbody_tpu_torch.ops.direct import (
    pairwise_potential,
    pairwise_potential_plain,
)

G, EPS = 1.0, 0.1


def _scene(n, seed):
    """A uniform ball with one coincident pair (rows 0 and 1) and one
    zero-mass row (row 2)."""
    rng = np.random.default_rng(seed)
    r = np.cbrt(rng.uniform(size=n)) * 5.0
    v = rng.normal(size=(n, 3))
    pos = (v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None])
    pos = pos.astype(np.float32)
    pos[1] = pos[0]
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    mass[2] = 0.0
    return pos, mass


@pytest.mark.parametrize("n", [1000, 2048])
def test_plain_matches_jax(n):
    """Twin vs the JAX kernel (interpret mode: tree sums per 1024² tile,
    Kahan across j) and vs the JAX f64 blocked sum: relative 1e-6 (float32
    pair terms summed in float64 here)."""
    pos, mass = _scene(n, seed=n)
    got = float(pairwise_potential_plain(torch.from_numpy(pos),
                                         torch.from_numpy(mass), G, EPS))
    jp, jm = jnp.asarray(pos), jnp.asarray(mass)
    want_k = float(pairwise_potential_pallas(jp, jm, G, EPS, interpret=True))
    want_f64 = float(jax_pe(jp, jm, G, EPS, accumulate="f64"))
    assert got < 0.0
    np.testing.assert_allclose(got, want_k, rtol=1e-6)
    np.testing.assert_allclose(got, want_f64, rtol=1e-6)


def test_coincident_pair_is_excluded():
    """Rows 0 and 1 coincide, row 2 sits 3 away: only the two (0, 2) and
    (1, 2) pairs count — the coincident pair is excluded, not softened
    in — in the twin and in the JAX kernel alike (relative 1e-6)."""
    pos = np.array([[1.0, 2.0, 3.0], [1.0, 2.0, 3.0], [1.0, 2.0, 6.0]],
                   np.float32)
    mass = np.array([2.0, 0.5, 1.5], np.float32)
    want = -G * (2.0 + 0.5) * 1.5 / np.sqrt(9.0 + EPS * EPS)
    got = float(pairwise_potential_plain(torch.from_numpy(pos),
                                         torch.from_numpy(mass), G, EPS))
    jax_got = float(pairwise_potential_pallas(
        jnp.asarray(pos), jnp.asarray(mass), G, EPS, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(jax_got, want, rtol=1e-6)


@pytest.mark.parametrize("block_terms", [1, 4096])
def test_plain_blocking_does_not_change_the_sum(block_terms, monkeypatch):
    """One row per block or a few rows per block against one block:
    relative 1e-7 (the same float32 terms, float64 sums in another
    grouping)."""
    pos, mass = _scene(700, seed=9)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    want = float(pairwise_potential_plain(tp, tm, G, EPS))
    monkeypatch.setattr(direct, "PE_BLOCK_TERMS", block_terms)
    got = float(pairwise_potential_plain(tp, tm, G, EPS))
    np.testing.assert_allclose(got, want, rtol=1e-7)


def test_wrapper_takes_the_twin_on_cpu_only():
    """CPU tensors run the twin and launch nothing; a tensor on another
    device that is not CUDA raises instead of falling back."""
    pos, mass = _scene(300, seed=3)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    calls = pairwise_potential_plain.calls
    launches = pairwise_potential.launches
    got = pairwise_potential(tp, tm, G, EPS)
    assert pairwise_potential_plain.calls == calls + 1
    assert pairwise_potential.launches == launches
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == float(pairwise_potential_plain(tp, tm, G, EPS))
    with pytest.raises(ValueError, match="not supported"):
        pairwise_potential(tp.to("meta"), tm.to("meta"), G, EPS)
