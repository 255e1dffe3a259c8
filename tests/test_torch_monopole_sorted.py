"""Monopole (order-1) Barnes-Hut in cell-sorted order: nbody_tpu_torch's
``barnes_hut_forces_sorted(multipole_order=1)`` against the JAX package's
sorted call, which runs its segment-sum, scatter and sweep Pallas kernels
in interpret mode (CPU)."""

import jax.numpy as jnp
import numpy as np
import torch

from nbody_tpu.ops import barnes_hut as jbh
from nbody_tpu_torch.ops import barnes_hut as tbh

N, LEVELS, K, G, EPS = 1500, 3, 8, 1.0, 0.1


def test_sorted_matches_jax_sorted():
    """The same order and psort, acc atol 2e-5·max|a| (f32 sums in another
    order). At θ = 1 (ws 1): the interpret-mode sweep at ws 2 takes
    minutes on a CPU; ws 2 is held against the JAX XLA path in
    test_torch_monopole.py, where the port's sorted call equals its
    unsorted one exactly."""
    rng = np.random.default_rng(11)
    r = np.cbrt(rng.uniform(size=N)) * 4.0
    v = rng.normal(size=(N, 3))
    pos = (v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None])
    pos = pos.astype(np.float32)
    mass = rng.uniform(0.5, 1.5, N).astype(np.float32)
    acc_s, psort, order = tbh.barnes_hut_forces_sorted(
        torch.from_numpy(pos), torch.from_numpy(mass), G, EPS, 1.0,
        levels=LEVELS, near_k=K, multipole_order=1)
    ja, jps, jo = jbh.barnes_hut_forces_sorted(
        jnp.asarray(pos), jnp.asarray(mass), G, EPS, 1.0, levels=LEVELS,
        near_k=K, multipole_order=1)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(psort.numpy(), np.asarray(jps))
    ja = np.asarray(ja)
    np.testing.assert_allclose(acc_s.numpy(), ja, rtol=0,
                               atol=2e-5 * float(np.abs(ja).max()))
