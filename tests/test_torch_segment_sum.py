"""The sorted segment sum (kernel K6's plain twin) against the JAX
package's Pallas kernel ``monotone_segment_sum`` in interpret mode (CPU),
in the kernel's own two test cases and with interleaved sentinel rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops.pallas_scatter import monotone_segment_sum
from nbody_tpu_torch.ops.scatter import (
    SENTINEL_DEST,
    segment_sum,
    segment_sum_plain,
)

D = 8
NC = D ** 3


def _rows(n=1500, seed=1, sentinels=0):
    """Cell-sorted ids of a dense ball on a d = 8 grid and their [m, m·x]
    rows; ``sentinels`` rows with ids ≥ 2²⁴ interleaved at random places."""
    rng = np.random.default_rng(seed)
    r = np.cbrt(rng.uniform(size=n)) * 4.0
    v = rng.normal(size=(n, 3))
    pos = v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None]
    c = np.clip(((pos + 4.0) / (8.0 / D)).astype(np.int32), 0, D - 1)
    ids = np.sort((c[:, 0] * D + c[:, 1]) * D + c[:, 2]).astype(np.int32)
    if sentinels:
        at = np.sort(rng.integers(0, n + 1, sentinels))
        ids = np.insert(ids, at, SENTINEL_DEST + rng.integers(
            0, 1000, sentinels)).astype(np.int32)
    m = rng.uniform(0.5, 1.5, ids.shape[0]).astype(np.float32)
    x = rng.normal(size=(ids.shape[0], 3)).astype(np.float32)
    vals = np.concatenate([m[:, None], m[:, None] * x], axis=1)
    return vals.astype(np.float32), ids


def _jax(vals, ids, r, w):
    """The JAX kernel with its chunk source starts found on the monotone
    envelope of the ids (sentinels inherit the last real id)."""
    env = np.maximum.accumulate(np.where(ids < SENTINEL_DEST, ids, -1))
    starts = np.searchsorted(env, np.arange(-(-NC // r)) * r, side="left")
    return np.asarray(monotone_segment_sum(
        jnp.asarray(vals), jnp.asarray(ids),
        jnp.asarray(starts.astype(np.int32)), num_dest=NC, r=r, w=w,
        interpret=True))


@pytest.mark.parametrize(
    "r,w,sentinels",
    [(128, 128, 0), (128, 2048, 0), (128, 128, 40), (128, 2048, 40)],
    ids=["window-loop", "single-window", "window-loop-sentinels",
         "single-window-sentinels"])
def test_plain_matches_jax(r, w, sentinels):
    """rtol 1e-5, atol 1e-5 (the JAX package's own bound: f32 sums in
    another order)."""
    vals, ids = _rows(sentinels=sentinels)
    got = segment_sum_plain(torch.from_numpy(vals), torch.from_numpy(ids),
                            NC).numpy()
    assert got.shape == (4, NC)
    np.testing.assert_allclose(got, _jax(vals, ids, r, w), rtol=1e-5,
                               atol=1e-5)


def test_sentinels_add_nothing():
    """The same rows with and without interleaved sentinels give the same
    sums, bit for bit."""
    vals, ids = _rows(sentinels=60)
    real = ids < SENTINEL_DEST
    with_s = segment_sum_plain(torch.from_numpy(vals), torch.from_numpy(ids),
                               NC)
    without = segment_sum_plain(torch.from_numpy(vals[real]),
                                torch.from_numpy(ids[real]), NC)
    assert torch.equal(with_s, without)


def test_wrapper_takes_the_twin_on_cpu_only():
    vals, ids = _rows(n=300)
    tv, ti = torch.from_numpy(vals), torch.from_numpy(ids)
    calls, launches = segment_sum_plain.calls, segment_sum.launches
    got = segment_sum(tv, ti, NC)
    assert segment_sum_plain.calls == calls + 1
    assert segment_sum.launches == launches
    assert torch.equal(got, segment_sum_plain(tv, ti, NC))
    with pytest.raises(ValueError, match="not supported"):
        segment_sum(tv.to("meta"), ti.to("meta"), NC)
