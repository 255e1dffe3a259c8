"""The all-pairs potential (kernel K5's plain twin) against the JAX
package's Pallas kernel in interpret mode and its float64 blocked sum,
and K5's walk over tile pairs (``pair_tile_schedule``, the plain mirror
of the kernel's index arithmetic): each unordered tile pair once, and a
float64 sum along that walk equal to the twin (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops.direct import pairwise_potential_pallas
from nbody_tpu.ops.integrator import potential_energy as jax_pe
from nbody_tpu_torch.ops import direct
from nbody_tpu_torch.ops.direct import (
    PE_TILE,
    pair_tile_schedule,
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


T = PE_TILE


@pytest.mark.parametrize("n", [0, 1, 2, T - 1, T, T + 1, 3 * T + 5,
                               5 * T - 3])
def test_tile_schedule_covers_each_unordered_pair_once(n):
    """The main form's walk, cut into runs of 1, 2, 3 and 8 tile pairs a
    block: every block but the last takes a full run, and the blocks
    together take each unordered tile pair (I ≤ J) exactly once, the
    diagonal ones (I == J) marked (5T − 3 rows: an odd tile count)."""
    nt = -(-n // T)
    want = {(i, j) for i in range(nt) for j in range(i, nt)}
    for run in (1, 2, 3, 8):
        blocks = pair_tile_schedule(n, T, run)
        assert all(len(b) == run for b in blocks[:-1])
        got = [(i, j) for b in blocks for i, j, _ in b]
        assert len(got) == len(set(got)) and set(got) == want, run
        assert all(d == (i == j) for b in blocks for i, j, d in b)


@pytest.mark.parametrize("n, ns", [(1, 1), (T + 1, 3 * T + 5),
                                   (5 * T - 3, 2)])
def test_tile_schedule_cross_form_covers_every_pair_once(n, ns):
    """The cross form's walk: every (target tile, source tile) pair once,
    none marked diagonal, whatever the run."""
    want = {(i, j) for i in range(-(-n // T)) for j in range(-(-ns // T))}
    for run in (1, 3, 8):
        got = [(i, j, d) for b in pair_tile_schedule(n, T, run, ns=ns)
               for i, j, d in b]
        assert len(got) == len(want)
        assert {(i, j) for i, j, _ in got} == want
        assert not any(d for _, _, d in got)


def _schedule_walk(pos, mass, tile, run):
    """−G Σ_{i<j} m_i·m_j/√(r² + ε²) along ``pair_tile_schedule``: each
    tile pair's float32 terms (the twin's arithmetic, raw r² == 0
    excluded, a diagonal pair's j > i only) summed in float64."""
    n = pos.shape[0]
    eps2 = EPS * EPS
    total = torch.zeros((), dtype=torch.float64)
    for block in pair_tile_schedule(n, tile, run):
        for i, j, diag in block:
            a = slice(i * tile, min(n, (i + 1) * tile))
            b = slice(j * tile, min(n, (j + 1) * tile))
            d = [pos[b, c][None, :] - pos[a, c][:, None] for c in range(3)]
            r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            e = (mass[a, None] * mass[None, b]) * torch.rsqrt(r2 + eps2)
            e = torch.where(r2 == 0.0, 0.0, e)
            if diag:
                e = torch.triu(e, diagonal=1)
            total = total + e.sum(dtype=torch.float64)
    return float(-G * total)


@pytest.mark.parametrize("n, tile, run", [(700, 64, 5), (600, T, 1)])
def test_schedule_walk_matches_twin_and_jax(n, tile, run):
    """A float64 sum along the walk (rows 0 and 1 coincide, row 2 has no
    mass) equals the twin at relative 1e-9 (the same float32 terms, each
    unordered pair's two terms equal bit for bit, float64 sums in another
    order; the twin returns float32, so the walk is rounded to float32
    first, and 1e-9 of it is below one ulp) and the JAX kernel in
    interpret mode at 1e-6."""
    pos, mass = _scene(n, seed=n + tile)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    got = _schedule_walk(tp, tm, tile, run)
    np.testing.assert_allclose(
        np.float32(got), float(pairwise_potential_plain(tp, tm, G, EPS)),
        rtol=1e-9)
    want_k = float(pairwise_potential_pallas(
        jnp.asarray(pos), jnp.asarray(mass), G, EPS, interpret=True))
    np.testing.assert_allclose(got, want_k, rtol=1e-6)
