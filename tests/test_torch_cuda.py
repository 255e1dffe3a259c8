"""nbody_tpu_torch CUDA kernels against their plain twins, on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one:
a CUDA kernel has no CPU mode. This file imports nothing of JAX, so it runs
where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest`` because the suite's conftest configures JAX.)
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops.barnes_hut import barnes_hut_forces, bin_particles
from nbody_tpu_torch.ops.direct import direct_forces, direct_forces_kernel
from nbody_tpu_torch.ops.far_taps import far_taps, far_taps_plain
from nbody_tpu_torch.ops.scatter import tile_scatter, tile_scatter_plain
from nbody_tpu_torch.ops.sorted_window import build_sorted_grid
from nbody_tpu_torch.ops.tile_near import (
    tile_sweep_plane,
    tile_sweep_plane_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rel):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(
        got, want, rtol=0, atol=rel * max(float(np.abs(want).max()), 1e-30))


def _sphere(n, radius, seed):
    rng = np.random.default_rng(seed)
    r = np.cbrt(rng.uniform(size=n)) * radius
    v = rng.normal(size=(n, 3))
    pos = v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None]
    return (torch.from_numpy(pos.astype(np.float32)),
            torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))


def test_direct_kernel(dev):
    """K1 vs plain, all pairs and a target subset (atol 1e-5·max|a|)."""
    p, m = (t.to(dev) for t in _sphere(4096, 5.0, seed=1))
    _close(direct_forces_kernel(p, m, 1.0, 0.1), direct_forces(p, m, 1.0, 0.1),
           1e-5)
    tgt = p[:100].contiguous()
    _close(direct_forces_kernel(p, m, 1.0, 0.1, targets=tgt),
           direct_forces(p, m, 1.0, 0.1, targets=tgt), 1e-5)


def test_scatter_kernel(dev):
    """K2 vs plain: slots and counts equal, moments rtol 1e-5 + 1e-6·max."""
    p, m = (t.to(dev) for t in _sphere(20000, 4.0, seed=2))
    lo, cell, coords = bin_particles(p, 4)
    g = build_sorted_grid(p, m, coords, 16)
    tk, mk = tile_scatter(g.psort, g.cell_start, lo, cell, d=16, k=16)
    tp, mp = tile_scatter_plain(g.psort, g.cell_start, lo, cell, d=16, k=16)
    assert torch.equal(tk, tp)
    assert torch.equal(mk[10], mp[10])
    tol = 1e-5 * mp.abs() + 1e-6 * mp.abs().amax(dim=1, keepdim=True)
    assert bool(((mk - mp).abs() <= tol).all())


@pytest.mark.parametrize("p", [1, 4, 16])
def test_far_taps_kernel(dev, p):
    """K3 vs plain (FP32 matmuls, TF32 off): atol 2e-5·max|out|."""
    rng = np.random.default_rng(p)
    mom = torch.from_numpy(rng.normal(size=(80, p ** 3)).astype(np.float32))
    taps = torch.from_numpy(
        rng.normal(size=(27, 152, 80)).astype(np.float32))
    mom, taps = mom.to(dev), taps.to(dev)
    _close(far_taps(mom, taps, p=p, ws=1),
           far_taps_plain(mom, taps, p=p, ws=1), 2e-5)


@pytest.mark.parametrize("cutoff2", [None, 1.5], ids=["far", "cutoff"])
def test_tile_near_kernel(dev, cutoff2):
    """K4 vs plain with counts (and a far seed or the cutoff predicate):
    atol 2e-5·max|out|."""
    d, k = 16, 8
    rng = np.random.default_rng(14)
    pos = rng.uniform(0.0, 8.0, (d, 3, k, d * d))
    mass = rng.uniform(0.0, 1.0, (d, 1, k, d * d))
    tiles = torch.from_numpy(
        np.concatenate([pos, mass], 1).astype(np.float32)).to(dev)
    counts = torch.from_numpy(
        rng.integers(0, 10, d ** 3).astype(np.float32)).to(dev)
    kw = dict(k=k, d=d, ws=1, eps=0.1, counts=counts, cutoff2=cutoff2)
    if cutoff2 is None:
        kw.update(
            far_plane=torch.from_numpy(rng.normal(size=(d, 19, d * d)).astype(
                np.float32)).to(dev),
            lo=torch.zeros(3, device=dev), cell=torch.tensor(0.5, device=dev))
    _close(tile_sweep_plane(tiles, **kw), tile_sweep_plane_plain(tiles, **kw),
           2e-5)


def test_barnes_hut_card_matches_cpu(dev):
    """The whole BH force on the card (kernels) vs on the CPU (plain
    twins), same inputs: atol 2e-5·max|a| on rows within the slot cap."""
    p, m = _sphere(20000, 6.0, seed=3)
    before = tile_sweep_plane.launches
    got = barnes_hut_forces(p.to(dev), m.to(dev), levels=4, near_k=16)
    assert tile_sweep_plane.launches == before + 1
    _close(got, barnes_hut_forces(p, m, levels=4, near_k=16), 2e-5)
