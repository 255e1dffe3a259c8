"""nbody_tpu_torch CUDA kernels against their plain twins, on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one:
a CUDA kernel has no CPU mode. This file imports nothing of JAX, so it runs
where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest`` because the suite's conftest configures JAX.)
"""

import ctypes

import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops.barnes_hut import (
    barnes_hut_forces,
    barnes_hut_forces_frozen,
    barnes_hut_forces_sorted,
    bin_particles,
    make_barnes_hut_forces_sorted,
)
from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.ops.direct import (
    direct_forces,
    direct_forces_kernel,
    pairwise_potential,
    pairwise_potential_plain,
)
from nbody_tpu_torch.ops.far_taps import far_taps, far_taps_plain
from nbody_tpu_torch.ops import integrator as tint
from nbody_tpu_torch.ops import table_step as T
from nbody_tpu_torch.ops.forces import make_table_step_params
from nbody_tpu_torch.ops.scatter import (
    SENTINEL_DEST,
    segment_sum,
    segment_sum_plain,
    tile_place,
    tile_place_plain,
    tile_scatter,
    tile_scatter_plain,
)
from nbody_tpu_torch.ops.sort import (
    INT_MAX,
    _plan_words,
    bitonic_argsort,
    bitonic_sort_pairs,
    bitonic_sort_pairs_plain,
    kernel_launches,
)
from nbody_tpu_torch.ops.sorted_window import (
    build_sorted_grid,
    cell_starts_at,
    sorted_ranks,
    xy_ball,
)
from nbody_tpu_torch.ops.spatial_hash import (
    spatial_hash_forces,
    spatial_hash_forces_tiles,
    spatial_hash_forces_tiles_frozen,
    spatial_hash_forces_tiles_sorted,
    tiles_bin,
)
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.types import ForceMethod, SimulationConfig
from nbody_tpu_torch.ops.tile_near import (
    tile_sweep_plane,
    tile_sweep_plane_plain,
)
from nbody_tpu_torch.ops.window_sweep import (
    window_sweep_kernel,
    window_sweep_plain,
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


@pytest.mark.parametrize(
    "case", ["split", "ragged", "eps0", "one-target", "eps1e-13", "eps1e-6"])
def test_direct_kernel_cases(dev, case):
    """K1 vs plain (atol 1e-5·max|a|) and two calls bit-equal: 4096
    targets against 65536 sources (the source axis split over blocks,
    partial sums joined), 5003 rows (no multiple of a tile or of a block's
    targets), ε = 0 with coincident rows (the loop that keeps rsqrtf and
    the r² == 0 select), one target against 65536 sources, and the same
    coincident rows at ε = 1e-13 (below the lean loop's least ε², where
    its self pair's weight would overflow) and at ε = 1e-6 (the least ε
    of the lean loop)."""
    eps, tgt = 0.1, None
    if case == "ragged":
        p, m = _sphere(5003, 5.0, seed=21)
    elif case in ("eps0", "eps1e-13", "eps1e-6"):
        p, m = _sphere(3001, 5.0, seed=22)
        p[1] = p[0]
        p[2000] = p[5]
        eps = {"eps0": 0.0, "eps1e-13": 1e-13, "eps1e-6": 1e-6}[case]
    else:
        p, m = _sphere(65536, 5.0, seed=23)
    p, m = p.to(dev), m.to(dev)
    if case == "split":
        tgt = p[:4096].contiguous()
        rows = _build.library().nbt_direct_forces_range(
            torch.cuda.current_device(), 4096, 65536)
        assert 0 < rows < 65536
    elif case == "one-target":
        tgt = p[7:8].contiguous()
    before = direct_forces_kernel.launches
    got = direct_forces_kernel(p, m, 1.0, eps, targets=tgt)
    assert direct_forces_kernel.launches == before + 1
    assert bool(torch.isfinite(got).all())
    _close(got, direct_forces(p, m, 1.0, eps, targets=tgt), 1e-5)
    assert torch.equal(got, direct_forces_kernel(p, m, 1.0, eps, targets=tgt))


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


_K3_CASES = [(p, ws) for ws in (1, 2) for p in (1, 2, 4, 8, 16, 32)]


def _k3_inputs(p, ws, dev):
    rng = np.random.default_rng(p + 100 * ws)
    mom = torch.from_numpy(rng.normal(size=(80, p ** 3)).astype(np.float32))
    taps = torch.from_numpy(rng.normal(
        size=((2 * ws + 1) ** 3, 152, 80)).astype(np.float32))
    return mom.to(dev), taps.to(dev)


@pytest.mark.parametrize(
    "p,ws", _K3_CASES,
    ids=[f"{p}" if ws == 1 else f"{p}-ws{ws}" for p, ws in _K3_CASES])
def test_far_taps_kernel(dev, p, ws):
    """K3 (3xTF32 on the tensor cores) vs plain (FP32 matmuls, TF32 off):
    atol 2e-5·max|out|, at every level size from p = 1 (only the centre
    tap inside the grid) to 32, with both brick tilings, ws 1 and 2."""
    mom, taps = _k3_inputs(p, ws, dev)
    before = far_taps.launches
    got = far_taps(mom, taps, p=p, ws=ws)
    assert far_taps.launches == before + 1
    _close(got, far_taps_plain(mom, taps, p=p, ws=ws), 2e-5)


@pytest.mark.parametrize("p", [16, 32])
def test_far_taps_kernel_is_deterministic(dev, p):
    """Two K3 calls on the same input give the same bits (no atomics, one
    fixed order of the terms of each output)."""
    mom, taps = _k3_inputs(p, 1, dev)
    assert torch.equal(far_taps(mom, taps, p=p, ws=1),
                       far_taps(mom, taps, p=p, ws=1))


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


# id: (d, k, ws, counts, far channels, cutoff², ε)
_K4_CASES = {
    "ws2": (16, 16, 2, "random", 19, None, 0.1),
    "ws4": (12, 16, 4, "random", 0, None, 0.1),
    "k64-full": (12, 64, 2, "full-core", 0, None, 0.1),
    "d14": (14, 32, 1, "random", 19, None, 0.1),
    "no-counts": (10, 8, 1, None, 9, None, 0.1),
    "eps0-coincident": (12, 16, 1, "random", 0, None, 0.0),
    "cutoff": (16, 16, 1, "random", 0, 1.5, 0.1),
    "far9": (16, 16, 1, "random", 9, None, 0.1),
    "far19": (16, 16, 1, "random", 19, None, 0.1),
}


def _k4_inputs(case, dev):
    d, k, ws, counts_kind, n_far, cutoff2, eps = _K4_CASES[case]
    rng = np.random.default_rng(sorted(_K4_CASES).index(case))
    pos = rng.uniform(0.0, 8.0, (d, 3, k, d * d))
    mass = rng.uniform(0.0, 1.0, (d, 1, k, d * d))
    if case == "eps0-coincident":
        pos[:, :, 1] = pos[:, :, 0]          # two slots of every cell
        pos[1:, :, 2] = pos[:-1, :, 0]       # and a slot of the next x cell
    tiles = np.concatenate([pos, mass], 1).astype(np.float32)
    kw = dict(k=k, d=d, ws=ws, eps=eps, cutoff2=cutoff2)
    if counts_kind is not None:
        counts = rng.integers(0, k + 3, (d, d, d))
        if counts_kind == "full-core":       # every slot live near the centre
            counts[d // 4:3 * d // 4, d // 4:3 * d // 4, d // 4:3 * d // 4] = k
        kw["counts"] = torch.from_numpy(
            counts.reshape(-1).astype(np.float32)).to(dev)
    if n_far:
        kw.update(
            far_plane=torch.from_numpy(rng.normal(
                size=(d, n_far, d * d)).astype(np.float32)).to(dev),
            lo=torch.zeros(3, device=dev), cell=torch.tensor(0.5, device=dev))
    return torch.from_numpy(tiles).to(dev), kw


def _k4_plan(d, k, ws):
    """K4's launch plan from the library: (cells a brick, rows a staged
    chunk, halo columns a group, dynamic shared memory bytes)."""
    lib = _build.library()
    return tuple(lib.nbt_tile_near_plan(d, k, ws, f) for f in range(4))


def _k4_max_halo_rows(counts, d, k, ws):
    """The most live rows of one K4 brick's halo (its (2ws+1)² columns over
    the brick's z-run ± ws), at the kernel's plan."""
    bz = _k4_plan(d, k, ws)[0]
    live = np.pad(np.minimum(counts.reshape(d, d, d), k), ws)
    most = 0
    for x in range(d):
        for y in range(d):
            for z0 in range(0, d, bz):
                most = max(most, int(live[x:x + 2 * ws + 1, y:y + 2 * ws + 1,
                                          z0:min(z0 + bz, d) + 2 * ws].sum()))
    return most


@pytest.mark.parametrize("case", sorted(_K4_CASES))
def test_tile_near_kernel_cases(dev, case):
    """K4 vs plain (atol 2e-5·max|out|) and two calls bit-equal: ws 2 and
    4 (125 and 729 cells), k 64 with every slot live in a core whose
    bricks' halos exceed one shared-memory chunk, d 14 (no power of two;
    at k 32 the bricks do not divide it, so each column ends in a short
    brick),
    no counts, ε = 0 with coincident rows (the loop that keeps rsqrtf and
    the r² test), the cutoff form, far planes of 9 and 19 channels."""
    tiles, kw = _k4_inputs(case, dev)
    if case == "k64-full":
        d, k, ws = kw["d"], kw["k"], kw["ws"]
        rows_cap = _k4_plan(d, k, ws)[1]
        assert _k4_max_halo_rows(kw["counts"].cpu().numpy(), d, k,
                                 ws) > rows_cap
    before = tile_sweep_plane.launches
    got = tile_sweep_plane(tiles, **kw)
    assert tile_sweep_plane.launches == before + 1
    assert bool(torch.isfinite(got).all())
    _close(got, tile_sweep_plane_plain(tiles, **kw), 2e-5)
    assert torch.equal(got, tile_sweep_plane(tiles, **kw))


@pytest.mark.parametrize("eps", [1e-13, 1e-6])
def test_tile_near_kernel_small_eps(dev, eps):
    """K4 on the coincident rows of case eps0-coincident at ε = 1e-13
    (below the lean loop's least ε², where a coincident pair's weight
    would overflow) and at ε = 1e-6 (the least ε of the lean loop):
    finite, vs plain atol 2e-5·max|out|, two calls bit-equal."""
    tiles, kw = _k4_inputs("eps0-coincident", dev)
    kw["eps"] = eps
    got = tile_sweep_plane(tiles, **kw)
    assert bool(torch.isfinite(got).all())
    _close(got, tile_sweep_plane_plain(tiles, **kw), 2e-5)
    assert torch.equal(got, tile_sweep_plane(tiles, **kw))


@pytest.mark.parametrize("k", [1, 8, 16, 64])
def test_tile_near_plan_fits_the_kernel(dev, k):
    """K4's launch plan is one the kernel takes (bricks of 1-32 cells, at
    least one staged row and halo column a chunk, at most 200 KB of
    dynamic shared memory) for every d and every ws up to 16, the most
    ``theta_to_ws`` gives, so no shape the sweep ran before is refused;
    and the bricks hold 128·ws² slots where the grid allows."""
    for d in (1, 2, 14, 56, 64):
        for ws in range(0, 17):
            bz, rows_cap, group_cols, smem = _k4_plan(d, k, ws)
            ws = min(ws, d - 1)
            assert 1 <= bz <= min(32, d)
            assert rows_cap >= 1 and group_cols >= 1
            assert smem <= 200 * 1024, (d, ws, smem)
            if ws >= 1 and 128 // k * ws * ws <= min(32, d):
                assert bz == 128 // k * ws * ws


def test_barnes_hut_card_matches_cpu(dev):
    """The whole BH force on the card (kernels) vs on the CPU (plain
    twins), same inputs: atol 2e-5·max|a| on rows within the slot cap."""
    p, m = _sphere(20000, 6.0, seed=3)
    before = tile_sweep_plane.launches
    got = barnes_hut_forces(p.to(dev), m.to(dev), levels=4, near_k=16)
    assert tile_sweep_plane.launches == before + 1
    _close(got, barnes_hut_forces(p, m, levels=4, near_k=16), 2e-5)


@pytest.mark.parametrize(
    "form,window,ws,eps",
    [("hash", 2048, 1, 0.1), ("bh", 2048, 1, 0.1), ("hash", 64, 1, 0.1),
     ("bh", 2048, 4, 0.1), ("bh", 2048, 16, 0.1), ("bh", 2048, 1, 0.0),
     ("hash", 2048, 1, 0.0), ("bh", 2048, 1, 1e-13),
     ("bh", 2048, 1, 1e-6)],
    ids=["hash", "bh", "overflow", "bh-ws4", "bh-ws16", "bh-eps0",
         "hash-eps0", "bh-eps1e-13", "bh-eps1e-6"])
def test_window_sweep_kernel(dev, form, window, ws, eps):
    """K7 vs plain on a 20000-row ball (d 16): the hash form (cutoff 1.0,
    B 256), the BH form (no cutoff, ws 1), a too-small window, the BH
    form at ws 4 (81 offsets) and ws 16 (1089, the widest ``theta_to_ws``
    gives), ε = 0 in both forms (the pair loop that keeps the r² > 0
    test and rsqrtf), and the BH form at ε = 1e-13 (below the lean loop's
    least ε², where each target's own weight would overflow) and 1e-6
    (the least ε of the lean loop): atol 2e-5·max|a| and the same
    overflow count."""
    p, m = (t.to(dev) for t in _sphere(20000, 4.0, seed=4))
    coords = bin_particles(p, 4)[2]
    g = build_sorted_grid(p, m, coords, 16, with_csort=True)
    kw = dict(d=16, offsets=xy_ball(ws), z_hw=ws, window=window,
              block_size=256, eps=eps,
              cutoff2=None if form == "bh" else 1.0)
    args = (g.psort, g.csort, g.cell_start)
    before = window_sweep_kernel.launches
    got, over = window_sweep_kernel(*args, **kw)
    assert window_sweep_kernel.launches == before + 1
    want, over_p = window_sweep_plain(*args, **kw)
    assert int(over) == int(over_p)
    if ws == 1:
        assert (int(over) > 0) == (window == 64)
    assert bool(torch.isfinite(got).all())
    _close(got, want, 2e-5)


def _k7_scene(scene, dev):
    """(sorted grid, d, block size) of a card test scene for K7 on unit
    cells at the origin."""
    rng = np.random.default_rng(14)
    d, b = 8, 256
    if scene == "big-cell":      # one cell of 600 rows, more than a block
        pos = np.concatenate([rng.uniform(3.0, 4.0, (600, 3)),
                              rng.uniform(0.0, d, (3000, 3))])
    elif scene == "small-n":     # n < B: one block of n threads
        pos = rng.uniform(2.0, 6.0, (100, 3))
    elif scene == "ragged":      # n not a multiple of B
        pos = rng.uniform(1.0, 7.0, (4000 + 77, 3))
    else:                        # "edge": a cube filling the grid
        d, b = 4, 128
        pos = rng.uniform(0.0, d, (3000, 3))
    pos = torch.from_numpy(pos.astype(np.float32)).to(dev)
    mass = torch.from_numpy(
        rng.uniform(0.5, 1.5, pos.shape[0]).astype(np.float32)).to(dev)
    coords = torch.clamp(pos.floor().to(torch.int32), 0, d - 1)
    return build_sorted_grid(pos, mass, coords, d, with_csort=True), d, b


def _k7_kw(form, d, b, window):
    return dict(d=d, offsets=xy_ball(1), z_hw=1, window=window,
                block_size=b, eps=0.1,
                cutoff2=1.0 if form == "hash" else None)


@pytest.mark.parametrize("window", [2048, 64], ids=["W2048", "W64"])
@pytest.mark.parametrize("form", ["hash", "bh"])
@pytest.mark.parametrize("scene", ["big-cell", "small-n", "ragged", "edge"])
def test_window_sweep_kernel_cells(dev, scene, form, window):
    """K7 vs plain where the per-cell spans have edges: a cell longer than
    the block, n < B, n not a multiple of B, a grid-filling cube whose
    edge offsets would wrap, each with W 2048 and with an overflowing
    W 64, in the hash form (cutoff 1.0) and the BH form: atol
    2e-5·max|a| and the same overflow count."""
    g, d, b = _k7_scene(scene, dev)
    kw = _k7_kw(form, d, b, window)
    args = (g.psort, g.csort, g.cell_start)
    got, over = window_sweep_kernel(*args, **kw)
    want, over_p = window_sweep_plain(*args, **kw)
    assert int(over) == int(over_p)
    if window == 64:
        assert int(over) > 0
    _close(got, want, 2e-5)


@pytest.mark.parametrize("form", ["hash", "bh"])
def test_window_sweep_kernel_is_deterministic(dev, form):
    """Two K7 calls give bit-identical forces and overflow (no float
    atomics: each target sums its spans in order)."""
    p, m = (t.to(dev) for t in _sphere(20000, 4.0, seed=4))
    g = build_sorted_grid(p, m, bin_particles(p, 4)[2], 16, with_csort=True)
    kw = _k7_kw(form, 16, 256, 2048)
    args = (g.psort, g.csort, g.cell_start)
    a1, o1 = window_sweep_kernel(*args, **kw)
    a2, o2 = window_sweep_kernel(*args, **kw)
    assert torch.equal(a1, a2) and int(o1) == int(o2)


@pytest.mark.parametrize("engine", ["window", "tiles"])
def test_spatial_hash_card_matches_cpu(dev, engine):
    """The hash on the card (K7, or K2 + K4) vs on the CPU (plain twins),
    same inputs: atol 2e-5·max|a|, equal overflow."""
    p, m = _sphere(20000, 6.0, seed=5)
    if engine == "window":
        fn, kw = spatial_hash_forces, dict(cap=64, window=2048,
                                           block_size=256)
    else:
        fn, kw = spatial_hash_forces_tiles, dict(d=16, k=32)
    kw.update(cutoff=1.0, cell_size=1.0, return_overflow=True)
    got, over = fn(p.to(dev), m.to(dev), 1.0, 0.1, **kw)
    want, over_c = fn(p, m, 1.0, 0.1, **kw)
    assert int(over) == int(over_c)
    _close(got, want, 2e-5)


def test_barnes_hut_window_card_matches_cpu(dev):
    """BH with the window near engine (levels 3, occupancy 39) on the card
    vs on the CPU: atol 2e-5·max|a|."""
    p, m = _sphere(20000, 6.0, seed=6)
    kw = dict(levels=3, near_engine="window", window=2048)
    before = window_sweep_kernel.launches
    got = barnes_hut_forces(p.to(dev), m.to(dev), **kw)
    assert window_sweep_kernel.launches == before + 1
    _close(got, barnes_hut_forces(p, m, **kw), 2e-5)


def test_pair_potential_kernel(dev):
    """K5 vs plain at N = 20000 with a coincident pair and a zero-mass
    row: relative 1e-5 (rsqrtf and torch.rsqrt differ by ulps per term;
    the sums are float64 in both)."""
    p, m = _sphere(20000, 5.0, seed=7)
    p[1] = p[0]
    m[2] = 0.0
    p, m = p.to(dev), m.to(dev)
    before = pairwise_potential.launches
    got = float(pairwise_potential(p, m, 1.0, 0.1))
    assert pairwise_potential.launches == before + 1
    np.testing.assert_allclose(
        got, float(pairwise_potential_plain(p, m, 1.0, 0.1)), rtol=1e-5)


def test_segment_sum_kernel(dev):
    """K6 vs plain on sorted ids with interleaved sentinel rows and
    without: max|diff| <= 1e-6·max|out|."""
    rng = np.random.default_rng(8)
    n, nd = 50000, 4096
    ids = np.sort(rng.integers(0, nd, n)).astype(np.int32)
    at = np.sort(rng.integers(0, n + 1, 500))
    ids_s = np.insert(ids, at, SENTINEL_DEST + rng.integers(0, 9, 500))
    for dest in (ids_s.astype(np.int32), ids):
        vals = torch.from_numpy(
            rng.normal(size=(dest.shape[0], 4)).astype(np.float32)).to(dev)
        d = torch.from_numpy(dest).to(dev)
        before = segment_sum.launches
        got = segment_sum(vals, d, nd)
        assert segment_sum.launches == before + 1
        _close(got, segment_sum_plain(vals, d, nd), 1e-6)


def _k6_case(case, rng):
    """(vals (N, C) float32, dest (N,) int32, num_dest) of a K6 card case;
    the kernel reduces chunks of ``ch`` rows, as its library reports."""
    ch = _build.library().nbt_segment_sum_chunk_rows()
    c, nd = 4, 4096
    if case == "long-segment":   # one segment over ~120 chunks
        ids = np.concatenate([np.sort(rng.integers(0, 100, 3000)),
                              np.full(123_457, 100),
                              np.sort(rng.integers(101, nd, 5000))])
    elif case == "sentinel-runs":  # sentinel runs across chunk ends
        ids = np.sort(rng.integers(0, nd, 20 * ch)).astype(np.int64)
        for at in (ch - 300, 3 * ch - 5, 6 * ch, 9 * ch + 700):
            ids[at:at + 2 * ch + 50] = SENTINEL_DEST + 7
        ids[:40] = SENTINEL_DEST     # leading sentinels
        ids[-200:] = SENTINEL_DEST + 1  # trailing sentinels
    elif case == "all-sentinel":
        ids = SENTINEL_DEST + rng.integers(0, 9, 5 * ch + 3)
    else:                        # "C1", "C15": n not a multiple of ch
        c = int(case[1:])
        ids = np.sort(rng.integers(-5, nd + 5, 7 * ch + 333))
    vals = rng.uniform(0.5, 1.5, (ids.shape[0], c)).astype(np.float32)
    return vals, ids.astype(np.int32), nd


@pytest.mark.parametrize(
    "case", ["long-segment", "sentinel-runs", "all-sentinel", "C1", "C15"])
def test_segment_sum_kernel_cases(dev, case):
    """K6 vs its plain twin where the row-parallel design has edges: a
    segment of 123457 rows across ~120 chunks, sentinel runs longer than
    a chunk across chunk ends (and at both ends), every row a sentinel,
    C = 1 and C = 15 with ids outside [0, num_dest) and n not a multiple
    of the chunk: max|diff| <= 1e-6·max|out|. The twin runs on float64
    copies of the inputs: in float32 its ``index_add_`` sums the long
    segment one row at a time, ~2e-5 off by itself."""
    vals, ids, nd = _k6_case(case, np.random.default_rng(15))
    v = torch.from_numpy(vals).to(dev)
    d = torch.from_numpy(ids).to(dev)
    got = segment_sum(v, d, nd)
    want = segment_sum_plain(v.double(), d, nd)
    assert got.shape == (vals.shape[1], nd)
    if case == "all-sentinel":
        assert not bool(got.any())
    _close(got.double(), want, 1e-6)


@pytest.mark.parametrize("c", [4, 15])
def test_segment_sum_kernel_is_deterministic(dev, c):
    """Two K6 calls give bit-identical sums (no float atomics)."""
    rng = np.random.default_rng(16)
    ids = np.sort(rng.integers(0, 1 << 15, 300_000)).astype(np.int32)
    v = torch.from_numpy(
        rng.normal(size=(ids.shape[0], c)).astype(np.float32)).to(dev)
    d = torch.from_numpy(ids).to(dev)
    assert torch.equal(segment_sum(v, d, 1 << 15), segment_sum(v, d, 1 << 15))


def test_k5_k6_raise_without_their_build(dev, monkeypatch):
    """A CUDA tensor never reaches the plain twin: with the kernel library
    unavailable both wrappers raise."""
    def missing():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "library", missing)
    p, m = (t.to(dev) for t in _sphere(1000, 5.0, seed=9))
    calls = (pairwise_potential_plain.calls, segment_sum_plain.calls)
    with pytest.raises(RuntimeError, match="nvcc"):
        pairwise_potential(p, m, 1.0, 0.1)
    ids = torch.zeros(1000, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="nvcc"):
        segment_sum(p.contiguous(), ids, 8)
    assert (pairwise_potential_plain.calls, segment_sum_plain.calls) == calls


@pytest.mark.parametrize("engine", ["tiles", "window"])
def test_monopole_card_matches_cpu(dev, engine):
    """Monopole Barnes-Hut (levels 4, ws 2) on the card (K6 + K2 + K4, or
    K7) vs on the CPU (plain twins), same inputs: atol 2e-5·max|a|."""
    p, m = _sphere(20000, 6.0, seed=10)
    kw = dict(levels=4, near_k=16, near_engine=engine, multipole_order=1)
    before = segment_sum.launches
    got = barnes_hut_forces(p.to(dev), m.to(dev), **kw)
    assert segment_sum.launches == before + (engine == "tiles")
    _close(got, barnes_hut_forces(p, m, **kw), 2e-5)


@pytest.mark.parametrize(
    "n,hi", [(1000, 5000), (2049, 7), (100_000, 1 << 18), (1 << 17, 50),
             (8191, 1000), (8192, 30), (8193, 1000), ((1 << 14) + 1, 1000),
             ((1 << 15) + 1, 9), ((1 << 16) + 5, 1 << 20), ((1 << 17) + 3, 50)],
    ids=["1000", "2049_ties", "100000", "131072_ties", "tile-1", "tile",
         "tile+1", "2^14+1", "group3_2^15+1", "group4_2^16+5", "2^17+3"])
def test_bitonic_sort_kernel(dev, n, hi):
    """K8 vs its plain twin, keys and values bit for bit, and a sorting
    permutation: one tile (with and without pads), the 2¹³ tile ± 1, the
    first stages above it (device-memory groups of 1, 3 and 4 passes) and
    2¹⁷ + 3 (a stage of a full group and a group of one)."""
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(0, hi, n).astype(np.int32)).to(dev)
    vals = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(
            np.int32)).to(dev)
    before = bitonic_sort_pairs.launches
    got = bitonic_sort_pairs(keys, vals)
    assert bitonic_sort_pairs.launches == before + 1
    want = bitonic_sort_pairs_plain(keys, vals)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ks, perm = bitonic_argsort(keys)
    assert torch.equal(ks, torch.sort(keys).values)
    assert torch.equal(keys[perm.long()], ks)
    assert torch.equal(torch.sort(perm).values,
                       torch.arange(n, dtype=torch.int32, device=dev))


def test_bitonic_sort_int_max_keys(dev):
    """Keys equal to INT_MAX beside pads, in one tile and above it: still a
    sorting permutation, and equal to the twin."""
    rng = np.random.default_rng(11)
    for n in (3000, 20000):
        keys = rng.integers(0, 10, n).astype(np.int32)
        keys[rng.choice(n, n // 30, replace=False)] = INT_MAX
        keys = torch.from_numpy(keys).to(dev)
        ks, perm = bitonic_argsort(keys)
        rows = torch.arange(n, dtype=torch.int32, device=dev)
        want = bitonic_sort_pairs_plain(keys, rows)
        assert torch.equal(ks, want[0]) and torch.equal(perm, want[1])
        assert torch.equal(torch.sort(perm).values, rows)


def _sort_kernels(fn) -> int:
    """The K8 kernels (``bitonic_*`` in csrc/bitonic_sort.cu) one call of
    ``fn`` queues, counted by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if "bitonic_" in e.key and e.device_time_total > 0)


@pytest.mark.parametrize("n", [1_000_000, (1 << 17) + 3],
                         ids=["1M", "2^17+3"])
def test_bitonic_sort_queues_its_launch_plan(dev, n):
    """The kernels one sort queues, counted on the card, are
    ``kernel_launches(n)``: 18 at 1M."""
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(
        rng.integers(0, 1 << 18, n).astype(np.int32)).to(dev)
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    assert _sort_kernels(
        lambda: bitonic_sort_pairs(keys, vals)) == kernel_launches(n)


def test_bitonic_sort_refuses_a_plan_off_the_network(dev):
    """The entry point runs only a plan whose launches chain into the
    canonical pass sequence: one without the device-memory pass of stage
    14 is refused."""
    n, m = 1 << 14, 14
    keys = torch.arange(n, 0, -1, dtype=torch.int32, device=dev)
    work = torch.empty((2 << m,), dtype=torch.int32, device=dev)
    out = torch.empty((2, n), dtype=torch.int32, device=dev)
    words, count = _plan_words(m)
    assert count == 3   # tile sort, the group of pass (14, 13), the merge
    bad = (ctypes.c_int * 8)(*words[:4], *words[8:])
    with pytest.raises(RuntimeError, match="nbt_bitonic_sort"):
        _build.launch("nbt_bitonic_sort", dev, keys.data_ptr(),
                      keys.data_ptr(), n, m, ctypes.addressof(bad), 2,
                      work.data_ptr(), out[0].data_ptr(), out[1].data_ptr())


@pytest.mark.parametrize("engine", ["bh", "hash"])
def test_frozen_fresh_meta_is_the_sorted_step_on_card(dev, engine):
    """On the card: frozen(psort, fresh meta) equals the sorted step bit
    for bit (BH levels 4, k 16; hash tiles d 16, k 32, cell 1.0), its
    audit reads 0, and after a move the audit equals a host recount."""
    p, m = (t.to(dev) for t in _sphere(20000, 6.0, seed=12))
    if engine == "bh":
        kw = dict(levels=4, near_k=16)
        acc, psort, _o, meta = barnes_hut_forces_sorted(
            p, m, with_grid_meta=True, **kw)

        def frozen(q):
            return barnes_hut_forces_frozen(q, meta, with_audit=True, **kw)

        def bins(x):
            return x.to(torch.int32)
        d = 16
    else:
        kw = dict(cutoff=1.0, cell_size=1.0, d=16, k=32)
        acc, psort, _o, meta = spatial_hash_forces_tiles_sorted(
            p, m, with_grid_meta=True, **kw)

        def frozen(q):
            return spatial_hash_forces_tiles_frozen(q, meta, with_audit=True,
                                                    **kw)

        def bins(x):
            return torch.floor(x).to(torch.int32)
        d = 16
    acc_f, stale = frozen(psort)
    assert torch.equal(acc_f, acc) and int(stale) == 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    moved = psort.clone()
    moved[:, :3] += 0.05 * torch.randn(moved.shape[0], 3, device=dev,
                                       generator=gen)
    _, stale = frozen(moved)
    c = torch.clamp(bins((moved[:, :3].cpu() - meta.lo.cpu())
                         / meta.cell.cpu()), 0, d - 1)
    ids = (c[:, 0] * d + c[:, 1]) * d + c[:, 2]
    recount = int((ids != meta.ids.cpu()).sum())
    assert int(stale) == recount > 0


def _k2_scene(form, dev):
    """The 1M shapes of K2's table forms, cell-sorted: Barnes-Hut tiles
    (the radius-10 sphere at d 64, k 16) or the sparse hash (the uniform
    cube of side 100, cell 2.0, d 56, k 16)."""
    if form == "bh":
        p, m = (t.to(dev) for t in _sphere(1_000_000, 10.0, seed=21))
        lo, cell, coords = bin_particles(p, 6)
        d = 64
    else:
        rng = np.random.default_rng(22)
        p = torch.from_numpy(rng.uniform(-50.0, 50.0, (1_000_000, 3)).astype(
            np.float32)).to(dev)
        m = torch.ones(1_000_000, device=dev)
        d = 56
        lo, coords = tiles_bin(p, 2.0, d)
        cell = torch.full((), 2.0, device=dev)
    return build_sorted_grid(p, m, coords, d), lo, cell, d, 16


def _assert_slots(tiles, want, placed, cube):
    """Placed slots bit-equal; filler slots (cell centres) within
    1e-6·cube."""
    p4 = placed[:, None].expand_as(tiles)
    assert torch.equal(tiles[p4], want[p4])
    assert float((tiles[~p4] - want[~p4]).abs().max()) <= 1e-6 * cube


@pytest.mark.parametrize("form", ["bh", "hash"])
def test_scatter_table_forms_kernel(dev, form):
    """K2's table forms at the 1M shapes against their twins: the rank form
    with coverage and 3 extra channels (coverage and extra planes
    bit-equal, counts equal, moments as test_scatter_kernel's), and the
    dest form on a repair-sized mover set (32768 rows each sent one cell
    up in x, ranked above the target's high-water mark, so arrivals to
    full cells are denied), moved inside the rank form's table: coverage,
    extra planes, high-water marks and row bookkeeping equal, placed slots
    bit-equal, filler within 1e-6·cube."""
    g, lo, cell, d, k = _k2_scene(form, dev)
    n, nc = g.psort.shape[0], d ** 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ex = torch.randn(n, 3, generator=gen, device=dev)
    args = (g.psort, g.cell_start, lo, cell)
    before = tile_scatter.launches
    tk, mk, ck, xk = tile_scatter(*args, d=d, k=k, with_coverage=True,
                                  extra=ex)
    assert tile_scatter.launches == before + 1
    tp, mp, cp, xp = tile_scatter_plain(*args, d=d, k=k, with_coverage=True,
                                        extra=ex)
    assert torch.equal(ck, cp) and torch.equal(xk, xp)
    assert torch.equal(mk[10], mp[10])
    tol = 1e-5 * mp.abs() + 1e-6 * mp.abs().amax(dim=1, keepdim=True)
    assert bool(((mk - mp).abs() <= tol).all())
    cube = float(cell) * d
    _assert_slots(tk, tp, ck[:, 0] > 0, cube)

    m = 32768
    src, dest, fits = _mover_set(ck, mk[10], d, k, m, gen)
    assert bool(fits.any()) and bool((~fits).any())
    got, want = _place_both(tk, ck, xk, mk[10], src, dest, lo, cell, d, k)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    assert int(got[1].sum()) == int(ck.sum())
    _assert_slots(got[0], want[0], got[1][:, 0] > 0, cube)


def _mover_set(cov, counts, d, k, m, gen):
    """m occupied slots (plane order) of a fresh table, each sent one cell
    up in x (clamped) and ranked above the target's high-water mark, as
    ``table_step._repair_step`` places movers → (src, dest, fits)."""
    occ = torch.nonzero(cov.reshape(-1))[:, 0]
    src = occ[torch.randperm(occ.numel(), generator=gen,
                             device=occ.device)[:m]]
    d2 = d * d
    cell = (src // (k * d2)) * d2 + src % d2
    tgt = torch.clamp(cell + d2, max=d ** 3 - 1).to(torch.int32)
    ordm = torch.argsort(tgt, stable=True)
    src, tgt = src[ordm], tgt[ordm]
    slot = torch.clamp(counts, max=k).to(torch.int32)[tgt.long()] + (
        sorted_ranks(tgt))
    fits = slot < k
    dest = torch.where(fits, tgt * k + slot, SENTINEL_DEST).to(torch.int32)
    return src.to(torch.int32), dest, fits


def _place_both(tiles, cov, ext, counts, src, dest, lo, cell, d, k):
    """K2's dest form and its twin on copies of one table, with a row
    bookkeeping of its occupied slots → (kernel's, twin's) tensors."""
    d2 = d * d
    occ = torch.nonzero(cov.reshape(-1))[:, 0]
    ids = ((occ // (k * d2)) * d2 + occ % d2) * k + (occ // d2) % k
    slot_row = torch.full((d ** 3 * k,), -1, dtype=torch.int32,
                          device=cov.device)
    slot_row[ids] = torch.arange(occ.numel(), dtype=torch.int32,
                                 device=cov.device)
    out = []
    for fn in (tile_place, tile_place_plain):
        t = (tiles.clone(), cov.clone(), ext.clone(),
             torch.clamp(counts, max=k), slot_row.clone(),
             ids.to(torch.int32))
        before = tile_place.launches
        fn(*t, src, dest, lo, cell, d=d, k=k)
        assert tile_place.launches == before + (fn is tile_place)
        out.append(t)
    return out


def test_scatter_table_form_arity_and_empty_place(dev):
    """The rank form has the main form and the table form (coverage and 3
    extra channels) only; any other request raises before a launch. The
    dest form with no movers changes nothing."""
    p, m = (t.to(dev) for t in _sphere(20000, 4.0, seed=5))
    lo, cell, coords = bin_particles(p, 4)
    g = build_sorted_grid(p, m, coords, 16)
    args = (g.psort, g.cell_start, lo, cell)
    before = tile_scatter.launches
    for kw in (dict(with_coverage=True),
               dict(extra=torch.ones(20000, 3, device=dev)),
               dict(with_coverage=True,
                    extra=torch.ones(20000, 5, device=dev))):
        with pytest.raises(ValueError, match="table form"):
            tile_scatter(*args, d=16, k=16, **kw)
    assert tile_scatter.launches == before
    ex = torch.randn(20000, 3, device=dev)
    tiles, mom, cov, ext = tile_scatter(*args, d=16, k=16,
                                        with_coverage=True, extra=ex)
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    got, _ = _place_both(tiles, cov, ext, mom[10], none, none, lo, cell, 16,
                         16)
    assert all(torch.equal(a, b) for a, b in
               zip(got[:3], (tiles, cov, ext)))


@pytest.mark.parametrize("mode", ["bh", "hash"])
def test_table_drift_and_kick_kernels(dev, mode):
    """``table_drift`` (with and without the audit) and ``table_kick`` at
    the 1M table shapes against their plain twins, bit for bit: the
    drifted tables, the mover ids under each engine's binning and the
    stale count, then the kicked tables; rows are moved far enough that a
    few percent change cell."""
    g, lo, cell, d, k = _k2_scene(mode, dev)
    n = g.psort.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    tiles, _, cov, vel = tile_scatter(
        g.psort, g.cell_start, lo, cell, d=d, k=k, with_coverage=True,
        extra=torch.randn(n, 3, generator=gen, device=dev) * 20.0)
    acc = torch.randn(vel.shape, generator=gen, device=dev) * cov
    tp = (T.bh_table_params(levels=6, near_k=16) if mode == "bh" else
          T.hash_table_params(cutoff=2.0, cell_size=2.0, d=56, k=16))
    for audit in (False, True):
        before = T.table_drift.launches
        got = T.table_drift(tiles, vel, acc, cov, lo, cell, 1e-3, tp, audit)
        assert T.table_drift.launches == before + 1
        want = T.table_drift_plain(tiles, vel, acc, cov, lo, cell, 1e-3, tp,
                                   audit)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
    assert 0 < int(got[3]) < n // 2
    raw = torch.randn(vel.shape, generator=gen, device=dev)
    ka = T.table_kick(raw.clone(), cov, got[1].clone(), 2.0, 1e-3)
    kb = T.table_kick_plain(raw.clone(), cov, got[1].clone(), 2.0, 1e-3)
    assert torch.equal(ka[0], kb[0]) and torch.equal(ka[1], kb[1])


def _table_case(dev, vel_scale, cube=False):
    """N = 65536 on the radius-6 sphere (masses 0.5-1.5), or with ``cube``
    the uniform cube of side 12 (16 rows a cell on average, so none past
    k), Barnes-Hut at levels 4 (d 16, k 40: the fused tiles engine),
    velocities ``vel_scale``·N(0, 1): the config's row-space sorted
    engine, its table parameters on the card and the state with a(t)."""
    n = 65536
    cfg = SimulationConfig(particle_count=n, force_method=ForceMethod.BARNES_HUT,
                           bh_max_level=4, dt=1e-3)
    p, m = (t.to(dev) for t in _sphere(n, 6.0, seed=31))
    rng = np.random.default_rng(32)
    if cube:
        p = torch.from_numpy(rng.uniform(-6.0, 6.0, (n, 3)).astype(
            np.float32)).to(dev)
    vel = torch.from_numpy((vel_scale * rng.normal(size=(n, 3))).astype(
        np.float32)).to(dev)
    sf = make_barnes_hut_forces_sorted(cfg)
    tp = make_table_step_params(cfg, device=dev)
    assert tp is not None and (tp.d, tp.k) == (16, 40)
    acc_s, _, order = sf(p, m)
    acc = torch.empty_like(acc_s)
    acc[order] = acc_s
    return sf, tp, ParticleState(pos=p, vel=vel, acc=acc, mass=m,
                                 time=torch.zeros((), device=dev))


def _near(a, b, rel):
    return float((a - b).abs().max()) <= rel * float(b.abs().max())


def _replay(sf, st, resorted, dt=1e-3):
    """The row-space steps on a given schedule (the first step and those
    flagged sort; the others frozen on the last sort's cells)."""
    r, (meta,) = tint._sorted_step(tint._rows_from(st), sf.with_meta, dt)
    for resort in resorted:
        if resort:
            r, (meta,) = tint._sorted_step(r, sf.with_meta, dt)
        else:
            r, _ = tint._frozen_step(r, sf.frozen, meta, dt)
    return tint._state_from(r)


def test_table_drivers_on_card_match_row_space(dev):
    """The three table drivers on the card at N = 65536 against the
    row-space drivers: the fixed cadence (4, 9 steps) against
    ``make_resort_multi_step`` and the adaptive driver (0.01, cap 16)
    against the row-space steps on its own schedule, positions within
    1e-6·max|pos| and velocities within 1e-5·max|v| (the frozen steps'
    moments are summed in another order); the repair driver on a hot
    scene (30·N(0, 1) velocities: movers every step) against sorting
    every step, positions within 1e-4·max|pos| (the JAX package's bound:
    the frozen grid geometry's far field differs), on the cube, where no
    cell holds more than k rows (rows past the cap lose their near field,
    and which rows those are differs between two runs). Masses come back
    row for row; launches: K2's rank form on sorted steps only."""
    sf, tp, st = _table_case(dev, 0.0)
    before = tile_scatter.launches
    tab = T.make_table_multi_step(tp, 1e-3, 9, 4)(st)
    assert tile_scatter.launches == before + 3
    row = tint.make_resort_multi_step(sf, 1e-3, 9, 4)(st)
    assert _near(tab.pos, row.pos, 1e-6) and _near(tab.vel, row.vel, 1e-5)
    assert torch.equal(tab.mass, st.mass)

    ada, (stale, resorted) = T.make_table_adaptive_multi_step(
        tp, 1e-3, 9, max_stale_frac=0.01, max_cadence=16, with_trace=True)(st)
    row = _replay(sf, st, resorted.tolist())
    assert _near(ada.pos, row.pos, 1e-6) and _near(ada.vel, row.vel, 1e-5)
    assert torch.equal(ada.mass, st.mass)

    sf, tp, st = _table_case(dev, 30.0, cube=True)
    before = tile_place.launches
    rep, (stale, rebuilt) = T.make_table_repair_multi_step(
        tp, 1e-3, 9, with_trace=True)(st)
    assert int(stale.min()) > 0 and not bool(rebuilt.any())
    assert tile_place.launches == before + 8
    assert float(T._entry(st, 1e-3, tp).live.max()) < tp.k
    row = tint.make_sorted_multi_step(sf, 1e-3, 9)(st)
    assert _near(rep.pos, row.pos, 1e-4)
    assert torch.equal(rep.mass, st.mass)
    assert bool(torch.isfinite(rep.vel).all())


def test_table_holes_are_inert_to_the_sweep(dev):
    """K4's liveness on a table with holes: after three repair steps of the
    hot scene (movers leave holes below each cell's high-water mark),
    the sweep with counts = the high-water mark gives, on every occupied
    slot, the accelerations of a fresh rebuild of the same rows in the
    same cells (K2's rank form, holes compacted; atol 2e-5·max, the
    sources are summed in another order), and those of the sweep with
    every slot live bit for bit."""
    _sf, tp, st = _table_case(dev, 30.0, cube=True)
    dt, d, k = 1e-3, tp.d, tp.k
    ts = T._entry(st, dt, tp)
    for _ in range(3):
        pos_d_t, vel_h, side_pd, mover, n_stale = T._drift(ts, dt, tp,
                                                           audit=True)
        ts = T._repair_step(ts, pos_d_t, vel_h, side_pd, mover, int(n_stale),
                            dt, tp)
    occ = ts.cov_t[:, 0] > 0                                  # (d, k, d²)
    slot = torch.arange(k, device=dev)[None, :, None]
    holes = ~occ & (slot < ts.live.reshape(d, 1, d * d))
    assert bool(holes.any())
    far_plane, _ = T._far_grids(T._table_moments(ts.pos_t, ts, ts.side, tp),
                          ts.lo, ts.cell, tp)
    kw = dict(k=k, d=d, ws=tp.ws, eps=tp.softening, far_plane=far_plane,
              lo=ts.lo, cell=ts.cell)
    raw = tile_sweep_plane(ts.pos_t, counts=ts.live, **kw)
    raw_all = tile_sweep_plane(ts.pos_t, **kw)
    o3 = occ[:, None].expand_as(raw)
    assert torch.equal(raw[o3], raw_all[o3])

    # the occupied slots in (cell, slot) order, rebuilt without holes
    occ_ck = occ.permute(0, 2, 1).reshape(-1)                 # cell·k + slot
    s = torch.nonzero(occ_ck)[:, 0]
    c = (s // k).to(torch.int32)
    pos_ck = ts.pos_t.permute(0, 3, 2, 1).reshape(-1, 4)[s].contiguous()
    cell_start = cell_starts_at(c, torch.arange(d ** 3 + 1, device=dev,
                                                dtype=torch.int32))
    tiles, mom = tile_scatter(pos_ck, cell_start, ts.lo, ts.cell, d=d, k=k)
    fresh = tile_sweep_plane(tiles, counts=mom[10], **kw)
    r_new = sorted_ranks(c).long()
    cl = c.long()
    x, yz = cl // (d * d), cl % (d * d)
    got = raw[x, :, s % k, yz]
    want = fresh[x, :, r_new, yz]
    assert _near(got, want, 2e-5)
