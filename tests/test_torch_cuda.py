"""nbody_tpu_torch CUDA kernels against their plain twins, on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one:
a CUDA kernel has no CPU mode. This file imports nothing of JAX, so it runs
where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest`` because the suite's conftest configures JAX.)
"""

import collections
import ctypes
import json

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
    PE_TILE,
    direct_forces,
    direct_forces_kernel,
    pair_tile_schedule,
    pairwise_potential,
    pairwise_potential_plain,
)
from nbody_tpu_torch.ops.far_down import MAX_LEVELS, far_down, far_down_plain
from nbody_tpu_torch.ops.far_taps import far_taps, far_taps_plain
from nbody_tpu_torch.ops.payload_gather import (
    payload_gather,
    payload_gather_plain,
)
from nbody_tpu_torch.ops import integrator as tint
from nbody_tpu_torch.ops import table_step as T
from nbody_tpu_torch.ops.forces import make_table_step_params
from nbody_tpu_torch.ops.scatter import (
    SENTINEL_DEST,
    k2_plan,
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
from nbody_tpu_torch.types import (
    ForceMethod,
    InitDistribution,
    SimulationConfig,
    UniformDistParams,
)
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


def _k2_counts(case, plan, k, rng):
    """(d, per-cell row counts) of a skewed K2 case: one cell holding more
    rows than a staged chunk; a z-row whose rows span several chunks, with
    short and long runs astride the chunk edges; cells of exactly k, k + 1
    rows and either side of the long-run threshold; an all-empty z-row
    (and an empty x-plane); d = 56."""
    chunk, long_run = plan["chunk_rows"], plan["long_run"]
    d = 56 if case == "d56" else 8
    counts = rng.poisson(3 if case == "d56" else 5, d ** 3)
    if case == "chunk-cell":
        counts[(3 * d + 4) * d + 5] = chunk + 517
    elif case == "chunk-zrow":
        row = (2 * d + 6) * d
        counts[row:row + d] = [chunk - 100, 5, 700, 0, long_run,
                               long_run + 1, chunk + 300, 3]
    elif case == "k-edge":
        counts[:] = rng.choice([k, k + 1, 0, long_run, long_run + 1],
                               d ** 3)
    elif case == "empty-zrow":
        counts[(4 * d + 1) * d:(4 * d + 2) * d] = 0
        counts[:d * d] = 0
    return d, counts


def _k2_case(case, dev):
    """A K2 rank-form input: the 20000-row sphere at d 16, or a skewed
    grid (``_k2_counts``) whose rows lie uniformly inside their cells →
    (psort, cell_start, lo, cell, d)."""
    if case == "sphere":
        p, m = (t.to(dev) for t in _sphere(20000, 4.0, seed=2))
        lo, cell, coords = bin_particles(p, 4)
        g = build_sorted_grid(p, m, coords, 16)
        return g.psort, g.cell_start, lo, cell, 16
    rng = np.random.default_rng(7)
    d, counts = _k2_counts(case, k2_plan(), 16, rng)
    ids = np.repeat(np.arange(d ** 3), counts)
    xyz = np.stack([ids // (d * d), (ids // d) % d, ids % d], axis=1)
    lo, cell = np.array([-3.0, -2.0, -1.0]), 0.75
    pos = lo + (xyz + rng.uniform(0.0, 1.0, xyz.shape)) * cell
    psort = np.concatenate([pos, rng.uniform(0.5, 1.5, (len(ids), 1))], 1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    return (torch.from_numpy(psort.astype(np.float32)).to(dev),
            torch.from_numpy(starts.astype(np.int32)).to(dev),
            torch.tensor(lo, dtype=torch.float32, device=dev),
            torch.tensor(cell, dtype=torch.float32, device=dev), d)


@pytest.mark.parametrize("case", ["sphere", "chunk-cell", "chunk-zrow",
                                  "k-edge", "empty-zrow", "d56"])
def test_scatter_kernel(dev, case):
    """K2's rank forms against their twins on skewed grids (``_k2_case``),
    k = 16: slots (placed and filler), counts, coverage and extra planes
    bit-equal; moments within 1e-5·|x| + 1e-6·max|channel|; two calls of
    each form bit-equal."""
    psort, cell_start, lo, cell, d = _k2_case(case, dev)
    k = 16
    args = (psort, cell_start, lo, cell)
    ex = torch.randn(psort.shape[0], 3, device=dev)
    kw = dict(d=d, k=k, with_coverage=True, extra=ex)
    before = tile_scatter.launches
    main, table = tile_scatter(*args, d=d, k=k), tile_scatter(*args, **kw)
    assert tile_scatter.launches == before + 2
    for got, want in ((main, tile_scatter_plain(*args, d=d, k=k)),
                      (table, tile_scatter_plain(*args, **kw))):
        tk, mk, tp, mp = got[0], got[1], want[0], want[1]
        assert torch.equal(tk, tp)
        assert torch.equal(mk[10], mp[10])
        tol = 1e-5 * mp.abs() + 1e-6 * mp.abs().amax(dim=1, keepdim=True)
        assert bool(((mk - mp).abs() <= tol).all())
        assert all(torch.equal(a, b) for a, b in zip(got[2:], want[2:]))
    for got, again in ((main, tile_scatter(*args, d=d, k=k)),
                       (table, tile_scatter(*args, **kw))):
        assert all(torch.equal(a, b) for a, b in zip(got, again))


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


@pytest.mark.parametrize("k", [1, 8, 16, 40, 64])
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


def _k40_scene(dev, d=32, ws=1):
    """The 4M flagship's occupancy band at a smaller grid: a sphere of
    15·d³ rows binned at d (occupancy 15 over the cube, ~29 inside the
    sphere; ``bh_engine_params`` gives near_k 40), its K2 tiles and
    moments at k 40, and K4's keyword arguments with a 19-channel far
    plane from the pyramid."""
    from nbody_tpu_torch.ops.barnes_hut import far_plane_grid

    k, levels = 40, d.bit_length() - 1
    p, m = (t.to(dev) for t in _sphere(15 * d ** 3, 10.0, seed=40))
    lo, cell, coords = bin_particles(p, levels)
    g = build_sorted_grid(p, m, coords, d)
    tk, mk = tile_scatter(g.psort, g.cell_start, lo, cell, d=d, k=k)
    far = far_plane_grid(mk[:10].T.reshape(d, d, d, 10), lo, cell,
                         levels=levels, ws=ws, eps=0.1)
    kw = dict(k=k, d=d, ws=ws, eps=0.1, counts=mk[10], far_plane=far, lo=lo,
              cell=cell)
    return g, lo, cell, tk, kw


def _far_scene(scene, dev):
    """(packed finest moments (d, d, d, 10), lo, cell, levels): the
    bh1m-sphere initial state (1M rows in a ball of radius 10 at rest,
    masses 1/N; d 64, k 16) or ``_k40_scene``'s sphere (d 32, k 40)."""
    if scene == "bh1m":
        n, d, k = 1_000_000, 64, 16
        p, _ = _sphere(n, 10.0, seed=42)
        m = torch.full((n,), 1.0 / n)
    else:
        d, k = 32, 40
        p, m = _sphere(15 * d ** 3, 10.0, seed=40)
    p, m = p.to(dev), m.to(dev)
    levels = d.bit_length() - 1
    lo, cell, coords = bin_particles(p, levels)
    g = build_sorted_grid(p, m, coords, d)
    _, mk = tile_scatter(g.psort, g.cell_start, lo, cell, d=d, k=k)
    return mk[:10].T.reshape(d, d, d, 10), lo, cell, levels


@pytest.mark.parametrize("scene", ["bh1m", "k40"])
def test_far_down_kernel(dev, scene):
    """The far field's downward pass (one launch) vs its plain twin (the
    torch composition) on K3's outputs of every level: bit-equal, since
    the kernel rounds each product and sum once in the twin's order; two
    calls bit-equal; ``far_plane_grid`` launches it once a call and
    returns the same plane."""
    from nbody_tpu_torch.ops.barnes_hut import (
        _far_taps_levels,
        far_plane_grid,
        pyramid_from_packed,
    )

    packed, lo, cell, levels = _far_scene(scene, dev)
    d = 1 << levels
    pyr = pyramid_from_packed(packed, lo, cell, levels)
    outs = _far_taps_levels(pyr, 1, 0.1, levels)
    before = far_down.launches
    got = far_down(outs, cell)
    assert far_down.launches == before + 1
    assert got.shape == (d, 19, d * d)
    assert bool(torch.isfinite(got).all()) and bool((got != 0).any())
    assert torch.equal(got, far_down_plain(outs, cell))
    assert torch.equal(far_down(outs, cell), got)
    before = far_down.launches
    plane = far_plane_grid(packed, lo, cell, levels=levels, ws=1, eps=0.1)
    assert far_down.launches == before + 1
    assert torch.equal(plane, got)


@pytest.mark.parametrize("levels", range(1, 8))
def test_far_down_kernel_at_each_level(dev, levels):
    """The kernel at each depth it is built for up to d 128 (the 4M
    flagship takes its levels from ``bh_max_level``): random K3-shaped
    outputs and edge, bit-equal to the plain twin, one launch."""
    rng = np.random.default_rng(100 + levels)
    outs = [torch.from_numpy(rng.normal(size=(152, 8 ** lvl // 8))
                             .astype(np.float32)).to(dev)
            for lvl in range(1, levels + 1)]
    cell = torch.tensor(float(rng.uniform(0.01, 2.0)), dtype=torch.float32,
                        device=dev)
    before = far_down.launches
    got = far_down(outs, cell)
    assert far_down.launches == before + 1
    d = 1 << levels
    assert got.shape == (d, 19, d * d)
    assert torch.equal(got, far_down_plain(outs, cell))


def test_far_down_refuses_what_the_kernel_does_not_take(dev):
    """The wrapper raises, launching nothing, on a level of the wrong
    shape, a non-contiguous or float64 level, a CPU/CUDA mix, a cell of
    more than one element and more levels than the kernel takes."""
    rng = np.random.default_rng(9)

    def level(p):
        return torch.from_numpy(
            rng.normal(size=(152, p ** 3)).astype(np.float32)).to(dev)

    outs = [level(1 << i) for i in range(3)]
    cell = torch.tensor(0.5, device=dev)
    before = far_down.launches
    bad = [
        ([outs[0], level(1), outs[2]], cell),
        ([outs[0], outs[1], level(4).T.contiguous().T], cell),
        ([outs[0], outs[1].double(), outs[2]], cell),
        (outs, cell.cpu()),
        ([outs[0].cpu(), *outs[1:]], cell),
        (outs, torch.full((2,), 0.5, device=dev)),
        ([level(1)] * (MAX_LEVELS + 1), cell),
    ]
    for args in bad:
        with pytest.raises((ValueError, TypeError)):
            far_down(*args)
    assert far_down.launches == before
    assert far_down(outs, cell.reshape(1)).shape == (8, 19, 64)


def _permutation(kind, n, rng):
    """An identity, a near-identity (a tenth of the rows swapped with
    their neighbour: the sorted step's carried rows, already in the last
    step's cell order) or a full random permutation of n rows."""
    order = np.arange(n)
    if kind == "near":
        for a in rng.choice(max(n - 1, 1), size=n // 10, replace=False):
            if a + 1 < n:
                order[[a, a + 1]] = order[[a + 1, a]]
    elif kind == "random":
        order = rng.permutation(n)
    return torch.from_numpy(order.astype(np.int64))


@pytest.mark.parametrize("perm", ["identity", "near", "random"])
@pytest.mark.parametrize("n", [1, 1000, 1 << 20])
def test_payload_gather_kernel(dev, n, perm):
    """The sort's row permutation (one launch) vs its plain twin (cat,
    row gathers, // and %), bit for bit, for no extra columns and E 3 and
    4, with and without the cell coordinates; positions and masses as
    their own tensors and as views of one (N, 4) table (the sorted step's
    rows), extra columns as a strided view; N 1, N not a multiple of the
    block and 1M."""
    rng = np.random.default_rng(n)
    d = 64
    ids = torch.from_numpy(rng.integers(0, d ** 3, n).astype(np.int32))
    order = _permutation(perm, n, rng)
    table = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32))
    ids, order, table = ids.to(dev), order.to(dev), table.to(dev)
    for pos, mass in ((table[:, :3].contiguous(), table[:, 3].contiguous()),
                      (table[:, :3], table[:, 3])):
        for e in (None, 3, 4):
            extra = None if e is None else table[:, 6 - e:]
            for with_csort in (False, True):
                before = payload_gather.launches
                got = payload_gather(pos, mass, ids, order, d, extra,
                                     with_csort)
                assert payload_gather.launches == before + 1
                want = payload_gather_plain(pos, mass, ids, order, d, extra,
                                            with_csort)
                for g, w in zip(got, want):
                    assert (g is None) == (w is None)
                    if g is not None:
                        assert g.dtype == w.dtype and torch.equal(g, w)


def test_payload_gather_refuses_what_the_kernel_does_not_take(dev):
    """The wrapper raises, launching nothing, on float64 positions, int64
    ids, int32 order, a CPU/CUDA mix, a wrong length, strided columns and
    a one-dimensional extra."""
    n = 100
    pos = torch.rand(n, 3, device=dev)
    mass = torch.rand(n, device=dev)
    ids = torch.randint(0, 512, (n,), dtype=torch.int32, device=dev)
    order = torch.randperm(n, device=dev)
    before = payload_gather.launches
    bad = [
        (pos.double(), mass, ids, order),
        (pos, mass, ids.long(), order),
        (pos, mass, ids, order.int()),
        (pos, mass.cpu(), ids, order),
        (pos[:-1], mass, ids, order),
        (torch.rand(3, n, device=dev).T, mass, ids, order),
    ]
    for args in bad:
        with pytest.raises((ValueError, TypeError)):
            payload_gather(*args, 8)
    with pytest.raises(ValueError):
        payload_gather(pos, mass, ids, order, 8, extra=mass)
    assert payload_gather.launches == before
    assert payload_gather(pos, mass, ids, order, 8)[0].shape == (n, 4)


@pytest.mark.parametrize("engine", ["bh tiles", "hash window"])
def test_payload_gather_on_the_graphed_sorted_step(dev, engine,
                                                   monkeypatch):
    """``run_steps`` on a captured sorted step launches the payload gather
    once a step, and its state equals, bit for bit, the eager steps of the
    plain route (``build_sorted_grid`` through the plain twin)."""
    from nbody_tpu_torch.ops import sorted_window

    steps = 6
    ps = _graph_system(dev, engine)
    assert ps._sorted_step is not None
    state0 = ps.state
    with monkeypatch.context() as m:
        m.setattr(sorted_window, "payload_gather", payload_gather_plain)
        calls = payload_gather_plain.calls
        want = ps._multi_step(steps, graphed=False)(state0)
        assert payload_gather_plain.calls == calls + steps
    before, calls = payload_gather.launches, payload_gather_plain.calls
    ps.run_steps(steps)
    torch.cuda.synchronize()
    assert payload_gather.launches == before + steps
    assert payload_gather_plain.calls == calls
    assert ps.step_graphs["sorted"].replays == steps - 1
    _same_state(ps.state, want, f"{engine} run_steps")


def test_scatter_kernel_at_k40(dev):
    """K2 at the flagship's k 40 (a 491520-row sphere at d 32): slots
    (placed and filler) and counts bit-equal to the twin, moments within
    1e-5·|x| + 1e-6·max|channel|, some cells past the cap, two calls
    bit-equal."""
    g, lo, cell, _, kw = _k40_scene(dev)
    args = (g.psort, g.cell_start, lo, cell)
    tk, mk = tile_scatter(*args, d=kw["d"], k=40)
    tp, mp = tile_scatter_plain(*args, d=kw["d"], k=40)
    assert torch.equal(tk, tp) and torch.equal(mk[10], mp[10])
    assert float(mk[10].max()) > 40
    tol = 1e-5 * mp.abs() + 1e-6 * mp.abs().amax(dim=1, keepdim=True)
    assert bool(((mk - mp).abs() <= tol).all())
    again = tile_scatter(*args, d=kw["d"], k=40)
    assert torch.equal(again[0], tk) and torch.equal(again[1], mk)


@pytest.mark.parametrize("ws", [1, 2])
def test_tile_near_kernel_at_k40(dev, ws):
    """K4 at the flagship's k 40 on real K2 tiles with the far seed, ws 1
    (bricks of 128/40 = 3 cells) and 2 (12): vs plain atol
    2e-5·max|out|, two calls bit-equal, and the plan as ``make_plan``
    states it."""
    _, _, _, tiles, kw = _k40_scene(dev, ws=ws)
    assert _k4_plan(kw["d"], 40, ws)[0] == 128 // 40 * ws * ws
    before = tile_sweep_plane.launches
    got = tile_sweep_plane(tiles, **kw)
    assert tile_sweep_plane.launches == before + 1
    assert bool(torch.isfinite(got).all())
    _close(got, tile_sweep_plane_plain(tiles, **kw), 2e-5)
    assert torch.equal(got, tile_sweep_plane(tiles, **kw))


def test_sorted_routes_bit_equal_on_card(dev):
    """``sorted_verlet_step`` with the payload riding K2's sort
    (``route_extra=True``) and with its own gathers, 3 steps of BH tiles
    at k 40 on the card: bit-equal to each other and to
    ``make_sorted_multi_step``."""
    p, m = (t.to(dev) for t in _sphere(15 * 16 ** 3, 6.0, seed=41))
    cfg = SimulationConfig(particle_count=p.shape[0], bh_max_level=4,
                           force_method=ForceMethod.BARNES_HUT)
    sf = make_barnes_hut_forces_sorted(cfg)
    st = tint.initialize_forces(
        ParticleState(pos=p, vel=torch.zeros_like(p), acc=torch.zeros_like(p),
                      mass=m, time=torch.zeros((), device=dev)),
        lambda q, w: barnes_hut_forces(q, w, levels=4, near_k=40))
    a = b = tint.sorted_state_from(st)
    for _ in range(3):
        a = tint.sorted_verlet_step(a, sf, 1e-3)
        b = tint.sorted_verlet_step(b, sf, 1e-3, route_extra=True)
    for f in ("pos", "vel", "acc", "mass", "to_orig"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    multi = tint.make_sorted_multi_step(sf, 1e-3, 3, route_extra=True)(st)
    assert torch.equal(multi.pos, tint.to_particle_state(a).pos)


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


def test_window_sweep_kernel_adds_into_overflow_out(dev):
    """K7 with ``overflow_out`` adds each launch's overflow to the tensor
    it is given (no fresh zero) and returns it; the forces are bit for
    bit those of a launch without it."""
    p, m = (t.to(dev) for t in _sphere(20000, 4.0, seed=4))
    g = build_sorted_grid(p, m, bin_particles(p, 4)[2], 16, with_csort=True)
    kw = _k7_kw("hash", 16, 256, 64)
    args = (g.psort, g.csort, g.cell_start)
    acc, over = window_sweep_kernel(*args, **kw)
    assert int(over) > 0
    total = torch.full((), 3, dtype=torch.int64, device=dev)
    for k in (1, 2):
        acc_k, got = window_sweep_kernel(*args, overflow_out=total, **kw)
        assert got is total and int(total) == 3 + k * int(over)
        assert torch.equal(acc_k, acc)


@pytest.mark.parametrize("mass,steps", [(1, 200), (1_000_000, 60)],
                         ids=["cell_mass", "source_mass"])
def test_hash1m_sphere_through_the_facade(dev, mass, steps):
    """The benchmark's 1M spatial hash (``portbench/configs/
    hash1m-sphere.json``: cell 1.0, cutoff 2.0, ``hash_window`` unset,
    the radius-10 sphere at rest) through ``initialize`` / ``set_state`` /
    ``run_steps``, at the cell's total mass 1 and at the source's mass 1
    a row, whose sphere collapses, so that the JAX package's window of 2048
    rows drops more after its 60 steps than at the start: the window is
    every row, the graphed steps add no row to the overflow counter, and
    the accelerations at 4096 sampled rows are the plain reference's
    (``portbench/reference/hash.py``, float64) within the cell's
    ``acc_gap`` limit (the largest row gap less its cutoff band, over the
    largest reference acceleration)."""
    from nbody_tpu_torch import ParticleSystem, SimulationState
    from nbody_tpu_torch.ops.spatial_hash import spatial_hash_forces
    from nbody_tpu_torch.utils.profiling import read_counter
    from portbench import check, core
    from portbench.reference import hash as hash_ref

    conf = core.load_json("configs", "hash1m-sphere")
    cfg = core.simulation_config(conf["simulation"])
    assert cfg.hash_window == 0
    n = cfg.particle_count
    pos, vel, m = core.make_scene({**conf["scene"], "total_mass": mass}, n,
                                  2 ** 31 + 24, dev)
    ps = ParticleSystem()
    ps.initialize(cfg, device=dev)
    ps.set_state(SimulationState(
        pos=pos.cpu().numpy(), vel=vel.cpu().numpy(),
        mass=m.cpu().numpy(), dt=cfg.dt, G=cfg.G,
        softening=cfg.softening, force_method=cfg.force_method), device=dev)
    p = ps._force_fn.engine_params
    assert (p["engine"], p["window"], p["block"]) == ("window", n, 256)

    def jax_rule():
        st = ps.state
        return int(spatial_hash_forces(
            st.pos, st.mass, cfg.G, cfg.softening, window=2048,
            block_size=256, return_overflow=True)[1])

    start = jax_rule()
    for _ in range(2):
        ps.run_steps(steps // 2)
    ps.synchronize()
    assert "sorted" in ps.step_graphs
    audit = ps.audit_short_range()
    assert (audit["overflow"], audit["window_overflow_rows"]) == (0, 0)
    assert read_counter("hash.window_overflow_rows") == 0
    if mass > 1:
        assert jax_rule() > start > 0
    st = ps.state
    t = check.sample_rows(n, 24, 4096).to(dev)
    want, ok, band, _ = hash_ref.accelerations(st.pos, st.mass, t,
                                               conf["simulation"])
    diff = torch.linalg.vector_norm(st.acc[t].double() - want, dim=1)
    gap = float(torch.clamp(diff - band, min=0.0)[ok].max()
                / torch.linalg.vector_norm(want, dim=1)[ok].max())
    assert gap <= core.load_json("limits", "hash1m-sphere.run")["acc_gap"][
        "limit"]


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


@pytest.mark.parametrize("n", [1, 2, 255, 257, 16384, 20000])
def test_pair_potential_kernel(dev, n):
    """K5 vs plain with a coincident pair and a zero-mass row (from N = 3)
    at ε = 0.1 and ε = 0 (the ftz and the rsqrtf loop): relative 1e-5
    (rsqrtf and torch.rsqrt differ by ulps per term; the sums are float64
    in both); two calls bit-equal; N = 1 to 257 cross the 256-row tile,
    16384 is the app's sampled estimate. A lone coincident pair gives 0."""
    p, m = _sphere(max(n, 3), 5.0, seed=7)
    p, m = p[:n].contiguous(), m[:n].contiguous()
    if n >= 3:
        p[1] = p[0]
        m[2] = 0.0
    p, m = p.to(dev), m.to(dev)
    for eps in (0.1, 0.0):
        before = pairwise_potential.launches
        got = pairwise_potential(p, m, 1.0, eps)
        assert pairwise_potential.launches == before + 1
        np.testing.assert_allclose(
            float(got), float(pairwise_potential_plain(p, m, 1.0, eps)),
            rtol=1e-5)
        assert torch.equal(got, pairwise_potential(p, m, 1.0, eps))
    assert float(pairwise_potential(p[:1].expand(2, 3).contiguous(),
                                    m[:1].expand(2).contiguous())) == 0.0


def test_pair_potential_subnormal_pair(dev):
    """At ε = 0 a pair 1e-20 apart has a denormal r² (1e-40): it is not
    coincident, so K5 counts its term m_i·m_j/√r² (~1e20), finite, as the
    plain twin does (relative 1e-5). The ftz loop, which takes ε² ≥
    1e-12 only, would flush r² + ε² to 0 here and give an infinite sum."""
    p, m = _sphere(300, 5.0, seed=7)
    p[0] = 0.0
    p[1] = torch.tensor([1e-20, 0.0, 0.0])
    p, m = p.to(dev), m.to(dev)
    got = pairwise_potential(p, m, 1.0, 0.0)
    want = pairwise_potential_plain(p, m, 1.0, 0.0)
    assert torch.isfinite(got) and float(got) < -1e18
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_pair_potential_loops_agree_bit_for_bit(dev):
    """K5's two pair loops give the same bits on normal inputs. Scaling
    positions and ε by 2^-20 scales every r², r² + ε² and 1/√ by an exact
    power of two, so the ε² < 1e-12 input (the rsqrtf loop) must give
    exactly 2^20 times the ε = 0.1 input's potential (the ftz loop), for
    the main and the cross form."""
    from nbody_tpu_torch.ops.direct import pairwise_potential_cross

    p, m = _sphere(3000, 5.0, seed=7)
    p[1] = p[0]
    m[2] = 0.0
    p, m = p.to(dev), m.to(dev)
    s = 2.0 ** -20
    ps = p * s
    lean = pairwise_potential(p, m, 1.0, 0.1)
    exact = pairwise_potential(ps, m, 1.0, 0.1 * s)
    assert torch.equal(exact, lean * 2.0 ** 20)
    a, b = (p[:1000], m[:1000]), (p[1000:], m[1000:])
    lean = pairwise_potential_cross(*a, *b, 1.0, 0.1)
    exact = pairwise_potential_cross(ps[:1000], m[:1000], ps[1000:],
                                     m[1000:], 1.0, 0.1 * s)
    assert torch.equal(exact, lean * 2.0 ** 20)


@pytest.mark.parametrize("n,ns", [(1, None), (PE_TILE + 1, None),
                                  (3 * PE_TILE + 5, None),
                                  (3 * PE_TILE + 5, PE_TILE + 1)])
def test_pair_potential_partials_follow_the_mirror(dev, n, ns):
    """With fewer tile pairs than one wave of blocks, K5's plan gives each
    block one tile pair: as many partials as ``pair_tile_schedule`` has
    blocks at run 1, so the mirror's tile is the kernel's."""
    want = len(pair_tile_schedule(n, PE_TILE, 1, ns=ns))
    got = _build.library().nbt_pair_potential_partials(
        torch.cuda.current_device(), n, n if ns is None else ns,
        int(ns is not None))
    assert got == want


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
    K6 + K7) vs on the CPU (plain twins), same inputs: atol 2e-5·max|a|.
    Both engines sum their finest moments by K6, once a call."""
    p, m = _sphere(20000, 6.0, seed=10)
    kw = dict(levels=4, near_k=16, near_engine=engine, multipole_order=1)
    before = segment_sum.launches
    got = barnes_hut_forces(p.to(dev), m.to(dev), **kw)
    assert segment_sum.launches == before + 1
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
    r, (meta,) = tint._sorted_step(tint.sorted_state_from(st),
                                   sf.with_meta, dt)
    for resort in resorted:
        if resort:
            r, (meta,) = tint._sorted_step(r, sf.with_meta, dt)
        else:
            r, _ = tint._frozen_step(r, sf.frozen, meta, dt)
    return tint.to_particle_state(r)


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


def test_table_slot_row_marks_coverage(dev):
    """The invariant K2's dest form reads its high-water marks by: a table
    slot is occupied (cov 1) exactly where its ``slot_row`` entry is ≥ 0,
    after a build (``_entry``) and after each of four repair steps of
    the hot scene (movers every step, holes left behind); and ``live`` is
    the high-water mark of cov wherever a repair touched a cell (min(count,
    k) after the build)."""
    _sf, tp, st = _table_case(dev, 30.0, cube=True)
    dt, d, k = 1e-3, tp.d, tp.k
    ts = T._entry(st, dt, tp)
    slot1 = torch.arange(1, k + 1, device=dev)
    for step in range(5):
        occ = ts.cov_t[:, 0] > 0                              # (d, k, d²)
        rows = ts.slot_row.reshape(d, d * d, k).permute(0, 2, 1) >= 0
        assert torch.equal(occ, rows)
        hwm = torch.where(occ, slot1[None, :, None], 0).amax(dim=1)
        assert torch.equal(ts.live, hwm.reshape(-1).to(ts.live.dtype))
        if step == 4:
            break
        before = tile_place.launches
        pos_d_t, vel_h, side_pd, mover, n_stale = T._drift(ts, dt, tp,
                                                           audit=True)
        assert int(n_stale) > 0
        ts = T._repair_step(ts, pos_d_t, vel_h, side_pd, mover, int(n_stale),
                            dt, tp)
        assert tile_place.launches == before + 1


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


def test_facade_potential_energy_runs_k5(dev):
    """``compute_potential_energy`` on the card launches K5 once and no
    plain twin, and is within 1e-5 relative of the plain loop summed in
    float64 (N = 16384, the spherical scene); ``total_energy`` takes the
    same route."""
    from nbody_tpu_torch import ParticleSystem
    from nbody_tpu_torch.ops.integrator import potential_energy, total_energy

    ps = ParticleSystem()
    ps.initialize(SimulationConfig(particle_count=16384), device=dev)
    launches, calls = pairwise_potential.launches, pairwise_potential_plain.calls
    got = ps.compute_potential_energy()
    assert pairwise_potential.launches == launches + 1
    assert pairwise_potential_plain.calls == calls
    st = ps.state
    want = float(potential_energy(st.pos.double(), st.mass.double(), 1.0,
                                  0.1, accumulate="f64"))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    total_energy(st, 1.0, 0.1)
    assert pairwise_potential.launches == launches + 2
    assert pairwise_potential_plain.calls == calls


def test_cli_export_import_on_card(dev, tmp_path, capsys):
    """The CLI's benchmark on the card (N = 4096, Barnes-Hut, 4 steps)
    launches K2, K3 and K4 and no plain twin, prints one record, and its
    ``--export`` file imports bit-equal, with a(t) bit-equal to
    ``initialize_forces`` on the imported state."""
    import json

    from nbody_tpu_torch.app import Application
    from nbody_tpu_torch.cli import parse_app_cli_options

    path = str(tmp_path / "s.nbody")
    opts = parse_app_cli_options(["--particles", "4096", "--method", "bh",
                                  "--benchmark-steps", "4", "--export", path])
    plains = (tile_scatter_plain.calls, far_taps_plain.calls,
              tile_sweep_plane_plain.calls)
    before = tile_scatter.launches
    app = Application(opts)
    assert app.run() == 0
    assert tile_scatter.launches == before + 9   # a(0), warm 4, timed 4
    assert plains == (tile_scatter_plain.calls, far_taps_plain.calls,
                      tile_sweep_plane_plain.calls)
    (rec,) = json.loads(capsys.readouterr().out)["benchmark_runs"]
    assert rec["iterations"] == 4
    imp = Application(parse_app_cli_options(["--import", path]))
    imp._initialize_system()
    a, b = imp.system.state, app.system.state
    assert a.pos.is_cuda
    for x, y in ((a.pos, b.pos), (a.vel, b.vel), (a.mass, b.mass)):
        assert torch.equal(x, y)
    assert torch.equal(a.acc, tint.initialize_forces(
        a, imp.system._force_fn).acc)


def _r1_held(dev, pos, vel, cam, mode, width=320, height=180):
    """R1 against its twin on the same points: visibility, px, py, size
    and colours bit-equal; the image and its uint8 copy bit-equal to the
    twin's point-order sum (``accumulate="ordered"``) and to a second
    call; the image within 1e-5 of the twin's float32 terms summed in
    float64. One launch a call, no twin call."""
    from nbody_tpu_torch.ops.render import render_points, render_points_plain

    kw = dict(width=width, height=height, point_size=2.0, mode=mode,
              uint8=True, sprites=True)
    pos, vel = pos.to(dev), vel.to(dev)
    launches, calls = render_points.launches, render_points_plain.calls
    got = render_points(pos, vel, cam, **kw)
    again = render_points(pos, vel, cam, **kw)
    assert render_points.launches == launches + 2
    assert render_points_plain.calls == calls
    assert torch.equal(got.image, again.image)
    assert torch.equal(got.image_u8, again.image_u8)
    want = render_points_plain(pos, vel, cam, accumulate="ordered", **kw)
    for name, g, w in zip(("px", "py", "size", "rgb"), got.sprites,
                          want.sprites):
        assert torch.equal(g, w), name
    assert torch.equal(got.image, want.image)
    assert torch.equal(got.image_u8, want.image_u8)
    f64 = render_points_plain(pos, vel, cam, accumulate="f64", **kw)
    assert float((got.image - f64.image).abs().max()) <= 1e-5
    assert torch.equal(got.image_u8, (got.image * 255).to(torch.uint8))
    assert float(got.image.min()) >= 0 and float(got.image.max()) <= 1
    return got


def _at_view(cam, ndc_xy, depth):
    """World points that project to ``ndc_xy`` at view depth ``depth``."""
    p = cam.projection_matrix
    ndc_xy, depth = np.asarray(ndc_xy, float), np.asarray(depth, float)
    view = np.stack([ndc_xy[:, 0] * depth / p[0, 0],
                     ndc_xy[:, 1] * depth / p[1, 1], -depth,
                     np.ones_like(depth)], axis=1)
    world = view @ np.linalg.inv(cam.view_matrix).T
    return torch.from_numpy(world[:, :3].astype(np.float32))


def _at_pixel(cam, px, py, radius, width=320, height=180):
    """World points whose sprites sit near pixel (px, py) at ``radius``
    (a sprite's radius is round(30 / depth) at point size 2)."""
    px, py = np.asarray(px, float), np.asarray(py, float)
    ndc = np.stack([2 * px / (width - 1) - 1, 1 - 2 * py / (height - 1)], 1)
    return _at_view(cam, ndc, 30.0 / np.asarray(radius, float))


CHUNKS = [64, 1]  # R1's index chunks a tile at most (list_chunks' cap)


@pytest.mark.parametrize("chunks", CHUNKS, ids=lambda c: "c%d" % c)
@pytest.mark.parametrize("mode", [0, 1, 2], ids=["depth", "velocity",
                                                  "density"])
def test_render_kernel_cases(dev, mode, chunks, monkeypatch):
    """With 64 index chunks a tile, and with one (a tile's list sorted
    whole, as ``list_chunks`` gives at large images): one point; each
    radius 1-8 at the centre; a
    radius-8 sprite at each image corner (clipped by the edges); sprites
    centred on and beside tile edges; a ragged cloud of 1037 points with
    points behind the eye and off screen, at the app's camera and a close
    one; no points — in each color mode."""
    from nbody_tpu_torch.ops import render as render_ops
    from nbody_tpu_torch.render import Camera
    from nbody_tpu_torch.types import ColorMode

    monkeypatch.setattr(render_ops, "MAX_CHUNKS", chunks)
    mode = ColorMode(mode)
    cam = Camera(distance=45.0, azimuth=0.7, elevation=0.75)
    one = _at_view(cam, [[0.1, -0.2]], [40.0])
    _r1_held(dev, one, torch.ones(1, 3), cam, mode)
    r = np.arange(1, 9, dtype=float)
    radii = _at_view(cam, np.stack([np.linspace(-0.8, 0.8, 8),
                                    np.zeros(8)], 1), 30.0 / r)
    got = _r1_held(dev, radii, torch.rand(8, 3), cam, mode)
    assert sorted(torch.round(got.sprites[2] * 0.5).tolist()) == list(
        range(1, 9))
    corners = _at_view(cam, [[-1, -1], [-1, 1], [1, -1], [1, 1]],
                       [30.0 / 8] * 4)
    _r1_held(dev, corners, torch.rand(4, 3), cam, mode)
    edge = np.array([7.0, 8.0, 15.0, 16.0, 31.5, 32.0, 47.4, 63.6])
    gx, gy, gr = np.meshgrid(edge + 40, edge + 40, [1, 3, 8])
    edges = _at_pixel(cam, gx.ravel(), gy.ravel(), gr.ravel())
    _r1_held(dev, edges, torch.rand(edges.shape[0], 3), cam, mode)
    pos = _sphere(1037, 10.0, 7)[0]
    vel = torch.from_numpy(np.random.default_rng(8).normal(
        size=(1037, 3)).astype(np.float32))
    for c in (cam, Camera(distance=5.0, azimuth=0.7, elevation=0.75)):
        _r1_held(dev, pos, vel, c, mode)
    _r1_held(dev, pos[:0], vel[:0], cam, mode)


@pytest.mark.parametrize("order", ["spread", "contiguous"])
def test_render_kernel_sort_paths(dev, order):
    """A tile list of 1500 sprites stacked on a few pixels among 50000
    points: with the stacked indices spread over the index range, each
    index chunk's run is short (sorted a warp a run); with them
    contiguous, one chunk holds the whole list (sorted whole). Both
    bit-equal to the ordered twin."""
    from nbody_tpu_torch.ops.render import tile_counts
    from nbody_tpu_torch.render import Camera
    from nbody_tpu_torch.types import ColorMode

    cam = Camera(distance=45.0, azimuth=0.7, elevation=0.75)
    rng = np.random.default_rng(13)
    m, n = 1500, 50000
    stack = _at_pixel(cam, rng.choice([100.0, 101.4, 102.6], m),
                      rng.choice([60.0, 61.5], m), np.ones(m))
    pos = torch.from_numpy(np.tile(2 * cam.position, (n, 1)).astype(
        np.float32))
    at = (torch.from_numpy(np.sort(rng.choice(n, m, replace=False)))
          if order == "spread" else torch.arange(20000, 20000 + m))
    pos[at] = stack
    vel = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    got = _r1_held(dev, pos, vel, cam, ColorMode.DEPTH)
    counts = tile_counts(*got.sprites[:3], width=320, height=180)
    assert 1000 < int(counts.max()) <= 2048


@pytest.mark.parametrize("chunks", CHUNKS, ids=lambda c: "c%d" % c)
def test_render_kernel_long_lists(dev, chunks, monkeypatch):
    """Tiles whose list is longer than shared memory holds (the second
    splat kernel): 6000 sprites stacked on a few pixels among 2²² + 6000
    points, most of them behind the eye, so that the stacked indices span
    two partitions of the index range — bit-equal to the ordered twin."""
    from nbody_tpu_torch.ops import render as render_ops
    from nbody_tpu_torch.ops.render import tile_counts
    from nbody_tpu_torch.render import Camera
    from nbody_tpu_torch.types import ColorMode

    monkeypatch.setattr(render_ops, "MAX_CHUNKS", chunks)
    cam = Camera(distance=45.0, azimuth=0.7, elevation=0.75)
    rng = np.random.default_rng(12)
    m, n = 6000, (1 << 22) + 6000
    stack = _at_pixel(cam, rng.choice([100.0, 101.4, 106.0], m),
                      rng.choice([60.0, 62.5], m), rng.integers(1, 9, m))
    pos = torch.from_numpy(np.tile(2 * cam.position, (n, 1)).astype(
        np.float32))
    at = torch.from_numpy(np.sort(rng.choice(n, m, replace=False)))
    pos[at] = stack
    vel = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    got = _r1_held(dev, pos, vel, cam, ColorMode.VELOCITY)
    counts = tile_counts(*got.sprites[:3], width=320, height=180)
    assert int(counts.max()) > 2048
    assert int(at[-1]) >= 2048 * 2048 and int(at[0]) < 2048 * 2048


def test_point_renderer_on_card_launches_r1(dev):
    """``PointRenderer`` on CUDA tensors launches R1 and returns the image
    on the card, equal to ``render_points`` there; the 1280×720 default."""
    from nbody_tpu_torch.ops.render import render_points
    from nbody_tpu_torch.render import PointRenderer

    pos = _sphere(5000, 10.0, 2)[0].to(dev)
    vel = torch.randn(5000, 3, device=dev)
    rend = PointRenderer()
    before = render_points.launches
    img = rend.render(pos, vel)
    u8 = rend.frame(pos, vel)
    assert render_points.launches == before + 2
    assert img.is_cuda and img.shape == (720, 1280, 3)
    assert u8.dtype == torch.uint8 and u8.shape == (720, 1280, 3)
    assert int((u8.int() - (img * 255).to(torch.uint8).int()).abs().max()) <= 1


def test_point_stream_double_buffer_on_card(dev):
    """A request, then two more steps: ``latest()`` gives the positions of
    request time bit for bit (the double buffer and ``record_stream`` keep
    the copy's source alive); a second snapshot requested after them is
    the new state; ``verify_data_integrity`` holds."""
    from nbody_tpu_torch import ParticleSystem
    from nbody_tpu_torch.render import PointStream

    ps = ParticleSystem()
    ps.initialize(SimulationConfig(particle_count=65536,
                                   force_method=ForceMethod.DIRECT_N2),
                  device=dev)
    stream = PointStream(ps)
    want = ps.state.pos.cpu()
    stream.request()
    ps.update()
    ps.update()
    snap = stream.latest()
    assert torch.equal(torch.from_numpy(snap.positions), want)
    stream.request()
    later = stream.latest()
    assert torch.equal(torch.from_numpy(later.positions), ps.state.pos.cpu())
    assert abs(later.sim_time - 2e-3) < 1e-6 and later.frame_id == 1
    assert torch.equal(torch.from_numpy(snap.positions), want)
    assert stream.verify_data_integrity()


def test_terminal_view_on_card_matches_host(dev):
    """The count grid made on the card equals the one made from the host
    copy of the points, and ``compose`` gives the same string."""
    from nbody_tpu_torch.render import TerminalView

    pos = _sphere(20000, 10.0, 4)[0]
    view = TerminalView()
    grid = view.raster(pos.to(dev))
    assert grid.is_cuda
    assert torch.equal(grid.cpu(), view.raster(pos))
    assert view.compose(pos.to(dev), "s") == view.compose(pos.numpy(), "s")


# ---- the sharded paths: K4's slab form, K5's cross form ----------------------


# id: (d, nx, x0, planes, k, ws, cutoff², live planes)
_SLAB_CASES = {
    # BH-like slab of a d 16 grid with its halo; the first halo plane is
    # the grid's edge (no live slot), the last holds live rows
    "edge": (16, 6, 1, 4, 16, 1, None, "edge"),
    "ws2": (12, 7, 2, 3, 16, 2, None, "all"),
    "k64-cutoff": (12, 6, 1, 4, 64, 1, 2.0, "all"),
}


def _slab_inputs(case, dev):
    d, nx, x0, planes, k, ws, cutoff2, live = _SLAB_CASES[case]
    rng = np.random.default_rng(sorted(_SLAB_CASES).index(case) + 40)
    pos = rng.uniform(0.0, 6.0, (nx, 3, k, d * d))
    mass = rng.uniform(0.0, 1.0, (nx, 1, k, d * d))
    pos[:, :, 1] = pos[:, :, 0]                   # coincident slots
    tiles = np.concatenate([pos, mass], 1).astype(np.float32)
    counts = rng.integers(0, k + 3, (nx, d * d))
    if live == "edge":
        counts[0] = 0
    kw = dict(k=k, d=d, ws=ws, eps=0.1, x0=x0, planes=planes,
              cutoff2=cutoff2)
    return (torch.from_numpy(tiles).to(dev),
            torch.from_numpy(counts.reshape(-1).astype(np.float32)).to(dev),
            kw)


@pytest.mark.parametrize("case", sorted(_SLAB_CASES))
def test_tile_near_slab_kernel(dev, case):
    """K4's slab form vs its plain twin (atol 2e-5·max|out|), two calls
    bit-equal, one launch counted: a slab whose edge plane holds no live
    slot, ws 2 (targets 2 planes in from the slab's edge) and k 64 with
    the cutoff, whose plan fits the kernel's shared memory."""
    tiles, counts, kw = _slab_inputs(case, dev)
    from nbody_tpu_torch.ops.tile_near import tile_sweep_slab

    if kw["k"] == 64:
        assert _k4_plan(kw["d"], 64, kw["ws"])[3] <= 200 * 1024
    before = tile_sweep_slab.launches
    got = tile_sweep_slab(tiles, counts, **kw)
    assert tile_sweep_slab.launches == before + 1
    assert got.shape == (kw["planes"], 3, kw["k"], kw["d"] ** 2)
    assert bool(torch.isfinite(got).all())
    plain = tile_sweep_plane_plain(
        tiles, k=kw["k"], d=kw["d"], ws=kw["ws"], eps=kw["eps"],
        cutoff2=kw["cutoff2"], counts=counts, slab=(kw["x0"], kw["planes"]))
    _close(got, plain, 2e-5)
    assert torch.equal(got, tile_sweep_slab(tiles, counts, **kw))


def test_pair_potential_cross_kernel(dev):
    """K5's cross form vs its twin (relative 1e-5) with coincident pairs
    across the two sets, two calls bit-equal; a lone coincident pair gives
    exactly 0, and the four blocks of a set sum to the main form."""
    from nbody_tpu_torch.ops.direct import pairwise_potential_cross

    p, m = _sphere(20000, 5.0, seed=9)
    p[12000:12100] = p[:100]                     # coincident across sets
    p, m = p.to(dev), m.to(dev)
    a, b = (p[:10000], m[:10000]), (p[10000:], m[10000:])
    before = pairwise_potential_cross.launches
    got = pairwise_potential_cross(*a, *b, 1.0, 0.1)
    assert pairwise_potential_cross.launches == before + 1
    np.testing.assert_allclose(
        float(got), float(pairwise_potential_plain(*a, 1.0, 0.1, sources=b)),
        rtol=1e-5)
    assert torch.equal(got, pairwise_potential_cross(*a, *b, 1.0, 0.1))
    assert float(pairwise_potential_cross(p[:1], m[:1], p[12000:12001],
                                          m[12000:12001])) == 0.0
    total = sum(float(pairwise_potential_cross(*x, *y)) for x in (a, b)
                for y in (a, b))
    np.testing.assert_allclose(total, float(pairwise_potential(p, m)),
                               rtol=1e-6)


@pytest.mark.parametrize("path", ["ring", "tree", "hash"])
def test_sharded_paths_card_match_cpu(dev, path):
    """The sharded forces on 4 virtual shards of the card (kernels K1, K3,
    K4's slab form) vs the same on 4 virtual CPU shards (plain twins):
    atol 2e-5·max|a|, no overflow."""
    from nbody_tpu_torch.parallel import mesh as M
    from nbody_tpu_torch.parallel import (
        ring_direct_forces,
        sharded_barnes_hut_forces,
        sharded_spatial_hash_forces,
    )

    p, m = _sphere(8192, 6.0, seed=21)
    out = []
    for where in (dev, torch.device("cpu")):
        mesh = M.make_mesh(4, devices=[where] * 4)
        ps, ms = M.split(p, mesh), M.split(m, mesh)
        if path == "ring":
            acc, over = ring_direct_forces(ps, ms, mesh), 0
        elif path == "tree":
            acc, over = sharded_barnes_hut_forces(
                ps, ms, mesh, levels=4, near_k=16, return_overflow=True)
        else:
            acc, over = sharded_spatial_hash_forces(
                ps, ms, mesh, cutoff=1.5, cell_size=1.5, cap=16,
                max_per_cell=64, return_overflow=True)
        assert int(over) == 0
        out.append(M.gather(acc).cpu())
    _close(out[0], out[1], 2e-5)


def test_facade_shard_devices_needs_cards(dev):
    """On the card the mesh takes the visible cards: more shards than
    cards raise ValidationError naming both counts."""
    from nbody_tpu_torch import ParticleSystem
    from nbody_tpu_torch.errors import ValidationError

    count = torch.cuda.device_count()
    ps = ParticleSystem()
    with pytest.raises(ValidationError, match=f"{count + 1} devices but only "
                                              f"{count}"):
        ps.initialize(SimulationConfig(particle_count=1024,
                                       shard_devices=count + 1), device=dev)


def test_sharded_paths_across_cards(dev, capsys):
    """With two or more cards (skipped on one): the mesh of the visible
    cards (peer copies between positions) gives the forces and energies
    of the same mesh's virtual shards on card 0 (atol 2e-5·max|a|,
    relative 1e-6), the facade's ``shard_devices`` steps on it, and the
    CLI's ``--devices`` benchmark exits 0."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two cards: one card holds only virtual shards")
    from nbody_tpu_torch import ParticleSystem
    from nbody_tpu_torch.cli import main as cli_main
    from nbody_tpu_torch.parallel import mesh as M
    from nbody_tpu_torch.parallel import (
        ring_direct_forces,
        sharded_barnes_hut_forces,
        sharded_energy,
        sharded_spatial_hash_forces,
    )

    p_n = min(4, count)
    real = M.make_mesh(p_n)
    assert len(set(real.devices)) == p_n
    virtual = M.make_mesh(p_n, devices=[real.devices[0]] * p_n)
    p, m = _sphere(65536, 6.0, seed=22)
    v = torch.from_numpy(np.random.default_rng(3).normal(
        size=(65536, 3)).astype(np.float32))
    out = []
    for mesh in (real, virtual):
        ps, ms = M.split(p, mesh), M.split(m, mesh)
        st = M.shard_state(ParticleState(pos=p, vel=v, acc=torch.zeros_like(p),
                                         mass=m, time=torch.zeros(())), mesh)
        out.append([
            M.gather(ring_direct_forces(ps, ms, mesh)).cpu(),
            M.gather(sharded_barnes_hut_forces(ps, ms, mesh, levels=4,
                                               near_k=16)).cpu(),
            M.gather(sharded_spatial_hash_forces(
                ps, ms, mesh, cutoff=1.5, cell_size=1.5, cap=16,
                max_per_cell=64)).cpu(),
            torch.stack(sharded_energy(st, mesh)).cpu(),
        ])
    for got, want in zip(out[0][:3], out[1][:3]):
        _close(got, want, 2e-5)
    np.testing.assert_allclose(out[0][3].numpy(), out[1][3].numpy(),
                               rtol=1e-6)
    ps_ = ParticleSystem()
    ps_.initialize(SimulationConfig(particle_count=8192, shard_devices=p_n,
                                    force_method=ForceMethod.BARNES_HUT,
                                    bh_max_level=4), device=dev)
    assert ps_.mesh.devices == real.devices
    ps_.run_steps(2)
    assert np.isfinite(ps_.positions()).all()
    assert cli_main(["--particles", "8192", "--method", "barnes-hut",
                     "--devices", str(p_n), "--benchmark",
                     "--benchmark-steps", "2"]) == 0
    assert f'"devices": "{p_n}"' in capsys.readouterr().out


# ---- the facade's captured step (ops/step_graph.py) ----------------------

# engine -> (config of a small scene that selects it, the step kind its
# run_steps captures)
GRAPH_ENGINES = {
    "bh tiles": (dict(force_method=ForceMethod.BARNES_HUT, bh_max_level=3),
                 "sorted"),
    "bh window": (dict(force_method=ForceMethod.BARNES_HUT, bh_max_level=2),
                  "plain"),
    "hash window": (dict(force_method=ForceMethod.SPATIAL_HASH,
                         hash_engine="window"), "sorted"),
    "hash tiles": (dict(force_method=ForceMethod.SPATIAL_HASH,
                        hash_engine="tiles", hash_max_grid_dim=32,
                        spatial_hash_cell_size=2.0,
                        init_distribution=InitDistribution.UNIFORM,
                        dist_params=UniformDistParams(
                            min_bounds=(-16.0,) * 3,
                            max_bounds=(16.0,) * 3)), "sorted"),
    "direct": (dict(force_method=ForceMethod.DIRECT_N2), "plain"),
}
STATE_FIELDS = ("pos", "vel", "acc", "mass", "time")


def _graph_system(dev, engine, n=4096):
    from nbody_tpu_torch import ParticleSystem

    ps = ParticleSystem()
    ps.initialize(SimulationConfig(particle_count=n, dt=1e-3,
                                   **GRAPH_ENGINES[engine][0]), device=dev)
    return ps


def _same_state(got, want, what):
    for k in STATE_FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), \
            f"{what}: {k} differs"


@pytest.mark.parametrize("engine", list(GRAPH_ENGINES))
def test_step_graph_equals_eager(dev, engine):
    """The graphed run_steps (first call: an eager step, the capture and
    replays; second call: replays only) and update() equal the eager
    multi-step functions of the same force from the same state, bit for
    bit. The launch counters count the replays' launches."""
    ps = _graph_system(dev, engine)
    kind = GRAPH_ENGINES[engine][1]
    assert (ps._sorted_step is not None) == (kind == "sorted")
    state0 = ps.state
    before = {f: f.launches for f in _build.COUNTED}
    want = ps._multi_step(4, graphed=False)(state0)
    eager = {f: f.launches - n for f, n in before.items()}
    before = {f: f.launches for f in _build.COUNTED}
    ps.run_steps(4)
    torch.cuda.synchronize()
    graphed = {f: f.launches - n for f, n in before.items()}
    assert graphed == eager, "launch counts of the graphed run"
    assert any(eager.values())
    _same_state(ps.state, want, f"{engine} run_steps")
    g = ps.step_graphs[kind]
    assert (g.captures, g.replays) == (1, 3)
    _same_state(ps._multi_step(4)(state0), want, f"{engine} replays")
    assert (g.captures, g.replays) == (1, 7)
    # update(): the plain step, its own graph where run_steps sorts
    start = ps.state
    want = tint.make_multi_step(ps._force_fn, 1e-3, 3)(start)
    for _ in range(3):
        ps.update()
    _same_state(ps.state, want, f"{engine} update")
    assert ps.step_graphs["plain"].captures == 1


def test_step_graph_hands_out_no_buffer(dev):
    """A state the facade handed out is unchanged after later calls: the
    graph's static buffers are never handed out."""
    ps = _graph_system(dev, "bh tiles")
    ps.run_steps(2)
    held = ps.state
    copy = {k: getattr(held, k).clone() for k in STATE_FIELDS}
    ps.run_steps(3)
    ps.update()
    ps.run_steps(2)
    torch.cuda.synchronize()
    for k in STATE_FIELDS:
        assert torch.equal(getattr(held, k), copy[k]), k
    bufs = [t.data_ptr() for g in ps.step_graphs.values()
            for t in g._static.values()]
    assert not {getattr(ps.state, k).data_ptr() for k in STATE_FIELDS} & set(
        bufs)


def test_step_graph_recaptured_on_change(dev, tmp_path):
    """A second run_steps captures nothing new; set_time_step,
    set_softening, set_force_method, reset and load_state of another N
    each drop the graph, and the next call captures once and equals a
    fresh eager run at the new parameters."""
    ps = _graph_system(dev, "bh tiles")
    ps.run_steps(2)
    g = ps.step_graphs["sorted"]
    ps.run_steps(2)
    assert ps.step_graphs["sorted"] is g and g.captures == 1

    def after(change, kind="sorted"):
        change()
        assert ps.step_graphs == {}
        start = ps.state
        want = ps._multi_step(3, graphed=False)(start)
        ps.run_steps(3)
        assert ps.step_graphs[kind].captures == 1
        _same_state(ps.state, want, change.__name__)

    after(lambda: ps.set_time_step(2e-3))
    assert ps.config.dt == 2e-3
    after(lambda: ps.set_softening(0.2))
    after(lambda: ps.set_force_method(ForceMethod.DIRECT_N2), "plain")
    after(ps.reset, "plain")
    other = _graph_system(dev, "bh tiles", n=2048)
    other.run_steps(1)
    path = str(tmp_path / "s.nbody")
    other.save_state(path)
    after(lambda: ps.load_state(path))
    assert ps.particle_count == 2048


def test_step_graph_capture_failure_raises(dev):
    """A step that reads the host cannot be captured: the call raises (no
    eager fallback), and the card stays usable."""
    from nbody_tpu_torch.ops.step_graph import StepGraph

    def step(s):
        shift = float(s.pos.sum().item()) * 0.0
        return ParticleState(pos=s.pos + shift, vel=s.vel, acc=s.acc,
                             mass=s.mass, time=s.time + 1.0)

    p, m = (t.to(dev) for t in _sphere(256, 1.0, seed=5))
    st = ParticleState(pos=p, vel=torch.zeros_like(p),
                       acc=torch.zeros_like(p), mass=m,
                       time=torch.zeros((), device=dev))
    g = StepGraph(step)
    with pytest.raises(Exception):
        g(st, 3)
    assert g.graph is None
    torch.cuda.synchronize()
    assert float((p * 2).sum()) == pytest.approx(2 * float(p.sum()))


# ---- phase marks inside the captured step (utils/profiling.py) ----------

# The phases of one captured BH tiles sorted step, in order
STEP_PHASES = ("step.drift", "bh.sort", "bh.placement", "bh.pyramid",
               "bh.far", "bh.sweep", "bh.pickup", "step.kick",
               "graph.copy_back")


def _device_ops(fn, tmp_path, name) -> list:
    """The device operations (Chrome-trace events: kernels, memcpys,
    memsets) one call of ``fn`` queues, traced by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from nbody_tpu_torch.utils.profiling import DEVICE_CATS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # fn's first kernel starts on a busy card: the trace may leave out
        # a kernel that starts on an idle one as the profiler starts
        torch.cuda._sleep(1_000_000)
        fn()
        torch.cuda.synchronize()
    path = tmp_path / f"{name}.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
            and "spin_kernel" not in e.get("name", "")]


def test_step_graph_phase_marks(dev, tmp_path):
    """A captured BH tiles sorted step queues as many kernels a replay with
    the profiling switch off or on as with the switch never touched: the
    same graph. Captured at trace it queues that many plus an entry and an
    exit mark for each of its nine phases, the trace names them
    (``MARK_NAME``), every device operation of the replay lies in a phase,
    and the phases sum to the replay's device time."""
    from nbody_tpu_torch.ops.step_graph import StepGraph
    from nbody_tpu_torch.utils import profiling as tprof

    ps = _graph_system(dev, "bh tiles")
    state = tint.sorted_state_from(ps.state)
    before = tprof.profiling_enabled()
    kernels = {}
    # a first profiler session of the process may hold earlier kernels
    _device_ops(torch.cuda.synchronize, tmp_path, "profiler")
    try:
        for name, value in (("untouched", before), ("off", False),
                            ("on", True), ("trace", "trace")):
            tprof.set_profiling_enabled(value)
            g = StepGraph(ps._sorted_step)
            g(state, 2)
            ops = _device_ops(g.replay, tmp_path, name)
            kernels[name] = collections.Counter(
                e["name"] for e in ops if e["cat"] == "kernel")
    finally:
        tprof.set_profiling_enabled(before)
    for name in ("off", "on"):
        assert kernels[name] == kernels["untouched"], (
            name, kernels[name] - kernels["untouched"],
            kernels["untouched"] - kernels[name])
    marks = kernels["trace"] - kernels["off"]
    assert kernels["trace"] - marks == kernels["off"]
    assert sum(marks.values()) == 2 * len(STEP_PHASES), marks
    assert all(tprof.MARK_NAME.search(k) for k in marks), marks
    got = tprof.phase_times(ops)
    assert set(got) == set(STEP_PHASES), got
    assert sum(got.values()) == pytest.approx(
        sum(e["dur"] for e in ops) / 1e3)


@pytest.mark.parametrize("call", ["run_steps", "update", "cadence"])
def test_facade_phase_marks_cover_its_calls(dev, tmp_path, call):
    """With the switch at trace before the first capture, every device
    operation of a graphed facade call lies in an inner phase: the
    copy-in, the replays' phases, the clone-out and the readout. The
    facade's own phase (``simulation.run_steps``, ``simulation.update``)
    holds its two marks and nothing else."""
    from nbody_tpu_torch import ParticleSystem
    from nbody_tpu_torch.utils import profiling as tprof

    before = tprof.profiling_enabled()
    try:
        tprof.set_profiling_enabled("trace")
        ps = ParticleSystem()
        ps.initialize(SimulationConfig(
            particle_count=4096, dt=1e-3,
            resort_every=4 if call == "cadence" else 1,
            **GRAPH_ENGINES["bh tiles"][0]), device=dev)
        run = ps.update if call == "update" else (lambda: ps.run_steps(8))
        run()
        run()
        ops = _device_ops(run, tmp_path, call)
    finally:
        tprof.set_profiling_enabled(before)
    got = tprof.phase_times(ops)
    outer = "simulation.update" if call == "update" else \
        "simulation.run_steps"
    inner = {"graph.copy_in", "graph.clone_out", *STEP_PHASES}
    if call != "update":
        inner |= {"graph.readout"}
    assert None not in got, got
    assert set(got) == inner | {outer}, got
    index = tprof.PHASES.index(outer)
    own = [e["dur"] for e in ops
           if (m := tprof.MARK_NAME.search(e["name"])) is not None
           and int(m.group(1)) == index]
    assert len(own) == 2
    assert got[outer] == pytest.approx(sum(own) / 1e3)


# ---- the frozen-grid drivers as captured segments (SegmentGraphs) -------

# (space, engine, knob): the ten frozen-grid drivers the facade can pick
FROZEN_DRIVERS = [(space, engine, knob) for engine in ("bh", "hash")
                  for space, knob in (("row", "cadence"),
                                      ("row", "stale_frac"),
                                      ("table", "cadence"),
                                      ("table", "stale_frac"),
                                      ("table", "repair"))]


def _frozen_scene(dev, engine):
    """(sorted force, table parameters, state with a(t)): the hot BH cube
    of ``_table_case`` (movers every step), or 16384 rows of the hash
    tiles scene at 30·N(0, 1) velocities."""
    if engine == "bh":
        return _table_case(dev, 30.0, cube=True)
    from nbody_tpu_torch import ParticleSystem

    ps = ParticleSystem()
    ps.initialize(SimulationConfig(particle_count=16384, dt=1e-3,
                                   **GRAPH_ENGINES["hash tiles"][0]),
                  device=dev)
    st = ps.state
    rng = np.random.default_rng(33)
    vel = torch.from_numpy((30.0 * rng.normal(size=(st.n, 3))).astype(
        np.float32)).to(dev)
    tp = make_table_step_params(ps.config, device=dev, pos_hint=st.pos)
    assert tp is not None and tp.mode == "hash"
    return ps._sorted_force, tp, ParticleState(
        pos=st.pos, vel=vel, acc=st.acc, mass=st.mass, time=st.time)


def _frozen_driver(space, knob, sf, tp, steps, graphs):
    """The driver of ``knob`` in ``space``, traced where it has a trace;
    cadence 4, audit 0.01 with cap 16, repair with its defaults."""
    dt = 1e-3
    if space == "row":
        if knob == "cadence":
            return tint.make_resort_multi_step(sf, dt, steps, 4, graphs=graphs)
        return tint.make_adaptive_multi_step(
            sf, dt, steps, max_stale_frac=0.01, max_cadence=16,
            with_trace=True, graphs=graphs)
    if knob == "cadence":
        return T.make_table_multi_step(tp, dt, steps, 4, graphs=graphs)
    if knob == "stale_frac":
        return T.make_table_adaptive_multi_step(
            tp, dt, steps, max_stale_frac=0.01, max_cadence=16,
            with_trace=True, graphs=graphs)
    return T.make_table_repair_multi_step(tp, dt, steps, with_trace=True,
                                          graphs=graphs)


def _same_run(got, want, what):
    """States (and traces) bit for bit."""
    if isinstance(want, tuple):
        (got, gtrace), (want, wtrace) = got, want
        for g, w in zip(gtrace, wtrace):
            assert torch.equal(g, w), f"{what}: trace differs"
    _same_state(got, want, what)


@pytest.mark.parametrize("space,engine,knob", FROZEN_DRIVERS)
def test_frozen_graph_equals_eager(dev, space, engine, knob):
    """Each frozen-grid driver on captured segments (a first call: each
    segment's first use eager, then captured; a second call: replays
    only) equals the same driver run eagerly from the same state, state
    and trace bit for bit, with as many host reads and launches; the
    fixed cadence reads the host only at a table re-sort (the side
    buffer's count)."""
    from nbody_tpu_torch.ops.step_graph import SegmentGraphs

    sf, tp, st = _frozen_scene(dev, engine)
    steps = 9
    eager = SegmentGraphs(graphed=False)
    before = {f: f.launches for f in _build.COUNTED}
    want = _frozen_driver(space, knob, sf, tp, steps, eager)(st)
    eager_launches = {f: f.launches - n for f, n in before.items()}
    graphs = SegmentGraphs()
    _same_run(_frozen_driver(space, knob, sf, tp, steps, graphs)(st), want,
              f"{space} {engine} {knob} first call")
    assert graphs.host_reads == eager.host_reads
    caps = {k: s.captures for k, s in graphs.segments.items()}
    assert caps and set(caps.values()) == {1}
    before = {f: f.launches for f in _build.COUNTED}
    _same_run(_frozen_driver(space, knob, sf, tp, steps, graphs)(st), want,
              f"{space} {engine} {knob} replays")
    torch.cuda.synchronize()
    assert {f: f.launches - n for f, n in before.items()} == eager_launches
    assert {k: s.captures for k, s in graphs.segments.items()} == caps
    assert graphs.host_reads == 2 * eager.host_reads
    if knob == "cadence":
        sorts = 1 + (steps - 1) // 4
        assert eager.host_reads == (sorts if space == "table" else 0)


def test_side_bucket_growth_recaptures(dev, monkeypatch):
    """The hash table cadence on a collapsing cube (the CPU test's scene,
    least bucket cut to 16): the side buffer grows once (32 → 256) inside
    the first graphed call, every segment is captured again after it, the
    run equals the eager one bit for bit; a second call keeps the bucket
    and captures only the entry (dropped at the growth, after its use), a
    third nothing."""
    from nbody_tpu_torch.ops.step_graph import SegmentGraphs

    monkeypatch.setattr(T, "SIDE_MIN", 16)
    n = 256
    rng = np.random.default_rng(13)
    pos = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    st = ParticleState(
        pos=torch.from_numpy(pos).to(dev),
        vel=torch.from_numpy((-150.0 * pos).astype(np.float32)).to(dev),
        acc=torch.zeros(n, 3, device=dev), mass=torch.ones(n, device=dev),
        time=torch.zeros((), device=dev))
    tp = T.hash_table_params(cutoff=2.0, cell_size=2.0, d=8, k=8)
    want = T.make_table_multi_step(tp, 1e-3, 5, 2)(st)
    graphs = SegmentGraphs()
    multi = T.make_table_multi_step(tp, 1e-3, 5, 2, graphs=graphs)
    _same_state(multi(st), want, "across the growth")
    assert graphs.state == {"side_cap": 256, "side_grows": 1}
    assert graphs.buffers["side"].shape[0] == 256
    segs = dict(graphs.segments)
    assert ("build", 32) not in segs and ("build", 256) in segs
    _same_state(multi(st), want, "after the growth")
    assert set(graphs.segments) == set(segs) | {"entry"}
    assert all(graphs.segments[k] is s for k, s in segs.items())
    captures = graphs.captures
    _same_state(multi(st), want, "replays only")
    assert graphs.captures == captures
    assert graphs.state == {"side_cap": 256, "side_grows": 1}


def test_segment_capture_failure_raises(dev):
    """A segment that reads the host runs eagerly at its first use, then
    cannot be captured: the call raises (no eager fallback), nothing is
    kept, and the card stays usable."""
    from nbody_tpu_torch.ops.step_graph import SegmentGraphs

    g = SegmentGraphs()
    x = torch.arange(8.0, device=dev)
    g.load(x=x)
    with pytest.raises(Exception):
        g.run("bad", lambda b: {"x": b["x"] + 0.0 * float(b["x"].sum())})
    assert "bad" not in g.segments
    torch.cuda.synchronize()
    assert float((x * 2).sum()) == 56.0


@pytest.mark.parametrize("knob,kind", [
    (dict(resort_every=4), "cadence"),
    (dict(resort_stale_frac=0.01), "adaptive"),
    (dict(resort_repair=True), "table repair")])
def test_frozen_graph_facade_hands_out_no_buffer(dev, monkeypatch, knob,
                                                 kind):
    """Through the facade (BH tiles; repair routed to the table): run_steps
    replays the driver's captured segments (``step_graphs[kind]``), equal
    to ``_multi_step(..., graphed=False)`` bit for bit; a state handed out
    is unchanged after later calls and shares no buffer."""
    import nbody_tpu_torch.system as system

    monkeypatch.setattr(system, "TABLE_ROUTES",
                        system.TABLE_ROUTES | {("bh", "repair")})
    from nbody_tpu_torch import ParticleSystem

    ps = ParticleSystem()
    ps.initialize(SimulationConfig(particle_count=4096, dt=1e-3,
                                   **GRAPH_ENGINES["bh tiles"][0], **knob),
                  device=dev)
    state0 = ps.state
    want = ps._multi_step(5, graphed=False)(state0)
    ps.run_steps(5)
    _same_state(ps.state, want, kind)
    g = ps.step_graphs[kind]
    assert g.segments and all(s.captures == 1 for s in g.segments.values())
    held = ps.state
    copy = {k: getattr(held, k).clone() for k in STATE_FIELDS}
    ps.run_steps(3)
    ps.run_steps(2)
    torch.cuda.synchronize()
    for k in STATE_FIELDS:
        assert torch.equal(getattr(held, k), copy[k]), k
    bufs = {t.untyped_storage().data_ptr() for t in g.buffers.values()}
    assert not {getattr(ps.state, k).untyped_storage().data_ptr()
                for k in STATE_FIELDS} & bufs


# ---- the sharded step as captured segments (parallel/program.py) ---------

# distribution -> the config of a 32K-row sphere (radius 6) that selects it
# on 4 positions
SHARDED_GRAPHS = {
    "ring": dict(force_method=ForceMethod.DIRECT_N2),
    "tree-slabs": dict(force_method=ForceMethod.BARNES_HUT, bh_max_level=5),
    "hash-slabs": dict(force_method=ForceMethod.SPATIAL_HASH,
                       hash_max_grid_dim=16),
    # a grid of 30 does not split over 4
    "replicated-fallback": dict(force_method=ForceMethod.SPATIAL_HASH,
                                hash_max_grid_dim=30, hash_engine="tiles"),
}
SHARDED_N = 32768


def _sharded_case(dev, dist, n=SHARDED_N):
    """(config, mesh of 4 virtual shards of the card, force, state with
    a(0)) of ``dist`` on a sphere of ``n`` rows."""
    import warnings

    from nbody_tpu_torch.parallel import make_mesh, mesh as M
    from nbody_tpu_torch.parallel.step import (
        make_sharded_force_fn,
        sharded_initialize_forces,
    )

    cfg = SimulationConfig(particle_count=n, dt=1e-3,
                           **SHARDED_GRAPHS[dist])
    mesh = make_mesh(4, devices=[dev] * 4)
    p, m = _sphere(n, 6.0, seed=31)
    v = torch.from_numpy(np.random.default_rng(4).normal(
        0.0, 2.0, (n, 3)).astype(np.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the fallback warns by design
        force = make_sharded_force_fn(cfg, mesh, pos_hint=p)
    assert force.distribution == dist
    p, m, v = p.to(dev), m.to(dev), v.to(dev)
    st = M.shard_state(ParticleState(pos=p, vel=v, acc=torch.zeros_like(p),
                                     mass=m, time=torch.zeros((), device=dev)),
                       mesh)
    return cfg, mesh, force, sharded_initialize_forces(st, force)


def _same_shards(got, want, what):
    for i, (a, b) in enumerate(zip(got.shards, want.shards)):
        for k in STATE_FIELDS:
            assert torch.equal(getattr(a, k), getattr(b, k)), \
                f"{what}: position {i}'s {k} differs"


@pytest.mark.parametrize("dist", list(SHARDED_GRAPHS))
def test_sharded_graph_equals_eager(dev, dist):
    """4 steps of ``sharded_multi_step`` on 4 virtual shards of the card:
    two eager runs bit-equal, the graphed run (each stage eager at its
    first use, then captured; replays after) and a replay-only call bit-
    equal to them; one capture a segment, its replays counted, and the
    launch counters of the graphed runs equal to the eager run's."""
    from nbody_tpu_torch.parallel.step import sharded_multi_step

    cfg, mesh, force, state0 = _sharded_case(dev, dist)
    eager = sharded_multi_step(force, cfg.dt, 4, graphed=False)
    before = {f: f.launches for f in _build.COUNTED}
    want = eager(state0)
    torch.cuda.synchronize()
    launches = {f: f.launches - n for f, n in before.items()}
    assert any(launches.values())
    _same_shards(eager(state0), want, f"{dist}: two eager runs")
    graphed = sharded_multi_step(force, cfg.dt, 4)
    for call in ("first call", "replay-only call"):
        before = {f: f.launches for f in _build.COUNTED}
        got = graphed(state0)
        torch.cuda.synchronize()
        assert {f: f.launches - n for f, n in before.items()} == launches, \
            f"{dist} {call}: launch counts"
        _same_shards(got, want, f"{dist} {call}")
    g = graphed.graphs
    assert g.captures == g.segments == sum(
        len(s.segments) for s in g.sets.values())
    assert g.replays == g.segments * (3 + 4)
    assert len(g.sets) == 1 and g.pool_bytes > 0


def test_sharded_graph_through_the_facade(dev, monkeypatch):
    """The facade on 4 virtual shards of the card (its mesh made so):
    run_steps and update() replay the "sharded" segments, equal to the
    eager step bit for bit; set_softening and set_time_step drop them, and
    the next run captures once and equals a fresh eager run."""
    import nbody_tpu_torch.system as system
    from nbody_tpu_torch import ParticleSystem
    from nbody_tpu_torch.parallel import make_mesh
    from nbody_tpu_torch.parallel.step import sharded_verlet_step

    monkeypatch.setattr(system, "_make_mesh", lambda cfg, d: make_mesh(
        cfg.shard_devices, devices=[d] * cfg.shard_devices))
    ps = ParticleSystem()
    ps.initialize(SimulationConfig(particle_count=SHARDED_N, dt=1e-3,
                                   shard_devices=4,
                                   **SHARDED_GRAPHS["tree-slabs"]),
                  device=dev)
    state0 = ps.state
    want = ps._multi_step(3, graphed=False)(state0)
    ps.run_steps(3)
    _same_shards(ps.state, want, "run_steps")
    g = ps.step_graphs["sharded"]
    assert (g.captures, g.replays) == (g.segments, 2 * g.segments)
    # a collective between each two segments (the halo's hops may add more)
    assert g.collectives >= g.segments - 1
    start = ps.state
    ps.update()
    _same_shards(ps.state, sharded_verlet_step(start, ps._force_fn, 1e-3),
                 "update")
    assert ps.step_graphs["sharded"] is g and g.captures == g.segments
    for change in (lambda: ps.set_softening(0.2),
                   lambda: ps.set_time_step(2e-3)):
        change()
        assert ps.step_graphs == {}
        start = ps.state
        want = ps._multi_step(2, graphed=False)(start)
        ps.run_steps(2)
        _same_shards(ps.state, want, "after a setter")
        g = ps.step_graphs["sharded"]
        assert g.captures == g.segments


def test_sharded_graph_capture_failure_raises(dev):
    """A stage that reads the host cannot be captured: the graphed run
    raises (no eager fallback), and the card stays usable."""
    from nbody_tpu_torch.parallel import make_mesh, mesh as M
    from nbody_tpu_torch.parallel.program import ShardedGraphs, Stage

    mesh = make_mesh(2, devices=[dev] * 2)
    p, m = (t.to(dev) for t in _sphere(256, 1.0, seed=5))

    def bad(i, q, c):
        return {"pos": c["pos"] + 0.0 * float(c["pos"].sum()),
                "time": c["time"] + 1.0}

    st = M.shard_state(ParticleState(pos=p, vel=torch.zeros_like(p),
                                     acc=torch.zeros_like(p), mass=m,
                                     time=torch.zeros((), device=dev)), mesh)
    g = ShardedGraphs([Stage("bad", bad)], mesh)
    with pytest.raises(Exception):
        g(st, 3)
    assert g.captures == 0
    torch.cuda.synchronize()
    assert float((p * 2).sum()) == pytest.approx(2 * float(p.sum()))
