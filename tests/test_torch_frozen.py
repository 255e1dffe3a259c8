"""Frozen-grid forces of nbody_tpu_torch (Barnes-Hut tiles and hash tiles)
against the JAX package's ``barnes_hut_forces_frozen`` and
``spatial_hash_forces_tiles_frozen`` (interpret-mode Pallas on the CPU), on
the same numpy inputs.

One module-scoped fixture per engine holds the JAX side: the sorted call
with its ``FrozenGridMeta`` and one audited frozen call on moved rows
(0.3·N(0, 1) per coordinate, from numpy), the four interpret-mode calls of
this file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import barnes_hut as jbh
from nbody_tpu.ops import spatial_hash as jsh
from nbody_tpu_torch.ops import barnes_hut as tbh
from nbody_tpu_torch.ops import spatial_hash as tsh

N, G, EPS, THETA = 512, 1.0, 0.1, 0.5
BH_KW = dict(levels=3, near_k=8, multipole_order=2)
HASH_KW = dict(cutoff=2.0, cell_size=2.0, d=8, k=8)


def _sphere(seed=3, radius=5.0):
    rng = np.random.default_rng(seed)
    r = np.cbrt(rng.uniform(size=N)) * radius
    v = rng.normal(size=(N, 3))
    pos = v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None]
    return pos.astype(np.float32), rng.uniform(0.5, 1.5, N).astype(np.float32)


def _cube(seed=4, half=6.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-half, half, (N, 3)).astype(np.float32)
    return pos, rng.uniform(0.5, 1.5, N).astype(np.float32)


def _moved(psort, seed):
    rng = np.random.default_rng(seed)
    out = np.array(psort, dtype=np.float32)
    out[:, :3] += (0.3 * rng.normal(size=(N, 3))).astype(np.float32)
    return out


def _jax_side(sorted_fn, frozen_fn, scene, seed):
    """The JAX sorted call with meta, then its audited frozen call on the
    meta's rows moved by numpy noise."""
    pos, mass = scene
    acc, psort, _order, meta = sorted_fn(jnp.asarray(pos), jnp.asarray(mass))
    moved = _moved(np.asarray(psort), seed)
    acc_f, stale = frozen_fn(jnp.asarray(moved), meta)
    return dict(pos=pos, mass=mass, acc=np.asarray(acc),
                psort=np.asarray(psort), ids=np.asarray(meta.ids),
                rank=np.asarray(meta.rank), moved=moved,
                acc_frozen=np.asarray(acc_f), stale=int(stale))


@pytest.fixture(scope="module")
def bh():
    jkw = dict(BH_KW, near_impl="pallas_interpret")
    return _jax_side(
        lambda p, m: jbh.barnes_hut_forces_sorted(
            p, m, G, EPS, THETA, with_grid_meta=True, **jkw),
        lambda p, meta: jbh.barnes_hut_forces_frozen(
            p, meta, G, EPS, THETA, with_audit=True, **jkw),
        _sphere(), seed=9)


@pytest.fixture(scope="module")
def hash_():
    jkw = dict(HASH_KW, impl="pallas_interpret")
    return _jax_side(
        lambda p, m: jsh.spatial_hash_forces_tiles_sorted(
            p, m, G, EPS, with_grid_meta=True, **jkw),
        lambda p, meta: jsh.spatial_hash_forces_tiles_frozen(
            p, meta, G, EPS, with_audit=True, **jkw),
        _cube(), seed=10)


def _port(engine):
    """(sorted-with-meta, frozen) of the port for one engine."""
    if engine == "bh":
        return (lambda p, m: tbh.barnes_hut_forces_sorted(
                    p, m, G, EPS, THETA, with_grid_meta=True, **BH_KW),
                lambda p, meta, **kw: tbh.barnes_hut_forces_frozen(
                    p, meta, G, EPS, THETA, **BH_KW, **kw))
    return (lambda p, m: tsh.spatial_hash_forces_tiles_sorted(
                p, m, G, EPS, with_grid_meta=True, **HASH_KW),
            lambda p, meta, **kw: tsh.spatial_hash_forces_tiles_frozen(
                p, meta, G, EPS, **HASH_KW, **kw))


def _recount(moved, ids, engine, lo, cell):
    """Rows whose cell under the frozen binning differs from ``ids``,
    recounted in numpy (the Barnes-Hut bins truncate toward zero, the
    hash bins floor)."""
    d = (1 << BH_KW["levels"]) if engine == "bh" else HASH_KW["d"]
    x = (moved[:, :3] - lo) / cell
    c = np.clip(x.astype(np.int32) if engine == "bh"
                else np.floor(x).astype(np.int32), 0, d - 1)
    return int(((c[:, 0] * d + c[:, 1]) * d + c[:, 2] != ids).sum())


@pytest.mark.parametrize("engine", ["bh", "hash"])
def test_meta_matches_jax(engine, request):
    """The port's sorted rows and its meta's ids and ranks equal the JAX
    meta's exactly (both sort stably by the same int32 ids)."""
    j = request.getfixturevalue("bh" if engine == "bh" else "hash_")
    sorted_fn, _ = _port(engine)
    _acc, psort, _order, meta = sorted_fn(torch.from_numpy(j["pos"]),
                                          torch.from_numpy(j["mass"]))
    np.testing.assert_array_equal(psort.numpy(), j["psort"])
    np.testing.assert_array_equal(meta.ids.numpy(), j["ids"])
    np.testing.assert_array_equal(meta.rank.numpy(), j["rank"])


@pytest.mark.parametrize("engine", ["bh", "hash"])
def test_frozen_fresh_meta_is_the_sorted_step(engine):
    """frozen(psort, fresh meta) is the port's sorted step bit for bit,
    and its audit reads 0."""
    pos, mass = _sphere() if engine == "bh" else _cube()
    sorted_fn, frozen_fn = _port(engine)
    acc, psort, _order, meta = sorted_fn(torch.from_numpy(pos),
                                         torch.from_numpy(mass))
    acc_f, stale = frozen_fn(psort, meta, with_audit=True)
    assert torch.equal(acc_f, acc)
    assert int(stale) == 0


@pytest.mark.parametrize("engine", ["bh", "hash"])
def test_frozen_on_moved_rows_matches_jax(engine, request):
    """frozen on the moved rows against the JAX frozen function on the
    same rows: every row within atol 2e-5·max|a| (the BH parity tests'
    tolerance; f32 sums in another order). The audit equals the JAX count
    and a numpy recount on the port's frozen binning, and is non-zero."""
    j = request.getfixturevalue("bh" if engine == "bh" else "hash_")
    sorted_fn, frozen_fn = _port(engine)
    _acc, _psort, _order, meta = sorted_fn(torch.from_numpy(j["pos"]),
                                           torch.from_numpy(j["mass"]))
    acc_f, stale = frozen_fn(torch.from_numpy(j["moved"]), meta,
                             with_audit=True)
    want = j["acc_frozen"]
    np.testing.assert_allclose(acc_f.numpy(), want, rtol=0,
                               atol=2e-5 * float(np.abs(want).max()))
    recount = _recount(j["moved"], j["ids"], engine, meta.lo.numpy(),
                       float(meta.cell))
    assert int(stale) == j["stale"] == recount > 0
