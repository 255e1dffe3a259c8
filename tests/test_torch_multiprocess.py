"""nbody_tpu_torch.parallel on a mesh across processes (CPU, gloo).

ONE module-scoped launch of 4 gloo CPU ranks (``tests/torch_ranks.py
mesh``, started by ``parallel.distributed.run_ranks``) runs every case;
the tests read the ranks' outputs. Each rank holds one position of a
4-position mesh, and two of an 8-position one (the chained halo). Every
result is held bit for bit to the one-process mesh of the same positions
as virtual CPU shards, computed here by the same functions with one
intra-op thread, as the ranks run; the direct-N² facade also to the JAX
facade sharded over 4 of the conftest's virtual devices (atol 1e-5 on pos
and vel, rtol 1e-5 on the energy, as ``test_sharded_facade_matches_jax_
facade``).
"""

import contextlib
import sys
import time

import numpy as np
import pytest
import torch

import nbody_tpu as jnb
import torch_ranks as R
from nbody_tpu.state import SimulationState as JSnapshot
from nbody_tpu_torch.parallel import make_mesh
from nbody_tpu_torch.parallel.distributed import run_ranks
from nbody_tpu_torch.utils.serialization import Serializer

WORLD = R.WORLD


@contextlib.contextmanager
def one_thread():
    """One intra-op thread, as each rank runs, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' outputs, by rank, and their output directory."""
    out = tmp_path_factory.mktemp("ranks")
    return R.launch("mesh", out, timeout=240), out


@pytest.fixture(scope="module")
def ref():
    """The same functions on one-process meshes of virtual CPU shards."""
    with one_thread():
        mesh4 = make_mesh(4, devices=["cpu"] * 4)
        mesh8 = make_mesh(8, devices=["cpu"] * 8)
        out = {"coll4": R.collectives(mesh4), "coll8": R.collectives(mesh8),
               **R.forces(mesh4), **R.forces(mesh8), **R.energy(mesh4),
               "facade": R.facades()}
    return out


def test_global_device_info_counts_every_rank(ranks):
    """No card on a CPU rank: 0 everywhere. With rank r reporting r cards,
    the global count is their sum, 6, not r × 4."""
    outs, _ = ranks
    for r, o in enumerate(outs):
        assert o["info"] == {"process_index": r, "process_count": WORLD,
                             "local_devices": 0, "global_devices": 0}
        assert o["info_uneven"] == {"process_index": r,
                                    "process_count": WORLD,
                                    "local_devices": r, "global_devices": 6}


def test_mesh_spans_the_ranks(ranks):
    """Positions rank-major: rank r holds [r·L, (r + 1)·L)."""
    outs, _ = ranks
    for r, o in enumerate(outs):
        assert o["local4"] == [r]
        assert o["local8"] == [2 * r, 2 * r + 1]
        assert o["facade"]["ring"]["local_positions"] == 1
        assert o["facade"]["ring"]["size"] == 4


@pytest.mark.parametrize("which", ["coll4", "coll8"],
                         ids=["1-position-a-rank", "2-positions-a-rank"])
def test_collectives_match_one_process(ranks, ref, which):
    """psum/pmin/pmax, all_to_all, all_gather and ppermute by 1, −1 and 2:
    each rank's result at its position q equals the one-process result
    at q, bit for bit."""
    outs, _ = ranks
    want = ref[which]
    for o in outs:
        for op, got in o[which].items():
            local = o["local4"] if which == "coll4" else o["local8"]
            assert len(got) == len(local)
            for i, q in enumerate(local):
                assert torch.equal(got[i], want[op][q]), (op, q)


@pytest.mark.parametrize("what", ["ring", "bh", "hash", "halo"])
def test_forces_match_one_process(ranks, ref, what):
    """The ring (K1's twin by hop), tree-slabs (order 2, d 8 over 4
    slabs), hash-slabs and the chained halo (8 slabs of one plane over 4
    ranks × 2 positions, ws 2 > S): the gathered accelerations on every
    rank equal the one-process mesh's bit for bit."""
    outs, _ = ranks
    for o in outs:
        assert torch.equal(o[what], ref[what])


@pytest.mark.parametrize("what", ["bh_overflow", "hash_overflow",
                                  "halo_overflow", "routing_overflow"])
def test_overflow_counts_match_one_process(ranks, ref, what):
    """The psum'd overflow counts: 0 for the three paths, and the routing
    overflow at a capacity of 4 rows (> 0) the same on every rank."""
    outs, _ = ranks
    assert (ref[what] > 0) == (what == "routing_overflow")
    assert [o[what] for o in outs] == [ref[what]] * WORLD


def test_energy_matches_one_process(ranks, ref):
    outs, _ = ranks
    for o in outs:
        assert torch.equal(o["ke"], ref["ke"])
        assert torch.equal(o["pe"], ref["pe"])


@pytest.mark.parametrize("path", ["ring", "tree"])
def test_facade_matches_one_process(ranks, ref, path):
    """``ParticleSystem`` with ``shard_devices=4`` on 4 ranks: after 3
    ``run_steps`` every rank reads the one-process facade's positions,
    velocities and energies, bit for bit; ``devices`` counts the 4
    processes."""
    outs, _ = ranks
    want = ref["facade"][path]
    assert want["distribution"] == ("ring" if path == "ring"
                                    else "tree-slabs")
    for o in outs:
        got = o["facade"][path]
        assert torch.equal(got["pos"], want["pos"])
        assert torch.equal(got["vel"], want["vel"])
        for key in ("ke", "pe", "total", "time", "n", "distribution"):
            assert got[key] == want[key], key
        assert got["devices"] == WORLD and want["devices"] == 1


def test_facade_matches_jax_facade(ranks):
    """The direct-N² facade across 4 ranks against the JAX facade sharded
    over 4 virtual devices, from one shared state."""
    outs, _ = ranks
    pos, vel, mass = R.facade_state()
    js = jnb.ParticleSystem()
    js._config = jnb.SimulationConfig(shard_devices=4)
    js.set_state(JSnapshot(pos=pos, vel=vel, mass=mass,
                           force_method=jnb.ForceMethod.DIRECT_N2, dt=1e-3,
                           G=1.0, softening=0.1))
    js.run_steps(R.FACADE_STEPS)
    got = outs[0]["facade"]["ring"]
    np.testing.assert_allclose(got["pos"].numpy(), js.positions(), atol=1e-5)
    np.testing.assert_allclose(got["vel"].numpy(), js.velocities(),
                               atol=1e-5)
    np.testing.assert_allclose(got["total"], js.compute_total_energy(),
                               rtol=1e-5)


def test_save_state_writes_once_on_rank_0(ranks):
    """``save_state`` on the mesh across processes: one file, the logical
    rows every rank reads."""
    outs, out = ranks
    snap = Serializer.load(str(out / "facade.nbody"))
    assert snap.particle_count == 200
    np.testing.assert_array_equal(snap.pos, outs[0]["facade"]["ring"]["pos"])
    np.testing.assert_array_equal(snap.vel, outs[3]["facade"]["ring"]["vel"])


FAIL_RANK_2 = ("import os, sys, time\n"
               "if os.environ['RANK'] == '2':\n"
               "    raise SystemExit(3)\n"
               "time.sleep(60)\n")


@pytest.mark.parametrize("code,timeout,match", [
    (FAIL_RANK_2, 50, "rank 2 exit code 3"),
    ("import time; time.sleep(60)", 1, r"ranks \[0, 1, 2, 3\] still running"),
], ids=["rank-raises", "ranks-hang"])
def test_failed_or_hung_ranks_fail_the_launch(code, timeout, match):
    """A rank that fails ends the launch at once, the others killed; ranks
    that never end are killed at the deadline. Either way ``run_ranks``
    raises well before the ranks' own 60 s."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        run_ranks([sys.executable, "-c", code], WORLD, timeout=timeout)
    assert time.monotonic() - t0 < 30
