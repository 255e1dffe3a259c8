"""nbody_tpu_torch.utils.checkpoint: sharding-preserving checkpoints
without orbax (CPU).

The port's counterpart of tests/test_orbax_io.py: its three cases on the
port (round trip, a given step, a missing checkpoint raising
``SerializationError``), an unreadable manifest, an existing step, a save
cut short, and a save by 4 gloo CPU ranks (ONE module-scoped launch of
``tests/torch_ranks.py checkpoint``) restored across the ranks and here
onto 2 and 1 positions and without a template, bit for bit. One case
holds the port's restored arrays equal to the JAX package's orbax round
trip of the same seed's state.
"""

import json

import jax
import numpy as np
import pytest
import torch

import torch_ranks as R
from nbody_tpu.models import init_spherical
from nbody_tpu.utils.orbax_io import HAVE_ORBAX
from nbody_tpu_torch.errors import SerializationError
from nbody_tpu_torch.parallel import make_mesh, mesh as M
from nbody_tpu_torch.state import ParticleState
from nbody_tpu_torch.utils import restore_checkpoint, save_checkpoint
from nbody_tpu_torch.utils.checkpoint import latest_step

FIELDS = ("pos", "vel", "acc", "mass", "time")


def _state(n, seed):
    rng = np.random.default_rng(seed)
    return ParticleState.from_numpy(
        rng.normal(size=(n, 3)), rng.normal(size=(n, 3)),
        acc=rng.normal(size=(n, 3)), mass=rng.uniform(0.5, 1.5, n),
        time=0.125 * seed, device="cpu")


def _equal(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_round_trip(tmp_path):
    state = _state(256, 1)
    save_checkpoint(str(tmp_path / "ckpt"), state, step=3)
    restored = restore_checkpoint(str(tmp_path / "ckpt"))
    assert restored.device.type == "cpu"
    _equal(restored, state)


def test_restore_specific_step(tmp_path):
    s1, s2 = _state(64, 1), _state(64, 2)
    save_checkpoint(str(tmp_path / "c"), s1, step=1)
    save_checkpoint(str(tmp_path / "c"), s2, step=2)
    assert latest_step(str(tmp_path / "c")) == 2
    _equal(restore_checkpoint(str(tmp_path / "c"), step=1), s1)
    _equal(restore_checkpoint(str(tmp_path / "c"), step=2), s2)
    _equal(restore_checkpoint(str(tmp_path / "c")), s2)


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(SerializationError):
        restore_checkpoint(str(tmp_path / "nope"))
    save_checkpoint(str(tmp_path / "c"), _state(8, 1), step=1)
    with pytest.raises(SerializationError, match="step 7"):
        restore_checkpoint(str(tmp_path / "c"), step=7)


@pytest.mark.parametrize("manifest", [
    "{not json", json.dumps({"format": "other", "version": 1, "rows": 8,
                             "positions": 1}),
    json.dumps({"format": "nbody_tpu_torch.checkpoint", "version": 1,
                "rows": 8, "positions": 3}),
], ids=["garbage", "foreign", "rows-do-not-split"])
def test_unreadable_manifest_raises(tmp_path, manifest):
    save_checkpoint(str(tmp_path / "c"), _state(8, 1), step=4)
    (tmp_path / "c" / "4" / "manifest.json").write_text(manifest)
    with pytest.raises(SerializationError, match="manifest"):
        restore_checkpoint(str(tmp_path / "c"))


def test_existing_step_and_cut_save(tmp_path):
    """A step is written once; a temporary directory left by a save cut
    short is no step."""
    root = tmp_path / "c"
    save_checkpoint(str(root), _state(8, 1), step=4)
    with pytest.raises(SerializationError, match="exists"):
        save_checkpoint(str(root), _state(8, 2), step=4)
    (root / ".tmp-9").mkdir()
    (root / ".tmp-9" / "pos.0.npy").write_bytes(b"cut")
    assert latest_step(str(root)) == 4
    assert sorted(p.name for p in root.iterdir()) == [".tmp-9", "4"]


@pytest.mark.skipif(not HAVE_ORBAX, reason="orbax unavailable")
def test_matches_the_jax_orbax_round_trip(tmp_path):
    """The JAX package's orbax round trip and the port's of the same
    seed's state give the same arrays."""
    from nbody_tpu.utils import orbax_io

    jstate = init_spherical(jax.random.PRNGKey(42), 256)
    orbax_io.save_checkpoint(str(tmp_path / "orbax"), jstate, step=3)
    want = orbax_io.restore_checkpoint(str(tmp_path / "orbax"))
    state = ParticleState(**{f: torch.from_numpy(np.array(getattr(jstate, f)))
                             for f in FIELDS})
    save_checkpoint(str(tmp_path / "port"), state, step=3)
    got = restore_checkpoint(str(tmp_path / "port"))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """4 gloo ranks, one position each, saved ``checkpoint_state()`` at
    ``CHECKPOINT_STEP`` and restored it with their state as template."""
    out = tmp_path_factory.mktemp("ckpt_ranks")
    return R.launch("checkpoint", out, timeout=120), str(out / "ckpt")


def test_sharded_save_restores_across_the_ranks(ranks):
    outs, _ = ranks
    for r, o in enumerate(outs):
        assert o["local"] == [r] and o["restored_size"] == R.WORLD
        for saved, back in zip(o["saved"], o["restored"]):
            for f in FIELDS:
                assert torch.equal(back[f], saved[f]), f


@pytest.mark.parametrize("positions", [2, 1])
def test_sharded_save_restores_onto_fewer_positions(ranks, positions):
    """Onto a one-process mesh of 2 or 1 positions: each position's rows
    are the state's, bit for bit."""
    _, ckpt = ranks
    state = R.checkpoint_state()
    mesh = make_mesh(positions, devices=["cpu"] * positions)
    template = M.shard_state(_state(state.n, 9), mesh)
    back = restore_checkpoint(ckpt, template=template)
    assert back.mesh is mesh and len(back.shards) == positions
    _equal(M.gather_state(back), state)
    want = M.shard_state(state, mesh)
    for a, b in zip(back.shards, want.shards):
        _equal(a, b)


def test_sharded_save_restores_without_template(ranks):
    _, ckpt = ranks
    back = restore_checkpoint(ckpt, step=R.CHECKPOINT_STEP)
    assert isinstance(back, ParticleState)
    _equal(back, R.checkpoint_state())
    with pytest.raises(SerializationError, match="rows"):
        restore_checkpoint(ckpt, template=_state(8, 1))
