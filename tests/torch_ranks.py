"""Rank programs of the multi-process CPU tests (not a test module).

    python tests/torch_ranks.py {mesh|checkpoint} OUT_DIR

is started once per rank by ``nbody_tpu_torch.parallel.distributed.
run_ranks`` (torchrun's environment), brings up a gloo group of CPU ranks
with one intra-op thread (so per-position sums are the one-process
mesh's, bit for bit) and writes ``OUT_DIR/rank<r>.pt``, a dict of tensors
and numbers that the tests read with ``torch.load(weights_only=True)``.
The scenes and parameters live here so the tests build their
one-process references from the same values. Imports torch, numpy and
the port only.
"""

import os
import sys
from pathlib import Path

import numpy as np
import torch

WORLD = 4
N = 256
BH_KW = dict(G=1.0, softening=0.1, theta=0.5, levels=3, near_k=8)
HALO_KW = dict(BH_KW, theta=0.25, near_k=16)
HASH_KW = dict(G=1.0, softening=0.1, cutoff=1.5, cell_size=1.5, cap=8,
               max_per_cell=16)
FACADE_STEPS = 3
CHECKPOINT_STEP = 5


def ball(n=N, radius=4.0, seed=13):
    """A uniform ball: (pos, vel, mass) float32 numpy."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = u * radius * np.cbrt(rng.uniform(size=(n, 1)))
    vel = rng.normal(0.0, 0.3, (n, 3))
    mass = rng.uniform(0.5, 1.5, n)
    return (pos.astype(np.float32), vel.astype(np.float32),
            mass.astype(np.float32))


def collective_inputs(p):
    """``p`` random (p, 3) blocks for the collectives (all_to_all takes
    a leading axis of p)."""
    rng = np.random.default_rng(2)
    return [torch.from_numpy(rng.normal(size=(p, 3)).astype(np.float32))
            for _ in range(p)]


def facade_state():
    """The shared state of the direct-N² facade runs (and of the JAX
    facade they are held to)."""
    rng = np.random.default_rng(17)
    pos = rng.uniform(-3, 3, (200, 3)).astype(np.float32)
    vel = rng.normal(0, 0.2, (200, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, 200).astype(np.float32)
    return pos, vel, mass


def collectives(mesh):
    """Every collective on this process's blocks of
    ``collective_inputs(mesh.size)``."""
    from nbody_tpu_torch.parallel import mesh as M

    xs = collective_inputs(mesh.size)
    mine = [xs[q] for q in mesh.local]
    out = {"psum": M.psum(mine, mesh), "pmin": M.pmin(mine, mesh),
           "pmax": M.pmax(mine, mesh), "all_to_all": M.all_to_all(mine, mesh),
           "all_gather": M.all_gather(mine, mesh)}
    for shift in (1, -1, 2):
        out[f"ppermute{shift}"] = M.ppermute(mine, mesh, shift)
    return out


def forces(mesh):
    """Ring, tree-slabs, the chained halo (when the mesh has 8
    positions), hash-slabs and the routing overflow on ``ball()``:
    global tensors (gathered) and overflow counts."""
    import nbody_tpu_torch.parallel as tpar
    from nbody_tpu_torch.parallel import mesh as M

    pos, _, mass = (torch.from_numpy(a) for a in ball())
    ps, ms = M.split(pos, mesh), M.split(mass, mesh)

    def glob(blocks):
        return M.gather_global(blocks, mesh)

    if mesh.size == 8:
        acc, over = tpar.sharded_barnes_hut_forces(
            ps, ms, mesh, return_overflow=True, **HALO_KW)
        return {"halo": glob(acc), "halo_overflow": int(over)}
    out = {"ring": glob(tpar.ring_direct_forces(ps, ms, mesh, 1.0, 0.1))}
    acc, over = tpar.sharded_barnes_hut_forces(
        ps, ms, mesh, return_overflow=True, **BH_KW)
    out.update(bh=glob(acc), bh_overflow=int(over))
    acc, over = tpar.sharded_spatial_hash_forces(
        ps, ms, mesh, return_overflow=True, **HASH_KW)
    out.update(hash=glob(acc), hash_overflow=int(over))
    _, over = tpar.sharded_spatial_hash_forces(
        ps, ms, mesh, capacity=4, return_overflow=True, **HASH_KW)
    out["routing_overflow"] = int(over)
    return out


def energy(mesh):
    import nbody_tpu_torch.parallel as tpar
    from nbody_tpu_torch.parallel import mesh as M
    from nbody_tpu_torch.state import ParticleState

    pos, vel, mass = ball()
    st = M.shard_state(
        ParticleState.from_numpy(pos, vel, mass=mass, device="cpu"), mesh)
    ke, pe = tpar.sharded_energy(st, mesh, 1.0, 0.1)
    return {"ke": ke, "pe": pe}


def facades(out_dir=None):
    """``run_steps(FACADE_STEPS)`` of the facade sharded over 4 on the CPU:
    direct N² from ``facade_state()`` and Barnes-Hut tree-slabs
    (``bh_max_level`` 3) from the seed. With ``out_dir`` the direct run
    also saves its state to ``out_dir/facade.nbody``."""
    from nbody_tpu_torch.state import SimulationState
    from nbody_tpu_torch.system import ParticleSystem
    from nbody_tpu_torch.types import ForceMethod, SimulationConfig

    pos, vel, mass = facade_state()
    ring = ParticleSystem()
    ring._config = SimulationConfig(shard_devices=4)
    ring.set_state(SimulationState(pos=pos, vel=vel, mass=mass,
                                   force_method=ForceMethod.DIRECT_N2,
                                   dt=1e-3, G=1.0, softening=0.1),
                   device="cpu")
    tree = ParticleSystem()
    tree.initialize(SimulationConfig(
        particle_count=200, dt=1e-3, shard_devices=4, seed=7,
        force_method=ForceMethod.BARNES_HUT, bh_max_level=3), device="cpu")
    out = {}
    for name, s in (("ring", ring), ("tree", tree)):
        s.run_steps(FACADE_STEPS)
        diag = s.diagnostics()
        out[name] = {
            "pos": torch.from_numpy(s.positions()),
            "vel": torch.from_numpy(s.velocities()),
            "ke": s.compute_kinetic_energy(),
            "pe": s.compute_potential_energy(),
            "total": s.compute_total_energy(),
            "time": s.simulation_time, "n": s.state.n,
            "local_positions": len(s.mesh.devices), "size": s.mesh.size,
            "distribution": diag["force_distribution"],
            "devices": diag["devices"],
        }
    if out_dir is not None:
        ring.save_state(str(Path(out_dir) / "facade.nbody"))
    return out


def run_mesh(out_dir):
    from nbody_tpu_torch.parallel import distributed, make_mesh

    out = {"info": distributed.global_device_info()}
    rank = out["info"]["process_index"]
    real = distributed.local_cards
    # each rank reports `rank` cards: the sum must be 0+1+2+3, not
    # (this rank's count) × 4
    distributed.local_cards = lambda: [torch.device("cuda", 0)] * rank
    try:
        out["info_uneven"] = distributed.global_device_info()
    finally:
        distributed.local_cards = real
    mesh4 = make_mesh(4, devices=["cpu"])
    mesh8 = make_mesh(8, devices=["cpu"] * 2)
    out["local4"], out["local8"] = list(mesh4.local), list(mesh8.local)
    out["coll4"], out["coll8"] = collectives(mesh4), collectives(mesh8)
    out.update(forces(mesh4))
    out.update(forces(mesh8))
    out.update(energy(mesh4))
    out["facade"] = facades(out_dir)
    return out


def checkpoint_state():
    """The state the checkpoint ranks save: ``ball()`` with accelerations
    and a time."""
    from nbody_tpu_torch.state import ParticleState

    pos, vel, mass = ball()
    rng = np.random.default_rng(3)
    return ParticleState.from_numpy(
        pos, vel, acc=rng.normal(size=pos.shape), mass=mass, time=0.25,
        device="cpu")


def run_checkpoint(out_dir):
    from nbody_tpu_torch.parallel import make_mesh, mesh as M
    from nbody_tpu_torch.utils import restore_checkpoint, save_checkpoint

    mesh = make_mesh(4, devices=["cpu"])
    sh = M.shard_state(checkpoint_state(), mesh)
    ckpt = str(Path(out_dir) / "ckpt")
    save_checkpoint(ckpt, sh, step=CHECKPOINT_STEP)
    back = restore_checkpoint(ckpt, template=sh)
    fields = ("pos", "vel", "acc", "mass", "time")
    return {
        "local": list(mesh.local),
        "saved": [{f: getattr(s, f) for f in fields} for s in sh.shards],
        "restored": [{f: getattr(s, f) for f in fields}
                     for s in back.shards],
        "restored_size": back.mesh.size,
    }


def launch(scenario, out_dir, timeout):
    """Run ``scenario`` on WORLD gloo CPU ranks (the repository on their
    path); the ranks' outputs, by rank."""
    from nbody_tpu_torch.parallel.distributed import run_ranks

    here = Path(__file__).resolve()
    path = os.pathsep.join(filter(None, [str(here.parent.parent),
                                         os.environ.get("PYTHONPATH")]))
    run_ranks([sys.executable, str(here), scenario, str(out_dir)], WORLD,
              timeout=timeout, env={**os.environ, "PYTHONPATH": path})
    return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=True)
            for r in range(WORLD)]


def main(argv):
    scenario, out_dir = argv
    from nbody_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    if not distributed.initialize_distributed(backend="gloo", timeout=60):
        raise SystemExit("no process group: start through run_ranks")
    run = {"mesh": run_mesh, "checkpoint": run_checkpoint}[scenario]
    out = run(out_dir)
    rank = distributed.process_world()[0]
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    distributed.barrier()
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
