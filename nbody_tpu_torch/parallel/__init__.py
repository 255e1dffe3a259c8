"""Particle sharding over a device mesh.

PyTorch counterpart of ``nbody_tpu/parallel/``: the particle axis splits
over the positions of a ``Mesh`` of torch devices, in one process (a
repeated device holds virtual shards) or, with a process group up, across
processes (one rank per card), and explicit collectives move data between
them (``mesh.py``):

  * ring-rotated j-blocks for the all-pairs force (``ring.py``, kernel K1
    per hop);
  * psum energy reductions, the potential on a ring of kernel K5's cross
    form (``step.py``);
  * the psum-combined pyramid for Barnes-Hut and slab-routed near fields
    with chained-ppermute halos, swept by kernel K4's slab form
    (``tree.py``);
  * ``torch.distributed`` initialization and a launcher of local ranks
    (``distributed.py``);
  * each force and step as a fixed sequence of stages split at those
    collectives, on the card each stage a captured CUDA graph replayed
    with the collectives between replays (``program.py``).
"""

from nbody_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_state,
    sharded_device_count,
)
from nbody_tpu_torch.parallel.ring import ring_direct_forces
from nbody_tpu_torch.parallel.step import (
    make_sharded_multi_step,
    make_sharded_step,
    sharded_energy,
)
from nbody_tpu_torch.parallel.tree import (
    sharded_barnes_hut_forces,
    sharded_spatial_hash_forces,
)

__all__ = [
    "make_mesh",
    "shard_state",
    "sharded_device_count",
    "ring_direct_forces",
    "make_sharded_multi_step",
    "make_sharded_step",
    "sharded_energy",
    "sharded_barnes_hut_forces",
    "sharded_spatial_hash_forces",
]
