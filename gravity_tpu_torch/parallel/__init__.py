"""Multi-device execution on ``torch.distributed``: particle meshes, the
sharded direct sums and the hierarchical ring.

Counterpart of ``gravity_tpu/parallel/`` for its ``mesh``, ``sharded`` and
``multislice`` modules; the halo slab engine (``halo.py``) is a later
bullet of ROADMAP Queue 1 item 5.
"""

from .mesh import (
    DCN_AXIS,
    SHARD_AXIS,
    ParticleMesh,
    initialize_distributed,
    make_particle_mesh,
    num_shards,
    particle_sharding,
    particle_spec,
    replicate_state,
    shard_state,
)
from .multislice import hierarchical_ring_accel
from .sharded import (
    make_sharded_accel2,
    make_sharded_accel_fn,
    make_sharded_rect_accel,
)

__all__ = [
    "DCN_AXIS",
    "SHARD_AXIS",
    "ParticleMesh",
    "hierarchical_ring_accel",
    "initialize_distributed",
    "make_particle_mesh",
    "make_sharded_accel2",
    "make_sharded_accel_fn",
    "make_sharded_rect_accel",
    "num_shards",
    "particle_sharding",
    "particle_spec",
    "replicate_state",
    "shard_state",
]
