"""Multi-device execution on ``torch.distributed``: particle meshes, the
sharded direct sums, the hierarchical ring, the halo slab engine and the
sharded FMM forms.

Counterpart of ``gravity_tpu/parallel/`` for its ``mesh``, ``sharded``,
``multislice`` and ``halo`` modules, and of the sharded forms of
``gravity_tpu/ops/fmm.py`` and ``ops/sfmm.py``.
"""

from .halo import (
    halo_comm_model,
    make_halo_nlist_accel,
    resolve_halo_sizing,
    resolve_mig_cap,
)
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
from .sharded_fmm import make_sharded_fmm_accel, make_sharded_sfmm_accel

__all__ = [
    "DCN_AXIS",
    "SHARD_AXIS",
    "ParticleMesh",
    "halo_comm_model",
    "hierarchical_ring_accel",
    "initialize_distributed",
    "make_halo_nlist_accel",
    "make_particle_mesh",
    "make_sharded_accel2",
    "make_sharded_accel_fn",
    "make_sharded_fmm_accel",
    "make_sharded_rect_accel",
    "make_sharded_sfmm_accel",
    "num_shards",
    "particle_sharding",
    "particle_spec",
    "replicate_state",
    "resolve_halo_sizing",
    "resolve_mig_cap",
    "shard_state",
]
