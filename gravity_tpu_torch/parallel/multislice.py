"""The hierarchical ring of a two-axis (S, P/S) mesh.

Counterpart of ``gravity_tpu/parallel/multislice.py``. The outer (``dcn``)
axis is the slow link between groups of devices (hosts, or slices on a
TPU), the inner (``shard``) axis the fast one inside a group:

1. the ranks of the outer axis gather their source shards once an
   evaluation, (S n_local, 3) in outer-coordinate order;
2. the ring of :func:`.sharded.ring_sum` runs over the inner axis with
   those stacked sources, so every hop's copy stays on the fast link.
"""

from __future__ import annotations

from .mesh import ParticleMesh, all_gather_rows
from .sharded import ring_sum


def hierarchical_ring_accel(pos_l, m_l, *, mesh: ParticleMesh,
                            local_kernel):
    src_pos = all_gather_rows(pos_l, mesh.outer_group)
    src_m = all_gather_rows(m_l, mesh.outer_group)
    return ring_sum(pos_l, src_pos, src_m, ranks=mesh.inner_ranks,
                    rank=mesh.rank, group=mesh.inner_group,
                    local_kernel=local_kernel)
