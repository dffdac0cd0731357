"""The sharded FMM forms: ``(pos_l, m_l) -> acc_l`` with the cell passes
split over the world.

Counterpart of ``make_sharded_fmm_accel`` (``gravity_tpu/ops/fmm.py``) and
``make_sharded_sfmm_accel`` (``gravity_tpu/ops/sfmm.py``). The build is
replicated and the dominant cell passes are split:

- every rank gathers the world's positions and masses and rebuilds the
  octree, the cell arrays and the coarse expansions (O(N));
- each rank runs ``ops/fmm.cell_pass`` on its own contiguous share of the
  target cells: the dense grid's whole x-slabs
  (:class:`~gravity_tpu_torch.ops.fmm.SlabShare`), the sparse layout's K
  chunks (:class:`~gravity_tpu_torch.ops.fmm.ChunkShare`, with the JAX
  package's ``k_eff`` and ``k_chunk_eff``,
  :func:`~gravity_tpu_torch.ops.sfmm.sharded_k_sizing`);
- the per-cell outputs are all-gathered in rank order;
- the per-particle evaluation runs on every rank, and each rank keeps its
  own rows.

The split is by cells, not by rows: every rank bins every target, so the
slot overflow pattern is the unsharded one, and a sharded evaluation has
the unsharded evaluation's bits on any world. The functions are
collectives: every rank calls them in the same order.

Differentiable where the JAX forms are (``jax.grad`` transposes their
``all_gather``s): the gathers here are :class:`~.mesh.AllGatherRows`, whose
backward reduce-scatters the cotangent by rows, the rest is PyTorch's own
differentiation of the plain cell passes (``cells.SegmentSumRows`` for the
bf16 sums). A rank's loss is the sum over its own rows, so the world's
gradient of the summed loss reaches each rank's rows, the unsharded
gradient's on any world.
"""

from __future__ import annotations

from ..constants import CUTOFF_RADIUS, G
from ..ops import fmm, sfmm
from .mesh import ParticleMesh, all_gather_rows


def make_sharded_fmm_accel(mesh: ParticleMesh, *, depth: int,
                           leaf_cap: int = 32, ws: int = 1, g: float = G,
                           cutoff: float = CUTOFF_RADIUS, eps: float = 0.0,
                           order: int = 2, quad: bool = True):
    """The dense-grid FMM on ``mesh``: x-slabs of the leaf grid a rank. A
    world that does not divide the 2^depth slabs is refused here, with the
    JAX package's message."""
    share = fmm.SlabShare(mesh.rank, mesh.size, depth)

    def accel(pos_l, m_l):
        pos, m = all_gather_rows(pos_l), all_gather_rows(m_l)
        acc = fmm._dense_eval(pos, pos, m, depth=depth, leaf_cap=leaf_cap,
                              t_cap=leaf_cap, ws=ws, g=g, cutoff=cutoff,
                              eps=eps, order=order, quad=quad, form="self",
                              share=share)
        return acc[mesh.rows(pos.shape[0])]

    return accel


def make_sharded_sfmm_accel(mesh: ParticleMesh, *, depth: int,
                            leaf_cap: int = 32, k_cells: int = 65536,
                            ws: int = 1, g: float = G,
                            cutoff: float = CUTOFF_RADIUS, eps: float = 0.0,
                            order: int = 2, quad: bool = True,
                            k_chunk: int = sfmm.DEFAULT_K_CHUNK,
                            far_mode: str = "auto"):
    """The sparse FMM on ``mesh``: ``k_cells`` rounded so that the chunk
    count divides the world, a run of chunks a rank. The returned function
    carries the EFFECTIVE sizing it runs with, ``k_eff`` and
    ``k_chunk_eff``: what audits read."""
    k_eff, k_chunk_eff, local = sfmm.sharded_k_sizing(k_cells, mesh.size,
                                                      k_chunk)
    share = fmm.ChunkShare(mesh.rank, mesh.size, local * k_chunk_eff)

    def accel(pos_l, m_l):
        pos, m = all_gather_rows(pos_l), all_gather_rows(m_l)
        acc = sfmm.sfmm_accelerations(
            pos, m, depth=depth, leaf_cap=leaf_cap, k_cells=k_eff, ws=ws,
            g=g, cutoff=cutoff, eps=eps, order=order, quad=quad,
            k_chunk=k_chunk_eff, far_mode=far_mode, share=share)
        return acc[mesh.rows(pos.shape[0])]

    accel.k_eff = k_eff
    accel.k_chunk_eff = k_chunk_eff
    return accel
