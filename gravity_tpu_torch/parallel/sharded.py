"""The sharded direct sums: ``(positions, masses) -> accelerations`` with
each rank holding its rows.

Counterpart of ``gravity_tpu/parallel/sharded.py``, the replacement of the
reference MPI backend's per-step ``MPI_Allgatherv``
(the reference's ``mpi.c:227-231``):

- **allgather**: every rank gathers all positions and masses
  (``all_gather_into_tensor``) and runs the local kernel for its rows
  against the whole source set, the MPI backend's "my slice against
  everyone" loop. O(N) memory a rank.
- **ring**: P hops over the mesh axis. At hop h rank r holds rank
  (r - h) mod P's shard (the JAX package's ``ppermute`` i -> i + 1) and
  adds its partial accelerations in that order; the next shard's
  ``isend``/``irecv`` is posted before the hop's kernel, so that the copy
  runs beside the compute. The last hop sends nothing, and a world of one
  sends nothing at all. O(N / P) memory a rank.

A local kernel is ``(pos_targets (M, 3), pos_sources (K, 3), m_sources
(K,)) -> (M, 3)``: ``simulation.make_local_kernel`` gives each backend's.
The functions are collectives: every rank of the mesh calls them in the
same order.

Both strategies and the rectangular form are differentiable, as the JAX
package's ``lax.all_gather``, ``ppermute`` and ``psum`` are: the gather's
backward reduce-scatters (``mesh.AllGatherRows``), a ring hop's sends the
cotangents one rank back (:class:`RingShift`), and the rectangular sum's
all-reduces them to every rank (:class:`AllReduceSum`). A forward that
needs no gradient keeps the overlapped hops.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.distributed as dist

from ..constants import CUTOFF_RADIUS, G
from ..ops.forces import accelerations_vs
from .mesh import ParticleMesh, all_gather_rows

LocalKernel = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                       torch.Tensor]


def _allgather_accel(pos_l, m_l, *, local_kernel):
    return local_kernel(pos_l, all_gather_rows(pos_l), all_gather_rows(m_l))


def ring_sum(targets, src_pos, src_m, *, ranks, rank, group, local_kernel):
    """The ring over ``ranks`` (``group``): P hops of ``local_kernel(
    targets, sources held, their masses)``, summed in hop order; at hop h
    this rank holds the sources that ``ranks[(i - h) mod P]`` started
    with. Each hop's exchange is posted before its kernel and waited on
    after it."""
    p = len(ranks)
    i = ranks.index(rank)
    nxt, prv = ranks[(i + 1) % p], ranks[(i - 1) % p]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (targets, src_pos, src_m)):
        # The differentiable form: each hop's exchange a RingShift, after
        # the hop's kernel (no overlap).
        acc = local_kernel(targets, src_pos, src_m)
        for _ in range(p - 1):
            src_pos, src_m = RingShift.apply(src_pos, src_m, nxt, prv, group)
            acc = acc + local_kernel(targets, src_pos, src_m)
        return acc
    src_pos, src_m = src_pos.contiguous(), src_m.contiguous()
    acc = torch.zeros_like(targets)
    for hop in range(p):
        pending = []
        if hop < p - 1:
            next_pos, next_m = torch.empty_like(src_pos), \
                torch.empty_like(src_m)
            pending = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, src_pos, nxt, group),
                dist.P2POp(dist.isend, src_m, nxt, group),
                dist.P2POp(dist.irecv, next_pos, prv, group),
                dist.P2POp(dist.irecv, next_m, prv, group),
            ])
        acc = acc + local_kernel(targets, src_pos, src_m)
        for work in pending:
            work.wait()
        if pending:
            src_pos, src_m = next_pos, next_m
    return acc


def _exchange(tensors, send_to: int, recv_from: int, group) -> list:
    """Each of ``tensors`` sent to rank ``send_to`` and its like received
    from ``recv_from``, waited on."""
    tensors = [t.contiguous() for t in tensors]
    got = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, send_to, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, recv_from, group) for t in got]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return got


class RingShift(torch.autograd.Function):
    """One hop of the ring: (positions, masses) sent to the next rank, the
    previous rank's received (``ppermute`` i -> i + 1); the backward sends
    the cotangents the other way (i -> i - 1), ``ppermute``'s transpose."""

    @staticmethod
    def forward(ctx, pos, m, nxt: int, prv: int, group):
        ctx.peers = (nxt, prv, group)
        return tuple(_exchange((pos, m), nxt, prv, group))

    @staticmethod
    def backward(ctx, d_pos, d_m):
        nxt, prv, group = ctx.peers
        d_pos, d_m = _exchange((d_pos, d_m), prv, nxt, group)
        return d_pos, d_m, None, None, None


class AllReduceSum(torch.autograd.Function):
    """``all_reduce`` (SUM) of a rank's partial, the same total on every
    rank (``psum``); the backward all-reduces the cotangents, so that each
    rank's partial gets the sum of every rank's cotangent of the total
    (``psum``'s transpose)."""

    @staticmethod
    def forward(ctx, partial):
        total = partial.contiguous().clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
        return total

    @staticmethod
    def backward(ctx, ct):
        total = ct.contiguous().clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
        return total


def make_sharded_accel2(
    mesh: ParticleMesh,
    *,
    strategy: str = "allgather",
    local_kernel: LocalKernel | None = None,
    g: float = G,
    cutoff: float = CUTOFF_RADIUS,
    eps: float = 0.0,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``(pos_l (n_local, 3), m_l (n_local,)) -> acc_l (n_local, 3)`` over
    ``mesh``: ``allgather`` or ``ring`` (on a two-axis mesh the
    hierarchical ring of :mod:`.multislice`). Masses are an argument, so
    runs whose masses change (merging) keep the same function. The rows
    are :func:`~.mesh.shard_state`'s: zero-mass padding is exact."""
    if local_kernel is None:
        local_kernel = functools.partial(accelerations_vs, g=g,
                                         cutoff=cutoff, eps=eps)
    if strategy == "allgather":
        return functools.partial(_allgather_accel, local_kernel=local_kernel)
    if strategy != "ring":
        raise ValueError(f"unknown sharding strategy {strategy!r}")
    if len(mesh.shape) == 2:
        from .multislice import hierarchical_ring_accel

        return functools.partial(hierarchical_ring_accel, mesh=mesh,
                                 local_kernel=local_kernel)

    def ring(pos_l, m_l):
        return ring_sum(pos_l, pos_l, m_l, ranks=mesh.inner_ranks,
                        rank=mesh.rank, group=mesh.inner_group,
                        local_kernel=local_kernel)

    return ring


def make_sharded_rect_accel(
    mesh: ParticleMesh,
    local_kernel: LocalKernel,
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """``(targets (K, 3) the same on every rank, pos_l, m_l) -> (K, 3)``:
    each rank's sources against all K targets, then one ``all_reduce``
    (SUM) over the world; no source moves (the JAX package's ``psum``
    form, the multirate fast rung's kick)."""
    del mesh

    def rect(targets, pos_l, m_l):
        partial_acc = local_kernel(targets, pos_l, m_l)
        if torch.is_grad_enabled() and partial_acc.requires_grad:
            return AllReduceSum.apply(partial_acc)
        partial_acc = partial_acc.contiguous()
        dist.all_reduce(partial_acc, op=dist.ReduceOp.SUM)
        return partial_acc

    return rect


def make_sharded_accel_fn(
    mesh: ParticleMesh,
    masses: torch.Tensor,
    *,
    strategy: str = "allgather",
    local_kernel: LocalKernel | None = None,
    g: float = G,
    cutoff: float = CUTOFF_RADIUS,
    eps: float = 0.0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``accel_fn(pos_l)`` with this rank's ``masses`` bound: the one-
    argument form of :func:`make_sharded_accel2`."""
    sharded = make_sharded_accel2(mesh, strategy=strategy,
                                  local_kernel=local_kernel, g=g,
                                  cutoff=cutoff, eps=eps)

    def accel_fn(positions: torch.Tensor) -> torch.Tensor:
        return sharded(positions, masses)

    return accel_fn
