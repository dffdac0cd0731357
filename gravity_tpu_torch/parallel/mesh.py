"""Particle meshes on ``torch.distributed``: one process a device.

Counterpart of ``gravity_tpu/parallel/mesh.py``. The JAX package runs one
program over a named ``Mesh`` of devices and lets XLA place the shards;
here every device is a process of one ``torch.distributed`` world (NCCL on
the card, gloo on the CPU), the shape the reference's ``mpirun`` has, and
each rank holds its own rows of the particle axis.

- :func:`initialize_distributed` joins the launcher's world (the
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
  ``MASTER_PORT`` that ``python -m torch.distributed.run`` sets), or with
  no launcher makes a world of one, so that a sharded preset runs on one
  card as it runs in JAX on one chip.
- :class:`ParticleMesh` is a shape (P,) or (S, P/S) over the world, with
  the JAX axis names (:data:`SHARD_AXIS`, and :data:`DCN_AXIS` outer), a
  rank's coordinates and the process groups of its outer and inner axes.
- :func:`shard_state` pads to a multiple of P with zero-mass bodies
  (``ParticleState.pad_to``) and keeps rank r's rows, the JAX sharding's
  block r; :func:`replicate_state` all-gathers them back.

A failed ``init_process_group`` or a collective's error raises: nothing
falls back to another backend or to the CPU.

Gradients cross ranks as the JAX package's collectives carry them: the
gather's backward is the reduce-scatter of the cotangent by rows
(:class:`AllGatherRows`), the loss of a sharded program being the sum of
the ranks' own losses, as a global sum over the sharded state is in JAX.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..state import ParticleState
from ..utils.platform import DeviceLike, resolve_device

SHARD_AXIS = "shard"
DCN_AXIS = "dcn"

# ``all_gather_single`` is the newer name of ``all_gather_into_tensor``
# (the same call); a torch without it has only the older one.
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def local_rank() -> int:
    """This process's device index on its host (the launcher's
    ``LOCAL_RANK``; 0 without one)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(device: DeviceLike = None) -> torch.device:
    """A rank's device: ``cuda:LOCAL_RANK`` unless the caller asks for the
    CPU (``utils/platform.resolve_device`` otherwise)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    return resolve_device(dev)


def initialize_distributed(device: DeviceLike = None) -> None:
    """Join the world of this process, once: NCCL for a CUDA device, gloo
    for the CPU. Under a launcher (``WORLD_SIZE`` and ``MASTER_ADDR`` in
    the environment) the ``env://`` rendezvous; without one a world of one
    over an in-process store. A no-op when the default group exists (a
    caller, such as a test, may make it with a store of its own)."""
    if dist.is_initialized():
        return
    dev = rank_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


@dataclasses.dataclass
class ParticleMesh:
    """The world as a (P,) or (S, P/S) mesh. ``coords`` are this rank's
    coordinates (row-major: rank = s * (P/S) + i); ``outer_ranks`` and
    ``inner_ranks`` the ranks that share its inner or outer coordinate,
    with their groups (``None`` is the whole world); ``device`` the rank's
    device."""

    shape: tuple
    axis_names: tuple
    rank: int
    device: torch.device
    outer_ranks: tuple
    inner_ranks: tuple
    outer_group: object = None
    inner_group: object = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def coords(self) -> tuple:
        if len(self.shape) == 1:
            return (self.rank,)
        return divmod(self.rank, self.shape[1])

    def rows(self, n: int) -> slice:
        """This rank's rows of an axis of ``n`` (a multiple of P)."""
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def make_particle_mesh(mesh_shape: Optional[Sequence[int]] = None, *,
                       num_slices: int = 1,
                       device: DeviceLike = None) -> ParticleMesh:
    """The mesh over this process's world (joined first if need be):
    ``mesh_shape`` None is (world,), or (num_slices, world / num_slices)
    with ``num_slices`` > 1; a two-axis shape builds the outer (``dcn``)
    and inner (``shard``) groups, which every rank makes in one order, as
    ``dist.new_group`` requires."""
    initialize_distributed(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if mesh_shape is None:
        if world % num_slices:
            raise ValueError(
                f"{world} devices not divisible into {num_slices} slices")
        mesh_shape = ((num_slices, world // num_slices) if num_slices > 1
                      else (world,))
    shape = tuple(int(x) for x in mesh_shape)
    if math.prod(shape) != world or len(shape) not in (1, 2):
        raise ValueError(f"mesh_shape {shape} does not cover the world of "
                         f"{world} processes")
    dev = rank_device(device)
    if len(shape) == 1:
        everyone = tuple(range(world))
        return ParticleMesh(shape, (SHARD_AXIS,), rank, dev, everyone,
                            everyone)
    outer, inner = shape
    s, i = divmod(rank, inner)
    mine = {}
    for col in range(inner):
        ranks = tuple(r * inner + col for r in range(outer))
        group = dist.new_group(list(ranks))
        if col == i:
            mine["outer"] = (ranks, group)
    for row in range(outer):
        ranks = tuple(row * inner + c for c in range(inner))
        group = dist.new_group(list(ranks))
        if row == s:
            mine["inner"] = (ranks, group)
    return ParticleMesh(shape, (DCN_AXIS, SHARD_AXIS), rank, dev,
                        mine["outer"][0], mine["inner"][0],
                        mine["outer"][1], mine["inner"][1])


def particle_spec(mesh: ParticleMesh) -> tuple:
    """The mesh axes the particle axis is split over (all of them)."""
    return mesh.axis_names


def particle_sharding(mesh: ParticleMesh, n: int) -> slice:
    """This rank's rows of ``n`` particles padded to a multiple of P."""
    return mesh.rows(math.ceil(n / mesh.size) * mesh.size)


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` (the world for None) stacked along
    dim 0 in rank order: ``lax.all_gather(..., tiled=True)``.
    Differentiable (:class:`AllGatherRows`) where autograd needs it."""
    if torch.is_grad_enabled() and t.requires_grad:
        return AllGatherRows.apply(t, group)
    return _gather_rows(t, group)


def _gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    size = dist.get_world_size(group)
    out = t.new_empty((size * t.shape[0], *t.shape[1:]))
    _all_gather(out, t, group=group)
    return out


def reduce_scatter_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the ranks of ``group`` of ``t`` (P r, ...), this rank's
    r rows of it: ``lax.psum_scatter(..., tiled=True)``, the transpose of
    :func:`all_gather_rows`. NCCL reduce-scatters; gloo, which has no
    reduce-scatter of a tensor, all-reduces and keeps the rows."""
    t = t.contiguous()
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    per = t.shape[0] // size
    if dist.get_backend(group) == "nccl":
        out = t.new_empty((per, *t.shape[1:]))
        dist.reduce_scatter_tensor(out, t, group=group)
        return out
    total = t.clone()
    dist.all_reduce(total, group=group)
    return total[rank * per:(rank + 1) * per]


class AllGatherRows(torch.autograd.Function):
    """:func:`all_gather_rows` with its transpose as the backward: each
    rank's rows get the sum of every rank's cotangent of them."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _gather_rows(t, group)

    @staticmethod
    def backward(ctx, ct):
        return reduce_scatter_rows(ct, ctx.group), None


def shard_state(state: ParticleState, mesh: ParticleMesh) -> ParticleState:
    """This rank's rows of ``state`` padded to ceil(n / P) P with zero-mass
    bodies (exact for every force), on the rank's device."""
    p = mesh.size
    padded, _ = state.pad_to(math.ceil(state.n / p) * p)
    rows = mesh.rows(padded.n)
    return ParticleState(*(t[rows].contiguous().to(mesh.device)
                           for t in (padded.positions, padded.velocities,
                                     padded.masses)))


def replicate_state(state: ParticleState,
                    mesh: ParticleMesh) -> ParticleState:
    """Every rank's rows gathered in rank order: the padded global state,
    on every rank (the inverse of :func:`shard_state`)."""
    del mesh
    return ParticleState(*(all_gather_rows(t) for t in (
        state.positions, state.velocities, state.masses)))


def all_ranks_true(flag: torch.Tensor) -> torch.Tensor:
    """A boolean scalar of the world, true where it is true on every rank
    (one ``all_reduce``), so that every rank takes the same branch."""
    out = flag.to(torch.int32).reshape(1)
    dist.all_reduce(out, op=dist.ReduceOp.MIN)
    return out[0].bool()


def num_shards(mesh: ParticleMesh) -> int:
    return mesh.size
