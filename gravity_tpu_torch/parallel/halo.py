"""Domain-decomposed cell-list forces: the slab halo exchange.

Counterpart of ``gravity_tpu/parallel/halo.py``. The allgather form of the
sharded cell list gathers the world every evaluation, O(N) bytes and
memory a rank. Here the ``side^3`` cell grid is cut into slabs of
``side / D`` x-planes, one a rank of a single-axis mesh of D ranks, all
pair-tile work stays local, and only the one-cell-deep boundary planes
move: O(surface) bytes, O(N / D) memory and work a rank. An evaluation,
every step of it on the rank's device with no host read:

1. **Global cube**: one ``all_reduce`` (MAX of -min, max and the largest
   mass) gives every rank the solo ``bounding_cube`` and mass scale, bit
   for bit (a periodic run's grid is the box).
2. **Migration**: a rank's rows are sharded by index, which has no
   spatial order, so it buckets them by destination slab (x cell // (side
   / D)) into static (D, mig_cap) blocks, each with one more row, the
   normalized-mass remainder monopole of what did not fit
   (``_source_overflow_channels``, the solo cell list's, an empty
   remainder's centre 0), and one ``all_to_all_single`` of equal blocks
   delivers them.
3. **Binning**: the received rows are sorted into the slab's
   (side / D, side, side) cells by one stable sort (a block a source rank
   in rank order, a rank's rows in index order: the solo cell list's order
   of the bodies of a cell), the buckets' padding parked on trash cells.
4. **Halo exchange**: ``batch_isend_irecv`` sends the first and last
   planes' cell blocks (positions and G m), counts and nine overflow
   channels to the slab neighbours. Receive buffers start at zero, so an
   isolated edge with no sender is an exact no-op; in a box the ring
   closes and the receiver shifts positions and channels 1 and 6 by
   +-box in x (a world of one sends to itself by a copy).
5. **Slab evaluation**: ``ops/nlist.py``'s slab engines over the
   x-extended grid: the isolated pair tiles through
   :func:`~gravity_tpu_torch.ops.nlist.pair_cells_slab_kernel`
   (``csrc/nlist_pair.cu``'s slab entry on the card), a periodic slab's
   through the plain engine on every device, as the cubic periodic cell
   list's; the source remainders, the overflow targets' whole-cell
   monopoles and the migration remainders' monopoles (both computed for
   every target and selected on the device, where the JAX package gates
   them with ``lax.cond``).
6. **Inverse**: the same ``all_to_all_single`` takes each row's
   acceleration back to its home rank.

``make_halo_nlist_accel`` returns ``accel2(pos_l, m_l)`` with the contract
of :func:`.sharded.make_sharded_accel2`: a rank's rows in, its rows out,
masses an argument. Every rank calls it in the same order (collectives).

Gradients go where ``jax.grad`` through the JAX form goes. The two
exchanges carry them as the JAX collectives' transposes do: the
``all_to_all`` of the migration and of the return sends each block's
cotangent back to the rank it came from (:class:`AllToAll`), and the halo
planes' cotangents go back to their senders, which add them into the
planes they sent (:class:`HaloExchange`, ``ppermute``'s transpose); the
index gathers and scatters around them, and a box's slab tiles (plain
PyTorch on every device), are PyTorch's own differentiation. So a periodic
engine differentiates with respect to the positions, through both kinds.
The global cube's ``pmin``/``pmax`` and the mass scale's ``pmax`` have no
differentiation rule in JAX, and the engine raises
:class:`~gravity_tpu_torch.ops.forces.NoBackwardError` naming them where
JAX raises: an isolated engine whose positions or masses require grad,
and any engine whose masses do. The isolated slab tiles'
``nlist_pair.cu`` entry stays forward only behind that refusal.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..constants import CUTOFF_RADIUS, G
from ..ops.cells import (
    _cell_slots,
    _scatter_cells,
    grid_coords,
    segment_sum,
    sorted_segment_sum,
)
from ..ops.forces import NoBackwardError, rounded
from ..ops.nlist import (
    _monopole_w,
    _overflow_targets_slab,
    _remainder_cells_slab,
    _source_overflow_channels,
    cell_totals,
    pair_cells_slab_kernel,
    pair_cells_slab_plain,
    resolve_nlist_sizing,
)
from ..ops.pm import bounding_cube
from .mesh import ParticleMesh

__all__ = [
    "halo_comm_model",
    "make_halo_nlist_accel",
    "resolve_halo_sizing",
    "resolve_mig_cap",
]

_EPS_TINY = 1e-37
# Trash segments of the slab binning: the received rows that are bucket
# padding are spread over this many segments past the real cells, so that
# no segment of the cell totals' sums is long (the card's segment_reduce
# gives a segment one thread).
TRASH_SEGMENTS = 1024


def resolve_halo_sizing(positions, rcut: float, cap: int = 0, *,
                        devices: int, side: int = 0, box: float = 0.0, **kw):
    """:func:`~gravity_tpu_torch.ops.nlist.resolve_nlist_sizing` held to
    the slab decomposition: ``side`` a multiple of ``devices`` (whole cell
    planes a rank). Rounds down where it can (coarser cells are always
    correct, coverage needs an edge >= rcut) and up to the ``devices``
    floor only when the solo side is too small to split, re-fitting
    ``cap`` at the final side."""
    side_r, cap_r = resolve_nlist_sizing(positions, rcut, cap, side=side,
                                         box=box, **kw)
    if devices <= 1 or side_r % devices == 0:
        return side_r, cap_r
    side_min = 3 if box > 0.0 else 2
    down = (side_r // devices) * devices
    if down >= max(side_min, devices):
        side_f = down
    else:
        side_f = devices * ((max(side_min, devices) + devices - 1)
                            // devices)
    return resolve_nlist_sizing(positions, rcut, cap, side=side_f, box=box,
                                **kw)


def resolve_mig_cap(positions, side: int, devices: int, *,
                    box: float = 0.0) -> int:
    """The static migration bucket capacity a (source rank, destination
    slab), from host positions: the next power of two >= 2x the largest
    bucket of contiguous index blocks (the mesh's sharding), at least 16
    and at most a rank's row count."""
    if isinstance(positions, torch.Tensor):
        positions = positions.detach().cpu().double().numpy()
    pos = np.asarray(positions, np.float64)
    n = pos.shape[0]
    n_loc = max(1, -(-n // max(devices, 1)))
    if devices <= 1:
        return n_loc
    if box > 0.0:
        x = np.mod(pos[:, 0], box)
        origin, span = 0.0, float(box)
    else:
        lo, hi = pos.min(axis=0), pos.max(axis=0)
        span = float((hi - lo).max()) * 1.02 + 1e-30
        origin = float((0.5 * (hi + lo) - 0.5 * span)[0])
        x = pos[:, 0]
    cell_x = np.clip(((x - origin) / span * side).astype(np.int64), 0,
                     side - 1)
    dest = cell_x // (side // devices)
    worst = 1
    for block in np.array_split(dest, devices):
        if block.size:
            worst = max(worst, int(np.bincount(block,
                                               minlength=devices).max()))
    mig = 16
    while mig < 2 * worst:
        mig *= 2
    return int(min(mig, n_loc))


def halo_comm_model(n: int, side: int, cap: int, devices: int, *,
                    mig_cap: int = 0, dtype_bytes: int = 4) -> dict:
    """Analytic bytes a rank an evaluation: a cell block carries cap x
    (position 3 + G m 1) values plus 9 overflow channels; the halo is one
    boundary plane each way, the migration D (mig_cap + 1) rows of 5 out
    and mig_cap rows of 3 back."""
    s2 = side * side
    per_cell = (cap * 4 + 9) * dtype_bytes
    ghost = 2 * s2 * per_cell
    local = max(1, side // max(devices, 1)) * s2 * per_cell
    n_loc = max(1, -(-n // max(devices, 1)))
    mig = mig_cap or n_loc
    migrate = devices * ((mig + 1) * 5 + mig * 3) * dtype_bytes
    return {"ghost_bytes": ghost, "local_bytes": local,
            "halo_fraction": ghost / local, "migrate_bytes": migrate}


def _all_to_all(t: torch.Tensor, group, devices: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)`` over dim 0 in D equal blocks: block
    j goes to rank j, which puts it at this rank's block. A world of one
    keeps its rows. Differentiable (:class:`AllToAll`) where autograd
    needs it."""
    if devices == 1:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return AllToAll.apply(t, group)
    return _all_to_all_blocks(t, group)


def _all_to_all_blocks(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


class AllToAll(torch.autograd.Function):
    """:func:`_all_to_all` with its transpose as the backward: the same
    exchange of the cotangent, which sends each block back to the rank it
    came from."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all_blocks(t, group)

    @staticmethod
    def backward(ctx, ct):
        return _all_to_all_blocks(ct, ctx.group), None


def _halo_exchange(planes: tuple, ranks: tuple, d: int, box: float,
                   group) -> tuple:
    """:func:`_exchange`, differentiable (:class:`HaloExchange`) where
    autograd needs it."""
    if torch.is_grad_enabled() and any(t.requires_grad for pair in planes
                                       for t in pair):
        out = HaloExchange.apply(ranks, d, box, group,
                                 *(t for pair in planes for t in pair))
        return list(out[:len(planes)]), list(out[len(planes):])
    return _exchange(planes, ranks, d, box, group)


class HaloExchange(torch.autograd.Function):
    """:func:`_exchange` of (first, last) plane pairs, flattened, with
    ``ppermute``'s transpose as the backward: the cotangent of a plane
    received from the left goes back to the left neighbour, which adds it
    into the last plane it sent, and one from the right into the right
    neighbour's first plane (a peer that is this rank, a world of one in a
    box, adds its own). That is the same exchange with the cotangents of
    (from the left, from the right) as the (first, last) it sends, so the
    backward calls :func:`_exchange` again: what it receives from the left
    is the cotangent of this rank's first plane, from the right of its
    last. Integer planes (the counts) carry none."""

    @staticmethod
    def forward(ctx, ranks, d, box, group, *flat):
        ctx.peers = (ranks, d, box, group)
        ctx.floating = [t.is_floating_point() for t in flat[0::2]]
        from_left, from_right = _exchange(
            tuple(zip(flat[0::2], flat[1::2])), ranks, d, box, group)
        out = (*from_left, *from_right)
        ctx.mark_non_differentiable(
            *(o for o in out if not o.is_floating_point()))
        return out

    @staticmethod
    def backward(ctx, *cts):
        k = len(ctx.floating)
        live = [i for i in range(k) if ctx.floating[i]]
        to_first, to_last = _exchange(
            tuple((cts[i], cts[k + i]) for i in live), *ctx.peers)
        grads = [None] * (2 * k)
        for j, i in enumerate(live):
            grads[2 * i], grads[2 * i + 1] = to_first[j], to_last[j]
        return (None, None, None, None, *grads)


def _refuse_without_rule(pos_l, m_l, box: float) -> None:
    """Raise :class:`NoBackwardError` where ``jax.grad`` through the JAX
    form raises: the global cube's ``pmin``/``pmax`` of the positions
    (isolated) and the mass scale's ``pmax`` (``gravity_tpu/parallel/
    halo.py:197-198``, ``:204``) have no differentiation rule, on a mesh
    of any size."""
    if not torch.is_grad_enabled():
        return
    if box <= 0.0 and pos_l.requires_grad:
        what, prim = "positions of an isolated engine (the global cube)", \
            "pmin"
    elif m_l.requires_grad:
        what, prim = "masses (the global mass scale)", "pmax"
    else:
        return
    raise NoBackwardError(
        f"the halo cell list (parallel/halo.py) has no backward with "
        f"respect to the {what}: the JAX form's {prim} has no "
        f"differentiation rule, so jax.grad raises there too; "
        f"differentiate a periodic engine with respect to its positions, "
        f"or call it under torch.no_grad()")


def _exchange(planes: tuple, ranks: tuple, d: int, box: float,
              group) -> tuple:
    """(from the left, from the right): the neighbours' last and first
    planes of each tensor of ``planes`` (first, last) pairs; zeros where
    an isolated edge has no neighbour. In a box the ring closes; a peer
    that is this rank copies."""
    devices = len(ranks)
    left = d - 1 if d > 0 else (devices - 1 if box > 0.0 else None)
    right = d + 1 if d < devices - 1 else (0 if box > 0.0 else None)
    from_left = [torch.zeros_like(last) for _, last in planes]
    from_right = [torch.zeros_like(first) for first, _ in planes]
    ops = []
    for (first, last), lh, rh in zip(planes, from_left, from_right):
        if right is not None:
            if ranks[right] == ranks[d]:
                lh.copy_(last)
            else:
                ops.append(dist.P2POp(dist.isend, last.contiguous(),
                                      ranks[right], group, 0))
        if left is not None:
            if ranks[left] == ranks[d]:
                rh.copy_(first)
            else:
                ops.append(dist.P2POp(dist.isend, first.contiguous(),
                                      ranks[left], group, 1))
        if left is not None and ranks[left] != ranks[d]:
            ops.append(dist.P2POp(dist.irecv, lh, ranks[left], group, 0))
        if right is not None and ranks[right] != ranks[d]:
            ops.append(dist.P2POp(dist.irecv, rh, ranks[right], group, 1))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return from_left, from_right


def _halo_body(pos_l, m_l, *, mesh: ParticleMesh, side: int, cap: int,
               mig_cap: int, rcut: float, g: float, cutoff: float,
               eps: float, box: float, kind: str, ewald_scales):
    _refuse_without_rule(pos_l, m_l, box)
    ranks, group = mesh.inner_ranks, mesh.inner_group
    devices = len(ranks)
    d = ranks.index(mesh.rank)
    n_loc = pos_l.shape[0]
    dtype, device = pos_l.dtype, pos_l.device
    s = side
    sx = side // devices
    n_cells_loc = sx * s * s
    mig = mig_cap if mig_cap > 0 else n_loc

    with record_function("halo.migrate"):
        # 1. The global cube and mass scale: one all_reduce (MAX) of -min,
        # max and the largest mass, in fp32 for a bf16 state (exact).
        if box > 0.0:
            pos_w = torch.remainder(pos_l, rounded(box, dtype))
            origin, span = pos_l.new_zeros(3), pos_l.new_full((), box)
            ext = m_l.max().reshape(1)
        else:
            pos_w = pos_l
            ext = torch.cat([-pos_l.min(dim=0).values, pos_l.max(dim=0).values,
                             m_l.max().reshape(1)])
        if devices > 1:
            wide = ext.float() if dtype == torch.bfloat16 else ext.clone()
            dist.all_reduce(wide, op=dist.ReduceOp.MAX, group=group)
            ext = wide.to(dtype)
        if box <= 0.0:
            origin, span = bounding_cube(torch.stack([-ext[:3], ext[3:6]]))
        m_scale = torch.clamp_min(ext[-1], _EPS_TINY)
        cell_h = span / side
        if kind == "newton":
            rcut_eff = torch.clamp_max(cell_h, rcut)
            params = (rcut_eff * rcut_eff).reshape(1)
        else:
            # alpha ~ 1/length scales inversely with the cube, rcut directly.
            a_s, r_s = ewald_scales
            alpha = torch.full_like(span, rounded(a_s, dtype)) / span
            rc_t = rounded(r_s, dtype) * span
            params = torch.stack([rc_t * rc_t, alpha])

        # 2. Migration: bucket the rows by destination slab, all_to_all.
        coords = grid_coords(pos_w, origin, span, side)
        dest = coords[:, 0] // sx
        order = torch.argsort(dest, stable=True)
        sorted_dest = dest[order]
        count = segment_sum(torch.ones_like(dest), dest, devices)
        start = torch.cumsum(count, 0) - count
        slot, _ = _cell_slots(sorted_dest, start, devices, mig)
        feat = torch.cat([pos_w, m_l[:, None], torch.ones_like(m_l)[:, None]],
                         dim=1)
        buckets = _scatter_cells(feat[order], slot, devices, mig)
        m_hat = m_l / m_scale
        bsum = sorted_segment_sum(
            torch.cat([m_hat[:, None], m_hat[:, None] * pos_w], dim=1)[order],
            sorted_dest, devices)
        bmass_hat = bsum[:, 0]
        bcom = bsum[:, 1:] / torch.clamp_min(bmass_hat, _EPS_TINY)[:, None]
        mig_w, mig_com, mig_over = _source_overflow_channels(
            buckets[..., :3], buckets[..., 3], count, bmass_hat, bcom, m_scale,
            g, mig)
        rem_row = torch.cat([mig_com, mig_w[:, None],
                             mig_over.to(dtype)[:, None]], dim=1)
        send = torch.cat([buckets, rem_row[:, None, :]], dim=1)
        recv = _all_to_all(send.reshape(devices * (mig + 1), 5), group,
                           devices)

    with record_function("halo.bin"):
        # 3. Bin the received rows into the slab's cells.
        r = recv.reshape(devices, mig + 1, 5)
        nr = devices * mig
        r_feat = r[:, :mig].reshape(nr, 5)
        r_rem = r[:, mig]
        r_pos, r_mass = r_feat[:, :3], r_feat[:, 3]
        rc = grid_coords(r_pos, origin, span, side)
        lx = rc[:, 0] - d * sx
        ok = (r_feat[:, 4] > 0.5) & (lx >= 0) & (lx < sx)
        idx = torch.arange(nr, device=device)
        lid = torch.where(ok, (lx * s + rc[:, 1]) * s + rc[:, 2],
                          n_cells_loc + idx % TRASH_SEGMENTS)
        sort_order = torch.argsort(lid, stable=True)
        sorted_lid = lid[sort_order]
        lcount = segment_sum(torch.ones_like(lid), lid,
                             n_cells_loc + TRASH_SEGMENTS)
        lstart = torch.cumsum(lcount, 0) - lcount
        slot_l, _ = _cell_slots(sorted_lid, lstart, n_cells_loc, cap)
        cells_pos = _scatter_cells(r_pos[sort_order], slot_l, n_cells_loc, cap)
        cells_mass = _scatter_cells(r_mass[sort_order], slot_l, n_cells_loc,
                                    cap)
        r_mass_ok = torch.where(ok, r_mass, 0.0)
        _, cmass_hat, ccom = cell_totals(r_pos, r_mass_ok, sort_order,
                                         sorted_lid, lcount, m_scale=m_scale)
        cmass_hat, ccom = cmass_hat[:n_cells_loc], ccom[:n_cells_loc]
        t_count = lcount[:n_cells_loc]
        rem_w_c, rem_com_c, over_c = _source_overflow_channels(
            cells_pos, cells_mass, t_count, cmass_hat, ccom, m_scale, g, cap)
        cmass_w = g * cmass_hat * m_scale

    with record_function("halo.exchange"):
        # 4. The halo exchange: the boundary planes' cell blocks, counts and
        # channels [rem_w, rem_com xyz, over, cmass_w, ccom xyz] a cell.
        pmain = torch.cat([cells_pos, (cells_mass * g)[..., None]],
                          dim=-1).reshape(sx, s * s, cap, 4)
        pchan = torch.cat([rem_w_c[:, None], rem_com_c,
                           over_c.to(dtype)[:, None], cmass_w[:, None], ccom],
                          dim=1).reshape(sx, s * s, 9)
        pcount = t_count.reshape(sx, s * s)
        (lh_main, lh_chan, lh_count), (rh_main, rh_chan, rh_count) = \
            _halo_exchange(tuple((t[0], t[sx - 1])
                                 for t in (pmain, pchan, pcount)),
                           ranks, d, box, group)
        if box > 0.0:
            # The ring's image shifts, applied on receive (positions' x,
            # rem_com's and ccom's), so the slab engines read minimum-image x.
            bx = rounded(box, dtype)
            if d == 0:
                lh_main[..., 0] -= bx
                lh_chan[..., 1] -= bx
                lh_chan[..., 6] -= bx
            if d == devices - 1:
                rh_main[..., 0] += bx
                rh_chan[..., 1] += bx
                rh_chan[..., 6] += bx
        ext_main = torch.cat([lh_main[None], pmain, rh_main[None]]).reshape(
            (sx + 2) * s * s, cap, 4)
        ext_chan = torch.cat([lh_chan[None], pchan, rh_chan[None]]).reshape(
            (sx + 2) * s * s, 9)
        ext_count = torch.cat(
            [lh_count[None], pcount, rh_count[None]]).reshape(
                (sx + 2) * s * s)
        ext_pos = ext_main[..., :3].contiguous()
        ext_gm = ext_main[..., 3].contiguous()

    with record_function("halo.tiles"):
        # 5. The slab evaluation (the self form: targets are the binning).
        if box > 0.0:
            acc_cell = pair_cells_slab_plain(
                cells_pos, t_count, ext_pos, ext_gm, sx, s, params,
                cutoff=cutoff, eps=eps, kind=kind, box=box)
        else:
            acc_cell = pair_cells_slab_kernel(
                cells_pos, t_count, ext_pos, ext_gm, ext_count, sx, s, params,
                cutoff=cutoff, eps=eps, kind=kind)
        acc_cell = acc_cell + _remainder_cells_slab(
            cells_pos, ext_chan[:, 0], ext_chan[:, 1:4], ext_chan[:, 4] > 0.5,
            sx, s, params, kind=kind, eps=eps, cell_h=cell_h, box=box)

    with record_function("halo.overflow"):
        # 6. Un-bin; targets past cap take the whole-cell monopole fallback,
        # computed for all and selected.
        rank_l = idx - lstart[sorted_lid]
        ok_sorted = ok[sort_order]
        over_t = (rank_l >= cap) & ok_sorted
        safe_id = torch.clamp_max(sorted_lid, n_cells_loc - 1)
        acc_sorted = torch.where(
            ok_sorted[:, None], acc_cell[safe_id, rank_l.clamp_max(cap - 1)],
            0.0)
        t_pos_sorted = r_pos[sort_order]
        t_lc = torch.stack([lx.clamp(0, sx - 1), rc[:, 1], rc[:, 2]],
                           dim=1)[sort_order]
        fallback = _overflow_targets_slab(
            t_pos_sorted, t_lc, ext_chan[:, 5], ext_chan[:, 6:9], s, params,
            kind=kind, eps=eps, cell_h=cell_h, box=box)
        acc_sorted = torch.where(over_t[:, None], fallback, acc_sorted)

        # The migration buckets' remainder monopoles (emigrant mass beyond
        # mig_cap), softened at the slab half-width, selected on the device.
        half = 0.5 * span / devices
        eps_m2 = torch.clamp_min(half * half, eps * eps)
        extra = torch.zeros_like(acc_sorted)
        for row in r_rem:
            wmass = torch.where(row[4] > 0.5, row[3], 0.0)
            diff = row[None, :3] - t_pos_sorted
            if box > 0.0:
                bx = rounded(box, dtype)
                diff = diff - bx * torch.round(diff / bx)
            r2 = (diff * diff).sum(dim=-1)
            w = _monopole_w(kind, r2, wmass, params, eps_m2)
            extra = extra + w[:, None] * diff
        acc_sorted = torch.where(
            (r_rem[:, 4] > 0.5).any(),
            acc_sorted + torch.where(ok_sorted[:, None], extra, 0.0),
            acc_sorted)

    with record_function("halo.return"):
        # 7. The inverse all_to_all and this rank's index order; rows beyond
        # mig_cap (their mass in the remainder) get zero.
        inv = torch.empty_like(idx)
        inv[sort_order] = idx
        back = _all_to_all(acc_sorted[inv], group, devices)
        rank0 = torch.arange(n_loc, device=device) - start[sorted_dest]
        rank_orig = torch.empty_like(rank0)
        rank_orig[order] = rank0
        kept = rank_orig < mig
        rows = torch.clamp(dest * mig + rank_orig, 0, nr - 1)
        return torch.where(kept[:, None], back[rows], 0.0)


def make_halo_nlist_accel(
    mesh: ParticleMesh,
    *,
    side: int,
    cap: int,
    rcut: float = 0.0,
    g: float = G,
    cutoff: float = CUTOFF_RADIUS,
    eps: float = 0.0,
    box: float = 0.0,
    mig_cap: int = 0,
    kind: str = "newton",
    ewald_scales: tuple | None = None,
):
    """The domain-decomposed ``accel2(pos_l, m_l)``: the halo counterpart
    of :func:`.sharded.make_sharded_accel2` for the cell list
    (``kind="newton"``, the truncated dynamics) or P3M's erfc near field
    (``kind="ewald"``, ``ewald_scales = (alpha_span, rcut_frac)`` with
    alpha = alpha_span / span and rcut = rcut_frac * span, both following
    the global cube).

    ``side`` must be a multiple of the mesh's size
    (:func:`resolve_halo_sizing`), the rows :func:`~.mesh.shard_state`'s
    (zero-mass padding is exact); ``mig_cap`` 0 sizes the buckets at a
    rank's rows, :func:`resolve_mig_cap` from the initial state."""
    if len(mesh.shape) != 1:
        raise ValueError(
            "halo slab decomposition runs over a single mesh axis; got "
            f"axes {mesh.axis_names!r} (multi-axis meshes take the "
            "allgather path)")
    devices = mesh.shape[0]
    if side % devices != 0 or side < devices:
        raise ValueError(
            f"halo nlist needs side divisible by the mesh axis size "
            f"(>= 1 cell plane per device); got side={side}, "
            f"devices={devices} (resolve_halo_sizing rounds for you)")
    if box > 0.0 and side < 3:
        raise ValueError(
            f"periodic halo nlist needs side >= 3; got side={side}")
    if kind == "newton":
        if rcut <= 0.0:
            raise ValueError(f"halo nlist rcut must be > 0, got {rcut}")
    elif kind == "ewald":
        if ewald_scales is None:
            raise ValueError("kind='ewald' needs ewald_scales")
    else:
        raise ValueError(f"unknown halo kind {kind!r}")
    return functools.partial(
        _halo_body, mesh=mesh, side=side, cap=cap, mig_cap=mig_cap,
        rcut=rcut, g=g, cutoff=cutoff, eps=eps, box=box, kind=kind,
        ewald_scales=ewald_scales)
