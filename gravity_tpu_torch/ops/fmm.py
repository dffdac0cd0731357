"""Dense-grid FMM gravity.

Counterpart of ``gravity_tpu/ops/fmm.py``: the octree's interaction sets
(``ops/tree.py``: ``_offsets``, ``_parity_mask_table``) evaluated as a
fast-multipole downward pass on the leaf grid of a complete octree.

- **Coarse levels d in [2, depth-1]**: every leaf a target occupies
  receives a p = ``order`` local expansion about its OWN centre (the
  acceleration F, its Jacobian J, and at order 2 the hatted moments A and
  T), summing each ancestor's interaction list. The factors that would be
  fp32 subnormals at astronomical scales (3 w / r^2, w / r^4) never
  appear: unit directions and h_leaf-normalised moments keep every
  intermediate O(w).
- **Finest level**: the leaf-level interaction list, exact per target
  against the list cells' monopoles and source quadrupoles.
- **Near field**: exact pair sums between each target leaf's (t_cap)
  slots and its 27 neighbours' (cap) slots, plus each neighbour's mass
  beyond its cap as a monopole softened to half a leaf.
- **Evaluation**: per target, F + J dx (+ the order-2 term) at its leaf
  plus the near and finest sums of its slot; targets without a slot (slot
  overflow; with the rectangular form also targets outside the source
  cube) take the per-point monopole hierarchy at their own position.

How the TPU design maps onto the card. The JAX package reads every
neighbour as a shifted slice of a whole ``side^3`` grid, scanned one
offset at a time, because the TPU's index rate prices gathers; its passes
run over every leaf, occupied or not. Here each pass runs over the leaves
that hold a target, in chunks (:func:`_cell_chunk`, the counterpart of
``_clamp_slab``'s budget), and reads a chunk's neighbours by one gather of
all its list offsets at once: a parity's list has 189 of the 343 offsets
(ws = 1), so the masked-out 154 are never computed. A cell's terms are
the JAX package's; their sum runs in another order (fp32 agreement to
summation-order tolerance, fp64 to ~1e-15). Leaves without a target feed
no result, so skipping them changes none.

Host reads: one an evaluation, of the number of target leaves and of
fallback targets (sizes of the passes that follow). The JAX package gates
its fallback with ``lax.cond``; here the fallback runs on exactly the
targets that take it, which gives each of them the same terms.

A bf16 state runs at its own dtype, as in the JAX package.

On a mesh (``parallel/sharded_fmm.py``, the JAX package's
``make_sharded_fmm_accel``) every rank rebuilds the octree and the cell
arrays from the gathered state and runs :func:`cell_pass` on its own
contiguous share of the target leaves (:class:`SlabShare`: whole x-slabs
of the leaf grid); the per-leaf outputs are all-gathered in rank order.
A leaf's outputs do not depend on which leaves share its chunk (the
finest list's offset groups are sized by the nominal chunk, not by the
chunk at hand), so a sharded evaluation gives the unsharded bits.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..constants import CUTOFF_RADIUS, G
from .cells import _near_offsets, _scatter_cells, bin_to_cells, grid_coords
from .tree import (
    _apply_j,
    _mass_scale,
    _offsets,
    _parity_mask_table,
    _quad_correction,
    build_octree,
)

# Elements of the largest temporary of a pass: the JAX package's slab
# budget (_clamp_slab: 2^28 elements of the (cells, t_cap, cap, 3) pair
# block, ~1 GB in fp32).
PASS_BUDGET = 1 << 28


def _cell_chunk(t_cap: int, cap: int) -> int:
    """Target leaves a pass: the largest power of two whose (cells, t_cap,
    cap, 3) near-field temporary fits :data:`PASS_BUDGET` (the port's
    ``_clamp_slab``, which bounds the same temporary by x-slabs of the
    grid)."""
    c = max(1, PASS_BUDGET // max(1, 3 * t_cap * cap))
    return 1 << (c.bit_length() - 1)


@functools.lru_cache(maxsize=None)
def _list_tables(ws: int, device: torch.device):
    """(lists (8, Lv, 3), near (|near|, 3), window index of each list
    offset (8, Lv)) on the device: row p of ``lists`` holds the offsets of
    ``_parity_mask_table``'s row p, in the table's order (189 of 343 at
    ws = 1, the same count for every parity)."""
    offs = _offsets(ws)
    pmask = _parity_mask_table(ws)
    rows = [np.nonzero(pmask[p])[0] for p in range(8)]
    if len({len(r) for r in rows}) != 1:
        raise ValueError(f"ws={ws}: parities' lists differ in length")
    wrad = int(np.max(np.abs(offs)))
    wside = 2 * wrad + 1
    win = (offs[:, 0] + wrad) * wside * wside + (offs[:, 1] + wrad) * wside \
        + (offs[:, 2] + wrad)
    as_t = functools.partial(torch.as_tensor, dtype=torch.int64,
                             device=device)
    return (as_t(np.stack([offs[r] for r in rows])),
            as_t(_near_offsets(ws)),
            as_t(np.stack([win[r] for r in rows])))


def _parity(coords: torch.Tensor, k: int = 0) -> torch.Tensor:
    """Parity of the level-(depth-k) ancestor of leaf ``coords``:
    (bit_k(x) << 2) | (bit_k(y) << 1) | bit_k(z) (the JAX package's
    ``_bit_parity_grid`` read at the leaves)."""
    b = (coords >> k) & 1
    return (b[..., 0] << 2) | (b[..., 1] << 1) | b[..., 2]


def _flat(cell: torch.Tensor, side: int) -> torch.Tensor:
    return (cell[..., 0] * side + cell[..., 1]) * side + cell[..., 2]


def _in_grid(cell: torch.Tensor, side: int) -> torch.Tensor:
    return ((cell >= 0) & (cell < side)).all(dim=-1)


def _leaf_centers(coords: torch.Tensor, origin, span, side: int, dtype):
    """Leaf-centre coordinates of leaf coords (..., 3): the one decode
    shared by the expansions and the Taylor evaluations."""
    return origin + (coords.to(dtype) + 0.5) * (span / side)


# ---------------------------------------------------------------------------
# Coarse far field: local expansions about leaf centres
# ---------------------------------------------------------------------------


class _CoarseGrids:
    """Levels 2..depth-1 of the pyramid, zero-padded by the offset radius
    and flattened, so that a cell's level-d list is one gather (the
    padding's zero mass drops the cells off the grid, as the JAX package's
    padded slices do). ``window=True`` reads a (W, W, W) window of each
    cell's neighbourhood first and the list from it (the JAX package's
    ``far_mode="window"``); the values read are the same."""

    def __init__(self, levels, depth: int, ws: int, span, window: bool):
        self.lists, _, self.win_idx = _list_tables(ws, span.device)
        self.wrad = 2 * ws + 1  # the offsets' radius
        self.window = window
        self.grids = []
        pad = self.wrad
        for d in range(2, depth):
            sd = 1 << d
            sp = sd + 2 * pad
            chans = [levels[d][0].reshape(sd, sd, sd, 1),
                     levels[d][1].reshape(sd, sd, sd, 3)]
            if len(levels[d]) > 2:
                chans.append(levels[d][2].reshape(sd, sd, sd, 6))
            grid = F.pad(torch.cat(chans, dim=-1), (0, 0) + (pad,) * 6)
            self.grids.append((d, sp, span / sd, grid.reshape(sp**3, -1),
                               len(levels[d]) > 2))
        w = torch.arange(-self.wrad, self.wrad + 1, device=span.device)
        wx, wy, wz = torch.meshgrid(w, w, w, indexing="ij")
        self.window_offsets = torch.stack([wx, wy, wz], -1).reshape(-1, 3)

    def read(self, grid, sp: int, anc, parity):
        """(C, Lv, channels) level values of each cell's list."""
        if self.window:
            cell = anc[:, None, :] + self.window_offsets + self.wrad
            win = grid[_flat(cell, sp)]  # (C, W^3, channels)
            idx = self.win_idx[parity]  # (C, Lv)
            return win.gather(1, idx[..., None].expand(-1, -1, grid.shape[1]))
        cell = anc[:, None, :] + self.lists[parity] + self.wrad
        return grid[_flat(cell, sp)]


def _coarse_expansions(coarse: _CoarseGrids, coords, centers, depth: int,
                       g: float, eps: float, h_leaf, m_scale, order: int,
                       potential: bool = False):
    """p = ``order`` local expansions about the centres of the leaves
    ``coords`` (C, 3), summed over the interaction lists of every ancestor
    level d in [2, depth-1]: (F (C, 3), J (C, 6) with its trace term, A
    (C, 3), T (C, 10), phi (C,)), A and T None below order 2 and phi None
    without ``potential``. The flush-safe forms of the JAX package's
    ``_coarse_leaf_expansions``: J from 3 w uhat uhat, A = sum w hq uhat, T
    = sum w hq uhat uhat uhat (10 packed symmetric components) with uhat
    = u / r and hq = h_leaf / r."""
    c = coords.shape[0]
    zeros = centers.new_zeros
    f, j6, trace_w = zeros((c, 3)), zeros((c, 6)), zeros(c)
    a3 = zeros((c, 3)) if order >= 2 else None
    t10 = zeros((c, 10)) if order >= 2 else None
    phi = zeros(c) if potential else None
    for d, sp, h_d, grid, use_quad in coarse.grids:
        k = depth - d
        anc = coords >> k
        vals = coarse.read(grid, sp, anc, _parity(coords, k))
        sm, sc = vals[..., 0], vals[..., 1:4]
        ok = sm > 0
        diff = torch.where(ok[..., None], sc - centers[:, None, :], 0.0)
        r2 = (diff * diff).sum(dim=-1) + eps * eps
        safe = torch.where(ok, r2, 1.0)
        inv_r = torch.rsqrt(safe)
        inv_r2 = inv_r * inv_r
        w = torch.where(ok, ((g * sm) * inv_r) * inv_r2, 0.0)
        f = f + (w[..., None] * diff).sum(dim=1)
        if phi is not None:
            phi = phi + (w * safe).sum(dim=1)
        uh = diff * inv_r[..., None]
        if use_quad:
            sq = torch.where(ok[..., None], vals[..., 4:10], 0.0)
            f = f + _quad_correction(diff, inv_r, sq, ok, g, m_scale,
                                     h_d).sum(dim=1)
        ux, uy, uz = uh[..., 0], uh[..., 1], uh[..., 2]
        w3 = 3.0 * w
        j6 = j6 + torch.stack([
            (w3 * ux * ux).sum(dim=1), (w3 * uy * uy).sum(dim=1),
            (w3 * uz * uz).sum(dim=1), (w3 * ux * uy).sum(dim=1),
            (w3 * ux * uz).sum(dim=1), (w3 * uy * uz).sum(dim=1),
        ], dim=1)
        trace_w = trace_w + w.sum(dim=1)
        if order >= 2:
            whq = w * (h_leaf * inv_r)
            a3 = a3 + (whq[..., None] * uh).sum(dim=1)
            t10 = t10 + torch.stack([
                (whq * ux * ux * ux).sum(dim=1),  # xxx
                (whq * uy * uy * uy).sum(dim=1),  # yyy
                (whq * uz * uz * uz).sum(dim=1),  # zzz
                (whq * ux * ux * uy).sum(dim=1),  # xxy
                (whq * ux * ux * uz).sum(dim=1),  # xxz
                (whq * ux * uy * uy).sum(dim=1),  # xyy
                (whq * uy * uy * uz).sum(dim=1),  # yyz
                (whq * ux * uz * uz).sum(dim=1),  # xzz
                (whq * uy * uz * uz).sum(dim=1),  # yzz
                (whq * ux * uy * uz).sum(dim=1),  # xyz
            ], dim=1)
    j6 = j6 - torch.cat([trace_w[:, None].expand(-1, 3), zeros((c, 3))],
                        dim=1)
    return f, j6, a3, t10, phi


def _eval_far(f, j6, a3, t10, dx, h_leaf, order: int):
    """Taylor evaluation of the rows' local expansions at offsets ``dx``
    from their leaf centres: F + J dx, plus at order 2 the Hessian term
    h_leaf [-3 dxh (A . dxh) - 1.5 |dxh|^2 A + 7.5 T : dxh dxh] in the
    hatted moments (dxh = dx / h_leaf)."""
    far = f + _apply_j(j6, dx)
    if order < 2:
        return far
    dxh = dx / h_leaf
    x, y, z = dxh[:, 0], dxh[:, 1], dxh[:, 2]
    adx = a3[:, 0] * x + a3[:, 1] * y + a3[:, 2] * z
    dx2 = x * x + y * y + z * z
    txx, tyy, tzz = t10[:, 0], t10[:, 1], t10[:, 2]
    txxy, txxz, txyy = t10[:, 3], t10[:, 4], t10[:, 5]
    tyyz, txzz, tyzz = t10[:, 6], t10[:, 7], t10[:, 8]
    txyz = t10[:, 9]
    tdd = torch.stack([
        txx * x * x + txyy * y * y + txzz * z * z
        + 2.0 * (txxy * x * y + txxz * x * z + txyz * y * z),
        txxy * x * x + tyy * y * y + tyzz * z * z
        + 2.0 * (txyy * x * y + txyz * x * z + tyyz * y * z),
        txxz * x * x + tyyz * y * y + tzz * z * z
        + 2.0 * (txyz * x * y + txzz * x * z + tyzz * y * z),
    ], dim=1)
    return far + h_leaf * (-3.0 * adx[:, None] * dxh
                           - 1.5 * dx2[:, None] * a3 + 7.5 * tdd)


# ---------------------------------------------------------------------------
# Sources by neighbour: the dense grid's lookups (ops/sfmm.py has the
# rank-table ones)
# ---------------------------------------------------------------------------


def overflow_remainder(cells_pos, cells_mass, count, cell_mhat, tot_mw,
                       m_scale, cap: int):
    """(over, rem_mhat, rem_com) of each cell from its normalised mass and
    mass-weighted position: its mass beyond the padded prefix of ``cap``
    slots and that remainder's COM, in normalised mass (m x overflows fp32
    at astronomical masses)."""
    pref_mhat = cells_mass.sum(dim=-1) / m_scale
    over = count > cap
    rem_mhat = torch.clamp_min(torch.where(over, cell_mhat - pref_mhat, 0.0),
                               0.0)
    pref_mw = ((cells_mass / m_scale)[..., None] * cells_pos).sum(dim=-2)
    rem_com = (tot_mw - pref_mw) / torch.clamp_min(rem_mhat, 1e-37)[:, None]
    return over, rem_mhat, rem_com


class DenseSources:
    """The source side of the dense grid: leaf monopoles (and
    quadrupoles), the (side^3, cap) slot blocks and their overflow
    remainders, looked up by leaf coords (cells off the grid read as
    empty)."""

    def __init__(self, levels, depth: int, cells_pos, cells_mass, count,
                 m_scale, cap: int):
        self.side = 1 << depth
        self.cmass, self.ccom = levels[depth][0], levels[depth][1]
        self.cquad = levels[depth][2] if len(levels[depth]) > 2 else None
        self.cells_pos, self.cells_mass = cells_pos, cells_mass
        cell_mhat = self.cmass / m_scale
        self.over, self.rem_mhat, self.rem_com = overflow_remainder(
            cells_pos, cells_mass, count, cell_mhat,
            self.ccom * cell_mhat[:, None], m_scale, cap)
        self.m_scale = m_scale
        self.cap = cap

    def _ids(self, cell):
        in_b = _in_grid(cell, self.side)
        return in_b, _flat(cell.clamp(0, self.side - 1), self.side)

    def monopoles(self, cell):
        """(mass, com, quad | None, mono_ok, quad_ok) of list cells."""
        in_b, nid = self._ids(cell)
        sm = torch.where(in_b, self.cmass[nid], 0.0)
        ok = sm > 0
        sq = self.cquad[nid] if self.cquad is not None else None
        return sm, self.ccom[nid], sq, ok, ok

    def blocks(self, cell):
        """(slot positions, slot masses, overflow flag, remainder mass
        (normalised), remainder COM, None) of neighbour cells."""
        in_b, nid = self._ids(cell)
        smass = torch.where(in_b[:, None], self.cells_mass[nid], 0.0)
        return (self.cells_pos[nid], smass, in_b & self.over[nid],
                self.rem_mhat[nid], self.rem_com[nid], None)


# ---------------------------------------------------------------------------
# The cell pass: finest list + near field over target leaves
# ---------------------------------------------------------------------------


def _finest(src, tcoords, tpos, lists, g: float, eps: float, h_leaf,
            m_scale, potential: bool):
    """The leaf-level interaction list, exact per target: (C, t, 3) and
    phi (C, t) | None. Offsets are taken in groups that keep the (C,
    group, t, 3) temporary within :data:`PASS_BUDGET`."""
    c, t = tpos.shape[0], tpos.shape[1]
    offs = lists[_parity(tcoords)]  # (C, Lv, 3)
    # Sized by the nominal chunk of leaves, so that a leaf's sum takes the
    # same groups whatever share of the leaves its chunk holds.
    group = max(1, PASS_BUDGET // max(1, 3 * _cell_chunk(t, src.cap) * t))
    acc = tpos.new_zeros((c, t, 3))
    phi = tpos.new_zeros((c, t)) if potential else None
    for lo in range(0, offs.shape[1], group):
        cell = tcoords[:, None, :] + offs[:, lo:lo + group]
        sm, sc, sq, ok, q_ok = src.monopoles(cell)
        okt = ok[..., None]
        diff = torch.where(okt[..., None],
                           sc[:, :, None, :] - tpos[:, None, :, :], 0.0)
        r2 = (diff * diff).sum(dim=-1) + eps * eps
        # Masked lanes: diff is zeroed there, so with eps = 0 rsqrt(0) = inf
        # would poison 0 * inf downstream.
        safe = torch.where(okt, r2, 1.0)
        inv_r = torch.rsqrt(safe)
        w = torch.where(okt, ((g * sm[..., None]) * inv_r) * inv_r * inv_r,
                        0.0)
        acc = acc + (w[..., None] * diff).sum(dim=1)
        if phi is not None:
            phi = phi + (w * safe).sum(dim=1)
        if sq is not None:
            qt = q_ok[..., None]
            sqm = torch.where(q_ok[..., None], sq, 0.0)[:, :, None, :]
            acc = acc + _quad_correction(diff, inv_r, sqm, qt, g, m_scale,
                                         h_leaf).sum(dim=1)
    return acc, phi


def _monopole_on_slots(acc, phi, tpos, ok, m_hat, com, m_scale, g: float,
                       eps2):
    """Add the monopole of (m_hat m_scale, com) (C,), (C, 3) at every slot
    of the (C, t, 3) targets where ``ok`` (C,), softened by eps2 (a device
    scalar)."""
    diff = torch.where(ok[:, None, None], com[:, None, :] - tpos, 0.0)
    r2 = (diff * diff).sum(dim=-1) + eps2
    inv_r = torch.rsqrt(r2)
    w = torch.where(ok[:, None],
                    ((g * (m_hat * m_scale))[:, None] * inv_r) * inv_r
                    * inv_r, 0.0)
    acc = acc + w[..., None] * diff
    if phi is not None:
        phi = phi + w * r2
    return acc, phi


def _near(src, tcoords, tpos, near, g: float, cutoff: float, eps: float,
          eps_over, m_scale, potential: bool):
    """The exact near field of the target leaves over their 27 neighbours'
    slot blocks, each neighbour's overflow remainder as a monopole softened
    to half a leaf (and, for the sparse layout, a rank-overflow
    neighbour's whole mass so): (C, t, 3) and phi (C, t) | None. Padded
    slots carry mass 0, so the cutoff guard is the only mask; a target
    coinciding with a source gets exactly zero from it."""
    c, t = tpos.shape[0], tpos.shape[1]
    acc = tpos.new_zeros((c, t, 3))
    phi = tpos.new_zeros((c, t)) if potential else None
    eps2_over = eps_over * eps_over
    for o in near:
        spos, smass, r_over, r_m, r_c, whole = src.blocks(tcoords + o)
        diff = spos[:, None, :, :] - tpos[:, :, None, :]
        r2s = (diff * diff).sum(dim=-1) + eps * eps
        okp = r2s > cutoff * cutoff
        safe = torch.where(okp, r2s, 1.0)
        inv_r = torch.rsqrt(safe)
        w = torch.where(okp, ((g * smass[:, None, :]) * inv_r) * inv_r
                        * inv_r, 0.0)
        acc = acc + (w[..., None] * diff).sum(dim=2)
        if phi is not None:
            phi = phi + (w * safe).sum(dim=-1)
        acc, phi = _monopole_on_slots(acc, phi, tpos, r_over, r_m, r_c,
                                      m_scale, g, eps2_over)
        if whole is not None:
            acc, phi = _monopole_on_slots(acc, phi, tpos, *whole, m_scale,
                                          g, eps2_over)
    return acc, phi


class CellShare:
    """A rank's contiguous share of the target cells of :func:`cell_pass`
    and the all-gather of the per-cell outputs in rank order: the split of
    the sharded FMM forms (the JAX package's ``slab_ids`` and
    ``chunk_sel``). :meth:`bounds` gives every rank's range (the build is
    replicated, so each rank knows all of them)."""

    def __init__(self, rank: int, world: int, group=None):
        self.rank, self.world, self.group = rank, world, group

    def bounds(self, tcoords) -> list:
        raise NotImplementedError

    def gather(self, outs: tuple, bounds: list) -> tuple:
        """The per-cell outputs of every rank, concatenated in rank order:
        one all-gather of the rank's outputs packed into one (C_r, W) block
        padded to the largest share."""
        from ..parallel.mesh import all_gather_rows

        live = [o for o in outs if o is not None]
        counts = [hi - lo for lo, hi in zip(bounds[:-1], bounds[1:])]
        width = max(counts)
        flat = torch.cat([o.reshape(o.shape[0], math.prod(o.shape[1:]))
                          for o in live], dim=1)
        block = flat.new_zeros((width, flat.shape[1]))
        block[:flat.shape[0]] = flat
        every = all_gather_rows(block, self.group).reshape(
            self.world, width, -1)
        whole = torch.cat([every[r, :counts[r]] for r in range(self.world)])
        out, col = [], 0
        for o in outs:
            if o is None:
                out.append(None)
                continue
            w = math.prod(o.shape[1:])
            out.append(whole[:, col:col + w].reshape(-1, *o.shape[1:]))
            col += w
        return tuple(out)


class SlabShare(CellShare):
    """Whole x-slabs of the dense leaf grid: rank r takes the leaves with
    x in [r side/P, (r+1) side/P) (``make_sharded_fmm_accel``'s slab
    runs; the slab width shrinks until the slab count divides the world,
    which leaves side/P planes a rank). A world that does not divide the
    side is refused with the JAX package's message."""

    def __init__(self, rank: int, world: int, depth: int, group=None):
        super().__init__(rank, world, group)
        side = 1 << depth
        if side % world:
            raise ValueError(
                f"mesh size {world} does not divide the {side} near-field "
                f"slabs at depth={depth}; use a power-of-two mesh <= {side}")
        self.planes = side // world

    def bounds(self, tcoords) -> list:
        # The target leaves are in ascending leaf id, so x ascends.
        edges = torch.arange(self.world + 1, device=tcoords.device) \
            * self.planes
        return torch.searchsorted(tcoords[:, 0].contiguous(),
                                  edges.to(tcoords.dtype)).tolist()


class ChunkShare(CellShare):
    """``per_rank`` consecutive cell ranks a rank (the sparse FMM's K
    chunks split over the world, ``make_sharded_sfmm_accel``)."""

    def __init__(self, rank: int, world: int, per_rank: int, group=None):
        super().__init__(rank, world, group)
        self.per_rank = per_rank

    def bounds(self, tcoords) -> list:
        c = tcoords.shape[0]
        return [min(r * self.per_rank, c) for r in range(self.world + 1)]


def cell_pass(src, coarse, tcoords, tpos, *, depth: int, ws: int, g: float,
              cutoff: float, eps: float, origin, span, m_scale, order: int,
              potential: bool, prefix: str, share: CellShare | None = None):
    """The per-leaf passes for target leaves ``tcoords`` (C, 3) with
    (C, t, 3) slot positions, in chunks of :func:`_cell_chunk` leaves:
    (near + finest (C, t, 3), their phi (C, t) | None, and the leaves'
    expansions (F, J, A, T, phi)). With ``share`` this rank runs its own
    range of the leaves and the outputs of all are gathered."""
    side = 1 << depth
    lists, near, _ = _list_tables(ws, tpos.device)
    h_leaf = span / side
    eps_over = torch.clamp_min(0.5 * h_leaf, eps)
    dtype = tpos.dtype
    chunk = _cell_chunk(tpos.shape[1], src.cap)
    bounds = None
    lo, hi = 0, tcoords.shape[0]
    if share is not None:
        bounds = share.bounds(tcoords)
        lo, hi = bounds[share.rank], bounds[share.rank + 1]
    parts = []
    # An empty share still runs one (empty) chunk: its outputs' shapes.
    for start in range(lo, hi, chunk) or [lo]:
        tc = tcoords[start:min(start + chunk, hi)]
        tp = tpos[start:min(start + chunk, hi)]
        with record_function(f"{prefix}.far"):
            exp = _coarse_expansions(
                coarse, tc, _leaf_centers(tc, origin, span, side, dtype),
                depth, g, eps, h_leaf, m_scale, order, potential)
        with record_function(f"{prefix}.near_finest"):
            acc, phi = _near(src, tc, tp, near, g, cutoff, eps, eps_over,
                             m_scale, potential)
            acc_f, phi_f = _finest(src, tc, tp, lists, g, eps, h_leaf,
                                   m_scale, potential)
            acc = acc + acc_f
            if potential:
                phi = phi + phi_f
        parts.append((acc, phi) + exp)
    outs = tuple(None if p[0] is None else torch.cat(p)
                 for p in zip(*parts))
    if share is not None:
        with record_function(f"{prefix}.gather"):
            outs = share.gather(outs, bounds)
    return outs


# ---------------------------------------------------------------------------
# Per-point monopole hierarchy (the fallback)
# ---------------------------------------------------------------------------


def _fallback_chunk(cap: int) -> int:
    return max(1, PASS_BUDGET // (3 * 27 * max(1, cap)))


def _point_monopoles(eval_pos, sm, sc, ok, eps_here, g: float):
    """Sum over axis 1 of the monopoles (sm, sc) (M, L[, 3]) at ``eval_pos``
    (M, 3) where ``ok``, each softened by ``eps_here`` (L,) or a scalar:
    (acc (M, 3), phi (M,), diff, inv_r)."""
    diff = torch.where(ok[..., None], sc - eval_pos[:, None, :], 0.0)
    r2 = (diff * diff).sum(dim=-1) + eps_here * eps_here
    safe = torch.where(ok, r2, 1.0)
    inv_r = torch.rsqrt(safe)
    w = torch.where(ok, ((g * sm) * inv_r) * inv_r * inv_r, 0.0)
    return ((w[..., None] * diff).sum(dim=1), (w * safe).sum(dim=1), diff,
            inv_r)


def monopole_neighborhood(src, eval_pos, eval_coords, *, ws: int, g: float,
                          cutoff: float, eps: float, span, side: int,
                          m_scale):
    """The leaf-level 7^3 neighbourhood of each eval point's leaf at the
    point's OWN position (the JAX package's ``_monopole_neighborhood``
    with cell blocks): the list cells as monopoles with the run's eps
    (and their quadrupoles), the 27 near cells exact over their slots
    plus each one's overflow remainder softened to half a leaf. Returns
    (acc (M, 3), phi (M,))."""
    lists, near, _ = _list_tables(ws, eval_pos.device)
    h_leaf = span / side
    eps_over = torch.clamp_min(0.5 * h_leaf, eps)
    cell = eval_coords[:, None, :] + lists[_parity(eval_coords)]
    sm, sc, sq, ok, q_ok = src.monopoles(cell)
    acc, phi, diff, inv_r = _point_monopoles(eval_pos, sm, sc, ok, eps, g)
    if sq is not None:
        sqm = torch.where(q_ok[..., None], sq, 0.0)
        acc = acc + _quad_correction(diff, inv_r, sqm, q_ok, g, m_scale,
                                     h_leaf).sum(dim=1)
    # The exact near 27: slot pairs and overflow remainders.
    ncell = eval_coords[:, None, :] + near  # (M, 27, 3)
    m = eval_pos.shape[0]
    spos, smass, r_over, r_m, r_c, whole = src.blocks(ncell.reshape(-1, 3))
    diff = spos.reshape(m, -1, 3) - eval_pos[:, None, :]
    r2s = (diff * diff).sum(dim=-1) + eps * eps
    okp = r2s > cutoff * cutoff
    safe = torch.where(okp, r2s, 1.0)
    inv_r = torch.rsqrt(safe)
    w = torch.where(okp, ((g * smass.reshape(m, -1)) * inv_r) * inv_r
                    * inv_r, 0.0)
    acc = acc + (w[..., None] * diff).sum(dim=1)
    phi = phi + (w * safe).sum(dim=1)
    mono = [(r_over, r_m, r_c)] + ([whole] if whole is not None else [])
    for ok_o, m_o, c_o in mono:
        a, p, _, _ = _point_monopoles(
            eval_pos, (m_o * m_scale).reshape(m, -1),
            c_o.reshape(m, -1, 3), ok_o.reshape(m, -1), eps_over, g)
        acc, phi = acc + a, phi + p
    return acc, phi


def monopole_coarse_levels(coarse: _CoarseGrids, eval_pos, eval_coords,
                           depth: int, g: float, eps: float):
    """Every level-d (d in [2, depth-1]) interaction list as monopoles at
    the points' own positions, with the run's eps (the JAX package's
    ``_monopole_coarse_levels``): (acc (M, 3), phi (M,)). Out-of-cube
    points read their clipped edge cell's list, at real distances."""
    acc = eval_pos.new_zeros((eval_pos.shape[0], 3))
    phi = eval_pos.new_zeros(eval_pos.shape[0])
    for d, sp, _, grid, _ in coarse.grids:
        k = depth - d
        anc = eval_coords >> k
        cell = anc[:, None, :] + coarse.lists[_parity(eval_coords, k)] \
            + coarse.wrad
        vals = grid[_flat(cell, sp)]
        sm = vals[..., 0]
        a, p, _, _ = _point_monopoles(eval_pos, sm, vals[..., 1:4], sm > 0,
                                      eps, g)
        acc, phi = acc + a, phi + p
    return acc, phi


def chunked_points(fn, eval_pos, eval_coords, cap: int):
    """``fn(pos, coords) -> (acc, phi)`` over point chunks that keep the
    (M, 27 cap, 3) temporary within :data:`PASS_BUDGET`."""
    chunk = _fallback_chunk(cap)
    parts = [fn(eval_pos[lo:lo + chunk], eval_coords[lo:lo + chunk])
             for lo in range(0, eval_pos.shape[0], chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


# ---------------------------------------------------------------------------
# Target binning and the evaluation
# ---------------------------------------------------------------------------


def bin_targets(t_ids, t_cap: int, fallback_of):
    """Targets by leaf: a stable sort of the leaf ids, each target's rank
    among the occupied leaves and slot in its leaf, and the fallback flags
    ``fallback_of(sorted slot, sort order)``; one host read gives the
    number of occupied leaves C and of fallback targets. Returns (sort,
    sorted ids, first-of-leaf flags, rank, slot, C, the fallback targets'
    sorted indices)."""
    n = t_ids.shape[0]
    sort = torch.argsort(t_ids, stable=True)
    sids = t_ids[sort]
    is_first = torch.ones_like(sids, dtype=torch.bool)
    is_first[1:] = sids[1:] != sids[:-1]
    rank = torch.cumsum(is_first, 0) - 1
    idx = torch.arange(n, device=t_ids.device)
    start = torch.cummax(torch.where(is_first, idx, 0), 0).values
    slot = idx - start
    fb = fallback_of(slot, sort)
    n_cells, n_fb = torch.stack([rank[-1] + 1, fb.sum()]).tolist()
    fb_idx = compact(fb, idx, n_fb)
    return sort, sids, is_first, rank, slot, n_cells, fb_idx


def compact(mask, values, count: int):
    """``values[mask]`` for a count already read on the host, without a
    second wait for the device."""
    buf = values.new_zeros(count + 1)
    pos = torch.where(mask, torch.cumsum(mask, 0) - 1, count)
    buf[pos] = values
    return buf[:count]


def target_blocks(sorted_pos, sids, is_first, rank, slot, n_cells: int,
                  t_cap: int, side: int):
    """(leaf coords (C, 3), slot positions (C, t_cap, 3)) of the occupied
    target leaves, in ascending leaf id; slots past t_cap are dropped."""
    ids = compact(is_first, sids, n_cells)
    coords = torch.stack([ids // (side * side), (ids // side) % side,
                          ids % side], dim=1)
    kept = slot < t_cap
    s = torch.where(kept, rank * t_cap + slot, n_cells * t_cap)
    return coords, _scatter_cells(sorted_pos, s, n_cells, t_cap)


def _unsort(values, sort):
    out = torch.empty_like(values)
    out[sort] = values
    return out


def _dense_eval(targets, positions, masses, *, depth: int, leaf_cap: int,
                t_cap: int, ws: int, g: float, cutoff: float, eps: float,
                order: int, quad: bool, form: str,
                share: CellShare | None = None):
    """The dense-grid evaluation at ``targets``. ``form``: "self" (targets
    are the sources: slot-overflow targets take the monopole neighbourhood
    in place of their near + finest sums, as ``_fmm_core``), "vs" (slot
    overflow and targets outside the cube take the complete monopole
    hierarchy, as ``fmm_accelerations_vs``), "potential" (order 1, no
    quadrupoles, the phi channel; slot overflow takes the complete
    hierarchy's phi, as ``_fmm_pe_scaled``). Returns acc (K, 3), or (phi
    (K,), m_scale) for "potential". ``share``: this rank's share of the
    cell pass on a mesh (:func:`cell_pass`)."""
    side = 1 << depth
    dtype = positions.dtype
    potential = form == "potential"
    with record_function("fmm.build"):
        levels, origin, span, coords = build_octree(positions, masses, depth,
                                                    quad=quad)
        m_scale = _mass_scale(masses)
        cells_pos, cells_mass, count, *_ = bin_to_cells(
            positions, masses, coords, side, leaf_cap)
        src = DenseSources(levels, depth, cells_pos, cells_mass, count,
                           m_scale, leaf_cap)
        coarse = _CoarseGrids(levels, depth, ws, span, window=False)
        t_coords = grid_coords(targets, origin, span, side)

        def fallback_of(slot, sort):
            if form != "vs":
                return slot >= t_cap
            t = targets[sort]
            in_cube = ((t >= origin) & (t <= origin + span)).all(dim=1)
            return (slot >= t_cap) | ~in_cube

        sort, sids, is_first, rank, slot, n_cells, fb_idx = bin_targets(
            _flat(t_coords, side), t_cap, fallback_of)
        sorted_pos = targets[sort]
        tcoords, tpos = target_blocks(sorted_pos, sids, is_first, rank, slot,
                                      n_cells, t_cap, side)
    acc_cell, phi_cell, f, j6, a3, t10, phi_loc = cell_pass(
        src, coarse, tcoords, tpos, depth=depth, ws=ws, g=g, cutoff=cutoff,
        eps=eps, origin=origin, span=span, m_scale=m_scale, order=order,
        potential=potential, prefix="fmm", share=share)
    with record_function("fmm.eval"):
        flat = rank * t_cap + torch.clamp_max(slot, t_cap - 1)
        dx = sorted_pos - _leaf_centers(tcoords, origin, span, side,
                                        dtype)[rank]
        if potential:
            out = (phi_loc[rank] + (f[rank] * dx).sum(dim=-1)
                   + phi_cell.reshape(-1)[flat])
        else:
            near_sorted = acc_cell.reshape(-1, 3)[flat]
            far_sorted = _eval_far(
                f[rank], j6[rank], a3[rank] if a3 is not None else None,
                t10[rank] if t10 is not None else None, dx, span / side,
                order)
    if fb_idx.shape[0]:
        with record_function("fmm.fallback"):
            fpos = sorted_pos[fb_idx]
            fcoords = t_coords[sort][fb_idx]

            def neighborhood(p, c):
                return monopole_neighborhood(
                    src, p, c, ws=ws, g=g, cutoff=cutoff, eps=eps, span=span,
                    side=side, m_scale=m_scale)

            def all_levels(p, c):
                a, ph = neighborhood(p, c)
                a2, ph2 = monopole_coarse_levels(coarse, p, c, depth, g, eps)
                return a + a2, ph + ph2

            if form == "self":
                mono, _ = chunked_points(neighborhood, fpos, fcoords,
                                         leaf_cap)
                near_sorted = near_sorted.index_copy(0, fb_idx, mono)
            else:
                mono, mphi = chunked_points(all_levels, fpos, fcoords,
                                            leaf_cap)
    if potential:
        if fb_idx.shape[0]:
            out = out.index_copy(0, fb_idx, mphi)
        return _unsort(out, sort), m_scale
    acc = far_sorted + near_sorted
    if form == "vs" and fb_idx.shape[0]:
        acc = acc.index_copy(0, fb_idx, mono)
    return _unsort(acc, sort)


def fmm_accelerations(positions: torch.Tensor, masses: torch.Tensor, *,
                      depth: int = 6, leaf_cap: int = 32, ws: int = 1,
                      g: float = G, cutoff: float = CUTOFF_RADIUS,
                      eps: float = 0.0, order: int = 2,
                      quad: bool = True) -> torch.Tensor:
    """Dense-grid FMM accelerations for all particles (targets = sources).
    ``order=1, quad=False`` is the octree's ``far="expansion"``
    decomposition; the default (order-2 target expansions, source
    quadrupoles) is the ~0.2-0.3% median-error class of the octree's
    ``far="direct"``."""
    return _dense_eval(positions, positions, masses, depth=depth,
                       leaf_cap=leaf_cap, t_cap=leaf_cap, ws=ws, g=g,
                       cutoff=cutoff, eps=eps, order=order, quad=quad,
                       form="self")


def fmm_accelerations_vs(targets: torch.Tensor, positions: torch.Tensor,
                         masses: torch.Tensor, *, depth: int = 6,
                         leaf_cap: int = 32, t_cap: int = 0, ws: int = 1,
                         g: float = G, cutoff: float = CUTOFF_RADIUS,
                         eps: float = 0.0, order: int = 2,
                         quad: bool = True) -> torch.Tensor:
    """Dense-grid FMM accelerations at ``targets`` (K, 3) from sources
    (positions, masses): the rectangular form of the multirate kicks
    (cf. ``tree.tree_accelerations_vs``). The targets get their own
    binning on the source grid with ``t_cap`` slots a leaf (default
    ``leaf_cap``). Targets past t_cap, or outside the source cube (whose
    clipped edge leaf's expansion would diverge), take the complete
    monopole hierarchy at their own position. A target coinciding with a
    source gets exactly zero from it."""
    return _dense_eval(targets, positions, masses, depth=depth,
                       leaf_cap=leaf_cap, t_cap=t_cap or leaf_cap, ws=ws,
                       g=g, cutoff=cutoff, eps=eps, order=order, quad=quad,
                       form="vs")


def _fmm_pe_scaled(positions, masses, *, depth: int, leaf_cap: int, ws: int,
                   g: float, cutoff: float, eps: float):
    """(sum_i m_hat_i phi_i, m_scale) as device scalars, phi in g m / r
    units (fp32-safe); the -0.5 m_scale rescale is the host's, in f64."""
    phi, m_scale = _dense_eval(
        positions, positions, masses, depth=depth, leaf_cap=leaf_cap,
        t_cap=leaf_cap, ws=ws, g=g, cutoff=cutoff, eps=eps, order=1,
        quad=False, form="potential")
    return ((masses / m_scale) * phi).sum(), m_scale


def fmm_potential_energy(positions: torch.Tensor, masses: torch.Tensor, *,
                         depth: int = 6, leaf_cap: int = 32, ws: int = 1,
                         g: float = G, cutoff: float = CUTOFF_RADIUS,
                         eps: float = 0.0) -> np.float64:
    """Total potential energy through the FMM decomposition, -0.5 sum_i
    m_i phi_i with phi_i = sum_j g m_j / r_soft(i, j): the scalar channel
    rides the force passes (phi = w r2_safe; the coarse field's p = 1
    gradient is F). The dense diagnostic's conventions: sub-``cutoff``
    pairs give zero, the softened self term (r = eps) is included.
    Returns a host ``np.float64``."""
    s_hat, m_scale = _fmm_pe_scaled(
        positions, masses, depth=depth, leaf_cap=leaf_cap, ws=ws, g=g,
        cutoff=cutoff, eps=eps)
    return (np.float64(-0.5) * np.float64(float(m_scale))
            * np.float64(float(s_hat)))
