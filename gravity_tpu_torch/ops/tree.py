"""Barnes-Hut-style octree gravity.

Counterpart of ``gravity_tpu/ops/tree.py``: a levelized complete octree
over the bounding cube, evaluated with fixed-shape interaction lists.

- **Build**: every body's integer leaf coords at depth D; for each level
  d in [0, D] the cell masses and centres of mass (and, with ``quad``, the
  traceless quadrupole, stored as Q / (m_scale h_d^2)) by segment sums
  over the bodies' level-d cell ids (``cells.Segments``: at bf16 on the
  card one sort of the ids a level, masses and weighted positions in one
  launch, the quadrupoles in a second). The tree is a pyramid
  of flat (8^d,) arrays. The leaves are padded into (8^D, leaf_cap) slot
  blocks (``ops/cells.py::bin_to_cells``, a stable sort, so the same
  bodies take a leaf's slots as in the JAX package).
- **Far field**, plain PyTorch on every device (the JAX package's jnp
  gathers): for each level d in [2, D], the masked monopole (+ quadrupole)
  sum over the cells in a target's interaction list (children of its
  parent's radius-ws neighbourhood that are not in its own), per target
  chunk (``far="direct"``); or the coarse levels collapsed into per-leaf
  p=1 local expansions (``far="expansion"``).
- **Near field**: the exact pair sum over the (2 ws + 1)^3 neighbour
  leaves' first ``leaf_cap`` bodies. ``near_mode="gather"`` takes
  per-target block gathers inside the chunk loop, plain PyTorch as in the
  JAX package; ``near_mode="nlist"`` takes the cell-list tile engine
  (``ops/nlist.py::nlist_near_field``): the hand-written CUDA kernel
  ``csrc/nlist_pair.cu`` in its untruncated ``newton`` form on the card,
  its plain version on the CPU.
- **Overflow**: a neighbour leaf's mass beyond ``leaf_cap`` enters as a
  monopole softened to half the leaf size, so dense leaves degrade to the
  resolution limit and never drop mass.

A bf16 state is evaluated in bf16 throughout, as in the JAX package: cell
totals by bf16 segment sums (a cell of more than 256 to 512 bodies of
equal mass gets too little mass in both packages, ``cells.segment_sum``),
both far modes and both near fields, the latter through ``nlist_pair``'s
bf16 form on the card.

No step of an evaluation waits for the device: the overflow monopole,
which the JAX package gates with ``lax.cond``, is computed for every chunk
and masked (its terms are exact zeros off the overflow set).

Not ported here: the FMM and the sparse FMM that share this module's
sizing helpers in the JAX package (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import functools
import math
import warnings

import numpy as np
import torch
from torch.profiler import record_function

from ..config import TREE_FAR_MODES, TREE_NEAR_MODES
from ..constants import CUTOFF_RADIUS, G
from ..interop import to_numpy
from .cells import (
    Segments,
    _near_offsets,
    bin_to_cells,
    grid_coords,
    map_target_chunks,
)

# ---------------------------------------------------------------------------
# Interaction-list offset table: for each parity (cell coord mod 2 per axis)
# a mask over the relative-offset cube selecting the cells that are
# children of the parent's neighbours but not the cell's own neighbours.
# ---------------------------------------------------------------------------


def _offsets(ws: int) -> np.ndarray:
    """Relative-offset cube for well-separatedness ws: each axis in
    [-(2ws+1), 2ws+1]."""
    rng = range(-(2 * ws + 1), 2 * ws + 2)
    return np.array(
        [(dx, dy, dz) for dx in rng for dy in rng for dz in rng],
        dtype=np.int32,
    )


def _parity_mask_table(ws: int) -> np.ndarray:
    """(8, |offsets|) mask: children of the parent's radius-ws neighbourhood
    that are NOT in the cell's own radius-ws neighbourhood. Accepted cells
    are >= ws cells away: a worst-case Barnes-Hut theta of ~0.87 / ws."""
    offs = _offsets(ws)
    table = np.zeros((8, len(offs)), dtype=bool)
    for p in range(8):
        par = np.array([(p >> 2) & 1, (p >> 1) & 1, p & 1])
        parent_cell = np.floor((par[None, :] + offs) / 2)
        parent_ok = np.all(
            (parent_cell >= -ws) & (parent_cell <= ws), axis=1
        )
        not_near = np.max(np.abs(offs), axis=1) > ws
        table[p] = parent_ok & not_near
    return table


@functools.lru_cache(maxsize=None)
def _tables(ws: int, device: torch.device):
    """(offsets (L, 3), parity masks (8, L), near stencil (|near|, 3)) on
    the device, copied there once per (ws, device): a copy from pageable
    host memory would make the host wait for the stream every evaluation."""
    return (torch.as_tensor(_offsets(ws), dtype=torch.int64, device=device),
            torch.as_tensor(_parity_mask_table(ws), device=device),
            torch.as_tensor(_near_offsets(ws), dtype=torch.int64,
                            device=device))


# ---------------------------------------------------------------------------
# Tree build
# ---------------------------------------------------------------------------


def _mass_scale(masses):
    return torch.clamp_min(masses.max(), 1e-37)


def build_octree(positions, masses, depth: int, *, quad: bool = False):
    """Levelized octree: per-level dense (cell mass, cell COM[, quad]).

    Returns (levels, origin, span, coords) where levels[d] = (mass (8^d,),
    com (8^d, 3)) for d in [0, depth], plus, with ``quad``, the traceless
    quadrupole about the COM stored NORMALIZED as Q / (m_scale h_d^2), six
    components (xx, yy, zz, xy, xz, yz): m d^2 reaches ~1e50 at planetary
    masses and astronomical cells, past fp32, while d / h_d is O(1). The
    COM is accumulated with m / max(m) weights for the same reason."""
    lo = positions.min(dim=0).values
    hi = positions.max(dim=0).values
    span = (hi - lo).max() * 1.0001 + 1e-30
    origin = 0.5 * (hi + lo) - 0.5 * span

    coords = grid_coords(positions, origin, span, 1 << depth)
    m_scale = _mass_scale(masses)
    m_hat = masses / m_scale
    mw = m_hat[:, None] * positions
    levels = []
    for d in range(depth + 1):
        sd = 1 << d
        cd = coords >> (depth - d)
        ids = (cd[:, 0] * sd + cd[:, 1]) * sd + cd[:, 2]
        n_cells = sd**3
        segments = Segments(ids, n_cells)
        cmass_hat, cmw = segments.sum(m_hat, mw)
        ccom = cmw / torch.clamp_min(cmass_hat, 1e-37)[:, None]
        if not quad:
            levels.append((cmass_hat * m_scale, ccom))
            continue
        h_d = span / sd
        dvec = (positions - ccom[ids]) / h_d  # O(1) within the cell
        d2 = (dvec * dvec).sum(dim=1)
        dx, dy, dz = dvec[:, 0], dvec[:, 1], dvec[:, 2]
        q6 = torch.stack([
            m_hat * (3.0 * dx * dx - d2),
            m_hat * (3.0 * dy * dy - d2),
            m_hat * (3.0 * dz * dz - d2),
            m_hat * 3.0 * dx * dy,
            m_hat * 3.0 * dx * dz,
            m_hat * 3.0 * dy * dz,
        ], dim=1)
        levels.append((cmass_hat * m_scale, ccom, segments.sum(q6)[0]))
    return levels, origin, span, coords


def _leaf_coords(depth: int, device):
    side = 1 << depth
    cid = torch.arange(side**3, device=device)
    return torch.stack([cid // (side * side), (cid // side) % side,
                        cid % side], dim=1)


def _leaf_expansions(levels, origin, span, depth: int, ws: int, g: float,
                     eps: float, cell_chunk: int = 8192):
    """The coarse levels (2..depth-1) of the far field as p=1 local
    expansions about the LEAF centres: for every leaf, the monopole
    acceleration F and its symmetric Jacobian J (6 components) summed over
    its ancestors' interaction lists, evaluated at the leaf centre. A
    target then takes F + J (x - c_leaf). Returns (F (8^depth, 3), J
    (8^depth, 6))."""
    side = 1 << depth
    if depth <= 2:  # no coarse level
        return origin.new_zeros((side**3, 3)), origin.new_zeros((side**3, 6))
    stack = _LevelStack(levels, 2, depth - 1, depth, span, ws)
    leaf_h = span / side
    dtype = origin.dtype

    def one_chunk(coords_c):
        centers = origin[None, :] + (coords_c.to(dtype) + 0.5) * leaf_h
        ids, mask = stack.interaction_ids(coords_c)
        src_m = stack.mass[ids]  # (C, levels x L)
        ok = mask & (src_m > 0)
        diff = torch.where(ok[..., None],
                           stack.com[ids] - centers[:, None, :], 0.0)
        r2 = (diff * diff).sum(dim=-1) + eps * eps
        inv_r = torch.rsqrt(torch.where(ok, r2, 1.0))
        inv_r2 = inv_r * inv_r
        # w = G m / r^3, G m folded in first (fp32 subnormal guard).
        w = torch.where(ok, ((g * src_m) * inv_r) * inv_r2, 0.0)
        f = (w[..., None] * diff).sum(dim=1)
        # J_ij = -w delta_ij + 3 w u_i u_j with unit u = diff / r: the
        # textbook 3 w / r^2 factor is subnormal in fp32 at astronomical
        # scales and would flush the anisotropic part.
        uh = diff * inv_r[..., None]
        w3 = 3.0 * w
        ux, uy, uz = uh[..., 0], uh[..., 1], uh[..., 2]
        trace_w = w.sum(dim=1)
        j6 = torch.stack([
            (w3 * ux**2).sum(dim=1) - trace_w,
            (w3 * uy**2).sum(dim=1) - trace_w,
            (w3 * uz**2).sum(dim=1) - trace_w,
            (w3 * (ux * uy)).sum(dim=1), (w3 * (ux * uz)).sum(dim=1),
            (w3 * (uy * uz)).sum(dim=1),
        ], dim=1)
        return f, j6

    leaf_coords = _leaf_coords(depth, origin.device)
    parts = [one_chunk(leaf_coords[lo:lo + cell_chunk])
             for lo in range(0, side**3, cell_chunk)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _apply_j(j6, dx):
    """(J dx) for symmetric-6 J (N, 6) and dx (N, 3)."""
    jx = j6[:, 0] * dx[:, 0] + j6[:, 3] * dx[:, 1] + j6[:, 4] * dx[:, 2]
    jy = j6[:, 3] * dx[:, 0] + j6[:, 1] * dx[:, 1] + j6[:, 5] * dx[:, 2]
    jz = j6[:, 4] * dx[:, 0] + j6[:, 5] * dx[:, 1] + j6[:, 2] * dx[:, 2]
    return torch.stack([jx, jy, jz], dim=1)


# ---------------------------------------------------------------------------
# Evaluation pieces
# ---------------------------------------------------------------------------


def _monopole_acc(pos, cell_mass, cell_com, mask, g, eps, cell_quad=None,
                  h_d=None, m_scale=None):
    """Masked monopole (+ optional normalized quadrupole) sum: pos (C, 3);
    cells (C, L[, 3|6]); mask (C, L). ``eps`` is a float or a device
    scalar (the overflow channel's widened softening)."""
    diff = cell_com - pos[:, None, :]  # (C, L, 3)
    r2 = (diff * diff).sum(dim=-1) + eps * eps
    ok = mask & (cell_mass > 0)
    inv_r = torch.rsqrt(torch.where(ok, r2, 1.0))
    # fp32 order: G m folded in before the cube (subnormal flush guard).
    w = torch.where(ok, (((g * cell_mass) * inv_r) * inv_r) * inv_r, 0.0)
    # Masked slots may hold inf COMs; 0 * inf would be NaN.
    diff = torch.where(ok[..., None], diff, 0.0)
    acc = (w[..., None] * diff).sum(dim=1)
    if cell_quad is None:
        return acc
    q = torch.where(ok[..., None], cell_quad, 0.0)
    corr = _quad_correction(diff, inv_r, q, ok, g, m_scale, h_d)
    return acc + corr.sum(dim=1)


def _quad_dot(q, diff):
    """(Q diff) for symmetric-6-packed Q (..., 6) [xx, yy, zz, xy, xz, yz]
    and diff (..., 3)."""
    qd_x = q[..., 0] * diff[..., 0] + q[..., 3] * diff[..., 1] \
        + q[..., 4] * diff[..., 2]
    qd_y = q[..., 3] * diff[..., 0] + q[..., 1] * diff[..., 1] \
        + q[..., 5] * diff[..., 2]
    qd_z = q[..., 4] * diff[..., 0] + q[..., 5] * diff[..., 1] \
        + q[..., 2] * diff[..., 2]
    return torch.stack([qd_x, qd_y, qd_z], dim=-1)


def _quad_correction(diff, inv_r, q_masked, ok, g, m_scale, h):
    """Per-source acceleration of a normalized traceless quadrupole
    Q_hat = Q / (m_scale h^2):

        a_q = -c5 (Q_hat diff) + 2.5 c5 (diff . Q_hat diff) inv_r^2 diff

    with c5 = (G m_scale inv_r)(h inv_r)^2 inv_r^2, every factor O(m_scale
    / r) or O(1), where the raw G Q / r^5 flushes to zero in fp32 at
    astronomical scales."""
    inv_r2 = inv_r * inv_r
    s1 = (g * m_scale) * inv_r
    hq = h * inv_r
    c5 = torch.where(ok, ((s1 * hq) * hq) * inv_r2, 0.0)
    qd = _quad_dot(q_masked, diff)
    qq = (qd * diff).sum(dim=-1)
    return -c5[..., None] * qd + (((2.5 * c5) * qq) * inv_r2)[..., None] * diff


class _LevelStack:
    """Levels ``first``..``last`` of the pyramid as one flat set of cells,
    so that a target chunk gathers and sums the interaction lists of every
    level at once (the JAX package loops over the levels; one pass over
    all of them launches a level-count fewer operations). Holds the
    stacked (mass, com[, quad]), each column's h_d for the quadrupole, and
    the per-level constants of the lists, all made on the device."""

    def __init__(self, levels, first: int, last: int, depth: int, span,
                 ws: int):
        device = span.device
        offsets, self.parity_masks, _ = _tables(ws, device)
        d = torch.arange(first, last + 1, device=device)
        self.shifts = depth - d
        self.sd = torch.pow(2, d)
        self.start = (torch.pow(8, d) - 8**first) // 7
        # The flat id step of each offset at each level, (levels, L), and
        # the offsets by axis, (3, L).
        sd = self.sd[:, None]
        self.flat_offsets = (offsets[:, 0] * sd + offsets[:, 1]) * sd \
            + offsets[:, 2]
        self.axis_offsets = offsets.t().contiguous()
        stacked = [torch.cat([levels[k][i] for k in range(first, last + 1)])
                   for i in range(len(levels[first]))]
        self.mass, self.com = stacked[0], stacked[1]
        self.quad = stacked[2] if len(stacked) == 3 else None
        self.h = (span / self.sd.to(span.dtype)).repeat_interleave(
            offsets.shape[0])

    def interaction_ids(self, coords_c):
        """Stacked interaction-list cell ids (C, levels x L) and their
        validity mask, for targets in leaf cells ``coords_c`` (C, 3): at
        level d the children of the parent's radius-ws neighbourhood that
        are not in the cell's own. Ids of cells off the grid, which the
        mask drops, are set to 0 (the JAX package clips them)."""
        cd = coords_c[:, None, :] >> self.shifts[None, :, None]  # (C, l, 3)
        parity = ((cd[..., 0] & 1) << 2) | ((cd[..., 1] & 1) << 1) \
            | (cd[..., 2] & 1)
        ok = self.parity_masks[parity]  # (C, l, L)
        sd = self.sd[None, :, None]
        for a in range(3):
            # 0 <= cd + offset < sd, as offset >= -cd and offset < sd - cd.
            ca = cd[..., a, None]
            off = self.axis_offsets[a]
            ok = ok & (off >= -ca) & (off < sd - ca)
        base = (cd[..., 0] * self.sd + cd[..., 1]) * self.sd + cd[..., 2] \
            + self.start
        ids = torch.where(ok, base[:, :, None] + self.flat_offsets, 0)
        c = coords_c.shape[0]
        return ids.reshape(c, -1), ok.reshape(c, -1)


def _near_gather(coords_c, near, side: int, leaf_count, cells_pos,
                 cells_mass, leaf_cap: int):
    """Whole-block gathers of the neighbour leaves' padded (cap, 3) slot
    blocks. Returns (nids (C, |near|), counts (C, |near|), src_pos (C,
    |near| K, 3), src_mass (C, |near| K), valid (C, |near|, K))."""
    ncell = coords_c[:, None, :] + near[None, :, :]
    in_bounds = ((ncell >= 0) & (ncell < side)).all(dim=-1)
    ncell = ncell.clamp(0, side - 1)
    nids = (ncell[..., 0] * side + ncell[..., 1]) * side + ncell[..., 2]
    counts = torch.where(in_bounds, leaf_count[nids], 0)
    c = coords_c.shape[0]
    src_pos = cells_pos[nids].reshape(c, -1, 3)
    src_mass = cells_mass[nids].reshape(c, -1)
    k_idx = torch.arange(leaf_cap, device=coords_c.device)
    valid = k_idx < counts[..., None]
    return nids, counts, src_pos, src_mass, valid


def _overflow_remainder(src_pos, src_mass, valid, nids, cmass_l, ccom_l,
                        over, m_scale):
    """Remaining mass and COM of capped-out leaves: the cell total minus
    the gathered prefix, in normalized mass throughout (m x overflows fp32
    for heavy bodies). Returns (rem_mhat (C, |near|), rem_com (C, |near|,
    3))."""
    src_mhat = (src_mass / m_scale).reshape(valid.shape)
    pref_mhat = torch.where(valid, src_mhat, 0.0).sum(dim=-1)
    pref_mw = torch.where(
        valid[..., None],
        src_mhat[..., None] * src_pos.reshape(*valid.shape, 3), 0.0,
    ).sum(dim=-2)
    cmass_hat = cmass_l[nids] / m_scale
    rem_mhat = torch.clamp_min(
        torch.where(over, cmass_hat - pref_mhat, 0.0), 0.0)
    tot_mw = ccom_l[nids] * cmass_hat[..., None]
    rem_com = (tot_mw - pref_mw) / torch.clamp_min(rem_mhat, 1e-37)[..., None]
    return rem_mhat, rem_com


def _pair_acc(pos, src_pos, src_mass, mask, g, cutoff, eps):
    """Masked direct sum: pos (C, 3); sources (C, L[, 3])."""
    diff = src_pos - pos[:, None, :]
    r2s = (diff * diff).sum(dim=-1) + eps * eps
    ok = mask & (r2s > cutoff * cutoff)
    inv_r = torch.rsqrt(torch.where(ok, r2s, 1.0))
    w = torch.where(ok, (((g * src_mass) * inv_r) * inv_r) * inv_r, 0.0)
    diff = torch.where(ok[..., None], diff, 0.0)
    return (w[..., None] * diff).sum(dim=1)


def tree_accelerations_vs(
    targets: torch.Tensor,
    positions: torch.Tensor,
    masses: torch.Tensor,
    *,
    depth: int = 6,
    leaf_cap: int = 32,
    chunk: int = 1024,
    ws: int = 1,
    g: float = G,
    cutoff: float = CUTOFF_RADIUS,
    eps: float = 0.0,
    far: str = "direct",
    quad: bool = True,
    near_mode: str = "gather",
) -> torch.Tensor:
    """Octree accelerations at ``targets`` from sources (positions,
    masses).

    ``depth`` sets the leaf grid (2^depth a side), ``leaf_cap`` the
    near-field occupancy cap (beyond it a leaf's remainder enters as its
    monopole), ``ws`` the well-separatedness (cells >= ws apart are
    approximated; theta ~ 0.87 / ws), ``chunk`` the target chunk.
    ``far``: "direct" (per-target monopole + quadrupole sums over every
    level's interaction list) or "expansion" (coarse levels as per-leaf
    p=1 expansions, the finest list exact, monopole only). ``near_mode``:
    "gather" or "nlist" (ws = 1 only; see the module docstring)."""
    if far not in TREE_FAR_MODES:
        raise ValueError(f"unknown far-field mode {far!r}")
    if near_mode not in TREE_NEAR_MODES:
        raise ValueError(f"unknown near-field mode {near_mode!r}")
    if near_mode == "nlist" and ws != 1:
        raise ValueError(
            "near_mode='nlist' evaluates the shared 27-cell stencil "
            f"(ws=1); got ws={ws} — use near_mode='gather' for wider "
            "neighborhoods"
        )
    use_quad = quad and far == "direct"
    side = 1 << depth
    _, _, near = _tables(ws, positions.device)
    with record_function("tree.build"):
        levels, origin, span, coords = build_octree(positions, masses, depth,
                                                    quad=use_quad)
        m_scale = _mass_scale(masses)
        t_coords = grid_coords(targets, origin, span, side)
        # The first leaf_cap bodies of each leaf in stable sort order.
        cells_pos, cells_mass, leaf_count, *_ = bin_to_cells(
            positions, masses, coords, side, leaf_cap)
        if far == "expansion":
            f_leaf, j_leaf = _leaf_expansions(levels, origin, span, depth,
                                              ws, g, eps)
            leaf_h = span / side
        # Every level's list per target ("direct"), or only the finest,
        # whose p=1 expansion ratio would be too large ("expansion").
        first = 2 if far == "direct" else depth
        stack = (_LevelStack(levels, first, depth, depth, span, ws)
                 if depth >= first else None)
    cmass_l, ccom_l = levels[depth][0], levels[depth][1]
    # A target next to (or inside) an overflowing leaf would see a
    # point-monopole's spurious pull: soften it to the leaf size.
    eps_over = torch.clamp_min(0.5 * (span / side), eps)

    def chunk_acc(pos_c, coords_c):
        with record_function("tree.far"):
            if far == "expansion":
                # Coarse levels: one 9-float gather and a p=1 Taylor step
                # about the leaf centre; the finest list stays exact.
                lid = (coords_c[:, 0] * side + coords_c[:, 1]) * side \
                    + coords_c[:, 2]
                centers = origin[None, :] + (coords_c.to(pos_c.dtype)
                                             + 0.5) * leaf_h
                acc = f_leaf[lid] + _apply_j(j_leaf[lid], pos_c - centers)
            else:
                acc = torch.zeros_like(pos_c)
            if stack is not None:
                ids, mask = stack.interaction_ids(coords_c)
                acc = acc + _monopole_acc(
                    pos_c, stack.mass[ids], stack.com[ids], mask, g, eps,
                    cell_quad=stack.quad[ids] if use_quad else None,
                    h_d=stack.h, m_scale=m_scale,
                )
        if near_mode == "nlist":
            return acc  # the tile engine below takes the near field

        with record_function("tree.near_gather"):
            c = pos_c.shape[0]
            nids, counts, src_pos, src_mass, valid = _near_gather(
                coords_c, near, side, leaf_count, cells_pos, cells_mass,
                leaf_cap)
            acc = acc + _pair_acc(pos_c, src_pos, src_mass,
                                  valid.reshape(c, -1), g, cutoff, eps)
            # Capped-out leaves: the monopole of their remaining mass.
            over = counts > leaf_cap
            rem_mhat, rem_com = _overflow_remainder(
                src_pos, src_mass, valid, nids, cmass_l, ccom_l, over,
                m_scale)
            return acc + _monopole_acc(pos_c, rem_mhat * m_scale, rem_com,
                                       over, g, eps_over)

    acc = map_target_chunks(chunk_acc, targets, t_coords, chunk)
    if near_mode == "gather":
        return acc

    from .nlist import nlist_near_field

    return acc + nlist_near_field(
        targets, t_coords, cells_pos, cells_mass, leaf_count, cmass_l,
        ccom_l, m_scale, span, side, leaf_cap, g, cutoff, eps,
    )


def tree_accelerations(positions: torch.Tensor, masses: torch.Tensor,
                       **kwargs) -> torch.Tensor:
    """Octree accelerations for all particles (targets = sources)."""
    return tree_accelerations_vs(positions, positions, masses, **kwargs)


# ---------------------------------------------------------------------------
# Potential energy
# ---------------------------------------------------------------------------


def tree_potential_energy(
    positions: torch.Tensor,
    masses: torch.Tensor,
    *,
    depth: int = 6,
    leaf_cap: int = 32,
    chunk: int = 1024,
    ws: int = 1,
    g: float = G,
    cutoff: float = CUTOFF_RADIUS,
    eps: float = 0.0,
    quad: bool = True,
) -> np.float64:
    """Total potential energy via the octree, -0.5 sum_i G m_i phi_i: the
    scalable counterpart of ``ops/forces.py::potential_energy`` (whose
    dense pair scan costs ~5.5e11 pair evaluations at 1M bodies). The
    force path's decomposition in "direct" far mode: per-level
    interaction-list sums of m / r (with ``quad`` the quadrupole term
    (1/2) Q:uu / r^5), the exact capped near field and the leaf-softened
    overflow monopole. As the dense diagnostic: Plummer-softened r,
    sub-``cutoff`` pairs give zero, and the softened self term (r = eps) is
    included (a constant at fixed masses).

    Returns a host ``np.float64``: the device sums in normalized masses
    (m / max(m), in fp32 range) and the -0.5 G m_scale^2 rescale happens
    on the host in float64 (the raw value reaches ~1e42 at astronomical
    masses, past fp32)."""
    s_hat, m_scale = _tree_pe_scaled(
        positions, masses, depth=depth, leaf_cap=leaf_cap, chunk=chunk,
        ws=ws, cutoff=cutoff, eps=eps, quad=quad,
    )
    return (np.float64(-0.5 * g) * np.float64(float(m_scale)) ** 2
            * np.float64(float(s_hat)))


def _masked_inv_r_sum(pos_c, src_m, src_pos, ok, eps, m_scale,
                      cell_quad=None, h_d=None):
    """sum over sources of m / sqrt(r^2 + eps^2), masked; with
    ``cell_quad`` plus the quadrupole term (1/2) Q:uu / r^5 (Q = m_scale
    h_d^2 Q_hat), ordered so every factor is O(m_scale / r) or O(1)."""
    diff = torch.where(ok[..., None], src_pos - pos_c[:, None, :], 0.0)
    r2 = (diff * diff).sum(dim=-1) + eps * eps
    inv_r = torch.where(ok, torch.rsqrt(torch.where(ok, r2, 1.0)), 0.0)
    rows = (src_m * inv_r).sum(dim=-1)
    if cell_quad is None:
        return rows
    q = torch.where(ok[..., None], cell_quad, 0.0)
    qq = (_quad_dot(q, diff) * diff).sum(dim=-1)
    hq = h_d * inv_r
    inv_r2 = inv_r * inv_r
    return rows + ((((0.5 * (m_scale * inv_r)) * hq) * hq)
                   * (qq * inv_r2)).sum(dim=-1)


def _tree_pe_scaled(positions, masses, *, depth: int, leaf_cap: int,
                    chunk: int, ws: int, cutoff: float, eps: float,
                    quad: bool):
    """(sum_i m_hat_i sum_j m_hat_j / r_ij, m_scale): device scalars in
    fp32 range (see :func:`tree_potential_energy`)."""
    levels, origin, span, coords = build_octree(positions, masses, depth,
                                                quad=quad)
    side = 1 << depth
    m_scale = _mass_scale(masses)
    cells_pos, cells_mass, leaf_count, *_ = bin_to_cells(
        positions, masses, coords, side, leaf_cap)
    _, _, near = _tables(ws, positions.device)
    stack = (_LevelStack(levels, 2, depth, depth, span, ws) if depth >= 2
             else None)
    cmass_l, ccom_l = levels[depth][0], levels[depth][1]
    eps_over = torch.clamp_min(0.5 * (span / side), eps)

    def chunk_rows(pos_c, coords_c):
        rows = pos_c.new_zeros(pos_c.shape[0])
        # Far field: no cutoff on cells, as in the force path, where the
        # cutoff guards near-field point pairs only.
        if stack is not None:
            ids, mask = stack.interaction_ids(coords_c)
            src_m = stack.mass[ids]
            rows = rows + _masked_inv_r_sum(
                pos_c, src_m, stack.com[ids], mask & (src_m > 0), eps,
                m_scale, cell_quad=stack.quad[ids] if quad else None,
                h_d=stack.h,
            )
        # Near field: the exact capped pairs, with the cutoff convention of
        # the dense diagnostic.
        c = pos_c.shape[0]
        nids, counts, src_pos, src_mass, valid_3d = _near_gather(
            coords_c, near, side, leaf_count, cells_pos, cells_mass,
            leaf_cap)
        diff = src_pos - pos_c[:, None, :]
        r2s = (diff * diff).sum(dim=-1) + eps * eps
        ok = valid_3d.reshape(c, -1) & (r2s > cutoff * cutoff)
        inv_r = torch.where(ok, torch.rsqrt(torch.where(ok, r2s, 1.0)), 0.0)
        rows = rows + (src_mass * inv_r).sum(dim=-1)
        # Overflow: the remaining mass of capped-out leaves as a
        # leaf-softened monopole.
        over = counts > leaf_cap
        rem_mhat, rem_com = _overflow_remainder(
            src_pos, src_mass, valid_3d, nids, cmass_l, ccom_l, over,
            m_scale)
        return rows + _masked_inv_r_sum(pos_c, rem_mhat * m_scale, rem_com,
                                        over, eps_over, m_scale)

    t_coords = grid_coords(positions, origin, span, side)
    rows = map_target_chunks(chunk_rows, positions, t_coords, chunk)
    # rows (~m n / r) fits fp32, G m rows may not at astronomical masses:
    # contract in normalized masses and rescale on the host in f64.
    s_hat = ((masses / m_scale) * (rows / m_scale)).sum()
    return s_hat, m_scale


# ---------------------------------------------------------------------------
# Sizing helpers (host numpy, as in the JAX package)
# ---------------------------------------------------------------------------


def _host_positions(positions) -> np.ndarray:
    if isinstance(positions, torch.Tensor):
        positions = to_numpy(positions)
    return np.asarray(positions, np.float64)


def recommended_depth(n: int, leaf_cap: int = 32) -> int:
    """Leaf depth so the mean occupied-leaf load is ~leaf_cap/4, ASSUMING
    uniform 3D occupancy. Real distributions are lower-dimensional (disks
    ~2D, collapsed halos ~0D) and overload this estimate's leaves: prefer
    :func:`recommended_depth_data` whenever positions exist."""
    target_cells = max(1, (4 * n) // leaf_cap)
    return max(2, min(8, math.ceil(math.log(target_cells, 8))))


def estimate_cell_memory_bytes(n: int, depth: int, leaf_cap: int, *,
                               quad: bool = True,
                               dtype_bytes: int = 4) -> int:
    """Device-memory footprint of the octree's cell structures at a depth:
    the level pyramid (mass, COM and quadrupole per cell, x8/7 of the leaf
    level), the padded (cells, cap) position and mass blocks (the dominant
    term, 16 B x 8^depth x leaf_cap in fp32) and the sorted particle
    copies."""
    cells = (1 << depth) ** 3
    per_cell = (10 if quad else 4) * dtype_bytes
    pyramid = cells * per_cell * 8 // 7
    padded = cells * leaf_cap * 4 * dtype_bytes  # pos(3) + mass(1)
    particles = n * 12 * dtype_bytes  # sorted pos/mass/ids working set
    return pyramid + padded + particles


# The JAX package's warning threshold for the cell structures alone (a
# quarter of a 16 GiB TPU chip's memory), kept so both packages warn at
# the same sizes.
CELL_MEMORY_WARN_BYTES = 4 << 30


def warn_if_cell_memory_heavy(n: int, depth: int, leaf_cap: int, where: str,
                              *, dtype_bytes: int = 4) -> int:
    """Estimate and warn past :data:`CELL_MEMORY_WARN_BYTES`; returns the
    estimate in bytes. Pass the run's element size: a float64 run
    allocates twice the fp32 footprint."""
    est = estimate_cell_memory_bytes(n, depth, leaf_cap,
                                     dtype_bytes=dtype_bytes)
    if est > CELL_MEMORY_WARN_BYTES:
        warnings.warn(
            f"{where}: octree cell structures at depth={depth}, "
            f"leaf_cap={leaf_cap} need ~{est / (1 << 30):.1f} GiB of "
            "device memory (padded per-cell blocks scale as "
            "16 B x 8^depth x cap) before integrator state and the "
            "evaluation's temporaries. Lower tree_depth/leaf_cap, or use "
            "p3m at this scale.",
            stacklevel=3,
        )
    return est


def _leaf_ids(pos: np.ndarray, side: int):
    origin = pos.min(axis=0)
    span = float((pos.max(axis=0) - origin).max())
    coords = np.clip((pos - origin) / span * side, 0, side - 1).astype(
        np.int64)
    return (coords[:, 0] * side + coords[:, 1]) * side + coords[:, 2]


def recommended_depth_data(positions, leaf_cap: int = 32, *,
                           max_depth: int = 7) -> int:
    """Data-driven leaf depth: the smallest depth whose mean OCCUPIED-leaf
    load is <= leaf_cap/2, so the capped-exact near field covers the
    typical leaf. Counts occupied leaves on the host (one pass per
    candidate depth), which the count-only :func:`recommended_depth`
    cannot: a thin disk at n = 1M occupies ~side^2 of the side^3 leaves.
    ``max_depth`` caps the padded leaf arrays (8^depth x leaf_cap); at it,
    a warning says the criterion is unmet."""
    occupied = 1
    pos = _host_positions(positions)
    span = float((pos.max(axis=0) - pos.min(axis=0)).max())
    if span <= 0.0 or pos.shape[0] <= leaf_cap:
        return 2
    for d in range(2, max_depth + 1):
        occupied = np.unique(_leaf_ids(pos, 1 << d)).size
        if pos.shape[0] / occupied <= leaf_cap / 2:
            return d
    mean_load = pos.shape[0] / max(occupied, 1)
    warnings.warn(
        f"octree depth railed at max_depth={max_depth}: mean occupied-leaf "
        f"load {mean_load:.0f} > leaf_cap/2 = {leaf_cap // 2} "
        f"(n={pos.shape[0]}). Unresolved cells degrade to softened "
        f"overflow monopoles; consider raising tree_leaf_cap, or p3m for "
        f"strongly clustered states.",
        stacklevel=2,
    )
    return max_depth


def recommended_leaf_cap(positions, depth: int, *, cap_min: int = 32,
                         cap_max: int = 256) -> int:
    """Data-driven near-field occupancy cap for a depth: the smallest
    power of two >= the DENSEST leaf's occupancy, clamped to [cap_min,
    cap_max], so that no mass flows through overflow monopoles."""
    pos = _host_positions(positions)
    span = float((pos.max(axis=0) - pos.min(axis=0)).max())
    if span <= 0.0:
        return cap_min
    occ = int(np.bincount(_leaf_ids(pos, 1 << depth)).max())
    cap = cap_min
    while cap < occ and cap < cap_max:
        cap *= 2
    return cap
