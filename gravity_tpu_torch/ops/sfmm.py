"""Sparse cell-list FMM: occupancy-proportional fast gravity for
clustered states.

Counterpart of ``gravity_tpu/ops/sfmm.py``. The dense-grid FMM
(``ops/fmm.py``) keeps its source side on whole ``side^3`` grids; this
layout compacts it to the K occupied leaves, which affords the deeper
grids (depth 8-9 against the dense rail at 7) that resolve a clustered
state's dense cells:

- **Compaction**: one stable sort by leaf id, occupied ranks from segment
  boundaries, the bodies padded into a (k_cells, cap) slot layout, per
  rank monopoles and quadrupoles over all of a leaf's bodies and overflow
  remainders, and a dense int32 rank table (``side^3`` entries, the only
  volume-sized array: 537 MB at depth 9) for cell -> rank lookups.
- **Coarse far field, finest list, near field**: the dense design's
  interaction sets and expansion maths (the passes of ``ops/fmm.py``,
  :func:`~gravity_tpu_torch.ops.fmm.cell_pass`), their sources looked up
  through the rank table (:class:`SparseSources`). ``far_mode``: "gather"
  reads each level's list cells straight from the padded level grids,
  "window" reads a (W, W, W) window a cell first (the TPU's choice in the
  JAX package); the values are the same. "auto" is "gather": the JAX
  package picks "window" on a TPU only.
- **Fallbacks**: slot-overflow targets and rank-overflow leaves (more
  than ``k_cells`` occupied) take the per-point monopole hierarchy (the
  leaf 7^3 neighbourhood through the rank table, every coarse ancestor's
  list). As a SOURCE, a rank-overflow leaf's mass enters its neighbours'
  near and finest sums as a monopole at its COM (softened to half a leaf
  in the near field), from per-rank channels that cover every occupied
  leaf.

Size ``k_cells`` from data with :func:`recommended_sparse_params`. The
sizing helpers are host numpy, as in the JAX package, and bin in the
positions' own dtype, so they return the JAX package's integers.

Host reads: one an evaluation (the occupied count and the fallback
count). A bf16 state runs at its own dtype, its cell totals through the
bf16 segment sum (``csrc/segment_sum.cu`` on the card), as the JAX
package's ``segment_sum`` at bf16. On a mesh
(``parallel/sharded_fmm.py``) every rank rebuilds the compaction from the
gathered state and runs the cell pass on its own run of the K chunks
(:class:`~gravity_tpu_torch.ops.fmm.ChunkShare`), with K and the chunk
width from :func:`sharded_k_sizing`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..constants import CUTOFF_RADIUS, G
from ..interop import to_numpy
from .cells import (
    _scatter_cells,
    grid_coords,
    segment_sum,
    sorted_segment_sum,
)
from .fmm import (
    _CoarseGrids,
    _eval_far,
    _flat,
    _in_grid,
    _leaf_centers,
    _list_tables,
    _parity,
    _point_monopoles,
    _unsort,
    CellShare,
    cell_pass,
    chunked_points,
    compact,
    monopole_coarse_levels,
    overflow_remainder,
)
from .tree import _mass_scale, build_octree

# The chunk width of the JAX package's per-cell stages, which rounds
# k_cells (effective_k_cells): audits replay the as-run k with it.
DEFAULT_K_CHUNK = 8192

FAR_MODES = ("auto", "gather", "window")


def _decode_ids(ids, side: int) -> torch.Tensor:
    """(K,) flat leaf ids -> (K, 3) coords; ids are clipped into range
    first, so sentinel rows decode to a valid (unread) cell."""
    ids = torch.clamp_max(ids, side**3 - 1)
    return torch.stack([ids // (side * side), (ids // side) % side,
                        ids % side], dim=-1)


def _build_sparse(positions, masses, depth: int, k_cells: int,
                  leaf_cap: int, quad: bool) -> dict:
    """The compaction: occupied ranks, the (k_cells, cap) slot layout,
    per-rank monopoles (and quadrupoles) and overflow remainders, the rank
    table, and the coarse octree levels 0..depth-1 (the dense leaf-level
    grids are what this build avoids)."""
    n = positions.shape[0]
    side = 1 << depth
    n_leaves = side**3
    # build_octree at depth-1 computes the same bounding cube.
    levels, origin, span, _ = build_octree(positions, masses, depth - 1,
                                           quad=quad)
    coords = grid_coords(positions, origin, span, side)
    ids = _flat(coords, side)
    sort_order = torch.argsort(ids, stable=True)
    sorted_ids = ids[sort_order]
    sorted_pos = positions[sort_order]
    sorted_mass = masses[sort_order]
    is_first = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    occ_rank = torch.cumsum(is_first, 0) - 1
    k_occ = occ_rank[-1] + 1

    # Occupied-leaf ids (ascending; sentinel n_leaves past k_occ) and the
    # rank table (-1 = empty; EVERY occupied leaf's rank, so that a
    # rank-overflow neighbour (rank >= k_cells) is told from empty space).
    first_at = torch.where(is_first & (occ_rank < k_cells), occ_rank, k_cells)
    occ_ids = torch.full((k_cells + 1,), n_leaves, dtype=sorted_ids.dtype,
                         device=positions.device)
    occ_ids[first_at] = sorted_ids
    table = torch.full((n_leaves + 1,), -1, dtype=torch.int32,
                       device=positions.device)
    table[torch.where(is_first, sorted_ids, n_leaves)] = \
        occ_rank.to(torch.int32)
    occ_coords = _decode_ids(occ_ids[:k_cells], side)

    # Slot layout: the rank within the leaf from the running first index.
    idx = torch.arange(n, device=positions.device)
    cell_start = torch.cummax(torch.where(is_first, idx, 0), 0).values
    rank_in_cell = idx - cell_start
    kept = (occ_rank < k_cells) & (rank_in_cell < leaf_cap)
    slot = torch.where(kept, occ_rank * leaf_cap + rank_in_cell,
                       k_cells * leaf_cap)
    cells_pos = _scatter_cells(sorted_pos, slot, k_cells, leaf_cap)
    cells_mass = _scatter_cells(sorted_mass, slot, k_cells, leaf_cap)

    # Per-rank monopoles over ALL of a leaf's bodies (beyond the cap too),
    # in normalised mass (m x overflows fp32 at astronomical scales).
    m_scale = _mass_scale(masses)
    m_hat = sorted_mass / m_scale
    # The bodies are in leaf order, so each sum is one chain a rank over
    # the sort above (the same bits on every run, as jax.ops.segment_sum's
    # element order on the CPU).
    seg = torch.where(occ_rank < k_cells, occ_rank, k_cells)
    m_mw = torch.cat([m_hat[:, None], m_hat[:, None] * sorted_pos], dim=1)
    occ_sums = sorted_segment_sum(m_mw, seg, k_cells + 1)[:k_cells]
    occ_mhat, occ_mw = occ_sums[:, 0], occ_sums[:, 1:]
    occ_com = occ_mw / torch.clamp_min(occ_mhat, 1e-37)[:, None]
    occ_qhat = None
    if quad:
        # Traceless quadrupole about the COM in m_scale h_leaf^2 units.
        h_leaf = span / side
        dvec = (sorted_pos - occ_com[torch.clamp_max(seg, k_cells - 1)]) \
            / h_leaf
        d2 = (dvec * dvec).sum(dim=1)
        dx, dy, dz = dvec[:, 0], dvec[:, 1], dvec[:, 2]
        q6 = torch.stack([
            m_hat * (3.0 * dx * dx - d2), m_hat * (3.0 * dy * dy - d2),
            m_hat * (3.0 * dz * dz - d2), m_hat * 3.0 * dx * dy,
            m_hat * 3.0 * dx * dz, m_hat * 3.0 * dy * dz,
        ], dim=1)
        occ_qhat = sorted_segment_sum(q6, seg, k_cells + 1)[:k_cells]
    # Per-RANK monopoles of every occupied leaf (n-sized: ranks past
    # k_cells are the rank-overflow leaves' source data).
    all_sums = sorted_segment_sum(m_mw, occ_rank, n)
    all_mhat = all_sums[:, 0]
    all_com = all_sums[:, 1:] / torch.clamp_min(all_mhat, 1e-37)[:, None]
    count = segment_sum(torch.ones_like(seg), seg, k_cells + 1)[:k_cells]
    over, rem_mhat, rem_com = overflow_remainder(
        cells_pos, cells_mass, count, occ_mhat, occ_mw, m_scale, leaf_cap)
    return dict(
        levels=levels, origin=origin, span=span, side=side,
        sort_order=sort_order, sorted_pos=sorted_pos,
        sorted_coords=coords[sort_order], occ_rank=occ_rank, k_occ=k_occ,
        kept=kept, rank_in_cell=rank_in_cell, occ_coords=occ_coords,
        table=table, cells_pos=cells_pos, cells_mass=cells_mass,
        occ_mhat=occ_mhat, occ_com=occ_com, occ_qhat=occ_qhat, over=over,
        rem_mhat=rem_mhat, rem_com=rem_com, m_scale=m_scale,
        all_mhat=all_mhat, all_com=all_com, k_cells=k_cells, cap=leaf_cap,
    )


class SparseSources:
    """The source side of the sparse layout, looked up by leaf coords
    through the rank table (ops/fmm.DenseSources' interface): occupied
    ranks below k_cells give their slots and monopoles, rank-overflow
    leaves their whole mass as a monopole, empty space nothing."""

    def __init__(self, b: dict):
        self.b = b
        self.side, self.k, self.cap = b["side"], b["k_cells"], b["cap"]
        self.n_ranks = b["all_mhat"].shape[0]
        self.m_scale = b["m_scale"]

    def ranks(self, cell):
        """Rank of each cell (-1 off the grid or empty)."""
        in_b = _in_grid(cell, self.side)
        sid = _flat(cell.clamp(0, self.side - 1), self.side)
        return torch.where(in_b, self.b["table"][sid].long(), -1)

    def monopoles(self, cell):
        """(mass, com, quad | None, mono_ok, quad_ok) of list cells: a
        slotted leaf's monopole and quadrupole; a rank-overflow leaf's
        monopole alone (the cap-overflow degradation class)."""
        b = self.b
        t = self.ranks(cell)
        tc = t.clamp(0, self.k - 1)
        tv = t.clamp(0, self.n_ranks - 1)
        slotted = (t >= 0) & (t < self.k)
        sm = torch.where(slotted, b["occ_mhat"][tc] * self.m_scale, 0.0)
        ok = slotted & (sm > 0)
        ov = t >= self.k
        mass = torch.where(ok, sm, torch.where(
            ov, b["all_mhat"][tv] * self.m_scale, 0.0))
        com = torch.where(ok[..., None], b["occ_com"][tc], b["all_com"][tv])
        sq = b["occ_qhat"][tc] if b["occ_qhat"] is not None else None
        return mass, com, sq, ok | ov, ok

    def blocks(self, cell):
        """(slot positions, slot masses, overflow flag, remainder, its COM,
        (rank-overflow flag, mass, COM)) of neighbour cells."""
        b = self.b
        t = self.ranks(cell)
        ok = (t >= 0) & (t < self.k)
        tc = t.clamp(0, self.k - 1)
        tv = t.clamp(0, self.n_ranks - 1)
        smass = torch.where(ok[:, None], b["cells_mass"][tc], 0.0)
        return (b["cells_pos"][tc], smass, ok & b["over"][tc],
                b["rem_mhat"][tc], b["rem_com"][tc],
                (t >= self.k, b["all_mhat"][tv], b["all_com"][tv]))


def _sparse_monopole_neighborhood(src: SparseSources, eval_pos, eval_coords,
                                  ws: int, g: float, eps: float, span):
    """The 7^3 neighbourhood of each eval point's leaf as monopoles at its
    OWN position, through the rank table (the JAX package's
    ``_sparse_monopole_neighborhood``): the near 27 softened to half a
    leaf, the list cells with the run's eps; the per-rank channels cover
    every occupied leaf, rank-overflow ones too."""
    lists, near, _ = _list_tables(ws, eval_pos.device)
    m = eval_pos.shape[0]
    offs = torch.cat([near.expand(m, -1, -1),
                      lists[_parity(eval_coords)]], dim=1)
    t = src.ranks(eval_coords[:, None, :] + offs)
    tc = t.clamp(0, src.n_ranks - 1)
    sm = torch.where(t >= 0, src.b["all_mhat"][tc] * src.m_scale, 0.0)
    eps_over = torch.clamp_min(0.5 * (span / src.side), eps)
    eps_here = torch.cat([eps_over.expand(near.shape[0]),
                          eps_over.new_full((lists.shape[1],), eps)])
    acc, _, _, _ = _point_monopoles(eval_pos, sm, src.b["all_com"][tc],
                                    sm > 0, eps_here, g)
    return acc


def resolve_far_mode(far_mode: str) -> str:
    """``far_mode="auto"`` -> "gather" (the JAX package takes "window" on
    a TPU only, which this package never runs on)."""
    if far_mode not in FAR_MODES:
        raise ValueError(f"far_mode {far_mode!r}: choose from {FAR_MODES}")
    return "gather" if far_mode == "auto" else far_mode


def effective_k_cells(k_cells: int, k_chunk: int = DEFAULT_K_CHUNK) -> int:
    """The k the solver runs with: ``k_cells`` rounded up to a k_chunk
    multiple, as the JAX package's equal chunks need. Audits compare
    occupancy against this k, not the nominal one."""
    return max(k_chunk, (k_cells + k_chunk - 1) // k_chunk * k_chunk)


def sharded_k_sizing(k_cells: int, world: int,
                     k_chunk: int = DEFAULT_K_CHUNK) -> tuple:
    """(k_eff, k_chunk_eff, chunks a rank) of the sparse FMM on a world of
    ``world`` ranks, the JAX package's rule (``make_sharded_sfmm_accel``):
    K made divisible by the world first, then chunked at most ``k_chunk``
    wide, and rounded up to whole chunks a rank, so that every rank gets
    an equal, contiguous, non-empty run of chunks."""
    k_base = max(world, (k_cells + world - 1) // world * world)
    k_chunk_eff = max(1, min(k_chunk, k_base // world))
    quantum = k_chunk_eff * world
    k_eff = (k_base + quantum - 1) // quantum * quantum
    return k_eff, k_chunk_eff, k_eff // k_chunk_eff // world


def sfmm_accelerations(positions: torch.Tensor, masses: torch.Tensor, *,
                       depth: int = 8, leaf_cap: int = 32,
                       k_cells: int = 65536, ws: int = 1, g: float = G,
                       cutoff: float = CUTOFF_RADIUS, eps: float = 0.0,
                       order: int = 2, quad: bool = True,
                       k_chunk: int = DEFAULT_K_CHUNK,
                       far_mode: str = "auto",
                       share: CellShare | None = None) -> torch.Tensor:
    """Sparse cell-list FMM accelerations for all N particles (targets =
    sources). ``k_cells`` is the occupied-leaf capacity (rounded by
    :func:`effective_k_cells`); occupancy beyond it degrades (module
    docstring). Accuracy contract and parameters otherwise those of
    ``ops/fmm.fmm_accelerations``; ``share`` is this rank's share of the
    cell pass on a mesh."""
    k_cells = effective_k_cells(k_cells, k_chunk)
    window = resolve_far_mode(far_mode) == "window"
    n = positions.shape[0]
    with record_function("sfmm.build"):
        b = _build_sparse(positions, masses, depth, k_cells, leaf_cap, quad)
        src = SparseSources(b)
        coarse = _CoarseGrids(b["levels"], depth, ws, b["span"], window)
        fallback = ~b["kept"]
        k_occ, n_fb = torch.stack([b["k_occ"], fallback.sum()]).tolist()
        n_cells = min(k_occ, k_cells)
        fb_idx = compact(fallback, torch.arange(n, device=positions.device),
                         n_fb)
        tcoords = b["occ_coords"][:n_cells]
    acc_cell, _, f, j6, a3, t10, _ = cell_pass(
        src, coarse, tcoords, b["cells_pos"][:n_cells], depth=depth, ws=ws,
        g=g, cutoff=cutoff, eps=eps, origin=b["origin"], span=b["span"],
        m_scale=b["m_scale"], order=order, potential=False, prefix="sfmm",
        share=share)
    with record_function("sfmm.eval"):
        side, span = b["side"], b["span"]
        rank_c = torch.clamp_max(b["occ_rank"], k_cells - 1)
        slot_c = torch.clamp_max(b["rank_in_cell"], leaf_cap - 1)
        near_sorted = acc_cell.reshape(-1, 3)[rank_c * leaf_cap + slot_c]
        dx = b["sorted_pos"] - _leaf_centers(tcoords, b["origin"], span,
                                             side, positions.dtype)[rank_c]
        acc_sorted = _eval_far(
            f[rank_c], j6[rank_c], a3[rank_c] if a3 is not None else None,
            t10[rank_c] if t10 is not None else None, dx, span / side,
            order) + near_sorted
    if n_fb:
        with record_function("sfmm.fallback"):
            def hierarchy(p, c):
                acc = _sparse_monopole_neighborhood(src, p, c, ws, g, eps,
                                                    span)
                acc_c, phi_c = monopole_coarse_levels(coarse, p, c, depth, g,
                                                      eps)
                return acc + acc_c, phi_c

            mono, _ = chunked_points(hierarchy, b["sorted_pos"][fb_idx],
                                     b["sorted_coords"][fb_idx], leaf_cap)
            acc_sorted = acc_sorted.index_copy(0, fb_idx, mono)
    return _unsort(acc_sorted, b["sort_order"])


# ---------------------------------------------------------------------------
# Sizing on the host (numpy, as in the JAX package)
# ---------------------------------------------------------------------------


def _host(positions) -> np.ndarray:
    """Positions as a host array in their own dtype (the JAX package bins
    ``np.asarray`` of its state: a float32 state in float32)."""
    if isinstance(positions, torch.Tensor):
        return to_numpy(positions)
    return np.asarray(positions)


def _host_cell_ids(pos: np.ndarray, depth: int) -> np.ndarray:
    """Host leaf ids on the bounding cube build_octree uses: the one
    binning of the sizing sweep and the post-run occupancy audit."""
    side = 1 << depth
    lo = pos.min(axis=0)
    hi = pos.max(axis=0)
    span = float((hi - lo).max()) * 1.0001 + 1e-30
    origin = 0.5 * (hi + lo) - 0.5 * span
    u = (pos - origin[None, :]) / span
    c = np.clip((u * side).astype(np.int64), 0, side - 1)
    return (c[:, 0] * side + c[:, 1]) * side + c[:, 2]


def recommended_sparse_params(positions, cap_max: int = 64,
                              max_depth: int = 9,
                              table_budget_bytes: int = 1 << 29,
                              min_depth: int = 4):
    """Joint (depth, cap) sizing from concrete positions: returns (depth,
    leaf_cap, k_cells, occupied). Admissible pairs keep the mass beyond the
    cap at most ~1% (the densest cells' remainder monopoles drive the
    error) with cap the p95 occupied load (powers of two in [4, cap_max]);
    among them the estimated cost 27 K cap^2 + 343 levels K is least. The
    int32 rank table bounds the depth (512^3 = 537 MB at depth 9)."""
    pos = _host(positions)
    n = pos.shape[0]
    best = None  # (cost, depth, cap, occ)
    deepest = None
    d_lo = max(1, min(min_depth, max_depth))
    # Caps are powers of two that never pass the caller's bound.
    cap_ceiling = 1 << (max(int(cap_max), 4).bit_length() - 1)
    for depth in range(d_lo, max_depth + 1):
        side = 1 << depth
        # The first depth always counts: a forced shallow depth or a tiny
        # table budget still yields a sizing.
        if depth > d_lo and side**3 * 4 > table_budget_bytes:
            break
        _, counts = np.unique(_host_cell_ids(pos, depth), return_counts=True)
        occ = len(counts)
        p95 = float(np.percentile(counts, 95))
        cap = 4
        while cap < min(cap_max, max(4, int(np.ceil(p95)))):
            cap *= 2
        cap = min(cap, cap_ceiling)
        over_frac = float(np.maximum(counts - cap, 0).sum()) / max(n, 1)
        deepest = (depth, cap, occ)
        if over_frac <= 0.01:
            cost = occ * (27 * cap * cap + 343 * max(1, depth - 2))
            if best is None or cost < best[0]:
                best = (cost, depth, cap, occ)
    if best is None:
        # No admissible pair in the budget: the deepest grid tried.
        depth, cap, occ = deepest
    else:
        _, depth, cap, occ = best
    k_cells = int(min((1 << depth) ** 3, 2 * occ))
    return depth, cap, max(1024, k_cells), occ


def resolve_sfmm_sizing(positions, tree_depth: int, tree_leaf_cap: int):
    """The one (depth, cap, k_cells) of a configured sparse FMM, shared by
    the Simulator and the debug-check audit. ``tree_depth`` 0 sizes depth
    and cap from the data; a nonzero depth is forced with
    ``tree_leaf_cap``, k_cells sized from the occupancy at that depth."""
    if tree_depth:
        _, _, k_cells, _ = recommended_sparse_params(
            positions, cap_max=tree_leaf_cap, min_depth=tree_depth,
            max_depth=tree_depth)
        return tree_depth, tree_leaf_cap, k_cells
    depth, cap, k_cells, _ = recommended_sparse_params(
        positions, cap_max=max(32, tree_leaf_cap))
    return depth, cap, k_cells


def sfmm_auto_decision(positions, tree_leaf_cap: int):
    """``fmm_mode="auto"``: (sparse, sizing). Sparse when the state
    occupies under 5% of its resolving grid's leaves, where the dense
    design's passes are almost all empty space; ``sizing`` is the
    :func:`recommended_sparse_params` tuple the decision was priced on."""
    sizing = recommended_sparse_params(positions,
                                       cap_max=max(32, tree_leaf_cap))
    depth, _, _, occ = sizing
    return occ < 0.05 * (1 << (3 * depth)), sizing


def final_occupancy_check(positions, sizing) -> dict:
    """The occupancy of ``positions`` at an as-run sizing (depth, cap,
    effective k_cells[, k_chunk]): occupancy past k_cells means
    rank-overflow leaves degraded to the monopole fallback during the
    run."""
    depth, cap, k_cells = sizing[:3]
    occ = int(len(np.unique(_host_cell_ids(_host(positions), depth))))
    return {"depth": depth, "cap": cap, "k_cells": int(k_cells),
            "occupied": occ, "overflow": occ > k_cells}
