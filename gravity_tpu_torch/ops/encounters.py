"""Close-encounter detection and particle merging.

Counterpart of ``gravity_tpu/ops/encounters.py``. Close pairs are
detected and optionally merged (inelastic: mass and momentum conserved,
the donor becomes a massless tracer at the merged body's phase-space
point, kinetic energy not conserved). Candidates come from a chunked
running top-k that never forms the (N, N) matrix
(:func:`closest_pairs`), or, at large N, from each body's nearest
neighbour on a cell grid (:func:`nearest_within_radius_grid`); one
greedy pass merges each body at most once (:func:`_greedy_merge`).
Zero-mass bodies take no part.

The greedy pass is a loop over the k candidates of device ops
(``torch.where``), with no host read: the caller reads ``n_merged`` once
a check. ``box`` > 0 (periodic runs) detects and merges with
minimum-image separations, so a pair across a face merges at the face and
its merged body is wrapped back into the box.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..interop import to_numpy
from ..state import ParticleState
from .cells import build_padded_cells_indexed, grid_coords
from .forces import rounded, tiny
from .nlist import _offsets


def _min_image(diff: torch.Tensor, box: float) -> torch.Tensor:
    """Per-axis separations wrapped into [-box/2, box/2) (``jnp.mod`` is
    ``torch.remainder``: the result takes the divisor's sign)."""
    b = rounded(box, diff.dtype)
    return torch.remainder(diff + 0.5 * b, b) - 0.5 * b


def closest_pairs(
    positions: torch.Tensor,
    masses: torch.Tensor,
    *,
    k: int = 16,
    chunk: int = 1024,
    box: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The k globally closest (distance, i, j) pairs, ascending, each
    unordered pair once (j > i), zero-mass bodies ignored. Slots beyond
    the valid pairs hold inf / -1. O(N * chunk) memory: a running top-k
    over i-chunks. ``box`` > 0 takes minimum-image distances."""
    n = positions.shape[0]
    dtype, device = positions.dtype, positions.device
    mask = masses > 0
    chunk = max(1, min(chunk, n))
    cols = torch.arange(n, device=device)
    best_r2 = torch.full((k,), math.inf, dtype=dtype, device=device)
    best_i = torch.full((k,), -1, dtype=torch.int64, device=device)
    best_j = torch.full((k,), -1, dtype=torch.int64, device=device)
    for i0 in range(0, n, chunk):
        pos_i = positions[i0:i0 + chunk]
        rows = torch.arange(i0, i0 + pos_i.shape[0], device=device)
        diff = positions[None, :, :] - pos_i[:, None, :]
        if box > 0.0:
            diff = _min_image(diff, box)
        r2 = (diff * diff).sum(dim=-1)  # (chunk, n)
        keep = ((cols[None, :] > rows[:, None]) & mask[i0:i0 + chunk, None]
                & mask[None, :])
        r2 = torch.where(keep, r2, torch.full_like(r2, math.inf))
        # Merge this chunk's pairs into the running top-k (smallest r2).
        neg = torch.cat([-best_r2, -r2.reshape(-1)])
        cand_i = torch.cat([best_i, rows[:, None].expand(r2.shape)
                            .reshape(-1)])
        cand_j = torch.cat([best_j, cols[None, :].expand(r2.shape)
                            .reshape(-1)])
        top, sel = torch.topk(neg, k)
        best_r2, best_i, best_j = -top, cand_i[sel], cand_j[sel]
    valid = torch.isfinite(best_r2)
    return (torch.sqrt(best_r2), torch.where(valid, best_i, -1),
            torch.where(valid, best_j, -1))


def min_separation(positions, masses, *, chunk: int = 1024,
                   box: float = 0.0):
    """Smallest distance between any two massive particles."""
    d, _, _ = closest_pairs(positions, masses, k=1, chunk=chunk, box=box)
    return d[0]


class MergeResult(NamedTuple):
    state: ParticleState
    n_merged: torch.Tensor  # merges applied this pass (device int64)


# Max side^3 * cap slots of the merge grid: the planner coarsens the grid,
# then falls back to the brute pass, rather than exceed it.
_SLOT_LIMIT = 1 << 24


def merge_scan_chunk(n: int) -> int:
    """Chunk of the exact O(N^2) merge scan: (chunk, N) distance buffers
    of at most ~2^24 elements."""
    return max(1, min(1024, (1 << 24) // max(n, 1)))


def _greedy_merge(state: ParticleState, dists, is_, js,
                  radius: float, box: float = 0.0) -> MergeResult:
    """Greedy at-most-one-merge-per-body pass over candidate pairs in
    the given (ascending-distance) order; a duplicate such as (j, i)
    after (i, j) is blocked by the used flags. Shared by the brute and
    grid detections. Each candidate updates rows i and j through
    ``torch.where`` on the device. ``box`` > 0 places the merged body at
    the centre of i and the minimum image of j, wrapped into the box."""
    dtype = state.dtype
    i_safe = torch.clamp_min(is_, 0)
    j_safe = torch.clamp_min(js, 0)
    ok_pair = (torch.isfinite(dists) & (dists < rounded(radius, dtype))
               & (is_ >= 0) & (js >= 0))
    pos, vel, m = state.positions, state.velocities, state.masses
    used = torch.zeros(state.n, dtype=torch.bool, device=state.device)
    count = torch.zeros((), dtype=torch.int64, device=state.device)
    floor = tiny(dtype)
    for t in range(dists.shape[0]):
        i, j = i_safe[t:t + 1], j_safe[t:t + 1]
        ok = ok_pair[t] & ~used[i][0] & ~used[j][0]
        mi, mj = m[i], m[j]
        # Candidates have mass > 0 when detected, and a slot zeroed
        # earlier in this pass is marked used, so a 0 / 0 only arises
        # where ok is false.
        mt = torch.clamp_min(mi + mj, floor)
        # Mass fractions, not m x: the JAX package's (mi x_i + mj x_j) /
        # mt overflows fp32 at SI scales (m ~ 4e27 kg times x ~ 1e13 m).
        wi, wj = (mi / mt)[:, None], (mj / mt)[:, None]
        if box > 0.0:
            xj_eff = pos[i] + _min_image(pos[j] - pos[i], box)
            new_pos = torch.remainder(wi * pos[i] + wj * xj_eff,
                                      rounded(box, dtype))
        else:
            new_pos = wi * pos[i] + wj * pos[j]
        new_vel = wi * vel[i] + wj * vel[j]
        pos = pos.index_copy(0, i, torch.where(ok, new_pos, pos[i]))
        pos = pos.index_copy(0, j, torch.where(ok, new_pos, pos[j]))
        vel = vel.index_copy(0, i, torch.where(ok, new_vel, vel[i]))
        vel = vel.index_copy(0, j, torch.where(ok, new_vel, vel[j]))
        m = m.index_copy(0, i, torch.where(ok, mi + mj, mi))
        m = m.index_copy(0, j, torch.where(ok, torch.zeros_like(mj), m[j]))
        used = used.index_copy(0, i, used[i] | ok)
        used = used.index_copy(0, j, used[j] | ok)
        count = count + ok.to(torch.int64)
    return MergeResult(
        state.replace(positions=pos, velocities=vel, masses=m), count)


def merge_close_pairs(state: ParticleState, radius: float, *, k: int = 16,
                      chunk: int = 1024, box: float = 0.0) -> MergeResult:
    """One merge pass: greedily merge pairs with r < radius, from the k
    closest pairs in ascending distance, each body at most once (a pass
    with ``n_merged == 0`` is a fixed point). The merged body (lower
    index) carries the total mass, the mass-weighted centre and the
    momentum-conserving velocity; the donor (higher index) becomes a
    massless tracer at the same point. ``box`` > 0 detects and merges
    with minimum-image separations. Exact at any radius, O(N^2):
    :func:`merge_close_pairs_grid` is O(N) at small radii."""
    dists, is_, js = closest_pairs(state.positions, state.masses, k=k,
                                   chunk=chunk, box=box)
    return _greedy_merge(state, dists, is_, js, radius, box)


def nearest_within_radius_grid(
    positions: torch.Tensor,
    masses: torch.Tensor,
    radius: float,
    *,
    side: int,
    cap: int,
    chunk: int = 2048,
    box: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each massive body's nearest massive neighbour within ``radius``,
    on a side^3 cell grid whose cells are at least ``radius`` wide, so
    the 27-neighbourhood holds every in-radius pair.

    Returns ``(d (N,), j (N,), n_dropped ())``: distance and index of the
    nearest in-radius neighbour (inf / -1 when none), and the count of
    massive bodies that overflowed their cell's ``cap`` slots and were
    dropped from the source side (a device scalar; the caller retries
    with a larger cap when it is nonzero). ``box`` > 0 wraps both the grid
    and the separations (minimum image)."""
    n = positions.shape[0]
    dtype, device = positions.dtype, positions.device
    valid = masses > 0
    n_cells = side**3
    if box > 0.0:
        origin = torch.zeros(3, dtype=dtype, device=device)
        span = torch.tensor(box, dtype=dtype, device=device)
        positions = torch.remainder(positions, span)
    else:
        big = torch.full_like(positions, math.inf)
        origin = torch.where(valid[:, None], positions, big).amin(dim=0)
        pmax = torch.where(valid[:, None], positions, -big).amax(dim=0)
        span = torch.clamp_min((pmax - origin).max(), tiny(dtype))
    coords = grid_coords(positions, origin, span, side)
    cell_id = (coords[:, 0] * side + coords[:, 1]) * side + coords[:, 2]
    # Massless bodies are left out of the source structure entirely.
    cell_id = torch.where(valid, cell_id, n_cells)
    order = torch.argsort(cell_id, stable=True)
    s_id = cell_id[order]
    cell_start = torch.searchsorted(
        s_id, torch.arange(n_cells + 1, device=device))
    cells_pos, cells_mass, cells_idx, n_dropped = build_padded_cells_indexed(
        positions[order], masses[order], order, s_id, cell_start, n_cells,
        cap,
    )
    offs = _offsets(device)
    r2_max = rounded(rounded(radius, dtype) ** 2, dtype)
    idx = torch.arange(n, device=device)
    d_out, j_out = [], []
    for lo in range(0, n, chunk):
        pos_c, coord_c, idx_c = (positions[lo:lo + chunk],
                                 coords[lo:lo + chunk], idx[lo:lo + chunk])
        nbr = coord_c[:, None, :] + offs[None, :, :]  # (C, 27, 3)
        if box > 0.0:
            nbr = torch.remainder(nbr, side)
            ok_cell = torch.ones(nbr.shape[:2], dtype=torch.bool,
                                 device=device)
        else:
            ok_cell = ((nbr >= 0) & (nbr < side)).all(dim=-1)
            nbr = nbr.clamp(0, side - 1)
        nbr_id = (nbr[..., 0] * side + nbr[..., 1]) * side + nbr[..., 2]
        diff = cells_pos[nbr_id] - pos_c[:, None, None, :]  # (C, 27, cap, 3)
        if box > 0.0:
            diff = _min_image(diff, box)
        r2 = (diff * diff).sum(dim=-1)
        nidx = cells_idx[nbr_id]
        ok = (ok_cell[..., None] & (cells_mass[nbr_id] > 0)
              & (nidx != idx_c[:, None, None]) & (r2 < r2_max))
        r2 = torch.where(ok, r2, torch.full_like(r2, math.inf))
        r2f = r2.reshape(r2.shape[0], 27 * cap)
        nidxf = nidx.reshape(r2.shape[0], 27 * cap)
        a = torch.argmin(r2f, dim=1, keepdim=True)
        best_r2 = r2f.gather(1, a)[:, 0]
        best_j = nidxf.gather(1, a)[:, 0]
        d_out.append(torch.sqrt(best_r2))
        j_out.append(torch.where(torch.isfinite(best_r2), best_j, -1))
    d = torch.where(valid, torch.cat(d_out), math.inf)
    j = torch.where(valid, torch.cat(j_out), -1)
    return d, j, n_dropped


def _merge_pass_grid(state, radius, *, k, side, cap, chunk, box=0.0):
    d, j, n_dropped = nearest_within_radius_grid(
        state.positions, state.masses, radius, side=side, cap=cap,
        chunk=chunk, box=box,
    )
    # A mutual nearest pair appears as (i, j) and (j, i): drop the
    # higher-index orientation so that each pair takes one top-k slot.
    i_arr = torch.arange(d.shape[0], device=d.device)
    mutual = (j >= 0) & (j[j.clamp_min(0)] == i_arr)
    d = torch.where(mutual & (j < i_arr), math.inf, d)
    neg_top, sel = torch.topk(-d, min(k, d.shape[0]))
    dists = -neg_top
    found = torch.isfinite(dists)
    is_ = torch.where(found, sel, -1)
    js = torch.where(found, j[sel], -1)
    # (lo, hi): the lower index survives, as in merge_close_pairs.
    lo, hi = torch.minimum(is_, js), torch.maximum(is_, js)
    is_ = torch.where(found, lo, -1)
    js = torch.where(found, hi, -1)
    return _greedy_merge(state, dists, is_, js, radius, box), n_dropped


def merge_close_pairs_grid(
    state: ParticleState,
    radius: float,
    *,
    k: int = 16,
    chunk: int = 2048,
    box: float = 0.0,
    max_side: int = 64,
    cap_limit: int = 2048,
) -> MergeResult:
    """One merge pass with cell-grid candidates, O(N) where
    :func:`merge_close_pairs` is O(N^2): each body's nearest in-radius
    neighbour, the same at-most-once contract and lower-index survivor.
    The host plans the grid from the positions (the largest power-of-two
    side with cells >= radius, at most ``max_side``, coarsened while
    side^3 * cap exceeds the slot limit) and the cap (from the measured
    occupancy, doubled on overflow), and falls back to the exact brute
    pass when the grid degenerates. ``box`` > 0 plans the grid over the
    box and wraps the separations (minimum image)."""

    def brute():
        return merge_close_pairs(state, radius, k=k,
                                 chunk=merge_scan_chunk(state.n), box=box)

    pos = to_numpy(state.positions).astype(np.float64)
    m = to_numpy(state.masses).astype(np.float64)
    valid = m > 0
    if not valid.any():
        return MergeResult(state, torch.zeros((), dtype=torch.int64,
                                              device=state.device))
    if box > 0.0:
        origin = np.zeros(3)
        span = float(box)
        pos = np.mod(pos, span)
    else:
        origin = pos[valid].min(axis=0)
        span = max(float((pos[valid].max(axis=0) - origin).max()), 1e-300)
    side = 1
    while side * 2 <= max_side and span / (side * 2) >= radius:
        side *= 2

    def cap_for(side_):
        coords = np.clip(
            ((pos[valid] - origin) / span * side_).astype(np.int64),
            0, side_ - 1,
        )
        ids = (coords[:, 0] * side_ + coords[:, 1]) * side_ + coords[:, 2]
        occupancy = int(np.bincount(ids).max())
        cap_ = 8
        while cap_ < occupancy + 4:
            cap_ *= 2
        return cap_

    cap = cap_for(side)
    while side > 4 and side**3 * cap > _SLOT_LIMIT:
        side //= 2
        cap = cap_for(side)
    if side < 4 or cap > cap_limit or side**3 * cap > _SLOT_LIMIT:
        return brute()
    while True:
        chunk_eff = max(64, min(chunk, (1 << 22) // (27 * cap)))
        res, n_dropped = _merge_pass_grid(state, radius, k=k, side=side,
                                          cap=cap, chunk=chunk_eff, box=box)
        if int(n_dropped) == 0:
            return res
        # The numpy plan and the device binning rounded differently and
        # a cell overflowed: retry with more room.
        cap *= 2
        if cap > cap_limit or side**3 * cap > _SLOT_LIMIT:
            return brute()
