"""Cell-grid binning shared by the cell-list solvers.

Counterpart of ``gravity_tpu/ops/cells.py`` (the parts the cell-list
force backend, the P3M solver and the merge grid use). Points are binned
into a cube grid over the source bounding cube
(``ops/pm.py::bounding_cube``, re-exported here) and padded into a dense
``(side^3, cap)`` slot layout.

Index tensors are int64 (the JAX package's are int32); their values are
the same. The sort within a cell is stable, as ``jnp.argsort`` is, so the
same bodies take a cell's slots and the same ones overflow.
"""

from __future__ import annotations

import numpy as np
import torch

from .pm import bounding_cube

__all__ = [
    "bin_to_cells",
    "bounding_cube",
    "build_padded_cells",
    "build_padded_cells_indexed",
    "cell_ids",
    "grid_coords",
    "map_target_chunks",
    "segment_sum",
]


def _near_offsets(ws: int) -> np.ndarray:
    """The (2ws+1)^3 near-neighborhood stencil (Chebyshev radius ws),
    row-major over (dx, dy, dz) in [-ws, ws].

    The order is a contract: the cell-list kernel (csrc/nlist_pair.cu)
    decodes a flat offset index o back to (o // 9 - 1, (o // 3) % 3 - 1,
    o % 3 - 1) with the same row-major arithmetic."""
    rng = range(-ws, ws + 1)
    return np.array(
        [(dx, dy, dz) for dx in rng for dy in rng for dz in rng],
        dtype=np.int32,
    )


def grid_coords(points, origin, span, side: int) -> torch.Tensor:
    """Integer cell coords of ``points`` on a side^3 grid over the cube
    (origin, span), clipped to the grid (coincident-with-boundary and
    out-of-cube points land in edge cells)."""
    u = (points - origin[None, :]) / span
    return torch.clamp((u * side).to(torch.int64), 0, side - 1)


def cell_ids(coords: torch.Tensor, side: int) -> torch.Tensor:
    return (coords[:, 0] * side + coords[:, 1]) * side + coords[:, 2]


def segment_sum(values: torch.Tensor, ids: torch.Tensor,
                n: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of ``values`` summed by ``ids``. On
    CUDA the float sums use atomics, so their last bits vary from run to
    run."""
    out = torch.zeros((n, *values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, ids, values)


def _cell_slots(sorted_cell_ids, cell_start, n_cells: int, cap: int):
    """Scatter slots for dense per-cell blocks: slot = cell * cap +
    rank-within-cell. Ranks >= cap and ids >= n_cells park on the trash
    row. Returns (slot, kept)."""
    n = sorted_cell_ids.shape[0]
    idx = torch.arange(n, device=sorted_cell_ids.device)
    rank = idx - cell_start[sorted_cell_ids]
    kept = (sorted_cell_ids < n_cells) & (rank < cap)
    slot = torch.where(kept, sorted_cell_ids * cap + rank,
                       torch.full_like(rank, n_cells * cap))
    return slot, kept


def _scatter_cells(values, slot, n_cells: int, cap: int, fill=0):
    """One O(N) scatter of ``values`` into (n_cells, cap[, ...]) blocks;
    the trash row is dropped."""
    tail = values.shape[1:]
    out = torch.full((n_cells * cap + 1, *tail), fill, dtype=values.dtype,
                     device=values.device)
    out[slot] = values
    return out[: n_cells * cap].reshape(n_cells, cap, *tail)


def bin_to_cells(points, weights, coords, side: int, cap: int):
    """Sort ``points`` by cell and pad them into the (side^3, cap)
    cell-slot layout.

    Returns (cells_pos, cells_w, count, start, sort_order, sorted_ids)."""
    ids = cell_ids(coords, side)
    sort_order = torch.argsort(ids, stable=True)
    sorted_ids = ids[sort_order]
    n_cells = side**3
    count = segment_sum(torch.ones_like(ids), ids, n_cells)
    start = torch.cumsum(count, 0) - count
    cells_pos, cells_w = build_padded_cells(
        points[sort_order], weights[sort_order], sorted_ids, start,
        n_cells, cap,
    )
    return cells_pos, cells_w, count, start, sort_order, sorted_ids


def build_padded_cells(sorted_pos, sorted_mass, sorted_cell_ids,
                       cell_start, n_cells: int, cap: int):
    """Dense per-cell blocks from cell-sorted particle arrays: slot k of
    cell c holds the k-th particle of that cell, zero mass and zero
    position beyond the cell's count (zero mass is an exact no-op for
    every pair kernel)."""
    slot, _ = _cell_slots(sorted_cell_ids, cell_start, n_cells, cap)
    cells_pos = _scatter_cells(sorted_pos, slot, n_cells, cap)
    cells_mass = _scatter_cells(sorted_mass, slot, n_cells, cap)
    return cells_pos, cells_mass


def build_padded_cells_indexed(sorted_pos, sorted_mass, sorted_idx,
                               sorted_cell_ids, cell_start, n_cells: int,
                               cap: int):
    """:func:`build_padded_cells` plus a per-slot global-index block (fill
    -1) and the count of in-grid bodies that overflowed their cell's cap
    (a device scalar). Ids >= n_cells exclude a body from the structure;
    ``cell_start`` then has n_cells + 1 entries."""
    slot, kept = _cell_slots(sorted_cell_ids, cell_start, n_cells, cap)
    cells_pos = _scatter_cells(sorted_pos, slot, n_cells, cap)
    cells_mass = _scatter_cells(sorted_mass, slot, n_cells, cap)
    cells_idx = _scatter_cells(sorted_idx, slot, n_cells, cap, fill=-1)
    n_dropped = ((sorted_cell_ids < n_cells) & ~kept).sum()
    return cells_pos, cells_mass, cells_idx, n_dropped


def map_target_chunks(fn, targets, t_coords, chunk: int) -> torch.Tensor:
    """Apply ``fn(pos_chunk (C, 3), coord_chunk (C, 3)) -> (C, 3)`` over
    the targets in chunks of ``chunk`` rows and concatenate. The tail
    chunk is padded with zero rows, computed and dropped, so every call
    sees the same shape; the targets are never taken as one whole-N chunk
    (that would materialise (N, 27 * cap, 3) temporaries at the sizes the
    fast solvers serve)."""
    n = targets.shape[0]
    chunk = max(1, min(chunk, n))
    n_padded = -(-n // chunk) * chunk
    pad = n_padded - n
    if pad:
        targets = torch.cat([targets, targets.new_zeros((pad, 3))])
        t_coords = torch.cat([t_coords, t_coords.new_zeros((pad, 3))])
    out = [fn(targets[lo:lo + chunk], t_coords[lo:lo + chunk])
           for lo in range(0, n_padded, chunk)]
    return torch.cat(out)[:n]
