"""Cell-grid binning shared by the cell-list solvers.

Counterpart of ``gravity_tpu/ops/cells.py`` (the parts the cell-list
force backend, the P3M solver and the merge grid use). Points are binned
into a cube grid over the source bounding cube
(``ops/pm.py::bounding_cube``, re-exported here) and padded into a dense
``(side^3, cap)`` slot layout. A batch of B independent systems (the
serve engine's slots) bins through one sort of ids flattened over the
batch (:func:`bin_to_cells_batched`), each slot over its own cube.

Index tensors are int64 (the JAX package's are int32); their values are
the same. The sort within a cell is stable, as ``jnp.argsort`` is, so the
same bodies take a cell's slots and the same ones overflow.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch.profiler import record_function

from . import cuda_build
from .pm import bounding_cube

__all__ = [
    "bin_ids_to_cells",
    "bin_to_cells",
    "bin_to_cells_batched",
    "bounding_cube",
    "build_padded_cells",
    "build_padded_cells_indexed",
    "cell_ids",
    "grid_coords",
    "is_tiny",
    "map_target_chunks",
    "Segments",
    "segment_sum",
    "segment_sum_bf16",
    "segment_sum_bf16_plain",
    "segment_sum_rows",
    "slot_cell_ids",
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
    out-of-cube points land in edge cells). A batch, points (B, n, 3)
    over origin (B, 3) and span (B,), takes each slot's own cube."""
    u = (points - origin[..., None, :]) / span[..., None, None]
    return torch.clamp((u * side).to(torch.int64), 0, side - 1)


def cell_ids(coords: torch.Tensor, side: int) -> torch.Tensor:
    return (coords[:, 0] * side + coords[:, 1]) * side + coords[:, 2]


def segment_sum(values: torch.Tensor, ids: torch.Tensor,
                n: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of ``values`` summed by ``ids``. The
    fp32 and fp64 sums (and integer counts) are ``index_add_``, on CUDA
    with atomics, so their last bits vary from run to run; a bf16 sum goes
    through :func:`segment_sum_bf16`, which uses none and gives the same
    bits on every run."""
    if values.dtype == torch.bfloat16:
        return segment_sum_bf16(values, ids, n)
    out = torch.zeros((n, *values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, ids, values)


# A bf16 row is tiny when it is nonzero and its biased exponent is below
# 8: |x| < 2^-119, a magnitude's bits below 0x0400. Only a segment with a
# tiny row can differ under the JAX package's flush (csrc/segment_sum.cu).
_TINY_BITS = 0x0400
_LEAST_NORMAL = 2.0**-126


def is_tiny(values: torch.Tensor) -> torch.Tensor:
    """Where bf16 ``values`` are tiny: nonzero and below 2^-119."""
    magnitude = values.view(torch.int16).to(torch.int32) & 0x7FFF
    return (magnitude != 0) & (magnitude < _TINY_BITS)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal values read as zero of their sign, as XLA's CPU sums
    read them."""
    return torch.where(x.abs() < _LEAST_NORMAL, x * 0, x)


def _flushed_add(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """bf16 ``acc + x`` under the flush: the fp32 sum of the flushed
    ``x``, flushed, rounded to bf16 (``acc`` is never subnormal)."""
    return _flush(acc.float() + _flush(x.float())).to(acc.dtype)


def _flushed_chain(col: torch.Tensor) -> torch.Tensor:
    """The element-order bf16 sum of the 1-D ``col`` under the flush: each
    input and each fp32 sum flushed, then rounded to bf16. Adds one at a
    time at a tiny row and while the total is tiny; between them
    ``index_add_`` takes the stretch, whose flushed and unflushed bits are
    the same (the argument of csrc/segment_sum.cu)."""
    acc = col.new_zeros(1)
    n = col.shape[0]
    i = 0
    for stop in torch.nonzero(is_tiny(col)).flatten().tolist() + [n]:
        while i < stop:
            if bool(is_tiny(acc)):
                acc = _flushed_add(acc, col[i:i + 1])
                i += 1
            else:
                acc.index_add_(0, acc.new_zeros(stop - i, dtype=torch.int64),
                               col[i:stop])
                i = stop
        if i < n:
            acc = _flushed_add(acc, col[i:i + 1])
            i += 1
    return acc[0]


def _flush_tiny_segments(out: torch.Tensor, values: torch.Tensor,
                         ids: torch.Tensor) -> torch.Tensor:
    """``out`` (n,), the ``index_add_`` sums of the 1-D ``values`` by
    ``ids``, with each segment that holds a tiny row summed again under
    the flush."""
    tiny = is_tiny(values)
    if bool(tiny.any()):
        for s in torch.unique(ids[tiny]).tolist():
            out[s] = _flushed_chain(values[ids == s])
    return out


def segment_sum_bf16_plain(values: torch.Tensor, ids: torch.Tensor,
                           n: int) -> torch.Tensor:
    """The bf16 segment sum of the JAX package's scatter-add on the CPU:
    rounded to bf16 after every add, in element order, so a segment of
    ones stalls at 256 (256 + 1 rounds back to 256) and a cell total of
    more bodies comes out short in both packages; a subnormal input, and
    a sum below 2^-126 before it is rounded, read as zero of its sign, as
    XLA's CPU sums flush them. torch's ``index_add_`` on the CPU adds a
    1-D source in element order but the rows of a 2-D one in another, so
    the sum is taken column by column; a segment with a tiny row is summed
    again under the flush. The plain version of :func:`segment_sum_bf16`'s
    kernel."""
    if values.dim() > 1:
        cols = values.reshape(values.shape[0], -1).unbind(1)
        out = torch.stack([segment_sum_bf16_plain(c.contiguous(), ids, n)
                           for c in cols], dim=1)
        return out.reshape(n, *values.shape[1:])
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    return _flush_tiny_segments(out.index_add_(0, ids, values), values, ids)


# Kernel launches of segment_sum_rows so far (only where it launches).
LAUNCHES = 0
LIBRARY = cuda_build.CudaLibrary("segment_sum", {
    "segment_sum_bf16": ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                          ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
                         ctypes.c_int),
})
_MAX_COLS = 8
# The kernel reads a column in 16-byte chunks of 8 rows.
_CHUNK_ROWS = 8
# Rows a flag byte of the kernel's tiny-row pass covers (kFlagRows).
_FLAG_ROWS = 256


class Segments:
    """Sums over one id vector: ``jax.ops.segment_sum(v, ids, n)`` of each
    of several values, which may share one plan and one launch.

    ``sum(*values)`` returns one total a value. fp32 and fp64 values take
    :func:`segment_sum` (``index_add_``) one by one. bf16 values on the CPU
    take :func:`segment_sum_bf16_plain`; on CUDA their columns (at most 8
    in all) are summed by one launch of ``csrc/segment_sum.cu``
    (:func:`segment_sum_rows`) over the plan of these ids (:meth:`plan`),
    which is made at the first such sum and kept for the next: an octree
    level sums its masses and weighted positions in one launch and its
    quadrupoles, which need the centres of mass, in a second on the same
    plan."""

    def __init__(self, ids: torch.Tensor, n: int):
        self.ids = ids
        self.n = n
        self._plan = None

    def plan(self):
        """(order, starts): a stable sort of the ids (element order inside
        a segment), padded with row 0 to a multiple of 8 rows, and each
        segment's first row in that order, ``starts[n]`` the number of
        rows with an id below n. No atomics: the starts are a binary
        search of the sorted ids."""
        if self._plan is None:
            with record_function("segment_sum.plan"):
                ids, n = self.ids, self.n
                key = ids.to(torch.int32) if n < 2**31 else ids
                sorted_ids, order = torch.sort(key, stable=True)
                starts = torch.searchsorted(
                    sorted_ids, torch.arange(n + 1, dtype=key.dtype,
                                             device=ids.device))
                pad = -ids.shape[0] % _CHUNK_ROWS
                if pad:
                    order = torch.cat([order, order.new_zeros(pad)])
                self._plan = (order, starts)
        return self._plan

    def gather(self, *values) -> torch.Tensor:
        """The values' columns in the plan's order, column-major: (cols,
        rows padded to a multiple of 8), each column contiguous."""
        order, _ = self.plan()
        flat = [v.reshape(v.shape[0], math.prod(v.shape[1:])) for v in values]
        rows = torch.empty((sum(f.shape[1] for f in flat), order.shape[0]),
                           dtype=values[0].dtype, device=values[0].device)
        c = 0
        for f in flat:
            torch.index_select(f.t(), 1, order, out=rows[c:c + f.shape[1]])
            c += f.shape[1]
        return rows

    def sum(self, *values) -> list:
        if not values:
            return []
        if any(v.dtype != torch.bfloat16 for v in values):
            return [segment_sum(v, self.ids, self.n) for v in values]
        n_rows = self.ids.shape[0]
        widths = [math.prod(v.shape[1:]) for v in values]
        if any(v.dim() < 1 or v.shape[0] != n_rows for v in values) \
                or self.ids.dim() != 1 or not 1 <= sum(widths) <= _MAX_COLS:
            raise ValueError(
                f"values {[tuple(v.shape) for v in values]} and ids "
                f"{tuple(self.ids.shape)}: one id a row, at most "
                f"{_MAX_COLS} values a row in all")
        devices = {v.device for v in values} | {self.ids.device}
        if devices == {torch.device("cpu")}:
            return [segment_sum_bf16_plain(v, self.ids, self.n)
                    for v in values]
        if len(devices) != 1 or values[0].device.type != "cuda":
            raise ValueError("the CUDA kernel needs values and ids on one "
                             f"CUDA device, got {sorted(map(str, devices))}")
        if self.ids.dtype != torch.int64:
            raise TypeError(f"the CUDA kernel takes int64 ids, not "
                            f"{self.ids.dtype}")
        if n_rows == 0:
            return [values[0].new_zeros((self.n, *v.shape[1:]))
                    for v in values]
        with record_function("segment_sum.sum"):
            out = segment_sum_rows(self.gather(*values), self.plan()[1],
                                   n_rows)
        return [o.reshape(self.n, *v.shape[1:]) for o, v in
                zip(out.split(widths, dim=1), values)]


def segment_sum_rows(rows: torch.Tensor, starts: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """The wrapper of ``csrc/segment_sum.cu``: bf16 ``rows`` (cols, stride),
    column-major in segment order (:meth:`Segments.gather`), summed over
    the segments that ``starts`` (n + 1,) bounds, into (n, cols), each
    column one chain of bf16 adds in row order. CPU tensors take the plain
    version (``index_add_`` column by column over the rows in this order,
    which is element order inside a segment, with the flush); CUDA
    tensors launch the
    kernel on the current stream, without synchronising, or raise."""
    global LAUNCHES
    cols, stride = rows.shape
    n = starts.shape[0] - 1
    if rows.dtype != torch.bfloat16 or starts.dtype != torch.int64:
        raise TypeError(f"the kernel takes bfloat16 rows and int64 starts, "
                        f"not {rows.dtype} and {starts.dtype}")
    if not 1 <= cols <= _MAX_COLS or stride % _CHUNK_ROWS \
            or not 0 <= n_rows <= stride or n < 0:
        raise ValueError(f"rows {tuple(rows.shape)}, {n_rows} of them "
                         f"real: at most {_MAX_COLS} columns of a multiple "
                         f"of {_CHUNK_ROWS} rows")
    if rows.device.type == "cpu" and starts.device.type == "cpu":
        lo, hi = int(starts[0]), int(starts[-1])
        seg = torch.repeat_interleave(torch.arange(n), starts.diff())
        return torch.stack([_flush_tiny_segments(
            torch.zeros(n, dtype=rows.dtype).index_add_(0, seg, col[lo:hi]),
            col[lo:hi], seg) for col in rows], dim=1)
    if rows.device.type != "cuda" or starts.device != rows.device:
        raise ValueError("the CUDA kernel needs rows and starts on one CUDA "
                         f"device, got {rows.device} and {starts.device}")
    if not rows.is_contiguous() or not starts.is_contiguous():
        raise ValueError("the CUDA kernel takes contiguous rows and starts")
    out = torch.empty((n, cols), dtype=rows.dtype, device=rows.device)
    if n == 0:
        return out
    # the kernel's tiny-row flags: a byte a block of rows, the column's
    # bytes padded to a multiple of 16
    flags = torch.empty(cols * -(-n_rows // (16 * _FLAG_ROWS)) * 16,
                        dtype=torch.uint8, device=rows.device)
    lib = LIBRARY.load()
    with torch.cuda.device(rows.device):
        status = lib.segment_sum_bf16(
            rows.data_ptr(), stride, n_rows, starts.data_ptr(), n, cols,
            out.data_ptr(), flags.data_ptr(),
            torch.cuda.current_stream(rows.device).cuda_stream)
    LIBRARY.check(status)
    LAUNCHES += 1
    return out


def segment_sum_bf16(values: torch.Tensor, ids: torch.Tensor,
                     n: int) -> torch.Tensor:
    """:func:`segment_sum_bf16_plain`'s contract, for one value of at most
    8 columns: ``Segments(ids, n).sum(values)``. CPU tensors take the plain
    version; CUDA tensors launch ``csrc/segment_sum.cu`` once or raise.
    Unlike ``index_add_``'s bf16 atomics on the card, this gives the JAX
    package's CPU bits, flushed subnormals included, the same on every
    run."""
    if values.dtype != torch.bfloat16:
        raise TypeError(f"a bf16 segment sum takes bfloat16 values, not "
                        f"{values.dtype}")
    return Segments(ids, n).sum(values)[0]


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
    return bin_ids_to_cells(points, weights, cell_ids(coords, side),
                            side**3, cap)


def bin_ids_to_cells(points, weights, ids, n_cells: int, cap: int):
    """:func:`bin_to_cells` from the bodies' flat cell ids (< n_cells):
    one stable argsort, so the bodies of a cell keep their order."""
    sort_order = torch.argsort(ids, stable=True)
    sorted_ids = ids[sort_order]
    count = segment_sum(torch.ones_like(ids), ids, n_cells)
    start = torch.cumsum(count, 0) - count
    cells_pos, cells_w = build_padded_cells(
        points[sort_order], weights[sort_order], sorted_ids, start,
        n_cells, cap,
    )
    return cells_pos, cells_w, count, start, sort_order, sorted_ids


def slot_cell_ids(coords: torch.Tensor, side: int) -> torch.Tensor:
    """The flat ids of a batch's bodies, (B, n, 3) coords -> (B n,): slot
    b's cell c is ``b * side^3 + c``, so one sort orders a whole batch
    slot by slot and each slot's bodies as its own sort orders them."""
    b, n = coords.shape[:2]
    ids = cell_ids(coords.reshape(b * n, 3), side).reshape(b, n)
    slot = torch.arange(b, device=coords.device)[:, None] * side**3
    return (ids + slot).reshape(b * n)


def bin_to_cells_batched(points, weights, coords, side: int, cap: int):
    """:func:`bin_to_cells` over a batch of B systems, points (B, n, 3),
    weights (B, n) and coords (B, n, 3), through one stable argsort of
    the flat ids (:func:`slot_cell_ids`) over B n bodies: slot b's cells
    are slot b's solo cells.

    Returns (cells_pos (B, side^3, cap, 3), cells_w (B, side^3, cap),
    count (B, side^3), start, sort_order, sorted_ids), the last three over
    the flattened batch: ``start`` (B side^3,) each flat cell's first
    position in the sorted order, ``sort_order`` and ``sorted_ids`` (B n,)
    indices into the flattened bodies and their flat ids."""
    b, n = points.shape[:2]
    n_cells = side**3
    cells_pos, cells_w, count, start, sort_order, sorted_ids = (
        bin_ids_to_cells(points.reshape(b * n, 3), weights.reshape(b * n),
                         slot_cell_ids(coords, side), b * n_cells, cap))
    return (cells_pos.reshape(b, n_cells, cap, 3),
            cells_w.reshape(b, n_cells, cap), count.reshape(b, n_cells),
            start, sort_order, sorted_ids)


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
