"""Particle-mesh mass assignment over the bounding cube, isolated
boundaries.

Counterpart of the parts of ``gravity_tpu/ops/pm.py`` that the P3M solver
(``ops/p3m.py``) uses: the cloud-in-cell (CIC) deposit of masses onto an
(M, M, M) grid and the CIC gather of a per-axis grid field back to points,
with the isolated-boundary convention (stencil cells clamped into the
grid), and :func:`bounding_cube`.

The deposit is ``index_put_(..., accumulate=True)``, the counterpart of
``.at[].add``, over the eight stencil corners in the JAX package's (dx, dy,
dz) order. On the CPU the sums run in element order, as XLA's scatter does;
on a CUDA device they are atomics, so their last bits vary from run to run.

Not ported yet (ROADMAP Queue 1 item 7): the periodic wrap, TSC
assignment, the Green's function and the standalone ``pm`` backend.
"""

from __future__ import annotations

import torch

from .forces import rounded


def bounding_cube(positions: torch.Tensor):
    """(origin, span) of a cube containing all positions, small margin;
    device tensors of the positions' dtype. A batch of systems, (B, n, 3),
    gives each slot its own cube: origin (B, 3) and span (B,), each slot's
    the bits of its own call (min and max are exact, and the rest is
    elementwise). The margin and floor are Python scalars already rounded
    to the dtype, which round a product as their tensors do, with no
    host-to-device copy (a copy would stall the host every evaluation)."""
    lo = positions.min(dim=-2).values
    hi = positions.max(dim=-2).values
    span = ((hi - lo).max(dim=-1).values * rounded(1.02, positions.dtype)
            + rounded(1e-30, positions.dtype))
    center = 0.5 * (hi + lo)
    origin = center - 0.5 * span[..., None]
    return origin, span


def _stencil_indices(base, dx: int, dy: int, dz: int, m: int):
    """Grid indices of the (dx, dy, dz) stencil corner of each base cell,
    clamped into the grid (isolated boundaries)."""
    return (
        torch.clamp(base[:, 0] + dx, 0, m - 1),
        torch.clamp(base[:, 1] + dy, 0, m - 1),
        torch.clamp(base[:, 2] + dz, 0, m - 1),
    )


def _corners(positions, origin, h):
    """(base cell, fractional offset) of each point on the grid of spacing
    ``h`` from ``origin``, and the eight (dx, dy, dz, weight) corners."""
    u = (positions - origin[None, :]) / h
    i0 = torch.floor(u).to(torch.int64)
    f = u - i0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (f[:, 0] if dx else 1.0 - f[:, 0])
                    * (f[:, 1] if dy else 1.0 - f[:, 1])
                    * (f[:, 2] if dz else 1.0 - f[:, 2])
                )
                yield i0, dx, dy, dz, w


def cic_deposit(positions, masses, grid: int, origin, h) -> torch.Tensor:
    """Scatter masses to an (M, M, M) grid with cloud-in-cell weights;
    out-of-range corners are clamped to the boundary."""
    rho = positions.new_zeros((grid, grid, grid))
    for i0, dx, dy, dz, w in _corners(positions, origin, h):
        rho.index_put_(_stencil_indices(i0, dx, dy, dz, grid), masses * w,
                       accumulate=True)
    return rho


def cic_gather(field, positions, origin, h) -> torch.Tensor:
    """Interpolate a per-axis grid field (M, M, M, C) to the points."""
    m = field.shape[0]
    out = positions.new_zeros((positions.shape[0], field.shape[-1]))
    for i0, dx, dy, dz, w in _corners(positions, origin, h):
        out = out + w[:, None] * field[_stencil_indices(i0, dx, dy, dz, m)]
    return out
