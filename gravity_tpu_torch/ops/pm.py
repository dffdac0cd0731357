"""Particle-mesh (PM) gravity: mass assignment and the FFT Poisson solve
with isolated boundaries.

Counterpart of ``gravity_tpu/ops/pm.py``: the cloud-in-cell (CIC) and
triangular-shaped-cloud (TSC) deposits of masses onto an (M, M, M) grid
and their gathers of a per-axis grid field back to points, with the
isolated-boundary convention (stencil cells clamped into the grid) or the
periodic one (``wrap=True``: cells taken mod M), :func:`bounding_cube`,
and the standalone isolated ``pm`` backend (:func:`pm_accelerations`):
the density embedded in a zero-padded (2M)^3 grid, convolved with the
softened -1/r Green's function by FFT (``torch.fft``, cuFFT on the card,
where the JAX package calls ``jnp.fft``), differentiated by central
differences and gathered back. The JAX package reaches no Pallas kernel
here, and the port has none either: plain PyTorch on every device.

The deposit is ``index_put_(..., accumulate=True)``, the counterpart of
``.at[].add``, over the stencil corners in the JAX package's order. On
the CPU the sums run in element order, as XLA's scatter does. On a CUDA
device PyTorch sorts the indices (a stable sort) and sums each cell's run
in that order, not with float atomics: the card repeats its own bits run
after run (a resumed ``cosmo`` run gives the uninterrupted run's bits,
``chip_smoke.py`` phase ``cosmo_path``), and differs from the CPU in the
last bits.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..constants import G
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


def _stencil_indices(base, dx: int, dy: int, dz: int, m: int,
                     wrap: bool = False):
    """Grid indices of the (dx, dy, dz) stencil corner of each base cell:
    the one definition of the boundary convention, wrapped mod m
    (periodic; ``torch.remainder`` is never negative, as ``%`` in jnp) or
    clamped into the grid (isolated)."""
    if wrap:
        return (torch.remainder(base[:, 0] + dx, m),
                torch.remainder(base[:, 1] + dy, m),
                torch.remainder(base[:, 2] + dz, m))
    return (
        torch.clamp(base[:, 0] + dx, 0, m - 1),
        torch.clamp(base[:, 1] + dy, 0, m - 1),
        torch.clamp(base[:, 2] + dz, 0, m - 1),
    )


def _cic_corners(positions, origin, h):
    """(base cell, dx, dy, dz, weight) of the eight CIC corners of each
    point on the grid of spacing ``h`` from ``origin``."""
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


def _tsc_axis_weights(f):
    """TSC weights for offsets (-1, 0, +1) around the nearest cell, given
    d = u - nearest centre in [-1/2, 1/2)."""
    return (0.5 * (0.5 - f) ** 2, 0.75 - f * f, 0.5 * (0.5 + f) ** 2)


def _tsc_corners(positions, origin, h):
    """(nearest cell, dx, dy, dz, weight) of the 27 TSC stencil points."""
    u = (positions - origin[None, :]) / h
    c = torch.floor(u + 0.5).to(torch.int64)
    d = u - c.to(u.dtype)
    wx, wy, wz = (_tsc_axis_weights(d[:, a]) for a in range(3))
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                yield c, dx, dy, dz, wx[dx + 1] * wy[dy + 1] * wz[dz + 1]


def _deposit(corners, positions, masses, grid: int, origin, h, wrap):
    rho = positions.new_zeros((grid, grid, grid))
    for base, dx, dy, dz, w in corners(positions, origin, h):
        rho.index_put_(_stencil_indices(base, dx, dy, dz, grid, wrap),
                       masses * w, accumulate=True)
    return rho


def _gather(corners, field, positions, origin, h, wrap):
    m = field.shape[0]
    out = field.new_zeros((positions.shape[0], field.shape[-1]))
    for base, dx, dy, dz, w in corners(positions, origin, h):
        out = out + w[:, None] * field[_stencil_indices(base, dx, dy, dz, m,
                                                        wrap)]
    return out


def cic_deposit(positions, masses, grid: int, origin, h, *,
                wrap: bool = False) -> torch.Tensor:
    """Scatter masses to an (M, M, M) grid with cloud-in-cell weights:
    out-of-range corners clamped to the boundary (isolated), or with
    ``wrap`` taken mod M (periodic: a point in the last cell spreads its
    weight across the face into cell 0)."""
    return _deposit(_cic_corners, positions, masses, grid, origin, h, wrap)


def cic_gather(field, positions, origin, h, *,
               wrap: bool = False) -> torch.Tensor:
    """Interpolate a per-axis grid field (M, M, M, C) to the points, with
    :func:`cic_deposit`'s boundary convention."""
    return _gather(_cic_corners, field, positions, origin, h, wrap)


def tsc_deposit(positions, masses, grid: int, origin, h, *,
                wrap: bool = False) -> torch.Tensor:
    """Scatter masses with triangular-shaped-cloud (second-order)
    weights: a 27-point stencil, one order smoother than CIC (k-space
    window sinc^3 per axis). Boundaries as :func:`cic_deposit`."""
    return _deposit(_tsc_corners, positions, masses, grid, origin, h, wrap)


def tsc_gather(field, positions, origin, h, *,
               wrap: bool = False) -> torch.Tensor:
    """TSC interpolation of a grid field to the points (the gather twin
    of :func:`tsc_deposit`)."""
    return _gather(_tsc_corners, field, positions, origin, h, wrap)


def assignment_fns(assignment: str):
    """(deposit, gather, k-space window exponent) of a mass-assignment
    scheme, shared by the isolated and periodic solvers (the exponent
    matters only where a window is deconvolved: the periodic path)."""
    if assignment == "cic":
        return cic_deposit, cic_gather, 2
    if assignment == "tsc":
        return tsc_deposit, tsc_gather, 3
    raise ValueError(
        f"unknown assignment {assignment!r}; choose 'cic' or 'tsc'"
    )


def _greens_function(m2: int, h, eps: float, dtype):
    """Softened -1/r kernel on the padded (2M)^3 grid, wrapped so that
    negative separations index from the top (the circular convolution
    sees the padded box as separation space). ``h`` is a device scalar."""
    idx = torch.arange(m2, device=h.device)
    sep = torch.where(idx < m2 // 2, idx, idx - m2)
    x = sep.to(dtype) * h
    r2 = (x[:, None, None] ** 2 + x[None, :, None] ** 2
          + x[None, None, :] ** 2 + rounded(eps * eps, dtype))
    half = 0.5 * h
    r2 = torch.maximum(r2, half * half)
    return -1.0 / torch.sqrt(r2)


def _grad_axis(fld, axis: int, h):
    """Central difference along ``axis``, one-sided at the cube faces."""
    fwd = torch.roll(fld, -1, axis)
    bwd = torch.roll(fld, 1, axis)
    interior = (fwd - bwd) / (2.0 * h)
    n = fld.shape[axis]
    idx = torch.arange(n, device=fld.device)
    shape = [-1 if a == axis else 1 for a in range(3)]
    first = (idx == 0).reshape(shape)
    last = (idx == n - 1).reshape(shape)
    one_fwd = (fwd - fld) / h
    one_bwd = (fld - bwd) / h
    return torch.where(first, one_fwd, torch.where(last, one_bwd, interior))


def pm_solve(targets, positions, masses, origin, span, *, grid: int,
             g: float, eps: float, assignment: str = "cic") -> torch.Tensor:
    """PM solve (softened -1/r kernel) over an explicit bounding cube:
    deposit the sources, convolve on the zero-padded (2M)^3 grid, gather
    the field at the targets. The real-space Green's function applies no
    window deconvolution, so ``tsc`` here smooths slightly more than
    ``cic``."""
    deposit, gather, _ = assignment_fns(assignment)
    dtype = positions.dtype
    m = grid
    m2 = 2 * m
    h = span / (m - 1)
    with record_function("pm.deposit"):
        rho = deposit(positions, masses, m, origin, h)
    with record_function("pm.fft"):
        rho_p = positions.new_zeros((m2, m2, m2))
        rho_p[:m, :m, :m] = rho
        greens = _greens_function(m2, h, eps, dtype)
        phi_k = torch.fft.rfftn(rho_p) * torch.fft.rfftn(greens)
        phi = torch.fft.irfftn(phi_k, s=(m2, m2, m2))[:m, :m, :m]
        phi = rounded(g, dtype) * phi.to(dtype)
        acc_field = torch.stack([-_grad_axis(phi, a, h) for a in range(3)],
                                dim=-1)  # (M, M, M, 3)
    with record_function("pm.gather"):
        return gather(acc_field, targets, origin, h)


def pm_accelerations_vs(targets, positions, masses, *, grid: int = 128,
                        g: float = G, eps: float = 0.0,
                        assignment: str = "cic") -> torch.Tensor:
    """PM accelerations at ``targets`` from sources (positions, masses),
    isolated boundaries: the mesh solve over the sources' bounding cube,
    re-derived each call, the field gathered at the targets."""
    origin, span = bounding_cube(positions)
    return pm_solve(targets, positions, masses, origin, span, grid=grid,
                    g=g, eps=eps, assignment=assignment)


def pm_accelerations(positions, masses, *, grid: int = 128, g: float = G,
                     eps: float = 0.0, assignment: str = "cic"):
    """PM accelerations for all particles (isolated boundaries). ``eps``
    is the Plummer softening; values below half a cell are clamped to
    the grid's resolution floor."""
    return pm_accelerations_vs(positions, positions, masses, grid=grid,
                               g=g, eps=eps, assignment=assignment)
