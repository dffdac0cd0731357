"""Periodic-box PM gravity: the cosmological boundary condition.

Counterpart of ``gravity_tpu/ops/periodic.py``. Every particle interacts
with the infinite lattice of its images through the natural periodic FFT
solve, with no zero padding:

    phi_k = -4 pi G * rho_k * e^{-k eps} / k^2,   phi_{k=0} = 0

The dropped k = 0 mode subtracts the mean density (only fluctuations
gravitate, as a homogeneous expanding background needs). ``e^{-k eps}``
is the k-space softening whose real-space kernel is the arctan core
``phi(r) = -(2/pi) G m arctan(r/eps) / r``. Accelerations are spectral
gradients (i k phi_k), gathered with the wrapped assignment window used
for the deposit; the window is deconvolved once a pass.

Plain PyTorch on every device: the JAX package's form is XLA scatter and
``jnp.fft`` with no Pallas kernel, and ``torch.fft`` (cuFFT on the card)
stands where it calls ``jnp.fft``. The mode grids are built in the
state's dtype, as the JAX package builds ``fftfreq`` in float32 (float64
under x64), so ``k2h2``, the window and the softening round alike; the
complex spectra stay complex64 on an fp32 state.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.profiler import record_function

from ..constants import G
from .forces import rounded
from .pm import assignment_fns


def _mode_grids(grid: int, box: float, dtype, device):
    """(mx, my, mz) integer mode numbers on the rfft half-grid, in
    ``dtype``, and the fundamental wavenumber kf = 2 pi / box (a device
    scalar)."""
    idx = torch.fft.fftfreq(grid, dtype=dtype, device=device) * grid
    idz = torch.fft.rfftfreq(grid, dtype=dtype, device=device) * grid
    mx, my, mz = torch.meshgrid(idx, idx, idz, indexing="ij")
    two_pi = torch.tensor(2.0 * math.pi, dtype=dtype, device=device)
    kf = two_pi / torch.tensor(box, dtype=dtype, device=device)
    return (mx, my, mz), kf


def _phi_k(rho_k, modes, *, h, kf, g: float, eps: float, grid: int, dtype,
           p_assign: int = 2):
    """The softened periodic potential in k-space from the mass-per-cell
    transform: the one place the kernel (deconvolution, softening, Jeans
    swindle, normalization) is defined, shared by the force and energy
    paths.

    fp32 structure: 4 pi G / (k^2 h^3) combines G ~ 1e-10, h^3 ~ 1e35 and
    k^2 ~ 1e-25, and one association order makes G / h^3 ~ 1e-45, which
    flushes to zero. It is written (4 pi G / h) / (k^2 h^2) with the
    dimensionless k^2 h^2 = m^2 (2 pi / grid)^2 = O(1), each division a
    tensor division (a Python scalar over a tensor would take a
    reciprocal first)."""
    mx, my, mz = modes
    m2 = mx * mx + my * my + mz * mz
    k2h2 = m2 * rounded((2.0 * math.pi / grid) ** 2, dtype)
    k2h2_safe = torch.where(m2 > 0, k2h2, 1.0)
    # Assignment window (sinc^p per axis: p = 2 CIC, p = 3 TSC),
    # deconvolved once a pass. torch.sinc is normalized, as jnp.sinc.
    w = (torch.sinc(mx / grid) * torch.sinc(my / grid)
         * torch.sinc(mz / grid)) ** p_assign
    w2 = torch.clamp_min(w * w, rounded(1e-12, dtype))
    # Arctan-core softening: k eps = sqrt(m2) kf eps.
    soft = torch.exp(-torch.sqrt(m2) * (kf * rounded(eps, dtype)))
    four_pi_g = torch.tensor(4.0 * math.pi * g, dtype=dtype, device=h.device)
    kernel = (four_pi_g / h) / k2h2_safe
    phi_k = -rho_k * kernel * soft / w2
    # Jeans swindle: drop the k = 0 mean-density mode.
    return torch.where(m2 > 0, phi_k, 0.0)


def _grid_setup(positions, box: float, grid: int):
    origin = positions.new_zeros(3)
    h = positions.new_full((), box) / grid
    return origin, h


def pm_periodic_accelerations_vs(targets, positions, masses, *, box: float,
                                 grid: int = 128, g: float = G,
                                 eps: float = 0.0,
                                 assignment: str = "cic") -> torch.Tensor:
    """Accelerations at ``targets`` from a periodic box of sources, box
    [0, box)^3. Positions may lie outside it: the wrapped assignment maps
    them into their cell. ``eps`` is the arctan-core softening length
    (not exactly Plummer, equivalent in role); scales below the mesh are
    smoothed by the grid itself."""
    deposit, gather, p_assign = assignment_fns(assignment)
    dtype = positions.dtype
    origin, h = _grid_setup(positions, box, grid)
    with record_function("pm.deposit"):
        rho = deposit(positions, masses, grid, origin, h, wrap=True)
    with record_function("pm.fft"):
        rho_k = torch.fft.rfftn(rho)
        modes, kf = _mode_grids(grid, box, dtype, positions.device)
        phi_k = _phi_k(rho_k, modes, h=h, kf=kf, g=g, eps=eps, grid=grid,
                       dtype=dtype, p_assign=p_assign)
        # a = -grad(phi) -> a_k = -i k phi_k; the 1/h^3 of the inverse
        # transform's normalization is folded into phi_k. kc is real in
        # the state's dtype, so the product stays complex64 at fp32.
        acc_grids = torch.stack([
            torch.fft.irfftn(-1j * (m * kf) * phi_k, s=(grid, grid, grid))
            for m in modes
        ], dim=-1)
    with record_function("pm.gather"):
        return gather(acc_grids, targets, origin, h, wrap=True).to(dtype)


def pm_periodic_accelerations(positions, masses, *, box: float,
                              grid: int = 128, g: float = G,
                              eps: float = 0.0, assignment: str = "cic"):
    """All-particles form (targets = sources)."""
    return pm_periodic_accelerations_vs(positions, positions, masses,
                                        box=box, grid=grid, g=g, eps=eps,
                                        assignment=assignment)


def _potential_core(positions, mw, box: float, *, grid: int, g: float,
                    eps: float, assignment: str = "cic") -> torch.Tensor:
    """0.5 sum_i mw_i phi_w(x_i) with unit-scale weights ``mw`` (a device
    scalar, well inside fp32's range); the caller restores the m_mean^2
    scale in host float64."""
    deposit, gather, p_assign = assignment_fns(assignment)
    dtype = positions.dtype
    origin, h = _grid_setup(positions, box, grid)
    rho = deposit(positions, mw, grid, origin, h, wrap=True)
    rho_k = torch.fft.rfftn(rho)
    modes, kf = _mode_grids(grid, box, dtype, positions.device)
    phi_k = _phi_k(rho_k, modes, h=h, kf=kf, g=g, eps=eps, grid=grid,
                   dtype=dtype, p_assign=p_assign)
    phi_grid = torch.fft.irfftn(phi_k, s=(grid, grid, grid))[..., None]
    phi = gather(phi_grid, positions, origin, h, wrap=True)[:, 0]
    return 0.5 * (mw * phi).sum()


def mean_mass_weights(masses: torch.Tensor):
    """(mw, m_mean): masses over their mean (floored at the dtype's
    smallest normal), the mesh potential's unit-scale weights."""
    m_mean = masses.mean()
    floor = torch.finfo(masses.dtype).tiny
    return masses / torch.clamp_min(m_mean, floor), m_mean


def pm_periodic_potential_energy(positions, masses, *, box: float,
                                 grid: int = 128, g: float = G,
                                 eps: float = 0.0,
                                 assignment: str = "cic") -> float:
    """Mesh potential energy E = 0.5 sum_i m_i phi(x_i) of a periodic run:
    the potential the periodic solver conserves (the isolated pair sum is
    not, and jumps when positions re-wrap). It includes each particle's
    cloud self-energy, nearly constant in time, so the drift stays a
    meaningful integrator diagnostic. Unit-scale weights on the device,
    the m_mean^2 rescale in host float64 (m phi overflows fp32 at
    astronomical scales)."""
    mw, m_mean = mean_mass_weights(masses)
    s = _potential_core(positions, mw, box, grid=grid, g=g, eps=eps,
                        assignment=assignment)
    return float(np.float64(float(m_mean)) ** 2 * np.float64(float(s)))
