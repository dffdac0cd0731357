"""Density power spectrum P(k).

Counterpart of ``gravity_tpu/ops/spectra.py``: CIC mass assignment onto a
periodic grid (``pm.cic_deposit(wrap=True)``), one 3D FFT (``torch.fft``,
cuFFT on the card), radially binned |delta_k|^2. Conventions:

    delta(x) = rho(x)/rho_mean - 1
    delta_k  = (1/Ngrid^3) sum_x delta(x) e^{-ikx}
    P(k)     = V <|delta_k|^2>

so an unclustered Poisson distribution has P(k) = V/N (shot noise) at all
k. The CIC window is deconvolved by default; interlacing (a second
deposit shifted by half a cell) cancels the leading alias images. The
device part is dimensionless (masses enter as relative weights), and the
volume scale is applied in host float64. The bin sums are
``index_add_``: on the card float atomics, so their last bits vary from
run to run.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .pm import bounding_cube, cic_deposit


def _spectrum_device(positions, masses, origin, span, *, grid: int,
                     n_bins: int, deconvolve: bool, interlace: bool):
    """The dimensionless core: (k in kf units, P/V, n_eff) as tensors."""
    dtype, dev = positions.dtype, positions.device
    tiny = torch.finfo(dtype).tiny
    h = span / grid
    mw = masses / torch.clamp_min(masses.mean(), tiny)
    rho = cic_deposit(positions, mw, grid, origin, h, wrap=True)
    mean = rho.mean()
    delta = rho / torch.clamp_min(mean, tiny) - 1.0
    dk = torch.fft.fftn(delta) / (grid**3)

    idx = torch.fft.fftfreq(grid, dtype=dtype, device=dev) * grid
    kx, ky, kz = torch.meshgrid(idx, idx, idx, indexing="ij")
    if interlace:
        # Interlacing (Sefusatti et al. 2016): the half-cell-shifted
        # deposit, phase-corrected, cancels the leading odd alias images.
        rho2 = cic_deposit(positions + 0.5 * h, mw, grid, origin, h,
                           wrap=True)
        delta2 = rho2 / torch.clamp_min(mean, tiny) - 1.0
        dk2 = torch.fft.fftn(delta2) / (grid**3)
        phase = torch.exp(1j * math.pi * (kx + ky + kz) / grid)
        dk = 0.5 * (dk + dk2 * phase)
    k_mag = torch.sqrt(kx**2 + ky**2 + kz**2)

    pk3 = torch.abs(dk) ** 2
    if deconvolve:
        # CIC window W(k) = prod sinc^2(k_i / grid) (torch.sinc is
        # normalized, as jnp.sinc): |delta_k|^2 over W^2.
        w = (torch.sinc(kx / grid) * torch.sinc(ky / grid)
             * torch.sinc(kz / grid)) ** 2
        pk3 = pk3 / torch.clamp_min(w**2, 1e-12)

    # Radial bins over [1, grid/2] fundamental units: the k = 0 mode and
    # the corner modes past Nyquist are dropped.
    edges = torch.linspace(1.0, grid / 2.0, n_bins + 1, dtype=dtype,
                           device=dev)
    k_flat = k_mag.reshape(-1)
    # jnp.digitize(x, edges) - 1: edges[i] <= x < edges[i + 1].
    which = torch.bucketize(k_flat, edges, right=True) - 1
    valid = (which >= 0) & (which < n_bins) & (k_flat >= 1.0)
    which = torch.where(valid, which, n_bins)
    sums = pk3.new_zeros(n_bins + 1).index_add_(
        0, which, pk3.reshape(-1) * valid)
    counts = pk3.new_zeros(n_bins + 1).index_add_(0, which, valid.to(dtype))
    p_over_v = sums[:n_bins] / torch.where(counts[:n_bins] > 0,
                                           counts[:n_bins], math.nan)
    k_centers = 0.5 * (edges[:-1] + edges[1:])
    # The shot-noise count: (sum w)^2 / sum w^2 (N for equal masses).
    w_sum = mw.sum()
    n_eff = w_sum * w_sum / torch.clamp_min((mw * mw).sum(), tiny)
    return k_centers, p_over_v, n_eff


def density_power_spectrum(positions, masses, *, grid: int = 64,
                           box: tuple | None = None, n_bins: int = 16,
                           deconvolve: bool = True,
                           interlace: bool = False):
    """Radially binned P(k) of the mass density field.

    ``box = (origin (3,), side)`` fixes the periodic box; by default the
    bounding cube of the positions. Returns numpy ``(k_centers (n_bins,),
    power (n_bins,), shot_noise)``: empty bins hold NaN, k is in rad per
    length unit, and the volume normalization is applied in host float64
    (a 1e20-length box cubes past fp32's range)."""
    dtype, dev = positions.dtype, positions.device
    if box is None:
        origin, span = bounding_cube(positions)
    else:
        origin = torch.as_tensor(np.asarray(box[0], np.float64)).to(
            dtype=dtype, device=dev)
        span = torch.tensor(box[1], dtype=dtype, device=dev)
    k_kf, p_over_v, n_eff = _spectrum_device(
        positions, masses, origin, span, grid=grid, n_bins=n_bins,
        deconvolve=deconvolve, interlace=interlace)
    span_f = float(span)
    volume = span_f**3
    kf = 2.0 * np.pi / span_f
    k = k_kf.double().cpu().numpy() * kf
    power = p_over_v.double().cpu().numpy() * volume
    shot = volume / float(n_eff)
    return k, power, shot
