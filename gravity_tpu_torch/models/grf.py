"""Gaussian-random-field (Zel'dovich) cosmological initial conditions.

Counterpart of ``gravity_tpu/models/grf.py``: particles start on a
uniform lattice and are displaced by a Gaussian random displacement field
whose density power spectrum follows P(k) ~ k^n_s (or a given shape):

    delta_k  ~  sqrt(P(k)/2) (a + i b),   a, b ~ N(0, 1)
    psi_k    =  i k_vec / k^2 delta_k       (displacement field)
    x        =  q + psi(q),   v = f_vel psi(q)

one inverse real FFT an axis (``torch.fft``, cuFFT on the card), with the
second-order (2LPT) field on request.

The spectral core (:func:`grf_fields_from_normals`) takes the two normal
fields as tensors. A run draws them from a CPU ``torch.Generator`` seeded
from its config (:func:`draw_normals`), so the realization does not
depend on the device; tests feed it the JAX package's
``jax.random.normal`` draws, so that both packages build one
realization.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..state import ParticleState


def grf_side(n: int) -> int:
    """Lattice side for n particles; raises unless n is a perfect cube."""
    side = round(n ** (1.0 / 3.0))
    if side**3 != n:
        raise ValueError(
            f"model 'grf' needs a perfect-cube n (8, 27, 64, ..., 4096, "
            f"32768, 262144, ...); got n={n}"
        )
    return side


def grf_lattice(side: int, box: float, dtype=torch.float32, device="cpu"):
    """The (side^3, 3) cell-centred lattice that create_grf displaces: the
    one definition of the IC lattice, shared with callers that rebuild
    displacement fields (the ``cosmo`` verb)."""
    ar = torch.arange(side, device=device)
    q = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                    dim=-1).reshape(-1, 3)
    return (q + 0.5).to(dtype) * (box / side)


def _mode_grids(side: int, dtype, device):
    """Integer mode grids (kx, ky, kz) on the rfft half-spectrum."""
    idx = torch.fft.fftfreq(side, dtype=dtype, device=device) * side
    idz = torch.fft.rfftfreq(side, dtype=dtype, device=device) * side
    return torch.meshgrid(idx, idx, idz, indexing="ij")


def _k2_safe(kx, ky, kz, kf):
    k2 = (kx**2 + ky**2 + kz**2) * kf**2
    return torch.where(k2 > 0, k2, 1.0)


def zeldovich_displacements(delta_k, kx, ky, kz, side: int, box: float):
    """First-order (Zel'dovich) displacement field psi(1), (n, 3), from the
    rfft half-spectrum ``delta_k``: psi_k = i k delta_k / k^2 in physical
    wavenumbers k = 2 pi m / box."""
    kf = 2.0 * math.pi / box
    k2_safe = _k2_safe(kx, ky, kz, kf)
    psi = [torch.fft.irfftn(1j * (kc * kf) / k2_safe * delta_k,
                            s=(side, side, side))
           for kc in (kx, ky, kz)]
    return torch.stack([p.reshape(-1) for p in psi], dim=1)


def second_order_displacements(delta_k, kx, ky, kz, side: int, box: float):
    """Second-order (2LPT) displacement field psi(2), (n, 3), for the same
    ``delta_k`` normalization as :func:`zeldovich_displacements`: the
    2LPTic convention, psi(2) = -(3/7) grad(phi2) at D = 1 with
    del^2 phi2 = sum_{i<j} [phi1,ii phi1,jj - (phi1,ij)^2]."""
    kf = 2.0 * math.pi / box
    k2_safe = _k2_safe(kx, ky, kz, kf)
    s3 = (side, side, side)

    def d2(ka, kb):
        return torch.fft.irfftn((ka * kf) * (kb * kf) / k2_safe * delta_k,
                                s=s3)

    pxx, pyy, pzz = d2(kx, kx), d2(ky, ky), d2(kz, kz)
    pxy, pxz, pyz = d2(kx, ky), d2(kx, kz), d2(ky, kz)
    src = (pxx * pyy + pxx * pzz + pyy * pzz
           - pxy**2 - pxz**2 - pyz**2)
    src_k = torch.fft.rfftn(src)
    psi2 = [torch.fft.irfftn((3.0 / 7.0) * 1j * (kc * kf) / k2_safe * src_k,
                             s=s3)
            for kc in (kx, ky, kz)]
    return torch.stack([p.reshape(-1) for p in psi2], dim=1)


def spectrum_amplitude(side: int, *, box: float, spectral_index: float = -2.0,
                       power_spectrum=None, dtype=torch.float32,
                       device="cpu"):
    """(amp, kx, ky, kz): the normalized sqrt(P(k)) on the rfft
    half-spectrum (k = 0 zeroed, max 1) and the integer mode grids.

    ``power_spectrum`` replaces the power law with a P(k) shape: a
    callable over physical wavenumbers k = 2 pi m / box (taking and
    returning tensors), or an (M, 2) table of (k, P) rows interpolated
    log-log (clamped outside its range), prepared in host float64 and
    normalized in log space before it reaches the device (dimensionful
    amplitudes overflow fp32)."""
    kx, ky, kz = _mode_grids(side, dtype, device)
    k_mag = torch.sqrt(kx**2 + ky**2 + kz**2)
    if power_spectrum is None:
        amp = torch.where(k_mag > 0, k_mag ** (spectral_index / 2.0), 0.0)
    else:
        k_phys = k_mag * (2.0 * math.pi / box)
        if callable(power_spectrum):
            p_k = power_spectrum(k_phys)
        else:
            tab = np.asarray(power_spectrum, np.float64)
            if tab.ndim != 2 or tab.shape[1] != 2 or tab.shape[0] < 2:
                raise ValueError(
                    "power_spectrum table must be (M >= 2, 2) rows of "
                    f"(k, P); got shape {tab.shape}"
                )
            if np.any(tab <= 0.0) or not np.all(np.isfinite(tab)):
                raise ValueError(
                    "power_spectrum table needs finite k > 0 and P > 0 "
                    "in every row (drop zero-padding/negative entries)"
                )
            tab = tab[np.argsort(tab[:, 0])]
            log_tab_k = torch.as_tensor(np.log(tab[:, 0])).to(dtype=dtype,
                                                             device=device)
            log_tab_p = torch.as_tensor(
                np.log(tab[:, 1]) - np.log(tab[:, 1]).max()).to(
                    dtype=dtype, device=device)
            logk = torch.log(torch.where(k_phys > 0, k_phys, 1.0))
            p_k = torch.exp(_interp(logk, log_tab_k, log_tab_p))
        amp = torch.where(k_mag > 0, torch.sqrt(torch.clamp_min(p_k, 0.0)),
                          0.0).to(k_mag.dtype)
    # sigma_psi pins the final scale; normalizing here keeps a
    # dimensionful spectrum's mean square inside fp32.
    amp_max = amp.max()
    amp = torch.where(amp_max > 0, amp / amp_max, amp)
    return amp, kx, ky, kz


def _interp(x, xp, fp):
    """``jnp.interp``, op for op: piecewise-linear, clamped to fp's end
    values."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    f = torch.where(dx == 0, fp[i],
                    fp[i - 1] + (delta / torch.where(dx == 0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def draw_normals(gen: torch.Generator, side: int, dtype=torch.float32,
                 device="cpu"):
    """(re, im): the two standard-normal fields on the rfft half-grid,
    drawn in float64 from the CPU generator and rounded to ``dtype``."""
    shape = (side, side, side // 2 + 1)
    re = torch.randn(shape, generator=gen, dtype=torch.float64)
    im = torch.randn(shape, generator=gen, dtype=torch.float64)
    return re.to(dtype=dtype, device=device), im.to(dtype=dtype,
                                                     device=device)


def grf_fields_from_normals(re, im, amp, kx, ky, kz, *, side: int,
                            box: float, sigma_psi: float,
                            with_second_order: bool):
    """(psi1_scaled, psi2_scaled | None): the spectral construction from
    the normal fields. The first-order field is normalized to RMS
    ``sigma_psi * box`` per axis; that rescale s acts linearly on delta,
    so the second-order field scales as s^2."""
    delta_k = amp * torch.complex(re, im)
    psi1 = zeldovich_displacements(delta_k, kx, ky, kz, side, box)
    rms = torch.sqrt((psi1**2).mean())
    target = torch.tensor(sigma_psi * box, dtype=psi1.dtype,
                          device=psi1.device)
    s = target / torch.clamp_min(rms, torch.finfo(psi1.dtype).tiny)
    psi2 = None
    if with_second_order:
        psi2 = s**2 * second_order_displacements(delta_k, kx, ky, kz, side,
                                                 box)
    return s * psi1, psi2


def _grf_fields(normals, n: int, *, box: float, spectral_index: float = -2.0,
                sigma_psi: float = 0.02, power_spectrum=None,
                with_second_order: bool = True, dtype=torch.float32,
                device="cpu"):
    """(psi1_scaled, psi2_scaled | None) of one realization: ``normals``
    is a CPU ``torch.Generator`` (drawn with :func:`draw_normals`) or the
    (re, im) tensors themselves. The fields are float64 for a float64
    state and float32 otherwise, as the JAX package builds them in its
    default float dtype (an FFT takes no bf16)."""
    side = grf_side(n)
    dtype = torch.float64 if dtype == torch.float64 else torch.float32
    amp, kx, ky, kz = spectrum_amplitude(
        side, box=box, spectral_index=spectral_index,
        power_spectrum=power_spectrum, dtype=dtype, device=device)
    if isinstance(normals, torch.Generator):
        re, im = draw_normals(normals, side, dtype, device)
    else:
        re, im = (t.to(dtype=dtype, device=device) for t in normals)
    return grf_fields_from_normals(re, im, amp, kx, ky, kz, side=side,
                                   box=box, sigma_psi=sigma_psi,
                                   with_second_order=with_second_order)


def grf_displacement_fields(normals, n: int, *, box: float = 1.0e13,
                            spectral_index: float = -2.0,
                            sigma_psi: float = 0.02, power_spectrum=None,
                            dtype=torch.float32, device="cpu"):
    """(psi1, psi2) scaled displacement fields of the create_grf
    realization of ``normals``, kept apart so that callers can apply
    order-dependent velocity factors (2LPT growing-mode momenta need
    f2 ~ 2 f1 on the second-order piece)."""
    return _grf_fields(normals, n, box=box, spectral_index=spectral_index,
                       sigma_psi=sigma_psi, power_spectrum=power_spectrum,
                       dtype=dtype, device=device)


def create_grf(normals, n: int, *, box: float = 1.0e13,
               spectral_index: float = -2.0, sigma_psi: float = 0.02,
               vel_factor: float = 0.0, total_mass: float = 1.0e33,
               dtype=torch.float32, power_spectrum=None, lpt_order: int = 1,
               device="cpu") -> ParticleState:
    """Lattice plus Zel'dovich displacements with P(k) ~ k^spectral_index.

    ``n`` must be a perfect cube. ``sigma_psi`` sets the RMS displacement
    an axis as a fraction of the box side; ``vel_factor`` scales the
    velocities v = vel_factor psi (default cold). ``power_spectrum``
    replaces the power law with a shape (:func:`spectrum_amplitude`);
    ``sigma_psi`` pins the amplitude either way. ``lpt_order`` 2 adds the
    second-order field. ``normals`` is a CPU ``torch.Generator`` or the
    (re, im) normal fields."""
    if lpt_order not in (1, 2):
        raise ValueError(f"lpt_order must be 1 or 2, got {lpt_order}")
    side = grf_side(n)
    psi1, psi2 = _grf_fields(
        normals, n, box=box, spectral_index=spectral_index,
        sigma_psi=sigma_psi, power_spectrum=power_spectrum,
        with_second_order=lpt_order == 2, dtype=dtype, device=device)
    psi = psi1 if psi2 is None else psi1 + psi2
    lattice = grf_lattice(side, box, dtype=psi.dtype, device=psi.device)
    positions = torch.remainder(lattice + psi,
                                torch.tensor(box, dtype=psi.dtype,
                                             device=psi.device)).to(dtype)
    velocities = (vel_factor * psi).to(dtype)
    masses = torch.full((n,), total_mass / n, dtype=dtype,
                        device=psi.device)
    return ParticleState(positions, velocities, masses)
