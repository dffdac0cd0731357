"""Hernquist-sphere initial conditions (galaxy bulge / dark-halo profile).

Counterpart of ``gravity_tpu/models/hernquist.py``. Hernquist (1990):
rho(r) = M a / (2 pi r (r + a)^3), M(r)/M = r^2 / (r + a)^2. Radii by the
exact inverse CDF, truncated at ``r_max_scale`` a; velocities isotropic
Gaussian with the Jeans radial dispersion of Hernquist (1990) eq. 10,
scaled down to 0.95 of the local escape speed where they exceed it;
then re-centred. Drawn in float64 from a CPU ``torch.Generator``, rounded
to ``dtype`` and moved to the device; the draws differ from
``jax.random``'s.
"""

from __future__ import annotations


import torch

from ..constants import G
from ..state import ParticleState
from ._draw import centred, isotropic, uniform


def _jeans_sigma2(s: torch.Tensor, gm_over_a: float) -> torch.Tensor:
    """Radial velocity dispersion^2 at s = r/a (Hernquist 1990 eq. 10):
    gm_over_a * f(s) / 12 with
    f(s) = 12 s (1+s)^3 ln(1 + 1/s) - s/(1+s) (25 + 52 s + 42 s^2 + 12 s^3).
    log1p keeps the cancelling bracket stable to s ~ 1e4; it is clamped
    at 0 past that."""
    s = torch.clamp_min(s, 1e-8)
    f = 12.0 * s * (1.0 + s) ** 3 * torch.log1p(1.0 / s) - (
        s / (1.0 + s)) * (25.0 + 52.0 * s + 42.0 * s * s + 12.0 * s**3)
    return gm_over_a * torch.clamp_min(f, 0.0) / 12.0


def create_hernquist(
    gen: torch.Generator,
    n: int,
    *,
    total_mass: float = 1.0e30,
    scale_radius: float = 1.0e12,
    g: float = G,
    r_max_scale: float = 50.0,
    dtype=torch.float32,
    device="cpu",
) -> ParticleState:
    if gen.device.type != "cpu":
        raise ValueError("initial conditions are drawn from a CPU generator")
    # The enclosed-mass fraction q in [0, q_max], q_max that of r_max.
    q_max = r_max_scale**2 / (1.0 + r_max_scale) ** 2
    sq = torch.sqrt(uniform(gen, n, 1e-10, q_max))
    r = scale_radius * sq / (1.0 - sq)
    positions = r[:, None] * isotropic(gen, n)

    sigma2 = _jeans_sigma2(r / scale_radius, g * total_mass / scale_radius)
    v = torch.sqrt(sigma2)[:, None] * torch.randn(
        n, 3, dtype=torch.float64, generator=gen)
    v_esc = torch.sqrt(2.0 * g * total_mass / (r + scale_radius))
    speed = torch.linalg.norm(v, dim=1)
    scale = torch.clamp_max(0.95 * v_esc / torch.clamp_min(speed, 1e-300),
                            1.0)
    masses = torch.full((n,), total_mass / n, dtype=torch.float64)
    return centred(positions, v * scale[:, None], masses, dtype, device)
