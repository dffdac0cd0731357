"""Exponential-disk (Milky-Way-like) initial conditions.

Counterpart of ``gravity_tpu/models/disk.py``: a thin exponential disk
with Gaussian vertical structure around a central bulge point mass, on
near-circular orbits set by the enclosed mass. Galactic natural units
(G = 1, kpc, 1e10 Msun): run it with ``g=1.0``, as the ``baseline-1m-p3m``
preset does.

The numbers come from a CPU ``torch.Generator`` in float64 (four draws:
radius quantiles, azimuths, heights, velocity noise) and the radius is
inverted from the enclosed-mass CDF by the same 40-round bisection; the
state is then rounded to ``dtype`` and moved to the device. The draws
differ from ``jax.random``'s, so parity tests hand both packages one
state (``interop.state_from_numpy``).
"""

from __future__ import annotations

import math

import torch

from ..state import ParticleState


def create_disk(
    gen: torch.Generator,
    n: int,
    *,
    disk_mass: float = 5.0,
    bulge_mass: float = 1.0,
    scale_length: float = 3.0,
    scale_height: float = 0.3,
    g: float = 1.0,
    dtype=torch.float32,
    device="cpu",
) -> ParticleState:
    if gen.device.type != "cpu":
        raise ValueError("initial conditions are drawn from a CPU generator")
    if n < 2:
        raise ValueError(f"model 'disk' needs n >= 2 (bulge + disk), got {n}")
    f64 = torch.float64
    u = torch.empty(n, dtype=f64).uniform_(1e-7, 1.0 - 1e-7, generator=gen)

    def cdf(x):  # enclosed-mass fraction at x = R / Rd
        return 1.0 - (1.0 + x) * torch.exp(-x)

    lo = torch.zeros(n, dtype=f64)
    hi = torch.full((n,), 30.0, dtype=f64)
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        below = cdf(mid) < u
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    radius = 0.5 * (lo + hi) * scale_length

    phi = torch.empty(n, dtype=f64).uniform_(0.0, 2.0 * math.pi,
                                             generator=gen)
    z = scale_height * torch.randn(n, dtype=f64, generator=gen)
    positions = torch.stack(
        [radius * torch.cos(phi), radius * torch.sin(phi), z], dim=1)

    m_enc = bulge_mass + disk_mass * cdf(radius / scale_length)
    v_circ = torch.sqrt(g * m_enc / torch.clamp_min(radius,
                                                     1e-3 * scale_length))
    sigma_v = 0.05 * v_circ  # mild velocity dispersion
    noise = torch.randn(n, 3, dtype=f64, generator=gen)
    velocities = torch.stack(
        [
            -v_circ * torch.sin(phi) + sigma_v * noise[:, 0],
            v_circ * torch.cos(phi) + sigma_v * noise[:, 1],
            0.2 * sigma_v * noise[:, 2],
        ],
        dim=1,
    )

    # Particle 0 is the bulge point mass at rest; the rest share disk_mass.
    masses = torch.full((n,), disk_mass / (n - 1), dtype=f64)
    masses[0] = bulge_mass
    positions[0] = 0.0
    velocities[0] = 0.0
    return ParticleState(positions, velocities, masses).astype(dtype).to(device)
