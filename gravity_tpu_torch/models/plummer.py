"""Plummer-sphere initial conditions (the ``baseline-16k`` model).

Counterpart of ``gravity_tpu/models/plummer.py``: Aarseth-Henon-Wielen
sampling of the Plummer (1911) profile in virial equilibrium, in SI
units (total mass 1e30 kg, scale radius 1e12 m). Radii by the inverse
of the enclosed-mass CDF, isotropic directions, speeds q v_esc with q
drawn by the same 8-round von Neumann accept/resample on
g(q) = q^2 (1 - q^2)^(7/2), then positions and velocities re-centred
exactly.

The numbers come from a CPU ``torch.Generator`` in float64; the state is
then rounded to ``dtype`` and moved to the device. The draws differ from
``jax.random``'s. The JAX package draws in float32 unless x64 is on, so
its largest radius quantile is 1 - 2^-24 and its tail stops near
5,000 a, where this one reaches ~12,000 a. The profile's <r^2> diverges
logarithmically, so the two packages agree on Lagrangian radii, the
virial ratio and the velocity dispersion, not on second moments of r.
"""

from __future__ import annotations

import math

import torch

from ..constants import G
from ..state import ParticleState
from ._draw import centred, isotropic, uniform

# Accept/resample rounds for q: the reject probability after 8 is ~1e-8.
Q_ROUNDS = 8


def create_plummer(
    gen: torch.Generator,
    n: int,
    *,
    total_mass: float = 1.0e30,
    scale_radius: float = 1.0e12,
    g: float = G,
    dtype=torch.float32,
    device="cpu",
) -> ParticleState:
    if gen.device.type != "cpu":
        raise ValueError("initial conditions are drawn from a CPU generator")
    # Radius from the enclosed-mass fraction X:
    # M(r)/M = (1 + (a/r)^2)^(-3/2)  =>  r = a / sqrt(X^(-2/3) - 1).
    x = uniform(gen, n, 1e-8, 1.0 - 1e-8)
    r = scale_radius / torch.sqrt(x ** (-2.0 / 3.0) - 1.0)
    positions = r[:, None] * isotropic(gen, n)

    q = torch.full((n,), 0.5, dtype=torch.float64)
    ok = torch.zeros(n, dtype=torch.bool)
    for _ in range(Q_ROUNDS):
        q_new = uniform(gen, n, 0.0, 1.0)
        y = uniform(gen, n, 0.0, 0.1)
        accept = y < q_new**2 * (1.0 - q_new**2) ** 3.5
        q = torch.where(accept & ~ok, q_new, q)
        ok = ok | accept
    v_esc = math.sqrt(2.0 * g * total_mass) * (
        r * r + scale_radius * scale_radius) ** -0.25
    velocities = (q * v_esc)[:, None] * isotropic(gen, n)

    masses = torch.full((n,), total_mass / n, dtype=torch.float64)
    return centred(positions, velocities, masses, dtype, device)
