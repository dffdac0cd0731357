"""Cold-collapse initial conditions: a uniform ball (at rest by default).

Counterpart of ``gravity_tpu/models/cold_collapse.py``: radii R U^(1/3),
isotropic directions, velocities ``velocity_dispersion`` times a normal
draw (0 by default), then re-centred. The JAX version draws directly in
``dtype``; this one draws in float64 from a CPU ``torch.Generator`` and
rounds once at the end, so its numbers are its own (compare
distributions, or hand both packages one state through ``interop``).
"""

from __future__ import annotations

import torch

from ..state import ParticleState
from ._draw import centred, isotropic, uniform


def create_cold_collapse(
    gen: torch.Generator,
    n: int,
    *,
    total_mass: float = 1.0e33,
    radius: float = 1.0e13,
    velocity_dispersion: float = 0.0,
    dtype=torch.float32,
    device="cpu",
) -> ParticleState:
    if gen.device.type != "cpu":
        raise ValueError("initial conditions are drawn from a CPU generator")
    r = radius * uniform(gen, n, 0.0, 1.0) ** (1.0 / 3.0)
    positions = r[:, None] * isotropic(gen, n)
    velocities = velocity_dispersion * torch.randn(
        n, 3, dtype=torch.float64, generator=gen)
    masses = torch.full((n,), total_mass / n, dtype=torch.float64)
    return centred(positions, velocities, masses, dtype, device)
