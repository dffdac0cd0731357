"""Draws shared by the spherical models: float64 numbers from a CPU
``torch.Generator``, and the exact re-centring of a realization before it
is rounded to its dtype."""

from __future__ import annotations

import math

import torch

from ..state import ParticleState


def uniform(gen: torch.Generator, n: int, low: float,
            high: float) -> torch.Tensor:
    return torch.empty(n, dtype=torch.float64).uniform_(low, high,
                                                        generator=gen)


def isotropic(gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, 3) unit vectors, uniform on the sphere: cos(theta) ~ U(-1, 1),
    phi ~ U(0, 2 pi)."""
    costh = uniform(gen, n, -1.0, 1.0)
    sinth = torch.sqrt(torch.clamp_min(1.0 - costh * costh, 0.0))
    phi = uniform(gen, n, 0.0, 2.0 * math.pi)
    return torch.stack([sinth * torch.cos(phi), sinth * torch.sin(phi),
                        costh], dim=1)


def centred(positions, velocities, masses, dtype, device) -> ParticleState:
    """Subtract the mean position and velocity (in float64), then round
    to ``dtype`` and move to ``device``."""
    positions = positions - positions.mean(dim=0, keepdim=True)
    velocities = velocities - velocities.mean(dim=0, keepdim=True)
    return ParticleState(positions, velocities,
                         masses).astype(dtype).to(device)
