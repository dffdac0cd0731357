"""Two-galaxy merger initial conditions (the ``baseline-2m`` model).

Counterpart of ``gravity_tpu/models/merger.py``: two exponential disks
(:mod:`.disk`) of n//2 and n - n//2 bodies on an approach orbit, offset
by -/+(separation, impact parameter, 0)/2 with +/-(approach speed, 0,
0)/2, the second disk tilted about the x axis by ``inclination``.
Galactic natural units (G = 1, kpc, 1e10 Msun): run it with ``g=1.0``.

Both disks are drawn on the CPU (one generator, first disk first) and
rounded to ``dtype``; the tilt, the offsets and the kicks are then done
on the CPU in ``dtype``, as the JAX version does them in the state's
dtype (``vecs @ rot.T``), so no TF32 product touches them, and the
state moves to the device last.
"""

from __future__ import annotations

import math

import torch

from ..state import ParticleState
from .disk import create_disk


def _rotate_x(vecs: torch.Tensor, angle: float) -> torch.Tensor:
    c, s = math.cos(angle), math.sin(angle)
    rot = torch.tensor([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]],
                       dtype=vecs.dtype)
    return vecs @ rot.T


def create_merger(
    gen: torch.Generator,
    n: int,
    *,
    separation: float = 18.0,        # kpc
    impact_parameter: float = 3.0,   # kpc
    approach_speed: float = 0.7,     # velocity units (~145 km/s)
    inclination: float = 0.5,        # radians, second disk tilt
    dtype=torch.float32,
    device="cpu",
    **disk_kwargs,
) -> ParticleState:
    """N bodies split into two disks on a collision course."""
    n1 = n // 2
    d1 = create_disk(gen, n1, dtype=dtype, **disk_kwargs)
    d2 = create_disk(gen, n - n1, dtype=dtype, **disk_kwargs)
    half_sep = torch.tensor([separation / 2, impact_parameter / 2, 0.0],
                            dtype=dtype)
    dv = torch.tensor([approach_speed / 2, 0.0, 0.0], dtype=dtype)
    merged = ParticleState(
        positions=torch.cat([d1.positions - half_sep,
                             _rotate_x(d2.positions, inclination) + half_sep]),
        velocities=torch.cat([d1.velocities + dv,
                              _rotate_x(d2.velocities, inclination) - dv]),
        masses=torch.cat([d1.masses, d2.masses]),
    )
    return merged.to(device)
