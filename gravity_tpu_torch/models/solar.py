"""Solar-system seed: Sun, Earth, Mars — the exact reference constants.

Counterpart of ``gravity_tpu/models/solar.py``.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..state import ParticleState


def create_solar_system(dtype=torch.float32, device="cpu") -> ParticleState:
    positions = torch.tensor(
        [
            [0.0, 0.0, 0.0],  # Sun
            [C.EARTH_ORBIT_RADIUS, 0.0, 0.0],  # Earth
            [C.MARS_ORBIT_RADIUS, 0.0, 0.0],  # Mars
        ],
        dtype=dtype, device=device,
    )
    velocities = torch.tensor(
        [
            [0.0, 0.0, 0.0],
            [0.0, C.EARTH_ORBIT_SPEED, 0.0],
            [0.0, C.MARS_ORBIT_SPEED, 0.0],
        ],
        dtype=dtype, device=device,
    )
    masses = torch.tensor(
        [C.SUN_MASS, C.EARTH_MASS, C.MARS_MASS], dtype=dtype, device=device
    )
    return ParticleState(positions, velocities, masses)
