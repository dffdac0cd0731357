"""Uniform random-cube initial conditions — the reference's random filler.

Counterpart of ``gravity_tpu/models/random_cube.py``:
pos ~ U(-3e11, 3e11)^3, vel ~ U(-3e4, 3e4)^3, mass ~ U(1e23, 1e25), with
the solar seed first. The numbers come from a CPU ``torch.Generator``
and are then moved to the device, so the initial state does not depend
on the device. They differ from ``jax.random``'s; parity tests hand both
packages the same numpy state instead (``interop.state_from_numpy``).
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..state import ParticleState
from .solar import create_solar_system


def _uniform(gen: torch.Generator, shape, low: float, high: float, dtype):
    return torch.empty(shape, dtype=dtype).uniform_(low, high, generator=gen)


def generate_random_particles(
    gen: torch.Generator, n: int, dtype=torch.float32, device="cpu"
) -> ParticleState:
    if gen.device.type != "cpu":
        raise ValueError("initial conditions are drawn from a CPU generator")
    positions = _uniform(
        gen, (n, 3), -C.RANDOM_POS_BOUND, C.RANDOM_POS_BOUND, dtype
    )
    velocities = _uniform(
        gen, (n, 3), -C.RANDOM_VEL_BOUND, C.RANDOM_VEL_BOUND, dtype
    )
    masses = _uniform(gen, (n,), C.RANDOM_MASS_LOW, C.RANDOM_MASS_HIGH, dtype)
    return ParticleState(positions, velocities, masses).to(device)


def create_random_cube(
    gen: torch.Generator, n: int, *, include_solar: bool = True,
    dtype=torch.float32, device="cpu",
) -> ParticleState:
    """Solar seed padded with random particles up to N total — the IC used
    by every reference ``main``."""
    if not include_solar:
        return generate_random_particles(gen, n, dtype=dtype, device=device)
    solar = create_solar_system(dtype=dtype, device=device)
    if n < solar.n:
        raise ValueError(f"n={n} smaller than solar seed ({solar.n})")
    if n == solar.n:
        return solar
    rand = generate_random_particles(gen, n - solar.n, dtype=dtype,
                                     device=device)
    return ParticleState.concatenate([solar, rand])
