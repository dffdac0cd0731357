"""Initial-condition model families.

Counterpart of ``gravity_tpu/models/__init__.py``. Ported: the two
reference models, ``solar`` and ``random``, and the galaxy ``disk`` of
the P3M run; the others are ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

import torch

from ..config import NotPortedError, _UNPORTED_VALUES
from .disk import create_disk
from .random_cube import create_random_cube, generate_random_particles
from .solar import create_solar_system

_NOT_PORTED = _UNPORTED_VALUES["model"][0]


def _solar(gen, n, dtype, device):
    if n != 3:
        raise ValueError(
            f"model 'solar' has exactly 3 bodies; got n={n}. "
            "Use --n 3, or model 'random' for solar seed + random filler."
        )
    return create_solar_system(dtype=dtype, device=device)


def _random(gen, n, dtype, device):
    return create_random_cube(gen, n, dtype=dtype, device=device)


def _disk(gen, n, dtype, device):
    return create_disk(gen, n, dtype=dtype, device=device)


MODELS = {"solar": _solar, "random": _random, "disk": _disk}


def create_model(name: str, gen: torch.Generator, n: int, dtype,
                 device="cpu"):
    if name in _NOT_PORTED:
        raise NotPortedError(
            f"model {name!r} is not ported to gravity_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 4)"
        )
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; choose from {sorted(MODELS)}")
    return MODELS[name](gen, n, dtype, device)


__all__ = [
    "MODELS",
    "create_disk",
    "create_model",
    "create_random_cube",
    "create_solar_system",
    "generate_random_particles",
]
