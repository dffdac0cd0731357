"""Initial-condition model families.

Counterpart of ``gravity_tpu/models/__init__.py``. Ported: the two
reference models, ``solar`` and ``random``, the galaxy ``disk`` and
``merger``, and the spheres ``plummer``, ``cold_collapse`` and
``hernquist``. ``grf`` comes with the periodic family (ROADMAP Queue 1
item 7): its lattice period follows the run's periodic box.
"""

from __future__ import annotations

import torch

from ..config import NotPortedError, _UNPORTED_VALUES
from .cold_collapse import create_cold_collapse
from .disk import create_disk
from .hernquist import create_hernquist
from .merger import create_merger
from .plummer import create_plummer
from .random_cube import create_random_cube, generate_random_particles
from .solar import create_solar_system

_NOT_PORTED, _NOT_PORTED_ITEM = _UNPORTED_VALUES["model"]


def _solar(gen, n, dtype, device):
    if n != 3:
        raise ValueError(
            f"model 'solar' has exactly 3 bodies; got n={n}. "
            "Use --n 3, or model 'random' for solar seed + random filler."
        )
    return create_solar_system(dtype=dtype, device=device)


def _factory(create):
    def model(gen, n, dtype, device):
        return create(gen, n, dtype=dtype, device=device)

    return model


MODELS = {
    "solar": _solar,
    "random": _factory(create_random_cube),
    "plummer": _factory(create_plummer),
    "cold_collapse": _factory(create_cold_collapse),
    "disk": _factory(create_disk),
    "hernquist": _factory(create_hernquist),
    "merger": _factory(create_merger),
}


def create_model(name: str, gen: torch.Generator, n: int, dtype,
                 device="cpu"):
    if name in _NOT_PORTED:
        raise NotPortedError(
            f"model {name!r} is not ported to gravity_tpu_torch yet "
            f"({_NOT_PORTED_ITEM})"
        )
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; choose from {sorted(MODELS)}")
    return MODELS[name](gen, n, dtype, device)


__all__ = [
    "MODELS",
    "create_cold_collapse",
    "create_disk",
    "create_hernquist",
    "create_merger",
    "create_model",
    "create_plummer",
    "create_random_cube",
    "create_solar_system",
    "generate_random_particles",
]
