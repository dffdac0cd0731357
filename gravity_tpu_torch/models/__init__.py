"""Initial-condition model families.

Counterpart of ``gravity_tpu/models/__init__.py``. Ported: the two
reference models, ``solar`` and ``random``, the galaxy ``disk`` and
``merger``, the spheres ``plummer``, ``cold_collapse`` and
``hernquist``, and the cosmological ``grf``, whose lattice period follows
the run's periodic box.
"""

from __future__ import annotations

import torch

from .cold_collapse import create_cold_collapse
from .disk import create_disk
from .grf import (
    create_grf,
    grf_displacement_fields,
    grf_lattice,
    grf_side,
    second_order_displacements,
    zeldovich_displacements,
)
from .hernquist import create_hernquist
from .merger import create_merger
from .plummer import create_plummer
from .random_cube import create_random_cube, generate_random_particles
from .solar import create_solar_system


def _solar(gen, n, dtype, device, **kw):
    if n != 3:
        raise ValueError(
            f"model 'solar' has exactly 3 bodies; got n={n}. "
            "Use --n 3, or model 'random' for solar seed + random filler."
        )
    return create_solar_system(dtype=dtype, device=device)


def _factory(create):
    def model(gen, n, dtype, device, **kw):
        return create(gen, n, dtype=dtype, device=device)

    return model


def _grf(gen, n, dtype, device, periodic_box: float = 0.0, **kw):
    """grf honours the run's periodic box, so that the lattice period and
    the solver's period cannot disagree (0.0: the factory's default
    box)."""
    extra = {"box": periodic_box} if periodic_box > 0.0 else {}
    return create_grf(gen, n, dtype=dtype, device=device, **extra)


MODELS = {
    "solar": _solar,
    "random": _factory(create_random_cube),
    "plummer": _factory(create_plummer),
    "cold_collapse": _factory(create_cold_collapse),
    "disk": _factory(create_disk),
    "grf": _grf,
    "hernquist": _factory(create_hernquist),
    "merger": _factory(create_merger),
}


def create_model(name: str, gen: torch.Generator, n: int, dtype,
                 device="cpu", **kwargs):
    """``kwargs`` carries run-level context a factory may honour (the
    ``periodic_box`` of the grf lattice)."""
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; choose from {sorted(MODELS)}")
    return MODELS[name](gen, n, dtype, device, **kwargs)


__all__ = [
    "MODELS",
    "create_cold_collapse",
    "create_disk",
    "create_grf",
    "grf_displacement_fields",
    "grf_lattice",
    "grf_side",
    "second_order_displacements",
    "zeldovich_displacements",
    "create_hernquist",
    "create_merger",
    "create_model",
    "create_plummer",
    "create_random_cube",
    "create_solar_system",
    "generate_random_particles",
]
