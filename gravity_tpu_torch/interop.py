"""State carried across packages as numpy arrays.

The port draws its random initial conditions from ``torch.Generator``,
which cannot reproduce ``jax.random``'s numbers. These two functions let
a state made anywhere (a gravity_tpu ``ParticleState`` fetched with
``np.asarray``, a file, a test's seeded numpy draw) become this
package's state and back, so both packages integrate the identical
initial condition. The JAX package has no counterpart module.
"""

from __future__ import annotations

import numpy as np
import torch

from .state import ParticleState
from .utils.platform import DeviceLike, resolve_device


def _from_array(a) -> torch.Tensor:
    """An array-like as a CPU tensor. numpy has no bfloat16 of its own: an
    array of the ``ml_dtypes`` bfloat16 (what ``np.asarray`` of a JAX bf16
    array gives) goes through float32, which holds every bf16 value
    exactly."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def state_from_numpy(positions, velocities, masses, *,
                     dtype: torch.dtype = torch.float32,
                     device: DeviceLike = None) -> ParticleState:
    """(N, 3), (N, 3) and (N,) array-likes -> a state on ``device``."""
    dev = resolve_device(device)
    return ParticleState.create(
        _from_array(positions), _from_array(velocities), _from_array(masses),
        dtype=dtype, device=dev,
    )


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; a bf16 tensor as float32 (exact),
    as the JAX package's trajectory writer stores it."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def state_to_numpy(state: ParticleState):
    """-> (positions, velocities, masses) as host numpy arrays (float32
    for a bf16 state)."""
    return tuple(to_numpy(t) for t in
                 (state.positions, state.velocities, state.masses))
