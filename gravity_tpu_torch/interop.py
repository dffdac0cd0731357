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


def state_from_numpy(positions, velocities, masses, *,
                     dtype: torch.dtype = torch.float32,
                     device: DeviceLike = None) -> ParticleState:
    """(N, 3), (N, 3) and (N,) array-likes -> a state on ``device``."""
    dev = resolve_device(device)
    return ParticleState.create(
        torch.from_numpy(np.array(positions)),
        torch.from_numpy(np.array(velocities)),
        torch.from_numpy(np.array(masses)),
        dtype=dtype, device=dev,
    )


def state_to_numpy(state: ParticleState):
    """-> (positions, velocities, masses) as host numpy arrays."""
    return tuple(
        t.detach().cpu().numpy()
        for t in (state.positions, state.velocities, state.masses)
    )
