"""The port's integrators against ``gravity_tpu.ops.integrators``.

Both sides integrate the same numpy initial state with their own plain
direct sum, through ``make_step_fn`` and ``init_carry``, in fp64.
Tolerance: rtol 1e-12 on each particle's position and velocity vector —
the two force sums differ by a few ulp per step, and 20 steps of a
16-body system do not amplify that past 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.ops import integrators as jax_integrators
from gravity_tpu.ops.forces import accelerations_vs as jax_accelerations_vs
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch.interop import state_from_numpy, state_to_numpy
from gravity_tpu_torch.ops import integrators
from gravity_tpu_torch.ops.forces import accelerations_vs

DT = 3600.0


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _initial_state(n=16, seed=1):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3e11, 3e11, (n, 3))
    vel = rng.uniform(-3e4, 3e4, (n, 3))
    masses = rng.uniform(1e23, 1e25, n)
    masses[0] = 1.989e30  # a Sun, so the orbits bend within 20 steps
    pos[0] = 0.0
    vel[0] = 0.0
    return pos, vel, masses


def _rows_close(got, want, rtol):
    err = np.linalg.norm(got - want, axis=1)
    scale = np.linalg.norm(want, axis=1)
    assert np.all(err <= rtol * scale), float(np.max(err / scale))


@pytest.mark.parametrize("steps", [1, 20])
@pytest.mark.parametrize("name", ["euler", "leapfrog", "verlet", "yoshida4"])
def test_matches_jax_integrator(x64, name, steps):
    pos, vel, masses = _initial_state()

    jm = jnp.asarray(masses)
    jstate = JaxState(jnp.asarray(pos), jnp.asarray(vel), jm)
    jaccel = lambda p: jax_accelerations_vs(p, p, jm)  # noqa: E731
    jstep = jax.jit(jax_integrators.make_step_fn(name, jaccel, DT))
    jacc = jax_integrators.init_carry(jaccel, jstate)

    state = state_from_numpy(pos, vel, masses, dtype=torch.float64,
                             device="cpu")
    accel = lambda p: accelerations_vs(p, p, state.masses)  # noqa: E731
    step = integrators.make_step_fn(name, accel, DT)
    acc = integrators.init_carry(accel, state)

    for _ in range(steps):
        jstate, jacc = jstep(jstate, jacc)
        state, acc = step(state, acc)
    got_pos, got_vel, _ = state_to_numpy(state)
    _rows_close(got_pos, np.asarray(jstate.positions), 1e-12)
    _rows_close(got_vel, np.asarray(jstate.velocities), 1e-12)
    _rows_close(acc.numpy(), np.asarray(jacc), 1e-12)


def test_euler_is_velocity_then_position():
    """The reference's order: x advances with the NEW velocity."""
    pos, vel, masses = _initial_state(n=4)
    state = state_from_numpy(pos, vel, masses, dtype=torch.float64,
                             device="cpu")
    acc = accelerations_vs(state.positions, state.positions, state.masses)
    new = integrators.semi_implicit_euler(
        state, DT, lambda p: accelerations_vs(p, p, state.masses)
    )
    want_v = state.velocities + acc * DT
    assert torch.equal(new.velocities, want_v)
    assert torch.equal(new.positions, state.positions + want_v * DT)


def test_force_evals_per_step_and_unknown_integrator():
    # Every JAX entry, multirate's included (ops/multirate.py).
    assert (integrators.FORCE_EVALS_PER_STEP
            == jax_integrators.FORCE_EVALS_PER_STEP)
    with pytest.raises(ValueError, match="unknown integrator"):
        integrators.make_step_fn("rk4", lambda p: p, DT)
