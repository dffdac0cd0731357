"""Time integrators.

Counterpart of ``gravity_tpu/ops/integrators.py``. Semi-implicit Euler —
velocity first, then position with the *new* velocity — is the
reference's integrator and the parity one. Leapfrog KDK, velocity Verlet
and the 4th-order Yoshida composition are the other three. Each is a
function ``(state, dt, accel_fn[, acc]) -> state | (state, acc)`` that
builds new tensors and leaves its inputs alone.

Every scalar step size is rounded to the state's dtype where it is used,
as JAX rounds a weak-typed Python float: a bf16 state steps with
bf16(dt), bf16(dt / 2) and bf16(w dt). PyTorch would otherwise multiply
a bf16 tensor by the unrounded float in fp32 and round once (at dt =
2e-3 the two step sizes differ by ~5e-4 relative). For float32 and
float64 the rounding changes nothing.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..state import ParticleState
from .forces import rounded

# accel_fn(positions (N, 3)) -> accelerations (N, 3). Masses are closed
# over by the force backend.
AccelFn = Callable[[torch.Tensor], torch.Tensor]


def _step(value, state: ParticleState):
    """``value`` rounded to the state's dtype, as JAX rounds a weak-typed
    Python scalar. A tensor step size (the adaptive loop's device ``dt``)
    is taken as it is, in the state's dtype, never read on the host."""
    if isinstance(value, torch.Tensor):
        return value.to(state.dtype)
    return rounded(float(value), state.dtype)


def _euler_update(state: ParticleState, acc, dt) -> ParticleState:
    """v += a * dt; x += v_new * dt — the reference's exact update order."""
    dt = _step(dt, state)
    new_v = state.velocities + acc * dt
    new_x = state.positions + new_v * dt
    return state.replace(positions=new_x, velocities=new_v)


def semi_implicit_euler(
    state: ParticleState, dt, accel_fn: AccelFn
) -> ParticleState:
    """Semi-implicit (symplectic) Euler — reference parity."""
    return _euler_update(state, accel_fn(state.positions), dt)


def leapfrog_kdk(
    state: ParticleState,
    dt,
    accel_fn: AccelFn,
    acc: Optional[torch.Tensor] = None,
) -> tuple[ParticleState, torch.Tensor]:
    """Kick-drift-kick leapfrog; returns (state, acc_at_new_positions).

    Passing the previous step's closing accelerations as ``acc`` makes the
    opening kick free, so a step costs one force evaluation."""
    if acc is None:
        acc = accel_fn(state.positions)
    half = _step(0.5 * dt, state)
    dt = _step(dt, state)
    v_half = state.velocities + acc * half
    new_x = state.positions + v_half * dt
    new_acc = accel_fn(new_x)
    new_v = v_half + new_acc * half
    return state.replace(positions=new_x, velocities=new_v), new_acc


def velocity_verlet(
    state: ParticleState,
    dt,
    accel_fn: AccelFn,
    acc: Optional[torch.Tensor] = None,
) -> tuple[ParticleState, torch.Tensor]:
    """Velocity Verlet (algebraically equivalent to KDK)."""
    if acc is None:
        acc = accel_fn(state.positions)
    dt = _step(dt, state)
    new_x = state.positions + state.velocities * dt + 0.5 * acc * dt * dt
    new_acc = accel_fn(new_x)
    new_v = state.velocities + 0.5 * (acc + new_acc) * dt
    return state.replace(positions=new_x, velocities=new_v), new_acc


# Yoshida (1990) 4th-order symplectic composition coefficients: three
# leapfrog sub-steps of sizes (w1, w0, w1)*dt with w0 negative.
_Y4_W1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_Y4_W0 = 1.0 - 2.0 * _Y4_W1


def yoshida4(
    state: ParticleState,
    dt,
    accel_fn: AccelFn,
    acc: Optional[torch.Tensor] = None,
) -> tuple[ParticleState, torch.Tensor]:
    """4th-order symplectic (Yoshida) integrator; returns (state, acc).

    Three KDK sub-steps of (w1, w0, w1)*dt; three force evaluations per
    step, the closing kick of each sub-step being the opening kick of the
    next."""
    if acc is None:
        acc = accel_fn(state.positions)
    for w in (_Y4_W1, _Y4_W0, _Y4_W1):
        state, acc = leapfrog_kdk(state, w * dt, accel_fn, acc)
    return state, acc


INTEGRATORS = {
    "euler": semi_implicit_euler,
    "leapfrog": leapfrog_kdk,
    "verlet": velocity_verlet,
    "yoshida4": yoshida4,
}

# Net force evaluations per step under the carried-acc scheme of
# make_step_fn; used for throughput accounting (pairs/s).
FORCE_EVALS_PER_STEP = {
    "euler": 1,
    "leapfrog": 1,
    "verlet": 1,
    "yoshida4": 3,
    # One full (N, N) evaluation an outer step; the rectangular (K, N)
    # fast kicks are not counted, so the reported pairs/s is conservative.
    "multirate": 1,
}


def make_step_fn(integrator: str, accel_fn: AccelFn, dt):
    """Build ``(state, acc) -> (state, acc)``, uniform across integrators.

    Seed the carried ``acc`` with :func:`init_carry`. Semi-implicit Euler
    recomputes it each step; leapfrog/verlet/yoshida4 reuse it."""
    if integrator == "euler":

        def step(state, acc):
            del acc
            acc_here = accel_fn(state.positions)
            return _euler_update(state, acc_here, dt), acc_here

        return step
    if integrator in ("leapfrog", "verlet", "yoshida4"):
        fn = INTEGRATORS[integrator]

        def step(state, acc):
            return fn(state, dt, accel_fn, acc)

        return step
    raise ValueError(
        f"unknown integrator {integrator!r}; choose from {sorted(INTEGRATORS)}"
    )


def init_carry(accel_fn: AccelFn, state: ParticleState) -> torch.Tensor:
    """Initial carried accelerations for :func:`make_step_fn` step loops."""
    return accel_fn(state.positions)
