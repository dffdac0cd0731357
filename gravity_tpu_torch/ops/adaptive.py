"""Adaptive global time stepping.

Counterpart of ``gravity_tpu/ops/adaptive.py``. Each step, dt is chosen
from the current state and the whole system advances by one KDK leapfrog
of that size (or by an outer multirate step: ``step_fn``). Two criteria:

- **acceleration**: ``dt = eta * sqrt(eps / max|a|)``, with the softening
  length ``eps`` as the resolution scale;
- **velocity**: ``dt = eta * min(|v| / |a|)``, scale-free.

Zero-mass particles are excluded from both criteria: a sharded state
pads with zero-mass bodies, which must not drive the global dt. On a mesh
the criterion reads the whole state (``gather``, the per-body |a| or
timescale gathered in rank order after the mask), so every rank takes the
same dt, the unsharded run's on a world of one.

The JAX package runs the steps in a device ``lax.while_loop`` that stops
at ``t_end``. Here :func:`adaptive_run` takes up to ``max_steps`` steps in
blocks of ``block`` with no host read inside a block: every step computes
its dt, time and counters as device scalars, and a step taken once ``t >=
t_end`` is an exact no-op (dt 0; the state, the carried acceleration,
``t``, the compensation, ``dt_min``/``dt_max_used`` and the step count
all kept by ``torch.where``). Between blocks one host read of ``t <
t_end`` stops the loop, so a call costs at most one block of such tail
steps past ``t_end`` whatever its ``max_steps``, and the results equal
JAX's. The Simulator sizes each call as one block to keep the tail short
(``simulation.Simulator.run_adaptive``), and the first steps of a call
that are active whatever dt comes out (:func:`sure_steps`, about
``(t_end - t0) / dt_max``) skip the gates.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..state import ParticleState
from .forces import rounded, tiny
from .integrators import AccelFn, leapfrog_kdk

# Steps between two host reads of ``t < t_end`` in :func:`adaptive_run`.
BLOCK = 64


def _norm(x: torch.Tensor) -> torch.Tensor:
    """|x| over the last axis as sqrt(sum(x * x)), jnp.linalg.norm's form."""
    return torch.sqrt((x * x).sum(dim=-1))


def acceleration_timestep(acc, *, eta: float, eps: float, dt_max: float,
                          mask=None, exclude_fastest: int = 0, gather=None):
    """``eta * sqrt(eps / max|a|)``, clipped to (0, dt_max], as a device
    scalar. ``mask`` (bool (N,)) keeps the real particles;
    ``exclude_fastest`` drops the k largest |a| first (the multirate
    composition: those k are sub-cycled, so they must not size the outer
    step); ``gather`` maps a rank's (n_local,) values to the whole
    state's."""
    dtype = acc.dtype
    a = _norm(acc)
    if mask is not None:
        a = torch.where(mask, a, torch.zeros_like(a))
    if gather is not None:
        a = gather(a)
    if exclude_fastest > 0:
        kk = min(exclude_fastest, a.shape[0] - 1)
        amax = torch.kthvalue(a, a.shape[0] - kk).values
    else:
        amax = a.max()
    # eps / amax as a tensor division: torch takes ``float / tensor`` as
    # tensor.reciprocal() * float, two roundings where JAX has one.
    dt = rounded(eta, dtype) * torch.sqrt(
        torch.full_like(amax, rounded(eps, dtype))
        / torch.clamp_min(amax, tiny(dtype)))
    return torch.clamp_max(dt, rounded(dt_max, dtype))


def velocity_timestep(vel, acc, *, eta: float, dt_max: float, mask=None,
                      exclude_fastest: int = 0, gather=None):
    """``eta * min(|v| / |a|)``, clipped to (0, dt_max], as a device
    scalar; ``exclude_fastest`` drops the k smallest timescales first;
    ``gather`` as :func:`acceleration_timestep`'s."""
    dtype = vel.dtype
    ratio = _norm(vel) / torch.clamp_min(_norm(acc), tiny(dtype))
    if mask is not None:
        ratio = torch.where(mask, ratio, torch.full_like(ratio, math.inf))
    if gather is not None:
        ratio = gather(ratio)
    if exclude_fastest > 0:
        kk = min(exclude_fastest, ratio.shape[0] - 1)
        # A picked inf (fewer real particles than the exclusion) gives
        # min(eta * inf, dt_max) = dt_max, the unconstrained step.
        dt_min_kept = torch.kthvalue(ratio, kk + 1).values
    else:
        dt_min_kept = ratio.min()
    dt = rounded(eta, dtype) * dt_min_kept
    return torch.clamp_max(dt, rounded(dt_max, dtype))


class AdaptiveResult(NamedTuple):
    state: ParticleState
    acc: torch.Tensor
    t: torch.Tensor  # simulated time reached (== t_end unless max_steps hit)
    steps: torch.Tensor  # KDK steps taken this call (int64)
    dt_min: torch.Tensor  # smallest dt used this call (inf if none)
    dt_max_used: torch.Tensor  # largest dt used this call (0 if none)
    comp: torch.Tensor  # Kahan compensation for t (pass back as comp0)


def make_timestep_fn(
    criterion: str, *, eta: float, eps: float, dt_max: float,
    exclude_fastest: int = 0, gather=None,
) -> Callable:
    """(state, acc) -> dt for a named criterion ('accel' | 'velocity');
    ``gather`` for a rank's rows of a sharded state."""
    if criterion == "accel":
        if eps <= 0.0:
            raise ValueError(
                "the 'accel' criterion needs a softening length eps > 0 "
                "as its resolution scale; use criterion='velocity' for "
                "unsoftened runs"
            )
        return lambda state, acc: acceleration_timestep(
            acc, eta=eta, eps=eps, dt_max=dt_max, mask=state.masses > 0,
            exclude_fastest=exclude_fastest, gather=gather,
        )
    if criterion == "velocity":
        return lambda state, acc: velocity_timestep(
            state.velocities, acc, eta=eta, dt_max=dt_max,
            mask=state.masses > 0, exclude_fastest=exclude_fastest,
            gather=gather,
        )
    raise ValueError(
        f"unknown timestep criterion {criterion!r}; "
        "choose 'accel' or 'velocity'"
    )


def sure_steps(t0: float, *, t_end: float, dt_max: float,
               dtype: torch.dtype) -> int:
    """Steps from host time ``t0`` that are active whatever dt the
    criterion gives: each step advances t by at most dt_max, so the
    first floor((t_end - t0) / dt_max) steps start before t_end, less a
    margin of one step and two ulp of t_end in ``dtype`` for the
    rounding of t and dt."""
    if not t0 < t_end:
        return 0
    margin = 1 + math.ceil(2 * torch.finfo(dtype).eps * abs(t_end) / dt_max)
    return max(0, math.floor((t_end - t0) / dt_max) - margin)


def adaptive_run(
    state: ParticleState,
    accel_fn: AccelFn,
    *,
    t_end: float,
    dt_max: float,
    eta: float = 0.025,
    eps: float = 0.0,
    criterion: str = "accel",
    max_steps: int = 1_000_000,
    dt_min_frac: float = 1e-6,
    t0=0.0,
    comp0=0.0,
    acc0: Optional[torch.Tensor] = None,
    step_fn: Optional[Callable] = None,
    exclude_fastest: int = 0,
    gather: Optional[Callable] = None,
    block: int = BLOCK,
) -> AdaptiveResult:
    """Up to ``max_steps`` adaptive KDK steps towards ``t_end``.

    The JAX function's contract: ``dt = min(max(criterion, dt_min_frac *
    dt_max), t_end - t)``, so the last step lands on ``t_end``; ``t``
    accumulates with Kahan compensation in the state's dtype; pass the
    returned ``(state, t, comp, acc)`` back as ``(state, t0, comp0,
    acc0)`` to continue. ``step_fn(state, acc, dt) -> (state, new_acc)``
    replaces the KDK step (the multirate composition; pass
    ``exclude_fastest`` = its fast capacity). On a mesh ``state`` is a
    rank's rows and ``gather`` brings the criterion's per-body values of
    every rank (``make_timestep_fn``).

    No step reads the device on the host; steps past ``t_end`` are exact
    no-ops, and the loop stops after the first block of ``block`` steps
    that ends at ``t_end`` (module docstring). ``t0`` and ``comp0`` may be
    Python floats or device scalars; a Python ``t0`` lets the call's
    sure-active prefix (:func:`sure_steps`) skip the gates."""
    dt_fn = make_timestep_fn(
        criterion, eta=eta, eps=eps, dt_max=dt_max,
        exclude_fastest=exclude_fastest, gather=gather,
    )
    dtype, device = state.dtype, state.device
    if acc0 is None:
        acc0 = accel_fn(state.positions)
    t_end_c = rounded(t_end, dtype)
    dt_floor = rounded(dt_min_frac * dt_max, dtype)
    n_sure = 0
    if not isinstance(t0, torch.Tensor):
        n_sure = min(max_steps, sure_steps(float(t0), t_end=t_end_c,
                                           dt_max=dt_max, dtype=dtype))

    def scalar(value):
        if isinstance(value, torch.Tensor):
            return value.to(device=device, dtype=dtype)
        return torch.full((), value, dtype=dtype, device=device)

    st, acc = state, acc0
    t, comp = scalar(t0), scalar(comp0)
    dmin = torch.full((), math.inf, dtype=dtype, device=device)
    dmax = torch.zeros((), dtype=dtype, device=device)
    steps = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(max_steps):
        if i > n_sure and i % block == 0 and not bool(t < t_end_c):
            break  # the block's one host read: the rest would be no-ops
        dt = torch.minimum(torch.clamp_min(dt_fn(st, acc), dt_floor),
                           t_end_c - t)
        gated = i >= n_sure
        if gated:
            active = t < t_end_c
            dt = torch.where(active, dt, torch.zeros_like(dt))
        if step_fn is None:
            new_st, new_acc = leapfrog_kdk(st, dt, accel_fn, acc)
        else:
            new_st, new_acc = step_fn(st, acc, dt)
        # Kahan-compensated t += dt: dt can fall far below ulp(t).
        y = dt - comp
        t_new = t + y
        comp_new = (t_new - t) - y
        dmin_new = torch.minimum(dmin, dt)
        dmax_new = torch.maximum(dmax, dt)
        if gated:
            def keep(new, old):
                return torch.where(active, new, old)

            st = st.replace(positions=keep(new_st.positions, st.positions),
                            velocities=keep(new_st.velocities,
                                            st.velocities))
            acc = keep(new_acc, acc)
            t, comp = keep(t_new, t), keep(comp_new, comp)
            dmin, dmax = keep(dmin_new, dmin), keep(dmax_new, dmax)
            steps = steps + active.to(torch.int64)
        else:
            st, acc, t, comp = new_st, new_acc, t_new, comp_new
            dmin, dmax = dmin_new, dmax_new
            steps = steps + 1
    return AdaptiveResult(st, acc, t, steps, dmin, dmax, comp)
