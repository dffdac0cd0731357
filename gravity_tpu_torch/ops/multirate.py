"""Block-timestep (multirate) KDK integration on one card.

Counterpart of the single-card forms of ``gravity_tpu/ops/multirate.py``.
Each outer step, the K particles with the largest |a| (a static
capacity) form the fast rung and are sub-cycled inside one outer KDK
step, their forces re-evaluated against all N sources by a rectangular
(K, N) kernel (``simulation.make_local_kernel``):

    v += a(x) * dt/2            on slow only          (opening slow kick)
    repeat S times:
        v_f += a_f(x) * dt_s/2  fast kick (from all sources)
        x   += v * dt_s         drift everyone
        v_f += a_f(x) * dt_s/2  fast kick
    v += a(x) * dt/2            on slow only          (closing slow kick)

An outer step costs one full evaluation (``accel_full``, the backend's
own) and S rectangular ones; the closing full force is the next step's
carry. :func:`rung_ladder_step` generalises it to R power-of-two rungs.
The scheme is not symplectic and momentum exchange between rungs is not
exactly antisymmetric within a step, as in the JAX package.

The step sizes (dt / S, dt / 2, dt / 2^r, ...) are formed in the state's
dtype as JAX forms them on a dtype array: a Python dt on the CPU, a
device dt (the adaptive loop's) on its device, each by a true division
(the card divides a tensor by a host scalar through its reciprocal,
which can differ in the last bit). The sharded forms belong to ROADMAP
Queue 1 item 5.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..state import ParticleState

# accel_vs(pos_targets (M, 3), pos_sources (N, 3), masses (N,)) -> (M, 3)
AccelVs = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _dt(dt, state: ParticleState) -> torch.Tensor:
    """``dt`` as a 0-dim tensor of the state's dtype: a tensor as is (on
    its device), a Python float on the CPU."""
    if isinstance(dt, torch.Tensor):
        return dt.to(state.dtype)
    return torch.tensor(dt, dtype=state.dtype)


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` in x's dtype, by a true division."""
    return x / torch.full_like(x, n)


def _factor(x: torch.Tensor):
    """A step size as a multiplier: a CPU scalar as its exact Python
    float (no host-to-device copy), a device scalar as it is."""
    return x.item() if x.device.type == "cpu" else x


def select_fast(acc, masses, *, k: int):
    """Indices of the k highest-|a| massive particles (the fast rung),
    highest first. Zero-mass particles score -1 and never go fast."""
    a = torch.sqrt((acc * acc).sum(dim=-1))
    a = torch.where(masses > 0, a, torch.full_like(a, -1.0))
    return torch.topk(a, k).indices


def _slow_weight(fast_idx, state: ParticleState) -> torch.Tensor:
    """(N, 1): 0 on the fast set, 1 elsewhere, in the state's dtype."""
    w = torch.ones(state.n, dtype=state.dtype, device=state.device)
    return w.index_fill(0, fast_idx, 0.0)[:, None]


def two_rung_step(
    state: ParticleState,
    acc: torch.Tensor,
    dt,
    *,
    accel_vs: AccelVs,
    k: int,
    n_sub: int = 4,
    accel_full: Optional[Callable] = None,
) -> tuple[ParticleState, torch.Tensor]:
    """One outer step of the two-rung scheme; returns (state, new_acc).

    ``acc`` is the full-force carry at the current positions; ``new_acc``
    the full force at the new positions. ``accel_full(positions,
    masses)`` is the closing evaluation (default ``accel_vs(pos, pos,
    masses)``)."""
    if n_sub < 1:
        raise ValueError(f"n_sub must be >= 1, got {n_sub}")
    if accel_full is None:
        accel_full = lambda pos, m: accel_vs(pos, pos, m)  # noqa: E731
    masses = state.masses
    dt = _dt(dt, state)
    dt_s = _div(dt, n_sub)
    half, half_s = _factor(0.5 * dt), _factor(0.5 * dt_s)
    dt_s = _factor(dt_s)

    fast_idx = select_fast(acc, masses, k=k)
    slow_w = _slow_weight(fast_idx, state)
    x, v = state.positions, state.velocities

    # Opening slow kick with the carried full force.
    v = v + slow_w * acc * half
    a_f = acc[fast_idx]
    for _ in range(n_sub):
        v = v.index_add(0, fast_idx, a_f * half_s)
        x = x + v * dt_s
        # (K, N) force on the fast rung from all sources at the drifted
        # positions; it is also the next substep's opening kick.
        a_f = accel_vs(x[fast_idx], x, masses)
        v = v.index_add(0, fast_idx, a_f * half_s)

    # Closing slow kick; the full force is the next step's carry.
    new_acc = accel_full(x, masses)
    v = v + slow_w * new_acc * half
    return state.replace(positions=x, velocities=v), new_acc


def make_multirate_step_fn(
    accel_vs: AccelVs, dt, *, k: int, n_sub: int = 4,
    accel_full: Optional[Callable] = None,
):
    """(state, acc) -> (state, acc), drop-in for make_step_fn's shape."""
    if n_sub < 1:
        raise ValueError(f"n_sub must be >= 1, got {n_sub}")

    def step(state, acc):
        return two_rung_step(state, acc, dt, accel_vs=accel_vs, k=k,
                             n_sub=n_sub, accel_full=accel_full)

    return step


def rung_segments(capacities):
    """Static (start, cap) slices of the |a|-ranked union index, fastest
    rung first (``capacities`` runs slowest extra rung first)."""
    seg = []
    start = 0
    for cap in reversed(capacities):
        seg.append((start, cap))
        start += cap
    return seg


def assign_rungs(acc, masses, *, capacities):
    """(union_idx, per-rung index tensors, fastest first) from the |a|
    ranking with static capacities; zero-mass particles stay in rung 0."""
    union_idx = select_fast(acc, masses, k=sum(capacities))
    return union_idx, [
        union_idx[s:s + cap] for s, cap in rung_segments(capacities)
    ]


def rung_ladder_step(
    state: ParticleState,
    acc: torch.Tensor,
    dt,
    *,
    accel_vs: AccelVs,
    capacities: tuple,
    accel_full: Optional[Callable] = None,
) -> tuple[ParticleState, torch.Tensor]:
    """One outer KDK step of an R-rung power-of-two ladder: rung 0 (the
    rest) steps at dt, rung r at dt / 2^r with static size
    ``capacities[r-1]``. All rungs drift together on the finest grid;
    rung r's force is re-evaluated 2^r times an outer step as a (K_r, N)
    kick against all sources, a rung's closing and next opening
    half-kicks merged into one full kick at its boundaries."""
    n_rungs = len(capacities) + 1
    if n_rungs < 2:
        raise ValueError("need at least one fast-rung capacity")
    if any(c < 1 for c in capacities):
        raise ValueError(f"capacities must be >= 1, got {capacities}")
    if accel_full is None:
        accel_full = lambda pos, m: accel_vs(pos, pos, m)  # noqa: E731
    masses = state.masses
    dt = _dt(dt, state)
    n_micro = 1 << (n_rungs - 1)
    dt_min = _factor(_div(dt, n_micro))
    half = 0.5 * dt

    # rung_idx[0] is the fastest set; one union scatter builds the slow
    # weight, so no fast particle is also kicked as rung 0.
    union_idx, rung_idx = assign_rungs(acc, masses, capacities=capacities)
    slow_w = _slow_weight(union_idx, state)
    x, v = state.positions, state.velocities

    # Opening half-kicks, every rung: rung r's is dt / 2^r / 2.
    v = v + slow_w * acc * _factor(half)
    for f, idx in enumerate(rung_idx):
        r = n_rungs - 1 - f
        v = v.index_add(0, idx, acc[idx] * _factor(_div(half, 1 << r)))

    # Drift on the finest grid; at each rung-r boundary re-evaluate that
    # rung's force and kick (a full kick mid-step, a half at the end).
    for i in range(n_micro):
        x = x + v * dt_min
        for f, idx in enumerate(rung_idx):
            r = n_rungs - 1 - f
            period = 1 << (n_rungs - 1 - r)
            if (i + 1) % period == 0:
                a_r = accel_vs(x[idx], x, masses)
                last = (i + 1) == n_micro
                factor = _div(half if last else dt, 1 << r)
                v = v.index_add(0, idx, a_r * _factor(factor))

    # Closing slow half-kick; the full force becomes the next carry.
    new_acc = accel_full(x, masses)
    v = v + slow_w * new_acc * _factor(half)
    return state.replace(positions=x, velocities=v), new_acc


def make_rung_ladder_step_fn(
    accel_vs: AccelVs, dt, *, capacities: tuple,
    accel_full: Optional[Callable] = None,
):
    """(state, acc) -> (state, acc), drop-in for make_step_fn's shape."""

    def step(state, acc):
        return rung_ladder_step(state, acc, dt, accel_vs=accel_vs,
                                capacities=tuple(capacities),
                                accel_full=accel_full)

    return step
