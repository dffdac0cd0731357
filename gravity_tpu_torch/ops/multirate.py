"""Block-timestep (multirate) KDK integration.

Counterpart of ``gravity_tpu/ops/multirate.py``.
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
which can differ in the last bit).

One step function a scheme serves a single card and a mesh; only the
bookkeeping of the fast set differs (:func:`_fast_set`). Off a mesh the
set is rows of the state, read by index and kicked by ``index_add``. On
a ``torch.distributed`` mesh (``mesh=``) the state is a rank's rows: one
all-gather an outer step brings the positions, velocities, forces and
masses of the whole state to every rank, so that every rank picks the
same set and sub-cycles it replicated, writing the rows it owns into
its shard each substep (an elementwise select, no scatter); each fast
kick is the backend's rectangular kernel on the rank's sources, summed
over the ranks by one ``all_reduce`` (``parallel.make_sharded_rect_accel``).
The JAX package leaves the fast rows of the sharded state stale while
they sub-cycle and adds their fast-fast pairs by a replicated dense
kernel; here the kick sees every source at its current position with its
mass, so the arithmetic is the single card's, op for op: on a world of
one the sharded step gives its bits, and on several ranks only the
kick's sum over the ranks runs in another order. (Off a mesh the
replicated bookkeeping made ``baseline-16k``'s two-rung and ladder steps
1.4x and 1.6x slower on an H100, host-bound: more ops a substep.)
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..parallel.mesh import ParticleMesh, all_gather_rows
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


class _LocalFast:
    """The fast set off a mesh: rows of the state itself, read by index
    and kicked by ``index_add``, in static rung segments ``(lo, cap)`` of
    the |a| ranking (:func:`rung_segments`; one for two rungs). ``a0`` is
    the carried force on the set, ``slow_w`` (N, 1) 0 on it and 1
    elsewhere."""

    def __init__(self, state: ParticleState, acc: torch.Tensor, segments):
        self.idx = select_fast(acc, state.masses,
                               k=sum(cap for _, cap in segments))
        self.a0 = acc[self.idx]
        self.rows = [self.idx[lo:lo + cap] for lo, cap in segments]
        w = torch.ones(state.n, dtype=state.dtype, device=state.device)
        self.slow_w = w.index_fill(0, self.idx, 0.0)[:, None]

    def kick(self, v, dv, f: int = 0):
        """``v`` with ``dv`` added to segment ``f``'s rows."""
        return v.index_add(0, self.rows[f], dv)

    def drift(self, x, v, dt):
        return x + v * dt

    def positions(self, x, f: int = 0):
        return x[self.rows[f]]

    def close(self, v):
        return v


class _ReplicatedFast:
    """The fast set on a mesh: one all-gather of the rows packed side by
    side brings the whole state to every rank, every rank picks the same
    set and sub-cycles its positions and velocities as (F, 3) arrays, and
    writes them onto the set's rows it owns by an elementwise select (no
    scatter). Same interface as :class:`_LocalFast`."""

    def __init__(self, state: ParticleState, acc: torch.Tensor,
                 mesh: ParticleMesh, segments):
        n = state.n
        m = state.masses[:, None].to(state.dtype)
        whole = all_gather_rows(torch.cat(
            [state.positions, state.velocities, acc, m], dim=1))
        idx = select_fast(whole[:, 6:9], whole[:, 9],
                          k=sum(cap for _, cap in segments))
        self.segments = segments
        self.x_f, self.v_f, self.a0 = (whole[idx, :3], whole[idx, 3:6],
                                       whole[idx, 6:9])
        f = idx.shape[0]
        local = idx - mesh.rank * n
        mine = (local >= 0) & (local < n)
        # The set's slot of each row, f where none; row n is a trash row
        # for the set's rows on other ranks.
        slot = torch.full((n + 1,), f, dtype=idx.dtype, device=idx.device)
        slot[torch.where(mine, local, n)] = torch.arange(f,
                                                         device=idx.device)
        self.slot = slot[:n]
        self.is_fast = self.slot < f
        self.slow_w = torch.where(self.is_fast, 0.0, 1.0).to(
            state.dtype)[:, None]

    def _put(self, rows, rep):
        padded = torch.cat([rep, rep.new_zeros((1, rep.shape[1]))])
        return torch.where(self.is_fast[:, None], padded[self.slot], rows)

    def kick(self, v, dv, f: int = 0):
        if len(self.segments) == 1:
            self.v_f = self.v_f + dv
        else:
            lo, cap = self.segments[f]
            self.v_f = torch.cat([self.v_f[:lo], self.v_f[lo:lo + cap] + dv,
                                  self.v_f[lo + cap:]])
        return v

    def drift(self, x, v, dt):
        self.x_f = self.x_f + self.v_f * dt
        return self._put(x + v * dt, self.x_f)

    def positions(self, x, f: int = 0):
        lo, cap = self.segments[f]
        return self.x_f[lo:lo + cap]

    def close(self, v):
        return self._put(v, self.v_f)


def _fast_set(state, acc, mesh: Optional[ParticleMesh], segments):
    """The fast set, the whole state's highest-|a| massive bodies in rung
    ``segments``: the state's own rows off a mesh, replicated on one."""
    if mesh is None:
        return _LocalFast(state, acc, segments)
    return _ReplicatedFast(state, acc, mesh, segments)


def two_rung_step(
    state: ParticleState,
    acc: torch.Tensor,
    dt,
    *,
    accel_vs: AccelVs,
    k: int,
    n_sub: int = 4,
    accel_full: Optional[Callable] = None,
    mesh: Optional[ParticleMesh] = None,
) -> tuple[ParticleState, torch.Tensor]:
    """One outer step of the two-rung scheme; returns (state, new_acc).

    ``acc`` is the full-force carry at the current positions; ``new_acc``
    the full force at the new positions. ``accel_full(positions,
    masses)`` is the closing evaluation (default ``accel_vs(pos, pos,
    masses)``). On a ``mesh`` the state is a rank's rows, ``accel_vs``
    sums the kick over the ranks and ``accel_full`` is the sharded force
    (the module docstring says how the arithmetic stays the same)."""
    if n_sub < 1:
        raise ValueError(f"n_sub must be >= 1, got {n_sub}")
    if accel_full is None:
        accel_full = lambda pos, m: accel_vs(pos, pos, m)  # noqa: E731
    masses = state.masses
    dt = _dt(dt, state)
    dt_s = _div(dt, n_sub)
    half, half_s = _factor(0.5 * dt), _factor(0.5 * dt_s)
    dt_s = _factor(dt_s)

    fast = _fast_set(state, acc, mesh, [(0, k)])
    x, v = state.positions, state.velocities

    # Opening slow kick with the carried full force.
    v = v + fast.slow_w * acc * half
    a_f = fast.a0
    for _ in range(n_sub):
        v = fast.kick(v, a_f * half_s)
        x = fast.drift(x, v, dt_s)
        # (K, N) force on the fast rung from all sources at the drifted
        # positions; it is also the next substep's opening kick.
        a_f = accel_vs(fast.positions(x), x, masses)
        v = fast.kick(v, a_f * half_s)

    # Closing slow kick; the full force is the next step's carry.
    v = fast.close(v)
    new_acc = accel_full(x, masses)
    v = v + fast.slow_w * new_acc * half
    return state.replace(positions=x, velocities=v), new_acc


def make_multirate_step_fn(
    accel_vs: AccelVs, dt, *, k: int, n_sub: int = 4,
    accel_full: Optional[Callable] = None,
    mesh: Optional[ParticleMesh] = None,
):
    """(state, acc) -> (state, acc), drop-in for make_step_fn's shape."""
    if n_sub < 1:
        raise ValueError(f"n_sub must be >= 1, got {n_sub}")

    def step(state, acc):
        return two_rung_step(state, acc, dt, accel_vs=accel_vs, k=k,
                             n_sub=n_sub, accel_full=accel_full, mesh=mesh)

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
    mesh: Optional[ParticleMesh] = None,
) -> tuple[ParticleState, torch.Tensor]:
    """One outer KDK step of an R-rung power-of-two ladder: rung 0 (the
    rest) steps at dt, rung r at dt / 2^r with static size
    ``capacities[r-1]``. All rungs drift together on the finest grid;
    rung r's force is re-evaluated 2^r times an outer step as a (K_r, N)
    kick against all sources, a rung's closing and next opening
    half-kicks merged into one full kick at its boundaries. The union of
    the fast rungs is :func:`two_rung_step`'s fast set, each rung a static
    slice of it (:func:`rung_segments`, fastest first); ``mesh`` as
    there."""
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

    seg = rung_segments(capacities)
    fast = _fast_set(state, acc, mesh, seg)
    x, v = state.positions, state.velocities

    # Opening half-kicks, every rung: rung r's is dt / 2^r / 2.
    v = v + fast.slow_w * acc * _factor(half)
    for f, (lo, cap) in enumerate(seg):
        r = n_rungs - 1 - f
        v = fast.kick(v, fast.a0[lo:lo + cap] * _factor(_div(half, 1 << r)),
                      f)

    # Drift on the finest grid; at each rung-r boundary re-evaluate that
    # rung's force and kick (a full kick mid-step, a half at the end).
    for i in range(n_micro):
        x = fast.drift(x, v, dt_min)
        for f in range(len(seg)):
            r = n_rungs - 1 - f
            period = 1 << (n_rungs - 1 - r)
            if (i + 1) % period == 0:
                a_r = accel_vs(fast.positions(x, f), x, masses)
                last = (i + 1) == n_micro
                factor = _div(half if last else dt, 1 << r)
                v = fast.kick(v, a_r * _factor(factor), f)

    # Closing slow half-kick; the full force becomes the next carry.
    v = fast.close(v)
    new_acc = accel_full(x, masses)
    v = v + fast.slow_w * new_acc * _factor(half)
    return state.replace(positions=x, velocities=v), new_acc


def make_rung_ladder_step_fn(
    accel_vs: AccelVs, dt, *, capacities: tuple,
    accel_full: Optional[Callable] = None,
    mesh: Optional[ParticleMesh] = None,
):
    """(state, acc) -> (state, acc), drop-in for make_step_fn's shape."""

    def step(state, acc):
        return rung_ladder_step(state, acc, dt, accel_vs=accel_vs,
                                capacities=tuple(capacities),
                                accel_full=accel_full, mesh=mesh)

    return step
