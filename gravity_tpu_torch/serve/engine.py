"""Batched ensemble engine: B independent simulations as one batched loop.

Counterpart of ``gravity_tpu/serve/engine.py``. Serving many small
requests one program each pays a launch round-trip per job and leaves
the card mostly idle; here B systems, each zero-mass-padded to one
power-of-two bucket (the ``ParticleState.pad_to`` contract: padding
exerts no force), step together over ``(B, n, 3)`` tensors. The backends,
by the JAX package's names:

- ``pallas`` and ``pallas-mxu``: a force evaluation of the whole batch is
  ONE launch of a hand-written kernel with a slot grid axis
  (``direct_kernel.accelerations_vs_batched_kernel``,
  ``mxu_kernel.accelerations_vs_mxu_batched_kernel``), the counterpart of
  ``pallas_call``'s batching rule under the JAX engine's ``vmap``;
- ``nlist``: the cutoff-radius cell list over the batch
  (``nlist.nlist_accelerations_vs_batched``: each slot its own bounding
  cube, one sort of the batch, the pair tiles ONE launch of
  ``csrc/nlist_pair.cu``'s batched entry), truncated physics whose rcut,
  side and cap ride the key;
- ``dense`` and ``chunked``: the plain PyTorch sums over the batch axis
  (with the rcut mask where the job declares one), for jobs that name
  them (and the CPU's static route).

Each slot of a batched evaluation has the bits of the solo evaluation of
the slot's arrays, so a served job follows the solo run of its
bucket-padded state bit for bit.

Per-slot isolation: slots never mix, so one diverging system NaNs only
its own slot. A round returns a per-slot finite flag over each job's
REAL particles (padding lanes are test bodies and may do anything), and
a flagged slot comes back rolled back to its round-start carry; the
scheduler fails it while its batchmates keep integrating.

Jobs in one batch share (bucket, backend, dtype, integrator, physics
constants), the :class:`BatchKey`; dt and the remaining-step budget are
per slot, so mixed-dt and mixed-length jobs share one round: each step
advances only the slots whose budget is not exhausted (a masked
``where``). The JAX engine compiles a key's round once; here
``compile_counts[key]`` counts builds of the key's round function (its
kernels and step closure), once over the engine's life.

Where the JAX engine's ``lax.scan`` runs on the device, the round here is
a Python loop of batched steps that queues its launches without waiting;
the one host read of a round is the (B,) finite flag that
:func:`account_slice` consumes. The per-slot dt is a ``(B, 1, 1)``
float64 tensor on the device, which ``ops/integrators.py`` rounds to the
state's dtype where a step uses it, as it rounds a solo run's Python dt:
served and solo runs keep the same bits.

Job classes other than ``integrate`` bring their own program family
(``serve/jobs/``): the engine's batch lifecycle and round hand a key of
such a class to its class, as the JAX engine does: ``fit`` (a batched
rollout and its backward a round), ``sweep-member`` and ``watch`` (the
integrate round with a closest-pair carry, on a batch of the key's
integrate twin, :func:`native_key`), ``sharded-integrate`` (one system an
exclusive batch, on a worker group of its own for D >= 2 devices).

Threads: a kernel runs on the CUDA device of the tensors it is given,
and :attr:`EnsembleEngine.guard` (the daemon's round lock) must be held
by the thread that launches: a launch from any other thread raises
instead of going unnoticed.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SimulationConfig
from ..ops import direct_kernel, mxu_kernel, nlist
from ..ops.forces import accelerations_vs
from ..ops.integrators import make_step_fn
from ..state import ParticleState
from ..telemetry import perf as _perf
from ..utils.platform import DeviceLike, resolve_device

# Force backends of the batched round, by the JAX package's names.
ENGINE_BACKENDS = ("dense", "chunked", "pallas", "pallas-mxu", "nlist")

MIN_BUCKET = 16
# Largest padded bucket the engine accepts, the JAX engine's: the direct
# sums cover (slots, n, n) pairs and the cell list's grid is sized
# blind at admission; past this n the right tool is a solo run, whose
# auto router can pick a fast solver for the data.
MAX_BUCKET = 8192
# The BatchKey.extra entries that are physics (a truncated key's rcut and
# cell-list sizing), not a class's program parameters.
PHYSICS_EXTRA = ("nlist_rcut", "nlist_side", "nlist_cap")


def bucket_size(n: int, min_bucket: int = MIN_BUCKET) -> int:
    """Power-of-two padding bucket for an n-body job (>= min_bucket).
    Bucketing bounds the builds at log2(n_max) keys while capping padding
    waste at < 2x; the occupancy metric shows the actual waste."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    return max(min_bucket, 1 << (n - 1).bit_length())


class BatchKey(NamedTuple):
    """Everything that must be equal for two jobs to share a batch (one
    build per distinct key, kept for the engine's lifetime). dt, steps,
    model and seed are absent: per slot, or host side. ``job_type``
    selects the program family (``integrate``, the engine's own, or a
    class's, ``serve/jobs/``);
    ``extra`` carries a family's additional static parameters."""

    bucket_n: int
    slots: int
    backend: str
    dtype: str
    integrator: str
    g: float
    eps: float
    cutoff: float
    job_type: str = "integrate"
    extra: tuple = ()


def batch_key_for(
    config: SimulationConfig, *, slots: int, min_bucket: int = MIN_BUCKET,
    reroute=None, job_type: str = "integrate", extra: tuple = (),
    device: DeviceLike = None,
) -> BatchKey:
    """The batch a job with this config lands in. Raises ValueError for
    configs outside the ensemble envelope (a submit-time rejection).

    ``auto``/``direct`` route through the measured tuning cache at the
    job's padded bucket (:func:`~gravity_tpu_torch.autotune.
    resolve_engine_backend`, probed at submit time on a miss), or with
    autotuning off the static route: ``pallas`` on the card, ``dense``
    on the CPU. ``auto`` with ``nlist_rcut`` > 0 routes statically to
    ``dense``, as the JAX engine does. Truncated physics (``nlist``, or an
    rcut on ``dense``/``chunked``) keys its rcut, side and cap in
    ``extra``: ``nlist`` needs rcut > 0 and an explicit ``nlist_side``
    (no state exists at admission to size the grid from), and a declared
    rcut on a full-gravity backend is refused. ``reroute`` (backend ->
    backend) is the circuit breakers' admission hook (serve/breaker.py);
    ``device`` is the engine's (the card unless the CPU is asked for)."""
    backend = config.force_backend
    if backend not in ("auto", "direct") and backend not in ENGINE_BACKENDS:
        raise ValueError(
            f"force_backend {config.force_backend!r} is not servable by "
            f"the ensemble engine (supported: auto/direct/"
            f"{'/'.join(ENGINE_BACKENDS)}); run it solo via `run`"
        )
    if config.n > MAX_BUCKET:
        raise ValueError(
            f"n={config.n} exceeds the ensemble engine's bucket cap "
            f"({MAX_BUCKET}); run this size solo via `run` (its auto "
            "router picks a scale-appropriate backend)"
        )
    from ..models import MODELS

    if config.model not in MODELS:
        raise ValueError(
            f"unknown model {config.model!r}; one of {sorted(MODELS)}"
        )
    if config.integrator not in ("euler", "leapfrog", "verlet", "yoshida4"):
        raise ValueError(
            f"integrator {config.integrator!r} is not servable by the "
            "ensemble engine (fixed-dt euler/leapfrog/verlet/yoshida4)"
        )
    for knob, default in (
        ("adaptive", False), ("merge_radius", 0.0), ("periodic_box", 0.0),
        ("external", ""), ("sharding", "none"),
    ):
        val = getattr(config, knob, default)
        if val != default:
            raise ValueError(
                f"config.{knob}={val!r} is not servable by the ensemble "
                "engine; run it solo via `run`"
            )
    if backend in ("auto", "direct"):
        on_card = resolve_device(device).type == "cuda"
        backend = "pallas" if on_card else "dense"
        if config.nlist_rcut > 0.0:
            # Declared truncated physics routes statically to the masked
            # dense form, as in the JAX engine: the probe's candidates
            # compute full gravity.
            backend = "dense"
        elif getattr(config, "autotune", True):
            from ..autotune import resolve_engine_backend

            backend = resolve_engine_backend(
                config, min_bucket=min_bucket, job_type=job_type,
                device=device,
            ).backend
    if reroute is not None:
        rerouted = reroute(backend)
        if rerouted != backend and rerouted not in ENGINE_BACKENDS:
            raise ValueError(
                f"reroute {backend!r} -> {rerouted!r} left the engine's "
                f"backends ({'/'.join(ENGINE_BACKENDS)})"
            )
        backend = rerouted
    if backend == "nlist" or config.nlist_rcut > 0.0:
        if config.nlist_rcut <= 0.0:
            raise ValueError(
                "force_backend='nlist' needs nlist_rcut > 0 "
                "(--nlist-rcut): the cell-list kernel computes "
                "rcut-truncated forces"
            )
        if backend not in ("nlist", "dense", "chunked"):
            raise ValueError(
                f"nlist_rcut > 0 declares truncated physics, but "
                f"force_backend {backend!r} computes full gravity and "
                "ignores it; use nlist (or dense/chunked, which apply "
                "the rcut mask)"
            )
        if backend == "nlist" and config.nlist_side <= 0:
            raise ValueError(
                "served nlist jobs need an explicit --nlist-side: no "
                "concrete state exists at admission to size the cell "
                "list from"
            )
        # The rcut and the cell list's sizing are part of the key: jobs
        # with other radii or grids never share a batch.
        extra = tuple(extra) + (
            ("nlist_rcut", config.nlist_rcut),
            ("nlist_side", config.nlist_side),
            ("nlist_cap", config.nlist_cap),
        )
    return BatchKey(
        bucket_n=bucket_size(config.n, min_bucket),
        slots=slots,
        backend=backend,
        dtype=config.dtype,
        integrator=config.integrator,
        g=config.g,
        eps=config.eps,
        cutoff=config.cutoff,
        job_type=job_type,
        extra=tuple(extra),
    )


@dataclasses.dataclass
class EnsembleBatch:
    """Device slot tensors for one BatchKey. ``dt``/``remaining``/
    ``n_real`` live on the host (numpy): the scheduler changes them
    between rounds and each round ships them once."""

    key: BatchKey
    positions: torch.Tensor  # (B, n, 3)
    velocities: torch.Tensor  # (B, n, 3)
    masses: torch.Tensor  # (B, n)
    acc: torch.Tensor  # (B, n, 3) carried accelerations
    dt: np.ndarray  # (B,) float
    remaining: np.ndarray  # (B,) int64 steps left in each slot's budget
    n_real: np.ndarray  # (B,) int32 real (unpadded) particles per slot

    @property
    def slots(self) -> int:
        return self.positions.shape[0]


class SliceResult(NamedTuple):
    advanced: np.ndarray  # (B,) steps actually taken this slice
    finite: np.ndarray  # (B,) bool: real lanes finite after the slice


def budget_i32(remaining: np.ndarray) -> np.ndarray:
    """Per-slot budgets clamped to int32: budgets beyond 2^31 units are
    not a serving shape. The one clamp a round's budgets go through."""
    return np.minimum(remaining, np.iinfo(np.int32).max).astype(np.int32)


def account_slice(
    remaining: np.ndarray, n_real: np.ndarray, units: int, finite
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host bookkeeping after one budgeted slice: (advanced, new
    remaining, finite with empty slots vacuously True)."""
    advanced = np.minimum(remaining, units)
    finite_np = np.where(np.asarray(n_real) > 0, np.asarray(finite), True)
    return advanced, remaining - advanced, finite_np


def _resolved(backend: str) -> str:
    """The Simulator's name of an engine backend (its kernels' names)."""
    from ..simulation import KERNEL_BACKEND, MXU_BACKEND

    return {"pallas": KERNEL_BACKEND,
            "pallas-mxu": MXU_BACKEND}.get(backend, backend)


def native_key(key: BatchKey) -> BatchKey:
    """The ``integrate`` twin of a class's key: the same bucket, slots,
    backend and physics, without the class's program parameters (a sweep
    member's and a watch's batch is one of these, with their carries
    beside it)."""
    return key._replace(job_type="integrate", extra=tuple(
        (k, v) for k, v in key.extra if k in PHYSICS_EXTRA))


def _key_config(key: BatchKey) -> SimulationConfig:
    """The physics of a key as a config at its bucket (the rcut of a
    truncated key from its ``extra``)."""
    nlist_kw = {k: v for k, v in key.extra if k in PHYSICS_EXTRA}
    return SimulationConfig(
        n=key.bucket_n, force_backend=key.backend, dtype=key.dtype,
        g=key.g, eps=key.eps, cutoff=key.cutoff, **nlist_kw,
    )


def batched_kernel(key: BatchKey):
    """``(B, M, 3) x (B, K, 3) x (B, K) -> (B, M, 3)`` of the key's
    backend: one batched launch of a hand-written kernel for
    ``pallas``/``pallas-mxu`` and for the pair tiles of ``nlist`` (their
    plain batched versions only for CPU tensors; each differentiable
    through the dense backward, ``ops/forces.DenseVJP``), the plain sum
    over the batch for dense/chunked."""
    cfg = _key_config(key)
    common = dict(g=cfg.g, cutoff=cfg.cutoff, eps=cfg.eps)
    if key.backend == "pallas":
        return functools.partial(
            direct_kernel.accelerations_vs_batched_kernel, **common)
    if key.backend == "pallas-mxu":
        return functools.partial(
            mxu_kernel.accelerations_vs_mxu_batched_kernel, **common)
    if key.backend == "nlist":
        from ..simulation import _resolve_nlist_config

        # Sized blind, as the solo kernel of the key is.
        side, cap = _resolve_nlist_config(cfg, None)
        return nlist.make_nlist_batched_kernel(
            rcut=cfg.nlist_rcut, side=side, cap=cap, **common)
    if cfg.nlist_rcut > 0.0:
        common["rcut"] = cfg.nlist_rcut
    if key.backend == "dense":
        return functools.partial(accelerations_vs, **common)
    if key.backend == "chunked":
        return functools.partial(_chunked_batched, chunk=cfg.chunk,
                                 **common)
    raise ValueError(f"backend {key.backend!r} is not an engine backend")


def solo_batched_kernel(config: SimulationConfig):
    """The batched kernel a solo reference (``fit_solo``,
    ``sweep_member_solo``, ``watch_solo``) runs on one slot at n: the
    config's backend, ``dense`` for ``auto``/``direct``, as the JAX
    package's solo references take it."""
    backend = config.force_backend
    if backend in ("auto", "direct"):
        backend = "dense"
    extra = ()
    if backend == "nlist" or config.nlist_rcut > 0.0:
        extra = tuple((k, getattr(config, k)) for k in PHYSICS_EXTRA)
    return batched_kernel(BatchKey(
        bucket_n=config.n, slots=1, backend=backend, dtype=config.dtype,
        integrator=config.integrator, g=config.g, eps=config.eps,
        cutoff=config.cutoff, extra=extra))


def real_lanes_finite(n_real: torch.Tensor, *lanes) -> torch.Tensor:
    """(B,) whether every real lane (the first ``n_real`` bodies of each
    slot) of each (B, n, 3) tensor in ``lanes`` is finite: padding bodies
    are massless test particles whose fate does not matter."""
    real = (torch.arange(lanes[0].shape[1], device=lanes[0].device,
                         dtype=torch.float64)[None, :]
            < n_real[:, None])[:, :, None]
    fin = None
    for t in lanes:
        ok = torch.where(real, torch.isfinite(t), True).flatten(1).all(dim=1)
        fin = ok if fin is None else fin & ok
    return fin


def slot_args(dt: np.ndarray, remaining: np.ndarray, n_real: np.ndarray,
              units: int, device: torch.device) -> tuple:
    """(args, all_take) of a budgeted round: ``args`` (B, 3) float64 on
    ``device``, each slot's dt, budget (clamped, :func:`budget_i32`) and
    real particle count, shipped in one copy (pinned on the card, so
    that the upload does not wait for it); ``all_take`` (host) the units
    in which every slot takes, which skip the budget mask's select."""
    budgets = budget_i32(remaining)
    host = np.stack([dt.astype(np.float64), budgets.astype(np.float64),
                     n_real.astype(np.float64)], axis=1)
    args = torch.from_numpy(host)
    if device.type == "cuda":
        args = args.pin_memory().to(device, non_blocking=True)
    return args, np.arange(units) < budgets.min(initial=0)


def _chunked_batched(pos_i, pos_j, masses_j, *, chunk: int, **kw):
    """The plain chunked sum over a batch: target rows ``chunk`` at a
    time, each against every source of its slot."""
    return torch.cat([
        accelerations_vs(p, pos_j, masses_j, **kw)
        for p in torch.split(pos_i, chunk, dim=-2)
    ], dim=-2)


class EnsembleEngine:
    """Owner of the per-BatchKey round functions.

    ``compile_counts[key]`` counts builds of ``key``'s round function
    (its kernels resolved, its step closure made): exactly once over the
    engine's life, the signal the scheduler's metrics and the perf gate's
    ``serve_compile_once`` read. ``device`` is where batches live: the
    card unless the CPU is asked for."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._round_fns: dict[BatchKey, object] = {}
        self._probe_fns: dict[tuple, object] = {}
        self.compile_counts: dict[BatchKey, int] = {}
        # Keys whose first round has its perf-ledger row.
        self._ledgered: set = set()
        # Seconds each key's build took; the batched force evaluations of
        # the rounds by backend (each one launch of a kernel's batched
        # entry for pallas/pallas-mxu); host reads by site (the finite
        # flag: one a round by design; the ledger and the sentinel at
        # their cadences).
        self.build_seconds: dict[BatchKey, float] = {}
        self.force_evals: dict[str, int] = {}
        self.host_reads = {"finite": 0, "ledger": 0, "probe": 0}
        # Optional telemetry hook (a FlightRecorder, or anything with
        # .record(kind, **fields)): build marks land in the crash ring.
        self.recorder = None
        # The lock whose holder may launch (the daemon's round lock); None
        # for in-process use from one thread.
        self.guard = None
        # The worker groups of the sharded-integrate keys, by key.
        self.sharded_groups: dict = {}

    def close(self) -> None:
        """End the worker groups of the sharded keys."""
        groups, self.sharded_groups = self.sharded_groups, {}
        for group in groups.values():
            group.close()

    @staticmethod
    def _job_class(key: BatchKey):
        """The registered program family of a key's class; None for the
        engine's own ``integrate`` rounds."""
        if key.job_type == "integrate":
            return None
        from .jobs import get_class

        return get_class(key.job_type)

    def _check_thread(self) -> None:
        guard = self.guard
        if guard is not None and not guard.held_by_me():
            raise RuntimeError(
                "EnsembleEngine: device work from thread "
                f"{threading.current_thread().name!r}, which does not hold "
                "the engine's guard lock (kernels launch only from the "
                "thread that holds it)"
            )

    def _mark_compile(self, key: BatchKey, seconds: float) -> None:
        self.compile_counts[key] = self.compile_counts.get(key, 0) + 1
        self.build_seconds[key] = seconds
        if self.recorder is not None:
            try:
                self.recorder.record(
                    "compile", bucket=key.bucket_n, slots=key.slots,
                    backend=key.backend, job_type=key.job_type,
                    count=self.compile_counts[key],
                )
            except Exception:  # noqa: BLE001 — telemetry must not
                pass  # fail a build

    # --- kernels ---

    def _solo_kernel(self, key: BatchKey):
        """``(targets, sources, masses) -> acc`` for ONE system at the
        bucket: the kernel a solo Simulator of the key's backend uses
        (the carried-acceleration seed and the accuracy probe)."""
        from ..simulation import make_local_kernel

        return make_local_kernel(_key_config(key), _resolved(key.backend))

    def counted_kernel(self, key: BatchKey):
        """The key's :func:`batched_kernel`, each call counted in
        :attr:`force_evals` under the key's backend (the smoke's launches
        = evaluations check)."""
        kernel = batched_kernel(key)
        evals = self.force_evals
        evals.setdefault(key.backend, 0)

        def counted(pos_i, pos_j, masses_j):
            evals[key.backend] += 1
            return kernel(pos_i, pos_j, masses_j)

        return counted

    def _seed_accel(self, key: BatchKey, positions, masses):
        """The carried-acceleration seed of one admitted slot: the solo
        kernel on its padded state (a pure function of state, so an
        evict/resume round trip reproduces the carry of a continuous
        run, and a solo run of the padded state starts from the same
        bits)."""
        return self._solo_kernel(key)(positions, positions, masses)

    def _build_round_fn(self, key: BatchKey):
        """``(pos, vel, mass, acc, slot_args, all_take, n_steps) ->
        (pos, vel, acc, finite)`` for the whole batch: ``n_steps`` batched
        steps with the budget mask, the finite flag over real lanes, and
        the in-round rollback of a non-finite slot to its round-start
        carry (the round keeps the round-start tensors alive for it: two
        generations of the (B, n, 3) triple)."""
        from ..utils import faults

        # Injected unbuildable backends (utils/faults.py) fail where the
        # JAX engine builds its kernels.
        faults.check_backend(key.backend, _resolved(key.backend))
        kernel = self.counted_kernel(key)

        def accel(p, mass):
            return kernel(p, p, mass)

        def round_fn(pos, vel, mass, acc, slot_args, all_take, *,
                     n_steps, probe=None):
            # slot_args (B, 3) float64 on the device: each slot's dt,
            # budget and real particle count, shipped in one copy.
            # all_take (host): the steps in which every slot takes, which
            # skip the budget mask's select.
            dt = slot_args[:, 0].reshape(-1, 1, 1)
            remaining, n_real = slot_args[:, 1], slot_args[:, 2]
            step = make_step_fn(key.integrator, lambda p: accel(p, mass),
                                dt)
            device = pos.device
            steps = torch.arange(n_steps, device=device, dtype=torch.float64)
            take = (steps[:, None] < remaining[None, :])[:, :, None, None]
            st = ParticleState(pos, vel, mass)
            a = acc
            for i in range(n_steps):
                if i == n_steps - 1 and probe is not None:
                    # A key's first round counts one step, its last (the
                    # counter's host cost behind the queued steps); the
                    # peak's window opened with the round.
                    with probe:
                        new_st, new_a = step(st, a)
                else:
                    new_st, new_a = step(st, a)
                if all_take[i]:
                    st, a = new_st, new_a
                    continue
                t = take[i]
                st = st.replace(
                    positions=torch.where(t, new_st.positions,
                                          st.positions),
                    velocities=torch.where(t, new_st.velocities,
                                           st.velocities),
                )
                a = torch.where(t, new_a, a)
            # Finite watchdog over the REAL lanes only.
            fin = real_lanes_finite(n_real, st.positions, st.velocities)
            keep = fin[:, None, None]
            return (torch.where(keep, st.positions, pos),
                    torch.where(keep, st.velocities, vel),
                    torch.where(keep, a, acc), fin)

        return round_fn

    def round_fn(self, key: BatchKey):
        if key not in self._round_fns:
            cls = self._job_class(key)  # refuses the unported classes
            t0 = time.perf_counter()
            self._round_fns[key] = (self._build_round_fn(key) if cls is None
                                    else cls.build_round_fn(self, key))
            self._mark_compile(key, time.perf_counter() - t0)
        return self._round_fns[key]

    # --- batch lifecycle ---

    def new_batch(self, key: BatchKey) -> EnsembleBatch:
        """All-empty batch: zero-mass states, zero budgets."""
        cls = self._job_class(key)
        if cls is not None:
            return cls.new_batch(self, key)
        from ..simulation import resolve_dtype

        dtype = resolve_dtype(key.dtype)
        b, n = key.slots, key.bucket_n
        zeros = functools.partial(torch.zeros, dtype=dtype,
                                  device=self.device)
        return EnsembleBatch(
            key=key, positions=zeros((b, n, 3)), velocities=zeros((b, n, 3)),
            masses=zeros((b, n)), acc=zeros((b, n, 3)),
            dt=np.zeros((b,), np.float64),
            remaining=np.zeros((b,), np.int64),
            n_real=np.zeros((b,), np.int32),
        )

    def load_slot(self, batch: EnsembleBatch, slot: int,
                  state: ParticleState, *, dt: float, steps: int,
                  job=None) -> EnsembleBatch:
        """Admit a job into ``slot``: pad its state to the bucket and seed
        the carried acceleration (identical at admission and re-admission,
        so evict/resume round trips keep solo parity). ``job`` is read by
        the other classes' slot loads only."""
        self._check_thread()
        key = batch.key
        cls = self._job_class(key)
        if cls is not None:
            return cls.load_slot(self, batch, slot, state, dt=dt,
                                 steps=steps, job=job)
        from ..simulation import resolve_dtype
        from ..utils import faults

        faults.check_backend(key.backend, _resolved(key.backend))
        n_real = state.n
        padded, _ = state.astype(resolve_dtype(key.dtype)).to(
            self.device).pad_to(key.bucket_n)
        acc0 = self._seed_accel(key, padded.positions, padded.masses)
        dt_arr, rem, nr = (batch.dt.copy(), batch.remaining.copy(),
                           batch.n_real.copy())
        dt_arr[slot], rem[slot], nr[slot] = dt, steps, n_real
        pos, vel, m, acc = (batch.positions.clone(),
                            batch.velocities.clone(), batch.masses.clone(),
                            batch.acc.clone())
        pos[slot], vel[slot], m[slot], acc[slot] = (
            padded.positions, padded.velocities, padded.masses, acc0)
        return dataclasses.replace(
            batch, positions=pos, velocities=vel, masses=m, acc=acc,
            dt=dt_arr, remaining=rem, n_real=nr,
        )

    def clear_slot(self, batch: EnsembleBatch, slot: int) -> EnsembleBatch:
        """Free a slot: zero its budget and mass (a zero-mass slot exerts
        no force and a zero budget freezes its lanes)."""
        cls = self._job_class(batch.key)
        if cls is not None:
            return cls.clear_slot(self, batch, slot)
        rem, nr = batch.remaining.copy(), batch.n_real.copy()
        rem[slot], nr[slot] = 0, 0
        m = batch.masses.clone()
        m[slot] = 0
        return dataclasses.replace(batch, masses=m, remaining=rem, n_real=nr)

    def slot_snapshot(self, batch: EnsembleBatch,
                      slot: int) -> tuple[ParticleState, dict]:
        """(state, extras) of one slot: integrate carries no extras."""
        cls = self._job_class(batch.key)
        if cls is not None:
            return cls.slot_snapshot(self, batch, slot)
        return self.slot_state(batch, slot), {}

    def slot_state(self, batch: EnsembleBatch, slot: int,
                   n_real: Optional[int] = None) -> ParticleState:
        """The (unpadded) current state of one slot's job, as fresh
        tensors on the engine's device."""
        cls = self._job_class(batch.key)
        if cls is not None:
            return cls.slot_snapshot(self, batch, slot)[0]
        n = int(batch.n_real[slot]) if n_real is None else n_real
        return ParticleState(
            positions=batch.positions[slot, :n].clone(),
            velocities=batch.velocities[slot, :n].clone(),
            masses=batch.masses[slot, :n].clone(),
        )

    # --- the numerics observatory ---

    @staticmethod
    def _key_rcut(key: BatchKey) -> float:
        try:
            return float(dict(key.extra).get("nlist_rcut", 0.0) or 0.0)
        except (TypeError, ValueError):
            return 0.0

    def _ledger_pe_kind(self, key: BatchKey) -> str:
        """The dense pair scan up to LEDGER_DENSE_MAX (always for the
        truncated family), ``none`` above it."""
        from ..ops.diagnostics import LEDGER_DENSE_MAX

        if self._key_rcut(key) > 0.0 or key.bucket_n <= LEDGER_DENSE_MAX:
            return "dense"
        return "none"

    def _ledger_row(self, key: BatchKey, pos, vel, m) -> torch.Tensor:
        from ..ops.diagnostics import ledger_vec, pe_hat_dense

        vec = ledger_vec(pos, vel, m)
        if self._ledger_pe_kind(key) == "none":
            return torch.cat([vec, vec.new_zeros((1,))])
        pe = pe_hat_dense(pos, m, cutoff=key.cutoff, eps=key.eps,
                          rcut=self._key_rcut(key))
        return torch.cat([vec, pe.reshape(1)])

    @staticmethod
    def state_batch(batch):
        """The batch that holds a class batch's integrating state: its
        ``base`` (sweep members, watch), else the batch itself."""
        return getattr(batch, "base", batch)

    def _ledger_applicable(self, key: BatchKey, batch) -> bool:
        """Whether the key's batches hold an integrating (positions,
        velocities, masses) state whose conserved quantities mean
        something: every integration class; not ``fit`` (its lanes hold
        the optimizer's guess, ``conserves = False``)."""
        if not getattr(self._job_class(key), "conserves", True):
            return False
        inner = self.state_batch(batch)
        return all(hasattr(inner, f)
                   for f in ("positions", "velocities", "masses"))

    def batch_ledger(self, batch: EnsembleBatch) -> np.ndarray:
        """Per-slot conservation-ledger components of a live batch: a
        ``(slots, 14)`` host array, the 13 ``LEDGER_VEC_FIELDS`` and the
        dense dimensionless pair-potential sum, slot by slot (zero-mass
        padding lanes are inert). Convert one row with
        :meth:`slot_ledger_host`. None for a class whose batch holds no
        conserving lanes (``conserves = False``)."""
        self._check_thread()
        if not self._ledger_applicable(batch.key, batch):
            return None
        inner = self.state_batch(batch)
        rows = torch.stack([
            self._ledger_row(batch.key, inner.positions[s],
                             inner.velocities[s], inner.masses[s])
            for s in range(inner.slots)
        ])
        self.host_reads["ledger"] += 1
        return rows.double().cpu().numpy()

    def stats(self) -> dict:
        """The engine's counters as JSON: builds and build seconds by key,
        batched force evaluations by backend, host reads by site."""
        def name(k):
            return (f"job={k.job_type},bucket={k.bucket_n},slots={k.slots},"
                    f"backend={k.backend},dtype={k.dtype},"
                    f"integrator={k.integrator}")

        return {
            "builds": {name(k): v for k, v in self.compile_counts.items()},
            "build_seconds": {name(k): v
                              for k, v in self.build_seconds.items()},
            "force_evals": dict(self.force_evals),
            "host_reads": dict(self.host_reads),
        }

    def slot_ledger_host(self, row, key: BatchKey) -> dict:
        """Host-float64 ledger from one :meth:`batch_ledger` row."""
        from ..ops.diagnostics import ledger_host

        kind = self._ledger_pe_kind(key)
        return ledger_host(row[:13], pe=row[13] if kind != "none" else None,
                           g=key.g, pe_kind=kind)

    def state_ledger(self, state: ParticleState, key: BatchKey) -> dict:
        """The t0 ledger baseline of one job's (unpadded) state, summed on
        the engine's device as the rounds' ledgers are (an admitted job's
        state arrives on the host: its dense pair scan there took seconds
        a job at bucket 8,192)."""
        from ..simulation import resolve_dtype

        st = state.astype(resolve_dtype(key.dtype)).to(self.device)
        row = self._ledger_row(key, st.positions, st.velocities, st.masses)
        return self.slot_ledger_host(row.double().cpu().numpy(), key)

    def probe_slot_accuracy(self, batch: EnsembleBatch, slot: int,
                            k: int = 64) -> np.ndarray:
        """Accuracy-sentinel probe of one occupied slot: the key's solo
        kernel against the exact (rcut-masked) direct sum on ``k`` fixed
        sampled targets. Returns the (k,) relative errors on the host, or
        None for a class whose batch holds no conserving lanes."""
        self._check_thread()
        key = batch.key
        if not self._ledger_applicable(key, batch):
            return None
        fn = self._probe_fns.get((key, k))
        if fn is None:
            from ..utils.profiling import (
                make_force_error_probe,
                sentinel_indices,
            )

            fn = make_force_error_probe(
                self._solo_kernel(key),
                idx=sentinel_indices(key.bucket_n, k), g=key.g,
                cutoff=key.cutoff, eps=key.eps, rcut=self._key_rcut(key),
            )
            self._probe_fns[(key, k)] = fn
        inner = self.state_batch(batch)
        rel = fn(inner.positions[slot], inner.masses[slot])
        self.host_reads["probe"] += 1
        return rel.double().cpu().numpy()

    # --- the hot path ---

    def first_round_probe(self, key: BatchKey, tensors):
        """A :class:`~gravity_tpu_torch.telemetry.perf.FirstCall` whose peak
        window opens now, for the first round of ``key`` (``tensors``: the
        batch's own, counted as its inputs), or None after it or where
        counting is off. Close it with :meth:`_record_first_round`."""
        if (key in self._ledgered or not _perf.counting_allowed()
                or _perf.counting()):
            return None
        self._ledgered.add(key)
        probe = _perf.FirstCall(self.device, sum(
            t.numel() * t.element_size() for t in tensors))
        probe.start_peak()  # the whole round's peak, for admission
        return probe

    def _record_first_round(self, key: BatchKey, probe, seconds: float
                            ) -> None:
        """A key's perf-ledger row after its first round (site
        ``serve_round``): the build and first round's seconds, the counted
        flops, bytes and transcendentals of the round's last step over
        the whole batch, the cost model's flops of one step of every slot,
        and the round's peak device bytes above what was allocated before
        it plus the batch's own tensors, which admission then reads for
        the key's later jobs (``perf.required_bytes_for_key``)."""
        peak, source = probe.peak()
        flops = _perf.analytic_flops(key.backend, key.bucket_n)
        _perf.ledger().record_compile(
            site="serve_round", key=_perf.engine_key_str(key),
            compile_s=seconds, backend=key.backend, n=key.bucket_n,
            analytic=(flops or 0.0) * key.slots or None,
            cost=probe.counter.cost(), peak_bytes=peak, peak_source=source,
            storm_count=self.compile_counts.get(key, 1),
            estimated_bytes=_perf.estimate_peak_bytes(key),
            job_type=key.job_type, slots=key.slots, bucket=key.bucket_n,
            kernel_launches_counted=probe.counter.launches,
        )

    def run_slice(self, batch: EnsembleBatch,
                  slice_steps: int) -> tuple[EnsembleBatch, SliceResult]:
        """Advance every occupied slot by up to ``slice_steps`` steps.
        Callers keep ``slice_steps`` constant so that each key builds
        once (the budget mask absorbs shorter remainders). A slot that
        went non-finite comes back rolled back to its round-start state,
        flagged in ``SliceResult.finite``. One host read: the flags."""
        self._check_thread()
        key = batch.key
        cls = self._job_class(key)
        if cls is not None:
            return cls.run_slice(self, batch, slice_steps)
        t0 = time.perf_counter()
        fn = self.round_fn(key)
        probe = self.first_round_probe(key, (
            batch.positions, batch.velocities, batch.masses, batch.acc))
        args, all_take = slot_args(batch.dt, batch.remaining, batch.n_real,
                                   slice_steps, self.device)
        pos, vel, acc, finite = fn(
            batch.positions, batch.velocities, batch.masses, batch.acc,
            args, all_take, n_steps=slice_steps, probe=probe,
        )
        finite_host = finite.cpu().numpy()
        self.host_reads["finite"] += 1
        if probe is not None:
            self._record_first_round(key, probe, time.perf_counter() - t0)
        advanced, remaining, finite_np = account_slice(
            batch.remaining, batch.n_real, slice_steps, finite_host)
        new_batch = dataclasses.replace(
            batch, positions=pos, velocities=vel, acc=acc,
            remaining=remaining,
        )
        return new_batch, SliceResult(advanced=advanced, finite=finite_np)
