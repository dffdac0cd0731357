"""Self-healing run supervisor: every abort path becomes a recovery path.

Counterpart of ``gravity_tpu/supervisor.py``:

- **Divergence** (:class:`~gravity_tpu_torch.simulation.SimulationDiverged`):
  roll back to the last verified checkpoint (a corrupt snapshot falls
  back to an older one) and integrate the bad interval again at halved
  dt; past it, the original dt resumes. Each recurrence halves again,
  bounded by ``max_retries``.
- **Transient errors** (:class:`~gravity_tpu_torch.utils.faults.
  TransientFault`): retry with exponential backoff from the last finite
  in-memory state.
- **An unbuildable backend** (:class:`~gravity_tpu_torch.utils.faults.
  BackendUnavailable`): degrade down the ladder ``pallas-mxu`` (the
  ``nbody_mxu`` kernel) -> ``pallas`` (``nbody_direct``) -> ``chunked``
  (the plain PyTorch sum). On the card the ladder stops at its last
  kernel rung: no rung below it runs plain PyTorch on card tensors, and
  the failure propagates instead (the CLI exits 2).
- **An accuracy breach** (:class:`~gravity_tpu_torch.simulation.
  AccuracyBreach`): re-size the tree's or the FMM's leaf cap once, then
  reroute to an exact direct sum (on the card, only to a kernel).
- **Preemption** (SIGTERM -> :class:`~gravity_tpu_torch.simulation.
  SimulationPreempted`): the run loop checkpoints; the supervisor records
  the event and re-raises, so that the CLI exits with
  :data:`EXIT_PREEMPTED`.

Only the fault plan (``utils/faults.py``) raises ``TransientFault`` and
``BackendUnavailable``. A kernel that fails to build or launch raises its
own error, which no rung catches: it propagates and the run fails, so
that no route hides a broken kernel. Every action is a JSONL recovery
event (``diverged``, ``rolled_back``, ``retry``, ``degraded``,
``preempted``, ``accuracy_breach``; ``utils/logging.RecoveryEventLogger``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from .config import NotPortedError, SimulationConfig
from .simulation import (
    JAX_NAMES,
    AccuracyBreach,
    SimulationDiverged,
    SimulationPreempted,
    Simulator,
    _resolve_backend,
    _resolve_direct,
    preemption_guard,
)
from .utils.checkpoint import (
    CheckpointCorrupt,
    make_checkpoint_manager,
    restore_checkpoint_with_extra,
    save_checkpoint,
)
from .utils.faults import BackendUnavailable, TransientFault
from .utils.platform import DeviceLike, resolve_device

# Process exit codes. 75 is EX_TEMPFAIL, "transient failure, retry me",
# apart from the hard failure 2, so that schedulers requeue a preempted
# run.
EXIT_OK = 0
EXIT_ERROR = 1
EXIT_FAILED = 2
EXIT_PREEMPTED = 75

# The exact-physics degrade ladder, by the JAX package's backend names:
# the Gram-form kernel, the direct-sum kernel, the plain PyTorch sum.
# Approximate solvers are not rungs: swapping physics is not a recovery.
BACKEND_LADDER = ("pallas-mxu", "pallas", "chunked")
# The backends that are plain PyTorch on any device: rungs for CPU
# tensors only.
PLAIN_BACKENDS = ("dense", "chunked")

_NOT_PORTED_SHARDED = (
    "sharded backends (sharded/<devices>/<local>) are not ported to "
    "gravity_tpu_torch yet (ROADMAP.md Queue 1 item 5, multi-GPU)"
)


def parse_sharded_backend(backend: str):
    """The JAX package's ``sharded/<devices>/<local>`` form: refused, its
    mesh is ROADMAP.md Queue 1 item 5."""
    raise NotPortedError(f"{backend!r}: {_NOT_PORTED_SHARDED}")


def next_rung(backend: str, ladder: tuple = BACKEND_LADDER, *,
              on_card: bool = False) -> Optional[str]:
    """The next rung down the exact-physics ladder, or None at (or off)
    its bottom. The port's resolved kernel names map to the JAX names
    (``nbody_mxu`` -> ``pallas-mxu``, ``nbody_direct`` -> ``pallas``); the
    cell list's rung is the masked direct sum (``chunked``), its exact
    reference. ``on_card``: the plain rungs are off the ladder, so that no
    recovery runs card tensors through plain PyTorch in place of a
    kernel."""
    if backend.startswith("sharded/"):
        parse_sharded_backend(backend)
    backend = JAX_NAMES.get(backend, backend)
    if backend == "nlist":
        nxt = "chunked"
    elif backend not in ladder:
        return None
    else:
        i = ladder.index(backend)
        nxt = ladder[i + 1] if i + 1 < len(ladder) else None
    if on_card and nxt in PLAIN_BACKENDS:
        return None
    return nxt


@dataclasses.dataclass
class SupervisorPolicy:
    """Recovery knobs (CLI: ``--max-retries``, ``--on-diverge``)."""

    max_retries: int = 3  # a failure class
    on_diverge: str = "halve-dt"  # halve-dt | abort
    backoff_s: float = 0.25  # the first transient retry's delay
    backoff_max_s: float = 8.0
    backend_ladder: tuple = BACKEND_LADDER

    @staticmethod
    def from_config(config: SimulationConfig) -> "SupervisorPolicy":
        if config.on_diverge not in ("halve-dt", "abort"):
            raise ValueError(
                f"on_diverge must be 'halve-dt' or 'abort', got "
                f"{config.on_diverge!r}"
            )
        return SupervisorPolicy(max_retries=config.max_retries,
                                on_diverge=config.on_diverge)


class RunSupervisor:
    """Wraps ``Simulator.run``/``run_adaptive`` in the recovery loop.

    The supervisor always has a checkpoint manager (made at
    ``config.checkpoint_dir`` when none is given): the divergence
    watchdog's emergency save of the last finite state is the rollback
    point, whatever the checkpoint cadence.

    Steps are counted in the original dt throughout: a recovery segment
    covering ``span`` original steps runs ``span * 2**halvings`` halved
    steps, then the supervisor saves its end at step ``start + span``, so
    that checkpoints stay monotone. Trajectory and metrics streams follow
    the main legs only; after a rollback they may hold frames of the
    discarded interval (append-only streams cannot be rewound)."""

    def __init__(
        self,
        config: SimulationConfig,
        policy: Optional[SupervisorPolicy] = None,
        *,
        logger=None,
        events=None,
        checkpoint_manager=None,
        trajectory_writer=None,
        metrics_logger=None,
        state=None,
        start_step: int = 0,
        start_t: float = 0.0,
        start_comp: float = 0.0,
        device: DeviceLike = None,
    ):
        self.config = config
        self.policy = policy or SupervisorPolicy.from_config(config)
        self.logger = logger
        self.events = events
        self.writer = trajectory_writer
        self.metrics = metrics_logger
        self.device = resolve_device(device)
        if checkpoint_manager is None:
            checkpoint_manager = make_checkpoint_manager(
                config.checkpoint_dir)
        self.mgr = checkpoint_manager
        self._state = state
        self._start_step = start_step
        self._start_t = start_t
        self._start_comp = start_comp
        self.diverge_retries = 0
        self.transient_retries = 0
        self.accuracy_retries = 0
        # Whether the leaf-cap rung of the accuracy heal has been spent: a
        # recurrence reroutes instead of re-sizing forever.
        self._releafed = False
        self.degraded_from: Optional[str] = None
        # The Simulator of the completed final leg (``--debug-check``
        # audits it).
        self.last_sim: Optional[Simulator] = None

    def _event(self, kind: str, /, **fields) -> None:
        if self.events is not None:
            self.events.event(kind, **fields)
        if self.logger is not None:
            detail = " ".join(f"{k}={v}" for k, v in fields.items())
            self.logger.log_print(f"[supervisor] {kind}: {detail}")

    def _build(self, config: SimulationConfig, state) -> Simulator:
        """A Simulator, walking the degrade ladder when the fault plan
        takes its backend down. Only that typed failure walks it: a real
        kernel build or launch error propagates."""
        while True:
            try:
                return Simulator(config, state=state, device=self.device)
            except BackendUnavailable as e:
                nxt = self._degrade_target(config)
                if nxt is None:
                    raise
                self._event("degraded", from_backend=config.force_backend,
                            to_backend=nxt, error=str(e))
                self.degraded_from = (self.degraded_from
                                      or config.force_backend)
                config = dataclasses.replace(config, force_backend=nxt)
                # For every later leg and segment of this run.
                self.config = dataclasses.replace(self.config,
                                                  force_backend=nxt)

    @property
    def _on_card(self) -> bool:
        return self.device.type == "cuda"

    def _degrade_target(self, config: SimulationConfig) -> Optional[str]:
        """The next rung below the resolved backend (``auto`` on a card
        that cannot build its chosen kernel degrades too)."""
        backend = config.force_backend
        if backend not in self.policy.backend_ladder:
            backend = _resolve_backend(config, self.device)
        return next_rung(backend, self.policy.backend_ladder,
                         on_card=self._on_card)

    def _accuracy_heal(self, e: AccuracyBreach, sim) -> None:
        """Heal an error-budget breach; the state is finite, the solver
        is wrong for the data. (1) Once, a tree's or an FMM's leaf cap
        re-sized to ``ops/tree.recommended_leaf_cap`` of the current state
        (the classic overload: an under-capped dense core degrading to
        overflow monopoles); (2) the scale-appropriate exact direct sum in
        place of the approximate solver (an exact backend that breaches
        walks the ladder). Raises the breach past the retry budget or with
        no rung left."""
        if self.accuracy_retries >= self.policy.max_retries:
            raise e
        self.accuracy_retries += 1
        config = self.config
        if e.backend in ("tree", "fmm", "sfmm") and not self._releafed:
            self._releafed = True
            from .ops.tree import recommended_depth_data, recommended_leaf_cap

            if sim is not None:
                positions = sim.final_state().positions
                depth = config.tree_depth or recommended_depth_data(
                    positions, config.tree_leaf_cap)
                new_cap = recommended_leaf_cap(positions, depth)
                if new_cap > config.tree_leaf_cap:
                    self._event("retry", kind="accuracy", step=e.step,
                                backend=e.backend, leaf_cap=new_cap,
                                from_leaf_cap=config.tree_leaf_cap,
                                attempt=self.accuracy_retries)
                    self.config = dataclasses.replace(
                        config, tree_leaf_cap=new_cap)
                    return
        if e.backend in ("tree", "fmm", "sfmm", "pm", "p3m"):
            nxt = _resolve_direct(config, self._on_card)
            if self._on_card and nxt in PLAIN_BACKENDS:
                nxt = None
        else:
            nxt = next_rung(e.backend, self.policy.backend_ladder,
                            on_card=self._on_card)
        if nxt is None or nxt == JAX_NAMES.get(e.backend, e.backend):
            raise e
        self._event("degraded", from_backend=e.backend, to_backend=nxt,
                    error=str(e))
        self.degraded_from = self.degraded_from or e.backend
        self.config = dataclasses.replace(config, force_backend=nxt)

    def _backoff(self, error: Exception, at_step) -> None:
        """Count, log and sleep one transient retry (raises past the
        budget)."""
        if self.transient_retries >= self.policy.max_retries:
            raise error
        self.transient_retries += 1
        delay = min(self.policy.backoff_s * 2 ** (self.transient_retries - 1),
                    self.policy.backoff_max_s)
        self._event("retry", kind="transient", step=at_step,
                    attempt=self.transient_retries, backoff_s=delay,
                    error=str(error))
        time.sleep(delay)

    def _annotate(self, stats: dict) -> dict:
        if (self.diverge_retries or self.transient_retries
                or self.accuracy_retries or self.degraded_from):
            stats["supervisor"] = {
                "diverge_retries": self.diverge_retries,
                "transient_retries": self.transient_retries,
                "accuracy_retries": self.accuracy_retries,
                "degraded_from": self.degraded_from,
                "backend": self.config.force_backend,
            }
        return stats

    def run(self) -> dict:
        # The guard covers the supervisor's own windows too (backoff
        # sleeps, rebuilds between legs).
        with preemption_guard():
            if self.config.adaptive:
                return self._run_adaptive()
            return self._run_fixed()

    def _block(self) -> int:
        return max(1, min(self.config.progress_every, self.config.steps))

    def _run_fixed(self) -> dict:
        policy = self.policy
        state = self._state
        step = self._start_step
        # The dt-halving depth of the current bad interval; back to 0 once
        # a recovery segment lands.
        halvings = 0
        sim = None
        while True:
            try:
                if halvings == 0:
                    # Main leg: the original dt from `step` to the end.
                    sim = self._build(self.config, state)
                    stats = sim.run(
                        self.logger, steps=self.config.steps,
                        start_step=step, trajectory_writer=self.writer,
                        checkpoint_manager=self.mgr,
                        metrics_logger=self.metrics,
                    )
                    self.last_sim = sim
                    return self._annotate(stats)
                # Recovery segment: one block of original steps at
                # dt / 2**halvings, off the user's streams, serial (the
                # watchdog then fires at the block that diverges).
                span = min(self._block(), self.config.steps - step)
                factor = 2 ** halvings
                seg_cfg = dataclasses.replace(
                    self.config, dt=self.config.dt / factor,
                    steps=span * factor, checkpoint_every=0,
                    record_trajectories=False, io_pipeline="off")
                self._event("retry", kind="diverge", step=step, span=span,
                            dt=seg_cfg.dt, attempt=self.diverge_retries)
                sim = self._build(seg_cfg, state)
                seg = sim.run(None)
                state = seg["final_state"]
                step += span
                halvings = 0
                save_checkpoint(self.mgr, step, state)
                continue
            except SimulationPreempted:
                # Preempted in the supervisor's own bookkeeping: save the
                # resume point held here (an identical re-save is a
                # no-op).
                if state is not None and step > self._start_step:
                    try:
                        save_checkpoint(self.mgr, step, state)
                    except Exception:  # noqa: BLE001 — must not mask
                        pass  # the preemption
                self._event("preempted",
                            step=getattr(sim, "_last_step", step))
                raise
            except SimulationDiverged as e:
                self._event("diverged", step=e.step,
                            retries_used=self.diverge_retries)
                if (policy.on_diverge != "halve-dt"
                        or self.diverge_retries >= policy.max_retries):
                    raise
                self.diverge_retries += 1
                if halvings == 0:
                    # The watchdog saved the last finite state; max_step
                    # rejects newer snapshots of another run sharing the
                    # directory. No usable snapshot: the divergence
                    # propagates.
                    try:
                        state, step, _ = restore_checkpoint_with_extra(
                            self.mgr, max_step=e.step)
                    except (FileNotFoundError, CheckpointCorrupt):
                        raise e
                # Else the segment itself diverged: halve deeper from the
                # same snapshot.
                halvings += 1
                self._event("rolled_back", to_step=step, halvings=halvings)
                continue
            except TransientFault as e:
                self._backoff(e, getattr(sim, "_last_step", step))
                if halvings == 0 and sim is not None:
                    # A transient error leaves the state good: continue
                    # from the last consumed block.
                    state = sim.final_state()
                    step = sim._last_step
                continue
            except AccuracyBreach as e:
                # The state is finite: continue from the last consumed
                # block with a healed solver.
                self._event("accuracy_breach", step=e.step,
                            backend=e.backend, p90_rel_err=e.p90_rel_err,
                            budget=e.budget)
                self._accuracy_heal(e, sim)
                if halvings == 0 and sim is not None:
                    state = sim.final_state()
                    step = sim._last_step
                continue

    def _run_adaptive(self) -> dict:
        """Adaptive runs heal by halving eta: on divergence, roll back to
        the last verified checkpoint (which carries t and the Kahan
        compensation) and retry with a halved safety factor, which
        persists (the criterion re-expands dt past the bad interval)."""
        policy = self.policy
        eta = self.config.eta
        state = self._state
        s0 = self._start_step
        t0, comp0 = self._start_t, self._start_comp
        sim = None
        while True:
            try:
                cfg = dataclasses.replace(self.config, eta=eta)
                sim = self._build(cfg, state)
                stats = sim.run_adaptive(
                    self.logger, trajectory_writer=self.writer,
                    checkpoint_manager=self.mgr,
                    metrics_logger=self.metrics,
                    start_t=t0, start_comp=comp0, start_steps=s0,
                )
                self.last_sim = sim
                return self._annotate(stats)
            except SimulationPreempted:
                snap = getattr(sim, "_snap", None)
                if snap is not None and snap[1] > self._start_step:
                    try:
                        save_checkpoint(self.mgr, snap[1], snap[0],
                                        extra={"t": snap[2],
                                               "comp": snap[3]})
                    except Exception:  # noqa: BLE001 — must not mask
                        pass  # the preemption
                self._event("preempted",
                            step=getattr(sim, "_last_step", s0),
                            mode="adaptive")
                raise
            except SimulationDiverged as e:
                self._event("diverged", step=e.step, mode="adaptive",
                            retries_used=self.diverge_retries)
                if (policy.on_diverge != "halve-dt"
                        or self.diverge_retries >= policy.max_retries):
                    raise
                self.diverge_retries += 1
                state, s0, t0, comp0 = self._adaptive_rollback(
                    max_step=e.step)
                eta /= 2.0
                self._event("rolled_back", to_step=s0, t=t0,
                            mode="adaptive")
                self._event("retry", kind="diverge", eta=eta,
                            mode="adaptive", attempt=self.diverge_retries)
                continue
            except TransientFault as e:
                self._backoff(e, getattr(sim, "_last_step", s0))
                snap = getattr(sim, "_snap", None) if sim else None
                if snap is not None:
                    state, s0, t0, comp0 = snap
                continue

    def _adaptive_rollback(self, max_step=None):
        """(state, steps, t, comp) of the newest verified checkpoint at or
        below ``max_step``, or the supervisor's own starting point when
        none exists yet."""
        try:
            state, step, extra = restore_checkpoint_with_extra(
                self.mgr, max_step=max_step)
        except FileNotFoundError:
            return (self._state, self._start_step, self._start_t,
                    self._start_comp)
        return state, step, extra.get("t", 0.0), extra.get("comp", 0.0)


def supervise(config: SimulationConfig, **kwargs) -> dict:
    """Build a :class:`RunSupervisor` and run it."""
    return RunSupervisor(config, **kwargs).run()
