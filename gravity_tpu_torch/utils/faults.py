"""Deterministic fault injection: every recovery path, testable on the CPU.

Counterpart of the run-loop part of ``gravity_tpu/utils/faults.py``. None
of the failures the supervisor heals (divergence, transient device
errors, an unbuildable backend, preemption, an accuracy breach) happens
on its own in a short test, so each is injectable here and fires at the
code point where the real fault would surface: a divergence at a block
boundary (the fixed-dt loop takes the consumed block's watchdog verdict
as non-finite, :func:`divergence_due`; the adaptive loop NaNs a copy of
its state, :func:`maybe_corrupt_state`, and its watchdog trips through
its detection path), :class:`TransientFault` is raised at block start,
:class:`BackendUnavailable` when a Simulator is built, and a real SIGTERM
is sent to this process (the signal handler itself is exercised).

These two exceptions come from the fault plan and from nowhere else: a
kernel that fails to build or to launch raises its own error, which
propagates and is never turned into either of them.

The plan comes from the ``GRAVITY_TPU_FAULTS`` environment variable (so
subprocesses inherit it) or from :func:`install`. Grammar, items
separated by commas:

    diverge@STEP          a non-finite state at the first block
                          boundary crossing STEP (fires once)
    transient@STEP        raise TransientFault at the first block starting
                          at or after STEP; ``transient@STEPxCOUNT``
                          repeats it COUNT times
    preempt@STEP          send SIGTERM to this process at the first block
                          boundary crossing STEP (fires once)
    backend:NAME          building force backend NAME raises
                          BackendUnavailable (persistent)
    accuracy_breach@STEP  the sentinel's first probe at or after STEP
                          reports an error past any budget (fires once)

The serving layer's items fire in ``serve/`` and its spool writes, as in
the JAX package:

    crash_worker@R        SIGKILL this process at scheduling round R
    stall_worker@RxSECS   pause the worker SECS seconds at round R, its
                          lease heartbeats suspended
    stale_lease@R[xSECS]  backdate the worker's leases at round R and stop
                          renewing for SECS (default 30) seconds
    torn_spool_write@K    the K-th (0-based) atomic JSON write lands
                          truncated
    drop_result_write@K   the K-th result write reports success and
                          writes nothing
    torn_progress_write@K the K-th progress snapshot lands truncated
    disk_full@K           the K-th durable spool write raises ENOSPC

and the sharded job class's (``serve/jobs/sharded.py``):

    mesh_fail@K           fail the (K+1)-th build of a sharded key's worker
                          group with BackendUnavailable (``xCOUNT`` fails
                          COUNT consecutive builds): the elastic ladder
                          re-keys to fewer devices
    collective_stall@RxS  at the sharded slice R (the batch's
                          ``slices_run``) hold the group's collective S
                          seconds, past its watchdog: the group is torn
                          down and the round fails with BackendUnavailable

Example: ``GRAVITY_TPU_FAULTS="transient@10x2,diverge@20"``.
"""

from __future__ import annotations

import dataclasses
import os
import signal
from typing import Optional

ENV_KNOB = "GRAVITY_TPU_FAULTS"

RUN_KINDS = ("diverge", "transient", "preempt", "accuracy_breach")
SERVING_KINDS = (
    "crash_worker", "stall_worker", "stale_lease", "torn_spool_write",
    "drop_result_write", "torn_progress_write", "disk_full", "mesh_fail",
    "collective_stall",
)


class TransientFault(RuntimeError):
    """An injected transient device or runtime error: the class the
    supervisor retries with exponential backoff."""


class BackendUnavailable(RuntimeError):
    """An injected unbuildable force backend: the class the supervisor
    degrades down the backend ladder."""

    def __init__(self, backend: str, reason: str = "fault injection"):
        super().__init__(
            f"force backend {backend!r} unavailable ({reason})"
        )
        self.backend = backend


@dataclasses.dataclass
class _Fault:
    kind: str
    step: int = 0
    count: int = 1
    backend: str = ""
    # Was COUNT written (KIND@STEPxCOUNT)? stale_lease's payload needs to
    # tell "x1" from none given.
    explicit_count: bool = False


class FaultPlan:
    """A parsed, stateful plan (counts decrement as faults fire)."""

    def __init__(self, faults: list):
        self._faults = faults
        # Ordinal counters of the write-granular serving faults: they key
        # off how many such writes came before, not a step.
        self._spool_writes = 0
        self._result_writes = 0
        self._progress_writes = 0
        self._durable_writes = 0
        self._mesh_builds = 0

    @staticmethod
    def parse(spec: str) -> "FaultPlan":
        faults = []
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if item.startswith("backend:"):
                faults.append(
                    _Fault(kind="backend", backend=item.split(":", 1)[1])
                )
                continue
            if "@" not in item:
                raise ValueError(
                    f"bad fault spec {item!r}: expected KIND@STEP[xCOUNT] "
                    "or backend:NAME"
                )
            kind, arg = item.split("@", 1)
            count = 1
            explicit = "x" in arg
            if explicit:
                arg, cnt = arg.split("x", 1)
                count = int(cnt)
            step = int(arg)
            if kind not in RUN_KINDS + SERVING_KINDS:
                raise ValueError(f"unknown fault kind {kind!r}")
            faults.append(_Fault(kind=kind, step=step, count=count,
                                 explicit_count=explicit))
        return FaultPlan(faults)

    def _take(self, kind: str, due) -> Optional[_Fault]:
        """Consume one occurrence of the first matching armed fault."""
        for f in self._faults:
            if f.kind == kind and f.count > 0 and due(f):
                f.count -= 1
                return f
        return None

    def corrupt_due(self, prev_step: int, step: int) -> bool:
        return self._take(
            "diverge", lambda f: prev_step < f.step <= step
        ) is not None

    def transient_due(self, step: int) -> bool:
        return self._take("transient", lambda f: step >= f.step) is not None

    def preempt_due(self, prev_step: int, step: int) -> bool:
        return self._take(
            "preempt", lambda f: prev_step < f.step <= step
        ) is not None

    def breach_due(self, step: int) -> bool:
        return self._take(
            "accuracy_breach", lambda f: step >= f.step
        ) is not None

    def backend_down(self, backend: str) -> bool:
        # Persistent: a platform that cannot build a kernel fails every
        # attempt, which the degrade ladder must survive.
        return any(
            f.kind == "backend" and f.backend == backend
            for f in self._faults
        )


_active: Optional[FaultPlan] = None
_parsed_env = False


def active() -> Optional[FaultPlan]:
    """The process-wide plan (the environment is parsed lazily; None = no
    injection)."""
    global _active, _parsed_env
    if _active is None and not _parsed_env:
        _parsed_env = True
        spec = os.environ.get(ENV_KNOB, "")
        if spec:
            _active = FaultPlan.parse(spec)
    return _active


def install(spec: str) -> FaultPlan:
    """Install a plan in this process (tests)."""
    global _active, _parsed_env
    _active = FaultPlan.parse(spec)
    _parsed_env = True
    return _active


def reset() -> None:
    """Drop the plan; the next :func:`active` reads the environment again."""
    global _active, _parsed_env
    _active = None
    _parsed_env = False


def maybe_corrupt_state(state, prev_step: int, step: int):
    """A copy of ``state`` with one NaN coordinate when a diverge fault
    crosses ``(prev_step, step]``, else ``state`` itself."""
    plan = active()
    if plan is None or not plan.corrupt_due(prev_step, step):
        return state
    positions = state.positions.clone()
    positions[0, 0] = float("nan")
    return state.replace(positions=positions)


def divergence_due(prev_step: int, step: int) -> bool:
    """Does a diverge fault cross ``(prev_step, step]``? The fixed-dt loop
    then takes the block's watchdog verdict as non-finite. (Fires once.)"""
    plan = active()
    return plan is not None and plan.corrupt_due(prev_step, step)


def maybe_raise_transient(step: int) -> None:
    plan = active()
    if plan is not None and plan.transient_due(step):
        raise TransientFault(
            f"injected transient device error at step {step}"
        )


def maybe_preempt(prev_step: int, step: int) -> None:
    """Send a real SIGTERM, so that the handler itself is exercised."""
    plan = active()
    if plan is not None and plan.preempt_due(prev_step, step):
        os.kill(os.getpid(), signal.SIGTERM)


def check_backend(*names: str) -> None:
    """Raise :class:`BackendUnavailable` when the plan takes down any of
    ``names`` (a backend's config name and its resolved name)."""
    plan = active()
    if plan is None:
        return
    for name in names:
        if plan.backend_down(name):
            raise BackendUnavailable(name)


def accuracy_breach_due(step: int) -> bool:
    """Should the sentinel probe at ``step`` report an injected error past
    any budget? (Fires once.)"""
    plan = active()
    return plan is not None and plan.breach_due(step)


# --- hooks called from the serving layer (gravity_tpu_torch/serve/) ---


def maybe_crash_worker(round_no: int) -> None:
    """SIGKILL this process at the start of scheduling round ``round_no``:
    no atexit, no finally, no lease release, like ``kill -9``."""
    plan = active()
    if plan is not None and plan._take(
            "crash_worker", lambda f: round_no >= f.step) is not None:
        os.kill(os.getpid(), signal.SIGKILL)


def _take_once_with_payload(plan: FaultPlan, kind: str, due) -> int:
    """Consume a whole fault (COUNT is a payload in seconds here, not a
    repeat count) and return its payload, or 0."""
    for f in plan._faults:
        if f.kind == kind and f.count > 0 and due(f):
            payload, f.count = f.count, 0
            return payload
    return 0


def stall_worker_secs(round_no: int) -> float:
    """Seconds to pause the worker at this round (0 = no stall due)."""
    plan = active()
    if plan is None:
        return 0.0
    return float(_take_once_with_payload(
        plan, "stall_worker", lambda f: round_no >= f.step))


def stale_lease_secs(round_no: int, default_s: float = 30.0) -> float:
    """Heartbeat-suspension seconds of a due ``stale_lease`` fault (0 =
    not due): a bare ``stale_lease@R`` takes ``default_s``, an explicit
    ``xSECS`` (x1 too) is taken as written."""
    plan = active()
    if plan is None:
        return 0.0
    for f in plan._faults:
        if f.kind == "stale_lease" and f.count > 0 and round_no >= f.step:
            payload, f.count = f.count, 0
            return float(payload if f.explicit_count else default_s)
    return 0.0


def _ordinal_due(kind: str, counter: str) -> bool:
    plan = active()
    if plan is None:
        return False
    seq = getattr(plan, counter)
    setattr(plan, counter, seq + 1)
    return plan._take(kind, lambda f: seq >= f.step) is not None


def mesh_fail_due() -> bool:
    """One injected failure of a sharded group's build due? Counted a
    build attempt (``serve/jobs/sharded.py`` raises BackendUnavailable on
    True, so the elastic ladder walks through its real path)."""
    plan = active()
    if plan is None:
        return False
    seq = plan._mesh_builds
    plan._mesh_builds += 1
    return plan._take("mesh_fail", lambda f: seq >= f.step) is not None


def collective_stall_secs(round_no: int) -> float:
    """Seconds a due ``collective_stall`` holds the sharded slice
    ``round_no`` (0 = not due); fires once."""
    plan = active()
    if plan is None:
        return 0.0
    return float(_take_once_with_payload(
        plan, "collective_stall", lambda f: round_no >= f.step))


def torn_write_due() -> bool:
    """One torn JSON write due? (utils/hostio.atomic_write_json)"""
    return _ordinal_due("torn_spool_write", "_spool_writes")


def drop_result_due() -> bool:
    """One silently dropped result write due? (Spool.write_result)"""
    return _ordinal_due("drop_result_write", "_result_writes")


def torn_progress_due() -> bool:
    """One torn progress-snapshot write due? (Spool.write_progress, whose
    checksum must catch it)"""
    return _ordinal_due("torn_progress_write", "_progress_writes")


def disk_full_due() -> None:
    """Raise an injected ENOSPC when a ``disk_full`` fault is due, at the
    spool's result and progress writes."""
    if _ordinal_due("disk_full", "_durable_writes"):
        import errno

        raise OSError(errno.ENOSPC,
                      "No space left on device (injected disk_full)")
