"""Per-backend circuit breakers — graceful degradation at admission.

Counterpart of ``gravity_tpu/serve/breaker.py``. A backend that cannot
build its kernel fails every round it is asked to run; the breaker
(closed -> open after N consecutive failures -> half-open trial after a
cooldown) moves that decision to ADMISSION: while a backend's breaker is
open, job keying walks the supervisor's exact-physics ladder
(``pallas-mxu -> pallas -> chunked``, supervisor.next_rung) and new jobs
route to a rung that works. Transitions are emitted as ``breaker_open``
/ ``breaker_closed`` serving events.

A ``sharded-integrate`` key's backend (``sharded/<devices>/<local>``)
walks the elastic half of the ladder first: half the devices down to 2,
then the solo form of the same kernel. One deliberate departure from the
JAX package: on the card the exact-physics ladder stops at ``pallas``, as
the port's supervisor's does (``on_card``), and no rung below it is a
plain PyTorch form. An open breaker there fails
admission with the breaker's reason (:class:`BreakerOpen`, a
ValueError: a 400 at submit, a failed job at a requeue); a kernel's job
is never rerouted to ``dense`` or ``chunked``. On the CPU the JAX
package's floor, the batched ``dense`` form, holds.
"""

from __future__ import annotations

import time
from typing import Optional

from ..supervisor import next_rung

# The serve engine's exact-physics floor on the CPU: the batched dense
# form. The card has none below the kernels.
ENGINE_LADDER_FLOOR = "dense"


class BreakerOpen(ValueError):
    """Admission refused: the backend's breaker is open and the ladder
    has no rung below it that may run (the card's ``pallas``)."""


class CircuitBreaker:
    """Closed / open / half-open for one backend name."""

    def __init__(
        self, backend: str, *, threshold: int = 3, cooldown_s: float = 30.0
    ):
        if threshold < 1 or cooldown_s < 0:
            raise ValueError("threshold >= 1 and cooldown_s >= 0 required")
        self.backend = backend
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.failures = 0
        self.state = "closed"  # closed | open | half-open
        self.opened_ts = 0.0
        # What opened it last (a kernel's error, an accuracy breach).
        self.reason = ""
        # Half-open admits exactly ONE trial: the first allow() after
        # the cooldown consumes it; everyone else keeps routing around
        # until that trial's outcome closes or re-opens the breaker.
        # If the trial job never actually reaches the backend
        # (cancelled, deadline-expired, bad config), a new trial
        # re-arms after another cooldown — the breaker can never wedge
        # half-open forever.
        self._trial_pending = False
        self._trial_ts = 0.0

    def allow(self, now: Optional[float] = None) -> bool:
        """May this backend be tried right now? An open breaker lets
        ONE trial through after the cooldown (half-open); its outcome
        closes or re-opens. Consuming: the True that grants the trial
        is returned once — concurrent keyings during the trial window
        stay rerouted (no thundering herd into a maybe-dead backend)."""
        if self.state == "closed":
            return True
        now = time.time() if now is None else now
        if self.state == "open" and now - self.opened_ts >= self.cooldown_s:
            self.state = "half-open"
            self._trial_pending = True
        if self.state == "half-open" and not self._trial_pending \
                and now - self._trial_ts >= self.cooldown_s:
            self._trial_pending = True  # aborted trial: re-arm
        if self.state == "half-open" and self._trial_pending:
            self._trial_pending = False
            self._trial_ts = now
            return True
        return False

    def record_failure(self, now: Optional[float] = None,
                       reason: str = "") -> bool:
        """Count one failure; returns True when this failure OPENED the
        breaker (the caller emits the event exactly once)."""
        now = time.time() if now is None else now
        self.failures += 1
        if reason:
            self.reason = reason
        if self.state == "half-open" or (
            self.state == "closed" and self.failures >= self.threshold
        ):
            self.state = "open"
            self.opened_ts = now
            self._trial_pending = False
            return True
        if self.state == "open":
            self.opened_ts = now
        return False

    def trip(self, now: Optional[float] = None, reason: str = "") -> bool:
        """Force the breaker OPEN regardless of the failure count —
        the accuracy sentinel's error-budget breach
        (docs/observability.md "Numerics"): a backend measured to be
        serving wrong answers is degraded exactly like one that cannot
        build, so admission reroutes down the exact-physics ladder.
        Returns True when this call newly opened it."""
        now = time.time() if now is None else now
        if reason:
            self.reason = reason
        was_open = self.state == "open"
        self.state = "open"
        self.opened_ts = now
        self._trial_pending = False
        return not was_open

    def record_success(self) -> bool:
        """Count one success; returns True when it CLOSED an open/half-
        open breaker."""
        self.failures = 0
        if self.state != "closed":
            self.state = "closed"
            return True
        return False

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "failures": self.failures,
            "threshold": self.threshold,
            "reason": self.reason,
        }


class BreakerBoard:
    """The scheduler's breaker registry + the admission reroute."""

    def __init__(self, *, threshold: int = 3, cooldown_s: float = 30.0,
                 on_card: bool = False):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        # On the card the ladder ends at the kernels (module docstring).
        self.on_card = on_card
        self._breakers: dict[str, CircuitBreaker] = {}

    def get(self, backend: str) -> CircuitBreaker:
        if backend not in self._breakers:
            self._breakers[backend] = CircuitBreaker(
                backend, threshold=self.threshold,
                cooldown_s=self.cooldown_s,
            )
        return self._breakers[backend]

    def success(self, backend: str) -> bool:
        """Record a success on an EXISTING breaker (never creates one —
        success is the steady state and needs no bookkeeping). Returns
        True when it closed an open/half-open breaker."""
        b = self._breakers.get(backend)
        return b.record_success() if b is not None else False

    def reroute(self, backend: str) -> str:
        """The first rung at or below ``backend`` whose breaker admits a
        try. On the CPU the dense floor is returned even with an open
        breaker (shedding beats refusing physics we can run); on the card
        an open breaker at the bottom kernel raises :class:`BreakerOpen`
        with its reason."""
        seen = backend
        while self._breakers.get(seen) is not None \
                and not self._breakers[seen].allow():
            nxt = next_rung(seen, on_card=self.on_card)
            if nxt is None:
                if self.on_card:
                    b = self._breakers[seen]
                    raise BreakerOpen(
                        f"backend {seen!r} is unavailable: its circuit "
                        f"breaker is open after {b.failures} failure(s)"
                        + (f" (last: {b.reason})" if b.reason else "")
                        + "; on the card no plain PyTorch form takes a "
                        "kernel's job"
                    )
                if seen != ENGINE_LADDER_FLOOR:
                    nxt = ENGINE_LADDER_FLOOR
                else:
                    return seen
            seen = nxt
        return seen

    def snapshot(self) -> dict:
        return {
            name: b.snapshot() for name, b in self._breakers.items()
        }
