"""Crash flight recorder: a bounded in-memory ring of the last N
spans/events per worker, dumped atomically to a JSON file when
something goes wrong.

Copied from ``gravity_tpu/telemetry/flightrec.py`` (host only; the port
keeps its own copy).

Chaos postmortems used to depend on whatever happened to be in
``serving_events.jsonl`` when a worker died — the streams are
per-concern and unbounded, so "what was the fleet doing when worker A
got SIGKILLed?" meant grepping three files and hoping. The recorder
keeps the merged recent history (serving events, spans, lease
transitions, compile marks) in one ring that costs an append while
healthy and is written out — ``flightrec_<worker>_<ts>.json`` — on:

- divergence (a slot's watchdog flagged non-finite state),
- a circuit breaker opening,
- SIGTERM (the daemon's and the solo run's preemption path),
- a fatal round error (the donated-batch crash path),
- demand (``GET /flightrec`` on the daemon).

Format (docs/observability.md "Flight recorder"): ``{"v": 1,
"worker": ..., "reason": ..., "ts": ..., "capacity": N, "entries":
[{"ts": ..., "kind": ..., ...}, ...]}`` — entries oldest-first.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

DEFAULT_CAPACITY = 512

# Dump-trigger reasons (docs lint tables them).
DUMP_REASONS = (
    "divergence", "breaker_open", "sigterm", "round_error",
    "adoption", "request", "accuracy_breach", "recompile_storm",
)


class FlightRecorder:
    """Thread-safe bounded ring + atomic dump."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 out_dir: Optional[str] = None,
                 worker: Optional[str] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.out_dir = out_dir
        self.worker = worker or f"pid-{os.getpid()}"
        self._ring: deque = deque(maxlen=capacity)
        # RLock, not Lock: dump() runs from SIGTERM handlers, which
        # Python executes on the main thread between bytecodes — if the
        # signal lands while that same thread is inside record()
        # holding the lock, a plain Lock would deadlock the shutdown
        # path the dump exists to observe.
        self._lock = threading.RLock()
        self.dumps = 0
        self._seq = 0  # filename sequence, reserved under the lock
        self.last_dump_path: Optional[str] = None

    def record(self, kind: str, /, **fields) -> None:
        entry = {"ts": round(time.time(), 3), "kind": kind, **fields}
        with self._lock:
            self._ring.append(entry)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self) -> list:
        with self._lock:
            return list(self._ring)

    def dump(self, reason: str,
             out_dir: Optional[str] = None) -> Optional[str]:
        """Write the ring to ``flightrec_<worker>_<ts>_<k>.json``
        (tmp + os.replace: a reader never sees a half dump); returns
        the path, or None when there is nowhere to write. Never raises
        — the dump rides crash paths that must keep crashing the way
        they were going to."""
        out = out_dir or self.out_dir
        if out is None:
            return None
        payload = {
            "v": 1,
            "worker": self.worker,
            "reason": reason,
            "ts": round(time.time(), 3),
            "capacity": self.capacity,
            "entries": self.snapshot(),
        }
        ts = time.strftime("%Y%m%d_%H%M%S")
        # Reserve the filename sequence number under the lock: the
        # worker thread (divergence) and an HTTP thread (/flightrec)
        # dumping in the same wall-clock second must not compute the
        # same path and silently overwrite one postmortem with the
        # other (review finding).
        with self._lock:
            seq = self._seq
            self._seq += 1
        path = os.path.join(
            out, f"flightrec_{self.worker}_{ts}_{seq}.json"
        )
        tmp = f"{path}.tmp.{os.getpid()}.{seq}"
        try:
            os.makedirs(out, exist_ok=True)
            with open(tmp, "w") as f:
                # default=str: ring entries may carry numpy scalars or
                # exception objects from hot paths; a dump must never
                # fail over a field's type.
                f.write(json.dumps(payload, default=str))
            os.replace(tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return None
        with self._lock:
            self.dumps += 1
            self.last_dump_path = path
        return path
