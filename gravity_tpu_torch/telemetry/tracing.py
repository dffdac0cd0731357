"""End-to-end job tracing: spans over the whole serving lifecycle.

Copied from ``gravity_tpu/telemetry/tracing.py`` (host only; the port keeps
its own copy). The port emits the serving spans, the pod router's
``route`` span and a solo run's spans (``run --trace``);
``gravity_tpu_torch trace-export`` renders a trace.

Every job gets a **trace id** at submit; each phase of its life —
admission (with the autotune probe as a child), queue wait, slot load,
compile, every round slice, the result D2H, and the spool write — is a
**span**: one JSONL line ``{"v": 1, "ts": ..., "event": "span",
"trace": ..., "span": ..., "parent": ..., "name": ..., "t0": <wall
start>, "dur_s": ..., "worker": ..., **attrs}`` appended (O_APPEND,
one line per record — the :class:`~gravity_tpu_torch.utils.logging.
JsonlEventLogger` spine) to ``traces.jsonl`` under the spool/log dir.

Workers sharing a spool append to ONE trace stream, and the trace id
rides the spool job record — so when a worker dies and a survivor
adopts its job, the dead worker's spans and the adopter's stitch into
one trace with no join step. ``gravity_tpu trace-export`` converts a
trace to Chrome/Perfetto ``trace_event`` JSON (one process per trace,
one thread lane per worker) so "where did this job's 9 seconds go?"
is a picture, not a grep (docs/observability.md "Trace model").

Solo runs (`gravity_tpu run --trace`) emit the same span structure
(block/checkpoint spans) through the same stream format.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import time
import uuid
from typing import Optional

from ..utils.logging import JsonlEventLogger

# Canonical span names (docs/observability.md tables these; the docs
# lint asserts coverage). Serving lifecycle first, solo-run spans last.
SPAN_NAMES = (
    "admission", "autotune_probe", "queue", "slot_load", "compile",
    "round", "d2h", "result_write", "adopted", "progress_snapshot",
    "block", "checkpoint", "sentinel",
    # The pod router's hop: /submit receipt -> worker acceptance,
    # stitched into the job's own trace via the spool-persisted trace
    # id (docs/serving.md "Pod topology & router").
    "route",
)


def new_trace_id() -> str:
    return f"tr-{uuid.uuid4().hex[:12]}"


def new_span_id() -> str:
    return f"sp-{uuid.uuid4().hex[:10]}"


class TraceEventLogger(JsonlEventLogger):
    """The span stream — same JSONL spine (ts + schema version +
    worker context) as every other event stream in the repo."""

    KINDS = ("span",)


class Tracer:
    """Span emitter. ``path=None`` disables the file stream (spans
    still mirror into the flight recorder's ring when one is
    attached); emission never raises into the serving path."""

    def __init__(self, path: Optional[str] = None,
                 worker: Optional[str] = None, recorder=None):
        self.path = path
        self.worker = worker
        self.recorder = recorder
        self._log = (
            TraceEventLogger(
                path, context={"worker": worker} if worker else None
            )
            if path else None
        )

    @property
    def enabled(self) -> bool:
        return self._log is not None or self.recorder is not None

    def emit(
        self, name: str, trace: str, t0: float, dur_s: float, *,
        parent: Optional[str] = None, span_id: Optional[str] = None,
        **attrs,
    ) -> str:
        """Record one completed span; returns its span id."""
        sid = span_id or new_span_id()
        fields = {
            "name": name, "trace": trace, "span": sid,
            "parent": parent, "t0": round(float(t0), 6),
            "dur_s": round(float(dur_s), 6), **attrs,
        }
        try:
            if self._log is not None:
                self._log.event("span", **fields)
            if self.recorder is not None:
                self.recorder.record("span", **fields)
        except Exception:  # noqa: BLE001 — telemetry must never take
            pass  # down the serving path it observes
        return sid

    @contextlib.contextmanager
    def span(self, name: str, trace: str, *,
             parent: Optional[str] = None, **attrs):
        """Time a block as a span. Yields a mutable attrs dict (add
        result fields before exit); an exception is recorded as an
        ``error`` attr and re-raised."""
        t0 = time.time()
        live = dict(attrs)
        try:
            yield live
        except BaseException as e:
            live.setdefault("error", f"{type(e).__name__}: {e}")
            raise
        finally:
            self.emit(name, trace, t0, time.time() - t0, parent=parent,
                      **live)

    def read(self) -> list:
        if self._log is None:
            return []
        return self._log.read()


# --- ambient binding (the autotune probe runs deep inside batch_key
# resolution; a contextvar hands it the submitting job's trace) ---

_BOUND: contextvars.ContextVar = contextvars.ContextVar(
    "gravity_tpu_trace_bind", default=None
)


@contextlib.contextmanager
def bind(tracer: Tracer, trace: str, parent: Optional[str] = None):
    token = _BOUND.set((tracer, trace, parent))
    try:
        yield
    finally:
        _BOUND.reset(token)


def emit_bound(name: str, t0: float, dur_s: float, **attrs) -> bool:
    """Emit a span into the currently bound trace; False (and no-op)
    when nothing is bound — lets low-level code (autotune) stay
    decoupled from whether anyone is tracing it."""
    bound = _BOUND.get()
    if bound is None:
        return False
    tracer, trace, parent = bound
    tracer.emit(name, trace, t0, dur_s, parent=parent, **attrs)
    return True


# --- reading + Chrome/Perfetto export ---


def load_spans(path: str) -> list:
    """Span records from a traces.jsonl file (torn final line from a
    crashed writer tolerated)."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("event") == "span":
                out.append(rec)
    return out


def trace_ids(spans: list) -> list:
    return sorted({s["trace"] for s in spans if s.get("trace")})


def chrome_trace(spans: list, trace: Optional[str] = None) -> dict:
    """Convert span records to Chrome ``trace_event`` JSON (loadable in
    Perfetto / chrome://tracing). One pid per trace id, one tid per
    worker — an adopted job's pre- and post-crash spans render as two
    thread lanes of one process."""
    if trace is not None:
        spans = [s for s in spans if s.get("trace") == trace]
    events = []
    pids: dict = {}
    tids: dict = {}
    for s in sorted(spans, key=lambda r: r.get("t0", 0.0)):
        tr = s.get("trace", "?")
        worker = s.get("worker") or "main"
        pid = pids.setdefault(tr, len(pids) + 1)
        tid = tids.setdefault((tr, worker), len(tids) + 1)
        args = {
            k: v for k, v in s.items()
            if k not in ("event", "name", "t0", "dur_s", "ts", "v")
        }
        events.append({
            "name": s.get("name", "?"),
            "cat": "gravity",
            "ph": "X",
            "ts": round(s["t0"] * 1e6, 1),
            "dur": round(max(s.get("dur_s", 0.0), 0.0) * 1e6, 1),
            "pid": pid,
            "tid": tid,
            "args": args,
        })
    meta = []
    for tr, pid in pids.items():
        meta.append({
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": f"trace {tr}"},
        })
    for (tr, worker), tid in tids.items():
        meta.append({
            "name": "thread_name", "ph": "M", "pid": pids[tr],
            "tid": tid, "args": {"name": worker},
        })
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def span_coverage(spans: list, trace: Optional[str] = None) -> dict:
    """How much of a trace's wall-clock its TOP-LEVEL spans account
    for: merged-interval union of parentless spans vs (last end -
    first start). The acceptance gate's "spans sum to within 10% of
    the job's end-to-end latency" check."""
    if trace is not None:
        spans = [s for s in spans if s.get("trace") == trace]
    tops = [s for s in spans if not s.get("parent")]
    if not tops:
        return {"spans": 0, "union_s": 0.0, "wall_s": 0.0,
                "coverage": None}
    ivals = sorted(
        (s["t0"], s["t0"] + max(s.get("dur_s", 0.0), 0.0)) for s in tops
    )
    union = 0.0
    cur_lo, cur_hi = ivals[0]
    for lo, hi in ivals[1:]:
        if lo > cur_hi:
            union += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    union += cur_hi - cur_lo
    wall = max(hi for _, hi in ivals) - min(lo for lo, _ in ivals)
    return {
        "spans": len(tops),
        "union_s": round(union, 6),
        "wall_s": round(wall, 6),
        "coverage": round(union / wall, 4) if wall > 0 else None,
    }
