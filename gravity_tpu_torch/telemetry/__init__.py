"""Unified telemetry: tracing + typed metrics + crash flight recorder.

Counterpart of ``gravity_tpu/telemetry/__init__.py``: one per-worker
bundle (:class:`Telemetry`) threads through the serving stack.

- **Tracing** (telemetry/tracing.py): per-job trace ids and lifecycle
  spans as JSONL (admission, queue, slot load, build, rounds, result
  write), stitched across workers through the spool record.
- **Metrics** (telemetry/metrics.py): counter/gauge/histogram registry
  behind both the JSON ``/metrics`` blob and the Prometheus text
  exposition, mergeable across workers for the fleet view.
- **Flight recorder** (telemetry/flightrec.py): bounded ring of recent
  spans/events dumped atomically on divergence, breaker-open, SIGTERM,
  fatal round errors, and demand.
- **Performance** (telemetry/perf.py): the admission half, the memory
  check and the per-key ledger rows; the profiler half is ROADMAP.md
  Queue 1 item 8.
"""

from __future__ import annotations

import os
from typing import Optional

from .flightrec import FlightRecorder
from .metrics import (
    MetricsRegistry,
    declare_worker_metrics,
    merge_snapshots,
    parse_prometheus_text,
    prometheus_text,
    snapshot_quantile,
)
from .perf import InsufficientDeviceMemory, PerfLedger
from .perf import ledger as perf_ledger
from .tracing import (
    SPAN_NAMES,
    Tracer,
    bind,
    chrome_trace,
    emit_bound,
    load_spans,
    new_span_id,
    new_trace_id,
    span_coverage,
    trace_ids,
)

TRACES_FILE = "traces.jsonl"


class Telemetry:
    """Per-worker telemetry bundle. ``out_dir=None`` keeps everything
    in memory (no span file, no dump target) — the zero-setup default
    for in-process schedulers; the daemon points it at the spool."""

    def __init__(
        self,
        out_dir: Optional[str] = None,
        worker: Optional[str] = None,
        capacity: int = 512,
        trace_path: Optional[str] = None,
    ):
        self.out_dir = out_dir
        self.worker = worker or f"pid-{os.getpid()}"
        self.recorder = FlightRecorder(
            capacity=capacity, out_dir=out_dir, worker=self.worker
        )
        self.registry = MetricsRegistry()
        if trace_path is None and out_dir is not None:
            trace_path = os.path.join(out_dir, TRACES_FILE)
        self.tracer = Tracer(
            trace_path, worker=self.worker, recorder=self.recorder
        )


__all__ = [
    "FlightRecorder", "InsufficientDeviceMemory", "MetricsRegistry",
    "PerfLedger", "SPAN_NAMES", "TRACES_FILE", "Telemetry", "Tracer",
    "bind", "chrome_trace", "declare_worker_metrics", "emit_bound",
    "load_spans", "merge_snapshots", "new_span_id", "new_trace_id",
    "parse_prometheus_text", "perf_ledger", "prometheus_text",
    "snapshot_quantile", "span_coverage", "trace_ids",
]
