"""Typed metrics registry: counters, gauges, histograms — one source
of truth behind both the JSON ``/metrics`` blob and the Prometheus
text exposition (docs/observability.md "Metric names").

Copied from ``gravity_tpu/telemetry/metrics.py`` (it imports no JAX; the port
keeps its own copy).

The serving layer used to keep its health counters in hand-rolled
dicts scattered over scheduler.py/service.py, which meant the JSON
snapshot, the round events, and any future scrape format each
re-derived them separately. Instruments here are created-or-fetched by
``(name, labels)`` so call sites stay one-liners, snapshots are plain
JSON (mergeable across workers for the fleet view), and
:func:`prometheus_text` renders the standard exposition format from
the same data.

Percentiles: histograms store fixed-bound bucket counts, so a single
worker AND a fleet-wide merge answer p50/p95/p99 the same way —
:meth:`Histogram.quantile` interpolates inside the winning bucket.
Exact-window percentiles (the scheduler's completed-latency deques)
remain for the single-worker JSON; the buckets are what survive
aggregation.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Optional

# Seconds-scale latency buckets: serving rounds are 10ms-10s, job
# latencies up to minutes. Upper bound +Inf is implicit.
DEFAULT_TIME_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
)

# Relative-error buckets for the accuracy sentinel's per-backend force
# error histogram (docs/observability.md "Numerics"): log-spaced from
# fp32 round-off (~1e-7, where the exact direct sums live) up through
# the fast solvers' accuracy classes (1e-3..1e-2) to outright overload
# (>0.1 — the PR-7 fmm-disk regime the sentinel exists to catch).
ERROR_BUCKETS = (
    1e-7, 1e-6, 1e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0,
)

# Every instrument the serving worker registers (docs/observability.md
# must table each name — tests/test_telemetry.py lints that). Kept as
# data so the docs-lint and the scheduler cannot drift.
WORKER_METRICS = (
    ("gravity_rounds_total", "counter",
     "Scheduling rounds run by this worker"),
    ("gravity_round_seconds", "histogram",
     "Wall-clock seconds per scheduling round (run_slice inclusive)"),
    ("gravity_jobs_submitted_total", "counter",
     "Jobs accepted at admission, by traffic class"),
    ("gravity_jobs_terminal_total", "counter",
     "Jobs gone terminal, by traffic class and status"),
    ("gravity_job_latency_seconds", "histogram",
     "Submit-to-completed latency of completed jobs, by class"),
    ("gravity_queue_wait_seconds", "histogram",
     "Enqueue-to-slot-admission wait per admission"),
    ("gravity_queue_depth", "gauge",
     "Jobs currently pending admission"),
    ("gravity_active_slots", "gauge",
     "Occupied batch slots"),
    ("gravity_occupancy", "gauge",
     "Real particles / padded capacity of the last round's batch"),
    ("gravity_compiles_total", "counter",
     "Batch program (re)traces observed at round time"),
    ("gravity_breaker_open", "gauge",
     "Per-backend circuit breaker state (0 closed, 1 open), by backend"),
    ("gravity_slo_breaches_total", "counter",
     "SLO breach transitions (edge-triggered), by slo"),
    ("gravity_flightrec_dumps_total", "counter",
     "Flight-recorder dumps written by this worker"),
    # The numerics observatory (docs/observability.md "Numerics").
    ("gravity_force_error_rel", "histogram",
     "Sampled relative force error vs the exact oracle, by backend "
     "(accuracy sentinel probes)"),
    ("gravity_sentinel_probes_total", "counter",
     "Accuracy-sentinel probes run, by backend"),
    ("gravity_accuracy_breaches_total", "counter",
     "Error-budget breach transitions (edge-triggered), by backend"),
    ("gravity_job_energy_drift", "gauge",
     "Per-job |dE/E0| conservation-ledger drift, by job"),
    ("gravity_job_momentum_drift", "gauge",
     "Per-job |dP|/p_ref conservation-ledger drift, by job"),
    # Durable mid-run progress (docs/robustness.md "Sharded &
    # long-job failure modes").
    ("gravity_job_resume_step", "gauge",
     "Units restored from the last verified progress snapshot when a "
     "requeued/adopted job resumed mid-run, by job"),
    # Performance observatory (docs/observability.md "Performance").
    ("gravity_compile_seconds", "histogram",
     "Wall-clock seconds per XLA program compile, by site"),
    ("gravity_program_flops", "gauge",
     "Measured per-iteration flops of the latest compiled program, "
     "by ledger key (XLA cost analysis)"),
    ("gravity_program_peak_bytes", "gauge",
     "Measured device-memory footprint (arg+output+temp) of the "
     "latest compiled program, by ledger key"),
    ("gravity_host_gap_frac", "gauge",
     "Fraction of recent wall-clock with no device work in flight "
     "(solo: the block pipeline's host gap; serve: round time "
     "outside run_slice)"),
    ("gravity_steps_per_sec", "gauge",
     "Integration throughput over the last block/round (serve: "
     "slot-units advanced per second summed over residents)"),
    ("gravity_autotune_probe_ms", "histogram",
     "Wall-clock milliseconds per autotune measurement probe"),
    # The pod router's (serve/router/), tabled as in the JAX package, so
    # that a worker's families and exposition match its.
    ("gravity_router_placements_total", "counter",
     "Router placement decisions that reached a worker, by policy rule"),
    ("gravity_router_rejected_total", "counter",
     "Router-level submit rejections, by typed reason"),
    ("gravity_router_worker_routed", "gauge",
     "Jobs this router has placed onto each worker since it started, "
     "by worker"),
    ("gravity_router_latency_seconds", "histogram",
     "Wall-clock seconds from router /submit receipt to worker "
     "acceptance (placement + proxy)"),
)

# The pod router's families (serve/router/): its registry declares only
# these (declare_router_metrics).
ROUTER_METRIC_PREFIX = "gravity_router_"

# Millisecond-scale buckets for the autotune probe cost (a probe is
# 10ms-minutes; the seconds-scale latency buckets would collapse the
# interesting range into two bins).
MS_BUCKETS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0, 300000.0,
)

# Per-family bucket overrides for declare_worker_metrics: histograms
# default to the latency buckets, which are meaningless for relative
# errors or millisecond probe costs.
WORKER_METRIC_BUCKETS = {
    "gravity_force_error_rel": ERROR_BUCKETS,
    "gravity_autotune_probe_ms": MS_BUCKETS,
}

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bound bucket histogram. ``counts[i]`` is the number of
    observations in ``(bounds[i-1], bounds[i]]`` (non-cumulative;
    exposition cumulates), ``counts[-1]`` the +Inf overflow."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, buckets=DEFAULT_TIME_BUCKETS):
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> Optional[float]:
        return bucket_quantile(self.bounds, self.counts, q)


def bucket_quantile(bounds, counts, q: float) -> Optional[float]:
    """Interpolated quantile from (bounds, per-bucket counts); None on
    an empty histogram. The +Inf bucket clamps to the largest finite
    bound (an honest "at least this much")."""
    total = sum(counts)
    if total == 0:
        return None
    target = q * total
    seen = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if seen + c >= target:
            if i >= len(bounds):
                return float(bounds[-1])
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            frac = (target - seen) / c
            return float(lo + (hi - lo) * frac)
        seen += c
    return float(bounds[-1])


class MetricsRegistry:
    """Get-or-create instrument store keyed by (name, sorted labels)."""

    _TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        # RLock: _instrument creates missing families through
        # declare() while already holding the lock.
        self._lock = threading.RLock()
        # name -> {"type", "help", "buckets", "series": {labelkey: inst}}
        self._families: dict = {}

    def declare(self, name: str, typ: str, help: str = "",
                buckets=None) -> None:
        """Register a family (HELP/TYPE) ahead of any series — so the
        exposition and the docs lint see every metric a worker CAN
        emit, not just the ones this process happened to touch."""
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        if typ not in self._TYPES:
            raise ValueError(f"bad metric type {typ!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                self._families[name] = {
                    "type": typ, "help": help,
                    "buckets": tuple(buckets) if buckets else None,
                    "series": {},
                }
            elif fam["type"] != typ:
                raise ValueError(
                    f"metric {name!r} already declared as {fam['type']}"
                )

    def _instrument(self, name: str, typ: str, labels: dict):
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"bad label name {k!r}")
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                self.declare(name, typ)
                fam = self._families[name]
            if fam["type"] != typ:
                raise ValueError(
                    f"metric {name!r} is a {fam['type']}, not a {typ}"
                )
            inst = fam["series"].get(key)
            if inst is None:
                if typ == "histogram":
                    inst = Histogram(fam["buckets"] or DEFAULT_TIME_BUCKETS)
                else:
                    inst = self._TYPES[typ]()
                fam["series"][key] = inst
            return inst

    def remove_series(self, name: str, **labels) -> None:
        """Drop one labeled series. Per-job label dimensions (the
        drift gauges) call this at job finish so a long-lived daemon's
        exposition, published snapshot, and registry memory stay
        bounded — every other label set (backend/class) is finite by
        construction."""
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                fam["series"].pop(key, None)

    def counter(self, name: str, **labels) -> Counter:
        return self._instrument(name, "counter", labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._instrument(name, "gauge", labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._instrument(name, "histogram", labels)

    def names(self) -> list:
        with self._lock:
            return sorted(self._families)

    def snapshot(self) -> dict:
        """JSON-able copy of every family: the mergeable fleet unit."""
        out = {}
        with self._lock:
            families = {
                name: (fam["type"], fam["help"], dict(fam["series"]))
                for name, fam in self._families.items()
            }
        for name, (typ, help_, series) in sorted(families.items()):
            rows = []
            for key, inst in sorted(series.items()):
                labels = dict(key)
                if typ == "histogram":
                    rows.append({
                        "labels": labels,
                        "bounds": list(inst.bounds),
                        "counts": list(inst.counts),
                        "sum": inst.sum,
                        "count": inst.count,
                    })
                else:
                    rows.append({"labels": labels, "value": inst.value})
            out[name] = {"type": typ, "help": help_, "series": rows}
        return out

    def prometheus_text(self) -> str:
        return prometheus_text(self.snapshot())


# How each gauge aggregates fleet-wide. Counters and histograms are
# additive by nature; gauges are NOT uniformly so — summing a 0..1
# ratio (occupancy) or a 0/1 state (breaker_open) across N workers
# reports impossible values. Default for undeclared gauges: sum
# (depth/slot counts are genuine fleet totals).
GAUGE_MERGE = {
    "gravity_occupancy": "mean",
    "gravity_breaker_open": "max",
    # Per-job drift gauges: a job is owned by one worker at a time,
    # but an adoption can leave the dead worker's last published
    # snapshot carrying the same series — max reports the worst
    # observed drift instead of a nonsense sum.
    "gravity_job_energy_drift": "max",
    "gravity_job_momentum_drift": "max",
    # Performance observatory: a ratio averages; per-program facts
    # are identical across workers that compiled the same key — max
    # reports one honest figure instead of a worker-count multiple.
    # steps_per_sec stays the sum default: fleet throughput is a
    # genuine total.
    "gravity_host_gap_frac": "mean",
    "gravity_program_flops": "max",
    "gravity_program_peak_bytes": "max",
}


def merge_snapshots(snaps: list) -> dict:
    """Aggregate worker registry snapshots into one fleet registry:
    counters and histograms (identical bucket bounds) sum; gauges
    follow :data:`GAUGE_MERGE` (mean for ratios, max for states, sum
    for totals). The fleet view's aggregation unit: per-class p99 over
    every live worker comes from the merged
    ``gravity_job_latency_seconds`` buckets."""
    merged: dict = {}
    gauge_counts: dict = {}
    for snap in snaps:
        for name, fam in (snap or {}).items():
            m = merged.setdefault(name, {
                "type": fam["type"], "help": fam.get("help", ""),
                "series": [],
            })
            mode = GAUGE_MERGE.get(name, "sum") \
                if fam["type"] == "gauge" else "sum"
            for row in fam["series"]:
                key = tuple(sorted(row["labels"].items()))
                match = next(
                    (r for r in m["series"]
                     if r["labels"] == row["labels"]), None
                )
                if match is None:
                    m["series"].append(
                        {k: (list(v) if isinstance(v, list) else v)
                         for k, v in row.items()}
                    )
                    if fam["type"] == "gauge":
                        gauge_counts[(name, key)] = 1
                elif fam["type"] == "histogram":
                    if match["bounds"] != list(row["bounds"]):
                        continue  # incompatible buckets: skip, not lie
                    match["counts"] = [
                        a + b for a, b in
                        zip(match["counts"], row["counts"])
                    ]
                    match["sum"] += row["sum"]
                    match["count"] += row["count"]
                elif mode == "max":
                    match["value"] = max(match["value"], row["value"])
                else:
                    # sum now; "mean" divides by the worker count in
                    # the normalization pass below.
                    match["value"] += row["value"]
                    if fam["type"] == "gauge":
                        gauge_counts[(name, key)] += 1
    for name, fam in merged.items():
        if fam["type"] == "gauge" and GAUGE_MERGE.get(name) == "mean":
            for row in fam["series"]:
                key = tuple(sorted(row["labels"].items()))
                n = gauge_counts.get((name, key), 1)
                if n > 1:
                    row["value"] /= n
    return merged


def snapshot_quantile(snap: dict, name: str, q: float,
                      **labels) -> Optional[float]:
    fam = snap.get(name)
    if fam is None or fam["type"] != "histogram":
        return None
    for row in fam["series"]:
        if row["labels"] == {k: str(v) for k, v in labels.items()}:
            return bucket_quantile(row["bounds"], row["counts"], q)
    return None


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(labels: dict, extra: Optional[tuple] = None) -> str:
    items = sorted(labels.items())
    if extra is not None:
        items = items + [extra]
    if not items:
        return ""
    body = ",".join(
        '{}="{}"'.format(
            k,
            str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"),
        )
        for k, v in items
    )
    return "{" + body + "}"


def prometheus_text(snapshot: dict) -> str:
    """Render a registry (or fleet-merged) snapshot as Prometheus text
    exposition format 0.0.4."""
    lines = []
    for name in sorted(snapshot):
        fam = snapshot[name]
        typ = fam["type"]
        if fam.get("help"):
            esc = fam["help"].replace("\\", "\\\\").replace("\n", "\\n")
            lines.append(f"# HELP {name} {esc}")
        lines.append(f"# TYPE {name} {typ}")
        for row in fam["series"]:
            labels = row["labels"]
            if typ == "histogram":
                cum = 0
                for bound, c in zip(
                    list(row["bounds"]) + [math.inf],
                    row["counts"],
                ):
                    cum += c
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(labels, ('le', _fmt_value(bound)))}"
                        f" {cum}"
                    )
                lines.append(
                    f"{name}_sum{_fmt_labels(labels)}"
                    f" {_fmt_value(row['sum'])}"
                )
                lines.append(
                    f"{name}_count{_fmt_labels(labels)} {row['count']}"
                )
            else:
                lines.append(
                    f"{name}{_fmt_labels(labels)}"
                    f" {_fmt_value(row['value'])}"
                )
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^{}]*\})?"
    r" (?P<value>[^ ]+)"
    r"( (?P<ts>-?[0-9]+))?$"
)
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"'
)


def parse_prometheus_text(text: str) -> dict:
    """STRICT parser for the exposition format — the validation half
    used by tests and the smoke stage. Raises ValueError on any
    malformed line, a sample preceding its TYPE, unknown sample names
    for declared histograms, non-monotone cumulative buckets, or a
    histogram whose +Inf bucket disagrees with its _count. Returns
    {name: {"type", "samples": {(label items): value}}}."""
    out: dict = {}
    types: dict = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            if len(parts) != 4 or parts[3] not in (
                "counter", "gauge", "histogram", "summary", "untyped"
            ):
                raise ValueError(f"line {lineno}: bad TYPE line {line!r}")
            types[parts[2]] = parts[3]
            out.setdefault(parts[2], {"type": parts[3], "samples": {}})
            continue
        if line.startswith("#"):
            raise ValueError(f"line {lineno}: bad comment {line!r}")
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: bad sample line {line!r}")
        name = m.group("name")
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in types \
                    and types[name[: -len(suffix)]] == "histogram":
                base = name[: -len(suffix)]
        if base not in types:
            raise ValueError(
                f"line {lineno}: sample {name!r} precedes its TYPE"
            )
        labels = {}
        raw = m.group("labels")
        if raw:
            body = raw[1:-1].rstrip(",")
            if body:
                matched = _LABEL_PAIR_RE.findall(body)
                rebuilt = ",".join(
                    f'{k}="{v}"' for k, v in matched
                )
                if rebuilt != body:
                    raise ValueError(
                        f"line {lineno}: bad labels {raw!r}"
                    )
                labels = dict(matched)
        try:
            value = float(m.group("value"))
        except ValueError:
            raise ValueError(
                f"line {lineno}: bad value {m.group('value')!r}"
            ) from None
        out[base]["samples"][
            (name, tuple(sorted(labels.items())))
        ] = value
    # Histogram invariants.
    for name, fam in out.items():
        if fam["type"] != "histogram":
            continue
        by_series: dict = {}
        for (sample, labels), value in fam["samples"].items():
            rest = tuple(kv for kv in labels if kv[0] != "le")
            s = by_series.setdefault(
                rest, {"buckets": [], "sum": None, "count": None}
            )
            if sample == f"{name}_bucket":
                le = dict(labels).get("le")
                if le is None:
                    raise ValueError(
                        f"{name}: bucket sample without le label"
                    )
                s["buckets"].append((float(le), value))
            elif sample == f"{name}_sum":
                s["sum"] = value
            elif sample == f"{name}_count":
                s["count"] = value
        for rest, s in by_series.items():
            if not s["buckets"] or s["count"] is None or s["sum"] is None:
                raise ValueError(
                    f"{name}{dict(rest)}: incomplete histogram"
                )
            s["buckets"].sort(key=lambda b: b[0])
            cum = [v for _, v in s["buckets"]]
            if any(b > a for a, b in zip(cum[1:], cum)):
                raise ValueError(
                    f"{name}{dict(rest)}: non-monotone buckets"
                )
            if s["buckets"][-1][0] != math.inf:
                raise ValueError(f"{name}{dict(rest)}: no +Inf bucket")
            if s["buckets"][-1][1] != s["count"]:
                raise ValueError(
                    f"{name}{dict(rest)}: +Inf bucket != _count"
                )
    return out


def declare_worker_metrics(registry: MetricsRegistry) -> MetricsRegistry:
    """Register the serving worker's full instrument set (families
    only; label series materialize on first touch)."""
    for name, typ, help_ in WORKER_METRICS:
        registry.declare(
            name, typ, help_, buckets=WORKER_METRIC_BUCKETS.get(name)
        )
    return registry


def declare_router_metrics(registry: MetricsRegistry) -> MetricsRegistry:
    """Register the pod router's instrument families (the
    ``gravity_router_*`` subset of WORKER_METRICS: the router is not a
    worker, so its registry carries only its own families)."""
    for name, typ, help_ in WORKER_METRICS:
        if name.startswith(ROUTER_METRIC_PREFIX):
            registry.declare(
                name, typ, help_, buckets=WORKER_METRIC_BUCKETS.get(name)
            )
    return registry
