"""The performance observatory's admission half: memory-aware admission
and the per-key ledger of the serve engine's builds.

Counterpart of the serving half of ``gravity_tpu/telemetry/perf.py``.
The JAX package compiles each serve key's round through XLA's AOT path
and reads its flops and peak HBM from ``cost_analysis`` and
``memory_analysis``; PyTorch has no such compile. Here a key's ledger
row is recorded at its FIRST round: the build seconds (the round
function's build and the first round's kernel builds), the measured
peak device bytes of that round (``torch.cuda.reset_peak_memory_stats``
and ``max_memory_allocated`` around it, the card only) and the cost
model's flops (:func:`analytic_flops` times the slots). The measured
peak then feeds admission for every later job of that key, as in the
JAX package; a cold key takes :func:`estimate_peak_bytes`.

The profiler half (``instrument_jit``, the ``/profile`` endpoint and
the ``profile`` verb) is ROADMAP.md Queue 1 item 8.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Optional

from ..utils.logging import JsonlEventLogger

LEDGER_FILE = "perf_ledger.jsonl"

# Fraction of the device memory budget a program's peak may claim at
# admission — headroom for the runtime's own allocations and the
# resident batches of OTHER keys.
ADMIT_HEADROOM = 0.9

# Bounded in-memory row history (the JSONL sink is the durable record).
MAX_ROWS = 4096


class InsufficientDeviceMemory(ValueError):
    """A job's resolved program cannot fit device memory: raised at
    ADMISSION (a clean typed rejection the HTTP layer maps to 400)
    instead of letting the slot load run out of memory mid-round."""

    def __init__(self, message: str, *, required_bytes: int,
                 budget_bytes: int, source: str):
        super().__init__(message)
        self.required_bytes = int(required_bytes)
        self.budget_bytes = int(budget_bytes)
        # "measured" (a ledger row for this key) or "estimated" (the
        # cold-key sizing model) — the rejection names its evidence.
        self.source = source


class PerfEventLogger(JsonlEventLogger):
    """``perf_ledger.jsonl`` — one ``perf_compile`` record per key."""

    KINDS = ("perf_compile",)


def analytic_flops(backend: str, n: int, *,
                   force_evals: int = 1) -> Optional[float]:
    """The cost model's one-step flop expectation of a direct-sum
    backend at n bodies: the N (N - 1) directed pairs at the
    formulation's flops a pair."""
    from ..utils.timing import (
        FLOPS_PER_PAIR,
        backend_formulation,
        pairs_per_step,
    )

    if n is None or n < 2:
        return None
    fpp = FLOPS_PER_PAIR.get(backend_formulation(backend),
                             FLOPS_PER_PAIR["jnp"])
    return float(pairs_per_step(n)) * fpp * max(force_evals, 1)


def device_memory_budget() -> Optional[int]:
    """Device memory budget in bytes, or None where there is none (the
    CPU: admission checking is off unless ``GRAVITY_TPU_HBM_BYTES``
    forces a budget, as the tests do). On the card: the total memory
    ``torch.cuda.mem_get_info`` reports."""
    env = os.environ.get("GRAVITY_TPU_HBM_BYTES")
    if env:
        try:
            return int(float(env))
        except ValueError:
            pass
    import torch

    if not torch.cuda.is_available():
        return None
    try:
        _, total = torch.cuda.mem_get_info()
    except RuntimeError:
        return None
    return int(total)


def estimate_peak_bytes(key) -> int:
    """Cold-key sizing model of a serve BatchKey's footprint: two
    generations of the (slots, n, 3) state triple (a round keeps the
    round-start carry for its rollback) plus the backend's dominant pair
    intermediate."""
    item = {"float64": 8, "bfloat16": 2}.get(str(key.dtype), 4)
    slots, n = int(key.slots), int(key.bucket_n)
    state = 2 * slots * (3 * n * 3 + n) * item
    if key.backend == "dense":
        pair = slots * n * n * 3 * item  # the (n, n, 3) diff tensor
    elif key.backend == "chunked":
        pair = slots * n * min(1024, n) * 3 * item
    else:
        # The kernels stage sources in shared memory: device memory stays
        # state-dominated (packed sources and chunk partials).
        pair = slots * n * 8 * 4
    return state + pair


class PerfLedger:
    """Process-wide per-key record store with optional sinks. Always
    records in memory (bounded ring); ``attach`` points it at a worker's
    telemetry, so that rows also append to
    ``<out_dir>/perf_ledger.jsonl`` and feed the metrics registry and the
    flight recorder. One attachment at a time (last wins)."""

    def __init__(self):
        self._lock = threading.RLock()
        self.rows: deque = deque(maxlen=MAX_ROWS)
        self._by_key: dict = {}
        self._compile_counts: dict = {}
        self._log: Optional[PerfEventLogger] = None
        self.registry = None
        self.recorder = None
        self._owner = None

    def attach(self, *, out_dir=None, registry=None, recorder=None,
               owner=None) -> None:
        with self._lock:
            self._log = (PerfEventLogger(os.path.join(out_dir, LEDGER_FILE))
                         if out_dir else None)
            self.registry = registry
            self.recorder = recorder
            self._owner = owner

    def detach(self, owner=None) -> None:
        """Drop the sinks (if ``owner`` still holds them)."""
        with self._lock:
            if owner is not None and self._owner is not owner:
                return
            self._log = None
            self.registry = None
            self.recorder = None
            self._owner = None

    def reset(self) -> None:
        with self._lock:
            self.rows.clear()
            self._by_key.clear()
            self._compile_counts.clear()

    def record_compile(self, *, site: str, key: str, compile_s: float = 0.0,
                       backend: Optional[str] = None, n: Optional[int] = None,
                       analytic: Optional[float] = None,
                       peak_bytes: Optional[int] = None, **extra) -> dict:
        """Append one key's row; returns it. ``analytic`` is the cost
        model's flops of one step of the whole batch, ``peak_bytes`` the
        measured peak device bytes of the key's first round (None where
        there is no card to measure)."""
        row = {"site": site, "key": key, "backend": backend, "n": n,
               "compile_s": round(float(compile_s), 6)}
        if analytic:
            row["flops"] = float(analytic)
            row["flops_source"] = "analytic"
        if peak_bytes is not None:
            row["peak_bytes"] = int(peak_bytes)
        row.update(extra)
        with self._lock:
            self.rows.append(row)
            self._by_key[key] = row
            count = self._compile_counts.get(key, 0) + 1
            self._compile_counts[key] = count
            row["compile_count"] = count
            log, registry, recorder = self._log, self.registry, self.recorder
        try:
            if log is not None:
                log.event("perf_compile", **row)
        except Exception:  # noqa: BLE001 — the ledger must never take
            pass  # down the program it observes
        if registry is not None:
            try:
                registry.histogram("gravity_compile_seconds",
                                   site=site).observe(row["compile_s"])
                if row.get("flops") is not None:
                    registry.gauge("gravity_program_flops",
                                   key=key).set(row["flops"])
                if row.get("peak_bytes") is not None:
                    registry.gauge("gravity_program_peak_bytes",
                                   key=key).set(row["peak_bytes"])
            except Exception:  # noqa: BLE001
                pass
        if recorder is not None:
            try:
                recorder.record("perf_compile", site=site, key=key,
                                compile_s=row["compile_s"],
                                flops=row.get("flops"),
                                peak_bytes=row.get("peak_bytes"),
                                count=count)
            except Exception:  # noqa: BLE001
                pass
        return row

    def row_for(self, key: str) -> Optional[dict]:
        with self._lock:
            row = self._by_key.get(key)
            return dict(row) if row is not None else None

    def rows_list(self) -> list:
        with self._lock:
            return [dict(r) for r in self.rows]

    def compile_count(self, key: str) -> int:
        with self._lock:
            return self._compile_counts.get(key, 0)


_LEDGER = PerfLedger()


def ledger() -> PerfLedger:
    return _LEDGER


def logical_key(site: str, **parts) -> str:
    """Canonical ledger key string: ``site:part=value/...`` with parts
    sorted — short enough for a metric label, stable across runs."""
    body = "/".join(f"{k}={parts[k]}" for k in sorted(parts)
                    if parts[k] is not None)
    return f"{site}:{body}" if body else site


def engine_key_str(key) -> str:
    """The serving BatchKey's ledger identity (one build per BatchKey —
    the granularity of the engine's compile_counts)."""
    return logical_key(
        "serve", job=key.job_type, bucket=key.bucket_n, slots=key.slots,
        backend=key.backend, dtype=key.dtype, integrator=key.integrator,
    )


def required_bytes_for_key(key) -> tuple[int, str]:
    """(bytes, source) a BatchKey's batch needs on the device: the
    ledger's measured peak once the key has run a round in this process,
    else the sizing-model estimate."""
    row = _LEDGER.row_for(engine_key_str(key))
    if row is not None and row.get("peak_bytes"):
        return int(row["peak_bytes"]), "measured"
    return estimate_peak_bytes(key), "estimated"


def check_admission_memory(key) -> None:
    """Raise :class:`InsufficientDeviceMemory` when ``key``'s batch
    cannot fit the device memory budget (no-op where there is no
    budget). The serving scheduler calls this at submit time."""
    budget = device_memory_budget()
    if not budget:
        return
    required, source = required_bytes_for_key(key)
    if required > budget * ADMIT_HEADROOM:
        raise InsufficientDeviceMemory(
            f"job does not fit device memory: backend {key.backend!r} at "
            f"bucket {key.bucket_n} x {key.slots} slots needs "
            f"~{required / 1e9:.2f} GB ({source}) vs a "
            f"{budget / 1e9:.2f} GB device budget (x{ADMIT_HEADROOM} "
            f"admission headroom); run it solo or shrink n",
            required_bytes=required, budget_bytes=budget, source=source,
        )
