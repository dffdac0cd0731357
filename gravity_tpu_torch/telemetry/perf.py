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


# The (B, n, 3) generations a round holds at once besides the batch's own
# tensors, by integrator: the round-start carry (kept for the rollback),
# the current and the new state and acceleration, a step's half-kicked
# velocity and drifted positions, the budget mask's selections and the
# elementwise temporaries around them; Verlet's and Yoshida's steps hold
# more (their acc sums, three sub-steps).
STEP_GENERATIONS = {"euler": 12, "leapfrog": 14, "verlet": 16,
                    "yoshida4": 18}
# The element units of the cell list's per-(slot, cell, offset, slot)
# temporaries at once (ops/nlist.py::_remainder_cells: the masked
# differences, their squares, the weight's intermediates, the weighted
# differences; a 3-vector counts 3), and of a target's per-offset
# fallback terms (_overflow_targets).
NLIST_TILE_UNITS = 9
# The plain sum's (rows, n) temporaries at once (ops/forces.py::
# accelerations_vs): the differences (3), r^2, the weight's
# intermediates and the masks, then the weighted differences (3); 10.1
# units measured at bucket 4,096 in fp64 (NVIDIA H100 80GB HBM3, 700 W);
# its chunk of rows for ``chunked`` (SimulationConfig.chunk).
PLAIN_PAIR_UNITS = 12
PLAIN_CHUNK = 1024
NLIST_FALLBACK_UNITS = 9
# The largest source chunk count a direct-sum launch takes at n sources:
# one chunk a staged tile of 256 (kTile of csrc/nbody_direct.cu and
# csrc/nbody_mxu.cu), at most direct_kernel.MAX_CHUNKS; the card's own
# occupancy picks S at or below it (direct_kernel.source_chunks).
KERNEL_TILE = 256


def chunk_bound(n: int) -> int:
    """The most source chunks S a launch at n sources can take."""
    from ..ops.direct_kernel import MAX_CHUNKS

    return max(1, min(MAX_CHUNKS, -(-n // KERNEL_TILE)))


def estimate_peak_bytes(key) -> int:
    """Cold-key sizing model of a serve BatchKey's first round, in bytes.
    It counts, for B = slots, n = bucket, ``item`` the dtype's bytes
    (bf16 at 4, as the JAX model counts it):

    - the JAX model's figure (``gravity_tpu/telemetry/perf.py:234-262``),
      never less: two generations of the (B, n, 3) state triple and the
      masses, plus its pair term (nlist B side^3 27 cap 4 item, the
      kernels B n 8 item; dense and chunked below);
    - for ``dense`` and ``chunked``, the plain sum's pair temporaries,
      :data:`PLAIN_PAIR_UNITS` of B n rows, rows = n or the config's chunk
      of 1,024 (the JAX model counts the (n, n, 3) difference alone);
    - the step's temporaries: :data:`STEP_GENERATIONS` of the key's
      integrator times a (B, n, 3) generation;
    - the kernels' scratch: ``nbody_direct``'s packed sources (B, n, 4)
      and its (B, S, n, 3) chunk partial, ``nbody_mxu``'s packed tiles
      (B n 64 bytes), its centred operands and (B, n, 4) sums and its
      (B, S, n, 4) partial, all in the compute type (fp32 for bf16), S at
      most :func:`chunk_bound`;
    - for ``nlist`` (side and cap from ``key.extra``): the (B, side^3,
      cap) cell grids (positions, masses, G m, the pair tiles and their
      sum with the remainder, the scatter buffers), the remainder's
      per-offset terms (:data:`NLIST_TILE_UNITS` of B side^3 27 cap), the
      targets' overflow fallback (:data:`NLIST_FALLBACK_UNITS` of B n 27
      and its int64 neighbour ids), and the sorted and un-binned copies
      with the int64 coordinates, ids and orders of B n bodies.

    The measured peak of a key's first round replaces it for every later
    admission (:func:`required_bytes_for_key`)."""
    item = 8 if str(key.dtype) in ("float64", "f64") else 4
    compute = item
    slots, n = int(key.slots), int(key.bucket_n)
    vec = slots * n * 3 * item
    state = 2 * (3 * vec + slots * n * item)
    backend = key.backend
    extra = dict(key.extra) if key.extra else {}
    side = int(extra.get("nlist_side", 8) or 8)
    cap = int(extra.get("nlist_cap", 0) or 0) or 64
    if backend in ("dense", "chunked"):
        rows = n if backend == "dense" else min(PLAIN_CHUNK, n)
        pair = slots * n * rows * PLAIN_PAIR_UNITS * item
    elif backend == "nlist":
        pair = slots * side**3 * 27 * cap * 4 * item
    else:
        pair = slots * n * 8 * item
    steps = STEP_GENERATIONS.get(key.integrator, max(
        STEP_GENERATIONS.values())) * vec
    chunks = chunk_bound(n)
    scratch = 0
    if backend == "pallas":
        scratch = slots * n * compute * (4 + 3 * chunks)
    elif backend == "pallas-mxu":
        scratch = slots * n * (64 + 4 * (3 + 3 + 4 + 4 * chunks + 6))
    elif backend == "nlist":
        grid = slots * side**3 * cap
        bodies = slots * n
        scratch = (grid * (17 * item + 16)
                   + NLIST_TILE_UNITS * grid * 27 * item
                   + bodies * 27 * (NLIST_FALLBACK_UNITS * item + 17)
                   + bodies * (24 * item + 8 * 16))
    return state + pair + steps + scratch


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
