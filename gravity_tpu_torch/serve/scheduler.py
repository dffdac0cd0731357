"""Bucketed continuous batching over the ensemble engine.

Counterpart of ``gravity_tpu/serve/scheduler.py``, with the JAX package's
admission, slot, yield, lease, fencing, breaker and spool semantics, for
every class of serve/jobs: a sweep parent never takes a slot, fans its
members out at admission, aggregates them when the last one lands
(``_check_parents``), cascades a cancel to them and is tracked again
after a restart; a watch's ``round_snapshot`` and ``post_round`` hooks
run around its rounds. The departures: a round that raises on the card (a
kernel's build or launch error) trips its backend's breaker at once with
the error as its reason, and the residents' requeue through the breaker
then fails them with that reason rather than route a kernel's job to a
plain PyTorch form (serve/breaker.py); a key's perf-ledger row is
recorded at its first round, with the round's measured peak device
bytes (telemetry/perf.py).

Admission model: jobs hash to a :class:`~gravity_tpu_torch.serve.engine.
BatchKey` (n-bucket + program shape); each key owns one resident
:class:`EnsembleBatch` whose slots are filled as jobs arrive and
backfilled the moment a slot frees — continuous batching, not
gang-scheduling. Every round runs ONE bounded step-slice of one key's
batch (keys rotate round-robin), so a 500k-step job can never starve a
10-step job: short jobs ride along in free slots immediately, and when
a batch is full, resident jobs yield their slot after ``yield_rounds``
consecutive rounds while peers wait (their state is preserved and they
re-queue — the carried-acceleration seed is a pure function of state,
so evict/resume costs nothing in accuracy). Higher-priority arrivals
preempt the lowest-priority resident job outright.

Occupancy is reported per round (real particles / padded slot
capacity) so bucket-padding waste is a visible serving metric, not a
silent tax. Divergence is per-slot: a flagged slot rolls back to its
round-start state, fails, and frees — its batchmates never notice
(engine lanes are vmap-independent).

With a spool directory attached, job specs and results persist as
JSON/NPZ under it, so a restarted daemon re-queues every unfinished
job (``respooled`` events; ICs are a pure function of the config, so
a restarted job reproduces the same trajectory from step 0).

Fleet mode (docs/robustness.md "Fleet failure modes"): with a spool,
every job is additionally owned through a TTL **lease** with a fencing
token (serve/leases.py), so N scheduler processes can share one spool.
Each worker heartbeats its leases, periodically scans the spool for
unclaimed work and **adopts** expired leases (a ``kill -9``'d peer's
jobs respool onto the survivors; a job whose result ``.npz`` already
landed is finalized, not re-run), and fences every spool write so a
paused-then-resurrected worker cannot clobber its adopter's results.
Admission degrades gracefully: per-backend **circuit breakers**
(serve/breaker.py) reroute keying down the exact-physics ladder while
a backend cannot build, a bounded queue **sheds** submissions with a
retry-after hint instead of accepting unbounded backlog, and a job
that poisons its bucket (fails its round repeatedly) goes terminal
``failed`` after ``max_requeues`` instead of starving batchmates.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import socket
import time
import uuid
from typing import Optional

import numpy as np

import torch

from ..config import SimulationConfig
from ..interop import state_to_numpy, to_numpy
from ..state import ParticleState
from ..telemetry import Telemetry, declare_worker_metrics
from ..telemetry import tracing as _tracing
from ..utils.faults import (
    BackendUnavailable,
    drop_result_due,
    maybe_crash_worker,
    stale_lease_secs,
    stall_worker_secs,
)
from ..utils.hostio import atomic_write_json
from ..utils.logging import ServingEventLogger
from .breaker import BreakerBoard
from .engine import BatchKey, EnsembleBatch, EnsembleEngine
from .jobs.sharded import group_stats
from .leases import LeaseManager, read_json_retry

# Job lifecycle: pending -> running -> completed | failed | cancelled
# (running -> pending again on a yield/preemption).
TERMINAL = ("completed", "failed", "cancelled")


class QueueFull(RuntimeError):
    """Admission load shed: the bounded queue is at capacity. Carries
    the retry-after hint the HTTP layer surfaces as ``Retry-After``."""

    def __init__(self, retry_after_s: float, depth: int):
        super().__init__(
            f"queue full ({depth} jobs); retry in ~{retry_after_s:.0f}s"
        )
        self.retry_after_s = retry_after_s
        self.depth = depth


def _kernel_launches() -> dict:
    """The hand-written kernels' launch counts in this process, solo and
    batched."""
    from ..ops import direct_kernel, mxu_kernel, nlist

    return {"nbody_direct": direct_kernel.LAUNCHES,
            "nbody_direct/batched": direct_kernel.BATCHED_LAUNCHES,
            "nbody_mxu": mxu_kernel.LAUNCHES,
            "nbody_mxu/batched": mxu_kernel.BATCHED_LAUNCHES,
            "nlist_pair": nlist.LAUNCHES["newton"],
            "nlist_pair/bf16": nlist.LAUNCHES["newton_bf16"],
            "nlist_pair/batched": nlist.LAUNCHES["newton/batched"],
            "nlist_pair/batched_bf16": nlist.LAUNCHES["newton_bf16/batched"]}


def _router_verdicts() -> dict:
    from ..autotune import engine_verdicts

    return engine_verdicts()


def _perf_rows() -> list:
    from ..telemetry import perf as _perf

    return _perf.ledger().rows_list()


def default_worker_id() -> str:
    return (
        f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:6]}"
    )


@dataclasses.dataclass
class Job:
    id: str
    config: SimulationConfig
    priority: int = 0
    deadline_s: Optional[float] = None
    seq: int = 0
    status: str = "pending"
    steps_done: int = 0
    error: Optional[str] = None
    # Traffic class (serve/jobs registry) + its validated payload.
    # ``steps_done`` counts the CLASS's units (steps for integrate/
    # sweep members/watch, optimizer iterations for fit, completed
    # members for a sweep parent).
    job_type: str = "integrate"
    params: dict = dataclasses.field(default_factory=dict)
    # Sweep parent linkage (members carry the parent id; the parent
    # aggregates member verdicts when the last one lands).
    parent: Optional[str] = None
    # Small JSON verdict persisted in the record (fit loss, sweep
    # member verdict, watch event counts) — the typed result half that
    # survives without the .npz.
    result_payload: Optional[dict] = None
    submitted_ts: float = 0.0
    started_ts: Optional[float] = None
    finished_ts: Optional[float] = None
    # Wall-clock seconds of scheduling rounds this job was resident in —
    # the honest per-job execution time under continuous batching
    # (submission-to-completion latency spans OTHER buckets' interleaved
    # rounds; review finding).
    active_s: float = 0.0
    # Evict/resume snapshot (unpadded). None = not yet started -> the
    # deterministic ICs from the config.
    state: Optional[ParticleState] = None
    # Class-specific evict/resume extras (fit optimizer moments, sweep
    # min-separation, watch detector flags + event log) and the full
    # result arrays held in memory until the spool write lands.
    extra_state: Optional[dict] = None
    result_data: Optional[dict] = None
    resident_rounds: int = 0
    # Fleet-mode ownership (persisted): the fencing token of our lease
    # over this job (0 = never claimed) and how many times the job has
    # been requeued after a failed/interrupted attempt — the poison-
    # pill counter behind ``max_requeues``.
    fence: int = 0
    requeues: int = 0
    # Persisted: the job's ``completed`` event went out. A peer that
    # re-runs it (its result was lost with its owner) emits none again.
    announced: bool = False
    # Telemetry (persisted): the job's trace id, minted at submit and
    # carried in the spool record so an adopted job's spans — dead
    # worker's and survivor's — stitch into ONE trace
    # (docs/observability.md "Trace model").
    trace_id: str = ""
    # Local-only: when this job last entered a pending queue (the
    # start of its current queue-wait span).
    queued_ts: float = 0.0
    # Local-only: False = a peer worker owns this job; we serve status
    # reads from its spool record and never schedule it.
    owned: bool = True
    # Local-only: the BatchKey this job was queued under (breaker
    # reroutes can change the computed key between enqueue and lookup).
    key_cache: Optional[BatchKey] = None
    # Numerics observatory (docs/observability.md "Numerics"): the
    # t0 conservation-ledger baseline (local-only — recomputed from
    # the deterministic ICs after a respool) and the latest measured
    # drift (persisted in the record / surfaced in /status).
    ledger0: Optional[dict] = None
    drift: Optional[dict] = None

    @property
    def steps(self) -> int:
        """This job's total work budget in its class's units."""
        from .jobs import get_class

        return get_class(self.job_type).budget(self)

    def to_dict(self) -> dict:
        from .jobs import get_class

        return {
            "id": self.id,
            "status": self.status,
            "n": self.config.n,
            "job_type": self.job_type,
            "units": get_class(self.job_type).units,
            "parent": self.parent,
            "result": self.result_payload,
            "steps": self.steps,
            "steps_done": self.steps_done,
            "priority": self.priority,
            "deadline_s": self.deadline_s,
            "error": self.error,
            "submitted_ts": self.submitted_ts,
            "started_ts": self.started_ts,
            "finished_ts": self.finished_ts,
            "active_s": self.active_s,
            "fence": self.fence,
            "requeues": self.requeues,
            "trace_id": self.trace_id,
            "drift": self.drift,
        }


class Spool:
    """Directory-backed persistence: ``jobs/<id>.json`` specs + status,
    ``results/<id>.npz`` final states. Everything a restarted daemon
    needs to resume its queue and keep serving old results.

    With a :class:`~gravity_tpu_torch.serve.leases.LeaseManager` attached
    (fleet mode), job and result writes are FENCED: the caller's token
    is validated against the job's current lease (and the fence
    persisted in the record, for released leases) under the lease lock,
    in the same critical section as the ``os.replace`` — a zombie's
    stale-token write returns False/None instead of landing."""

    def __init__(self, root: str):
        self.root = root
        self.jobs_dir = os.path.join(root, "jobs")
        self.results_dir = os.path.join(root, "results")
        # Cross-worker cancel requests: any worker may drop a marker;
        # the job's OWNER consumes it in housekeeping (HTTP handlers
        # cannot reach a peer's scheduler, but every worker shares the
        # spool).
        self.cancels_dir = os.path.join(root, "cancel")
        # Durable mid-run progress snapshots (docs/robustness.md
        # "Sharded & long-job failure modes"): per-job checksummed
        # state+extras at a round boundary, so adoption resumes a long
        # job from its last verified snapshot instead of step 0.
        self.progress_dir = os.path.join(root, "progress")
        os.makedirs(self.jobs_dir, exist_ok=True)
        os.makedirs(self.results_dir, exist_ok=True)
        os.makedirs(self.cancels_dir, exist_ok=True)
        os.makedirs(self.progress_dir, exist_ok=True)
        self.leases: Optional[LeaseManager] = None

    def request_cancel(self, job_id: str) -> None:
        atomic_write_json(
            os.path.join(self.cancels_dir, f"{job_id}.json"),
            {"job": job_id, "ts": time.time()},
        )

    def cancel_requested(self, job_id: str) -> bool:
        return os.path.exists(
            os.path.join(self.cancels_dir, f"{job_id}.json")
        )

    def clear_cancel(self, job_id: str) -> None:
        try:
            os.remove(os.path.join(self.cancels_dir, f"{job_id}.json"))
        except OSError:
            pass

    def attach_leases(self, leases: LeaseManager) -> None:
        self.leases = leases

    def job_path(self, job_id: str) -> str:
        return os.path.join(self.jobs_dir, f"{job_id}.json")

    def read_job(self, job_id: str) -> Optional[dict]:
        """One job record (torn-read-retrying); None if absent."""
        rec = read_json_retry(self.job_path(job_id))
        return rec if isinstance(rec, dict) else None

    def job_ids(self) -> list:
        """Every job id with a record on disk (the router's /status
        listing and spool-wide scans; tolerant of a vanishing dir)."""
        try:
            return sorted(
                n[:-len(".json")]
                for n in os.listdir(self.jobs_dir)
                if n.endswith(".json")
            )
        except OSError:
            return []

    def record_fence(self, job_id: str) -> int:
        rec = self.read_job(job_id)
        try:
            return int((rec or {}).get("fence", 0) or 0)
        except (TypeError, ValueError):
            return 0

    def write_job(self, job: Job, before_write=None) -> bool:
        """Persist the record; returns False when fencing rejected the
        write (a newer claim owns this job — the caller must treat the
        on-disk record as the truth). ``before_write`` runs after the
        fence check, just before the record lands."""
        record = job.to_dict()
        record["config"] = json.loads(job.config.to_json())
        record["params"] = job.params
        path = self.job_path(job.id)
        if self.leases is None:
            if before_write is not None:
                before_write()
            record["announced"] = job.announced
            atomic_write_json(path, record)
            return True
        with self.leases.locked():
            if not self.leases.fence_ok(
                job.id, job.fence, lambda: self.record_fence(job.id)
            ):
                return False
            if before_write is not None:
                before_write()
            record["announced"] = job.announced
            atomic_write_json(path, record)
            return True

    def result_path(self, job_id: str) -> str:
        return os.path.join(self.results_dir, f"{job_id}.npz")

    @staticmethod
    def normalize_result(result) -> dict:
        """The ONE result-schema mapping: a ParticleState or a
        {name: array} dict becomes {name: np.ndarray} (host-fetched).
        Shared by :meth:`write_result` and the scheduler's background
        writer (which times the fetch as the ``d2h`` span) so the two
        can never drift."""
        if isinstance(result, ParticleState):
            result = {
                "positions": result.positions,
                "velocities": result.velocities,
                "masses": result.masses,
            }
        return {
            k: to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in result.items()
        }

    def write_result(
        self, job_id: str, result,
        fence: Optional[int] = None,
    ) -> Optional[str]:
        """Write the result ``.npz`` — a ParticleState or a plain
        {name: array} dict (the job-class result schema: fit jobs add
        loss/iterations, sweeps their per-member verdict arrays);
        returns its path, or None when fencing rejected the write. The
        array serialization runs OUTSIDE the lease lock (it is the
        heavy part); only the validate + ``os.replace`` are in the
        critical section."""
        from ..utils.faults import disk_full_due

        disk_full_due()  # injected ENOSPC: absorbed per job upstream
        path = self.result_path(job_id)
        if drop_result_due():
            # Injected lost write: report success like a writer that
            # died right after the syscall returned — the adoption
            # scan's completed-without-result handling must recover.
            return path
        result = self.normalize_result(result)
        tmp = f"{path}.tmp.{os.getpid()}.npz"
        np.savez(tmp, **result)
        if self.leases is None or fence is None:
            os.replace(tmp, path)
            return path
        with self.leases.locked():
            if not self.leases.fence_ok(
                job_id, fence, lambda: self.record_fence(job_id)
            ):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                return None
            os.replace(tmp, path)
        return path

    def load_result(self, job_id: str) -> Optional[dict]:
        path = self.result_path(job_id)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    # --- durable mid-run progress (docs/robustness.md "Sharded &
    # long-job failure modes") ---

    def progress_meta_path(self, job_id: str) -> str:
        return os.path.join(self.progress_dir, f"{job_id}.json")

    def _progress_file(self, job_id: str, tag: str) -> str:
        return os.path.join(self.progress_dir, f"{job_id}.{tag}.npz")

    def write_progress(
        self, job_id: str, step: int, arrays: dict, extras: dict,
        fence: Optional[int] = None,
    ) -> Optional[str]:
        """Persist one fenced, checksummed progress snapshot: the
        job's state arrays (plus any array-valued evict extras) as an
        ``.npz``, and a meta record carrying (step, SHA-256 of the
        array bytes, fence, JSON extras). Two snapshot files alternate
        (``<id>.a.npz`` / ``<id>.b.npz``) with the meta listing the
        newest first, so a torn latest write — caught by the checksum
        at read time — falls back to the PREVIOUS verified snapshot
        instead of step 0 (the PR-2 corrupt-checkpoint posture).

        Serialization and hashing run OUTSIDE the lease lock (the
        heavy half); fence validation, the ``os.replace``, and the
        meta write share one critical section, so a zombie's stale
        snapshot can never overwrite its adopter's newer one — the
        write returns None instead (``fenced``)."""
        import hashlib

        from ..utils.faults import disk_full_due, torn_progress_due

        disk_full_due()  # injected ENOSPC: fails THIS job's write only
        meta = read_json_retry(self.progress_meta_path(job_id))
        entries = list((meta or {}).get("entries") or [])
        prev_file = entries[0].get("file", "") if entries else ""
        tag = "b" if prev_file.endswith(".a.npz") else "a"
        path = self._progress_file(job_id, tag)
        # Serialize STRAIGHT to the tmp file and stream-hash it: an
        # in-memory payload copy would transiently double-to-triple
        # the host footprint per snapshot — hundreds of MB per round
        # for exactly the huge jobs this feature targets.
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **self.normalize_result(arrays))
        hasher = hashlib.sha256()
        with open(tmp, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                hasher.update(chunk)
        checksum = hasher.hexdigest()
        entry = {
            "file": os.path.basename(path), "step": int(step),
            "checksum": checksum, "fence": fence, "ts": time.time(),
            "extras": extras,
        }
        new_meta = {
            "v": 1, "job": job_id, "entries": [entry] + entries[:1],
        }
        torn = torn_progress_due()
        # The heavy disk write happened OUTSIDE the lease flock (the
        # write_result pattern): a multi-hundred-MB snapshot pinned
        # under the spool-wide lock would block every peer's heartbeat
        # renewal — the durability feature inducing the very lease
        # expiry it exists to recover from. Only the fence check, the
        # renames, and the small meta write share the critical section.

        def _land() -> None:
            if torn:
                # Injected torn write: truncated bytes land under the
                # full payload's checksum — the reader's verification
                # must reject this entry and fall back.
                size = os.path.getsize(tmp)
                with open(tmp, "rb") as src, open(path, "wb") as dst:
                    dst.write(src.read(max(1, size // 3)))
                try:
                    os.remove(tmp)
                except OSError:
                    pass
            else:
                os.replace(tmp, path)
            # fault_injection=False: the progress stream has its own
            # torn_progress_write hook (above) and must not consume
            # torn_spool_write chaos tokens aimed at job/lease records.
            atomic_write_json(
                self.progress_meta_path(job_id), new_meta,
                fault_injection=False,
            )

        if self.leases is None or fence is None:
            _land()
            return path
        with self.leases.locked():
            if not self.leases.fence_ok(
                job_id, fence, lambda: self.record_fence(job_id)
            ):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                return None
            _land()
        return path

    def load_progress(self, job_id: str) -> Optional[dict]:
        """The last VERIFIED progress snapshot: walks the meta entries
        newest-first, checks each file's SHA-256 against the recorded
        checksum, and returns ``{"step", "arrays", "extras", "fence"}``
        for the first that verifies — None when no entry does (torn
        writes, missing files, no snapshot yet)."""
        import hashlib
        import io

        meta = read_json_retry(self.progress_meta_path(job_id))
        for entry in (meta or {}).get("entries") or []:
            try:
                path = os.path.join(
                    self.progress_dir, str(entry["file"])
                )
                with open(path, "rb") as f:
                    payload = f.read()
                if hashlib.sha256(payload).hexdigest() \
                        != entry["checksum"]:
                    continue
                with np.load(io.BytesIO(payload)) as z:
                    arrays = {k: z[k] for k in z.files}
                return {
                    "step": int(entry["step"]),
                    "arrays": arrays,
                    "extras": entry.get("extras") or {},
                    "fence": entry.get("fence"),
                }
            except (OSError, KeyError, TypeError, ValueError):
                continue
        return None

    def clear_progress(self, job_id: str) -> None:
        """Drop a terminal job's snapshot files (the record/result are
        the durable truth from here on)."""
        for path in (
            self.progress_meta_path(job_id),
            self._progress_file(job_id, "a"),
            self._progress_file(job_id, "b"),
        ):
            try:
                os.remove(path)
            except OSError:
                pass


class EnsembleScheduler:
    """The serving brain: admission queue, slot assignment, round
    execution, metrics. Single-threaded by design — the daemon calls
    :meth:`run_round` from one worker thread and guards job-table reads
    with its own lock."""

    def __init__(
        self,
        *,
        slots: int = 4,
        slice_steps: int = 100,
        yield_rounds: int = 2,
        engine: Optional[EnsembleEngine] = None,
        device=None,
        events: Optional[ServingEventLogger] = None,
        spool: Optional[Spool] = None,
        min_bucket: int = 16,
        worker_id: Optional[str] = None,
        lease_ttl_s: float = 30.0,
        max_queue: int = 0,
        max_requeues: int = 5,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 30.0,
        reap_interval_s: Optional[float] = None,
        telemetry: Optional[Telemetry] = None,
        slo_p99_ms: Optional[float] = None,
        slo_occupancy: Optional[float] = None,
        error_budget: float = 0.0,
        sentinel_every: int = 8,
        sentinel_k: int = 64,
        ledger_every: int = 1,
        progress_every: int = 1,
    ):
        if slots < 1 or slice_steps < 1 or yield_rounds < 1:
            raise ValueError(
                "slots, slice_steps, and yield_rounds must be >= 1"
            )
        if max_queue < 0 or max_requeues < 1:
            raise ValueError(
                "max_queue must be >= 0 and max_requeues >= 1"
            )
        self.slots = slots
        self.slice_steps = slice_steps
        self.yield_rounds = yield_rounds
        # The engine's device (the card unless the CPU is asked for) is
        # where every batch lives and every kernel runs.
        self.engine = engine or EnsembleEngine(device)
        self.events = events
        self.spool = spool
        self.min_bucket = min_bucket
        self.worker_id = worker_id or default_worker_id()
        # Unified telemetry (docs/observability.md): tracer + typed
        # metric registry + crash flight recorder, one bundle per
        # worker. Spool-backed schedulers write spans/dumps under the
        # spool (shared stream: adoption stitches traces for free);
        # in-process ones keep the ring in memory only.
        self.telemetry = telemetry or Telemetry(
            out_dir=spool.root if spool is not None else None,
            worker=self.worker_id,
        )
        declare_worker_metrics(self.telemetry.registry)
        # Compile marks from the engine land in the same ring.
        self.engine.recorder = self.telemetry.recorder
        # Performance observatory (docs/observability.md
        # "Performance"): point the process perf ledger at this
        # worker's telemetry — compiled-program rows append to
        # perf_ledger.jsonl under the spool, feed the compile/flops/
        # peak-bytes metrics, and recompile storms raise the
        # recompile_storm event + flight-recorder dump through this
        # worker's own emitters. close() detaches.
        from ..telemetry import perf as _perf

        _perf.ledger().attach(
            out_dir=spool.root if spool is not None else None,
            registry=self.telemetry.registry,
            recorder=self.telemetry.recorder,
            event_hook=self._event,
            owner=self,
        )
        # SLO burn flags (--slo-p99-ms / --slo-occupancy): breaches are
        # edge-triggered slo_breach events + counters, state readable
        # in /metrics (docs/observability.md "SLO flags").
        self.slo_p99_ms = slo_p99_ms
        self.slo_occupancy = slo_occupancy
        self._slo_burn: dict = {"p99": False, "occupancy": False}
        # Numerics observatory (docs/observability.md "Numerics"):
        # every `ledger_every` rounds the per-slot conservation ledger
        # refreshes each resident job's drift gauges; every
        # `sentinel_every` rounds one resident lane's force error is
        # probed against the exact oracle. `error_budget` > 0 turns
        # the probe into an SLO: an over-budget p90 raises an
        # edge-triggered accuracy_breach event, dumps the flight
        # recorder, and TRIPS the backend's breaker so admission
        # reroutes down the exact-physics ladder (the burn clears when
        # a later probe measures back under budget).
        self.error_budget = float(error_budget or 0.0)
        self.sentinel_every = max(0, int(sentinel_every))
        self.sentinel_k = max(1, int(sentinel_k))
        self.ledger_every = max(0, int(ledger_every))
        # Durable mid-run progress (docs/robustness.md "Sharded &
        # long-job failure modes"): every `progress_every` resident
        # rounds each running job's (state, extras, units-done) rides
        # the background HostWriter into a fenced, checksummed spool
        # snapshot, so adoption/respool resumes from there instead of
        # step 0. 0 disables (restart-clean semantics everywhere).
        self.progress_every = max(0, int(progress_every))
        self._accuracy_burn: dict = {}
        self._last_occupancy: Optional[float] = None
        self._last_adoption_dump = 0.0
        # 0 = unbounded (in-process consumers); the daemon defaults to
        # a bound so backlog sheds instead of growing without limit.
        self.max_queue = max_queue
        self.max_requeues = max_requeues
        self.breakers = BreakerBoard(
            threshold=breaker_threshold, cooldown_s=breaker_cooldown_s,
            on_card=self.engine.device.type == "cuda",
        )
        # Fleet mode: lease ownership whenever jobs are durable.
        self.leases: Optional[LeaseManager] = None
        if spool is not None:
            self.leases = LeaseManager(
                spool.root, self.worker_id, ttl_s=lease_ttl_s,
                recorder=self.telemetry.recorder,
            )
            spool.attach_leases(self.leases)
        self._next_scan = 0.0
        # Spool records whose durable-terminal state is already
        # registered locally — skipped by the reaper without a read.
        self._known_terminal: set = set()
        self.reap_interval_s = (
            reap_interval_s if reap_interval_s is not None
            else min(max(lease_ttl_s / 4.0, 0.05), 5.0)
        )
        self._last_round_s = 1.0
        # Background spool writer (docs/scaling.md "Host pipeline &
        # donation", serving half): completed-job result fetch (the D2H
        # of the final state) and the .npz write run off the round
        # loop, overlapping the next round's device compute. One
        # bounded FIFO thread — results land in completion order, and
        # a failed write surfaces at the next submit/drain.
        self._io = None
        if spool is not None:
            from ..utils.hostio import HostWriter

            self._io = HostWriter(max_queue=8, name="gravity-spool-io")
        self.jobs: dict[str, Job] = {}
        self._seq = 0
        # Per-key pending job ids and resident batches.
        self._pending: dict[BatchKey, list[str]] = {}
        self._batches: dict[BatchKey, EnsembleBatch] = {}
        self._slot_jobs: dict[BatchKey, list[Optional[str]]] = {}
        self._rotation: list[BatchKey] = []
        self._rotor = 0
        # Sweep parents: tracked jobs that never occupy a slot; their
        # members complete them (``_check_parents``).
        self._parents: set = set()
        # Sliding window: all-time percentiles stop reflecting current
        # serving health and the list is a slow leak in a long-lived
        # daemon (review finding).
        from collections import deque

        self._completed_latencies: deque = deque(maxlen=512)
        # Per-class latency windows + terminal counters (/metrics
        # "classes": queue/active are recomputed per call; these are
        # the cumulative halves).
        self._class_latencies: dict = {}
        self._class_terminal: dict = {}
        self.rounds_run = 0
        # Last published metrics snapshot: /metrics serves this when
        # the round lock is busy (a long compile must not stall
        # scrapes — docs/observability.md), refreshed at round end and
        # in housekeeping.
        self.last_metrics: Optional[dict] = None
        self._last_metrics_pub = 0.0
        if spool is not None:
            self._respool()
        self.metrics_snapshot()

    # --- submission / lifecycle API ---

    def submit(
        self,
        config: SimulationConfig,
        *,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        job_id: Optional[str] = None,
        job_type: str = "integrate",
        params: Optional[dict] = None,
        _internal: bool = False,
    ) -> str:
        """Validate + enqueue; returns the job id. Raises ValueError
        (:class:`~gravity_tpu_torch.serve.jobs.JobValidationError` for
        malformed class payloads: an unknown type, a fit without
        observations, a sweep with zero members, a watch without a radius)
        for jobs the stack cannot serve and :class:`QueueFull` when the
        bounded queue is shedding.

        ``job_type`` selects the traffic class (serve/jobs registry);
        ``params`` is the class payload, validated HERE so a bad job is
        a clean submit-time 400, never an admission-round crash. A sweep
        expands into its members in this call (each an ordinary leased,
        respoolable job; ``_internal`` admits those).

        An explicit ``job_id`` is an idempotency key: re-submitting the
        SAME job under a known id returns that id instead of raising
        — the client retry path (lost response after the daemon already
        accepted, or a failover re-POST to a surviving worker) must not
        enqueue the simulation twice. A known id with a DIFFERENT
        config/type/payload is still a hard duplicate error."""
        from .jobs import JobValidationError, get_class

        cls = get_class(job_type)
        if not getattr(cls, "submittable", True) and not _internal:
            raise JobValidationError(
                f"job type {job_type!r} is internal (submit its parent "
                "class instead)")
        params = cls.validate(config, params or {})
        # Telemetry: the trace is born HERE. The admission span id is
        # pre-minted so the autotune probe (which may run inside the
        # batch keying below) can parent its span under it.
        t_admit = time.time()
        trace_id = _tracing.new_trace_id()
        admission_span = _tracing.new_span_id()
        if job_id is not None:
            # The id becomes a file name under jobs/ leases/ results/
            # cancel/ — and arrives over an open HTTP API. Reject
            # anything that could escape the spool or break the
            # listdir-based reaper.
            import re

            if not re.fullmatch(r"[A-Za-z0-9._-]{1,128}", job_id) \
                    or job_id.startswith("."):
                raise ValueError(
                    f"invalid job id {job_id!r}: 1-128 chars from "
                    "[A-Za-z0-9._-], not starting with '.'"
                )
        fingerprint = (
            config.to_json(), job_type,
            json.dumps(params, sort_keys=True),
        )
        if job_id is not None:
            existing = self.jobs.get(job_id)
            if existing is not None:
                if (
                    existing.config.to_json(), existing.job_type,
                    json.dumps(existing.params, sort_keys=True),
                ) == fingerprint:
                    return job_id
                raise ValueError(f"duplicate job id {job_id!r}")
            if self.spool is not None:
                # Unknown locally but maybe not fleet-wide: a retry
                # after a lost response may land on a worker that has
                # not scanned the accepting worker's record yet — or
                # after the job already COMPLETED and released its
                # lease. Absorb the record through the reaper's own
                # path (terminal ⇒ registered as done, never re-run;
                # live-peer-owned ⇒ registered read-only; claimable ⇒
                # we adopt it) instead of minting a duplicate run.
                record = self.spool.read_job(job_id)
                if record is not None:
                    rec_fp = (
                        json.dumps(record.get("config"),
                                   sort_keys=True),
                        record.get("job_type", "integrate"),
                        json.dumps(record.get("params") or {},
                                   sort_keys=True),
                    )
                    if rec_fp != (
                        json.dumps(json.loads(config.to_json()),
                                   sort_keys=True),
                        job_type,
                        json.dumps(params, sort_keys=True),
                    ):
                        raise ValueError(
                            f"duplicate job id {job_id!r}"
                        )
                    self._absorb_spool_record(job_id, record, None)
                    return job_id
        resident = getattr(cls, "resident", True)
        # A sweep admits its whole member fan-out in one call: shed it as
        # a unit (members are queue entries), not after half are in.
        admits = 1 if resident else int(params.get("members", 1))
        if self.max_queue and self.queue_depth + admits > self.max_queue:
            # Load shed with a retry hint sized to how fast rounds are
            # actually draining the queue here, not a magic constant.
            retry_after = max(1.0, round(
                self._last_round_s
                * (self.queue_depth / max(self.slots, 1)), 1,
            ))
            self._event("shed", n=config.n, queue_depth=self.queue_depth,
                        retry_after_s=retry_after)
            raise QueueFull(retry_after, self.queue_depth)
        # The autotune probe (resolve_engine_backend on a cache miss) runs
        # inside the keying, under the caller's round lock: on the card
        # it launches kernels, serialised with the rounds.
        with _tracing.bind(self.telemetry.tracer, trace_id,
                           parent=admission_span):
            if resident:
                key = self._job_key_for(cls, config, params)
            else:
                # A parent never enters a batch, but its members must be
                # servable: key one member now, so that the whole fan-out
                # is one submit-time rejection, not N admission failures.
                key = self._job_key_for(get_class("sweep-member"), config, {
                    "member": 0, **{k: v for k, v in params.items() if k in (
                        "spread", "drift_tol", "escape_radius",
                        "sweep_seed")}})
        # Memory-aware admission (docs/observability.md
        # "Performance"): the resolved key's program must fit device
        # memory — from the perf ledger's MEASURED peak HBM when the
        # key has compiled before, the sizing-model estimate on a cold
        # key. An over-budget job is a typed submit-time rejection
        # (HTTP 400), never an OOM that takes down a live round and
        # its batchmates — the first concrete piece of the ROADMAP-1
        # router's placement logic. No-op where the platform exposes
        # no budget (CPU without the GRAVITY_TPU_HBM_BYTES override).
        from ..telemetry import perf as _perf

        try:
            _perf.check_admission_memory(key)
        except _perf.InsufficientDeviceMemory as e:
            self._event(
                "memory_rejected", n=config.n, job_type=job_type,
                backend=key.backend, bucket=key.bucket_n,
                required_bytes=e.required_bytes,
                budget_bytes=e.budget_bytes, source=e.source,
            )
            raise
        if deadline_s is not None:
            # Coerce at the boundary: the HTTP API is open, and a
            # string deadline would TypeError inside _expire_deadlines
            # EVERY round, wedging the whole daemon (review finding).
            deadline_s = float(deadline_s)
        job_id = job_id or f"job-{uuid.uuid4().hex[:12]}"
        if job_id in self.jobs:
            raise ValueError(f"duplicate job id {job_id!r}")
        self._seq += 1
        job = Job(
            id=job_id, config=config, priority=priority,
            deadline_s=deadline_s, seq=self._seq,
            submitted_ts=time.time(),
            job_type=job_type, params=params,
            parent=params.get("parent") if _internal else None,
            trace_id=trace_id,
        )
        if self.leases is not None:
            lease = self.leases.claim(
                job_id, min_fence=self.spool.record_fence(job_id)
            )
            if lease is None:
                # A live lease with no readable record: the owner died
                # between claim and persist, or the record is torn.
                # (A record-backed retry was already absorbed above.)
                raise ValueError(
                    f"job id {job_id!r} is leased by another worker"
                )
            job.fence = lease.fence
        self.jobs[job_id] = job
        if resident:
            self._enqueue(key, job_id)
        else:
            self._parents.add(job_id)
        try:
            self._persist(job, raise_oserr=True)
        except OSError as e:
            # Admission must be DURABLE-or-rejected: unwind the local
            # enqueue and fail the submit (HTTP 500) rather than hand
            # the client an id no worker could ever adopt or respool.
            # No `submitted` event has been emitted yet — the durable
            # stream never records a lifecycle that will have no
            # terminal event (the spool_error from _persist is the
            # audit trail).
            self.jobs.pop(job_id, None)
            self._parents.discard(job_id)
            if job_id in self._pending.get(key, []):
                self._pending[key].remove(job_id)
            if self.leases is not None:
                self.leases.release(job_id)
            raise RuntimeError(
                f"submit rejected: spool cannot persist the job "
                f"record ({e})"
            ) from e
        if resident:
            self._event("submitted", job=job_id, n=config.n,
                        bucket=key.bucket_n, priority=priority,
                        job_type=job_type)
        else:
            self._event("submitted", job=job_id, n=config.n,
                        priority=priority, job_type=job_type,
                        members=admits)
        self.telemetry.registry.counter(
            "gravity_jobs_submitted_total", **{"class": job_type}
        ).inc()
        self.telemetry.tracer.emit(
            "admission", trace_id, t_admit, time.time() - t_admit,
            span_id=admission_span, job=job_id, job_type=job_type,
            n=config.n,
        )
        if not resident:
            # The members through the normal submit path, each an ordinary
            # leased, respoolable, adoptable job (deterministic ids: a
            # retried or adopted expansion reuses the same records).
            for k in range(admits):
                self.submit(
                    config, priority=priority, deadline_s=deadline_s,
                    job_id=cls.member_id(job_id, k),
                    job_type="sweep-member",
                    params=cls.member_params(job, k), _internal=True)
        return job_id

    def _check_parents(self) -> None:
        """Complete the sweep parents whose members are all terminal:
        aggregate the member verdicts (local jobs first, the shared
        spool's records for peer-run members) into the parent's result.
        A member with neither a job nor a record (a fan-out cut by a
        worker's death) is submitted again from its deterministic id and
        params, so that an adopted half-expanded sweep completes."""
        from .jobs import get_class

        for pid in list(self._parents):
            job = self.jobs.get(pid)
            if job is None or job.status in TERMINAL or not job.owned:
                continue
            cls = get_class(job.job_type)
            members = int(job.params.get("members", 0))
            payloads: list = [None] * members
            done = 0
            complete = True
            for k in range(members):
                mid = cls.member_id(pid, k)
                member = self.jobs.get(mid)
                status = payload = None
                if member is not None:
                    status, payload = member.status, member.result_payload
                if (member is None or not member.owned) \
                        and status not in TERMINAL \
                        and self.spool is not None:
                    rec = self.spool.read_job(mid)
                    if rec is not None:
                        status = rec.get("status")
                        payload = rec.get("result")
                if status is None:
                    complete = False
                    try:
                        self.submit(
                            job.config, priority=job.priority,
                            deadline_s=job.deadline_s, job_id=mid,
                            job_type="sweep-member",
                            params=cls.member_params(job, k),
                            _internal=True)
                    except (ValueError, QueueFull):
                        pass  # shed or leased by a peer: the next scan
                    continue
                if status not in TERMINAL:
                    # Keep counting: progress must not understate behind
                    # one running member.
                    complete = False
                    continue
                if status == "completed":
                    done += 1
                    payloads[k] = payload
            job.steps_done = done
            if not complete:
                continue
            arrays, payload = cls.aggregate(job, payloads)
            job.result_payload = payload
            job.result_data = arrays
            if self.spool is not None:
                self._spool_result_async(job, arrays)
            if done > 0:
                self._finish(job, "completed")
            else:
                self._finish(job, "failed",
                             error=f"all {members} members failed/cancelled")

    def cancel(self, job_id: str) -> bool:
        job = self.jobs.get(job_id)
        if job is None or not job.owned:
            # Not ours (a peer owns it, or we have never heard of it):
            # if the SHARED spool has a live record, drop a cancel
            # marker the owner consumes in its housekeeping — any
            # worker accepts the cancel, the owner executes it.
            if self.spool is not None:
                record = self.spool.read_job(job_id)
                if record is not None and record.get(
                    "status", "pending"
                ) not in TERMINAL:
                    self.spool.request_cancel(job_id)
                    return True
            return False
        if job.status in TERMINAL:
            return False
        if job_id in self._parents:
            # Cancelling a sweep cancels its members (local ones directly,
            # peer-owned ones through the spool's cancel marker).
            from .jobs import get_class

            cls = get_class(job.job_type)
            for k in range(int(job.params.get("members", 0))):
                mid = cls.member_id(job_id, k)
                member = self.jobs.get(mid)
                if member is None or member.status not in TERMINAL:
                    self.cancel(mid)
            self._finish(job, "cancelled")
            return True
        if job.status == "running":
            key = self._assigned_key(job)
            slots = self._slot_jobs.get(key, [])
            if job_id in slots:
                self._free_slot(key, slots.index(job_id))
        else:
            key = self._assigned_key(job)
            if job_id in self._pending.get(key, []):
                self._pending[key].remove(job_id)
        self._finish(job, "cancelled")
        return True

    def status(self, job_id: str) -> Optional[dict]:
        job = self.jobs.get(job_id)
        if job is None:
            return None
        if not job.owned and self.spool is not None:
            # A peer owns it: its spool record is the live truth.
            self._sync_from_record(job)
        return job.to_dict()

    def result_data(self, job_id: str) -> Optional[dict]:
        """A completed job's result arrays — the class's full schema
        (integrate: positions/velocities/masses; fit adds the fitted
        parameters + loss; sweeps their per-member verdict arrays)."""
        job = self.jobs.get(job_id)
        if job is None:
            return None
        if not job.owned and self.spool is not None:
            self._sync_from_record(job)
        if job.status != "completed":
            return None
        # Single read: the background spool writer sets
        # job.result_data = None (without a lock) once the .npz is
        # durably down — reading the attribute twice races it into
        # returning None for a job whose result exists both in memory
        # and on disk.
        data = job.result_data
        if data is not None:
            return data
        state = job.state
        if state is not None:
            pos, vel, m = state_to_numpy(state)
            return {"positions": pos, "velocities": vel, "masses": m}
        if self.spool is not None:
            return self.spool.load_result(job_id)
        return None

    def result(self, job_id: str) -> Optional[ParticleState]:
        """ParticleState view of :meth:`result_data` (the classic
        integrate client surface; classes without a state result —
        sweep parents — return None here)."""
        data = self.result_data(job_id)
        if data is None or "positions" not in data:
            return None
        return ParticleState.create(
            np.asarray(data["positions"]), np.asarray(data["velocities"]),
            np.asarray(data["masses"]),
        )

    def peek_state(self, job_id: str) -> Optional[ParticleState]:
        """Current (unpadded) state of a job wherever it lives: its
        resident slot while running, its evict/terminal snapshot
        otherwise — round-boundary observability (sweep trajectory
        frames) without disturbing the batch."""
        job = self.jobs.get(job_id)
        if job is None:
            return None
        if job.status == "running":
            key = self._assigned_key(job)
            slots = self._slot_jobs.get(key, [])
            if job_id in slots:
                return self.engine.slot_state(
                    self._batches[key], slots.index(job_id)
                )
        return job.state

    @property
    def queue_depth(self) -> int:
        return sum(len(q) for q in self._pending.values())

    @property
    def active_count(self) -> int:
        return sum(
            1 for slots in self._slot_jobs.values()
            for j in slots if j is not None
        )

    def has_work(self) -> bool:
        if self.queue_depth > 0 or self.active_count > 0:
            return True
        # A sweep parent whose members are still landing is work: the
        # aggregation check must run until it goes terminal.
        return any(
            job is not None and job.owned and job.status not in TERMINAL
            for job in map(self.jobs.get, self._parents))

    def latency_percentiles(self, job_type: Optional[str] = None
                            ) -> dict:
        lat = list(
            self._completed_latencies if job_type is None
            else self._class_latencies.get(job_type, ())
        )
        if not lat:
            return {"p50_s": None, "p95_s": None, "p99_s": None}
        return {
            "p50_s": float(np.percentile(lat, 50)),
            "p95_s": float(np.percentile(lat, 95)),
            "p99_s": float(np.percentile(lat, 99)),
        }

    def class_metrics(self) -> dict:
        """Per-traffic-class serving health: queue depth, occupancy,
        terminal counters, completed-latency percentiles — the
        /metrics "classes" block."""
        queue: dict = {}
        for key, pending in self._pending.items():
            queue[key.job_type] = queue.get(key.job_type, 0) \
                + len(pending)
        for pid in self._parents:
            job = self.jobs.get(pid)
            if job is not None and job.owned \
                    and job.status not in TERMINAL:
                queue[job.job_type] = queue.get(job.job_type, 0) + 1
        active: dict = {}
        for key, slots in self._slot_jobs.items():
            n_act = sum(1 for j in slots if j is not None)
            if n_act:
                active[key.job_type] = \
                    active.get(key.job_type, 0) + n_act
        out = {}
        for jt in (
            set(queue) | set(active) | set(self._class_terminal)
            | set(self._class_latencies)
        ):
            terminal = self._class_terminal.get(jt, {})
            out[jt] = {
                "queue_depth": queue.get(jt, 0),
                "active": active.get(jt, 0),
                "completed": terminal.get("completed", 0),
                "failed": terminal.get("failed", 0),
                "cancelled": terminal.get("cancelled", 0),
                "latency": self.latency_percentiles(jt),
            }
        return out

    def slo_status(self) -> dict:
        """Current SLO flags + burn state for /metrics."""
        return {
            "p99_ms": self.slo_p99_ms,
            "occupancy": self.slo_occupancy,
            "burn": dict(self._slo_burn),
        }

    def metrics_snapshot(self) -> dict:
        """The full worker metrics view — one dict behind the JSON
        /metrics payload, the Prometheus exposition's gauge refresh,
        and the per-worker snapshot file the fleet view aggregates.
        Stored in ``self.last_metrics`` so the daemon can serve a
        scrape WITHOUT the round lock while a long compile holds it
        (satellite contract: a scrape returns within a bound even
        mid-round)."""
        reg = self.telemetry.registry
        reg.gauge("gravity_queue_depth").set(self.queue_depth)
        reg.gauge("gravity_active_slots").set(self.active_count)
        breakers = self.breakers.snapshot()
        for backend, b in breakers.items():
            reg.gauge("gravity_breaker_open", backend=backend).set(
                1.0 if b.get("state") == "open" else 0.0
            )
        recorder = self.telemetry.recorder
        snap = {
            "v": 1,
            "ts": round(time.time(), 3),
            "worker_id": self.worker_id,
            "queue_depth": self.queue_depth,
            "active": self.active_count,
            "rounds": self.rounds_run,
            "occupancy": self._last_occupancy,
            "latency": self.latency_percentiles(),
            "classes": self.class_metrics(),
            "compile_counts": {
                f"job={k.job_type},bucket={k.bucket_n},"
                f"slots={k.slots},backend={k.backend}": v
                for k, v in self.engine.compile_counts.items()
            },
            "breakers": breakers,
            # The port's device-side counters: the engine's builds, force
            # evaluations and host reads, and every kernel's launches in
            # this process (a daemon's own, read over /metrics).
            "engine": self.engine.stats(),
            "kernel_launches": _kernel_launches(),
            # The sharded keys' worker groups: devices, build seconds and
            # rank 0's kernel launches.
            "sharded_groups": group_stats(self.engine),
            "router": _router_verdicts(),
            "perf_ledger": _perf_rows(),
            "max_queue": self.max_queue,
            "leases_held": (
                len(self.leases.held_ids())
                if self.leases is not None else 0
            ),
            "slo": self.slo_status(),
            "numerics": {
                "error_budget": self.error_budget or None,
                "sentinel_every": self.sentinel_every,
                "sentinel_k": self.sentinel_k,
                "ledger_every": self.ledger_every,
                "accuracy_burn": {
                    k: v for k, v in self._accuracy_burn.items() if v
                },
            },
            "flightrec": {
                "entries": len(recorder),
                "dumps": recorder.dumps,
                "last_dump": recorder.last_dump_path,
            },
            "registry": reg.snapshot(),
        }
        self.last_metrics = snap
        return snap

    def _publish_metrics(self, min_interval_s: float = 1.0) -> None:
        """Refresh ``last_metrics`` and (spool mode, rate-limited)
        write it to ``workers/<id>.metrics.json`` — the file the fleet
        view (`/metrics?fleet=1`, `gravity_tpu fleet-status`) reads
        for every live worker without having to scrape N HTTP
        endpoints mid-round."""
        now = time.time()
        # Elapsed-since-last-publish, not an absolute deadline: a
        # caller with a long interval (idle housekeeping at
        # reap_interval_s) must not suppress a later caller's shorter
        # one (round end at 1s) — the round-end freshness contract is
        # "stale by at most ~a round" (review finding).
        if now - self._last_metrics_pub < min_interval_s:
            return
        self._last_metrics_pub = now
        snap = self.metrics_snapshot()
        if self.spool is not None:
            workers_dir = os.path.join(self.spool.root, "workers")
            path = os.path.join(
                workers_dir, f"{self.worker_id}.metrics.json"
            )
            # fault_injection=False: a best-effort metrics publish
            # must not consume a torn_spool_write chaos token aimed at
            # job/lease records.
            try:
                os.makedirs(workers_dir, exist_ok=True)
                atomic_write_json(path, snap, fault_injection=False)
            except OSError:
                pass  # metrics publication must never fail serving

    # --- internals ---

    def _event(self, kind: str, /, **fields) -> None:
        if self.events is not None:
            self.events.event(kind, **fields)
        # Every serving event also lands in the flight-recorder ring:
        # a dump is the merged recent history, not one stream's view.
        self.telemetry.recorder.record("event", event=kind, **fields)
        if kind == "breaker_open":
            # A breaker opening is a fleet incident: dump the recent
            # history at the moment of the first strike-over-threshold
            # (both the slot-load and the run_slice strike sites land
            # here).
            self._dump_flightrec("breaker_open")
        elif kind == "adopted" and fields.get("from_worker") not in (
            None, self.worker_id
        ):
            # Adopting a dead peer's jobs means a worker just died
            # unexpectedly — the survivor's ring holds the discovery
            # sequence (expired lease, claim, respool). One dump per
            # reaper pass, not one per adopted job.
            now = time.time()
            if now - self._last_adoption_dump > 5.0:
                self._last_adoption_dump = now
                self._dump_flightrec("adoption")

    def _dump_flightrec(self, reason: str) -> Optional[str]:
        path = self.telemetry.recorder.dump(reason)
        if path is not None:
            self.telemetry.registry.counter(
                "gravity_flightrec_dumps_total"
            ).inc()
        return path

    def _persist(self, job: Job, raise_oserr: bool = False,
                 before_write=None) -> bool:
        """Write the job record; False = fencing rejected it (we lost
        ownership to an adopter — local state re-synced from disk).

        ``raise_oserr`` (the ADMISSION persist): a disk that cannot
        take the record must fail the submit honestly — accepting a
        job whose spool record never landed would be accept-and-maybe-
        lose (no peer could ever adopt it). Every later persist runs
        mid-round and degrades instead (typed ``spool_error``): one
        full disk must not respool a whole bucket of batchmates.

        An already-UNOWNED job never writes at all: a fenced write
        absorbed the adopter's record — INCLUDING its fence — as the
        local truth (``_apply_record``), so a later write from this
        zombie would carry the adopter's own token and PASS
        validation, clobbering the owner's record and emitting a
        duplicate terminal event (the chaos-2 exactly-one-completed
        invariant; surfaced when slower admissions let a fenced
        admission write land before the resident copy finished).

        ``before_write`` runs once the fence has passed, just before the
        record lands (a terminal event: no reader of the record sees the
        job terminal before its event)."""
        if self.spool is None:
            return True
        if not job.owned:
            return False
        try:
            landed = self.spool.write_job(job, before_write=before_write)
        except OSError as e:
            # Disk full (ENOSPC) or any other I/O failure persisting
            # the record: degrade durability for THIS job — typed
            # spool_error, local state stays the truth — instead of
            # letting the OSError surface as a generic round failure
            # that respools every batchmate.
            self._event("spool_error", job=job.id, error=str(e),
                        write="record")
            if raise_oserr:
                raise
            return True
        if not landed:
            # Fenced out: a newer claim (our adopter) owns this job —
            # its record is the truth; stop believing our local copy.
            self._event("fenced", job=job.id, fence=job.fence,
                        write="job")
            self._sync_from_record(job)
        return landed

    def _apply_record(self, job: Job, rec: Optional[dict]) -> None:
        """Overlay a spool record (the owner's truth) onto our local
        job and mark it unowned."""
        if rec:
            job.status = rec.get("status", job.status)
            job.steps_done = rec.get("steps_done", job.steps_done)
            job.error = rec.get("error", job.error)
            job.fence = rec.get("fence", job.fence)
            job.requeues = rec.get("requeues", job.requeues)
            job.announced = bool(rec.get("announced", job.announced))
            job.finished_ts = rec.get("finished_ts", job.finished_ts)
            job.result_payload = rec.get("result", job.result_payload)
        job.owned = False
        job.state = None
        job.extra_state = None
        job.result_data = None
        if self.leases is not None:
            self.leases.forget(job.id)

    def _sync_from_record(self, job: Job) -> None:
        self._apply_record(job, self.spool.read_job(job.id))

    def _spool_result_async(self, job: Job, result) -> None:
        # The closure captures ONLY what it needs (spool / events /
        # leases / the job) — never `self`: a queued result write must
        # not keep a dropped scheduler alive past its __del__-time
        # lease release (the restart-respool tests rely on `del sched`
        # behaving like a clean stop).
        spool, events, leases = self.spool, self.events, self.leases
        fence = job.fence if leases is not None else None
        tracer, trace_id = self.telemetry.tracer, job.trace_id

        def _write() -> None:
            # Errors are handled HERE, per job, not left in the
            # HostWriter: its sticky first-error would otherwise
            # re-raise on every later submit mid-run_round — before
            # _free_slot/_finish — leaking the slot and zombifying the
            # whole daemon over one failed write (review finding). A
            # failed write keeps job.state in memory, so result() still
            # serves it for this process's lifetime; only a restart
            # loses it (and then respools the job).
            # The lease stays renewed until the bytes land, whatever the
            # round thread does meanwhile: a peer cannot adopt (and re-run)
            # a completed job whose result is in flight.
            kept = (leases.kept() if leases is not None
                    else contextlib.nullcontext())
            try:
                with kept:
                    # D2H span: fetching the result arrays off the device
                    # is the heavy host half; the spool write is the disk
                    # half — split so the trace shows which one hurt.
                    t_d2h = time.time()
                    fetched = Spool.normalize_result(result)
                    if trace_id:
                        tracer.emit("d2h", trace_id, t_d2h,
                                    time.time() - t_d2h, job=job.id)
                    t_wr = time.time()
                    path = spool.write_result(job.id, fetched, fence=fence)
                    if trace_id:
                        tracer.emit("result_write", trace_id, t_wr,
                                    time.time() - t_wr, job=job.id,
                                    fenced=path is None)
            except Exception as e:  # noqa: BLE001
                try:
                    if events is not None:
                        events.event("spool_error", job=job.id,
                                     error=str(e), write="result")
                except Exception:  # noqa: BLE001 — the event log likely
                    pass  # shares the failing disk; stay un-sticky
                return
            if path is None:
                # Fenced out mid-air: an adopter's result is already
                # (or about to be) the durable one; ours is discarded.
                try:
                    if events is not None:
                        events.event("fenced", job=job.id, fence=fence,
                                     write="result")
                except Exception:  # noqa: BLE001
                    pass
                if leases is not None:
                    leases.forget(job.id)
                return
            # Only after the bytes are durably down: result() now
            # reloads from the spool instead of the in-memory copy,
            # and the lease is safe to release (an adopter scanning a
            # completed-without-result record would otherwise re-run
            # the job out from under our in-flight write).
            job.state = None
            job.result_data = None
            if leases is not None:
                leases.release(job.id)
            # The result is the durable truth now — the mid-run
            # progress snapshot has nothing left to resume.
            spool.clear_progress(job.id)

        if self._io is None:  # after close_io: degrade to a sync write
            _write()
        else:
            self._io.submit(_write)

    @staticmethod
    def _split_extras(extras: dict) -> tuple[dict, dict]:
        """(array-valued, JSON-valued) halves of an evict-extras dict:
        arrays ride the snapshot ``.npz`` under ``extra.<key>`` names,
        everything JSON-native (fit loss/iteration counters, watch
        event logs and detector flags) rides the meta record."""
        arrs: dict = {}
        meta: dict = {}
        for k, v in (extras or {}).items():
            if isinstance(v, (bool, int, float, str, list, dict)) \
                    or v is None:
                meta[k] = v
            else:
                arrs[f"extra.{k}"] = v
        return arrs, meta

    def _spool_progress_async(self, job: Job, state, extras: dict
                              ) -> None:
        """Queue one durable progress snapshot of a RUNNING job (state
        + merged evict extras at its current unit count) onto the
        background writer — the D2H and disk bytes overlap the next
        round's compute, exactly like result spooling. BEST-EFFORT:
        when the writer queue is full (disk slower than rounds), the
        snapshot is SKIPPED rather than stalling the round loop to
        spool-write throughput — the previous snapshot stays the
        resume point and the next cadence tries again. Failures are
        absorbed per job (``spool_error``); a fenced write (we lost
        the job to an adopter mid-flight) logs ``fenced``."""
        spool, events, leases = self.spool, self.events, self.leases
        fence = job.fence if leases is not None else None
        tracer, trace_id = self.telemetry.tracer, job.trace_id
        job_id, step = job.id, job.steps_done
        arr_extras, meta_extras = self._split_extras(extras)
        arrays = {
            "positions": state.positions,
            "velocities": state.velocities,
            "masses": state.masses,
            **arr_extras,
        }

        def _write() -> None:
            try:
                t0 = time.time()
                path = spool.write_progress(
                    job_id, step, arrays, meta_extras, fence=fence
                )
                if trace_id:
                    tracer.emit(
                        "progress_snapshot", trace_id, t0,
                        time.time() - t0, job=job_id, step=step,
                        fenced=path is None,
                    )
            except Exception as e:  # noqa: BLE001 — a failed snapshot
                # (full disk, injected ENOSPC) degrades durability for
                # THIS job only: it keeps running, the previous
                # snapshot stays the resume point, nothing else trips.
                try:
                    if events is not None:
                        events.event("spool_error", job=job_id,
                                     error=str(e), write="progress")
                except Exception:  # noqa: BLE001 — the event log
                    pass  # likely shares the failing disk
                return
            if path is None:
                try:
                    if events is not None:
                        events.event("fenced", job=job_id, fence=fence,
                                     write="progress")
                except Exception:  # noqa: BLE001
                    pass

        if self._io is None:
            _write()
        elif not self._io.try_submit(_write, reserve=2):
            # Queue crowded: drop THIS snapshot (the recorder keeps
            # the skip auditable). The reserve leaves headroom for the
            # MANDATORY result writes' blocking submits, so snapshot
            # traffic can never couple round latency to disk speed.
            self.telemetry.recorder.record(
                "event", event="progress_skipped", job=job_id, step=step
            )

    def _resume_from_progress(self, job: Job) -> Optional[int]:
        """Try to restore a requeued/adopted job from its last verified
        progress snapshot: populates ``state`` / ``extra_state`` /
        ``steps_done`` (the evict/resume triple, so the continuation
        reproduces what an uninterrupted run would have computed) and
        returns the resume step, or None to restart clean from 0."""
        if self.spool is None or not self.progress_every:
            return None
        snap = self.spool.load_progress(job.id)
        if snap is None:
            return None
        try:
            step = int(snap["step"])
            if not 0 < step <= job.steps:
                return None
            arrays = snap["arrays"]
            state = ParticleState.create(
                arrays["positions"], arrays["velocities"],
                arrays["masses"],
            )
        except (KeyError, TypeError, ValueError):
            return None
        extras = dict(snap.get("extras") or {})
        for k, v in arrays.items():
            if k.startswith("extra."):
                extras[k[len("extra."):]] = v
        job.state = state
        job.extra_state = extras or None
        job.steps_done = step
        self.telemetry.registry.gauge(
            "gravity_job_resume_step", job=job.id
        ).set(float(step))
        return step

    def _clear_progress_async(self, job_id: str) -> None:
        """Clear a job's progress snapshots BEHIND any queued snapshot
        write: the clear rides the same FIFO writer, so a snapshot
        still in the queue when the job goes terminal lands first and
        is then removed — a synchronous clear here would execute
        before the queued write and orphan the re-created files for
        the life of the spool (terminal records are never re-scanned).
        """
        if self._io is None:
            self.spool.clear_progress(job_id)
        else:
            self._io.submit(self.spool.clear_progress, job_id)

    def drain_io(self) -> None:
        """Block until every queued spool write has finished. Result-
        write FAILURES do not surface here — they are absorbed per job
        inside ``_spool_result_async`` (``spool_error`` event, state
        kept in memory) so one bad write cannot poison the writer and
        zombify the daemon; only writer-infrastructure errors (a dead
        thread) would raise. In-process consumers call it at
        end-of-queue; the daemon calls it on shutdown."""
        if self._io is not None:
            self._io.barrier()

    def close_io(self) -> None:
        """Drain and STOP the background writer thread (the scheduler
        is done serving), then RELEASE every held lease — the clean-
        shutdown half of the ownership contract: a stopped worker's
        jobs respool onto the next worker immediately instead of after
        a TTL (a SIGKILL skips all of this; that is what expiry +
        adoption recover). drain_io only barriers — without the close,
        every spool-backed scheduler leaks one idle 'gravity-spool-io'
        thread for the process lifetime (the daemon calls it from
        stop(); Simulator closes its HostWriter the same way)."""
        if self._io is not None:
            self._io.close(raise_errors=False)
            self._io = None
        # The sharded keys' worker groups end with the scheduler.
        self.engine.close()
        if self.leases is not None:
            self.leases.stop_heartbeat()
            self.leases.release_all()
        # The process perf ledger must not keep writing into a closed
        # scheduler's spool/registry (detach only if we still own it —
        # a newer scheduler's attach wins).
        from ..telemetry import perf as _perf

        _perf.ledger().detach(owner=self)

    def __enter__(self) -> "EnsembleScheduler":
        return self

    def __exit__(self, *exc_info) -> None:
        # In-process consumers (tests, embedders): `with` releases the
        # writer thread; without it the thread idles until process exit
        # (it is a daemon thread, so exit itself is clean either way).
        self.close_io()

    def __del__(self) -> None:
        # Dropping the last reference behaves like a clean stop:
        # queued result writes land, leases release. Best-effort only —
        # interpreter teardown may have dismantled half the world.
        try:
            self.close_io()
        except Exception:  # noqa: BLE001
            pass

    def start_lease_heartbeat(self) -> None:
        """Daemon mode: renew leases from a dedicated thread so a
        minutes-long first compile on the round thread cannot let them
        lapse (in-process consumers renew from housekeeping instead)."""
        if self.leases is not None:
            self.leases.start_heartbeat()

    def _job_key_for(self, cls, config: SimulationConfig,
                     params: dict) -> BatchKey:
        return cls.batch_key(
            config, params, slots=self.slots, min_bucket=self.min_bucket,
            reroute=self.breakers.reroute, device=self.engine.device,
        )

    def _job_key(self, job: Job) -> BatchKey:
        from .jobs import get_class

        return self._job_key_for(get_class(job.job_type), job.config,
                                 job.params)

    def _assigned_key(self, job: Job) -> BatchKey:
        """The key this job is actually queued/resident under. Distinct
        from :meth:`_job_key`, which recomputes (and may reroute
        differently once a breaker opens/closes mid-flight)."""
        return job.key_cache if job.key_cache is not None \
            else self._job_key(job)

    def _enqueue(self, key: BatchKey, job_id: str) -> None:
        if key not in self._pending:
            self._pending[key] = []
        if key not in self._rotation:
            self._rotation.append(key)
        self.jobs[job_id].key_cache = key
        self.jobs[job_id].queued_ts = time.time()
        self._pending[key].append(job_id)
        # Priority (desc) then submission order: one sort per admission
        # keeps the head of the queue always the next-due job.
        self._pending[key].sort(
            key=lambda j: (-self.jobs[j].priority, self.jobs[j].seq)
        )

    def _batch_for(self, key: BatchKey) -> EnsembleBatch:
        if key not in self._batches:
            self._batches[key] = self.engine.new_batch(key)
            self._slot_jobs[key] = [None] * key.slots
        return self._batches[key]

    def _finish(
        self, job: Job, status: str, error: Optional[str] = None
    ) -> None:
        job.status = status
        job.error = error
        job.finished_ts = time.time()
        # The drift gauges are the registry's only per-job label
        # dimension: drop the finished job's series so the exposition
        # stays bounded over the daemon's lifetime (the last value
        # lives on in job.drift / the spool record).
        for gname in (
            "gravity_job_energy_drift", "gravity_job_momentum_drift",
            "gravity_job_resume_step",
        ):
            self.telemetry.registry.remove_series(gname, job=job.id)
        # One terminal event a job: a job whose event went out (a re-run
        # of a result lost with its owner) ends silently, whether the
        # re-run completes or is poisoned. The flag rides the record, so
        # a later adopter sees it too. The event goes out once the fence
        # has passed and before the record lands, so whoever reads the
        # job terminal finds its event.
        announce = not job.announced
        emitted = []

        def emit() -> None:
            emitted.append(True)
            if announce:
                job.announced = True
                self._event(
                    status if status in ServingEventLogger.KINDS
                    else "failed",
                    job=job.id, steps_done=job.steps_done, error=error,
                )

        if not self._persist(job, before_write=emit):
            # Fenced: an adopter owns the outcome — no terminal event
            # from the zombie (exactly one completed/failed per job in
            # the shared stream; _persist already logged `fenced`).
            return
        if not emitted:  # no spool, or a record the disk refused
            emit()
        from collections import deque

        counts = self._class_terminal.setdefault(
            job.job_type, {"completed": 0, "failed": 0, "cancelled": 0}
        )
        counts[status] = counts.get(status, 0) + 1
        self.telemetry.registry.counter(
            "gravity_jobs_terminal_total",
            **{"class": job.job_type, "status": status},
        ).inc()
        if status == "completed":
            latency = job.finished_ts - job.submitted_ts
            self._completed_latencies.append(latency)
            self._class_latencies.setdefault(
                job.job_type, deque(maxlen=512)
            ).append(latency)
            # Bucketed twin of the exact-window percentiles: what the
            # Prometheus exposition and the fleet merge read.
            self.telemetry.registry.histogram(
                "gravity_job_latency_seconds",
                **{"class": job.job_type},
            ).observe(latency)
        if self.spool is not None and status != "completed":
            # failed/cancelled: the snapshot is dead weight. A
            # COMPLETED job keeps its progress until the result .npz
            # lands (cleared in the writer callback) — if the owner
            # dies inside that window, the adopter's re-run resumes
            # from the snapshot instead of step 0.
            self._clear_progress_async(job.id)
        if self.leases is not None and status != "completed":
            # failed/cancelled: nothing further to write — release now.
            # A completed job keeps its lease until its .npz lands
            # (released in the writer callback, or by the explicit
            # release on the finalize-from-spool path), so an adoption
            # scan can never re-run it out from under the in-flight
            # result write.
            self.leases.release(job.id)

    def _admit(self, key: BatchKey, slot: int, job: Job) -> bool:
        from .jobs import get_class

        try:
            state = job.state
            if state is None:
                state = get_class(job.job_type).initial_state(job)
        except Exception as e:  # noqa: BLE001 — a bad config must fail
            # THIS job, not crash the scheduling round for its peers
            # (submit-time validation covers the known cases; this is
            # the backstop for the rest).
            self._finish(job, "failed", error=f"admission failed: {e}")
            return False
        # Queue-wait span: enqueue (or last requeue/evict) to now.
        now = time.time()
        if job.trace_id and job.queued_ts:
            self.telemetry.tracer.emit(
                "queue", job.trace_id, job.queued_ts,
                now - job.queued_ts, job=job.id,
            )
            self.telemetry.registry.histogram(
                "gravity_queue_wait_seconds"
            ).observe(now - job.queued_ts)
        t_load = now
        batch = self._batch_for(key)
        try:
            self._batches[key] = self.engine.load_slot(
                batch, slot, state,
                dt=job.config.dt, steps=job.steps - job.steps_done,
                job=job,
            )
        except BackendUnavailable as e:
            # The slot load builds the key's kernel (carried-accel
            # seed): a backend that cannot compile surfaces HERE, at
            # admission — count it on the breaker and requeue the job,
            # which re-keys through the breaker reroute (once the
            # breaker opens, the retry lands in a bucket whose backend
            # builds). The requeue still counts toward max_requeues
            # (at most one admission attempt per job per round, so the
            # counter is per-round-bounded): when even the rerouted
            # FLOOR cannot build, the job must go terminal 'poisoned'
            # instead of burning a failed kernel build every round
            # forever.
            if self.breakers.get(key.backend).record_failure():
                self._event(
                    "breaker_open", backend=key.backend,
                    failures=self.breakers.get(key.backend).failures,
                    error=str(e),
                )
            job.requeues += 1
            if job.requeues > self.max_requeues:
                self._event("poisoned", job=job.id,
                            requeues=job.requeues, error=str(e))
                self._finish(
                    job, "failed",
                    error=f"poisoned: {job.requeues} failed admissions/"
                          f"requeues (last: {e})",
                )
                return False
            try:
                new_key = self._job_key(job)
            except ValueError as err:
                self._finish(job, "failed",
                             error=f"requeue rejected: {err}")
                return False
            self._enqueue(new_key, job.id)
            self._event("respooled", job=job.id,
                        reason=f"backend {key.backend} unavailable")
            self._persist(job)
            return False
        if (
            job.ledger0 is None
            and job.steps_done == 0
            and self.ledger_every
            and getattr(get_class(job.job_type), "conserves", True)
        ):
            # The drift baseline is the job's ACTUAL t0 state (fresh
            # admissions only; an evict/resume keeps its original
            # baseline, an adopted mid-flight job baselines at first
            # observation). Computed INSIDE the slot_load span window
            # (emitted below) so its first-shape compile stays
            # attributed in the job's trace — the coverage gate tiles
            # a job's wall-clock from its top-level spans. Telemetry
            # must never fail an admission.
            try:
                job.ledger0 = self.engine.state_ledger(state, key)
            except Exception:  # noqa: BLE001
                job.ledger0 = None
        if job.trace_id:
            self.telemetry.tracer.emit(
                "slot_load", job.trace_id, t_load,
                time.time() - t_load, job=job.id, slot=slot,
                bucket=key.bucket_n, backend=key.backend,
            )
        self._slot_jobs[key][slot] = job.id
        job.status = "running"
        job.resident_rounds = 0
        if job.started_ts is None:
            job.started_ts = time.time()
        self._event("admitted", job=job.id, slot=slot,
                    bucket=key.bucket_n)
        self._persist(job)
        return True

    def _free_slot(self, key: BatchKey, slot: int) -> None:
        self._batches[key] = self.engine.clear_slot(
            self._batches[key], slot
        )
        self._slot_jobs[key][slot] = None

    def _evict(self, key: BatchKey, slot: int, *, reason: str) -> None:
        """Pull a running job out of its slot, preserving state, and
        re-queue it (continuous-batching time slicing / preemption)."""
        job_id = self._slot_jobs[key][slot]
        job = self.jobs[job_id]
        state, extra = self.engine.slot_snapshot(
            self._batches[key], slot
        )
        job.state = state
        # MERGE: job-level extras (the watch event log, follow-up
        # counters) must survive an evict; the snapshot only refreshes
        # the slot-carried keys.
        job.extra_state = {**(job.extra_state or {}), **extra}
        self._free_slot(key, slot)
        job.status = "pending"
        self._enqueue(key, job_id)
        self._event("yielded", job=job_id, reason=reason,
                    steps_done=job.steps_done)

    def _fill_slots(self, key: BatchKey) -> None:
        """Admission for one key: free slots first, then priority
        preemption, then the anti-starvation yield."""
        pending = self._pending.get(key, [])
        slots = self._slot_jobs.setdefault(key, [None] * key.slots)
        # 1. Backfill free slots. Each candidate is tried at most once
        # per round: an admission failure may requeue the job into this
        # very list (backend-unavailable path), and re-trying it in the
        # same pass would spin. A requeued job at the queue HEAD must
        # not block the rest of the queue either — skip attempted
        # entries and keep admitting, so free slots never sit idle
        # behind one unbuildable job while its breaker warms up.
        attempted: set = set()
        for slot in range(key.slots):
            if slots[slot] is not None:
                continue
            while True:
                job_id = next(
                    (j for j in pending if j not in attempted), None
                )
                if job_id is None:
                    break
                pending.remove(job_id)
                attempted.add(job_id)
                if self._admit(key, slot, self.jobs[job_id]):
                    break
        if not pending or all(j in attempted for j in pending):
            return
        # 2. Priority preemption: a strictly-higher-priority arrival
        # takes the lowest-priority resident's slot.
        for waiting_id in list(pending):
            if waiting_id in attempted:
                continue
            waiter = self.jobs[waiting_id]
            resident = [
                (self.jobs[slots[s]].priority, -s, s)
                for s in range(key.slots) if slots[s] is not None
            ]
            if not resident:
                break
            low_prio, _, low_slot = min(resident)
            if waiter.priority > low_prio:
                self._evict(key, low_slot, reason="preempted")
                pending.remove(waiting_id)
                attempted.add(waiting_id)
                self._admit(key, low_slot, waiter)
            else:
                break  # pending is priority-sorted; no further winners
        if not pending:
            return
        # 3. Anti-starvation time slicing: residents that have held a
        # slot for yield_rounds consecutive rounds give it up to equal-
        # priority waiters (bounded wait: a short job admitted behind a
        # full batch of long jobs runs within yield_rounds+1 rounds).
        for waiting_id in list(pending):
            if waiting_id in attempted:
                continue
            ripe = [
                (-self.jobs[slots[s]].resident_rounds,
                 self.jobs[slots[s]].priority, s)
                for s in range(key.slots)
                if slots[s] is not None
                and self.jobs[slots[s]].resident_rounds
                >= self.yield_rounds
                and self.jobs[slots[s]].priority
                <= self.jobs[waiting_id].priority
            ]
            if not ripe:
                break
            _, _, slot = min(ripe)
            self._evict(key, slot, reason="yield")
            self._pending[key].remove(waiting_id)
            attempted.add(waiting_id)
            self._admit(key, slot, self.jobs[waiting_id])

    def _next_key(self) -> Optional[BatchKey]:
        """Round-robin over keys that have work."""
        n = len(self._rotation)
        for i in range(n):
            key = self._rotation[(self._rotor + i) % n]
            if self._pending.get(key) or any(
                j is not None for j in self._slot_jobs.get(key, [])
            ):
                self._rotor = (self._rotor + i + 1) % n
                return key
        return None

    def _observe_numerics(
        self, key: BatchKey, batch, slots, occupied, res
    ) -> Optional[dict]:
        """The numerics observatory's per-round step
        (docs/observability.md "Numerics"): refresh every finite
        resident job's conservation-ledger drift (gauges + /status),
        and — at the sentinel cadence — probe one resident lane's
        force error against the exact oracle, feeding the per-backend
        error histogram and the error-budget breach check. Returns the
        probe info (for the child-span emission in the accounting
        loop) or None. Telemetry must never fail a round: every
        device-touching step is individually absorbed."""
        reg = self.telemetry.registry
        # rounds_run was already incremented for THIS round; -1 so the
        # first round of a fresh worker lands on the cadence (a short
        # daemon must still produce drift gauges and probe samples).
        tick = self.rounds_run - 1
        led = None
        if self.ledger_every and tick % self.ledger_every == 0:
            try:
                led = self.engine.batch_ledger(batch)
            except Exception:  # noqa: BLE001
                led = None
        if led is not None:
            from ..ops.diagnostics import ledger_drift

            for slot in occupied:
                if not bool(res.finite[slot]):
                    continue
                job = self.jobs.get(slots[slot])
                if job is None:
                    continue
                try:
                    cur = self.engine.slot_ledger_host(led[slot], key)
                except Exception:  # noqa: BLE001
                    continue
                if job.ledger0 is None:
                    # Adopted/evicted mid-flight with no baseline:
                    # first observation becomes it (drift measured
                    # from here on — documented limitation).
                    job.ledger0 = cur
                    continue
                drift = ledger_drift(job.ledger0, cur)
                job.drift = drift
                if drift["energy_drift"] is not None:
                    reg.gauge(
                        "gravity_job_energy_drift", job=job.id
                    ).set(drift["energy_drift"])
                reg.gauge(
                    "gravity_job_momentum_drift", job=job.id
                ).set(drift["momentum_drift"])
        probe = None
        if self.sentinel_every \
                and tick % self.sentinel_every == 0:
            slot = next(
                (s for s in occupied if bool(res.finite[s])), None
            )
            if slot is not None and slots[slot] in self.jobs:
                from ..utils.faults import accuracy_breach_due
                from ..utils.profiling import sentinel_summary

                t0 = time.time()
                try:
                    rel = self.engine.probe_slot_accuracy(
                        batch, slot, k=self.sentinel_k
                    )
                except Exception:  # noqa: BLE001
                    rel = None
                if rel is not None:
                    summary = sentinel_summary(rel)
                    injected = accuracy_breach_due(self.rounds_run)
                    if injected:
                        # Injected solver overload (fault spec
                        # accuracy_breach@R): the breach workflow runs
                        # through its real path on CPU.
                        summary = dict(
                            summary, p90_rel_err=1.0, max_rel_err=1.0,
                            injected=True,
                        )
                    hist = reg.histogram(
                        "gravity_force_error_rel", backend=key.backend
                    )
                    if injected:
                        hist.observe(1.0)
                    else:
                        for v in rel:
                            hist.observe(float(v))
                    reg.counter(
                        "gravity_sentinel_probes_total",
                        backend=key.backend,
                    ).inc()
                    probe = {
                        "job": slots[slot], "slot": slot,
                        "backend": key.backend, "t0": t0,
                        "dur_s": time.time() - t0, **summary,
                    }
                    self._check_accuracy_budget(key, probe)
        return probe

    def _check_accuracy_budget(self, key: BatchKey, probe: dict) -> None:
        """Edge-triggered error-budget enforcement: one
        ``accuracy_breach`` event + flight-recorder dump + breaker
        trip per under->over transition; the burn clears when a later
        probe measures back under budget (which re-enables the
        breaker's success-close path)."""
        if self.error_budget <= 0.0:
            return
        backend = key.backend
        burning = probe["p90_rel_err"] > self.error_budget
        was = self._accuracy_burn.get(backend, False)
        if burning and not was:
            self.telemetry.registry.counter(
                "gravity_accuracy_breaches_total", backend=backend
            ).inc()
            self._event(
                "accuracy_breach", backend=backend, job=probe["job"],
                p90_rel_err=probe["p90_rel_err"],
                budget=self.error_budget,
                injected=bool(probe.get("injected", False)),
            )
            self._dump_flightrec("accuracy_breach")
            if self.breakers.get(backend).trip():
                # The supervisor-heal hook, serving edition: an open
                # breaker reroutes every subsequent keying down the
                # exact-physics ladder (serve/breaker.py) — wrong
                # answers are degraded exactly like kernels that
                # cannot build.
                self._event(
                    "breaker_open", backend=backend,
                    failures=self.breakers.get(backend).failures,
                    error=(
                        f"accuracy breach: sentinel p90 rel err "
                        f"{probe['p90_rel_err']:.3e} > budget "
                        f"{self.error_budget:.3e}"
                    ),
                )
        self._accuracy_burn[backend] = burning

    def run_round(self) -> Optional[dict]:
        """One scheduling round: pick a key, fill its slots, advance its
        batch one step-slice, retire finished/diverged/expired jobs.
        Returns the round's metrics (also streamed as a ``round``
        event), or None when there is no work at all."""
        # Chaos hooks, at the real boundary every round crosses:
        # crash_worker is a genuine un-catchable SIGKILL; stall_worker
        # pauses us with heartbeats suspended (lease expiry + adoption
        # happen to a LIVE process); stale_lease backdates our leases
        # with no sleep at all (the deterministic fencing test).
        maybe_crash_worker(self.rounds_run)
        if self.leases is not None:
            stall = stall_worker_secs(self.rounds_run)
            if stall > 0:
                self.leases.suspend(stall)
                time.sleep(stall)
            stale = stale_lease_secs(self.rounds_run)
            if stale > 0:
                self.leases.suspend(stale)
                self.leases.backdate()
        self.housekeeping()
        # Parent aggregation runs even when no batch has work: the last
        # member may have landed in an earlier round (or on a peer).
        self._check_parents()
        key = self._next_key()
        if key is None:
            return None
        self._expire_deadlines()
        self._fill_slots(key)
        batch = self._batches.get(key)
        slots = self._slot_jobs.get(key, [])
        occupied = [s for s in range(key.slots) if slots[s] is not None]
        if batch is None or not occupied:
            return None

        # Occupancy is what the round INTEGRATED — snapshot it before
        # finished jobs free their slots below.
        occ_particles = sum(
            self.jobs[slots[s]].config.n for s in occupied
        )
        from .jobs import get_class

        cls = get_class(key.job_type)
        # The round-START host snapshot of a class that needs it after the
        # round (watch follow-ups), and the units done before the round,
        # which post_round anchors event steps to.
        round_start = (cls.round_snapshot(self, batch, list(slots))
                       if cls.snapshot_before_round else None)
        start_units = {
            slots[s]: self.jobs[slots[s]].steps_done for s in occupied
        }
        compiles_before = self.engine.compile_counts.get(key, 0)
        t0_wall = time.time()
        t0 = time.perf_counter()
        try:
            batch, res = self.engine.run_slice(batch, self.slice_steps)
            slice_s = time.perf_counter() - t0
        except Exception as exc:
            # run_slice DONATES the batch carry: after a throw mid-slice
            # (e.g. a transient device error at the finite fetch) the
            # resident states are unrecoverable — the old batch's
            # buffers are consumed, and leaving it in _batches would
            # brick this bucket forever ("Array has been deleted" every
            # round) while the daemon reports healthy. Treat it as a
            # bucket crash: drop the batch and re-queue residents clean
            # from step 0 (ICs are a pure function of the config — the
            # same contract as a daemon-restart respool), then re-raise
            # for the caller's backstop.
            breaker = self.breakers.get(key.backend)
            if isinstance(exc, BackendUnavailable):
                # An unbuildable backend, or a sharded key's lost mesh (a
                # stalled or dead worker group), fails every round it is
                # asked to run: count it on the backend's breaker so
                # admission reroutes down the ladder (the elastic half
                # first) instead of burning a round per retry forever.
                opened = breaker.record_failure(reason=str(exc))
            elif self.breakers.on_card:
                # On the card any other round error is a kernel's build or
                # launch error (or the card's own): trip the backend's
                # breaker at once with it as the reason, so that the
                # residents' requeue below fails them with it instead of
                # sending a kernel's job to a plain form.
                opened = breaker.trip(reason=f"{type(exc).__name__}: {exc}")
            else:
                opened = False
            if opened:
                self._event(
                    "breaker_open", backend=key.backend,
                    failures=breaker.failures, error=str(exc),
                )
            # Fatal round error: the batch carry is consumed — dump the
            # flight recorder before the respool bookkeeping so the
            # postmortem sees the ring as the crash left it.
            self.telemetry.recorder.record(
                "event", event="round_error", bucket=key.bucket_n,
                backend=key.backend, error=str(exc),
            )
            self._dump_flightrec("round_error")
            self._batches.pop(key, None)
            resident = [j for j in self._slot_jobs.pop(key, []) if j]
            for job_id in resident:
                job = self.jobs[job_id]
                job.status = "pending"
                job.steps_done = 0
                job.state = None
                job.extra_state = None
                job.result_data = None
                # Same "restart clean" reset as the respool scan: the
                # dead attempt's compute time and timestamps would
                # otherwise double-count in /status once the job
                # re-runs.
                job.started_ts = None
                job.finished_ts = None
                job.error = None
                job.active_s = 0.0
                # Resume from the last verified progress snapshot when
                # one exists (the failed round's work is lost, but
                # every snapshotted round before it is not); the
                # requeue still counts — resumability does not blunt
                # the poison-pill cap.
                resume_step = self._resume_from_progress(job)
                job.requeues += 1
                if job.requeues > self.max_requeues:
                    # Poison pill: this job has now taken down its
                    # bucket max_requeues times — terminal, instead of
                    # starving its batchmates forever.
                    self._event("poisoned", job=job_id,
                                requeues=job.requeues, error=str(exc))
                    self._finish(
                        job, "failed",
                        error=f"poisoned: requeued {job.requeues} times "
                              f"(last round error: {exc})",
                    )
                    continue
                # Re-key on requeue: a breaker that just opened must
                # route the retry to a different bucket/backend.
                try:
                    new_key = self._job_key(job)
                except ValueError as e:
                    self._finish(job, "failed",
                                 error=f"requeue rejected: {e}")
                    continue
                self._enqueue(new_key, job_id)
                self._event(
                    "respooled", job=job_id,
                    reason=(
                        "round failed; resuming from snapshot"
                        if resume_step else
                        "round failed; restarting clean"
                    ),
                    resume_step=resume_step or 0,
                )
                self._persist(job)
            raise
        self._batches[key] = batch
        self.rounds_run += 1
        compiled = (
            self.engine.compile_counts.get(key, 0) > compiles_before
        )
        # Numerics observatory (docs/observability.md "Numerics"):
        # per-slot ledger drift + the cadenced accuracy probe run on
        # the LIVE returned batch, before completed jobs free their
        # slots below. The probe can trip the backend's breaker
        # (budget breach) — so it runs BEFORE the success gate — and
        # its cost is INSIDE round_s, so the per-job round spans keep
        # tiling the job's wall-clock (the trace-coverage contract).
        probe = self._observe_numerics(key, batch, slots, occupied, res)
        if not self._accuracy_burn.get(key.backend) \
                and self.breakers.success(key.backend):
            # A backend in accuracy burn must NOT close its breaker on
            # mere compute success: it runs fine, it is just measured
            # WRONG — only a clean probe (which clears the burn flag)
            # re-opens the gate.
            self._event("breaker_closed", backend=key.backend)
        round_s = time.perf_counter() - t0
        self._last_round_s = round_s
        reg = self.telemetry.registry
        reg.counter("gravity_rounds_total").inc()
        reg.histogram("gravity_round_seconds").observe(round_s)
        if compiled:
            reg.counter("gravity_compiles_total").inc()
        # Performance observatory (docs/observability.md
        # "Performance"): the run-stats-only throughput facts promoted
        # to scrapeable gauges — slot-units/s over this round, and the
        # round's host tax (time outside run_slice: numerics probes,
        # accounting, span emission) as the serve analog of the solo
        # host_gap_frac.
        reg.gauge("gravity_steps_per_sec").set(
            float(np.sum(res.advanced)) / round_s if round_s > 0
            else 0.0
        )
        reg.gauge("gravity_host_gap_frac").set(
            max(0.0, round_s - slice_s) / round_s if round_s > 0
            else 0.0
        )

        # The class's hook BEFORE the accounting: its events and
        # follow-ups see the round-start unit counts, and a job completing
        # this very round still emits its final round's events.
        cls.post_round(self, key, batch, list(slots), res, start_units,
                       round_start)
        real_pairs = 0.0
        for slot in occupied:
            job = self.jobs[slots[slot]]
            if not job.owned:
                # Adopted away mid-round: a fenced write during this
                # round synced the adopter's record over our copy.
                # Drop the resident lane silently — the owner's
                # events/result are the only ones that count, and
                # burning further rounds on it would only produce more
                # fenced writes (and, without the _persist unowned
                # guard, a duplicate terminal event).
                self._free_slot(key, slot)
                continue
            advanced = int(res.advanced[slot])
            job.steps_done += advanced
            job.resident_rounds += 1
            job.active_s += round_s
            real_pairs += cls.pairs_per_unit(job) * advanced
            if job.trace_id:
                # One round span per resident job: same interval for
                # batchmates (they shared the device program), so each
                # job's own timeline stays gap-free. The first round
                # of a key carries the trace cost — surfaced as a
                # child compile span.
                rid = self.telemetry.tracer.emit(
                    "round", job.trace_id, t0_wall, round_s,
                    job=job.id, round=self.rounds_run,
                    units=advanced, bucket=key.bucket_n,
                    backend=key.backend, compiled=compiled,
                )
                if compiled:
                    # Enriched with the perf ledger's figures for this
                    # key (docs/observability.md "Performance"): the
                    # compile span now SAYS what the program costs,
                    # not just that a compile happened.
                    from ..telemetry import perf as _perf

                    led_row = _perf.ledger().row_for(
                        _perf.engine_key_str(key)
                    ) or {}
                    self.telemetry.tracer.emit(
                        "compile", job.trace_id, t0_wall, round_s,
                        parent=rid, bucket=key.bucket_n,
                        backend=key.backend,
                        compile_s=led_row.get("compile_s"),
                        flops=led_row.get("flops"),
                        peak_bytes=led_row.get("peak_bytes"),
                        model_ratio=led_row.get("model_ratio"),
                    )
                if probe is not None and probe["job"] == job.id:
                    # The sentinel's cost + verdict as a CHILD of the
                    # probed job's round span (docs/observability.md
                    # "Numerics").
                    self.telemetry.tracer.emit(
                        "sentinel", job.trace_id, probe["t0"],
                        probe["dur_s"], parent=rid, job=job.id,
                        backend=probe["backend"],
                        median_rel_err=probe["median_rel_err"],
                        p90_rel_err=probe["p90_rel_err"],
                        max_rel_err=probe["max_rel_err"],
                    )
            if not bool(res.finite[slot]):
                # Per-slot watchdog: the engine already rolled the lane
                # back to its round-start state IN-program (run_slice
                # donates the previous round's buffers, so there is no
                # host snapshot to read) — record it, fail the job, free
                # the slot. Batchmates are untouched — vmap lanes are
                # independent.
                job.steps_done -= advanced
                job.state = self.engine.slot_state(batch, slot)
                self._free_slot(key, slot)
                self._finish(
                    job, "failed",
                    error=f"diverged within {cls.units} "
                          f"{job.steps_done + 1}..{job.steps_done + advanced} "
                          f"(non-finite state; last finite "
                          f"{cls.units[:-1]} {job.steps_done})",
                )
                # Divergence postmortem: the failed/round events above
                # are already in the ring — dump it.
                self._dump_flightrec("divergence")
            elif job.steps_done >= job.steps:
                state, extra = self.engine.slot_snapshot(batch, slot)
                job.extra_state = {**(job.extra_state or {}), **extra}
                try:
                    arrays, payload = cls.finalize(
                        job, state, job.extra_state
                    )
                except Exception as e:  # noqa: BLE001 — a verdict that
                    # cannot be computed fails THIS job, not the round.
                    job.state = state
                    self._free_slot(key, slot)
                    self._finish(
                        job, "failed", error=f"finalize failed: {e}"
                    )
                    continue
                job.result_payload = payload
                job.state = state
                job.result_data = arrays
                if self.spool is not None:
                    # Result fetch + .npz write on the background
                    # writer: the D2H of the final state overlaps the
                    # next round's compute. job.result_data keeps
                    # serving result() from memory until the bytes are
                    # down, then ownership passes to the spool (keeping
                    # every finished state in-memory is an unbounded
                    # leak in a long-lived daemon — review finding).
                    self._spool_result_async(job, arrays)
                self._free_slot(key, slot)
                self._finish(job, "completed")
            elif (
                self.spool is not None
                and self.progress_every
                and job.resident_rounds % self.progress_every == 0
            ):
                # Durable mid-run progress: the still-running job's
                # verified round-boundary state (plus its evict extras
                # — optimizer moments, detector flags) rides the
                # background writer into a fenced, checksummed spool
                # snapshot. Adoption/respool resumes HERE instead of
                # step 0 (docs/robustness.md "Sharded & long-job
                # failure modes"). The slot slices are fresh device
                # buffers, so next round's donation cannot invalidate
                # the queued fetch.
                state, extra = self.engine.slot_snapshot(batch, slot)
                self._spool_progress_async(
                    job, state, {**(job.extra_state or {}), **extra}
                )
        self._check_parents()

        metrics = {
            "job_type": key.job_type,
            "units": cls.units,
            "bucket": key.bucket_n,
            "backend": key.backend,
            "dtype": key.dtype,
            "slots_used": len(occupied),
            "slots_total": key.slots,
            "occupancy": occ_particles / (key.bucket_n * key.slots),
            "queue_depth": self.queue_depth,
            "active": self.active_count,
            "round_s": round_s,
            "slice_steps": self.slice_steps,
            "pairs_per_sec": (
                real_pairs / round_s if round_s > 0 else None
            ),
            **self.latency_percentiles(),
        }
        self._last_occupancy = metrics["occupancy"]
        reg.gauge("gravity_occupancy").set(metrics["occupancy"])
        self._event("round", **metrics)
        self._check_slo(metrics)
        self._publish_metrics(min_interval_s=1.0)
        return metrics

    def _check_slo(self, round_metrics: dict) -> None:
        """Edge-triggered SLO burn: emit one ``slo_breach`` event per
        healthy->breached transition (and count it), clear the flag on
        recovery — a breached fleet must not firehose one event per
        round (docs/observability.md "SLO flags")."""
        reg = self.telemetry.registry
        if self.slo_p99_ms is not None:
            p99 = round_metrics.get("p99_s")
            burning = p99 is not None and p99 * 1e3 > self.slo_p99_ms
            if burning and not self._slo_burn["p99"]:
                reg.counter("gravity_slo_breaches_total",
                            slo="p99").inc()
                self._event("slo_breach", slo="p99",
                            p99_ms=round(p99 * 1e3, 1),
                            target_ms=self.slo_p99_ms)
            self._slo_burn["p99"] = burning
        if self.slo_occupancy is not None:
            occ = round_metrics.get("occupancy")
            burning = occ is not None and occ < self.slo_occupancy
            if burning and not self._slo_burn["occupancy"]:
                reg.counter("gravity_slo_breaches_total",
                            slo="occupancy").inc()
                self._event("slo_breach", slo="occupancy",
                            occupancy=round(occ, 4),
                            target=self.slo_occupancy)
            self._slo_burn["occupancy"] = burning

    def run_until_idle(self, max_rounds: int = 100_000) -> int:
        """Drive rounds until every job is terminal; returns rounds run
        (the in-process consumers: tests, embedders)."""
        rounds = 0
        while self.has_work():
            if rounds >= max_rounds:
                raise RuntimeError(
                    f"run_until_idle exceeded {max_rounds} rounds with "
                    f"{self.queue_depth} queued / {self.active_count} "
                    "active jobs"
                )
            if self.run_round() is None and not self.has_work():
                break
            rounds += 1
        self.drain_io()
        return rounds

    def _expire_deadlines(self) -> None:
        now = time.time()
        for job in list(self.jobs.values()):
            if job.status in TERMINAL or job.deadline_s is None \
                    or not job.owned:
                continue
            if now - job.submitted_ts > job.deadline_s:
                key = self._assigned_key(job)
                if job.status == "running":
                    slots = self._slot_jobs.get(key, [])
                    if job.id in slots:
                        self._free_slot(key, slots.index(job.id))
                elif job.id in self._pending.get(key, []):
                    self._pending[key].remove(job.id)
                self._finish(
                    job, "failed",
                    error=f"deadline of {job.deadline_s}s exceeded",
                )

    # --- fleet-mode housekeeping: heartbeats, adoption, reaping ---

    def housekeeping(self) -> None:
        """Fleet-mode periodic work, callable from any round/idle loop:
        renew our lease heartbeats (rate-limited; the daemon ALSO runs
        the dedicated thread), react to leases we lost while out, and —
        every ``reap_interval_s`` — scan the spool for unclaimed work
        and expired leases to adopt. No-op without a spool."""
        if self.leases is None:
            return
        self.leases.maybe_renew()
        # Drain losses from EVERY renewal path — the rate-limited one
        # above and the daemon's dedicated heartbeat thread (whose
        # renew_all return value nobody reads).
        for job_id in self.leases.take_lost():
            self._on_lease_lost(job_id)
        now = time.time()
        if now < self._next_scan:
            return
        self._next_scan = now + self.reap_interval_s
        self._scan_spool()
        self._consume_cancel_markers()
        self._reap_worker_registry()
        # Keep the published snapshot fresh even while idle (an idle
        # replica still answers /metrics and the fleet view).
        self._publish_metrics(min_interval_s=self.reap_interval_s)

    def _consume_cancel_markers(self) -> None:
        """Execute cross-worker cancel requests for jobs WE own (any
        worker accepts a cancel into the spool; only the owner can pull
        the job out of its batch). Stale markers — job already terminal
        or unknown — are reaped so the directory stays bounded."""
        try:
            names = os.listdir(self.spool.cancels_dir)
        except OSError:
            return
        for name in names:
            if not name.endswith(".json"):
                continue
            job_id = name[:-len(".json")]
            job = self.jobs.get(job_id)
            if job is not None and job.owned \
                    and job.status not in TERMINAL:
                self.cancel(job_id)
                self.spool.clear_cancel(job_id)
            elif job is not None and job.status in TERMINAL:
                self.spool.clear_cancel(job_id)
            elif job is None:
                # Nobody absorbed this job (e.g. a record whose config
                # no live worker can parse — the scan deliberately
                # leaves those unclaimed): cancel it at the SPOOL level
                # under a claimed lease so the marker doesn't sit there
                # forever acknowledging a cancel no one executes.
                rec = self.spool.read_job(job_id)
                if rec is None or rec.get("status") in TERMINAL:
                    self.spool.clear_cancel(job_id)
                    continue
                lease = None if self.leases is None else \
                    self.leases.claim(
                        job_id,
                        min_fence=int(rec.get("fence", 0) or 0),
                    )
                if lease is None:
                    continue  # a live peer owns it; that owner acts
                rec.update(status="cancelled", fence=lease.fence,
                           finished_ts=time.time())
                atomic_write_json(self.spool.job_path(job_id), rec)
                self.leases.release(job_id)
                self.spool.clear_cancel(job_id)
                self._event("cancelled", job=job_id,
                            reason="spool-level cancel (unclaimable "
                                   "record)")

    def _reap_worker_registry(self) -> None:
        """Delete dead SAME-HOST worker endpoint/metrics registry
        files: ``workers/<id>.json`` is only removed by a clean stop,
        so a SIGKILL'd worker leaves an entry every client failover
        and ``fleet-status`` scan must pid-probe forever. Liveness is
        (pid, starttime) process-INSTANCE identity; remote hosts'
        entries are untouchable from here (their pids mean nothing
        locally) and unreadable/torn entries are left for a later
        scan."""
        from .leases import entry_alive

        workers_dir = os.path.join(self.spool.root, "workers")
        try:
            names = os.listdir(workers_dir)
        except OSError:
            return
        for name in names:
            if not name.endswith(".json") \
                    or name.endswith(".metrics.json"):
                continue
            wid = name[:-len(".json")]
            if wid == self.worker_id:
                continue
            info = read_json_retry(os.path.join(workers_dir, name))
            if not isinstance(info, dict):
                continue
            # The SAME liveness rule client failover uses: remote
            # entries always count as alive (unprobeable from here).
            if entry_alive(info):
                continue
            reaped = False
            try:
                os.remove(os.path.join(workers_dir, name))
                reaped = True
            except OSError:
                pass  # a racing peer won, or the dir is read-only:
                # either way the reap is not OURS to announce
            try:
                os.remove(os.path.join(
                    workers_dir, f"{wid}.metrics.json"
                ))
            except OSError:
                pass
            if reaped:
                # Gated on the endpoint remove actually succeeding:
                # an unremovable entry (read-only spool) must not
                # re-emit worker_reaped every 1.25s scan forever, and
                # of two racing survivors only the winner announces.
                self._event("worker_reaped", worker_id=wid,
                            pid=info.get("pid"))

    def _on_lease_lost(self, job_id: str) -> None:
        """A heartbeat discovered a peer adopted this job (our lease
        lapsed — stall, clock trouble, injected staleness): stop
        scheduling it and treat the spool record as the truth. Any
        write we still have in flight is rejected by fencing anyway;
        this just stops wasting rounds on a job we no longer own."""
        job = self.jobs.get(job_id)
        if job is None or job.status in TERMINAL or not job.owned:
            return
        key = self._assigned_key(job)
        if job.status == "running":
            slots = self._slot_jobs.get(key, [])
            if job_id in slots:
                self._free_slot(key, slots.index(job_id))
        elif job_id in self._pending.get(key, []):
            self._pending[key].remove(job_id)
        self._sync_from_record(job)

    def _job_from_record(self, record: dict) -> Optional[Job]:
        from .jobs import JobValidationError, get_class

        try:
            config = SimulationConfig.from_json(
                json.dumps(record["config"])
            )
        except (KeyError, TypeError, ValueError):
            return None
        job_type = record.get("job_type", "integrate")
        try:
            get_class(job_type)
        except JobValidationError:
            # A class this worker's build does not speak: leave the
            # record for a peer that does (same contract as an
            # unparseable config).
            return None
        params = record.get("params")
        self._seq += 1
        return Job(
            id=record["id"], config=config,
            priority=record.get("priority", 0),
            deadline_s=record.get("deadline_s"),
            seq=self._seq,
            status=record.get("status", "pending"),
            steps_done=record.get("steps_done", 0),
            error=record.get("error"),
            submitted_ts=record.get("submitted_ts", time.time()),
            started_ts=record.get("started_ts"),
            finished_ts=record.get("finished_ts"),
            fence=int(record.get("fence", 0) or 0),
            requeues=int(record.get("requeues", 0) or 0),
            announced=bool(record.get("announced"))
            or record.get("status") == "completed",
            job_type=job_type,
            params=params if isinstance(params, dict) else {},
            parent=record.get("parent"),
            result_payload=record.get("result"),
            trace_id=record.get("trace_id") or "",
        )

    def _register_unowned(self, record: dict, known: Optional[Job]
                          ) -> None:
        """Track a peer-owned job so /status and /result on THIS worker
        can answer for it (clients fail over between workers; any
        replica must be able to speak for the whole spool)."""
        if known is not None:
            # The caller just read this record — apply it directly
            # instead of paying a second disk read per job per scan.
            self._apply_record(known, record)
            return
        job = self._job_from_record(record)
        if job is not None:
            job.owned = False
            self.jobs[job.id] = job

    def _respool(self) -> None:
        """Startup scan — same machinery as the periodic reaper."""
        self._scan_spool()

    def _scan_spool(self) -> None:
        """The reaper: walk the spool's job records and take ownership
        of everything claimable — unleased pending work, expired leases
        (a dead peer's jobs: ``adopted`` events), our own records after
        a restart (``respooled``). Idempotent with the async result
        writes: a job whose ``.npz`` already landed is finalized as
        completed, never re-run; one that was mid-flight restarts clean
        from step 0 (ICs are a pure function of the config) with its
        ``requeues`` counter bumped — past ``max_requeues`` it goes
        terminal ``failed`` (``poisoned``) instead of crash-looping
        through the whole fleet. Live peers' jobs are registered
        read-only so any worker can answer status/result for them.

        Steady-state cost: terminal records accumulate for the life of
        the spool, so every record whose terminal state we have already
        registered joins ``_known_terminal`` and is skipped WITHOUT a
        file read — the per-scan cost is O(active + new), not O(every
        job ever submitted)."""
        try:
            names = sorted(os.listdir(self.spool.jobs_dir))
        except OSError:
            return
        for name in names:
            if not name.endswith(".json"):
                continue
            file_id = name[:-len(".json")]
            if file_id in self._known_terminal:
                continue
            known = self.jobs.get(file_id)
            if known is not None and (
                known.owned or known.status in TERMINAL
            ):
                if known.status in TERMINAL and (
                    known.status != "completed"
                    or os.path.exists(self.spool.result_path(file_id))
                ):
                    self._known_terminal.add(file_id)
                    continue
                if known.owned:
                    continue
                # Remaining case: UNOWNED 'completed' with no result
                # bytes — we saw the peer's record during its in-flight
                # result write. If the peer died before the .npz
                # landed, this job is claimable and must RE-RUN — fall
                # through and absorb (while the owner lives, its lease
                # still blocks us).
            record = self.spool.read_job(file_id)
            if record is None:
                continue  # torn write from a crash; the job re-runs
            self._absorb_spool_record(file_id, record, known)

    def _absorb_spool_record(
        self, file_id: str, record: dict, known: Optional[Job]
    ) -> None:
        """Take whatever action one spool record calls for: register a
        durable-terminal or live-peer-owned job read-only, finalize a
        landed-result job, or claim + requeue claimable work (the
        reaper's per-record body; `submit` with an explicit job id
        absorbs through the same path so retries of an already-spooled
        job never fork a duplicate)."""
        job_id = record.get("id")
        if not isinstance(job_id, str) or not job_id:
            return
        status = record.get("status", "pending")
        result_exists = os.path.exists(
            self.spool.result_path(job_id)
        )
        # A "completed" record without its result bytes is not
        # durable (the .npz rides the background writer): treat it
        # like a mid-flight crash and re-run. Every other terminal
        # record is final — register it for queries and move on.
        if status in TERMINAL and (
            status != "completed" or result_exists
        ):
            self._register_unowned(record, known)
            self._known_terminal.add(file_id)
            return
        if self.leases is None:
            lease = None
        else:
            lease = self.leases.claim(
                job_id,
                min_fence=int(record.get("fence", 0) or 0),
            )
            if lease is None:
                # A live peer owns it.
                self._register_unowned(record, known)
                return
        job = known if known is not None \
            else self._job_from_record(record)
        if job is None:
            # Unparseable config (foreign/corrupt record): leave it
            # for a worker that understands it; our lease lapses.
            if self.leases is not None:
                self.leases.release(job_id)
            return
        # A copy cached read-only while the job ran predates its
        # terminal event: the record says whether that went out.
        job.announced = (job.announced or bool(record.get("announced"))
                         or status in TERMINAL)
        self.jobs[job_id] = job
        job.owned = True
        if lease is not None:
            job.fence = lease.fence
        adopted_from = getattr(lease, "adopted_from", None)
        if job.trace_id and adopted_from \
                and adopted_from != self.worker_id:
            # Stitch marker: the adopter's first span in the dead
            # worker's trace (the trace id rode the spool record).
            now = time.time()
            self.telemetry.tracer.emit(
                "adopted", job.trace_id, now, 0.0, job=job_id,
                from_worker=adopted_from, fence=job.fence,
            )
        if result_exists:
            # Idempotent adoption: the result already landed (the
            # writer died between the .npz and the record write, or
            # the record write was fenced) — finalize, don't re-run.
            job.steps_done = job.steps
            job.state = None
            self._event("adopted", job=job_id,
                        from_worker=adopted_from, fence=job.fence,
                        reason="result already on disk")
            self._finish(job, "completed")
            if self.leases is not None:
                self.leases.release(job_id)
            self._clear_progress_async(job_id)
            return
        from .jobs import get_class

        if not getattr(get_class(job.job_type), "resident", True):
            # A sweep parent: nothing to enqueue. Its members are records
            # of their own (absorbed apart); tracking and the aggregation
            # check complete it once they land.
            self._parents.add(job_id)
            job.status = "pending"
            job.state = None
            if adopted_from and adopted_from != self.worker_id:
                self._event("adopted", job=job_id,
                            from_worker=adopted_from, fence=job.fence)
            else:
                self._event("respooled", job=job_id)
            self._persist(job)
            return
        # Interrupted mid-flight, never started, or completed with
        # its result lost: restart clean.
        was_started = (
            status in ("running", "completed")
            or record.get("started_ts") is not None
        )
        job.status = "pending"
        job.steps_done = 0
        job.state = None
        job.extra_state = None
        job.result_data = None
        job.started_ts = None
        job.finished_ts = None
        job.error = None
        job.active_s = 0.0
        # Adoption-as-recovery: resume from the dead owner's (or our
        # own pre-restart) last verified progress snapshot — the steps
        # already paid for are not re-executed. The requeue counter
        # still bumps below: resumability never blunts max_requeues.
        resume_step = self._resume_from_progress(job)
        if was_started:
            job.requeues += 1
            if job.requeues > self.max_requeues:
                self._event("poisoned", job=job_id,
                            requeues=job.requeues)
                self._finish(
                    job, "failed",
                    error=f"poisoned: requeued {job.requeues} "
                          "times across workers",
                )
                return
        try:
            key = self._job_key(job)
        except (ValueError, TypeError) as e:
            # A stale spool record the current envelope rejects
            # (model renamed, caps lowered, ...) must fail THAT job,
            # not crash daemon startup and strand its peers (review
            # finding). TypeError too: dataclasses don't type-check,
            # so a foreign record with a wrong-typed field (n="10")
            # parses fine and only blows up inside the keying.
            self._finish(
                job, "failed", error=f"respool rejected: {e}"
            )
            return
        self._enqueue(key, job.id)
        if adopted_from and adopted_from != self.worker_id:
            self._event("adopted", job=job.id,
                        from_worker=adopted_from, fence=job.fence,
                        resume_step=resume_step or 0)
            if resume_step:
                # The resilience headline: adoption resumed mid-run
                # work instead of re-running it (docs/robustness.md
                # "Sharded & long-job failure modes").
                self._event(
                    "adopted_resumed", job=job.id,
                    from_worker=adopted_from, fence=job.fence,
                    resume_step=resume_step,
                )
        else:
            self._event("respooled", job=job.id,
                        resume_step=resume_step or 0)
        self._persist(job)
