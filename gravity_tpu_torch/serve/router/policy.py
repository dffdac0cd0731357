"""Placement policy — the router's brain, as a PURE function.

Counterpart of ``gravity_tpu/serve/router/policy.py``: the same rules,
the same decisions and rationales on the same views (the tests hold the
two ``Decision.to_dict()`` results equal). Host only: nothing here
touches a device.

``place(job, workers)`` maps one job descriptor plus a list of
:class:`WorkerView` snapshots (registry entry + published metrics,
assembled by the daemon or built synthetically by tests) to one
:class:`Decision` carrying the chosen worker AND the rationale that
chose it, or raises :class:`PlacementError` with a typed, HTTP-mappable
rejection. No I/O, no clocks, no globals: the same inputs always
produce the same decision, which is what makes the policy unit-testable
against synthetic fleets and the ``routed`` events auditable after the
fact.

Rules, in evidence order:

1. **Liveness / drain filter** — dead (``entry_alive`` false) and
   draining workers never receive placements; an empty fleet is a 503
   the client retries against direct discovery.
2. **Sharded exclusivity** — ``sharded-integrate`` goes only to
   sharded-capable workers, preferring an idle one (the job IS the
   batch). Sharded **nlist** jobs
   additionally require the worker's ``nlist_capable`` capability —
   the truncated cell-list family must exist on the host for every
   rung of the halo degrade ladder above the chunked floor.
3. **Memory pre-check** — the job's required bytes (perf-ledger
   measured peak when the program has compiled anywhere in the fleet,
   the sizing-model estimate cold; computed by the caller so the
   policy stays pure) must fit some candidate's advertised HBM budget
   under the same ``ADMIT_HEADROOM`` the workers enforce — an
   over-HBM submit is rejected AT THE ROUTER with the same typed 400
   the worker would have produced, before it bounces off every
   replica.
4. **Compile-cache affinity** — a job whose (job_type, bucket,
   backend) already appears in a candidate's ``compile_counts`` is
   steered to that worker: reusing a built batch program beats any
   load-balancing gain for small jobs (a key's first round loads its
   kernels and pays its admission probe; a small-n slice is
   milliseconds).
5. **Class-latency steering** — fit/watch pick the candidate with the
   best per-class p95 from the fleet metrics view; sweep parents fan
   across workers (least-routed first) so one worker does not absorb
   a whole ensemble's member fan-out.
6. **Least-loaded default** — open breakers for the job's backend,
   queue depth, active slots, then routed-count and worker id as the
   deterministic final tiebreak.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

# The router enforces the same headroom fraction the workers'
# memory-aware admission uses (telemetry/perf.py) — a router pass that
# the worker then rejects would just move the bounce one hop.
from ...telemetry.perf import ADMIT_HEADROOM

__all__ = [
    "ADMIT_HEADROOM",
    "Decision",
    "JobSpec",
    "PlacementError",
    "WorkerView",
    "parse_compile_key",
    "place",
]


class PlacementError(Exception):
    """A typed placement rejection the HTTP layer maps 1:1 to a
    response: ``kind`` is the machine-readable reason (also the
    ``router_rejected`` event's ``reason``), ``code`` the HTTP status,
    ``payload`` extra typed fields (the insufficient-memory rejection
    carries the same ``required_bytes``/``budget_bytes``/``source``
    fields as the worker's own 400)."""

    def __init__(self, kind: str, code: int, message: str,
                 payload: Optional[dict] = None):
        super().__init__(message)
        self.kind = kind
        self.code = code
        self.payload = dict(payload or {})


@dataclass
class WorkerView:
    """One worker as the router sees it: the registry entry's identity
    + capability metadata and the published metrics snapshot
    (``workers/<id>.metrics.json``). Tests build these directly;
    the daemon builds them from the spool."""

    worker_id: str
    host: str = "127.0.0.1"
    port: int = 0
    alive: bool = True
    draining: bool = False
    # Capability/capacity metadata written at serve start (satellite:
    # devices, sharded_capable, backends, hbm_budget_bytes, max_bucket,
    # slots).
    capabilities: dict = field(default_factory=dict)
    # The worker's published metrics snapshot (queue_depth, active,
    # occupancy, compile_counts, breakers, classes).
    metrics: dict = field(default_factory=dict)

    @classmethod
    def from_spool(cls, entry: dict, metrics: Optional[dict],
                   alive: bool = True) -> "WorkerView":
        return cls(
            worker_id=str(entry.get("worker_id") or "?"),
            host=entry.get("host") or "127.0.0.1",
            port=int(entry.get("port") or 0),
            alive=alive,
            draining=bool(entry.get("draining")),
            capabilities=dict(entry.get("capabilities") or {}),
            metrics=dict(metrics or {}),
        )

    # --- evidence accessors (missing metrics read as empty/zero: a
    # worker that has not published yet is a fresh, idle candidate) ---

    @property
    def queue_depth(self) -> int:
        return int(self.metrics.get("queue_depth") or 0)

    @property
    def active(self) -> int:
        return int(self.metrics.get("active") or 0)

    @property
    def occupancy(self) -> float:
        v = self.metrics.get("occupancy")
        return float(v) if v is not None else 0.0

    @property
    def hbm_budget_bytes(self) -> Optional[int]:
        v = self.capabilities.get("hbm_budget_bytes")
        return int(v) if v else None

    @property
    def sharded_capable(self) -> bool:
        return bool(self.capabilities.get("sharded_capable"))

    @property
    def nlist_capable(self) -> bool:
        """Whether this worker can run the truncated cell-list kernel
        family (sharded-nlist jobs). Absent metadata reads as NOT
        capable — a worker registered by a build that predates the
        flag never advertised the kernel, and the router places on
        evidence, not optimism."""
        return bool(self.capabilities.get("nlist_capable"))

    def open_breakers(self) -> set:
        return {
            backend
            for backend, b in (self.metrics.get("breakers") or {}).items()
            if isinstance(b, dict) and b.get("state") == "open"
        }

    def class_p95_s(self, job_type: str) -> Optional[float]:
        row = (self.metrics.get("classes") or {}).get(job_type) or {}
        v = (row.get("latency") or {}).get("p95_s")
        return float(v) if v is not None else None

    def owned_compile_key(self, job: "JobSpec") -> Optional[str]:
        """The ``compile_counts`` key proving this worker already owns
        the job's compiled program, or None. Keys are the scheduler's
        ``job=<t>,bucket=<b>,slots=<s>,backend=<be>`` strings; a job
        with ``backend='auto'`` matches any backend at its (job_type,
        bucket) — autotune resolves per worker, but the program family
        and padded shape are what compile identity hangs on."""
        if job.bucket is None:
            return None
        for key, count in (self.metrics.get("compile_counts") or {}).items():
            if not count:
                continue
            parts = parse_compile_key(key)
            if parts.get("job") != job.job_type:
                continue
            if parts.get("bucket") != str(job.bucket):
                continue
            if job.backend not in ("auto", None) \
                    and parts.get("backend") != job.backend:
                continue
            return key
        return None


def parse_compile_key(key: str) -> dict:
    """``job=t,bucket=b,slots=s,backend=be`` -> dict (tolerant: a
    malformed key parses to whatever fields it has)."""
    out = {}
    for part in key.split(","):
        k, sep, v = part.partition("=")
        if sep:
            out[k.strip()] = v.strip()
    return out


@dataclass
class JobSpec:
    """What the policy needs to know about one submit — distilled by
    the daemon from the request body, or built directly by tests."""

    job_type: str = "integrate"
    n: int = 1
    backend: str = "auto"       # config.force_backend
    resident: bool = True       # False: a parent class (sweep fan-out)
    sharded: bool = False       # sharded-integrate: exclusive residency
    bucket: Optional[int] = None      # padded bucket, for affinity
    required_bytes: Optional[int] = None  # memory evidence (None: skip)
    memory_source: str = "estimated"      # "measured" | "estimated"


@dataclass
class Decision:
    """One placement: the worker, the rule that won, and the evidence
    it weighed — exactly what the ``routed`` event records."""

    worker_id: str
    rule: str
    rationale: dict = field(default_factory=dict)
    excluded: list = field(default_factory=list)  # (worker_id, reason)

    def to_dict(self) -> dict:
        return {
            "worker": self.worker_id,
            "rule": self.rule,
            "rationale": dict(self.rationale),
            "excluded": [list(x) for x in self.excluded],
        }


def _breaker_penalty(w: WorkerView, job: JobSpec) -> int:
    """Open breakers that would bite this job on this worker: the
    job's own backend when it is pinned, ANY open breaker when the
    worker would resolve 'auto' locally (an open breaker there means
    recent strikes — a degraded candidate either way)."""
    open_ = w.open_breakers()
    if job.backend in ("auto", None):
        return len(open_)
    return 1 if job.backend in open_ else 0


def place(
    job: JobSpec,
    workers: Sequence[WorkerView],
    routed_counts: Optional[dict] = None,
) -> Decision:
    """Choose a worker for ``job`` (see module docstring for the rule
    order). ``routed_counts`` is the router's in-memory {worker_id:
    placements so far} — the fan-out/rotation tiebreak; absent counts
    read as zero so the function stays pure and deterministic."""
    routed = dict(routed_counts or {})
    excluded: list = []
    live = []
    for w in workers:
        if not w.alive:
            excluded.append((w.worker_id, "dead"))
        elif w.draining:
            excluded.append((w.worker_id, "draining"))
        else:
            live.append(w)
    if not live:
        raise PlacementError(
            "no_live_workers", 503,
            "no live, undrained worker in the registry",
            {"retry_after_s": 1.0, "excluded": [list(x) for x in excluded]},
        )
    cands = live
    if job.sharded:
        capable = [w for w in cands if w.sharded_capable]
        excluded += [
            (w.worker_id, "not_sharded_capable")
            for w in cands if not w.sharded_capable
        ]
        if not capable:
            raise PlacementError(
                "no_sharded_capable", 400,
                f"no sharded-capable worker for job type "
                f"{job.job_type!r} (n={job.n})",
                {"excluded": [list(x) for x in excluded]},
            )
        cands = capable
        if job.backend == "nlist":
            # Sharded cell-list jobs additionally need the nlist
            # kernel family advertised — the halo exchange degrades
            # through nlist rungs end-to-end, so a worker without the
            # kernel would fail every rung above the chunked floor.
            capable = [w for w in cands if w.nlist_capable]
            excluded += [
                (w.worker_id, "not_nlist_capable")
                for w in cands if not w.nlist_capable
            ]
            if not capable:
                raise PlacementError(
                    "no_nlist_capable", 400,
                    f"no nlist-capable worker for sharded nlist job "
                    f"(n={job.n})",
                    {"excluded": [list(x) for x in excluded]},
                )
            cands = capable
    if job.required_bytes:
        fit = []
        for w in cands:
            budget = w.hbm_budget_bytes
            if budget is not None \
                    and job.required_bytes > budget * ADMIT_HEADROOM:
                excluded.append((w.worker_id, "insufficient_memory"))
            else:
                fit.append(w)
        if not fit:
            best = max(
                (w.hbm_budget_bytes or 0 for w in cands), default=0
            )
            raise PlacementError(
                "insufficient_device_memory", 400,
                f"job does not fit any worker's device memory: needs "
                f"~{job.required_bytes / 1e9:.2f} GB "
                f"({job.memory_source}) vs a best budget of "
                f"{best / 1e9:.2f} GB (x{ADMIT_HEADROOM} admission "
                f"headroom)",
                {
                    "kind": "insufficient_device_memory",
                    "required_bytes": int(job.required_bytes),
                    "budget_bytes": int(best),
                    "source": job.memory_source,
                },
            )
        cands = fit

    def _base(w: WorkerView) -> dict:
        return {
            "queue_depth": w.queue_depth, "active": w.active,
            "routed": routed.get(w.worker_id, 0),
            "memory": (
                {"required_bytes": job.required_bytes,
                 "source": job.memory_source}
                if job.required_bytes else None
            ),
        }

    if job.sharded:
        # Exclusive slice residency: the emptiest capable worker — a
        # sharded job owns the whole mesh for its residency, so the
        # ideal host has nothing queued and nothing resident.
        cands.sort(key=lambda w: (
            w.active + w.queue_depth,
            routed.get(w.worker_id, 0), w.worker_id,
        ))
        w = cands[0]
        return Decision(w.worker_id, "sharded_exclusive", {
            **_base(w),
            "devices": w.capabilities.get("devices"),
        }, excluded)

    if job.resident:
        owners = []
        for w in cands:
            key = w.owned_compile_key(job)
            if key is not None:
                owners.append((w, key))
        if owners:
            owners.sort(key=lambda wk: (
                wk[0].queue_depth, wk[0].active, wk[0].worker_id,
            ))
            w, key = owners[0]
            return Decision(w.worker_id, "compile_affinity", {
                **_base(w), "compile_key": key,
            }, excluded)

    if job.job_type == "sweep" or not job.resident:
        # Fan parents across workers: least-routed first, per-class
        # p95 as the tiebreak — one worker must not absorb every
        # member fan-out while its peers idle.
        def _p95(w):
            v = w.class_p95_s(job.job_type)
            return v if v is not None else 0.0

        cands.sort(key=lambda w: (
            routed.get(w.worker_id, 0), round(_p95(w), 4),
            w.queue_depth, w.worker_id,
        ))
        w = cands[0]
        return Decision(w.worker_id, "sweep_fanout", {
            **_base(w), "p95_s": w.class_p95_s(job.job_type),
        }, excluded)

    if job.job_type in ("fit", "watch"):
        measured = [
            w for w in cands if w.class_p95_s(job.job_type) is not None
        ]
        if measured:
            # Steer by the per-class latency histogram: the candidate
            # completing this class fastest wins; unmeasured workers
            # only win once every measured one is more loaded.
            cands.sort(key=lambda w: (
                round(w.class_p95_s(job.job_type) or 0.0, 4),
                w.queue_depth, routed.get(w.worker_id, 0), w.worker_id,
            ))
            w = cands[0]
            return Decision(w.worker_id, "class_latency", {
                **_base(w), "p95_s": w.class_p95_s(job.job_type),
            }, excluded)

    cands.sort(key=lambda w: (
        _breaker_penalty(w, job), w.queue_depth, w.active,
        routed.get(w.worker_id, 0), w.worker_id,
    ))
    w = cands[0]
    return Decision(w.worker_id, "least_loaded", {
        **_base(w),
        "breakers_open": sorted(w.open_breakers()),
        "occupancy": w.occupancy,
    }, excluded)
