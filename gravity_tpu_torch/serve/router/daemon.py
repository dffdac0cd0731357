"""The pod router daemon — ``gravity_tpu_torch route``.

Counterpart of ``gravity_tpu/serve/router/daemon.py``. A STATELESS
placement tier over N serving workers sharing one spool. The router
speaks the same HTTP/JSON API as a worker, so every existing client verb
works against it unchanged:

- ``/submit`` — place the job with the evidence-driven policy
  (router/policy.py) and proxy it to the chosen worker; emit a
  ``routed`` event carrying the full placement rationale, stitch a
  ``route`` span into the job's trace, and count the decision in the
  router's metrics registry. A typed policy rejection (no live
  workers, no sharded-capable worker, over-HBM) is answered at the
  router with the same shapes the workers use — including the
  ``insufficient_device_memory`` 400 — plus a ``router_rejected``
  event.
- ``/status`` / ``/result`` — answered straight from the shared spool
  (any replica already can; the router needs no worker round-trip).
- ``/cancel`` — a spool cancel marker: the owning worker consumes it
  within a round wherever the job lives (scheduler housekeeping).
- ``/metrics`` — the router's own snapshot (placement counts,
  per-worker routed gauges, decision ring); ``?fleet=1`` proxies to a
  live worker for the fleet aggregation and grafts the router section
  onto it.
- ``/drain`` — proxied to the named worker, taking it out of the
  router's rotation without killing its residents.

The router never touches a device: it imports the serving package for
its host-side pieces (the spool, the sizing model, the registry) and
calls nothing of ``torch.cuda``, so a router process holds no CUDA
context. A worker's memory budget comes from its registry entry
(``hbm_budget_bytes``, the worker's own ``device_memory_budget()``).

Durable state: NONE. The router's only artifacts are the ``router.json``
endpoint advertisement (which ``find_daemon`` prefers while its pid is
alive, so clients route through the pod front door transparently) and
the shared telemetry streams. kill -9 the router and ``find_daemon``
walks straight back to ``daemon.json``/the worker registry — clients
complete direct; restart it and placement resumes from the registry
and published metrics, nothing to recover.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ...config import SimulationConfig
from ...telemetry import TRACES_FILE, Tracer, new_span_id
from ...telemetry.metrics import MetricsRegistry, declare_router_metrics
from ...telemetry.perf import (
    LEDGER_FILE,
    estimate_peak_bytes,
    logical_key,
    read_ledger,
    summarize_rows,
)
from ...utils.hostio import atomic_write_json
from ...utils.logging import ServingEventLogger
from ..engine import MAX_BUCKET, PHYSICS_EXTRA, BatchKey, bucket_size
from ..leases import _local_host, entry_alive, pid_start, read_json_retry
from ..scheduler import Spool

# ROUTER_FILE lives in service.py beside DAEMON_FILE: discovery owns
# the endpoint-file contract; the router advertisement sits beside
# daemon.json in the spool root (NOT under workers/ — the registry
# reaper and the placement scan must never mistake the router for a
# worker).
from ..service import ROUTER_FILE, WORKERS_DIR, DaemonUnreachable
from .policy import Decision, JobSpec, PlacementError, WorkerView, place

# Sizes of the in-memory decision ring `fleet-status` renders. Memory
# only — the durable audit trail is the routed events.
DECISION_RING = 64


def _default_router_id() -> str:
    import uuid

    return f"router-{_local_host()}-{os.getpid()}-{uuid.uuid4().hex[:6]}"


class RouterDaemon:
    """Own the HTTP front door, the placement policy, and the router
    telemetry. Holds zero durable state — see module docstring."""

    def __init__(
        self,
        spool_dir: str,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        router_id: Optional[str] = None,
        # Worker /submit proxy budget: must outwait an admission-time
        # autotune probe, not a socket RTT.
        proxy_timeout_s: float = 300.0,
    ):
        self.spool_dir = spool_dir
        self.host = host
        self.port = port
        self.router_id = router_id or _default_router_id()
        self.proxy_timeout_s = proxy_timeout_s
        os.makedirs(spool_dir, exist_ok=True)
        self.spool = Spool(spool_dir)
        # Same shared serving-events stream the workers append to: the
        # pod's audit trail is ONE file, with the router attributable
        # via the worker context field like any other emitter.
        self.events = ServingEventLogger(
            os.path.join(spool_dir, "serving_events.jsonl"),
            context={"worker": self.router_id},
        )
        # Router spans land in the same traces.jsonl the workers write:
        # the route span stitches into the job's own trace (the trace
        # id is minted at worker admission and persisted in the spool
        # job record).
        self.tracer = Tracer(
            os.path.join(spool_dir, TRACES_FILE), worker=self.router_id,
        )
        self.registry = declare_router_metrics(MetricsRegistry())
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self._server: Optional[ThreadingHTTPServer] = None
        self._threads: list[threading.Thread] = []
        # In-memory placement memory (rotation + the fleet-status
        # view); lost on restart by design.
        self._routed_counts: dict[str, int] = {}
        self._decisions: deque = deque(maxlen=DECISION_RING)
        self._placements = 0
        self._rejections = 0

    # --- discovery ---

    def worker_views(self) -> list[WorkerView]:
        """Every worker-registry entry as a policy view: endpoint +
        capabilities from ``workers/<id>.json``, evidence from the
        published ``workers/<id>.metrics.json`` twin, liveness via the
        same ``entry_alive`` instance-identity the reaper uses."""
        workers_dir = os.path.join(self.spool_dir, WORKERS_DIR)
        try:
            names = sorted(
                n for n in os.listdir(workers_dir)
                if n.endswith(".json") and not n.endswith(".metrics.json")
            )
        except OSError:
            return []
        views = []
        for name in names:
            entry = read_json_retry(os.path.join(workers_dir, name))
            if not isinstance(entry, dict) or "host" not in entry \
                    or "port" not in entry:
                continue
            wid = entry.get("worker_id") or name[:-len(".json")]
            metrics = read_json_retry(
                os.path.join(workers_dir, f"{wid}.metrics.json")
            )
            views.append(WorkerView.from_spool(
                entry, metrics if isinstance(metrics, dict) else None,
                alive=entry_alive(entry),
            ))
        return views

    # --- placement evidence ---

    def _job_spec(self, body: dict,
                  views: list[WorkerView]) -> JobSpec:
        """Distill the submit body into the policy's job descriptor.
        Parse failures degrade to a least-loaded default spec — the
        chosen worker's own validation stays the authority on what is
        servable (the router must never invent a different 400)."""
        job_type = str(body.get("job_type") or "integrate")
        sharded = job_type == "sharded-integrate"
        resident = True
        try:
            from ..jobs import get_class

            resident = bool(getattr(get_class(job_type), "resident", True))
        except Exception:  # noqa: BLE001 — unknown class: worker 400s
            pass
        try:
            config = SimulationConfig.from_json(
                json.dumps(body.get("config") or {})
            )
        except TypeError:
            return JobSpec(job_type=job_type, resident=resident,
                           sharded=sharded)
        bucket = None
        if not sharded and 1 <= config.n <= MAX_BUCKET:
            bucket = bucket_size(config.n)
        required, source = self._memory_evidence(
            job_type, config, views, sharded,
        )
        return JobSpec(
            job_type=job_type, n=config.n,
            backend=config.force_backend, resident=resident,
            sharded=sharded, bucket=bucket,
            required_bytes=required, memory_source=source,
        )

    def _memory_evidence(
        self, job_type: str, config, views: list[WorkerView],
        sharded: bool,
    ) -> tuple[Optional[int], str]:
        """(required_bytes, source) for the router-side memory
        pre-check: the fleet's durable perf ledger
        (``<spool>/perf_ledger.jsonl`` — measured peaks survive worker
        restarts there) when any worker has run this key, else the same
        sizing-model estimate worker admission uses, with the key's
        cell-list sizing. ``(None, ...)`` skips the check — an ``auto``
        backend is resolved per worker at admission, so the router
        cannot name the program and defers to the worker's own memory
        gate. A job past the engine's bucket cap is sized at its own
        padded bucket, so that one too large for every worker's memory
        is refused here as such (the JAX router skips the check there
        and proxies it to a worker's bucket-cap 400)."""
        slots_values = sorted({
            int(v.capabilities.get("slots") or 0)
            for v in views if v.capabilities.get("slots")
        }) or [4]
        if sharded:
            local = config.force_backend
            if local in ("auto", "direct"):
                local = "dense"
            devices = sorted({
                int(v.capabilities.get("devices") or 1) for v in views
            }) or [1]
            rows = self._measured_peaks()
            for d in devices:
                b = -(-config.n // d) * d
                key_str = logical_key(
                    "serve", job=job_type, bucket=b, slots=1,
                    backend=f"sharded/{d}/{local}", dtype=config.dtype,
                    integrator=config.integrator,
                )
                peak = rows.get(key_str)
                if peak:
                    return peak, "measured"
            key = BatchKey(
                bucket_n=config.n, slots=1,
                backend=f"sharded/1/{local}", dtype=config.dtype,
                integrator=config.integrator, g=config.g,
                eps=config.eps, cutoff=0.0, job_type=job_type,
            )
            return estimate_peak_bytes(key), "estimated"
        if config.force_backend in ("auto", "direct") or config.n < 1:
            return None, "estimated"
        bucket = bucket_size(config.n)
        rows = self._measured_peaks()
        for slots in slots_values:
            key_str = logical_key(
                "serve", job=job_type, bucket=bucket, slots=slots,
                backend=config.force_backend, dtype=config.dtype,
                integrator=config.integrator,
            )
            peak = rows.get(key_str)
            if peak:
                return peak, "measured"
        key = BatchKey(
            bucket_n=bucket, slots=max(slots_values),
            backend=config.force_backend, dtype=config.dtype,
            integrator=config.integrator, g=config.g, eps=config.eps,
            cutoff=0.0, job_type=job_type,
            extra=tuple((k, getattr(config, k)) for k in PHYSICS_EXTRA),
        )
        return estimate_peak_bytes(key), "estimated"

    def _measured_peaks(self) -> dict:
        """{ledger key: peak_bytes} from the spool's durable perf
        ledger — every worker appends its compile rows there, so the
        router sees measured evidence fleet-wide."""
        rows = summarize_rows(read_ledger(
            os.path.join(self.spool_dir, LEDGER_FILE)
        ))
        return {
            r.get("key"): int(r["peak_bytes"])
            for r in rows if r.get("peak_bytes")
        }

    # --- request handling (shared by HTTP and tests) ---

    def handle_post(self, path: str, body: dict) -> tuple[int, dict]:
        if path == "/submit":
            return self._handle_submit(body)
        if path == "/cancel":
            job_id = str(body.get("job") or "")
            rec = self.spool.read_job(job_id)
            if rec is None:
                return 409, {"cancelled": False,
                             "error": f"unknown job {job_id!r}"}
            if rec.get("status") in ("completed", "failed", "cancelled"):
                return 409, {"cancelled": False,
                             "status": rec.get("status")}
            # The marker is the fleet-wide cancel path: whichever
            # worker owns (or adopts) the job consumes it within a
            # housekeeping round.
            self.spool.request_cancel(job_id)
            return 200, {"cancelled": True, "via": "spool_marker"}
        if path == "/drain":
            worker = str(body.get("worker") or "")
            drain = bool(body.get("drain", True))
            for view in self.worker_views():
                if view.worker_id == worker and view.alive:
                    try:
                        return self._proxy(
                            view, "POST", "/drain", {"drain": drain},
                        )
                    except DaemonUnreachable as e:
                        return 503, {"error": str(e)}
            return 404, {"error": f"no live worker {worker!r}"}
        if path == "/shutdown":
            self._stop.set()
            return 200, {"stopping": True}
        return 404, {"error": f"unknown path {path!r}"}

    def _handle_submit(self, body: dict) -> tuple[int, dict]:
        t0 = time.time()
        views = self.worker_views()
        with self.lock:
            counts = dict(self._routed_counts)
        job_type = str(body.get("job_type") or "integrate")
        spec = self._job_spec(body, views)
        tried: set = set()
        while True:
            try:
                decision = place(
                    spec,
                    [v for v in views if v.worker_id not in tried],
                    counts,
                )
            except PlacementError as e:
                return self._reject(e, spec, tried)
            target = next(
                v for v in views if v.worker_id == decision.worker_id
            )
            try:
                code, payload = self._proxy(
                    target, "POST", "/submit", body,
                )
            except DaemonUnreachable:
                # The registry said alive but the socket says dead
                # (kill -9 inside the pid-probe window): stop placing
                # onto the corpse and re-place among the survivors.
                tried.add(decision.worker_id)
                continue
            break
        dur = time.time() - t0
        if code == 200 and "job" in payload:
            self._record_placement(
                payload["job"], job_type, decision, t0, dur,
            )
            payload = {**payload, "worker": decision.worker_id,
                       "routed_by": self.router_id}
        return code, payload

    def _record_placement(
        self, job_id: str, job_type: str, decision: Decision,
        t0: float, dur: float,
    ) -> None:
        with self.lock:
            self._placements += 1
            n = self._routed_counts.get(decision.worker_id, 0) + 1
            self._routed_counts[decision.worker_id] = n
            self._decisions.append({
                "ts": round(time.time(), 3), "job": job_id,
                "job_type": job_type, **decision.to_dict(),
            })
        reg = self.registry
        reg.counter(
            "gravity_router_placements_total", rule=decision.rule,
        ).inc()
        reg.gauge(
            "gravity_router_worker_routed", worker=decision.worker_id,
        ).set(n)
        reg.histogram("gravity_router_latency_seconds").observe(dur)
        self.events.event(
            "routed", job=job_id, job_type=job_type,
            target=decision.worker_id, rule=decision.rule,
            rationale=decision.rationale,
            excluded=[list(x) for x in decision.excluded],
        )
        # Stitch the route span into the job's own trace: the worker
        # minted the trace id at admission and persisted it in the
        # spool record, so the router's hop renders in the same
        # Perfetto lane set as the worker's spans.
        rec = self.spool.read_job(job_id)
        trace_id = (rec or {}).get("trace_id")
        if trace_id:
            self.tracer.emit(
                "route", trace_id, t0, dur, span_id=new_span_id(),
                worker=self.router_id, target=decision.worker_id,
                rule=decision.rule,
            )

    def _reject(self, e: PlacementError, spec: JobSpec,
                tried: set) -> tuple[int, dict]:
        with self.lock:
            self._rejections += 1
        self.registry.counter(
            "gravity_router_rejected_total", reason=e.kind,
        ).inc()
        self.events.event(
            "router_rejected", reason=e.kind, job_type=spec.job_type,
            n=spec.n, error=str(e),
            **{k: v for k, v in e.payload.items() if k != "excluded"},
        )
        payload = {"error": str(e), **e.payload}
        if tried:
            payload["unreachable"] = sorted(tried)
        headers_hint = {}
        if e.code == 503:
            headers_hint = {"retry_after_s": e.payload.get(
                "retry_after_s", 1.0,
            )}
        return e.code, {**payload, **headers_hint}

    def handle_get(self, path: str, params: dict) -> tuple[int, dict]:
        if path == "/healthz":
            views = self.worker_views()
            return 200, {
                "ok": True, "router": True,
                "router_id": self.router_id,
                "workers": sorted(
                    v.worker_id for v in views if v.alive
                ),
                "draining": sorted(
                    v.worker_id for v in views if v.alive and v.draining
                ),
                "placements": self._placements,
            }
        if path == "/metrics":
            if params.get("fleet") in ("1", "true", "yes"):
                for view in self.worker_views():
                    if not view.alive:
                        continue
                    try:
                        code, payload = self._proxy(
                            view, "GET", "/metrics?fleet=1", None,
                        )
                    except DaemonUnreachable:
                        continue
                    if code == 200:
                        payload["router"] = self.router_snapshot()
                    return code, payload
                return 503, {"error": "no live worker for fleet view"}
            return 200, self.router_snapshot()
        if path == "/status":
            job_id = params.get("job")
            if job_id is None:
                jobs = []
                for jid in self.spool.job_ids():
                    rec = self.spool.read_job(jid)
                    if rec is not None:
                        jobs.append({
                            k: v for k, v in rec.items()
                            if k != "config"
                        })
                return 200, {"jobs": jobs, "router_id": self.router_id}
            rec = self.spool.read_job(job_id)
            if rec is None:
                return 404, {"error": f"unknown job {job_id!r}"}
            return 200, {k: v for k, v in rec.items() if k != "config"}
        if path == "/result":
            return self._handle_result(params.get("job", ""))
        return 404, {"error": f"unknown path {path!r}"}

    def _handle_result(self, job_id: str) -> tuple[int, dict]:
        """The worker /result contract served spool-direct: any
        replica can serve any durable result, and so can the router —
        same status gating, same non-finite-to-null sanitization."""
        rec = self.spool.read_job(job_id)
        if rec is None:
            return 404, {"error": f"unknown job {job_id!r}"}
        st = {k: v for k, v in rec.items() if k != "config"}
        if st.get("status") != "completed":
            return 409, {
                "error": f"job {job_id!r} is {st.get('status')}", **st,
            }
        payload = dict(st)
        result_path = self.spool.result_path(job_id)
        if os.path.exists(result_path):
            payload["path"] = result_path
        data = self.spool.load_result(job_id)
        if data is not None:
            for k, v in data.items():
                arr = np.asarray(v)
                if np.issubdtype(arr.dtype, np.floating) \
                        and not np.isfinite(arr).all():
                    obj = arr.astype(object)
                    obj[~np.isfinite(arr)] = None
                    payload[k] = obj.tolist()
                else:
                    payload[k] = arr.tolist()
        return 200, payload

    def router_snapshot(self) -> dict:
        """The router /metrics payload: live fleet view + placement
        memory + the instrument registry (fleet-status renders the
        table; tests assert the counters)."""
        views = self.worker_views()
        with self.lock:
            decisions = list(self._decisions)
            counts = dict(self._routed_counts)
            placements = self._placements
            rejections = self._rejections
        return {
            "v": 1,
            "ts": round(time.time(), 3),
            "router": True,
            "router_id": self.router_id,
            "placements": placements,
            "rejections": rejections,
            "routed": counts,
            "workers": {
                v.worker_id: {
                    "alive": v.alive,
                    "draining": v.draining,
                    "queue_depth": v.queue_depth,
                    "active": v.active,
                    "capabilities": v.capabilities,
                    "routed": counts.get(v.worker_id, 0),
                }
                for v in views
            },
            "decisions": decisions,
            "registry": self.registry.snapshot(),
        }

    # --- worker proxy ---

    def _proxy(
        self, view: WorkerView, method: str, path: str,
        body: Optional[dict],
    ) -> tuple[int, dict]:
        """One direct call to a SPECIFIC worker (never through
        find_daemon — the router must not route through itself)."""
        url = f"http://{view.host}:{view.port}{path}"
        data = None
        headers = {}
        if method == "POST":
            data = json.dumps(body or {}).encode()
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(
            url, data=data, headers=headers, method=method,
        )
        try:
            with urllib.request.urlopen(
                req, timeout=self.proxy_timeout_s,
            ) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read())
            except ValueError:
                return e.code, {"error": f"HTTP {e.code}"}
        # HTTPException = worker SIGKILLed mid-response (IncompleteRead
        # / BadStatusLine) — same reroute case as a refused connection.
        except (
            urllib.error.URLError, OSError, http.client.HTTPException,
        ) as e:
            raise DaemonUnreachable(
                f"worker {view.worker_id} at {url} not responding: {e}"
            ) from e

    # --- lifecycle ---

    def start(self) -> tuple[str, int]:
        router = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet by default
                pass

            def _reply(self, code: int, payload: dict,
                       headers: Optional[dict] = None) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    path, _, query = self.path.partition("?")
                    params = dict(
                        kv.split("=", 1)
                        for kv in query.split("&") if "=" in kv
                    )
                    code, payload = router.handle_get(path, params)
                except Exception as e:  # noqa: BLE001 — API boundary
                    code, payload = 500, {"error": str(e)}
                self._reply(code, payload)

            def do_POST(self):
                headers = None
                try:
                    length = int(
                        self.headers.get("Content-Length") or 0
                    )
                    body = (
                        json.loads(self.rfile.read(length) or b"{}")
                        if length else {}
                    )
                    path = self.path.partition("?")[0]
                    code, payload = router.handle_post(path, body)
                    if code == 503 and "retry_after_s" in payload:
                        headers = {
                            "Retry-After":
                                int(payload["retry_after_s"]) or 1
                        }
                except Exception as e:  # noqa: BLE001 — API boundary
                    code, payload = 500, {"error": str(e)}
                self._reply(code, payload, headers)

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.host, self.port = self._server.server_address[:2]
        atomic_write_json(
            os.path.join(self.spool_dir, ROUTER_FILE), {
                "host": self.host, "port": self.port,
                "pid": os.getpid(),
                "pid_start": pid_start(os.getpid()),
                "host_name": _local_host(),
                "router_id": self.router_id,
                "role": "router",
            },
        )
        t = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="gravity-route-http",
        )
        self._threads = [t]
        t.start()
        return self.host, self.port

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        for t in self._threads:
            t.join(timeout=5)
        try:
            # Only remove router.json if it is OURS — a restarted
            # router may have replaced it already.
            path = os.path.join(self.spool_dir, ROUTER_FILE)
            info = read_json_retry(path)
            if info is None or info.get("router_id") in (
                None, self.router_id,
            ):
                os.remove(path)
        except OSError:
            pass

    def serve_blocking(self) -> None:
        """CLI entry: run until SIGINT/SIGTERM."""
        import signal

        def _sig(signum, frame):
            self._stop.set()

        for s in (signal.SIGINT, signal.SIGTERM):
            try:
                signal.signal(s, _sig)
            except ValueError:
                pass
        try:
            while not self._stop.is_set():
                time.sleep(0.2)
        finally:
            self.stop()
