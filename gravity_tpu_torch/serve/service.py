"""The serving daemon and its HTTP/JSON client.

Counterpart of ``gravity_tpu/serve/service.py``, with the same endpoints
and answers. The daemon runs on the card unless ``device="cpu"``
(``--device cpu``) is given: without a card it refuses to start. Every
thread that launches holds the daemon's round lock (:class:`RoundLock`,
the engine's guard): the worker thread's rounds and the handler threads'
admission probes (``/submit`` may probe the autotuner on a cache miss)
are serialised under it, on the daemon's device; the engine raises on a
launch from a thread that does not hold it. ``POST /profile {"rounds":
N, "dir": D}`` captures the worker's next N rounds that have work, each
under a ``torch.profiler`` trace (``utils/profiling.trace``) into D
(default ``<spool>/profile``); nothing is paid while the budget is 0.

``gravity_tpu_torch serve`` hosts an :class:`EnsembleScheduler` behind a
localhost HTTP/JSON API (stdlib ``http.server`` — no new dependency);
``gravity_tpu submit/status/result/cancel`` are the client verbs. The
daemon advertises itself by writing ``daemon.json`` (host, port, pid)
into its spool directory, so clients only need ``--spool-dir`` to find
it. Jobs and results persist under the same spool (see
scheduler.Spool), which is what makes a daemon restart resume its
queue; serving metrics stream to ``serving_events.jsonl`` next to the
job files, in the same JSONL event style as the run supervisor's
recovery log.

Endpoints (all JSON):

==========  ======  ================================================
path        method  body / query
==========  ======  ================================================
/healthz    GET     liveness + queue counters
/submit     POST    {"config": {...SimulationConfig...},
                    "job_type": "integrate|fit|sweep|watch",
                    "params": {...class payload...},
                    "priority": int, "deadline_s": float|null}
/status     GET     ?job=<id> (omit for every job)
/result     GET     ?job=<id> -> final state arrays + spool path
/cancel     POST    {"job": <id>}
/metrics    GET     queue depth, latency p50/p95, compile counts,
                    rounds run
/drain      POST    {"drain": bool}: out of (or back into) the pod
                    router's placement rotation; residents run on
/shutdown   POST    graceful stop (drains nothing; jobs respool on
                    the next start)
==========  ======  ================================================

Threading model: one worker thread drives scheduler rounds; HTTP
handler threads only touch the scheduler under the daemon's lock.
Device work happens exclusively on the worker thread.
"""

from __future__ import annotations

import http.client
import json
import os
import random
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..config import SimulationConfig
from ..utils.hostio import atomic_write_json
from ..utils.logging import ServingEventLogger
from .leases import (
    _local_host,
    entry_alive,
    pid_start,
    read_json_retry,
)
from .scheduler import EnsembleScheduler, QueueFull, Spool, default_worker_id

DAEMON_FILE = "daemon.json"
# Per-worker endpoint registry: every worker sharing the spool
# advertises itself under workers/<worker_id>.json so clients can fail
# over to a surviving replica when the daemon.json worker dies
# (docs/serving.md "Multi-worker shared spool").
WORKERS_DIR = "workers"
# The pod router's endpoint advertisement (serve/router/): clients
# prefer a LIVE router over direct worker discovery, so starting
# `gravity_tpu route` upgrades every existing client verb to
# policy-placed submits with zero client changes — and a dead router
# fails them over straight back to the workers (docs/serving.md
# "Pod topology & router").
ROUTER_FILE = "router.json"


def worker_capabilities(*, slots: int) -> dict:
    """Capability/capacity metadata a worker advertises in its
    registry entry at serve start — the router's static placement
    input (devices, sharded capability, admissible backends, HBM
    budget, bucket cap, batch slots), also rendered by `gravity_tpu
    fleet-status`."""
    from ..telemetry.perf import device_memory_budget
    from .engine import ENGINE_BACKENDS, MAX_BUCKET

    return {
        "devices": int(torch.cuda.device_count()),
        # The sharded-integrate class: a worker group a key.
        "sharded_capable": True,
        # Every worker serves the truncated cell-list family.
        "nlist_capable": True,
        "backends": list(ENGINE_BACKENDS),
        "hbm_budget_bytes": device_memory_budget(),
        "max_bucket": MAX_BUCKET,
        "slots": int(slots),
    }


class RoundLock:
    """The daemon's lock, which knows its holder and its waiters. The
    engine's guard (:attr:`~gravity_tpu_torch.serve.engine.EnsembleEngine.
    guard`) asks :meth:`held_by_me` before every launch; the worker calls
    :meth:`yield_to_waiters` between rounds, since a plain lock lets the
    thread that releases it take it straight back, and back-to-back
    rounds would starve the handler threads (a submit waited ~28 s
    behind 3 ms CPU rounds)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._meta = threading.Lock()
        self._owner: Optional[int] = None
        self._waiting = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        with self._meta:
            self._waiting += 1
        try:
            got = self._lock.acquire(blocking, timeout)
        finally:
            with self._meta:
                self._waiting -= 1
        if got:
            self._owner = threading.get_ident()
        return got

    def release(self) -> None:
        self._owner = None
        self._lock.release()

    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident()

    def yield_to_waiters(self, max_s: float = 0.25) -> None:
        """Sleep (lock released) until no thread waits for the lock, at
        most ``max_s``."""
        deadline = time.monotonic() + max_s
        while self._waiting and time.monotonic() < deadline:
            time.sleep(0.0005)

    def __enter__(self) -> "RoundLock":
        self.acquire()
        return self

    def __exit__(self, *exc_info) -> None:
        self.release()


class GravityDaemon:
    """Own the scheduler, the spool, and the HTTP front end."""

    def __init__(
        self,
        spool_dir: str,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        slots: int = 4,
        slice_steps: int = 100,
        yield_rounds: int = 2,
        idle_sleep_s: float = 0.02,
        worker_id: Optional[str] = None,
        lease_ttl_s: float = 30.0,
        max_queue: int = 1024,
        max_requeues: int = 5,
        slo_p99_ms: Optional[float] = None,
        slo_occupancy: Optional[float] = None,
        error_budget: float = 0.0,
        sentinel_every: int = 8,
        sentinel_k: int = 64,
        ledger_every: int = 1,
        progress_every: int = 1,
        device=None,
    ):
        self.spool_dir = spool_dir
        self.host = host
        self.port = port
        self.idle_sleep_s = idle_sleep_s
        self.worker_id = worker_id or default_worker_id()
        os.makedirs(spool_dir, exist_ok=True)
        self.spool = Spool(spool_dir)
        # N workers sharing one spool append to ONE event stream; the
        # worker context field keeps every line attributable.
        self.events = ServingEventLogger(
            os.path.join(spool_dir, "serving_events.jsonl"),
            context={"worker": self.worker_id},
        )
        self.scheduler = EnsembleScheduler(
            slots=slots, slice_steps=slice_steps,
            yield_rounds=yield_rounds, events=self.events,
            spool=self.spool, worker_id=self.worker_id,
            lease_ttl_s=lease_ttl_s, max_queue=max_queue,
            max_requeues=max_requeues,
            slo_p99_ms=slo_p99_ms, slo_occupancy=slo_occupancy,
            error_budget=error_budget, sentinel_every=sentinel_every,
            sentinel_k=sentinel_k, ledger_every=ledger_every,
            progress_every=progress_every, device=device,
        )
        self.device = self.scheduler.engine.device
        self.telemetry = self.scheduler.telemetry
        self.lock = RoundLock()
        self.scheduler.engine.guard = self.lock
        self._stop = threading.Event()
        self._server: Optional[ThreadingHTTPServer] = None
        self._threads: list[threading.Thread] = []
        # Drain state (POST /drain): a draining worker keeps serving its
        # residents and every client verb, but advertises itself out of
        # the pod router's placement rotation through its registry entry.
        self.draining = False
        self._endpoint: Optional[dict] = None
        # The profiler capture budget of POST /profile: rounds left to
        # trace, and where; zero cost while 0.
        self._profile_rounds = 0
        self._profile_dir = os.path.join(spool_dir, "profile")

    # --- lifecycle ---

    def start(self) -> tuple[str, int]:
        """Bind the HTTP server, start the worker + server threads, and
        advertise the endpoint in the spool. Returns (host, port)."""
        daemon = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet by default
                pass

            def _reply(
                self, code: int, payload: dict,
                headers: Optional[dict] = None,
            ) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length") or 0)
                if not length:
                    return {}
                return json.loads(self.rfile.read(length) or b"{}")

            def _reply_text(self, code: int, text: str) -> None:
                body = text.encode()
                self.send_response(code)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8",
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    path, _, query = self.path.partition("?")
                    params = dict(
                        kv.split("=", 1)
                        for kv in query.split("&") if "=" in kv
                    )
                    # Content negotiation on /metrics: Prometheus
                    # scrapers ask for text/plain (or force it with
                    # ?format=prometheus); everything else keeps the
                    # JSON blob.
                    accept = self.headers.get("Accept", "")
                    if path == "/metrics" and (
                        params.get("format") == "prometheus"
                        or "text/plain" in accept
                    ):
                        code, text = daemon.metrics_prometheus(params)
                        self._reply_text(code, text)
                        return
                    code, payload = daemon.handle_get(path, params)
                except Exception as e:  # noqa: BLE001 — API boundary
                    code, payload = 500, {"error": str(e)}
                self._reply(code, payload)

            def do_POST(self):
                headers = None
                try:
                    body = self._body()
                    path = self.path.partition("?")[0]
                    code, payload = daemon.handle_post(path, body)
                    if code == 503 and "retry_after_s" in payload:
                        # Load shed: the standard backpressure header,
                        # so generic HTTP clients back off correctly.
                        headers = {
                            "Retry-After":
                                int(payload["retry_after_s"]) or 1
                        }
                except Exception as e:  # noqa: BLE001 — API boundary
                    code, payload = 500, {"error": str(e)}
                self._reply(code, payload, headers)

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.host, self.port = self._server.server_address[:2]
        endpoint = {
            "host": self.host, "port": self.port, "pid": os.getpid(),
            # Process-instance identity: clients verify (pid, start
            # time) so a recycled pid can't make this entry look alive
            # after a SIGKILL (registry files are only removed by a
            # CLEAN stop).
            "pid_start": pid_start(os.getpid()),
            # host = the BIND address; host_name = the machine, so
            # clients on other hosts know the pid probe does not apply.
            "host_name": _local_host(),
            "worker_id": self.worker_id,
            # The router's static placement input + drain state
            # (docs/serving.md "Pod topology & router").
            "capabilities": worker_capabilities(
                slots=self.scheduler.slots
            ),
            "draining": self.draining,
        }
        # daemon.json stays the primary discovery file (last worker to
        # start wins); the per-worker registry is the failover list
        # clients walk when its pid is dead (find_daemon).
        atomic_write_json(
            os.path.join(self.spool_dir, DAEMON_FILE), endpoint
        )
        workers_dir = os.path.join(self.spool_dir, WORKERS_DIR)
        os.makedirs(workers_dir, exist_ok=True)
        atomic_write_json(
            os.path.join(workers_dir, f"{self.worker_id}.json"), endpoint
        )
        self._endpoint = endpoint
        self.scheduler.start_lease_heartbeat()
        t_http = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="gravity-serve-http",
        )
        t_work = threading.Thread(
            target=self._worker, daemon=True, name="gravity-serve-worker"
        )
        self._threads = [t_http, t_work]
        for t in self._threads:
            t.start()
        return self.host, self.port

    def _worker(self) -> None:
        """The ONLY thread that touches the device: scheduler rounds
        while there is work, short sleeps while idle. A round that
        throws must not kill the thread — the daemon would then report
        healthy while every job hangs forever (review finding); log the
        error and keep serving (per-job failures are already absorbed
        inside the scheduler; this is the backstop)."""
        import traceback

        if self.device.type == "cuda":
            # The current device is per thread: this one launches on the
            # daemon's.
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            try:
                with self.lock:
                    # Housekeeping runs even while idle: an idle
                    # replica is exactly the one that must notice a
                    # dead peer's expired leases and adopt its jobs.
                    self.scheduler.housekeeping()
                    if not self.scheduler.has_work():
                        worked = False
                    elif self._profile_rounds > 0:
                        # POST /profile: exactly the asked rounds under
                        # a trace; the capture ends with its round, also
                        # when the round raises.
                        from ..utils.profiling import trace

                        self._profile_rounds -= 1
                        with trace(self._profile_dir):
                            worked = (
                                self.scheduler.run_round() is not None
                            )
                    else:
                        worked = (
                            self.scheduler.run_round() is not None
                        )
            except Exception:  # noqa: BLE001 — keep the daemon alive
                traceback.print_exc()
                worked = False
                # Back off: a persistent error must not hot-spin.
                self._stop.wait(max(self.idle_sleep_s, 0.5))
            # Handlers waiting on the lock go before the next round.
            self.lock.yield_to_waiters()
            if not worked:
                self._stop.wait(self.idle_sleep_s)

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        for t in self._threads:
            t.join(timeout=5)
        try:
            # Hard barrier on the background spool writer: queued result
            # writes must finish before the daemon exits (a restarted
            # daemon respools jobs whose results never hit disk). Write
            # failures were already absorbed per job (spool_error
            # events); this guard only covers writer-infrastructure
            # errors during shutdown.
            self.scheduler.drain_io()
        except Exception:  # noqa: BLE001 — shutdown is best-effort
            pass
        self.scheduler.close_io()
        try:
            os.remove(os.path.join(
                self.spool_dir, WORKERS_DIR, f"{self.worker_id}.json"
            ))
        except OSError:
            pass
        try:
            # Only remove daemon.json if it is OURS: with peers sharing
            # the spool, deleting a survivor's endpoint file would cut
            # clients off from a perfectly healthy worker.
            path = os.path.join(self.spool_dir, DAEMON_FILE)
            info = read_json_retry(path)
            if info is None or info.get("worker_id") in (
                None, self.worker_id
            ):
                os.remove(path)
        except OSError:
            pass

    def serve_blocking(self) -> None:
        """CLI entry: run until SIGINT/SIGTERM."""
        import signal

        def _sig(signum, frame):
            if signum == signal.SIGTERM:
                # Flight recorder on the way out: SIGTERM is the
                # preemption path chaos postmortems reconstruct.
                try:
                    self.scheduler._dump_flightrec("sigterm")
                except Exception:  # noqa: BLE001 — never block the stop
                    pass
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

    def _on_device(self):
        """The daemon's CUDA device as this thread's current one (a
        handler thread's admission probe launches there); a no-op on the
        CPU."""
        import contextlib

        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # --- request handling (shared by HTTP and tests) ---

    def metrics_snapshot(self, timeout: float = 0.25) -> dict:
        """The /metrics payload, WITHOUT queueing behind a round: try
        the daemon lock briefly for a fresh snapshot; fall back to the
        scheduler's last published one when the worker is deep in a
        long compile (satellite contract: a scrape always returns
        within ~the timeout, stale by at most a round)."""
        acquired = self.lock.acquire(timeout=timeout)
        if acquired:
            try:
                snap = self.scheduler.metrics_snapshot()
            finally:
                self.lock.release()
            stale = False
        else:
            snap = self.scheduler.last_metrics or {
                "v": 1, "worker_id": self.worker_id,
                "queue_depth": self.scheduler.queue_depth,
                "active": self.scheduler.active_count,
                "rounds": self.scheduler.rounds_run,
            }
            stale = True
        return {**snap, "stale": stale, "events_path": self.events.path}

    def fleet_metrics(self, timeout: float = 0.25) -> dict:
        """`/metrics?fleet=1`: every live worker's published snapshot
        (workers/<id>.metrics.json beside the endpoint registry),
        aggregated — summed counters/queue depths, bucket-merged
        latency histograms for honest fleet-wide per-class p50/p95/p99,
        breaker union, and the SLO burn state
        (docs/observability.md "Fleet view")."""
        from ..telemetry import (
            merge_snapshots,
            snapshot_quantile,
        )

        mine = self.metrics_snapshot(timeout=timeout)
        snaps = {self.worker_id: mine}
        workers_dir = os.path.join(self.spool_dir, WORKERS_DIR)
        for info in _live_workers(self.spool_dir):
            wid = info.get("worker_id")
            if not wid or wid in snaps:
                continue
            rec = read_json_retry(
                os.path.join(workers_dir, f"{wid}.metrics.json")
            )
            if isinstance(rec, dict):
                snaps[wid] = rec
        merged = merge_snapshots(
            [s.get("registry") or {} for s in snaps.values()]
        )
        classes: dict = {}
        for s in snaps.values():
            for cls, row in (s.get("classes") or {}).items():
                agg = classes.setdefault(cls, {
                    "queue_depth": 0, "active": 0, "completed": 0,
                    "failed": 0, "cancelled": 0,
                })
                for k in ("queue_depth", "active", "completed",
                          "failed", "cancelled"):
                    agg[k] += row.get(k) or 0
        for cls, agg in classes.items():
            agg["latency"] = {
                f"p{int(q * 100)}_s": snapshot_quantile(
                    merged, "gravity_job_latency_seconds", q,
                    **{"class": cls},
                )
                for q in (0.5, 0.95, 0.99)
            }
        breakers: dict = {}
        for s in snaps.values():
            for backend, b in (s.get("breakers") or {}).items():
                cur = breakers.get(backend)
                if cur is None or b.get("state") == "open":
                    breakers[backend] = b
        occs = [
            s.get("occupancy") for s in snaps.values()
            if s.get("occupancy") is not None
        ]
        burn = {"p99": False, "occupancy": False}
        breaches = 0
        for s in snaps.values():
            slo = s.get("slo") or {}
            for k, v in (slo.get("burn") or {}).items():
                burn[k] = burn.get(k, False) or bool(v)
        fam = merged.get("gravity_slo_breaches_total") or {}
        for row in fam.get("series", []):
            breaches += row.get("value", 0)
        return {
            "fleet": True,
            "workers": sorted(snaps),
            "worker_snapshots": {
                wid: {
                    k: s.get(k)
                    for k in ("queue_depth", "active", "rounds",
                              "occupancy", "ts", "stale")
                }
                for wid, s in snaps.items()
            },
            "queue_depth": sum(
                s.get("queue_depth") or 0 for s in snaps.values()
            ),
            "active": sum(
                s.get("active") or 0 for s in snaps.values()
            ),
            "rounds": sum(
                s.get("rounds") or 0 for s in snaps.values()
            ),
            "occupancy": (
                sum(occs) / len(occs) if occs else None
            ),
            "classes": classes,
            "breakers": breakers,
            "slo": {
                "p99_ms": self.scheduler.slo_p99_ms,
                "occupancy": self.scheduler.slo_occupancy,
                "burn": burn,
                "breaches_total": breaches,
            },
            "registry": merged,
        }

    def metrics_prometheus(self, params: dict) -> tuple[int, str]:
        """Prometheus text exposition (Accept: text/plain, or
        ?format=prometheus) — single worker or ?fleet=1 merged."""
        from ..telemetry import prometheus_text

        if params.get("fleet") in ("1", "true", "yes"):
            snap = self.fleet_metrics()
        else:
            snap = self.metrics_snapshot()
        return 200, prometheus_text(snap.get("registry") or {})

    def handle_get(self, path: str, params: dict) -> tuple[int, dict]:
        if path == "/healthz":
            # Deliberately lock-free: the worker holds the lock through
            # whole rounds (minutes on a first compile), and a liveness
            # probe that blocks exactly then would misreport a healthy
            # daemon as dead (review finding). The counters are plain
            # attribute reads — racy by a round at worst.
            return 200, {
                "ok": True,
                "worker_id": self.worker_id,
                "queue_depth": self.scheduler.queue_depth,
                "active": self.scheduler.active_count,
                "rounds": self.scheduler.rounds_run,
                "draining": self.draining,
            }
        if path == "/metrics":
            # Served from a snapshot taken OUTSIDE the round lock: a
            # long first compile must not stall scrapes.
            if params.get("fleet") in ("1", "true", "yes"):
                return 200, self.fleet_metrics()
            return 200, self.metrics_snapshot()
        if path == "/flightrec":
            # On-demand flight-recorder dump (ring has its own lock —
            # no round-lock contention here either).
            recorder = self.telemetry.recorder
            dump_path = None
            if params.get("dump", "1") not in ("0", "false", "no"):
                dump_path = self.scheduler._dump_flightrec("request")
            return 200, {
                "worker_id": self.worker_id,
                "entries": len(recorder),
                "dumps": recorder.dumps,
                "path": dump_path,
            }
        with self.lock:
            if path == "/status":
                job_id = params.get("job")
                if job_id is None:
                    return 200, {
                        "jobs": [
                            j.to_dict()
                            for j in self.scheduler.jobs.values()
                        ]
                    }
                st = self._status_any(job_id)
                if st is None:
                    return 404, {"error": f"unknown job {job_id!r}"}
                return 200, st
            if path == "/result":
                job_id = params.get("job", "")
                st = self._status_any(job_id)
                if st is None:
                    return 404, {"error": f"unknown job {job_id!r}"}
                if st["status"] != "completed":
                    return 409, {
                        "error": f"job {job_id!r} is {st['status']}",
                        **st,
                    }
                data = self.scheduler.result_data(job_id)
                if data is None:
                    # Spool fallback: any replica can serve any durable
                    # result, including a dead peer's — the reaper may
                    # not have registered the job locally yet.
                    data = self.spool.load_result(job_id)
                payload = dict(st)
                # The .npz rides the background writer, so "completed"
                # no longer implies bytes on disk: advertise the path
                # only once it exists (the inline arrays below serve
                # the in-flight window; after a spool_error the path
                # would never exist at all).
                result_path = self.spool.result_path(job_id)
                if os.path.exists(result_path):
                    payload["path"] = result_path
                if data is not None:
                    # The class's full result schema, arrays as lists:
                    # integrate/watch ship the final state, fit adds
                    # the fitted parameters + loss, sweeps their
                    # per-member verdict arrays. Non-finite entries
                    # (a failed member's NaN verdict, an inf min_sep
                    # from a single-body member) become null: bare
                    # NaN/Infinity tokens are json.dumps-legal but
                    # rejected by strict parsers (jq, JS JSON.parse),
                    # and this API is open to non-Python clients. The
                    # spool .npz keeps the exact values.
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
        return 404, {"error": f"unknown path {path!r}"}

    def _status_any(self, job_id: str) -> Optional[dict]:
        """Status from the scheduler, falling back to the shared spool
        record — any replica answers for any job in the spool, owned or
        not (the client may have failed over from a dead worker whose
        jobs we have not adopted yet)."""
        st = self.scheduler.status(job_id)
        if st is not None:
            return st
        rec = self.spool.read_job(job_id)
        if rec is None:
            return None
        return {k: v for k, v in rec.items() if k != "config"}

    def handle_post(self, path: str, body: dict) -> tuple[int, dict]:
        if path == "/submit":
            try:
                config = SimulationConfig.from_json(
                    json.dumps(body.get("config") or {})
                )
            except TypeError as e:
                return 400, {"error": f"bad config: {e}"}
            params = body.get("params")
            if params is not None and not isinstance(params, dict):
                return 400, {"error": "params must be an object"}
            with self.lock, self._on_device():
                try:
                    job_id = self.scheduler.submit(
                        config,
                        priority=int(body.get("priority") or 0),
                        deadline_s=body.get("deadline_s"),
                        job_id=body.get("job_id"),
                        job_type=str(
                            body.get("job_type") or "integrate"
                        ),
                        params=params,
                    )
                except QueueFull as e:
                    # Bounded-queue load shed: 503 + Retry-After (set
                    # as a header by the HTTP layer) — the client backs
                    # off instead of the daemon buffering unboundedly.
                    return 503, {
                        "error": str(e),
                        "retry_after_s": e.retry_after_s,
                        "queue_depth": e.depth,
                    }
                except (ValueError, TypeError) as e:
                    # TypeError too: dataclasses don't type-check, so a
                    # wrong-typed field (n="10") surfaces inside
                    # batch_key_for — still client input, still 400.
                    payload = {"error": str(e)}
                    from ..telemetry import InsufficientDeviceMemory

                    if isinstance(e, InsufficientDeviceMemory):
                        # Memory-aware admission (docs/observability
                        # .md "Performance"): typed fields so a router
                        # can place the job elsewhere instead of
                        # string-matching the message.
                        payload.update(
                            kind="insufficient_device_memory",
                            required_bytes=e.required_bytes,
                            budget_bytes=e.budget_bytes,
                            source=e.source,
                        )
                    return 400, payload
            return 200, {"job": job_id}
        if path == "/cancel":
            with self.lock:
                ok = self.scheduler.cancel(str(body.get("job")))
            return (200 if ok else 409), {"cancelled": ok}
        if path == "/profile":
            # Capture the next N rounds under torch.profiler (JAX
            # service.py:714-731).
            try:
                rounds = int(body.get("rounds", 1))
            except (TypeError, ValueError):
                return 400, {"error": "rounds must be an integer"}
            if rounds < 0:
                return 400, {"error": "rounds must be >= 0"}
            out_dir = body.get("dir")
            if out_dir:
                self._profile_dir = str(out_dir)
            self._profile_rounds = rounds
            return 200, {"profiling_rounds": rounds,
                         "dir": self._profile_dir}
        if path == "/drain":
            # Take this worker out of (or back into) the router's
            # placement rotation WITHOUT touching its residents: flip the
            # flag in the registry entry the router reads. Direct clients
            # are unaffected: drain is a placement signal, not an
            # admission gate.
            drain = bool(body.get("drain", True))
            changed = drain != self.draining
            self.draining = drain
            if self._endpoint:
                self._endpoint = {**self._endpoint, "draining": drain}
                try:
                    atomic_write_json(os.path.join(
                        self.spool_dir, WORKERS_DIR,
                        f"{self.worker_id}.json"), self._endpoint)
                except OSError as e:
                    return 500, {"error": f"registry write failed: {e}"}
            if changed:
                self.events.event("drained", drain=drain)
            return 200, {"worker_id": self.worker_id, "draining": drain}
        if path == "/shutdown":
            self._stop.set()
            return 200, {"stopping": True}
        return 404, {"error": f"unknown path {path!r}"}


# --- client side ---


class DaemonUnreachable(RuntimeError):
    pass


# The one registry-liveness rule, shared with the scheduler's
# worker-registry reaper (serve/leases.py).
_entry_alive = entry_alive


def _live_workers(spool_dir: str) -> list[dict]:
    """Worker-registry entries whose pid is still alive, newest file
    first — the client-side failover list."""
    workers_dir = os.path.join(spool_dir, WORKERS_DIR)

    def _mtime(name: str) -> float:
        # Per-entry tolerant: a worker removing its own file mid-listing
        # (clean stop) must not abort failover to the SURVIVORS.
        try:
            return os.path.getmtime(os.path.join(workers_dir, name))
        except OSError:
            return 0.0

    try:
        names = sorted(
            (n for n in os.listdir(workers_dir) if n.endswith(".json")),
            key=_mtime,
            reverse=True,
        )
    except OSError:
        return []
    out = []
    for name in names:
        info = read_json_retry(os.path.join(workers_dir, name))
        if isinstance(info, dict) and "host" in info and "port" in info \
                and _entry_alive(info):
            out.append(info)
    return out


def find_daemon(spool_dir: str) -> tuple[str, int]:
    """The endpoint to talk to: a LIVE pod router first (``router.json``
    — the placement front door speaks the same API, so clients route
    through it transparently), then ``daemon.json`` while its pid is
    alive, else any live worker from the registry (failover to a
    surviving replica). A dead router/daemon endpoint file is deleted
    on sight — kill -9 the router and the NEXT client call lands
    direct on a worker; a stale endpoint file must produce a clear
    'daemon not running' error (CLI exit 2), never a hang against a
    port nobody owns."""
    router_path = os.path.join(spool_dir, ROUTER_FILE)
    info = read_json_retry(router_path)
    if isinstance(info, dict) and "host" in info and "port" in info:
        if _entry_alive(info):
            return info["host"], int(info["port"])
        try:
            # Same TOCTOU care as daemon.json below: only reap the
            # exact record we probed dead.
            if read_json_retry(router_path) == info:
                os.remove(router_path)
        except OSError:
            pass
    path = os.path.join(spool_dir, DAEMON_FILE)
    info = read_json_retry(path)
    if isinstance(info, dict) and "host" in info and "port" in info:
        if _entry_alive(info):
            return info["host"], int(info["port"])
        try:
            # Re-read before reaping: a fresh daemon may have replaced
            # the file between our read and now — deleting ITS
            # endpoint would cut primary discovery for a healthy
            # worker (TOCTOU; the registry walk would still recover).
            if read_json_retry(path) == info:
                os.remove(path)  # stale: its worker is gone
        except OSError:
            pass
    for worker in _live_workers(spool_dir):
        return worker["host"], int(worker["port"])
    raise DaemonUnreachable(
        f"daemon not running: no live worker advertised under "
        f"{spool_dir!r}; start one with "
        "`python -m gravity_tpu_torch serve --spool-dir " + spool_dir
        + "`"
    )


def backoff_delay(
    attempt: int, base_s: float = 0.25, cap_s: float = 8.0,
    retry_after_s: Optional[float] = None,
) -> float:
    """Exponential backoff with full jitter (attempt counts from 0).
    A server-provided ``Retry-After`` hint floors the delay — backing
    off LESS than the server asked for just re-sheds the request."""
    delay = min(base_s * 2**attempt, cap_s)
    delay *= 0.5 + random.random() * 0.5  # jitter: de-sync the herd
    if retry_after_s is not None:
        delay = max(delay, float(retry_after_s))
    return delay


def request(
    spool_dir: str,
    method: str,
    path: str,
    payload: Optional[dict] = None,
    *,
    # The worker holds the daemon lock for a whole scheduling round —
    # a first compile can take minutes — and handlers queue behind it,
    # so the client must outwait a round, not a socket RTT (review
    # finding; wait_for additionally retries on transient timeouts).
    timeout: float = 300.0,
    # Transparent retry with jittered exponential backoff: covers an
    # unreachable/restarting daemon (the re-entrant find_daemon fails
    # over to a surviving worker between attempts) and 503 load sheds
    # (honoring their retry_after_s hint). 0 = one shot.
    retries: int = 0,
) -> dict:
    """One client call against the daemon advertised in ``spool_dir``."""
    attempt = 0
    while True:
        try:
            return _request_once(
                spool_dir, method, path, payload, timeout=timeout
            )
        except DaemonUnreachable:
            if attempt >= retries:
                raise
            time.sleep(backoff_delay(attempt))
        except _Shed as e:
            if attempt >= retries:
                return e.payload
            time.sleep(backoff_delay(
                attempt, retry_after_s=e.payload.get("retry_after_s")
            ))
        attempt += 1


class _Shed(Exception):
    """Internal: a 503 load-shed reply (payload carries the hint)."""

    def __init__(self, payload: dict):
        self.payload = payload


def _request_once(
    spool_dir: str,
    method: str,
    path: str,
    payload: Optional[dict] = None,
    *,
    timeout: float = 300.0,
) -> dict:
    host, port = find_daemon(spool_dir)
    url = f"http://{host}:{port}{path}"
    data = None
    headers = {}
    if method == "POST":
        data = json.dumps(payload or {}).encode()
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(
        url, data=data, headers=headers, method=method
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read())
        except ValueError:
            body = {"error": f"HTTP {e.code}"}
        if e.code == 503:
            raise _Shed(body) from e
        return body
    # HTTPException covers a daemon SIGKILLed MID-RESPONSE
    # (IncompleteRead / BadStatusLine): the body will never arrive, so
    # it is the same failover case as a refused connection.
    except (
        urllib.error.URLError, OSError, http.client.HTTPException,
    ) as e:
        raise DaemonUnreachable(
            f"daemon at {url} not responding: {e}"
        ) from e


def wait_for(
    spool_dir: str, job_ids: list[str], *, timeout: float = 300.0,
    poll_s: float = 0.1,
) -> dict[str, dict]:
    """Poll until every job is terminal; returns {job_id: status}."""
    deadline = time.monotonic() + timeout
    out: dict[str, dict] = {}
    remaining = list(job_ids)
    while remaining:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"jobs still unfinished after {timeout}s: {remaining}"
            )
        for job_id in list(remaining):
            try:
                st = request(
                    spool_dir, "GET", f"/status?job={job_id}",
                    timeout=min(60.0, timeout),
                )
            except DaemonUnreachable:
                # A poll that lands while the worker holds the lock
                # through a long compile is not a dead daemon — keep
                # polling until OUR deadline decides.
                break
            if st.get("status") in ("completed", "failed", "cancelled"):
                out[job_id] = st
                remaining.remove(job_id)
        if remaining:
            time.sleep(poll_s)
    return out
