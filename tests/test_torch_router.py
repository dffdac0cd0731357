"""The port's pod router (``gravity_tpu_torch/serve/router/``) on the CPU.

- The placement policy is a pure function: every case of the JAX
  package's policy tests feeds the same worker views and job to
  ``gravity_tpu.serve.router.policy.place`` and to the port's ``place``,
  and the two ``Decision.to_dict()`` results (worker, rule, rationale,
  exclusions) or the two ``PlacementError``s are equal.
- The router daemon end to end over real localhost HTTP: two in-process
  ``GravityDaemon`` workers (``device="cpu"``) and a ``RouterDaemon`` on
  one spool; the router-side memory rejection; the drain workflow; a
  router killed and restarted mid-run; a worker SIGKILLed under load with
  every job completed exactly once.

Every end-to-end test runs under a time limit of its own
(:func:`time_limit`), and every wait in it is bounded.
"""

import contextlib
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from gravity_tpu.serve.router import policy as jax_policy
from gravity_tpu_torch.serve import (
    GravityDaemon,
    RouterDaemon,
    find_daemon,
    request,
    wait_for,
)
from gravity_tpu_torch.serve.router import policy
from gravity_tpu_torch.serve.router.policy import (
    JobSpec,
    PlacementError,
    parse_compile_key,
    place,
)
from gravity_tpu_torch.serve.service import ROUTER_FILE
from gravity_tpu_torch.utils.logging import ServingEventLogger

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def time_limit(seconds: int):
    """Raise TimeoutError in this (the main) thread after ``seconds``."""
    def _expire(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, _expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


# --- the policy against the JAX package's, on the same views ---


def _view_kwargs(wid, *, alive=True, draining=False, queue=0, active=0,
                 compile_counts=None, breakers=None, classes=None, hbm=None,
                 sharded_capable=True, nlist_capable=None, devices=1,
                 slots=4):
    caps = {"devices": devices, "sharded_capable": sharded_capable,
            "hbm_budget_bytes": hbm, "slots": slots}
    if nlist_capable is not None:
        caps["nlist_capable"] = nlist_capable
    return dict(worker_id=wid, alive=alive, draining=draining,
                capabilities=caps,
                metrics={"queue_depth": queue, "active": active,
                         "compile_counts": compile_counts or {},
                         "breakers": breakers or {},
                         "classes": classes or {}})


def _both(spec: dict, views: list, counts=None):
    """The port's Decision (or PlacementError) and the JAX package's on
    the same views and job; raises unless they are equal."""
    out = []
    for mod in (policy, jax_policy):
        ws = [mod.WorkerView(**v) for v in views]
        try:
            out.append(mod.place(mod.JobSpec(**spec), ws, counts))
        except mod.PlacementError as e:
            out.append(e)
    mine, ref = out
    if isinstance(ref, Exception):
        assert isinstance(mine, PlacementError), mine
        assert (mine.kind, mine.code, str(mine), mine.payload) == (
            ref.kind, ref.code, str(ref), ref.payload)
    else:
        assert mine.to_dict() == ref.to_dict()
    return mine


def test_policy_compile_affinity_beats_idleness():
    """A worker that already owns the job's built program wins even
    against an idler peer."""
    owner = _view_kwargs("owner", queue=1, compile_counts={
        "job=integrate,bucket=64,slots=4,backend=dense": 1})
    idle = _view_kwargs("idle")
    d = _both(dict(job_type="integrate", n=50, backend="dense", bucket=64),
              [idle, owner])
    assert (d.worker_id, d.rule) == ("owner", "compile_affinity")
    assert d.rationale["compile_key"] == (
        "job=integrate,bucket=64,slots=4,backend=dense")


def test_policy_affinity_requires_bucket_and_backend_match():
    """Another bucket or another pinned backend is another program: no
    affinity steering."""
    owner = _view_kwargs("owner", queue=3, compile_counts={
        "job=integrate,bucket=128,slots=4,backend=dense": 1})
    idle = _view_kwargs("idle")
    d = _both(dict(job_type="integrate", n=50, backend="dense", bucket=64),
              [owner, idle])
    assert (d.worker_id, d.rule) == ("idle", "least_loaded")
    d = _both(dict(job_type="integrate", n=100, backend="chunked",
                   bucket=128), [owner, idle])
    assert (d.worker_id, d.rule) == ("idle", "least_loaded")


def test_policy_sharded_exclusive_and_capability_filter():
    """sharded-integrate goes only to sharded-capable workers, the
    emptiest first; a sharded nlist job also needs nlist capability."""
    busy = _view_kwargs("busy", active=2, devices=2)
    empty = _view_kwargs("empty", devices=2)
    nocap = _view_kwargs("nocap", sharded_capable=False)
    spec = dict(job_type="sharded-integrate", n=4096, sharded=True)
    d = _both(spec, [busy, nocap, empty])
    assert (d.worker_id, d.rule) == ("empty", "sharded_exclusive")
    assert ["nocap", "not_sharded_capable"] in d.to_dict()["excluded"]
    e = _both(spec, [nocap])
    assert (e.kind, e.code) == ("no_sharded_capable", 400)
    nl = dict(spec, backend="nlist")
    d = _both(nl, [_view_kwargs("a", nlist_capable=False),
                   _view_kwargs("b", nlist_capable=True)])
    assert d.worker_id == "b"
    e = _both(nl, [_view_kwargs("a")])
    assert (e.kind, e.code) == ("no_nlist_capable", 400)


def test_policy_memory_rejection_is_typed():
    """No candidate's budget fits: the typed insufficient_device_memory
    rejection with the worker's 400 fields; a roomy peer takes the job."""
    small = _view_kwargs("small", hbm=1_000_000)
    smaller = _view_kwargs("smaller", hbm=500_000)
    spec = dict(job_type="integrate", n=2048, backend="dense", bucket=2048,
                required_bytes=50_000_000, memory_source="measured")
    e = _both(spec, [small, smaller])
    assert (e.kind, e.code) == ("insufficient_device_memory", 400)
    assert e.payload["required_bytes"] == 50_000_000
    assert e.payload["budget_bytes"] == 1_000_000
    assert e.payload["source"] == "measured"
    d = _both(spec, [small, smaller, _view_kwargs("big", hbm=10**10)])
    assert d.worker_id == "big"
    assert ["small", "insufficient_memory"] in d.to_dict()["excluded"]


def test_policy_drain_and_dead_exclusion():
    """Draining and dead workers never receive placements; an empty
    fleet is a 503-shaped rejection."""
    dead = _view_kwargs("dead", alive=False)
    draining = _view_kwargs("draining", draining=True)
    live = _view_kwargs("live", queue=9)
    d = _both(dict(job_type="integrate", n=10), [dead, draining, live])
    assert d.worker_id == "live"
    assert ["dead", "dead"] in d.to_dict()["excluded"]
    assert ["draining", "draining"] in d.to_dict()["excluded"]
    e = _both(dict(job_type="integrate", n=10), [dead, draining])
    assert (e.kind, e.code) == ("no_live_workers", 503)


def test_policy_class_latency_steering():
    """fit and watch jobs steer to the best measured per-class p95."""
    for job_type in ("fit", "watch"):
        slow = _view_kwargs("slow", classes={
            job_type: {"latency": {"p95_s": 4.0}}})
        quick = _view_kwargs("quick", queue=1, classes={
            job_type: {"latency": {"p95_s": 0.5}}})
        d = _both(dict(job_type=job_type, n=16), [slow, quick])
        assert (d.worker_id, d.rule) == ("quick", "class_latency")
        assert d.rationale["p95_s"] == 0.5


def test_policy_sweep_parents_fan_across_workers():
    """Consecutive sweep parents rotate across workers, least-routed
    first."""
    a, b = _view_kwargs("a"), _view_kwargs("b")
    spec = dict(job_type="sweep", n=16, resident=False)
    counts, seen = {}, []
    for _ in range(4):
        d = _both(spec, [a, b], counts)
        assert d.rule == "sweep_fanout"
        seen.append(d.worker_id)
        counts[d.worker_id] = counts.get(d.worker_id, 0) + 1
    assert seen == ["a", "b", "a", "b"]


def test_policy_breaker_penalty_and_determinism():
    """An open breaker for the pinned backend demotes a worker; the same
    inputs give the same decision."""
    tripped = _view_kwargs("tripped", breakers={"dense": {"state": "open"}})
    ok = _view_kwargs("ok", queue=5)
    spec = dict(job_type="integrate", n=10, backend="dense", bucket=16)
    d1, d2 = _both(spec, [tripped, ok]), _both(spec, [tripped, ok])
    assert d1.to_dict() == d2.to_dict()
    assert (d1.worker_id, d1.rule) == ("ok", "least_loaded")
    auto = _both(dict(spec, backend="auto"), [tripped, ok])
    assert auto.worker_id == "ok"


def test_published_compile_keys_are_the_policys(tmp_path):
    """The compile keys a port worker publishes parse to the (job,
    bucket, backend) the affinity rule matches, and that worker owns a
    job of the same config."""
    d = GravityDaemon(str(tmp_path / "spool"), slots=2, slice_steps=10,
                      idle_sleep_s=0.01, worker_id="w1", device="cpu")
    d.start()
    try:
        with time_limit(60):
            r = request(d.spool_dir, "POST", "/submit",
                        {"config": _cfg(12, steps=10)})
            wait_for(d.spool_dir, [r["job"]], timeout=50)
            snap = d.metrics_snapshot()
    finally:
        d.stop()
    (key, count), = snap["compile_counts"].items()
    assert count == 1
    assert parse_compile_key(key) == {
        "job": "integrate", "bucket": "16", "slots": "2",
        "backend": "dense"}
    view = policy.WorkerView(worker_id="w1", metrics=snap)
    assert view.owned_compile_key(JobSpec(
        job_type="integrate", n=12, backend="dense", bucket=16)) == key
    assert view.owned_compile_key(JobSpec(
        job_type="integrate", n=12, backend="chunked", bucket=16)) is None


# --- the router over live workers ---


def _cfg(n, steps=20, **kw):
    kw.setdefault("model", "random")
    kw.setdefault("dt", 3600.0)
    kw.setdefault("integrator", "leapfrog")
    kw.setdefault("force_backend", "dense")
    return {"n": n, "steps": steps, **kw}


def _events(spool, kind):
    path = os.path.join(spool, "serving_events.jsonl")
    return [e for e in ServingEventLogger(path).read()
            if e["event"] == kind]


def _workers(spool, *ids):
    out = []
    for wid in ids:
        d = GravityDaemon(spool, slots=4, slice_steps=10,
                          idle_sleep_s=0.01, worker_id=wid, device="cpu")
        d.start()
        out.append(d)
    return out


def _wait_metrics_compiles(spool, wid, timeout=30.0):
    """The published workers/<id>.metrics.json once it shows a compile
    count: the router's affinity evidence."""
    path = os.path.join(spool, "workers", f"{wid}.metrics.json")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(path) as f:
                snap = json.load(f)
            if any((snap.get("compile_counts") or {}).values()):
                return snap
        except (OSError, ValueError):
            pass
        time.sleep(0.2)
    raise AssertionError(f"no published compile_counts for {wid}")


def test_router_e2e_three_classes_policy_and_affinity(tmp_path):
    """Three job classes placed across two workers through the router,
    each with a rationale-bearing routed event; a job of the same key
    lands on the worker that built it (``compile_affinity``), checked
    against that worker's own compile counts."""
    spool = str(tmp_path / "spool")
    d1, d2 = _workers(spool, "w1", "w2")
    router = RouterDaemon(spool, router_id="rt")
    router.start()
    try:
        with time_limit(120):
            assert find_daemon(spool) == (router.host, router.port)
            r1 = request(spool, "POST", "/submit", {"config": _cfg(12)})
            assert r1["routed_by"] == "rt"
            first = r1["worker"]
            out = wait_for(spool, [r1["job"]], timeout=60)
            assert out[r1["job"]]["status"] == "completed"
            snap = _wait_metrics_compiles(spool, first)
            assert any("job=integrate" in k and v
                       for k, v in snap["compile_counts"].items())
            r2 = request(spool, "POST", "/submit", {"config": _cfg(12)})
            assert r2["worker"] == first
            by_job = {e["job"]: e for e in _events(spool, "routed")}
            assert by_job[r2["job"]]["rule"] == "compile_affinity"
            key = by_job[r2["job"]]["rationale"]["compile_key"]
            owner = d1 if first == "w1" else d2
            assert owner.metrics_snapshot()["compile_counts"][key] == 1
            r3 = request(spool, "POST", "/submit", {
                "config": _cfg(10), "job_type": "sweep",
                "params": {"members": 3}})
            r4 = request(spool, "POST", "/submit", {
                "config": _cfg(8), "job_type": "watch",
                "params": {"radius": 1e12}})
            out = wait_for(spool, [r2["job"], r3["job"], r4["job"]],
                           timeout=90)
            assert all(v["status"] == "completed" for v in out.values())
            routed = _events(spool, "routed")
            assert {e["job_type"] for e in routed} >= {
                "integrate", "sweep", "watch"}
            for e in routed:
                assert e["rule"] and isinstance(e["rationale"], dict)
                assert e["worker"] == "rt"  # the emitter
                assert e["target"] in ("w1", "w2")
            snap = router.router_snapshot()
            assert snap["placements"] == 4
            fam = snap["registry"]["gravity_router_placements_total"]
            assert sum(row["value"] for row in fam["series"]) == 4
            # The router's answers come from the spool.
            assert request(spool, "GET", f"/status?job={r1['job']}")[
                "status"] == "completed"
            res = request(spool, "GET", f"/result?job={r1['job']}")
            assert len(res["positions"]) == 12
    finally:
        router.stop()
        d1.stop()
        d2.stop()


def test_router_memory_rejection_e2e(tmp_path, monkeypatch):
    """An over-budget submit is refused AT THE ROUTER with the typed 400
    (the worker's own fields) and a router_rejected event; so is a job
    past the engine's bucket cap that no worker's memory holds."""
    monkeypatch.setenv("GRAVITY_TPU_HBM_BYTES", "200000")
    spool = str(tmp_path / "spool")
    d1, = _workers(spool, "w1")
    router = RouterDaemon(spool, router_id="rt")
    router.start()
    try:
        with time_limit(60):
            with open(os.path.join(spool, "workers", "w1.json")) as f:
                entry = json.load(f)
            assert entry["capabilities"]["hbm_budget_bytes"] == 200000
            for n in (2048, 262_144):
                req = urllib.request.Request(
                    f"http://{router.host}:{router.port}/submit",
                    data=json.dumps({"config": _cfg(n)}).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(req, timeout=30)
                assert ei.value.code == 400
                payload = json.loads(ei.value.read())
                assert payload["kind"] == "insufficient_device_memory"
                assert payload["required_bytes"] > payload["budget_bytes"]
                assert payload["source"] == "estimated"
                rej = _events(spool, "router_rejected")
                assert rej[-1]["reason"] == "insufficient_device_memory"
            assert not _events(spool, "submitted")
    finally:
        router.stop()
        d1.stop()


def test_router_drain_workflow(tmp_path, capsys):
    """``drain`` takes a worker out of rotation (placements go elsewhere,
    a drained event, the registry flag); ``--undrain`` restores it; both
    through the router's /drain and through the CLI verb."""
    from gravity_tpu_torch.cli import main

    spool = str(tmp_path / "spool")
    d1, d2 = _workers(spool, "w1", "w2")
    router = RouterDaemon(spool, router_id="rt")
    router.start()

    def registry(wid):
        with open(os.path.join(spool, "workers", f"{wid}.json")) as f:
            return json.load(f)

    try:
        with time_limit(60):
            resp = request(spool, "POST", "/drain",
                           {"worker": "w1", "drain": True})
            assert resp == {"worker_id": "w1", "draining": True}
            assert registry("w1")["draining"] is True
            assert _events(spool, "drained")[-1]["drain"] is True
            jobs = []
            for _ in range(3):
                r = request(spool, "POST", "/submit",
                            {"config": _cfg(8, steps=5)})
                assert r["worker"] == "w2"
                jobs.append(r["job"])
            request(spool, "POST", "/drain", {"worker": "w1",
                                              "drain": False})
            assert registry("w1")["draining"] is False
            assert main(["drain", "--spool-dir", spool, "w2"]) == 0
            assert json.loads(capsys.readouterr().out) == {
                "worker_id": "w2", "draining": True}
            assert registry("w2")["draining"] is True and d2.draining
            r = request(spool, "POST", "/submit",
                        {"config": _cfg(30, steps=5)})
            assert r["worker"] == "w1"
            assert main(["drain", "--spool-dir", spool, "w2",
                         "--undrain"]) == 0
            assert registry("w2")["draining"] is False
            assert main(["drain", "--spool-dir", spool, "nobody"]) == 2
            out = wait_for(spool, jobs + [r["job"]], timeout=40)
            assert all(v["status"] == "completed" for v in out.values())
    finally:
        router.stop()
        d1.stop()
        d2.stop()


def test_router_restart_mid_run_is_transparent(tmp_path):
    """A router killed mid-run: the job in flight finishes, clients go
    straight to the worker (find_daemon passes the dead router.json),
    and a new router places again with nothing recovered."""
    spool = str(tmp_path / "spool")
    d1, = _workers(spool, "w1")
    router = RouterDaemon(spool, router_id="rt1")
    router.start()
    try:
        with time_limit(90):
            r1 = request(spool, "POST", "/submit", {"config": _cfg(10)})
            assert r1["routed_by"] == "rt1"
            # kill -9: the server dropped without the clean stop's
            # router.json removal, the record's pid a dead one.
            router._server.shutdown()
            router._server.server_close()
            path = os.path.join(spool, ROUTER_FILE)
            with open(path) as f:
                rec = json.load(f)
            rec["pid"] = 2 ** 30
            with open(path, "w") as f:
                json.dump(rec, f)
            assert find_daemon(spool) == (d1.host, d1.port)
            out = wait_for(spool, [r1["job"]], timeout=40)
            assert out[r1["job"]]["status"] == "completed"
            router2 = RouterDaemon(spool, router_id="rt2")
            router2.start()
            try:
                assert find_daemon(spool) == (router2.host, router2.port)
                r2 = request(spool, "POST", "/submit",
                             {"config": _cfg(10)})
                assert r2["routed_by"] == "rt2"
                assert router2.router_snapshot()["placements"] == 1
                out = wait_for(spool, [r2["job"]], timeout=40)
                assert out[r2["job"]]["status"] == "completed"
            finally:
                router2.stop()
    finally:
        d1.stop()


def test_router_worker_sigkill_exactly_once(tmp_path):
    """Two ``serve --device cpu`` workers under a router; one is
    SIGKILLed under load. Its jobs are adopted and finish exactly once,
    the router places nothing on the corpse, and every job completes.
    Each wait is bounded and the whole test has 150 s."""
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    env = {"PYTHONPATH": REPO_ROOT, "PATH": os.environ.get("PATH", ""),
           "OMP_NUM_THREADS": "1"}
    procs = {}
    router = None
    try:
        with time_limit(150):
            for wid in ("ka", "kb"):
                procs[wid] = subprocess.Popen(
                    [sys.executable, "-m", "gravity_tpu_torch", "serve",
                     "--device", "cpu", "--spool-dir", spool, "--slots",
                     "2", "--slice-steps", "5", "--lease-ttl-s", "2",
                     "--worker-id", wid],
                    env=env, cwd=REPO_ROOT, stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL)
            deadline = time.monotonic() + 60
            while not all(os.path.exists(os.path.join(
                    spool, "workers", f"{w}.json")) for w in procs):
                assert time.monotonic() < deadline, "workers never started"
                time.sleep(0.2)
            router = RouterDaemon(spool, router_id="rt")
            router.start()
            jobs = []
            for i in range(6):
                r = request(spool, "POST", "/submit", {
                    "config": _cfg(10, steps=40), "job_id": f"kill-{i}"})
                jobs.append(r["job"])
            targets = {e["job"]: e["target"]
                       for e in _events(spool, "routed")}
            victim = targets[jobs[0]]
            procs[victim].kill()
            procs[victim].wait(timeout=10)
            for i in range(6, 9):
                r = request(spool, "POST", "/submit", {
                    "config": _cfg(10, steps=40), "job_id": f"kill-{i}"},
                    retries=3)
                jobs.append(r["job"])
                assert r["worker"] != victim
            out = wait_for(spool, jobs, timeout=100)
            assert all(v["status"] == "completed" for v in out.values())
            per_job = {}
            for e in _events(spool, "completed"):
                if e.get("job") in out:
                    per_job[e["job"]] = per_job.get(e["job"], 0) + 1
            assert per_job == {j: 1 for j in jobs}
    finally:
        if router is not None:
            router.stop()
        for p in procs.values():
            p.kill()
            p.wait(timeout=10)
