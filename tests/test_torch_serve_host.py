"""The serving stack's host parts against the JAX package's on the CPU:
the serving fault kinds (``utils/faults.py``) a single worker fires, the
leases, the circuit breakers and the telemetry (metrics with their
Prometheus text, spans, the flight recorder), each on scripted inputs
fed to both packages' modules.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from gravity_tpu.serve import breaker as jax_breaker
from gravity_tpu.serve import leases as jax_leases
from gravity_tpu.telemetry import metrics as jax_metrics
from gravity_tpu.telemetry import tracing as jax_tracing
from gravity_tpu.utils import faults as jax_faults
from gravity_tpu.utils import hostio as jax_hostio
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.serve import EnsembleScheduler, Spool
from gravity_tpu_torch.serve import breaker as port_breaker
from gravity_tpu_torch.serve import leases as port_leases
from gravity_tpu_torch.telemetry import FlightRecorder
from gravity_tpu_torch.telemetry import metrics as port_metrics
from gravity_tpu_torch.telemetry import tracing as port_tracing
from gravity_tpu_torch.utils import faults as port_faults
from gravity_tpu_torch.utils import hostio as port_hostio
from gravity_tpu_torch.utils.logging import ServingEventLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def both_faults(monkeypatch):
    """Install one spec in both packages' fault modules."""
    def install(spec: str):
        monkeypatch.delenv(port_faults.ENV_KNOB, raising=False)
        port_faults.install(spec)
        jax_faults.install(spec)

    yield install
    port_faults.reset()
    jax_faults.reset()


def _cfg(n=8, steps=20, **kw):
    kw.setdefault("model", "random")
    kw.setdefault("dt", 3600.0)
    kw.setdefault("integrator", "leapfrog")
    kw.setdefault("force_backend", "dense")
    return SimulationConfig(n=n, steps=steps, **kw)


@pytest.mark.parametrize("spec,hook", [
    ("torn_spool_write@2", "torn_write_due"),
    ("drop_result_write@1", "drop_result_due"),
    ("torn_progress_write@3", "torn_progress_due"),
])
def test_ordinal_write_faults_fire_as_jax(both_faults, spec, hook):
    """The write-ordinal faults fire at the same write as the JAX
    package's, once."""
    both_faults(spec)
    got = [getattr(port_faults, hook)() for _ in range(6)]
    want = [getattr(jax_faults, hook)() for _ in range(6)]
    assert got == want and sum(got) == 1


@pytest.mark.parametrize("spec,hook,args", [
    ("stall_worker@3x2", "stall_worker_secs", (1, 3, 4)),
    ("stale_lease@2", "stale_lease_secs", (1, 2, 3)),
    ("stale_lease@2x1", "stale_lease_secs", (1, 2, 3)),
])
def test_payload_faults_fire_as_jax(both_faults, spec, hook, args):
    both_faults(spec)
    got = [getattr(port_faults, hook)(r) for r in args]
    want = [getattr(jax_faults, hook)(r) for r in args]
    assert got == want and any(got)


def test_disk_full_raises_enospc_once(both_faults, tmp_path):
    both_faults("disk_full@1")
    spool = Spool(str(tmp_path / "spool"))
    arrays = {"positions": np.zeros((2, 3), np.float32)}
    assert spool.write_result("a", arrays) is not None
    with pytest.raises(OSError, match="injected disk_full"):
        spool.write_result("b", arrays)
    assert spool.write_result("c", arrays) is not None


def test_torn_and_dropped_spool_writes(both_faults, tmp_path):
    """A torn JSON write lands truncated (a reader retries, then sees
    None), as in the JAX package; a dropped result reports its path and
    writes nothing; a torn progress snapshot fails its checksum and the
    reader falls back."""
    both_faults("torn_spool_write@0,drop_result_write@0,"
                "torn_progress_write@1")
    for hostio, name in ((port_hostio, "port"), (jax_hostio, "jax")):
        path = str(tmp_path / f"{name}.json")
        hostio.atomic_write_json(path, {"a": list(range(50))})
        assert hostio.read_json_retry(path, attempts=2) is None
    spool = Spool(str(tmp_path / "spool"))
    path = spool.write_result("j", {"positions": np.ones((2, 3))})
    assert path is not None and not os.path.exists(path)
    arrays = {"positions": np.ones((4, 3), np.float32)}
    spool.write_progress("p", 10, arrays, {"k": 1})
    spool.write_progress("p", 20, arrays, {"k": 2})  # torn
    snap = spool.load_progress("p")
    assert snap["step"] == 10 and snap["extras"] == {"k": 1}


def test_mesh_faults_stay_refused(both_faults):
    """The mesh faults are ported: each parses and fires in the port as in
    the JAX package (mesh_fail a group build, collective_stall a sharded
    slice; tests/test_torch_serve_sharded.py walks them end to end)."""
    for item in ("mesh_fail@0x2", "collective_stall@1x3"):
        both_faults(item)
        if item.startswith("mesh_fail"):
            fired = [(port_faults.mesh_fail_due(), jax_faults.mesh_fail_due())
                     for _ in range(3)]
            assert fired == [(True, True), (True, True), (False, False)]
        else:
            fired = [(port_faults.collective_stall_secs(r),
                      jax_faults.collective_stall_secs(r))
                     for r in range(3)]
            assert fired == [(0.0, 0.0), (3.0, 3.0), (0.0, 0.0)]


def test_stall_and_stale_lease_fire_in_a_round(both_faults, tmp_path):
    """stall_worker pauses the round with heartbeats suspended;
    stale_lease backdates the worker's leases, so a peer may claim the
    job (expired to the peer's manager)."""
    both_faults("stall_worker@0x1,stale_lease@1x5")
    root = str(tmp_path / "spool")
    with EnsembleScheduler(slots=1, slice_steps=5, spool=Spool(root),
                           device="cpu", worker_id="w1") as sched:
        jid = sched.submit(_cfg(steps=200))
        import time

        t0 = time.monotonic()
        sched.run_round()
        assert time.monotonic() - t0 >= 1.0
        sched.run_round()
        peer = port_leases.LeaseManager(root, "w2", ttl_s=30.0)
        lease = peer.peek(jid)
        assert lease is not None and peer.expired(lease)


def test_crash_worker_is_a_sigkill(tmp_path):
    """crash_worker@1 SIGKILLs the worker at round 1: no cleanup runs,
    its lease stays on disk for a peer to adopt."""
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from gravity_tpu_torch.config import SimulationConfig
        from gravity_tpu_torch.serve import EnsembleScheduler, Spool
        s = EnsembleScheduler(slots=1, slice_steps=5, device="cpu",
                              spool=Spool({str(tmp_path / 'spool')!r}))
        s.submit(SimulationConfig(n=8, steps=100, dt=3600.0,
                                  force_backend="dense"), job_id="j1")
        s.run_round()
        s.run_round()
        print("survived")
    """)
    env = dict(os.environ, GRAVITY_TPU_FAULTS="crash_worker@1",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    assert "survived" not in proc.stdout
    assert os.path.exists(tmp_path / "spool" / "leases" / "j1.json")


def test_accuracy_breach_trips_the_breaker(both_faults, tmp_path):
    """An injected breach at the serving sentinel: one accuracy_breach
    event, the backend's breaker open, admission rerouted down the CPU
    ladder (dense is the floor there)."""
    both_faults("accuracy_breach@0")
    events = ServingEventLogger(str(tmp_path / "e.jsonl"))
    with EnsembleScheduler(slots=2, slice_steps=5, device="cpu",
                           events=events, error_budget=0.01,
                           sentinel_every=1) as sched:
        sched.submit(_cfg(force_backend="pallas", eps=1e9, steps=10))
        sched.run_round()
        kinds = [e["event"] for e in events.read()]
        assert kinds.count("accuracy_breach") == 1
        assert "breaker_open" in kinds
        assert sched.breakers.snapshot()["pallas"]["state"] == "open"
        assert sched.breakers.reroute("pallas") == "chunked"
        # The next probe measures clean: the burn clears, the breaker
        # closes on the round's success (the JAX package's semantics).
        sched.run_until_idle()
        assert "breaker_closed" in [e["event"] for e in events.read()]


def _script_breaker(mod):
    b = mod.CircuitBreaker("pallas", threshold=2, cooldown_s=10.0)
    out = [b.allow(0.0)]
    out += [b.record_failure(1.0), b.state, b.record_failure(2.0), b.state]
    out += [b.allow(5.0), b.allow(12.5), b.state, b.allow(12.6)]
    out += [b.record_failure(13.0), b.state, b.allow(30.0),
            b.record_success(), b.state, b.trip(31.0), b.state]
    return out


def test_breaker_transitions_match_jax():
    assert _script_breaker(port_breaker) == _script_breaker(jax_breaker)


def test_breaker_board_reroute_matches_jax_on_cpu():
    boards = [m.BreakerBoard(threshold=1, cooldown_s=1e9)
              for m in (port_breaker, jax_breaker)]
    got = []
    for board in boards:
        seq = []
        for backend in ("pallas-mxu", "pallas", "chunked", "dense"):
            board.get(backend).record_failure()
            seq.append([board.reroute(b) for b in
                        ("pallas-mxu", "pallas", "chunked", "dense")])
        got.append(seq)
    assert got[0] == got[1]


def test_breaker_board_card_floor():
    """On the card the ladder ends at pallas: an open pallas breaker
    refuses admission with its reason; pallas-mxu still falls to it."""
    board = port_breaker.BreakerBoard(threshold=1, cooldown_s=1e9,
                                      on_card=True)
    board.get("pallas-mxu").record_failure(reason="mxu broke")
    assert board.reroute("pallas-mxu") == "pallas"
    board.get("pallas").trip(reason="kernel launch failed")
    with pytest.raises(port_breaker.BreakerOpen,
                       match="kernel launch failed"):
        board.reroute("pallas-mxu")


def _script_leases(mod, root):
    a = mod.LeaseManager(root, "wa", ttl_s=30.0)
    b = mod.LeaseManager(root, "wb", ttl_s=30.0)
    la = a.claim("j1")
    out = [la.fence, b.claim("j1") is None, a.held_fence("j1")]
    a.backdate()
    lb = b.claim("j1", min_fence=0)
    out += [lb.fence, lb.adopted_from, a.fence_ok("j1", la.fence),
            b.fence_ok("j1", lb.fence)]
    b.release("j1")
    out += [a.claim("j1", min_fence=lb.fence).fence, sorted(a.held_ids())]
    return out


def test_leases_match_jax(tmp_path):
    got = _script_leases(port_leases, str(tmp_path / "port"))
    want = _script_leases(jax_leases, str(tmp_path / "jax"))
    assert got == want


def _script_registry(mod):
    reg = mod.MetricsRegistry()
    mod.declare_worker_metrics(reg)
    reg.counter("gravity_rounds_total").inc()
    reg.counter("gravity_rounds_total").inc(2)
    reg.gauge("gravity_occupancy").set(0.40625)
    h = reg.histogram("gravity_job_latency_seconds", **{"class": "integrate"})
    for v in (0.003, 0.02, 0.5, 7.0):
        h.observe(v)
    reg.histogram("gravity_round_seconds").observe(0.25)
    reg.gauge("gravity_job_energy_drift", job="j1").set(1e-7)
    reg.remove_series("gravity_job_energy_drift", job="j1")
    return reg.snapshot()


def test_prometheus_text_matches_jax():
    port_snap = _script_registry(port_metrics)
    jax_snap = _script_registry(jax_metrics)
    assert port_snap == jax_snap
    text = port_metrics.prometheus_text(port_snap)
    assert text == jax_metrics.prometheus_text(jax_snap)
    assert port_metrics.parse_prometheus_text(text) == \
        jax_metrics.parse_prometheus_text(text)
    merged = port_metrics.merge_snapshots([port_snap, port_snap])
    assert merged == jax_metrics.merge_snapshots([jax_snap, jax_snap])
    assert port_metrics.snapshot_quantile(
        merged, "gravity_job_latency_seconds", 0.5,
        **{"class": "integrate"}) == jax_metrics.snapshot_quantile(
        merged, "gravity_job_latency_seconds", 0.5,
        **{"class": "integrate"})


def test_spans_and_flight_recorder(tmp_path):
    """Spans written by the port's tracer read back as the JAX package's
    loader reads them, with the same coverage; the recorder dumps its
    ring atomically."""
    path = str(tmp_path / "traces.jsonl")
    rec = FlightRecorder(capacity=4, out_dir=str(tmp_path), worker="w")
    tr = port_tracing.Tracer(path, worker="w", recorder=rec)
    tid = port_tracing.new_trace_id()
    root = tr.emit("admission", tid, 100.0, 0.5, job="j")
    tr.emit("queue", tid, 100.5, 1.0, job="j")
    tr.emit("round", tid, 101.5, 2.0, job="j")
    tr.emit("compile", tid, 101.5, 2.0, parent=root)
    spans = jax_tracing.load_spans(path)
    assert [s["name"] for s in spans] == ["admission", "queue", "round",
                                          "compile"]
    assert port_tracing.span_coverage(spans, tid) == \
        jax_tracing.span_coverage(spans, tid)
    assert port_tracing.chrome_trace(spans, tid) == \
        jax_tracing.chrome_trace(spans, tid)
    dump = rec.dump("test")
    with open(dump) as f:
        data = json.load(f)
    assert data["reason"] == "test" and len(data["entries"]) == 4
