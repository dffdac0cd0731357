"""The port's scheduler (``gravity_tpu_torch/serve/scheduler.py``) on the
CPU: ``tests/test_serve_scheduler.py``'s policy contracts on the port
(buckets, occupancy, priorities, preemption, the starvation bound,
evict/resume parity, deadlines, cancellation, spool respool), plus the
bounded queue (``QueueFull``), the memory-aware admission through
``GRAVITY_TPU_HBM_BYTES``, and the card's breaker floor: a round that
raises fails its jobs with the error and trips the breaker, and a
kernel's job is never rerouted to a plain form. Results are held to the
port's solo ``Simulator`` runs (1e-5).
"""

import numpy as np
import pytest

from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.serve import (
    EnsembleScheduler,
    JobValidationError,
    QueueFull,
    Spool,
    batch_key_for,
)
from gravity_tpu_torch.serve.breaker import BreakerOpen
from gravity_tpu_torch.simulation import Simulator
from gravity_tpu_torch.telemetry import InsufficientDeviceMemory
from gravity_tpu_torch.telemetry import perf as perf_mod
from gravity_tpu_torch.utils.logging import ServingEventLogger


def _cfg(n, steps=20, **kw):
    kw.setdefault("model", "random")
    kw.setdefault("dt", 3600.0)
    kw.setdefault("integrator", "leapfrog")
    kw.setdefault("force_backend", "dense")
    return SimulationConfig(n=n, steps=steps, **kw)


def _sched(**kw):
    return EnsembleScheduler(device="cpu", **kw)


def _solo(config):
    return Simulator(config, device="cpu").run()["final_state"] \
        .positions.numpy()


def _max_rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def test_mixed_buckets_dts_lengths_match_solo():
    configs = [
        _cfg(9, steps=37, seed=1, dt=1800.0),
        _cfg(16, steps=12, seed=2, model="plummer", eps=1e9,
             force_backend="pallas"),
        _cfg(30, steps=25, seed=3, dt=7200.0, integrator="verlet"),
        _cfg(33, steps=41, seed=4, force_backend="chunked"),
        _cfg(70, steps=19, seed=5, integrator="yoshida4"),
    ]
    with _sched(slots=2, slice_steps=8) as sched:
        ids = [sched.submit(c) for c in configs]
        sched.run_until_idle()
        for jid, c in zip(ids, configs):
            st = sched.status(jid)
            assert st["status"] == "completed" and st["steps_done"] == c.steps
            assert _max_rel(sched.result(jid).positions.numpy(),
                            _solo(c)) <= 1e-5
        assert all(v == 1 for v in sched.engine.compile_counts.values())


def test_bucket_assignment_groups_jobs():
    with _sched(slots=4, slice_steps=10) as sched:
        a, b, c = (sched.submit(_cfg(n)) for n in (9, 16, 17))
        keys = [batch_key_for(sched.jobs[j].config, slots=4, device="cpu")
                for j in (a, b, c)]
        assert keys[0] == keys[1] and keys[0].bucket_n == 16
        assert keys[2].bucket_n == 32
        sched.run_until_idle()
        assert len(sched.engine.compile_counts) == 2


def test_round_metrics_occupancy_accounting(tmp_path):
    events = ServingEventLogger(str(tmp_path / "events.jsonl"))
    with _sched(slots=4, slice_steps=50, events=events) as sched:
        sched.submit(_cfg(10, steps=5))
        sched.submit(_cfg(16, steps=5))
        metrics = sched.run_round()
    assert metrics["slots_used"] == 2
    assert metrics["occupancy"] == pytest.approx(26 / 64)
    rounds = [e for e in events.read() if e["event"] == "round"]
    assert rounds and rounds[0]["occupancy"] == pytest.approx(26 / 64)


def test_priority_orders_admission():
    with _sched(slots=1, slice_steps=10) as sched:
        low = sched.submit(_cfg(8, steps=10), priority=0)
        high = sched.submit(_cfg(8, steps=10), priority=5)
        sched.run_round()
        assert sched.jobs[high].status == "completed"
        assert sched.jobs[low].status in ("pending", "running")
        sched.run_until_idle()
        assert sched.jobs[low].status == "completed"


def test_priority_preempts_resident_job():
    with _sched(slots=1, slice_steps=10, yield_rounds=100) as sched:
        long_low = sched.submit(_cfg(8, steps=200), priority=0)
        sched.run_round()
        high = sched.submit(_cfg(8, steps=10), priority=9)
        sched.run_round()
        assert sched.jobs[high].status == "completed"
        sched.run_until_idle()
        job = sched.jobs[long_low]
        assert job.status == "completed" and job.steps_done == 200


def test_starvation_bound(tmp_path):
    events = ServingEventLogger(str(tmp_path / "events.jsonl"))
    with _sched(slots=1, slice_steps=10, yield_rounds=2,
                events=events) as sched:
        long_id = sched.submit(_cfg(8, steps=500))
        sched.run_round()
        short_id = sched.submit(_cfg(8, steps=10))
        waited = 0
        while sched.jobs[short_id].status != "completed":
            assert waited <= 3, f"short job starved {waited} rounds"
            sched.run_round()
            waited += 1
        assert "yielded" in [e["event"] for e in events.read()]
        sched.run_until_idle()
        assert sched.jobs[long_id].steps_done == 500


def test_evict_resume_preserves_solo_parity():
    config = _cfg(8, steps=120, seed=3)
    with _sched(slots=1, slice_steps=10, yield_rounds=1) as sched:
        long_id = sched.submit(config)
        sched.run_round()
        for i in range(3):
            sched.submit(_cfg(8, steps=10, seed=50 + i))
            sched.run_round()
        sched.run_until_idle()
        assert sched.jobs[long_id].status == "completed"
        got = sched.result(long_id).positions.numpy()
    assert _max_rel(got, _solo(config)) <= 1e-5


def test_deadline_expires_queued_job():
    with _sched(slots=1, slice_steps=10) as sched:
        jid = sched.submit(_cfg(8, steps=10), deadline_s=-1.0)
        sched.run_round()
        st = sched.status(jid)
    assert st["status"] == "failed" and "deadline" in st["error"]


def test_cancel_pending_and_running():
    with _sched(slots=1, slice_steps=10) as sched:
        running = sched.submit(_cfg(8, steps=500))
        queued = sched.submit(_cfg(8, steps=500))
        sched.run_round()
        assert sched.cancel(queued) is True
        assert sched.cancel(running) is True
        assert sched.status(queued)["status"] == "cancelled"
        assert sched.status(running)["status"] == "cancelled"
        assert not sched.has_work()
        assert sched.cancel(running) is False


def test_queue_full_sheds_with_retry_hint(tmp_path):
    events = ServingEventLogger(str(tmp_path / "events.jsonl"))
    with _sched(slots=1, slice_steps=10, max_queue=2,
                events=events) as sched:
        sched.submit(_cfg(8))
        sched.submit(_cfg(8))
        with pytest.raises(QueueFull) as e:
            sched.submit(_cfg(8))
        assert e.value.retry_after_s >= 1.0 and e.value.depth == 2
    assert any(ev["event"] == "shed" for ev in events.read())


def test_memory_rejection_through_budget_override(monkeypatch, tmp_path):
    """GRAVITY_TPU_HBM_BYTES forces a budget on the CPU: a key whose
    estimate does not fit is a typed submit-time rejection; a small one
    is admitted."""
    perf_mod.ledger().reset()
    monkeypatch.setenv("GRAVITY_TPU_HBM_BYTES", str(1 << 20))
    events = ServingEventLogger(str(tmp_path / "events.jsonl"))
    with _sched(slots=4, slice_steps=10, events=events) as sched:
        with pytest.raises(InsufficientDeviceMemory) as e:
            sched.submit(_cfg(1000))
        assert e.value.source == "estimated"
        assert e.value.required_bytes > e.value.budget_bytes * 0.9
        sched.submit(_cfg(8))
    assert any(ev["event"] == "memory_rejected" for ev in events.read())


def test_perf_ledger_row_at_first_round():
    perf_mod.ledger().reset()
    with _sched(slots=2, slice_steps=5) as sched:
        sched.submit(_cfg(8, steps=10))
        sched.run_until_idle()
        key = next(iter(sched.engine.compile_counts))
    row = perf_mod.ledger().row_for(perf_mod.engine_key_str(key))
    assert row["compile_count"] == 1 and row["flops"] > 0
    assert row["estimated_bytes"] == perf_mod.estimate_peak_bytes(key)
    # No allocator to read on the CPU: the peak is the counter's
    # high-water mark of live tensor bytes, above the batch's own.
    assert row["flops_source"] == "counted"
    assert row["peak_source"] == "counted_live_bytes"
    assert row["peak_bytes"] > 0


def test_unported_job_classes_refused():
    """Every class of the JAX package is served now: what is refused at
    submit is a malformed payload, each a typed JobValidationError (the
    daemon's 400), as tests/test_serve_jobs.py:91-125 pins for the JAX
    package, with nothing half-admitted."""
    with _sched(slots=1, slice_steps=10) as sched:
        for job_type, params, match in (
                ("fit", {}, "observations"),
                ("sweep", {"members": 0}, "members must be >= 1"),
                ("watch", {}, "radius"),
                ("sweep-member", {"member": 0}, "internal")):
            with pytest.raises(JobValidationError, match=match):
                sched.submit(_cfg(8), job_type=job_type, params=params)
        assert sched.queue_depth == 0 and not sched.jobs
        # Item 5's class is served: admitted as an exclusive key.
        jid = sched.submit(_cfg(8), job_type="sharded-integrate")
        key = sched.jobs[jid].key_cache
        assert (key.job_type, key.slots, key.backend) == \
            ("sharded-integrate", 1, "dense")
        with pytest.raises(ValueError, match="unknown job type"):
            sched.submit(_cfg(8), job_type="bogus")


def test_round_error_on_card_fails_jobs_and_trips_breaker(monkeypatch):
    """The card's departure, exercised on the CPU with the breakers in
    their card mode: a round that raises (a kernel's launch error) trips
    the backend's breaker at once; the residents' requeue meets the
    open breaker at the ladder's card floor (pallas) and fails with the
    error in their status, never rerouted to dense or chunked."""
    with _sched(slots=2, slice_steps=5) as sched:
        sched.breakers.on_card = True
        jid = sched.submit(_cfg(8, steps=20, force_backend="pallas",
                                eps=1e9))

        def broken(batch, steps):
            raise RuntimeError("nbody_direct launch failed: test")

        monkeypatch.setattr(sched.engine, "run_slice", broken)
        with pytest.raises(RuntimeError, match="launch failed"):
            sched.run_round()
        st = sched.status(jid)
        assert st["status"] == "failed"
        assert "launch failed" in st["error"]
        assert sched.breakers.snapshot()["pallas"]["state"] == "open"
        with pytest.raises(BreakerOpen, match="launch failed"):
            sched.submit(_cfg(8, force_backend="pallas", eps=1e9))
        # pallas-mxu's rung below is pallas: open there too, refused.
        with pytest.raises(BreakerOpen):
            sched.breakers.reroute("pallas")


def test_spool_respool_after_restart(tmp_path):
    spool_dir = str(tmp_path / "spool")
    config_done = _cfg(8, steps=10, seed=1)
    config_pending = _cfg(8, steps=40, seed=2)
    sched1 = _sched(slots=1, slice_steps=10, spool=Spool(spool_dir),
                    events=ServingEventLogger(str(tmp_path / "e1.jsonl")))
    done_id = sched1.submit(config_done, job_id="done-job")
    pending_id = sched1.submit(config_pending, job_id="pending-job")
    sched1.run_round()
    assert sched1.jobs[done_id].status == "completed"
    sched1.close_io()
    del sched1
    events2 = ServingEventLogger(str(tmp_path / "e2.jsonl"))
    with _sched(slots=1, slice_steps=10, spool=Spool(spool_dir),
                events=events2) as sched2:
        assert sched2.status(done_id)["status"] == "completed"
        assert sched2.result(done_id) is not None
        assert sched2.status(pending_id)["status"] == "pending"
        assert any(e["event"] == "respooled" for e in events2.read())
        sched2.run_until_idle()
        assert sched2.status(pending_id)["status"] == "completed"
        got = sched2.result(pending_id).positions.numpy()
    assert _max_rel(got, _solo(config_pending)) <= 1e-5


def test_event_logger_rejects_unknown_kind(tmp_path):
    events = ServingEventLogger(str(tmp_path / "e.jsonl"))
    with pytest.raises(ValueError):
        events.event("not-a-kind")
