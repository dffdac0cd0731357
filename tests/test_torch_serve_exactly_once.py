"""A served job ends with one terminal event (gravity_tpu_torch/serve/
scheduler.py and leases.py), on the CPU.

Two in-process schedulers share one spool and one event stream.

* A stalled writer: worker ``wa`` runs a job to completion while its
  background result writer is held before the ``.npz`` lands, longer
  than the 1 s lease TTL, and ``wa`` runs no round in that time. Worker
  ``wb`` then scans the spool, as a peer's reaper does. The owner holds
  its lease heartbeat while the result is in flight, so the peer adopts
  nothing and re-runs nothing: ``completed`` appears once, and the
  stored result is the first run's. (A daemon's own heartbeat thread
  already covers this window; an in-process scheduler has none.)
* A dead owner: ``wb`` caches the job read-only while ``wa`` runs it;
  ``wa`` writes its ``completed`` record and event and dies before the
  ``.npz`` lands (its heartbeat stopped, its lease expired). ``wb``
  adopts and re-runs the job from its cached copy, and emits no second
  terminal event: the record says the first went out.
"""

import threading
import time

import numpy as np

from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.serve import EnsembleScheduler, Spool
from gravity_tpu_torch.utils.logging import ServingEventLogger

TTL_S = 1.0
STALL_S = 1.6


def _cfg():
    return SimulationConfig(n=8, steps=10, seed=3, model="random",
                            dt=3600.0, integrator="leapfrog",
                            force_backend="dense")


def _worker(spool_dir, events_path, worker_id, ttl_s=TTL_S, slice_steps=10):
    return EnsembleScheduler(
        device="cpu", slots=1, slice_steps=slice_steps,
        spool=Spool(spool_dir), events=ServingEventLogger(events_path),
        worker_id=worker_id, lease_ttl_s=ttl_s, reap_interval_s=0.0)


def test_stalled_result_writer_completes_once(tmp_path):
    spool_dir = str(tmp_path / "spool")
    events_path = str(tmp_path / "events.jsonl")
    release = threading.Event()
    owner = _worker(spool_dir, events_path, "wa")
    write_result = owner.spool.write_result

    def stalled(*args, **kw):
        assert release.wait(timeout=60)
        return write_result(*args, **kw)

    owner.spool.write_result = stalled
    peer = None
    try:
        jid = owner.submit(_cfg(), job_id="once")
        owner.run_round()
        assert owner.jobs[jid].status == "completed"
        first = Spool.normalize_result(owner.jobs[jid].result_data)
        time.sleep(STALL_S)  # past the TTL, the .npz still held back
        peer = _worker(spool_dir, events_path, "wb")
        peer.run_until_idle()
        release.set()
        owner.close_io()
        peer.run_until_idle()
        assert peer.status(jid)["status"] == "completed"
        got = peer.result_data(jid)
    finally:
        release.set()
        owner.close_io()
        if peer is not None:
            peer.close_io()
    events = [e for e in ServingEventLogger(events_path).read()
              if e.get("job") == jid]
    kinds = [e["event"] for e in events]
    assert kinds.count("completed") == 1, kinds
    assert "adopted" not in kinds and "fenced" not in kinds, kinds
    assert set(got) == set(first)
    for name, value in first.items():
        np.testing.assert_array_equal(got[name], value)


def test_dead_owner_after_completed_record_ends_once(tmp_path):
    spool_dir = str(tmp_path / "spool")
    events_path = str(tmp_path / "events.jsonl")
    release = threading.Event()
    owner = _worker(spool_dir, events_path, "wa", ttl_s=30.0, slice_steps=5)
    write_result = owner.spool.write_result

    def stalled(*args, **kw):
        assert release.wait(timeout=60)
        return write_result(*args, **kw)

    owner.spool.write_result = stalled
    peer = None
    try:
        jid = owner.submit(_cfg(), job_id="dead-owner")
        owner.run_round()
        assert owner.jobs[jid].status == "running"
        peer = _worker(spool_dir, events_path, "wb", ttl_s=30.0)
        cached = peer.jobs[jid]
        assert not cached.owned and cached.status == "running"
        owner.run_round()
        assert owner.jobs[jid].status == "completed"
        # The owner dies here: no heartbeat from now on, its lease expired.
        owner.leases.suspend(3600.0)
        owner.leases.backdate()
        peer.housekeeping()  # the peer's reaper
        peer.run_until_idle()
        assert peer.jobs[jid] is cached and cached.owned
        assert peer.status(jid)["status"] == "completed"
        got = peer.result_data(jid)
    finally:
        release.set()
        owner.close_io()
        if peer is not None:
            peer.close_io()
    kinds = [e["event"] for e in ServingEventLogger(events_path).read()
             if e.get("job") == jid]
    assert "adopted" in kinds, kinds
    terminal = [k for k in kinds if k in ("completed", "failed", "cancelled")]
    assert terminal == ["completed"], kinds
    assert np.all(np.isfinite(got["positions"]))
