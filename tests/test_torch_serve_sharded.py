"""The ``sharded-integrate`` job class (gravity_tpu_torch/serve/jobs/
sharded.py) against the JAX package's (``tests/test_serve_sharded.py``'s
cases), on the CPU.

- ``next_rung`` and ``parse_sharded_backend`` give
  ``gravity_tpu.supervisor``'s strings, with the port's on-card rule
  beside them (the plain rungs off the ladder below the solo form).
- The key, the bucket and the validation rejections are the JAX class's
  for the same payloads.
- A job on a group of 2 gloo ranks (worker processes of the scheduler,
  joined by a ``FileStore``) equals the solo run of its padded state bit
  for bit; the solo form too; the ring (each hop adds a shard's partial
  sum) and the halo cell list within 1e-5 of |row| of the solo run (the
  JAX suite's bar; the halo engine's on a world of more than one,
  ``tests/test_torch_halo.py``).
- ``mesh_fail`` walks 8 -> 4 -> 2 -> solo; ``collective_stall`` fails its
  round, the group is torn down and the job completes from its progress
  snapshot on a rebuilt group; the requeue cap holds.
- The fault grammar of the two mesh kinds is the JAX package's.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from gravity_tpu import supervisor as jax_supervisor
from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.serve.jobs import get_class as jax_get_class
from gravity_tpu.serve.jobs import JobValidationError as JaxValidationError
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.serve import EnsembleScheduler, Spool
from gravity_tpu_torch.serve.jobs import JobValidationError, get_class
from gravity_tpu_torch.simulation import Simulator
from gravity_tpu_torch.state import ParticleState
from gravity_tpu_torch.supervisor import next_rung, parse_sharded_backend
from gravity_tpu_torch.utils import faults as fmod
from gravity_tpu_torch.utils.logging import ServingEventLogger

HALO_TOL = 1e-5
RING_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def plan():
    """Installs a fault plan in this process; undone after the test."""
    yield fmod.install
    fmod.reset()


def _cfg(n, steps=30, cls=SimulationConfig, **kw):
    kw.setdefault("model", "random")
    kw.setdefault("dt", 3600.0)
    kw.setdefault("integrator", "leapfrog")
    kw.setdefault("force_backend", "dense")
    return cls(n=n, steps=steps, **kw)


def _sched(**kw):
    return EnsembleScheduler(device="cpu", **kw)


def _solo_padded(cfg, bucket: int) -> ParticleState:
    """The solo run of the job's initial state padded to ``bucket``."""
    from gravity_tpu_torch.simulation import make_initial_state

    st, _ = make_initial_state(cfg, device="cpu").pad_to(bucket)
    sim = Simulator(cfg.__class__(**{**cfg.__dict__, "n": bucket}),
                    state=st, device="cpu")
    return sim.run()["final_state"]


def _near_solo(got, cfg, bucket, tol):
    want = _solo_padded(cfg, bucket)
    for f in ("positions", "velocities"):
        a = getattr(got, f).numpy()
        b = getattr(want, f).numpy()[:cfg.n]
        assert np.all(np.abs(a - b) <= tol * np.linalg.norm(
            b, axis=1, keepdims=True))


def _same_as_solo(got, cfg, bucket):
    want = _solo_padded(cfg, bucket)
    n = cfg.n
    assert torch.equal(got.positions, want.positions[:n])
    assert torch.equal(got.velocities, want.velocities[:n])


# --- the elastic ladder ---


SHARDED_NAMES = ["sharded/8/dense", "sharded/4/dense", "sharded/2/dense",
                 "sharded/2/pallas", "sharded/6/chunked",
                 "sharded/3/chunked", "sharded/x/dense", "sharded/",
                 "sharded/2/pallas-mxu", "sharded/4/nlist"]


@pytest.mark.parametrize("name", SHARDED_NAMES)
def test_next_rung_walks_the_elastic_half_as_jax(name):
    assert next_rung(name) == jax_supervisor.next_rung(name)
    # The elastic half is the same on the card.
    assert next_rung(name, on_card=True) == jax_supervisor.next_rung(name)


def test_below_the_solo_form_the_ports_card_rule_stands():
    for local in ("pallas", "pallas-mxu", "nlist", "dense"):
        assert next_rung(local) == jax_supervisor.next_rung(local)
    assert next_rung("pallas", on_card=True) is None
    assert next_rung("pallas-mxu", on_card=True) == "pallas"
    assert next_rung("nlist", on_card=True) is None
    # The full walk on a card: 4 -> 2 -> solo kernel, then no plain rung.
    walk, rung = [], "sharded/4/pallas"
    while rung is not None:
        walk.append(rung)
        rung = next_rung(rung, on_card=True)
    assert walk == ["sharded/4/pallas", "sharded/2/pallas", "pallas"]


@pytest.mark.parametrize("name", ["sharded/4/dense", "dense",
                                  "sharded/0/dense", "sharded/4/",
                                  "sharded/x/dense", "sharded/1/pallas"])
def test_parse_sharded_backend_as_jax(name):
    assert parse_sharded_backend(name) == \
        jax_supervisor.parse_sharded_backend(name)


# --- keying and validation ---


KEY_CASES = [
    (dict(n=10), {"devices": 4}),
    (dict(n=10), {"devices": 1}),
    (dict(n=100_000, force_backend="chunked"), {"devices": 8}),
    (dict(n=12, force_backend="pallas"), {"devices": 2}),
    (dict(n=4096, force_backend="nlist", nlist_rcut=5.0, nlist_side=8),
     {"devices": 4}),
    (dict(n=4096, force_backend="nlist", nlist_rcut=5.0, nlist_side=8,
          nlist_cap=16), {"devices": 2, "strategy": "allgather"}),
    (dict(n=300, force_backend="auto"), {"devices": 3}),
    (dict(n=9000, force_backend="direct"), {"devices": 2,
                                            "strategy": "ring"}),
]


@pytest.mark.parametrize("fields,params", KEY_CASES)
def test_sharded_key_is_the_jax_classes(fields, params):
    ours, theirs = get_class("sharded-integrate"), \
        jax_get_class("sharded-integrate")
    cfg, jcfg = _cfg(**fields), _cfg(cls=JaxConfig, **fields)
    key = ours.batch_key(cfg, ours.validate(cfg, params), slots=4,
                         min_bucket=16)
    jkey = theirs.batch_key(jcfg, theirs.validate(jcfg, params), slots=4,
                            min_bucket=16)
    assert key.slots == jkey.slots == 1
    assert (key.backend, key.bucket_n, key.extra) == \
        (jkey.backend, jkey.bucket_n, jkey.extra)


REJECTIONS = [
    ("validate", dict(n=8), {"strategy": "mpi"}),
    ("validate", dict(n=8), {"devices": "many"}),
    ("validate", dict(n=8), {"devices": 0}),
    ("validate", dict(n=8), {"bogus": 1}),
    ("validate", dict(n=8, force_backend="tree"), {}),
    ("validate", dict(n=8), {"strategy": "halo"}),
    ("validate", dict(n=8, force_backend="nlist", nlist_rcut=1.0,
                      nlist_side=4), {"strategy": "ring"}),
    ("key", dict(n=8, periodic_box=1.0), {}),
    ("key", dict(n=8, integrator="multirate"), {}),
    ("key", dict(n=8, adaptive=True), {}),
    ("key", dict(n=8, force_backend="nlist", nlist_rcut=1.0), {}),
    ("key", dict(n=8, nlist_rcut=1.0), {}),
]


@pytest.mark.parametrize("where,fields,params", REJECTIONS)
def test_validation_rejections_are_the_jax_classes(where, fields, params):
    ours, theirs = get_class("sharded-integrate"), \
        jax_get_class("sharded-integrate")
    errs = []
    for cls, err, conf in ((ours, JobValidationError, SimulationConfig),
                           (theirs, JaxValidationError, JaxConfig)):
        with pytest.raises(err) as e:
            if where == "validate":
                cls.validate(_cfg(cls=conf, **fields), params)
            else:
                cls.batch_key(_cfg(cls=conf, **fields),
                              cls.validate(_cfg(cls=conf, n=8), {}),
                              slots=2, min_bucket=16)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_devices_default_to_the_cards_visible(monkeypatch):
    cls = get_class("sharded-integrate")
    cfg = _cfg(10)
    key = cls.batch_key(cfg, cls.validate(cfg, {}), slots=1, min_bucket=16,
                        device="cpu")
    assert key.backend == "dense" and key.bucket_n == 10
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr("gravity_tpu_torch.utils.platform.resolve_device",
                        lambda d=None: torch.device("cuda"))
    key = cls.batch_key(cfg, cls.validate(cfg, {}), slots=1, min_bucket=16)
    assert key.backend == "sharded/4/dense" and key.bucket_n == 12


# --- served parity on a group and solo ---


def test_sharded_jobs_on_a_group_equal_the_solo_runs():
    """A 2-rank group (gloo) for the allgather and the ring, the solo form
    in the daemon's process: each the solo run of its padded state."""
    cfg = _cfg(23, steps=40, seed=5)
    with _sched(slots=2, slice_steps=10) as sched:
        jobs = {
            name: sched.submit(cfg, job_type="sharded-integrate",
                               params=params)
            for name, params in (
                ("allgather", {"devices": 2}),
                ("ring", {"devices": 2, "strategy": "ring"}),
                ("solo", {"devices": 1}))}
        assert sched.jobs[jobs["allgather"]].key_cache.backend == \
            "sharded/2/dense"
        sched.run_until_idle()
        for name, jid in jobs.items():
            job = sched.jobs[jid]
            assert job.status == "completed", (name, job.error)
            bucket = 24 if name != "solo" else 23
            if name == "ring":
                # Each hop adds a shard's partial sum: another order of
                # the row's sum, the JAX suite's 1e-5 of |row|.
                _near_solo(sched.result(jid), cfg, bucket, RING_TOL)
            else:
                _same_as_solo(sched.result(jid), cfg, bucket)
        stats = sched.engine.stats()
    assert stats["force_evals"]["sharded/2/dense"] == 2 * (1 + 40)


def test_sharded_halo_cell_list_job_against_the_solo_cell_list():
    cfg = _cfg(256, steps=8, seed=3, force_backend="nlist", nlist_rcut=2e11,
               nlist_side=4, nlist_cap=32, dt=600.0)
    with _sched(slots=1, slice_steps=4) as sched:
        jid = sched.submit(cfg, job_type="sharded-integrate",
                           params={"devices": 2})
        assert dict(sched.jobs[jid].key_cache.extra)["strategy"] == "halo"
        sched.run_until_idle()
        assert sched.jobs[jid].status == "completed", sched.jobs[jid].error
        got = sched.result(jid)
    _near_solo(got, cfg, 256, HALO_TOL)


# --- elastic degradation under injected faults ---


def test_mesh_fail_walks_the_elastic_ladder_to_completion(tmp_path, plan):
    plan("mesh_fail@0x99")
    ev_path = str(tmp_path / "ev.jsonl")
    cfg = _cfg(16, steps=20, seed=7)
    with _sched(slots=2, slice_steps=10, breaker_threshold=1,
                events=ServingEventLogger(ev_path), max_requeues=5) as sched:
        jid = sched.submit(cfg, job_type="sharded-integrate",
                           params={"devices": 8})
        sched.run_until_idle()
        job = sched.jobs[jid]
        assert job.status == "completed", job.error
        assert job.key_cache.backend == "dense"
        assert job.requeues == 3
        _same_as_solo(sched.result(jid), cfg, 16)
    events = [json.loads(line) for line in open(ev_path)]
    opened = [e["backend"] for e in events if e["event"] == "breaker_open"]
    assert opened == ["sharded/8/dense", "sharded/4/dense",
                      "sharded/2/dense"], opened


def test_collective_stall_fails_round_and_resumes_from_snapshot(tmp_path,
                                                                 plan):
    plan("collective_stall@1x1")
    ev_path = str(tmp_path / "ev.jsonl")
    cfg = _cfg(12, steps=30, seed=13)
    with _sched(slots=2, slice_steps=10, spool=Spool(str(tmp_path / "sp")),
                events=ServingEventLogger(ev_path), worker_id="w",
                lease_ttl_s=300.0, reap_interval_s=0.0) as sched:
        jid = sched.submit(cfg, job_type="sharded-integrate",
                           params={"devices": 2})
        sched.run_round()
        sched.drain_io()  # the round-1 snapshot must be durable
        with pytest.raises(Exception, match="collective stall"):
            sched.run_round()
        sched.run_until_idle()
        job = sched.jobs[jid]
        assert job.status == "completed", job.error
        assert job.requeues == 1
        _same_as_solo(sched.result(jid), cfg, 12)
    events = [json.loads(line) for line in open(ev_path)]
    respooled = [e for e in events if e["event"] == "respooled"]
    assert respooled and respooled[-1]["resume_step"] == 10, respooled


def test_mesh_fail_requeues_capped_by_poison(tmp_path, plan):
    plan("mesh_fail@0x99")
    ev_path = str(tmp_path / "ev.jsonl")
    with _sched(slots=2, slice_steps=10, breaker_threshold=99,
                events=ServingEventLogger(ev_path), max_requeues=2) as sched:
        jid = sched.submit(_cfg(8, steps=20), job_type="sharded-integrate",
                           params={"devices": 4})
        sched.run_until_idle()
        job = sched.jobs[jid]
        assert job.status == "failed" and "poisoned" in (job.error or "")
    events = [json.loads(line) for line in open(ev_path)]
    assert any(e["event"] == "poisoned" for e in events)


# --- the fault grammar ---


def test_mesh_fault_grammar_is_the_jax_packages():
    from gravity_tpu.utils import faults as jax_faults

    spec = ("mesh_fail@2x3,collective_stall@1x5,torn_progress_write@0,"
            "disk_full@1x2")
    ours = fmod.FaultPlan.parse(spec)._faults
    theirs = jax_faults.FaultPlan.parse(spec)._faults
    assert [(f.kind, f.step, f.count) for f in ours] == \
        [(f.kind, f.step, f.count) for f in theirs]


def test_collective_stall_fires_once_and_mesh_fail_counts_builds(plan):
    plan("collective_stall@1x5")
    assert fmod.collective_stall_secs(0) == 0.0
    assert fmod.collective_stall_secs(1) == 5.0
    assert fmod.collective_stall_secs(2) == 0.0  # fires once
    plan("mesh_fail@1x2")
    assert [fmod.mesh_fail_due() for _ in range(5)] == \
        [False, True, True, False, False]
