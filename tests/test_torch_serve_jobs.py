"""The served ``fit``, ``sweep`` and ``watch`` classes of the port
(``gravity_tpu_torch/serve/jobs/``) against the JAX package, on the CPU.

- fit: the port's ``fit_solo`` matches the JAX package's within 1e-8
  relative (fp64; the JAX ICs inline as ``params.state``, since the two
  packages' model draws differ); a served fit matches the port's solo
  within 1e-5, through ``dense`` and through the kernel entry
  (``pallas``: its plain forward in ``ops/forces.DenseVJP`` on the CPU),
  and after evict and resume;
- sweep: fed the JAX member's ICs, the port's member program and verdict
  give min_sep and energy_drift within 1e-10 relative of the JAX ones and
  the same ``escaped``; served members match the port's
  ``sweep_member_solo`` (1e-5 relative and 1e-7 absolute, the JAX bars);
  the cancel cascade; re-expansion and respool after a restart;
- watch: served events (step, i, j, kind) equal the JAX package's
  ``watch_solo`` exactly, also across evict and resume; a follow-up is
  submitted and completes; a shed follow-up does not break the round;
- admission: the typed rejections (``tests/test_serve_jobs.py:91-155``),
  one build per (class, bucket), and a fit key's first-round peak at or
  below its estimate (``telemetry/perf.fit_bytes``).
"""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.ops.integrators import make_step_fn as jax_step_fn
from gravity_tpu.serve.jobs import fit as jax_fit
from gravity_tpu.serve.jobs import sweep as jax_sweep
from gravity_tpu.serve.jobs import watch as jax_watch
from gravity_tpu.simulation import make_initial_state as jax_initial_state
from gravity_tpu.simulation import make_local_kernel as jax_local_kernel
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.serve import (
    EnsembleScheduler,
    JobValidationError,
    QueueFull,
    Spool,
    fit_solo,
    get_class,
    sweep_member_solo,
    watch_solo,
)
from gravity_tpu_torch.state import ParticleState
from gravity_tpu_torch.telemetry import perf as perf_mod
from gravity_tpu_torch.utils.logging import ServingEventLogger


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fields(n, steps=30, **kw):
    kw.setdefault("model", "random")
    kw.setdefault("dt", 3600.0)
    kw.setdefault("integrator", "leapfrog")
    kw.setdefault("force_backend", "dense")
    return dict(n=n, steps=steps, **kw)


def _cfg(n, steps=30, **kw):
    return SimulationConfig(**_fields(n, steps, **kw))


def _sched(**kw):
    return EnsembleScheduler(device="cpu", **kw)


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _state_payload(st) -> dict:
    return {k: np.asarray(getattr(st, k)).tolist()
            for k in ("positions", "velocities", "masses")}


def _fit_params(fields, iters=30):
    """The JAX suite's fit problem (``tests/test_serve_jobs.py:51-79``):
    observations of the JAX config's own trajectory at half and full
    rollout, a 0.95x guess; the JAX ICs inline, so both packages fit the
    same system."""
    config = JaxConfig(**fields)
    st = jax_initial_state(config)
    kernel = jax_local_kernel(dataclasses.replace(
        config, force_backend="dense"), "dense")
    step = jax_step_fn(config.integrator,
                       lambda p: kernel(p, p, st.masses), config.dt)
    s, a = st, kernel(st.positions, st.positions, st.masses)
    obs_steps, out = [config.steps // 2, config.steps], []
    for i in range(config.steps):
        s, a = step(s, a)
        if i + 1 in obs_steps:
            out.append(np.asarray(s.positions).tolist())
    obs = {"steps": obs_steps, "positions": out}
    return st, {
        "observations": obs, "iters": iters, "lr": 2.0,
        "optimizer": "adam",
        "scale": float(np.abs(np.asarray(out)).max()),
        "guess_velocities": (np.asarray(st.velocities) * 0.95).tolist(),
        "state": _state_payload(st),
    }


def test_fit_solo_matches_jax(x64):
    fields = _fields(6, steps=12, seed=3, dtype="float64")
    _, params = _fit_params(fields, iters=16)
    want = jax_fit.fit_solo(JaxConfig(**fields), dict(params))
    got = fit_solo(SimulationConfig(**fields), dict(params), device="cpu")
    assert got["finite"] and want["finite"]
    assert _max_rel(got["velocities"], want["velocities"]) <= 1e-8
    assert abs(got["loss"] - want["loss"]) <= 1e-8 * abs(want["loss"])


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_fit_served_matches_solo_and_recovers(backend):
    fields = _fields(6, steps=12, seed=3, force_backend=backend)
    st, params = _fit_params(fields, iters=16)
    cfg = SimulationConfig(**fields)
    solo = fit_solo(cfg, dict(params), device="cpu")
    with _sched(slots=2, slice_steps=48) as sched:
        jid = sched.submit(cfg, job_type="fit", params=dict(params))
        sched.run_until_idle()
        status = sched.status(jid)
        assert status["status"] == "completed", status
        assert status["units"] == "iters" and status["steps_done"] == 16
        data = sched.result_data(jid)
    assert _max_rel(data["velocities"], solo["velocities"]) <= 1e-5
    assert abs(float(data["loss"][0]) - solo["loss"]) \
        <= 1e-5 * max(abs(solo["loss"]), 1e-30)
    truth = np.asarray(st.velocities)
    guess_err = np.abs(np.asarray(params["guess_velocities"]) - truth).max()
    assert solo["loss"] < 1.0
    assert np.abs(solo["velocities"] - truth).max() < guess_err


def test_fit_survives_evict_resume(tmp_path):
    """slots=1, two jobs, yield_rounds=1, one iteration a round: the Adam
    moments and the iteration counter round-trip through the snapshot."""
    fields = _fields(6, steps=10, seed=5)
    _, params = _fit_params(fields, iters=12)
    solo = fit_solo(SimulationConfig(**fields), dict(params), device="cpu")
    events = ServingEventLogger(str(tmp_path / "ev.jsonl"))
    with _sched(slots=1, slice_steps=10, yield_rounds=1,
                events=events) as sched:
        ids = [sched.submit(SimulationConfig(**fields), job_type="fit",
                            params=dict(params)) for _ in range(2)]
        sched.run_until_idle()
        for jid in ids:
            assert sched.status(jid)["status"] == "completed"
            assert _max_rel(sched.result_data(jid)["velocities"],
                            solo["velocities"]) <= 1e-5
    assert sum(e["event"] == "yielded" for e in events.read()) >= 2


def test_fit_key_first_round_peak_within_estimate():
    """A fit key's perf-ledger row: its first round's measured peak (the
    counter's live bytes on the CPU) at or below the estimate, which
    counts the rollout's saved pair tensors for ``dense``."""
    fields = _fields(64, steps=10, seed=1)
    rng = np.random.default_rng(0)
    obs = {"steps": [5, 10], "positions": rng.normal(size=(2, 64, 3))
           .tolist()}
    with _sched(slots=2, slice_steps=20) as sched:
        sched.submit(SimulationConfig(**fields), job_type="fit",
                     params={"observations": obs, "iters": 2,
                             "scale": 1e11})
        sched.run_until_idle()
        key = next(iter(sched.engine.compile_counts))
    assert key.job_type == "fit"
    row = perf_mod.ledger().row_for(perf_mod.engine_key_str(key))
    est = perf_mod.estimate_peak_bytes(key)
    assert row["estimated_bytes"] == est
    assert row["peak_source"] == "counted_live_bytes"
    assert 0 < row["peak_bytes"] <= est
    # The fit terms sit on top of the integrate key's estimate.
    twin = key._replace(job_type="integrate", extra=())
    assert est == perf_mod.estimate_peak_bytes(twin) + perf_mod.fit_bytes(key)


# --- sweep ---


@pytest.mark.parametrize("escape_radius", [0.0, 1e13])
def test_member_program_matches_jax_on_jax_ics(escape_radius, x64):
    """The JAX member's ICs (its fold_in draw) through both packages'
    member program and verdict. At dt = 3.6e6 s the drift (~1e-4) stands
    far above the energies' fp64 rounding: at the JAX suite's 3,600 s it
    is ~1e-13, itself rounding (the packages' energies ~1e-16 of |E|
    apart). The default escape radius sees escapes, 1e13 m none."""
    fields = _fields(8, steps=20, seed=7, dtype="float64", dt=3.6e6)
    params = {"spread": 0.05, "sweep_seed": 11,
              "escape_radius": escape_radius}
    for k in range(3):
        p = {**params, "member": k}
        want = jax_sweep.sweep_member_solo(JaxConfig(**fields), p)
        ics = jax_sweep.member_initial_state(JaxConfig(**fields), p)
        got = sweep_member_solo(
            SimulationConfig(**fields), p, device="cpu",
            ics=ParticleState(*(torch.from_numpy(np.array(x)) for x in (
                ics.positions, ics.velocities, ics.masses))))
        assert got["finite"] and want["finite"]
        assert abs(got["min_sep"] - want["min_sep"]) \
            <= 1e-10 * want["min_sep"]
        assert abs(got["energy_drift"] - want["energy_drift"]) \
            <= 1e-10 * want["energy_drift"]
        assert got["escaped"] == want["escaped"] == (escape_radius == 0.0)


def test_sweep_member_verdicts_match_solo():
    cfg = _cfg(8, steps=20, seed=7)
    params = {"members": 4, "spread": 0.05, "sweep_seed": 11}
    with _sched(slots=4, slice_steps=10) as sched:
        pid = sched.submit(cfg, job_type="sweep", params=dict(params))
        sched.run_until_idle()
        status = sched.status(pid)
        assert status["status"] == "completed", status
        assert status["steps_done"] == 4
        summary = status["result"]
        assert summary["members"] == 4 and summary["completed"] == 4
        data = sched.result_data(pid)
        for k in range(4):
            solo = sweep_member_solo(cfg, {**params, "member": k},
                                     device="cpu")
            assert solo["finite"]
            assert abs(float(data["min_sep"][k]) - solo["min_sep"]) \
                <= 1e-5 * max(solo["min_sep"], 1e-30), k
            assert abs(float(data["energy_drift"][k])
                       - solo["energy_drift"]) <= 1e-7, k
            assert bool(data["escaped"][k]) == solo["escaped"], k
        member = sched.status(f"{pid}.m2")
        assert member["status"] == "completed"
        assert member["parent"] == pid
        assert member["job_type"] == "sweep-member"


def test_member_draws_are_seeded_per_member():
    """torch.Generator draws from (sweep_seed, member): the same member
    is the same ICs, other members and seeds differ."""
    from gravity_tpu_torch.serve.jobs.sweep import member_initial_state

    cfg = _cfg(8, seed=2)
    a = member_initial_state(cfg, {"spread": 0.1, "sweep_seed": 3,
                                   "member": 1})
    b = member_initial_state(cfg, {"spread": 0.1, "sweep_seed": 3,
                                   "member": 1})
    c = member_initial_state(cfg, {"spread": 0.1, "sweep_seed": 3,
                                   "member": 2})
    d = member_initial_state(cfg, {"spread": 0.1, "sweep_seed": 4,
                                   "member": 1})
    assert torch.equal(a.velocities, b.velocities)
    assert not torch.equal(a.velocities, c.velocities)
    assert not torch.equal(a.velocities, d.velocities)
    assert torch.equal(a.positions, c.positions)


def test_sweep_exercises_scheduler_and_cancel():
    cfg = _cfg(6, steps=400, seed=1)
    with _sched(slots=2, slice_steps=20) as sched:
        pid = sched.submit(cfg, job_type="sweep",
                           params={"members": 6, "spread": 0.02})
        for _ in range(3):
            sched.run_round()
        assert sched.active_count == 2 and sched.queue_depth >= 3
        assert sched.cancel(pid)
        for k in range(6):
            assert sched.status(f"{pid}.m{k}")["status"] == "cancelled", k
        assert sched.status(pid)["status"] == "cancelled"
        assert not sched.has_work()


def test_sweep_parent_reexpands_interrupted_fanout(tmp_path):
    import os

    cfg = _cfg(6, steps=10, seed=4)
    spool = Spool(str(tmp_path / "spool"))
    sched = _sched(slots=2, slice_steps=10, spool=spool)
    pid = sched.submit(cfg, job_type="sweep",
                       params={"members": 3, "spread": 0.02})
    sched.close_io()
    del sched
    for k in (1, 2):
        os.remove(spool.job_path(f"{pid}.m{k}"))
    sched2 = _sched(slots=2, slice_steps=10,
                    spool=Spool(str(tmp_path / "spool")))
    sched2.run_until_idle()
    st = sched2.status(pid)
    assert st["status"] == "completed", st
    assert st["result"]["completed"] == 3
    sched2.close_io()


def test_sweep_respools_after_restart(tmp_path):
    cfg = _cfg(6, steps=20, seed=9)
    params = {"members": 3, "spread": 0.03}
    sched = _sched(slots=2, slice_steps=10,
                   spool=Spool(str(tmp_path / "spool")))
    pid = sched.submit(cfg, job_type="sweep", params=dict(params))
    sched.run_round()
    sched.close_io()
    del sched
    sched2 = _sched(slots=2, slice_steps=10,
                    spool=Spool(str(tmp_path / "spool")))
    sched2.run_until_idle()
    st = sched2.status(pid)
    assert st["status"] == "completed", st
    data = sched2.result_data(pid)
    for k in range(3):
        solo = sweep_member_solo(cfg, {**params, "member": k}, device="cpu")
        assert abs(float(data["min_sep"][k]) - solo["min_sep"]) \
            <= 1e-5 * max(solo["min_sep"], 1e-30)
    sched2.close_io()


# --- watch ---


def _encounter_setup(steps=50):
    fields = _fields(3, steps=steps)
    params = {
        "radius": 1.99e10, "merge_radius": 1.96e10,
        "state": {
            "positions": [[-1e10, 0, 0], [1e10, 0, 0], [5e11, 5e11, 0]],
            "velocities": [[500.0, 0, 0], [-500.0, 0, 0], [0, 0, 0]],
            "masses": [1e26, 1e26, 1.0],
        },
    }
    return fields, params


def _jax_events(fields, params, slice_steps):
    events = jax_watch.watch_solo(JaxConfig(**fields), dict(params),
                                  slice_steps=slice_steps)
    return [(e["step"], e["i"], e["j"], int(e["kind"] == "merger"))
            for e in events]


def _served_events(data):
    return list(zip(data["event_step"].tolist(), data["event_i"].tolist(),
                    data["event_j"].tolist(), data["event_kind"].tolist()))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_watch_events_match_jax_exactly(dtype, tmp_path):
    fields, params = _encounter_setup()
    fields["dtype"] = dtype
    ctx = jax.enable_x64(dtype == "float64")
    with ctx:
        want = _jax_events(fields, params, 25)
    assert want, "the setup should produce at least one encounter"
    solo = watch_solo(SimulationConfig(**fields), dict(params),
                      slice_steps=25, device="cpu")
    assert [(e["step"], e["i"], e["j"], int(e["kind"] == "merger"))
            for e in solo] == want
    events = ServingEventLogger(str(tmp_path / "ev.jsonl"))
    with _sched(slots=2, slice_steps=25, events=events) as sched:
        jid = sched.submit(SimulationConfig(**fields), job_type="watch",
                           params=dict(params))
        sched.run_until_idle()
        assert sched.status(jid)["status"] == "completed"
        assert _served_events(sched.result_data(jid)) == want
    stream = [e for e in events.read()
              if e["event"] in ("encounter", "merger")]
    assert [(e["step"], e["i"], e["j"]) for e in stream] == \
        [w[:3] for w in want]


def test_watch_flag_survives_evict_resume():
    """slots=1, two watch jobs, yield_rounds=1, 10 steps a round: the
    "was inside" flag rides the evict extras, so no crossing is dropped
    or repeated at a round boundary."""
    fields, params = _encounter_setup()
    want = _jax_events(fields, params, 10)
    with _sched(slots=1, slice_steps=10, yield_rounds=1) as sched:
        ids = [sched.submit(SimulationConfig(**fields), job_type="watch",
                            params=dict(params)) for _ in range(2)]
        sched.run_until_idle()
        for jid in ids:
            assert sched.status(jid)["status"] == "completed"
            assert _served_events(sched.result_data(jid)) == want


def test_watch_followup_submits_highres_job(tmp_path):
    fields, params = _encounter_setup()
    params["followup"] = {"refine": 4, "max": 1}
    events = ServingEventLogger(str(tmp_path / "ev.jsonl"))
    cfg = SimulationConfig(**fields)
    with _sched(slots=2, slice_steps=25, events=events) as sched:
        jid = sched.submit(cfg, job_type="watch", params=params)
        sched.run_until_idle()
        assert sched.status(jid)["status"] == "completed"
        follow = sched.status(f"{jid}.f0")
        assert follow is not None and follow["status"] == "completed"
        child = sched.jobs[f"{jid}.f0"]
        assert child.config.dt == cfg.dt / 4
        assert child.config.steps == 25 * 4
        assert child.priority == 1
        assert child.params.get("state") is not None
        assert sched.status(f"{jid}.f1") is None
    sub = [e for e in events.read() if e["event"] == "followup_submitted"]
    assert len(sub) == 1 and sub[0]["followup"] == f"{jid}.f0"


def test_watch_followup_queuefull_does_not_break_round(monkeypatch):
    fields, params = _encounter_setup()
    params["followup"] = {"refine": 2, "max": 1}
    cfg = SimulationConfig(**fields)
    with _sched(slots=2, slice_steps=25) as sched:
        jid = sched.submit(cfg, job_type="watch", params=dict(params))
        orig = sched.submit

        def shedding(config, **kw):
            if kw.get("job_type") == "integrate" and str(
                    kw.get("job_id") or "").startswith(jid):
                raise QueueFull(1.0, 99)
            return orig(config, **kw)

        monkeypatch.setattr(sched, "submit", shedding)
        sched.run_until_idle()
        st = sched.status(jid)
        assert st["status"] == "completed", st
        assert st["steps_done"] == cfg.steps
        assert st["result"]["events"] >= 1
        assert sched.status(f"{jid}.f0") is None


# --- across classes ---


@pytest.mark.parametrize("job_type,params,match", [
    ("not-a-type", {}, "unknown job type"),
    ("fit", {}, "observations"),
    ("fit", {"observations": {"steps": [], "positions": []}}, "empty"),
    ("fit", {"observations": {"steps": [999],
                              "positions": [[[0, 0, 0]] * 8]}},
     "outside the rollout"),
    ("fit", {"observations": {"steps": [5],
                              "positions": [[[0, 0, 0]] * 3]}}, "shape"),
    ("sweep", {}, "members"),
    ("sweep", {"members": 0}, "members must be >= 1"),
    ("sweep", {"members": 3, "spread": -1}, "spread"),
    ("watch", {}, "radius"),
    ("watch", {"radius": -1.0}, "radius must be > 0"),
    ("watch", {"radius": 1.0, "max_events": 0}, "max_events"),
    ("watch", {"radius": 1.0, "followup": {"refine": 1}}, "refine"),
    ("sweep-member", {"member": 0}, "internal"),
    ("integrate", {"bogus": 1}, "no params"),
    ("integrate", {"state": {"positions": [[0, 0, 0]]}}, "state"),
])
def test_submit_rejects_malformed_job_payloads(job_type, params, match):
    with _sched(slots=2, slice_steps=10) as sched:
        with pytest.raises(JobValidationError, match=match):
            sched.submit(_cfg(8), job_type=job_type, params=params)
        assert sched.queue_depth == 0 and not sched.jobs


def test_daemon_submit_rejects_bad_payloads_as_400(tmp_path):
    from gravity_tpu_torch.serve import GravityDaemon

    daemon = GravityDaemon(str(tmp_path / "spool"), device="cpu")
    try:
        config = json.loads(_cfg(8).to_json())
        for body, frag in [
            ({"config": config, "job_type": "wat"}, "unknown job type"),
            ({"config": config, "job_type": "fit"}, "observations"),
            ({"config": config, "job_type": "sweep",
              "params": {"members": 0}}, "members"),
            ({"config": config, "job_type": "sweep", "params": "zero"},
             "params"),
            ({"config": config, "job_type": "watch"}, "radius"),
        ]:
            code, payload = daemon.handle_post("/submit", body)
            assert code == 400, (body, code, payload)
            assert frag in payload["error"], (frag, payload)
    finally:
        daemon.scheduler.close_io()


def test_mixed_classes_build_once_per_type_and_bucket():
    fields = _fields(6, steps=10, seed=4)
    _, fparams = _fit_params(fields, iters=6)
    wfields, wparams = _encounter_setup(steps=20)
    with _sched(slots=2, slice_steps=10) as sched:
        ids = {
            "integrate": sched.submit(_cfg(8, steps=20, seed=2)),
            "fit": sched.submit(SimulationConfig(**fields), job_type="fit",
                                params=fparams),
            "sweep": sched.submit(_cfg(8, steps=20, seed=2),
                                  job_type="sweep",
                                  params={"members": 3, "spread": 0.01}),
            "watch": sched.submit(SimulationConfig(**wfields),
                                  job_type="watch", params=wparams),
        }
        sched.run_until_idle()
        for jt, jid in ids.items():
            assert sched.status(jid)["status"] == "completed", jt
        counts = sched.engine.compile_counts
        assert all(v == 1 for v in counts.values()), counts
        assert {k.job_type for k in counts} == {
            "integrate", "fit", "sweep-member", "watch"}
        classes = sched.class_metrics()
        assert classes["fit"]["completed"] == 1
        assert classes["sweep"]["completed"] == 1
        assert classes["sweep-member"]["completed"] == 3
        assert classes["watch"]["completed"] == 1
        for jt in ("fit", "sweep", "watch"):
            assert classes[jt]["latency"]["p99_s"] is not None, jt


@pytest.mark.parametrize("name,units,resident", [
    ("integrate", "steps", True), ("fit", "iters", True),
    ("sweep", "members", False), ("sweep-member", "steps", True),
    ("watch", "steps", True), ("sharded-integrate", "steps", True),
])
def test_job_class_registry_surface(name, units, resident):
    cls = get_class(name)
    assert cls.units == units
    assert getattr(cls, "resident", True) == resident
    with pytest.raises(JobValidationError):
        get_class("nope")


@pytest.mark.parametrize("chunk_pairs", [1 << 25, 37])
def test_closest_pair_batched_is_closest_pairs_slot_by_slot(
        chunk_pairs, monkeypatch):
    """The sweep and watch programs' scan (closest_pairs at k = 1 over a
    batch at once) against closest_pairs on each slot: bucket padding of
    zero mass, a slot with one massive body, an empty slot; in row chunks
    of every size."""
    from gravity_tpu_torch.ops import encounters

    monkeypatch.setattr(encounters, "MIN_PAIR_PAIRS", chunk_pairs)
    rng = np.random.default_rng(8)
    pos = torch.from_numpy(rng.uniform(-1e11, 1e11, (4, 40, 3)))
    m = torch.from_numpy(rng.uniform(1e23, 1e25, (4, 40)))
    m[0, 30:] = 0.0
    m[2, 1:] = 0.0
    m[3] = 0.0
    d, bi, bj = encounters.closest_pair_batched(pos, m)
    for b in range(4):
        want = encounters.closest_pairs(pos[b], m[b], k=1, chunk=16)
        assert (int(bi[b]), int(bj[b])) == (int(want[1][0]), int(want[2][0]))
        assert float(d[b]) == float(want[0][0]) or (
            math.isinf(float(d[b])) and math.isinf(float(want[0][0])))
