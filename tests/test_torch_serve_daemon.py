"""The port's serving daemon (``gravity_tpu_torch/serve/service.py``)
over real localhost HTTP on the CPU (``device="cpu"``).

The client verbs run through the port's CLI functions (``submit``,
``status``, ``result``, ``cancel``) against a daemon on ``127.0.0.1:0``
in this process; every answer's JSON key set equals the JAX daemon's for
the same request. A restarted daemon respools unfinished work. Without a
card and without ``device="cpu"`` the daemon refuses to start.
"""

import json

import numpy as np
import pytest
import torch

from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.serve import GravityDaemon as JaxDaemon
from gravity_tpu.serve import request as jax_request
from gravity_tpu.serve import wait_for as jax_wait_for
from gravity_tpu_torch.cli import main
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.serve import GravityDaemon, request, wait_for
from gravity_tpu_torch.simulation import Simulator

CFG = dict(model="random", n=10, steps=30, dt=3600.0, integrator="leapfrog",
           force_backend="dense", seed=4)


@pytest.fixture
def daemon(tmp_path):
    d = GravityDaemon(str(tmp_path / "spool"), slots=2, slice_steps=10,
                      idle_sleep_s=0.01, device="cpu")
    d.start()
    yield d
    d.stop()


@pytest.fixture
def jax_daemon(tmp_path):
    d = JaxDaemon(str(tmp_path / "jax_spool"), slots=2, slice_steps=10,
                  idle_sleep_s=0.01)
    d.start()
    yield d
    d.stop()


def _cli(capsys, *argv) -> tuple:
    rc = main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


def _submit_argv(spool, **cfg) -> list:
    argv = ["submit", "--spool-dir", spool]
    for k, v in cfg.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return argv


def test_cli_verbs_round_trip(daemon, capsys, tmp_path):
    spool = daemon.spool_dir
    rc, out, _ = _cli(capsys, *_submit_argv(spool, **CFG), "--wait")
    assert rc == 0
    st = json.loads(out)
    assert st["status"] == "completed" and st["steps_done"] == 30
    jid = st["id"]
    rc, out, _ = _cli(capsys, "status", "--spool-dir", spool, jid)
    assert rc == 0 and json.loads(out)["status"] == "completed"
    rc, out, _ = _cli(capsys, "status", "--spool-dir", spool)
    assert rc == 0 and [j["id"] for j in json.loads(out)["jobs"]] == [jid]
    npz = str(tmp_path / "final.npz")
    rc, out, _ = _cli(capsys, "result", "--spool-dir", spool, jid,
                      "--out", npz)
    assert rc == 0 and json.loads(out)["n"] == 10
    solo = Simulator(SimulationConfig(**CFG), device="cpu").run()[
        "final_state"].positions.numpy()
    with np.load(npz) as z:
        got = z["positions"]
    assert np.max(np.abs(got - solo) / np.maximum(np.abs(solo), 1e-30)) \
        <= 1e-5
    # A terminal job cannot be cancelled: exit 1 with cancelled false.
    rc, out, _ = _cli(capsys, "cancel", "--spool-dir", spool, jid)
    assert rc == 1 and json.loads(out) == {"cancelled": False}


def test_cli_cancel_queued_job(daemon, capsys):
    spool = daemon.spool_dir
    long = dict(CFG, steps=100_000)
    ids = []
    for _ in range(3):
        rc, out, _ = _cli(capsys, *_submit_argv(spool, **long))
        assert rc == 0
        ids.append(json.loads(out)["job"])
    for jid in ids:
        rc, out, _ = _cli(capsys, "cancel", "--spool-dir", spool, jid)
        assert rc == 0 and json.loads(out) == {"cancelled": True}
    sts = wait_for(spool, ids, timeout=60)
    assert all(s["status"] == "cancelled" for s in sts.values())


def test_cli_refuses_unported_job_types(daemon, capsys):
    """fit, sweep and watch are served: a malformed payload is the
    daemon's 400 (the JAX daemon's, tests/test_serve_jobs.py:128-155),
    and an unknown class the verb's own refusal."""
    spool = daemon.spool_dir
    rc, _, err = _cli(capsys, *_submit_argv(spool, **CFG), "--job-type",
                      "fit")
    assert rc == 1 and "observations" in err
    rc, _, err = _cli(capsys, *_submit_argv(spool, **CFG), "--job-type",
                      "sweep", "--params", '{"members": 0}')
    assert rc == 1 and "members" in err
    rc, _, err = _cli(capsys, *_submit_argv(spool, **CFG), "--job-type",
                      "bogus")
    assert rc == 2 and "served classes" in err
    # sharded-integrate is served now: on the CPU a group of one, the
    # solo form, which completes.
    rc, out, _ = _cli(capsys, *_submit_argv(daemon.spool_dir, **CFG),
                      "--job-type", "sharded-integrate", "--devices", "1",
                      "--wait", "--timeout", "120")
    assert rc == 0 and json.loads(out)["status"] == "completed"
    # Over the API: a watch without its radius and a non-object payload
    # are 400s that say why.
    config = json.loads(SimulationConfig(**CFG).to_json())
    resp = request(daemon.spool_dir, "POST", "/submit", {
        "config": config, "job_type": "watch"})
    assert "radius" in resp["error"]
    resp = request(daemon.spool_dir, "POST", "/submit", {
        "config": config, "job_type": "sweep", "params": "zero"})
    assert "params" in resp["error"]


def test_answers_have_the_jax_daemons_keys(daemon, jax_daemon):
    """The same submit, status, result, cancel and healthz requests to
    both daemons: the same JSON key sets."""
    port_cfg = json.loads(SimulationConfig(**CFG).to_json())
    jax_cfg = json.loads(JaxConfig(**CFG).to_json())
    answers = {}
    for name, req, spool, cfg in (
            ("port", request, daemon.spool_dir, port_cfg),
            ("jax", jax_request, jax_daemon.spool_dir, jax_cfg)):
        sub = req(spool, "POST", "/submit", {"config": cfg,
                                             "job_id": "job-keys"})
        long = req(spool, "POST", "/submit",
                   {"config": dict(cfg, steps=100_000)})
        (jax_wait_for if name == "jax" else wait_for)(
            spool, ["job-keys"], timeout=120)
        answers[name] = {
            "submit": sub,
            "status": req(spool, "GET", "/status?job=job-keys"),
            "result": req(spool, "GET", "/result?job=job-keys"),
            "cancel": req(spool, "POST", "/cancel", {"job": long["job"]}),
            "cancel_again": req(spool, "POST", "/cancel",
                                {"job": long["job"]}),
            "unknown": req(spool, "GET", "/status?job=nope"),
            "healthz": req(spool, "GET", "/healthz"),
            "profile": req(spool, "POST", "/profile", {"rounds": 1}),
        }
    for what, ans in answers["port"].items():
        assert set(ans) == set(answers["jax"][what]), what
    assert answers["port"]["profile"]["profiling_rounds"] == 1
    assert answers["port"]["cancel"] == {"cancelled": True}
    assert answers["port"]["result"]["status"] == "completed"


def test_daemon_restart_respools_and_completes(tmp_path):
    spool = str(tmp_path / "spool")
    config = SimulationConfig(**dict(CFG, steps=60, seed=42))
    d1 = GravityDaemon(spool, slots=2, slice_steps=5, idle_sleep_s=0.01,
                       device="cpu")
    d1.start()
    resp = request(spool, "POST", "/submit",
                   {"config": json.loads(config.to_json())})
    jid = resp["job"]
    d1.stop()
    d2 = GravityDaemon(spool, slots=2, slice_steps=5, idle_sleep_s=0.01,
                       device="cpu")
    d2.start()
    try:
        st = wait_for(spool, [jid], timeout=120)[jid]
        assert st["status"] == "completed", st
        resp = request(spool, "GET", f"/result?job={jid}")
        solo = Simulator(config, device="cpu").run()["final_state"] \
            .positions.numpy()
        got = np.asarray(resp["positions"], np.float32)
        assert np.max(np.abs(got - solo) / np.maximum(np.abs(solo), 1e-30)) \
            <= 1e-5
        assert "respooled" in [e["event"] for e in d2.events.read()]
    finally:
        d2.stop()


def test_metrics_carry_engine_counters(daemon):
    spool = daemon.spool_dir
    resp = request(spool, "POST", "/submit", {
        "config": json.loads(SimulationConfig(**CFG).to_json())})
    wait_for(spool, [resp["job"]], timeout=60)
    m = request(spool, "GET", "/metrics")
    assert list(m["engine"]["builds"].values()) == [1]
    assert m["engine"]["force_evals"]["dense"] >= 30
    assert m["engine"]["host_reads"]["finite"] == m["rounds"]
    assert set(m["kernel_launches"]) == {
        "nbody_direct", "nbody_direct/batched", "nbody_mxu",
        "nbody_mxu/batched", "nlist_pair", "nlist_pair/bf16",
        "nlist_pair/batched", "nlist_pair/batched_bf16"}
    text = daemon.metrics_prometheus({})[1]
    assert "gravity_rounds_total" in text


def test_daemon_needs_a_card_or_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GravityDaemon(str(tmp_path / "spool"))


def test_round_lock_lets_a_waiter_in_between_rounds():
    """Back-to-back rounds under the daemon's lock: a handler thread
    waiting for it gets in at the next yield, not after the worker
    stops."""
    import threading
    import time

    from gravity_tpu_torch.serve.service import RoundLock

    lock = RoundLock()
    stop = threading.Event()
    got_in = []

    def worker():
        while not stop.is_set():
            with lock:
                assert lock.held_by_me()
                time.sleep(0.002)  # a short round
            lock.yield_to_waiters()

    t = threading.Thread(target=worker)
    t.start()
    time.sleep(0.01)
    t0 = time.monotonic()
    with lock:
        got_in.append(time.monotonic() - t0)
        assert lock.held_by_me()
    stop.set()
    t.join()
    assert got_in[0] < 0.5
    assert not lock.held_by_me()
