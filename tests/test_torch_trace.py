"""Solo-run tracing and the fleet verbs of the port on the CPU.

- ``Simulator.run(telemetry=...)``: a ``block`` span a consumed block, a
  ``checkpoint`` span a save, ``sentinel`` spans, the stats' trace id;
  the span names equal the JAX package's for the same run, and a traced
  run ends on the untraced run's bits.
- The flight recorder through ``run`` (``--trace``, ``--error-budget``):
  a dump on an injected divergence, an accuracy breach and a SIGTERM,
  where the JAX package writes one; ``resume --trace``.
- ``trace-export`` of a served job's trace with the router's ``route``
  span, of a solo run's, and its exit codes; ``fleet-status`` over two
  workers and a router.
"""

import glob
import json
import os

import pytest
import torch

from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.simulation import Simulator as JaxSimulator
from gravity_tpu.telemetry import Telemetry as JaxTelemetry
from gravity_tpu.utils.checkpoint import (
    make_checkpoint_manager as jax_checkpoint_manager,
)
from gravity_tpu_torch.cli import main
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.serve import (
    GravityDaemon,
    RouterDaemon,
    request,
    wait_for,
)
from gravity_tpu_torch.simulation import Simulator
from gravity_tpu_torch.telemetry import Telemetry, load_spans, span_coverage
from gravity_tpu_torch.utils import faults as fmod
from gravity_tpu_torch.utils.checkpoint import make_checkpoint_manager

CFG = dict(model="random", n=16, steps=20, dt=3600.0, integrator="leapfrog",
           force_backend="dense", progress_every=5, checkpoint_every=10)
RUN = ["--device", "cpu", "--model", "random", "--n", "32", "--steps", "40",
       "--progress-every", "10", "--integrator", "leapfrog",
       "--force-backend", "dense", "--eps", "1e9"]


@pytest.fixture
def port_faults(monkeypatch):
    def install(spec: str):
        monkeypatch.setenv(fmod.ENV_KNOB, spec)
        return fmod.install(spec)

    yield install
    fmod.reset()


def _names(path, trace):
    return sorted(s["name"] for s in load_spans(path) if s["trace"] == trace)


def test_solo_run_trace_spans_match_the_jax_package(tmp_path):
    """Block and checkpoint spans, the stats' trace id, coverage > 0.9;
    the JAX Simulator's run of the same config emits the same names."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    tele = Telemetry(out_dir=str(port_dir), worker="solo-w")
    cfg = SimulationConfig(**CFG, checkpoint_dir=str(port_dir / "ckpt"))
    stats = Simulator(cfg, device="cpu").run(
        checkpoint_manager=make_checkpoint_manager(cfg.checkpoint_dir),
        telemetry=tele)
    tr = stats["trace_id"]
    path = str(port_dir / "traces.jsonl")
    names = _names(path, tr)
    assert names.count("block") == 4 and names.count("checkpoint") == 2
    spans = load_spans(path)
    cov = span_coverage([s for s in spans if s["name"] == "block"], tr)
    assert cov["coverage"] > 0.9
    blocks = [s for s in spans if s["name"] == "block"]
    assert [(s["steps_from"], s["steps_to"]) for s in blocks] == [
        (1, 5), (6, 10), (11, 15), (16, 20)]
    assert [s["compiled"] for s in blocks] == [True, False, False, False]
    jax_tele = JaxTelemetry(out_dir=str(jax_dir), worker="solo-w")
    jcfg = JaxConfig(**CFG, checkpoint_dir=str(jax_dir / "ckpt"))
    jstats = JaxSimulator(jcfg).run(
        checkpoint_manager=jax_checkpoint_manager(jcfg.checkpoint_dir),
        telemetry=jax_tele)
    assert names == _names(str(jax_dir / "traces.jsonl"),
                           jstats["trace_id"])


def test_traced_run_gives_the_untraced_bits(tmp_path):
    """Telemetry reads what the loop already has: the same final state,
    bit for bit, with the ledger and the sentinel on (a sentinel span a
    probe)."""
    cfg = SimulationConfig(**dict(CFG, checkpoint_every=0), ledger=True,
                           sentinel_every=1)
    plain = Simulator(cfg, device="cpu").run()
    tele = Telemetry(out_dir=str(tmp_path), worker="w")
    traced = Simulator(cfg, device="cpu").run(telemetry=tele)
    for k in ("positions", "velocities", "masses"):
        assert torch.equal(getattr(plain["final_state"], k),
                           getattr(traced["final_state"], k))
    assert "trace_id" not in plain
    names = _names(str(tmp_path / "traces.jsonl"), traced["trace_id"])
    assert names.count("sentinel") == traced["sentinel"]["probes"] == 4
    snap = tele.registry.snapshot()
    assert snap["gravity_steps_per_sec"]["series"][0]["value"] > 0


def _dumps(log_dir):
    return [json.load(open(p)) for p in sorted(glob.glob(
        os.path.join(log_dir, "flightrec_*.json")))]


def test_run_trace_dumps_the_flight_recorder_on_divergence(
        tmp_path, port_faults, capsys):
    """``run --trace`` with an injected divergence: exit 2 and one
    flight-recorder dump (reason divergence) holding the run's spans and
    the diverged event; the spans name the run's trace."""
    log_dir = str(tmp_path / "logs")
    port_faults("diverge@25")
    rc = main(["run", *RUN, "--trace", "--log-dir", log_dir])
    assert rc == 2
    assert json.loads(capsys.readouterr().err.strip().splitlines()[-1])[
        "error"] == "diverged"
    dumps = _dumps(log_dir)
    assert [d["reason"] for d in dumps] == ["divergence"]
    entries = dumps[0]["entries"]
    assert [e["name"] for e in entries if e["kind"] == "span"] == [
        "block", "block"]
    assert entries[-1]["kind"] == "event"
    assert entries[-1]["event"] == "diverged"
    assert entries[-1]["step"] == 20


def test_error_budget_breach_dumps_without_trace(tmp_path, port_faults,
                                                 capsys):
    """``--error-budget`` arms the recorder on its own: a breach exits 2
    with its dump (reason accuracy_breach), as in the JAX package."""
    log_dir = str(tmp_path / "logs")
    port_faults("accuracy_breach@20")
    rc = main(["run", *RUN, "--error-budget", "0.5", "--sentinel-every",
               "1", "--log-dir", log_dir])
    assert rc == 2
    err = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert err["error"] == "accuracy_breach"
    assert [d["reason"] for d in _dumps(log_dir)] == ["accuracy_breach"]


def test_preempted_traced_run_dumps_and_resumes_traced(tmp_path,
                                                       port_faults, capsys):
    """A SIGTERM (``preempt@20``) under ``--trace``: exit 75, a sigterm
    dump; ``resume --trace`` ends with its own trace id and span file;
    ``--auto-recover --trace`` heals a divergence and dumps the ring at
    it."""
    log_dir = str(tmp_path / "logs")
    ckpt = ["--checkpoint-every", "10", "--checkpoint-dir",
            str(tmp_path / "ck"), "--log-dir", log_dir, "--trace"]
    port_faults("preempt@20")
    assert main(["run", *RUN, *ckpt]) == 75
    assert [d["reason"] for d in _dumps(log_dir)] == ["sigterm"]
    fmod.reset()
    capsys.readouterr()
    assert main(["resume", *RUN, *ckpt]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["resumed_at"] == 20 and stats["trace_path"].endswith(
        "traces.jsonl")
    names = _names(stats["trace_path"], stats["trace_id"])
    assert names.count("block") == 2 and "checkpoint" in names
    heal_dir = str(tmp_path / "heal")
    port_faults("diverge@25")
    assert main(["run", *RUN, "--auto-recover", "--trace", "--log-dir",
                 heal_dir, "--checkpoint-dir", str(tmp_path / "ck2")]) == 0
    dumps = _dumps(heal_dir)
    assert dumps and all(d["reason"] == "divergence" for d in dumps)
    assert any(e.get("event") == "diverged" for e in dumps[-1]["entries"])


def test_trace_export_exit_codes(tmp_path, capsys):
    """Exit 2 for a job with no spool record, a record with no trace id,
    and a span file holding several traces without ``--trace``; exit 0
    with ``--trace`` on that file."""
    spool = tmp_path / "spool"
    (spool / "jobs").mkdir(parents=True)
    (spool / "jobs" / "old.json").write_text(json.dumps({"id": "old"}))
    assert main(["trace-export", "--spool-dir", str(spool), "nope"]) == 2
    assert main(["trace-export", "--spool-dir", str(spool), "old"]) == 2
    log_dir = str(tmp_path / "logs")
    traces = []
    for _ in range(2):
        capsys.readouterr()
        assert main(["run", *RUN, "--trace", "--log-dir", log_dir]) == 0
        traces.append(json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])["trace_id"])
    path = os.path.join(log_dir, "traces.jsonl")
    assert main(["trace-export", "--trace-file", path]) == 2
    assert "2 traces" in capsys.readouterr().err
    out = str(tmp_path / "one.json")
    assert main(["trace-export", "--trace-file", path, "--trace",
                 traces[1], "--out", out]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["trace"] == traces[1] and line["coverage"] > 0.9
    doc = json.load(open(out))
    assert [e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"
            ].count("block") == 4
    assert main(["trace-export", "--trace-file", path, "--trace",
                 "tr-none"]) == 2


def test_routed_job_trace_and_fleet_status(tmp_path, capsys):
    """A job submitted through the router: its exported trace holds the
    router's ``route`` span beside the worker's spans; ``fleet-status``
    shows both workers' liveness, drain flag and capabilities and the
    router's placements."""
    spool = str(tmp_path / "spool")
    workers = [GravityDaemon(spool, slots=2, slice_steps=10,
                             idle_sleep_s=0.01, worker_id=w, device="cpu")
               for w in ("w1", "w2")]
    for w in workers:
        w.start()
    router = RouterDaemon(spool, router_id="rt")
    router.start()
    try:
        r = request(spool, "POST", "/submit", {"config": dict(
            model="random", n=12, steps=20, dt=3600.0,
            integrator="leapfrog", force_backend="dense")})
        assert r["routed_by"] == "rt"
        wait_for(spool, [r["job"]], timeout=60)
        out = str(tmp_path / "job.json")
        capsys.readouterr()
        assert main(["trace-export", "--spool-dir", spool, r["job"],
                     "--out", out]) == 0
        line = json.loads(capsys.readouterr().out)
        names = {e["name"] for e in json.load(open(out))["traceEvents"]
                 if e.get("ph") == "X"}
        assert {"route", "admission", "round"} <= names, names
        assert line["spans"] >= 4
        route = [s for s in load_spans(os.path.join(spool, "traces.jsonl"))
                 if s["name"] == "route"]
        assert len(route) == 1 and route[0]["target"] == r["worker"]
        assert route[0]["trace"] == line["trace"]
        assert main(["fleet-status", "--spool-dir", spool]) == 0
        status = json.loads(capsys.readouterr().out)
        reg = status["worker_registry"]
        assert sorted(reg) == ["w1", "w2"]
        for row in reg.values():
            assert row["alive"] and not row["draining"]
            assert row["sharded_capable"] and row["nlist_capable"]
            assert row["capabilities"]["slots"] == 2
        assert status["router"]["placements"] == 1
        assert status["router"]["routed"] == {r["worker"]: 1}
        assert "registry" not in status
    finally:
        router.stop()
        for w in workers:
            w.stop()
