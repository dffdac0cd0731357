"""The port's self-healing supervisor (``gravity_tpu_torch/supervisor.py``)
on the CPU, every recovery path driven by fault injection, mirroring
``tests/test_supervisor.py``; and the rule that no rung hides a kernel: a
real build error propagates through ``run``, ``resume`` and
``--auto-recover`` alike and is never degraded.

Tolerances: a transient retry continues from the in-memory state at the
same dt, so its final state equals the uninterrupted run's bit for bit;
a divergence heal integrates one block again at dt/2, so its final state
is within 1e-3 relative of the uninterrupted run's (the JAX suite's bar).
"""

import json
import os

import numpy as np
import pytest
import torch

from gravity_tpu_torch import simulation
from gravity_tpu_torch.cli import main
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.simulation import (
    SimulationDiverged,
    SimulationPreempted,
    Simulator,
)
from gravity_tpu_torch.supervisor import (
    BACKEND_LADDER,
    RunSupervisor,
    SupervisorPolicy,
    next_rung,
    parse_sharded_backend,
)
from gravity_tpu_torch.utils import faults as fmod
from gravity_tpu_torch.utils.checkpoint import (
    make_checkpoint_manager,
    restore_checkpoint,
    restore_checkpoint_with_extra,
    save_checkpoint,
)
from gravity_tpu_torch.utils.faults import TransientFault
from gravity_tpu_torch.utils.logging import RecoveryEventLogger


@pytest.fixture
def port_faults(monkeypatch):
    def install(spec: str):
        monkeypatch.setenv(fmod.ENV_KNOB, spec)
        return fmod.install(spec)

    yield install
    fmod.reset()


def _cfg(**kw):
    base = dict(model="random", n=32, steps=40, dt=3600.0, seed=3,
                force_backend="dense", progress_every=10)
    base.update(kw)
    return SimulationConfig(**base)


def _sup(cfg, tmp_path, **kw):
    events = RecoveryEventLogger(str(tmp_path / "recovery.jsonl"))
    mgr = make_checkpoint_manager(str(tmp_path / "ckpt"), max_to_keep=10)
    return RunSupervisor(cfg, events=events, checkpoint_manager=mgr,
                         device="cpu", **kw), events


def _truth(**kw):
    return Simulator(_cfg(**kw), device="cpu").run()["final_state"]


def _rel_diff(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("mode", ["on", "off"])
def test_self_healing_divergence_roundtrip(port_faults, tmp_path, mode):
    """diverge@20: the watchdog's checkpoint at 10, a rollback, the block
    (10, 20] again at dt/2, then the original dt to the end."""
    truth = _truth()
    port_faults("diverge@20")
    sup, events = _sup(_cfg(io_pipeline=mode), tmp_path)
    stats = sup.run()
    final = stats["final_state"]
    assert bool(torch.isfinite(final.positions).all())
    assert _rel_diff(final.positions, truth.positions) < 1e-3
    assert stats["supervisor"]["diverge_retries"] == 1
    recs = events.read()
    assert [e["event"] for e in recs] == ["diverged", "rolled_back", "retry"]
    assert recs[0]["step"] == 10 and recs[1]["to_step"] == 10
    assert recs[2]["kind"] == "diverge" and recs[2]["dt"] == 1800.0
    assert stats["io_pipeline"] == mode


def test_divergence_abort_policy(port_faults, tmp_path):
    port_faults("diverge@20")
    sup, events = _sup(_cfg(on_diverge="abort"), tmp_path)
    with pytest.raises(SimulationDiverged):
        sup.run()
    assert [e["event"] for e in events.read()] == ["diverged"]


def test_retries_bounded(port_faults, tmp_path):
    port_faults("diverge@20,diverge@20,diverge@20")
    sup, _ = _sup(_cfg(max_retries=2), tmp_path)
    with pytest.raises(SimulationDiverged):
        sup.run()
    assert sup.diverge_retries == 2


def test_transient_backoff_retry(port_faults, tmp_path):
    truth = _truth()
    port_faults("transient@10x2")
    sup, events = _sup(_cfg(), tmp_path,
                       policy=SupervisorPolicy(backoff_s=0.01))
    stats = sup.run()
    assert stats["supervisor"]["transient_retries"] == 2
    assert torch.equal(stats["final_state"].positions, truth.positions)
    retries = [e for e in events.read() if e["event"] == "retry"]
    assert [r["kind"] for r in retries] == ["transient", "transient"]
    assert retries[1]["backoff_s"] == pytest.approx(
        2 * retries[0]["backoff_s"])


def test_transient_budget_exhausts(port_faults, tmp_path):
    port_faults("transient@10x5")
    sup, _ = _sup(_cfg(), tmp_path,
                  policy=SupervisorPolicy(max_retries=2, backoff_s=0.01))
    with pytest.raises(TransientFault):
        sup.run()


def test_backend_degrade_ladder(port_faults, tmp_path):
    """backend:pallas-mxu (the nbody_mxu kernel) degrades to pallas
    (nbody_direct) with a degraded event; both down, on CPU tensors, to
    chunked (on the card that rung is refused:
    test_card_ladder_stops_at_the_last_kernel)."""
    port_faults("backend:pallas-mxu")
    sup, events = _sup(_cfg(force_backend="pallas-mxu"), tmp_path)
    stats = sup.run()
    assert stats["supervisor"]["backend"] == "pallas"
    assert stats["backend"] == "nbody_direct"
    degr = [e for e in events.read() if e["event"] == "degraded"]
    assert [(d["from_backend"], d["to_backend"]) for d in degr] == [
        ("pallas-mxu", "pallas")]
    fmod.reset()
    port_faults("backend:pallas-mxu,backend:pallas")
    sup, events = _sup(_cfg(force_backend="pallas-mxu"), tmp_path / "b")
    stats = sup.run()
    assert stats["supervisor"]["backend"] == "chunked"
    assert stats["supervisor"]["degraded_from"] == "pallas-mxu"


def test_degrade_keys_off_the_resolved_backend(port_faults, tmp_path):
    """An unbuildable kernel under a name off the ladder degrades by the
    backend it resolves to: the resolved nbody_mxu walks the ladder."""
    port_faults("backend:nbody_mxu")
    sup, events = _sup(_cfg(force_backend="pallas-mxu"), tmp_path)
    stats = sup.run()
    assert stats["supervisor"]["backend"] == "pallas"
    assert next_rung("nbody_mxu") == "pallas"
    assert next_rung("nbody_direct") == "chunked"
    assert next_rung("nlist") == "chunked"
    assert next_rung("chunked") is None and next_rung("tree") is None
    assert BACKEND_LADDER == ("pallas-mxu", "pallas", "chunked")
    assert next_rung("nbody_mxu", on_card=True) == "pallas"
    assert next_rung("nbody_direct", on_card=True) is None
    assert next_rung("nlist", on_card=True) is None


def _on_card(sup):
    """The supervisor's ladder decisions as on a card. Only the decisions
    are driven (no tensor is made): the Simulator a rung builds is a
    stand-in."""
    sup.device = torch.device("cuda", 0)
    return sup


def test_card_ladder_stops_at_the_last_kernel(port_faults, tmp_path,
                                              monkeypatch):
    """On the card an unbuildable pallas (nbody_direct) is not degraded to
    the plain sum: BackendUnavailable propagates (exit 2) with no degraded
    event; pallas-mxu still degrades to pallas, whose failure then
    propagates."""
    from gravity_tpu_torch import supervisor as smod
    from gravity_tpu_torch.utils.faults import BackendUnavailable

    built = []

    def unbuildable(config, state=None, device=None):
        built.append(config.force_backend)
        raise BackendUnavailable(f"{config.force_backend}: injected")

    monkeypatch.setattr(smod, "Simulator", unbuildable)
    sup, events = _sup(_cfg(force_backend="pallas"), tmp_path)
    with pytest.raises(BackendUnavailable):
        _on_card(sup).run()
    assert built == ["pallas"] and events.read() == []
    sup, events = _sup(_cfg(force_backend="pallas-mxu"), tmp_path / "b")
    with pytest.raises(BackendUnavailable):
        _on_card(sup).run()
    assert built[1:] == ["pallas-mxu", "pallas"]
    assert [(e["from_backend"], e["to_backend"]) for e in events.read()] \
        == [("pallas-mxu", "pallas")]


@pytest.mark.parametrize("backend,on_card,healed", [
    ("nbody_direct", False, "chunked"),
    ("nbody_direct", True, None),
    ("nlist", False, "chunked"),
    ("nlist", True, None),
    ("nbody_mxu", True, "pallas"),
    ("tree", True, "pallas"),
])
def test_accuracy_heal_reroutes_to_a_kernel_on_the_card(
        tmp_path, backend, on_card, healed):
    """An accuracy breach reroutes to an exact sum: on the card only to a
    kernel. With no kernel rung left the breach propagates (exit 2)."""
    from gravity_tpu_torch.simulation import AccuracyBreach

    sup, _ = _sup(_cfg(force_backend="dense"), tmp_path)
    if on_card:
        _on_card(sup)
    sup._releafed = True  # the tree's leaf-cap rung is spent
    breach = AccuracyBreach(10, backend, 1e-3, 1e-8)
    if healed is None:
        with pytest.raises(AccuracyBreach):
            sup._accuracy_heal(breach, None)
    else:
        sup._accuracy_heal(breach, None)
        assert sup.config.force_backend == healed


def test_sharded_backends_refused():
    """Sharded backends are ported: the elastic half of the ladder halves
    the devices down to 2, then the solo form of the same kernel, and the
    parse is the JAX package's (tests/test_torch_serve_sharded.py holds
    both to it)."""
    assert next_rung("sharded/8/pallas") == "sharded/4/pallas"
    assert next_rung("sharded/2/pallas", on_card=True) == "pallas"
    assert parse_sharded_backend("sharded/4/pallas") == (4, "pallas")
    assert parse_sharded_backend("pallas") == (None, None)


def test_preemption_checkpoints_and_resumes(port_faults, tmp_path):
    """SIGTERM mid-run takes the checkpoint-and-exit path; the snapshot
    resumes to the uninterrupted run's state, bit for bit on the CPU."""
    mgr = make_checkpoint_manager(str(tmp_path / "ckpt"))
    port_faults("preempt@20")
    with pytest.raises(SimulationPreempted):
        Simulator(_cfg(), device="cpu").run(checkpoint_manager=mgr)
    state, step = restore_checkpoint(mgr)
    assert step == 20
    resumed = Simulator(_cfg(), state=state, device="cpu").run(
        start_step=step)["final_state"]
    assert torch.equal(resumed.positions, _truth().positions)


def test_preempted_event_emitted(port_faults, tmp_path):
    port_faults("preempt@20")
    sup, events = _sup(_cfg(), tmp_path)
    with pytest.raises(SimulationPreempted):
        sup.run()
    assert [e["event"] for e in events.read()] == ["preempted"]
    assert events.read()[0]["step"] == 20


def _adaptive_cfg(**kw):
    return _cfg(model="plummer", n=32, eps=1e10, steps=10, adaptive=True,
                integrator="leapfrog", progress_every=5, eta=0.05, **kw)


def test_adaptive_transient_keeps_progress(port_faults, tmp_path):
    port_faults("transient@5")
    sup, _ = _sup(_adaptive_cfg(), tmp_path,
                  policy=SupervisorPolicy(backoff_s=0.01))
    stats = sup.run()
    assert stats["t_reached"] == pytest.approx(stats["t_end"], rel=1e-5)
    assert stats["supervisor"]["transient_retries"] == 1
    assert stats["steps"] == 5 and stats["adaptive_steps"] == 10


def test_adaptive_supervised_recovery(port_faults, tmp_path):
    port_faults("diverge@5")
    sup, events = _sup(_adaptive_cfg(), tmp_path)
    stats = sup.run()
    assert stats["t_reached"] == pytest.approx(stats["t_end"], rel=1e-5)
    assert stats["supervisor"]["diverge_retries"] == 1
    kinds = [e["event"] for e in events.read()]
    assert kinds[:2] == ["diverged", "rolled_back"] and "retry" in kinds


def test_adaptive_checkpoint_carries_t_and_resumes(port_faults, tmp_path):
    """An adaptive run preempted at a block saves (t, comp); the resume
    ends where the uninterrupted run ends, bit for bit."""
    truth = Simulator(_adaptive_cfg(), device="cpu").run()
    mgr = make_checkpoint_manager(str(tmp_path / "ckpt"))
    port_faults("preempt@5")
    with pytest.raises(SimulationPreempted):
        Simulator(_adaptive_cfg(checkpoint_every=5),
                  device="cpu").run_adaptive(checkpoint_manager=mgr)
    state, step, extra = restore_checkpoint_with_extra(mgr)
    assert step == 5 and 0.0 < extra["t"] < truth["t_end"]
    resumed = Simulator(_adaptive_cfg(), state=state,
                        device="cpu").run_adaptive(
        start_t=extra["t"], start_comp=extra["comp"], start_steps=step)
    assert resumed["adaptive_steps"] == truth["adaptive_steps"]
    assert torch.equal(resumed["final_state"].positions,
                       truth["final_state"].positions)


def test_rollback_ignores_a_foreign_newer_snapshot(port_faults, tmp_path):
    """A newer snapshot of another run in a shared directory is never the
    rollback point: the rollback takes the watchdog's own save at 10."""
    sup, events = _sup(_cfg(), tmp_path)
    foreign = Simulator(_cfg(seed=9), device="cpu").state
    save_checkpoint(sup.mgr, 90, foreign)
    port_faults("diverge@20")
    stats = sup.run()
    recs = events.read()
    assert [e["event"] for e in recs] == ["diverged", "rolled_back", "retry"]
    assert recs[1]["to_step"] == 10
    assert _rel_diff(stats["final_state"].positions,
                     _truth().positions) < 1e-3
    assert 90 in sup.mgr.all_steps()


def test_replaced_corrupt_step_on_recovery_save(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    sim = Simulator(_cfg(steps=20), device="cpu")
    mgr = make_checkpoint_manager(ckpt, max_to_keep=10)
    save_checkpoint(mgr, 10, sim.state)
    healthy = sim.run()["final_state"]
    save_checkpoint(mgr, 20, healthy)
    path = os.path.join(ckpt, "20", "checkpoint.pt")
    with open(path, "wb") as f:
        f.write(b"\x00" * 64)
    save_checkpoint(mgr, 20, healthy)  # replaces the torn snapshot
    state, step, _ = restore_checkpoint_with_extra(mgr)
    assert step == 20 and torch.equal(state.positions, healthy.positions)


def test_restore_falls_back_past_corrupted_latest(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    mgr = make_checkpoint_manager(ckpt, max_to_keep=10)
    mid = Simulator(_cfg(steps=20), device="cpu").run()["final_state"]
    save_checkpoint(mgr, 10, mid)
    end = Simulator(_cfg(steps=10), state=mid, device="cpu").run()
    save_checkpoint(mgr, 20, end["final_state"])
    path = os.path.join(ckpt, "20", "checkpoint.pt")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 3)
    state, step, _ = restore_checkpoint_with_extra(
        make_checkpoint_manager(ckpt, max_to_keep=10))
    assert step == 10 and torch.equal(state.positions, mid.positions)


class _BuildError(RuntimeError):
    """What a failed nvcc build or a CUDA launch raises."""


@pytest.fixture
def broken_kernel(monkeypatch):
    """nbody_direct's loader fails as a real build would."""
    def boom(*args, **kwargs):
        raise _BuildError("nbody_direct: nvcc failed (exit 1)")

    monkeypatch.setattr(simulation, "accelerations_vs_kernel", boom)


def test_a_real_build_error_propagates_under_auto_recover(broken_kernel,
                                                          tmp_path):
    """The supervisor degrades only for the fault plan's
    BackendUnavailable: a kernel's own error propagates, with no
    degraded event."""
    sup, events = _sup(_cfg(force_backend="pallas"), tmp_path)
    with pytest.raises(_BuildError):
        sup.run()
    assert events.read() == []


@pytest.mark.parametrize("verb", ["run", "run-auto-recover", "resume"])
def test_a_real_build_error_propagates_through_the_cli(broken_kernel,
                                                       tmp_path, verb):
    ckpt = str(tmp_path / "ckpt")
    if verb == "resume":
        save_checkpoint(make_checkpoint_manager(ckpt), 10,
                        Simulator(_cfg(), device="cpu").state)
    argv = ["resume" if verb == "resume" else "run", "--device", "cpu",
            "--model", "random", "--n", "32", "--steps", "40",
            "--force-backend", "pallas", "--checkpoint-dir", ckpt,
            "--log-dir", str(tmp_path / "logs")]
    if verb == "run-auto-recover":
        argv.append("--auto-recover")
    with pytest.raises(_BuildError):
        main(argv)
    recovery = [f for f in os.listdir(tmp_path / "logs")
                if f.startswith("recovery_")] \
        if os.path.isdir(tmp_path / "logs") else []
    for name in recovery:
        lines = open(tmp_path / "logs" / name).read().splitlines()
        assert not any(json.loads(x)["event"] == "degraded" for x in lines)


def test_supervised_cli_run_heals_and_reports(port_faults, tmp_path,
                                              capsys):
    port_faults("diverge@20")
    rc = main(["run", "--device", "cpu", "--model", "random", "--n", "32",
               "--steps", "40", "--progress-every", "10",
               "--auto-recover", "--checkpoint-dir", str(tmp_path / "ck"),
               "--log-dir", str(tmp_path / "logs")])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["supervisor"]["diverge_retries"] == 1
    (name,) = [f for f in os.listdir(tmp_path / "logs")
               if f.startswith("recovery_")]
    kinds = [json.loads(x)["event"] for x in
             open(tmp_path / "logs" / name).read().splitlines()]
    assert kinds == ["diverged", "rolled_back", "retry"]
    assert np.isfinite(stats["total_time_s"])
