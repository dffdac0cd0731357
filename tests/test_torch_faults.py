"""The port's fault injection (``gravity_tpu_torch/utils/faults.py``), on
the CPU: the run-loop grammar of ``gravity_tpu/utils/faults.py`` parses
the same way, each fault fires at its real code point, the serving items
parse (tests/test_torch_serve_host.py fires them), the mesh items are
refused with their ROADMAP item, and the two exceptions
come from the plan alone (mirrors ``tests/test_faults.py``)."""

import json

import numpy as np
import pytest
import torch

from gravity_tpu.utils.faults import FaultPlan as JaxFaultPlan
from gravity_tpu_torch.cli import main
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.simulation import SimulationDiverged, Simulator
from gravity_tpu_torch.utils import faults as fmod
from gravity_tpu_torch.utils.checkpoint import (
    make_checkpoint_manager,
    restore_checkpoint,
)
from gravity_tpu_torch.utils.faults import (
    BackendUnavailable,
    FaultPlan,
    TransientFault,
)


@pytest.fixture
def port_faults(monkeypatch):
    """Arms a plan in this process and for subprocesses; undone after."""

    def install(spec: str):
        monkeypatch.setenv(fmod.ENV_KNOB, spec)
        return fmod.install(spec)

    yield install
    fmod.reset()


def _cfg(**kw):
    base = dict(model="random", n=32, steps=30, dt=3600.0, seed=3,
                force_backend="dense", progress_every=10)
    base.update(kw)
    return SimulationConfig(**base)


def test_parse_spec_as_the_jax_package():
    spec = "diverge@20,transient@10x2,backend:pallas-mxu"
    plan, jax_plan = FaultPlan.parse(spec), JaxFaultPlan.parse(spec)
    for p in (plan, jax_plan):
        assert p.backend_down("pallas-mxu") and not p.backend_down("pallas")
    for args in ((10,), (15,), (99,)):
        assert plan.transient_due(*args) == jax_plan.transient_due(*args)
    for args in ((0, 19), (10, 20), (10, 20)):
        assert plan.corrupt_due(*args) == jax_plan.corrupt_due(*args)


def test_parse_rejects_garbage():
    with pytest.raises(ValueError):
        FaultPlan.parse("meteor@10")
    with pytest.raises(ValueError):
        FaultPlan.parse("diverge")


@pytest.mark.parametrize("item,roadmap", [
    ("crash_worker@3", None), ("stall_worker@2x5", None),
    ("stale_lease@1", None), ("torn_spool_write@0", None),
    ("drop_result_write@0", None), ("torn_progress_write@1", None),
    ("disk_full@0", None), ("mesh_fail@0x2", None),
    ("collective_stall@1x3", None),
])
def test_serving_and_mesh_items_are_refused(item, roadmap):
    """They parse in the JAX package and in the port alike, the serving
    items (tests/test_torch_serve_host.py fires them) and the mesh items
    (tests/test_torch_serve_sharded.py fires them): none is refused
    (``roadmap`` None for each), and each parses to the JAX package's
    kind, step and count."""
    assert roadmap is None
    theirs = JaxFaultPlan.parse(item)._faults
    ours = FaultPlan.parse(item)._faults
    assert [(f.kind, f.step, f.count) for f in ours] == \
        [(f.kind, f.step, f.count) for f in theirs]


@pytest.mark.parametrize("mode", ["off", "on"])
def test_injected_divergence_trips_watchdog(port_faults, tmp_path, mode):
    """diverge@20 NaNs the state so that the real watchdog raises, with the
    last finite state saved at the block boundary before it, serial or
    pipelined."""
    port_faults("diverge@20")
    mgr = make_checkpoint_manager(str(tmp_path / "ckpt"))
    sim = Simulator(_cfg(io_pipeline=mode), device="cpu")
    with pytest.raises(SimulationDiverged) as ei:
        sim.run(checkpoint_manager=mgr)
    assert ei.value.step == 10
    state, step = restore_checkpoint(mgr)
    assert step == 10 and bool(torch.isfinite(state.positions).all())


def test_injected_transient_raises(port_faults):
    port_faults("transient@10")
    with pytest.raises(TransientFault):
        Simulator(_cfg(), device="cpu").run()


def test_injected_backend_failure(port_faults):
    port_faults("backend:pallas-mxu")
    with pytest.raises(BackendUnavailable):
        Simulator(_cfg(force_backend="pallas-mxu"), device="cpu")
    Simulator(_cfg(force_backend="pallas"), device="cpu")
    Simulator(_cfg(force_backend="dense"), device="cpu")


def test_unsupervised_backend_failure_clean_cli_exit(port_faults, tmp_path,
                                                     capsys):
    port_faults("backend:dense")
    rc = main(["run", "--device", "cpu", "--model", "random", "--n", "16",
               "--steps", "5", "--force-backend", "dense",
               "--log-dir", str(tmp_path / "logs")])
    assert rc == 2
    err = capsys.readouterr().err
    assert json.loads(err.strip().splitlines()[-1])["error"] == \
        "backend_unavailable"


def test_no_injection_is_free(port_faults):
    ref = Simulator(_cfg(), device="cpu").run()["final_state"]
    port_faults("diverge@999,transient@999,preempt@999")
    out = Simulator(_cfg(), device="cpu").run()["final_state"]
    assert torch.equal(ref.positions, out.positions)


def test_env_knob_parsed_lazily(monkeypatch):
    monkeypatch.setenv(fmod.ENV_KNOB, "transient@0")
    fmod.reset()
    with pytest.raises(TransientFault):
        fmod.maybe_raise_transient(0)
    fmod.reset()
    monkeypatch.delenv(fmod.ENV_KNOB)
    fmod.maybe_raise_transient(0)  # no plan, no raise
    fmod.reset()


def test_accuracy_breach_grammar_fires_once():
    plan = FaultPlan.parse("accuracy_breach@20")
    assert not plan.breach_due(19)
    assert plan.breach_due(25)
    assert not plan.breach_due(30)


def test_divergence_due_fires_once_on_the_crossing_block():
    fmod.install("diverge@5")
    try:
        assert not fmod.divergence_due(5, 10)
        assert fmod.divergence_due(0, 5)
        assert not fmod.divergence_due(0, 5)
    finally:
        fmod.reset()
    assert not fmod.divergence_due(0, 10)


def test_maybe_corrupt_state_copies():
    """The injected NaN lands in a copy: the block's own tensors, which the
    pipeline may still hold, are left as they were."""
    state = Simulator(_cfg(), device="cpu").state
    fmod.install("diverge@5")
    try:
        out = fmod.maybe_corrupt_state(state, 0, 10)
    finally:
        fmod.reset()
    assert np.isnan(out.positions[0, 0].item())
    assert bool(torch.isfinite(state.positions).all())
