"""The port's host pipeline (``Simulator.run`` with ``io_pipeline``) on the
CPU, mirroring ``tests/test_io_pipeline.py``: the pipelined and serial
loops write the same trajectory, checkpoint and final-state bytes; the
pipelined watchdog reads its verdict a block late and says the same; a
preempted pipelined run saves its last consumed block and resumes to the
uninterrupted run's state bit for bit; a writer failure fails the run;
``on`` with merging raises and ``auto`` degrades; the metrics stream
names its pair rate by backend. Also: the pipeline consumes a block by
its own completion fence (``_Block.wait``), never the device-wide
synchronize, and the trajectory writer's thread gets numpy arrays only.
"""

import os

import numpy as np
import pytest
import torch

from gravity_tpu_torch import simulation
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.simulation import (
    SimulationDiverged,
    SimulationPreempted,
    Simulator,
)
from gravity_tpu_torch.supervisor import RunSupervisor
from gravity_tpu_torch.utils import faults as fmod
from gravity_tpu_torch.utils.checkpoint import (
    make_checkpoint_manager,
    restore_checkpoint,
)
from gravity_tpu_torch.utils.profiling import MetricsLogger
from gravity_tpu_torch.utils.trajectory import (
    NativeTrajectoryReader,
    NativeTrajectoryWriter,
    TrajectoryReader,
    TrajectoryWriter,
)


@pytest.fixture
def port_faults(monkeypatch):
    def install(spec: str):
        monkeypatch.setenv(fmod.ENV_KNOB, spec)
        return fmod.install(spec)

    yield install
    fmod.reset()


def _cfg(mode, **kw):
    base = dict(model="plummer", n=48, steps=60, dt=3600.0, eps=1e9, seed=5,
                integrator="leapfrog", force_backend="dense",
                progress_every=10, trajectory_every=2, checkpoint_every=20,
                io_pipeline=mode)
    base.update(kw)
    return SimulationConfig(**base)


def _run(root, mode, native=False, **kw):
    cfg = _cfg(mode, **kw)
    if native:
        writer = NativeTrajectoryWriter(os.path.join(root, "t.gtrj"), cfg.n)
    else:
        writer = TrajectoryWriter(os.path.join(root, "traj"), cfg.n,
                                  every=1, flush_every=4)
    mgr = make_checkpoint_manager(os.path.join(root, "ckpt"), max_to_keep=10)
    sim = Simulator(cfg, device="cpu")
    stats = sim.run(trajectory_writer=writer, checkpoint_manager=mgr,
                    metrics_logger=MetricsLogger(os.path.join(root, "m.jsonl")))
    return sim, stats


def _bytes(t):
    return t.contiguous().numpy().tobytes()


@pytest.mark.parametrize("native", [False, True])
def test_sync_async_artifacts_bitwise_identical(tmp_path, native):
    sim_off, st_off = _run(str(tmp_path / "off"), "off", native)
    sim_on, st_on = _run(str(tmp_path / "on"), "on", native)
    assert (st_off["io_pipeline"], st_on["io_pipeline"]) == ("off", "on")
    assert st_off["host_gap_frac"] is not None
    assert st_on["host_gap_frac"] is not None
    for leaf in ("positions", "velocities", "masses"):
        assert _bytes(getattr(sim_off.final_state(), leaf)) == \
            _bytes(getattr(sim_on.final_state(), leaf))
    if native:
        assert open(tmp_path / "off" / "t.gtrj", "rb").read() == \
            open(tmp_path / "on" / "t.gtrj", "rb").read()
        assert NativeTrajectoryReader(
            str(tmp_path / "on" / "t.gtrj")).steps == list(range(2, 61, 2))
    else:
        t_off = TrajectoryReader(str(tmp_path / "off" / "traj"))
        t_on = TrajectoryReader(str(tmp_path / "on" / "traj"))
        assert t_off.steps == t_on.steps == list(range(2, 61, 2))
        assert t_off.load(mmap=False).tobytes() == \
            t_on.load(mmap=False).tobytes()
        assert t_off.manifest == t_on.manifest
    m_off = make_checkpoint_manager(str(tmp_path / "off" / "ckpt"))
    m_on = make_checkpoint_manager(str(tmp_path / "on" / "ckpt"))
    assert m_off.all_steps() == m_on.all_steps() == [20, 40, 60]
    for s in m_off.all_steps():
        a, _ = restore_checkpoint(m_off, s)
        b, _ = restore_checkpoint(m_on, s)
        for leaf in ("positions", "velocities", "masses"):
            assert _bytes(getattr(a, leaf)) == _bytes(getattr(b, leaf)), s


def test_pipelined_watchdog_lags_one_block_same_verdict(port_faults,
                                                        tmp_path):
    """The verdict of block (10, 20] is read while (20, 30] is in flight;
    it names the same last finite step and saves the same snapshot as the
    serial loop."""
    port_faults("diverge@20")
    mgr = make_checkpoint_manager(str(tmp_path / "ckpt"))
    sim = Simulator(_cfg("on", checkpoint_every=0), device="cpu")
    with pytest.raises(SimulationDiverged) as ei:
        sim.run(checkpoint_manager=mgr)
    assert ei.value.step == 10 and sim._last_step == 10
    state, step = restore_checkpoint(mgr)
    assert step == 10 and bool(torch.isfinite(state.positions).all())
    fmod.reset()
    port_faults("diverge@20")
    serial = Simulator(_cfg("off", checkpoint_every=0), device="cpu")
    mgr2 = make_checkpoint_manager(str(tmp_path / "ckpt2"))
    with pytest.raises(SimulationDiverged):
        serial.run(checkpoint_manager=mgr2)
    state2, _ = restore_checkpoint(mgr2)
    assert torch.equal(state.positions, state2.positions)


def test_pipelined_preempt_saves_consumed_step_and_resumes(port_faults,
                                                           tmp_path):
    """A real SIGTERM mid-pipeline: the last consumed block is saved (the
    block in flight is dropped), and a resume from it ends bit for bit
    where the uninterrupted run ends."""
    truth = Simulator(_cfg("on"), device="cpu").run()["final_state"]
    port_faults("preempt@30")
    mgr = make_checkpoint_manager(str(tmp_path / "ckpt"))
    sim = Simulator(_cfg("on"), device="cpu")
    with pytest.raises(SimulationPreempted):
        sim.run(checkpoint_manager=mgr)
    state, step = restore_checkpoint(mgr)
    assert step == 30 == sim._last_step
    stats = Simulator(_cfg("on"), state=state, device="cpu").run(
        start_step=step, checkpoint_manager=mgr)
    assert stats["steps"] == 60 - step
    assert torch.equal(stats["final_state"].positions, truth.positions)
    assert torch.equal(stats["final_state"].velocities, truth.velocities)


def test_supervised_divergence_heals_with_pipeline_on(port_faults, tmp_path):
    port_faults("diverge@20")
    cfg = _cfg("on", auto_recover=True, checkpoint_dir=str(tmp_path / "ck"))
    sup = RunSupervisor(cfg, device="cpu")
    stats = sup.run()
    assert tuple(stats["final_state"].positions.shape) == (48, 3)
    assert sup.diverge_retries == 1 and stats["io_pipeline"] == "on"


def test_writer_failure_fails_the_run(tmp_path, monkeypatch):
    """A background checkpoint save that throws surfaces on the main
    thread and fails the run."""
    calls = []

    def boom(manager, step, state, **kw):
        calls.append(step)
        raise OSError("disk full (injected)")

    monkeypatch.setattr(simulation, "save_checkpoint", boom)
    mgr = make_checkpoint_manager(str(tmp_path / "ckpt"))
    sim = Simulator(_cfg("on"), device="cpu")
    with pytest.raises(OSError, match="disk full"):
        sim.run(checkpoint_manager=mgr)
    assert calls == [20]


def test_io_pipeline_on_rejects_merging():
    with pytest.raises(ValueError, match="merging"):
        Simulator(_cfg("on", merge_radius=1e9), device="cpu").run()


def test_io_pipeline_auto_degrades_for_merging():
    stats = Simulator(_cfg("auto", merge_radius=1.0, checkpoint_every=0),
                      device="cpu").run()
    assert stats["io_pipeline"] == "off"


def test_io_pipeline_rejects_bad_mode():
    with pytest.raises(ValueError, match="io_pipeline"):
        _cfg("sometimes")


@pytest.mark.parametrize("backend,key", [
    ("dense", "pairs_per_sec"), ("pallas", "pairs_per_sec"),
    ("tree", "dense_equiv_pairs_per_sec")])
def test_metrics_pairs_rate_named_by_backend(tmp_path, backend, key):
    ml = MetricsLogger(str(tmp_path / f"metrics_{backend}.jsonl"))
    cfg = _cfg("on", force_backend=backend, checkpoint_every=0, n=64,
               steps=20, progress_every=10)
    Simulator(cfg, device="cpu").run(metrics_logger=ml)
    records = ml.read()
    assert [r["step"] for r in records] == [10, 20]
    assert all(key in r and r["block_steps"] == 10 for r in records)
    other = ({"pairs_per_sec", "dense_equiv_pairs_per_sec"} - {key}).pop()
    assert all(other not in r for r in records)


def test_pipeline_waits_on_each_blocks_own_fence(monkeypatch):
    """A block is consumed through its own _Block.wait, once a block, and
    the loop never calls the device-wide sync between blocks (a
    torch.cuda.synchronize there would wait for the block in flight)."""
    waits, syncs = [], []
    real_wait = simulation._Block.wait

    def wait(self):
        waits.append(self.end_step)
        return real_wait(self)

    monkeypatch.setattr(simulation._Block, "wait", wait)
    monkeypatch.setattr(simulation, "sync", lambda d: syncs.append(d))
    Simulator(_cfg("on", checkpoint_every=0), device="cpu").run()
    assert waits == [10, 20, 30, 40, 50, 60]
    assert len(syncs) == 2  # before the timed loop and after it


def test_the_writer_thread_gets_numpy_frames(tmp_path):
    seen = []

    class Probe:
        def record(self, step, positions):
            seen.append((step, type(positions)))

        def close(self):
            pass

    Simulator(_cfg("on", checkpoint_every=0), device="cpu").run(
        trajectory_writer=Probe())
    assert [s for s, _ in seen] == list(range(2, 61, 2))
    assert {t for _, t in seen} == {np.ndarray}


def test_initial_state_is_private_to_the_pipeline():
    """The pipeline works on a copy of the caller's state: the caller's
    tensors are untouched and still readable after the run."""
    sim = Simulator(_cfg("on", checkpoint_every=0), device="cpu")
    x0 = sim.state.positions
    before = x0.clone()
    sim.run()
    assert torch.equal(x0, before) and sim.state.positions is not x0


def test_host_gap_frac_reported_in_both_modes(tmp_path):
    for mode in ("on", "off"):
        _, stats = _run(str(tmp_path / mode), mode)
        assert 0.0 <= stats["host_gap_frac"] <= 1.0
