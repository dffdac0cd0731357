"""The port's Simulator and CLI against the JAX package, on the CPU.

Both packages integrate the same numpy initial state: the port's state
comes from ``interop.state_from_numpy``, the JAX one from the same
arrays. Tolerances are per particle, on the position and velocity
vectors: fp32 rtol 1e-5 (20 steps of float32 arithmetic in two summation
orders), fp64 rtol 1e-12 against tests/reference_oracle.py.
"""

import dataclasses
import glob
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_oracle
from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.simulation import Simulator as JaxSimulator
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu.utils.trajectory import TrajectoryReader as JaxReader
from gravity_tpu_torch.config import PRESETS, SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy, state_to_numpy
from gravity_tpu_torch.ops import host_kernel
from gravity_tpu_torch.simulation import (
    SimulationDiverged,
    Simulator,
    _resolve_backend,
)
from gravity_tpu_torch.utils.logging import RunLogger
from gravity_tpu_torch.utils.trajectory import TrajectoryReader, TrajectoryWriter

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _initial_state(model, n, seed=2, dtype=np.float32):
    if model == "solar":
        pos = np.array([[0, 0, 0], [1.496e11, 0, 0], [2.279e11, 0, 0]])
        vel = np.array([[0, 0, 0], [0, 29.78e3, 0], [0, 24.077e3, 0]])
        masses = np.array([1.989e30, 5.972e24, 6.39e23])
    else:
        rng = np.random.default_rng(seed)
        pos = rng.uniform(-3e11, 3e11, (n, 3))
        vel = rng.uniform(-3e4, 3e4, (n, 3))
        masses = rng.uniform(1e23, 1e25, n)
        pos[:3], vel[:3], masses[:3] = _initial_state("solar", 3)
    return pos.astype(dtype), vel.astype(dtype), masses.astype(dtype)


def _rows_close(got, want, rtol):
    err = np.linalg.norm(np.asarray(got, np.float64) - want, axis=1)
    scale = np.linalg.norm(np.asarray(want, np.float64), axis=1)
    assert np.all(err <= rtol * scale), float(np.max(err / scale))


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("model,n", [("solar", 3), ("random", 64)])
def test_matches_jax_simulator(model, n, integrator):
    pos, vel, masses = _initial_state(model, n)
    jax_cfg = JaxConfig(model=model, n=n, steps=20, integrator=integrator,
                        force_backend="dense", progress_every=10)
    jax_final = JaxSimulator(
        jax_cfg,
        state=JaxState(jnp.asarray(pos), jnp.asarray(vel),
                       jnp.asarray(masses)),
    ).run()["final_state"]

    cfg = SimulationConfig(model=model, n=n, steps=20,
                           integrator=integrator, progress_every=10)
    sim = Simulator(cfg, state_from_numpy(pos, vel, masses, device="cpu"),
                    device="cpu")
    assert sim.backend == "dense"
    stats = sim.run()
    got_pos, got_vel, got_m = state_to_numpy(stats["final_state"])
    _rows_close(got_pos, np.asarray(jax_final.positions), 1e-5)
    _rows_close(got_vel, np.asarray(jax_final.velocities), 1e-5)
    np.testing.assert_array_equal(got_m, masses)
    assert stats["steps"] == 20 and stats["kernel_launches"] == 0


def test_fp64_matches_reference_oracle():
    pos, vel, masses = _initial_state("random", 8, dtype=np.float64)
    cfg = dataclasses.replace(PRESETS["reference-mpi"], steps=20,
                              dtype="float64")
    final = Simulator(
        cfg, state_from_numpy(pos, vel, masses, dtype=torch.float64,
                              device="cpu"),
        device="cpu",
    ).run()["final_state"]
    want_pos, want_vel = reference_oracle.simulate(pos, vel, masses,
                                                   cfg.dt, 20)
    got_pos, got_vel, _ = state_to_numpy(final)
    _rows_close(got_pos, want_pos, 1e-12)
    _rows_close(got_vel, want_vel, 1e-12)


def test_log_has_reference_sections_and_trajectories(tmp_path):
    """The reference log contract, and .npy trajectories that the JAX
    package's own reader reads back."""
    cfg = dataclasses.replace(PRESETS["reference-spark"], n=40, steps=12,
                              progress_every=4, trajectory_every=2)
    sim = Simulator(cfg, device="cpu")
    logger = RunLogger(str(tmp_path), quiet=True)
    writer = TrajectoryWriter(str(tmp_path / "traj"), sim.n_real)
    stats = sim.run(logger, trajectory_writer=writer)
    log = open(logger.path).read()
    for section in ("Starting CPU gravity simulation at", "Device: cpu",
                    "Number of particles: 40", "Step 4/12", "Step 12/12",
                    "Performance Statistics:", "Final positions:",
                    "Particle 0: (", "Simulation completed successfully"):
        assert section in log
    kinds = [e["event"] for e in logger.events.read()]
    assert kinds[0] == "banner" and kinds[-1] == "completed"
    assert kinds.count("progress") == 3

    jax_reader = JaxReader(str(tmp_path / "traj"))
    frames = jax_reader.load()
    assert jax_reader.steps == [2, 4, 6, 8, 10, 12]
    assert frames.shape == (6, 40, 3)
    np.testing.assert_array_equal(
        frames, TrajectoryReader(str(tmp_path / "traj")).load()
    )
    np.testing.assert_array_equal(
        frames[-1], stats["final_state"].positions.numpy()
    )


def test_divergence_watchdog_raises():
    pos, vel, masses = _initial_state("random", 8)
    pos[5, 0] = np.nan
    sim = Simulator(SimulationConfig(n=8, steps=10, progress_every=5),
                    state_from_numpy(pos, vel, masses, device="cpu"),
                    device="cpu")
    with pytest.raises(SimulationDiverged) as info:
        sim.run()
    assert info.value.step == 0


def test_backend_resolution():
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    for backend in ("auto", "direct", "pallas"):
        cfg = SimulationConfig(n=50_000, force_backend=backend)
        assert _resolve_backend(cfg, cuda) == "nbody_direct"
    assert _resolve_backend(SimulationConfig(n=64), cuda) == "nbody_direct"
    assert _resolve_backend(SimulationConfig(n=4096), cpu) == "dense"
    # Above DENSE_MAX_N the CPU takes the host-native C++ direct sum where
    # it builds, as the JAX package does.
    assert _resolve_backend(SimulationConfig(n=4097), cpu) == (
        "cpp" if host_kernel.host_forces_available() else "chunked")
    assert _resolve_backend(
        SimulationConfig(force_backend="pallas"), cpu
    ) == "nbody_direct"
    assert _resolve_backend(
        SimulationConfig(force_backend="chunked"), cuda
    ) == "chunked"


def test_cli_run_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "gravity_tpu_torch", "run", "--device", "cpu",
         "--preset", "reference-mpi", "--steps", "20",
         "--log-dir", str(tmp_path)],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["n"] == 8 and stats["steps"] == 20
    assert stats["backend"] == "dense" and stats["device"] == "cpu"
    logs = glob.glob(str(tmp_path / "simulation_log_*.txt"))
    assert len(logs) == 1
    assert "Simulation completed successfully" in open(logs[0]).read()
