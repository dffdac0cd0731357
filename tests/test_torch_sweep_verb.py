"""The port's ``sweep`` verb (``gravity_tpu_torch/cli.py``) on the CPU.

Every size is a job on an in-process ensemble scheduler; the log keeps
the reference's sections for each size. Each size's final positions (the
last trajectory frame) equal the port's solo ``Simulator`` run of the
same config within 1e-6 of max |x| (fp32, the sweep pads to its bucket),
and the JAX package's ``Simulator`` fed the same initial state through
``interop.state_to_numpy`` within 1e-5. A config outside the ensemble
envelope, which ``batch_key_for`` refuses, takes the solo loop.
"""

import glob
import os

import numpy as np
import pytest

from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.simulation import Simulator as JaxSimulator
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch.cli import main
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.interop import state_to_numpy, to_numpy
from gravity_tpu_torch.simulation import Simulator, make_initial_state
from gravity_tpu_torch.utils.trajectory import TrajectoryReader

SIZES = (8, 16, 40)
FLAGS = dict(model="random", steps=5, dt=3600.0, integrator="leapfrog",
             force_backend="dense", progress_every=5)


def _log(log_dir) -> str:
    (path,) = glob.glob(os.path.join(log_dir, "simulation_log_*.txt"))
    return open(path).read()


def test_sweep_command(tmp_path):
    """``sweep --sizes 8 16 --steps 5``: exit 0 and the reference's log
    sections for each size."""
    log_dir = str(tmp_path / "logs")
    rc = main(["sweep", "--device", "cpu", "--sizes", "8", "16", "--steps",
               "5", "--force-backend", "dense", "--log-dir", log_dir])
    assert rc == 0
    text = _log(log_dir)
    for n in (8, 16):
        assert f"Starting gravity simulation with {n} particles" in text
    assert text.count("Performance Statistics:") == 2
    assert text.count("Final positions:") == 2
    assert "Ensemble sweep: 2 jobs" in text
    assert text.rstrip().endswith("Simulation completed successfully")


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """The sweep's final positions by size, from its trajectories."""
    log_dir = str(tmp_path_factory.mktemp("sweep") / "logs")
    argv = ["sweep", "--device", "cpu", "--sizes", *map(str, SIZES),
            "--trajectories", "--log-dir", log_dir]
    for k, v in FLAGS.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    assert main(argv) == 0
    out = {}
    for n in SIZES:
        (path,) = glob.glob(os.path.join(log_dir, f"trajectories_*_n{n}"))
        reader = TrajectoryReader(path)
        assert reader.steps[-1] == FLAGS["steps"]
        out[n] = np.asarray(reader.load()[-1])
    return out


@pytest.mark.parametrize("n", SIZES)
def test_sweep_sizes_equal_the_solo_runs(swept, n):
    """Each size against the port's solo run and the JAX package's run of
    the same initial state."""
    config = SimulationConfig(n=n, **FLAGS)
    state = make_initial_state(config, "cpu")
    solo = Simulator(config, state=state, device="cpu").run()
    want = to_numpy(solo["final_state"].positions)
    scale = np.abs(want).max()
    assert np.abs(swept[n] - want).max() <= 1e-6 * scale
    pos, vel, m = state_to_numpy(state)
    ref = JaxSimulator(JaxConfig(n=n, **FLAGS),
                       state=JaxState.create(pos, vel, m)).run()
    assert np.abs(swept[n] - np.asarray(
        ref["final_state"].positions)).max() <= 1e-5 * scale


def test_sweep_outside_the_envelope_runs_solo(tmp_path):
    """``--adaptive`` is outside the ensemble envelope: batch_key_for
    refuses it, and the sizes run one Simulator after another."""
    log_dir = str(tmp_path / "logs")
    rc = main(["sweep", "--device", "cpu", "--sizes", "8", "12", "--steps",
               "5", "--force-backend", "dense", "--adaptive", "--log-dir",
               log_dir])
    assert rc == 0
    text = _log(log_dir)
    assert "ensemble sweep unavailable for this config" in text
    assert "adaptive" in text.split("unavailable")[1].splitlines()[0]
    for n in (8, 12):
        assert f"Starting gravity simulation with {n} particles" in text
    assert text.count("Final positions:") == 2
    assert "Ensemble sweep" not in text
    assert text.rstrip().endswith("Simulation completed successfully")
