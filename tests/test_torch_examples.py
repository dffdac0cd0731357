"""The port's examples (``gravity_tpu_torch/examples/``) run end to end
on the CPU at ``tests/test_examples.py``'s sizes, in this process with
``--device cpu``, and print the JAX examples' markers. The two that file
marks slow are slow here too."""

import contextlib
import glob
import importlib
import io
import json

import pytest
import torch

from gravity_tpu_torch.cli import main as cli_main


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run(name, *argv, device=True):
    module = importlib.import_module(f"gravity_tpu_torch.examples.{name}")
    out = io.StringIO()
    args = [*argv, "--device", "cpu"] if device else list(argv)
    with contextlib.redirect_stdout(out):
        rc = module.main(args)
    return rc, out.getvalue()


def test_solar_system_example():
    rc, out = run("solar_system", "--steps-per-day", "2")
    assert rc == 0 and "closure error" in out


def test_galaxy_merger_example():
    rc, out = run("galaxy_merger", "--n", "512", "--steps", "10",
                  "--backend", "chunked")
    assert rc == 0 and "energy drift" in out


@pytest.mark.slow
def test_cosmology_example():
    rc, out = run("cosmology", "--steps", "20")
    assert rc == 0 and "GROWTH OK" in out


@pytest.mark.slow
def test_field_probe_example():
    rc, out = run("field_probe", "--n", "2048", "--grid", "8")
    assert rc == 0 and "rotation curve" in out and "OK" in out


def test_gradient_orbit_fit_example():
    """A thin client of serve/jobs/fit.py: the default path starts a real
    daemon, submits the fit as a served job and checks the result against
    the solo reference."""
    rc, out = run("gradient_orbit_fit", "--iters", "120", "--steps", "30")
    assert rc == 0 and "FIT OK" in out
    assert "[served" in out, out


def test_gradient_orbit_fit_example_solo():
    rc, out = run("gradient_orbit_fit", "--iters", "120", "--steps", "30",
                  "--solo")
    assert rc == 0 and "FIT OK" in out and "[solo]" in out


@pytest.mark.parametrize("fmt", ["npy", "native"])
def test_plot_trajectory_example(tmp_path, fmt):
    pytest.importorskip("matplotlib")
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli_main([
            "run", "--device", "cpu", "--model", "random", "--n", "16",
            "--steps", "5", "--force-backend", "dense", "--trajectories",
            "--trajectory-format", fmt, "--log-dir", str(tmp_path / "logs"),
        ]) == 0
    pattern = "*.gtrj" if fmt == "native" else "trajectories_*"
    (path,) = glob.glob(str(tmp_path / "logs" / pattern))
    rc, out = run("plot_trajectory", path, "--out", str(tmp_path / "p.png"),
                  device=False)
    assert rc == 0 and (tmp_path / "p.png").stat().st_size > 0


def test_star_cluster_example():
    rc, out = run("star_cluster", "--n", "128", "--steps", "10")
    assert rc == 0
    rep = json.loads(out.strip().splitlines()[-1])
    # The block-timestep schemes beat single-rate by a wide margin at one
    # full force evaluation an outer step.
    assert rep["drift_two_rung"] < rep["drift_single_rate"] / 10
    assert rep["drift_ladder_r3"] < rep["drift_single_rate"] / 10


def test_examples_need_a_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("solar_system", "--steps-per-day", "2", device=False)
