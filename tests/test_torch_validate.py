"""The port's ``validate`` verb (``gravity_tpu_torch/validate.py``)
against the JAX package's (``gravity_tpu/cli.py`` ``cmd_validate`` with
``--tpu``), on the CPU at the JAX battery's off-chip sizes.

The JAX battery runs once for the module. The port's runs once through
its CLI (``validate --device cpu --gpu``) on the JAX package's own draws
(``create_model(name, PRNGKey(seed), n)``, carried over as numpy through
``interop.py``), so that both packages hold the same states. Tolerances:

- the landing and the merge errors: 1e-9 absolute (both exact here);
- leapfrog's endpoint error on the two-body orbit: 1e-3 relative (the
  same float32 steps);
- yoshida4's endpoint error: 4 float32 ulps of the orbit's radius (16 km
  an ulp at 1.5e11 m). It sits at float32's rounding floor, which the
  JAX battery's own comment names (~2e4 m), so the two packages' sums,
  rounded in other orders, land on different ulps of it;
- the year's closure: 1e-2 relative in float32, where 8,766 steps of
  rounding walk the end point by ~1e6 m of its 9.6e8 m (measured
  2.6e-3 apart), and 1e-6 relative in float64, where they agree to the
  truncation error (a test of its own);
- leapfrog's energy drift: both under the bar and 1e-6 apart (their
  values, 3e-7 to 7e-7, are a few float32 epsilons of the energy);
- the octree's, both FMMs' and the potential's errors, which the
  algorithm sets: 5% relative;
- the kernel records, whose errors are the rounding of one sum against
  another (0 for the port's CPU route, which is the plain version):
  under 1e-5; the Gram form's bf16 record 5% relative.
"""

import argparse
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu import cli as jax_cli
from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.models import create_model as jax_create_model
from gravity_tpu.simulation import Simulator as JaxSimulator
from gravity_tpu_torch import validate
from gravity_tpu_torch.cli import main as cli_main
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy
from gravity_tpu_torch.simulation import Simulator

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_draw(device):
    """The JAX package's draws, on ``device`` as the port's states."""

    def draw(model, n, seed):
        st = jax_create_model(model, jax.random.PRNGKey(seed), n,
                              jnp.float32)
        return state_from_numpy(np.asarray(st.positions),
                                np.asarray(st.velocities),
                                np.asarray(st.masses), device=device)

    return draw


def run_port(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["validate", *argv])
    return rc, json.loads(out.getvalue())


@pytest.fixture(scope="module")
def batteries():
    """(JAX report, the port's report and exit code) of the battery with
    the on-chip gate, once for the module."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_rc = jax_cli.cmd_validate(argparse.Namespace(tpu=True))
    jax_report = json.loads(out.getvalue())
    assert jax_rc == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(validate, "default_draw", jax_draw)
        rc, port = run_port(["--device", "cpu", "--gpu"])
    return jax_report, port, rc


def test_records_are_the_jax_batterys_mapped_to_gpu(batteries):
    jax_report, port, rc = batteries
    assert list(port["checks"]) == [k.replace("tpu_", "gpu_")
                                    for k in jax_report["checks"]]
    assert len(port["checks"]) == 17
    assert rc == 0 and port["ok"] is True
    assert all(c["ok"] for c in port["checks"].values())
    assert set(port["checks"]["gpu_2m_direct_3step"]) == \
        set(jax_report["checks"]["tpu_2m_direct_3step"]) == {"skipped", "ok"}


def test_deterministic_checks_agree(batteries):
    jax_report, port, _ = batteries
    j, p = jax_report["checks"], port["checks"]
    for name, key in (("adaptive_t_landing", "rel_err"),
                      ("merge_conservation", "mass_err"),
                      ("merge_conservation", "momentum_err")):
        assert abs(p[name][key] - j[name][key]) <= 1e-9, name
    lf = ("yoshida4_vs_leapfrog", "leapfrog_err_m")
    assert p[lf[0]][lf[1]] == pytest.approx(j[lf[0]][lf[1]], rel=1e-3)
    ulp = float(np.spacing(np.float32(1.496e11)))
    y4 = ("yoshida4_vs_leapfrog", "yoshida4_err_m")
    assert abs(p[y4[0]][y4[1]] - j[y4[0]][y4[1]]) <= 4 * ulp
    cl = ("earth_year_closure", "rel_closure_err")
    assert p[cl[0]][cl[1]] == pytest.approx(j[cl[0]][cl[1]], rel=1e-2)
    dr = ("leapfrog_energy_drift", "drift")
    assert abs(p[dr[0]][dr[1]] - j[dr[0]][dr[1]]) <= 1e-6


@pytest.mark.parametrize("name,key", [
    ("gpu_tree_parity", "median_rel_err"),
    ("gpu_fmm_parity", "median_rel_err"),
    ("gpu_fmm_potential", "rel_err"),
    ("gpu_fmm_parity_cold", "median_rel_err"),
    ("gpu_sfmm_parity_disk", "median_rel_err"),
    ("gpu_pallas_mxu_bf16_parity", "median_rel_err"),
])
def test_solver_errors_agree_within_5_percent(batteries, name, key):
    jax_report, port, _ = batteries
    ours = port["checks"][name][key]
    theirs = jax_report["checks"][name.replace("gpu_", "tpu_")][key]
    assert ours == pytest.approx(theirs, rel=0.05)
    if name == "gpu_sfmm_parity_disk":
        rec = jax_report["checks"]["tpu_sfmm_parity_disk"]
        assert (port["checks"][name]["depth"], port["checks"][name]["cap"]) \
            == (rec["depth"], rec["cap"])


@pytest.mark.parametrize("name", [
    "kernel_cross_check", "gpu_pallas_parity", "gpu_pallas_mxu_parity",
    "gpu_sharded_mesh1"])
def test_kernel_records_are_rounding_and_name_the_plain_route(batteries,
                                                              name):
    jax_report, port, _ = batteries
    rec = port["checks"][name]
    assert rec["median_rel_err"] < 1e-5
    assert jax_report["checks"][name.replace("gpu_", "tpu_")][
        "median_rel_err"] < 1e-5
    # On the CPU the wrapper is the plain version: no launch, and the
    # record says so (on the card a record without launches fails).
    assert rec["route"] == "plain" and rec["launches"] == 0


def test_bench_record_is_the_cpu_liveness_bar(batteries):
    _, port, _ = batteries
    rec = port["checks"]["gpu_bench_5step"]
    assert rec["n"] == 2048 and rec["platform"] == "cpu"
    assert rec["bar"] == validate.CPU_BENCH_BAR == 1.0e6
    assert rec["pairs_per_sec_per_chip"] > rec["bar"]


def test_validate_without_the_gate_exits_0():
    rc, report = run_port(["--device", "cpu"])
    assert rc == 0 and report["ok"] is True
    assert list(report["checks"]) == [
        "kernel_cross_check", "earth_year_closure", "leapfrog_energy_drift",
        "yoshida4_vs_leapfrog", "adaptive_t_landing", "merge_conservation"]


@pytest.mark.parametrize("argv", [["--gpu"], []])
def test_no_card_raises_and_never_shrinks_to_the_cpu(monkeypatch, argv):
    """Without --device cpu the battery needs the card: it raises, it does
    not run at the CPU sizes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_port(argv)


def test_rate_bars_are_half_the_cards_kernel_table_rates():
    assert validate.GPU_BENCH_BAR == pytest.approx(8.97e11, rel=1e-3)
    assert validate.GPU_2M_BAR == pytest.approx(9.54e11, rel=1e-3)


def test_year_closure_agrees_in_float64():
    """The same closure in float64 in both packages: the truncation error
    of 8,766 leapfrog steps, which the two compute alike."""
    kw = dict(model="solar", n=3, steps=8766, dt=3600.0,
              integrator="leapfrog", force_backend="dense", dtype="float64")
    sim = Simulator(SimulationConfig(**kw), device="cpu")
    start = sim.state.positions[1].numpy()
    final = sim.run()["final_state"].positions[1].numpy()
    port = np.linalg.norm(final - start) / np.linalg.norm(start)
    with jax.enable_x64(True):
        jsim = JaxSimulator(JaxConfig(**kw))
        j0 = np.asarray(jsim.state.positions[1])
        j1 = np.asarray(jsim.run()["final_state"].positions[1])
    theirs = np.linalg.norm(j1 - j0) / np.linalg.norm(j0)
    assert port == pytest.approx(theirs, rel=1e-6)


def test_port_draw_disk_records_miss_as_the_jax_package_does():
    """With the port's own draw (torch seed 2) at the off-chip size the
    data-driven depth is 4, where the octree misses its 0.05 bar: the JAX
    package's octree misses it alike on the same state (0.113 both), so
    the CPU tests above feed the JAX draws."""
    from gravity_tpu.ops import tree as jax_tree
    from gravity_tpu.ops.forces import pairwise_accelerations_chunked as jref
    from gravity_tpu_torch.ops import tree
    from gravity_tpu_torch.ops.forces import pairwise_accelerations_chunked

    disk = validate.default_draw(CPU)("disk", 2048, 2)
    pos, m = disk.positions, disk.masses
    jp, jm = jnp.asarray(pos.numpy()), jnp.asarray(m.numpy())
    depth = tree.recommended_depth_data(pos)
    assert depth == jax_tree.recommended_depth_data(jp) == 4
    ours = validate._rel_err(
        tree.tree_accelerations(pos, m, depth=depth, g=1.0, eps=0.05),
        pairwise_accelerations_chunked(pos, m, chunk=2048, g=1.0, eps=0.05))
    theirs = validate._rel_err(
        torch.from_numpy(np.array(jax_tree.tree_accelerations(
            jp, jm, depth=depth, g=1.0, eps=0.05))),
        torch.from_numpy(np.array(jref(jp, jm, chunk=2048, g=1.0,
                                       eps=0.05))))
    assert ours == pytest.approx(theirs, rel=0.05)
    assert ours > 0.05 and theirs > 0.05
