"""Periodic Simulator runs of the port against the JAX package, on the
CPU, and the periodic family's routing, refusals and perf-ledger rows.

One numpy state (a fp64 grf realization made by the JAX package) goes
through both Simulators: ``pm`` leapfrog, the minimum-image cell list and
multirate through ``pm``, 10 steps each. Final positions within 1e-9 of
the box, the mesh energy and the conservation ledger within 1e-9
relative.
"""

import json
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.models import create_grf as jax_create_grf
from gravity_tpu.serve.engine import batch_key_for as jax_batch_key_for
from gravity_tpu.simulation import Simulator as JaxSimulator
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch import cli
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy
from gravity_tpu_torch.ops import nlist
from gravity_tpu_torch.serve.engine import batch_key_for
from gravity_tpu_torch.simulation import Simulator, _resolve_backend
from gravity_tpu_torch.telemetry import perf

BOX = 1.0e13
CPU = torch.device("cpu")

RUNS = {
    "pm": dict(force_backend="pm", pm_grid=16, eps=3e11),
    "nlist": dict(force_backend="nlist", nlist_rcut=BOX / 4, nlist_side=3,
                  nlist_cap=64, eps=3e11),
    "pm_multirate": dict(force_backend="pm", pm_grid=16, eps=3e11,
                         integrator="multirate", multirate_k=64),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _grf_arrays():
    st = jax_create_grf(jax.random.PRNGKey(3), 8**3, box=BOX,
                        sigma_psi=0.02, vel_factor=1e-3, total_mass=1e36,
                        dtype=jnp.float64)
    return tuple(np.asarray(a) for a in (st.positions, st.velocities,
                                         st.masses))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_periodic_runs_match_jax(name, x64):
    arrays = _grf_arrays()
    fields = dict(model="grf", n=8**3, steps=10, dt=5e4,
                  integrator="leapfrog", periodic_box=BOX, dtype="float64",
                  progress_every=5, ledger=True)
    fields.update(RUNS[name])
    jsim = JaxSimulator(JaxConfig(**fields),
                        state=JaxState(*(jnp.asarray(a) for a in arrays)))
    want = jsim.run()
    sim = Simulator(SimulationConfig(**fields),
                    state=state_from_numpy(*arrays, dtype=torch.float64,
                                           device="cpu"),
                    device="cpu")
    got = sim.run()
    final = got["final_state"].positions.numpy()
    assert final.min() >= 0 and final.max() < BOX
    gap = final - np.asarray(want["final_state"].positions)
    gap = gap - BOX * np.round(gap / BOX)
    assert np.abs(gap).max() < 1e-9 * BOX
    assert got["kernel_launches"] == 0
    assert float(sim.energy()) == pytest.approx(float(jsim.energy()),
                                                rel=1e-9)
    full_gravity = RUNS[name]["force_backend"] == "pm"
    assert got["ledger"]["pe_kind"] == ("pm" if full_gravity else "dense")
    assert got["ledger"]["com_drift"] is want["ledger"]["com_drift"] is None
    assert got["ledger"]["energy_drift"] == pytest.approx(
        want["ledger"]["energy_drift"], rel=1e-6, abs=1e-12)
    assert got["total_energy"] == pytest.approx(want["total_energy"],
                                                rel=1e-9)


def test_routing_refusals_and_serving(recwarn):
    """auto in a box: nlist with an rcut, else pm, with no autotune probe;
    every other backend refused with the JAX package's message; the serve
    engine refuses a periodic config as the JAX engine does; the sentinel
    is off for full periodic gravity."""
    base = dict(model="grf", n=64, periodic_box=BOX)
    assert _resolve_backend(SimulationConfig(**base), CPU) == "pm"
    assert _resolve_backend(SimulationConfig(nlist_rcut=BOX / 4, **base),
                            CPU) == "nlist"
    sim = Simulator(SimulationConfig(**base), device="cpu")
    assert sim.backend == "pm" and sim.autotune == {"cache": "off",
                                                    "probe_ms": 0.0}
    for backend in ("tree", "p3m", "dense", "fmm"):
        with pytest.raises(ValueError, match="periodic-capable solver"):
            Simulator(SimulationConfig(force_backend=backend, **base),
                      device="cpu")
    cfg = SimulationConfig(model="random", n=64, periodic_box=BOX)
    jcfg = JaxConfig(model="random", n=64, periodic_box=BOX)
    with pytest.raises(ValueError) as want:
        jax_batch_key_for(jcfg, slots=4)
    with pytest.raises(ValueError) as got:
        batch_key_for(cfg, slots=4, device="cpu")
    assert str(got.value) == str(want.value)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = Simulator(SimulationConfig(sentinel_every=1, **base),
                        device="cpu")
    assert sim._sentinel_fn is None
    assert any("sentinel disabled" in str(w.message) for w in caught)
    for bad in (dict(pm_assignment="ngp"), dict(periodic_box=-1.0)):
        with pytest.raises(ValueError):
            SimulationConfig(**bad)
    cfg = SimulationConfig.from_json(JaxConfig(
        model="grf", periodic_box=BOX, force_backend="pm",
        pm_assignment="tsc").to_json())
    assert (cfg.periodic_box, cfg.pm_assignment) == (BOX, "tsc")


def test_pm_blocks_get_finite_perf_rows():
    """A pm block, periodic and isolated, gets its perf-ledger row with
    every field finite, its FFTs counted by the stated rule."""
    keys = ("flops", "bytes_accessed", "transcendentals", "peak_bytes",
            "analytic_flops", "model_ratio")
    for fields in (dict(model="grf", periodic_box=BOX),
                   dict(model="plummer")):
        cfg = SimulationConfig(n=512, force_backend="pm", pm_grid=16,
                               steps=4, progress_every=2, eps=1e11,
                               integrator="leapfrog", **fields)
        stats = Simulator(cfg, device="cpu").run()
        [row] = stats["perf"]
        assert row["backend"] == "pm"
        for key in keys:
            assert perf.finite(row[key]), (key, row[key])
    # The rule: a real transform of N points is 2.5 N log2 N flops, a
    # complex one 5 N log2 N, N the real side's transformed size.
    with perf.CostCounter() as counter:
        spec = torch.fft.rfftn(torch.ones(8, 16, 16), dim=(1, 2))
    assert counter.flops == 8 * 2.5 * 256 * math.log2(256)
    with perf.CostCounter() as counter:
        torch.fft.irfftn(spec, s=(16, 16), dim=(1, 2))
        torch.fft.fftn(torch.ones(4, 4, 4, dtype=torch.complex64))
    assert counter.flops == (8 * 2.5 * 256 * math.log2(256)
                             + 5.0 * 64 * math.log2(64))


def test_cli_periodic_run_and_debug_check(tmp_path, capsys):
    """run --model grf --periodic-box ... through the port's CLI (pm,
    TSC), and --debug-check on the periodic cell list against the
    minimum-image oracle (the full-gravity box skips its check)."""
    base = ["run", "--device", "cpu", "--model", "grf", "--n", "512",
            "--steps", "4", "--dt", "1e3", "--integrator", "leapfrog",
            "--periodic-box", "1e13", "--log-dir", str(tmp_path)]
    assert cli.main(base + ["--force-backend", "pm", "--pm-grid", "8",
                            "--pm-assignment", "tsc", "--debug-check"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["backend"] == "pm" and "debug_check" not in stats
    before = dict(nlist.LAUNCHES)
    assert cli.main(base + ["--force-backend", "nlist", "--nlist-rcut",
                            "2.5e12", "--debug-check"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["backend"] == "nlist" and nlist.LAUNCHES == before
    assert stats["debug_check"]["max_rel_err"] < 1e-4
    # tune has nothing to fill in a box, as in the JAX CLI.
    assert cli.main(["tune", "--device", "cpu", "--model", "grf",
                     "--periodic-box", "1e13"]) == 2
    assert "periodic runs route statically" in capsys.readouterr().err
