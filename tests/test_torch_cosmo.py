"""The port's comoving cosmology (ops/cosmo.py) and its ``cosmo`` verb
against the JAX package, on the CPU.

The factors, growth and momenta are host float64 in both packages and
agree to 1e-12 relative; the KDK scan on one state to 1e-10 of the box
(fp64). The ``cosmo`` verb at 16^3 bodies and 40 steps, for both
parameter sets of tests/test_cosmo.py:58-59, draws its normal fields as
the JAX CLI does (the port's draw is monkeypatched to the JAX draws of
the same seed), so both build one realization: ``growth_measured``
within 1e-3 relative of the JAX CLI's, ``rel_err`` < 0.06 (the JAX
suite's bar), the Layzer-Irvine residual within 1e-3 relative. Streaming
and ``--resume`` give the uninterrupted run's bits on the CPU.
"""

import contextlib
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.cli import main as jax_main
from gravity_tpu.models import create_grf as jax_create_grf
from gravity_tpu.ops import cosmo as jcosmo
from gravity_tpu.ops.periodic import (
    pm_periodic_accelerations_vs as jax_pm_vs,
)
from gravity_tpu_torch import cli
from gravity_tpu_torch.interop import state_from_numpy
from gravity_tpu_torch.models import grf
from gravity_tpu_torch.ops import cosmo
from gravity_tpu_torch.ops.periodic import pm_periodic_accelerations_vs
from gravity_tpu_torch.utils.checkpoint import (
    make_checkpoint_manager,
    restore_checkpoint_with_extra,
)

COSMOLOGIES = [dict(omega_m=1.0), dict(omega_m=0.3),
               dict(omega_m=0.3, omega_k=0.1, w0=-0.9, wa=0.2)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("cos", COSMOLOGIES)
def test_factors_growth_and_momenta_match_jax(cos, x64):
    extra = {k: v for k, v in cos.items() if k != "omega_m"}
    om = cos["omega_m"]
    a = np.linspace(0.1, 1.0, 7)
    np.testing.assert_allclose(cosmo.e_of_a(a, om, **extra),
                               jcosmo.e_of_a(a, om, **extra), rtol=1e-14)
    got = cosmo.lcdm_factors(0.2, 0.5, 0.05, om, **extra)
    want = jcosmo.lcdm_factors(0.2, 0.5, 0.05, om, **extra)
    np.testing.assert_allclose(got, want, rtol=1e-13)
    assert cosmo.linear_growth_ratio(0.2, 0.5, om, **extra) == \
        pytest.approx(jcosmo.linear_growth_ratio(0.2, 0.5, om, **extra),
                      rel=1e-12)
    assert cosmo.growth_rate(0.5, om, **extra) == \
        pytest.approx(jcosmo.growth_rate(0.5, om, **extra), rel=1e-12)
    edges = np.exp(np.linspace(np.log(0.02), np.log(0.08), 9))
    for g, w in zip(cosmo.comoving_kdk_factors(edges, 0.05, om, **extra,
                                               dtype=torch.float64),
                    jcosmo.comoving_kdk_factors(edges, 0.05, om, **extra,
                                                dtype=jnp.float64)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13)
    disp = np.random.default_rng(0).normal(size=(16, 3)) * 1e9
    got = cosmo.growing_mode_momenta(torch.from_numpy(disp), 0.3, 0.05, om,
                                     **extra)
    want = jcosmo.growing_mode_momenta(jnp.asarray(disp), 0.3, 0.05, om,
                                       **extra)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)
    np.testing.assert_allclose(
        cosmo.zeldovich_momenta(torch.from_numpy(disp), 0.3, 0.05).numpy(),
        np.asarray(jcosmo.zeldovich_momenta(jnp.asarray(disp), 0.3, 0.05)),
        rtol=1e-13)
    assert cosmo.eds_kick_factor(0.02, 0.08, 0.05) == \
        jcosmo.eds_kick_factor(0.02, 0.08, 0.05)
    assert cosmo.eds_drift_factor(0.02, 0.08, 0.05) == \
        jcosmo.eds_drift_factor(0.02, 0.08, 0.05)
    recs = [(0.1, 1.0, -2.0), (0.2, 1.5, -2.5), (0.4, 2.5, -3.1)]
    assert cosmo.layzer_irvine_residual(recs) == \
        pytest.approx(jcosmo.layzer_irvine_residual(recs), rel=1e-14)


def test_recollapsing_universe_raises():
    with pytest.raises(ValueError, match="E\\^2"):
        cosmo.e_of_a(0.5, 0.3, -2.0)
    with pytest.raises(ValueError, match="records"):
        cosmo.layzer_irvine_residual([(0.1, 1.0, 1.0)])


def _grf_pair(seed, side, box=1.0):
    """One fp64 grf state in both packages (the JAX draws of ``seed``)."""
    jst = jax_create_grf(jax.random.PRNGKey(seed), side**3, box=box,
                         spectral_index=-2.0, sigma_psi=0.002,
                         total_mass=1.0, dtype=jnp.float64)
    st = state_from_numpy(*(np.asarray(a) for a in
                            (jst.positions, jst.velocities, jst.masses)),
                          dtype=torch.float64, device="cpu")
    lat = grf.grf_lattice(side, box, dtype=torch.float64).numpy()
    disp = (np.asarray(jst.positions) - lat + box / 2) % box - box / 2
    return jst, st, disp


def test_kdk_scan_matches_jax_and_blocks_match_single_shot(x64):
    """comoving_kdk_scan against the JAX package's on one state, and the
    blockwise scan on the global edge grid against a single shot
    (tests/test_cosmo.py:249), the invariant of streaming and resume."""
    box, side, h0, a1, a2, steps = 1.0, 8, 0.05, 0.02, 0.04, 12
    jst, st, disp = _grf_pair(2, side, box)
    jst = jst.replace(velocities=jcosmo.zeldovich_momenta(
        jnp.asarray(disp) / a1, a1, h0))
    st = st.replace(velocities=cosmo.zeldovich_momenta(
        torch.from_numpy(disp) / a1, a1, h0))
    g_eff = 3 * h0**2 * box**3 / (8 * np.pi)

    def accel(x):
        return pm_periodic_accelerations_vs(x, x, st.masses, box=box,
                                            grid=side, g=g_eff, eps=0.0)

    def jaccel(x):
        return jax_pm_vs(x, x, jst.masses, box=box, grid=side, g=g_eff,
                         eps=0.0)

    single = cosmo.comoving_kdk_run(st, accel, a_start=a1, a_end=a2,
                                    n_steps=steps, h0=h0)
    want = jcosmo.comoving_kdk_run(jst, jaccel, a_start=a1, a_end=a2,
                                   n_steps=steps, h0=h0)
    gap = single.positions.numpy() - np.asarray(want.positions)
    assert np.abs(gap).max() < 1e-10 * box
    edges = np.exp(np.linspace(np.log(a1), np.log(a2), steps + 1))
    blocked = st
    for lo in range(0, steps, 5):  # uneven blocks: 5, 5, 2
        hi = min(lo + 5, steps)
        k1s, drs, k2s = cosmo.comoving_kdk_factors(edges[lo:hi + 1], h0,
                                                   dtype=torch.float64)
        blocked = cosmo.comoving_kdk_scan(blocked, k1s, drs, k2s,
                                          accel_fn=accel)
    np.testing.assert_allclose(blocked.positions.numpy(),
                               single.positions.numpy(), rtol=1e-12)


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's grf draw replaced by the JAX CLI's: jax.random.normal of
    PRNGKey(seed) split, the seed read back from the generator."""
    seeds = []

    def draw(gen, side, dtype=torch.float32, device="cpu"):
        kr, ki = jax.random.split(jax.random.PRNGKey(gen.initial_seed()))
        shape = (side, side, side // 2 + 1)
        seeds.append(gen.initial_seed())
        return tuple(torch.from_numpy(np.array(jax.random.normal(k, shape)))
                     .to(dtype=dtype, device=device) for k in (kr, ki))

    monkeypatch.setattr(grf, "draw_normals", draw)
    return seeds


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("omega_m,a1,a2", [(1.0, 0.02, 0.08),
                                           (0.3, 0.2, 0.5)])
def test_cli_cosmo_growth_matches_jax(omega_m, a1, a2, jax_draws):
    argv = ["cosmo", "--n", str(16**3), "--steps", "40",
            "--omega-m", str(omega_m), "--a-start", str(a1),
            "--a-end", str(a2)]
    if omega_m != 1.0:
        argv.append("--li-check")
    want = _run(jax_main, argv)
    got = _run(cli.main, argv + ["--device", "cpu"])
    assert jax_draws == [0]
    assert got["platform"] == "cpu" and got["rel_err"] < 0.06
    assert got["growth_measured"] == pytest.approx(want["growth_measured"],
                                                   rel=1e-3)
    assert got["growth_linear"] == pytest.approx(want["growth_linear"],
                                                 rel=1e-12)
    if "layzer_irvine" in want:
        assert got["layzer_irvine"]["n_samples"] == \
            want["layzer_irvine"]["n_samples"]
        assert got["layzer_irvine"]["residual"] == pytest.approx(
            want["layzer_irvine"]["residual"], rel=1e-3)


def test_cli_cosmo_streaming_and_resume_bitwise(tmp_path):
    """Checkpoints and frames at block boundaries; --resume from step 20
    ends on the uninterrupted run's bits; a resume onto another grid is
    refused."""
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "out")
    argv = ["cosmo", "--n", str(8**3), "--steps", "40", "--device", "cpu",
            "--progress-every", "10", "--checkpoint-every", "20",
            "--checkpoint-dir", ckpt, "--trajectories", "--out-dir", out,
            "--lpt-order", "2"]
    full = _run(cli.main, argv)
    assert any(x.startswith("trajectories_cosmo_") for x in os.listdir(out))
    mgr = make_checkpoint_manager(ckpt)
    assert sorted(mgr.all_steps()) == [20, 40]
    whole, _, extra = restore_checkpoint_with_extra(mgr, 40)
    assert extra["a"] == pytest.approx(0.08)
    shutil.rmtree(os.path.join(ckpt, "40"))
    resumed_report = _run(cli.main, argv + ["--resume"])
    assert resumed_report["resumed_at"] == 20
    assert resumed_report["growth_measured"] == full["growth_measured"]
    resumed, _, _ = restore_checkpoint_with_extra(
        make_checkpoint_manager(ckpt), 40)
    for name in ("positions", "velocities"):
        assert torch.equal(getattr(resumed, name), getattr(whole, name))
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        shutil.rmtree(os.path.join(ckpt, "40"))
        rc = cli.main(argv[:4] + ["41"] + argv[5:] + ["--resume"])
    assert rc == 1 and "original grid" in err.getvalue()
