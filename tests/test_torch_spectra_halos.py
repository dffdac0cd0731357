"""The port's structure diagnostics against the JAX package, on the CPU:
the density power spectrum (ops/spectra.py), friends-of-friends and the
correlation function (ops/halos.py, a copy of the JAX module) and the
``analyze`` verb's report.

One seeded numpy state goes through both packages. P(k) within 1e-4
relative in fp32 (the deposits and the FFT round differently) and 1e-10
in fp64; k and the shot noise 1e-12. Halos and xi(r) are numpy and scipy
in both: the same numbers. ``analyze`` on one grf realization (the
port's draw monkeypatched to the JAX draws): the periodic report's
fields within 1e-4 relative (the Lagrangian radii 1e-3), the halo count
exact.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.cli import main as jax_main
from gravity_tpu.ops import halos as jax_halos
from gravity_tpu.ops import spectra as jax_spectra
from gravity_tpu_torch import cli
from gravity_tpu_torch.models import grf
from gravity_tpu_torch.ops import halos, spectra

BOX = 1.0e13
TOL = {np.float32: 1e-4, np.float64: 1e-10}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _clustered(n, dtype, seed=0):
    """Uniform background plus a few tight clumps, inside the box."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, BOX, (n, 3))
    centres = rng.uniform(0.1 * BOX, 0.9 * BOX, (6, 3))
    k = n // 3
    pos[:k] = centres[rng.integers(0, 6, k)] + rng.normal(0, 2e11, (k, 3))
    pos = np.mod(pos, BOX)
    m = rng.uniform(0.5e30, 1.5e30, n)
    return pos.astype(dtype), m.astype(dtype)


@pytest.mark.parametrize("box", [None, ((0.0, 0.0, 0.0), BOX)])
@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_power_spectrum_matches_jax(dtype, interlace, box, x64):
    pos, m = _clustered(2048, dtype)
    kw = dict(grid=16, box=box, interlace=interlace, n_bins=8)
    jk, jp, js = jax_spectra.density_power_spectrum(jnp.asarray(pos),
                                                    jnp.asarray(m), **kw)
    k, p, shot = spectra.density_power_spectrum(torch.from_numpy(pos),
                                                torch.from_numpy(m), **kw)
    np.testing.assert_allclose(k, jk, rtol=1e-12)
    np.testing.assert_allclose(p, jp, rtol=TOL[dtype])
    assert shot == pytest.approx(js, rel=1e-12 if dtype == np.float64
                                 else 1e-6)
    if not interlace:
        raw = spectra.density_power_spectrum(
            torch.from_numpy(pos), torch.from_numpy(m), grid=16, box=box,
            n_bins=8, deconvolve=False)[1]
        assert np.all(raw[np.isfinite(raw)] <= p[np.isfinite(p)])


def test_halos_and_correlation_equal_jax():
    pos, m = _clustered(3000, np.float64, seed=2)
    for box in (0.0, BOX):
        got = halos.friends_of_friends(pos, m, linking_length=1.2e11,
                                       box=box, min_members=10)
        want = jax_halos.friends_of_friends(pos, m, linking_length=1.2e11,
                                            box=box, min_members=10)
        assert got.n_halos == want.n_halos > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got = halos.correlation_function(pos, box=BOX, n_bins=8)
    want = jax_halos.correlation_function(pos, box=BOX, n_bins=8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="periodic box"):
        halos.correlation_function(pos, box=0.0)


@pytest.fixture
def jax_draws(monkeypatch):
    def draw(gen, side, dtype=torch.float32, device="cpu"):
        kr, ki = jax.random.split(jax.random.PRNGKey(gen.initial_seed()))
        shape = (side, side, side // 2 + 1)
        return tuple(torch.from_numpy(np.array(jax.random.normal(k, shape)))
                     .to(dtype=dtype, device=device) for k in (kr, ki))

    monkeypatch.setattr(grf, "draw_normals", draw)


def _report(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue())


def test_analyze_report_matches_jax(jax_draws):
    argv = ["analyze", "--model", "grf", "--n", str(16**3),
            "--periodic-box", "1e13", "--eps", "1e11", "--pm-grid", "16",
            "--spectrum", "--spectrum-grid", "16", "--fof", "5e11",
            "--fof-min-members", "5", "--correlation",
            "--correlation-bins", "8"]
    want = _report(jax_main, argv)
    got = _report(cli.main, argv + ["--device", "cpu"])
    assert got["virial_ratio"] is None and "periodic_note" in got
    assert got["potential_energy"] < 0
    assert got["potential_energy"] == pytest.approx(
        want["potential_energy"], rel=1e-4)
    # The radii are order statistics: a last-bit difference of the fp32
    # cumulative mass may pick the neighbouring body (~1e-3 of r here).
    for key in ("0.10", "0.50", "0.90"):
        assert got["lagrangian_radii"][key] == pytest.approx(
            want["lagrangian_radii"][key], rel=1e-3)
    np.testing.assert_allclose(got["power_spectrum"]["k"],
                               want["power_spectrum"]["k"], rtol=1e-12)
    np.testing.assert_allclose(got["power_spectrum"]["P"],
                               want["power_spectrum"]["P"], rtol=1e-4)
    assert got["fof"]["n_halos"] == want["fof"]["n_halos"]
    assert got["fof"]["mass_fraction_in_halos"] == pytest.approx(
        want["fof"]["mass_fraction_in_halos"], rel=1e-4)
    np.testing.assert_allclose(got["correlation"]["xi"],
                               want["correlation"]["xi"], rtol=1e-2,
                               atol=1e-3)
    # --correlation needs a box, as in the JAX package.
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["analyze", "--model", "plummer", "--n", "64",
                       "--device", "cpu", "--correlation"])
    assert rc == 1 and "--periodic-box" in err.getvalue()
