"""The port's particle-mesh solvers (ops/pm.py isolated, ops/periodic.py in
a periodic box) against the JAX package, on the CPU.

One seeded numpy state goes through both packages. Tolerances: fp32
forces within 1e-5 of max |a| and fp64 within 1e-10 (the two FFT
libraries round differently and the deposits sum alike); the mesh
potential energy 1e-5 (fp32) and 1e-10 (fp64) relative. The physics
checks follow tests/test_periodic.py and tests/test_pm.py on the port
alone: the Ewald pair (rtol 0.02), wrap invariance, the uniform lattice,
momentum, fp32 at astronomical scales, the vs form's subset.
"""

from math import erfc, exp, pi, sin, sqrt

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.ops import periodic as jax_periodic
from gravity_tpu.ops import pm as jax_pm
from gravity_tpu_torch.constants import G
from gravity_tpu_torch.ops import periodic, pm

TOL = {np.float32: 1e-5, np.float64: 1e-10}
DTYPES = [np.float32, np.float64]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cloud(n, dtype, box=1e13, seed=0, spill=0.0):
    """Positions over [-spill, 1 + spill) box, masses ~1e30."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spill * box, (1 + spill) * box, (n, 3)).astype(dtype)
    m = rng.uniform(0.5e30, 1.5e30, n).astype(dtype)
    return pos, m


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _close(got, want, dtype):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= TOL[dtype] * np.abs(want).max(), err / np.abs(want).max()


@pytest.mark.parametrize("assignment", ["cic", "tsc"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_periodic_forces_and_energy_match_jax(dtype, assignment, x64):
    pos, m = _cloud(512, dtype, spill=0.1)
    kw = dict(box=1e13, grid=16, eps=2e11, assignment=assignment)
    want = jax_periodic.pm_periodic_accelerations(jnp.asarray(pos),
                                                  jnp.asarray(m), **kw)
    got = periodic.pm_periodic_accelerations(*_t(pos, m), **kw)
    assert got.dtype == torch.from_numpy(pos).dtype
    _close(got.numpy(), want, dtype)
    e_want = jax_periodic.pm_periodic_potential_energy(
        jnp.asarray(pos), jnp.asarray(m), **kw)
    e_got = periodic.pm_periodic_potential_energy(*_t(pos, m), **kw)
    assert abs(e_got - e_want) <= TOL[dtype] * abs(e_want)


@pytest.mark.parametrize("assignment", ["cic", "tsc"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_isolated_pm_matches_jax(dtype, assignment, x64):
    pos, m = _cloud(512, dtype)
    kw = dict(grid=16, eps=2e11, assignment=assignment)
    want = jax_pm.pm_accelerations(jnp.asarray(pos), jnp.asarray(m), **kw)
    got = pm.pm_accelerations(*_t(pos, m), **kw)
    _close(got.numpy(), want, dtype)
    targets = pos[:37] * np.asarray(0.9, dtype)
    want = jax_pm.pm_accelerations_vs(jnp.asarray(targets), jnp.asarray(pos),
                                      jnp.asarray(m), **kw)
    got = pm.pm_accelerations_vs(*_t(targets, pos, m), **kw)
    _close(got.numpy(), want, dtype)


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("assignment", ["cic", "tsc"])
def test_deposit_and_gather_match_jax(assignment, wrap, x64):
    """Deposits and gathers of both schemes, wrapped and clamped, on points
    that reach past the grid's faces."""
    pos, m = _cloud(300, np.float64, box=1.0, spill=0.2)
    grid = 8
    h = 1.0 / grid
    jdep, jgat, jp = jax_pm.assignment_fns(assignment)
    dep, gat, p = pm.assignment_fns(assignment)
    assert p == jp
    origin = np.zeros(3)
    want = jdep(jnp.asarray(pos), jnp.asarray(m), grid, jnp.asarray(origin),
                jnp.asarray(h), wrap=wrap)
    got = dep(*_t(pos, m), grid, torch.from_numpy(origin),
              torch.tensor(h, dtype=torch.float64), wrap=wrap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                               atol=1e-13)
    if wrap:
        assert got.sum().item() == pytest.approx(m.sum(), rel=1e-12)
    field = np.random.default_rng(1).normal(size=(grid, grid, grid, 3))
    want = jgat(jnp.asarray(field), jnp.asarray(pos), jnp.asarray(origin),
                jnp.asarray(h), wrap=wrap)
    got = gat(torch.from_numpy(field), torch.from_numpy(pos),
              torch.from_numpy(origin), torch.tensor(h, dtype=torch.float64),
              wrap=wrap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    with pytest.raises(ValueError, match="assignment"):
        pm.assignment_fns("ngp")


def _ewald_pair_ax(d, box, m, eps):
    """tests/test_periodic.py's Ewald sum of the pair's x-acceleration
    with the arctan-core softening as a nearest-image correction."""
    alpha = 3.0 / box
    d = np.asarray(d, float)
    ar = np.zeros(3)
    for ix in range(-3, 4):
        for iy in range(-3, 4):
            for iz in range(-3, 4):
                rn = d + np.array([ix, iy, iz]) * box
                r = np.linalg.norm(rn)
                ar += (G * m * rn / r**3
                       * (erfc(alpha * r)
                          + 2 * alpha * r / sqrt(pi) * exp(-(alpha * r) ** 2)))
    ak = np.zeros(3)
    for mx in range(-10, 11):
        for my in range(-10, 11):
            for mz in range(-10, 11):
                if mx == my == mz == 0:
                    continue
                k = 2 * pi / box * np.array([mx, my, mz])
                k2 = k @ k
                ak += (4 * pi * G * m / box**3 * k / k2
                       * exp(-k2 / (4 * alpha**2)) * sin(k @ d))
    r = np.linalg.norm(d)
    f_point = G * m / r**2
    f_soft = (2 / pi) * G * m * (np.arctan(r / eps) / r**2
                                 - eps / (r * (r**2 + eps**2)))
    return (ar + ak)[0] + (f_soft - f_point) * d[0] / r


def test_pair_force_matches_ewald():
    box, eps = 1.0e12, 5.0e10
    pos = torch.tensor([[0.4e12, 0.5e12, 0.5e12], [0.6e12, 0.5e12, 0.5e12]],
                       dtype=torch.float64)
    masses = torch.tensor([1e30, 1e30], dtype=torch.float64)
    # TSC at grid 64: tests/test_periodic.py:98-114's < 0.02.
    acc = periodic.pm_periodic_accelerations(pos, masses, box=box, grid=64,
                                             eps=eps, assignment="tsc")
    want = _ewald_pair_ax([0.2e12, 0.0, 0.0], box, 1e30, eps)
    assert abs(float(acc[0, 0]) - want) < 0.02 * abs(want)
    np.testing.assert_allclose(acc[0].numpy(), -acc[1].numpy(),
                               atol=1e-10 * abs(float(acc[0, 0])))
    # Through the face: particles at 0.05 and 0.95 attract outward.
    pos = torch.tensor([[0.05e12, 0.5e12, 0.5e12],
                        [0.95e12, 0.5e12, 0.5e12]], dtype=torch.float64)
    acc = periodic.pm_periodic_accelerations(pos, masses, box=box, grid=32,
                                             eps=2e10)
    assert float(acc[0, 0]) < 0 < float(acc[1, 0])


def test_wrap_invariance_lattice_and_momentum():
    box = 1.0e12
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.uniform(0, box, (32, 3)))
    masses = torch.full((32,), 1e28, dtype=torch.float64)
    a1 = periodic.pm_periodic_accelerations(pos, masses, box=box, grid=32,
                                            eps=4e10)
    shift = torch.tensor([box, -2 * box, 3 * box], dtype=torch.float64)
    a2 = periodic.pm_periodic_accelerations(pos + shift, masses, box=box,
                                            grid=32, eps=4e10)
    np.testing.assert_allclose(a1.numpy(), a2.numpy(), atol=1e-18)
    # A uniform lattice is an equilibrium of the k = 0-free solver.
    side, h = 8, 1.0 / 8
    ar = torch.arange(side, dtype=torch.float64)
    lattice = (torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                           -1).reshape(-1, 3) + 0.5) * h
    acc = periodic.pm_periodic_accelerations(
        lattice, torch.ones(side**3, dtype=torch.float64), box=1.0, grid=16,
        eps=0.1)
    assert float(acc.abs().max()) < 1e-6 * G / h**2
    # Momentum: sum m a vanishes to roundoff.
    m = torch.from_numpy(rng.uniform(1e27, 1e29, 32))
    acc = periodic.pm_periodic_accelerations(pos, m, box=box, grid=32,
                                             eps=3e10)
    ptot = (m[:, None] * acc).sum(0)
    scale = float((m * acc.norm(dim=1)).sum())
    assert float(ptot.abs().max()) < 1e-10 * scale
    # The vs form on a subset of targets is the full form's rows.
    some = periodic.pm_periodic_accelerations_vs(pos[:10], pos, masses,
                                                 box=box, grid=32, eps=3e10)
    full = periodic.pm_periodic_accelerations(pos, masses, box=box, grid=32,
                                              eps=3e10)
    np.testing.assert_allclose(some.numpy(), full[:10].numpy(), rtol=1e-12)


def test_fp32_astro_scale_forces_nonzero():
    """The (4 pi G / h) / (k^2 h^2) association keeps fp32 forces alive at
    astronomical scales (G / h^3 ~ 1e-45 would flush to zero); the fp32
    mesh stays within the JAX suite's bar of fp64, and its spectra stay
    complex64."""
    from gravity_tpu_torch.models import create_grf

    st = create_grf(torch.Generator().manual_seed(0), 512, box=1e13)
    acc = periodic.pm_periodic_accelerations(st.positions, st.masses,
                                             box=1e13, grid=16)
    amax = float(acc.abs().max())
    assert amax > 1e-5 and acc.dtype == torch.float32
    acc64 = periodic.pm_periodic_accelerations(
        st.positions.double(), st.masses.double(), box=1e13, grid=16)
    np.testing.assert_allclose(acc.numpy(), acc64.numpy(), rtol=2e-3,
                               atol=amax * 1e-3)
    modes, kf = periodic._mode_grids(16, 1e13, torch.float32, "cpu")
    assert modes[0].dtype == kf.dtype == torch.float32
    rho_k = torch.fft.rfftn(torch.ones(16, 16, 16))
    phi_k = periodic._phi_k(rho_k, modes, h=torch.tensor(1e13 / 16), kf=kf,
                            g=G, eps=0.0, grid=16, dtype=torch.float32)
    assert phi_k.dtype == (-1j * (modes[0] * kf) * phi_k).dtype \
        == torch.complex64
