"""The CUDA kernels on the card: held against their plain versions.

Needs a CUDA device and nvcc; skips without a card. On a machine with
one (which need not have JAX; tests/conftest.py imports it):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

Tolerances: the direct sum on each row's acceleration vector, fp32 rtol
2e-5 and fp64 rtol 1e-12 (the same terms summed in another order); the
cell-list tiles and the Gram form in units of each row's sum of |terms|,
fp32 1e-4 and fp64 1e-12, since their kernels form r^2 and the masks
exactly as the plain versions do and differ only in the order of the
sums and the rsqrt (chip_smoke.py states the bounds). The cell list's
ewald kind is held to the same numbers in units of each row's sum of
gm (|newt| + |corr|) |d|, the terms before they cancel near rcut: its
erff and expf differ from the plain version's by an ulp or two.
"""

import numpy as np
import pytest
import torch

from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.ops import direct_kernel, mxu_kernel, nlist, p3m
from gravity_tpu_torch.ops.cells import bin_to_cells, bounding_cube, grid_coords
from gravity_tpu_torch.ops.forces import accelerations_vs
from gravity_tpu_torch.simulation import Simulator

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda", 0)


def _system(n, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.uniform(-3e11, 3e11, (n, 3)))
    masses = torch.from_numpy(rng.uniform(1e23, 1e25, n))
    return pos.to(device, dtype), masses.to(device, dtype)


@pytest.mark.parametrize("eps", [0.0, 1e9])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("m,k", [(64, 64), (1000, 1000), (100, 384),
                                 (1, 257)])
def test_kernel_matches_plain(cuda, m, k, dtype, rtol, eps):
    pos, masses = _system(k, dtype, cuda, seed=k)
    pos_i = pos[:m].contiguous()
    before = direct_kernel.LAUNCHES
    got = direct_kernel.accelerations_vs_kernel(pos_i, pos, masses, eps=eps)
    assert direct_kernel.LAUNCHES == before + 1
    want = accelerations_vs(pos_i, pos, masses, eps=eps)
    torch.cuda.synchronize()
    err = (got - want).double().norm(dim=1)
    assert bool((err <= rtol * want.double().norm(dim=1)).all())


def test_coincident_bodies_are_zero(cuda):
    pos = torch.zeros(16, 3, device=cuda)
    masses = torch.full((16,), 1e30, device=cuda)
    acc = direct_kernel.accelerations_vs_kernel(pos, pos, masses)
    assert bool((acc == 0).all())


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    pos, masses = _system(8, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        direct_kernel.accelerations_vs_kernel(pos.t().contiguous().t(), pos,
                                              masses)
    with pytest.raises(TypeError, match="float64"):
        direct_kernel.accelerations_vs_kernel(pos, pos.double(), masses)
    with pytest.raises(TypeError, match="float32 or float64"):
        direct_kernel.accelerations_vs_kernel(pos.half(), pos.half(),
                                              masses.half())
    with pytest.raises(ValueError, match="is on cpu"):
        direct_kernel.accelerations_vs_kernel(pos, pos.cpu(), masses.cpu())


def test_simulator_runs_through_the_kernel(cuda):
    cfg = SimulationConfig(n=300, steps=10, progress_every=5)
    sim = Simulator(cfg)
    before = direct_kernel.LAUNCHES
    stats = sim.run()
    assert sim.backend == "nbody_direct"
    assert direct_kernel.LAUNCHES - before == stats["kernel_launches"] == 11
    assert bool(torch.isfinite(stats["final_state"].positions).all())


def _within_term_scale(got, want, scale, tol):
    err = (got.double() - want.double()).abs()
    assert bool((err <= tol * scale.double()).all())


@pytest.mark.parametrize("use_rcut", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("side,cap", [(4, 64), (2, 32)])
def test_nlist_kernel_matches_plain(cuda, side, cap, dtype, tol, use_rcut):
    """(2, 32) overflows its cells: the kernel reads only the first cap
    slots of each, as the plain version does."""
    pos, masses = _system(600, dtype, cuda, seed=side)
    origin, span = bounding_cube(pos)
    coords = grid_coords(pos, origin, span, side)
    cells_pos, cells_m, count, *_ = bin_to_cells(pos, masses, coords, side,
                                                 cap)
    params = (span / side).reshape(1) ** 2
    args = (cells_pos, count, cells_pos, cells_m * 6.6743e-11, count, side,
            params)
    kw = dict(cutoff=1e-10, eps=1e9, use_rcut=use_rcut)
    before = nlist.LAUNCHES["newton"]
    got = nlist.pair_cells_kernel(*args, **kw)
    assert nlist.LAUNCHES["newton"] == before + 1
    want = nlist.pair_cells_plain(*args, **kw)
    scale = nlist.pair_cells_plain(*args, absolute=True, **kw)
    torch.cuda.synchronize()
    _within_term_scale(got, want, scale, tol)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,k", [(1000, 1000), (100, 384), (1, 257)])
def test_mxu_kernel_matches_plain(cuda, m, k, bf16):
    pos, masses = _system(k, torch.float32, cuda, seed=k)
    center = pos.mean(dim=0)
    ops = pos - center
    if bf16:
        ops = ops.to(torch.bfloat16)
    xi, gm = ops[:m].contiguous(), masses * 6.6743e-11
    before = mxu_kernel.LAUNCHES
    got = mxu_kernel.gram_acc4(xi, ops, gm, cutoff=1e-10, eps=1e9)
    assert mxu_kernel.LAUNCHES == before + 1
    want = mxu_kernel.gram_acc4_plain(xi, ops, gm, cutoff=1e-10, eps=1e9,
                                      bf16=bf16)
    w = mxu_kernel._gram_weights(
        xi.float(), mxu_kernel._norm2(xi.float()), ops.float(),
        mxu_kernel._norm2(ops.float()), gm, cutoff=1e-10, eps=1e9)
    xj4 = torch.cat([ops.float().abs(), torch.ones_like(gm)[:, None]], 1)
    torch.cuda.synchronize()
    scale = (w[:, :, None] * xj4[None, :, :]).sum(dim=1)
    _within_term_scale(got, want, scale, 1e-4)


def test_simulator_runs_the_new_backends_through_their_kernels(cuda):
    for cfg, count in (
        (SimulationConfig(n=2000, steps=5, integrator="leapfrog", eps=1e9,
                          force_backend="nlist", nlist_rcut=1e11),
         lambda: nlist.LAUNCHES["newton"]),
        (SimulationConfig(n=500, steps=5, integrator="leapfrog", eps=1e9,
                          force_backend="pallas-mxu"),
         lambda: mxu_kernel.LAUNCHES),
        (SimulationConfig(model="disk", n=4096, steps=5, g=1.0, dt=2e-3,
                          eps=0.05, integrator="leapfrog",
                          force_backend="p3m", pm_grid=32, p3m_cap=16),
         lambda: nlist.LAUNCHES["ewald"]),
    ):
        sim = Simulator(cfg)
        before = count()
        stats = sim.run()
        assert count() - before == stats["kernel_launches"] == 6
        assert bool(torch.isfinite(stats["final_state"].positions).all())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("side,cap", [(6, 64), (3, 16)])
def test_nlist_ewald_kernel_matches_plain(cuda, side, cap, dtype, tol):
    """The ewald kind on a thin disk around a point mass, P3M's own
    sizing at grid 32 (side 6) and an overflowing one (side 3, cap 16)."""
    rng = np.random.default_rng(side)
    n = 3000
    r = torch.from_numpy(rng.exponential(3.0, n))
    phi = torch.from_numpy(rng.uniform(0.0, 2.0 * np.pi, n))
    pos = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                       torch.from_numpy(0.3 * rng.normal(size=n))], 1)
    pos[0] = 0.0
    masses = torch.full((n,), 5.0 / n, dtype=torch.float64)
    masses[0] = 1.0
    pos, masses = pos.to(cuda, dtype), masses.to(cuda, dtype)
    origin, span = bounding_cube(pos)
    coords = grid_coords(pos, origin, span, side)
    cells_pos, cells_m, count, *_ = bin_to_cells(pos, masses, coords, side,
                                                 cap)
    sigma = 1.25 * span / 31
    params = torch.stack([(4.0 * sigma) ** 2, 1.0 / (2.0 ** 0.5 * sigma)])
    args = (cells_pos, count, cells_pos, cells_m, count, side, params)
    kw = dict(cutoff=1e-10, eps=0.05, kind="ewald")
    before = dict(nlist.LAUNCHES)
    got = nlist.pair_cells_kernel(*args, **kw)
    assert nlist.LAUNCHES == {**before, "ewald": before["ewald"] + 1}
    want = nlist.pair_cells_plain(*args, **kw)
    scale = nlist.pair_cells_plain(*args, absolute=True, **kw)
    torch.cuda.synchronize()
    _within_term_scale(got, want, scale, tol)


def test_p3m_nlist_mode_matches_gather_on_the_card(cuda):
    """One P3M evaluation through the ewald kernel against the plain
    gather pass on the same state: the same sum in another order (fp64,
    rtol 1e-9 of the mean |a|)."""
    rng = np.random.default_rng(3)
    pos = torch.from_numpy(rng.uniform(-10.0, 10.0, (4000, 3))).to(cuda)
    masses = torch.from_numpy(rng.uniform(0.5, 1.5, 4000)).to(cuda)
    kw = dict(grid=32, cap=32, g=1.0, eps=0.05)
    before = nlist.LAUNCHES["ewald"]
    a = p3m.p3m_accelerations(pos, masses, short_mode="nlist", **kw)
    assert nlist.LAUNCHES["ewald"] == before + 1
    b = p3m.p3m_accelerations(pos, masses, short_mode="gather", **kw)
    assert nlist.LAUNCHES["ewald"] == before + 1
    err = (a - b).abs().max() / b.norm(dim=1).mean()
    assert float(err) < 1e-9
