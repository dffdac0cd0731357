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
erff and expf differ from the plain version's by an ulp or two. The
slab form of the cell-list kernel (the halo engine's tiles) is held to
the plain slab engine by the same bars (bf16 2^-5), and its launches on
hand-cut slabs to the cubic launch's bits.
"""

import dataclasses

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
def cuda(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    # These tests run without tests/conftest.py: a tuning cache of the
    # test's own, never one left on the machine.
    monkeypatch.setenv("GRAVITY_TPU_TUNE_DIR", str(tmp_path / "tuning"))
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
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        direct_kernel.accelerations_vs_kernel(pos.half(), pos.half(),
                                              masses.half())
    with pytest.raises(ValueError, match="is on cpu"):
        direct_kernel.accelerations_vs_kernel(pos, pos.cpu(), masses.cpu())


def test_simulator_runs_through_the_kernel(cuda):
    # direct, not auto: plain auto routes by a probe of nbody_direct
    # against nbody_mxu, whose winner at N = 300 is not this test's
    cfg = SimulationConfig(n=300, steps=10, progress_every=5,
                           force_backend="direct")
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
    key = nlist.launch_key("newton", use_rcut)
    before = nlist.LAUNCHES[key]
    got = nlist.pair_cells_kernel(*args, **kw)
    assert nlist.LAUNCHES[key] == before + 1
    want = nlist.pair_cells_plain(*args, **kw)
    scale = nlist.pair_cells_plain(*args, absolute=True, **kw)
    torch.cuda.synchronize()
    _within_term_scale(got, want, scale, tol)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,k", [(1000, 1000), (100, 384), (1, 257),
                                 (1, 4099), (1000, 3), (129, 20_011),
                                 (4097, 20_003)])
def test_mxu_kernel_matches_plain(cuda, m, k, bf16):
    """Ragged M and K (past a multiple of the block's targets, of a
    k-step and of the 256-source tile, and K below one k-step), and
    M << K, which the wrapper splits into several source chunks: a
    second launch gives the same bits."""
    pos, masses = _system(k, torch.float32, cuda, seed=k)
    center = pos.mean(dim=0)
    ops = pos - center
    if bf16:
        ops = ops.to(torch.bfloat16)
    xi, gm = ops[:m].contiguous(), masses * 6.6743e-11
    before = mxu_kernel.LAUNCHES
    got = mxu_kernel.gram_acc4(xi, ops, gm, cutoff=1e-10, eps=1e9)
    assert mxu_kernel.LAUNCHES == before + 1
    again = mxu_kernel.gram_acc4(xi, ops, gm, cutoff=1e-10, eps=1e9)
    want = mxu_kernel.gram_acc4_plain(xi, ops, gm, cutoff=1e-10, eps=1e9,
                                      bf16=bf16)
    w = mxu_kernel._gram_weights(
        xi.float(), mxu_kernel._norm2(xi.float()), ops.float(),
        mxu_kernel._norm2(ops.float()), gm, cutoff=1e-10, eps=1e9)
    xj4 = torch.cat([ops.float().abs(), torch.ones_like(gm)[:, None]], 1)
    torch.cuda.synchronize()
    scale = (w[:, :, None] * xj4[None, :, :]).sum(dim=1)
    _within_term_scale(got, want, scale, 1e-4)
    assert torch.equal(got, again)
    if (m, k) == (129, 20_011):
        assert mxu_kernel.chunks_for(m, k, bf16=bf16, cutoff=1e-10,
                                     eps=1e9) > 1


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


def _term_scale(pos_i, pos_j, masses_j, eps):
    """Each row's sum of |w_ij d_ij| in float64: the scale the kernel's
    tile, chunk and chunk-total sums round at."""
    from gravity_tpu_torch.ops.forces import _pair_weights

    pi, pj, mj = (t.double() for t in (pos_i, pos_j, masses_j))
    diff = pj[None, :, :] - pi[:, None, :]
    w = _pair_weights((diff * diff).sum(-1), mj[None, :], 6.6743e-11, 1e-10,
                      eps)
    return (w[:, :, None] * diff.abs()).sum(dim=1)


@pytest.mark.parametrize("eps", [0.0, 1e9])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("m,k", [
    (7, 20_000),     # M << K: one block of targets, many source chunks
    (5_000, 3),      # K << M, K shorter than one tile: one chunk
    (1_001, 4_099),  # M and K past a multiple of the block and the tile
    (257, 256),      # one tile exactly, M one past the block
    (40_000, 600),   # enough blocks of targets to keep one chunk
])
def test_kernel_edge_shapes_match_plain(cuda, m, k, dtype, tol, eps):
    pos, masses = _system(max(m, k), dtype, cuda, seed=m + k)
    pos_i, pos_j, m_j = pos[:m].contiguous(), pos[:k].contiguous(), masses[:k]
    got = direct_kernel.accelerations_vs_kernel(pos_i, pos_j, m_j, eps=eps)
    want = accelerations_vs(pos_i, pos_j, m_j, eps=eps)
    torch.cuda.synchronize()
    _within_term_scale(got, want, _term_scale(pos_i, pos_j, m_j, eps), tol)


def test_kernel_plan_splits_the_sources_where_targets_are_few(cuda):
    """M << K takes several source chunks; a grid of targets that already
    fills the card takes one."""
    lib = direct_kernel.load_library()
    block_m, tile = lib.nbody_direct_shape(0), lib.nbody_direct_shape(1)
    slots = direct_kernel._slots(0, torch.float32, True, 0.0, 1e-20)
    assert slots >= 132
    few = direct_kernel.source_chunks(7, 20_000, block_m=block_m, tile=tile,
                                      slots=slots)
    assert few > 1
    many = direct_kernel.source_chunks(slots * block_m, 20_000,
                                       block_m=block_m, tile=tile,
                                       slots=slots)
    assert many == 1


@pytest.mark.parametrize("m,k", [(50_000, 50_000), (7, 20_000)])
def test_kernel_is_bitwise_deterministic(cuda, m, k):
    """The chunks' partial sums are added in a fixed order: two runs on the
    same inputs give the same bits."""
    pos, masses = _system(max(m, k), torch.float32, cuda, seed=3)
    pos_i, pos_j, m_j = pos[:m].contiguous(), pos[:k].contiguous(), masses[:k]
    a = direct_kernel.accelerations_vs_kernel(pos_i, pos_j, m_j)
    b = direct_kernel.accelerations_vs_kernel(pos_i, pos_j, m_j)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _nlist_counts_case(t_cap, cap, dtype, device, seed):
    """Cells of a side-3 grid whose target and source counts run through 0,
    31, 32, 33, the caps and past them; positions fill a unit-cell grid
    of edge 1, G m is zero on every slot past a cell's count."""
    rng = np.random.default_rng(seed)
    side = 3
    n = side**3
    choices = [0, 31, 32, 33, t_cap, t_cap + 5, cap, cap + 7, 1, 15, 16, 17]
    t_count = torch.tensor([choices[i % len(choices)] for i in range(n)])
    s_count = torch.tensor([choices[(i * 7 + 2) % len(choices)]
                            for i in range(n)])
    c = torch.arange(n)
    corner = torch.stack([c // 9, (c // 3) % 3, c % 3], 1).double()
    tpos = corner[:, None, :] + torch.from_numpy(rng.uniform(0, 1,
                                                             (n, t_cap, 3)))
    spos = corner[:, None, :] + torch.from_numpy(rng.uniform(0, 1,
                                                             (n, cap, 3)))
    gm = torch.from_numpy(rng.uniform(0.5, 1.5, (n, cap))) / 1000
    gm = torch.where(torch.arange(cap)[None, :] < s_count[:, None], gm, 0.0)
    return (tpos.to(device, dtype), t_count.to(device), spos.to(device, dtype),
            gm.to(device, dtype), s_count.to(device), side)


@pytest.mark.parametrize("kind,use_rcut", [("newton", True),
                                           ("newton", False),
                                           ("ewald", True)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("t_cap,cap", [(64, 40), (20, 33), (45, 96),
                                       (100, 70), (160, 50)])
def test_nlist_kernel_count_edges_match_plain(cuda, t_cap, cap, dtype, tol,
                                              kind, use_rcut):
    """Counts of 0, 31, 32, 33, t_cap and over it; t_cap below 32 and not a
    multiple of 32 or of a warp's 16 slots; targets apart from sources."""
    args = _nlist_counts_case(t_cap, cap, dtype, cuda, seed=t_cap + cap)
    params = torch.tensor([1.0, 1.0 / (2.0**0.5 * 0.25)], dtype=dtype,
                          device=cuda)
    kw = dict(cutoff=1e-10, eps=0.05, use_rcut=use_rcut, kind=kind)
    got = nlist.pair_cells_kernel(*args, params, **kw)
    want = nlist.pair_cells_plain(*args, params, **kw)
    scale = nlist.pair_cells_plain(*args, params, absolute=True, **kw)
    torch.cuda.synchronize()
    _within_term_scale(got, want, scale, tol)
    t_count = args[1].clamp_max(t_cap).cpu()
    empty = torch.arange(t_cap)[None, :] >= t_count[:, None]
    assert bool((got.cpu()[empty] == 0).all())
    assert bool((got.cpu()[~empty] != 0).any())


# The bf16 form of nbody_direct against the plain version at bf16, in
# units of each row's sum of |terms|: both round every op of a term to
# bf16 alike, and differ by the order of their fp32 sums (< 1e-4 of the
# scale, as fp32) before each rounds its row once (one bf16 ulp, 2^-8),
# and where the three squares of r^2 add in another order and round r^2
# the other way (1.5 x 2^-8 of that term): under 3 x 2^-8.
BF16_TOL = 3 * 2.0**-8


@pytest.mark.parametrize("eps", [0.0, 1e9])
@pytest.mark.parametrize("m,k", [(64, 64), (1000, 1000), (100, 384),
                                 (1, 257), (7, 20_000), (1_001, 4_099),
                                 (5_000, 3)])
def test_bf16_kernel_matches_plain(cuda, m, k, eps):
    pos, masses = _system(max(m, k), torch.bfloat16, cuda, seed=m + k)
    pos_i, pos_j, m_j = pos[:m].contiguous(), pos[:k].contiguous(), masses[:k]
    before = direct_kernel.LAUNCHES
    got = direct_kernel.accelerations_vs_kernel(pos_i, pos_j, m_j, eps=eps)
    again = direct_kernel.accelerations_vs_kernel(pos_i, pos_j, m_j, eps=eps)
    assert direct_kernel.LAUNCHES == before + 2
    want = accelerations_vs(pos_i, pos_j, m_j, eps=eps)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    _within_term_scale(got, want, _term_scale(pos_i, pos_j, m_j, eps),
                       BF16_TOL)


def test_simulator_runs_bf16_states_through_the_kernels(cuda):
    for backend, module in (("pallas", direct_kernel),
                            ("pallas-mxu", mxu_kernel)):
        cfg = SimulationConfig(model="plummer", n=3000, steps=10, eps=1e9,
                               integrator="leapfrog", dtype="bfloat16",
                               force_backend=backend, progress_every=5)
        sim = Simulator(cfg)
        before = module.LAUNCHES
        stats = sim.run()
        assert module.LAUNCHES - before == stats["kernel_launches"] == 11
        final = stats["final_state"]
        assert final.positions.dtype == torch.bfloat16
        assert bool(torch.isfinite(final.positions).all())


# The multirate fast kicks: each kernel at the rectangular shapes its
# path launches (make_local_kernel).


@pytest.mark.parametrize("m", [2, 2048])
def test_direct_kick_shapes_match_plain(cuda, m):
    """nbody_direct at M = 2 and 2,048 targets (the star cluster's binary,
    baseline-16k's auto k) against its 16,384 sources, mask-free: rows
    at fp32 rtol 2e-5, the same bits on a repeat."""
    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.simulation import (
        KERNEL_BACKEND,
        make_initial_state,
        make_local_kernel,
    )

    cfg = PRESETS["baseline-16k"]
    state = make_initial_state(cfg, cuda)
    kick = make_local_kernel(cfg, KERNEL_BACKEND)
    gen = torch.Generator().manual_seed(m)
    idx = torch.randperm(state.n, generator=gen)[:m].to(cuda)
    ti = state.positions[idx]
    before = direct_kernel.LAUNCHES
    got = kick(ti, state.positions, state.masses)
    again = kick(ti, state.positions, state.masses)
    assert direct_kernel.LAUNCHES == before + 2
    want = accelerations_vs(ti, state.positions, state.masses, eps=cfg.eps)
    torch.cuda.synchronize()
    err = (got - want).double().norm(dim=1)
    assert bool((err <= 2e-5 * want.double().norm(dim=1)).all())
    assert torch.equal(got, again)


def test_nlist_kick_at_t_cap_below_cap_matches_plain(cuda):
    """The cell list's K-target kick bins its targets at the t_cap that
    _occupancy_t_cap sizes below the cap; the pair tiles at that t_cap
    against the plain version, 1e-4 of each row's term scale."""
    from gravity_tpu_torch.simulation import _occupancy_t_cap

    n, rcut, k = 20_000, 5e10, 2500
    pos, masses = _system(n, torch.float32, cuda, seed=3)
    side, cap = nlist.resolve_nlist_sizing(pos, rcut)
    t_cap = _occupancy_t_cap(cap, k, n, pos, side, "test")
    assert t_cap < cap
    targets = pos[torch.randperm(n, device=cuda)[:k]]
    origin, span, params, _, binned = nlist.source_cells(
        pos, masses, rcut=rcut, side=side, cap=cap)
    cells_pos, cells_mass, cell_count = binned[:3]
    tcells = bin_to_cells(targets, torch.ones_like(targets[:, 0]),
                          grid_coords(targets, origin, span, side), side,
                          t_cap)
    args = (tcells[0], tcells[2], cells_pos, cells_mass * 6.6743e-11,
            cell_count, side, params)
    kw = dict(cutoff=1e-10, eps=1e9, use_rcut=True, kind="newton")
    before = nlist.LAUNCHES["newton"]
    got = nlist.pair_cells_kernel(*args, **kw)
    assert nlist.LAUNCHES["newton"] == before + 1
    want = nlist.pair_cells_plain(*args, **kw)
    scale = nlist.pair_cells_plain(*args, absolute=True, **kw)
    torch.cuda.synchronize()
    assert got.shape == (side**3, t_cap, 3)
    _within_term_scale(got, want, scale, 1e-4)


def test_mxu_kick_shape_matches_plain(cuda):
    """nbody_mxu at M = 8,192 targets against 65,536 sources (the
    flagship's auto k), held to its plain version at 1e-4 of each row's
    sum of |w| |[x_j | 1]|, the same bits on a repeat."""
    pos, masses = _system(65_536, torch.float32, cuda, seed=8)
    ops = pos - pos.mean(dim=0)
    xi = ops[torch.randperm(65_536, device=cuda)[:8192]]
    gm = masses * 6.6743e-11
    got = mxu_kernel.gram_acc4(xi, ops, gm, cutoff=1e-10, eps=1e9)
    again = mxu_kernel.gram_acc4(xi, ops, gm, cutoff=1e-10, eps=1e9)
    rows = torch.arange(0, 8192, 16, device=cuda)
    want = mxu_kernel.gram_acc4_plain(xi[rows], ops, gm, cutoff=1e-10,
                                      eps=1e9, bf16=False)
    w = mxu_kernel._gram_weights(
        xi[rows], mxu_kernel._norm2(xi[rows]), ops, mxu_kernel._norm2(ops),
        gm, cutoff=1e-10, eps=1e9)
    xj4 = torch.cat([ops.abs(), torch.ones_like(gm)[:, None]], 1)
    scale = w @ xj4
    torch.cuda.synchronize()
    _within_term_scale(got[rows], want, scale, 1e-4)
    assert torch.equal(got, again)


@pytest.mark.parametrize("backend,count", [
    ("pallas", lambda: direct_kernel.LAUNCHES),
    ("pallas-mxu", lambda: mxu_kernel.LAUNCHES),
    ("nlist", lambda: nlist.LAUNCHES["newton"]),
])
@pytest.mark.parametrize("rungs", [2, 3])
def test_simulator_multirate_launches_its_kernels(cuda, backend, count,
                                                  rungs):
    """A multirate run launches the backend's kernel once for the carry,
    then a step's full evaluation and its kicks: 1 + 4 (two rungs, sub 4)
    or 1 + 4 + 2 (three rungs) a step."""
    cfg = SimulationConfig(n=4096, steps=3, integrator="multirate",
                           multirate_rungs=rungs, eps=1e9,
                           force_backend=backend, nlist_rcut=(
                               1e11 if backend == "nlist" else 0.0))
    sim = Simulator(cfg)
    before = count()
    stats = sim.run()
    per_step = 5 if rungs == 2 else 7
    assert count() - before == stats["kernel_launches"] == 1 + 3 * per_step
    assert bool(torch.isfinite(stats["final_state"].positions).all())


def _disk_state(n, dtype, device, seed):
    rng = np.random.default_rng(seed)
    r = torch.from_numpy(rng.exponential(3.0, n))
    phi = torch.from_numpy(rng.uniform(0.0, 2.0 * np.pi, n))
    pos = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                       torch.from_numpy(0.3 * rng.normal(size=n))], 1)
    pos[0] = 0.0
    masses = torch.full((n,), 5.0 / n, dtype=torch.float64)
    masses[0] = 1.0
    return pos.to(device, dtype), masses.to(device, dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
def test_tree_near_field_kernel_matches_plain(cuda, dtype, tol):
    """The octree's near field: nlist_pair's untruncated newton form on
    the leaf blocks of a disk (depth 5, leaf_cap 8: the central leaves
    overflow), one launch counted under "near", the same bits again."""
    from gravity_tpu_torch.ops import tree

    pos, masses = _disk_state(4096, dtype, cuda, seed=5)
    _, origin, span, coords = tree.build_octree(pos, masses, 5)
    cells_pos, cells_m, count, *_ = bin_to_cells(pos, masses, coords, 32, 8)
    assert int(count.max()) > 8
    args = (cells_pos, count, cells_pos, cells_m, count, 32,
            pos.new_zeros(1))
    kw = dict(cutoff=1e-10, eps=0.05, use_rcut=False, kind="newton")
    before = dict(nlist.LAUNCHES)
    got = nlist.pair_cells_kernel(*args, **kw)
    assert nlist.LAUNCHES == {**before, "near": before["near"] + 1}
    again = nlist.pair_cells_kernel(*args, **kw)
    want = nlist.pair_cells_plain(*args, **kw)
    scale = nlist.pair_cells_plain(*args, absolute=True, **kw)
    torch.cuda.synchronize()
    _within_term_scale(got, want, scale, tol)
    assert torch.equal(got, again)


def test_tree_runs_its_near_field_through_the_kernel(cuda):
    """--tree-near nlist launches the near field once an evaluation (the
    gather near field none; a two-rung multirate step 1 + 4 times); where
    nothing overflows both near fields agree (fp64, 1e-9 of the mean
    |a|)."""
    from gravity_tpu_torch.ops import tree

    for near, integrator, launches in (("nlist", "leapfrog", 6),
                                       ("gather", "leapfrog", 0),
                                       ("nlist", "multirate", 16)):
        cfg = SimulationConfig(model="disk", n=4096, steps=5 if integrator
                               == "leapfrog" else 3, g=1.0, dt=2e-3,
                               eps=0.05, integrator=integrator,
                               force_backend="tree", tree_near=near)
        before = nlist.LAUNCHES["near"]
        stats = Simulator(cfg).run()
        assert nlist.LAUNCHES["near"] - before == \
            stats["kernel_launches"] == launches
        assert bool(torch.isfinite(stats["final_state"].positions).all())
    pos, masses = _system(2000, torch.float64, cuda, seed=9)
    kw = dict(depth=3, leaf_cap=64, g=6.6743e-11, eps=1e9)
    a = tree.tree_accelerations(pos, masses, near_mode="nlist", **kw)
    b = tree.tree_accelerations(pos, masses, near_mode="gather", **kw)
    assert float((a - b).abs().max() / b.norm(dim=1).mean()) < 1e-9


# The bf16 form of nlist_pair against the plain version at bf16, in units
# of each row's sum of |terms|. Both round every op of a term alike and
# take the same masks; a term differs only where rsqrt.approx and the
# plain rsqrt round inv_r to bf16 one ulp apart (3 x 2^-8 of that term
# through the weight's three products). Each row is an fp32 sum in
# another order (~cap 2^-24 apart), rounded to bf16 once, and then added
# into the bf16 accumulator: where a row lands one ulp (2^-7 of at most
# the row's sum of |terms|) apart, the accumulator carries it. A few such
# ulps a target: 2^-5.
NLIST_BF16_TOL = 2.0**-5


@pytest.mark.parametrize("use_rcut", [True, False])
@pytest.mark.parametrize("t_cap,cap", [(64, 64), (32, 32), (20, 33),
                                       (128, 256)])
def test_nlist_bf16_kernel_matches_plain(cuda, t_cap, cap, use_rcut):
    """The bf16 form against the plain version at bf16 (rcut_eff^2 and
    G m rounded to bf16 as the path makes them): targets = sources and a
    t_cap below the cap, counts over the cap (side 3 at N = 20,000), one
    launch counted under its kind's key, the same bits again."""
    n, side, rcut = 20_000, 3 if cap < 64 else 6, 1.5e11
    pos, masses = _system(n, torch.bfloat16, cuda, seed=t_cap + cap)
    origin, span, params, _, binned = nlist.source_cells(
        pos, masses, rcut=rcut, side=side, cap=cap)
    cells_pos, cells_m, count = binned[:3]
    targets = pos[:n // 4] if t_cap < cap else pos
    tcells = bin_to_cells(targets, torch.ones_like(targets[:, 0]),
                          grid_coords(targets, origin, span, side), side,
                          t_cap)
    args = (tcells[0], tcells[2], cells_pos, cells_m * 6.6743e-11, count,
            side, params)
    assert params.dtype == torch.bfloat16
    kw = dict(cutoff=1e-10, eps=1e9, use_rcut=use_rcut, kind="newton")
    key = nlist.launch_key("newton", use_rcut, torch.bfloat16)
    assert key.endswith("_bf16")
    before = nlist.LAUNCHES[key]
    got = nlist.pair_cells_kernel(*args, **kw)
    again = nlist.pair_cells_kernel(*args, **kw)
    assert nlist.LAUNCHES[key] == before + 2
    want = nlist.pair_cells_plain(*args, **kw)
    scale = nlist.pair_cells_plain(*args, absolute=True, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    _within_term_scale(got, want, scale, NLIST_BF16_TOL)
    empty = (torch.arange(t_cap, device=cuda)[None, :]
             >= tcells[2].clamp_max(t_cap)[:, None])
    assert bool((got[empty] == 0).all())


def test_nlist_bf16_form_keeps_a_subnormal_weight(cuda):
    """G m / r^3 = 1e-39 lies in bf16's subnormal range: the bf16 form
    gives the plain version's bits, the light body's pull not flushed."""
    pos = torch.tensor([[0.0, 0.0, 0.0], [1e12, 0.0, 0.0],
                        [2.2e12, 0.0, 0.0]], dtype=torch.bfloat16)
    masses = torch.tensor([1e24, 1.5e7, 0.0], dtype=torch.bfloat16)
    kw = dict(rcut=1.2e12, side=2, cap=8)
    want = nlist.nlist_accelerations(pos, masses, **kw)
    got = nlist.nlist_accelerations(pos.to(cuda), masses.to(cuda), **kw)
    assert torch.equal(got.cpu(), want) and float(got[0, 0]) != 0.0


@pytest.mark.parametrize("eps", [0.0, 1e9])
@pytest.mark.parametrize("m,k", [(1, 1), (1, 255), (3, 257), (257, 7),
                                 (300, 513), (511, 1023)])
def test_bf16_packed_layouts_match_plain(cuda, m, k, eps):
    """nbody_direct's bf16 form holds a thread's two targets in the two
    halves of a register and stages each source in both: M = 1 and ragged
    M (a thread's second target past M), odd K (zero-mass padding in the
    last tile), the same bits again."""
    pos, masses = _system(max(m, k), torch.bfloat16, cuda, seed=3 * m + k)
    pos_i, pos_j, m_j = pos[:m].contiguous(), pos[:k].contiguous(), masses[:k]
    got = direct_kernel.accelerations_vs_kernel(pos_i, pos_j, m_j, eps=eps)
    again = direct_kernel.accelerations_vs_kernel(pos_i, pos_j, m_j, eps=eps)
    want = accelerations_vs(pos_i, pos_j, m_j, eps=eps)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _within_term_scale(got, want, _term_scale(pos_i, pos_j, m_j, eps),
                       BF16_TOL)


@pytest.mark.parametrize("eps", [0.0, 1e9])
def test_direct_bf16_form_keeps_a_subnormal_weight(cuda, eps):
    """G m / r^3 = 1e-39 lies in bf16's subnormal range: the packed bf16x2
    products keep it, and the light body's pull is the plain version's
    bits, not 0."""
    pos = torch.tensor([[0.0, 0.0, 0.0], [1e12, 0.0, 0.0],
                        [2.2e12, 0.0, 0.0]], dtype=torch.bfloat16)
    masses = torch.tensor([1e24, 1.5e7, 0.0], dtype=torch.bfloat16)
    want = accelerations_vs(pos, pos, masses, eps=eps)
    got = direct_kernel.accelerations_vs_kernel(
        pos.to(cuda), pos.to(cuda), masses.to(cuda), eps=eps)
    assert torch.equal(got.cpu(), want) and float(got[0, 0]) != 0.0


@pytest.mark.parametrize("use_rcut", [True, False])
@pytest.mark.parametrize("t_cap,cap", [(33, 131), (1, 255), (17, 129)])
def test_nlist_bf16_odd_source_counts_match_plain(cuda, t_cap, cap,
                                                  use_rcut):
    """nlist_pair's bf16 form takes two sources of a target a step, from
    pairs staged 128 sources at a time: odd source counts (the last pair's
    high half a no-op), counts past one staging tile and past the cap,
    and a ragged t_cap, against the plain version; the same bits again."""
    rng = np.random.default_rng(t_cap + cap)
    side, n = 2, 8
    counts = [1, 3, 5, 127, 129, 131, cap, cap + 4]
    t_count = torch.tensor([min(c, t_cap + 2) for c in counts[::-1]])
    s_count = torch.tensor(counts)
    c = torch.arange(n)
    corner = torch.stack([c // 4, (c // 2) % 2, c % 2], 1).double()
    tpos = corner[:, None] + torch.from_numpy(rng.uniform(0, 1, (n, t_cap, 3)))
    spos = corner[:, None] + torch.from_numpy(rng.uniform(0, 1, (n, cap, 3)))
    gm = torch.from_numpy(rng.uniform(0.5, 1.5, (n, cap))) / 1000
    gm = torch.where(torch.arange(cap)[None] < s_count[:, None], gm, 0.0)
    bf = torch.bfloat16
    args = (tpos.to(cuda, bf), t_count.to(cuda), spos.to(cuda, bf),
            gm.to(cuda, bf), s_count.to(cuda), side,
            torch.tensor([1.0], dtype=bf, device=cuda))
    kw = dict(cutoff=1e-10, eps=0.05, use_rcut=use_rcut, kind="newton")
    got = nlist.pair_cells_kernel(*args, **kw)
    again = nlist.pair_cells_kernel(*args, **kw)
    want = nlist.pair_cells_plain(*args, **kw)
    scale = nlist.pair_cells_plain(*args, absolute=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _within_term_scale(got, want, scale, NLIST_BF16_TOL)


def test_nlist_bf16_form_refuses_the_ewald_kind(cuda):
    pos, masses = _system(64, torch.bfloat16, cuda)
    origin, span = bounding_cube(pos)
    coords = grid_coords(pos, origin, span, 2)
    cells_pos, cells_m, count, *_ = bin_to_cells(pos, masses, coords, 2, 64)
    params = torch.ones(2, dtype=torch.bfloat16, device=cuda)
    before = dict(nlist.LAUNCHES)
    with pytest.raises(ValueError, match="pm.py:286"):
        nlist.pair_cells_kernel(cells_pos, count, cells_pos, cells_m, count,
                                2, params, cutoff=1e-10, eps=1e9,
                                kind="ewald")
    assert nlist.LAUNCHES == before


def test_simulator_runs_bf16_cell_lists_through_the_kernel(cuda):
    """A bf16 state through nlist (leapfrog and multirate) and the octree
    with --tree-near nlist: the bf16 form launches once a force
    evaluation, counted under its own key, and the state stays bf16 and
    finite."""
    for fields, key, launches in (
            (dict(model="random", n=4096, force_backend="nlist",
                  nlist_rcut=1e11, eps=1e9), "newton_bf16", 6),
            (dict(model="random", n=4096, force_backend="nlist",
                  nlist_rcut=1e11, eps=1e9, integrator="multirate"),
             "newton_bf16", 26),
            (dict(model="disk", n=4096, g=1.0, dt=2e-3, eps=0.05,
                  force_backend="tree", tree_near="nlist"), "near_bf16",
             6)):
        cfg = SimulationConfig(**{"integrator": "leapfrog", **fields},
                               steps=5, dtype="bfloat16", progress_every=5)
        before = nlist.LAUNCHES[key]
        stats = Simulator(cfg).run()
        assert nlist.LAUNCHES[key] - before == \
            stats["kernel_launches"] == launches
        final = stats["final_state"]
        assert final.positions.dtype == torch.bfloat16
        assert bool(torch.isfinite(final.positions).all())


def _bits(t):
    return t.cpu().contiguous().view(torch.int16)


def _cancelling(gen, rows, cols):
    """bf16 pairs +m 2^-126, -(m +- 1) 2^-126, m in [129, 254]: no tiny row
    (nonzero, below 2^-119), partial sums that land on 2^-126."""
    m = torch.randint(129, 255, (rows // 2, cols), generator=gen).float()
    step = torch.randint(0, 2, (rows // 2, cols), generator=gen) * 2.0 - 1.0
    pairs = torch.stack([m, -(m + step)], dim=1).reshape(rows, cols)
    return (pairs * 2.0**-126).to(torch.bfloat16)


def _tiny_early(gen):
    """1,048,576 rows of one segment, 4 columns: a subnormal at row 3 of
    normal values; 2^-119 and the subnormal -2^-127 opening a column of
    signed zeros, whose total the flush leaves at 2^-119 (unflushed:
    255 2^-127); no tiny row; a tiny normal -1.5 2^-126 at row 5."""
    rows = 1 << 20
    values = torch.randn(rows, 4, generator=gen)
    values[3, 0] = 2.0**-130
    values[:, 1] = torch.tensor([0.0, -0.0])[
        torch.randint(0, 2, (rows,), generator=gen)]
    values[:2, 1] = torch.tensor([2.0**-119, -(2.0**-127)])
    values[5, 3] = -1.5 * 2.0**-126
    return values.to(torch.bfloat16)


def _segment_edge_case(name):
    """(values, ids, n) of one edge case of the bf16 segment sums, made on
    the CPU from a seed."""
    gen = torch.Generator().manual_seed(len(name))

    def pick(choices, shape):
        table = torch.tensor(choices, dtype=torch.float32)
        return table[torch.randint(0, len(choices), shape, generator=gen)]

    if name == "ones_stall_at_256":
        ids = torch.repeat_interleave(torch.arange(3),
                                      torch.tensor([4000, 700, 300]))
        return torch.ones(5000, 3, dtype=torch.bfloat16), ids, 3
    if name == "signed_zeros":
        return (pick([0.0, -0.0], (400, 4)).to(torch.bfloat16),
                torch.randint(0, 6, (400,), generator=gen), 6)
    if name == "subnormals":
        return (pick([2.0**-130, -(2.0**-131), 2.0**-133, 2.0**-126,
                      -1.5 * 2.0**-126, 0.0], (600, 4)).to(torch.bfloat16),
                torch.randint(0, 5, (600,), generator=gen), 5)
    if name == "inf_and_nan":
        inf = float("inf")
        return (pick([inf, -inf, 1.0, 2.0, 3e38, float("nan")], (600, 3))
                .to(torch.bfloat16),
                torch.randint(0, 40, (600,), generator=gen), 40)
    if name == "empty_segments":
        ids = torch.tensor([3, 17, 18, 4000])[
            torch.randint(0, 4, (5000,), generator=gen)]
        return torch.randn(5000, 4, generator=gen).to(torch.bfloat16), ids, \
            8192
    if name == "tiny_early_in_long_segment":
        return _tiny_early(gen), torch.zeros(1 << 20, dtype=torch.int64), 1
    if name == "cancel_to_least_normal":
        return (_cancelling(gen, 1 << 18, 4),
                torch.arange(16).repeat_interleave(1 << 14), 16)
    # lengths about the kernel's 8-row chunks and its long-segment edge
    lengths = torch.tensor([0, 1, 7, 8, 9, 15, 16, 17, 255, 256, 257, 513,
                            4097, 70000, 3])
    ids = torch.repeat_interleave(torch.arange(lengths.numel()), lengths)
    ids = ids[torch.randperm(ids.numel(), generator=gen)]
    return (torch.randn(ids.numel(), 3, generator=gen).to(torch.bfloat16),
            ids, lengths.numel())


@pytest.mark.parametrize("n_seg,cols,n", [(1, 1, 200_000), (1, 3, 200_000),
                                          (8, 6, 200_000),
                                          (4096, 3, 200_000),
                                          (1 << 21, 1, 200_000),
                                          (1, 3, 1 << 20), (3, 8, 10_000)])
def test_segment_sum_bf16_kernel_matches_plain(cuda, n_seg, cols, n):
    """The bf16 segment sums on the card against the CPU's element-order
    sums of the same inputs: the same bits (the same adds, in the same
    order), also on a second launch; one launch counted each. Among them
    1,048,576 rows in one segment: one chain of adds."""
    from gravity_tpu_torch.ops import cells

    gen = torch.Generator().manual_seed(n_seg + cols)
    ids = torch.randint(0, n_seg, (n,), generator=gen)
    values = (torch.rand(n, cols, generator=gen) * 1e-3 + 1e-4).to(
        torch.bfloat16).squeeze(1)
    before = cells.LAUNCHES
    got = cells.segment_sum_bf16(values.to(cuda), ids.to(cuda), n_seg)
    again = cells.segment_sum_bf16(values.to(cuda), ids.to(cuda), n_seg)
    assert cells.LAUNCHES == before + 2
    want = cells.segment_sum_bf16_plain(values, ids, n_seg)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, again) and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", ["ones_stall_at_256", "signed_zeros",
                                  "subnormals", "inf_and_nan",
                                  "empty_segments", "lengths",
                                  "tiny_early_in_long_segment",
                                  "cancel_to_least_normal"])
def test_segment_sum_bf16_edge_cases_match_plain(cuda, name):
    """Edge cases, bit for bit (a NaN total too: 0x7fc0, the CPU's; the
    JAX package's flush of subnormals, which a tiny row early in a
    1,048,576-row segment sends down the kernel's flushing chain, and
    sums that cancel down to 2^-126 without one, which it does not), a
    mass and a weighted position merged into one launch."""
    from gravity_tpu_torch.ops import cells

    values, ids, n = _segment_edge_case(name)
    mass, pos = values[:, 0].contiguous(), values[:, 1:].contiguous()
    before = cells.LAUNCHES
    got = cells.Segments(ids.to(cuda), n).sum(mass.to(cuda), pos.to(cuda))
    again = cells.Segments(ids.to(cuda), n).sum(mass.to(cuda), pos.to(cuda))
    torch.cuda.synchronize()
    assert cells.LAUNCHES == before + 2
    for g, a, v in zip(got, again, (mass, pos)):
        want = cells.segment_sum_bf16_plain(v, ids, n)
        assert torch.equal(_bits(g), _bits(want))
        assert torch.equal(_bits(g), _bits(a))


@pytest.mark.parametrize("depth,quad", [(7, True), (3, False)])
def test_bf16_tree_build_launches_exactly(cuda, monkeypatch, depth, quad):
    """A bf16 octree build launches the segment sums exactly twice a level
    with quadrupoles (masses with weighted positions, then quadrupoles),
    once without, and gives the bits of the same build whose sums are the
    plain version's."""
    from gravity_tpu_torch.ops import cells, tree

    rng = np.random.default_rng(depth)
    pos = torch.from_numpy(rng.normal(size=(50_000, 3))).to(torch.bfloat16)
    m = torch.from_numpy(rng.uniform(1, 2, 50_000)).to(torch.bfloat16)
    pos, m = pos.to(cuda), m.to(cuda)
    before = cells.LAUNCHES
    got = tree.build_octree(pos, m, depth, quad=quad)[0]
    torch.cuda.synchronize()
    assert cells.LAUNCHES - before == (2 if quad else 1) * (depth + 1)

    class PlainSegments(cells.Segments):
        def sum(self, *values):
            return [cells.segment_sum_bf16_plain(
                v.cpu(), self.ids.cpu(), self.n).to(v.device) for v in values]

    monkeypatch.setattr(tree, "Segments", PlainSegments)
    want = tree.build_octree(pos, m, depth, quad=quad)[0]
    for level, ref in zip(got, want):
        for g, w in zip(level, ref):
            assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("mode", ["on", "off"])
def test_every_block_is_fenced_by_its_own_event(cuda, monkeypatch, mode):
    """With nothing queued behind a block (no watchdog, frames, saves,
    ledger or sentinel) the run loop still waits on the block's own CUDA
    event, in both modes: its completion is observed, never assumed."""
    blocks = []
    dispatch = Simulator._dispatch_companions

    def spy(self, *args, **kwargs):
        blocks.append(dispatch(self, *args, **kwargs))
        return blocks[-1]

    monkeypatch.setattr(Simulator, "_dispatch_companions", spy)
    cfg = SimulationConfig(model="random", n=1024, steps=20,
                           progress_every=5, force_backend="pallas",
                           nan_check=False, io_pipeline=mode)
    stats = Simulator(cfg).run()
    assert stats["io_pipeline"] == mode
    assert len(blocks) == 4
    assert all(b.event is not None and b.event.query() for b in blocks)
    assert 0.0 <= stats["host_gap_frac"] <= 1.0


# --- the FMM: plain PyTorch on the card, against the same functions on the
# CPU (fp64: every row within 1e-9 of its |a|; fp32: median relative 1e-5,
# max 1e-3, the summation-order bars of tests/test_torch_fmm.py) ---


def _fmm_disk(n, dtype, seed=3):
    rng = np.random.default_rng(seed)
    r = rng.exponential(3.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    pos = np.stack([r * np.cos(phi), r * np.sin(phi),
                    0.3 * rng.normal(size=n)], axis=1)
    m = np.full(n, 5.0 / (n - 1))
    pos[0], m[0] = 0.0, 1.0
    return torch.from_numpy(pos).to(dtype), torch.from_numpy(m).to(dtype)


def _fmm_close(got, want, dtype):
    want = want.double()
    rel = (got.cpu().double() - want).norm(dim=1) / want.norm(dim=1)
    if dtype == torch.float64:
        assert float(rel.max()) < 1e-9
    else:
        assert float(rel.median()) < 1e-5 and float(rel.max()) < 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", ["dense", "vs", "sparse", "window",
                                  "ranks"])
def test_fmm_on_the_card_matches_the_cpu(cuda, form, dtype):
    from gravity_tpu_torch.ops import fmm, sfmm

    pos, m = _fmm_disk(8192, dtype)
    kw = dict(g=1.0, eps=0.05)
    if form == "dense":
        def fn(p, w):
            return fmm.fmm_accelerations(p, w, depth=5, leaf_cap=16, **kw)
    elif form == "vs":
        def fn(p, w):
            tg = torch.cat([p[::5], p[:2] * 40.0])
            return fmm.fmm_accelerations_vs(tg, p, w, depth=5, leaf_cap=16,
                                            t_cap=4, **kw)
    else:
        k = 256 if form == "ranks" else 8192

        def fn(p, w):
            return sfmm.sfmm_accelerations(
                p, w, depth=6, leaf_cap=8, k_cells=k, k_chunk=256,
                far_mode="window" if form == "window" else "gather", **kw)
    before = (direct_kernel.LAUNCHES, dict(nlist.LAUNCHES))
    got = fn(pos.to(cuda), m.to(cuda))
    torch.cuda.synchronize()
    assert (direct_kernel.LAUNCHES, dict(nlist.LAUNCHES)) == before
    assert got.device.type == "cuda" and got.dtype == dtype
    _fmm_close(got, fn(pos, m), dtype)


@pytest.mark.parametrize("solver", ["dense", "sparse", "tree"])
def test_fmm_and_tree_repeat_their_bits_on_the_card(cuda, solver):
    """The fp32 segment sums of the FMM and the tree take no atomics (one
    chain a segment over a stable sort), so every evaluation on the card
    gives the bits of the first; the dense FMM's card-against-CPU bar
    (median 1e-5) holds in each of 10 evaluations."""
    from gravity_tpu_torch.ops import fmm, sfmm, tree

    pos, m = _fmm_disk(8192, torch.float32)
    kw = dict(g=1.0, eps=0.05)
    fn = {
        "dense": lambda p, w: fmm.fmm_accelerations(p, w, depth=5,
                                                    leaf_cap=16, **kw),
        "sparse": lambda p, w: sfmm.sfmm_accelerations(
            p, w, depth=6, leaf_cap=8, k_cells=8192, k_chunk=256, **kw),
        "tree": lambda p, w: tree.tree_accelerations(p, w, depth=5, **kw),
    }[solver]
    want = fn(pos, m)
    first = fn(pos.to(cuda), m.to(cuda))
    for _ in range(10 if solver == "dense" else 2):
        got = fn(pos.to(cuda), m.to(cuda))
        assert torch.equal(got, first)
        if solver != "tree":
            _fmm_close(got, want, torch.float32)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-10)])
def test_fmm_potential_on_the_card_matches_the_cpu(cuda, dtype, tol):
    from gravity_tpu_torch.ops import fmm

    pos, m = _fmm_disk(8192, dtype)
    kw = dict(depth=5, leaf_cap=16, g=1.0, eps=0.05)
    got = fmm.fmm_potential_energy(pos.to(cuda), m.to(cuda), **kw)
    want = fmm.fmm_potential_energy(pos, m, **kw)
    assert abs(got - want) <= tol * abs(want)


def test_simulator_runs_the_fmm_on_the_card(cuda):
    """The FMM preset's layout at 8,192 bodies: sparse by occupancy, plain
    PyTorch on the card (no kernel launched), finite, its occupancy
    audited."""
    cfg = SimulationConfig(model="disk", n=8192, steps=3, g=1.0, dt=2e-3,
                           eps=0.05, integrator="leapfrog",
                           force_backend="fmm")
    sim = Simulator(cfg, device=cuda)
    assert sim.fmm_sparse
    stats = sim.run()
    assert stats["kernel_launches"] == 0 and stats["fmm_mode"] == "sparse"
    assert not stats["sfmm_final_occupancy"]["overflow"]
    assert bool(torch.isfinite(stats["final_state"].positions).all())


def _serve_batch(dtype, device):
    """B = 4 slots of bucket 1,024: a padded 700-body Plummer sphere, a
    full random cube, the padded 3-body solar system and an empty slot."""
    from gravity_tpu_torch.simulation import make_initial_state

    pos, mass = [], []
    for model, n in (("plummer", 700), ("random", 1024), ("solar", 3)):
        state = make_initial_state(
            SimulationConfig(model=model, n=n, dtype="float64"), device)
        padded, _ = state.pad_to(1024)
        pos.append(padded.positions)
        mass.append(padded.masses)
    pos.append(torch.zeros_like(pos[0]))
    mass.append(torch.zeros_like(mass[0]))
    return (torch.stack(pos).to(dtype).contiguous(),
            torch.stack(mass).to(dtype).contiguous())


@pytest.mark.parametrize("dtype,eps,rtol", [
    (torch.float32, 0.0, 1e-4), (torch.float32, 1e9, 1e-4),
    (torch.float64, 0.0, 1e-12), (torch.bfloat16, 1e9, 3 * 2.0**-8)])
def test_batched_direct_kernel(cuda, dtype, eps, rtol):
    """The batched launch: one launch a batched evaluation, each slot the
    bits of a solo launch on its arrays, and the plain version within the
    kernel table's bar in units of each row's sum of |terms| (fp32 1e-4,
    fp64 1e-12, bf16 3 x 2^-8)."""
    pos, mass = _serve_batch(dtype, cuda)
    before = direct_kernel.BATCHED_LAUNCHES
    got = direct_kernel.accelerations_vs_batched_kernel(pos, pos, mass,
                                                        eps=eps)
    assert direct_kernel.BATCHED_LAUNCHES == before + 1
    solo = torch.stack([direct_kernel.accelerations_vs_kernel(
        pos[b], pos[b], mass[b], eps=eps) for b in range(4)])
    assert torch.equal(got, solo)
    want = direct_kernel.accelerations_vs_batched(pos, pos, mass, eps=eps)
    torch.cuda.synchronize()
    assert bool((got[3] == 0).all())
    from gravity_tpu_torch.constants import CUTOFF_RADIUS, G
    from gravity_tpu_torch.ops.forces import _pair_weights

    for b in range(3):
        p64, m64 = pos[b].double(), mass[b].double()
        diff = p64[None, :, :] - p64[:, None, :]
        w = _pair_weights((diff * diff).sum(-1), m64[None, :], G,
                          CUTOFF_RADIUS, eps)
        scale = (w[:, :, None] * diff.abs()).sum(dim=1)
        _within_term_scale(got[b], want[b], scale, rtol)


@pytest.mark.parametrize("bf16", [False, True])
def test_batched_mxu_kernel(cuda, bf16):
    """The Gram form's batched launch: one launch a batched evaluation,
    each slot the bits of a solo launch (the whole wrapper, and [S | W]
    on the same operands), and [S | W] within 1e-4 of the plain
    version's term scale."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    pos, mass = _serve_batch(dtype, cuda)
    before = mxu_kernel.BATCHED_LAUNCHES
    got = mxu_kernel.accelerations_vs_mxu_batched_kernel(pos, pos, mass,
                                                         eps=1e9)
    assert mxu_kernel.BATCHED_LAUNCHES == before + 1
    solo = torch.stack([mxu_kernel.accelerations_vs_mxu_kernel(
        pos[b], pos[b], mass[b], eps=1e9) for b in range(4)])
    assert torch.equal(got, solo)
    ops = torch.stack([(pos[b].float() - pos[b].float().mean(dim=0))
                       .to(dtype) for b in range(4)]).contiguous()
    gm = (mass.float() * 6.6743e-11).contiguous()
    acc4 = mxu_kernel.gram_acc4_batched(ops, ops, gm, cutoff=1e-10, eps=1e9)
    for b in range(4):
        assert torch.equal(acc4[b], mxu_kernel.gram_acc4(
            ops[b], ops[b], gm[b], cutoff=1e-10, eps=1e9))
        want = mxu_kernel.gram_acc4_plain(ops[b], ops[b], gm[b],
                                          cutoff=1e-10, eps=1e9, bf16=bf16)
        x = ops[b].float()
        w = mxu_kernel._gram_weights(x, mxu_kernel._norm2(x), x,
                                     mxu_kernel._norm2(x), gm[b],
                                     cutoff=1e-10, eps=1e9)
        xj4 = torch.cat([x.abs(), torch.ones_like(gm[b])[:, None]], 1)
        scale = (w[:, :, None] * xj4[None, :, :]).sum(dim=1)
        _within_term_scale(acc4[b], want, scale, 1e-4)


@pytest.mark.parametrize("backend", ["pallas", "pallas-mxu"])
def test_served_job_matches_padded_solo_bit_for_bit(cuda, backend):
    """A served job on the card: one build, one batched launch a force
    evaluation, and the bits of the solo run of its bucket-padded
    state."""
    from gravity_tpu_torch.serve import EnsembleScheduler, bucket_size
    from gravity_tpu_torch.simulation import make_initial_state

    config = SimulationConfig(model="plummer", n=700, steps=30, dt=3600.0,
                              eps=1e9, integrator="leapfrog",
                              force_backend=backend)
    counter = direct_kernel if backend == "pallas" else mxu_kernel
    before = counter.BATCHED_LAUNCHES
    with EnsembleScheduler(slots=2, slice_steps=10, device=cuda) as sched:
        jid = sched.submit(config)
        sched.run_until_idle()
        got = sched.result(jid)
        assert list(sched.engine.compile_counts.values()) == [1]
        assert counter.BATCHED_LAUNCHES - before == \
            sched.engine.force_evals[backend] == 30
    state = make_initial_state(config, cuda)
    padded, _ = state.pad_to(bucket_size(config.n))
    solo = Simulator(dataclasses.replace(config, n=padded.n),
                     state=padded).run()["final_state"]
    assert torch.equal(got.positions.to(cuda), solo.positions[:config.n])
    assert torch.equal(got.velocities.to(cuda), solo.velocities[:config.n])


# The served cell list (README's cell-list workload at serving size: rcut
# 5e10 m, side 12, cap 32) at B = 4 slots of bucket 1,024.
SERVE_NLIST = dict(rcut=5e10, side=12, cap=32, eps=1e9)


def _serve_nlist_batch(dtype, device):
    """A padded 700-body random cube, a full one, a padded 300-body one
    and an empty slot, bucket 1,024."""
    from gravity_tpu_torch.simulation import make_initial_state

    pos, mass = [], []
    for n, seed in ((700, 0), (1024, 1), (300, 2)):
        state = make_initial_state(SimulationConfig(
            model="random", n=n, seed=seed, dtype="float64"), device)
        padded, _ = state.pad_to(1024)
        pos.append(padded.positions)
        mass.append(padded.masses)
    pos.append(torch.zeros_like(pos[0]))
    mass.append(torch.zeros_like(mass[0]))
    return (torch.stack(pos).to(dtype).contiguous(),
            torch.stack(mass).to(dtype).contiguous())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12),
                                       (torch.bfloat16, 2.0**-5)])
def test_batched_nlist_kernel(cuda, dtype, tol):
    """The batched pair tiles: one launch a batched evaluation, each slot
    the bits of a solo launch on its arrays, and the plain version within
    the kernel table's bar in units of each row's sum of |terms|."""
    from gravity_tpu_torch.constants import G

    pos, mass = _serve_nlist_batch(dtype, cuda)
    kw = {k: SERVE_NLIST[k] for k in ("rcut", "side", "cap")}
    _, _, params, _, binned = nlist.source_cells_batched(pos, mass, **kw)
    cells_pos, cells_mass, count = binned[:3]
    args = (cells_pos, count, cells_pos, cells_mass * G, count,
            SERVE_NLIST["side"], params)
    key = nlist.launch_key("newton", True, dtype) + "/batched"
    before = nlist.LAUNCHES[key]
    got = nlist.pair_cells_kernel_batched(*args, cutoff=1e-10, eps=1e9)
    assert nlist.LAUNCHES[key] == before + 1
    for b in range(4):
        solo_args = tuple(a[b] for a in args[:5]) + (
            SERVE_NLIST["side"], params[b:b + 1])
        solo = nlist.pair_cells_kernel(*solo_args, cutoff=1e-10, eps=1e9)
        assert torch.equal(got[b], solo)
        want = nlist.pair_cells_plain(*solo_args, cutoff=1e-10, eps=1e9)
        scale = nlist.pair_cells_plain(*solo_args, cutoff=1e-10, eps=1e9,
                                       absolute=True)
        _within_term_scale(got[b], want, scale, tol)
    assert bool((got[3] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_batched_nlist_evaluation_is_solo_bits(cuda, dtype):
    """The whole batched cell list (binning, totals, tiles, overflow
    channels, un-binning) on the card: each slot the bits of its solo
    evaluation, the same bits on a second run, finite everywhere."""
    pos, mass = _serve_nlist_batch(dtype, cuda)
    got = nlist.nlist_accelerations_vs_batched(pos, mass, **SERVE_NLIST)
    again = nlist.nlist_accelerations_vs_batched(pos, mass, **SERVE_NLIST)
    solo = torch.stack([nlist.nlist_accelerations_vs(
        pos[b], pos[b], mass[b], **SERVE_NLIST) for b in range(4)])
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    assert torch.equal(got, solo)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_served_nlist_job_matches_padded_solo_bit_for_bit(cuda, dtype):
    """A served nlist job on the card: one build, one batched launch a
    force evaluation, and the bits of the solo run of its bucket-padded
    state."""
    from gravity_tpu_torch.serve import EnsembleScheduler, bucket_size
    from gravity_tpu_torch.simulation import make_initial_state

    config = SimulationConfig(model="random", n=700, steps=30, dt=3600.0,
                              eps=1e9, integrator="leapfrog", dtype=dtype,
                              force_backend="nlist", nlist_rcut=5e10,
                              nlist_side=12, nlist_cap=32)
    key = "newton_bf16/batched" if dtype == "bfloat16" else "newton/batched"
    before = nlist.LAUNCHES[key]
    with EnsembleScheduler(slots=2, slice_steps=10, device=cuda) as sched:
        jid = sched.submit(config)
        sched.run_until_idle()
        assert sched.status(jid)["status"] == "completed"
        got = sched.result(jid)
        assert list(sched.engine.compile_counts.values()) == [1]
        assert nlist.LAUNCHES[key] - before == \
            sched.engine.force_evals["nlist"] == 30
    state = make_initial_state(config, cuda)
    padded, _ = state.pad_to(bucket_size(config.n))
    solo = Simulator(dataclasses.replace(config, n=padded.n),
                     state=padded).run()["final_state"]
    assert torch.equal(got.positions.to(cuda), solo.positions[:config.n])
    assert torch.equal(got.velocities.to(cuda), solo.velocities[:config.n])


@pytest.mark.parametrize("backend,dtype,integrator", [
    ("pallas", "float32", "leapfrog"), ("pallas", "float32", "yoshida4"),
    ("pallas-mxu", "float32", "leapfrog"), ("pallas", "bfloat16", "euler"),
    ("nlist", "float32", "leapfrog"), ("nlist", "bfloat16", "yoshida4"),
    ("dense", "float64", "leapfrog")])
def test_first_round_peak_within_the_estimate(cuda, backend, dtype,
                                              integrator):
    """The admission estimate of a cold key covers the measured peak of
    its first round (torch.cuda.max_memory_allocated over the round)."""
    from gravity_tpu_torch.serve import EnsembleScheduler
    from gravity_tpu_torch.telemetry import perf

    extra = (dict(nlist_rcut=5e10, nlist_side=12, nlist_cap=32)
             if backend == "nlist" else {})
    config = SimulationConfig(model="random", n=3000, steps=40, dt=3600.0,
                              eps=1e9, integrator=integrator, dtype=dtype,
                              force_backend=backend, **extra)
    perf.ledger().reset()
    with EnsembleScheduler(slots=4, slice_steps=20, device=cuda) as sched:
        for seed in range(3):
            sched.submit(dataclasses.replace(config, seed=seed))
        sched.run_round()
        (row,) = perf.ledger().rows_list()
    assert 0 < row["peak_bytes"] <= row["estimated_bytes"]


def test_nlist_round_error_fails_its_jobs_on_the_card(cuda, monkeypatch):
    """No fallback: a served nlist round whose kernel raises fails its
    jobs with the error and trips the nlist breaker; nothing runs the
    job through dense or chunked."""
    from gravity_tpu_torch.serve import EnsembleScheduler
    from gravity_tpu_torch.serve.breaker import BreakerOpen

    config = SimulationConfig(model="random", n=700, steps=30, dt=3600.0,
                              eps=1e9, integrator="leapfrog",
                              force_backend="nlist", nlist_rcut=5e10,
                              nlist_side=12, nlist_cap=32)
    with EnsembleScheduler(slots=2, slice_steps=10, device=cuda) as sched:
        assert sched.breakers.on_card
        jid = sched.submit(config)

        def broken(*args, **kwargs):
            raise RuntimeError("nlist_pair batched launch failed: test")

        monkeypatch.setattr(nlist, "pair_cells_kernel_batched", broken)
        with pytest.raises(RuntimeError, match="launch failed"):
            sched.run_round()
        st = sched.status(jid)
        assert st["status"] == "failed" and "launch failed" in st["error"]
        assert sched.breakers.snapshot()["nlist"]["state"] == "open"
        with pytest.raises(BreakerOpen):
            sched.submit(config)
        assert set(sched.engine.force_evals) <= {"nlist"}


# --- the slab form of nlist_pair.cu (the halo engine's pair tiles) ----------


def _slab_args(side, cap, dtype, device, kind, seed=5):
    """Cubic tile arguments of a 600-body state and the same grid cut into
    two slabs: each slab's targets and x-extended sources (planes past the
    grid zero)."""
    pos, masses = _system(600, dtype, device, seed=seed)
    origin, span = bounding_cube(pos)
    coords = grid_coords(pos, origin, span, side)
    cells_pos, cells_m, count, *_ = bin_to_cells(pos, masses, coords, side,
                                                 cap)
    cell = span / side
    params = (cell.reshape(1) ** 2 if kind == "newton"
              else torch.stack([(0.9 * cell) ** 2, 2.0 / cell]))
    gm = cells_m * 6.6743e-11
    cubic = (cells_pos, count, cells_pos, gm, count, side, params)
    sx, plane = side // 2, side * side

    def planes(t, lo, hi):
        return torch.cat([t[x * plane:(x + 1) * plane] if 0 <= x < side
                          else torch.zeros_like(t[:plane])
                          for x in range(lo, hi)])

    slabs = [(cells_pos[j * sx * plane:(j + 1) * sx * plane],
              count[j * sx * plane:(j + 1) * sx * plane],
              planes(cells_pos, j * sx - 1, (j + 1) * sx + 1),
              planes(gm, j * sx - 1, (j + 1) * sx + 1),
              planes(count, j * sx - 1, (j + 1) * sx + 1), sx, side, params)
             for j in range(2)]
    return cubic, slabs


SLAB_CASES = [("newton", torch.float32, 1e-4), ("newton", torch.float64,
                                                 1e-12),
              ("newton", torch.bfloat16, 2.0**-5),
              ("ewald", torch.float32, 1e-4), ("ewald", torch.float64,
                                                1e-12)]


@pytest.mark.parametrize("kind,dtype,tol", SLAB_CASES)
@pytest.mark.parametrize("side,cap", [(4, 64), (2, 16)])
def test_nlist_slab_kernel_matches_plain(cuda, side, cap, kind, dtype, tol):
    """Each slab launch against the plain slab engine, in units of each
    row's sum of |terms| (bf16: the solo bf16 form's bar); (2, 16)
    overflows its cells."""
    _, slabs = _slab_args(side, cap, dtype, cuda, kind)
    kw = dict(cutoff=1e-10, eps=1e9, kind=kind)
    key = nlist.launch_key(kind, True, dtype) + "/slab"
    for slab in slabs:
        before = nlist.LAUNCHES[key]
        got = nlist.pair_cells_slab_kernel(*slab, **kw)
        assert nlist.LAUNCHES[key] == before + 1
        plain_args = (*slab[:4], *slab[5:])
        want = nlist.pair_cells_slab_plain(*plain_args, **kw)
        scale = nlist.pair_cells_slab_plain(*plain_args, absolute=True,
                                            **kw)
        torch.cuda.synchronize()
        _within_term_scale(got, want, scale, tol)


@pytest.mark.parametrize("kind,dtype,tol", SLAB_CASES)
def test_nlist_slab_launches_give_the_cubic_launch_bits(cuda, kind, dtype,
                                                        tol):
    cubic, slabs = _slab_args(4, 64, dtype, cuda, kind)
    kw = dict(cutoff=1e-10, eps=1e9, kind=kind)
    solo = nlist.pair_cells_kernel(*cubic, **kw)
    got = torch.cat([nlist.pair_cells_slab_kernel(*s, **kw) for s in slabs])
    torch.cuda.synchronize()
    assert torch.equal(got, solo)


def test_slab_cuda_tensors_never_take_the_plain_engine(cuda, monkeypatch):
    """A CUDA launch goes to the kernel; a failed build raises, and
    nothing falls back to the plain slab engine."""
    _, slabs = _slab_args(4, 64, torch.float32, cuda, "newton")
    kw = dict(cutoff=1e-10, eps=1e9)

    def plain(*args, **kwargs):
        raise AssertionError("the plain slab engine ran for CUDA tensors")

    monkeypatch.setattr(nlist, "pair_cells_slab_plain", plain)
    assert nlist.pair_cells_slab_kernel(*slabs[0], **kw).is_cuda

    def broken():
        raise RuntimeError("nvcc failed: test")

    monkeypatch.setattr(nlist.LIBRARY, "load", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        nlist.pair_cells_slab_kernel(*slabs[0], **kw)
    with pytest.raises(ValueError, match="must be"):
        nlist.pair_cells_slab_kernel(*slabs[0][:2], slabs[0][0],
                                     *slabs[0][3:], **kw)
