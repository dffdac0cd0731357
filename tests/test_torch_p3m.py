"""The port's P3M solver against the JAX package.

Inputs are drawn with numpy from a seed and given to both packages:
``gravity_tpu_torch.ops.p3m`` (the plain versions, which is what CPU
tensors run) against ``gravity_tpu.ops.p3m`` and the P3M near field of
``gravity_tpu.ops.pallas_nlist`` through its jnp engine and through its
Pallas kernel in interpret mode. The states are thin disks around a
central point mass (the P3M run's geometry), in galactic units (G = 1).
Tolerances, each 3-10x the port-vs-JAX spread measured on these inputs:

- kernel transform: 1e-13 of its largest entry in float64 (measured
  5e-14: both are built in float64); in float32 the port's own float64
  build rounded once, bitwise, and the JAX entry within one float32 ulp
  plus that 1e-13;
- pair weight: 1e-6 of its largest value in fp32 (measured 2.4e-7; erf
  and exp differ by an ulp), 1e-15 in fp64 (measured 1.7e-16);
- near-field tiles: 3e-5 of the mean |a| (measured 6.1e-6);
- whole solver, max |delta a| over the mean |a|: fp32 2.5e-4 (measured
  up to 4.9e-5: the central mass's near field is ~400x the mean and
  rounds at fp32 ulp there), fp64 1e-13 (measured up to 1.5e-14);
- 10-step Simulator runs: 1e-5 per particle, as the other run tests.
"""

import json
import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.ops import p3m as jax_p3m
from gravity_tpu.ops import pallas_nlist as jax_nlist
from gravity_tpu.simulation import Simulator as JaxSimulator
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy, state_to_numpy
from gravity_tpu_torch.ops import cells, nlist, p3m
from gravity_tpu_torch.simulation import Simulator

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU, CUDA = torch.device("cpu"), torch.device("cuda", 0)
G1 = dict(g=1.0, eps=0.05)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _disk(n, seed=0, dtype=np.float32):
    """A thin exponential disk (scale length 3, height 0.3) of total mass
    5 around a unit point mass at the origin, with circular velocities."""
    rng = np.random.default_rng(seed)
    r = rng.exponential(3.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    pos = np.stack([r * np.cos(phi), r * np.sin(phi),
                    0.3 * rng.normal(size=n)], axis=1)
    v = np.sqrt(6.0 / np.maximum(r, 0.1))
    vel = np.stack([-v * np.sin(phi), v * np.cos(phi),
                    0.01 * rng.normal(size=n)], axis=1)
    masses = np.full(n, 5.0 / (n - 1))
    pos[0], vel[0], masses[0] = 0.0, 0.0, 1.0
    return pos.astype(dtype), vel.astype(dtype), masses.astype(dtype)


def _max_over_mean(got, want):
    want = np.asarray(want, np.float64)
    scale = np.linalg.norm(want, axis=1).mean()
    return np.abs(np.asarray(got, np.float64) - want).max() / scale


# --- the pieces ----------------------------------------------------------


@pytest.mark.parametrize("m2", [32, 64])
@pytest.mark.parametrize("dtype,name", [(torch.float32, "float32"),
                                        (torch.float64, "float64")])
def test_force_kernel_hat_matches_the_numpy_constants(m2, dtype, name):
    """Both packages build the transform in float64 (two FFT libraries,
    1e-13 of the scale apart) and round it once. float64: that bar.
    float32: the port's complex64 is its own complex128 rounded, bit for
    bit; against the JAX package, two correct roundings of values that
    far apart differ by at most one float32 ulp plus that gap (where the
    float64 values straddle a rounding boundary they land an ulp apart:
    4,641 imaginary entries at m2 = 64 on one machine)."""
    got = p3m.force_kernel_hat(m2, 1.25, dtype, CPU)
    want = jax_p3m._force_kernel_hat_np(m2, 1.25, name)
    assert len(got) == 3
    if name == "float32":
        full = p3m.force_kernel_hat(m2, 1.25, torch.float64, CPU)
        for kh, kf in zip(got, full):
            assert torch.equal(kh, kf.to(torch.complex64))
    for kh, (re, im) in zip(got, want):
        assert kh.dtype == (torch.complex64 if name == "float32"
                            else torch.complex128)
        assert tuple(kh.shape) == (m2, m2, m2 // 2 + 1)
        scale = max(np.abs(re).max(), np.abs(im).max())
        for part, ref in ((kh.real.numpy(), re), (kh.imag.numpy(), im)):
            diff = np.abs(part.astype(np.float64) - ref)
            bar = 1e-13 * scale
            if name == "float32":
                bar = bar + np.spacing(np.abs(ref)).astype(np.float64)
            assert bool((diff <= bar).all())


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-15)])
def test_short_range_w_matches_jax(dtype, tol, x64):
    """r^2 over 0, the underflow floor, the u = 0.05 series switch (u = 0.5
    r here) and out to rcut (u = 2.83) and beyond."""
    alpha, eps2 = dtype(0.5), dtype(0.01)
    r2 = np.concatenate([
        [0.0, 1e-32, 1e-20],
        (np.linspace(0.098, 0.102, 41) ** 2),  # u from 0.049 to 0.051
        np.linspace(0.0, 6.0, 200) ** 2,
    ]).astype(dtype)
    got = p3m._short_range_w(torch.from_numpy(r2), torch.tensor(alpha),
                             eps2, torch.tensor(alpha * alpha * alpha))
    want = np.asarray(jax_p3m._short_range_w(
        jnp.asarray(r2), jnp.asarray(alpha), jnp.asarray(eps2),
        jnp.asarray(alpha * alpha * alpha), dtype))
    assert got.dtype == torch.from_numpy(r2).dtype
    assert np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()


def _near_field_inputs(pos, masses, grid, side, cap):
    tp, tm = torch.from_numpy(pos), torch.from_numpy(masses)
    origin, span = cells.bounding_cube(tp)
    coords = cells.grid_coords(tp, origin, span, side)
    cells_pos, cells_m, count, *_ = cells.bin_to_cells(tp, tm, coords, side,
                                                       cap)
    ids = cells.cell_ids(coords, side)
    m_scale = tm.max()
    m_hat = tm / m_scale
    cmass_hat = cells.segment_sum(m_hat, ids, side**3)
    ccom = (cells.segment_sum(m_hat[:, None] * tp, ids, side**3)
            / cmass_hat.clamp_min(1e-37)[:, None])
    sigma = 1.25 * span / (grid - 1)
    alpha = 1.0 / (np.sqrt(2.0) * sigma)
    return (cells_pos, cap, cells_pos, cells_m, count, cmass_hat, ccom,
            m_scale, span, side, cap, 1.0, 1e-10, 0.05, alpha, 4.0 * sigma)


@pytest.mark.parametrize("cap", [8, 32])
def test_near_field_tiles_match_jax_engines(cap):
    """The port's nlist_short_range_cells (plain ewald tiles plus the
    remainder monopoles), slot for slot, against the JAX package's jnp
    engine and its Pallas kernel in interpret mode. cap 8 overflows the
    central cells. Padded target slots hold what each engine leaves there
    (the remainder monopoles at the zero position) and are not
    compared."""
    pos, _, masses = _disk(1500, seed=cap)
    args = _near_field_inputs(pos, masses, grid=32, side=6, cap=cap)
    count = args[4]
    assert int(count.max()) > cap or cap == 32
    got = nlist.nlist_short_range_cells(*args, t_count=count).numpy()
    real = np.arange(cap)[None, :] < count.numpy()[:, None]
    jargs = [jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a
             for a in args]
    for impl in ("jnp", "pallas"):
        want = jax_nlist.nlist_short_range_cells(*jargs, jnp.float32,
                                                 impl=impl)
        assert _max_over_mean(got[real], np.asarray(want)[real]) < 3e-5, impl


def test_plain_ewald_tiles_scale_bounds_the_sum():
    """``absolute`` weighs each pair by gm (|newt| + |corr|): it bounds the
    row sums and exceeds |w| where the two terms cancel."""
    pos, _, masses = _disk(800, seed=3)
    args = _near_field_inputs(pos, masses, grid=32, side=6, cap=64)
    cells_pos, count, cells_m = args[0], args[4], args[3]
    params = torch.stack([args[15] * args[15], args[14]])
    tiles = (cells_pos, count, cells_pos, cells_m, count, 6, params)
    kw = dict(cutoff=1e-10, eps=0.05, kind="ewald")
    acc = nlist.pair_cells_plain(*tiles, **kw)
    scale = nlist.pair_cells_plain(*tiles, absolute=True, **kw)
    assert bool((acc.abs() <= scale * (1 + 1e-6)).all())
    assert float(scale.sum()) > float(acc.abs().sum())
    before = dict(nlist.LAUNCHES)
    np.testing.assert_array_equal(
        nlist.pair_cells_kernel(*tiles, **kw).numpy(), acc.numpy())
    assert nlist.LAUNCHES == before  # the CPU runs the plain version
    with pytest.raises(ValueError, match="pair kind"):
        nlist.pair_cells_plain(*tiles, cutoff=1e-10, eps=0.05, kind="coulomb")


# --- the whole solver ------------------------------------------------------


def _both(pos, masses, targets=None, *, dtype=np.float32, **kw):
    tp, tm = torch.from_numpy(pos), torch.from_numpy(masses)
    if targets is None:
        got = p3m.p3m_accelerations(tp, tm, **kw)
        want = jax_p3m.p3m_accelerations(jnp.asarray(pos),
                                         jnp.asarray(masses), **kw)
    else:
        got = p3m.p3m_accelerations_vs(torch.from_numpy(targets), tp, tm,
                                       **kw)
        want = jax_p3m.p3m_accelerations_vs(
            jnp.asarray(targets), jnp.asarray(pos), jnp.asarray(masses),
            **kw)
    assert got.dtype == torch.from_numpy(pos).dtype
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("mode", ["nlist", "gather"])
@pytest.mark.parametrize("cap,t_cap", [(64, 0), (8, 0), (16, 4)])
def test_p3m_matches_jax(mode, cap, t_cap):
    """N = 2048, grid 32 (binning side 6). cap 8 overflows the central
    cells' sources; t_cap 4 sends most targets to the whole-cell
    fallback."""
    pos, _, masses = _disk(2048, seed=1)
    got, want = _both(pos, masses, grid=32, cap=cap, t_cap=t_cap,
                      short_mode=mode, chunk=512, **G1)
    assert np.isfinite(got).all()
    assert _max_over_mean(got, want) < 2.5e-4


@pytest.mark.parametrize("mode", ["nlist", "gather"])
def test_p3m_targets_not_sources_fp64(mode, x64):
    """Targets other than the sources, with source and target overflow,
    in fp64, where the two packages agree to the last digits."""
    pos, _, masses = _disk(1024, seed=2, dtype=np.float64)
    targets = (pos[:300] * 1.01 + 0.01).astype(np.float64)
    for cap, t_cap in ((64, 0), (8, 2)):
        got, want = _both(pos, masses, targets, grid=32, cap=cap,
                          t_cap=t_cap, short_mode=mode, chunk=128, **G1)
        assert _max_over_mean(got, want) < 1e-13


def test_p3m_matches_jax_at_a_uniform_state():
    """A quasi-uniform cube (the other geometry): both modes against the
    JAX package, and close to each other."""
    rng = np.random.default_rng(4)
    pos = rng.uniform(-10.0, 10.0, (1500, 3)).astype(np.float32)
    masses = rng.uniform(0.5, 1.5, 1500).astype(np.float32)
    results = {}
    for mode in ("nlist", "gather"):
        got, want = _both(pos, masses, grid=32, cap=32, short_mode=mode, **G1)
        assert _max_over_mean(got, want) < 2.5e-4
        results[mode] = got
    assert _max_over_mean(results["nlist"], results["gather"]) < 2.5e-4


# --- routing, sizing and refusals -----------------------------------------


def test_resolve_short_mode():
    assert p3m.resolve_short_mode("auto", CPU) == "gather"
    assert jax_p3m.resolve_short_mode("auto", "cpu") == "gather"
    assert p3m.resolve_short_mode("auto", CUDA) == "nlist"
    for mode in ("nlist", "gather", "slice"):
        for device in (CPU, CUDA):
            assert p3m.resolve_short_mode(mode, device) == mode
    with pytest.raises(ValueError, match="short_mode"):
        p3m.resolve_short_mode("tiles", CPU)


def test_slice_is_not_ported():
    """The slice pass is ported now: a config takes it, and on one state
    it computes the same short-range sum as the cell-list pass (fp64, every
    row within 1e-12 of the largest |a|: the two passes add the pairs in
    other orders; tests/test_torch_p3m_kick_fmm_bf16.py holds it to the
    JAX package's ``_short_range_shifted``)."""
    pos, _, masses = _disk(64, seed=5, dtype=np.float64)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(masses)
    got = p3m.p3m_accelerations(tp, tm, grid=16, short_mode="slice", **G1)
    want = p3m.p3m_accelerations(tp, tm, grid=16, short_mode="nlist", **G1)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    cfg = SimulationConfig(force_backend="p3m", p3m_short="slice")
    assert cfg.p3m_short == "slice"


def test_sizing_helpers_and_warning_texts_match_jax():
    for grid, sc, rs in ((256, 1.25, 4.0), (128, 1.25, 4.0), (32, 2.0, 4.0),
                         (8, 1.25, 4.0)):
        assert p3m.binning_side(grid, sc, rs) == jax_p3m.binning_side(
            grid, sc, rs)
    assert p3m.binning_side(256, 1.25, 4.0) == 51
    thin, _, _ = _disk(4096, seed=6)
    cube = np.random.default_rng(7).uniform(-1, 1, (4096, 3))
    for positions in (thin, cube, None, thin[:8]):
        assert p3m.thin_aspect(positions) == jax_p3m.thin_aspect(positions)
    assert p3m.thin_aspect(torch.from_numpy(thin)) == jax_p3m.thin_aspect(
        thin)
    for aspect in (0.05, 0.2, 0.49):
        assert p3m.suggest_thin_grid(aspect) == jax_p3m.suggest_thin_grid(
            aspect)
    for n, positions in ((1_048_576, thin), (4096, thin), (4096, cube),
                         (100, None)):
        for grid, cap in ((256, 64), (32, 8), (64, 512)):
            args = (n, grid, 1.25, 4.0, cap)
            assert p3m.check_p3m_sizing(*args, positions=positions) == \
                jax_p3m.check_p3m_sizing(*args, positions=positions)
    assert p3m.nlist_near_eligible(32_768) and not \
        p3m.nlist_near_eligible(32_767)


# --- the Simulator and the CLI ---------------------------------------------


@pytest.mark.parametrize("mode", ["nlist", "gather"])
def test_simulator_p3m_matches_jax(mode):
    """10 leapfrog steps of a 1024-body disk, grid 32, cap 16 (the central
    cells overflow), on identical initial states."""
    pos, vel, masses = _disk(1024, seed=8)
    common = dict(model="disk", n=1024, steps=10, integrator="leapfrog",
                  force_backend="p3m", pm_grid=32, p3m_cap=16,
                  p3m_short=mode, dt=2e-3, progress_every=10, **G1)
    jax_final = JaxSimulator(
        JaxConfig(**common),
        state=JaxState(jnp.asarray(pos), jnp.asarray(vel),
                       jnp.asarray(masses)),
    ).run()["final_state"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = Simulator(SimulationConfig(**common),
                        state_from_numpy(pos, vel, masses, device="cpu"),
                        device="cpu")
    assert [str(w.message) for w in caught] == [jax_p3m.check_p3m_sizing(
        1024, 32, 1.25, 4.0, 16, positions=pos)]
    assert "under-resolves this thin geometry" in str(caught[0].message)
    assert sim.backend == "p3m"
    assert sim.p3m_sizing == (6, 16, 16, mode)
    stats = sim.run()
    got_pos, got_vel, _ = state_to_numpy(stats["final_state"])
    for got, want in ((got_pos, jax_final.positions),
                      (got_vel, jax_final.velocities)):
        want = np.asarray(want, np.float64)
        err = np.linalg.norm(got - want, axis=1)
        assert np.all(err <= 1e-5 * np.linalg.norm(want, axis=1) + 1e-12)
    assert stats["kernel_launches"] == 0  # the CPU runs the plain engine
    assert (stats["p3m_side"], stats["p3m_cap"], stats["p3m_short"]) == \
        (6, 16, mode)


def test_p3m_is_an_explicit_backend_only():
    from gravity_tpu_torch.simulation import KERNEL_BACKEND, _resolve_backend

    for device in (CPU, CUDA):
        assert _resolve_backend(SimulationConfig(force_backend="p3m"),
                                device) == "p3m"
    assert _resolve_backend(SimulationConfig(n=1 << 20), CUDA) == \
        KERNEL_BACKEND


def test_cli_parses_the_readme_p3m_command_and_runs_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "gravity_tpu_torch", "run", "--device",
            "cpu", "--model", "disk", "--n", "512", "--g", "1.0", "--dt",
            "2e-3", "--eps", "0.05", "--force-backend", "p3m", "--pm-grid",
            "32", "--p3m-cap", "16", "--integrator", "leapfrog", "--steps",
            "3", "--log-dir", str(tmp_path)]
    proc = subprocess.run(base + ["--p3m-short", "nlist"], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["backend"] == "p3m" and stats["p3m_short"] == "nlist"
    assert (stats["p3m_side"], stats["p3m_cap"], stats["pm_grid"]) == \
        (6, 16, 32)
    proc = subprocess.run(base + ["--p3m-short", "slice"], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["backend"] == "p3m" and stats["p3m_short"] == "slice"
