"""The port's close-encounter detection and merging (ops/encounters.py)
against the JAX package, on the CPU.

The same seeded numpy state goes through both packages. Candidate pairs
are compared as (i, j) sets with their distances (fp64 1e-12, fp32 1e-6
relative: one r^2 summed in another order), merged pairs and
``n_merged`` exactly, masses exactly, positions and velocities relative
per row (fp64 1e-12, fp32 1e-6: one weighted mean, which the port forms
with mass fractions where the JAX package forms m x, so that fp32 does
not overflow at SI scales).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.ops import encounters as jenc
from gravity_tpu.simulation import Simulator as JaxSimulator
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch.config import NotPortedError, SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy
from gravity_tpu_torch.ops import encounters
from gravity_tpu_torch.simulation import Simulator

TOL = {"float32": 1e-6, "float64": 1e-12}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _state(n, dtype, seed=4, clumps=8):
    """A random cube with ``clumps`` tight groups of 3 (chains the greedy
    pass must resolve once each) and a tracer."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3e11, 3e11, (n, 3))
    vel = rng.uniform(-3e4, 3e4, (n, 3))
    masses = rng.uniform(1e23, 1e25, n)
    for c in range(clumps):
        base = 3 * c + 10
        pos[base + 1] = pos[base] + rng.uniform(-1e9, 1e9, 3)
        pos[base + 2] = pos[base] + rng.uniform(-2e9, 2e9, 3)
    if n > 10:
        masses[9] = 0.0
        pos[9] = pos[10]  # a tracer on top of a body is never a candidate
    return tuple(a.astype(dtype) for a in (pos, vel, masses))


def _pair(n, dtype, **kw):
    pos, vel, masses = _state(n, np.dtype(dtype).type, **kw)
    return (JaxState(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(masses)),
            state_from_numpy(pos, vel, masses, dtype=getattr(torch, dtype),
                             device="cpu"))


def _rows_close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(got - want, axis=1)
    scale = np.linalg.norm(want, axis=1)
    assert np.all(err <= tol * scale + 1e-300), float(np.max(err / scale))


def _merge_equal(got, want, dtype):
    assert int(got.n_merged) == int(want.n_merged)
    np.testing.assert_array_equal(got.state.masses.numpy(),
                                  np.asarray(want.state.masses))
    _rows_close(got.state.positions.numpy(), want.state.positions,
                TOL[dtype])
    _rows_close(got.state.velocities.numpy(), want.state.velocities,
                TOL[dtype])


@pytest.mark.parametrize("k,chunk", [(16, 1024), (40, 100), (3, 7)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_closest_pairs_match_jax(x64, dtype, k, chunk):
    jax_state, state = _pair(512, dtype)
    want = jenc.closest_pairs(jax_state.positions, jax_state.masses, k=k,
                              chunk=chunk)
    got = encounters.closest_pairs(state.positions, state.masses, k=k,
                                   chunk=chunk)
    w_pairs = set(zip(np.asarray(want[1]).tolist(),
                      np.asarray(want[2]).tolist()))
    assert set(zip(got[1].tolist(), got[2].tolist())) == w_pairs
    assert all(i < j for i, j in w_pairs) and not any(9 in p for p in w_pairs)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=TOL[dtype])
    sep = encounters.min_separation(state.positions, state.masses)
    assert float(sep) == pytest.approx(float(want[0][0]), rel=TOL[dtype])


def test_closest_pairs_pad_with_inf_when_pairs_run_out():
    _, state = _pair(5, "float64", clumps=0)  # 5 bodies: 10 pairs
    d, i, j = encounters.closest_pairs(state.positions, state.masses, k=12)
    assert torch.isinf(d[10:]).all() and (i[10:] == -1).all()
    assert (j[10:] == -1).all() and torch.isfinite(d[:10]).all()


@pytest.mark.parametrize("radius", [1.5e9, 5e9, 3e10])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_merge_close_pairs_matches_jax(x64, dtype, radius):
    jax_state, state = _pair(512, dtype)
    want = jenc.merge_close_pairs(jax_state, radius, k=16, chunk=128)
    got = encounters.merge_close_pairs(state, radius, k=16, chunk=128)
    assert int(got.n_merged) > 0
    _merge_equal(got, want, dtype)
    # Mass and momentum are conserved to the dtype's rounding.
    m0, m1 = state.masses.double(), got.state.masses.double()
    assert float(m1.sum()) == pytest.approx(float(m0.sum()), rel=TOL[dtype])
    p0 = (m0[:, None] * state.velocities.double()).sum(0)
    p1 = (m1[:, None] * got.state.velocities.double()).sum(0)
    scale = float((m0[:, None] * state.velocities.double().abs()).sum())
    assert float((p1 - p0).abs().max()) <= 10 * TOL[dtype] * scale


def test_merge_at_si_scales_stays_finite_in_fp32(x64):
    """The merged body is the mass-weighted mean formed with mass
    fractions: at baseline-16k's scales in fp32 (3.9e27 kg bodies out to
    3e13 m) the JAX package's m x overflows and merges into NaN, the
    port's stays finite and conserves mass and momentum."""
    rng = np.random.default_rng(0)
    n = 64
    pos = rng.normal(0.0, 1e13, (n, 3)).astype(np.float32)
    pos[1] = pos[0] + np.float32(1e9)
    vel = rng.normal(0.0, 3e3, (n, 3)).astype(np.float32)
    masses = np.full(n, 3.90625e27, np.float32)
    jax_state = JaxState(jnp.asarray(pos), jnp.asarray(vel),
                         jnp.asarray(masses))
    state = state_from_numpy(pos, vel, masses, device="cpu")
    want = jenc.merge_close_pairs(jax_state, 1e10, k=4)
    got = encounters.merge_close_pairs(state, 1e10, k=4)
    assert int(got.n_merged) == int(want.n_merged) == 1
    assert not np.isfinite(np.asarray(want.state.positions)).all()
    assert bool(torch.isfinite(got.state.positions).all())
    assert float(got.state.masses[0]) == float(masses[0] + masses[1])
    assert float(got.state.masses[1]) == 0.0
    mid = (pos[0].astype(np.float64) + pos[1]) / 2
    _rows_close(got.state.positions[:2].numpy(), np.stack([mid, mid]), 1e-6)
    p0 = (masses[:, None].astype(np.float64) * vel).sum(0)
    p1 = (got.state.masses.double()[:, None]
          * got.state.velocities.double()).sum(0).numpy()
    assert np.abs(p1 - p0).max() <= 1e-6 * np.abs(
        masses[:, None].astype(np.float64) * vel).sum()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_nearest_within_radius_grid_matches_jax(x64, dtype):
    jax_state, state = _pair(2048, dtype)
    kw = dict(side=8, cap=64, chunk=300)
    want = jenc.nearest_within_radius_grid(
        jax_state.positions, jax_state.masses, 5e9, **kw)
    got = encounters.nearest_within_radius_grid(
        state.positions, state.masses, 5e9, **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=TOL[dtype])
    assert int(got[2]) == int(want[2]) == 0
    over = encounters.nearest_within_radius_grid(
        state.positions, state.masses, 5e9, side=2, cap=8)
    assert int(over[2]) == int(jenc.nearest_within_radius_grid(
        jax_state.positions, jax_state.masses, 5e9, side=2, cap=8)[2]) > 0


@pytest.mark.parametrize("radius", [1.5e9, 5e9])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_merge_close_pairs_grid_matches_jax(x64, dtype, radius):
    jax_state, state = _pair(2048, dtype)
    want = jenc.merge_close_pairs_grid(jax_state, radius, k=32)
    got = encounters.merge_close_pairs_grid(state, radius, k=32)
    assert int(got.n_merged) > 0
    _merge_equal(got, want, dtype)
    # A degenerate grid (radius near the system size) falls back to the
    # exact brute pass on both sides.
    want = jenc.merge_close_pairs_grid(jax_state, 2e11, k=8)
    got = encounters.merge_close_pairs_grid(state, 2e11, k=8)
    _merge_equal(got, want, dtype)


def test_merge_scan_chunk_and_refusals():
    for n in (1, 1000, 50_000, 2_000_000):
        assert encounters.merge_scan_chunk(n) == jenc.merge_scan_chunk(n)
    _, state = _pair(16, "float64", clumps=1)
    for call in (
        lambda: encounters.closest_pairs(state.positions, state.masses,
                                         box=1e12),
        lambda: encounters.merge_close_pairs_grid(state, 1e9, box=1e12),
        lambda: encounters.nearest_within_radius_grid(
            state.positions, state.masses, 1e9, side=4, cap=8, box=1e12),
    ):
        with pytest.raises(NotPortedError, match="Queue 1 item 7"):
            call()


@pytest.mark.parametrize("n,integrator", [(512, "leapfrog"), (2048, "euler")])
def test_simulator_merging_matches_jax(x64, monkeypatch, n, integrator):
    """Merge checks every 3 steps and at the last block: the same
    ``merged_pairs`` and final state as the JAX Simulator, through the
    brute scan and (its threshold lowered on both sides) the grid."""
    from gravity_tpu import simulation as jax_simulation
    from gravity_tpu_torch import simulation

    if n == 2048:
        monkeypatch.setattr(simulation, "MERGE_GRID_THRESHOLD", 1024)
        monkeypatch.setattr(jax_simulation, "MERGE_GRID_THRESHOLD", 1024)
    jax_state, state = _pair(n, "float64")
    cfg = dict(n=n, steps=7, dtype="float64", force_backend="dense",
               integrator=integrator, merge_radius=5e9, merge_every=3,
               merge_k=8, eps=1e9)
    want = JaxSimulator(JaxConfig(**cfg), state=jax_state).run()
    got = Simulator(SimulationConfig(**cfg), state=state, device="cpu").run()
    assert got["merged_pairs"] == want["merged_pairs"] > 0
    np.testing.assert_array_equal(got["final_state"].masses.numpy(),
                                  np.asarray(want["final_state"].masses))
    _rows_close(got["final_state"].positions.numpy(),
                want["final_state"].positions, TOL["float64"])
