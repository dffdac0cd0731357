"""The port's cutoff-radius cell list against the JAX package.

Inputs are drawn with numpy from a seed and given to both packages:
``gravity_tpu_torch.ops.nlist`` (its plain tile engine, which is what a
CPU tensor runs) against ``gravity_tpu.ops.pallas_nlist`` through its jnp
engine and through its Pallas kernel in interpret mode. Sizes follow
tests/test_nlist.py. Tolerances:

- fp32: max |delta a| < 1e-5 of the mean |a|, the JAX suite's own bound
  for the same sums taken in another order;
- fp64: 1e-12 of the mean |a| against a numpy rcut-masked oracle;
- 20-step leapfrog runs: 1e-5 per particle, as tests/test_torch_simulation.py.
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
from gravity_tpu.ops import pallas_nlist as jax_nlist
from gravity_tpu.simulation import Simulator as JaxSimulator
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch.config import NotPortedError, SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy, state_to_numpy
from gravity_tpu_torch.ops import nlist
from gravity_tpu_torch.simulation import (
    KERNEL_BACKEND,
    Simulator,
    _resolve_backend,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G1 = dict(g=1.0, eps=0.5)
CPU, CUDA = torch.device("cpu"), torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cloud(n, span=100.0, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, span, (n, 3)).astype(dtype)
    m = (rng.uniform(0.0, 1.0, n) + 0.5).astype(dtype)
    return pos, m


def _masked_ref(pos, m, rcut, targets=None, g=1.0, eps=0.5):
    """fp64 numpy truncated direct sum."""
    p = np.asarray(pos, np.float64)
    t = p if targets is None else np.asarray(targets, np.float64)
    diff = p[None] - t[:, None]
    r2 = (diff**2).sum(-1)
    w = g * np.asarray(m, np.float64)[None] / np.maximum(
        r2 + eps * eps, 1e-30) ** 1.5
    w[(r2 > rcut * rcut) | (r2 <= 0)] = 0.0
    return (w[..., None] * diff).sum(1)


def _max_over_mean(got, want):
    want = np.asarray(want, np.float64)
    scale = np.linalg.norm(want, axis=1).mean()
    return np.abs(np.asarray(got, np.float64) - want).max() / scale


def _port(pos, m, targets=None, **kw):
    tp, tm = torch.from_numpy(pos), torch.from_numpy(m)
    if targets is None:
        return nlist.nlist_accelerations(tp, tm, **kw).numpy()
    return nlist.nlist_accelerations_vs(torch.from_numpy(targets), tp, tm,
                                        **kw).numpy()


@pytest.mark.parametrize("rcut,span", [
    (8.0, 100.0),   # sparse: few neighbors per particle
    (20.0, 100.0),  # mid density
    (12.0, 40.0),   # dense: many neighbors, several cells each way
])
def test_matches_jax_jnp_and_pallas_engines(rcut, span):
    pos, m = _cloud(256, span, seed=int(rcut))
    side, _ = jax_nlist.resolve_nlist_sizing(pos, rcut)
    kw = dict(rcut=rcut, side=side, cap=64, **G1)
    got = _port(pos, m, **kw)
    for impl in ("jnp", "pallas"):
        want = jax_nlist.nlist_accelerations(
            jnp.asarray(pos), jnp.asarray(m), impl=impl, **kw)
        assert _max_over_mean(got, want) < 1e-5, impl
    assert _max_over_mean(got, _masked_ref(pos, m, rcut)) < 1e-5


def test_targets_vs_sources_form():
    pos, m = _cloud(192, seed=5)
    targets, _ = _cloud(64, seed=6)
    rcut = 14.0
    side, cap = jax_nlist.resolve_nlist_sizing(pos, rcut, cap=64)
    kw = dict(rcut=rcut, side=side, cap=cap, **G1)
    got = _port(pos, m, targets=targets, **kw)
    want = jax_nlist.nlist_accelerations_vs(
        jnp.asarray(targets), jnp.asarray(pos), jnp.asarray(m), impl="jnp",
        **kw)
    assert _max_over_mean(got, want) < 1e-5
    assert _max_over_mean(got, _masked_ref(pos, m, rcut, targets)) < 1e-5


@pytest.mark.parametrize("cap", [8, 32])
def test_overflow_channels_match_jax(cap):
    """side 2 at ~32 bodies a cell: sources past the cap become remainder
    monopoles and targets past it take the whole-cell fallback, in both
    packages alike."""
    pos, m = _cloud(256, span=30.0, seed=7)
    kw = dict(rcut=12.0, side=2, cap=cap, **G1)
    got = _port(pos, m, **kw)
    want = jax_nlist.nlist_accelerations(
        jnp.asarray(pos), jnp.asarray(m), impl="jnp", **kw)
    assert np.isfinite(got).all()
    assert (np.linalg.norm(got, axis=1) > 0).all()
    assert _max_over_mean(got, want) < 1e-5
    # The degradation is real: far from the exact truncated sum.
    assert _max_over_mean(got, _masked_ref(pos, m, 12.0)) > 1e-3


def test_fp64_matches_masked_oracle():
    pos, m = _cloud(256, seed=8, dtype=np.float64)
    rcut = 15.0
    side, _ = nlist.resolve_nlist_sizing(pos, rcut)
    got = _port(pos, m, rcut=rcut, side=side, cap=64, **G1)
    assert _max_over_mean(got, _masked_ref(pos, m, rcut)) < 1e-12


def test_sizing_matches_jax_and_warns_alike():
    for n, span, rcut, kw in ((2048, 100.0, 10.0, {}),
                              (2048, 100.0, 0.05, {"slot_budget": 1 << 16}),
                              (2048, 100.0, 10.0, {"cap": 64, "side": 4}),
                              (500, 40.0, 3.0, {})):
        pos, _ = _cloud(n, span, seed=9)
        assert nlist.resolve_nlist_sizing(
            torch.from_numpy(pos), rcut, **kw
        ) == jax_nlist.resolve_nlist_sizing(pos, rcut, **kw)
    pos, _ = _cloud(64, span=10.0, seed=10)
    results = []
    for fn in (nlist.resolve_nlist_sizing, jax_nlist.resolve_nlist_sizing):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sizing = fn(pos, 9.0)
        results.append((sizing, [str(w.message) for w in caught]))
    assert results[0] == results[1] and results[0][0][0] == 2
    assert "cell edge" in results[0][1][0]
    with pytest.raises(ValueError, match="rcut"):
        nlist.resolve_nlist_sizing(pos, 0.0)
    for n, side, cap in ((10_000, 4, 8), (100, 4, 8)):
        assert nlist.check_nlist_sizing(n, side, cap) == \
            jax_nlist.check_nlist_sizing(n, side, cap)
    assert nlist.evaluated_pairs_per_eval(4, 8) == \
        jax_nlist.evaluated_pairs_per_eval(4, 8)


def test_kernel_wrapper_on_cpu_is_the_plain_version():
    pos, m = _cloud(128, seed=11)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(m)
    side, cap = 4, 32
    from gravity_tpu_torch.ops.cells import (
        bin_to_cells,
        bounding_cube,
        grid_coords,
    )

    origin, span = bounding_cube(tp)
    coords = grid_coords(tp, origin, span, side)
    cells_pos, cells_m, count, *_ = bin_to_cells(tp, tm, coords, side, cap)
    params = torch.tensor([15.0 * 15.0])
    args = (cells_pos, count, cells_pos, cells_m, count, side, params)
    before = nlist.LAUNCHES
    got = nlist.pair_cells_kernel(*args, cutoff=1e-10, eps=0.5)
    assert nlist.LAUNCHES == before
    want = nlist.pair_cells_plain(*args, cutoff=1e-10, eps=0.5)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # Slots past a cell's count are zero; |terms| bound the sum.
    slots = torch.arange(cap)[None, :] >= count[:, None]
    assert bool((got[slots] == 0).all())
    scale = nlist.pair_cells_plain(*args, cutoff=1e-10, eps=0.5,
                                   absolute=True)
    assert bool((got.abs() <= scale * (1 + 1e-6)).all())
    # Pairs the kernel evaluates: the occupancy's, not the padded tiles'.
    pairs = nlist.real_pairs(count, count, side, cap, cap)
    assert 0 < pairs < nlist.evaluated_pairs_per_eval(side, cap)


@pytest.mark.parametrize("use_rcut", [True, False])
def test_tile_engine_matches_jax_tile_engines(use_rcut):
    """The plain tile engine, slot for slot, against the JAX package's jnp
    engine and its Pallas kernel in interpret mode, with and without the
    truncation (use_rcut=False is the tree near field's form). Padded
    target slots are the port's zeros and are not compared."""
    pos, m = _cloud(200, span=50.0, seed=13)
    side, cap, rcut = 3, 32, 15.0
    tp, tm = torch.from_numpy(pos), torch.from_numpy(m)
    _, _, params, _, binned = nlist.source_cells(tp, tm, rcut=rcut,
                                                 side=side, cap=cap)
    cells_pos, cells_m, count = binned[:3]
    kw = dict(cutoff=1e-10, eps=0.5, use_rcut=use_rcut)
    got = nlist.pair_cells_plain(cells_pos, count, cells_pos, cells_m,
                                 count, side, params, **kw).numpy()
    real = np.arange(cap)[None, :] < count.numpy()[:, None]
    jargs = (jnp.asarray(cells_pos.numpy()), jnp.asarray(cells_pos.numpy()),
             jnp.asarray(cells_m.numpy()), side,
             jnp.asarray(params.numpy()))
    for want in (
        jax_nlist._jnp_pair_cells(*jargs, kind="newton", **kw),
        jax_nlist._pallas_pair_cells(*jargs, kind="newton", interpret=True,
                                     **kw),
    ):
        assert _max_over_mean(got[real], np.asarray(want)[real]) < 1e-5
    assert np.all(got[~real] == 0)


def test_local_kernel_closures():
    pos, m = _cloud(128, seed=14)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(m)
    kw = dict(rcut=15.0, side=4, cap=32, **G1)
    kernel = nlist.make_nlist_local_kernel(**kw)
    np.testing.assert_array_equal(
        kernel(tp[:50], tp, tm).numpy(),
        nlist.nlist_accelerations_vs(tp[:50], tp, tm, **kw).numpy())


def test_periodic_form_is_not_ported():
    pos, m = _cloud(32, seed=12)
    with pytest.raises(NotPortedError, match="Queue 1 item 7"):
        _port(pos, m, rcut=10.0, side=3, cap=8, box=100.0)


# --- the Simulator, routing and the CLI ------------------------------------


def _initial_state(n, seed=2):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3e11, 3e11, (n, 3)).astype(np.float32)
    vel = rng.uniform(-3e4, 3e4, (n, 3)).astype(np.float32)
    masses = rng.uniform(1e23, 1e25, n).astype(np.float32)
    return pos, vel, masses


def _rows_close(got, want, rtol):
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(np.asarray(got, np.float64) - want, axis=1)
    assert np.all(err <= rtol * np.linalg.norm(want, axis=1)), \
        float(np.max(err / np.linalg.norm(want, axis=1)))


def test_simulator_nlist_matches_jax():
    """20 leapfrog steps through the cell list at side 4, cap 16; the cell
    edge (1.5e11 m) stays above rcut, so the radius is rcut itself."""
    pos, vel, masses = _initial_state(256)
    common = dict(model="random", n=256, steps=20, integrator="leapfrog",
                  force_backend="nlist", nlist_rcut=1.2e11, nlist_side=4,
                  nlist_cap=16, eps=1e9, progress_every=10)
    jax_final = JaxSimulator(
        JaxConfig(**common),
        state=JaxState(jnp.asarray(pos), jnp.asarray(vel),
                       jnp.asarray(masses)),
    ).run()["final_state"]
    sim = Simulator(SimulationConfig(**common),
                    state_from_numpy(pos, vel, masses, device="cpu"),
                    device="cpu")
    assert sim.backend == "nlist" and sim.nlist_sizing[:2] == (4, 16)
    stats = sim.run()
    got_pos, got_vel, _ = state_to_numpy(stats["final_state"])
    _rows_close(got_pos, jax_final.positions, 1e-5)
    _rows_close(got_vel, jax_final.velocities, 1e-5)
    assert stats["kernel_launches"] == 0  # the CPU runs the plain engine
    assert stats["nlist_side"] == 4 and stats["nlist_cap"] == 16
    assert stats["dense_equiv_pairs_per_sec"] == stats["pairs_per_sec"]
    assert stats["evaluated_pairs_per_sec"] > 0


def test_simulator_sizes_the_cell_list_from_the_state():
    pos, vel, masses = _initial_state(256, seed=3)
    cfg = SimulationConfig(n=256, force_backend="nlist", nlist_rcut=1.5e11)
    sim = Simulator(cfg, state_from_numpy(pos, vel, masses, device="cpu"),
                    device="cpu")
    side, cap = jax_nlist.resolve_nlist_sizing(pos, 1.5e11)
    assert sim.nlist_sizing == (side, cap,
                                nlist.evaluated_pairs_per_eval(side, cap))


def test_nlist_without_rcut_raises():
    with pytest.raises(ValueError, match="nlist_rcut"):
        Simulator(SimulationConfig(n=16, force_backend="nlist"),
                  device="cpu")


def test_rcut_routes_stay_in_the_truncated_family():
    for device in (CPU, CUDA):
        for backend in ("auto", "direct"):
            cfg = SimulationConfig(n=4096, force_backend=backend,
                                   nlist_rcut=1e11)
            assert _resolve_backend(cfg, device) == "dense"
            cfg = SimulationConfig(n=1 << 21, force_backend=backend,
                                   nlist_rcut=1e11)
            assert _resolve_backend(cfg, device) == "chunked"
        assert _resolve_backend(SimulationConfig(
            force_backend="nlist", nlist_rcut=1e11), device) == "nlist"
    with pytest.warns(UserWarning, match="FULL gravity"):
        assert _resolve_backend(SimulationConfig(
            force_backend="pallas", nlist_rcut=1e11), CUDA) == KERNEL_BACKEND


def test_auto_with_rcut_runs_the_masked_direct_sum():
    """auto + nlist_rcut on the CPU: the rcut-masked plain sum, as the JAX
    Simulator's dense route (rtol 1e-5 after 10 steps)."""
    pos, vel, masses = _initial_state(64, seed=4)
    common = dict(model="random", n=64, steps=10, integrator="leapfrog",
                  nlist_rcut=2e11, eps=1e9, progress_every=10)
    jax_final = JaxSimulator(
        JaxConfig(force_backend="dense", **common),
        state=JaxState(jnp.asarray(pos), jnp.asarray(vel),
                       jnp.asarray(masses)),
    ).run()["final_state"]
    final = Simulator(SimulationConfig(**common),
                      state_from_numpy(pos, vel, masses, device="cpu"),
                      device="cpu").run()["final_state"]
    _rows_close(state_to_numpy(final)[0], jax_final.positions, 1e-5)


def test_cli_parses_the_nlist_flags_and_runs_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "gravity_tpu_torch", "run", "--device", "cpu",
         "--model", "random", "--n", "128", "--steps", "4",
         "--integrator", "leapfrog", "--force-backend", "nlist",
         "--nlist-rcut", "1.5e11", "--nlist-side", "4", "--nlist-cap", "16",
         "--eps", "1e9", "--log-dir", str(tmp_path)],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["backend"] == "nlist" and stats["steps"] == 4
    assert (stats["nlist_side"], stats["nlist_cap"]) == (4, 16)
