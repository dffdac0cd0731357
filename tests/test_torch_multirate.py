"""The port's multirate block timesteps (ops/multirate.py, the
Simulator's multirate path and make_local_kernel) against the JAX
package, on the CPU.

The same seeded numpy state goes through both packages. The fast sets
are compared as sets (``lax.top_k`` and ``torch.topk`` may order ties
differently; the states here have distinct |a|). States relative per
row: fp64 1e-12, fp32 1e-5 after <= 10 steps; through the cell list
(its overflow channels sum in another order) and the Pallas kernel in
interpret mode (another summation order) the fp32 bound stays 1e-5.
"""

import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu import simulation as jax_simulation
from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.ops import multirate as jmultirate
from gravity_tpu.ops.forces import accelerations_vs as jax_accel
from gravity_tpu.ops.pallas_forces import make_pallas_local_kernel
from gravity_tpu.simulation import Simulator as JaxSimulator
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch import simulation
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy
from gravity_tpu_torch.ops import multirate
from gravity_tpu_torch.ops.forces import accelerations_vs
from gravity_tpu_torch.simulation import Simulator, make_local_kernel

TOL = {"float32": 1e-5, "float64": 1e-12}
EPS = 1e9


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _state(n, dtype, seed=11, g_units=False):
    rng = np.random.default_rng(seed)
    if g_units:
        pos = rng.normal(0.0, 1.0, (n, 3))
        vel = rng.normal(0.0, 0.3, (n, 3))
        masses = rng.uniform(0.5, 1.5, n) / n
    else:
        pos = rng.uniform(-3e11, 3e11, (n, 3))
        vel = rng.uniform(-3e4, 3e4, (n, 3))
        masses = rng.uniform(1e23, 1e25, n)
        masses[7] = 0.0  # a tracer never goes fast
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


def _states_close(got, want, tol):
    _rows_close(got.positions.numpy(), want.positions, tol)
    _rows_close(got.velocities.numpy(), want.velocities, tol)


def _kernels(eps=EPS):
    return (lambda ti, sj, m: jax_accel(ti, sj, m, eps=eps),
            lambda ti, sj, m: accelerations_vs(ti, sj, m, eps=eps))


def _accs(jax_state, state):
    jk, tk = _kernels()
    return (jk(jax_state.positions, jax_state.positions, jax_state.masses),
            tk(state.positions, state.positions, state.masses))


@pytest.mark.parametrize("k", [1, 16, 100])
def test_select_fast_matches_jax(x64, k):
    jax_state, state = _pair(256, "float64")
    acc_j, acc = _accs(jax_state, state)
    want = np.asarray(jmultirate.select_fast(acc_j, jax_state.masses, k=k))
    got = multirate.select_fast(acc, state.masses, k=k).numpy()
    assert set(got) == set(want)
    np.testing.assert_array_equal(got, want)  # distinct |a|: same order
    assert 7 not in set(got)
    union, rungs = multirate.assign_rungs(acc, state.masses,
                                          capacities=(64, 8))
    j_union, j_rungs = jmultirate.assign_rungs(acc_j, jax_state.masses,
                                               capacities=(64, 8))
    assert set(union.numpy()) == set(np.asarray(j_union))
    for a, b in zip(rungs, j_rungs):
        assert set(a.numpy()) == set(np.asarray(b))
    assert multirate.rung_segments((64, 8, 1)) == jmultirate.rung_segments(
        (64, 8, 1))


@pytest.mark.parametrize("n_sub", [3, 4])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_two_rung_step_matches_jax(x64, dtype, n_sub):
    jax_state, state = _pair(256, dtype)
    jk, tk = _kernels()
    acc_j, acc = _accs(jax_state, state)
    for _ in range(3):
        jax_state, acc_j = jmultirate.two_rung_step(
            jax_state, acc_j, 3600.0, accel_vs=jk, k=32, n_sub=n_sub)
        state, acc = multirate.two_rung_step(state, acc, 3600.0,
                                             accel_vs=tk, k=32, n_sub=n_sub)
    _states_close(state, jax_state, TOL[dtype])
    _rows_close(acc.numpy(), acc_j, TOL[dtype])


def test_step_sizes_are_formed_in_the_state_dtype(x64):
    """fp32, n_sub = 3, dt = 2e-3: fp32(dt) / 3 in fp32 and fp32(dt / 3)
    from the double differ. Under free drift (zero forces) from the
    origin, x is built from v and dt_s alone, so its bits show which
    dt_s each package used: both use fp32(dt) / 3. (XLA on the CPU
    contracts x + v dt_s into one fused multiply-add, the port does not;
    each is held to its own form of the same dt_s.)"""
    jax_state, state = _pair(64, "float32", g_units=True)
    # One set of real forces for both sides: the fast set and the
    # opening kicks alike.
    _, acc = _accs(jax_state, state)
    acc_j = jnp.asarray(acc.numpy())
    jax_state = jax_state.replace(
        positions=jnp.zeros_like(jax_state.positions))
    state = state.replace(positions=torch.zeros_like(state.positions))
    dt = 2e-3
    dt_s = np.float32(np.float32(dt) / np.float32(3))
    assert dt_s != np.float32(dt / 3)

    def zero_j(ti, sj, m):
        return jnp.zeros_like(ti)

    def zero(ti, sj, m):
        return torch.zeros_like(ti)

    want, _ = jmultirate.two_rung_step(jax_state, acc_j, dt, accel_vs=zero_j,
                                       k=8, n_sub=3)
    got, _ = multirate.two_rung_step(state, acc, dt, accel_vs=zero, k=8,
                                     n_sub=3)
    v = got.velocities.numpy()
    np.testing.assert_array_equal(v, want.velocities)

    def drift(step, fused):
        x = np.zeros_like(v)
        for _ in range(3):
            if fused:
                x = (x.astype(np.float64)
                     + v.astype(np.float64) * np.float64(step))
            else:
                x = x + v * step
            x = x.astype(np.float32)
        return x

    np.testing.assert_array_equal(got.positions.numpy(), drift(dt_s, False))
    np.testing.assert_array_equal(want.positions, drift(dt_s, True))
    assert not np.array_equal(got.positions.numpy(),
                              drift(np.float32(dt / 3), False))
    # The device-scalar form (the adaptive loop's dt) gives the same bits.
    dev, _ = multirate.two_rung_step(state, acc, torch.tensor(dt).float(),
                                     accel_vs=zero, k=8, n_sub=3)
    assert torch.equal(dev.positions, got.positions)


@pytest.mark.parametrize("capacities", [(32, 4), (24, 8, 2)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rung_ladder_step_matches_jax(x64, dtype, capacities):
    jax_state, state = _pair(256, dtype)
    jk, tk = _kernels()
    acc_j, acc = _accs(jax_state, state)
    for _ in range(3):
        jax_state, acc_j = jmultirate.rung_ladder_step(
            jax_state, acc_j, 3600.0, accel_vs=jk, capacities=capacities)
        state, acc = multirate.rung_ladder_step(
            state, acc, 3600.0, accel_vs=tk, capacities=capacities)
    _states_close(state, jax_state, TOL[dtype])


def test_step_validation_matches_jax():
    _, state = _pair(16, "float64")
    _, tk = _kernels()
    acc = tk(state.positions, state.positions, state.masses)
    with pytest.raises(ValueError, match="n_sub must be >= 1"):
        multirate.two_rung_step(state, acc, 1.0, accel_vs=tk, k=2, n_sub=0)
    with pytest.raises(ValueError, match="at least one fast-rung"):
        multirate.rung_ladder_step(state, acc, 1.0, accel_vs=tk,
                                   capacities=())
    with pytest.raises(ValueError, match="capacities must be >= 1"):
        multirate.rung_ladder_step(state, acc, 1.0, accel_vs=tk,
                                   capacities=(4, 0))


def _simulators(n, dtype, **kw):
    jax_state, state = _pair(n, dtype)
    cfg = dict(n=n, dtype=dtype, eps=EPS, integrator="multirate",
               progress_every=3, **{"steps": 8, **kw})
    return (JaxSimulator(JaxConfig(**cfg), state=jax_state),
            Simulator(SimulationConfig(**cfg), state=state, device="cpu"))


def _final_fast_sets(jax_final, final, k):
    acc_j, acc = _accs(jax_final, final)
    return (set(multirate.select_fast(acc, final.masses, k=k).numpy()),
            set(np.asarray(jmultirate.select_fast(acc_j, jax_final.masses,
                                                  k=k))))


@pytest.mark.parametrize("rungs,k", [(2, 0), (3, 64)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_simulator_multirate_on_dense_matches_jax(x64, dtype, rungs, k):
    jax_sim, sim = _simulators(256, dtype, force_backend="dense",
                               multirate_k=k, multirate_rungs=rungs,
                               multirate_sub=3)
    want, got = jax_sim.run(), sim.run()
    assert got["multirate_k"] == 32 if k == 0 else 64
    _states_close(got["final_state"], want["final_state"], TOL[dtype])
    got_set, want_set = _final_fast_sets(want["final_state"],
                                         got["final_state"], 32)
    assert got_set == want_set


def test_pallas_kicks_match_the_interpret_mode_kernel(x64):
    """JAX's fast kicks through the Pallas kernel (``make_pallas_local
    _kernel(interpret=True)``) against the port's through
    ``make_local_kernel(..., "nbody_direct")`` (the CUDA kernel's wrapper,
    which takes the plain version for CPU tensors)."""
    jax_state, state = _pair(256, "float32")
    cfg = SimulationConfig(n=256, eps=EPS, force_backend="pallas",
                           integrator="multirate")
    kick = make_local_kernel(cfg, simulation.KERNEL_BACKEND)
    pallas = make_pallas_local_kernel(eps=EPS, tile_i=32, tile_j=128,
                                      interpret=True)
    acc_j, acc = _accs(jax_state, state)
    for _ in range(2):
        jax_state, acc_j = jmultirate.two_rung_step(
            jax_state, acc_j, 3600.0, accel_vs=pallas, k=32, n_sub=2)
        state, acc = multirate.two_rung_step(state, acc, 3600.0,
                                             accel_vs=kick, k=32, n_sub=2)
    _states_close(state, jax_state, TOL["float32"])


NLIST = dict(force_backend="nlist", nlist_rcut=1.5e11, nlist_side=4,
             nlist_cap=32)


def test_simulator_multirate_on_nlist_matches_jax(x64):
    """The cell list's K-target kicks: the same t_cap below the cap on
    both sides (``_occupancy_t_cap``), the JAX side on its jnp engine."""
    jax_sim, sim = _simulators(512, "float64", multirate_k=64, steps=4,
                               **NLIST)
    side, cap, t_cap = sim.kick_sizing
    want_t_cap = jax_simulation._occupancy_t_cap(
        cap, 64, 512, jax_sim.state.positions, side, "nlist kernel")
    assert (side, cap) == (4, 32) and t_cap == want_t_cap < cap
    want, got = jax_sim.run(), sim.run()
    assert got["kick_t_cap"] == t_cap
    _states_close(got["final_state"], want["final_state"], TOL["float64"])


@pytest.mark.parametrize("cap,k,n,side", [
    (32, 128, 1024, 6),  # mean-based
    (256, 32_768, 262_144, 12),  # the README nlist run's shape
    (8, 4096, 4096, 4),  # the density estimate past the cap: a warning
])
def test_occupancy_t_cap_matches_jax(cap, k, n, side):
    rng = np.random.default_rng(2)
    pos = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    pos[: n // 4] *= 0.05  # a dense core
    with warnings.catch_warnings(record=True) as jax_w:
        warnings.simplefilter("always")
        want = jax_simulation._occupancy_t_cap(cap, k, n, jnp.asarray(pos),
                                               side, "nlist kernel")
        jax_none = jax_simulation._occupancy_t_cap(cap, k, n, None, side,
                                                   "nlist kernel")
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = simulation._occupancy_t_cap(cap, k, n, torch.from_numpy(pos),
                                          side, "nlist kernel")
        got_none = simulation._occupancy_t_cap(cap, k, n, None, side,
                                               "nlist kernel")
    assert (got, got_none) == (want, jax_none)
    assert len(got_w) == len(jax_w)


def test_simulator_multirate_through_the_gram_form(x64):
    """``pallas-mxu``: full evaluation and kicks in the Gram form (its
    plain version on the CPU), against JAX's dense multirate run at the
    Gram form's resolution, 1e-4 (PERF.md section 2)."""
    jax_state, state = _pair(256, "float32")
    cfg = dict(n=256, eps=EPS, integrator="multirate", steps=4,
               multirate_k=32)
    want = JaxSimulator(JaxConfig(force_backend="dense", **cfg),
                        state=jax_state).run()
    got = Simulator(SimulationConfig(force_backend="pallas-mxu", **cfg),
                    state=state, device="cpu").run()
    assert got["backend"] == simulation.MXU_BACKEND
    _states_close(got["final_state"], want["final_state"], 1e-4)


@pytest.mark.parametrize("fields,error,match", [
    # Multirate through P3M is ported (tests/test_torch_p3m_kick_fmm_bf16
    # .py), and on a mesh (tests/test_torch_sharding.py).
    (dict(multirate_k=-1), ValueError, "multirate_k must be >= 0"),
    (dict(multirate_sub=0), ValueError, "multirate_sub >= 1"),
    (dict(multirate_rungs=7), ValueError, r"must be in \[2, 6\]"),
    (dict(multirate_k=64, multirate_rungs=4), ValueError,
     "exceed n=64; lower multirate_k"),
])
def test_simulator_multirate_refusals(fields, error, match):
    with pytest.raises(error, match=match):
        cfg = SimulationConfig(**{"n": 64, "integrator": "multirate",
                                  "force_backend": "dense", **fields})
        Simulator(cfg, device="cpu")


def test_merged_masses_reach_the_kicks(x64):
    """A merge zeroes a donor's mass mid-run: the multirate kicks read
    the masses of the state they are given, so the run equals JAX's,
    whose block binds the masses from its traced state."""
    jax_state, state = _pair(128, "float64")
    cfg = dict(n=128, eps=EPS, integrator="multirate", multirate_k=16,
               steps=6, merge_radius=3e10, merge_every=3, dtype="float64",
               force_backend="dense")
    want = JaxSimulator(JaxConfig(**cfg), state=jax_state).run()
    got = Simulator(SimulationConfig(**cfg), state=state, device="cpu").run()
    assert got["merged_pairs"] == want["merged_pairs"] > 0
    np.testing.assert_array_equal(got["final_state"].masses.numpy(),
                                  np.asarray(want["final_state"].masses))
    _states_close(got["final_state"], want["final_state"], TOL["float64"])
    assert math.isfinite(float(got["final_state"].positions.sum()))
