"""The port's adaptive time stepping (ops/adaptive.py and
Simulator.run_adaptive) against the JAX package, on the CPU.

The state is a seeded random cube with a bound binary planted at its
centre, so the criteria give dt below the ceiling and dt varies from
step to step. Step counts, ``t_reached`` and the dt range are compared
as they come out (the same counts, t to 1 ulp of the dtype); states
relative per row: fp64 1e-12, fp32 1e-5. The smallest dt is the last
step, truncated onto t_end: it absorbs the difference of the sum of all
earlier steps, each equal to the dtype's tolerance, so it is held to
steps x tolerance x the largest dt (measured in fp32: 0.047 s of 268 s
after 169 steps, against a bound of 1.5 s).
"""

import json
import math
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import subprocess_env
from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.constants import G
from gravity_tpu.ops import adaptive as jadaptive
from gravity_tpu.ops.forces import accelerations_vs as jax_accel
from gravity_tpu.simulation import Simulator as JaxSimulator
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy
from gravity_tpu_torch.ops import adaptive
from gravity_tpu_torch.ops.forces import accelerations_vs
from gravity_tpu_torch.simulation import Simulator

TOL = {"float32": 1e-5, "float64": 1e-12}
EPS = 1e9
DT_MAX = 3600.0
# eta per criterion: both bind below DT_MAX on the binary.
ETA = {"accel": 0.025, "velocity": 0.01}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _state(dtype=np.float64, n=128, seed=7):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3e11, 3e11, (n, 3))
    vel = rng.uniform(-3e3, 3e3, (n, 3))
    masses = rng.uniform(1e23, 1e25, n)
    m_b, a_b = 1e28, 2e9
    v_b = math.sqrt(G * 2 * m_b / a_b) * 0.8  # an eccentric orbit
    pos[:2] = [[-a_b / 2, 0, 0], [a_b / 2, 0, 0]]
    vel[:2] = [[0, -v_b / 2, 0], [0, v_b / 2, 0]]
    masses[:2] = m_b
    masses[5] = 0.0  # a tracer: excluded from both criteria
    return tuple(a.astype(dtype) for a in (pos, vel, masses))


def _pair(dtype, **kw):
    pos, vel, masses = _state(np.dtype(dtype).type, **kw)
    jax_state = JaxState(jnp.asarray(pos), jnp.asarray(vel),
                         jnp.asarray(masses))
    state = state_from_numpy(pos, vel, masses, dtype=getattr(torch, dtype),
                             device="cpu")
    return jax_state, state


def _rows_close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(got - want, axis=1)
    scale = np.linalg.norm(want, axis=1)
    assert np.all(err <= tol * scale + 1e-300), float(np.max(err / scale))


def _ulp(x: float, dtype: str) -> float:
    return float(np.spacing(np.abs(np.asarray(x, dtype))))


@pytest.mark.parametrize("exclude", [0, 1, 3])
@pytest.mark.parametrize("criterion", ["accel", "velocity"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_timestep_criteria_match_jax(x64, dtype, criterion, exclude):
    jax_state, state = _pair(dtype)
    acc_j = jax_accel(jax_state.positions, jax_state.positions,
                      jax_state.masses, eps=EPS)
    acc = accelerations_vs(state.positions, state.positions, state.masses,
                           eps=EPS)
    kw = dict(eta=ETA[criterion], eps=EPS, dt_max=DT_MAX,
              exclude_fastest=exclude)
    want = float(jadaptive.make_timestep_fn(criterion, **kw)(jax_state,
                                                            acc_j))
    got = adaptive.make_timestep_fn(criterion, **kw)(state, acc)
    assert got.dtype == getattr(torch, dtype) and got.shape == ()
    # Excluding one binary member leaves the other to bind; excluding
    # three leaves the slow remainder, whose dt is past the ceiling.
    assert 0 < float(got) <= DT_MAX
    assert (float(got) < DT_MAX) == (exclude < 2)
    assert abs(float(got) - want) <= TOL[dtype] * want


def test_timestep_criteria_refuse_like_jax():
    with pytest.raises(ValueError, match="needs a softening length"):
        adaptive.make_timestep_fn("accel", eta=0.1, eps=0.0, dt_max=1.0)
    with pytest.raises(ValueError, match="unknown timestep criterion"):
        adaptive.make_timestep_fn("energy", eta=0.1, eps=1.0, dt_max=1.0)


def _run_both(dtype, criterion, *, steps=40):
    """JAX's while_loop stops at t_end; the port's block is given JAX's
    step count and 5 more, which must do nothing."""
    jax_state, state = _pair(dtype)
    kw = dict(t_end=steps * DT_MAX, dt_max=DT_MAX, eta=ETA[criterion],
              eps=EPS, criterion=criterion)
    want = jadaptive.adaptive_run(
        jax_state, lambda p: jax_accel(p, p, jax_state.masses, eps=EPS),
        **kw)
    got = adaptive.adaptive_run(
        state, lambda p: accelerations_vs(p, p, state.masses, eps=EPS),
        max_steps=int(want.steps) + 5, **kw)
    return want, got


@pytest.mark.parametrize("criterion", ["accel", "velocity"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_adaptive_run_matches_jax(x64, dtype, criterion):
    want, got = _run_both(dtype, criterion)
    assert int(got.steps) == int(want.steps) > 40  # dt below the ceiling
    assert abs(float(got.t) - float(want.t)) <= _ulp(float(want.t), dtype)
    assert float(got.t) == float(np.asarray(40 * DT_MAX, dtype))
    assert abs(float(got.dt_max_used) - float(want.dt_max_used)) <= (
        TOL[dtype] * float(want.dt_max_used))
    assert abs(float(got.dt_min) - float(want.dt_min)) <= (
        int(want.steps) * TOL[dtype] * float(want.dt_max_used))
    _rows_close(got.state.positions.numpy(), want.state.positions,
                TOL[dtype])
    _rows_close(got.state.velocities.numpy(), want.state.velocities,
                TOL[dtype])


def test_block_past_t_end_leaves_the_state_bit_identical():
    """Steps a block takes once t >= t_end change nothing: a block whose
    budget runs 7 steps past t_end equals the one that stops there, and
    a further block from t_end is a no-op."""
    _, state = _pair("float32")

    def run(st, budget, **kw):
        return adaptive.adaptive_run(
            st, lambda p: accelerations_vs(p, p, state.masses, eps=EPS),
            t_end=6 * DT_MAX, dt_max=DT_MAX, eta=ETA["accel"], eps=EPS,
            max_steps=budget, **kw)

    exact = run(state, 12)
    needed = int(exact.steps)
    fits = run(state, needed)
    over = run(state, needed + 7)
    for res in (fits, over):
        assert int(res.steps) == needed
        for name in ("t", "comp", "dt_min", "dt_max_used", "acc"):
            assert torch.equal(getattr(res, name), getattr(exact, name))
        assert torch.equal(res.state.positions, exact.state.positions)
        assert torch.equal(res.state.velocities, exact.state.velocities)
    again = run(over.state, 5, t0=over.t, comp0=over.comp, acc0=over.acc)
    assert int(again.steps) == 0
    assert torch.equal(again.t, over.t) and torch.equal(again.acc, over.acc)
    assert torch.equal(again.state.positions, over.state.positions)
    assert torch.equal(again.state.velocities, over.state.velocities)
    assert float(again.dt_min) == math.inf and float(again.dt_max_used) == 0


def test_ungated_prefix_changes_no_bits():
    """A host ``t0`` lets the sure-active first steps skip the gates; a
    device ``t0`` gates every step: the same bits either way, and
    restarting mid-run from the returned (t, comp, acc) matches one
    call."""
    _, state = _pair("float32")
    kw = dict(t_end=30 * DT_MAX, dt_max=DT_MAX, eta=ETA["accel"], eps=EPS)

    def accel_fn(p):
        return accelerations_vs(p, p, state.masses, eps=EPS)

    assert adaptive.sure_steps(0.0, t_end=kw["t_end"], dt_max=DT_MAX,
                               dtype=torch.float32) == 28
    host = adaptive.adaptive_run(state, accel_fn, max_steps=52, **kw)
    device = adaptive.adaptive_run(state, accel_fn, max_steps=52,
                                   t0=torch.zeros(()), **kw)
    first = adaptive.adaptive_run(state, accel_fn, max_steps=17, **kw)
    rest = adaptive.adaptive_run(first.state, accel_fn, max_steps=35,
                                 t0=float(first.t), comp0=float(first.comp),
                                 acc0=first.acc, **kw)
    assert int(first.steps) + int(rest.steps) == int(host.steps)
    for res in (device, rest):
        assert torch.equal(res.t, host.t)
        assert torch.equal(res.state.positions, host.state.positions)
        assert torch.equal(res.state.velocities, host.state.velocities)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_direct_call_at_default_max_steps_stops_near_t_end(x64, dtype):
    """A direct call at the default max_steps (1e6, JAX's) stops within a
    block of t_end, as JAX's while_loop does at it: it evaluates forces at
    most once a step, once for acc0 and once a tail step of its last
    block; its result has the bits of the masked loop that runs 200 steps
    past t_end with no host read, and matches JAX's at the bars above."""
    jax_state, state = _pair(dtype)
    calls = [0]

    def accel_fn(p):
        calls[0] += 1
        return accelerations_vs(p, p, state.masses, eps=EPS)

    kw = dict(t_end=40 * DT_MAX, dt_max=DT_MAX, eta=ETA["accel"], eps=EPS)
    got = adaptive.adaptive_run(state, accel_fn, **kw)
    steps = int(got.steps)
    assert float(got.t) == float(np.asarray(40 * DT_MAX, dtype))
    assert calls[0] <= 1 + steps + adaptive.BLOCK
    masked = adaptive.adaptive_run(state, accel_fn, max_steps=steps + 200,
                                   block=steps + 200, **kw)
    for name in ("t", "comp", "dt_min", "dt_max_used", "steps", "acc"):
        assert torch.equal(getattr(got, name), getattr(masked, name))
    assert torch.equal(got.state.positions, masked.state.positions)
    assert torch.equal(got.state.velocities, masked.state.velocities)
    want = jadaptive.adaptive_run(
        jax_state, lambda p: jax_accel(p, p, jax_state.masses, eps=EPS),
        **kw)
    assert steps == int(want.steps)
    _rows_close(got.state.positions.numpy(), want.state.positions,
                TOL[dtype])
    _rows_close(got.state.velocities.numpy(), want.state.velocities,
                TOL[dtype])


def _sims(dtype, **kw):
    jax_state, state = _pair(dtype)
    cfg = dict(n=state.n, dtype=dtype, force_backend="dense", eps=EPS,
               dt=DT_MAX, adaptive=True, **kw)
    return (JaxSimulator(JaxConfig(**cfg), state=jax_state),
            Simulator(SimulationConfig(**cfg), state=state, device="cpu"))


STAT_KEYS = ("adaptive_steps", "t_reached", "dt_min", "dt_max_used",
             "criterion", "t_end")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("criterion", ["accel", "velocity"])
def test_simulator_adaptive_run_matches_jax(x64, criterion, dtype):
    """Blocks of progress_every steps on both sides (the port's last
    blocks are shorter): the same stats and final state."""
    jax_sim, sim = _sims(dtype, steps=30, integrator="leapfrog",
                         eta=ETA[criterion], timestep_criterion=criterion,
                         progress_every=16)
    want, got = jax_sim.run(), sim.run()
    for key in STAT_KEYS:
        if key.startswith("dt"):
            continue
        assert got[key] == want[key], key
    assert abs(got["dt_max_used"] - want["dt_max_used"]) <= (
        TOL[dtype] * want["dt_max_used"])
    assert abs(got["dt_min"] - want["dt_min"]) <= (
        want["adaptive_steps"] * TOL[dtype] * want["dt_max_used"])
    # The port's blocks waste no more than a block's worth of steps.
    assert 0 <= got["adaptive_tail_steps"] < 16
    _rows_close(got["final_state"].positions.numpy(),
                want["final_state"].positions, TOL[dtype])


@pytest.mark.parametrize("rungs", [2, 3])
def test_adaptive_multirate_composition_matches_jax(x64, rungs):
    """The outer dt from the slow remainder (the k fastest excluded),
    the rungs subdividing it: the same step count and state as JAX."""
    jax_sim, sim = _sims("float64", steps=12, integrator="multirate",
                         multirate_k=16, multirate_rungs=rungs,
                         progress_every=5, eta=0.0005)
    want, got = jax_sim.run(), sim.run()
    for key in STAT_KEYS:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["adaptive_steps"] > 12
    _rows_close(got["final_state"].positions.numpy(),
                want["final_state"].positions, TOL["float64"])
    _rows_close(got["final_state"].velocities.numpy(),
                want["final_state"].velocities, TOL["float64"])


def test_adaptive_refuses_what_jax_refuses():
    _, state = _pair("float64")
    for integrator in ("verlet", "yoshida4"):
        sim = Simulator(SimulationConfig(n=state.n, adaptive=True, eps=EPS,
                                         integrator=integrator),
                        state=state, device="cpu")
        with pytest.raises(ValueError, match="is not supported"):
            sim.run()


def test_cli_adaptive_run_and_merge_refusal(tmp_path):
    """``--adaptive`` on the CPU prints the adaptive stats; with
    ``--merge-radius`` the CLI refuses with rc 1, as the JAX CLI."""
    base = [sys.executable, "-m", "gravity_tpu_torch", "run", "--device",
            "cpu", "--preset", "baseline-16k", "--n", "256", "--steps", "5",
            "--log-dir", str(tmp_path), "--adaptive", "--eta", "0.001"]
    out = subprocess.run(base, capture_output=True, text=True, timeout=300,
                         env=subprocess_env(), cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert stats["criterion"] == "accel"
    assert stats["t_reached"] == 5 * 3600.0
    assert stats["adaptive_steps"] > 5
    refused = subprocess.run(base + ["--merge-radius", "1e9"],
                             capture_output=True, text=True, timeout=300,
                             env=subprocess_env(), cwd=tmp_path)
    assert refused.returncode == 1
    assert "does not support --merge-radius" in refused.stderr
