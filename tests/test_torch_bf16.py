"""bfloat16 states in the port, against tests/test_bfloat16.py's bars and
against the JAX package at bf16 on the CPU.

bf16 has fp32's exponent range and an 8-bit mantissa (one ulp = 2^-8 of
a value's binade). The bars of the JAX suite: the force field within a
median 1% and a p90 of 3% of fp32, leapfrog energy drift below 1e-3 over
100 steps, the dtype kept through a run.

Parity on one numpy state (a JAX Plummer sphere rounded to bf16), in
units of each row's sum of |terms| (the scale a row's roundings act
on), per component:

- The port's plain bf16 sum against the JAX dense bf16 sum: both round
  the same ops to bf16, but XLA's einsum keeps each product w d unrounded
  where torch rounds it (2^-9 of a term), XLA's rsqrt may round a term's
  1/r the other way (2^-8 of it), and each rounds its result once (2^-9
  of the row): at most 2^-7 of the row's sum of |terms|. Most components
  are the same bits (measured 88% at N = 1,024, 92% at 4,096).
- The port against the JAX Pallas kernel in interpret mode at N = 4,096
  (two 2,048-source tiles): that kernel also rounds each tile's partial
  to bf16 and adds the two in a bf16 accumulator, three more roundings
  of 2^-9: at most 3 x 2^-8. The port sums in fp32 and rounds once, as
  the JAX dense form and the CUDA kernel's bf16 form do; the gap to the
  tile accumulator is a median relative 1.2e-3 here (measured), and is
  held below 2^-8.
- One integrator step on a fixed state and fixed accelerations: the same
  bits as JAX, which rounds its weak-typed Python step size to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.models import create_plummer as jax_plummer
from gravity_tpu.ops import integrators as jax_integrators
from gravity_tpu.ops.forces import accelerations_vs as jax_accelerations_vs
from gravity_tpu.ops.pallas_forces import pallas_accelerations_vs
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch.config import NotPortedError, SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy, state_to_numpy
from gravity_tpu_torch.ops import diagnostics, integrators
from gravity_tpu_torch.ops.forces import _pair_weights, accelerations_vs
from gravity_tpu_torch.simulation import (
    Simulator,
    _resolve_backend,
    resolve_dtype,
)
from gravity_tpu_torch.utils.trajectory import TrajectoryReader, TrajectoryWriter

G = 6.6743e-11
BF16_ULP = 2.0**-8


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _energy_f64(state, cfg) -> float:
    return float(diagnostics.total_energy(state.astype(torch.float64),
                                          g=cfg.g, eps=cfg.eps))


def test_resolve_dtype_accepts_bfloat16():
    assert resolve_dtype("bfloat16") == torch.bfloat16


@pytest.mark.parametrize("n", [256, 4096])
def test_bf16_force_field_error_vs_fp32(n):
    """The dense force field of the port's Plummer sphere at bf16 against
    the same initial conditions evaluated in fp32."""
    acc = {}
    for dtype in ("float32", "bfloat16"):
        cfg = SimulationConfig(model="plummer", n=n, eps=1e10, dtype=dtype,
                               force_backend="dense", seed=3)
        sim = Simulator(cfg, device="cpu")
        acc[dtype] = sim.accel(sim.state.positions,
                               sim.state.masses).double().numpy()
    norm = np.linalg.norm(acc["float32"], axis=-1)
    err = np.linalg.norm(acc["bfloat16"] - acc["float32"], axis=-1) / norm
    assert np.isfinite(err).all()
    assert np.median(err) < 0.01
    assert np.percentile(err, 90) < 0.03


def test_bf16_leapfrog_energy_drift_bounded():
    """100 leapfrog steps of a softened Plummer sphere: the bf16 total
    energy (evaluated in fp64) drifts < 1e-3 relative, fp32 < 1e-6."""
    drift = {}
    for dtype in ("float32", "bfloat16"):
        cfg = SimulationConfig(model="plummer", n=256, eps=1e10, dtype=dtype,
                               force_backend="dense", integrator="leapfrog",
                               steps=100, dt=1e4, seed=3)
        sim = Simulator(cfg, device="cpu")
        e0 = _energy_f64(sim.state, cfg)
        final = sim.run()["final_state"]
        assert bool(torch.isfinite(final.positions).all())
        drift[dtype] = diagnostics.energy_drift(e0, _energy_f64(final, cfg))
    assert drift["bfloat16"] < 1e-3
    assert drift["float32"] < 1e-6


@pytest.mark.parametrize("backend", ["dense", "chunked", "pallas",
                                     "pallas-mxu"])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_bf16_state_round_trips_through_integrators(integrator, backend):
    """The carry keeps the state's dtype on every bf16 backend: no silent
    promotion to fp32 mid-run."""
    cfg = SimulationConfig(model="random", n=64, dtype="bfloat16",
                           force_backend=backend, integrator=integrator,
                           steps=5, dt=3600.0, seed=1, eps=1e9, chunk=16)
    stats = Simulator(cfg, device="cpu").run()
    final = stats["final_state"]
    assert final.positions.dtype == torch.bfloat16
    assert final.velocities.dtype == torch.bfloat16
    assert bool(torch.isfinite(final.positions).all())
    assert stats["dtype"] == "bfloat16"


def test_bf16_routing_and_refusals():
    """A bf16 state takes nbody_direct's bf16 form on auto, direct and
    pallas on the card, nbody_mxu's bf16 form on pallas-mxu, the plain
    version on dense and chunked, the cell list on nlist; P3M refuses it
    with the JAX package's own reason (its mesh FFT, pm.py:286)."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    for backend in ("auto", "direct", "pallas"):
        cfg = SimulationConfig(n=16_384, dtype="bfloat16",
                               force_backend=backend)
        assert _resolve_backend(cfg, cuda) == "nbody_direct"
    cfg = SimulationConfig(dtype="bfloat16", force_backend="pallas-mxu")
    assert _resolve_backend(cfg, cuda) == "nbody_mxu"
    for backend in ("dense", "chunked"):
        cfg = SimulationConfig(dtype="bfloat16", force_backend=backend)
        assert _resolve_backend(cfg, cuda) == backend
    assert _resolve_backend(SimulationConfig(dtype="bfloat16"), cpu) == "dense"
    cfg = SimulationConfig(dtype="bfloat16", force_backend="nlist",
                           nlist_rcut=5e10)
    assert _resolve_backend(cfg, cuda) == "nlist"
    with pytest.raises(ValueError, match="pm.py:286") as e:
        SimulationConfig(dtype="bfloat16", force_backend="p3m")
    assert not isinstance(e.value, NotPortedError)


def test_bf16_interop_and_trajectories(tmp_path):
    """A JAX bf16 array (numpy's ml_dtypes bfloat16) becomes the same bf16
    values; a bf16 run records float32 frames, exact, as the JAX writer."""
    rng = np.random.default_rng(0)
    pos = jnp.asarray(rng.uniform(-3e11, 3e11, (40, 3)), jnp.bfloat16)
    vel = jnp.asarray(rng.uniform(-3e4, 3e4, (40, 3)), jnp.bfloat16)
    masses = jnp.asarray(rng.uniform(1e23, 1e25, 40), jnp.bfloat16)
    arrays = [np.asarray(a) for a in (pos, vel, masses)]
    assert arrays[0].dtype.name == "bfloat16"
    state = state_from_numpy(*arrays, dtype=torch.bfloat16, device="cpu")
    for got, want in zip(state_to_numpy(state), arrays):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want.astype(np.float32))

    cfg = SimulationConfig(n=40, steps=6, dtype="bfloat16", progress_every=3,
                           trajectory_every=2, eps=1e9)
    sim = Simulator(cfg, state, device="cpu")
    writer = TrajectoryWriter(str(tmp_path / "traj"), sim.n_real)
    final = sim.run(trajectory_writer=writer)["final_state"]
    frames = TrajectoryReader(str(tmp_path / "traj")).load()
    assert frames.shape == (3, 40, 3) and frames.dtype == np.float32
    np.testing.assert_array_equal(frames[-1], final.positions.float().numpy())


def _plummer_bf16(n, seed=3):
    """A JAX Plummer sphere rounded to bf16: (jax arrays, port state)."""
    state = jax_plummer(jax.random.PRNGKey(seed), n)
    pos = state.positions.astype(jnp.bfloat16)
    masses = state.masses.astype(jnp.bfloat16)
    port = state_from_numpy(np.asarray(pos), np.asarray(pos),
                            np.asarray(masses), dtype=torch.bfloat16,
                            device="cpu")
    return pos, masses, port


def _term_scale(positions, masses, eps):
    """Each row's sum of |w_ij d_ij| over sources, in float64."""
    p, m = positions.double(), masses.double()
    diff = p[None, :, :] - p[:, None, :]
    w = _pair_weights((diff * diff).sum(-1), m[None, :], G, 1e-10, eps)
    return (w[:, :, None] * diff.abs()).sum(dim=1).numpy()


@pytest.mark.parametrize("eps", [0.0, 1e9])
def test_plain_bf16_matches_jax_dense_bf16(eps):
    pos, masses, port = _plummer_bf16(1024)
    want = np.asarray(jax_accelerations_vs(pos, pos, masses, eps=eps)
                      .astype(jnp.float32), np.float64)
    got = accelerations_vs(port.positions, port.positions, port.masses,
                           eps=eps)
    assert got.dtype == torch.bfloat16
    got = got.double().numpy()
    scale = _term_scale(port.positions, port.masses, eps)
    assert np.all(np.abs(got - want) <= 2 * BF16_ULP * scale)
    assert (got == want).mean() > 0.8


def test_plain_bf16_matches_the_jax_pallas_kernel_in_interpret_mode():
    """N = 4,096: the Pallas kernel's 2,048-source tiles add their
    partials in a bf16 accumulator; the port sums in fp32."""
    pos, masses, port = _plummer_bf16(4096)
    eps = 1e9
    want = np.asarray(pallas_accelerations_vs(pos, pos, masses, eps=eps,
                                              interpret=True)
                      .astype(jnp.float32), np.float64)
    got = accelerations_vs(port.positions, port.positions, port.masses,
                           eps=eps).double().numpy()
    scale = _term_scale(port.positions, port.masses, eps)
    assert np.all(np.abs(got - want) <= 3 * BF16_ULP * scale)
    rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert np.median(rel) < BF16_ULP


@pytest.mark.parametrize("name", ["euler", "leapfrog", "verlet", "yoshida4"])
def test_bf16_step_rounds_dt_as_jax(name):
    """One step of a fixed bf16 state under fixed accelerations gives
    JAX's bits. Velocities start at 0, so v + a dt is the product itself,
    which a step size left unrounded (bf16(2e-3) is 5e-4 away) would
    round differently in many components."""
    rng = np.random.default_rng(7)
    pos = jnp.asarray(rng.uniform(-1.0, 1.0, (512, 3)), jnp.bfloat16)
    vel = jnp.zeros((512, 3), jnp.bfloat16)
    acc = jnp.asarray(rng.uniform(-1.0, 1.0, (512, 3)), jnp.bfloat16)
    masses = jnp.ones(512, jnp.bfloat16)
    dt = 2e-3
    jstate = JaxState(pos, vel, masses)
    jstep = jax_integrators.make_step_fn(name, lambda p: acc, dt)
    jstate, jacc = jstep(jstate, acc)

    state = state_from_numpy(*(np.asarray(a) for a in (pos, vel, masses)),
                             dtype=torch.bfloat16, device="cpu")
    tacc = torch.from_numpy(np.array(acc.astype(jnp.float32))).bfloat16()
    step = integrators.make_step_fn(name, lambda p: tacc, dt)
    state, _ = step(state, tacc)
    for got, want in ((state.positions, jstate.positions),
                      (state.velocities, jstate.velocities)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    # The test can see the rounding: with dt unrounded, torch multiplies
    # in fp32 and rounds once, and the kick differs from JAX's.
    unrounded = (tacc * dt).float().numpy()
    kick = np.asarray((acc * dt).astype(jnp.float32))
    assert (unrounded != kick).mean() > 0.05
