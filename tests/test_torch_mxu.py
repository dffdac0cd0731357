"""The port's Gram (matmul) form of the direct sum against the JAX package.

The same numpy inputs go through ``gravity_tpu_torch.ops.mxu_kernel``
(its plain version, which is what CPU tensors run) and through
``gravity_tpu.ops.pallas_forces_mxu`` in interpret mode, as
tests/test_pallas_mxu.py runs it. The two sum in other orders and centre
on a centroid rounded in another order, so the comparison is
statistical: per-row relative error, with budgets 3-10x over what was
measured on the CPU at n = 64 .. 2048 (port against JAX):

- fp32: median 4.9e-7 .. 1.7e-6, p99 1.3e-5 .. 2.3e-4, max 1.5e-5 .. 4.5e-3
  (the epilogue's cancellation tail, as in the JAX suite);
- bf16: median 1.8e-7 .. 7.5e-7, p99 2.4e-6 .. 2.1e-5, max 3.7e-6 .. 1.5e-4
  (both sides quantize the same operands; against the exact sum both sit
  at the bf16 class, median ~4e-3).

The structural contracts are exact: coincident and self pairs give
exactly zero, and a float64 input computes in float32 and is cast back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.ops.pallas_forces_mxu import (
    GRAM_NOISE_TAU as JAX_TAU,
)
from gravity_tpu.ops.pallas_forces_mxu import (
    pallas_accelerations_vs_mxu,
)
from gravity_tpu.simulation import Simulator as JaxSimulator
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy, state_to_numpy
from gravity_tpu_torch.ops import mxu_kernel
from gravity_tpu_torch.ops.forces import accelerations_vs
from gravity_tpu_torch.simulation import (
    KERNEL_BACKEND,
    MXU_BACKEND,
    Simulator,
    _resolve_backend,
)

BUDGET = {"fp32": (1e-5, 1e-3, 2e-2), "bf16": (5e-6, 2e-4, 1e-3)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _system(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3e11, 3e11, (n, 3)).astype(dtype)
    masses = rng.uniform(1e23, 1e25, n).astype(dtype)
    return pos, masses


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b, axis=-1)
    return np.linalg.norm(a - b, axis=-1) / np.where(den > 0, den, 1.0)


def _within(err, precision):
    median, p99, worst = BUDGET[precision]
    assert float(np.median(err)) < median
    assert float(np.percentile(err, 99)) < p99
    assert float(err.max()) < worst


def _port(pos_i, pos_j, masses, **kw):
    return mxu_kernel.accelerations_vs_mxu_kernel(
        torch.from_numpy(pos_i), torch.from_numpy(pos_j),
        torch.from_numpy(masses), **kw).numpy()


def _jax(pos_i, pos_j, masses, **kw):
    return np.asarray(pallas_accelerations_vs_mxu(
        jnp.asarray(pos_i), jnp.asarray(pos_j), jnp.asarray(masses),
        tile_i=32, tile_j=128, interpret=True, **kw))


def test_noise_floor_is_the_jax_packages():
    assert mxu_kernel.GRAM_NOISE_TAU == JAX_TAU


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("n", [64, 256, 1000])
def test_matches_jax_interpreted_kernel(n, precision):
    pos, masses = _system(n, seed=n)
    got = _port(pos, pos, masses, eps=1e9, precision=precision)
    want = _jax(pos, pos, masses, eps=1e9, precision=precision)
    assert got.dtype == np.float32
    _within(_rel_err(got, want), precision)


def test_rectangular_targets_sources():
    pos, masses = _system(384, seed=3)
    got = _port(pos[:100], pos, masses, eps=1e9)
    _within(_rel_err(got, _jax(pos[:100], pos, masses, eps=1e9)), "fp32")
    exact = accelerations_vs(torch.from_numpy(pos[:100]).double(),
                             torch.from_numpy(pos).double(),
                             torch.from_numpy(masses).double(), eps=1e9)
    _within(_rel_err(got, exact.numpy()), "fp32")


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("eps", [0.0, 1e9])
def test_coincident_bodies_give_exactly_zero(eps, precision):
    pos = np.full((16, 3), 2.5e11, np.float32)
    masses = np.full(16, 1e30, np.float32)
    got = _port(pos, pos, masses, eps=eps, precision=precision)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, 0.0)


def test_zero_mass_padding_is_a_no_op():
    """Zero-mass sources add nothing. Appended anywhere they shift the
    centroid, which re-rounds the centering: an fp32-class change. With
    the centroid held they change nothing but the order of the sums."""
    pos, masses = _system(200, seed=5)
    junk = np.full((56, 3), 1.7e11, np.float32)
    base = _port(pos, pos, masses, eps=1e9)
    aug = _port(pos, np.concatenate([pos, junk]),
                np.concatenate([masses, np.zeros(56, np.float32)]), eps=1e9)
    _within(_rel_err(aug, base), "fp32")
    center = pos.astype(np.float32).mean(axis=0, dtype=np.float32)
    acc4 = mxu_kernel.gram_acc4_plain(
        torch.from_numpy(pos - center),
        torch.from_numpy(np.concatenate([pos - center,
                                         np.zeros((8, 3), np.float32)])),
        torch.from_numpy(np.concatenate([masses, np.zeros(8, np.float32)])
                         * np.float32(6.6743e-11)),
        cutoff=1e-10, eps=1e9, bf16=False)
    base4 = mxu_kernel.gram_acc4_plain(
        torch.from_numpy(pos - center), torch.from_numpy(pos - center),
        torch.from_numpy(masses * np.float32(6.6743e-11)),
        cutoff=1e-10, eps=1e9, bf16=False)
    np.testing.assert_allclose(acc4.numpy(), base4.numpy(), rtol=1e-6)


def test_float64_input_computes_in_float32(x64):
    pos, masses = _system(128, seed=6, dtype=np.float64)
    got = _port(pos, pos, masses, eps=1e9)
    assert got.dtype == np.float64
    as32 = _port(pos.astype(np.float32), pos.astype(np.float32),
                 masses.astype(np.float32), eps=1e9)
    np.testing.assert_array_equal(got, as32.astype(np.float64))
    want = _jax(pos, pos, masses, eps=1e9)
    assert want.dtype == np.float64
    _within(_rel_err(got, want), "fp32")


def test_local_kernel_and_all_pairs_forms():
    pos, masses = _system(96, seed=11)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(masses)
    want = mxu_kernel.accelerations_vs_mxu_kernel(tp[:40], tp, tm, eps=1e9)
    kernel = mxu_kernel.make_mxu_local_kernel(eps=1e9)
    np.testing.assert_array_equal(kernel(tp[:40], tp, tm).numpy(),
                                  want.numpy())
    np.testing.assert_array_equal(
        mxu_kernel.pairwise_accelerations_mxu(tp, tm, eps=1e9).numpy(),
        mxu_kernel.accelerations_vs_mxu_kernel(tp, tp, tm, eps=1e9).numpy())


def test_bad_precision_raises():
    pos, masses = _system(8, seed=7)
    with pytest.raises(ValueError, match="precision"):
        _port(pos, pos, masses, precision="fp16")


def test_kernel_wrapper_on_cpu_is_the_plain_version():
    pos, masses = _system(100, seed=8)
    xi = torch.from_numpy(pos / np.float32(1e11))
    gm = torch.from_numpy(masses * np.float32(6.6743e-11))
    before = mxu_kernel.LAUNCHES
    for bf16 in (False, True):
        ops = xi.to(torch.bfloat16) if bf16 else xi
        got = mxu_kernel.gram_acc4(ops, ops, gm, cutoff=1e-10, eps=0.1)
        want = mxu_kernel.gram_acc4_plain(ops, ops, gm, cutoff=1e-10,
                                          eps=0.1, bf16=bf16)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert mxu_kernel.LAUNCHES == before


def test_routing_is_explicit_opt_in():
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    for device in (cpu, cuda):
        assert _resolve_backend(SimulationConfig(
            force_backend="pallas-mxu"), device) == MXU_BACKEND
    for backend in ("auto", "direct"):
        assert _resolve_backend(SimulationConfig(
            n=65536, force_backend=backend), cuda) == KERNEL_BACKEND


def test_simulator_pallas_mxu_matches_jax():
    """20 softened leapfrog steps through the Gram form in both packages
    (positions within 1e-5 of the largest, as the JAX suite's
    pallas-mxu-vs-dense run)."""
    pos, masses = _system(64, seed=9)
    vel = np.random.default_rng(10).uniform(-3e4, 3e4, (64, 3)).astype(
        np.float32)
    common = dict(model="random", n=64, steps=20, integrator="leapfrog",
                  force_backend="pallas-mxu", eps=1e9, progress_every=10)
    jax_final = JaxSimulator(
        JaxConfig(**common),
        state=JaxState(jnp.asarray(pos), jnp.asarray(vel),
                       jnp.asarray(masses)),
    ).run()["final_state"]
    sim = Simulator(SimulationConfig(**common),
                    state_from_numpy(pos, vel, masses, device="cpu"),
                    device="cpu")
    assert sim.backend == MXU_BACKEND
    stats = sim.run()
    got = state_to_numpy(stats["final_state"])[0].astype(np.float64)
    want = np.asarray(jax_final.positions, np.float64)
    scale = np.linalg.norm(want, axis=-1).max()
    assert float(np.linalg.norm(got - want, axis=-1).max()) / scale < 1e-5
    assert stats["kernel_launches"] == 0  # the CPU runs the plain version
