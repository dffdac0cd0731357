"""The port's plain direct sum against the JAX package.

Inputs are drawn with numpy from a seed and fed to both sides:
``gravity_tpu_torch.ops.forces`` against ``gravity_tpu.ops.forces`` (the
jnp path) and against the Pallas kernel in interpret mode, as
tests/test_pallas_kernel.py runs it. Tolerances:

- fp32, rtol 2e-5 / atol 1e-12: the two sides sum the same terms in a
  different order, and XLA's and PyTorch's rsqrt may differ by an ulp;
  the accelerations here are ~1e-8, so atol is ~1e-4 of them.
- fp64, rtol 1e-12 against tests/reference_oracle.py: the oracle's loop
  order differs from a vectorized sum by a few ulp per row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_oracle
from gravity_tpu.ops import forces as jax_forces
from gravity_tpu.ops.pallas_forces import pallas_accelerations_vs
from gravity_tpu_torch.ops import direct_kernel
from gravity_tpu_torch.ops.forces import (
    accelerations_vs,
    pairwise_accelerations_chunked,
    pairwise_accelerations_dense,
    potential_energy,
)
from gravity_tpu_torch.state import ParticleState

FP32 = dict(rtol=2e-5, atol=1e-12)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _system(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3e11, 3e11, (n, 3)).astype(dtype)
    masses = rng.uniform(1e23, 1e25, n).astype(dtype)
    return pos, masses


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("eps", [0.0, 1e9])
@pytest.mark.parametrize("n", [64, 256, 1000])
def test_matches_jax_jnp_and_pallas(n, eps):
    pos, masses = _system(n, seed=n)
    tp, tm = _torch(pos, masses)
    want = np.asarray(jax_forces.accelerations_vs(
        jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(masses), eps=eps
    ))
    pallas = np.asarray(pallas_accelerations_vs(
        jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(masses), eps=eps,
        tile_i=32, tile_j=128, interpret=True,
    ))
    got = accelerations_vs(tp, tp, tm, eps=eps).numpy()
    np.testing.assert_allclose(got, want, **FP32)
    np.testing.assert_allclose(got, pallas, **FP32)
    dense = pairwise_accelerations_dense(tp, tm, eps=eps).numpy()
    np.testing.assert_array_equal(dense, got)
    # A ragged last chunk: N need not divide by the chunk.
    chunked = pairwise_accelerations_chunked(tp, tm, eps=eps, chunk=100)
    np.testing.assert_allclose(chunked.numpy(), want, **FP32)


def test_rectangular_targets_sources():
    pos, masses = _system(384, seed=3)
    tp, tm = _torch(pos, masses)
    want = np.asarray(pallas_accelerations_vs(
        jnp.asarray(pos[:100]), jnp.asarray(pos), jnp.asarray(masses),
        tile_i=32, tile_j=128, interpret=True,
    ))
    got = accelerations_vs(tp[:100], tp, tm).numpy()
    np.testing.assert_allclose(got, want, **FP32)


def test_coincident_bodies_zero_and_finite():
    """Every pair below the cutoff: zero force and no NaN, exactly."""
    pos = torch.zeros(16, 3)
    masses = torch.full((16,), 1e30)
    acc = accelerations_vs(pos, pos, masses)
    assert bool(torch.isfinite(acc).all())
    assert bool((acc == 0).all())


@pytest.mark.parametrize("eps", [0.0, 1e9])
def test_zero_mass_padding_is_a_no_op(eps):
    """Padding to 400 with pad_to leaves the real rows' forces as they
    were (fp64, rtol 1e-14: only the summation's lane split changes)."""
    pos, masses = _system(384, seed=5, dtype=np.float64)
    vel = np.zeros_like(pos)
    state = ParticleState.create(pos, vel, masses)
    padded, mask = state.pad_to(400)
    base = accelerations_vs(state.positions, state.positions, state.masses,
                            eps=eps)
    acc = accelerations_vs(padded.positions, padded.positions,
                           padded.masses, eps=eps)
    assert bool(torch.isfinite(acc).all())
    np.testing.assert_allclose(acc[mask].numpy(), base.numpy(), rtol=1e-14)


def test_fp32_underflow_ordering_keeps_distant_pairs():
    """Two 1e24 kg bodies 1e13 m apart: inv_r**3 = 1e-39 is subnormal in
    fp32, so the weight must fold G*m in first. The force is non-zero and
    matches fp64 and the JAX package (rtol 1e-5: a few fp32 roundings)."""
    pos = np.array([[0.0, 0.0, 0.0], [1e13, 0.0, 0.0]], np.float32)
    masses = np.array([1e24, 1e24], np.float32)
    tp, tm = _torch(pos, masses)
    got = accelerations_vs(tp, tp, tm).numpy()
    assert np.all(got[:, 0] != 0)
    want64 = np.array([6.67430e-11 * 1e24 / 1e26, -6.67430e-11 * 1e24 / 1e26])
    np.testing.assert_allclose(got[:, 0], want64, rtol=1e-5)
    jax_got = np.asarray(jax_forces.accelerations_vs(
        jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(masses)
    ))
    np.testing.assert_allclose(got, jax_got, rtol=1e-5, atol=0)


def test_fp64_matches_reference_oracle():
    pos, masses = _system(32, seed=11, dtype=np.float64)
    tp, tm = _torch(pos, masses)
    got = accelerations_vs(tp, tp, tm).numpy()
    np.testing.assert_allclose(
        got, reference_oracle.accelerations(pos, masses), rtol=1e-12
    )


@pytest.mark.parametrize("chunk", [4096, 50])
def test_potential_energy_matches_jax(chunk):
    """Dense and chunked potential sums (rtol 1e-5, fp32 summation)."""
    pos, masses = _system(200, seed=13)
    tp, tm = _torch(pos, masses)
    want = float(jax_forces.potential_energy(
        jnp.asarray(pos), jnp.asarray(masses), chunk=chunk
    ))
    got = float(potential_energy(tp, tm, chunk=chunk))
    assert got < 0
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("n,rcut", [(64, 2e11), (300, 1e11)])
def test_rcut_masked_sum_matches_jax(n, rcut):
    """The truncated direct sum, the exact reference of the cell list:
    pairs beyond rcut contribute nothing, as in the JAX package."""
    pos, masses = _system(n, seed=n)
    tp, tm = _torch(pos, masses)
    want = np.asarray(jax_forces.accelerations_vs(
        jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(masses), eps=1e9,
        rcut=rcut))
    got = accelerations_vs(tp, tp, tm, eps=1e9, rcut=rcut).numpy()
    np.testing.assert_allclose(got, want, **FP32)
    full = accelerations_vs(tp, tp, tm, eps=1e9).numpy()
    assert np.abs(got - full).max() > 0
    chunked = pairwise_accelerations_chunked(tp, tm, eps=1e9, rcut=rcut,
                                             chunk=50)
    np.testing.assert_allclose(chunked.numpy(), want, **FP32)


def test_box_is_not_ported():
    """The minimum-image ``box`` form, ported with the periodic family (no
    longer refused): against the JAX package's, plain and rcut-masked,
    with positions straddling the box's faces."""
    pos, masses = _system(64)
    box = float(np.abs(pos).max())  # the cloud spans about two boxes
    tp, tm = _torch(pos, masses)
    for rcut in (0.0, 0.3 * box):
        want = np.asarray(jax_forces.accelerations_vs(
            jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(masses),
            eps=1e9, rcut=rcut, box=box))
        got = accelerations_vs(tp, tp, tm, eps=1e9, rcut=rcut, box=box)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                                   atol=1e-6 * np.abs(want).max())
        isolated = accelerations_vs(tp, tp, tm, eps=1e9, rcut=rcut)
        assert not np.allclose(got.numpy(), isolated.numpy())


def test_kernel_wrapper_on_cpu_is_the_plain_version():
    pos, masses = _torch(*_system(100, seed=17))
    before = direct_kernel.LAUNCHES
    got = direct_kernel.accelerations_vs_kernel(pos, pos, masses, eps=1e9)
    assert direct_kernel.LAUNCHES == before
    want = accelerations_vs(pos, pos, masses, eps=1e9)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
