"""The port's ``debug_check_forces`` (``gravity_tpu_torch/utils/
profiling.py``) against the JAX package's, on the CPU.

The same numpy state and the same accelerations to audit go into both:
both sample the same rows (``np.random.RandomState(seed)``), so the same
relative errors come out, within 1e-6 in float32 (the two oracles sum
their rows in other orders) and 1e-12 in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.utils.profiling import debug_check_forces as jax_check
from gravity_tpu_torch.utils.profiling import debug_check_forces

TOL = {np.float32: 1e-6, np.float64: 1e-12}
KEYS = ("max_rel_err", "p90_rel_err", "median_rel_err")


def _state(n, dtype, seed=3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3e11, 3e11, (n, 3)).astype(dtype)
    masses = rng.uniform(1e23, 1e25, n).astype(dtype)
    return pos, masses


def _audited(pos, masses, rcut, dtype, seed=4):
    """Accelerations to audit: the exact (rcut-masked) sum in float64,
    each row off by its own relative amount, so a row checked by one
    package and not the other would show in the statistics."""
    p = pos.astype(np.float64)
    d = p[None, :, :] - p[:, None, :]
    r2 = (d * d).sum(-1)
    w = 6.6743e-11 * masses.astype(np.float64)[None, :] / (r2 + 1e18) ** 1.5
    w[(r2 == 0) | ((r2 > rcut * rcut) if rcut else False)] = 0.0
    exact = (w[:, :, None] * d).sum(1)
    rng = np.random.default_rng(seed)
    off = rng.uniform(0.0, 0.1, (pos.shape[0], 1))
    return (exact * (1.0 + off)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rcut", [0.0, 2e11])
@pytest.mark.parametrize("n,sample", [(300, 128), (700, 128), (90, 2048)])
def test_audit_of_given_accelerations_matches_jax(x64, dtype, rcut, n,
                                                  sample):
    pos, masses = _state(n, dtype)
    full = _audited(pos, masses, rcut, dtype)
    kw = dict(eps=1e9, rcut=rcut, sample=sample, seed=1)
    got = debug_check_forces(torch.from_numpy(pos), torch.from_numpy(masses),
                             full_acc=torch.from_numpy(full), **kw)
    want = jax_check(jnp.asarray(pos), jnp.asarray(masses),
                     full_acc=jnp.asarray(full), **kw)
    assert got["n_checked"] == want["n_checked"] == min(n, sample)
    for key in KEYS:
        assert got[key] == pytest.approx(want[key], rel=0,
                                         abs=TOL[dtype]), key
    assert got["median_rel_err"] > 0.01  # the offsets, not the oracle


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kernel_audit_matches_jax(x64, dtype):
    """A kernel given to both: the same near-zero errors; the port's
    default kernel (the direct-sum wrapper, plain on the CPU) too."""
    from gravity_tpu.ops.forces import accelerations_vs as jax_vs
    from gravity_tpu_torch.ops.forces import accelerations_vs

    pos, masses = _state(400, dtype, seed=5)
    got = debug_check_forces(
        torch.from_numpy(pos), torch.from_numpy(masses), eps=1e9, sample=64,
        kernel=lambda t, p, m: accelerations_vs(t, p, m, eps=1e9))
    want = jax_check(jnp.asarray(pos), jnp.asarray(masses), eps=1e9,
                     sample=64,
                     kernel=lambda t, p, m: jax_vs(t, p, m, eps=1e9))
    default = debug_check_forces(torch.from_numpy(pos),
                                 torch.from_numpy(masses), eps=1e9,
                                 sample=64)
    for key in KEYS:
        assert got[key] == pytest.approx(want[key], abs=TOL[dtype])
        assert default[key] <= TOL[dtype] * 100
