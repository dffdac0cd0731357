"""The CUDA kernel on the card: held against its plain version.

Needs a CUDA device and nvcc; skips without a card. On a machine with
one (which need not have JAX; tests/conftest.py imports it):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

Tolerances are on each row's acceleration vector: fp32 rtol 2e-5, fp64
rtol 1e-12 — the kernel and the plain version sum the same terms in a
different order (chip_smoke.py states the per-term bound).
"""

import numpy as np
import pytest
import torch

from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.ops import direct_kernel
from gravity_tpu_torch.ops.forces import accelerations_vs
from gravity_tpu_torch.simulation import Simulator

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
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
    with pytest.raises(TypeError, match="float32 or float64"):
        direct_kernel.accelerations_vs_kernel(pos.half(), pos.half(),
                                              masses.half())
    with pytest.raises(ValueError, match="is on cpu"):
        direct_kernel.accelerations_vs_kernel(pos, pos.cpu(), masses.cpu())


def test_simulator_runs_through_the_kernel(cuda):
    cfg = SimulationConfig(n=300, steps=10, progress_every=5)
    sim = Simulator(cfg)
    before = direct_kernel.LAUNCHES
    stats = sim.run()
    assert sim.backend == "nbody_direct"
    assert direct_kernel.LAUNCHES - before == stats["kernel_launches"] == 11
    assert bool(torch.isfinite(stats["final_state"].positions).all())
