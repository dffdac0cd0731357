"""Differentiability of the port, on the CPU: the counterpart of each tier-1
row of ``tests/test_differentiability.py``.

Gradients flow through the forces, the integrators, the block-timestep
schemes, the octree and the sharded strategies. Each row holds the port's
gradient to a central finite difference at the JAX suite's bar and to
the JAX package's ``jax.grad`` on the same numpy inputs within 1e-9
relative (fp64). The rollout and kick rows also run through the kernel
entry (``pallas``: on the CPU its plain version forward inside
``ops/forces.DenseVJP``, the kernel's own backward), beside the plain
sums that PyTorch differentiates by itself.

The sharded rows run the port on 2 gloo ranks, spawned with
``torch.multiprocessing`` and joined by a ``FileStore`` in the test's
temporary directory: each rank's loss is its rows' sum, the loss of the
sharded program the ranks' sum (a global sum over the sharded state, as
the JAX test's is), and the gradient crosses ranks through the
collectives' backward (``parallel.mesh.AllGatherRows``,
``parallel.sharded.RingShift``). The JAX side runs its sharded forms on a
2-device mesh of the suite's virtual CPU devices. The FMM, PM and P3M
rows of the JAX suite are slow-marked there and not ported here.
"""

from __future__ import annotations

import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from gravity_tpu.ops import forces as jax_forces
from gravity_tpu.ops.integrators import make_step_fn as jax_step_fn
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch import parallel
from gravity_tpu_torch.ops import direct_kernel, forces
from gravity_tpu_torch.ops.integrators import make_step_fn
from gravity_tpu_torch.state import ParticleState

JAX_RTOL = 1e-9
SPAWN_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _random_system(n, seed=0):
    """The JAX suite's draw (``_random_system``) as numpy, fp64."""
    with jax.enable_x64(True):
        kp, km = jax.random.split(jax.random.PRNGKey(seed))
        pos = jax.random.uniform(kp, (n, 3), jnp.float64, minval=-3e11,
                                 maxval=3e11)
        masses = jax.random.uniform(km, (n,), jnp.float64, minval=1e23,
                                    maxval=1e25)
        return np.asarray(pos), np.asarray(masses)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _rollout(step, accel, state, length):
    a = accel(state.positions)
    for _ in range(length):
        state, a = step(state, a)
    return state


def _jax_rollout(step, accel, state, length):
    def body(carry, _):
        return step(*carry), None

    (final, _), _ = jax.lax.scan(body, (state, accel(state.positions)),
                                 None, length=length)
    return final


# The port's direct sums: the plain forms and the kernel entry.
KERNELS = {
    "dense": lambda **kw: functools.partial(forces.accelerations_vs, **kw),
    "chunked": lambda **kw: functools.partial(
        forces.accelerations_vs_chunked, chunk=4, **kw),
    "pallas": lambda **kw: direct_kernel.make_direct_local_kernel(**kw),
}


def test_grad_potential_is_minus_force(x64):
    """dU/dx_i = -m_i a_i, by autodiff; and the JAX package's dU/dx."""
    pos, masses = _random_system(24)
    p = _t(pos, grad=True)
    (grad_u,) = torch.autograd.grad(
        forces.potential_energy(p, _t(masses)), p)
    acc = forces.pairwise_accelerations_dense(_t(pos), _t(masses))
    np.testing.assert_allclose(grad_u.numpy(),
                               (-_t(masses)[:, None] * acc).numpy(),
                               rtol=1e-9)
    want = jax.grad(lambda q: jax_forces.potential_energy(
        q, jnp.asarray(masses)))(jnp.asarray(pos))
    assert _rel(grad_u.numpy(), want) <= JAX_RTOL


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_rollout_grad_matches_finite_difference(kernel, x64):
    """d(loss)/d(speed scale) through a 20-step leapfrog rollout against
    central differences (5e-4) and the JAX package's gradient."""
    pos, masses = _random_system(8)
    vel = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (8, 3),
                                       jnp.float64)) * 1e3
    accel_k = KERNELS[kernel]()

    def loss(scale):
        m = _t(masses)
        accel = lambda p: accel_k(p, p, m)  # noqa: E731
        step = make_step_fn("leapfrog", accel, 3600.0)
        st = _rollout(step, accel, ParticleState(_t(pos), _t(vel) * scale,
                                                 m), 20)
        return ((st.positions / 1e11) ** 2).sum()

    s = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(s), s)
    h = 1e-6
    with torch.no_grad():
        fd = (loss(1.0 + h) - loss(1.0 - h)) / (2 * h)
    np.testing.assert_allclose(float(g), float(fd), rtol=5e-4)

    jm = jnp.asarray(masses)
    jaccel = lambda p: jax_forces.accelerations_vs(p, p, jm)  # noqa: E731
    jstep = jax_step_fn("leapfrog", jaccel, 3600.0)

    def jloss(scale):
        st = _jax_rollout(jstep, jaccel, JaxState(
            jnp.asarray(pos), jnp.asarray(vel) * scale, jm), 20)
        return jnp.sum((st.positions / 1e11) ** 2)

    assert _rel(float(g), float(jax.grad(jloss)(1.0))) <= JAX_RTOL


def test_velocity_fit_converges(x64):
    """Gradient descent on an initial velocity so that a test particle
    reaches a target after a fixed flight time (the transfer-orbit fit):
    the miss falls below 1e-4 of the first; the first gradient is the
    JAX package's."""
    m_sun, r0 = 1.989e30, 1.496e11
    masses = np.array([m_sun, 1.0])
    pos = np.array([[0.0, 0.0, 0.0], [r0, 0.0, 0.0]])
    target = np.array([0.0, 1.3 * r0, 0.0])
    steps, dt = 40, 100_000.0
    kern = direct_kernel.make_direct_local_kernel()

    def miss(v0):
        m = _t(masses)
        accel = lambda p: kern(p, p, m)  # noqa: E731
        step = make_step_fn("leapfrog", accel, dt)
        vel = torch.stack([torch.zeros(3, dtype=torch.float64), v0])
        st = _rollout(step, accel, ParticleState(_t(pos), vel, m), steps)
        return (((st.positions[1] - _t(target)) / r0) ** 2).sum()

    def value_and_grad(v):
        v = v.detach().requires_grad_(True)
        val = miss(v)
        (g,) = torch.autograd.grad(val, v)
        return float(val.detach()), g

    v = torch.tensor([0.0, 2.98e4, 0.0], dtype=torch.float64)
    miss0, g0 = value_and_grad(v)
    jm = jnp.asarray(masses)
    jaccel = lambda p: jax_forces.accelerations_vs(p, p, jm)  # noqa: E731
    jstep = jax_step_fn("leapfrog", jaccel, dt)

    def jmiss(v0):
        st = JaxState(jnp.asarray(pos),
                      jnp.stack([jnp.zeros(3, jnp.float64), v0]), jm)
        st = _jax_rollout(jstep, jaccel, st, steps)
        return jnp.sum(((st.positions[1] - jnp.asarray(target)) / r0) ** 2)

    assert _rel(g0.numpy(), jax.grad(jmiss)(jnp.asarray(v.numpy()))) \
        <= JAX_RTOL
    lr = 5e8
    for _ in range(200):
        val, g = value_and_grad(v)
        if val < miss0 * 1e-4:
            break
        v = v - lr * g
    assert val < miss0 * 1e-4, (miss0, val)


@pytest.mark.parametrize("kernel", ["dense", "pallas"])
@pytest.mark.parametrize("scheme", ["two_rung", "ladder_r3"])
def test_grad_through_block_timestep_schemes(scheme, kernel, x64):
    """Gradients through the two-rung and rung-ladder steps (top-k
    selection, scatters, rectangular kicks) against a central difference
    (1e-5) and the JAX package's."""
    from gravity_tpu_torch.ops import multirate

    n = 12
    pos = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (n, 3),
                                        jnp.float64, minval=-1e10,
                                        maxval=1e10))
    masses = np.full((n,), 1e25)
    accel_vs = KERNELS[kernel]()
    acc0 = forces.accelerations_vs(_t(pos), _t(pos), _t(masses))
    kw = (dict(k=4, n_sub=2) if scheme == "two_rung"
          else dict(capacities=(4, 2)))
    fn = multirate.two_rung_step if scheme == "two_rung" \
        else multirate.rung_ladder_step

    def loss(v0):
        st, _ = fn(ParticleState(_t(pos), v0, _t(masses)), acc0, 1e3,
                   accel_vs=accel_vs, **kw)
        return (st.positions ** 2).sum() / 1e20

    v0 = torch.zeros((n, 3), dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(v0), v0)
    assert bool(torch.isfinite(g).all())
    e = torch.zeros((n, 3), dtype=torch.float64)
    e[3, 1] = 1.0
    with torch.no_grad():
        fd = (loss(1e-3 * e) - loss(-1e-3 * e)) / 2e-3
    np.testing.assert_allclose(float(g[3, 1]), float(fd), rtol=1e-5)

    assert _rel(g.numpy(), _jax_scheme_grad(scheme, pos, masses)) \
        <= JAX_RTOL


_JAX_SCHEME_GRADS: dict = {}


def _jax_scheme_grad(scheme, pos, masses):
    """The JAX package's gradient of the block-scheme loss (jitted, once a
    scheme for both kernel rows)."""
    if scheme not in _JAX_SCHEME_GRADS:
        from gravity_tpu.ops import multirate as jax_mr

        jm, jp = jnp.asarray(masses), jnp.asarray(pos)
        jvs = jax_forces.accelerations_vs
        jfn, kw = ((jax_mr.two_rung_step, dict(k=4, n_sub=2))
                   if scheme == "two_rung"
                   else (jax_mr.rung_ladder_step, dict(capacities=(4, 2))))

        def jloss(v):
            st, _ = jfn(JaxState(jp, v, jm), jvs(jp, jp, jm), 1e3,
                        accel_vs=jvs, **kw)
            return jnp.sum(st.positions ** 2) / 1e20

        _JAX_SCHEME_GRADS[scheme] = np.asarray(jax.jit(jax.grad(jloss))(
            jnp.zeros(pos.shape, jnp.float64)))
    return _JAX_SCHEME_GRADS[scheme]


def test_tree_grad_matches_finite_difference(x64):
    """Through the octree (sort, segment sums, capped exact near field,
    multipole far field): a central difference (1e-5) and the JAX
    package's gradient, on the JAX suite's 256-body disk."""
    from gravity_tpu.models import create_disk
    from gravity_tpu.ops.tree import tree_accelerations as jax_tree
    from gravity_tpu_torch.ops.tree import tree_accelerations

    state = create_disk(jax.random.PRNGKey(0), 256, dtype=jnp.float64)
    pos, masses = np.asarray(state.positions), np.asarray(state.masses)
    kw = dict(depth=3, g=1.0, eps=0.05, leaf_cap=32)

    def loss(scale):
        a = tree_accelerations(_t(pos) * scale, _t(masses), **kw)
        return (a * a).sum()

    s = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(s), s)
    h = 1e-6
    with torch.no_grad():
        fd = (loss(1.0 + h) - loss(1.0 - h)) / (2 * h)
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-5)
    want = jax.jit(jax.grad(lambda sc: jnp.sum(jax_tree(
        jnp.asarray(pos) * sc, jnp.asarray(masses), **kw) ** 2)))(1.0)
    assert _rel(float(g), float(want)) <= JAX_RTOL


# --- sharded, on 2 gloo ranks ---------------------------------------------

SHARDED_N, SHARDED_STEPS, SHARDED_H = 64, 5, 1e-4
# (strategy, local kernel): the JAX test's two, and the ring through the
# kernel entry (DenseVJP inside each hop).
SHARDED_CASES = {
    "allgather": ("allgather", "dense"),
    "ring": ("ring", "dense"),
    "ring-pallas": ("ring", "pallas"),
}


def _sharded_loss(accel2, pos_l, m_l, scale):
    """This rank's part of the loss: its rows' sum of |x|^2 after a
    5-step leapfrog rollout from rest plus scale * 1e3 m/s."""
    accel = lambda p: accel2(p, m_l)  # noqa: E731
    step = make_step_fn("leapfrog", accel, 3600.0)
    st = ParticleState(pos_l, torch.zeros_like(pos_l) + scale * 1e3, m_l)
    return (_rollout(step, accel, st, SHARDED_STEPS).positions ** 2).sum()


def _sharded_rank(rank: int, world: int, out_dir: str) -> None:
    """One rank: each case's gradient of its loss part and the parts at
    scale 1 +- h, summed over the world (one all_reduce a case)."""
    with open(os.path.join(out_dir, f"rank{rank}.log"), "w") as log:
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
        rank=rank, world_size=world)
    mesh = parallel.make_particle_mesh(device="cpu")
    data = np.load(os.path.join(out_dir, "inputs.npz"))
    rows = mesh.rows(SHARDED_N)
    pos_l = torch.from_numpy(data["pos"][rows])
    m_l = torch.from_numpy(data["masses"][rows])
    out = {}
    for name, (strategy, kernel) in SHARDED_CASES.items():
        accel2 = parallel.make_sharded_accel2(
            mesh, strategy=strategy, local_kernel=KERNELS[kernel]())
        s = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
        (g,) = torch.autograd.grad(_sharded_loss(accel2, pos_l, m_l, s), s)
        with torch.no_grad():
            parts = torch.stack([g, *(
                _sharded_loss(accel2, pos_l, m_l, 1.0 + d * SHARDED_H)
                for d in (1, -1))])
        dist.all_reduce(parts)
        out[name] = parts.numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def _spawn(out_dir, world: int) -> list:
    ctx = tmp.start_processes(_sharded_rank, args=(world, str(out_dir)),
                              nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                logs = "\n".join(
                    (out_dir / f"rank{r}.log").read_text()[-2000:]
                    for r in range(world)
                    if (out_dir / f"rank{r}.log").exists())
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{SPAWN_TIMEOUT_S} s:\n{logs}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in ctx.processes)
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def sharded_ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("grad_world2", numbered=False)
    pos, masses = _random_system(SHARDED_N)
    np.savez(out_dir / "inputs.npz", pos=pos, masses=masses)
    return _spawn(out_dir, 2), pos, masses


@pytest.mark.parametrize("case", sorted(SHARDED_CASES))
def test_sharded_rollout_grad_matches_finite_difference(sharded_ranks, case,
                                                        x64):
    """Through the all-gather and the ring's hops on 2 gloo ranks: the
    world's gradient against a central difference of the world's loss
    (1e-5) and the JAX package's sharded gradient on a 2-device mesh;
    every rank holds the same totals."""
    from jax.sharding import Mesh

    from gravity_tpu.parallel.sharded import make_sharded_accel2

    ranks, pos, masses = sharded_ranks
    g, lp, lm = ranks[0][case]
    assert np.array_equal(ranks[1][case], ranks[0][case])
    fd = (lp - lm) / (2 * SHARDED_H)
    assert np.isfinite(g)
    np.testing.assert_allclose(g, fd, rtol=1e-5)

    strategy = SHARDED_CASES[case][0]
    mesh = Mesh(np.array(jax.devices()[:2]), ("shard",))
    accel2 = make_sharded_accel2(mesh, strategy=strategy)
    jm = jnp.asarray(masses)
    accel = lambda p: accel2(p, jm)  # noqa: E731
    step = jax_step_fn("leapfrog", accel, 3600.0)

    def jloss(scale):
        st = JaxState(jnp.asarray(pos), jnp.zeros_like(jnp.asarray(pos))
                      + scale * 1e3, jm)
        return jnp.sum(_jax_rollout(step, accel, st,
                                    SHARDED_STEPS).positions ** 2)

    assert _rel(g, float(jax.jit(jax.grad(jloss))(1.0))) <= JAX_RTOL
