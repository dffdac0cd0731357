"""The kernels' backward against the JAX package, on the CPU.

The JAX package attaches one dense VJP (``wrap_with_dense_vjp``,
``gravity_tpu/ops/forces.py:196-226``) to each kernel that has no autodiff
rule; the port's counterpart is ``ops/forces.DenseVJP``. On the CPU every
kernel entry runs its plain version forward, through the same Function,
so these tests reach the port's backward itself, not PyTorch's own
differentiation of the plain forms. Inputs are numpy arrays from a seed
fed to both packages. The loss is ``sum((a / A)**2)`` with A = 1e-8 m/s^2,
the accelerations' scale, so that the fp32 mass gradients stay normal
numbers (unscaled they are ~1e-40, which XLA flushes and PyTorch keeps).

Bars (``tests/test_differentiability.py:317-350``): the gradient of
``sum(a**2)`` within 1e-10 relative in fp64 and 5e-4 in fp32 of JAX's
``jax.grad`` through the kernel's JAX entry. In the self form a body's
position gradient is its target part plus its source part, which cancel
to ~1e-5 of either here, so fp32 rounding of the parts alone gives ~1e-3
of the sum in either package: the fp32 position rows are held to 5e-4 of
the parts' scale (max |d pos_i|, |d pos_j| of the split VJP), as the
kernels' fp32 rows are held to a row's sum of |terms| (the Pallas kernel in
interpret mode, or the dense form it wraps). The Gram form's forward
differs from the JAX package's by its fp32 formulation noise (~1e-5 of
max |a| on these draws, each ~3e-5 from the exact sum), which the
gradient of sum(a**2) amplifies to up to ~3e-3 on some draws: its rows
hold the backward to JAX's VJP of the dense sum on the port's own
cotangent, at the same bars.

Entries without a backward (the ``ewald`` and untruncated pair tiles,
the batched and slab tiles, the Gram sums) are held to raising where a
gradient is asked of them on the card: meta tensors take the card's branch
of each wrapper, and the guard must fire before the launch's own checks.
The halo engine raises where JAX's does (its global cube and mass scale),
and the sharded FMM forms return a tensor in the graph.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gravity_tpu.ops import forces as jax_forces
from gravity_tpu.ops.pallas_forces import make_pallas_local_kernel
from gravity_tpu.ops.pallas_nlist import nlist_accelerations_vs as jax_nlist
from gravity_tpu_torch.ops import cells, direct_kernel, forces, mxu_kernel
from gravity_tpu_torch.ops import nlist

FP64_RTOL = 1e-10
FP32_RTOL = 5e-4
RCUT = 5e10
NLIST = dict(rcut=RCUT, side=8, cap=16)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _system(n, seed, dtype, batch=()):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3e11, 3e11, (*batch, n, 3)).astype(dtype)
    masses = rng.uniform(1e23, 1e25, (*batch, n)).astype(dtype)
    return pos, masses


A_SCALE = 1e-8


def _port_grads(kernel, pos, masses):
    """(acc, d pos, d masses) of sum((kernel(p, p, m) / A)**2) in the
    port."""
    p = torch.from_numpy(pos).requires_grad_(True)
    m = torch.from_numpy(masses).requires_grad_(True)
    acc = kernel(p, p, m)
    dp, dm = torch.autograd.grad(((acc / A_SCALE) ** 2).sum(), (p, m))
    return acc, dp.numpy(), dm.numpy()


def _jax_grads(kernel, pos, masses):
    def loss(p, m):
        a = kernel(p, p, m)
        return jnp.sum((a / A_SCALE) ** 2)

    dp, dm = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(pos),
                                                     jnp.asarray(masses))
    return np.asarray(dp), np.asarray(dm)


def _rel(a, b, scale=None):
    scale = np.max(np.abs(b)) if scale is None else scale
    return float(np.max(np.abs(a - b)) / scale)


def _parts_scale(acc, pos, masses, batched):
    """max |d pos_i|, |d pos_j| of JAX's dense VJP split into its target
    and source parts, on the port's cotangent: the scale of the terms a
    self-form position gradient sums."""
    dense = functools.partial(jax_forces.accelerations_vs, eps=1e9)
    if batched:
        dense = jax.vmap(dense)
    ct = jnp.asarray(2.0 * acc.detach().numpy() / A_SCALE**2)
    gi, gj, _ = jax.jit(lambda p, m, c: jax.vjp(dense, p, p, m)[1](c))(
        jnp.asarray(pos), jnp.asarray(masses), ct)
    return float(max(jnp.max(jnp.abs(gi)), jnp.max(jnp.abs(gj))))


def _is_dense_vjp(t):
    return type(t.grad_fn) is forces.DenseVJP._backward_cls


def _jax_batched(kernel):
    return jax.vmap(kernel)


PORT = {
    "direct": lambda: direct_kernel.make_direct_local_kernel(eps=1e9),
    "direct_batched": lambda: functools.partial(
        direct_kernel.accelerations_vs_batched_kernel, eps=1e9),
    "nlist": lambda: nlist.make_nlist_local_kernel(eps=1e9, **NLIST),
    "nlist_batched": lambda: nlist.make_nlist_batched_kernel(eps=1e9,
                                                             **NLIST),
}


def _jax_kernel(name, dtype):
    """The JAX entry of each port kernel: the Pallas kernel in interpret
    mode where the CPU runs it, else the dense form that
    ``wrap_with_dense_vjp`` wraps (JAX wraps the nlist Pallas engine with
    the rcut-masked dense VJP; on the CPU its engine is jnp)."""
    base = name.removesuffix("_batched")
    if base == "direct":
        k = (make_pallas_local_kernel(eps=1e9, interpret=True)
             if dtype == np.float32 else jax_forces.wrap_with_dense_vjp(
                 functools.partial(jax_forces.accelerations_vs, eps=1e9),
                 eps=1e9))
    else:
        k = jax_forces.wrap_with_dense_vjp(
            functools.partial(jax_nlist, impl="jnp", eps=1e9, **NLIST),
            eps=1e9, rcut=RCUT)
    return _jax_batched(k) if name.endswith("_batched") else k


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(PORT))
def test_kernel_grad_matches_jax(name, dtype, x64):
    batch = (2,) if name.endswith("_batched") else ()
    pos, masses = _system(64 if not batch else 48, seed=len(name), dtype=dtype,
                          batch=batch)
    acc, dp, dm = _port_grads(PORT[name](), pos, masses)
    assert _is_dense_vjp(acc), type(acc.grad_fn)
    jp, jm = _jax_grads(_jax_kernel(name, dtype), pos, masses)
    fp32 = dtype == np.float32
    rtol = FP32_RTOL if fp32 else FP64_RTOL
    scale = _parts_scale(acc, pos, masses, bool(batch)) if fp32 else None
    assert _rel(dp, jp, scale) <= rtol, (name, _rel(dp, jp, scale))
    assert _rel(dm, jm) <= rtol, (name, _rel(dm, jm))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("batched", [False, True])
def test_mxu_backward_is_jax_vjp(batched, dtype, x64):
    """Through the Gram form (``make_pallas_mxu_local_kernel``'s dense
    VJP): the port's backward on its own cotangent 2a / A^2 equals JAX's
    VJP of the dense sum on that cotangent."""
    batch = (2,) if batched else ()
    pos, masses = _system(48, seed=5, dtype=dtype, batch=batch)
    kern = (functools.partial(mxu_kernel.accelerations_vs_mxu_batched_kernel,
                              eps=1e9) if batched
            else mxu_kernel.make_mxu_local_kernel(eps=1e9))
    acc, dp, dm = _port_grads(kern, pos, masses)
    assert _is_dense_vjp(acc)
    ct = 2.0 * acc.detach().numpy() / A_SCALE**2
    dense = functools.partial(jax_forces.accelerations_vs, eps=1e9)
    if batched:
        dense = jax.vmap(dense)
    gp, gm = (np.asarray(x) for x in jax.jit(
        lambda p, m, c: jax.vjp(lambda q, w: dense(q, q, w), p, m)[1](c))(
            jnp.asarray(pos), jnp.asarray(masses), jnp.asarray(ct)))
    fp32 = dtype == np.float32
    rtol = FP32_RTOL if fp32 else FP64_RTOL
    scale = _parts_scale(acc, pos, masses, batched) if fp32 else None
    assert _rel(dp, gp, scale) <= rtol, _rel(dp, gp, scale)
    assert _rel(dm, gm) <= rtol, _rel(dm, gm)


def test_rectangular_kernel_grads_each_input(x64):
    """Targets apart from sources (a multirate kick, a rank's block):
    each input's gradient against JAX's through the Pallas entry."""
    pos, masses = _system(40, seed=9, dtype=np.float64)
    tgt = pos[:12] + 1e9
    p_t, p_s, m_s = (torch.from_numpy(a).requires_grad_(True)
                     for a in (tgt, pos, masses))
    acc = direct_kernel.accelerations_vs_kernel(p_t, p_s, m_s, eps=1e9)
    got = torch.autograd.grad((acc * acc).sum(), (p_t, p_s, m_s))
    kern = jax_forces.wrap_with_dense_vjp(
        functools.partial(jax_forces.accelerations_vs, eps=1e9), eps=1e9)
    want = jax.jit(jax.grad(lambda t, s, m: jnp.sum(kern(t, s, m) ** 2),
                            argnums=(0, 1, 2)))(
        *map(jnp.asarray, (tgt, pos, masses)))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) <= FP64_RTOL


def test_row_blocks_are_the_same_math(monkeypatch):
    """The backward in row blocks of targets (forces.backward_rows) gives
    the one-block gradient to rounding, batched and solo."""
    pos, masses = _system(48, seed=3, dtype=np.float64, batch=(2,))
    kern = PORT["direct_batched"]()
    _, dp1, dm1 = _port_grads(kern, pos, masses)
    monkeypatch.setattr(forces, "BACKWARD_PAIRS", 2 * 48 * 5)
    assert forces.backward_rows(48, 48, 2) == 5
    _, dp2, dm2 = _port_grads(kern, pos, masses)
    assert _rel(dp2, dp1) <= 1e-13 and _rel(dm2, dm1) <= 1e-13


def test_no_grad_and_second_derivative():
    pos, masses = _system(16, seed=1, dtype=np.float64)
    p = torch.from_numpy(pos).requires_grad_(True)
    m = torch.from_numpy(masses)
    with torch.no_grad():
        assert direct_kernel.accelerations_vs_kernel(p, p, m).grad_fn is None
    acc = direct_kernel.accelerations_vs_kernel(p, p, m)
    (dp,) = torch.autograd.grad((acc * acc).sum(), p, create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        dp.sum().backward()


def test_segment_sum_rows_backward_is_the_plain_gradient():
    """segment_sum.cu's exact backward (a gather of each row's segment
    cotangent, zero on the padding rows) against PyTorch's gradient
    through the plain version on the same inputs."""
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(np.sort(rng.integers(0, 9, 37)))
    seg = cells.Segments(ids, 9)
    values = torch.from_numpy(rng.normal(size=(37, 3))).to(torch.bfloat16)
    rows = seg.gather(values).detach()
    starts = seg.plan()[1]
    ct = torch.from_numpy(rng.normal(size=(9, 3))).to(torch.bfloat16)
    r1 = rows.clone().requires_grad_(True)
    out = cells.segment_sum_rows(r1, starts, 37)
    assert type(out.grad_fn) is cells.SegmentSumRows._backward_cls
    (got,) = torch.autograd.grad(out, r1, ct)
    r2 = rows.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        cells.segment_sum_rows_plain(r2, starts, 37), r2, ct)
    assert torch.equal(got, want)
    assert torch.equal(out.detach(), cells.segment_sum_rows_plain(
        rows, starts, 37))


def _meta(*shape, dtype=torch.float32, grad=False):
    t = torch.empty(shape, dtype=dtype, device="meta")
    return t.requires_grad_(grad) if dtype.is_floating_point else t


def _tile_args(grad, batch=()):
    side, t_cap, cap = 2, 4, 4
    c = side**3
    return (_meta(*batch, c, t_cap, 3, grad=grad),
            _meta(*batch, c, dtype=torch.int64),
            _meta(*batch, c, cap, 3, grad=grad),
            _meta(*batch, c, cap, grad=grad),
            _meta(*batch, c, dtype=torch.int64), side,
            _meta(2, grad=False))


def _slab_args(grad):
    side, sx = 2, 1
    return (_meta(sx * side * side, 4, 3, grad=grad),
            _meta(sx * side * side, dtype=torch.int64),
            _meta((sx + 2) * side * side, 4, 3, grad=grad),
            _meta((sx + 2) * side * side, 4, grad=grad),
            _meta((sx + 2) * side * side, dtype=torch.int64), sx, side,
            _meta(2))


KW = dict(cutoff=0.0, eps=1e9)
GUARDED = {
    "nlist_pair/ewald": lambda grad: nlist.pair_cells_kernel(
        *_tile_args(grad), kind="ewald", **KW),
    "nlist_pair/near": lambda grad: nlist.pair_cells_kernel(
        *_tile_args(grad), use_rcut=False, **KW),
    "nlist_pair/newton": lambda grad: nlist.pair_cells_kernel(
        *_tile_args(grad), **KW),
    "nlist_pair/batched": lambda grad: nlist.pair_cells_kernel_batched(
        *_tile_args(grad, (2,)), **KW),
    "nlist_pair/newton/slab": lambda grad: nlist.pair_cells_slab_kernel(
        *_slab_args(grad), **KW),
    "nlist_pair/ewald/slab": lambda grad: nlist.pair_cells_slab_kernel(
        *_slab_args(grad), kind="ewald", **KW),
    "nbody_mxu (gram_acc4)": lambda grad: mxu_kernel.gram_acc4(
        _meta(8, 3, grad=grad), _meta(8, 3), _meta(8), **KW),
    "nbody_mxu/batched": lambda grad: mxu_kernel.gram_acc4_batched(
        _meta(2, 8, 3, grad=grad), _meta(2, 8, 3), _meta(2, 8), **KW),
}


@pytest.mark.parametrize("name", sorted(GUARDED))
def test_card_entries_without_backward_raise(name):
    """On the card (meta tensors take that branch) each entry with no
    backward raises NoBackwardError naming its kernel when an input
    requires grad, before the launch's own checks; without one, or under
    no_grad, it goes on to them (here: the CUDA-tensor check)."""
    with pytest.raises(forces.NoBackwardError, match=name.split(" ")[0]):
        GUARDED[name](True)
    with pytest.raises(ValueError, match="CUDA"):
        GUARDED[name](False)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        GUARDED[name](True)


def _mesh():
    from gravity_tpu_torch.parallel.mesh import ParticleMesh

    return ParticleMesh((1,), ("shard",), 0, torch.device("cpu"), (0,),
                        (0,))


@pytest.mark.parametrize(
    "engine", ["halo", "halo_masses", "sharded_fmm", "sharded_sfmm"])
def test_forward_only_sharded_engines_raise(engine):
    """Where ``jax.grad`` through the JAX form raises, so does the port,
    before any collective: the isolated halo engine's positions (the
    global cube's ``pmin``) and the masses through a periodic one (the
    mass scale's ``pmax``). The sharded FMM forms, whose JAX gathers
    transpose, return a tensor in the graph on a world of one."""
    from gravity_tpu_torch.parallel import halo, make_particle_mesh
    from gravity_tpu_torch.parallel import sharded_fmm

    pos, masses = _system(16, seed=2, dtype=np.float64)
    p = torch.from_numpy(pos).requires_grad_(True)
    m = torch.from_numpy(masses)
    if engine.startswith("halo"):
        box = 0.0 if engine == "halo" else 1e13
        accel = halo.make_halo_nlist_accel(_mesh(), side=4, cap=8,
                                           rcut=RCUT, box=box)
        if engine == "halo_masses":
            p, m = p.detach(), m.requires_grad_(True)
        with pytest.raises(forces.NoBackwardError,
                           match="pmin" if engine == "halo" else "pmax"):
            accel(p, m)
        return
    created = not dist.is_initialized()
    mesh = make_particle_mesh(device="cpu")
    try:
        make = (sharded_fmm.make_sharded_fmm_accel if engine == "sharded_fmm"
                else sharded_fmm.make_sharded_sfmm_accel)
        acc = make(mesh, depth=2)(p, m)
        assert acc.grad_fn is not None and acc.shape == p.shape
        (d_p,) = torch.autograd.grad((acc * acc).sum(), p)
        assert torch.isfinite(d_p).all()
    finally:
        if created:
            dist.destroy_process_group()


def test_periodic_nlist_is_plain_differentiable():
    """A box's cell list is plain PyTorch on every device: no Function,
    PyTorch's own gradient."""
    kern = nlist.make_nlist_local_kernel(rcut=2e11, side=3, cap=32,
                                         box=1e12, eps=1e9)
    pos, masses = _system(24, seed=6, dtype=np.float64)
    p = torch.from_numpy(np.mod(pos, 1e12)).requires_grad_(True)
    acc = kern(p, p, torch.from_numpy(masses))
    assert acc.grad_fn is not None and not _is_dense_vjp(acc)
