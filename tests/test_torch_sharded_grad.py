"""Gradients through the sharded engines (gravity_tpu_torch/parallel/
sharded_fmm.py and halo.py) against the JAX package, on the CPU.

``jax.grad`` goes through the JAX sharded FMM forms and the periodic halo
engine (their collectives are ``all_gather``, ``all_to_all`` and
``ppermute``, each with a transpose) and raises on the isolated halo
engine's global cube (``pmin``/``pmax``) and on the mass scale (``pmax``).
The port differentiates and refuses in the same places. The loss is
``sum((a / A)**2)`` with A = 1e-8 m/s^2, the accelerations' scale, on
numpy-seeded states in SI units:

- the sharded dense and sparse FMM on 2 and 4 gloo ranks (spawned with
  ``torch.multiprocessing``, joined by a ``FileStore`` in the test's
  temporary directory, both worlds at once while the JAX references are
  computed), position and mass gradients: against the port's unsharded
  gradient (fp64 within 1e-12 of each row's scale, fp32 within 5e-4 of the
  largest component), and against ``jax.grad`` through the JAX package's
  unsharded ``fmm_accelerations``/``sfmm_accelerations`` (fp64 1e-10
  relative to its largest component, ``tests/test_torch_backward.py``'s
  bar). The JAX sharded forms are not compiled under ``jax.grad``: one
  takes minutes on a CPU, and its gradient equals the unsharded one's;
- the periodic plain slab tiles' VJP against ``jax.vjp`` of
  ``_jnp_pair_cells_slab`` with a box, both kinds, fp32 (5e-4 of the
  largest component) and fp64 (1e-10);
- the periodic halo engine's position gradient on 2 and 4 ranks and on
  a world of one (no collective), fp64 1e-10: the ``newton`` kind against
  ``jax.grad`` through the JAX package's solo periodic
  ``nlist_accelerations`` at the same (side, cap), the ``ewald`` kind
  against ``jax.grad`` through a dense minimum-image pair sum of the JAX
  package's P3M short-range weight (``ops/p3m._short_range_w``) at the
  engine's scales. No cell overflows its cap here, so both references
  see what the engine's pair tiles give; the remainder and overflow
  channels add zero;
- the refusals side by side: JAX's ``make_halo_nlist_accel`` on a
  one-device mesh raises ``NotImplementedError`` on ``pmin``/``pmax`` at
  trace time, and the port raises ``NoBackwardError`` naming the same
  primitive on the same calls.
"""

from __future__ import annotations

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp
from jax.sharding import Mesh

from gravity_tpu.constants import CUTOFF_RADIUS, G
from gravity_tpu.ops import fmm as jax_fmm
from gravity_tpu.ops import p3m as jax_p3m
from gravity_tpu.ops import pallas_nlist as jax_nlist
from gravity_tpu.ops import sfmm as jax_sfmm
from gravity_tpu.parallel import halo as jax_halo
from gravity_tpu_torch import parallel
from gravity_tpu_torch.ops import fmm, nlist, sfmm
from gravity_tpu_torch.ops.forces import NoBackwardError
from gravity_tpu_torch.parallel.mesh import ParticleMesh

A = 1e-8
N = 256
FMM = dict(depth=2, leaf_cap=32)  # four x-slabs: worlds of 2 and 4
SFMM = dict(depth=3, leaf_cap=16, k_cells=64)  # k_eff 64 on both worlds
FMM_KW = dict(eps=1e9)
BOX = 1e12
HALO = dict(side=4, cap=64, box=BOX, eps=1e9)
RCUT = BOX / 8
EWALD_SCALES = (10.0, 0.2)
FP64_RTOL = 1e-10
FP32_RTOL = 5e-4
ROW_TOL = 1e-12
WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 240
DTYPES = {"float32": torch.float32, "float64": torch.float64}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _disk(n: int = N, seed: int = 7):
    """A thin disk of stars around a heavy centre, in metres and kg."""
    rng = np.random.default_rng(seed)
    r = rng.exponential(3e11, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    pos = np.stack([r * np.cos(phi), r * np.sin(phi),
                    rng.normal(0.0, 3e10, n)], axis=1)
    m = rng.uniform(1e23, 1e25, n)
    m[0] = 2e30
    return pos, m


def _box_cloud(n: int = N, seed: int = 8):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, BOX, (n, 3)), rng.uniform(1e23, 1e25, n)


def _loss(acc):
    return ((acc / A) ** 2).sum()


def _halo_kw(kind: str) -> dict:
    if kind == "newton":
        return dict(HALO, rcut=RCUT)
    return dict(HALO, kind="ewald", ewald_scales=EWALD_SCALES)


def _grads(fn, pos, m, *, masses=True):
    """(d pos, d m | None) of this rank's loss through ``fn(pos, m)``."""
    p = pos.clone().requires_grad_(True)
    mm = m.clone().requires_grad_(masses)
    inputs = (p, mm) if masses else (p,)
    out = torch.autograd.grad(_loss(fn(p, mm)), inputs)
    return [g.numpy() for g in out]


def _rank_main(rank: int, world: int, out_dir: str) -> None:
    with open(os.path.join(out_dir, f"rank{rank}.log"), "w") as log:
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
        rank=rank, world_size=world)
    mesh = parallel.make_particle_mesh((world,), device="cpu")
    rows = mesh.rows(N)
    out = {}
    pos, m = _disk()
    for name, dtype in DTYPES.items():
        p, mm = (torch.from_numpy(a).to(dtype) for a in (pos, m))
        dense = parallel.make_sharded_fmm_accel(mesh, **FMM, **FMM_KW)
        sparse = parallel.make_sharded_sfmm_accel(mesh, **SFMM, **FMM_KW)
        for form, fn in (("dense", dense), ("sparse", sparse)):
            d_p, d_m = _grads(fn, p[rows], mm[rows])
            out[f"{form}/{name}/pos"], out[f"{form}/{name}/m"] = d_p, d_m
        if rank == 0:
            # The port's unsharded gradient at the sharded sizing.
            sizing = dict(SFMM, k_cells=sparse.k_eff,
                          k_chunk=sparse.k_chunk_eff)
            for form, fn in (
                    ("dense", lambda a, b: fmm.fmm_accelerations(
                        a, b, **FMM, **FMM_KW)),
                    ("sparse", lambda a, b: sfmm.sfmm_accelerations(
                        a, b, **sizing, **FMM_KW))):
                d_p, d_m = _grads(fn, p, mm)
                out[f"solo/{form}/{name}/pos"] = d_p
                out[f"solo/{form}/{name}/m"] = d_m
    bpos, bm = (torch.from_numpy(a) for a in _box_cloud())
    for kind in ("newton", "ewald"):
        fn = parallel.make_halo_nlist_accel(mesh, **_halo_kw(kind))
        (out[f"halo/{kind}"],) = _grads(fn, bpos[rows], bm[rows],
                                        masses=False)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def _start(out_dir, world: int):
    return tmp.start_processes(_rank_main, args=(world, str(out_dir)),
                               nprocs=world, join=False,
                               start_method="spawn")


def _join(ctx, out_dir, world: int) -> list:
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


def _one_rank_mesh() -> ParticleMesh:
    """A world of one without a process group: the halo engine runs no
    collective on it."""
    return ParticleMesh((1,), ("shard",), 0, torch.device("cpu"), (0,),
                        (0,))


def _jax_ewald_dense(p, m):
    """The periodic P3M near field as a dense minimum-image pair sum of
    the JAX package's erfc-remainder weight, at the halo engine's scales
    (alpha = a_s / box, rcut = r_s * box) and masks."""
    a_s, r_s = EWALD_SCALES
    alpha, rc2, eps2 = a_s / BOX, (r_s * BOX) ** 2, HALO["eps"] ** 2
    diff = p[None, :, :] - p[:, None, :]
    diff = diff - BOX * jnp.round(diff / BOX)
    r2 = jnp.sum(diff * diff, axis=-1)
    valid = (r2 < rc2) & (r2 + eps2 > CUTOFF_RADIUS ** 2) & (r2 > 0)
    w = jax_p3m._short_range_w(r2, alpha, eps2, alpha ** 3, p.dtype)
    w = jnp.where(valid, G * m[None, :] * w, 0.0)
    return jnp.sum(w[..., None] * diff, axis=1)


def _jax_refs() -> dict:
    """``jax.grad`` of the loss through the JAX package's unsharded FMM
    forms, solo periodic cell list and erfc pair weight, in fp64, op by
    op (the whole gradient's XLA compile takes longer than its eager run
    here)."""
    pos, m = _disk()
    refs = {}
    for form, fn, kw in (("dense", jax_fmm.fmm_accelerations, FMM),
                         ("sparse", jax_sfmm.sfmm_accelerations, SFMM)):
        grad = jax.grad(lambda p, mm: jnp.sum(
            (fn(p, mm, **kw, **FMM_KW) / A) ** 2), argnums=(0, 1))
        refs[form] = [np.asarray(g) for g in grad(jnp.asarray(pos),
                                                   jnp.asarray(m))]
    bpos, bm = _box_cloud()
    halo = _halo_kw("newton")
    refs["halo/newton"] = np.asarray(jax.grad(lambda p: jnp.sum((
        jax_nlist.nlist_accelerations(
            p, jnp.asarray(bm), rcut=RCUT, side=halo["side"],
            cap=halo["cap"], box=BOX, eps=halo["eps"]) / A) ** 2))(
                jnp.asarray(bpos)))
    refs["halo/ewald"] = np.asarray(jax.jit(jax.grad(lambda p: jnp.sum((
        _jax_ewald_dense(p, jnp.asarray(bm)) / A) ** 2)))(
            jnp.asarray(bpos)))
    return refs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds spawned at once; the JAX references computed
    meanwhile in this process."""
    dirs = {w: tmp_path_factory.mktemp(f"grad{w}", numbered=True)
            for w in WORLDS}
    started = {w: _start(dirs[w], w) for w in WORLDS}
    jax.config.update("jax_enable_x64", True)
    try:
        refs = _jax_refs()
    finally:
        jax.config.update("jax_enable_x64", False)
    ranks = {w: _join(started[w], dirs[w], w) for w in WORLDS}
    return ranks, refs


def _stacked(results, key):
    return np.concatenate([r[key] for r in results])


def _rel(a, b) -> float:
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _row_ok(got, want, tol) -> bool:
    """Every row within ``tol`` of its own scale (its norm; a mass
    gradient's row is its one value)."""
    scale = np.linalg.norm(want.reshape(want.shape[0], -1), axis=1)
    diff = np.abs(got - want).reshape(want.shape[0], -1).max(axis=1)
    return bool(np.all(diff <= tol * scale))


@pytest.mark.parametrize("part", ["pos", "m"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("form", ["dense", "sparse"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fmm_grad_matches_unsharded(worlds, world, form, dtype,
                                            part):
    """The world's gradient, each rank its own rows, is the port's
    unsharded gradient: fp64 within 1e-12 of every row's scale (the
    cotangents of the gathered cells add over the ranks in another
    order), fp32 within 5e-4 of the largest component."""
    ranks, _ = worlds
    got = _stacked(ranks[world], f"{form}/{dtype}/{part}")
    want = ranks[world][0][f"solo/{form}/{dtype}/{part}"]
    assert np.all(np.isfinite(got)) and np.abs(want).max() > 0
    if dtype == "float64":
        assert _row_ok(got, want, ROW_TOL)
    else:
        assert _rel(got, want) <= FP32_RTOL


@pytest.mark.parametrize("part", ["pos", "m"])
@pytest.mark.parametrize("form", ["dense", "sparse"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fmm_grad_matches_jax(worlds, world, form, part):
    """fp64: within 1e-10 of the largest component of ``jax.grad``
    through the JAX package's unsharded FMM at the same sizing."""
    ranks, refs = worlds
    got = _stacked(ranks[world], f"{form}/float64/{part}")
    want = refs[form][0 if part == "pos" else 1]
    assert _rel(got, want) <= FP64_RTOL


@pytest.mark.parametrize("kind", ["newton", "ewald"])
@pytest.mark.parametrize("world", WORLDS)
def test_periodic_halo_position_grad(worlds, world, kind):
    """fp64: the world's position gradient within 1e-10 of ``jax.grad``
    through JAX's solo periodic cell list (``newton``) or its dense erfc
    pair sum (``ewald``), every rank's rows finite."""
    ranks, refs = worlds
    got = _stacked(ranks[world], f"halo/{kind}")
    want = refs[f"halo/{kind}"]
    assert np.all(np.isfinite(got)) and np.abs(want).max() > 0
    assert _rel(got, want) <= FP64_RTOL


@pytest.mark.parametrize("kind", ["newton", "ewald"])
def test_halo_world_of_one_grad_matches_jax(worlds, kind):
    """The world of one (no collective) against the same JAX reference."""
    _, refs = worlds
    bpos, bm = (torch.from_numpy(a) for a in _box_cloud())
    one = parallel.make_halo_nlist_accel(_one_rank_mesh(),
                                         **_halo_kw(kind))
    (got,) = _grads(one, bpos, bm, masses=False)
    assert np.all(np.isfinite(got))
    assert _rel(got, refs[f"halo/{kind}"]) <= FP64_RTOL


# --- the periodic slab tiles ------------------------------------------------

SX, SIDE, T_CAP, CAP = 2, 4, 5, 6
SLAB_BOX = float(SIDE)
CUTOFF, EPS = 1e-6, 0.05


def _slab_inputs(seed: int, dtype):
    """Targets in the slab's (SX, SIDE, SIDE) unit cells, sources in the
    x-extended grid's (ext plane e holds x in [e - 1, e)); counts, G m
    zero past them; a cotangent on every target slot."""
    rng = np.random.default_rng(seed)

    def grid(planes, x0):
        c = np.stack(np.meshgrid(np.arange(planes), np.arange(SIDE),
                                 np.arange(SIDE), indexing="ij"), -1)
        return c.reshape(-1, 3) + np.array([x0, 0, 0])

    tc, ec = grid(SX, 0), grid(SX + 2, -1)
    tpos = tc[:, None, :] + rng.uniform(0, 1, (len(tc), T_CAP, 3))
    t_count = rng.integers(1, T_CAP + 1, len(tc))
    tpos[np.arange(T_CAP)[None, :] >= t_count[:, None]] = 0.0
    spos = ec[:, None, :] + rng.uniform(0, 1, (len(ec), CAP, 3))
    s_count = rng.integers(0, CAP + 1, len(ec))
    gm = np.where(np.arange(CAP)[None, :] < s_count[:, None],
                  rng.uniform(0.5, 1.5, (len(ec), CAP)), 0.0)
    ct = rng.normal(size=tpos.shape)
    ct[np.arange(T_CAP)[None, :] >= t_count[:, None]] = 0.0
    return (tpos.astype(dtype), t_count, spos.astype(dtype),
            gm.astype(dtype), ct.astype(dtype))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["newton", "ewald"])
def test_periodic_slab_tiles_vjp_matches_jax(kind, dtype, x64):
    """The VJP of the plain slab tiles with a box, with respect to the
    targets, the sources and G m, against ``jax.vjp`` of JAX's
    ``_jnp_pair_cells_slab`` on the same inputs and cotangent: fp64 within
    1e-10 and fp32 within 5e-4 of each part's largest component."""
    np_dtype = np.float32 if dtype == "float32" else np.float64
    tpos, t_count, spos, gm, ct = _slab_inputs(11, np_dtype)
    params = np.array([0.81, 0.0] if kind == "newton" else [0.81, 2.0],
                      np_dtype)
    _, vjp = jax.vjp(lambda t, s, w: jax_nlist._jnp_pair_cells_slab(
        t, s, w, SX, SIDE, jnp.asarray(params), kind=kind, cutoff=CUTOFF,
        eps=EPS, use_rcut=True, box=SLAB_BOX), jnp.asarray(tpos),
        jnp.asarray(spos), jnp.asarray(gm))
    want = [np.asarray(w) for w in vjp(jnp.asarray(ct))]
    ins = [torch.from_numpy(a).requires_grad_(True)
           for a in (tpos, spos, gm)]
    out = nlist.pair_cells_slab_plain(
        ins[0], torch.from_numpy(t_count), ins[1], ins[2], SX, SIDE,
        torch.from_numpy(params), cutoff=CUTOFF, eps=EPS, kind=kind,
        box=SLAB_BOX)
    got = torch.autograd.grad(out, ins, torch.from_numpy(ct))
    tol = FP32_RTOL if dtype == "float32" else FP64_RTOL
    # The padded target slots: JAX's tiles compute them, the port's zero
    # them (``pair_cells_slab_plain``), so their cotangent is zero above.
    for g, w in zip(got, want):
        assert np.all(np.isfinite(g.numpy())) and np.abs(w).max() > 0
        assert _rel(g.numpy(), w) <= tol


# --- the refusals ------------------------------------------------------------

# (box, which input requires grad, the JAX primitive named)
REFUSALS = {
    "isolated-positions": (0.0, "pos", "pmin"),
    "isolated-masses": (0.0, "m", "pmax"),
    "periodic-masses": (BOX, "m", "pmax"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_halo_refusals_match_jax(case):
    """Where ``jax.grad`` through JAX's halo engine raises at trace time
    (a one-device mesh), the port's raises ``NoBackwardError`` naming the
    same primitive, before any collective."""
    box, wrt, prim = REFUSALS[case]
    pos, m = _box_cloud(16) if box else _disk(16)
    kw = dict(side=4, cap=8, rcut=RCUT, box=box, eps=1e9)
    jmesh = Mesh(np.array(jax.devices()[:1]), ("shard",))
    jfn = jax_halo.make_halo_nlist_accel(jmesh, **kw)
    arg = 0 if wrt == "pos" else 1
    with pytest.raises(NotImplementedError, match=prim):
        jax.grad(lambda p, mm: jnp.sum(jfn(p, mm) ** 2), argnums=arg)(
            jnp.asarray(pos, jnp.float32), jnp.asarray(m, jnp.float32))
    fn = parallel.make_halo_nlist_accel(_one_rank_mesh(), **kw)
    p = torch.from_numpy(pos).requires_grad_(wrt == "pos")
    mm = torch.from_numpy(m).requires_grad_(wrt == "m")
    with pytest.raises(NoBackwardError, match=prim):
        fn(p, mm)
    with torch.no_grad():
        assert torch.isfinite(fn(p, mm)).all()
