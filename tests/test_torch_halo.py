"""The halo slab engine (gravity_tpu_torch/parallel/halo.py and the slab
engines of ops/nlist.py) against the JAX package, on the CPU.

- The three slab engines against JAX's ``_jnp_pair_cells_slab``,
  ``_remainder_cells_slab`` and ``_overflow_targets_slab`` on the same
  numpy inputs, both pair kinds, isolated and periodic.
- ``resolve_halo_sizing``, ``resolve_mig_cap`` and ``halo_comm_model``
  equal to JAX's.
- The halo engine on 2, 4 and 8 gloo ranks (spawned with
  ``torch.multiprocessing``, joined by a ``FileStore`` in the test's
  temporary directory, one spawn a world size, each with its own timeout)
  against JAX's solo ``nlist_accelerations`` at the same (side, cap):
  isolated and periodic, the periodic seam pair, a starved cap of 4, odd
  N; an 8-step hot-cloud Simulator run on 4 ranks against JAX's solo run;
  P3M with the halo near field on 4 ranks against JAX's unsharded P3M; the
  mesh contest of ``auto`` on 4 ranks.
- The witness of P3M's halo near field where cells pass their caps: a
  clustered disk on 2 and 4 ranks in fp64, the halo engine's ewald near
  field against the solo near field at the halo's side and the sharded
  mesh pass against the solo mesh pass, each apart.

JAX's own halo (a shard_map over a virtual mesh) is not run: one compile
takes over a minute on a CPU, and the JAX suite marks its halo tests
slow for it (``tests/test_nlist_halo.py:14-19``).

Bars:

- slab engines: fp32 ``rtol=2e-5, atol=1e-12`` (the pair tiles' atol
  widened to 2e-5 of the row's sum of |terms|: an ewald row whose newton
  and erf terms nearly cancel rounds at ulps of its terms, not of itself);
  fp64 the pair tiles within 1e-12 of each row's sum of |terms|; the
  monopole channels within 2e-5 (fp32) or 1e-12 (fp64) of |a| plus the
  largest |a| (a row of a few cancelling terms);
- the halo engine: max |diff| / mean |a| <= 1e-5, the JAX package's own
  contract for its halo form (``tests/test_nlist_halo.py:62-81``), runs
  within 1e-5 of |row|; P3M in fp64 1e-12 (``test_torch_p3m.py``'s bar
  for the unsharded solver; the halo form adds no arithmetic but alpha
  and rcut rounded from the global cube); the split witness: the near
  field within 1e-12 of each row's sum gm (|newt| + |corr|) |d| over the
  pairs within rcut (rounding), the mesh pass the solo one's bits.
"""

from __future__ import annotations

import math
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from gravity_tpu import autotune as jax_autotune
from gravity_tpu import simulation as jax_sim
from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.ops import pallas_nlist as jax_nlist
from gravity_tpu.ops.p3m import p3m_accelerations as jax_p3m
from gravity_tpu.parallel import halo as jax_halo
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch import autotune, parallel, simulation
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.ops import nlist, p3m, pm
from gravity_tpu_torch.state import ParticleState


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


FP32 = dict(rtol=2e-5, atol=1e-12)
F64_TERMS = 1e-12
HALO_TOL = 1e-5
RUN_TOL = 1e-5
P3M_TOL = 1e-12
SPAWN_TIMEOUT_S = 240
G1 = dict(g=1.0, eps=0.5, cutoff=0.0)
DT = {"float32": np.float32, "float64": np.float64}


# --- the slab engines ------------------------------------------------------

SX, SIDE, T_CAP, CAP = 2, 4, 5, 6
CUTOFF, EPS = 1e-6, 0.05


def _slab_inputs(seed: int, dtype):
    """Targets in the slab's (SX, SIDE, SIDE) cells and sources in the
    x-extended grid's (ext plane e holds x in [e - 1, e)), unit cells;
    counts, G m zero past them, and the monopole channels."""
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
    over = rng.uniform(size=len(ec)) < 0.5
    rem_w = np.where(over, rng.uniform(0.5, 2.0, len(ec)), 0.0)
    com = ec + rng.uniform(0, 1, (len(ec), 3))
    m = 40
    t_coords = np.stack([rng.integers(0, SX, m), rng.integers(0, SIDE, m),
                         rng.integers(0, SIDE, m)], -1)
    t_pos = t_coords + rng.uniform(0, 1, (m, 3))
    cell_w = rng.uniform(0.5, 2.0, len(ec))
    cast = {k: v.astype(dtype) for k, v in dict(
        tpos=tpos, spos=spos, gm=gm, rem_w=rem_w, com=com, t_pos=t_pos,
        cell_w=cell_w).items()}
    return dict(cast, t_count=t_count, s_count=s_count, over=over,
                t_coords=t_coords)


def _params(kind: str, dtype):
    return np.array([0.81, 0.0] if kind == "newton" else [0.81, 2.0], dtype)


def _real(inp):
    return np.arange(T_CAP)[None, :] < inp["t_count"][:, None]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("box", [0.0, float(SIDE)])
@pytest.mark.parametrize("kind", ["newton", "ewald"])
def test_pair_cells_slab_matches_jax(kind, box, dtype, x64):
    inp = _slab_inputs(1, DT[dtype])
    params = _params(kind, DT[dtype])
    want = np.asarray(jax_nlist._jnp_pair_cells_slab(
        jnp.asarray(inp["tpos"]), jnp.asarray(inp["spos"]),
        jnp.asarray(inp["gm"]), SX, SIDE, jnp.asarray(params), kind=kind,
        cutoff=CUTOFF, eps=EPS, use_rcut=True, box=box))
    args = (torch.from_numpy(inp["tpos"]), torch.from_numpy(inp["t_count"]),
            torch.from_numpy(inp["spos"]), torch.from_numpy(inp["gm"]), SX,
            SIDE, torch.from_numpy(params))
    kw = dict(cutoff=CUTOFF, eps=EPS, kind=kind, box=box)
    got = nlist.pair_cells_slab_plain(*args, **kw).numpy()
    real = _real(inp)
    assert np.all(got[~real] == 0)
    if box == 0.0:
        # The wrapper takes the plain engine for CPU tensors.
        kern = nlist.pair_cells_slab_kernel(
            *args[:4], torch.from_numpy(inp["s_count"]), *args[4:],
            cutoff=CUTOFF, eps=EPS, kind=kind).numpy()
        np.testing.assert_array_equal(kern, got)
    scale = nlist.pair_cells_slab_plain(*args, absolute=True, **kw).numpy()
    diff = np.abs(got - want)[real]
    if dtype == "float32":
        assert np.all(diff <= FP32["rtol"] * (np.abs(want[real])
                                              + scale[real])
                      + FP32["atol"])
    else:
        assert np.all(diff <= F64_TERMS * scale[real] + 1e-300)


def _monopole_bar(got, want, dtype):
    tol = FP32["rtol"] if dtype == "float32" else F64_TERMS
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("box", [0.0, float(SIDE)])
@pytest.mark.parametrize("kind", ["newton", "ewald"])
def test_remainder_cells_slab_matches_jax(kind, box, dtype, x64):
    inp = _slab_inputs(2, DT[dtype])
    params = _params(kind, DT[dtype])
    want = np.asarray(jax_nlist._remainder_cells_slab(
        jnp.asarray(inp["tpos"]), jnp.asarray(inp["rem_w"]),
        jnp.asarray(inp["com"]), jnp.asarray(inp["over"]), SX, SIDE,
        jnp.asarray(params), kind=kind, eps=EPS,
        cell_h=jnp.asarray(1.0, DT[dtype]), box=box))
    got = nlist._remainder_cells_slab(
        torch.from_numpy(inp["tpos"]), torch.from_numpy(inp["rem_w"]),
        torch.from_numpy(inp["com"]), torch.from_numpy(inp["over"]), SX,
        SIDE, torch.from_numpy(params), kind=kind, eps=EPS,
        cell_h=torch.tensor(1.0, dtype=getattr(torch, dtype)),
        box=box).numpy()
    assert np.abs(want).max() > 0
    _monopole_bar(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("box", [0.0, float(SIDE)])
@pytest.mark.parametrize("kind", ["newton", "ewald"])
def test_overflow_targets_slab_matches_jax(kind, box, dtype, x64):
    inp = _slab_inputs(3, DT[dtype])
    params = _params(kind, DT[dtype])
    want = np.asarray(jax_nlist._overflow_targets_slab(
        jnp.asarray(inp["t_pos"]), jnp.asarray(inp["t_coords"]),
        jnp.asarray(inp["cell_w"]), jnp.asarray(inp["com"]), SX, SIDE,
        jnp.asarray(params), kind=kind, eps=EPS,
        cell_h=jnp.asarray(1.0, DT[dtype]), box=box))
    got = nlist._overflow_targets_slab(
        torch.from_numpy(inp["t_pos"]), torch.from_numpy(inp["t_coords"]),
        torch.from_numpy(inp["cell_w"]), torch.from_numpy(inp["com"]), SIDE,
        torch.from_numpy(params), kind=kind, eps=EPS,
        cell_h=torch.tensor(1.0, dtype=getattr(torch, dtype)),
        box=box).numpy()
    assert np.abs(want).max() > 0
    _monopole_bar(got, want, dtype)


# --- sizing and the comm model ---------------------------------------------


def _cloud(n: int, seed: int, span: float = 100.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, span, (n, 3)).astype(dtype),
            rng.uniform(0.5, 1.5, n).astype(dtype))


@pytest.mark.parametrize("box", [0.0, 100.0])
def test_halo_sizing_equals_jax(box):
    for n, seed in ((512, 0), (2048, 1), (300, 2)):
        pos, _ = _cloud(n, seed)
        for rcut in (8.0, 20.0, 45.0):
            for devices in (1, 2, 3, 4, 8):
                want = jax_halo.resolve_halo_sizing(pos, rcut,
                                                    devices=devices, box=box)
                got = parallel.resolve_halo_sizing(pos, rcut,
                                                   devices=devices, box=box)
                assert got == want
                side = got[0]
                assert parallel.resolve_mig_cap(
                    pos, side, devices, box=box) == jax_halo.resolve_mig_cap(
                    pos, side, devices, box=box)


def test_halo_comm_model_equals_jax():
    for args in ((16384, 8, 64, 8), (1001, 12, 256, 4), (50, 4, 8, 1)):
        for kw in ({}, {"mig_cap": 512, "dtype_bytes": 8}):
            assert parallel.halo_comm_model(*args, **kw) == \
                jax_halo.halo_comm_model(*args, **kw)


# --- the halo engine on gloo ranks -----------------------------------------

# Force cases: (n, seed, span, rcut, box, cap, mig_cap).
FORCE_CASES = {
    2: {"iso": (256, 0, 100.0, 9.0, 0.0, 0, 0),
        "periodic": (128, 1, 50.0, 9.0, 50.0, 0, 0),
        "starved": (256, 2, 60.0, 9.0, 0.0, 4, 0),
        "odd": (203, 3, 100.0, 12.0, 0.0, 0, 0),
        "mig16": (256, 4, 60.0, 9.0, 0.0, 0, 16)},
    4: {"iso": (512, 5, 100.0, 9.0, 0.0, 0, 0)},
    8: {"iso": (256, 6, 100.0, 7.0, 0.0, 0, 0),
        "periodic": (256, 7, 50.0, 7.0, 50.0, 0, 0)},
}
# The periodic seam: a pair straddling the ring's closing seam (x ~ 0 and
# x ~ box in different slabs) attracts across the wrap; two far controls.
SEAM = np.array([[0.5, 25.0, 25.0], [49.5, 25.0, 25.0],
                 [25.0, 25.0, 10.0], [25.0, 25.0, 40.0]], np.float32)
HOT = dict(n=192, seed=8, rcut=25.0, steps=8, dt=2e-2, vel=20.0)
ODD_RUN = dict(n=203, seed=9, rcut=30.0, steps=4, dt=1e-3)
# P3M with the halo near field: a uniform cube in SI units, fp64, its
# binning side 4 (pm_grid 24), one plane a rank, no cell past the cap.
P3M_CASE = dict(n=1001, seed=10, pm_grid=24, p3m_cap=64, g=6.674e-11,
                eps=1e9, dtype="float64")
CONTEST_MIN_N = 64
# The split witness: six clumps in a thin disk, fp64, binning side 9 at
# pm_grid 48 (8 on the halo's 2 and 4 ranks), cap 8: a clump's cells hold
# up to ~260 bodies, so targets and sources pass the cap.
SPLIT = dict(n=2048, seed=21, pm_grid=48, cap=8, g=6.674e-11, eps=1e9,
             sigma_cells=1.25, rcut_sigmas=4.0)


def _sizing(pos, rcut, devices, box, cap):
    return jax_halo.resolve_halo_sizing(pos, rcut, cap=cap, devices=devices,
                                        box=box)


def _port_force(mesh, n, seed, span, rcut, box, cap, mig_cap):
    pos, m = _cloud(n, seed, span)
    state, _ = ParticleState(torch.from_numpy(pos), torch.zeros(n, 3),
                             torch.from_numpy(m)).pad_to(
        math.ceil(n / mesh.size) * mesh.size)
    side, cap = parallel.resolve_halo_sizing(pos, rcut, cap=cap,
                                             devices=mesh.size, box=box)
    fn = parallel.make_halo_nlist_accel(mesh, side=side, cap=cap, rcut=rcut,
                                        box=box, mig_cap=mig_cap, **G1)
    mine = parallel.shard_state(ParticleState(*(
        t[:n] for t in (state.positions, state.velocities, state.masses))),
        mesh)
    return fn(mine.positions, mine.masses).numpy()


def _hot_state(n, seed, vel=0.0):
    pos, m = _cloud(n, seed)
    v = (np.random.default_rng(seed + 100).normal(size=(n, 3)) * vel).astype(
        np.float32)
    return pos, v, m


def _run_cfg(case: dict, **fields) -> dict:
    return dict(n=case["n"], steps=case["steps"], dt=case["dt"],
                model="random", force_backend="nlist",
                nlist_rcut=case["rcut"], integrator="leapfrog",
                progress_every=case["steps"], g=1.0, eps=0.5, **fields)


def _port_run(case: dict, **fields) -> dict:
    pos, v, m = _hot_state(case["n"], case["seed"], case.get("vel", 0.0))
    sim = simulation.Simulator(SimulationConfig(**_run_cfg(case, **fields)),
                               state=ParticleState(*(torch.from_numpy(a) for a
                                                     in (pos, v, m))),
                               device="cpu")
    stats = sim.run()
    return {"positions": stats["final_state"].positions.numpy(),
            "velocities": stats["final_state"].velocities.numpy(),
            "halo": np.array(sim._halo_devices),
            "nlist_mesh": np.array(sim.config.nlist_mesh),
            "launch_side": np.array(sim.nlist_sizing[0])}


def _p3m_state():
    rng = np.random.default_rng(P3M_CASE["seed"])
    pos = rng.uniform(-3e11, 3e11, (P3M_CASE["n"], 3))
    m = rng.uniform(1e23, 1e25, P3M_CASE["n"])
    return pos, m


def _port_p3m(mesh) -> dict:
    pos, m = _p3m_state()
    n = P3M_CASE["n"]
    state = ParticleState(torch.from_numpy(pos), torch.zeros(n, 3,
                          dtype=torch.float64), torch.from_numpy(m))
    cfg = SimulationConfig(n=n, force_backend="p3m", sharding="allgather",
                           mesh_shape=(mesh.size,), integrator="leapfrog",
                           **{k: P3M_CASE[k] for k in ("pm_grid", "p3m_cap",
                                                       "g", "eps", "dtype")})
    sim = simulation.Simulator(cfg, state=state, device="cpu")
    sim.initial_carry()
    acc = sim._self_accel(sim.state.positions, sim.state.masses)
    return {"acc": acc.numpy(), "sizing": np.array(sim.p3m_sizing[:3]),
            "mode": np.array(sim.p3m_sizing[3])}


def _clumps():
    rng = np.random.default_rng(SPLIT["seed"])
    n = SPLIT["n"]
    centres = rng.uniform(-2e11, 2e11, (6, 3))
    centres[:, 2] *= 0.1
    pos = (centres[rng.integers(0, 6, n)]
           + rng.normal(0.0, 2e10, (n, 3)) * np.array([1.0, 1.0, 0.1]))
    return pos, rng.uniform(1e23, 1e25, n)


def _split_side(devices: int) -> int:
    side = p3m.binning_side(SPLIT["pm_grid"], SPLIT["sigma_cells"],
                            SPLIT["rcut_sigmas"])
    return (side // devices) * devices


def _p3m_split(mesh) -> dict:
    """The halo engine's ewald near field and the allgather mesh pass of
    the Simulator's sharded P3M (``_mesh_accel``), each alone."""
    pos, m = _clumps()
    n, grid, sc = SPLIT["n"], SPLIT["pm_grid"], SPLIT["sigma_cells"]
    mine = parallel.shard_state(ParticleState(
        torch.from_numpy(pos), torch.zeros(n, 3, dtype=torch.float64),
        torch.from_numpy(m)), mesh)
    near = parallel.make_halo_nlist_accel(
        mesh, side=_split_side(mesh.size), cap=SPLIT["cap"], kind="ewald",
        g=SPLIT["g"], eps=SPLIT["eps"], cutoff=0.0,
        ewald_scales=((grid - 1) / (math.sqrt(2.0) * sc),
                      SPLIT["rcut_sigmas"] * sc / (grid - 1)))

    def far_local(targets, sources, m_src):
        origin, span = pm.bounding_cube(sources)
        return p3m._mesh_accelerations(targets, sources, m_src, origin,
                                       span, grid=grid, g=SPLIT["g"],
                                       sigma_cells=sc)

    far = parallel.make_sharded_accel2(mesh, strategy="allgather",
                                       local_kernel=far_local)
    return {"split/near": near(mine.positions, mine.masses).numpy(),
            "split/far": far(mine.positions, mine.masses).numpy()}


def _contest(out_dir: str) -> dict:
    """auto on the hot cloud with the cell list's rcut, twice: a probe
    (rank 0 writes the cache), then a hit, each rank's verdict."""
    os.environ["GRAVITY_TPU_AUTOTUNE_MIN_N"] = str(CONTEST_MIN_N)
    os.environ["GRAVITY_TPU_TUNE_DIR"] = os.path.join(out_dir, "tune")
    pos, v, m = _hot_state(HOT["n"], HOT["seed"], HOT["vel"])
    state = ParticleState(*(torch.from_numpy(a) for a in (pos, v, m)))
    cfg = SimulationConfig(**{**_run_cfg(HOT, sharding="allgather"),
                              "force_backend": "auto"})
    out = {}
    for key in ("first", "again"):
        sim = simulation.Simulator(cfg, state=state, device="cpu")
        d = sim.autotune_decision
        out[f"contest/{key}"] = np.array([d.backend, d.cache, sim.backend,
                                          sim.config.nlist_mesh])
    return out


def _rank_main(rank: int, world: int, out_dir: str) -> None:
    with open(os.path.join(out_dir, f"rank{rank}.log"), "w") as log:
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
        rank=rank, world_size=world)
    mesh = parallel.make_particle_mesh((world,), device="cpu")
    out = {}
    for name, case in FORCE_CASES[world].items():
        out[f"force/{name}"] = _port_force(mesh, *case)
    if world == 2:
        fn = parallel.make_halo_nlist_accel(mesh, side=4, cap=4, rcut=9.0,
                                            box=50.0, **G1)
        mine = parallel.shard_state(ParticleState(
            torch.from_numpy(SEAM), torch.zeros(4, 3), torch.ones(4)), mesh)
        out["seam"] = fn(mine.positions, mine.masses).numpy()
    if world in (2, 4):
        out.update(_p3m_split(mesh))
    if world == 4:
        for k, v in _port_run(HOT, sharding="allgather",
                              mesh_shape=(4,)).items():
            out[f"hot/{k}"] = v
        for k, v in _port_run(ODD_RUN, sharding="allgather",
                              mesh_shape=(4,)).items():
            out[f"odd_run/{k}"] = v
        for k, v in _port_p3m(mesh).items():
            out[f"p3m/{k}"] = v
        out.update(_contest(out_dir))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def _spawn(out_dir, world: int) -> list:
    ctx = tmp.start_processes(_rank_main, args=(world, str(out_dir)),
                              nprocs=world, join=False,
                              start_method="spawn")
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
def ranks(tmp_path_factory):
    cache = {}

    def get(world: int) -> list:
        if world not in cache:
            cache[world] = _spawn(tmp_path_factory.mktemp(
                f"halo{world}", numbered=True), world)
        return cache[world]

    return get


def _stacked(results, key, n):
    return np.concatenate([r[key] for r in results])[:n]


def _mrel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(a - b).max() / (np.linalg.norm(b, axis=-1).mean()
                                        + 1e-30))


CASE_IDS = [(w, name) for w in sorted(FORCE_CASES)
            for name in FORCE_CASES[w] if name != "mig16"]


@pytest.mark.parametrize("world,name", CASE_IDS,
                         ids=[f"P{w}-{n}" for w, n in CASE_IDS])
def test_halo_engine_matches_jax_solo(ranks, world, name):
    n, seed, span, rcut, box, cap, _ = FORCE_CASES[world][name]
    pos, m = _cloud(n, seed, span)
    side, cap = _sizing(pos, rcut, world, box, cap)
    want = np.asarray(jax_nlist.nlist_accelerations(
        jnp.asarray(pos), jnp.asarray(m), rcut=rcut, side=side, cap=cap,
        box=box, **G1))
    got = _stacked(ranks(world), f"force/{name}", n)
    assert np.all(np.isfinite(got))
    assert _mrel(got, want) <= HALO_TOL


def test_halo_seam_pair_attracts_across_the_wrap(ranks):
    acc = _stacked(ranks(2), "seam", 4)
    assert acc[0, 0] < 0.0 and acc[1, 0] > 0.0
    np.testing.assert_allclose(acc[2:], 0.0, atol=1e-6)


def test_halo_starved_cap_degrades_as_the_solo_cell_list(ranks):
    """At cap 4 the over-cap sources act through the remainder monopoles
    that ride the exchange: the halo answer departs from the full-cap one
    exactly as JAX's solo answer at cap 4 does."""
    n, seed, span, rcut, box, cap4, _ = FORCE_CASES[2]["starved"]
    pos, m = _cloud(n, seed, span)
    kw = dict(rcut=rcut, box=box, **G1)
    side, cap = _sizing(pos, rcut, 2, box, 0)
    full = np.asarray(jax_nlist.nlist_accelerations(
        jnp.asarray(pos), jnp.asarray(m), side=side, cap=cap, **kw))
    side4, _ = _sizing(pos, rcut, 2, box, cap4)
    starved = np.asarray(jax_nlist.nlist_accelerations(
        jnp.asarray(pos), jnp.asarray(m), side=side4, cap=cap4, **kw))
    got = _stacked(ranks(2), "force/starved", n)
    assert np.all(np.isfinite(got)) and _mrel(starved, full) > 0.01
    assert abs(_mrel(got, full) - _mrel(starved, full)) <= HALO_TOL


def test_halo_migration_overflow_drops_exactly_the_emigrants(ranks):
    """mig_cap 16 overflows the migration buckets: a rank's rows past the
    16th bound for a slab get no short-range force (their mass acts
    through the bucket's remainder monopole), every other row a finite
    nonzero one."""
    n, seed, span, rcut, box, cap, mig = FORCE_CASES[2]["mig16"]
    pos, _ = _cloud(n, seed, span)
    side, _ = _sizing(pos, rcut, 2, box, cap)
    assert jax_halo.resolve_mig_cap(pos, side, 2) > mig
    lo, hi = pos.min(axis=0), pos.max(axis=0)
    span_c = float((hi - lo).max()) * 1.02 + 1e-30
    origin = float((0.5 * (hi + lo) - 0.5 * span_c)[0])
    dest = np.clip(((pos[:, 0] - origin) / span_c * side).astype(int), 0,
                   side - 1) // (side // 2)
    dropped = np.zeros(n, bool)
    for block in np.array_split(np.arange(n), 2):
        for d in range(2):
            dropped[block[dest[block] == d][mig:]] = True
    got = _stacked(ranks(2), "force/mig16", n)
    assert np.all(np.isfinite(got)) and 0 < dropped.sum() < n
    assert np.all(got[dropped] == 0)
    assert np.all(np.abs(got[~dropped]).max(axis=1) > 0)


def _jax_run(case: dict, devices: int):
    """JAX's solo run at the halo's (side, cap) on ``devices`` ranks."""
    pos, v, m = _hot_state(case["n"], case["seed"], case.get("vel", 0.0))
    side, cap = _sizing(pos, case["rcut"], devices, 0.0, 0)
    return jax_sim.Simulator(
        JaxConfig(**_run_cfg(case, nlist_side=side, nlist_cap=cap)),
        state=JaxState(jnp.asarray(pos), jnp.asarray(v),
                       jnp.asarray(m))).run()


@pytest.mark.parametrize("key,case", [("hot", HOT), ("odd_run", ODD_RUN)])
def test_halo_simulator_run_on_four_ranks_matches_jax_solo(ranks, key, case):
    """The Simulator's mesh routing takes the halo engine under auto on 4
    ranks; a hot cloud migrates across slabs every step, and odd N pads."""
    want = _jax_run(case, 4)["final_state"]
    for r in ranks(4):
        assert int(r[f"{key}/halo"]) == 4
        assert str(r[f"{key}/nlist_mesh"]) == "auto"
        for f in ("positions", "velocities"):
            assert _mrel(r[f"{key}/{f}"], getattr(want, f)) <= RUN_TOL


def test_p3m_halo_near_field_matches_jax_unsharded(ranks, x64):
    pos, m = _p3m_state()
    want = np.asarray(jax_p3m(
        jnp.asarray(pos), jnp.asarray(m), grid=P3M_CASE["pm_grid"],
        cap=P3M_CASE["p3m_cap"], g=P3M_CASE["g"], eps=P3M_CASE["eps"]))
    results = ranks(4)
    assert str(results[0]["p3m/mode"]) == "halo"
    assert results[0]["p3m/sizing"].tolist() == [4, 64, 64]
    got = _stacked(results, "p3m/acc", P3M_CASE["n"])
    assert _mrel(got, want) <= P3M_TOL


def _solo_split(side: int):
    """The solo P3M's near field at ``side`` (its mesh pass taken out) and
    its mesh pass, on the clumps, with each row's scale of rounding: the
    sum over the pairs within rcut of gm (|newt| + |corr|) |d|."""
    pos, m = _clumps()
    tp, tm = torch.from_numpy(pos), torch.from_numpy(m)
    kw = dict(grid=SPLIT["pm_grid"], sigma_cells=SPLIT["sigma_cells"],
              rcut_sigmas=SPLIT["rcut_sigmas"], g=SPLIT["g"],
              eps=SPLIT["eps"], cutoff=0.0)
    mesh_pass = p3m._mesh_accelerations
    origin, span = pm.bounding_cube(tp)
    far = mesh_pass(tp, tp, tm, origin, span, grid=kw["grid"], g=kw["g"],
                    sigma_cells=kw["sigma_cells"])
    try:
        p3m._mesh_accelerations = lambda targets, *a, **k: \
            torch.zeros_like(targets)
        near = p3m.p3m_accelerations(tp, tm, cap=SPLIT["cap"], side=side,
                                     short_mode="nlist", **kw)
    finally:
        p3m._mesh_accelerations = mesh_pass
    sigma = SPLIT["sigma_cells"] * span / (SPLIT["pm_grid"] - 1)
    params = torch.stack([(SPLIT["rcut_sigmas"] * sigma) ** 2,
                          1.0 / (math.sqrt(2.0) * sigma)])
    d = tp[None, :, :] - tp[:, None, :]
    w = nlist._ewald_w((d * d).sum(-1), SPLIT["g"] * tm[None, :], params,
                       cutoff=0.0, eps=SPLIT["eps"], absolute=True)
    scale = (w * d.norm(dim=-1)).sum(dim=1)
    return near.numpy(), far.numpy(), scale.numpy()


@pytest.mark.parametrize("world", [2, 4])
def test_p3m_halo_near_field_split_witness_where_cells_overflow(ranks,
                                                                world):
    """Part of P3M's halo run apart from the other: the near field to the
    solo near field at the halo's side within rounding, with targets and
    sources past the cap; the mesh pass the solo mesh pass's bits."""
    side = _split_side(world)
    pos, _ = _clumps()
    tp = torch.from_numpy(pos)
    origin, span = pm.bounding_cube(tp)
    coords = nlist.grid_coords(tp, origin, span, side)
    ids = (coords[:, 0] * side + coords[:, 1]) * side + coords[:, 2]
    counts = np.bincount(ids.numpy(), minlength=side**3)
    assert (counts > SPLIT["cap"]).sum() >= 10 and counts.max() > 8 * SPLIT[
        "cap"]
    results = ranks(world)
    near, far, scale = _solo_split(side)
    got_near = _stacked(results, "split/near", SPLIT["n"])
    got_far = _stacked(results, "split/far", SPLIT["n"])
    assert np.all(np.abs(got_near - near).max(axis=1) <= F64_TERMS * scale)
    np.testing.assert_array_equal(got_far, far)


def test_mesh_contest_gives_every_rank_one_winner(ranks):
    verdicts = [tuple(r["contest/first"]) for r in ranks(4)]
    again = [tuple(r["contest/again"]) for r in ranks(4)]
    assert len(set(verdicts)) == 1 and len(set(again)) == 1
    winner, cache, backend, mesh_mode = verdicts[0]
    assert cache == "miss" and again[0][1] == "hit"
    assert again[0][0] == winner
    assert winner in ("dense", "nlist@halo", "nlist@allgather")
    if "@" in winner:
        assert (backend, mesh_mode) == tuple(winner.split("@"))


@pytest.mark.parametrize("shape", [(1,), (4,), (2, 2)])
@pytest.mark.parametrize("fields", [
    dict(nlist_rcut=25.0), dict(nlist_rcut=25.0, nlist_mesh="halo"),
    dict(nlist_rcut=25.0, nlist_mesh="allgather"), dict(),
])
def test_mesh_candidates_equal_jax(shape, fields, monkeypatch):
    monkeypatch.setenv("GRAVITY_TPU_AUTOTUNE_MIN_N", str(CONTEST_MIN_N))
    for sharding in ("allgather", "ring"):
        common = dict(n=4096, sharding=sharding, mesh_shape=shape, **fields)
        got = autotune.eligible_candidates(SimulationConfig(**common), False)
        want = jax_autotune.eligible_candidates(JaxConfig(**common), False)
        assert got[0] == want[0]
        assert sorted(got[1]) == sorted(want[1])


def test_composite_candidate_configs_pin_the_mesh_strategy():
    cfg = SimulationConfig(nlist_rcut=1.0, sharding="allgather")
    for name in ("nlist@halo", "nlist@allgather", "dense"):
        got = autotune._candidate_config(cfg, name)
        want = jax_autotune._candidate_config(JaxConfig(
            nlist_rcut=1.0, sharding="allgather"), name)
        assert (got.force_backend, got.nlist_mesh) == (
            want.force_backend, want.nlist_mesh)


def test_cache_key_names_the_world_a_launch_runs_on(monkeypatch):
    """A sharded run with no mesh_shape runs on (world,), which a launcher
    sets anew each launch: a winner measured on 4 ranks is not a hit on 2
    or 8, and an explicit (4,) is the same key as a world of four."""
    base = dict(candidates=("dense", "nlist@halo", "nlist@allgather"),
                platform="cpu", device_kind="cpu", occupancy="occ2^-3")
    keys = {}
    for world in (2, 4, 8):
        monkeypatch.setattr(autotune, "_world_size", lambda w=world: w)
        keys[world] = autotune.key_hash(autotune.make_key(
            SimulationConfig(n=4096, sharding="allgather"), **base))
    assert len(set(keys.values())) == 3
    assert keys[4] == autotune.key_hash(autotune.make_key(
        SimulationConfig(n=4096, sharding="allgather", mesh_shape=(4,)),
        **base))
    solo = autotune.make_key(SimulationConfig(n=4096), **base)
    assert solo["mesh_shape"] is None
