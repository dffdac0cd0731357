"""The sharded FMM forms (gravity_tpu_torch/parallel/sharded_fmm.py) on 2 and
4 gloo ranks, against the port's unsharded evaluation and the JAX
package's, on the CPU.

Ranks are spawned with ``torch.multiprocessing`` and joined through a
``FileStore`` in the test's temporary directory (one spawn a world size, a
module), each with one intra-op thread. The same numpy-seeded thin disk
goes through:

- the sharded dense FMM (x-slabs of the leaf grid a rank) and the sharded
  sparse FMM (K chunks a rank), fp32 and fp64, against the port's
  unsharded evaluation at the same sizing: the same bits (the split is by
  cells, every rank bins every target);
- the same against the JAX package's unsharded ``fmm_accelerations`` and
  ``sfmm_accelerations``: fp32 median relative < 1e-5 and max < 1e-3 (the
  bars of ``tests/test_torch_fmm.py``), fp64 every row within 1e-9 of its
  |a|;
- a Simulator on the mesh with ``force_backend="fmm"``, ``fmm_mode="auto"``:
  the occupancy decision on the gathered state takes the sparse layout on
  the disk and the dense one on a uniform cube, the as-run sizing carries
  the sharded k_eff and k_chunk_eff (what ``final_occupancy_check`` reads),
  and a 2-step run gives the unsharded run's bits.

The k_eff / k_chunk_eff rule and the refusal of a world that does not
divide the slabs are held to the JAX package's own (its sharded forms
built on the suite's virtual CPU devices).
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

from gravity_tpu.ops import fmm as jax_fmm
from gravity_tpu.ops import sfmm as jax_sfmm
from gravity_tpu_torch import parallel
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.ops import fmm, sfmm
from gravity_tpu_torch.simulation import Simulator
from gravity_tpu_torch.state import ParticleState

N = 1536
DENSE = dict(depth=4, leaf_cap=16)
SPARSE = dict(depth=6, leaf_cap=16, k_cells=2048)
KW = dict(g=1.0, eps=0.05, cutoff=0.0)
# The Simulator cases: a forced depth keeps the sparse rank table small
# (the data's own sizing takes depth 9 on this disk).
SIM_KW = dict(tree_depth=4, tree_leaf_cap=16, integrator="leapfrog",
              dt=1e-3, steps=2, progress_every=2, dtype="float64")
F64_ROW_TOL = 1e-9
F32_MEDIAN_TOL = 1e-5
F32_MAX_TOL = 1e-3
SPAWN_TIMEOUT_S = 240
DTYPES = {"float32": torch.float32, "float64": torch.float64}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _disk(n: int = N, seed: int = 4):
    """A thin exponential disk around a unit point mass (galactic units)."""
    rng = np.random.default_rng(seed)
    r = rng.exponential(3.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    pos = np.stack([r * np.cos(phi), r * np.sin(phi),
                    rng.normal(0.0, 0.05, n)], axis=1)
    pos[0] = 0.0
    m = np.full(n, 5.0 / n)
    m[0] = 1.0
    return pos, m


def _cube(n: int = N, seed: int = 5):
    rng = np.random.default_rng(seed)
    return rng.uniform(-10.0, 10.0, (n, 3)), np.full(n, 1.0 / n)


def _state(pos, m, dtype):
    p = torch.from_numpy(pos).to(dtype)
    return ParticleState(p, torch.zeros_like(p), torch.from_numpy(m).to(dtype))


def _sim_case(kind: str, world: int) -> dict:
    """fmm/auto on the mesh: its layout, as-run sizing, one evaluation's
    bits and a 2-step run's final positions."""
    pos, m = _disk() if kind == "disk" else _cube()
    cfg = SimulationConfig(n=N, force_backend="fmm", fmm_mode="auto",
                           sharding="allgather", mesh_shape=(world,),
                           **SIM_KW, **KW)
    sim = Simulator(cfg, state=_state(pos, m, torch.float64), device="cpu")
    out = {"sparse": np.array(sim.fmm_sparse),
           "sizing": np.array(sim.sfmm_sizing or (sim.fmm_depth,))}
    out["acc"] = sim.global_self_accel(sim.global_state(sim.state).positions,
                                       sim.global_state(sim.state).masses
                                       ).numpy()
    stats = sim.run()
    out["final"] = stats["final_state"].positions.numpy()
    occ = stats.get("sfmm_final_occupancy")
    out["occ_k"] = np.array(occ["k_cells"] if occ else -1)
    out["stats_k"] = np.array([stats.get("sfmm_k_cells", -1),
                               stats.get("sfmm_k_chunk", -1)])
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
    pos, m = _disk()
    rows = mesh.rows(N)
    out = {}
    for name, dtype in DTYPES.items():
        st = _state(pos, m, dtype)
        dense = parallel.make_sharded_fmm_accel(mesh, **DENSE, **KW)
        out[f"dense/{name}"] = dense(st.positions[rows],
                                     st.masses[rows]).numpy()
        sparse = parallel.make_sharded_sfmm_accel(mesh, **SPARSE, **KW)
        out[f"sparse/{name}"] = sparse(st.positions[rows],
                                       st.masses[rows]).numpy()
        out["k"] = np.array([sparse.k_eff, sparse.k_chunk_eff])
    for kind in ("disk", "cube"):
        for k, v in _sim_case(kind, world).items():
            out[f"sim/{kind}/{k}"] = v
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
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cache = {}

    def get(world: int) -> list:
        if world not in cache:
            cache[world] = _spawn(tmp_path_factory.mktemp(
                f"sfmm{world}", numbered=True), world)
        return cache[world]

    return get


def _stacked(results, key):
    return np.concatenate([r[key] for r in results])[:N]


def _unsharded(form: str, name: str, k=None):
    pos, m = _disk()
    st = _state(pos, m, DTYPES[name])
    if form == "dense":
        return fmm.fmm_accelerations(st.positions, st.masses, **DENSE,
                                     **KW).numpy()
    return sfmm.sfmm_accelerations(
        st.positions, st.masses, depth=SPARSE["depth"],
        leaf_cap=SPARSE["leaf_cap"], k_cells=int(k[0]), k_chunk=int(k[1]),
        **KW).numpy()


CASES = [(w, f, d) for w in (2, 4) for f in ("dense", "sparse")
         for d in DTYPES]
IDS = [f"P{w}-{f}-{d}" for w, f, d in CASES]


@pytest.mark.parametrize("world,form,name", CASES, ids=IDS)
def test_sharded_fmm_gives_the_unsharded_bits(ranks, world, form, name):
    results = ranks(world)
    got = _stacked(results, f"{form}/{name}")
    want = _unsharded(form, name, results[0]["k"])
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got, want)


def _jax_unsharded(form: str, name: str):
    pos, m = _disk()
    dt = np.float32 if name == "float32" else np.float64
    p, mm = jnp.asarray(pos.astype(dt)), jnp.asarray(m.astype(dt))
    if form == "dense":
        return np.asarray(jax_fmm.fmm_accelerations(p, mm, **DENSE, **KW))
    return np.asarray(jax_sfmm.sfmm_accelerations(p, mm, **SPARSE, **KW))


@pytest.mark.parametrize("world,form,name", CASES, ids=IDS)
def test_sharded_fmm_matches_jax_unsharded(ranks, world, form, name, x64):
    got = _stacked(ranks(world), f"{form}/{name}").astype(np.float64)
    want = _jax_unsharded(form, name).astype(np.float64)
    norm = np.linalg.norm(want, axis=1)
    err = np.linalg.norm(got - want, axis=1)
    if name == "float64":
        assert np.all(err <= F64_ROW_TOL * norm)
    else:
        rel = err / np.maximum(norm, 1e-30)
        assert np.median(rel) < F32_MEDIAN_TOL and rel.max() < F32_MAX_TOL


def _jax_k(k_cells: int, world: int) -> tuple:
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("shard",))
    fn = jax_sfmm.make_sharded_sfmm_accel(mesh, depth=5, leaf_cap=16,
                                          k_cells=k_cells)
    return fn.k_eff, fn.k_chunk_eff


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_k_eff_and_k_chunk_eff_are_the_jax_rule(world):
    for k_cells in (1, 100, 1024, 1500, 8192, 20000, 65537):
        k_eff, k_chunk, local = sfmm.sharded_k_sizing(k_cells, world)
        assert (k_eff, k_chunk) == _jax_k(k_cells, world), k_cells
        assert local * k_chunk * world == k_eff and local >= 1


def test_a_world_that_cannot_divide_the_slabs_is_refused_as_in_jax():
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("shard",))
    with pytest.raises(ValueError) as jax_err:
        jax_fmm.make_sharded_fmm_accel(mesh, depth=1, leaf_cap=16)
    with pytest.raises(ValueError) as port_err:
        fmm.SlabShare(0, 4, depth=1)
    assert str(port_err.value) == str(jax_err.value)
    fmm.SlabShare(3, 4, depth=2)  # 4 slabs: one a rank


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_occupancy_route_and_the_as_run_sizing(ranks, world):
    results = ranks(world)
    first = results[0]
    assert bool(first["sim/disk/sparse"])
    assert not bool(first["sim/cube/sparse"])
    depth, cap, k_eff, k_chunk = first["sim/disk/sizing"].tolist()
    nominal = sfmm.resolve_sfmm_sizing(_disk()[0], 4, 16)[2]
    assert (k_eff, k_chunk) == sfmm.sharded_k_sizing(nominal, world)[:2]
    assert first["sim/disk/stats_k"].tolist() == [k_eff, k_chunk]
    assert int(first["sim/disk/occ_k"]) == k_eff
    for kind in ("disk", "cube"):
        for r in results[1:]:
            np.testing.assert_array_equal(r[f"sim/{kind}/acc"],
                                          results[0][f"sim/{kind}/acc"])
        # The unsharded Simulator at the same as-run sizing.
        pos, m = _disk() if kind == "disk" else _cube()
        cfg = SimulationConfig(n=N, force_backend="fmm", fmm_mode="auto",
                               **SIM_KW, **KW)
        solo = Simulator(cfg, state=_state(pos, m, torch.float64),
                         device="cpu")
        if kind == "disk":
            solo.sfmm_sizing = tuple(int(x) for x in (depth, cap, k_eff,
                                                      k_chunk))
        want = solo._self_accel(solo.state.positions, solo.state.masses)
        np.testing.assert_array_equal(results[0][f"sim/{kind}/acc"],
                                      want.numpy())
        final = solo.run()["final_state"].positions.numpy()
        np.testing.assert_array_equal(results[0][f"sim/{kind}/final"], final)


@pytest.mark.parametrize("sharding,want", [("none", "sfmm"),
                                           ("allgather", "fmm")])
def test_auto_crowning_sfmm_takes_fmm_on_a_mesh(monkeypatch, sharding,
                                                want):
    """``auto`` whose measured winner is ``sfmm`` runs it solo and takes
    the dense layout's name on a mesh (the JAX package's
    simulation.py:284-291), whose fmm_mode="auto" decision still routes a
    clustered state to the sparse form."""
    from gravity_tpu_torch import autotune, simulation

    monkeypatch.setattr(
        autotune, "resolve_backend_measured",
        lambda config, state, device=None: autotune.AutotuneDecision(
            "sfmm", "hit", 0.0, {}, {}, ""))
    cfg = SimulationConfig(n=N, force_backend="auto", sharding=sharding)
    backend, decision = simulation._resolve_backend_for_run(
        cfg, None, torch.device("cpu"))
    assert (backend, decision.backend) == (want, "sfmm")
