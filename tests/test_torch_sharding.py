"""The sharded direct sums (gravity_tpu_torch/parallel/) against the JAX
package's, on the CPU: the port on P gloo ranks, the JAX package on a
P-device mesh of the suite's 8 virtual CPU devices.

Ranks are spawned with ``torch.multiprocessing`` and joined through a
``FileStore`` in the test's temporary directory, never a TCP port (the
suite runs under several xdist workers at once). Each spawn has its own
timeout; the ranks' output goes to files there, and each rank saves its
rows of every case to an ``.npz`` that the test stacks in rank order. A
spawn runs all of its world size's cases, once a module.

The same seeded numpy state goes through both packages: allgather and
the ring at P = 2 and 4 (dense and chunked, N not divisible by P), the
allgather form of ``pallas`` (its plain version here), p3m and the tree
at P = 4, the hierarchical ring on a (2, 4) mesh of 8 ranks, the
rectangular psum form, the merge pass and a short Simulator run at P = 4,
the halo slab engine's nlist and P3M runs and the sharded integration
modes (multirate with two rungs and the ladder, adaptive, adaptive x
multirate) at P = 4 against the JAX package's unsharded runs, and the CLI
on a (2, 2) mesh.

Bars:

- fp32: ``rtol=2e-5, atol=1e-12`` (``tests/test_torch_forces.py:32``);
- fp64: every row within 1e-12 of its sum of |terms| (the pair terms'
  magnitudes, against which any order of the same sum rounds);
- the tree (fp32): max |diff| / mean |a| < 1e-5, and P3M (fp64) < 1e-12,
  the bars of ``tests/test_torch_tree.py`` and ``test_torch_p3m.py`` for
  the unsharded solvers (the sharded form adds no arithmetic);
- a 10-step leapfrog run: positions and velocities within 1e-5 of |row|
  (fp32), the merge pass's count and masses equal and the total mass
  conserved to 1e-6;
- the ledger's drifts on four ranks within 1e-4 of the same run's on one
  process (a baseline of one rank's rows would be off by order one).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from gravity_tpu import simulation as jax_sim
from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.parallel import (
    make_particle_mesh as jax_mesh,
    make_sharded_accel2 as jax_sharded,
    make_sharded_rect_accel as jax_rect,
    shard_state as jax_shard_state,
)
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch import parallel, simulation
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.state import ParticleState


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


N = 1001  # not a multiple of 2, 4 or 8: every mesh pads
FP32 = dict(rtol=2e-5, atol=1e-12)
F64_TERMS = 1e-12
TREE_TOL = 1e-5
P3M_TOL = 1e-12
RUN_TOL = 1e-5
SPAWN_TIMEOUT_S = 240
# The JAX names of the port's resolved kernel backends.
PORT_BACKEND = {"pallas": simulation.KERNEL_BACKEND}
KW = dict(g=6.674e-11, eps=1e9)
GALAXY = dict(g=1.0, eps=0.05)


def _inputs(n: int, seed: int, dtype, model: str = "cube"):
    """(positions, masses): a uniform cube, or a thin disk for the fast
    solvers (whose cells want structure)."""
    rng = np.random.default_rng(seed)
    if model == "disk":
        r = rng.exponential(3.0, n)
        phi = rng.uniform(0.0, 2.0 * np.pi, n)
        pos = np.stack([r * np.cos(phi), r * np.sin(phi),
                        0.3 * rng.normal(size=n)], axis=1)
        m = np.full(n, 5.0 / n)
    else:
        pos = rng.uniform(-3e11, 3e11, (n, 3))
        m = rng.uniform(1e23, 1e25, n)
    return pos.astype(dtype), m.astype(dtype)


def _fields(case: dict) -> dict:
    """The config fields both packages get for a case."""
    extra = dict(case.get("fields", {}))
    return dict(n=case["n"], **(GALAXY if case.get("model") == "disk"
                                else KW), **extra)


# Force cases: (strategy, backend, dtype, model, fields).
FORCE_CASES = {
    2: {
        "dense-allgather": ("allgather", "dense", "float32", "cube", {}),
        "dense-ring": ("ring", "dense", "float32", "cube", {}),
        "chunked-allgather": ("allgather", "chunked", "float32", "cube", {}),
        "chunked-ring-f64": ("ring", "chunked", "float64", "cube", {}),
    },
    4: {
        "dense-allgather": ("allgather", "dense", "float32", "cube", {}),
        "dense-ring": ("ring", "dense", "float32", "cube", {}),
        "chunked-allgather": ("allgather", "chunked", "float32", "cube", {}),
        "chunked-ring": ("ring", "chunked", "float32", "cube", {}),
        "dense-ring-f64": ("ring", "dense", "float64", "cube", {}),
        "pallas-allgather": ("allgather", "pallas", "float32", "cube", {}),
        "p3m-allgather-f64": ("allgather", "p3m", "float64", "disk",
                              dict(pm_grid=16, p3m_cap=16,
                                   p3m_short="gather")),
        "tree-allgather": ("allgather", "tree", "float32", "disk",
                           dict(tree_depth=4, tree_leaf_cap=16)),
    },
    8: {
        "dense-hring": ("ring", "dense", "float32", "cube", {}),
        "dense-hring-f64": ("ring", "dense", "float64", "cube", {}),
        "dense-allgather-2x4": ("allgather", "dense", "float32", "cube", {}),
    },
}
MESHES = {2: (2,), 4: (4,), 8: (2, 4)}
MERGE_RADIUS = 0.05  # a few of the disk's 1,001 bodies collide
RUN_CFG = dict(model="disk", n=N, integrator="leapfrog", steps=10,
               dt=1e-2, progress_every=5, force_backend="dense", **GALAXY)
# Runs on four ranks against the JAX package's unsharded run of the same
# fields: the halo engine under nlist_mesh="auto" (the cell list at a
# pinned sizing both packages share, P3M with its near field's cell list
# at binning side 4, one grid both use), and the sharded integration
# modes (an explicit fast capacity: the padded N would change auto's).
MESH_RUNS = {
    "halo-nlist": dict(force_backend="nlist", nlist_rcut=1.0,
                       nlist_side=8, nlist_cap=32),
    "halo-p3m": dict(force_backend="p3m", pm_grid=24, p3m_cap=16,
                     p3m_short="nlist"),
    "multirate": dict(integrator="multirate", multirate_k=64),
    "ladder": dict(integrator="multirate", multirate_k=64,
                   multirate_rungs=3),
    "adaptive": dict(adaptive=True),
    "adaptive-multirate": dict(adaptive=True, integrator="multirate",
                               multirate_k=64),
}
# The ledger on a mesh: its baseline and every reading are of the whole
# state (the merge case takes a new baseline after each merger).
LEDGER_CASES = {
    "ledger": dict(sharding="allgather", ledger=True,
                   merge_radius=MERGE_RADIUS, merge_every=5),
    "ledger-ring": dict(sharding="ring", ledger=True),
}
LEDGER_KEYS = ("max_energy_drift", "energy_drift", "momentum_drift",
               "angmom_drift", "com_drift")
# Drifts are relative (of |E|, |P|, |L|, the spread of the bodies): the
# world of four and the world of one agree to this much, where a
# baseline of one rank's quarter would be off by order one.
LEDGER_TOL = 1e-4


def _dtype(name: str):
    return {"float32": np.float32, "float64": np.float64}[name]


# --- the ranks -------------------------------------------------------------


def _port_force(mesh, strategy, backend, dtype, model, fields):
    pos, m = _inputs(N, 11, _dtype(dtype), model)
    state = ParticleState(torch.from_numpy(pos), torch.zeros_like(
        torch.from_numpy(pos)), torch.from_numpy(m))
    padded, _ = state.pad_to(math.ceil(N / mesh.size) * mesh.size)
    cfg = SimulationConfig(**_fields(dict(n=N, model=model, fields=fields)),
                           dtype=dtype)
    local = simulation.make_local_kernel(
        cfg, PORT_BACKEND.get(backend, backend), positions=padded.positions)
    mine = parallel.shard_state(state, mesh)
    fn = parallel.make_sharded_accel2(mesh, strategy=strategy,
                                      local_kernel=local)
    return fn(mine.positions, mine.masses).numpy()


def _run_state():
    pos, m = _inputs(N, 5, np.float32, "disk")
    vel = np.random.default_rng(6).normal(0.0, 0.3, (N, 3)).astype(
        np.float32)
    return pos, vel, m


def _port_run(fields: dict) -> dict:
    pos, vel, m = _run_state()
    state = ParticleState(*(torch.from_numpy(a) for a in (pos, vel, m)))
    sim = simulation.Simulator(SimulationConfig(**{**RUN_CFG, **fields}),
                               state=state, device="cpu")
    stats = sim.run()
    final = stats["final_state"]
    out = {"positions": final.positions.numpy(),
           "velocities": final.velocities.numpy(),
           "masses": final.masses.numpy(),
           "num_devices": np.array(stats["num_devices"]),
           "merged": np.array(stats.get("merged_pairs", -1)),
           "halo": np.array(sim._halo_devices)}
    for k in LEDGER_KEYS:
        if "ledger" in stats:
            out[k] = np.array(stats["ledger"][k], np.float64)
    return out


def _rank_main(rank: int, world: int, out_dir: str) -> None:
    """One rank: join the FileStore world, run every case of this world
    size, save this rank's rows (and rank-0's global results)."""
    with open(os.path.join(out_dir, f"rank{rank}.log"), "w") as log:
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
        rank=rank, world_size=world)
    mesh = parallel.make_particle_mesh(MESHES[world], device="cpu")
    out = {}
    for name, case in FORCE_CASES[world].items():
        out[f"force/{name}"] = _port_force(mesh, *case)
    out["coords"] = np.array(mesh.coords)
    if world == 4:
        # The rectangular psum form: 64 targets on every rank.
        pos, m = _inputs(N, 11, np.float32)
        mine = parallel.shard_state(ParticleState(
            torch.from_numpy(pos), torch.zeros(N, 3),
            torch.from_numpy(m)), mesh)
        rect = parallel.make_sharded_rect_accel(
            mesh, simulation.make_local_kernel(SimulationConfig(**KW),
                                               "dense"))
        out["rect"] = rect(torch.from_numpy(pos[:64]), mine.positions,
                           mine.masses).numpy()
        # The one-argument form, the layout helpers and the gather back.
        accel_fn = parallel.make_sharded_accel_fn(mesh, mine.masses,
                                                  strategy="ring", **KW)
        out["accel_fn"] = accel_fn(mine.positions).numpy()
        whole = parallel.replicate_state(mine, mesh)
        rows = parallel.particle_sharding(mesh, N)
        out["layout"] = np.array([
            parallel.num_shards(mesh), rows.start, rows.stop,
            int(torch.equal(whole.positions[rows], mine.positions)),
            int(torch.equal(whole.positions[:N], torch.from_numpy(pos))),
            int(float(whole.masses[N:].abs().sum()) == 0.0),
            int(parallel.particle_spec(mesh) == (parallel.SHARD_AXIS,))])
        for key, fields in (("run", dict(sharding="allgather")),
                            ("run-ring", dict(sharding="ring")),
                            ("merge", dict(sharding="allgather",
                                           merge_radius=MERGE_RADIUS,
                                           merge_every=5)),
                            *LEDGER_CASES.items()):
            for k, v in _port_run(fields).items():
                out[f"{key}/{k}"] = v
        for key, fields in MESH_RUNS.items():
            for k, v in _port_run(dict(sharding="allgather",
                                       **fields)).items():
                out[f"mesh/{key}/{k}"] = v
    if world == 4:
        from gravity_tpu_torch.cli import main

        code = main(["run", "--device", "cpu", "--model", "plummer",
                     "--n", "203", "--eps", "1e9", "--integrator",
                     "leapfrog", "--steps", "4", "--sharding", "ring",
                     "--mesh-shape", "2,2", "--ledger", "--sentinel-every",
                     "1", "--trajectories", "--debug-check", "--log-dir",
                     os.path.join(out_dir, "cli")])
        out["cli/code"] = np.array(code)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def _spawn(out_dir, world: int) -> list:
    """Spawn ``world`` ranks and wait for them at most SPAWN_TIMEOUT_S;
    a rank's exception fails the test with its traceback and log."""
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
    """{world: [rank 0's results, ...]}, each world spawned at its first
    use."""
    cache = {}

    def get(world: int) -> list:
        if world not in cache:
            cache[world] = _spawn(tmp_path_factory.mktemp(
                f"world{world}", numbered=False), world)
        return cache[world]

    return get


# --- the JAX package -------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_force(world, strategy, backend, dtype, model, fields_items):
    pos, m = _inputs(N, 11, _dtype(dtype), model)
    mesh = jax_mesh(MESHES[world])
    state = JaxState(jnp.asarray(pos), jnp.zeros_like(jnp.asarray(pos)),
                     jnp.asarray(m))
    state, _ = state.pad_to(math.ceil(N / world) * world)
    state = jax_shard_state(state, mesh)
    cfg = JaxConfig(**_fields(dict(n=N, model=model,
                                   fields=dict(fields_items))),
                    dtype=dtype)
    local = jax_sim.make_local_kernel(cfg, backend,
                                      positions=state.positions)
    fn = jax_sharded(mesh, strategy=strategy, local_kernel=local)
    return np.asarray(fn(state.positions, state.masses))[:N]


def _sum_abs_terms(pos, m, g, eps):
    """(N,) float64 sum over sources of |g m_j (x_j - x_i) / r^3|."""
    pos = pos.astype(np.float64)
    d = pos[None, :, :] - pos[:, None, :]
    r2 = (d * d).sum(-1) + eps * eps
    np.fill_diagonal(r2, np.inf)
    w = g * m.astype(np.float64)[None, :] / (r2 * np.sqrt(r2))
    return (w[..., None] * np.abs(d)).sum(1).max(-1)


def _stacked(results: list, key: str) -> np.ndarray:
    return np.concatenate([r[key] for r in results])[:N]


CASE_IDS = [(w, name) for w in sorted(FORCE_CASES)
            for name in FORCE_CASES[w]]


@pytest.mark.parametrize("world,name", CASE_IDS,
                         ids=[f"P{w}-{n}" for w, n in CASE_IDS])
def test_sharded_forces_match_jax(ranks, world, name, x64):
    strategy, backend, dtype, model, fields = FORCE_CASES[world][name]
    got = _stacked(ranks(world), f"force/{name}")
    want = _jax_force(world, strategy, backend, dtype, model,
                      tuple(sorted(fields.items())))
    assert got.shape == want.shape == (N, 3)
    if backend == "tree":
        err = np.abs(got - want).max() / np.abs(want).mean()
        assert err < TREE_TOL, err
    elif backend == "p3m":
        err = np.abs(got - want).max() / np.abs(want).mean()
        assert err < P3M_TOL, err
    elif dtype == "float64":
        pos, m = _inputs(N, 11, np.float64, model)
        bound = F64_TERMS * _sum_abs_terms(pos, m, KW["g"], KW["eps"])
        assert np.all(np.abs(got - want).max(1) <= bound)
    else:
        np.testing.assert_allclose(got, want, **FP32)


def test_mesh_coordinates_are_row_major(ranks):
    coords = [tuple(r["coords"]) for r in ranks(8)]
    assert coords == [divmod(r, 4) for r in range(8)]
    assert [tuple(r["coords"]) for r in ranks(2)] == [(0,), (1,)]


def test_rect_psum_matches_jax(ranks):
    pos, m = _inputs(N, 11, np.float32)
    mesh = jax_mesh((4,))
    state, _ = JaxState(jnp.asarray(pos), jnp.zeros_like(jnp.asarray(pos)),
                        jnp.asarray(m)).pad_to(1004)
    state = jax_shard_state(state, mesh)
    rect = jax_rect(mesh, jax_sim.make_local_kernel(JaxConfig(**KW),
                                                    "dense"))
    want = np.asarray(rect(jnp.asarray(pos[:64]), state.positions,
                           state.masses))
    for r in ranks(4):
        np.testing.assert_allclose(r["rect"], want, **FP32)


def _jax_run(fields: dict, mesh_shape=(4,)):
    pos, vel, m = _run_state()
    cfg = JaxConfig(**{**RUN_CFG, **fields}, mesh_shape=mesh_shape)
    return jax_sim.Simulator(cfg, state=JaxState(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(m))).run()


def _rows_close(got, want, tol):
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(got - want, axis=1)
    assert np.all(err <= tol * np.linalg.norm(want, axis=1)), err.max()


@pytest.mark.parametrize("key,sharding", [("run", "allgather"),
                                          ("run-ring", "ring")])
def test_simulator_run_on_four_ranks_matches_jax(ranks, key, sharding):
    stats = _jax_run(dict(sharding=sharding))
    want = stats["final_state"]
    for r in ranks(4):
        assert int(r[f"{key}/num_devices"]) == 4
        _rows_close(r[f"{key}/positions"], want.positions, RUN_TOL)
        _rows_close(r[f"{key}/velocities"], want.velocities, RUN_TOL)


def test_sharded_merge_conserves_mass_as_jax(ranks):
    stats = _jax_run(dict(sharding="allgather", merge_radius=MERGE_RADIUS,
                          merge_every=5))
    want = np.asarray(stats["final_state"].masses, np.float64)
    _, _, m = _run_state()
    for r in ranks(4):
        got = r["merge/masses"].astype(np.float64)
        assert int(r["merge/merged"]) == stats["merged_pairs"] > 0
        assert abs(got.sum() - m.sum(dtype=np.float64)) <= 1e-6 * m.sum()
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("key", sorted(LEDGER_CASES))
def test_ledger_on_four_ranks_is_the_whole_systems(ranks, key):
    """The drifts of a run on four ranks are those of the same run on one
    process: the ledger's baselines and readings are global."""
    pos, vel, m = _run_state()
    state = ParticleState(*(torch.from_numpy(a) for a in (pos, vel, m)))
    fields = {**LEDGER_CASES[key], "sharding": "none"}
    one = simulation.Simulator(SimulationConfig(**{**RUN_CFG, **fields}),
                               state=state, device="cpu").run()["ledger"]
    assert one["energy_drift"] is not None
    for r in ranks(4):
        for k in LEDGER_KEYS:
            got = float(r[f"{key}/{k}"])
            assert abs(got - one[k]) <= LEDGER_TOL, (k, got, one[k])


@pytest.mark.parametrize("key", sorted(MESH_RUNS))
def test_mesh_runs_on_four_ranks_match_jax_unsharded(ranks, key):
    """Where the JAX package takes the halo slab engine (auto on a
    single-axis mesh of >= 2: nlist, and p3m whose cell grid fits whole
    planes a device) the port takes it too; the sharded integration modes
    step the ranks' rows. Each run against the JAX package's unsharded
    run of the same fields."""
    fields = MESH_RUNS[key]
    want = _jax_run({**fields, "sharding": "none"}, mesh_shape=None)
    final = want["final_state"]
    halo = key.startswith("halo")
    for r in ranks(4):
        assert int(r[f"mesh/{key}/num_devices"]) == 4
        assert int(r[f"mesh/{key}/halo"]) == (4 if halo else 0)
        _rows_close(r[f"mesh/{key}/positions"], final.positions, RUN_TOL)
        _rows_close(r[f"mesh/{key}/velocities"], final.velocities,
                    RUN_TOL)


def test_cli_ring_on_a_two_by_two_mesh(ranks, tmp_path_factory):
    """Every rank exits 0; rank 0 alone wrote the log and the trajectory
    of the 203 real bodies (the frames gathered, the padding dropped)."""
    results = ranks(4)
    assert [int(r["cli/code"]) for r in results] == [0, 0, 0, 0]
    root = tmp_path_factory.getbasetemp()
    logs = sorted(root.glob("world4/cli/simulation_log_*.txt"))
    assert len(logs) == 1, logs
    text = logs[0].read_text()
    assert "Number of devices: 4" in text and "Sharding: ring" in text
    assert "Force cross-check" in text
    frames = sorted(root.glob("world4/cli/trajectories_*/*.npy"))
    assert frames and np.load(frames[0]).shape[-2:] == (203, 3)


def test_one_argument_form_and_layout_helpers(ranks):
    results = ranks(4)
    want = _stacked(results, "force/dense-ring")
    np.testing.assert_allclose(_stacked(results, "accel_fn"), want, **FP32)
    for r, row in zip(results, range(4)):
        assert r["layout"].tolist() == [4, 251 * row, 251 * (row + 1),
                                        1, 1, 1, 1]


# --- in one process: a world of one, the config and the refusals ----------


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_world_of_one_is_the_unsharded_run(world_of_one):
    pos, vel, m = _run_state()
    state = ParticleState(*(torch.from_numpy(a) for a in (pos, vel, m)))
    out = {}
    for sharding in ("none", "allgather", "ring"):
        cfg = SimulationConfig(**{**RUN_CFG, "sharding": sharding,
                                  "force_backend": "pallas"})
        out[sharding] = simulation.Simulator(cfg, state=state,
                                             device="cpu").run()
    for sharding in ("allgather", "ring"):
        assert out[sharding]["num_devices"] == 1
        for f in ("positions", "velocities"):
            assert torch.equal(getattr(out[sharding]["final_state"], f),
                               getattr(out["none"]["final_state"], f))


def test_presets_are_the_jax_packages(world_of_one):
    from gravity_tpu.config import PRESETS as JAX_PRESETS
    from gravity_tpu_torch.config import PRESETS

    assert sorted(PRESETS) == sorted(JAX_PRESETS)
    for name in ("baseline-262k", "baseline-2m-merger"):
        cfg = SimulationConfig.from_json(JAX_PRESETS[name].to_json())
        assert dataclasses.replace(cfg, log_dir=PRESETS[name].log_dir) == \
            PRESETS[name]
    sim = simulation.Simulator(dataclasses.replace(
        PRESETS["baseline-2m-merger"], n=300, steps=2), device="cpu")
    assert (sim.backend, sim.mesh.shape) == (simulation.KERNEL_BACKEND, (1,))


def test_cli_runs_the_sharded_presets(tmp_path, capsys):
    from gravity_tpu_torch.cli import main

    for preset in ("baseline-262k", "baseline-2m-merger"):
        assert main(["run", "--device", "cpu", "--preset", preset, "--n",
                     "256", "--steps", "2", "--mesh-shape", "1",
                     "--log-dir", str(tmp_path)]) == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert stats["sharding"] == ("allgather" if preset == "baseline-262k"
                                     else "ring")
        assert stats["mesh_shape"] == [1] and stats["num_devices"] == 1
    assert not dist.is_initialized()  # the verb leaves the world it joined


def test_ring_refuses_the_fast_solvers(world_of_one):
    for backend in ("tree", "pm", "p3m", "nlist"):
        cfg = SimulationConfig(n=64, force_backend=backend, nlist_rcut=5e10,
                               sharding="ring")
        with pytest.raises(ValueError, match="use sharding='allgather'"):
            simulation.Simulator(cfg, device="cpu")


@pytest.mark.parametrize("fields", [
    dict(force_backend="fmm"), dict(force_backend="sfmm"),
])
def test_later_bullets_of_item_5_are_refused(world_of_one, fields):
    """Item 5's sharded FMM forms are ported: a mesh config loads, and on
    a world of one the sharded run is the unsharded run bit for bit
    (tests/test_torch_sharded_fmm.py holds 2 and 4 ranks)."""
    pos, vel, m = _run_state()
    state = ParticleState(*(torch.from_numpy(a) for a in (pos, vel, m)))
    out = {}
    for sharding in ("none", "allgather"):
        cfg = SimulationConfig(**{**RUN_CFG, "steps": 2, "progress_every": 2,
                                  "sharding": sharding, "tree_depth": 3,
                                  **fields})
        out[sharding] = simulation.Simulator(cfg, state=state,
                                             device="cpu").run()
    assert out["allgather"]["num_devices"] == 1
    for f in ("positions", "velocities"):
        assert torch.equal(getattr(out["allgather"]["final_state"], f),
                           getattr(out["none"]["final_state"], f))


# The integration modes sharded on a world of one: the unsharded run's
# bits (the sharded forms keep the unsharded arithmetic op for op; only
# the fast kick's sum over several ranks would run in another order).
WORLD_OF_ONE_MODES = {
    "multirate": dict(integrator="multirate", multirate_k=64),
    "ladder": dict(integrator="multirate", multirate_k=64,
                   multirate_rungs=3),
    "adaptive": dict(adaptive=True),
    "adaptive-multirate": dict(adaptive=True, integrator="multirate",
                               multirate_k=64),
    "p3m-multirate": dict(integrator="multirate", multirate_k=64,
                          force_backend="p3m", pm_grid=32, p3m_cap=32),
    # The chunked sum's rectangular kernel runs chunk targets at a time
    # (a rank's (n_local, N) block was one dense (n_local, N, 3) tensor).
    "chunked-masked": dict(force_backend="chunked", chunk=256,
                           nlist_rcut=2.0),
}


@pytest.mark.parametrize("key", sorted(WORLD_OF_ONE_MODES))
def test_sharded_modes_on_a_world_of_one_are_the_unsharded_run(
        world_of_one, key):
    pos, vel, m = _run_state()
    state = ParticleState(*(torch.from_numpy(a) for a in (pos, vel, m)))
    out = {}
    for sharding in ("none", "allgather"):
        cfg = SimulationConfig(**{**RUN_CFG, "sharding": sharding,
                                  **WORLD_OF_ONE_MODES[key]})
        out[sharding] = simulation.Simulator(cfg, state=state,
                                             device="cpu").run()
    assert out["allgather"]["num_devices"] == 1
    for f in ("positions", "velocities"):
        assert torch.equal(getattr(out["allgather"]["final_state"], f),
                           getattr(out["none"]["final_state"], f))


def test_halo_strategy_needs_two_devices_and_one_axis(world_of_one):
    """nlist_mesh="halo" is accepted; the slab decomposition needs a
    single-axis mesh of two or more devices (the JAX Simulator's error),
    where auto takes the allgather; the sharded rung ladder under adaptive
    stays refused, as in the JAX package."""
    base = dict(RUN_CFG, sharding="allgather", force_backend="nlist",
                nlist_rcut=1.0, steps=2)
    cfg = SimulationConfig(**{**base, "nlist_mesh": "halo",
                              "nlist_mig_cap": 32})
    assert (cfg.nlist_mesh, cfg.nlist_mig_cap) == ("halo", 32)
    with pytest.raises(ValueError, match="single-axis mesh with >= 2"):
        simulation.Simulator(cfg, device="cpu")
    sim = simulation.Simulator(SimulationConfig(**base), device="cpu")
    assert sim._halo_devices == 0 and sim.nlist_mig_cap is None
    ladder = SimulationConfig(**{**RUN_CFG, "sharding": "allgather",
                                 "adaptive": True,
                                 "integrator": "multirate",
                                 "multirate_rungs": 3, "multirate_k": 64})
    with pytest.raises(ValueError, match="two-rung scheme on a mesh"):
        simulation.Simulator(ladder, device="cpu").run()


def test_checkpoints_and_the_supervisor_need_one_device(monkeypatch):
    """Checkpoints, resume and the supervisor run on a world of more than
    one now: the CLI's world check gives the rank and the world size of a
    launcher's world and refuses nothing
    (tests/test_torch_sharded_checkpoint.py runs them on 2 and 4 ranks)."""
    from gravity_tpu_torch import cli

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    args = cli.argparse.Namespace(distributed=True, device="cpu",
                                  command="run")
    for fields in (dict(checkpoint_every=10), dict(auto_recover=True)):
        assert cli._world(args, SimulationConfig(**fields)) == (1, 2)
    args.command = "resume"
    assert cli._world(args, SimulationConfig()) == (1, 2)


def test_chunked_rectangular_kernel_runs_chunk_targets_at_a_time(
        monkeypatch):
    """The chunked backend's rectangular kernel (a rank's (n_local, N)
    block, a multirate kick) sums ``chunk`` targets at a time, as the
    unsharded chunked sum does; it was one dense (n_local, N, 3) tensor,
    192 GiB for a rank of 262,144 bodies on four cards."""
    from gravity_tpu_torch.ops import forces

    seen = []
    inner = forces.accelerations_vs

    def spy(pos_i, *args, **kwargs):
        seen.append(pos_i.shape[0])
        return inner(pos_i, *args, **kwargs)

    monkeypatch.setattr(forces, "accelerations_vs", spy)
    cfg = SimulationConfig(n=1000, chunk=128, nlist_rcut=2.0, **GALAXY)
    kernel = simulation.make_local_kernel(cfg, "chunked")
    pos, m = _inputs(1000, 3, np.float32, "disk")
    got = kernel(torch.from_numpy(pos[:300]), torch.from_numpy(pos),
                 torch.from_numpy(m))
    assert seen == [128, 128, 44]
    want = inner(torch.from_numpy(pos[:300]), torch.from_numpy(pos),
                 torch.from_numpy(m), rcut=2.0, **GALAXY)
    assert torch.equal(got, want)
