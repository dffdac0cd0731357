"""The host-native C++ direct sum (``force_backend="cpp"``) on the CPU.

``gravity_tpu_torch/csrc/host_forces.cpp`` is the JAX package's
``runtime/ffi_forces.cpp`` row sum with a plain C interface, built by the
port's own g++ call. The cases mirror ``tests/test_ffi_forces.py`` one for
one and hold the port against the JAX package on the same numpy-seeded
inputs:

- the same loop under the same flags gives the same bits: float64 and
  float32 against ``ffi_accelerations_vs`` with ``assert_array_equal``
  (skipped, as the JAX file skips, where the JAX library does not build);
- against the plain sum, the JAX file's bars: 1e-12 relative in float64
  (1e-11 with softening: 1/sqrt against rsqrt, ~1 ulp, amplified by the
  row sums' cancellation), and in float32 rtol 3e-4 with an atol of 3e-4
  of the largest row;
- the gradient through the dense backward: rtol 5e-4 of the plain
  gradient (``tests/test_differentiability.py:347``);
- a Simulator run against ``dense``: rtol 1e-5 on the positions (the JAX
  file's bar), and against the JAX package's ``cpp`` run of the same
  initial state: the same bits (the same row sum, and the two packages'
  Euler steps round alike);
- the sharded local kernel on 2 gloo ranks: every row the unsharded bits
  (each rank sums its rows over every source in source order; the padded
  source has mass 0 and adds a zero), and within F64_TERMS of each row's
  sum of |terms| for the ring, whose hops sum the sources in other groups.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from gravity_tpu import simulation as jax_sim
from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.ops.forces import (
    pairwise_accelerations_dense as jax_dense,
)
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch import parallel, simulation
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy, state_to_numpy
from gravity_tpu_torch.ops import host_kernel
from gravity_tpu_torch.ops.forces import (
    accelerations_vs,
    pairwise_accelerations_dense,
)
from gravity_tpu_torch.ops.host_kernel import (
    host_accelerations_vs,
    host_forces_available,
    host_pairwise_accelerations,
    make_host_local_kernel,
)
from gravity_tpu_torch.state import ParticleState
from gravity_tpu_torch.utils import faults as fmod
from gravity_tpu_torch.utils.faults import BackendUnavailable

pytestmark = pytest.mark.skipif(
    not host_forces_available(),
    reason="the host-native C++ direct sum did not build (no g++?)",
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(g=6.674e-11, eps=1e9)
F64_TERMS = 1e-12
N_MESH = 1001  # odd: the 2-rank mesh pads one body
RUN_N = 4100  # above DENSE_MAX_N: the static route takes cpp
SPAWN_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_ffi():
    """The JAX package's kernel entry, or a skip where it does not build
    (as ``tests/test_ffi_forces.py`` skips)."""
    from gravity_tpu.ops import ffi_forces

    if not ffi_forces.ffi_forces_available():
        pytest.skip("the JAX package's FFI kernel is unavailable")
    return ffi_forces.ffi_accelerations_vs


def _random_system(n: int, dtype, seed: int = 0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3e11, 3e11, (n, 3)).astype(dtype)
    masses = rng.uniform(1e23, 1e25, n).astype(dtype)
    return pos, masses


def _sum_abs_terms(pos, m, g, eps):
    """Each row's sum of |terms| |G m_j d_ij / r^3|, float64."""
    d = pos[None, :, :] - pos[:, None, :]
    r2 = (d * d).sum(-1) + eps * eps
    np.fill_diagonal(r2, np.inf)
    w = g * m[None, :] / (r2 * np.sqrt(r2))
    return (w[..., None] * np.abs(d)).sum(1).max(1)


def _host(pos, masses, targets=None, **kw):
    t = torch.from_numpy(pos)
    ti = t if targets is None else torch.from_numpy(targets)
    return host_accelerations_vs(ti, t, torch.from_numpy(masses),
                                 **kw).numpy()


# --- the row sum against the JAX kernel and the plain sum ------------------


@pytest.mark.parametrize("eps", [0.0, 1e9])
def test_fp64_bits_equal_jax_ffi(x64, eps):
    pos, masses = _random_system(321, np.float64)
    got = _host(pos, masses, eps=eps)
    want = np.asarray(_jax_ffi()(jnp.asarray(pos), jnp.asarray(pos),
                                 jnp.asarray(masses), eps=eps))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    plain = pairwise_accelerations_dense(torch.from_numpy(pos),
                                         torch.from_numpy(masses),
                                         eps=eps).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-12 if eps == 0 else 1e-11)


def test_fp32_bits_equal_jax_ffi_and_within_the_jax_bar():
    pos, masses = _random_system(321, np.float32)
    got = _host(pos, masses)
    want = np.asarray(_jax_ffi()(jnp.asarray(pos), jnp.asarray(pos),
                                 jnp.asarray(masses)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for dense in (np.asarray(jax_dense(jnp.asarray(pos),
                                       jnp.asarray(masses))),
                  pairwise_accelerations_dense(
                      torch.from_numpy(pos),
                      torch.from_numpy(masses)).numpy()):
        np.testing.assert_allclose(got, dense, rtol=3e-4,
                                   atol=float(np.abs(dense).max()) * 3e-4)


def test_rectangular_targets_sources(x64):
    """The vs form with M != K (a rank's block, a fast kick)."""
    pos, masses = _random_system(96, np.float64, seed=1)
    targets = pos[:32].copy()
    got = _host(pos, masses, targets=targets)
    assert got.shape == (32, 3)
    want = accelerations_vs(torch.from_numpy(targets), torch.from_numpy(pos),
                            torch.from_numpy(masses)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_array_equal(got, np.asarray(_jax_ffi()(
        jnp.asarray(targets), jnp.asarray(pos), jnp.asarray(masses))))
    # Empty target or source sets.
    assert _host(pos, masses, targets=pos[:0].copy()).shape == (0, 3)
    empty = host_accelerations_vs(torch.from_numpy(targets),
                                  torch.zeros(0, 3, dtype=torch.float64),
                                  torch.zeros(0, dtype=torch.float64))
    assert torch.equal(empty, torch.zeros(32, 3, dtype=torch.float64))


@pytest.mark.parametrize("eps", [0.0, 1e9])
def test_softening_and_cutoff_semantics(eps):
    """eps folds into r^2 before the cutoff test, as in the plain sum: a
    coincident pair is cut at eps = 0 and counted once softened."""
    pos, masses = _random_system(64, np.float64, seed=2)
    pos[1] = pos[0]
    got = _host(pos, masses, eps=eps)
    want = pairwise_accelerations_dense(torch.from_numpy(pos),
                                        torch.from_numpy(masses),
                                        eps=eps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11)
    assert np.isfinite(got).all()
    # The cutoff on the softened r^2: a pair at 5e8 m inside cutoff 1e9
    # is cut at eps = 0 and kept at eps = 2e9 (r^2 + eps^2 > cutoff^2).
    two = np.array([[0.0, 0.0, 0.0], [5e8, 0.0, 0.0]])
    m2 = np.array([1e24, 1e24])
    cut = _host(two, m2, cutoff=1e9)
    kept = _host(two, m2, cutoff=1e9, eps=2e9)
    assert np.all(cut == 0.0) and kept[0, 0] > 0.0 > kept[1, 0]
    np.testing.assert_allclose(kept, accelerations_vs(
        torch.from_numpy(two), torch.from_numpy(two), torch.from_numpy(m2),
        cutoff=1e9, eps=2e9).numpy(), rtol=1e-15)


def test_fp32_factor_order_keeps_light_distant_pairs():
    """The fp32 underflow hazard that ``tests/test_torch_forces.py`` pins
    for the plain sum: at r ~ 1e16 m inv_r^3 = 1e-48 is below fp32's least
    subnormal, so cubing 1/r first would drop these pairs; the weight
    ((G m) inv_r) inv_r inv_r lies at ~1e-36, near the subnormal range,
    and every factor on the way stays normal. The C++ row sum and the
    plain sum give the same nonzero row, within a few fp32 ulps of the
    float64 sum (1/sqrt against rsqrt)."""
    rng = np.random.default_rng(7)
    src = rng.uniform(-1.0, 1.0, (16, 3))
    src = 1e16 * src / np.linalg.norm(src, axis=1, keepdims=True) * \
        rng.uniform(1.0, 2.0, (16, 1))
    pos = np.vstack([np.zeros((1, 3)), src]).astype(np.float32)
    masses = np.concatenate([[1e20], rng.uniform(5e21, 5e22, 16)]).astype(
        np.float32)
    inv_r = 1.0 / np.linalg.norm(pos[1:].astype(np.float64), axis=1)
    assert np.all(inv_r ** 3 < 1.4e-45)  # inv_r^3 alone is fp32 zero
    w = 6.674e-11 * masses[1:].astype(np.float64) * inv_r ** 3
    assert np.all((w > 1.2e-38) & (w < 1e-34))  # normal, near subnormal
    got = _host(pos, masses, targets=pos[:1].copy())
    plain = accelerations_vs(torch.from_numpy(pos[:1]), torch.from_numpy(pos),
                             torch.from_numpy(masses)).numpy()
    exact = accelerations_vs(torch.from_numpy(pos[:1]).double(),
                             torch.from_numpy(pos).double(),
                             torch.from_numpy(masses).double()).numpy()
    assert np.all(np.abs(got) > 0.0)
    np.testing.assert_allclose(got, plain, rtol=1e-6)
    np.testing.assert_allclose(got, exact, rtol=1e-6)


def test_refusals_raise_before_any_build(monkeypatch):
    """A CUDA or meta device, bf16 and mixed dtypes raise ValueError, as
    the JAX kernel's InvalidArgument, without asking for the library."""
    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(host_kernel, "host_forces_available", no_build)
    monkeypatch.setattr(host_kernel.LIBRARY, "load", no_build)
    cfg = SimulationConfig(n=64, force_backend="cpp")
    for device in ("cuda", "cuda:0", None, "meta"):
        with pytest.raises(ValueError, match="--device cpu"):
            simulation.make_local_kernel(cfg, "cpp", device=device)
    bf16 = SimulationConfig(n=64, force_backend="cpp", dtype="bfloat16")
    with pytest.raises(ValueError, match="float32/float64"):
        simulation.make_local_kernel(bf16, "cpp", device="cpu")
    with pytest.raises(ValueError, match="float32/float64"):
        simulation.Simulator(bf16, device="cpu")
    meta = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="runs on the CPU"):
        host_accelerations_vs(meta, meta, torch.zeros(4, device="meta"))
    f32 = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="mixed dtypes"):
        host_accelerations_vs(f32, f32.double(), torch.zeros(4).double())
    with pytest.raises(ValueError, match="float32 or float64"):
        host_pairwise_accelerations(f32.bfloat16(),
                                    torch.zeros(4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="expected pos_i"):
        host_accelerations_vs(f32, f32, torch.zeros(3))


def test_unbuildable_library_raises_backend_unavailable(monkeypatch):
    monkeypatch.setattr(host_kernel, "host_forces_available", lambda: False)
    cfg = SimulationConfig(n=64, force_backend="cpp")
    with pytest.raises(BackendUnavailable, match="'cpp'"):
        simulation.make_local_kernel(cfg, "cpp", device="cpu")
    with pytest.raises(BackendUnavailable):
        simulation.Simulator(cfg, device="cpu")
    # The static route does not take what cannot build.
    assert simulation._resolve_backend(
        SimulationConfig(n=8192), torch.device("cpu")) == "chunked"


def test_gradient_through_the_local_kernel_matches_the_plain_gradient():
    """The dense backward (DenseVJP), as JAX's make_ffi_local_kernel goes
    through wrap_with_dense_vjp; the forward itself is forward only."""
    pos, masses = _random_system(64, np.float32, seed=3)
    m = torch.from_numpy(masses)

    def grad_of(kernel):
        p = torch.from_numpy(pos).requires_grad_(True)
        (kernel(p, p, m) ** 2).sum().backward()
        return p.grad.numpy()

    before = host_kernel.LAUNCHES
    g_cpp = grad_of(make_host_local_kernel())
    assert host_kernel.LAUNCHES == before + 1  # the backward calls none
    g_ref = grad_of(lambda ti, sj, mj: accelerations_vs(ti, sj, mj))
    np.testing.assert_allclose(g_cpp, g_ref, rtol=5e-4)
    from gravity_tpu_torch.ops.forces import NoBackwardError

    p = torch.from_numpy(pos).requires_grad_(True)
    with pytest.raises(NoBackwardError):
        host_accelerations_vs(p, p, m)


# --- routing ---------------------------------------------------------------


@pytest.mark.parametrize("n", [64, 4096, 4097, 1_000_000])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("rcut", [0.0, 1e11])
def test_static_route_on_the_cpu_matches_jax(n, dtype, rcut):
    """cpp exactly where the JAX package's CPU route takes it (both
    libraries built here); the masked plain sum under declared truncated
    physics; the card's route unchanged, pinned without a card."""
    from gravity_tpu.ops.ffi_forces import ffi_forces_available

    kw = dict(n=n, dtype=dtype, nlist_rcut=rcut, force_backend="direct")
    port = simulation._resolve_direct(SimulationConfig(**kw), False)
    if ffi_forces_available():
        assert port == jax_sim._resolve_direct(JaxConfig(**kw), False)
    plain = "dense" if n <= 4096 else "chunked"
    big = n > 4096 and rcut == 0.0 and dtype != "bfloat16"
    assert port == ("cpp" if big else plain)
    cuda = torch.device("cuda", 0)
    assert simulation._resolve_backend(SimulationConfig(**kw), cuda) == (
        plain if rcut > 0.0 else simulation.KERNEL_BACKEND)
    if rcut == 0.0:
        assert simulation._resolve_backend(
            SimulationConfig(**{**kw, "force_backend": "cpp"}),
            torch.device("cpu")) == "cpp"


# --- the Simulator, the CLI, the supervisor, the autotuner ------------------


def _initial_state(n: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3e11, 3e11, (n, 3)).astype(np.float32)
    vel = rng.uniform(-3e4, 3e4, (n, 3)).astype(np.float32)
    masses = rng.uniform(1e23, 1e25, n).astype(np.float32)
    return pos, vel, masses


def test_simulator_cpp_backend_matches_dense_and_jax():
    pos, vel, masses = _initial_state(48)
    base = dict(model="random", n=48, steps=25, seed=3, progress_every=25)

    def port(backend):
        sim = simulation.Simulator(
            SimulationConfig(force_backend=backend, **base),
            state_from_numpy(pos, vel, masses, device="cpu"), device="cpu")
        before = host_kernel.LAUNCHES
        stats = sim.run()
        return sim, stats, host_kernel.LAUNCHES - before

    sim, stats, launches = port("cpp")
    assert sim.backend == stats["backend"] == "cpp"
    # One call an evaluation: the initial one and one a step.
    assert launches == stats["kernel_launches"] == 26
    got = state_to_numpy(stats["final_state"])[0]
    ref = state_to_numpy(port("dense")[1]["final_state"])[0]
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    _jax_ffi()
    want = np.asarray(jax_sim.Simulator(
        JaxConfig(force_backend="cpp", **base),
        state=JaxState(jnp.asarray(pos), jnp.asarray(vel),
                       jnp.asarray(masses)),
    ).run()["final_state"].positions)
    np.testing.assert_array_equal(got, want)


def test_cli_run_names_cpp(tmp_path):
    """``run --device cpu --force-backend cpp`` at 8,192 bodies, and
    ``direct`` there takes it too."""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1")
    for backend in ("cpp", "direct"):
        proc = subprocess.run(
            [sys.executable, "-m", "gravity_tpu_torch", "run", "--device",
             "cpu", "--model", "random", "--n", "8192", "--steps", "5",
             "--force-backend", backend, "--log-dir", str(tmp_path)],
            cwd=REPO_ROOT, env=env, capture_output=True, text=True,
            timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        stats = json.loads(proc.stdout.strip().splitlines()[-1])
        assert stats["backend"] == "cpp" and stats["kernel_launches"] == 6
        assert stats["n"] == 8192 and stats["steps"] == 5


@pytest.fixture
def port_faults(monkeypatch):
    def install(spec: str):
        monkeypatch.setenv(fmod.ENV_KNOB, spec)
        return fmod.install(spec)

    yield install
    fmod.reset()


def _sup(cfg, tmp_path):
    from gravity_tpu_torch.supervisor import RunSupervisor
    from gravity_tpu_torch.utils.checkpoint import make_checkpoint_manager
    from gravity_tpu_torch.utils.logging import RecoveryEventLogger

    events = RecoveryEventLogger(str(tmp_path / "recovery.jsonl"))
    mgr = make_checkpoint_manager(str(tmp_path / "ckpt"), max_to_keep=10)
    return RunSupervisor(cfg, events=events, checkpoint_manager=mgr,
                         device="cpu"), events


@pytest.mark.parametrize("cause", ["fault", "build"])
def test_supervisor_degrades_cpp_to_chunked(port_faults, monkeypatch,
                                            tmp_path, cause):
    """``backend:cpp`` and a library that does not build both degrade the
    run to the plain ``chunked`` sum (tests/test_supervisor.py:139-147)."""
    from gravity_tpu_torch.supervisor import next_rung

    if cause == "fault":
        port_faults("backend:cpp")
    else:
        monkeypatch.setattr(host_kernel, "host_forces_available",
                            lambda: False)
    cfg = SimulationConfig(model="random", n=32, steps=40, dt=3600.0, seed=3,
                           force_backend="cpp", progress_every=10)
    sup, events = _sup(cfg, tmp_path)
    stats = sup.run()
    assert stats["supervisor"]["backend"] == "chunked"
    assert stats["supervisor"]["degraded_from"] == "cpp"
    degr = [e for e in events.read() if e["event"] == "degraded"]
    assert [(d["from_backend"], d["to_backend"]) for d in degr] == [
        ("cpp", "chunked")]
    assert np.isfinite(stats["final_state"].positions.numpy()).all()
    assert next_rung("cpp") == "chunked"
    assert next_rung("cpp", on_card=True) is None


def test_cli_auto_recover_degrades_cpp_with_exit_0(port_faults, tmp_path,
                                                   capsys):
    from gravity_tpu_torch.cli import main

    port_faults("backend:cpp")
    rc = main(["run", "--device", "cpu", "--model", "random", "--n", "32",
               "--steps", "20", "--force-backend", "cpp", "--auto-recover",
               "--checkpoint-dir", str(tmp_path / "ck"), "--log-dir",
               str(tmp_path / "logs")])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["supervisor"]["backend"] == "chunked"


def test_autotune_probes_and_caches_cpp(monkeypatch, tmp_path):
    """The CPU contest above 4,096 bodies carries cpp as its direct member:
    probed on a miss, the verdict cached, a hit on the second call."""
    from gravity_tpu_torch import autotune

    monkeypatch.setenv("GRAVITY_TPU_TUNE_DIR", str(tmp_path / "tune"))
    autotune._mem_cache.clear()
    cfg = SimulationConfig(model="plummer", n=4104, eps=1e9,
                           integrator="leapfrog")
    cands, _ = autotune.eligible_candidates(cfg, False)
    assert cands[0] == "cpp"
    state = simulation.make_initial_state(cfg, "cpu")
    before = host_kernel.LAUNCHES
    d = autotune.resolve_backend_measured(cfg, state, device="cpu",
                                          candidates=("cpp", "chunked"))
    assert d.cache == "miss" and set(d.timings_s) == {"cpp", "chunked"}
    assert host_kernel.LAUNCHES > before
    assert d.backend == min(d.timings_s, key=d.timings_s.get)
    again = autotune.resolve_backend_measured(cfg, state, device="cpu",
                                              candidates=("cpp", "chunked"))
    assert again.cache == "hit" and again.backend == d.backend


# --- the sharded local kernel on gloo ranks -------------------------------


def _rank_main(rank: int, world: int, out_dir: str) -> None:
    """One rank: join the FileStore world, take the sharded direct sums
    over the cpp local kernel, and run a Simulator whose static route
    takes cpp on the world; save this rank's rows."""
    with open(os.path.join(out_dir, f"rank{rank}.log"), "w") as log:
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
        rank=rank, world_size=world)
    mesh = parallel.make_particle_mesh((world,), device="cpu")
    pos, masses = _random_system(N_MESH, np.float64, seed=11)
    state = ParticleState(torch.from_numpy(pos),
                          torch.zeros(N_MESH, 3, dtype=torch.float64),
                          torch.from_numpy(masses))
    local = simulation.make_local_kernel(
        SimulationConfig(n=N_MESH, dtype="float64", **KW), "cpp",
        device="cpu")
    mine = parallel.shard_state(state, mesh)
    out = {}
    for strategy in ("allgather", "ring"):
        fn = parallel.make_sharded_accel2(mesh, strategy=strategy,
                                          local_kernel=local)
        out[f"force/{strategy}"] = fn(mine.positions, mine.masses).numpy()
    before = host_kernel.LAUNCHES
    sim = simulation.Simulator(SimulationConfig(**_run_fields(
        sharding="allgather")), device="cpu")
    stats = sim.run()
    out["run/backend"] = np.array(sim.backend)
    out["run/launches"] = np.array(host_kernel.LAUNCHES - before)
    out["run/positions"] = stats["final_state"].positions.numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def _run_fields(**extra):
    return dict(model="random", n=RUN_N, steps=2, integrator="leapfrog",
                dtype="float64", force_backend="direct", progress_every=1,
                **KW, **extra)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("host_world2")
    ctx = tmp.start_processes(_rank_main, args=(2, str(out_dir)), nprocs=2,
                              join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                logs = "\n".join(
                    (out_dir / f"rank{r}.log").read_text()[-2000:]
                    for r in range(2)
                    if (out_dir / f"rank{r}.log").exists())
                raise TimeoutError(f"2 ranks still running after "
                                   f"{SPAWN_TIMEOUT_S} s:\n{logs}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(2)]


def _stacked(ranks, key, n):
    return np.concatenate([r[key] for r in ranks])[:n]


def test_sharded_allgather_local_kernel_gives_the_unsharded_bits(two_ranks,
                                                                 x64):
    pos, masses = _random_system(N_MESH, np.float64, seed=11)
    solo = _host(pos, masses, **KW)
    got = _stacked(two_ranks, "force/allgather", N_MESH)
    np.testing.assert_array_equal(got, solo)
    np.testing.assert_array_equal(got, np.asarray(_jax_ffi()(
        jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(masses), **KW)))
    ring = _stacked(two_ranks, "force/ring", N_MESH)
    bound = F64_TERMS * _sum_abs_terms(pos, masses, KW["g"], KW["eps"])
    assert np.all(np.abs(ring - solo).max(1) <= bound)


def test_sharded_run_takes_cpp_on_the_world(two_ranks):
    """direct above DENSE_MAX_N on 2 gloo ranks: cpp is the local kernel,
    one call a rank an evaluation, and the run gives the solo run's
    bits."""
    assert [str(r["run/backend"]) for r in two_ranks] == ["cpp", "cpp"]
    assert [int(r["run/launches"]) for r in two_ranks] == [3, 3]
    sim = simulation.Simulator(SimulationConfig(**_run_fields()),
                               device="cpu")
    assert sim.backend == "cpp"
    solo = sim.run()["final_state"].positions.numpy()
    got = two_ranks[0]["run/positions"]
    assert got.shape == solo.shape == (RUN_N, 3)
    np.testing.assert_array_equal(got, solo)
    assert math.isfinite(float(np.abs(got).max()))
