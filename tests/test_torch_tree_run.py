"""The octree backend through the port's entry points against the JAX
package, on the CPU: the Simulator (leapfrog and multirate kicks through
``make_local_kernel("tree")``), the energy diagnostic that prices large
tree and p3m runs with the tree potential, the config fields and the CLI.

States are drawn with numpy from a seed and given to both packages
through ``interop.state_from_numpy``. Tolerances: 1e-5 per particle after
<= 5 steps in fp32, as the other run tests; the fast kick 1e-5 of the
mean |a|; the energy 1e-5 of KE + |PE| (the two nearly cancel).
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu import simulation as jax_simulation
from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.ops import tree as jax_tree
from gravity_tpu.simulation import Simulator as JaxSimulator
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch import simulation
from gravity_tpu_torch.cli import _add_config_args, build_config
from gravity_tpu_torch.config import PRESETS, NotPortedError, SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy, state_to_numpy
from gravity_tpu_torch.ops import diagnostics
from gravity_tpu_torch.simulation import Simulator, make_local_kernel

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _disk(n, seed=0, dtype=np.float32):
    """A thin exponential disk (scale length 3, height 0.3) of mass 5
    around a unit point mass at the origin, with circular velocities."""
    rng = np.random.default_rng(seed)
    r = rng.exponential(3.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    pos = np.stack([r * np.cos(phi), r * np.sin(phi),
                    0.3 * rng.normal(size=n)], axis=1)
    v = np.sqrt(6.0 / np.maximum(r, 0.1))
    vel = np.stack([-v * np.sin(phi), v * np.cos(phi),
                    0.01 * rng.normal(size=n)], axis=1)
    masses = np.full(n, 5.0 / (n - 1))
    pos[0], vel[0], masses[0] = 0.0, 0.0, 1.0
    return pos.astype(dtype), vel.astype(dtype), masses.astype(dtype)


def _max_over_mean(got, want):
    want = np.asarray(want, np.float64)
    scale = np.linalg.norm(want, axis=1).mean()
    return np.abs(np.asarray(got, np.float64) - want).max() / scale


# --- the Simulator ---------------------------------------------------------


def _rows_close(got, want, rtol):
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(np.asarray(got, np.float64) - want, axis=1)
    return bool(np.all(err <= rtol * np.linalg.norm(want, axis=1) + 1e-12))


@pytest.mark.parametrize("near", ["gather", "nlist"])
def test_simulator_tree_matches_jax(near):
    """5 leapfrog steps of a 1024-body disk through both Simulators at
    depth 4, leaf_cap 16 (the central leaves overflow). Without
    ``tree_depth`` both fit the same depth to the state."""
    pos, vel, masses = _disk(1024, seed=8)
    common = dict(model="disk", n=1024, steps=5, integrator="leapfrog",
                  force_backend="tree", tree_leaf_cap=16, tree_near=near,
                  dt=2e-3, progress_every=5, g=1.0, eps=0.05)
    auto = Simulator(SimulationConfig(**common),
                     state_from_numpy(pos, vel, masses, device="cpu"),
                     device="cpu")
    assert auto.tree_depth == jax_tree.recommended_depth_data(pos, 16) == 5
    common["tree_depth"] = 4
    jax_final = JaxSimulator(
        JaxConfig(**common),
        state=JaxState(jnp.asarray(pos), jnp.asarray(vel),
                       jnp.asarray(masses)),
    ).run()["final_state"]
    sim = Simulator(SimulationConfig(**common),
                    state_from_numpy(pos, vel, masses, device="cpu"),
                    device="cpu")
    assert sim.backend == "tree" and sim.tree_depth == 4
    stats = sim.run()
    got_pos, got_vel, _ = state_to_numpy(stats["final_state"])
    assert _rows_close(got_pos, jax_final.positions, 1e-5)
    assert _rows_close(got_vel, jax_final.velocities, 1e-5)
    assert stats["kernel_launches"] == 0  # the CPU runs the plain tiles
    assert (stats["tree_depth"], stats["tree_leaf_cap"],
            stats["tree_near"]) == (sim.tree_depth, 16, near)


def test_multirate_kick_through_the_tree_matches_jax():
    """make_local_kernel("tree"), the multirate fast kick (K targets
    against all N sources), against the JAX package's; then 3 two-rung
    steps through both Simulators."""
    pos, vel, masses = _disk(1024, seed=9)
    common = dict(model="disk", n=1024, steps=3, integrator="multirate",
                  multirate_k=64, force_backend="tree", tree_depth=4,
                  tree_leaf_cap=16, tree_near="nlist", dt=2e-3,
                  progress_every=3, g=1.0, eps=0.05)
    cfg = SimulationConfig(**common)
    kick = make_local_kernel(cfg, "tree", positions=torch.from_numpy(pos),
                             k_targets=64)
    jax_kick = jax_simulation.make_local_kernel(JaxConfig(**common), "tree",
                                                positions=pos, k_targets=64)
    idx = np.random.default_rng(9).choice(1024, 64, replace=False)
    got = kick(torch.from_numpy(pos[idx]), torch.from_numpy(pos),
               torch.from_numpy(masses)).numpy()
    want = np.asarray(jax_kick(jnp.asarray(pos[idx]), jnp.asarray(pos),
                               jnp.asarray(masses)))
    assert _max_over_mean(got, want) < 1e-5

    jax_final = JaxSimulator(
        JaxConfig(**common),
        state=JaxState(jnp.asarray(pos), jnp.asarray(vel),
                       jnp.asarray(masses)),
    ).run()["final_state"]
    stats = Simulator(cfg, state_from_numpy(pos, vel, masses, device="cpu"),
                      device="cpu").run()
    got_pos, got_vel, _ = state_to_numpy(stats["final_state"])
    assert _rows_close(got_pos, jax_final.positions, 1e-5)
    assert _rows_close(got_vel, jax_final.velocities, 1e-5)


@pytest.mark.parametrize("backend", ["tree", "p3m"])
def test_energy_prices_large_runs_with_the_tree_potential(backend,
                                                          monkeypatch):
    """Above the threshold (lowered here to 512 bodies in both packages) a
    tree or p3m run's energy is KE in float64 plus the tree potential, a
    host float64, as the JAX Simulator's on the CPU platform."""
    monkeypatch.setattr(simulation, "ENERGY_TREE_THRESHOLD", 512)
    monkeypatch.setattr(jax_simulation, "ENERGY_TREE_THRESHOLD", 512)
    pos, vel, masses = _disk(1024, seed=10)
    common = dict(model="disk", n=1024, force_backend=backend, g=1.0,
                  eps=0.05, pm_grid=32, p3m_cap=16, tree_depth=4,
                  tree_leaf_cap=16)
    got = Simulator(SimulationConfig(**common),
                    state_from_numpy(pos, vel, masses, device="cpu"),
                    device="cpu").energy()
    want = JaxSimulator(
        JaxConfig(**common),
        state=JaxState(jnp.asarray(pos), jnp.asarray(vel),
                       jnp.asarray(masses)),
    ).energy()
    assert isinstance(got, np.float64)
    # KE and PE nearly cancel: the rounding is measured against their
    # magnitudes.
    ke = diagnostics.kinetic_energy_f64(state_from_numpy(pos, vel, masses,
                                                         device="cpu"))
    scale = ke + abs(got - ke)
    assert abs(got - float(want)) <= 1e-5 * scale
    # Below the threshold the dense pair scan stays.
    monkeypatch.setattr(simulation, "ENERGY_TREE_THRESHOLD", 16_384)
    dense = Simulator(SimulationConfig(**common),
                      state_from_numpy(pos, vel, masses, device="cpu"),
                      device="cpu").energy()
    assert isinstance(dense, torch.Tensor)
    assert float(dense) == float(diagnostics.total_energy(
        state_from_numpy(pos, vel, masses, device="cpu"), g=1.0, eps=0.05))


def test_tree_config_round_trips_through_the_jax_config():
    fields = dict(force_backend="tree", tree_depth=6, tree_leaf_cap=64,
                  tree_ws=2, tree_far="expansion", tree_near="gather")
    cfg = SimulationConfig.from_json(JaxConfig(**fields).to_json())
    for name, value in fields.items():
        assert getattr(cfg, name) == value
    assert json.loads(cfg.to_json())["tree_near"] == "gather"
    assert SimulationConfig.from_json(cfg.to_json()) == cfg


def test_tree_flags_parse_into_the_config():
    import argparse

    parser = argparse.ArgumentParser()
    _add_config_args(parser)
    args = parser.parse_args([
        "--preset", "baseline-1m", "--tree-near", "nlist", "--tree-depth",
        "6", "--tree-leaf-cap", "64", "--tree-ws", "1", "--tree-far",
        "expansion", "--fast-chunk", "2048",
    ])
    cfg = build_config(args)
    assert (cfg.force_backend, cfg.n, cfg.model) == ("tree", 1 << 20, "disk")
    assert (cfg.tree_near, cfg.tree_depth, cfg.tree_leaf_cap, cfg.tree_ws,
            cfg.tree_far, cfg.fast_chunk) == ("nlist", 6, 64, 1,
                                              "expansion", 2048)
    assert build_config(parser.parse_args(
        ["--preset", "baseline-1m"])).tree_near == "gather"
    for bad in (["--tree-near", "tiles"], ["--tree-far", "fmm"]):
        with pytest.raises(SystemExit):
            parser.parse_args(bad)


def test_tree_config_refusals():
    # A bf16 state runs through the octree, both near fields.
    for near in ("gather", "nlist"):
        cfg = SimulationConfig(force_backend="tree", tree_near=near,
                               dtype="bfloat16")
        assert (cfg.dtype, cfg.tree_near) == ("bfloat16", near)
    # The tile engine takes the 27-cell stencil only: the config is the
    # JAX package's, and the evaluation refuses it as JAX's does.
    cfg = SimulationConfig(model="disk", n=64, steps=1, g=1.0, eps=0.05,
                           force_backend="tree", tree_near="nlist",
                           tree_ws=2)
    with pytest.raises(ValueError, match="ws=1") as e:
        Simulator(cfg, device="cpu").run()
    assert not isinstance(e.value, NotPortedError)
    for name, value in (("tree_far", "multipole"), ("tree_near", "tiles"),
                        ("tree_leaf_cap", 0), ("tree_ws", 0),
                        ("tree_depth", -1)):
        with pytest.raises(ValueError, match=name):
            SimulationConfig(force_backend="tree", **{name: value})
    # The gather near field takes wider neighborhoods.
    SimulationConfig(force_backend="tree", tree_ws=2)
    assert PRESETS["baseline-1m"].force_backend == "tree"


def test_cli_runs_the_tree_on_cpu(tmp_path):
    """The README's CPU command, cut to 2 steps at N = 1024 (depth fit to
    the state: 4), in both near modes; --tree-ws 2 with the tile engine
    fails with the JAX package's ValueError."""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "gravity_tpu_torch", "run", "--device",
            "cpu", "--model", "disk", "--n", "1024", "--g", "1.0", "--dt",
            "2e-3", "--eps", "0.05", "--force-backend", "tree",
            "--integrator", "leapfrog", "--steps", "2", "--log-dir",
            str(tmp_path)]
    for near in ("nlist", "gather"):
        proc = subprocess.run(base + ["--tree-near", near], cwd=REPO_ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr
        stats = json.loads(proc.stdout.strip().splitlines()[-1])
        assert stats["backend"] == "tree" and stats["tree_near"] == near
        assert (stats["tree_depth"], stats["tree_leaf_cap"]) == (4, 32)
        assert stats["kernel_launches"] == 0
    proc = subprocess.run(base + ["--tree-near", "nlist", "--tree-ws", "2"],
                          cwd=REPO_ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and "ValueError" in proc.stderr
    assert "ws=1" in proc.stderr
