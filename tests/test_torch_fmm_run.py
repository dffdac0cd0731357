"""The FMM backends (``fmm`` in both layouts, ``sfmm``) through the port's
entry points against the JAX package, on the CPU: the Simulator (leapfrog
and multirate kicks through ``make_local_kernel("fmm")``), the layout
resolution and sizing, the energy diagnostic's and the ledger's FMM
potential, the config and the CLI, the supervisor's accuracy heal and the
router's candidates.

States are drawn with numpy from a seed and given to both packages
through ``interop.state_from_numpy``. Tolerances: 1e-5 per particle after
<= 3 steps in fp32, as the other run tests; a fast kick's rows median
relative < 1e-5 and max < 1e-3 (the summation-order bars of
tests/test_torch_fmm.py); the potential 1e-5 relative; the FMM and octree
potentials within 0.05 of each other (``tests/test_fmm.py:382-398``).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu import simulation as jax_simulation
from gravity_tpu.config import PRESETS as JAX_PRESETS
from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.ops import fmm as jax_fmm
from gravity_tpu.ops import sfmm as jax_sfmm
from gravity_tpu.simulation import Simulator as JaxSimulator
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch import simulation
from gravity_tpu_torch.autotune import eligible_candidates, make_key
from gravity_tpu_torch.cli import main
from gravity_tpu_torch.config import PRESETS, SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy, state_to_numpy
from gravity_tpu_torch.ops import diagnostics
from gravity_tpu_torch.simulation import Simulator, make_local_kernel
from gravity_tpu_torch.supervisor import RunSupervisor
from gravity_tpu_torch.utils.logging import RecoveryEventLogger


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


def _rows_close(got, want, rtol):
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(np.asarray(got, np.float64) - want, axis=1)
    return bool(np.all(err <= rtol * np.linalg.norm(want, axis=1) + 1e-12))


def _both(common, seed):
    """(port Simulator, JAX Simulator) of one config on one numpy disk."""
    pos, vel, masses = _disk(common["n"], seed)
    jax_sim = JaxSimulator(JaxConfig(**common), state=JaxState(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(masses)))
    sim = Simulator(SimulationConfig(**common),
                    state_from_numpy(pos, vel, masses, device="cpu"),
                    device="cpu")
    return sim, jax_sim


LEAPFROG = dict(model="disk", n=1024, steps=3, integrator="leapfrog",
                dt=2e-3, progress_every=3, g=1.0, eps=0.05)


@pytest.mark.parametrize("fields", [
    dict(force_backend="fmm", fmm_mode="dense", tree_depth=4,
         tree_leaf_cap=16),
    dict(force_backend="sfmm", tree_depth=5, tree_leaf_cap=8),
])
def test_simulator_fmm_matches_jax(fields):
    """3 leapfrog steps of a 1024-body disk through both Simulators, the
    dense grid at depth 4 and the sparse layout at depth 5, both with
    overflowing leaves."""
    sim, jax_sim = _both(dict(LEAPFROG, **fields), seed=8)
    jax_stats = jax_sim.run()
    assert sim.fmm_sparse == jax_sim.fmm_sparse
    assert sim.sfmm_sizing == getattr(jax_sim, "sfmm_sizing", None)
    stats = sim.run()
    got_pos, got_vel, _ = state_to_numpy(stats["final_state"])
    jax_final = jax_stats["final_state"]
    assert _rows_close(got_pos, jax_final.positions, 1e-5)
    assert _rows_close(got_vel, jax_final.velocities, 1e-5)
    assert stats["kernel_launches"] == 0
    assert stats["fmm_mode"] == ("sparse" if sim.fmm_sparse else "dense")
    if sim.fmm_sparse:
        assert stats["sfmm_final_occupancy"] == jax_sfmm.final_occupancy_check(
            got_pos, jax_sim.sfmm_sizing)
    else:
        assert stats["fmm_depth"] == 4


@pytest.mark.parametrize("model,n,fields,sparse", [
    ("disk", 4096, {}, True),
    ("random", 4096, {"eps": 1e9}, False),
    ("disk", 4096, {"fmm_mode": "dense"}, False),
    ("random", 2048, {"fmm_mode": "sparse", "eps": 1e9}, True),
])
def test_layout_resolution_matches_jax(model, n, fields, sparse):
    """fmm_mode auto routes by occupancy as the JAX package does (the
    clustered disk sparse, the uniform cube dense), and dense/sparse pin
    the layout; the sparse sizing is the JAX package's."""
    if model == "disk":
        pos = _disk(n, seed=3)[0]
    else:
        pos = np.random.default_rng(4).uniform(-1e12, 1e12, (n, 3))
        pos = pos.astype(np.float32)
    vel, masses = np.zeros_like(pos), np.full(n, 1.0 / n, np.float32)
    cfg = SimulationConfig(model=model, n=n, force_backend="fmm", g=1.0,
                           **fields)
    sim = Simulator(cfg, state_from_numpy(pos, vel, masses, device="cpu"),
                    device="cpu")
    assert sim.fmm_sparse is sparse
    if fields.get("fmm_mode", "auto") == "auto":
        assert jax_sfmm.sfmm_auto_decision(pos, 32)[0] is sparse
    if sparse:
        depth, cap, k, _ = jax_sfmm.recommended_sparse_params(pos, cap_max=32)
        assert sim.sfmm_sizing == (depth, cap,
                                   jax_sfmm.effective_k_cells(k), 8192)
    else:
        assert sim.fmm_depth > 0 and sim.sfmm_sizing is None


def test_multirate_kick_through_the_fmm_matches_jax(monkeypatch):
    """make_local_kernel("fmm") at K = 128 of 512 bodies against the JAX
    package's: the plain (K, N) sum under the dense-kick budget, the dense
    grid's rectangular form above it (the budget set to 0 in both
    packages); then 2 two-rung steps through both Simulators."""
    common = dict(LEAPFROG, n=512, steps=2, progress_every=2,
                  integrator="multirate", multirate_k=128,
                  force_backend="fmm", fmm_mode="dense", tree_depth=3,
                  tree_leaf_cap=16)
    pos, vel, masses = _disk(512, seed=9)
    tp = torch.from_numpy(pos)
    cfg, jcfg = SimulationConfig(**common), JaxConfig(**common)
    kick = make_local_kernel(cfg, "fmm", positions=tp, k_targets=128)
    jkick = jax_simulation.make_local_kernel(jcfg, "fmm",
                                             positions=jnp.asarray(pos),
                                             k_targets=128)
    assert kick.func.__name__ == jkick.func.__name__ == "accelerations_vs"
    for mod in (simulation, jax_simulation):
        monkeypatch.setattr(mod, "DENSE_KICK_BUDGET", 0)
    kick = make_local_kernel(cfg, "fmm", positions=tp, k_targets=128)
    jkick = jax_simulation.make_local_kernel(jcfg, "fmm",
                                             positions=jnp.asarray(pos),
                                             k_targets=128)
    assert kick.keywords["t_cap"] == jkick.keywords["t_cap"] > 0
    idx = np.random.default_rng(1).choice(512, 128, replace=False)
    got = kick(tp[idx], tp, torch.from_numpy(masses)).numpy()
    want = np.asarray(jkick(jnp.asarray(pos[idx]), jnp.asarray(pos),
                            jnp.asarray(masses)), np.float64)
    rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert np.median(rel) < 1e-5 and rel.max() < 1e-3, rel.max()
    jax_final = JaxSimulator(jcfg, state=JaxState(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(masses))).run()[
        "final_state"]
    stats = Simulator(cfg, state_from_numpy(pos, vel, masses, device="cpu"),
                      device="cpu").run()
    got_pos, got_vel, _ = state_to_numpy(stats["final_state"])
    assert _rows_close(got_pos, jax_final.positions, 1e-5)
    assert _rows_close(got_vel, jax_final.velocities, 1e-5)


def test_large_n_potential_fmm_branch(monkeypatch, x64):
    """The energy's and the ledger's large-N potential (thresholds lowered
    to this state): the FMM's where LARGE_N_POTENTIAL names it (the card),
    the octree's otherwise (the CPU). The FMM branch is the JAX package's
    fmm_potential_energy; the ledger prices it as Simulator.energy() does;
    the two potentials agree within the JAX suite's bar."""
    monkeypatch.setattr(simulation, "ENERGY_TREE_THRESHOLD", 100)
    monkeypatch.setattr(diagnostics, "LEDGER_DENSE_MAX", 100)
    cfg = SimulationConfig(**dict(LEAPFROG, force_backend="fmm",
                                  fmm_mode="dense", tree_leaf_cap=16))
    pos, vel, masses = _disk(1024, seed=10)
    potentials = {}
    for kind in ("fmm", "tree"):
        monkeypatch.setitem(simulation.LARGE_N_POTENTIAL, "cpu", kind)
        sim = Simulator(cfg, state_from_numpy(pos, vel, masses,
                                              device="cpu"), device="cpu")
        e = sim.energy()
        assert isinstance(e, np.float64)
        ledger = sim.ledger_of()
        assert ledger["pe_kind"] == kind
        assert abs(ledger["energy"] - e) <= 1e-6 * abs(e)
        pe = e - float(diagnostics.kinetic_energy_f64(sim.state))
        potentials[kind] = pe
        if kind == "fmm":
            want = float(jax_fmm.fmm_potential_energy(
                jnp.asarray(pos), jnp.asarray(masses),
                depth=sim._energy_tree_depth, leaf_cap=16, g=1.0, eps=0.05))
            assert abs(pe - want) <= 1e-5 * abs(want)
    assert abs(potentials["fmm"] - potentials["tree"]) \
        <= 0.05 * abs(potentials["tree"])
    assert simulation.LARGE_N_POTENTIAL["cuda"] in ("fmm", "tree")


def test_preset_and_cli_flags(tmp_path, capsys):
    """The preset is the JAX package's; ``run`` takes it (cut to 1,024
    bodies), ``--force-backend sfmm`` and ``--fmm-mode dense|sparse``, and
    ``--debug-check`` audits the FMM's full-set forces."""
    want = dataclasses.asdict(JAX_PRESETS["baseline-1m-fmm"])
    for name, value in dataclasses.asdict(PRESETS["baseline-1m-fmm"]).items():
        if name != "log_dir":  # each package logs to its own directory
            assert want[name] == value, name
    runs = {
        "preset": ["--preset", "baseline-1m-fmm", "--n", "1024",
                   "--debug-check"],
        "sfmm": ["--preset", "baseline-1m-fmm", "--n", "1024",
                 "--force-backend", "sfmm"],
        "dense": ["--model", "random", "--n", "512", "--eps", "1e9",
                  "--integrator", "leapfrog", "--force-backend", "fmm",
                  "--fmm-mode", "dense"],
        "sparse": ["--model", "random", "--n", "512", "--eps", "1e9",
                   "--integrator", "leapfrog", "--force-backend", "fmm",
                   "--fmm-mode", "sparse"],
    }
    out = {}
    for name, args in runs.items():
        assert main(["run", "--device", "cpu", "--steps", "2", "--log-dir",
                     str(tmp_path / name), *args]) == 0
        out[name] = json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1])
    assert out["preset"]["backend"] == "fmm"
    assert out["preset"]["fmm_mode"] == "sparse"  # the clustered disk
    assert out["preset"]["debug_check"]["median_rel_err"] < 0.05
    assert "sfmm_final_occupancy" in out["preset"]
    assert (out["sfmm"]["backend"], out["sfmm"]["fmm_mode"]) == ("sfmm",
                                                                  "sparse")
    assert out["dense"]["fmm_mode"] == "dense"
    assert out["sparse"]["fmm_mode"] == "sparse"
    with pytest.raises(SystemExit):
        main(["run", "--device", "cpu", "--fmm-mode", "tiles"])


def test_bf16_and_sharded_fmm_are_refused():
    """bf16 states through the FMM are ported (such a config loads;
    tests/test_torch_p3m_kick_fmm_bf16.py holds them to the JAX package),
    and so are the sharded FMM forms: the JAX package's mesh config of
    either loads with its sharding (tests/test_torch_sharded_fmm.py)."""
    for backend in ("fmm", "sfmm"):
        cfg = SimulationConfig(force_backend=backend, dtype="bfloat16")
        assert (cfg.force_backend, cfg.dtype) == (backend, "bfloat16")
        data = json.loads(JaxConfig(force_backend=backend,
                                    sharding="allgather").to_json())
        cfg = SimulationConfig.from_json(json.dumps(data))
        assert (cfg.force_backend, cfg.sharding) == (backend, "allgather")
    with pytest.raises(ValueError, match="fmm_mode"):
        SimulationConfig(fmm_mode="tiles")
    cfg = SimulationConfig.from_json(JaxConfig(
        force_backend="fmm", fmm_mode="sparse").to_json())
    assert (cfg.force_backend, cfg.fmm_mode) == ("fmm", "sparse")


def _overloaded_fmm_cfg(**kw):
    """The JAX package's verify-skill case: a 256-body disk through fmm at
    depth 3 with 4 slots a leaf, under an error budget of 0.05."""
    return SimulationConfig(model="disk", n=256, g=1.0, dt=2e-3, eps=0.05,
                            steps=6, integrator="leapfrog",
                            force_backend="fmm", tree_depth=3,
                            tree_leaf_cap=4, error_budget=0.05,
                            sentinel_every=1, progress_every=1, **kw)


def test_supervisor_heals_overloaded_fmm_by_releaf(tmp_path):
    """The overloaded fmm breaches its budget; without the supervisor the
    run raises, with it the leaf cap is re-sized 4 -> 64 once and the run
    completes within the budget."""
    with pytest.raises(simulation.AccuracyBreach) as ei:
        Simulator(_overloaded_fmm_cfg(), device="cpu").run()
    assert ei.value.backend == "fmm"
    events = RecoveryEventLogger(str(tmp_path / "recovery.jsonl"))
    cfg = _overloaded_fmm_cfg(auto_recover=True,
                              checkpoint_dir=str(tmp_path / "ckpt"))
    sup = RunSupervisor(cfg, events=events, device="cpu")
    stats = sup.run()
    assert stats["supervisor"]["accuracy_retries"] == 1
    assert stats["sentinel"]["p90_rel_err"] < cfg.error_budget
    retries = [e for e in events.read()
               if e["event"] == "retry" and e.get("kind") == "accuracy"]
    assert [(e["from_leaf_cap"], e["leaf_cap"]) for e in retries] == [(4, 64)]
    assert (sup.config.force_backend, sup.config.tree_leaf_cap) == ("fmm",
                                                                     64)


def test_router_takes_the_fmm_candidates():
    """From the fast-probe floor up the router probes tree, fmm and sfmm
    (on the card beside the two kernels), and the fmm layout keys the
    verdict."""
    cfg = SimulationConfig(model="disk", n=1 << 20, g=1.0, eps=0.05)
    assert eligible_candidates(cfg, True)[0] == (
        "pallas", "pallas-mxu", "tree", "fmm", "sfmm")
    keys = [make_key(dataclasses.replace(cfg, fmm_mode=mode),
                     candidates=("tree",), platform="cuda", device_kind="x",
                     occupancy="na") for mode in ("auto", "sparse")]
    assert keys[0]["knobs"]["fmm_mode"] == "auto" and keys[0] != keys[1]
