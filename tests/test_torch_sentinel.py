"""The port's accuracy sentinel (``gravity_tpu_torch/utils/profiling.py``
and the Simulator's probe) against the JAX package's, on the CPU.

``sentinel_indices`` is numpy in both packages: the same rows for the
same (n, k, seed), exactly. A probe of the same state and kernel gives
the JAX package's errors (fp64, 1e-9 absolute on relative errors that are
0 for an exact kernel or O(0.1) for the overloaded octree). The rest
mirrors the sentinel part of ``tests/test_numerics_observatory.py``: an
exact backend reads round-off, an overloaded octree breaches its budget
(exit 2 alone), and the supervisor heals it by re-leafing, then by an
exact reroute.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.ops.forces import accelerations_vs as jax_accelerations_vs
from gravity_tpu.utils.profiling import (
    make_force_error_probe as jax_probe,
)
from gravity_tpu.utils.profiling import sentinel_indices as jax_indices
from gravity_tpu.utils.profiling import sentinel_summary as jax_summary
from gravity_tpu_torch.cli import main
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.ops.forces import accelerations_vs
from gravity_tpu_torch.simulation import AccuracyBreach, Simulator
from gravity_tpu_torch.supervisor import RunSupervisor
from gravity_tpu_torch.utils import faults as fmod
from gravity_tpu_torch.utils.logging import RecoveryEventLogger
from gravity_tpu_torch.utils.profiling import (
    full_set_probe_kernel,
    make_force_error_probe,
    sentinel_indices,
    sentinel_summary,
)


@pytest.fixture
def port_faults(monkeypatch):
    def install(spec: str):
        monkeypatch.setenv(fmod.ENV_KNOB, spec)
        return fmod.install(spec)

    yield install
    fmod.reset()


def _overloaded_tree_cfg(**kw):
    """The JAX suite's overload (a 256-body disk at depth 3 with leaf cap
    4) on the octree: most mass goes through overflow monopoles, p90
    relative force error ~0.7 against a budget of 0.02."""
    kw.setdefault("error_budget", 0.02)
    kw.setdefault("steps", 10)
    return SimulationConfig(
        model="disk", n=256, dt=2.0e-3, g=1.0, eps=0.05,
        integrator="leapfrog", force_backend="tree", tree_depth=3,
        tree_leaf_cap=4, progress_every=5, sentinel_k=64, **kw)


@pytest.mark.parametrize("n,k,seed", [(1, 64, 0), (50, 64, 0),
                                      (1000, 64, 0), (1000, 64, 7),
                                      (16_384, 128, 3), (300, 1, 2)])
def test_sentinel_indices_equal_jax(n, k, seed):
    got, want = sentinel_indices(n, k, seed), jax_indices(n, k, seed)
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diff(got) > 0)


def test_sentinel_summary_equals_jax():
    rel = np.random.default_rng(1).random(64) ** 3
    assert sentinel_summary(torch.from_numpy(rel)) == jax_summary(rel)


@pytest.mark.parametrize("rcut", [0.0, 1.5e11])
def test_probe_matches_jax(rcut, x64):
    """The same state, a perturbed kernel, in fp64: the JAX probe's
    errors; with rcut the oracle is the masked sum on both sides."""
    rng = np.random.default_rng(4)
    pos = rng.standard_normal((96, 3)) * 1e11
    m = rng.random(96) * 1e29 + 1e28
    idx = sentinel_indices(96, 16, 5)

    def ours(t, p, mm):
        return 1.01 * accelerations_vs(t, p, mm, eps=1e9, rcut=rcut)

    def theirs(t, p, mm):
        return 1.01 * jax_accelerations_vs(t, p, mm, eps=1e9, rcut=rcut)

    got = make_force_error_probe(ours, idx=idx, g=6.6743e-11,
                                 cutoff=1e-10, eps=1e9, rcut=rcut)(
        torch.from_numpy(pos), torch.from_numpy(m))
    want = jax_probe(theirs, idx=idx, g=6.6743e-11, cutoff=1e-10, eps=1e9,
                     rcut=rcut)(jnp.asarray(pos), jnp.asarray(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9)
    np.testing.assert_allclose(got.numpy(), 0.01, rtol=1e-6)


def test_full_set_probe_kernel_compares_the_sampled_rows():
    calls = []

    def full(p, m):
        calls.append(p.shape[0])
        return torch.arange(3 * p.shape[0], dtype=p.dtype).reshape(-1, 3)

    kernel = full_set_probe_kernel(full, [1, 4])
    out = kernel(None, torch.zeros(6, 3), torch.ones(6))
    assert calls == [6] and out.tolist() == [[3, 4, 5], [12, 13, 14]]


def test_sentinel_exact_backend_near_zero():
    cfg = SimulationConfig(model="random", n=48, steps=20, eps=1e9,
                           sentinel_every=1, sentinel_k=16,
                           progress_every=10, force_backend="pallas")
    stats = Simulator(cfg, device="cpu").run()
    sent = stats["sentinel"]
    assert sent["probes"] == 2 and sent["k"] == 16
    assert sent["backend"] == "nbody_direct" and sent["max_rel_err"] < 1e-4


def test_sentinel_cadence_counts_blocks():
    cfg = SimulationConfig(model="random", n=32, steps=60, eps=1e9,
                           sentinel_every=2, progress_every=10)
    assert Simulator(cfg, device="cpu").run()["sentinel"]["probes"] == 3


def test_sentinel_flags_the_overloaded_tree():
    stats = Simulator(_overloaded_tree_cfg(error_budget=0.0,
                                           sentinel_every=1),
                      device="cpu").run()
    assert stats["sentinel"]["p90_rel_err"] > 0.1


def test_error_budget_breach_unsupervised(tmp_path, capsys):
    cfg = _overloaded_tree_cfg()
    with pytest.raises(AccuracyBreach) as ei:
        Simulator(cfg, device="cpu").run()
    assert ei.value.backend == "tree" and ei.value.step == 5
    assert ei.value.p90_rel_err > cfg.error_budget
    rc = main(["run", "--device", "cpu", "--model", "disk", "--n", "256",
               "--dt", "2e-3", "--g", "1.0", "--eps", "0.05",
               "--integrator", "leapfrog", "--force-backend", "tree",
               "--tree-depth", "3", "--tree-leaf-cap", "4",
               "--steps", "10", "--progress-every", "5",
               "--error-budget", "0.02", "--log-dir", str(tmp_path)])
    assert rc == 2
    err = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert err["error"] == "accuracy_breach" and err["backend"] == "tree"


def test_injected_breach_via_fault_spec(port_faults):
    port_faults("accuracy_breach@10")
    cfg = SimulationConfig(model="random", n=24, steps=40, eps=1e9,
                           error_budget=1e-3, progress_every=10)
    with pytest.raises(AccuracyBreach) as ei:
        Simulator(cfg, device="cpu").run()
    assert ei.value.p90_rel_err == 1.0 and ei.value.step == 10


def test_supervisor_heals_breach_by_releaf(tmp_path):
    events = RecoveryEventLogger(str(tmp_path / "recovery.jsonl"))
    cfg = _overloaded_tree_cfg(steps=20, auto_recover=True,
                               checkpoint_dir=str(tmp_path / "ckpt"))
    sup = RunSupervisor(cfg, events=events, device="cpu")
    stats = sup.run()
    assert stats["supervisor"]["accuracy_retries"] >= 1
    assert stats["sentinel"]["p90_rel_err"] < cfg.error_budget
    kinds = [e["event"] for e in events.read()]
    assert kinds[0] == "accuracy_breach"
    retries = [e for e in events.read()
               if e["event"] == "retry" and e.get("kind") == "accuracy"]
    assert retries and retries[0]["leaf_cap"] > cfg.tree_leaf_cap
    assert sup.config.tree_leaf_cap == retries[0]["leaf_cap"]
    assert sup.config.force_backend == "tree"


def test_supervisor_heals_breach_by_exact_reroute(tmp_path):
    events = RecoveryEventLogger(str(tmp_path / "recovery.jsonl"))
    cfg = _overloaded_tree_cfg(steps=20, auto_recover=True,
                               checkpoint_dir=str(tmp_path / "ckpt"))
    sup = RunSupervisor(cfg, events=events, device="cpu")
    sup._releafed = True  # rung 1 spent: the reroute rung
    stats = sup.run()
    assert stats["supervisor"]["degraded_from"] == "tree"
    assert sup.config.force_backend == "dense"  # the CPU's exact sum
    assert stats["steps"] == 20 - 5  # from the last consumed block
    degr = [e for e in events.read() if e["event"] == "degraded"]
    assert degr and degr[0]["from_backend"] == "tree"


def test_debug_check_reports_the_audit(tmp_path, capsys):
    assert main(["run", "--device", "cpu", "--model", "random", "--n", "40",
                 "--steps", "4", "--eps", "1e9", "--force-backend",
                 "pallas-mxu", "--debug-check",
                 "--log-dir", str(tmp_path)]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    check = stats["debug_check"]
    assert check["n_checked"] == 40 and check["max_rel_err"] < 1e-4
