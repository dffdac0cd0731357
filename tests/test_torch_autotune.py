"""The port's measurement-driven backend router (``gravity_tpu_torch/
autotune.py``), on the CPU, after the JAX package's ``tests/
test_autotune.py``, with parity against ``gravity_tpu/autotune.py``.

The same numpy positions give both packages the same occupancy signature,
and the same configurations the same candidate set. The cache mechanics
are the JAX package's: a stable key, probe on a miss, at once on a hit, a
record from other versions is a miss, ``refresh``, torn records, fenced
writes.
Where the port departs on purpose: only a candidate whose Simulator
refuses to be built is skipped; a kernel's build or launch error, or a
wrapper's refusal of a launch, inside a probe propagates.

Most probes are faked (stubbed ``_candidate_simulator`` and
``_time_backend`` with canned timings); the Simulator tests run real
probes at a lowered fast-probe floor.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import gravity_tpu.autotune as jat
import gravity_tpu_torch.autotune as at
from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu_torch.autotune import (
    eligible_candidates,
    key_hash,
    make_key,
    occupancy_signature,
    probe_counters,
    resolve_backend_measured,
    versions,
)
from gravity_tpu_torch.config import SimulationConfig

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once, and the
    real probes' FMM candidates fill volume-sized grids."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _fresh_cache(tmp_path, monkeypatch):
    """A throwaway tuning dir and a clean in-memory cache for every test:
    nothing touches ~/.cache."""
    monkeypatch.setenv("GRAVITY_TPU_TUNE_DIR", str(tmp_path / "tuning"))
    at._mem_cache.clear()
    yield


def _cfg(n, **kw):
    kw.setdefault("model", "plummer")
    kw.setdefault("dt", 3600.0)
    kw.setdefault("eps", 1.0e9)
    kw.setdefault("integrator", "leapfrog")
    return SimulationConfig(n=n, **kw)


def _fake_probe(monkeypatch, timings, refused=(), errors=None):
    """Stub the probe with canned (seconds, error) results: a ``refused``
    candidate's Simulator raises a sizing ValueError as it is built; the
    timing keeps the probe-step counter's contract."""

    def build(config, backend, state, device):
        if backend in refused:
            raise ValueError(f"{backend} sizing check failed")
        return SimpleNamespace(backend=backend)

    def time_backend(sim, probe_steps):
        at._counters["probe_steps"] += probe_steps
        p90 = (errors or {}).get(sim.backend, 0.0)
        return timings[sim.backend], {"median_rel_err": p90,
                                      "p90_rel_err": p90, "max_rel_err": p90}

    monkeypatch.setattr(at, "_candidate_simulator", build)
    monkeypatch.setattr(at, "_time_backend", time_backend)
    return time_backend


def _resolve(cfg, state=None, **kw):
    return resolve_backend_measured(cfg, state, device=CPU, **kw)


# --- parity with the JAX package ------------------------------------------


def _clustered(n, seed):
    """A Plummer-like cloud drawn with numpy: clustered."""
    rng = np.random.default_rng(seed)
    r = 1.0 / np.sqrt(rng.uniform(0.01, 1.0, n) ** (-2.0 / 3.0) - 1.0)
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None]


@pytest.mark.parametrize("name", ["uniform", "clustered", "line", "one"])
def test_occupancy_signature_matches_jax(name):
    rng = np.random.default_rng(0)
    pos = {"uniform": rng.uniform(0.0, 1.0, (4096, 3)),
           "clustered": _clustered(4096, 1),
           "line": np.outer(np.linspace(0, 1, 500), [1.0, 2.0, 3.0]),
           "one": np.ones((1, 3))}[name]
    sig = occupancy_signature(pos)
    assert sig == jat.occupancy_signature(pos)
    assert occupancy_signature(torch.from_numpy(pos)) == sig
    assert occupancy_signature(torch.from_numpy(pos).float()) == \
        jat.occupancy_signature(pos.astype(np.float32))


def test_occupancy_signature_separates_clustered_from_uniform():
    rng = np.random.default_rng(0)
    uniform = rng.uniform(0.0, 1.0, (4096, 3))
    assert occupancy_signature(uniform) != occupancy_signature(
        _clustered(4096, 2))
    assert occupancy_signature(uniform) == occupancy_signature(
        rng.uniform(0.0, 1.0, (4096, 3)))


def test_occupancy_signature_degrades_to_na():
    assert occupancy_signature(None) == "na"
    assert occupancy_signature(np.full((8, 3), np.nan)) == "na"
    assert occupancy_signature(np.zeros((0, 3))) == "na"
    assert occupancy_signature(torch.zeros(0, 3)) == "na"


@pytest.mark.parametrize("n,rcut,floor", [
    (2048, 0.0, None), (16_384, 0.0, None), (1 << 20, 0.0, None),
    (512, 0.0, "256"), (2048, 5e10, None), (20_000, 5e10, None),
    (1 << 20, 5e10, None)])
def test_eligible_candidates_match_jax_on_the_cpu(monkeypatch, n, rcut,
                                                  floor):
    """The JAX package's candidates on the CPU and the same skipped keys,
    with the host-native C++ direct sum built in both packages (``cpp``,
    the direct member above 4,096 bodies) and unbuildable in both."""
    import gravity_tpu.ops.ffi_forces as ffi
    from gravity_tpu_torch.ops import host_kernel

    if floor:
        monkeypatch.setenv("GRAVITY_TPU_AUTOTUNE_MIN_N", floor)
    kw = dict(model="plummer", n=n, eps=1e9, nlist_rcut=rcut)
    for available in (False, True):
        monkeypatch.setattr(ffi, "ffi_forces_available", lambda: available)
        monkeypatch.setattr(host_kernel, "host_forces_available",
                            lambda: available)
        cands, skipped = eligible_candidates(SimulationConfig(**kw), False)
        jcands, jskipped = jat.eligible_candidates(JaxConfig(**kw), False)
        assert jcands == cands
        assert set(skipped) == set(jskipped)
        assert ("cpp" in cands) == (
            available and n > 4096 and rcut == 0.0
            and n * (n - 1) <= at.DIRECT_PROBE_PAIR_BUDGET["cpu"])


def test_eligible_on_the_card_adds_the_gram_form_beside_the_kernel():
    cands, _ = eligible_candidates(_cfg(1_048_576), True)
    assert cands == ("pallas", "pallas-mxu", "tree", "fmm", "sfmm")
    cands, _ = eligible_candidates(_cfg(1000), True)
    assert cands == ("pallas", "pallas-mxu")
    # the Gram form computes in float32: not for a float64 state
    cands, _ = eligible_candidates(_cfg(1000, dtype="float64"), True)
    assert cands == ("pallas",)
    # truncated physics: the cell list against the masked direct sum
    cands, skipped = eligible_candidates(_cfg(262_144, nlist_rcut=5e10),
                                         True)
    assert cands == ("chunked", "nlist")
    assert "tree/fmm/sfmm" in skipped
    # the card's pair budget admits baseline-2m and no more
    cands, _ = eligible_candidates(_cfg(2_097_152), True)
    assert cands[0] == "pallas"
    cands, skipped = eligible_candidates(_cfg(2_097_153), True)
    assert cands == ("tree", "fmm", "sfmm") and "pair" in skipped["pallas"]


# --- cache key -------------------------------------------------------------


def test_key_hash_stable_and_sensitive():
    base = dict(candidates=("dense", "tree"), platform="cpu",
                device_kind="cpu", occupancy="occ2^-3")
    k1 = make_key(_cfg(4096), **base)
    assert key_hash(k1) == key_hash(make_key(_cfg(4096), **base))
    for other in (make_key(_cfg(8192), **base),
                  make_key(_cfg(4096, dtype="float64"), **base),
                  make_key(_cfg(4096), **{**base, "occupancy": "occ2^-6"}),
                  make_key(_cfg(4096), **{**base, "platform": "cuda"}),
                  make_key(_cfg(4096, tree_depth=5), **base),
                  make_key(_cfg(4096, tree_leaf_cap=512), **base),
                  make_key(_cfg(4096, tree_near="nlist"), **base),
                  make_key(_cfg(4096, nlist_rcut=1e10), **base)):
        assert key_hash(other) != key_hash(k1)


def test_versions_name_torch_cuda_and_nvcc():
    v = versions()
    assert v["torch"] == torch.__version__
    assert v["cuda"] == torch.version.cuda
    assert v["nvcc"] == "none" or "release" in v["nvcc"]
    assert set(v["kernels"]) == {"nbody_direct", "nbody_mxu", "nlist_pair",
                                 "segment_sum", "host_forces"}
    from gravity_tpu_torch.ops import cells

    assert cells.LIBRARY.library_path().endswith(
        f"libsegment_sum_{v['kernels']['segment_sum']}.so")
    assert at.tuning_dir().endswith("tuning")


def test_default_tuning_dir_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("GRAVITY_TPU_TUNE_DIR")
    assert at.tuning_dir().endswith(os.path.join(
        ".cache", "gravity_tpu_torch", "tuning"))
    assert at.tuning_dir() != jat.tuning_dir()


# --- eligibility -------------------------------------------------------


def test_eligible_small_n_is_direct_only():
    cands, skipped = eligible_candidates(_cfg(2048), False)
    assert cands == ("dense",)
    assert "tree/fmm/sfmm" in skipped


def test_eligible_large_n_cpu_drops_direct_over_pair_budget():
    cands, skipped = eligible_candidates(_cfg(1_048_576), False)
    assert cands == ("tree", "fmm", "sfmm")
    assert any("pair" in v for v in skipped.values())


def test_fast_probe_floor_env_override(monkeypatch):
    monkeypatch.setenv("GRAVITY_TPU_AUTOTUNE_MIN_N", "256")
    cands, _ = eligible_candidates(_cfg(512), False)
    assert "tree" in cands


# --- resolve: probe / persist / hit ----------------------------------------


def test_single_candidate_short_circuits_without_probe():
    before = probe_counters()["probe_steps"]
    d = _resolve(_cfg(1024))
    assert d.cache == "static" and d.backend == "dense"
    assert probe_counters()["probe_steps"] == before
    assert not os.path.isdir(at.tuning_dir()) or not os.listdir(
        at.tuning_dir())


def test_miss_probes_persists_then_hits(monkeypatch):
    _fake_probe(monkeypatch, {"dense": 0.05, "tree": 0.01, "nlist": 0.02})
    cfg = _cfg(4096)
    cands = ("dense", "tree", "nlist")
    d = _resolve(cfg, candidates=cands)
    assert d.cache == "miss" and d.backend == "tree" and d.probe_ms > 0.0
    with open(os.path.join(at.tuning_dir(), f"{d.key_hash}.json")) as f:
        rec = json.load(f)
    assert rec["winner"] == "tree" and rec["versions"] == versions()
    at._mem_cache.clear()
    before = probe_counters()["probe_steps"]
    d2 = _resolve(cfg, candidates=cands)
    assert d2.cache == "hit" and d2.backend == "tree"
    assert d2.probe_ms == 0.0
    assert probe_counters()["probe_steps"] == before


@pytest.mark.parametrize("field", ["nvcc", "kernels"])
def test_version_mismatch_invalidates(monkeypatch, field):
    """A record from another nvcc, or from another source of a candidate's
    kernel (a redesign can reorder the candidates), is a miss."""
    _fake_probe(monkeypatch, {"dense": 0.05, "tree": 0.01})
    cfg = _cfg(4096)
    d = _resolve(cfg, candidates=("dense", "tree"))
    path = os.path.join(at.tuning_dir(), f"{d.key_hash}.json")
    with open(path) as f:
        rec = json.load(f)
    if field == "nvcc":
        rec["versions"]["nvcc"] = "Build cuda_0.0.r0.0/compiler.0_0"
    else:
        rec["versions"]["kernels"]["segment_sum"] = "0" * 16
    with open(path, "w") as f:
        json.dump(rec, f)
    at._mem_cache.clear()
    assert _resolve(cfg, candidates=("dense", "tree")).cache == "miss"


def test_refresh_reprobes_and_overwrites(monkeypatch):
    cfg = _cfg(4096)
    cands = ("dense", "tree")
    _fake_probe(monkeypatch, {"dense": 0.05, "tree": 0.01})
    assert _resolve(cfg, candidates=cands).backend == "tree"
    _fake_probe(monkeypatch, {"dense": 0.001, "tree": 0.01})
    assert _resolve(cfg, candidates=cands).backend == "tree"
    d = _resolve(cfg, candidates=cands, refresh=True)
    assert d.cache == "miss" and d.backend == "dense"


def test_refused_candidates_are_skipped(monkeypatch):
    _fake_probe(monkeypatch, {"dense": 0.05, "tree": 0.01, "nlist": 0.001},
                refused=("tree", "nlist"))
    d = _resolve(_cfg(4096), candidates=("dense", "tree", "nlist"))
    assert d.backend == "dense"
    assert d.skipped == {"tree": "ValueError: tree sizing check failed",
                         "nlist": "ValueError: nlist sizing check failed"}


def test_all_candidates_refused_falls_back_static(monkeypatch):
    from gravity_tpu_torch.simulation import _resolve_direct

    _fake_probe(monkeypatch, {}, refused=("pallas", "tree"))
    cfg = _cfg(4096)
    d = _resolve(cfg, candidates=("pallas", "tree"))
    assert d.cache == "static"
    assert d.backend == _resolve_direct(cfg, False) == "dense"
    assert set(d.skipped) == {"pallas", "tree"}


def test_a_candidate_the_config_refuses_is_skipped_with_its_reason():
    """A real refusal before the candidate runs: the cell list without a
    radius raises the Simulator's sizing ValueError."""
    d = _resolve(_cfg(300), candidates=("dense", "nlist"))
    assert d.cache == "miss" and d.backend == "dense"
    assert "nlist_rcut > 0" in d.skipped["nlist"]


def test_a_kernel_build_error_in_a_probe_propagates(monkeypatch):
    """The port's departure: a kernel's build or launch error (a
    RuntimeError) is no skip; it fails the probe, and the run."""
    from gravity_tpu_torch import simulation

    def broken_build(*args, **kwargs):
        raise RuntimeError("nvcc failed on libnbody_direct_0.so with exit "
                           "code 1")

    monkeypatch.setattr(simulation, "accelerations_vs_kernel", broken_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _resolve(_cfg(300), candidates=("dense", "pallas"))
    monkeypatch.setattr(at, "eligible_candidates",
                        lambda config, on_card: (("dense", "pallas"), {}))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        simulation.Simulator(_cfg(300, steps=2), device=CPU)
    assert not os.path.isdir(at.tuning_dir()) or not os.listdir(
        at.tuning_dir())


@pytest.mark.parametrize("where", ["run", "audit"])
def test_a_wrapper_refusal_in_a_probe_propagates(monkeypatch, where):
    """A kernel wrapper's ValueError (its shape, contiguity or device
    checks refusing a launch) once the candidate runs is no skip either:
    only a Simulator that refuses to be built is. Raised at the
    candidate's first force evaluation or in its force audit, it fails the
    probe, and nothing is cached."""
    from gravity_tpu_torch import simulation
    from gravity_tpu_torch.ops.integrators import FORCE_EVALS_PER_STEP

    wrapper = simulation.accelerations_vs_kernel
    # the first carry, the untimed step and the timed steps come first
    before_audit = 1 + (1 + at.PROBE_STEPS) * FORCE_EVALS_PER_STEP["leapfrog"]
    calls = []

    def refusing_wrapper(*args, **kwargs):
        calls.append(1)
        if where == "run" or len(calls) > before_audit:
            raise ValueError("nbody_direct: positions must be contiguous")
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(simulation, "accelerations_vs_kernel",
                        refusing_wrapper)
    with pytest.raises(ValueError, match="must be contiguous"):
        _resolve(_cfg(300), candidates=("dense", "pallas"))
    assert len(calls) == (1 if where == "run" else before_audit + 1)
    assert not os.path.isdir(at.tuning_dir()) or not os.listdir(
        at.tuning_dir())


def test_a_real_probe_times_and_audits_each_candidate(monkeypatch):
    monkeypatch.setenv("GRAVITY_TPU_AUTOTUNE_MIN_N", "128")
    before = probe_counters()
    d = _resolve(_cfg(256), state=lambda: simulation_state(_cfg(256)))
    fast = ("tree", "fmm", "sfmm")
    assert d.cache == "miss" and set(d.timings_s) == {"dense", *fast}
    assert all(t > 0 for t in d.timings_s.values())
    assert d.errors["dense"]["p90_rel_err"] < 1e-5
    for name in fast:
        assert d.errors[name]["p90_rel_err"] \
            > d.errors["dense"]["p90_rel_err"]
    assert d.backend == min(d.timings_s, key=d.timings_s.get)
    assert d.skipped == {}
    after = probe_counters()
    assert after["probes"] == before["probes"] + 4
    assert after["probe_steps"] == before["probe_steps"] + 4 * at.PROBE_STEPS


def simulation_state(cfg):
    from gravity_tpu_torch.simulation import make_initial_state

    return make_initial_state(cfg, CPU)


# --- Simulator / bench / CLI wiring ----------------------------------------


def test_simulator_reports_cache_off_for_explicit_and_disabled():
    from gravity_tpu_torch.simulation import Simulator

    sim = Simulator(_cfg(64, force_backend="dense", steps=2), device=CPU)
    assert sim.autotune == {"cache": "off", "probe_ms": 0.0}
    assert sim.autotune_decision == at.off("dense")
    sim2 = Simulator(_cfg(64, autotune=False, steps=2), device=CPU)
    assert sim2.autotune["cache"] == "off"
    sim3 = Simulator(_cfg(64, steps=2), device=CPU)
    assert sim3.autotune == {"cache": "static", "probe_ms": 0.0}


def test_simulator_auto_miss_then_hit_lands_in_run_stats(monkeypatch):
    """The first auto run probes (miss, probe_ms > 0) and runs the winner;
    the second run of the same configuration takes no probe step and
    reports the hit, all in the run stats."""
    monkeypatch.setenv("GRAVITY_TPU_AUTOTUNE_MIN_N", "128")
    _fake_probe(monkeypatch, {"dense": 0.05, "tree": 0.01, "fmm": 0.02,
                              "sfmm": 0.03})
    from gravity_tpu_torch.simulation import Simulator

    cfg = _cfg(256, steps=2)
    sim = Simulator(cfg, device=CPU)
    assert sim.backend == "tree"
    stats = sim.run()
    assert stats["autotune_cache"] == "miss"
    assert stats["autotune_probe_ms"] > 0.0
    assert stats["backend"] == "tree" and stats["tree_depth"] > 0
    before = probe_counters()["probe_steps"]
    stats2 = Simulator(cfg, device=CPU).run()
    assert stats2["autotune_cache"] == "hit"
    assert stats2["autotune_probe_ms"] == 0.0 and stats2["backend"] == "tree"
    assert probe_counters()["probe_steps"] == before


def test_simulator_real_probe_then_hit(monkeypatch):
    monkeypatch.setenv("GRAVITY_TPU_AUTOTUNE_MIN_N", "128")
    from gravity_tpu_torch.simulation import Simulator

    cfg = _cfg(200, steps=3)
    sim = Simulator(cfg, device=CPU)
    assert sim.autotune["cache"] == "miss"
    winner = sim.autotune_decision.backend
    assert sim.backend == winner
    assert winner in ("dense", "tree", "fmm", "sfmm")
    stats = sim.run()
    assert stats["steps"] == 3 and stats["autotune_cache"] == "miss"
    before = probe_counters()
    sim2 = Simulator(cfg, device=CPU)
    assert sim2.autotune == {"cache": "hit", "probe_ms": 0.0}
    assert sim2.backend == winner
    assert probe_counters() == before


def test_probe_does_not_move_the_run_state(monkeypatch):
    """Every candidate probes the run's own initial state and leaves it
    as it was."""
    monkeypatch.setenv("GRAVITY_TPU_AUTOTUNE_MIN_N", "128")
    from gravity_tpu_torch.simulation import Simulator, make_initial_state

    cfg = _cfg(200, steps=2, seed=4)
    want = make_initial_state(cfg, CPU)
    sim = Simulator(cfg, device=CPU)
    assert sim.autotune["cache"] == "miss"
    assert torch.equal(sim.state.positions, want.positions)
    assert torch.equal(sim.state.velocities, want.velocities)


def test_bench_line_carries_routing_facts():
    from gravity_tpu_torch.bench import run_benchmark

    stats = run_benchmark(_cfg(64, force_backend="dense"), warmup_steps=1,
                          bench_steps=2, device=CPU)
    assert stats["autotune_cache"] == "off"
    assert stats["autotune_probe_ms"] == 0.0


def test_cli_tune_prewarms_the_cache(monkeypatch, capsys):
    """``tune --sizes ...``: one JSON line a size; a second call is all
    hits with no probe step."""
    monkeypatch.setenv("GRAVITY_TPU_AUTOTUNE_MIN_N", "128")
    _fake_probe(monkeypatch, {"dense": 0.05, "tree": 0.01, "fmm": 0.02,
                              "sfmm": 0.03})
    from gravity_tpu_torch.cli import main

    argv = ["tune", "--device", "cpu", "--sizes", "160", "256", "--model",
            "plummer", "--dt", "3600", "--eps", "1e9"]
    assert main(argv) == 0
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert [x["n"] for x in lines] == [160, 256]
    assert all(x["cache"] == "miss" and x["backend"] == "tree"
               for x in lines)
    assert all(set(x["timings_s"]) == {"dense", "tree", "fmm", "sfmm"}
               and not x["skipped"] for x in lines)
    before = probe_counters()["probe_steps"]
    assert main(argv) == 0
    lines2 = [json.loads(x) for x in
              capsys.readouterr().out.strip().splitlines()]
    assert all(x["cache"] == "hit" and x["probe_steps"] == 0
               for x in lines2)
    assert probe_counters()["probe_steps"] == before
    assert main(argv + ["--no-autotune"]) == 2


# --- concurrent writers -----------------------------------------------------


def test_torn_cache_record_is_a_miss_not_a_crash(monkeypatch):
    _fake_probe(monkeypatch, {"dense": 0.05, "tree": 0.01})
    cfg = _cfg(4096)
    cands = ("dense", "tree")
    d = _resolve(cfg, candidates=cands)
    path = os.path.join(at.tuning_dir(), f"{d.key_hash}.json")
    with open(path) as f:
        full = f.read()
    with open(path, "w") as f:
        f.write(full[: len(full) // 3])
    at._mem_cache.clear()
    assert _resolve(cfg, candidates=cands).cache == "miss"
    with open(path) as f:
        assert json.load(f)["winner"] == "tree"


def test_torn_read_retry_sees_concurrent_replace(monkeypatch):
    """A parse that fails while a peer's replace is in flight succeeds on
    the retry (the repair lands in the retry's sleep)."""
    _fake_probe(monkeypatch, {"dense": 0.05, "tree": 0.01})
    cfg = _cfg(4096)
    cands = ("dense", "tree")
    d = _resolve(cfg, candidates=cands)
    path = os.path.join(at.tuning_dir(), f"{d.key_hash}.json")
    with open(path) as f:
        full = f.read()
    with open(path, "w") as f:
        f.write(full[: len(full) // 3])
    at._mem_cache.clear()

    def _concurrent_writer_lands(_s):
        with open(path, "w") as f:
            f.write(full)

    monkeypatch.setattr(at.time, "sleep", _concurrent_writer_lands)
    before = probe_counters()["probe_steps"]
    d2 = _resolve(cfg, candidates=cands)
    assert d2.cache == "hit" and d2.backend == "tree"
    assert probe_counters()["probe_steps"] == before


def test_store_yields_to_newer_record_fencing(monkeypatch):
    """Records are stamped when their probe started: a slow prober that
    finishes after a peer's whole probe ran adopts the peer's verdict."""
    import time as _time

    cfg = _cfg(4096)
    cands = ("dense", "tree")
    _fake_probe(monkeypatch, {"dense": 0.05, "tree": 0.01})
    d = _resolve(cfg, candidates=cands)
    path = os.path.join(at.tuning_dir(), f"{d.key_hash}.json")
    real_probe = _fake_probe(monkeypatch, {"dense": 0.05, "tree": 0.01})

    def slow_probe_with_concurrent_peer(sim, steps):
        with open(path) as f:
            rec = json.load(f)
        rec["winner"] = "dense"
        rec["stamp_ns"] = _time.time_ns()
        with open(path, "w") as f:
            json.dump(rec, f)
        return real_probe(sim, steps)

    monkeypatch.setattr(at, "_time_backend", slow_probe_with_concurrent_peer)
    at._mem_cache.clear()
    d2 = _resolve(cfg, candidates=cands, refresh=True)
    assert d2.cache == "miss" and d2.backend == "tree"
    with open(path) as f:
        assert json.load(f)["winner"] == "dense"
    at._mem_cache.clear()
    d3 = _resolve(cfg, candidates=cands)
    assert d3.cache == "hit" and d3.backend == "dense"
