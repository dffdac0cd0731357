"""The port's performance observatory (``gravity_tpu_torch/telemetry/
perf.py``) against the JAX package's, on the CPU, at n <= 256.

A ledger row for every solo family and the serve key, with the JAX row's
fields (less XLA's memory breakdown ``arg_bytes``, ``output_bytes``,
``temp_bytes``, ``generated_code_bytes``, which PyTorch has no program to
report); the same ``analytic_flops``; a dense block's counted flops
within 0.9-1.1 of the JAX block's ``cost_analysis`` flops (measured
0.957 at n = 128 and 256 for euler, leapfrog and yoshida4: XLA counts
the fused integrator's few more elementwise ops), its transcendentals
equal; an instrumented block gives the bits of a plain one; the JSONL
sink, the ``autotune_probe`` label, recompile storms and the promoted
metrics.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.ops.integrators import init_carry
from gravity_tpu.simulation import Simulator as JaxSimulator
from gravity_tpu.telemetry import perf as jax_perf
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy
from gravity_tpu_torch.ops import direct_kernel, mxu_kernel, nlist
from gravity_tpu_torch.ops.forces import accelerations_vs
from gravity_tpu_torch.serve.engine import EnsembleEngine, batch_key_for
from gravity_tpu_torch.simulation import Simulator, make_initial_state
from gravity_tpu_torch.telemetry import Telemetry, parse_prometheus_text
from gravity_tpu_torch.telemetry import perf

# XLA's memory_analysis breakdown: no PyTorch counterpart.
XLA_ONLY = {"arg_bytes", "output_bytes", "temp_bytes",
            "generated_code_bytes"}


@pytest.fixture(autouse=True)
def _clean_ledgers():
    for led in (perf.ledger(), jax_perf.ledger()):
        led.reset()
        led.detach()
    yield
    for led in (perf.ledger(), jax_perf.ledger()):
        led.reset()
        led.detach()


def _cfg(n, backend="dense", cls=SimulationConfig, **kw):
    kw.setdefault("model", "random")
    kw.setdefault("dt", 3600.0)
    kw.setdefault("steps", 10)
    kw.setdefault("integrator", "leapfrog")
    return cls(n=n, force_backend=backend, **kw)


def _nlist_rcut(n):
    pos = make_initial_state(_cfg(n), "cpu").positions
    return float((pos.max(dim=0).values - pos.min(dim=0).values).max()) * 0.2


def _solo_row(backend, n=256, **kw):
    sim = Simulator(_cfg(n, backend, **kw), device="cpu")
    st = sim.state
    sim.run_block(st, sim.initial_carry(st), n_steps=1)
    return perf.ledger().row_for(sim._run_block.key)


def _jax_dense_row(n=256, integrator="leapfrog"):
    sim = JaxSimulator(_cfg(n, cls=JaxConfig, integrator=integrator))
    st = sim.state
    sim._run_block(st, init_carry(sim.accel_fn, st), n_steps=1, record=False)
    return sim, jax_perf.ledger().row_for(sim._run_block.key)


def _assert_row(row, backend, site="solo_block"):
    assert row is not None, backend
    assert row["site"] == site and row["backend"] == backend
    assert row["compile_s"] > 0.0 and row["analytic_flops"] > 0.0
    for field in ("flops", "bytes_accessed", "transcendentals",
                  "peak_bytes", "model_ratio"):
        assert perf.finite(row.get(field)), (backend, field, row)
    assert row["flops"] > 0 and row["bytes_accessed"] > 0
    assert row["flops_source"] == "counted"
    assert row["peak_source"] == "counted_live_bytes"


@pytest.mark.parametrize("backend", ["dense", "chunked", "pallas", "nlist",
                                     "tree", "sfmm"])
def test_ledger_row_for_each_solo_family(backend):
    kw = {"nlist_rcut": _nlist_rcut(256)} if backend == "nlist" else {}
    row = _solo_row(backend, **kw)
    _assert_row(row, backend)
    _, jax_row = _jax_dense_row(64)
    assert set(jax_row) - XLA_ONLY <= set(row), set(jax_row) - set(row)
    if backend in ("dense", "chunked", "pallas"):
        # The JAX suite's band for the direct sums (pair work plus the
        # integrator's elementwise ops).
        assert 0.8 <= row["model_ratio"] <= 3.0, row


def test_ledger_row_for_a_serve_key():
    cfg = _cfg(24, steps=4)
    engine = EnsembleEngine("cpu")
    key = batch_key_for(cfg, slots=2, device="cpu")
    batch = engine.new_batch(key)
    batch = engine.load_slot(batch, 0, make_initial_state(cfg, "cpu"),
                             dt=cfg.dt, steps=4)
    engine.run_slice(batch, 4)
    engine.run_slice(batch, 4)
    row = perf.ledger().row_for(perf.engine_key_str(key))
    _assert_row(row, key.backend, site="serve_round")
    assert row["job_type"] == "integrate" and row["slots"] == 2
    assert 0.8 <= row["model_ratio"] <= 3.0, row
    # One build, one row: the second round runs plain.
    assert engine.compile_counts[key] == 1
    assert perf.ledger().compile_count(perf.engine_key_str(key)) == 1


@pytest.mark.parametrize("backend,n,evals,tiles", [
    ("dense", 256, 1, None), ("pallas", 1000, 3, None),
    ("pallas-mxu", 4096, 1, None), ("chunked", 2, 1, None),
    ("nlist", 512, 1, 8**3 * 27 * 16 * 16), ("nlist", 512, 3, None),
    ("tree", 100_000, 1, None), ("sfmm", 1 << 20, 1, None),
    ("fmm", 256, 3, None), ("dense", 1, 1, None)])
def test_analytic_flops_equals_jax(backend, n, evals, tiles):
    got = perf.analytic_flops(backend, n, force_evals=evals,
                              evaluated_pairs=tiles)
    want = jax_perf.analytic_flops(backend, n, force_evals=evals,
                                   evaluated_pairs=tiles)
    assert got == want


@pytest.mark.parametrize("n,integrator", [(128, "leapfrog"),
                                          (256, "leapfrog"),
                                          (256, "euler"),
                                          (256, "yoshida4")])
def test_counted_flops_within_a_factor_of_xla(n, integrator):
    """The same state through both packages' dense block: counted flops
    0.9-1.1 of XLA's cost_analysis (measured 0.957), the same
    transcendentals (one rsqrt a pair), and at least XLA's bytes (eager
    ops move every temporary; XLA fuses them)."""
    jax_sim, want = _jax_dense_row(n, integrator)
    arrays = [np.asarray(a) for a in (jax_sim.state.positions,
                                      jax_sim.state.velocities,
                                      jax_sim.state.masses)]
    sim = Simulator(_cfg(n, integrator=integrator),
                    state_from_numpy(*arrays, device="cpu"), device="cpu")
    sim.run_block(sim.state, sim.initial_carry(), n_steps=1)
    got = perf.ledger().row_for(sim._run_block.key)
    assert 0.9 <= got["flops"] / want["flops"] <= 1.1, (got, want)
    assert got["transcendentals"] == want["transcendentals"]
    assert got["bytes_accessed"] >= want["bytes_accessed"]


def test_loop_counted_once():
    """One step's cost whatever the block's length (XLA counts a loop
    body once): a 7-step block's row reads as a 1-step block's."""
    sim = Simulator(_cfg(128), device="cpu")
    st, acc = sim.state, sim.initial_carry()
    sim.run_block(st, acc, n_steps=1)
    r1 = perf.ledger().row_for(sim._run_block.key)
    sim.run_block(st, acc, n_steps=7)
    r7 = perf.ledger().row_for(sim._run_block.key)
    assert r1["flops"] == r7["flops"]
    assert r1["model_ratio"] == r7["model_ratio"]
    assert (r1["n_steps"], r7["n_steps"]) == (1, 7)
    # Each signature once: the same calls again add no row.
    rows = len(perf.ledger().rows_list())
    sim.run_block(st, acc, n_steps=7)
    assert len(perf.ledger().rows_list()) == rows


@pytest.mark.parametrize("backend", ["dense", "tree"])
def test_instrumented_block_gives_the_plain_bits(backend):
    """A run through the instrumented block (its first block counted)
    ends on the bits of the plain block function, and its stats carry
    the rows."""
    cfg = _cfg(64, backend, steps=20, progress_every=7)
    stats = Simulator(cfg, device="cpu").run()
    assert stats["perf"] and all(r["site"] == "solo_block"
                                 for r in stats["perf"])
    sim = Simulator(cfg, device="cpu")
    st, acc = sim.state, sim.initial_carry()
    step = sim._step_fn(st.masses)
    for n_steps in (7, 7, 6):
        st, acc, _ = sim._block_fn(st, acc, step, n_steps=n_steps)
    assert torch.equal(stats["final_state"].positions, st.positions)
    assert torch.equal(stats["final_state"].velocities, st.velocities)


def test_uncounted_windows_add_no_row():
    """bench's timed block runs uncounted: its only row is the warm-up
    signature's."""
    from gravity_tpu_torch.bench import run_benchmark

    run_benchmark(_cfg(64), warmup_steps=2, bench_steps=3, device="cpu")
    rows = perf.ledger().rows_list()
    assert [r["n_steps"] for r in rows] == [2]
    with perf.uncounted():
        _solo_row("dense", n=64)
    assert len(perf.ledger().rows_list()) == 1


def test_perf_ledger_jsonl_persistence(tmp_path):
    perf.ledger().attach(out_dir=str(tmp_path))
    _solo_row("dense", n=64)
    rows = perf.read_ledger(str(tmp_path / perf.LEDGER_FILE))
    assert rows and rows[0]["event"] == "perf_compile"
    assert rows[0]["backend"] == "dense"
    assert perf.finite(rows[0]["model_ratio"])
    assert perf.summarize_rows(rows + rows)[0]["key"] == rows[0]["key"]


def test_autotune_probe_site_label(tmp_path, monkeypatch):
    """The probe's block rows carry the site autotune_probe; its probe ms
    reach the attached registry."""
    from gravity_tpu_torch.autotune import resolve_backend_measured

    monkeypatch.setenv("GRAVITY_TPU_TUNE_DIR", str(tmp_path / "tune"))
    tele = Telemetry(out_dir=str(tmp_path), worker="w-probe")
    perf.ledger().attach(registry=tele.registry)
    cfg = _cfg(64, "auto")
    resolve_backend_measured(cfg, make_initial_state(cfg, "cpu"),
                             device="cpu", candidates=("dense", "chunked"),
                             refresh=True)
    rows = perf.ledger().rows_list()
    assert {r["site"] for r in rows} == {"autotune_probe"}
    assert {r["backend"] for r in rows} == {"dense", "chunked"}
    snap = tele.registry.snapshot()
    assert snap["gravity_autotune_probe_ms"]["series"]


def test_recompile_storm_event_and_dump(tmp_path):
    events = []
    tele = Telemetry(out_dir=str(tmp_path), worker="w-test")
    perf.ledger().attach(out_dir=str(tmp_path), recorder=tele.recorder,
                         event_hook=lambda kind, **f: events.append(
                             (kind, f)))
    led = perf.ledger()
    old = led.storm_threshold
    led.storm_threshold = 2
    try:
        sim = Simulator(_cfg(16), device="cpu")
        st, acc = sim.state, sim.initial_carry()
        # Distinct signatures a call: the churn of a shape leak.
        for k in range(4):
            sim.run_block(st, acc, n_steps=1 + k)
    finally:
        led.storm_threshold = old
    storm = [e for e in events if e[0] == "recompile_storm"]
    assert len(storm) == 1, events  # edge-triggered: once a key
    assert storm[0][1]["key"] == sim._run_block.key
    assert storm[0][1]["compiles"] == 3
    dumps = [f for f in os.listdir(tmp_path) if f.startswith("flightrec_")]
    assert dumps, "the storm did not dump the flight recorder"
    doc = json.load(open(tmp_path / dumps[0]))
    assert doc["reason"] == "recompile_storm"


def test_promoted_metrics_scrapeable():
    from gravity_tpu_torch.serve import EnsembleScheduler

    with EnsembleScheduler(slots=2, slice_steps=10, device="cpu") as sched:
        jid = sched.submit(_cfg(12, steps=30))
        sched.run_until_idle()
        assert sched.jobs[jid].status == "completed"
        text = sched.telemetry.registry.prometheus_text()
    parsed = parse_prometheus_text(text)
    for name in ("gravity_compile_seconds", "gravity_program_flops",
                 "gravity_program_peak_bytes"):
        assert name in parsed, name
    samples = parsed["gravity_program_flops"]["samples"]
    assert samples and all(v > 0 for v in samples.values())


# --- the counter's rules ---

def test_counter_counts_as_xla_does():
    a, b = torch.ones(4, 5), torch.ones(5, 3)
    c = perf.CostCounter()
    with c:
        x = a * 2.0                      # 20 elementwise
        y = x.sum(dim=1)                 # 20 input elements
        z = a @ b                        # 2 m n k = 120
        r = torch.rsqrt(y)               # 4 transcendentals, no flop
        a.view(20).reshape(5, 4)         # views: nothing
        torch.sort(y)                    # 4 ceil(log2 4) = 8
        torch.zeros(3).index_add_(0, torch.tensor([0, 0, 1]),
                                  torch.ones(3))  # 3 updates
    assert c.flops == 20 + 20 + 120 + 8 + 3
    assert c.transcendentals == 4
    assert c.bytes_accessed > 0
    del z, r


def test_count_launch_adds_to_the_active_counter_only():
    perf.count_launch(10.0, 20.0, 3.0)  # no counter: nothing, no error
    c = perf.CostCounter()
    with c:
        perf.count_launch(10.0, 20.0, 3.0)
    perf.count_launch(10.0, 20.0, 3.0)
    assert (c.flops, c.bytes_accessed, c.transcendentals, c.launches) \
        == (10.0, 20.0, 3.0, 1)


def test_counter_leaves_results_alone():
    g = torch.Generator().manual_seed(0)
    p = torch.rand(200, 3, generator=g)
    m = torch.rand(200, generator=g)
    with perf.CostCounter(track_live=True) as c:
        got = accelerations_vs(p, p, m, g=1.0, eps=0.05)
    assert torch.equal(got, accelerations_vs(p, p, m, g=1.0, eps=0.05))
    assert c.peak_live >= 200 * 200 * 3 * 4  # the (n, n, 3) differences


@pytest.mark.parametrize("m,k,block_m,tile,batch", [
    (50_000, 50_000, 128, 256, 1), (8192, 8192, 64, 256, 4),
    (1, 3, 128, 256, 1)])
def test_kernel_cost_estimates_are_the_tpu_formulas(m, k, block_m, tile,
                                                    batch):
    """Each wrapper reports its TPU kernel's pl.CostEstimate at its own
    padding, B times on a batched launch."""
    mp = -(-m // block_m) * block_m
    kp = -(-k // tile) * tile
    assert direct_kernel.cost_estimate(m, k, block_m=block_m, tile=tile,
                                       batch=batch) == (
        batch * 20 * mp * kp, batch * (mp * 3 + 2 * kp * 4) * 4,
        batch * mp * kp)
    assert mxu_kernel.cost_estimate(m, k, block_m=block_m, tile=tile,
                                    batch=batch) == (
        batch * 22 * mp * kp, batch * ((mp * 3 + kp * 8) * 4 + mp * 16),
        batch * mp * kp)
    cells, t_cap, cap = 12**3, 256, 256
    assert nlist.pair_cost_estimate(cells, t_cap, cap, batch) == (
        batch * 21 * cells * 27 * t_cap * cap,
        batch * (cells * t_cap * 3 * 2 + cells * 27 * cap * 4) * 4,
        batch * cells * 27 * t_cap * cap)


def test_finite():
    assert perf.finite(1.0) and not perf.finite(math.nan)
    assert not perf.finite(None) and not perf.finite("x")
