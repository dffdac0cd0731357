"""The port's perf gate (``gravity_tpu_torch/perfgate.py``) on the CPU,
beside the JAX package's (``gravity_tpu/perfgate.py``).

The gate's arithmetic runs on synthetic arm timers, the same ones in both
packages, so the verdicts and measured values under the planted
handicaps are compared exactly; the count and coverage contracts and the
real arms run at small n on temporary baselines. No test writes the JAX
package's ``PERF_GATE_LAST.json`` or touches ``PERF_BASELINE.json``.
"""

import hashlib
import json
import math
import os

import pytest

from gravity_tpu import perfgate as jax_perfgate
from gravity_tpu_torch import perfgate
from gravity_tpu_torch.cli import main
from gravity_tpu_torch.telemetry import perf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FILES = ("PERF_BASELINE.json", "PERF_GATE_LAST.json")

TIMES = {("chunked", 512): 0.10, ("nlist", 512): 0.02,
         ("nlist", 2048): 0.05}
SPEEDUP = {"name": "speedup", "kind": "paired_ratio_min", "min_ratio": 2.0,
           "params": {"n": 512, "reps": 5}}
SCALING = {"name": "scaling", "kind": "scaling_exponent_max",
           "max_exponent": 1.7,
           "params": {"n_small": 512, "n_large": 2048, "reps": 5}}


@pytest.fixture(autouse=True)
def _clean_ledger():
    perf.ledger().reset()
    yield
    perf.ledger().reset()


def _digests():
    return {f: hashlib.sha256(open(os.path.join(ROOT, f), "rb").read())
            .hexdigest() for f in JAX_FILES}


def _baseline(tmp_path, contracts, name="PERF_BASELINE.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"v": 1, "contracts": contracts}))
    return str(path)


def _fake_arms(monkeypatch, times=TIMES):
    """Synthetic per-(backend, n) timers in both packages' gates."""
    monkeypatch.setattr(
        perfgate, "_pair_arm",
        lambda backend, n, s, e, device=None: lambda: float(times[(backend,
                                                                   n)]))
    monkeypatch.setattr(
        jax_perfgate, "_pair_arm",
        lambda backend, n, s, e: lambda: float(times[(backend, n)]))


def _quiet(*_):
    pass


def test_gate_clean_passes_and_writes_report(tmp_path, monkeypatch):
    _fake_arms(monkeypatch)
    baseline = _baseline(tmp_path, [SPEEDUP, SCALING])
    out = str(tmp_path / "report.json")
    logs = []
    code, report = perfgate.run_gate(baseline, report_path=out,
                                     log=logs.append, device="cpu")
    assert code == 0 and report["ok"] and report["device"] == "cpu"
    doc = json.load(open(out))
    by_name = {r["name"]: r for r in doc["results"]}
    assert by_name["speedup"]["measured"] == pytest.approx(5.0)
    assert by_name["scaling"]["measured"] == pytest.approx(
        math.log(2.5) / math.log(4.0), rel=1e-6)
    assert any("all contracts hold" in line for line in logs)


@pytest.mark.parametrize("handicap", [
    None,
    {"contract": "speedup", "arm": "b", "factor": 8.0},
    {"contract": "*", "arm": "both", "factor": 2.0},
    {"contract": "scaling", "arm": "b", "factor": 16.0},
    {"contract": "*", "arm": "a", "factor": 0.1},
])
def test_gate_outcomes_equal_the_jax_gate(tmp_path, monkeypatch, handicap):
    """Under each planted handicap the two gates give the same exit code,
    verdicts, measured values and CIs on the same arm times."""
    _fake_arms(monkeypatch)
    if handicap is not None:
        monkeypatch.setenv("GRAVITY_TPU_PERF_HANDICAP", json.dumps(handicap))
    baseline = _baseline(tmp_path, [SPEEDUP, SCALING])
    code, rep = perfgate.run_gate(baseline, report_path=None, log=_quiet,
                                  device="cpu")
    jcode, jrep = jax_perfgate.run_gate(baseline, report_path=None,
                                        log=_quiet)
    assert code == jcode
    for got, want in zip(rep["results"], jrep["results"]):
        assert (got["ok"], got["measured"], got["ci"]) == (
            want["ok"], want["measured"], want["ci"])


def test_gate_planted_regression_fails_with_structured_report(
        tmp_path, monkeypatch):
    _fake_arms(monkeypatch)
    monkeypatch.setenv("GRAVITY_TPU_PERF_HANDICAP", json.dumps(
        {"contract": "speedup", "arm": "b", "factor": 8.0}))
    baseline = _baseline(tmp_path, [SPEEDUP])
    logs = []
    code, report = perfgate.run_gate(baseline, report_path=None,
                                     log=logs.append, device="cpu")
    assert code == 1 and not report["ok"]
    r = report["results"][0]
    assert not r["ok"] and r["measured"] == pytest.approx(0.625)
    assert r["ci"] is not None and r["bound"] == 2.0
    violated = [line for line in logs if "VIOLATED" in line]
    assert violated and "speedup" in violated[0] and baseline in violated[0]


def test_gate_both_arm_slowdown_cannot_flip_ratios(tmp_path, monkeypatch):
    _fake_arms(monkeypatch)
    baseline = _baseline(tmp_path, [SPEEDUP, SCALING])
    code_clean, rep_clean = perfgate.run_gate(
        baseline, report_path=None, log=_quiet, device="cpu")
    monkeypatch.setenv("GRAVITY_TPU_PERF_HANDICAP", json.dumps(
        {"contract": "*", "arm": "both", "factor": 2.0}))
    code_slow, rep_slow = perfgate.run_gate(
        baseline, report_path=None, log=_quiet, device="cpu")
    assert code_clean == code_slow == 0
    for a, b in zip(rep_clean["results"], rep_slow["results"]):
        assert a["measured"] == pytest.approx(b["measured"])


def test_gate_count_and_coverage_contracts_ignore_the_handicap(
        tmp_path, monkeypatch):
    monkeypatch.setenv("GRAVITY_TPU_PERF_HANDICAP", json.dumps(
        {"contract": "*", "arm": "both", "factor": 2.0}))
    baseline = _baseline(tmp_path, [
        {"name": "compile_once", "kind": "count_max", "max_count": 1,
         "params": {"n": 12, "steps": 20, "slice_steps": 10}},
        {"name": "cov", "kind": "ledger_coverage",
         "params": {"n": 64, "families": ["dense", "serve"]}},
    ])
    code, report = perfgate.run_gate(baseline, report_path=None, log=_quiet,
                                     device="cpu")
    assert code == 0, report
    assert [r["measured"] for r in report["results"]] == [1.0, 2.0]


def test_gate_unknown_contract_and_bad_baseline(tmp_path):
    baseline = _baseline(tmp_path, [{"name": "x", "kind": "paired_ratio_min",
                                     "min_ratio": 1.0, "params": {}}])
    with pytest.raises(ValueError, match="unknown contract"):
        perfgate.run_gate(baseline, contracts=["nope"], report_path=None,
                          log=_quiet, device="cpu")
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"v": 1, "contracts": [
        {"name": "y", "kind": "martingale"}]}))
    with pytest.raises(ValueError, match="unknown kind"):
        perfgate.load_baseline(str(bad))
    (tmp_path / "flat.json").write_text("[]")
    with pytest.raises(ValueError, match="baseline must be"):
        perfgate.load_baseline(str(tmp_path / "flat.json"))


def test_gate_handicapped_run_never_persists(tmp_path, monkeypatch):
    _fake_arms(monkeypatch)
    baseline = _baseline(tmp_path, [SPEEDUP])
    out = str(tmp_path / "report.json")
    monkeypatch.setenv("GRAVITY_TPU_PERF_HANDICAP", json.dumps(
        {"contract": "*", "arm": "both", "factor": 2.0}))
    code, _ = perfgate.run_gate(baseline, report_path=out, log=_quiet,
                                device="cpu")
    assert code == 0 and not os.path.exists(out)
    monkeypatch.delenv("GRAVITY_TPU_PERF_HANDICAP")
    code, _ = perfgate.run_gate(baseline, report_path=out, log=_quiet,
                                device="cpu")
    assert code == 0 and json.load(open(out))["handicap"] is None


HALO = {"name": "halo", "kind": "mesh_paired_ratio_min", "min_ratio": 1.8,
        "params": {"devices": 2, "n_per_device": 256, "reps": 3,
                   "rcut_spacings": 2.5, "eps": 0.05, "worker_timeout": 240}}


@pytest.fixture(scope="module")
def halo_doc():
    """One real measurement of the halo contract: 2 gloo ranks of the CPU
    spawned by the gate's worker, 512 bodies."""
    return perfgate._spawn_mesh_worker(HALO["params"])


def test_halo_contract_measures_on_gloo_ranks(halo_doc, monkeypatch):
    """The allgather and halo arms interleaved on 2 gloo ranks: finite
    positive pairs at the halo's sizing, the two arms' forces equal to
    1e-5 of the mean |a|, and the gate's verdict is the measured one."""
    assert halo_doc["devices"] == 2 and halo_doc["n"] == 512
    assert len(halo_doc["pairs"]) == 3
    assert all(t > 0 and math.isfinite(t) for p in halo_doc["pairs"]
               for t in p)
    assert halo_doc["max_gap_over_mean_a"] <= 1e-5
    monkeypatch.setattr(perfgate, "_spawn_mesh_worker", lambda p: halo_doc)
    logs = []
    r = perfgate.run_mesh_paired_ratio(HALO, logs.append)
    ratios = [a / b for a, b in halo_doc["pairs"]]
    assert r.measured == pytest.approx(sorted(ratios)[1])
    assert r.ok == (r.ci[0] >= HALO["min_ratio"])
    assert r.detail["platform"] == "cpu-gloo"
    assert any("allgather/halo" in line for line in logs)


def test_halo_contract_catches_a_planted_2x_handicap(halo_doc, tmp_path,
                                                     monkeypatch):
    """Bound at the clean run's CI floor: the clean run holds, the halo
    arm slowed 2x in the parent (never in the worker) is VIOLATED with
    every ratio halved; a failed worker is reported violated too."""
    monkeypatch.setattr(perfgate, "_spawn_mesh_worker", lambda p: halo_doc)
    clean = perfgate.run_mesh_paired_ratio(HALO, _quiet)
    bound = dict(HALO, min_ratio=clean.ci[0])
    baseline = _baseline(tmp_path, [bound])
    code, _ = perfgate.run_gate(baseline, report_path=None, log=_quiet,
                                device="cpu")
    assert code == 0
    monkeypatch.setenv("GRAVITY_TPU_PERF_HANDICAP", json.dumps(
        {"contract": "halo", "arm": "b", "factor": 2.0}))
    logs = []
    code, report = perfgate.run_gate(baseline, report_path=None,
                                     log=logs.append, device="cpu")
    (r,) = report["results"]
    assert code == 1 and not r["ok"]
    assert r["measured"] == pytest.approx(clean.measured / 2)
    assert any("VIOLATED" in line and "halo" in line for line in logs)

    def failed(params):
        raise RuntimeError("mesh worker: 2 ranks still running after 1 s")

    monkeypatch.setattr(perfgate, "_spawn_mesh_worker", failed)
    r = perfgate.run_mesh_paired_ratio(HALO, _quiet)
    assert not r.ok and r.measured is None
    assert "worker_failed" in r.detail["error"]


def test_ledger_coverage_all_seven_families():
    res = perfgate.run_ledger_coverage(
        {"name": "cov", "kind": "ledger_coverage",
         "params": {"n": 128, "families": ["dense", "chunked", "pallas",
                                           "nlist", "tree", "sfmm",
                                           "serve"]}},
        _quiet, "cpu")
    assert res.ok and res.measured == 7.0, res.detail
    for fam, row in res.detail["rows"].items():
        assert row["flops_source"] == "counted", fam


def test_real_arms_run_on_the_cpu(tmp_path):
    """The paired and scaling contracts through the port's own cell list
    and chunked sum (no synthetic timer): finite values and CIs."""
    baseline = _baseline(tmp_path, [
        dict(SPEEDUP, params={"n": 512, "reps": 3}),
        dict(SCALING, params={"n_small": 256, "n_large": 1024, "reps": 3}),
        {"name": "gap", "kind": "frac_max", "max_frac": 1.0,
         "params": {"n": 128, "steps": 20, "reps": 1, "block": 10,
                    "ckpt_every": 10}}])
    _, report = perfgate.run_gate(baseline, report_path=None, log=_quiet,
                                  device="cpu")
    for r in report["results"]:
        assert perf.finite(r["measured"]), r
        if r["ci"] is not None:
            assert all(perf.finite(c) for c in r["ci"])
    assert report["results"][2]["ok"]  # a fraction is at most 1


def test_committed_baseline_loads_and_is_complete():
    doc = perfgate.load_baseline(os.path.join(ROOT, "PERF_BASELINE.json"))
    names = {c["name"] for c in doc["contracts"]}
    assert {"ledger_coverage", "nlist_vs_chunked_speedup",
            "nlist_scaling_subquadratic", "host_gap_pipelined",
            "halo_vs_allgather_speedup", "serve_compile_once"} <= names


def test_bench_gate_leaves_the_jax_files_alone(tmp_path, monkeypatch,
                                               capsys):
    """``bench --gate`` on the committed baseline writes its report to
    PERF_GATE_LAST_TORCH.json in the working directory; the JAX package's
    PERF_BASELINE.json and PERF_GATE_LAST.json keep their bytes."""
    before = _digests()
    monkeypatch.chdir(tmp_path)
    rc = main(["bench", "--device", "cpu", "--gate", "--gate-baseline",
               os.path.join(ROOT, "PERF_BASELINE.json"),
               "--gate-contracts", "serve_compile_once"])
    assert rc == 0
    report = json.load(open(tmp_path / perfgate.REPORT_FILE))
    assert [r["name"] for r in report["results"]] == ["serve_compile_once"]
    assert not (tmp_path / "PERF_GATE_LAST.json").exists()
    assert _digests() == before
    assert perfgate.REPORT_FILE == "PERF_GATE_LAST_TORCH.json"
