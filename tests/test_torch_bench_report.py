"""The port's ``bench --report`` (``gravity_tpu_torch/bench.py``
``collect_bench_rounds``, ``format_bench_report``) against the JAX
package's (``gravity_tpu/bench.py``), on synthetic round files in
``tmp_path`` (never the repo's own): the same rows and the same text,
apart from the gate report's name, which is the port's own
``PERF_GATE_LAST_TORCH.json`` (and the verb that writes it). Every row
keeps its platform: a ``tpu``/``tpu-cached`` row is never the card's, and
the delta column compares a ``cuda`` row only with ``cuda`` rows. The
report reads files only: no device."""

import contextlib
import io
import json

import pytest
import torch

from gravity_tpu import bench as jax_bench
from gravity_tpu_torch import bench
from gravity_tpu_torch.cli import main as cli_main

GATE = {"v": 1, "ok": True, "ran_at": "2026-10-01T00:00:00Z",
        "results": [{"name": "speedup", "kind": "paired_ratio_min",
                     "ok": True, "measured": 5.0, "bound": 1.5,
                     "ci": [4.0, 6.0], "detail": {}},
                    {"name": "compile_once", "kind": "count_max",
                     "ok": False, "measured": 2.0, "bound": 1.0}]}


def rounds(root, *, gate=True, handicap=False):
    """A tree of every artifact the report folds."""
    lines = [
        {"n": 262144, "backend": "pallas", "platform": "tpu-cached",
         "value": 1.8e11, "avg_step_s": 0.37,
         "measured_at": "2026-07-01T00:00:00Z"},
        {"n": 65536, "backend": "pallas", "platform": "tpu",
         "value": 1.6e11, "avg_step_s": 0.026, "mfu": 0.41,
         "host_gap_frac": 0.012, "autotune_cache": "hit"},
        {"n": 262144, "backend": "nbody_direct", "platform": "cuda",
         "value": 1.8575e12, "avg_step_s": 0.037, "mfu": 0.165,
         "achieved_tflops": 81.7, "host_gap_frac": 0.0},
        {"n": 8192, "backend": "cpp", "platform": "cpu", "value": 2.8e8,
         "avg_step_s": 0.24},
        {"n": 262144, "backend": "nbody_mxu", "platform": "cuda",
         "value": 1.2e12, "avg_step_s": 0.057},
    ]
    for i, line in enumerate(lines, 1):
        (root / f"BENCH_r{i:02d}.json").write_text(json.dumps(
            {"n": i, "rc": 0, "parsed": line}))
    (root / "BENCH_r06.json").write_text("{torn")
    for i, ok in ((1, True), (2, False)):
        (root / f"MULTICHIP_r{i:02d}.json").write_text(json.dumps(
            {"n_devices": 4 * i, "ok": ok, "skipped": False, "rc": 0}))
    (root / "NLIST_SWEEP_CPU.json").write_text("\n".join(json.dumps(r) for r
        in ({"n": 4096, "rcut": 2.5, "platform": "cpu", "side": 6,
             "cap": 32, "s_per_eval": 0.112,
             "dense_equiv_pairs_per_sec": 1.5e8, "speedup_vs_chunked": 3.4},
            {"note": "no n: skipped"})) + "\ntorn{\n")
    (root / "NLIST_TUNE_CPU.json").write_text(json.dumps(
        {"n": 8192, "backend": "nlist", "cache": "miss", "probe_ms": 8038.0,
         "timings_s": {"chunked": 0.809, "nlist": 0.146}}) + "\n")
    tdir = root / "tuning"
    tdir.mkdir()
    (tdir / "abc.json").write_text(json.dumps({
        "key": {"n": 8192, "platform": "cpu", "occupancy": "occ2^0",
                "candidates": ["chunked", "nlist"]},
        "winner": "nlist", "timings_s": {"chunked": 0.809, "nlist": 0.146},
        "errors": {"nlist": {"p90_rel_err": 2e-6}}}))
    (tdir / "noise.json").write_text(json.dumps({"no": "winner"}))
    ledger = [
        {"event": "perf_compile", "key": "k1", "site": "solo_block",
         "backend": "nbody_direct", "n": 16384, "flops": 5.4e9,
         "peak_bytes": 2.1e6, "compile_s": 0.8, "model_ratio": 1.003},
        {"event": "perf_compile", "key": "k2", "site": "serve_round",
         "backend": "nlist", "n": 8192, "flops": 1.1e9},
        {"event": "perf_compile", "key": "k1", "site": "solo_block",
         "backend": "nbody_direct", "n": 16384, "flops": 5.5e9,
         "peak_bytes": 2.2e6, "compile_s": 0.7, "model_ratio": 1.001},
        {"event": "other", "key": "k3"},
    ]
    (root / "perf_ledger.jsonl").write_text(
        "\n".join(json.dumps(r) for r in ledger) + "\n")
    (root / "PERF_BASELINE.json").write_text(json.dumps({"contracts": [
        {"name": "ledger_coverage", "kind": "count_min"},
        {"name": "speedup", "kind": "paired_ratio_min"}]}))
    if gate:
        doc = dict(GATE, handicap={"contract": "speedup", "factor": 2}) \
            if handicap else GATE
        for name in ("PERF_GATE_LAST.json", "PERF_GATE_LAST_TORCH.json"):
            (root / name).write_text(json.dumps(doc))
    return root


def port_text_of(jax_text: str) -> str:
    """The JAX report's text with the port's gate report and verb."""
    return (jax_text.replace("PERF_GATE_LAST.json", bench.GATE_REPORT)
            .replace("`gravity_tpu bench --gate`",
                     "`gravity_tpu_torch bench --gate`"))


def both(root):
    jax_data = jax_bench.collect_bench_rounds(str(root))
    data = bench.collect_bench_rounds(str(root))
    return (jax_data, jax_bench.format_bench_report(jax_data), data,
            bench.format_bench_report(data))


@pytest.mark.parametrize("gate,handicap", [(True, False), (True, True),
                                           (False, False)])
def test_rows_and_text_are_the_jax_packages(tmp_path, gate, handicap):
    jax_data, jax_text, data, text = both(rounds(tmp_path, gate=gate,
                                                 handicap=handicap))
    assert data == jax_data
    assert text == port_text_of(jax_text)
    assert len(data["bench"]) == 5 and data["perf_ledger"]
    if gate:
        assert bench.GATE_REPORT in text
        assert ("injected handicap" in text) == handicap
    else:
        assert f"no {bench.GATE_REPORT} yet" in text


def test_empty_directory(tmp_path):
    jax_data, jax_text, data, text = both(tmp_path)
    assert data == jax_data and text == port_text_of(jax_text)
    assert "(no BENCH_r*.json rounds found)" in text


def test_platform_labels_and_deltas_keep_tpu_and_card_apart(tmp_path):
    """The TPU rows say tpu / tpu-cached (a replay), the card's say cuda;
    the cuda rows' delta compares them with each other only."""
    data = bench.collect_bench_rounds(str(rounds(tmp_path)))
    rows = bench.format_bench_report(data).splitlines()[2:7]
    cols = [r.split() for r in rows]
    assert [(c[3], c[4]) for c in cols] == [
        ("tpu-cached", "replay"), ("tpu", "live"), ("cuda", "live"),
        ("cpu", "live"), ("cuda", "live")]
    assert cols[2][-1] == "-"            # the first cuda row: no delta
    assert cols[4][-1] == f"{1.2e12 / 1.8575e12 - 1.0:+.1%}"
    assert cols[1][-1] == f"{1.6e11 / 1.8e11 - 1.0:+.1%}"


def test_the_jax_gate_report_is_never_read(tmp_path):
    (tmp_path / "PERF_GATE_LAST.json").write_text(json.dumps(GATE))
    assert bench.collect_bench_rounds(str(tmp_path))["perf_gate"] is None
    assert jax_bench.collect_bench_rounds(str(tmp_path))["perf_gate"]


def test_verb_prints_the_report_and_touches_no_device(tmp_path,
                                                      monkeypatch):
    root = rounds(tmp_path)

    def no_device(*a, **k):
        raise AssertionError("bench --report asked for a device")

    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    monkeypatch.setattr("gravity_tpu_torch.utils.platform.resolve_device",
                        no_device)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli_main(["bench", "--report", "--report-dir",
                         str(root)]) == 0
    assert out.getvalue() == bench.format_bench_report(
        bench.collect_bench_rounds(str(root))) + "\n"
