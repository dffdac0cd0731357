"""The port's benchmark harness (``gravity_tpu_torch/bench.py``) and the
CLI's ``bench`` verb and config flags, on the CPU, against the JAX
package's ``gravity_tpu/bench.py`` and ``gravity_tpu/cli.py``.

``run_benchmark`` gives the JAX package's stats keys and the same pair
count for the same configuration (the times are the CPU's, no device
metric); the same argv through both packages' ``build_config`` gives the
same field values.
"""

import argparse
import dataclasses
import json
import time

import pytest
import torch

from gravity_tpu.bench import run_benchmark as jax_run_benchmark
from gravity_tpu.cli import _add_config_args as jax_add_config_args
from gravity_tpu.cli import build_config as jax_build_config
from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu_torch import bench
from gravity_tpu_torch.cli import _add_config_args, build_config, main
from gravity_tpu_torch.config import NotPortedError, SimulationConfig

RUN = dict(model="plummer", n=512, dt=3600.0, eps=1.0e9,
           integrator="leapfrog")


@pytest.fixture(autouse=True)
def _tune_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("GRAVITY_TPU_TUNE_DIR", str(tmp_path / "tuning"))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("fields", [
    dict(force_backend="direct"), dict(force_backend="auto"),
    dict(force_backend="dense", integrator="yoshida4"),
    dict(force_backend="nlist", nlist_rcut=3e11),
    dict(force_backend="tree")])
def test_run_benchmark_has_the_jax_keys_and_pair_count(fields):
    kw = {**RUN, **fields}
    got = bench.run_benchmark(SimulationConfig(**kw), warmup_steps=1,
                              bench_steps=2, device="cpu")
    want = jax_run_benchmark(JaxConfig(**kw), warmup_steps=1, bench_steps=2)
    assert set(got) == set(want)
    for key in ("n", "steps", "pair_interactions", "model", "integrator",
                "sharding", "dtype", "platform", "autotune_cache",
                "autotune_probe_ms", "flops_per_pair", "peak_tflops", "mfu",
                "device_kind", "formulation"):
        assert got[key] == want[key], key
    assert got["pair_interactions"] == 512 * 511 * 2 * (
        3 if kw["integrator"] == "yoshida4" else 1)
    assert got["total_time_s"] > 0


def test_nlist_benchmark_reports_both_rates():
    cfg = SimulationConfig(**RUN, force_backend="nlist", nlist_rcut=3e11)
    stats = bench.run_benchmark(cfg, warmup_steps=1, bench_steps=3,
                                device="cpu")
    side, cap = stats["nlist_side"], stats["nlist_cap"]
    slots = side**3 * 27 * cap * cap
    assert stats["evaluated_pairs_per_sec_per_chip"] == pytest.approx(
        slots * 3 / stats["total_time_s"])
    assert stats["dense_equiv_pairs_per_sec"] == stats[
        "pairs_per_sec_per_chip"]
    assert stats["formulation"] == "nlist" and stats["mfu"] is None


def test_main_prints_one_headline_line(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    monkeypatch.setenv("BENCH_N", "300")
    monkeypatch.setenv("BENCH_STEPS", "2")
    assert bench.main() == 0
    line = json.loads(capsys.readouterr().out.strip())
    assert line["metric"] == "pair_interactions_per_sec_per_chip"
    assert line["unit"] == "pairs/s/chip"
    assert line["vs_baseline"] == pytest.approx(line["value"] / 1e11)
    assert line["n"] == 300 and line["backend"] == "dense"
    assert line["platform"] == "cpu" and line["nvidia_smi"] is None
    assert line["autotune_cache"] == "off"
    assert line["torch"] == torch.__version__
    # no card: no clock window after the timed one
    assert line["sm_clock_mhz"] is None and line["sm_clock_steps"] == 0
    monkeypatch.setenv("BENCH_BACKEND", "nlist")
    assert bench.main() == 0
    line = json.loads(capsys.readouterr().out.strip())
    assert line["pairs_metric"] == "dense_equiv_pairs_per_sec"
    assert line["nlist_rcut"] > 0 and line["nlist_side"] >= 1
    assert line["evaluated_pairs_per_sec_per_chip"] > 0


def test_sm_clock_is_sampled_in_a_load_window_of_its_own(monkeypatch):
    """The sampler runs only while ``load`` repeats (after the timed
    window), for min_s at least and until a sample came; without
    nvidia-smi it stops at min_s with no sample."""
    monkeypatch.setattr(bench, "nvidia_smi", lambda query: "1980 MHz")
    loads = []

    def load():
        loads.append(1)
        time.sleep(0.01)
        return 4

    samples, steps = bench.sm_clock_under_load(load, min_s=0.05)
    assert samples and set(samples) == {1980.0}
    assert steps == 4 * len(loads) and len(loads) >= 5
    monkeypatch.setattr(bench, "nvidia_smi", lambda query: None)
    loads.clear()
    samples, steps = bench.sm_clock_under_load(load, min_s=0.05, max_s=10)
    assert samples == [] and steps == 4 * len(loads)
    assert len(loads) < 50


def test_main_needs_a_card_unless_the_cpu_is_asked(monkeypatch, capsys):
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() == 1
    assert capsys.readouterr().out == ""


def test_bench_verb_prints_the_stats(capsys):
    assert main(["bench", "--device", "cpu", "--model", "plummer", "--n",
                 "200", "--eps", "1e9", "--integrator", "leapfrog",
                 "--warmup", "1", "--bench-steps", "2"]) == 0
    stats = json.loads(capsys.readouterr().out.strip())
    assert stats["n"] == 200 and stats["steps"] == 2
    assert stats["pair_interactions"] == 200 * 199 * 2


@pytest.mark.parametrize("flag,item", [("--report", "item 10"),
                                       ("--gate", "item 8")])
def test_bench_modes_not_ported_name_their_item(flag, item, tmp_path,
                                                capsys):
    """``--report`` is still refused (item 10). ``--gate`` (item 8, now
    ported) runs: a one-contract temporary baseline, its report beside
    it."""
    if flag == "--gate":
        baseline = tmp_path / "baseline.json"
        baseline.write_text(json.dumps({"v": 1, "contracts": [
            {"name": "compile_once", "kind": "count_max", "max_count": 1,
             "params": {"n": 12, "steps": 20, "slice_steps": 10}}]}))
        out = tmp_path / "report.json"
        assert main(["bench", "--device", "cpu", "--gate",
                     "--gate-baseline", str(baseline),
                     "--gate-out", str(out)]) == 0
        assert "all contracts hold" in capsys.readouterr().out
        assert json.load(open(out))["results"][0]["measured"] == 1.0
        return
    with pytest.raises(NotPortedError, match=item):
        main(["bench", "--device", "cpu", "--n", "64", flag])


@pytest.mark.parametrize("mode", ["on", "off"])
def test_bench_cadence_runs_with_trajectories_and_checkpoints(mode, capsys):
    """``bench --cadence``: a whole run with trajectories and a checkpoint
    every block (progress_every), through the pipeline or the serial
    loop; its line carries steps_per_sec and host_gap_frac."""
    assert main(["bench", "--device", "cpu", "--n", "64", "--steps", "40",
                 "--progress-every", "10", "--cadence", "--io-pipeline",
                 mode]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["io_pipeline"] == mode and stats["steps"] == 40
    assert stats["checkpoint_every"] == 10 and stats["steps_per_sec"] > 0
    assert 0.0 <= stats["host_gap_frac"] <= 1.0


def _parse(add_args, argv):
    p = argparse.ArgumentParser()
    add_args(p)
    return p.parse_args(argv)


def _fields(config) -> dict:
    return dataclasses.asdict(config)


ARGVS = [
    ["--preset", "baseline-16k", "--cutoff", "1e-9", "--chunk", "512",
     "--no-nan-check"],
    ["--model", "random", "--n", "4096", "--no-autotune", "--chunk", "64",
     "--force-backend", "auto", "--eps", "1e9"],
    ["--preset", "baseline-1m", "--tree-near", "nlist", "--steps", "3",
     "--force-backend", "auto"],
    ["--config-json", "CONFIG", "--steps", "7"],
    ["--config-json", "CONFIG", "--no-nan-check", "--cutoff", "0.5"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_build_config_matches_jax(argv, tmp_path):
    """The same argv through both packages' config flags gives the same
    value of every field the port carries; a JSON config written by the
    JAX package is read by both."""
    path = tmp_path / "config.json"
    path.write_text(JaxConfig(model="disk", n=2048, g=1.0, eps=0.05,
                              integrator="leapfrog", chunk=256,
                              autotune=False, nan_check=False).to_json())
    argv = [str(path) if a == "CONFIG" else a for a in argv]
    got = build_config(_parse(_add_config_args, argv))
    want = jax_build_config(_parse(jax_add_config_args, argv))
    want_fields = _fields(want)
    for name, value in _fields(got).items():
        if name == "log_dir" and "--config-json" not in argv:
            # the defaults name their device: gravity_logs_tpu and _gpu
            continue
        assert value == want_fields[name], name
    if "--no-nan-check" in argv:
        assert got.nan_check is False
    if "--no-autotune" in argv or "--config-json" in argv:
        assert got.autotune is False
