"""The profiler capture (``gravity_tpu_torch/utils/profiling.trace``) on
the CPU: ``run --profile`` writes a Chrome trace of the run into
``<log_dir>/profile_<timestamp>/``; the daemon's ``POST /profile`` traces
its next round with work, then stops; no profiler is left running after
a block that raises, and the perf counter stays off inside a capture.
"""

import glob
import json
import os
import time

import pytest
import torch

from gravity_tpu_torch.cli import main
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.serve import GravityDaemon, request, wait_for
from gravity_tpu_torch.telemetry import perf
from gravity_tpu_torch.utils.profiling import trace


def _events(path):
    doc = json.load(open(path))
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def test_run_profile_writes_a_trace(tmp_path, capsys):
    log_dir = tmp_path / "logs"
    assert main(["run", "--device", "cpu", "--preset", "reference-mpi",
                 "--steps", "5", "--profile", "--log-dir", str(log_dir)]) \
        == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["steps"] == 5
    (path,) = glob.glob(str(log_dir / "profile_*" / "trace_*.json"))
    names = {e.get("name") for e in _events(path)}
    assert any(n and n.startswith("aten::") for n in names)


def test_trace_stops_when_its_block_raises(tmp_path):
    with pytest.raises(RuntimeError, match="inside"):
        with trace(str(tmp_path)):
            assert not perf.counting_allowed()
            raise RuntimeError("inside")
    assert perf.counting_allowed()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert glob.glob(str(tmp_path / "trace_*.json"))


def test_daemon_profile_traces_the_next_round(tmp_path):
    d = GravityDaemon(str(tmp_path / "spool"), slots=2, slice_steps=10,
                      idle_sleep_s=0.01, device="cpu")
    d.start()
    try:
        spool = d.spool_dir
        out_dir = str(tmp_path / "prof")
        assert request(spool, "POST", "/profile", {"rounds": "x"})[
            "error"] == "rounds must be an integer"
        assert "error" in request(spool, "POST", "/profile", {"rounds": -1})
        ans = request(spool, "POST", "/profile",
                      {"rounds": 1, "dir": out_dir})
        assert ans == {"profiling_rounds": 1, "dir": out_dir}
        cfg = SimulationConfig(model="random", n=10, steps=30, dt=3600.0,
                               integrator="leapfrog", force_backend="dense")
        job = request(spool, "POST", "/submit",
                      {"config": json.loads(cfg.to_json())})["job"]
        assert wait_for(spool, [job], timeout=60)[job]["status"] \
            == "completed"
        deadline = time.time() + 10
        while not glob.glob(os.path.join(out_dir, "trace_*.json")):
            assert time.time() < deadline, "no trace written"
            time.sleep(0.05)
        # Exactly the asked round: three rounds ran, one trace.
        assert len(glob.glob(os.path.join(out_dir, "trace_*.json"))) == 1
        assert d._profile_rounds == 0
    finally:
        d.stop()
