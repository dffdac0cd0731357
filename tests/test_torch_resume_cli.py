"""The port's ``run`` and ``resume`` verbs in subprocesses on the CPU: the
exit codes (0 done, 1 a usage error, 2 a recovery-layer failure with one
stderr JSON line, 75 preempted after a checkpoint), a preempted run
resumed to the uninterrupted run's final checkpoint bit for bit, the
fallback to the older snapshot when the newest is truncated, and an
adaptive resume."""

import json
import os
import subprocess
import sys

import pytest
import torch

from gravity_tpu_torch.utils.checkpoint import (
    make_checkpoint_manager,
    restore_checkpoint,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--device", "cpu", "--model", "random", "--n", "48",
          "--steps", "60", "--progress-every", "10", "--integrator",
          "leapfrog", "--eps", "1e9", "--checkpoint-every", "20"]


def _cli(*args, faults="", cwd=None):
    env = {"PYTHONPATH": REPO_ROOT, "PATH": os.environ.get("PATH", ""),
           "OMP_NUM_THREADS": "1"}
    if faults:
        env["GRAVITY_TPU_FAULTS"] = faults
    return subprocess.run(
        [sys.executable, "-m", "gravity_tpu_torch", *args], env=env,
        cwd=cwd or REPO_ROOT, capture_output=True, text=True, timeout=300)


def _final(ckpt, step):
    state, _ = restore_checkpoint(make_checkpoint_manager(ckpt), step)
    return state


def test_preempt_exits_75_and_resume_is_bitwise(tmp_path):
    """preempt@30: exit 75 with the resumable JSON line; ``resume`` exits 0
    and its step-60 checkpoint equals the uninterrupted run's, bit for
    bit; with the newest snapshot truncated, it resumes from the one
    before and still ends bit for bit."""
    logs = str(tmp_path / "logs")
    straight = str(tmp_path / "straight")
    ran = _cli("run", *COMMON, "--checkpoint-dir", straight, "--log-dir", logs)
    assert ran.returncode == 0, ran.stderr
    ckpt = str(tmp_path / "ckpt")
    pre = _cli("run", *COMMON, "--checkpoint-dir", ckpt, "--log-dir", logs,
               faults="preempt@30")
    assert pre.returncode == 75, pre.stderr
    line = json.loads(pre.stderr.strip().splitlines()[-1])
    assert line["preempted"] and line["resumable"]
    mgr = make_checkpoint_manager(ckpt)
    assert mgr.all_steps() == [20, 30]
    backup = str(tmp_path / "backup")
    os.makedirs(backup)
    for step in (20, 30):
        os.makedirs(os.path.join(backup, str(step)))
        with open(os.path.join(ckpt, str(step), "checkpoint.pt"), "rb") as f:
            data = f.read()
        with open(os.path.join(backup, str(step), "checkpoint.pt"), "wb") as f:
            f.write(data)
    res = _cli("resume", *COMMON, "--checkpoint-dir", ckpt, "--log-dir", logs)
    assert res.returncode == 0, res.stderr
    stats = json.loads(res.stdout.strip().splitlines()[-1])
    assert stats["resumed_at"] == 30 and stats["steps"] == 30
    want = _final(straight, 60)
    got = _final(ckpt, 60)
    assert torch.equal(got.positions, want.positions)
    assert torch.equal(got.velocities, want.velocities)
    # The newest snapshot truncated: resume falls back to step 20.
    path = os.path.join(backup, "30", "checkpoint.pt")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    res = _cli("resume", *COMMON, "--checkpoint-dir", backup,
               "--log-dir", logs)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1])["resumed_at"] == 20
    got = _final(backup, 60)
    assert torch.equal(got.positions, want.positions)


def test_diverged_exits_2_with_one_json_line(tmp_path):
    res = _cli("run", *COMMON, "--checkpoint-dir", str(tmp_path / "c"),
               "--log-dir", str(tmp_path / "logs"), faults="diverge@30")
    assert res.returncode == 2
    err = json.loads(res.stderr.strip().splitlines()[-1])
    assert err["error"] == "diverged" and err["last_finite_step"] == 20
    assert "Traceback" not in res.stderr


def test_auto_recover_heals_and_exits_0(tmp_path):
    res = _cli("run", *COMMON, "--auto-recover", "--checkpoint-dir",
               str(tmp_path / "c"), "--log-dir", str(tmp_path / "logs"),
               faults="diverge@30")
    assert res.returncode == 0, res.stderr
    stats = json.loads(res.stdout.strip().splitlines()[-1])
    assert stats["supervisor"]["diverge_retries"] == 1


def test_usage_error_exits_1(tmp_path):
    res = _cli("run", "--device", "cpu", "--adaptive", "--merge-radius",
               "1e9", "--log-dir", str(tmp_path))
    assert res.returncode == 1 and "merge-radius" in res.stderr


def test_resume_without_checkpoint_exits_2(tmp_path):
    res = _cli("resume", *COMMON, "--checkpoint-dir", str(tmp_path / "none"),
               "--log-dir", str(tmp_path / "logs"))
    assert res.returncode == 2 and "no checkpoint found" in res.stderr


def test_resume_explicit_step_and_past_target(tmp_path):
    ckpt = str(tmp_path / "c")
    logs = str(tmp_path / "logs")
    assert _cli("run", *COMMON, "--checkpoint-dir", ckpt,
                "--log-dir", logs).returncode == 0
    done = _cli("resume", *COMMON, "--checkpoint-dir", ckpt,
                "--log-dir", logs)
    assert done.returncode == 0
    assert "already at/past target" in done.stdout
    again = _cli("resume", *COMMON, "--checkpoint-dir", ckpt,
                 "--log-dir", logs, "--step", "40")
    assert again.returncode == 0, again.stderr
    assert json.loads(again.stdout.strip().splitlines()[-1])["resumed_at"] \
        == 40


def test_adaptive_preempt_and_resume(tmp_path):
    args = ["--device", "cpu", "--model", "plummer", "--n", "32",
            "--steps", "10", "--eps", "1e10", "--adaptive", "--integrator",
            "leapfrog", "--progress-every", "5", "--eta", "0.05",
            "--checkpoint-every", "5", "--checkpoint-dir",
            str(tmp_path / "c"), "--log-dir", str(tmp_path / "logs")]
    pre = _cli("run", *args, faults="preempt@5")
    assert pre.returncode == 75, pre.stderr
    res = _cli("resume", *args)
    assert res.returncode == 0, res.stderr
    stats = json.loads(res.stdout.strip().splitlines()[-1])
    assert stats["resumed_at"] == 5
    assert stats["t_reached"] == pytest.approx(stats["t_end"], rel=1e-5)
