"""The port's AST invariant analyzer (``gravity_tpu_torch/analysis/``) and
its ``lint`` verb, against the JAX package's analyzer on the CPU.

- Each of the four ported checkers flags exactly the ``# LINT-EXPECT``
  lines of its fixture tree under ``tests/lint_fixtures/`` and gives the
  same (checker, path, line, col, key, message) as the JAX checker there.
- The two JAX-only checkers (donation-safety, trace-purity) are refused
  with exit 2 and the reason.
- The contract: lint over ``gravity_tpu_torch/`` with the port's own
  baseline exits 0 and leaves no baseline entry unused.
"""

import contextlib
import io
import json
import os

import pytest

from conftest import REPO_ROOT

from gravity_tpu.analysis import run_analysis as jax_run_analysis
from gravity_tpu_torch.analysis import (
    CHECKER_IDS,
    JAX_ONLY,
    Baseline,
    run_analysis,
)
from gravity_tpu_torch.analysis.driver import DEFAULT_BASELINE
from gravity_tpu_torch.analysis.driver import main as lint_main
from gravity_tpu_torch.cli import main as cli_main

FIXTURES = os.path.join(os.path.dirname(__file__), "lint_fixtures")
FIXTURE_DIRS = {
    "fenced-write": "fencing",
    "flock-weight": "flockweight",
    "telemetry-drift": "telemetry",
    "fault-coverage": "faultspec",
}


def expected_markers(dirpath, checker_id):
    """{(relpath, line)} of every `# LINT-EXPECT: <id>` marker."""
    out = set()
    for fn in sorted(os.listdir(dirpath)):
        if fn.endswith(".py"):
            with open(os.path.join(dirpath, fn)) as f:
                for i, line in enumerate(f, 1):
                    if f"# LINT-EXPECT: {checker_id}" in line:
                        out.add((fn, i))
    return out


def identity(findings):
    return sorted((f.checker, f.path, f.line, f.col, f.key, f.message)
                  for f in findings)


def run_lint(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(["lint", *argv])
    return rc, out.getvalue(), err.getvalue()


def test_registry_is_the_four_ported_checkers():
    assert set(CHECKER_IDS) == set(FIXTURE_DIRS)
    assert set(JAX_ONLY) == {"donation-safety", "trace-purity"}


@pytest.mark.parametrize("checker_id", sorted(FIXTURE_DIRS))
def test_checker_fixtures_match_markers_and_the_jax_checker(checker_id):
    root = os.path.join(FIXTURES, FIXTURE_DIRS[checker_id])
    report = run_analysis([root], root, checker_ids=[checker_id])
    want = expected_markers(root, checker_id)
    assert want
    assert {(f.path, f.line) for f in report.findings} == want
    jax = jax_run_analysis([root], root, checker_ids=[checker_id])
    assert identity(report.findings) == identity(jax.findings)


def test_every_fixture_tree_at_once_matches_the_jax_analyzer():
    """The whole fixture tree, all four checkers, serial and in the
    process pool: the JAX analyzer's findings of those checkers."""
    serial = run_analysis([FIXTURES], FIXTURES, jobs=1)
    pooled = run_analysis([FIXTURES], FIXTURES, jobs=2)
    jax = jax_run_analysis([FIXTURES], FIXTURES, jobs=1)
    ours = [f for f in jax.findings if f.checker in CHECKER_IDS]
    assert identity(serial.findings) == identity(ours)
    assert [f.to_json() for f in pooled.findings] == \
        [f.to_json() for f in serial.findings]


@pytest.mark.parametrize("checker_id", sorted(JAX_ONLY))
def test_jax_only_checkers_are_refused_with_the_reason(checker_id):
    rc, out, err = run_lint(["--checkers", checker_id])
    assert rc == 2 and out == ""
    assert f"{checker_id!r} has no counterpart" in err
    assert "PyTorch" in err


def test_the_port_tree_lints_clean_with_its_own_baseline():
    """THE contract: no finding outside the port's baseline, and no
    unused baseline entry; the baseline is the port's file, never the
    root .lint-baseline.json."""
    assert DEFAULT_BASELINE == "gravity_tpu_torch/analysis/lint-baseline.json"
    baseline = Baseline.load(os.path.join(REPO_ROOT, DEFAULT_BASELINE))
    report = run_analysis([os.path.join(REPO_ROOT, "gravity_tpu_torch")],
                          REPO_ROOT, baseline=baseline)
    assert report.files > 80
    assert report.findings == [], "\n" + "\n".join(
        f.format() for f in report.findings)
    assert baseline.unused() == []
    assert all(e.get("reason") for e in baseline.entries)


def test_lint_verb_defaults_to_the_port_and_exits_0(monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    rc, out, err = run_lint(["--format", "json", "--jobs", "1"])
    doc = json.loads(out)
    assert rc == 0 and doc["findings"] == []
    assert doc["unused_baseline_entries"] == []
    assert doc["files"] > 80


def test_lint_verb_json_and_exit_codes(tmp_path):
    """A planted raw spool write: exit 1 with the finding in --format
    json; the clean tree exit 0; --list-checkers the four."""
    tree = tmp_path / "pkg"
    tree.mkdir()
    (tree / "mod.py").write_text(
        "import os, json\n"
        "def w(spool_dir, rec):\n"
        "    with open(os.path.join(spool_dir, 'jobs', 'a.json'),"
        " 'w') as f:\n"
        "        json.dump(rec, f)\n"
    )
    rc, out, _ = run_lint(["--root", str(tree), "--format", "json",
                           str(tree)])
    doc = json.loads(out)
    assert rc == 1 and doc["files"] == 1
    assert [(f["checker"], f["path"], f["line"]) for f in doc["findings"]] \
        == [("fenced-write", "mod.py", 3)]
    (tree / "mod.py").write_text("x = 1\n")
    assert lint_main(["--root", str(tree), str(tree)]) == 0
    rc, out, _ = run_lint(["--list-checkers"])
    assert rc == 0 and [line.split()[0] for line in out.splitlines()] == \
        list(CHECKER_IDS)


def test_heavy_torch_calls_under_the_flock_are_flagged(tmp_path):
    """The port's flock-weight table adds PyTorch's serialization, the
    device-to-host copy and the fence to the JAX package's."""
    tree = tmp_path / "pkg"
    tree.mkdir()
    (tree / "mod.py").write_text(
        "import torch\n"
        "def f(spool, t, path):\n"
        "    with spool.locked():\n"
        "        torch.save(t, path)\n"
        "        host = t.cpu()\n"
        "        torch.cuda.synchronize()\n"
        "    return host\n"
    )
    report = run_analysis([str(tree)], str(tree),
                          checker_ids=["flock-weight"])
    assert [(f.line, f.key) for f in report.findings] == [
        (4, "f:torch.save"), (5, "f:t.cpu"),
        (6, "f:torch.cuda.synchronize")]
