"""The per-file parallel driver behind ``gravity_tpu_torch lint``.

Counterpart of ``gravity_tpu/analysis/driver.py``: the default path is
``gravity_tpu_torch`` and the default baseline the port's own
``gravity_tpu_torch/analysis/lint-baseline.json``. The JAX package's
``donation-safety`` and ``trace-purity`` have no counterpart here
(``checkers.JAX_ONLY``): asking for one is a usage error, exit 2.

Each file is parsed once and every checker's per-file pass runs over
that one AST; files fan out across a process pool (pure-AST work, no
imports of the analyzed tree, so workers are cheap and isolated — a
file that crashes a checker degrades to a ``lint-error`` finding, it
does not take down the run). Cross-file passes (telemetry/fault
drift) run in the parent over the merged per-file contributions.

Exit contract (the CI gate): 0 = no non-baselined findings,
1 = findings, 2 = usage/baseline errors. ``--format json`` emits a
machine-readable report for fleet tooling.
"""

from __future__ import annotations

import argparse
import ast
import concurrent.futures
import json
import os
import sys
from typing import Optional

from .checkers import CHECKERS, make_checkers
from .core import Baseline, FileContext, Finding, ProjectContext

DEFAULT_BASELINE = "gravity_tpu_torch/analysis/lint-baseline.json"
DEFAULT_PATH = "gravity_tpu_torch"


def collect_files(paths: list, root: str) -> list:
    out = []
    for p in paths:
        path = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(path) and path.endswith(".py"):
            out.append(path)
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__"
                           and not d.startswith(".")]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return sorted(set(out))


def analyze_file(path: str, root: str, checker_ids=None):
    """One file's full per-file pass. Module-level (picklable) so the
    process pool can ship it. Returns (findings, {checker: contrib})."""
    checkers = make_checkers(checker_ids)
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    try:
        with open(path, encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError, ValueError) as e:
        return [Finding(
            checker="lint-error", path=rel, line=getattr(e, "lineno", 1)
            or 1, col=0,
            message=f"cannot analyze: {type(e).__name__}: {e}",
            key="parse",
        )], {}
    ctx = FileContext(path, root, source, tree)
    findings: list = []
    contribs: dict = {}
    for checker in checkers:
        try:
            findings.extend(checker.check(ctx))
            c = checker.contribute(ctx)
            if c is not None:
                contribs[checker.id] = c
        except Exception as e:  # noqa: BLE001 — a checker bug must
            # surface as a finding, not kill the whole lint run.
            findings.append(Finding(
                checker="lint-error", path=rel, line=1, col=0,
                message=f"checker {checker.id} crashed: "
                        f"{type(e).__name__}: {e}",
                key=f"crash:{checker.id}",
            ))
    return findings, contribs


class Report:
    def __init__(self, findings, baselined, files, baseline):
        self.findings = findings          # non-baselined, sorted
        self.baselined = baselined        # suppressed by the baseline
        self.files = files
        self.baseline = baseline

    def to_json(self) -> dict:
        return {
            "version": 1,
            "files": self.files,
            "findings": [f.to_json() for f in self.findings],
            "baselined": [f.to_json() for f in self.baselined],
            "unused_baseline_entries": (
                self.baseline.unused() if self.baseline else []
            ),
        }


def run_analysis(paths, root, checker_ids=None, jobs: Optional[int] = None,
                 baseline: Optional[Baseline] = None) -> Report:
    root = os.path.abspath(root)
    files = collect_files(paths, root)
    # Default SERIAL: run_analysis is also a library call from pytest
    # (where forking a process that holds torch's threads is asking for
    # trouble); the CLI opts into the pool explicitly.
    jobs = 1 if jobs is None else max(1, jobs)
    per_file: list = []
    contribs: dict = {}

    def absorb(rel_path, result):
        findings, file_contribs = result
        per_file.extend(findings)
        for cid, c in file_contribs.items():
            contribs.setdefault(cid, {})[rel_path] = c

    results = None
    if jobs > 1 and len(files) > 1:
        try:
            with concurrent.futures.ProcessPoolExecutor(
                    max_workers=jobs) as pool:
                results = list(pool.map(
                    analyze_file, files, [root] * len(files),
                    [checker_ids] * len(files),
                    chunksize=max(1, len(files) // (jobs * 4)),
                ))
        except (OSError, concurrent.futures.process.BrokenProcessPool):
            results = None   # fall back to in-process below
    if results is None:
        results = [analyze_file(f, root, checker_ids) for f in files]
    for path, result in zip(files, results):
        absorb(os.path.relpath(path, root).replace(os.sep, "/"), result)

    project = ProjectContext(
        root,
        [os.path.relpath(f, root).replace(os.sep, "/") for f in files],
        contribs,
    )
    for checker in make_checkers(checker_ids):
        per_file.extend(checker.finalize(project))

    per_file.sort(key=lambda f: (f.path, f.line, f.col, f.checker))
    if baseline is None:
        findings, baselined = per_file, []
    else:
        findings = [f for f in per_file if not baseline.matches(f)]
        baselined = [f for f in per_file if baseline.matches(f)]
    return Report(findings, baselined, len(files), baseline)


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gravity_tpu_torch lint",
        description="AST invariant analyzer "
                    "(gravity_tpu_torch/docs/static-analysis.md)",
    )
    p.add_argument("paths", nargs="*", default=None,
                   help=f"files/dirs to analyze (default: {DEFAULT_PATH}/ "
                        "under --root)")
    p.add_argument("--root", default=".",
                   help="tree root: relpaths, docs lookups, and the "
                        "default baseline resolve against it")
    p.add_argument("--format", choices=["text", "json"], default="text")
    p.add_argument("--baseline", default=None,
                   help=f"suppression file (default: "
                        f"<root>/{DEFAULT_BASELINE} when present)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline (report everything)")
    p.add_argument("--jobs", type=int, default=None,
                   help="parallel analysis processes (default: "
                        "min(8, cpus); 1 = in-process)")
    p.add_argument("--checkers", default=None,
                   help="comma-separated checker ids to run "
                        "(default: all)")
    p.add_argument("--list-checkers", action="store_true")
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_checkers:
        for cls in CHECKERS:
            print(f"{cls.id:18s} {cls.invariant}")
        return 0
    root = os.path.abspath(args.root)
    paths = args.paths or [DEFAULT_PATH]
    checker_ids = (
        [c.strip() for c in args.checkers.split(",") if c.strip()]
        if args.checkers else None
    )
    try:
        make_checkers(checker_ids)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    baseline = None
    if not args.no_baseline:
        bl_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
        if os.path.exists(bl_path):
            try:
                baseline = Baseline.load(bl_path)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
    try:
        report = run_analysis(
            paths, root, checker_ids=checker_ids,
            jobs=args.jobs or min(8, os.cpu_count() or 1),
            baseline=baseline,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.format == "json":
        print(json.dumps(report.to_json(), indent=1))
    else:
        for f in report.findings:
            print(f.format())
        summary = (
            f"{len(report.findings)} finding(s) in {report.files} "
            f"file(s)"
        )
        if report.baselined:
            summary += f" ({len(report.baselined)} baselined)"
        print(summary)
        for e in (baseline.unused() if baseline else []):
            print(
                f"warning: unused baseline entry "
                f"{e.get('checker')}:{e.get('path')}:{e.get('key')}",
                file=sys.stderr,
            )
    return 1 if report.findings else 0


if __name__ == "__main__":
    sys.exit(main())
