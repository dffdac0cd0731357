"""telemetry-drift (counterpart of ``gravity_tpu/analysis/checkers/
telemetry_drift.py``; the docs it reads are the port's own, under
``gravity_tpu_torch/docs/``): every event kind, metric name, span name, and
flight-recorder dump reason EMITTED anywhere in the tree must be
DECLARED in its registry constant, and every declared name must be
documented — the generalization of the three hand-rolled docs-lint
tests (tests/test_telemetry.py, test_serve_sharded.py, test_nlist.py)
into one checker with one source of truth.

Declarations are read from the tree's own AST (never imported):

- ``KINDS = ("...", ...)`` class attributes (the JsonlEventLogger
  spine: Run/Recovery/Serving/Metrics/Trace/Perf loggers),
- ``SPAN_NAMES`` / ``DUMP_REASONS`` module tuples,
- ``WORKER_METRICS`` tuple-of-tuples (first element = metric name).

Emissions are literal first arguments of ``.event(``/``._event(``/
``._emit(`` (event kinds), ``.counter(``/``.gauge(``/``.histogram(``
(metric names), ``.span(``/``tracer.emit(`` (span names), and
``.dump(``/``._dump_flightrec(`` (dump reasons).

The finalize pass also pins docs: declared names must appear in
``gravity_tpu_torch/docs/observability.md`` (kinds/spans/reasons
backticked, metrics bare), and the DOC_PINS table — including every
checker id into ``gravity_tpu_torch/docs/static-analysis.md`` — must
hold. Docs checks run only when
the doc files exist under the analysis root, so fixture trees get the
declaration checks without needing a docs/ mirror.
"""

from __future__ import annotations

import ast

from ..core import Checker, Finding, call_name, const_str, str_tuple

# Emission method name -> registry family.
EVENT_METHODS = ("event", "_event", "_emit")
METRIC_METHODS = ("counter", "gauge", "histogram")
SPAN_METHODS = ("span",)
SPAN_EMIT_METHODS = ("emit",)          # Tracer.emit(name, trace, ...)
DUMP_METHODS = ("dump", "_dump_flightrec")

DOCS = "gravity_tpu_torch/docs/"
OBSERVABILITY_DOC = DOCS + "observability.md"
CHECKER_DOC = DOCS + "static-analysis.md"
ROBUSTNESS_DOC = DOCS + "robustness.md"

# Doc-pin table: (needle, root-relative doc) — the port's README section
# and its own docs. Checker ids are pinned dynamically (see finalize).
DOC_PINS = (
    ("The PyTorch/CUDA port: `gravity_tpu_torch/`", "README.md"),
    ("--force-backend nlist", "README.md"),
    ("python -m gravity_tpu_torch lint", "README.md"),
    ("python -m gravity_tpu_torch validate", "README.md"),
    ("python -m gravity_tpu_torch traj", "README.md"),
    ("bench --report", "README.md"),
    ("gravity_tpu_torch.examples", "README.md"),
    ("GRAVITY_TPU_FAULTS", ROBUSTNESS_DOC),
    ("traces.jsonl", OBSERVABILITY_DOC),
    ("lint-baseline.json", CHECKER_DOC),
)


def _declarations(tree: ast.Module) -> dict:
    decl = {"kinds": set(), "metrics": set(), "spans": set(),
            "reasons": set()}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if not isinstance(tgt, ast.Name):
                continue
            if tgt.id == "KINDS":
                vals = str_tuple(node.value)
                if vals:
                    decl["kinds"].update(vals)
            elif tgt.id == "SPAN_NAMES":
                vals = str_tuple(node.value)
                if vals:
                    decl["spans"].update(vals)
            elif tgt.id == "DUMP_REASONS":
                vals = str_tuple(node.value)
                if vals:
                    decl["reasons"].update(vals)
            elif tgt.id == "WORKER_METRICS" and isinstance(
                    node.value, (ast.Tuple, ast.List)):
                for el in node.value.elts:
                    if isinstance(el, (ast.Tuple, ast.List)) and el.elts:
                        name = const_str(el.elts[0])
                        if name:
                            decl["metrics"].add(name)
    return decl


def _emissions(tree: ast.Module) -> list:
    """[(family, name, line, col), ...] — literal-first-arg telemetry
    emissions in one file."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not isinstance(
                node.func, ast.Attribute):
            continue
        meth = node.func.attr
        lit = const_str(node.args[0]) if node.args else None
        if lit is None:
            continue
        if meth in EVENT_METHODS:
            out.append(("kinds", lit, node.lineno, node.col_offset))
        elif meth in METRIC_METHODS:
            # Only audit repo-namespaced instruments: arbitrary
            # .histogram()/.counter() helpers exist in the wild.
            if lit.startswith("gravity_"):
                out.append(("metrics", lit, node.lineno, node.col_offset))
        elif meth in SPAN_METHODS:
            out.append(("spans", lit, node.lineno, node.col_offset))
        elif meth in SPAN_EMIT_METHODS and len(node.args) >= 2:
            out.append(("spans", lit, node.lineno, node.col_offset))
        elif meth in DUMP_METHODS:
            out.append(("reasons", lit, node.lineno, node.col_offset))
    return out


_FAMILY_LABEL = {
    "kinds": ("event kind", "a JsonlEventLogger KINDS tuple"),
    "metrics": ("metric name", "telemetry/metrics.py WORKER_METRICS"),
    "spans": ("span name", "telemetry/tracing.py SPAN_NAMES"),
    "reasons": ("dump reason", "telemetry/flightrec.py DUMP_REASONS"),
}


class TelemetryDrift(Checker):
    id = "telemetry-drift"
    invariant = ("every emitted event kind / metric / span / dump "
                 "reason is declared in its registry and documented")
    bug_class = "undeclared telemetry silently vanishing downstream"
    hint = ("declare the name in its registry tuple AND table it in "
            "gravity_tpu_torch/docs/observability.md")

    def contribute(self, ctx):
        suppressed_lines = [
            e for e in _emissions(ctx.tree)
            if not ctx.line_suppressed(e[2], self.id)
        ]
        return {
            "decl": {k: sorted(v)
                     for k, v in _declarations(ctx.tree).items()},
            "emit": suppressed_lines,
        }

    def finalize(self, project):
        contribs = project.contributions(self.id)
        decl = {"kinds": set(), "metrics": set(), "spans": set(),
                "reasons": set()}
        for c in contribs.values():
            for fam, vals in c["decl"].items():
                decl[fam].update(vals)
        findings = []
        # 1) emitted-but-undeclared (the writer-side drift).
        for rel, c in sorted(contribs.items()):
            for fam, name, line, col in c["emit"]:
                if name in decl[fam]:
                    continue
                label, registry = _FAMILY_LABEL[fam]
                findings.append(Finding(
                    checker=self.id, path=rel, line=line, col=col,
                    message=(f"{label} '{name}' is emitted but not "
                             f"declared in {registry}"),
                    hint=self.hint, key=f"emit:{fam}:{name}",
                ))
        # 2) declared-but-undocumented (the docs half of the three
        # migrated hand-rolled lint tests).
        doc = project.read_doc(OBSERVABILITY_DOC)
        if doc is not None:
            for fam, backticked in (("kinds", True), ("spans", True),
                                    ("reasons", True),
                                    ("metrics", False)):
                label, _ = _FAMILY_LABEL[fam]
                for name in sorted(decl[fam]):
                    needle = f"`{name}`" if backticked else name
                    if needle not in doc:
                        findings.append(Finding(
                            checker=self.id, path=OBSERVABILITY_DOC,
                            line=1, col=0,
                            message=(f"declared {label} '{name}' is "
                                     f"not documented in "
                                     f"{OBSERVABILITY_DOC}"),
                            hint="add it to the telemetry tables",
                            key=f"doc:{fam}:{name}",
                        ))
        # 3) doc pins (migrated from test_nlist) + checker-id pins.
        findings.extend(self._doc_pin_findings(project))
        return findings

    def _doc_pin_findings(self, project):
        from . import CHECKERS   # late: avoids a cycle at import time

        findings = []
        pins = list(DOC_PINS) + [
            (cls.id, CHECKER_DOC) for cls in CHECKERS
        ]
        for needle, rel in pins:
            doc = project.read_doc(rel)
            if doc is None:
                continue   # fixture trees carry no docs — skip
            if needle not in doc:
                findings.append(Finding(
                    checker=self.id, path=rel, line=1, col=0,
                    message=f"doc pin missing: '{needle}' must appear "
                            f"in {rel}",
                    hint="ship the doc row with the code, not after it",
                    key=f"pin:{rel}:{needle}",
                ))
        return findings
