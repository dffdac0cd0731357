"""fault-coverage (counterpart of ``gravity_tpu/analysis/checkers/
faultspec.py``; its fault tables are the port's
``gravity_tpu_torch/docs/robustness.md``): every fault kind declared
in ``utils/faults.py`` (``SERVING_KINDS`` plus the solo kinds) must be
CONSUMED somewhere in the tree — a ``_take``/``*_due`` site referencing the literal — and
documented in the robustness doc's fault tables. A kind that
parses but never fires is a chaos test that silently stopped testing
anything; an undocumented kind is an operator surprise.

Declarations are read from the scanned tree's AST (the
``SERVING_KINDS = (...)`` tuple); consumption is any other string
literal equal to the kind, anywhere in the tree, outside that
declaration. The solo kinds (``diverge``/``transient``/``preempt``/
``backend``) are only audited when the declaring file is the real
``utils/faults.py`` — fixture trees exercise the serving-kind logic
without replicating the solo plumbing.
"""

from __future__ import annotations

import ast

from ..core import Checker, Finding, str_tuple

SOLO_KINDS = ("diverge", "transient", "preempt", "backend")
from .telemetry_drift import ROBUSTNESS_DOC


class FaultCoverage(Checker):
    id = "fault-coverage"
    invariant = ("every declared fault spec kind is consumed by an "
                 "injection site and documented in the fault tables")
    bug_class = "chaos spec kinds that parse but never fire"
    hint = ("wire a *_due()/_take() consumption site and add the kind "
            "to gravity_tpu_torch/docs/robustness.md, or drop it from "
            "SERVING_KINDS")

    def contribute(self, ctx):
        declared = []
        decl_line = 0
        decl_nodes = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "SERVING_KINDS"
                    for t in node.targets):
                vals = str_tuple(node.value)
                if vals:
                    declared = list(vals)
                    decl_line = node.lineno
                    decl_nodes = {
                        id(sub) for sub in ast.walk(node.value)
                    }
        literals = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Constant) and isinstance(
                    node.value, str) and id(node) not in decl_nodes:
                literals.add(node.value)
        return {
            "declared": declared,
            "decl_line": decl_line,
            "is_faults_module": ctx.rel.endswith("utils/faults.py"),
            "literals": sorted(literals),
        }

    def finalize(self, project):
        contribs = project.contributions(self.id)
        decls: list = []   # (rel, line, kinds, is_faults_module)
        pool: set = set()
        for rel, c in sorted(contribs.items()):
            pool.update(c["literals"])
            if c["declared"]:
                decls.append((rel, c["decl_line"], list(c["declared"]),
                              c["is_faults_module"]))
        if not decls:
            return []
        audited = []   # (kind, decl rel, decl line)
        for rel, line, kinds, solo in decls:
            audited.extend((k, rel, line) for k in kinds)
            if solo:
                audited.extend((k, rel, line) for k in SOLO_KINDS)
        findings = []
        for kind, decl_rel, decl_line in audited:
            if kind not in pool and not any(
                    kind in lit for lit in pool):
                findings.append(Finding(
                    checker=self.id, path=decl_rel, line=decl_line,
                    col=0,
                    message=(f"fault kind '{kind}' is declared but "
                             f"never consumed by any injection site "
                             f"in the tree"),
                    hint=self.hint, key=f"consume:{kind}",
                ))
        doc = project.read_doc(ROBUSTNESS_DOC)
        if doc is not None:
            for kind, _rel, _line in audited:
                # Docs table kinds as `kind or `kind@STEP — match the
                # open backtick prefix (same contract as the migrated
                # test_serve_sharded docs lint).
                if f"`{kind}" not in doc:
                    findings.append(Finding(
                        checker=self.id, path=ROBUSTNESS_DOC, line=1,
                        col=0,
                        message=(f"fault kind '{kind}' is missing "
                                 f"from the {ROBUSTNESS_DOC} fault "
                                 f"tables"),
                        hint=self.hint, key=f"doc:{kind}",
                    ))
        return findings
