"""Static-analysis core: the finding model, the checker contract, the
baseline and suppression machinery, and the shared AST utilities every
checker builds on (gravity_tpu_torch/docs/static-analysis.md).

Counterpart of ``gravity_tpu/analysis/core.py``, a copy: the port keeps
its own, since the JAX package's ``__init__`` imports jax. The analyzer
behind ``gravity_tpu_torch lint`` turns bug classes that review keeps
re-catching into a gate: spool writes bypassing the fenced/atomic
persist path, heavy I/O inside the lease flock, telemetry names emitted
but never declared, fault kinds that never fire.

Everything here is PURE AST: no module in the analyzed tree is ever
imported, so the analyzer runs identically over ``gravity_tpu_torch/``,
a synthetic fixture tree or a scratch module, and never imports torch.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Optional

# Inline suppression: a finding whose source LINE carries
# ``# lint: ok=<checker-id>[ reason]`` is suppressed at the site.
# Prefer the committed baseline (it forces a written justification);
# inline markers are for generated/vendored lines only.
_SUPPRESS_RE = re.compile(r"#\s*lint:\s*ok=([a-z0-9-]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation. ``key`` is a content-derived stable
    identity (scope + symbol, never a line number) so baseline entries
    survive unrelated edits shifting lines."""

    checker: str       # checker id, e.g. "fenced-write"
    path: str          # root-relative posix path
    line: int
    col: int
    message: str
    hint: str = ""
    key: str = ""

    def format(self) -> str:
        s = f"{self.path}:{self.line}:{self.col}: [{self.checker}] {self.message}"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Checker:
    """One invariant. Subclasses set ``id``/``invariant``/``bug_class``
    and implement any of:

    - ``check(ctx)``     -> per-file findings (pure, parallel-safe)
    - ``contribute(ctx)``-> small picklable per-file facts for the
                            cross-file pass (declared registries,
                            string-literal pools, ...)
    - ``finalize(project)`` -> findings needing the whole tree (drift
                            between declarations, emissions, and docs)

    Registering a new rule is ~30 LoC: subclass, implement ``check``,
    append to ``checkers.CHECKERS`` (docs/static-analysis.md "Adding
    a checker").
    """

    id: str = ""
    invariant: str = ""
    bug_class: str = ""   # the review-round class this rule encodes
    hint: str = ""

    def check(self, ctx: "FileContext") -> list:
        return []

    def contribute(self, ctx: "FileContext"):
        return None

    def finalize(self, project: "ProjectContext") -> list:
        return []


class FileContext:
    """One parsed file, parent-annotated, with the helpers checkers
    share (scope qualnames, local-assignment resolution)."""

    def __init__(self, path: str, root: str, source: str,
                 tree: ast.Module):
        self.path = path
        self.root = root
        self.rel = os.path.relpath(path, root).replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self._parents: dict = {}
        self._qualnames: dict = {}
        self._annotate()

    def _annotate(self) -> None:
        stack: list[tuple] = [(self.tree, None, "")]
        while stack:
            node, parent, qual = stack.pop()
            self._parents[id(node)] = parent
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                qual = f"{qual}.{node.name}" if qual else node.name
            self._qualnames[id(node)] = qual
            for child in ast.iter_child_nodes(node):
                stack.append((child, node, qual))

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(id(node))

    def qualname(self, node: ast.AST) -> str:
        """Dotted enclosing-scope name of ``node`` ("" = module)."""
        return self._qualnames.get(id(node), "")

    def ancestors(self, node: ast.AST):
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def line_suppressed(self, line: int, checker_id: str) -> bool:
        if 1 <= line <= len(self.lines):
            m = _SUPPRESS_RE.search(self.lines[line - 1])
            return bool(m) and m.group(1) == checker_id
        return False

    def finding(self, checker: "Checker", node: ast.AST, message: str,
                *, key: str, hint: Optional[str] = None) -> Finding:
        return Finding(
            checker=checker.id, path=self.rel,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=message, hint=self.hint_for(checker, hint), key=key,
        )

    @staticmethod
    def hint_for(checker: "Checker", hint: Optional[str]) -> str:
        return checker.hint if hint is None else hint


class ProjectContext:
    """The cross-file view handed to ``finalize``: the root, every
    scanned file's relpath, and the merged per-checker contributions
    as ``{relpath: contribution}``."""

    def __init__(self, root: str, rels: list, contribs: dict):
        self.root = root
        self.rels = rels
        self.contribs = contribs   # checker id -> {rel: contribution}

    def contributions(self, checker_id: str) -> dict:
        return self.contribs.get(checker_id, {})

    def read_doc(self, rel: str) -> Optional[str]:
        path = os.path.join(self.root, rel)
        try:
            with open(path) as f:
                return f.read()
        except OSError:
            return None


# --- shared AST helpers ---

def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for a Name/Attribute chain; "" when the expression is
    anything else (subscripts, calls, literals)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(call: ast.Call) -> str:
    return dotted_name(call.func)


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def str_tuple(node: ast.AST) -> Optional[tuple]:
    """A tuple/list literal of string constants, or None."""
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    out = []
    for el in node.elts:
        s = const_str(el)
        if s is None:
            return None
        out.append(s)
    return tuple(out)


def expr_tokens(node: ast.AST, resolver: Optional[dict] = None,
                depth: int = 6) -> set:
    """Every identifier, attribute, called-function name, and string
    fragment reachable from ``node`` — the token pool path heuristics
    match against. ``resolver`` maps simple local names to their
    assigned value expressions (followed up to ``depth`` to see through
    ``tmp = f"{path}.tmp"; path = self.result_path(...)`` chains)."""
    tokens: set = set()
    seen: set = set()

    def walk(n: ast.AST, d: int) -> None:
        for sub in ast.walk(n):
            if isinstance(sub, ast.Name):
                tokens.add(sub.id)
                if (resolver and d > 0 and sub.id in resolver
                        and sub.id not in seen):
                    seen.add(sub.id)
                    walk(resolver[sub.id], d - 1)
            elif isinstance(sub, ast.Attribute):
                tokens.add(sub.attr)
            elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                tokens.add(sub.value)
    walk(node, depth)
    return tokens


def local_assignments(scope: ast.AST) -> dict:
    """``{name: value-expr}`` for every simple single-target assignment
    lexically inside ``scope`` (last one wins — good enough for the
    tmp-path idiom the fencing checker resolves)."""
    out: dict = {}
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name):
                out[tgt.id] = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name):
                out[node.target.id] = node.value
    return out


def iter_statements(body: list):
    """Depth-first statement stream in source order: each statement is
    yielded once, compound statements before their bodies. The linear
    'lexically afterwards in the same scope' order the donation checker
    walks. Nested function/class defs are NOT descended into (they are
    their own scopes)."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, field, None)
            if sub:
                yield from iter_statements(sub)
        for handler in getattr(stmt, "handlers", ()) or ():
            yield from iter_statements(handler.body)
        for case in getattr(stmt, "cases", ()) or ():
            yield from iter_statements(case.body)


def walk_statement(stmt: ast.AST):
    """Every node of one statement WITHOUT descending into nested
    statement lists (those are separate ``iter_statements`` items) or
    nested function/class defs."""
    stack = [stmt]
    first = True
    while stack:
        node = stack.pop()
        if not first:
            if isinstance(node, ast.stmt):
                continue
        first = False
        yield node
        for child in ast.iter_child_nodes(node):
            stack.append(child)


# --- baseline ---

class Baseline:
    """The committed suppression file: the port's own
    ``gravity_tpu_torch/analysis/lint-baseline.json`` (never the JAX
    package's root ``.lint-baseline.json``, whose entries name JAX
    paths), ``{"version": 1, "suppressions": [{"checker", "path", "key",
    "reason"}, ...]}``. Every entry carries a one-line justification;
    entries match findings by (checker, path, key) — never by line, so
    unrelated edits cannot invalidate them. The changelog of findings
    FIXED (not baselined) lives in gravity_tpu_torch/docs/
    static-analysis.md "Baseline changelog"."""

    def __init__(self, entries: Optional[list] = None, path: str = ""):
        self.entries = list(entries or [])
        self.path = path
        self._index = {
            (e.get("checker", ""), e.get("path", ""), e.get("key", ""))
            for e in self.entries
        }
        self._hits: set = set()

    @classmethod
    def load(cls, path: str) -> "Baseline":
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return cls(path=path)
        entries = doc.get("suppressions", []) if isinstance(doc, dict) else []
        bad = [e for e in entries
               if not isinstance(e, dict) or not e.get("reason")]
        if bad:
            raise ValueError(
                f"{path}: every baseline suppression needs a one-line "
                f"'reason' — {len(bad)} entries are missing one"
            )
        return cls(entries, path=path)

    def matches(self, finding: Finding) -> bool:
        k = (finding.checker, finding.path, finding.key)
        if k in self._index:
            self._hits.add(k)
            return True
        return False

    def unused(self) -> list:
        return [
            e for e in self.entries
            if (e.get("checker", ""), e.get("path", ""), e.get("key", ""))
            not in self._hits
        ]
