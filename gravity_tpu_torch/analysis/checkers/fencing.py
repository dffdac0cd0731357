"""fenced-write (counterpart of ``gravity_tpu/analysis/checkers/
fencing.py``, the same rule): every durable write targeting a spool / lease /
progress / worker-registry path must go through
``utils/hostio.atomic_write_json`` or one of the designated fenced
persist helpers (the zombie-write class: a raw
``open(path, "w")`` on a spool record is non-atomic — a reader can
observe the torn half — and bypasses the fence check that stops a
zombie worker's stale write from clobbering its adopter's newer one).

Detection: flag ``os.replace`` / ``os.rename`` / write-mode ``open`` /
``json.dump`` calls whose (locally resolved) path expression mentions
a spool-family token, unless the enclosing function is one of the
designated fenced writers below. Local simple assignments are followed
so ``tmp = f"{path}.tmp"; path = self.result_path(job)`` chains
resolve to their spool target.
"""

from __future__ import annotations

import ast
import re

from ..core import Checker, call_name, const_str, expr_tokens, \
    local_assignments

# Path-expression tokens that mark a write as targeting the
# spool/lease/progress persistence family.
SPOOL_TOKEN_RE = re.compile(
    r"spool|lease|progress|daemon\.json|jobs_dir|results_dir|"
    r"cancels_dir|job_path|result_path|workers_dir|\bworkers\b|"
    r"metrics\.json",
)

# The designated fenced/atomic persist path: (file suffix, scope
# qualname prefix). A write lexically inside one of these scopes IS
# the sanctioned implementation, not a bypass.
FENCED_WRITERS = (
    ("utils/hostio.py", "atomic_write_json"),
    ("serve/scheduler.py", "Spool.write_result"),
    ("serve/scheduler.py", "Spool.write_progress"),
)


def _path_args(call: ast.Call):
    """(callee, [expressions that name the write target]) for the
    write-shaped calls this checker audits, else None."""
    callee = call_name(call)
    tail = callee.rsplit(".", 1)[-1]
    if callee in ("os.replace", "os.rename") or tail in (
            "replace", "rename") and callee.startswith("os."):
        return callee, list(call.args[:2])
    if callee == "open" and len(call.args) >= 2:
        mode = const_str(call.args[1])
        if mode is not None and ("w" in mode or "x" in mode):
            return callee, [call.args[0]]
        return None
    if callee == "open":
        for kw in call.keywords:
            if kw.arg == "mode":
                mode = const_str(kw.value)
                if mode is not None and ("w" in mode or "x" in mode):
                    return callee, [call.args[0]] if call.args else []
        return None
    if callee.endswith("json.dump") or callee == "json.dump":
        return callee, list(call.args[1:2])
    return None


class FencedWrite(Checker):
    id = "fenced-write"
    invariant = ("spool/lease/progress records are written only via "
                 "atomic_write_json or the fenced Spool persist "
                 "helpers")
    bug_class = "zombie / torn spool write"
    hint = ("route the write through utils/hostio.atomic_write_json "
            "(fault_injection=False for non-spool-record streams) or "
            "a fenced Spool helper holding the lease lock")

    def check(self, ctx):
        findings = []
        resolvers: dict = {}
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            hit = _path_args(node)
            if hit is None:
                continue
            callee, targets = hit
            qual = ctx.qualname(node)
            if self._is_fenced_writer(ctx.rel, qual):
                continue
            scope = self._enclosing_scope(ctx, node)
            if id(scope) not in resolvers:
                resolvers[id(scope)] = local_assignments(scope)
            # depth=2 reaches the `tmp = f"{path}.tmp"; path =
            # <spool path expr>` idiom without chasing unrelated data
            # provenance (a trace EXPORT whose id came from a spool
            # READ is not a spool write).
            tokens = set()
            for t in targets:
                tokens |= expr_tokens(t, resolvers[id(scope)], depth=2)
            blob = " ".join(str(t) for t in tokens).lower()
            m = SPOOL_TOKEN_RE.search(blob)
            if not m:
                continue
            if ctx.line_suppressed(node.lineno, self.id):
                continue
            findings.append(ctx.finding(
                self, node,
                f"raw `{callee}` targets a spool-family path "
                f"(token `{m.group(0)}`) outside the fenced/atomic "
                f"persist helpers",
                key=f"{qual or '<module>'}:{callee}:{m.group(0)}",
            ))
        return findings

    @staticmethod
    def _is_fenced_writer(rel: str, qual: str) -> bool:
        for suffix, prefix in FENCED_WRITERS:
            if rel.endswith(suffix) and (
                    qual == prefix or qual.startswith(prefix + ".")):
                return True
        return False

    @staticmethod
    def _enclosing_scope(ctx, node):
        for anc in ctx.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return ctx.tree
