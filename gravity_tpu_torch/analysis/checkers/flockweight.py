"""flock-weight (counterpart of ``gravity_tpu/analysis/checkers/
flockweight.py``): no known-heavy work lexically inside a lease/flock
critical section (the lease-lock convoy class: the lease lock is
spool-wide — EVERY peer's heartbeat renewal serializes behind it, so
a multi-hundred-MB ``np.savez`` or a D2H fetch held under the lock
induces exactly the lease expiry the lock exists to prevent; the
sanctioned pattern is serialize/hash OUTSIDE, validate + rename
inside — see ``Spool.write_result``/``write_progress``).

Detection: inside any ``with ...locked():`` / flock context, flag
calls matching the heavy-cost table (array serialization, hashing,
D2H fetches, subprocesses, sleeps; the table adds PyTorch's
serialization, device-to-host copies and fences to the JAX package's).
Lexical only — a heavy helper
CALLED from the section is the callee's checker run, not this one.
"""

from __future__ import annotations

import ast

from ..core import Checker, call_name

# Context managers that open a flock-backed critical section.
LOCK_CONTEXT_TAILS = ("locked",)
LOCK_CONTEXT_SUBSTR = ("flock",)

# Known-heavy calls (data-driven; one row per cost class).
HEAVY_PREFIXES = (
    "np.save", "numpy.save", "np.savez", "np.load", "numpy.load",
    "hashlib.", "subprocess.", "shutil.", "requests.", "urllib.",
    "torch.save", "torch.load",
)
HEAVY_EXACT = (
    "time.sleep", "jax.device_get", "jax.block_until_ready",
    "torch.cuda.synchronize",
)
HEAVY_ATTR_TAILS = (
    "tobytes", "block_until_ready", "savez", "save", "cpu",
)


def _is_heavy(callee: str, call: ast.Call) -> bool:
    if callee in HEAVY_EXACT:
        return True
    if any(callee.startswith(p) for p in HEAVY_PREFIXES):
        return True
    tail = callee.rsplit(".", 1)[-1]
    return "." in callee and tail in HEAVY_ATTR_TAILS


def _is_lock_context(item: ast.withitem) -> bool:
    expr = item.context_expr
    name = call_name(expr) if isinstance(expr, ast.Call) else ""
    if not name and isinstance(expr, ast.Call):
        return False
    tail = name.rsplit(".", 1)[-1]
    if tail in LOCK_CONTEXT_TAILS:
        return True
    return any(s in name.lower() for s in LOCK_CONTEXT_SUBSTR)


class FlockWeight(Checker):
    id = "flock-weight"
    invariant = ("no heavy serialization/hashing/D2H/sleep inside a "
                 "flock critical section")
    bug_class = "lease-lock convoy (heartbeats starved under flock)"
    hint = ("move the heavy half outside the lock; keep only fence "
            "validation + os.replace + small meta writes inside "
            "(the Spool.write_result pattern)")

    def check(self, ctx):
        findings = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if not any(_is_lock_context(i) for i in node.items):
                continue
            for sub in ast.walk(node):
                if sub is node or not isinstance(sub, ast.Call):
                    continue
                callee = call_name(sub)
                if not callee or not _is_heavy(callee, sub):
                    continue
                if ctx.line_suppressed(sub.lineno, self.id):
                    continue
                qual = ctx.qualname(node) or "<module>"
                findings.append(ctx.finding(
                    self, sub,
                    f"heavy call `{callee}` inside the flock critical "
                    f"section opened at line {node.lineno} "
                    f"(`{qual}`) — every peer's lease heartbeat "
                    f"serializes behind this lock",
                    key=f"{qual}:{callee}",
                ))
        return findings
