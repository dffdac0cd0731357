"""gravity_tpu_torch.analysis — the AST invariant analyzer behind
``gravity_tpu_torch lint`` and ``tests/test_torch_lint.py``
(gravity_tpu_torch/docs/static-analysis.md).

Counterpart of ``gravity_tpu/analysis/``. Pure-AST (nothing in the
analyzed tree is imported), per-file parallel, with four checkers:
fenced-write, flock-weight, telemetry-drift, fault-coverage. The JAX
package's donation-safety and trace-purity encode JAX buffer donation
and jit trace purity, which PyTorch does not have (``JAX_ONLY``).
"""

from .checkers import CHECKER_IDS, CHECKERS, JAX_ONLY, make_checkers
from .core import Baseline, Checker, Finding
from .driver import analyze_file, collect_files, main, run_analysis

__all__ = [
    "Baseline",
    "CHECKERS",
    "CHECKER_IDS",
    "JAX_ONLY",
    "Checker",
    "Finding",
    "analyze_file",
    "collect_files",
    "main",
    "run_analysis",
    "make_checkers",
]
