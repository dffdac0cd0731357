"""The checker registry — data-driven, so a rule is added by appending
one class (gravity_tpu_torch/docs/static-analysis.md "Adding a checker").

Counterpart of ``gravity_tpu/analysis/checkers/__init__.py`` with four of
its six checkers. ``JAX_ONLY`` names the two that have no counterpart and
why; asking for one raises, as an unknown id does.
"""

from __future__ import annotations

from .faultspec import FaultCoverage
from .fencing import FencedWrite
from .flockweight import FlockWeight
from .telemetry_drift import TelemetryDrift

CHECKERS = (
    FencedWrite,
    FlockWeight,
    TelemetryDrift,
    FaultCoverage,
)

CHECKER_IDS = tuple(cls.id for cls in CHECKERS)

# The JAX package's checkers that encode JAX semantics PyTorch lacks.
JAX_ONLY = {
    "donation-safety": "it encodes JAX buffer donation (donate_argnums), "
                       "which PyTorch does not have",
    "trace-purity": "it encodes the purity of jit-traced and scanned "
                    "bodies, which eager PyTorch does not trace",
}


def make_checkers(ids=None):
    """Instantiate the registry (optionally a subset by id)."""
    if ids is None:
        return [cls() for cls in CHECKERS]
    ids = list(ids)
    jax_only = [i for i in ids if i in JAX_ONLY]
    if jax_only:
        raise ValueError("; ".join(
            f"checker {i!r} has no counterpart in gravity_tpu_torch: "
            f"{JAX_ONLY[i]}" for i in jax_only))
    unknown = set(ids) - set(CHECKER_IDS)
    if unknown:
        raise ValueError(
            f"unknown checker ids {sorted(unknown)}; "
            f"known: {list(CHECKER_IDS)}"
        )
    return [cls() for cls in CHECKERS if cls.id in ids]
