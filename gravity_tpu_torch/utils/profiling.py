"""Runtime fidelity checks.

Counterpart of ``gravity_tpu/utils/profiling.py``, of which only
:func:`debug_check_forces` is ported: the accuracy half of the autotuner's
probe. The profiler trace, the memory snapshot and the metrics logger are
ROADMAP.md Queue 1 item 8 (``telemetry/perf.py``) and item 3.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..constants import CUTOFF_RADIUS, G
from ..ops.forces import accelerations_vs

# Targets a call of the oracle takes at once: (rows, N, 3) temporaries.
_ORACLE_ROWS = 32


def debug_check_forces(
    positions: torch.Tensor,
    masses: torch.Tensor,
    *,
    g: Optional[float] = None,
    cutoff: Optional[float] = None,
    eps: float = 0.0,
    rcut: float = 0.0,
    sample: int = 2048,
    seed: int = 0,
    kernel=None,
    full_acc: Optional[torch.Tensor] = None,
) -> dict:
    """A force kernel against the plain direct sum on (a sample of) a live
    state: {max_rel_err, p90_rel_err, median_rel_err, n_checked}, the
    relative error of each sampled row's acceleration vector in float64.

    The sample is the JAX package's: ``np.random.RandomState(seed)``
    choosing ``sample`` of the N rows, sorted, so both packages check the
    same targets. The oracle is ``ops/forces.accelerations_vs`` in the
    state's dtype (rcut-masked when ``rcut`` > 0, the exact reference of
    the truncated cell-list family), taken a few targets at a time.

    ``kernel``: ``(targets, sources, masses) -> acc``; defaults to the
    direct-sum kernel's wrapper (``ops/direct_kernel.py``). ``full_acc``:
    precomputed accelerations of all N rows, for backends with no
    targets-against-sources form; the sampled rows are compared."""
    from ..ops.direct_kernel import accelerations_vs_kernel

    g = G if g is None else g
    cutoff = CUTOFF_RADIUS if cutoff is None else cutoff
    n = positions.shape[0]
    if n > sample:
        idx = np.sort(
            np.random.RandomState(seed).choice(n, sample, replace=False)
        )
        targets = positions[torch.from_numpy(idx).to(positions.device)]
    else:
        idx = None
        targets = positions
    if full_acc is not None:
        got = full_acc if idx is None else full_acc[
            torch.from_numpy(idx).to(full_acc.device)]
    else:
        kernel = kernel or (lambda t, p, m: accelerations_vs_kernel(
            t, p, m, g=g, cutoff=cutoff, eps=eps))
        got = kernel(targets, positions, masses)
    ref = torch.cat([
        accelerations_vs(targets[lo:lo + _ORACLE_ROWS], positions, masses,
                         g=g, cutoff=cutoff, eps=eps, rcut=rcut)
        for lo in range(0, targets.shape[0], _ORACLE_ROWS)])
    # float64 before the division: on an fp32 array the +1e-300 guard
    # underflows to zero, and a zero-reference row (possible only with
    # the rcut-masked oracle) would divide 0/0 into NaN.
    ref_np = ref.detach().cpu().double().numpy()
    got_np = got.detach().cpu().double().numpy()
    denom = np.linalg.norm(ref_np, axis=1) + 1e-300
    rel = np.linalg.norm(got_np - ref_np, axis=1) / denom
    return {
        "max_rel_err": float(rel.max()),
        "p90_rel_err": float(np.percentile(rel, 90)),
        "median_rel_err": float(np.median(rel)),
        "n_checked": int(targets.shape[0]),
    }
