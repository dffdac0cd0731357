"""Runtime fidelity checks and the per-block metrics stream.

Counterpart of ``gravity_tpu/utils/profiling.py``: :func:`trace` (the
profiler capture behind ``run --profile`` and the daemon's ``/profile``),
:func:`debug_check_forces` (the accuracy half
of the autotuner's probe and ``--debug-check``), the accuracy sentinel
(:func:`sentinel_indices`, :func:`make_force_error_probe`,
:func:`full_set_probe_kernel`, :func:`sentinel_summary`) and
:class:`MetricsLogger`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Optional

import numpy as np
import torch

from ..constants import CUTOFF_RADIUS, G
from ..ops.forces import accelerations_vs
from .logging import JsonlEventLogger

# Targets a call of the oracle takes at once: (rows, N, 3) temporaries.
_ORACLE_ROWS = 32
_TRACES = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block: the host's
    ops and, where a card is present, its kernels (CUPTI), exported as a
    Chrome trace ``trace_<pid>_<k>.json`` into ``log_dir`` (the counterpart
    of the JAX package's ``jax.profiler`` capture). The perf ledger's cost
    counter stays off inside (the two do not nest well), and no profiler
    is left running when the block raises."""
    from ..telemetry import perf

    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        with prof, perf.uncounted():
            if torch.cuda.is_available():
                # A first kernel to start the card's activity tracing on,
                # so that the block's own first kernel is recorded.
                torch.cuda.synchronize()
                torch.zeros(1, device="cuda").add_(1)
                torch.cuda.synchronize()
            yield log_dir
            if torch.cuda.is_available():
                # Every kernel of the block done before the capture ends.
                torch.cuda.synchronize()
    finally:
        path = os.path.join(log_dir,
                            f"trace_{os.getpid()}_{next(_TRACES)}.json")
        prof.export_chrome_trace(path)



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


class MetricsLogger(JsonlEventLogger):
    """The per-block metrics stream (``--metrics``): one ``event="block"``
    JSONL record a consumed block, with ``step``, ``block_steps``,
    ``block_s`` (consumption to consumption), ``wall_s`` since the logger
    was made, and a pair rate whose key says what was computed
    (``utils/timing.pairs_metric_name``: ``pairs_per_sec`` for the direct
    sums, ``dense_equiv_pairs_per_sec`` for the others); with the ledger
    the energy, momentum, angular momentum and COM drifts, with the
    sentinel its median and p90 relative force error."""

    KINDS = ("block",)

    def __init__(self, path: str):
        super().__init__(path)
        self._start = time.perf_counter()

    def log(self, **metrics) -> None:
        clean = {
            k: (v.item() if hasattr(v, "item") else v)
            for k, v in metrics.items()
        }
        self.event(
            "block", wall_s=time.perf_counter() - self._start, **clean
        )


def sentinel_indices(n: int, k: int, seed: int = 0) -> np.ndarray:
    """The K fixed target rows the accuracy sentinel probes: sorted,
    drawn by ``np.random.RandomState(seed)``, the JAX package's rows for
    the same (n, k, seed)."""
    k = max(1, min(int(k), n))
    if k >= n:
        return np.arange(n)
    return np.sort(
        np.random.RandomState(seed).choice(n, k, replace=False)
    )


def _oracle(g: float, cutoff: float, eps: float, rcut: float):
    """The exact direct sum ``(targets, sources, masses) -> acc`` of the
    sentinel: ``nbody_direct``'s rectangular form (its wrapper launches
    the kernel on CUDA tensors and takes the plain sum only on CPU ones);
    with ``rcut`` > 0 the rcut-masked plain sum, the exact reference of
    the truncated cell-list family, which no kernel computes."""
    if rcut > 0.0:
        return lambda t, p, m: accelerations_vs(
            t, p, m, g=g, cutoff=cutoff, eps=eps, rcut=rcut)
    from ..ops.direct_kernel import make_direct_local_kernel

    return make_direct_local_kernel(g=g, cutoff=cutoff, eps=eps)


def make_force_error_probe(kernel, *, idx, g: float, cutoff: float,
                           eps: float = 0.0, rcut: float = 0.0):
    """The device half of the accuracy sentinel: ``probe(positions,
    masses) -> (K,)`` relative force errors of ``kernel`` (``(targets,
    sources, masses) -> acc``) against the exact oracle (:func:`_oracle`)
    on the K fixed targets ``idx``. Queued right behind a block, so that
    its values are read through that block's completion fence."""
    oracle = _oracle(g, cutoff, eps, rcut)
    idx_np = np.asarray(idx, np.int64)
    cache = {}

    def probe(positions, masses):
        dev = positions.device
        if dev not in cache:
            cache[dev] = torch.from_numpy(idx_np).to(dev)
        targets = positions[cache[dev]]
        ref = oracle(targets, positions, masses)
        got = kernel(targets, positions, masses)
        denom = torch.linalg.norm(ref, dim=1) + torch.tensor(
            1e-30, dtype=ref.dtype, device=dev)
        return torch.linalg.norm(got - ref, dim=1) / denom

    return probe


def full_set_probe_kernel(full_accel, idx):
    """A full-set accelerations function ``(positions, masses) -> (N, 3)``
    in the sentinel's kernel slot: the backend evaluates the whole state
    and the probe compares the K sampled rows (one extra force evaluation
    a probe, amortized by the cadence)."""
    idx_np = np.asarray(idx, np.int64)
    cache = {}

    def kernel(targets, positions, masses):
        del targets
        dev = positions.device
        if dev not in cache:
            cache[dev] = torch.from_numpy(idx_np).to(dev)
        return full_accel(positions, masses)[cache[dev]]

    return kernel


def sentinel_summary(rel_errors) -> dict:
    """The host summary of one probe's (K,) relative errors: the fields
    the metrics stream, the run stats and the breach check read."""
    if isinstance(rel_errors, torch.Tensor):
        rel_errors = rel_errors.detach().double().cpu().numpy()
    rel = np.asarray(rel_errors, np.float64)
    return {
        "median_rel_err": float(np.median(rel)),
        "p90_rel_err": float(np.percentile(rel, 90)),
        "max_rel_err": float(rel.max()),
        "n_checked": int(rel.shape[0]),
    }
