"""Timing and throughput metrics.

Counterpart of ``gravity_tpu/utils/timing.py``: the completion fence for
wall-clock timing, pair-interaction counts and rates, and the roofline
position of a pair rate against the card's peak, and ``HostGapTimer``,
the host pipeline's device-idle share (``host_gap_frac``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from .platform import DeviceLike, sync

__all__ = ["sync", "warm_sync", "DIRECT_SUM_BACKENDS", "pairs_metric_name",
           "pairs_per_step", "FLOPS_PER_PAIR", "DEVICE_PEAK_TFLOPS",
           "device_peak_tflops", "roofline", "backend_formulation",
           "StepTimer", "HostGapTimer", "throughput"]


def warm_sync(device: DeviceLike = None) -> None:
    """Drain the card's queue before a timer starts, so that work queued
    before the timed region is not counted in it. :func:`sync` is the
    fence that ends a timed region: ``torch.cuda.synchronize`` on the
    card, a no-op on the CPU (PyTorch returns from a launch before the
    card finishes, so a host clock read without it measures the
    enqueue)."""
    sync(device)


# Backends that evaluate the dense N*(N-1) directed pair set that
# pairs_per_step() counts: the only ones whose pair rate is a real
# throughput. The JAX package's names, and the port's resolved names of
# the two hand-written direct-sum kernels.
DIRECT_SUM_BACKENDS = ("dense", "chunked", "pallas", "pallas-mxu", "cpp",
                       "nbody_direct", "nbody_mxu")


def pairs_metric_name(backend: str) -> str:
    """Metrics key of the pair rate: ``pairs_per_sec`` for the direct
    sums, which evaluate every pair; a fast solver's N*(N-1) rate is what
    a direct sum would have needed to match it, not work done, so it is
    ``dense_equiv_pairs_per_sec``."""
    return (
        "pairs_per_sec"
        if backend in DIRECT_SUM_BACKENDS
        else "dense_equiv_pairs_per_sec"
    )


def pairs_per_step(n: int, *, direct_sum: bool = True) -> int:
    """Pair interactions a force evaluation: the full N*(N-1) directed set
    (each of N particles sums over N-1 sources)."""
    del direct_sum
    return n * (n - 1)


# Flops a pair of each formulation, the JAX package's cost model: "vpu"
# the direct sum (3 subs, 3 muls and 2 adds for r^2, the softening add,
# an rsqrt, 3 weight muls, 3 muls and 3 adds into the sum: ~20), "mxu"
# the Gram form (6 + 8 in the matmuls, ~8 beside them: ~22), "jnp" the
# plain direct sum (as "vpu"), "nlist" the cell list (the direct sum and
# the rcut compare: ~21, counted over the evaluated pair tiles).
FLOPS_PER_PAIR = {"vpu": 20.0, "mxu": 22.0, "jnp": 20.0, "nlist": 21.0}

# Peak dense-matmul TFLOP/s of a card by device name, as the JAX package
# keeps its TPUs' MXU peaks: NVIDIA's H100 SXM5 datasheet, dense, without
# sparsity: bfloat16 989.4 on the tensor cores; float32 494.7, TF32 on
# the tensor cores, the card's analogue of the TPU's multi-pass fp32.
# MFU against it is the share of the card's matmul flops a kernel uses;
# the direct sum runs outside the tensor cores, so its MFU is small by
# nature, and the number says so.
DEVICE_PEAK_TFLOPS = (
    # (device name substring, lowercased) -> {dtype: TFLOP/s}
    ("h100", {"bfloat16": 989.4, "float32": 494.7}),
)


def device_peak_tflops(device_kind: Optional[str],
                       dtype: str = "float32") -> Optional[float]:
    """Peak matmul TFLOP/s of a card named ``device_kind``
    (``torch.cuda.get_device_name``), or None where no peak is quoted
    (the CPU, an unknown card). bfloat16 looks up the bf16 peak; every
    other dtype the float32 (TF32) one."""
    if not device_kind:
        return None
    kind = device_kind.lower()
    key = "bfloat16" if dtype == "bfloat16" else "float32"
    for sub, peaks in DEVICE_PEAK_TFLOPS:
        if sub in kind:
            return peaks[key]
    return None


def roofline(
    pairs_per_sec_per_chip: float,
    *,
    formulation: str = "vpu",
    device_kind: Optional[str] = None,
    dtype: str = "float32",
) -> dict:
    """Roofline position of a measured pair rate: {flops_per_pair,
    achieved_tflops, peak_tflops, mfu, device_kind, formulation}, with
    achieved = pairs/s * flops/pair and mfu = achieved / peak (None where
    no peak is quoted). An unknown formulation takes the 20-flop model."""
    fpp = FLOPS_PER_PAIR.get(formulation, FLOPS_PER_PAIR["jnp"])
    achieved = pairs_per_sec_per_chip * fpp / 1.0e12
    peak = device_peak_tflops(device_kind, dtype)
    return {
        "flops_per_pair": fpp,
        "achieved_tflops": achieved,
        "peak_tflops": peak,
        "mfu": achieved / peak if peak else None,
        "device_kind": device_kind,
        "formulation": formulation,
    }


def backend_formulation(backend: str) -> str:
    """The FLOPS_PER_PAIR formulation of a force backend (by its JAX name
    or the port's resolved one); the fast solvers take 'jnp', a harmless
    default, since only the direct sums have a pair roofline."""
    return {
        "pallas": "vpu",
        "nbody_direct": "vpu",
        "pallas-mxu": "mxu",
        "nbody_mxu": "mxu",
        "dense": "jnp",
        "chunked": "jnp",
        "cpp": "jnp",
        "nlist": "nlist",
    }.get(backend, "jnp")


@dataclass
class StepTimer:
    """Wall-clock timer with per-step marks."""

    start_time: float = 0.0
    marks: list = field(default_factory=list)

    def start(self) -> None:
        self.start_time = time.perf_counter()
        self.marks = []

    def mark(self) -> float:
        now = time.perf_counter()
        self.marks.append(now)
        return now - self.start_time

    @property
    def total(self) -> float:
        last = self.marks[-1] if self.marks else time.perf_counter()
        return last - self.start_time

    def avg_step(self, steps: int) -> float:
        return self.total / max(steps, 1)


@dataclass
class HostGapTimer:
    """Device-idle ("host gap") accounting of the block pipeline.

    ``host_gap_frac`` is the share of the run's wall clock during which
    the run loop held no dispatched and unconsumed block: time the card is
    idle because nothing was in flight. The serial loop (``io_pipeline``
    off) shows its whole host tax here (the watchdog read, the ledger,
    trajectory copies and writes, checkpoint saves, all with nothing
    queued); the depth-1 pipeline keeps a block in flight through
    consumption. Completion is only ever observed, never assumed: the
    caller marks :meth:`completed` after a CUDA event's ``synchronize()``
    or a value fetch of the block, so the metric cannot undercount the
    serial tax."""

    inflight: int = 0
    gap_s: float = 0.0
    _first_dispatch: Optional[float] = None
    _last_complete: Optional[float] = None
    _last_event: Optional[float] = None

    def dispatched(self) -> None:
        now = time.perf_counter()
        if self._first_dispatch is None:
            self._first_dispatch = now
        if self.inflight == 0 and self._last_complete is not None:
            self.gap_s += now - self._last_complete
        self.inflight += 1
        self._last_event = now

    def completed(self) -> None:
        now = time.perf_counter()
        self.inflight = max(0, self.inflight - 1)
        self._last_complete = now
        self._last_event = now

    def finish(self) -> None:
        """Close the window at the end of the run: host work after the
        last block's observed completion (its trajectory writes, the final
        checkpoint, the writer's drain) is idle time with nothing in
        flight."""
        now = time.perf_counter()
        if self.inflight == 0 and self._last_complete is not None:
            self.gap_s += now - self._last_complete
            self._last_complete = now
        self._last_event = now

    @property
    def span_s(self) -> float:
        if self._first_dispatch is None or self._last_event is None:
            return 0.0
        return self._last_event - self._first_dispatch

    @property
    def host_gap_frac(self) -> Optional[float]:
        span = self.span_s
        return self.gap_s / span if span > 0 else None


def throughput(
    n: int, steps: int, total_time: float, *, num_devices: int = 1,
    force_evals_per_step: int = 1,
) -> dict:
    """Benchmark summary: pair interactions a second, total and a chip."""
    pairs = pairs_per_step(n) * steps * force_evals_per_step
    per_sec = pairs / total_time if total_time > 0 else float("inf")
    return {
        "n": n,
        "steps": steps,
        "total_time_s": total_time,
        "avg_step_s": total_time / max(steps, 1),
        "pair_interactions": pairs,
        "pairs_per_sec": per_sec,
        "pairs_per_sec_per_chip": per_sec / max(num_devices, 1),
    }
