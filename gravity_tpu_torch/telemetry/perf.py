"""Performance observatory: the cost and memory ledger of every Simulator
block signature and every serve key, recompile-storm detection and
memory-aware admission.

Counterpart of ``gravity_tpu/telemetry/perf.py``. The JAX package
compiles each program through XLA's AOT path and reads its flops, bytes
and transcendentals from ``cost_analysis`` and its peak HBM from
``memory_analysis``. PyTorch compiles nothing; here the first call of a
signature is the "compile":

- :class:`CostCounter` is a ``TorchDispatchMode`` that counts each aten
  op the way XLA's HLO cost analysis counts its instruction: one flop an
  output element of an elementwise op, the input elements of a
  reduction, ``2 m n k`` for a matrix product, ``n ceil(log2 n)`` for a
  sort, a transcendental (and no flop) an element of ``rsqrt``,
  ``sqrt``, ``exp``, ``log``, ``sin`` or ``cos``, the FFTs by one rule
  (a transform of N points, the product of its transformed axes, costs
  5 N log2 N flops complex to complex and 2.5 N log2 N real to complex
  or complex to real, N counted on the real side, times the batch of
  transforms the other axes hold), and the operand and
  result bytes of every op that moves data as ``bytes_accessed``. The
  hand-written kernels launch through ``ctypes``, which no dispatch mode
  sees: each wrapper calls :func:`count_launch` with its TPU
  counterpart's ``pl.CostEstimate`` at the shapes of the launch.
- :class:`InstrumentedBlock` wraps the Simulator's block. Signatures are
  keyed on (``n_steps``, ``record_every``, n, dtype, device); the first
  call of one runs ONE step under the counter (the JAX convention: XLA
  counts a loop body once, so a row's flops are one step's): its last,
  so that the counter's host cost runs while the card works through the
  steps queued before it, not while it waits for its first work; with
  ``torch.cuda.reset_peak_memory_stats``/``max_memory_allocated`` around
  that step on the card (on the CPU the counter's high-water mark of live
  tensor bytes). Every later call runs plain, with no counter. A serve
  key's first round counts its last step the same way, its peak over the
  whole round.
- :class:`PerfLedger` keeps the rows: counted ``flops``,
  ``bytes_accessed``, ``transcendentals``, ``peak_bytes``, the pair
  model's ``analytic_flops`` and ``model_ratio`` = counted / analytic,
  ``flops_source`` and ``peak_source``; rows append to
  ``perf_ledger.jsonl`` when a sink is attached and feed the worker
  metrics. One owner (a Simulator's block, a serve key) counting more
  than :data:`STORM_THRESHOLD` signatures is a recompile storm: a
  ``recompile_storm`` event, once a key, and a flight-recorder dump.
- Admission: :func:`required_bytes_for_key` answers a serve key's need
  from its measured peak once it has run a round, from the sizing model
  :func:`estimate_peak_bytes` before.

For the direct sums ``model_ratio`` sits near 1 (the integrator's
elementwise ops on top of the pair work); the sub-quadratic solvers are
priced at the dense equivalent (the cell list at its evaluated tiles), so
their ratio reads as the measured work fraction. Counting never runs in a
timed window: ``bench`` and the autotuner's timed steps run under
:func:`uncounted`.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import math
import os
import threading
import time
import weakref
from collections import deque
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..utils.logging import JsonlEventLogger

LEDGER_FILE = "perf_ledger.jsonl"

# One owner (a Simulator's block, a serve key) counting more than this
# many signatures is a recompile storm: a solo run sees only its block
# and tail shapes, a serve key exactly one. Tests lower
# ``ledger().storm_threshold``.
STORM_THRESHOLD = 5

# Fraction of the device memory budget a program's peak may claim at
# admission — headroom for the runtime's own allocations and the
# resident batches of OTHER keys.
ADMIT_HEADROOM = 0.9

# Bounded in-memory row history (the JSONL sink is the durable record).
MAX_ROWS = 4096


class InsufficientDeviceMemory(ValueError):
    """A job's resolved program cannot fit device memory: raised at
    ADMISSION (a clean typed rejection the HTTP layer maps to 400)
    instead of letting the slot load run out of memory mid-round."""

    def __init__(self, message: str, *, required_bytes: int,
                 budget_bytes: int, source: str):
        super().__init__(message)
        self.required_bytes = int(required_bytes)
        self.budget_bytes = int(budget_bytes)
        # "measured" (a ledger row for this key) or "estimated" (the
        # cold-key sizing model) — the rejection names its evidence.
        self.source = source


class PerfEventLogger(JsonlEventLogger):
    """``perf_ledger.jsonl`` — one ``perf_compile`` record per key."""

    KINDS = ("perf_compile",)


# Ambient site override: the autotune probe drives real Simulator blocks;
# binding a site here labels those rows as probe rows without threading a
# parameter through the Simulator.
_SITE: contextvars.ContextVar = contextvars.ContextVar(
    "gravity_tpu_torch_perf_site", default=None)
# The active cost counter of this thread (None outside a counted call).
_COUNTER: contextvars.ContextVar = contextvars.ContextVar(
    "gravity_tpu_torch_perf_counter", default=None)
# Set inside timed windows: no new signature is counted there.
_UNCOUNTED: contextvars.ContextVar = contextvars.ContextVar(
    "gravity_tpu_torch_perf_uncounted", default=False)


@contextlib.contextmanager
def site(name: str):
    token = _SITE.set(name)
    try:
        yield
    finally:
        _SITE.reset(token)


@contextlib.contextmanager
def uncounted():
    """A timed window: instrumented blocks and serve rounds run plain
    inside it, and a signature first seen here is counted at its next
    call outside."""
    token = _UNCOUNTED.set(True)
    try:
        yield
    finally:
        _UNCOUNTED.reset(token)


def counting_allowed() -> bool:
    return not _UNCOUNTED.get()


def analytic_flops(backend: str, n: int, *, force_evals: int = 1,
                   evaluated_pairs: Optional[float] = None,
                   targets: Optional[int] = None) -> Optional[float]:
    """The cost model's ONE-step flop expectation for a backend at n bodies
    (the denominator of ``model_ratio``). Direct sums price the N (N - 1)
    directed pairs at their formulation's flops a pair; the cell list
    prices the pair tiles it evaluates when the caller knows them
    (``evaluated_pairs``); every other family (tree, fmm, sfmm, p3m, and
    nlist without sizing) is priced at the dense equivalent, so its ratio
    reads as the measured work fraction. ``targets`` < n prices one rank
    of a mesh, whose counter sees its own (targets, N) block: that share
    of the pairs."""
    from ..utils.timing import (
        FLOPS_PER_PAIR,
        backend_formulation,
        pairs_per_step,
    )

    if n is None or n < 2:
        return None
    fpp = FLOPS_PER_PAIR.get(backend_formulation(backend),
                             FLOPS_PER_PAIR["jnp"])
    share = (targets / n) if targets else 1.0
    if backend == "nlist" and evaluated_pairs:
        return float(evaluated_pairs) * share * fpp * max(force_evals, 1)
    return float(pairs_per_step(n)) * share * fpp * max(force_evals, 1)


# --- the cost counter ---

def _names(*names: str) -> frozenset:
    return frozenset(names)


# Ops that move or make no data: views, metadata and allocation.
_FREE = _names(
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "slice", "select", "squeeze", "unsqueeze", "as_strided", "alias",
    "detach", "lift_fresh", "empty", "empty_like", "empty_strided",
    "unbind", "split", "split_with_sizes", "chunk", "narrow", "diagonal",
    "unfold", "view_as_real", "view_as_complex", "_reshape_alias",
    "set_", "resize_", "_local_scalar_dense", "is_nonzero", "sym_size",
    "sym_stride", "sym_numel", "record_stream", "_to_copy_noop",
)
# Ops whose elements are data movement, not arithmetic (XLA's gather,
# scatter, concatenate, copy, broadcast and iota count no flop).
_MOVE = _names(
    "copy_", "clone", "contiguous", "cat", "stack", "index", "index_select",
    "gather", "take", "masked_select", "nonzero", "fill_", "fill",
    "zero_", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "new_zeros", "new_ones", "new_full", "new_empty",
    "arange", "linspace", "repeat", "repeat_interleave", "flip", "roll",
    "index_put_", "index_put", "scatter", "scatter_", "masked_fill",
    "masked_fill_", "constant_pad_nd", "tril", "triu", "_unsafe_index",
    "pin_memory", "_pin_memory", "lift_fresh_copy", "unique_dim",
    "_unique2", "bincount",
)
_TRANSCENDENTAL = _names(
    "rsqrt", "rsqrt_", "sqrt", "sqrt_", "exp", "exp_", "log", "log_",
    "sin", "sin_", "cos", "cos_", "tanh", "log1p", "expm1", "erf",
    "erfc", "atan2", "acos", "asin", "atan", "exp2", "log2", "log10",
)
_REDUCTION = _names(
    "sum", "mean", "amax", "amin", "max", "min", "prod", "norm",
    "linalg_vector_norm", "any", "all", "argmax", "argmin", "cumsum",
    "cumprod", "cummax", "cummin", "logsumexp", "var", "std", "var_mean",
    "std_mean", "segment_reduce", "_segment_reduce_backward", "aminmax",
    "count_nonzero", "median", "nansum",
)
_MATMUL = _names("mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "mv",
                 "addmv", "vdot")
_SORT = _names("sort", "argsort", "topk", "kthvalue", "msort")
# FFTs: real (r2c, c2r) at 2.5 N log2 N flops a transform of N points,
# complex (c2c) at 5 N log2 N (the usual radix-2 operation count).
_FFT_REAL = _names("_fft_r2c", "_fft_c2r")
_FFT_COMPLEX = _names("_fft_c2c")
# Scatter-adds: one flop an update element (XLA counts the update
# computation once an update).
_SCATTER_ADD = _names("index_add", "index_add_", "scatter_add",
                      "scatter_add_", "scatter_reduce", "scatter_reduce_",
                      "index_reduce", "index_reduce_")


def _tensors(tree) -> list:
    """The tensors of an op's arguments or results (no closure: a tensor
    list held in a reference cycle would outlive the op until the cyclic
    collector ran, raising the peak the counter watches)."""
    out, stack = [], [tree]
    while stack:  # depth first, in argument order
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _category(func) -> str:
    """How XLA's cost analysis prices an op (cached a func)."""
    cat = _CATEGORIES.get(func)
    if cat is None:
        name = func.overloadpacket.__name__
        for cat, names in (("free", _FREE), ("move", _MOVE),
                           ("transcendental", _TRANSCENDENTAL),
                           ("matmul", _MATMUL), ("reduction", _REDUCTION),
                           ("sort", _SORT), ("scatter_add", _SCATTER_ADD),
                           ("fft_real", _FFT_REAL),
                           ("fft_complex", _FFT_COMPLEX)):
            if name in names:
                break
        else:
            cat = ("convert" if name == "_to_copy" else
                   "elementwise" if (torch.Tag.pointwise in func.tags
                                     or name == "where") else "other")
        _CATEGORIES[func] = cat
    return cat


_CATEGORIES: dict = {}


def fft_flops(cat: str, args, ins, outs) -> float:
    """An FFT's flops by the module's rule: ``args[1]`` names the
    transformed axes; N is their size on the real side (the input of an
    r2c, the output of a c2r), and the other axes are a batch."""
    # The output of a c2r is real; an r2c's input and a c2c's are the
    # real-side (or the complex) shape.
    real = outs[0] if outs and outs[0].is_floating_point() else ins[0]
    dims = args[1] if len(args) > 1 else range(real.dim())
    n = math.prod(real.shape[d] for d in dims)
    if n < 2:
        return 0.0
    batch = real.numel() // n
    per = 2.5 if cat == "fft_real" else 5.0
    return batch * per * n * math.log2(n)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts the aten ops run under it as XLA's HLO cost analysis counts
    their instructions (the module docstring), plus what
    :func:`count_launch` reports for the kernels. ``track_live`` keeps the
    high-water mark of live tensor bytes made under it (``peak_live``):
    the CPU's peak, where no allocator is read."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # Nothing runs torch.compile under the counter: leaving the
        # dispatch method unwrapped keeps torch._dynamo (seconds to import)
        # out of the first counted call.
        return False

    def __init__(self, *, track_live: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.transcendentals = 0.0
        self.launches = 0
        self.track_live = track_live
        self.live = 0
        self.peak_live = 0
        self._seen: set = set()
        self._token = None

    def __enter__(self):
        self._token = _COUNTER.set(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _COUNTER.reset(self._token)

    def cost(self) -> dict:
        return {"flops": float(self.flops),
                "bytes_accessed": float(self.bytes_accessed),
                "transcendentals": float(self.transcendentals)}

    def add_launch(self, flops: float, bytes_accessed: float,
                   transcendentals: float) -> None:
        self.flops += float(flops)
        self.bytes_accessed += float(bytes_accessed)
        self.transcendentals += float(transcendentals)
        self.launches += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        cat = _category(func)
        if cat != "free":
            self._count(cat, args, kwargs, out)
        return out

    def _count(self, cat, args, kwargs, out) -> None:
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        moved = 0
        for t in ins:
            moved += t.numel() * t.element_size()
        out_elems = 0
        for t in outs:
            out_elems += t.numel()
            moved += t.numel() * t.element_size()
        self.bytes_accessed += moved
        if cat == "elementwise":
            self.flops += out_elems
        elif cat == "transcendental":
            self.transcendentals += out_elems
        elif cat == "matmul":
            a, b = ins[-2], ins[-1]
            m = a.shape[-2] if a.dim() > 1 else 1
            n_ = b.shape[-1] if b.dim() > 1 else 1
            batch = math.prod(a.shape[:-2]) if a.dim() > 2 else 1
            self.flops += 2.0 * batch * m * n_ * a.shape[-1]
        elif cat == "reduction":
            self.flops += ins[0].numel() if ins else 0
        elif cat == "sort":
            x = ins[0]
            dim = x.shape[-1] if x.dim() else 1
            self.flops += x.numel() * max(1, math.ceil(math.log2(max(dim,
                                                                     2))))
        elif cat == "scatter_add":
            self.flops += ins[-1].numel() if ins else 0
        elif cat in ("fft_real", "fft_complex"):
            self.flops += fft_flops(cat, args, ins, outs)
        elif cat == "convert":
            if outs and ins and outs[0].dtype != ins[0].dtype:
                self.flops += out_elems  # a convert is elementwise
        if self.track_live:
            for t in outs:
                self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._seen:
            return
        size = storage.nbytes()
        self._seen.add(key)
        self.live += size
        self.peak_live = max(self.peak_live, self.live)
        weakref.finalize(storage, self._release, key, size)

    def _release(self, key, size) -> None:
        self._seen.discard(key)
        self.live -= size


_WARM: set = set()


def warm(device: torch.device) -> None:
    """Take the counter's first-use costs (its machinery's and the
    allocator statistics' set-up, ~0.1 s on the card) once a process and
    device, where the caller is not timing: the Simulator calls it when it
    is built, so that a run's first counted block pays only its count."""
    key = str(device)
    if key in _WARM or not counting_allowed():
        return
    _WARM.add(key)
    probe = FirstCall(device, 0)
    with probe:
        torch.zeros(2, device=device).add_(1).sum()
    probe.peak()


def count_launch(flops: float, bytes_accessed: float,
                 transcendentals: float = 0.0) -> None:
    """A kernel wrapper's report of one launch (its TPU counterpart's
    ``pl.CostEstimate`` at the launch's shapes): added to the active
    :class:`CostCounter`, nothing when none is active. The kernels launch
    through ``ctypes``, which no dispatch mode sees."""
    counter = _COUNTER.get()
    if counter is not None:
        counter.add_launch(flops, bytes_accessed, transcendentals)


def counting() -> bool:
    """Whether a cost counter is active (a wrapper may skip work done only
    for the report)."""
    return _COUNTER.get() is not None


def device_memory_budget() -> Optional[int]:
    """Device memory budget in bytes, or None where there is none (the
    CPU: admission checking is off unless ``GRAVITY_TPU_HBM_BYTES``
    forces a budget, as the tests do). On the card: the total memory
    ``torch.cuda.mem_get_info`` reports."""
    env = os.environ.get("GRAVITY_TPU_HBM_BYTES")
    if env:
        try:
            return int(float(env))
        except ValueError:
            pass
    import torch

    if not torch.cuda.is_available():
        return None
    try:
        _, total = torch.cuda.mem_get_info()
    except RuntimeError:
        return None
    return int(total)


# The (B, n, 3) generations a round holds at once besides the batch's own
# tensors, by integrator: the round-start carry (kept for the rollback),
# the current and the new state and acceleration, a step's half-kicked
# velocity and drifted positions, the budget mask's selections and the
# elementwise temporaries around them; Verlet's and Yoshida's steps hold
# more (their acc sums, three sub-steps).
STEP_GENERATIONS = {"euler": 12, "leapfrog": 14, "verlet": 16,
                    "yoshida4": 18}
# The element units of the cell list's per-(slot, cell, offset, slot)
# temporaries at once (ops/nlist.py::_remainder_cells: the masked
# differences, their squares, the weight's intermediates, the weighted
# differences; a 3-vector counts 3), and of a target's per-offset
# fallback terms (_overflow_targets).
NLIST_TILE_UNITS = 9
# The plain sum's (rows, n) temporaries at once (ops/forces.py::
# accelerations_vs): the differences (3), r^2, the weight's
# intermediates and the masks, then the weighted differences (3); 10.1
# units measured at bucket 4,096 in fp64 (NVIDIA H100 80GB HBM3, 700 W);
# its chunk of rows for ``chunked`` (SimulationConfig.chunk).
PLAIN_PAIR_UNITS = 12
PLAIN_CHUNK = 1024
NLIST_FALLBACK_UNITS = 9
# A fit key's first round (serve/jobs/fit.py) keeps, besides the step's
# generations, what its backward reads: each of the ``rollout`` steps'
# saved (B, n, 3) tensors (the integrator's kicks and drifts, the force
# evaluation's saved positions) and, per observation, the step's scaled
# differences and their weighted squares; for ``dense`` and ``chunked``,
# which PyTorch differentiates itself, each step's saved (B, n, n) pair
# tensors (8.2 units a step measured at bucket 64, CPU); for the kernels,
# the backward's pair block, ``ops/forces.backward_rows`` target rows
# against every source of every slot, BACKWARD_PAIR_UNITS of it at once
# (the plain sum's recomputed temporaries, those autograd saves, and
# their gradients).
FIT_STEP_UNITS = 8
FIT_OBS_UNITS = 4
FIT_SAVED_PAIR_UNITS = 10
BACKWARD_PAIR_UNITS = 24
# The largest source chunk count a direct-sum launch takes at n sources:
# one chunk a staged tile of 256 (kTile of csrc/nbody_direct.cu and
# csrc/nbody_mxu.cu), at most direct_kernel.MAX_CHUNKS; the card's own
# occupancy picks S at or below it (direct_kernel.source_chunks).
KERNEL_TILE = 256


def chunk_bound(n: int) -> int:
    """The most source chunks S a launch at n sources can take."""
    from ..ops.direct_kernel import MAX_CHUNKS

    return max(1, min(MAX_CHUNKS, -(-n // KERNEL_TILE)))


def estimate_peak_bytes(key) -> int:
    """Cold-key sizing model of a serve BatchKey's first round, in bytes.
    It counts, for B = slots, n = bucket, ``item`` the dtype's bytes
    (bf16 at 4, as the JAX model counts it):

    - the JAX model's figure (``gravity_tpu/telemetry/perf.py:234-262``),
      never less: two generations of the (B, n, 3) state triple and the
      masses, plus its pair term (nlist B side^3 27 cap 4 item, the
      kernels B n 8 item; dense and chunked below);
    - for ``dense`` and ``chunked``, the plain sum's pair temporaries,
      :data:`PLAIN_PAIR_UNITS` of B n rows, rows = n or the config's chunk
      of 1,024 (the JAX model counts the (n, n, 3) difference alone);
    - the step's temporaries: :data:`STEP_GENERATIONS` of the key's
      integrator times a (B, n, 3) generation;
    - the kernels' scratch: ``nbody_direct``'s packed sources (B, n, 4)
      and its (B, S, n, 3) chunk partial, ``nbody_mxu``'s packed tiles
      (B n 64 bytes), its centred operands and (B, n, 4) sums and its
      (B, S, n, 4) partial, all in the compute type (fp32 for bf16), S at
      most :func:`chunk_bound`;
    - for ``nlist`` (side and cap from ``key.extra``): the (B, side^3,
      cap) cell grids (positions, masses, G m, the pair tiles and their
      sum with the remainder, the scatter buffers), the remainder's
      per-offset terms (:data:`NLIST_TILE_UNITS` of B side^3 27 cap), the
      targets' overflow fallback (:data:`NLIST_FALLBACK_UNITS` of B n 27
      and its int64 neighbour ids), and the sorted and un-binned copies
      with the int64 coordinates, ids and orders of B n bodies.

    A ``fit`` key (``rollout`` and ``obs`` from ``key.extra``) adds
    :func:`fit_bytes`: the rollout's saved residuals, the backward's pair
    block and the batch's optimizer and observation tensors.

    The measured peak of a key's first round replaces it for every later
    admission (:func:`required_bytes_for_key`)."""
    item = 8 if str(key.dtype) in ("float64", "f64") else 4
    compute = item
    slots, n = int(key.slots), int(key.bucket_n)
    vec = slots * n * 3 * item
    state = 2 * (3 * vec + slots * n * item)
    backend = key.backend
    extra = dict(key.extra) if key.extra else {}
    side = int(extra.get("nlist_side", 8) or 8)
    cap = int(extra.get("nlist_cap", 0) or 0) or 64
    if backend in ("dense", "chunked"):
        rows = n if backend == "dense" else min(PLAIN_CHUNK, n)
        pair = slots * n * rows * PLAIN_PAIR_UNITS * item
    elif backend == "nlist":
        pair = slots * side**3 * 27 * cap * 4 * item
    else:
        pair = slots * n * 8 * item
    steps = STEP_GENERATIONS.get(key.integrator, max(
        STEP_GENERATIONS.values())) * vec
    chunks = chunk_bound(n)
    scratch = 0
    if backend == "pallas":
        scratch = slots * n * compute * (4 + 3 * chunks)
    elif backend == "pallas-mxu":
        scratch = slots * n * (64 + 4 * (3 + 3 + 4 + 4 * chunks + 6))
    elif backend == "nlist":
        grid = slots * side**3 * cap
        bodies = slots * n
        scratch = (grid * (17 * item + 16)
                   + NLIST_TILE_UNITS * grid * 27 * item
                   + bodies * 27 * (NLIST_FALLBACK_UNITS * item + 17)
                   + bodies * (24 * item + 8 * 16))
    total = state + pair + steps + scratch
    if key.job_type == "fit":
        total += fit_bytes(key)
    return total


def fit_bytes(key) -> int:
    """A fit key's first-round bytes beyond an integrate round's: for
    ``rollout`` R and K observations, R (FIT_STEP_UNITS + FIT_OBS_UNITS K)
    (B, n, 3) generations of saved residuals; for ``dense``/``chunked`` R
    FIT_SAVED_PAIR_UNITS (B, n, n) saved pair tensors, for the kernels the
    backward's pair block (BACKWARD_PAIR_UNITS x B x rows x n, rows =
    ``ops/forces.backward_rows(n, n, B)``); and the batch's own
    observation, weight, moment and parameter tensors ((K + 5) of the
    (B, n, 3) generation)."""
    from ..ops.forces import backward_rows

    item = 8 if str(key.dtype) in ("float64", "f64") else 4
    slots, n = int(key.slots), int(key.bucket_n)
    extra = dict(key.extra) if key.extra else {}
    rollout = int(extra.get("rollout", 1))
    k_obs = int(extra.get("obs", 1))
    vec = slots * n * 3 * item
    saved = rollout * (FIT_STEP_UNITS + FIT_OBS_UNITS * k_obs) * vec
    if key.backend in ("dense", "chunked"):
        pairs = rollout * FIT_SAVED_PAIR_UNITS * slots * n * n * item
    else:
        pairs = (BACKWARD_PAIR_UNITS * slots * backward_rows(n, n, slots)
                 * n * item)
    return saved + pairs + (k_obs + 5) * vec


class PerfLedger:
    """Process-wide record store with optional sinks. Always records in
    memory (bounded ring); ``attach`` points it at a worker's telemetry,
    so that rows also append to ``<out_dir>/perf_ledger.jsonl``, feed the
    metrics registry and the flight recorder, and recompile storms reach
    the worker's event stream (``event_hook``). One attachment at a time
    (last wins)."""

    def __init__(self):
        self._lock = threading.RLock()
        self.rows: deque = deque(maxlen=MAX_ROWS)
        self._by_key: dict = {}
        self._compile_counts: dict = {}
        self._stormed: set = set()
        self.storm_threshold = STORM_THRESHOLD
        self._log: Optional[PerfEventLogger] = None
        self.registry = None
        self.recorder = None
        self.event_hook: Optional[Callable] = None
        self._owner = None

    def attach(self, *, out_dir=None, registry=None, recorder=None,
               event_hook=None, owner=None) -> None:
        with self._lock:
            self._log = (PerfEventLogger(os.path.join(out_dir, LEDGER_FILE))
                         if out_dir else None)
            self.registry = registry
            self.recorder = recorder
            self.event_hook = event_hook
            self._owner = owner

    def detach(self, owner=None) -> None:
        """Drop the sinks (if ``owner`` still holds them)."""
        with self._lock:
            if owner is not None and self._owner is not owner:
                return
            self._log = None
            self.registry = None
            self.recorder = None
            self.event_hook = None
            self._owner = None

    def reset(self) -> None:
        with self._lock:
            self.rows.clear()
            self._by_key.clear()
            self._compile_counts.clear()
            self._stormed.clear()

    def record_compile(self, *, site: str, key: str, compile_s: float = 0.0,
                       backend: Optional[str] = None, n: Optional[int] = None,
                       analytic: Optional[float] = None,
                       cost: Optional[dict] = None,
                       peak_bytes: Optional[int] = None,
                       peak_source: Optional[str] = None,
                       storm_count: Optional[int] = None, **extra) -> dict:
        """Append one signature's row; returns it. ``cost`` holds the
        counted ``flops``, ``bytes_accessed`` and ``transcendentals``
        (:class:`CostCounter`), ``analytic`` the cost model's flops of one
        step, ``peak_bytes`` the measured peak and ``peak_source`` how it
        was measured; ``storm_count`` is the owner's signature ordinal."""
        eff_site = _SITE.get() or site
        row = {"site": eff_site, "key": key, "backend": backend, "n": n,
               "compile_s": round(float(compile_s), 6)}
        if cost:
            row.update({k: float(v) for k, v in cost.items()
                        if v is not None})
            row["flops_source"] = "counted"
        measured = row.get("flops")
        if measured is None and analytic:
            # Only when nothing was counted: the model itself, flagged.
            measured = row["flops"] = float(analytic)
            row["flops_source"] = "analytic_fallback"
        if analytic and measured is not None and analytic > 0:
            row["analytic_flops"] = float(analytic)
            row["model_ratio"] = round(measured / analytic, 6)
        if peak_bytes is not None:
            row["peak_bytes"] = int(peak_bytes)
            row["peak_source"] = peak_source
        row.update(extra)
        with self._lock:
            self.rows.append(row)
            self._by_key[key] = row
            count = self._compile_counts.get(key, 0) + 1
            self._compile_counts[key] = count
            row["compile_count"] = count
            log, registry, recorder = self._log, self.registry, self.recorder
        try:
            if log is not None:
                log.event("perf_compile", **row)
        except Exception:  # noqa: BLE001 — the ledger must never take
            pass  # down the program it observes
        if registry is not None:
            try:
                registry.histogram("gravity_compile_seconds",
                                   site=eff_site).observe(row["compile_s"])
                if row.get("flops") is not None:
                    registry.gauge("gravity_program_flops",
                                   key=key).set(row["flops"])
                if row.get("peak_bytes") is not None:
                    registry.gauge("gravity_program_peak_bytes",
                                   key=key).set(row["peak_bytes"])
            except Exception:  # noqa: BLE001
                pass
        if recorder is not None:
            try:
                recorder.record("perf_compile", site=eff_site, key=key,
                                compile_s=row["compile_s"],
                                flops=row.get("flops"),
                                peak_bytes=row.get("peak_bytes"),
                                count=count)
            except Exception:  # noqa: BLE001
                pass
        if storm_count is not None and storm_count > self.storm_threshold:
            self._storm(key, storm_count)
        return row

    def _storm(self, key: str, count: int) -> None:
        """One owner past the threshold: the ``recompile_storm`` event ONCE
        a key (edge-triggered) and a flight-recorder dump."""
        with self._lock:
            if key in self._stormed:
                return
            self._stormed.add(key)
            recorder, hook = self.recorder, self.event_hook
        if hook is not None:
            try:
                hook("recompile_storm", key=key, compiles=count,
                     threshold=self.storm_threshold)
            except Exception:  # noqa: BLE001
                pass
        if recorder is not None:
            try:
                recorder.record("event", event="recompile_storm", key=key,
                                compiles=count)
                recorder.dump("recompile_storm")
            except Exception:  # noqa: BLE001
                pass

    def observe_probe(self, probe_ms: float) -> None:
        """The autotune probe's cost into the attached registry (the
        run-stats ``autotune_probe_ms`` as a scrapeable histogram)."""
        with self._lock:
            registry = self.registry
        if registry is None:
            return
        try:
            registry.histogram("gravity_autotune_probe_ms").observe(
                float(probe_ms))
        except Exception:  # noqa: BLE001
            pass

    def row_for(self, key: str) -> Optional[dict]:
        with self._lock:
            row = self._by_key.get(key)
            return dict(row) if row is not None else None

    def rows_list(self) -> list:
        with self._lock:
            return [dict(r) for r in self.rows]

    def compile_count(self, key: str) -> int:
        with self._lock:
            return self._compile_counts.get(key, 0)


_LEDGER = PerfLedger()


def ledger() -> PerfLedger:
    return _LEDGER


def logical_key(site: str, **parts) -> str:
    """Canonical ledger key string: ``site:part=value/...`` with parts
    sorted — short enough for a metric label, stable across runs."""
    body = "/".join(f"{k}={parts[k]}" for k in sorted(parts)
                    if parts[k] is not None)
    return f"{site}:{body}" if body else site


def engine_key_str(key) -> str:
    """The serving BatchKey's ledger identity (one build per BatchKey —
    the granularity of the engine's compile_counts)."""
    return logical_key(
        "serve", job=key.job_type, bucket=key.bucket_n, slots=key.slots,
        backend=key.backend, dtype=key.dtype, integrator=key.integrator,
    )


def required_bytes_for_key(key) -> tuple[int, str]:
    """(bytes, source) a BatchKey's batch needs on the device: the
    ledger's measured peak once the key has run a round in this process,
    else the sizing-model estimate."""
    row = _LEDGER.row_for(engine_key_str(key))
    if row is not None and row.get("peak_bytes"):
        return int(row["peak_bytes"]), "measured"
    return estimate_peak_bytes(key), "estimated"


def check_admission_memory(key) -> None:
    """Raise :class:`InsufficientDeviceMemory` when ``key``'s batch
    cannot fit the device memory budget (no-op where there is no
    budget). The serving scheduler calls this at submit time."""
    budget = device_memory_budget()
    if not budget:
        return
    required, source = required_bytes_for_key(key)
    if required > budget * ADMIT_HEADROOM:
        raise InsufficientDeviceMemory(
            f"job does not fit device memory: backend {key.backend!r} at "
            f"bucket {key.bucket_n} x {key.slots} slots needs "
            f"~{required / 1e9:.2f} GB ({source}) vs a "
            f"{budget / 1e9:.2f} GB device budget (x{ADMIT_HEADROOM} "
            f"admission headroom); run it solo or shrink n",
            required_bytes=required, budget_bytes=budget, source=source,
        )


# --- the counted first call ---

class FirstCall:
    """The measurement around the counted step of a signature's first
    call: ``counter`` (a :class:`CostCounter`) and the peak device bytes
    (``torch.cuda.reset_peak_memory_stats`` and ``max_memory_allocated``
    on the card; the counter's live-byte high-water mark on the CPU) above
    what was allocated before, plus the step's own inputs
    (``input_bytes``). Entered around one step only, so that its
    allocator reads come after the steps queued before it, unless
    :meth:`start_peak` opened the peak's window earlier (a serve round's
    peak covers the whole round, which admission reserves)."""

    def __init__(self, device: torch.device, input_bytes: int):
        self.device = device
        self.input_bytes = int(input_bytes)
        self.counter = CostCounter(track_live=device.type != "cuda")
        self._before = None

    def start_peak(self) -> None:
        self._before = 0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
            self._before = torch.cuda.memory_allocated(self.device)

    def __enter__(self):
        if self._before is None:
            self.start_peak()
        self.counter.__enter__()
        return self

    def __exit__(self, *exc):
        return self.counter.__exit__(*exc)

    def peak(self) -> tuple[int, str]:
        """(peak bytes, peak source)."""
        if self.device.type == "cuda":
            return (torch.cuda.max_memory_allocated(self.device)
                    - self._before + self.input_bytes, "cuda_allocator")
        return (self.counter.peak_live + self.input_bytes,
                "counted_live_bytes")


def one_step_counted(step_fn, probe: FirstCall, n_steps: int):
    """``step_fn`` whose ``n_steps``-th (last) call runs under ``probe``
    (every step of a block runs the same ops)."""
    calls = [0]

    def step(*args):
        calls[0] += 1
        if calls[0] != n_steps:
            return step_fn(*args)
        with probe:
            return step_fn(*args)

    return step


class InstrumentedBlock:
    """The Simulator's block (``fn(state, acc, step_fn, *, n_steps,
    record_every)``) with a ledger row for every signature, keyed on
    (``n_steps``, ``record_every``, n, dtype, device). The first call of a
    signature counts its last step (:class:`FirstCall`); every later
    call, and every call under :func:`uncounted`, runs ``fn`` as it is.
    The result is the bits of ``fn``: the counter only watches."""

    def __init__(self, fn, *, site: str, key: str,
                 backend: Optional[str] = None, n: Optional[int] = None,
                 analytic: Optional[float] = None,
                 meta: Optional[dict] = None):
        self._fn = fn
        self.site = site
        self.key = key
        self.backend = backend
        self.n = n
        self.analytic = analytic
        self.meta = dict(meta or {})
        self._seen: set = set()
        self._lock = threading.Lock()

    def __call__(self, state, acc, step_fn, *, n_steps: int,
                 record_every: int = 0):
        pos = state.positions
        sig = (int(n_steps), int(record_every), int(pos.shape[-2]),
               str(pos.dtype), str(pos.device))
        with self._lock:
            first = sig not in self._seen and counting_allowed() \
                and _COUNTER.get() is None
            if first:
                self._seen.add(sig)
                ordinal = len(self._seen)
        if not first:
            return self._fn(state, acc, step_fn, n_steps=n_steps,
                            record_every=record_every)
        inputs = sum(_nbytes(t) for t in (state.positions, state.velocities,
                                           state.masses, acc))
        probe = FirstCall(pos.device, inputs)
        t0 = time.perf_counter()
        out = self._fn(state, acc, one_step_counted(step_fn, probe, n_steps),
                       n_steps=n_steps, record_every=record_every)
        seconds = time.perf_counter() - t0
        peak, source = probe.peak()
        _LEDGER.record_compile(
            site=self.site, key=self.key, compile_s=seconds,
            backend=self.backend, n=self.n, analytic=self.analytic,
            cost=probe.counter.cost(), peak_bytes=peak, peak_source=source,
            storm_count=ordinal, n_steps=int(n_steps),
            record_every=int(record_every),
            kernel_launches_counted=probe.counter.launches, **self.meta)
        return out


def summarize_rows(rows: list) -> list:
    """Latest row a ledger key, in first-seen order."""
    latest: dict = {}
    order: list = []
    for row in rows:
        key = row.get("key")
        if key not in latest:
            order.append(key)
        latest[key] = row
    return [latest[k] for k in order]


def read_ledger(path: str) -> list:
    """Rows of a ``perf_ledger.jsonl`` (torn lines tolerated)."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("event") == "perf_compile":
                out.append(rec)
    return out


def finite(x) -> bool:
    try:
        return x is not None and math.isfinite(float(x))
    except (TypeError, ValueError):
        return False
