"""The host-native C++ direct sum (``force_backend="cpp"``) and its wrapper.

Counterpart of ``gravity_tpu/ops/ffi_forces.py``: the multithreaded row
sum of ``csrc/host_forces.cpp`` (the JAX package's
``runtime/ffi_forces.cpp`` loop, with a plain C interface instead of an
XLA custom call), built with g++ by ``ops/host_build.py`` at first use and
called through ``ctypes``, which drops the GIL. It is the CPU's fast fp64
oracle and its mid-N direct sum: the static route takes it on the CPU
above ``simulation.DENSE_MAX_N`` bodies where it builds
(``simulation._resolve_direct``), and the sharded direct sums on gloo
ranks take it as their local kernel.

It runs on the host only. It takes CPU tensors of one dtype, float32 or
float64, and raises on a CUDA or meta tensor, on bfloat16 and on mixed
dtypes (``ValueError``), as the JAX kernel returns ``InvalidArgument``;
there is no plain fallback, since the CPU is the kernel's own device. The
plain version it is held against is ``ops/forces.py::accelerations_vs``.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from ..constants import CUTOFF_RADIUS, G
from ..telemetry.perf import count_launch
from ..utils.timing import FLOPS_PER_PAIR
from . import host_build
from .forces import require_no_grad, wrap_with_dense_vjp

_ENTRY = {torch.float32: "host_forces_f32", torch.float64: "host_forces_f64"}
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
             ctypes.c_double, ctypes.c_double]
LIBRARY = host_build.HostLibrary("host_forces", {
    **{name: (_ARGTYPES, ctypes.c_int) for name in _ENTRY.values()},
    "host_forces_threads": ([ctypes.c_int64], ctypes.c_int64),
})
SOURCE = LIBRARY.source
# Facts of the build this process loaded (cuda_build.CudaLibrary.info).
BUILD_INFO = LIBRARY.info

# Calls of the row sum so far; a run reads it to show its path went
# through the library. Incremented only where the library is called.
LAUNCHES = 0

_lock = threading.Lock()
_available: bool | None = None
_unavailable_reason = ""


def host_forces_available() -> bool:
    """True when the library built and loaded; tried once a process, as
    the JAX package's ``ffi_forces_available()``. A library on disk that
    will not load is removed, so that the next process builds it anew."""
    global _available, _unavailable_reason
    with _lock:
        if _available is None:
            try:
                LIBRARY.load()
                _available = True
            except (RuntimeError, OSError, AttributeError) as exc:
                _available = False
                _unavailable_reason = str(exc).splitlines()[0] if str(
                    exc) else type(exc).__name__
                if isinstance(exc, (OSError, AttributeError)):
                    try:
                        os.unlink(LIBRARY.library_path())
                    except OSError:
                        pass
        return _available


def unavailable_reason() -> str:
    """Why :func:`host_forces_available` is false ("" where it is true or
    was not asked)."""
    return _unavailable_reason


def threads(m: int) -> int:
    """The threads a call of ``m`` target rows runs on (one a slice of at
    least 64 rows, at most the host's hardware threads)."""
    return int(LIBRARY.load().host_forces_threads(m))


def _check(pos_i, pos_j, masses_j) -> None:
    """The JAX kernel's refusals (its ``InvalidArgument``s), as
    ``ValueError``, before anything is built."""
    dtype = pos_i.dtype
    for name, t in (("pos_i", pos_i), ("pos_j", pos_j),
                    ("masses_j", masses_j)):
        if t.device.type != "cpu":
            raise ValueError(
                f"the host-native C++ direct sum runs on the CPU; {name} is "
                f"on {t.device} (use force_backend='pallas' on the card, or "
                "--device cpu)")
        if t.dtype != dtype:
            raise ValueError(f"mixed dtypes: {name} is {t.dtype}, pos_i is "
                             f"{dtype}")
    if dtype not in _ENTRY:
        raise ValueError(f"the host-native C++ direct sum takes float32 or "
                         f"float64, not {dtype}")
    if (pos_i.ndim != 2 or pos_i.shape[1] != 3 or pos_j.ndim != 2
            or pos_j.shape[1] != 3 or masses_j.shape != pos_j.shape[:1]):
        raise ValueError(
            "expected pos_i (M, 3), pos_j (K, 3), masses_j (K,); got "
            f"{tuple(pos_i.shape)}, {tuple(pos_j.shape)}, "
            f"{tuple(masses_j.shape)}")


def cost_estimate(m: int, k: int, itemsize: int) -> tuple:
    """(flops, bytes_accessed, transcendentals) of one call: the plain
    direct sum's flops a pair (``utils/timing.FLOPS_PER_PAIR["jnp"]``), one
    square root a pair, and each input read once and the output written
    once."""
    return (FLOPS_PER_PAIR["jnp"] * m * k, (2 * m * 3 + k * 4) * itemsize,
            m * k)


def host_accelerations_vs(
    pos_i: torch.Tensor,
    pos_j: torch.Tensor,
    masses_j: torch.Tensor,
    *,
    g: float = G,
    cutoff: float = CUTOFF_RADIUS,
    eps: float = 0.0,
) -> torch.Tensor:
    """Accelerations on ``pos_i`` (M, 3) sourced by ``pos_j`` (K, 3) and
    ``masses_j`` (K,) by the C++ row sum: the contract of
    ``ops.forces.accelerations_vs`` (the cutoff on the softened r^2, which
    drops the self-pair), so that it serves as a local kernel. Forward
    only: a call that autograd would differentiate raises
    (:func:`~.forces.require_no_grad`); :func:`make_host_local_kernel`
    carries the dense backward."""
    global LAUNCHES
    require_no_grad("host_accelerations_vs", pos_i, pos_j, masses_j)
    _check(pos_i, pos_j, masses_j)
    if not host_forces_available():
        raise RuntimeError(
            "the host-native C++ direct sum is unavailable (its g++ build "
            f"failed: {unavailable_reason()}); use dense or chunked")
    pos_i, pos_j, masses_j = (t.contiguous() for t in (pos_i, pos_j,
                                                      masses_j))
    acc = torch.empty_like(pos_i)
    m, k = pos_i.shape[0], pos_j.shape[0]
    status = getattr(LIBRARY.load(), _ENTRY[pos_i.dtype])(
        pos_i.data_ptr(), pos_j.data_ptr(), masses_j.data_ptr(),
        acc.data_ptr(), m, k, float(g), float(cutoff), float(eps))
    LIBRARY.check(status)
    LAUNCHES += 1
    count_launch(*cost_estimate(m, k, pos_i.element_size()))
    return acc


def host_pairwise_accelerations(
    positions: torch.Tensor,
    masses: torch.Tensor,
    *,
    g: float = G,
    cutoff: float = CUTOFF_RADIUS,
    eps: float = 0.0,
) -> torch.Tensor:
    """All-pairs accelerations (targets == sources) by the C++ row sum."""
    return host_accelerations_vs(positions, positions, masses, g=g,
                                 cutoff=cutoff, eps=eps)


def make_host_local_kernel(*, g: float = G, cutoff: float = CUTOFF_RADIUS,
                           eps: float = 0.0):
    """A (targets, sources, masses) -> accelerations closure over
    :func:`host_accelerations_vs`: the local kernel of the sharded direct
    sums on gloo ranks and of the multirate fast kicks on the CPU (the
    counterpart of ``make_ffi_local_kernel``). Differentiable through the
    dense backward (:class:`~.forces.DenseVJP`, the JAX package's
    ``wrap_with_dense_vjp``): the C++ call has no backward."""

    def forward(pos_i, pos_j, masses_j):
        return host_accelerations_vs(pos_i, pos_j, masses_j, g=g,
                                     cutoff=cutoff, eps=eps)

    return wrap_with_dense_vjp(forward, g=g, cutoff=cutoff, eps=eps)
