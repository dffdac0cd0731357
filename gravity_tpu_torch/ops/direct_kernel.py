"""The hand-written CUDA direct-sum kernel and its wrapper.

Counterpart of ``gravity_tpu/ops/pallas_forces.py``: the kernel in
``csrc/nbody_direct.cu`` replaces the TPU kernel ``_nbody_kernel`` that
``pallas_accelerations_vs`` reaches, in three forms: float32, float64 and
bfloat16 (fp32 registers, rounded to bf16 where the plain version holds
a bf16 value, summed in fp32 and rounded once a target). The source's
own note says what bounds it and how it is tiled. It is built and bound
by ``ops/cuda_build.py``.

:func:`accelerations_vs_kernel` takes the plain PyTorch version
(``ops/forces.py::accelerations_vs``) only for tensors that lie on the
CPU. For CUDA tensors it launches the kernel or raises. Its backward, on
every device, is the JAX package's dense VJP (``ops/forces.py::
DenseVJP``): plain PyTorch, no kernel, as JAX has no backward kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..constants import CUTOFF_RADIUS, G
from ..telemetry.perf import count_launch
from . import cuda_build
from .cuda_build import BUILD_DIR, NVCC_FLAGS  # noqa: F401  (public names)
from .forces import accelerations_vs, rounded, with_dense_vjp

_ENTRY = {torch.float32: "nbody_direct_f32", torch.float64: "nbody_direct_f64",
          torch.bfloat16: "nbody_direct_bf16"}
# The type each form computes and sums in (its scratch's dtype), and its
# code in nbody_direct_blocks_per_sm.
_COMPUTE = {torch.float32: torch.float32, torch.float64: torch.float64,
            torch.bfloat16: torch.float32}
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_P = ctypes.c_void_p
_ARGTYPES = [
    _P, ctypes.c_int64, _P, _P, ctypes.c_int64, ctypes.c_double,
    ctypes.c_double, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
]
# The batched entries: a slot count after the solo entry's arguments.
_BATCHED = {dtype: name.replace("nbody_direct_", "nbody_direct_batched_")
            for dtype, name in _ENTRY.items()}
# The most slots a batched launch takes (the grid's slot axis).
MAX_SLOTS = 65_535
LIBRARY = cuda_build.CudaLibrary("nbody_direct", {
    **{name: (_ARGTYPES, ctypes.c_int) for name in _ENTRY.values()},
    **{name: (_ARGTYPES + [ctypes.c_int], ctypes.c_int)
       for name in _BATCHED.values()},
    "nbody_direct_shape": ([ctypes.c_int], ctypes.c_int),
    "nbody_direct_blocks_per_sm": (
        [ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double],
        ctypes.c_int),
})
SOURCE = LIBRARY.source
# Facts of the build this process loaded (cuda_build.CudaLibrary.info).
BUILD_INFO = LIBRARY.info

# Kernel launches so far; a run reads it to show its path went through
# the kernel. Incremented only where the kernel is launched.
LAUNCHES = 0
# Batched launches so far (:func:`accelerations_vs_batched_kernel`): one
# for each force evaluation of a whole batch, whatever its slot count.
BATCHED_LAUNCHES = 0


def library_path() -> str:
    return LIBRARY.library_path()


def build() -> dict:
    """Compile the kernel's library unless this source is built already."""
    return LIBRARY.build()


def load_library() -> ctypes.CDLL:
    return LIBRARY.load()


# The most source chunks a launch takes: the chunk sums add at most this
# many ulp to a row's rounding (csrc/nbody_direct.cu).
MAX_CHUNKS = 64


@functools.lru_cache(maxsize=64)
def source_chunks(m: int, k: int, *, block_m: int, tile: int,
                  slots: int) -> int:
    """How many chunks S to split the K sources into for M targets.

    The grid is ceil(M / block_m) x S blocks of equal work, and the card
    runs ``slots`` of them at once (SMs x blocks an SM holds). The time
    is taken as waves x (tiles a chunk + 1), the 1 a block's fixed cost
    in tiles; S minimises it, the smallest S on a tie, at most
    :data:`MAX_CHUNKS` and at most one chunk a tile, so no chunk is
    empty. A grid that already fills whole waves keeps S = 1."""
    n_tiles = -(-k // tile)
    i_tiles = -(-m // block_m)
    if n_tiles <= 1 or i_tiles == 0:
        return 1
    best, best_cost = 1, None
    for s in range(1, min(MAX_CHUNKS, n_tiles) + 1):
        waves = -(-(i_tiles * s) // slots)
        cost = waves * (-(-n_tiles // s) + 1)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def cost_estimate(m: int, k: int, *, block_m: int, tile: int,
                  batch: int = 1) -> tuple:
    """(flops, bytes_accessed, transcendentals) of one launch: the TPU
    kernel's ``pl.CostEstimate`` (``gravity_tpu/ops/pallas_forces.py:
    158-162``: 20 flops and one rsqrt a pair, ``(mp 3 + 2 kp 4) 4`` bytes)
    at this launch's own padding, M to whole blocks of ``block_m`` and K
    to whole tiles, times the ``batch`` slots."""
    mp = -(-m // block_m) * block_m
    kp = -(-k // tile) * tile
    return (batch * 20 * mp * kp, batch * (mp * 3 + 2 * kp * 4) * 4,
            batch * mp * kp)


@functools.lru_cache(maxsize=64)
def _slots(index: int, dtype: torch.dtype, masked: bool, eps2: float,
           cutoff2: float) -> int:
    """Blocks of the kernel a launch takes that the whole card (CUDA
    device ``index``) holds at once: its SMs times the blocks an SM
    holds, both read once."""
    lib = load_library()
    blocks = lib.nbody_direct_blocks_per_sm(_DTYPE_CODE[dtype], int(masked),
                                            eps2, cutoff2)
    if blocks <= 0:
        LIBRARY.check(-blocks or 1)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * blocks


def chunks_for(m: int, k: int, *, dtype: torch.dtype, cutoff: float,
               eps: float) -> int:
    """The source chunks S that :func:`accelerations_vs_kernel` takes for
    M targets and K sources of ``dtype`` on the current CUDA device."""
    lib = load_library()
    slots = _slots(torch.cuda.current_device(), dtype,
                   eps * eps <= cutoff * cutoff,
                   rounded(rounded(eps, dtype) ** 2, dtype),
                   rounded(rounded(cutoff, dtype) ** 2, dtype))
    return source_chunks(m, k, block_m=lib.nbody_direct_shape(0),
                         tile=lib.nbody_direct_shape(1), slots=slots)


def _check(pos_i, pos_j, masses_j, batch: tuple = ()) -> None:
    """The launch's checks; ``batch`` is ``(B,)`` for a batched launch,
    whose arrays carry the slot axis first."""
    device, dtype = pos_i.device, pos_i.dtype
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}")
    if dtype not in _ENTRY:
        raise TypeError(f"the CUDA kernel takes float32, float64 or "
                        f"bfloat16, not {dtype}")
    for name, t in (("pos_i", pos_i), ("pos_j", pos_j),
                    ("masses_j", masses_j)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, pos_i on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, pos_i is {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lead = len(batch)
    m, k = pos_i.shape[lead], pos_j.shape[lead]
    if pos_i.shape != (*batch, m, 3) or pos_j.shape != (*batch, k, 3):
        raise ValueError(
            f"positions must be {(*batch, 'M', 3)} and {(*batch, 'K', 3)}, "
            f"got {tuple(pos_i.shape)} and {tuple(pos_j.shape)}"
        )
    if masses_j.shape != (*batch, k):
        raise ValueError(f"masses_j must be {(*batch, k)}, got "
                         f"{tuple(masses_j.shape)}")


def accelerations_vs_kernel(
    pos_i: torch.Tensor,
    pos_j: torch.Tensor,
    masses_j: torch.Tensor,
    *,
    g: float = G,
    cutoff: float = CUTOFF_RADIUS,
    eps: float = 0.0,
) -> torch.Tensor:
    """Accelerations on ``pos_i`` (M, 3) sourced by ``pos_j`` (K, 3) and
    ``masses_j`` (K,): the contract of ``ops.forces.accelerations_vs``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    on the current stream, without synchronising, or raise. Differentiable
    on every device through :class:`~.forces.DenseVJP` (the JAX package's
    ``wrap_with_dense_vjp``): the backward launches no kernel."""
    return with_dense_vjp(functools.partial(_launch, g=g, cutoff=cutoff,
                                            eps=eps),
                          pos_i, pos_j, masses_j, g=g, cutoff=cutoff, eps=eps)


def _launch(pos_i, pos_j, masses_j, *, g: float, cutoff: float,
            eps: float) -> torch.Tensor:
    """The forward of :func:`accelerations_vs_kernel`."""
    global LAUNCHES
    if all(t.device.type == "cpu" for t in (pos_i, pos_j, masses_j)):
        return accelerations_vs(pos_i, pos_j, masses_j, g=g, cutoff=cutoff,
                                eps=eps)
    _check(pos_i, pos_j, masses_j)
    dtype, device = pos_i.dtype, pos_i.device
    compute = _COMPUTE[dtype]
    # Rounded to the element type, then squared in it, as the plain
    # version (the square of a value of the type is exact in a double).
    eps2 = rounded(rounded(eps, dtype) ** 2, dtype)
    cutoff2 = rounded(rounded(cutoff, dtype) ** 2, dtype)
    masked = eps * eps <= cutoff * cutoff
    # G rounded to the element type, times m, rounded: the plain
    # version's _scalar(g) * m_j, with no host-to-device copy (which
    # would wait for the stream).
    gm = masses_j * rounded(g, dtype)
    acc = torch.empty_like(pos_i)
    if pos_i.shape[0] == 0:
        return acc
    lib = load_library()
    m, k = pos_i.shape[0], pos_j.shape[0]
    tile = lib.nbody_direct_shape(1)
    with torch.cuda.device(device):
        chunks = chunks_for(m, k, dtype=dtype, cutoff=cutoff, eps=eps)
        # Scratch in the compute type: the sources packed as (x, y, z,
        # G m), padded to whole tiles, and the chunks' partial sums (the
        # bf16 form always sums into them and rounds once).
        packed = torch.empty((-(-k // tile) * tile, 4), dtype=compute,
                             device=device)
        partial = (torch.empty((chunks, m, 3), dtype=compute, device=device)
                   if chunks > 1 or compute != dtype else acc)
        status = getattr(lib, _ENTRY[dtype])(
            pos_i.data_ptr(), m, pos_j.data_ptr(), gm.data_ptr(), k, eps2,
            cutoff2, int(masked), chunks, packed.data_ptr(),
            partial.data_ptr(), acc.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    LIBRARY.check(status)
    LAUNCHES += 1
    count_launch(*cost_estimate(m, k, block_m=lib.nbody_direct_shape(0),
                                tile=tile))
    return acc


def accelerations_vs_batched(pos_i, pos_j, masses_j, **kwargs):
    """The plain batched version: :func:`~.forces.accelerations_vs` slot by
    slot over ``(B, M, 3)``, ``(B, K, 3)`` and ``(B, K)``."""
    if pos_i.shape[0] == 0:
        return torch.empty_like(pos_i)
    return torch.stack([
        accelerations_vs(pos_i[b], pos_j[b], masses_j[b], **kwargs)
        for b in range(pos_i.shape[0])
    ])


def accelerations_vs_batched_kernel(
    pos_i: torch.Tensor,
    pos_j: torch.Tensor,
    masses_j: torch.Tensor,
    *,
    g: float = G,
    cutoff: float = CUTOFF_RADIUS,
    eps: float = 0.0,
) -> torch.Tensor:
    """B independent direct sums, ``(B, M, 3) x (B, K, 3) x (B, K) ->
    (B, M, 3)``, in one launch of each of the kernel's three parts (the
    serve engine's batched force evaluation). Slot b's result has the
    bits of :func:`accelerations_vs_kernel` on slot b's arrays: the source
    chunking is the one a solo launch at (M, K) takes.

    CPU tensors take the plain batched version
    (:func:`accelerations_vs_batched`); CUDA tensors launch the kernel on
    the current stream, without synchronising, or raise. Differentiable
    through :class:`~.forces.DenseVJP`, slot by slot (the fit class's
    batched rollout)."""
    return with_dense_vjp(functools.partial(_launch_batched, g=g,
                                            cutoff=cutoff, eps=eps),
                          pos_i, pos_j, masses_j, g=g, cutoff=cutoff, eps=eps)


def _launch_batched(pos_i, pos_j, masses_j, *, g: float, cutoff: float,
                    eps: float) -> torch.Tensor:
    """The forward of :func:`accelerations_vs_batched_kernel`."""
    global BATCHED_LAUNCHES
    if all(t.device.type == "cpu" for t in (pos_i, pos_j, masses_j)):
        return accelerations_vs_batched(pos_i, pos_j, masses_j, g=g,
                                        cutoff=cutoff, eps=eps)
    if pos_i.ndim != 3:
        raise ValueError(f"pos_i must be (B, M, 3), got {tuple(pos_i.shape)}")
    batch = pos_i.shape[0]
    _check(pos_i, pos_j, masses_j, (batch,))
    if batch > MAX_SLOTS:
        raise ValueError(f"a batched launch takes at most {MAX_SLOTS} "
                         f"slots, got {batch}")
    dtype, device = pos_i.dtype, pos_i.device
    compute = _COMPUTE[dtype]
    eps2 = rounded(rounded(eps, dtype) ** 2, dtype)
    cutoff2 = rounded(rounded(cutoff, dtype) ** 2, dtype)
    masked = eps * eps <= cutoff * cutoff
    gm = masses_j * rounded(g, dtype)
    acc = torch.empty_like(pos_i)
    m, k = pos_i.shape[1], pos_j.shape[1]
    if batch == 0 or m == 0:
        return acc
    lib = load_library()
    tile = lib.nbody_direct_shape(1)
    with torch.cuda.device(device):
        chunks = chunks_for(m, k, dtype=dtype, cutoff=cutoff, eps=eps)
        packed = torch.empty((batch, -(-k // tile) * tile, 4), dtype=compute,
                             device=device)
        partial = (torch.empty((batch, chunks, m, 3), dtype=compute,
                               device=device)
                   if chunks > 1 or compute != dtype else acc)
        status = getattr(lib, _BATCHED[dtype])(
            pos_i.data_ptr(), m, pos_j.data_ptr(), gm.data_ptr(), k, eps2,
            cutoff2, int(masked), chunks, packed.data_ptr(),
            partial.data_ptr(), acc.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream, batch,
        )
    LIBRARY.check(status)
    BATCHED_LAUNCHES += 1
    count_launch(*cost_estimate(m, k, block_m=lib.nbody_direct_shape(0),
                                tile=tile, batch=batch))
    return acc


def make_direct_local_kernel(*, g: float = G, cutoff: float = CUTOFF_RADIUS,
                             eps: float = 0.0):
    """A (targets, sources, masses) -> accelerations closure over
    :func:`accelerations_vs_kernel`: the (M, K) launches of the multirate
    fast kicks and of a rank's block (the counterpart of
    ``make_pallas_local_kernel``), differentiable through the dense
    backward (:class:`~.forces.DenseVJP`)."""

    def kernel(pos_i, pos_j, masses_j):
        return accelerations_vs_kernel(pos_i, pos_j, masses_j, g=g,
                                       cutoff=cutoff, eps=eps)

    return kernel
