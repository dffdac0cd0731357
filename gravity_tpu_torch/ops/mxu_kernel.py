"""The Gram (matmul) formulation of the direct sum, and its CUDA kernel.

Counterpart of ``gravity_tpu/ops/pallas_forces_mxu.py``. The pair sum
a_i = sum_j w_ij (x_j - x_i) is recast as

- r_ij^2 = |x_i|^2 + |x_j|^2 - 2 x_i . x_j (the Gram trick), and
- a_i = sum_j w_ij [x_j | 1] = [S | W], then a_i = S - W x_i, the rank-1
  correction applied once in the epilogue.

The Gram expansion subtracts O(|x|^2) quantities, so pairs with raw
r^2 <= ``GRAM_NOISE_TAU`` * (|x_i|^2 + |x_j|^2) cannot be told from
coincident and get weight 0; that also zeroes self-pairs. Coordinates
are centred on the source centroid first. Production use is the softened
large-N regime (eps well above |x| * sqrt(tau)).

The wrapper :func:`accelerations_vs_mxu_kernel` does what the JAX wrapper
does around its TPU kernel on every device (centering, quantizing to
bf16 for ``precision="bf16"``, the epilogue). The [S | W] sum in between
is :func:`gram_acc4`: the hand-written CUDA kernel ``csrc/nbody_mxu.cu``
(which replaces the TPU kernel ``_nbody_mxu_kernel``) for CUDA tensors,
the plain version :func:`gram_acc4_plain` for CPU tensors only. The
plain version is elementwise fp32 and never a matrix product, so TF32
cannot touch it. The kernel sums [S | W] on the tensor cores, fp32
operands in TF32 with a hi/lo split; :func:`tf32_split` is that split
as plain tensor arithmetic, for the tests that hold its error.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..constants import CUTOFF_RADIUS, G
from ..telemetry.perf import count_launch
from . import cuda_build
from .direct_kernel import source_chunks
from .forces import require_no_grad, rounded, with_dense_vjp

# Gram-formulation noise floor: pairs with r^2 <= TAU * (|x_i|^2 +
# |x_j|^2) are below the fp32 cancellation resolution and are treated as
# coincident. 16 ulp of headroom over 2^-24.
GRAM_NOISE_TAU = 16.0 * 2.0**-24
PRECISIONS = ("dtype", "fp32", "bf16")


def _norm2(x: torch.Tensor) -> torch.Tensor:
    return x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2]


def _gram_weights(xi, ni, xj, nj, gmj, *, cutoff: float, eps: float):
    """(M, K) fp32 weights of targets xi (M, 3) against sources xj (K, 3),
    given their squared norms and G*m_j. eps^2 and cutoff^2 are squared in
    double and then rounded to fp32."""
    cross = (xi[:, None, 0] * xj[None, :, 0]
             + xi[:, None, 1] * xj[None, :, 1]
             + xi[:, None, 2] * xj[None, :, 2])
    s = ni[:, None] + nj[None, :]
    r2 = torch.clamp_min(s - 2.0 * cross, 0.0)
    r2_soft = r2 + eps * eps
    # The noise floor tests the RAW r^2: a softened self-pair would pass
    # any floor and enter the sums as two large cancelling terms.
    valid = (r2 > GRAM_NOISE_TAU * s) & (r2_soft > cutoff * cutoff)
    inv_r = torch.rsqrt(torch.where(valid, r2_soft, 1.0))
    return torch.where(valid, ((gmj[None, :] * inv_r) * inv_r) * inv_r, 0.0)


def gram_acc4_plain(xi: torch.Tensor, xj: torch.Tensor, gmj: torch.Tensor, *,
                    cutoff: float, eps: float, bf16: bool,
                    chunk: int = 256) -> torch.Tensor:
    """(M, 4) fp32 [sum_j w_ij x_j | sum_j w_ij]: the plain version of the
    kernel. xi (M, 3) and xj (K, 3) are centred operands in fp32 or bf16,
    gmj (K,) fp32. With ``bf16`` the weights are rounded to bf16 before
    they are summed; every sum is fp32. Targets go ``chunk`` rows at a
    time to bound the (chunk, K, 4) transient."""
    xi, xj = xi.float(), xj.float()
    ni, nj = _norm2(xi), _norm2(xj)
    xj4 = torch.cat([xj, torch.ones_like(xj[:, :1])], dim=1)
    rows = []
    for lo in range(0, xi.shape[0], chunk):
        w = _gram_weights(xi[lo:lo + chunk], ni[lo:lo + chunk], xj, nj, gmj,
                          cutoff=cutoff, eps=eps)
        if bf16:
            w = w.to(torch.bfloat16).float()
        rows.append((w[:, :, None] * xj4[None, :, :]).sum(dim=1))
    if not rows:
        return xi.new_zeros((0, 4))
    return torch.cat(rows)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` on finite values: the low 13 bits of
    the word cleared after adding half of their range."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """fp32 cut to TF32 by clearing the low 13 bits: what a tensor core
    reads of a TF32 operand that was not rounded first."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo, both TF32: hi = tf32_round(x), lo = tf32_round(x -
    hi). |x - (hi + lo)| <= 2^-22 |x|. The kernel splits its sources'
    coordinates so; of a weight w it rounds hi so and hands the tensor
    core w - hi unrounded, which it reads as tf32_truncate(w - hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


_ENTRY = {torch.float32: "nbody_mxu_f32", torch.bfloat16: "nbody_mxu_bf16"}
# The batched entries: a slot count after the solo entry's arguments.
_BATCHED = {torch.float32: "nbody_mxu_batched_f32",
            torch.bfloat16: "nbody_mxu_batched_bf16"}
_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_int64, _P, _P, ctypes.c_int64, ctypes.c_double,
             ctypes.c_double, ctypes.c_double, ctypes.c_int, _P, _P, _P, _P]
LIBRARY = cuda_build.CudaLibrary("nbody_mxu", {
    **{name: (_ARGTYPES, ctypes.c_int) for name in _ENTRY.values()},
    **{name: (_ARGTYPES + [ctypes.c_int], ctypes.c_int)
       for name in _BATCHED.values()},
    "nbody_mxu_shape": ([ctypes.c_int], ctypes.c_int),
    "nbody_mxu_blocks_per_sm": (
        [ctypes.c_int, ctypes.c_double, ctypes.c_double], ctypes.c_int),
})

# Kernel launches so far; a run reads it to show its path went through
# the kernel. Incremented only where the kernel is launched.
LAUNCHES = 0
# Batched launches so far (:func:`gram_acc4_batched`): one for each force
# evaluation of a whole batch, whatever its slot count.
BATCHED_LAUNCHES = 0


def _squares(eps: float, cutoff: float) -> tuple[float, float]:
    """eps^2 and cutoff^2 squared in double and rounded to fp32, as the
    plain version takes them."""
    return (rounded(eps * eps, torch.float32),
            rounded(cutoff * cutoff, torch.float32))


@functools.lru_cache(maxsize=16)
def _slots(index: int, bf16: bool, eps2: float, cutoff2: float) -> int:
    """Blocks of the kernel a launch takes that the whole card (CUDA
    device ``index``) holds at once: its SMs times the blocks an SM
    holds, both read once."""
    lib = LIBRARY.load()
    blocks = lib.nbody_mxu_blocks_per_sm(int(bf16), eps2, cutoff2)
    if blocks <= 0:
        LIBRARY.check(-blocks or 1)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * blocks


def chunks_for(m: int, k: int, *, bf16: bool, cutoff: float,
               eps: float) -> int:
    """The source chunks S that :func:`gram_acc4` takes for M targets and
    K sources on the current CUDA device."""
    lib = LIBRARY.load()
    slots = _slots(torch.cuda.current_device(), bf16, *_squares(eps, cutoff))
    return source_chunks(m, k, block_m=lib.nbody_mxu_shape(0),
                         tile=lib.nbody_mxu_shape(1), slots=slots)


def _check(xi, xj, gmj, batch: tuple = ()) -> None:
    """The launch's checks; ``batch`` is ``(B,)`` for a batched launch,
    whose arrays carry the slot axis first."""
    device, dtype = xi.device, xi.dtype
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}")
    if dtype not in _ENTRY:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 "
                        f"operands, not {dtype}")
    lead = len(batch)
    m, k = xi.shape[lead], xj.shape[lead]
    for name, t, shape, want in (("xi", xi, (*batch, m, 3), dtype),
                                 ("xj", xj, (*batch, k, 3), dtype),
                                 ("gmj", gmj, (*batch, k), torch.float32)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, xi on {device}")
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}, not {want}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def cost_estimate(m: int, k: int, *, block_m: int, tile: int,
                  batch: int = 1) -> tuple:
    """(flops, bytes_accessed, transcendentals) of one launch: the TPU
    kernel's ``pl.CostEstimate`` (``gravity_tpu/ops/pallas_forces_mxu.py:
    255-259``: 22 flops and one rsqrt a pair, ``(mp 3 + kp 8) 4 + mp 16``
    bytes) at this launch's own padding, M to whole blocks of ``block_m``
    and K to whole tiles, times the ``batch`` slots."""
    mp = -(-m // block_m) * block_m
    kp = -(-k // tile) * tile
    return (batch * 22 * mp * kp, batch * ((mp * 3 + kp * 8) * 4 + mp * 16),
            batch * mp * kp)


def gram_acc4(xi: torch.Tensor, xj: torch.Tensor, gmj: torch.Tensor, *,
              cutoff: float, eps: float) -> torch.Tensor:
    """:func:`gram_acc4_plain`'s contract, bf16 when the operands are.
    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/nbody_mxu.cu`` on the current stream, without synchronising,
    or raise (also where autograd would need a gradient through it: the
    differentiable entry is :func:`accelerations_vs_mxu_kernel`)."""
    global LAUNCHES
    bf16 = xi.dtype == torch.bfloat16
    if all(t.device.type == "cpu" for t in (xi, xj, gmj)):
        return gram_acc4_plain(xi, xj, gmj, cutoff=cutoff, eps=eps,
                               bf16=bf16)
    require_no_grad("nbody_mxu (gram_acc4)", xi, xj, gmj)
    _check(xi, xj, gmj)
    device = xi.device
    m, k = xi.shape[0], xj.shape[0]
    out = torch.empty((m, 4), dtype=torch.float32, device=device)
    if m == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(device):
        chunks = chunks_for(m, k, bf16=bf16, cutoff=cutoff, eps=eps)
        # Scratch: the sources packed a tile at a time in the kernel's
        # fragment order, and the chunks' partial sums.
        tile = lib.nbody_mxu_shape(1)
        packed = torch.empty(-(-k // tile) * lib.nbody_mxu_shape(2 + bf16),
                             dtype=torch.uint8, device=device)
        partial = (torch.empty((chunks, m, 4), dtype=torch.float32,
                               device=device) if chunks > 1 else out)
        status = getattr(lib, _ENTRY[xi.dtype])(
            xi.data_ptr(), m, xj.data_ptr(), gmj.data_ptr(), k,
            *_squares(eps, cutoff), GRAM_NOISE_TAU, chunks, packed.data_ptr(), partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    LIBRARY.check(status)
    LAUNCHES += 1
    count_launch(*cost_estimate(m, k, block_m=lib.nbody_mxu_shape(0),
                                tile=tile))
    return out


def gram_acc4_batched(xi: torch.Tensor, xj: torch.Tensor, gmj: torch.Tensor,
                      *, cutoff: float, eps: float) -> torch.Tensor:
    """:func:`gram_acc4` over a slot axis, ``(B, M, 3) x (B, K, 3) x (B, K)
    -> (B, M, 4)``, in one launch of each of the kernel's three parts.
    Slot b's rows have the bits of :func:`gram_acc4` on slot b's arrays
    (the same source chunking). CPU tensors take the plain version slot
    by slot; CUDA tensors launch the kernel or raise."""
    global BATCHED_LAUNCHES
    bf16 = xi.dtype == torch.bfloat16
    if all(t.device.type == "cpu" for t in (xi, xj, gmj)):
        rows = [gram_acc4_plain(xi[b], xj[b], gmj[b], cutoff=cutoff,
                                eps=eps, bf16=bf16)
                for b in range(xi.shape[0])]
        return (torch.stack(rows) if rows
                else xi.new_zeros((0, xi.shape[1], 4), dtype=torch.float32))
    require_no_grad("nbody_mxu/batched (gram_acc4_batched)", xi, xj, gmj)
    if xi.ndim != 3:
        raise ValueError(f"xi must be (B, M, 3), got {tuple(xi.shape)}")
    batch = xi.shape[0]
    _check(xi, xj, gmj, (batch,))
    if batch > 65_535:
        raise ValueError(f"a batched launch takes at most 65535 slots, "
                         f"got {batch}")
    device = xi.device
    m, k = xi.shape[1], xj.shape[1]
    out = torch.empty((batch, m, 4), dtype=torch.float32, device=device)
    if batch == 0 or m == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(device):
        chunks = chunks_for(m, k, bf16=bf16, cutoff=cutoff, eps=eps)
        tile = lib.nbody_mxu_shape(1)
        packed = torch.empty(
            batch * -(-k // tile) * lib.nbody_mxu_shape(2 + bf16),
            dtype=torch.uint8, device=device)
        partial = (torch.empty((batch, chunks, m, 4), dtype=torch.float32,
                               device=device) if chunks > 1 else out)
        status = getattr(lib, _BATCHED[xi.dtype])(
            xi.data_ptr(), m, xj.data_ptr(), gmj.data_ptr(), k,
            *_squares(eps, cutoff), GRAM_NOISE_TAU, chunks,
            packed.data_ptr(), partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream, batch,
        )
    LIBRARY.check(status)
    BATCHED_LAUNCHES += 1
    count_launch(*cost_estimate(m, k, block_m=lib.nbody_mxu_shape(0),
                                tile=tile, batch=batch))
    return out


def _operands(pos_i, pos_j, masses_j, g: float, compute: torch.dtype,
              center: torch.Tensor):
    """The kernel's operands: targets and sources centred on ``center``
    and cast to ``compute``, and G m_j in fp32."""
    xi = (pos_i.float() - center).to(compute).contiguous()
    xj = (pos_j.float() - center).to(compute).contiguous()
    gmj = (masses_j.float() * g).contiguous()
    return xi, xj, gmj


def _compute_dtype(precision: str, dtype: torch.dtype) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be 'dtype', 'fp32' or 'bf16'; got {precision!r}"
        )
    bf16 = precision == "bf16" or (precision == "dtype"
                                   and dtype == torch.bfloat16)
    return torch.bfloat16 if bf16 else torch.float32


def accelerations_vs_mxu_kernel(
    pos_i: torch.Tensor,
    pos_j: torch.Tensor,
    masses_j: torch.Tensor,
    *,
    g: float = G,
    cutoff: float = CUTOFF_RADIUS,
    eps: float = 0.0,
    precision: str = "dtype",
) -> torch.Tensor:
    """Accelerations on targets ``pos_i`` (M, 3) from sources ``pos_j``
    (K, 3) and ``masses_j`` (K,), in the Gram formulation: the contract of
    ``ops.forces.accelerations_vs`` up to the formulation's resolution.

    ``precision``: "fp32" | "bf16" | "dtype" (bf16 for a bf16 input,
    fp32 otherwise). Computes in fp32 (bf16 operands for "bf16") and
    returns the input dtype: a float64 input computes in float32.
    Differentiable on every device through :class:`~.forces.DenseVJP`
    (``make_pallas_mxu_local_kernel``'s ``wrap_with_dense_vjp``): the
    backward is the exact direct sum's VJP, whatever the precision."""
    return with_dense_vjp(
        functools.partial(_mxu_forward, g=g, cutoff=cutoff, eps=eps,
                          precision=precision),
        pos_i, pos_j, masses_j, g=g, cutoff=cutoff, eps=eps)


def _mxu_forward(pos_i, pos_j, masses_j, *, g: float, cutoff: float,
                 eps: float, precision: str) -> torch.Tensor:
    """The forward of :func:`accelerations_vs_mxu_kernel`."""
    out_dtype = pos_i.dtype
    compute = _compute_dtype(precision, out_dtype)
    # Centre on the source centroid: the noise floor and the epilogue's
    # cancellation both scale with |x|^2.
    center = pos_j.float().mean(dim=0)
    xi, xj, gmj = _operands(pos_i, pos_j, masses_j, g, compute, center)
    acc4 = gram_acc4(xi, xj, gmj, cutoff=cutoff, eps=eps)
    # Epilogue in the same centred (and, for bf16, quantized) frame.
    acc = acc4[:, :3] - acc4[:, 3:4] * xi.float()
    return acc.to(out_dtype)


def accelerations_vs_mxu_batched(pos_i, pos_j, masses_j, **kwargs):
    """The plain batched version: :func:`accelerations_vs_mxu_kernel` slot
    by slot (on CPU tensors its plain path)."""
    if pos_i.shape[0] == 0:
        return torch.empty_like(pos_i)
    return torch.stack([
        accelerations_vs_mxu_kernel(pos_i[b], pos_j[b], masses_j[b],
                                    **kwargs)
        for b in range(pos_i.shape[0])
    ])


def accelerations_vs_mxu_batched_kernel(
    pos_i: torch.Tensor,
    pos_j: torch.Tensor,
    masses_j: torch.Tensor,
    *,
    g: float = G,
    cutoff: float = CUTOFF_RADIUS,
    eps: float = 0.0,
    precision: str = "dtype",
) -> torch.Tensor:
    """B independent Gram-form sums, ``(B, M, 3) x (B, K, 3) x (B, K) ->
    (B, M, 3)``, through one batched launch (:func:`gram_acc4_batched`).
    Slot b's result has the bits of :func:`accelerations_vs_mxu_kernel`
    on slot b's arrays: each slot's centroid is reduced on its own (K, 3)
    rows, as the solo wrapper reduces them, and the rest is elementwise.
    CPU tensors take the plain batched version. Differentiable through
    :class:`~.forces.DenseVJP`, slot by slot."""
    return with_dense_vjp(
        functools.partial(_mxu_batched_forward, g=g, cutoff=cutoff, eps=eps,
                          precision=precision),
        pos_i, pos_j, masses_j, g=g, cutoff=cutoff, eps=eps)


def _mxu_batched_forward(pos_i, pos_j, masses_j, *, g: float, cutoff: float,
                         eps: float, precision: str) -> torch.Tensor:
    """The forward of :func:`accelerations_vs_mxu_batched_kernel`."""
    if all(t.device.type == "cpu" for t in (pos_i, pos_j, masses_j)):
        return accelerations_vs_mxu_batched(
            pos_i, pos_j, masses_j, g=g, cutoff=cutoff, eps=eps,
            precision=precision)
    out_dtype = pos_i.dtype
    compute = _compute_dtype(precision, out_dtype)
    if pos_i.shape[0] == 0:
        return torch.empty_like(pos_i)
    center = torch.stack([pos_j[b].float().mean(dim=0)
                          for b in range(pos_j.shape[0])])[:, None, :]
    xi, xj, gmj = _operands(pos_i, pos_j, masses_j, g, compute, center)
    acc4 = gram_acc4_batched(xi, xj, gmj, cutoff=cutoff, eps=eps)
    acc = acc4[..., :3] - acc4[..., 3:4] * xi.float()
    return acc.to(out_dtype)


def pairwise_accelerations_mxu(positions, masses, **kwargs) -> torch.Tensor:
    """All-pairs accelerations (targets == sources), Gram formulation."""
    return accelerations_vs_mxu_kernel(positions, positions, masses, **kwargs)


def make_mxu_local_kernel(*, g: float = G, cutoff: float = CUTOFF_RADIUS,
                          eps: float = 0.0, precision: str = "dtype"):
    """A (targets, sources, masses) -> accelerations closure over
    :func:`accelerations_vs_mxu_kernel`, differentiable through the dense
    backward (:class:`~.forces.DenseVJP`)."""

    def kernel(pos_i, pos_j, masses_j):
        return accelerations_vs_mxu_kernel(
            pos_i, pos_j, masses_j, g=g, cutoff=cutoff, eps=eps,
            precision=precision,
        )

    return kernel
