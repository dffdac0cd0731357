"""The hand-written CUDA direct-sum kernel and its wrapper.

Counterpart of ``gravity_tpu/ops/pallas_forces.py``: the kernel in
``csrc/nbody_direct.cu`` replaces the TPU kernel ``_nbody_kernel`` that
``pallas_accelerations_vs`` reaches. The source's own note says what
bounds it and how it is tiled.

The library is compiled with ``nvcc`` for ``sm_90a`` into
``gravity_tpu_torch/build/`` at first use, named by a hash of the source
and the flags, so an edited source is rebuilt. It exposes a plain C
interface, bound here with ``ctypes``.

:func:`accelerations_vs_kernel` takes the plain PyTorch version
(``ops/forces.py::accelerations_vs``) only for tensors that lie on the
CPU. For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from ..constants import CUTOFF_RADIUS, G
from .forces import accelerations_vs

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PACKAGE_DIR, "csrc", "nbody_direct.cu")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "build")
# No --use_fast_math: the kernel must keep subnormals (see the source).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_ENTRY = {torch.float32: "nbody_direct_f32", torch.float64: "nbody_direct_f64"}
_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}

# Kernel launches so far; a run reads it to show its path went through
# the kernel. Incremented only where the kernel is launched.
LAUNCHES = 0

_lib = None
# Facts of the build this process loaded: path, seconds spent in nvcc (0
# when the library was already built), and the compiler's -Xptxas -v
# report of registers and shared memory.
BUILD_INFO: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernel needs the CUDA toolkit to build"
        )
    return found


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libnbody_direct_{digest}.so")


def build() -> dict:
    """Compile the kernel's library unless this source is built already."""
    out = library_path()
    if os.path.exists(out):
        return {"path": out, "seconds": 0.0, "ptxas": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}"
        )
    # Atomic publish: a concurrent process sees the whole library or none.
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "ptxas": proc.stderr}


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        info = build()
        lib = ctypes.CDLL(info["path"])
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
                ctypes.c_double, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        lib.nbody_direct_error_string.argtypes = [ctypes.c_int]
        lib.nbody_direct_error_string.restype = ctypes.c_char_p
        BUILD_INFO.update(info)
        _lib = lib
    return _lib


def _check(pos_i, pos_j, masses_j) -> None:
    device, dtype = pos_i.device, pos_i.dtype
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}")
    if dtype not in _ENTRY:
        raise TypeError(f"the CUDA kernel takes float32 or float64, not {dtype}")
    for name, t in (("pos_i", pos_i), ("pos_j", pos_j),
                    ("masses_j", masses_j)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, pos_i on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, pos_i is {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, k = pos_i.shape[0], pos_j.shape[0]
    if pos_i.shape != (m, 3) or pos_j.shape != (k, 3):
        raise ValueError(
            f"positions must be (M, 3) and (K, 3), got "
            f"{tuple(pos_i.shape)} and {tuple(pos_j.shape)}"
        )
    if masses_j.shape != (k,):
        raise ValueError(f"masses_j must be ({k},), got {tuple(masses_j.shape)}")


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
    on the current stream, without synchronising, or raise."""
    global LAUNCHES
    if all(t.device.type == "cpu" for t in (pos_i, pos_j, masses_j)):
        return accelerations_vs(pos_i, pos_j, masses_j, g=g, cutoff=cutoff,
                                eps=eps)
    _check(pos_i, pos_j, masses_j)
    dtype, device = pos_i.dtype, pos_i.device
    scalar = _NP_DTYPE[dtype]
    # Rounded to the element type before squaring, as the plain version.
    eps2 = float(scalar(eps) * scalar(eps))
    cutoff2 = float(scalar(cutoff) * scalar(cutoff))
    masked = eps * eps <= cutoff * cutoff
    gm = torch.tensor(g, dtype=dtype, device=device) * masses_j
    acc = torch.empty_like(pos_i)
    if pos_i.shape[0] == 0:
        return acc
    lib = load_library()
    with torch.cuda.device(device):
        status = getattr(lib, _ENTRY[dtype])(
            pos_i.data_ptr(), pos_i.shape[0], pos_j.data_ptr(),
            gm.data_ptr(), pos_j.shape[0], eps2, cutoff2, int(masked),
            acc.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            "nbody_direct launch failed: "
            + lib.nbody_direct_error_string(status).decode()
        )
    LAUNCHES += 1
    return acc
