"""Build and load the package's hand-written CUDA kernels.

Each kernel source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, bound with ``ctypes``.
The library lands in ``gravity_tpu_torch/build/`` (git-ignored), named by
a hash of its source and the flags, so an edited source is rebuilt; it is
written under a temporary name and renamed, so a concurrent process sees
the whole library or none. Nothing is built when a module is imported:
the first launch, or :func:`build_all`, builds.

No ``--use_fast_math``: the kernels keep subnormals (the fp32 weight
``((G m inv_r) inv_r) inv_r`` of a distant light pair is subnormal, and
flushing it would drop the pair).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels need the CUDA toolkit to build"
        )
    return found


@functools.lru_cache(maxsize=1)
def nvcc_version() -> str:
    """The release line of the ``nvcc`` that builds the kernels (``nvcc
    --version``'s last line), or ``"none"`` where there is none."""
    try:
        out = subprocess.run([nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return "none"
    lines = out.strip().splitlines()
    return lines[-1] if lines else "unknown"


class CudaLibrary:
    """One kernel source, its built library and its ctypes binding.

    ``signatures`` maps each exported C function to its
    ``(argtypes, restype)``. Every launch function returns the
    ``cudaGetLastError()`` of its launch as an int, and the library
    exports ``<name>_error_string`` to name it. A subclass names another
    compiler, source suffix and flags (``ops/host_build.HostLibrary``)."""

    SUFFIX = ".cu"
    FLAGS = NVCC_FLAGS

    def __init__(self, name: str, signatures: dict):
        self.name = name
        self.source = os.path.join(CSRC_DIR, f"{name}{self.SUFFIX}")
        self.signatures = dict(signatures)
        self.signatures[f"{name}_error_string"] = (
            [ctypes.c_int], ctypes.c_char_p
        )
        # Facts of the build this process loaded: path, seconds spent in
        # the compiler (0 when the library was already built), and its
        # diagnostics (nvcc's -Xptxas -v report of registers and shared
        # memory).
        self.info: dict = {}
        self._lib = None

    @staticmethod
    def compiler() -> str:
        return nvcc()

    def digest(self) -> str:
        """A hash of the source and the flags: it names the built library,
        and it keys what was measured with it (``autotune.versions``)."""
        with open(self.source, "rb") as f:
            return hashlib.sha256(
                f.read() + " ".join(self.FLAGS).encode()
            ).hexdigest()[:16]

    def library_path(self) -> str:
        return os.path.join(BUILD_DIR, f"lib{self.name}_{self.digest()}.so")

    def _start(self):
        """Start the compiler unless the library is built; returns the
        pending build or a finished record."""
        out = self.library_path()
        if os.path.exists(out):
            return {"path": out, "seconds": 0.0, "ptxas": ""}
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        compiler = self.compiler()
        proc = subprocess.Popen(
            [compiler, *self.FLAGS, "-o", tmp, self.source],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        return (proc, tmp, out, time.perf_counter(),
                os.path.basename(compiler))

    @staticmethod
    def _finish(pending) -> dict:
        if isinstance(pending, dict):
            return pending
        proc, tmp, out, t0, compiler = pending
        _, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"{compiler} failed on {os.path.basename(out)} with exit "
                f"code {proc.returncode}:\n{stderr}"
            )
        os.replace(tmp, out)
        return {"path": out, "seconds": seconds, "ptxas": stderr}

    def build(self) -> dict:
        """Compile the library unless this source is built already."""
        return self._finish(self._start())

    def load(self, built: dict | None = None) -> ctypes.CDLL:
        if self._lib is None:
            info = built if built is not None else self.build()
            lib = ctypes.CDLL(info["path"])
            for fn_name, (argtypes, restype) in self.signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = restype
            self.info.update(info)
            self._lib = lib
        return self._lib

    def check(self, status: int) -> None:
        """Raise on a launch's nonzero ``cudaGetLastError()`` status."""
        if status != 0:
            err = getattr(self._lib, f"{self.name}_error_string")(status)
            raise RuntimeError(f"{self.name} launch failed: {err.decode()}")


def build_all(libraries) -> None:
    """Build and load every library, one compiler process each, all
    started together."""
    libraries = [lib for lib in libraries if lib._lib is None]
    pending = [lib._start() for lib in libraries]
    failures = []
    # Every nvcc is waited for before a failure is raised.
    for lib, job in zip(libraries, pending):
        try:
            built = CudaLibrary._finish(job)
        except RuntimeError as exc:
            failures.append(str(exc))
            continue
        lib.load(built)
    if failures:
        raise RuntimeError("\n".join(failures))
