"""Build and load the package's host-native C++ libraries.

The counterpart of ``gravity_tpu/utils/native.py``'s ``load_ffi_library``
for the port: a source in ``csrc/`` with a plain C interface is compiled
by ``g++`` into a shared library, bound with ``ctypes`` (a ctypes call
drops the GIL). It shares :class:`~.cuda_build.CudaLibrary`'s machinery:
the library lands in ``gravity_tpu_torch/build/`` (git-ignored), named by
a hash of its source and flags, written under a temporary name and
renamed, and built at first use, never when a module is imported. A plain
C library builds in seconds.

The flags are the JAX package's (``-std=c++17 -O3 -shared -fPIC
-pthread``) plus ``-ffp-contract=off``, which keeps a host whose g++
contracts to fused multiply-adds by default (an aarch64 one) on the same
bits as one that cannot. No ``-ffast-math`` and no ``-march=native``.
"""

from __future__ import annotations

import shutil

from .cuda_build import BUILD_DIR, CudaLibrary  # noqa: F401  (public name)

GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread",
             "-ffp-contract=off")


def gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(
            "g++ not found on PATH; the host-native C++ direct sum "
            "(force_backend='cpp') needs it to build"
        )
    return found


class HostLibrary(CudaLibrary):
    """One C++ source in ``csrc/``, its g++-built library and its ctypes
    binding. Every entry returns 0 or a code that the library's
    ``<name>_error_string`` names (:meth:`check`)."""

    SUFFIX = ".cpp"
    FLAGS = GXX_FLAGS

    @staticmethod
    def compiler() -> str:
        return gxx()
