"""The port stands alone and never falls back to the CPU on its own.

- No file of gravity_tpu_torch/ or chip_smoke.py imports jax or
  gravity_tpu (an AST scan), and importing the package loads neither.
- Entry points default to the GPU and raise when there is none.
- Each kernel wrapper takes the plain version only for CPU tensors; for
  any other device it launches the kernel or raises, and it has no
  ``try`` that could fall back.
"""

import ast
import inspect
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.ops import cuda_build, direct_kernel, mxu_kernel, nlist
from gravity_tpu_torch.simulation import Simulator
from gravity_tpu_torch.utils.platform import resolve_device

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "gravity_tpu")


def _port_files():
    files = sorted((REPO_ROOT / "gravity_tpu_torch").rglob("*.py"))
    return files + [REPO_ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) >= 15
    router = REPO_ROOT / "gravity_tpu_torch" / "serve" / "router"
    assert {router / f"{m}.py" for m in ("__init__", "policy", "daemon")
            } <= set(files)
    for path in files:
        bad = set(_imported_roots(path)) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(REPO_ROOT)} imports {bad}"


def test_importing_the_package_loads_no_jax():
    code = (
        "import sys, gravity_tpu_torch, gravity_tpu_torch.cli, "
        "gravity_tpu_torch.simulation, gravity_tpu_torch.interop, "
        "gravity_tpu_torch.ops.p3m, gravity_tpu_torch.ops.pm, "
        "gravity_tpu_torch.models.disk, gravity_tpu_torch.serve.router\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_gpu_means_an_error_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(device)
    with pytest.raises(RuntimeError, match="--device cpu"):
        Simulator(SimulationConfig(n=8))
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrapper_on_cpu_takes_the_plain_version_without_launching():
    pos = torch.rand(32, 3, dtype=torch.float64) * 1e11
    masses = torch.rand(32, dtype=torch.float64) * 1e24
    before = direct_kernel.LAUNCHES
    direct_kernel.accelerations_vs_kernel(pos, pos, masses)
    assert direct_kernel.LAUNCHES == before


def test_wrapper_raises_rather_than_falling_back():
    """A tensor that is neither on the CPU nor on a CUDA device goes to
    the kernel's checks, which refuse it; nothing falls back."""
    pos = torch.empty(4, 3, device="meta")
    masses = torch.empty(4, device="meta")
    before = direct_kernel.LAUNCHES
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        direct_kernel.accelerations_vs_kernel(pos, pos, masses)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        direct_kernel.accelerations_vs_kernel(pos, torch.zeros(4, 3),
                                              torch.ones(4))
    assert direct_kernel.LAUNCHES == before


def _meta_nlist_args(device="meta"):
    cells = torch.empty(8, 4, 3, device=device)
    count = torch.empty(8, dtype=torch.int64, device=device)
    gm = torch.empty(8, 4, device=device)
    return (cells, count, cells, gm, count, 2, torch.empty(1, device=device))


def test_new_wrappers_raise_rather_than_falling_back():
    """The cell-list and Gram-form wrappers, like the direct one, refuse a
    tensor that is neither on the CPU nor on a CUDA device."""
    before = (dict(nlist.LAUNCHES), mxu_kernel.LAUNCHES)
    for kind in nlist.PAIR_KINDS:
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            nlist.pair_cells_kernel(*_meta_nlist_args(), cutoff=1e-10,
                                    eps=0.0, kind=kind)
    xi = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mxu_kernel.gram_acc4(xi, xi, torch.empty(4, device="meta"),
                             cutoff=1e-10, eps=0.0)
    assert (nlist.LAUNCHES, mxu_kernel.LAUNCHES) == before


def _has_try(fn):
    tree = ast.parse(inspect.getsource(fn).lstrip())
    return any(isinstance(n, ast.Try) for n in ast.walk(tree))


def test_wrapper_has_no_try():
    assert not _has_try(direct_kernel.accelerations_vs_kernel)


@pytest.mark.parametrize("wrapper", [nlist.pair_cells_kernel,
                                     mxu_kernel.gram_acc4])
def test_new_wrappers_have_no_try(wrapper):
    assert not _has_try(wrapper)


def test_kernel_source_is_built_for_hopper_without_fast_math():
    flags = " ".join(direct_kernel.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "ftz=true" not in flags
    assert os.path.exists(direct_kernel.SOURCE)
    assert direct_kernel.library_path().startswith(direct_kernel.BUILD_DIR)


@pytest.mark.parametrize("library", [nlist.LIBRARY, mxu_kernel.LIBRARY])
def test_new_kernel_sources_build_with_the_shared_flags(library):
    """Every kernel builds with the one set of nvcc flags, into the one
    git-ignored build directory."""
    assert cuda_build.NVCC_FLAGS == direct_kernel.NVCC_FLAGS
    assert os.path.exists(library.source)
    path = library.library_path()
    assert path.startswith(cuda_build.BUILD_DIR)
    assert os.path.basename(path).startswith(f"lib{library.name}_")
