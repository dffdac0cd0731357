"""The host-native C++ direct sum against the plain chunked sum on the CPU.

    python3 scripts/host_forces_cpu.py [--n 8192] [--reps 3]

Times one all-pairs force evaluation of ``force_backend="cpp"``
(``gravity_tpu_torch/ops/host_kernel.py``, the g++-built row sum of
``csrc/host_forces.cpp``, built at its first use) and of ``chunked``
(``ops/forces.py``, plain PyTorch, 1,024 targets a chunk) on the same
random cube (the ``random`` model of the run verb, seeded), in float64 and
float32, on the host clock: the median of ``--reps`` calls after one warm
call. Prints one JSON line: the CPU model and its hardware threads
(``/proc/cpuinfo``), the threads the row sum ran on and PyTorch's
intra-op threads, and for each dtype the ms of each form, their ratio and
the pairs a second. Runs on the CPU only; needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from gravity_tpu_torch.config import SimulationConfig  # noqa: E402
from gravity_tpu_torch.ops import host_kernel  # noqa: E402
from gravity_tpu_torch.ops.forces import (  # noqa: E402
    pairwise_accelerations_chunked,
)
from gravity_tpu_torch.simulation import make_initial_state  # noqa: E402


def cpu_model() -> str:
    with open("/proc/cpuinfo") as f:
        found = re.findall(r"^model name\s*:\s*(.+)$", f.read(), re.M)
    return found[0].strip() if found else "unknown"


def median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return 1e3 * statistics.median(times)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    if not host_kernel.host_forces_available():
        print(f"host_forces_cpu: the row sum did not build "
              f"({host_kernel.unavailable_reason()})", file=sys.stderr)
        return 1
    out = {"cpu": cpu_model(), "os_cpu_count": os.cpu_count(),
           "row_sum_threads": host_kernel.threads(args.n),
           "torch_threads": torch.get_num_threads(), "n": args.n,
           "build_s": host_kernel.BUILD_INFO["seconds"], "dtypes": {}}
    pairs = args.n * (args.n - 1)
    for dtype in ("float64", "float32"):
        config = SimulationConfig(model="random", n=args.n, dtype=dtype)
        state = make_initial_state(config, "cpu")
        pos, masses = state.positions, state.masses
        kw = dict(g=config.g, cutoff=config.cutoff, eps=config.eps)
        cpp = median_ms(lambda: host_kernel.host_pairwise_accelerations(
            pos, masses, **kw), args.reps)
        chunked = median_ms(lambda: pairwise_accelerations_chunked(
            pos, masses, **kw), args.reps)
        out["dtypes"][dtype] = {
            "cpp_ms": cpp, "chunked_ms": chunked,
            "chunked_over_cpp": chunked / cpp,
            "cpp_pairs_per_s": pairs / (cpp / 1e3),
            "chunked_pairs_per_s": pairs / (chunked / 1e3)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
