#!/usr/bin/env python3
"""Smoke run of gravity_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel from the checkout, holds it against its plain
PyTorch version on the card, drives the reference direct-sum run at its
full size (the ``reference-cuda`` preset: N = 50,000, 500 Euler steps)
and the package's other entry points, and times the kernel beside its
bound. Each phase prints one JSON line; the last two lines are the
kernels table and ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero and prints no result. It needs a
CUDA device and the package beside it, and imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Per-pair cost of the direct sum (the JAX cost model of the TPU kernel,
# gravity_tpu/ops/pallas_forces.py:143): ~20 flops and one rsqrt.
FLOPS_PER_PAIR = 20
# H100 SXM published peaks: fp32 outside the tensor cores and HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# rsqrt issue rate of the special function units, per SM per clock.
SFU_PER_SM_PER_CLOCK = 16

# Tolerances of kernel vs plain version, in units of each row's sum of
# |terms| (the scale that a row's summation rounds at). The kernel sums
# each 256-source tile in order and then adds the tile sums, so its
# worst-case rounding is ~(256 + K/256) ulp of that scale; the plain
# version's reduction rounds less. fp32: 451 ulp = 2.7e-5 at K = 50,000,
# plus a few ulp per term from rsqrt; fp64: 451 ulp = 5e-14.
TOL = {"float32": 1e-4, "float64": 1e-12}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def check(cond: bool, message: str) -> None:
    if not cond:
        raise RuntimeError(message)


def nvidia_smi(query: str, *extra: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
         *extra],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Median ms of ``fn`` over ``reps`` calls, each timed with events."""
    import torch

    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def term_scale(pos_i, pos_j, masses_j, eps, chunk=1024):
    """Per-component sum over sources of |w_ij * d_ij|, in float64."""
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS, G
    from gravity_tpu_torch.ops.forces import _pair_weights

    pos_i, pos_j, masses_j = (t.double() for t in (pos_i, pos_j, masses_j))
    rows = []
    for pi in torch.split(pos_i, chunk):
        diff = pos_j[None, :, :] - pi[:, None, :]
        w = _pair_weights((diff * diff).sum(-1), masses_j[None, :], G,
                          CUTOFF_RADIUS, eps)
        rows.append((w[:, :, None] * diff.abs()).sum(dim=1))
    return torch.cat(rows)


def compare(name, kern, plain, scale, dtype_name) -> dict:
    """Kernel against plain version; raises past the stated tolerance."""
    import torch

    check(bool(torch.isfinite(kern).all()), f"{name}: kernel output not finite")
    diff = (kern.double() - plain.double()).abs()
    zero_scale = scale == 0
    check(bool((diff[zero_scale] == 0).all()),
          f"{name}: nonzero output where every term is zero")
    scaled = diff[~zero_scale] / scale[~zero_scale]
    max_scaled = float(scaled.max()) if scaled.numel() else 0.0
    norm = plain.double().norm(dim=1)
    rel = (diff.norm(dim=1) / norm)[norm > 0]
    tol = TOL[dtype_name]
    record = {
        "case": name, "dtype": dtype_name,
        "max_err_over_term_scale": max_scaled, "tolerance": tol,
        "tolerance_reason": "in units of the row's sum of |terms|: "
                            "worst-case rounding of the kernel's two-level "
                            "sum is ~(256 + K/256) ulp",
        "max_rel_err": float(rel.max()) if rel.numel() else 0.0,
        "p99_rel_err": (float(torch.quantile(rel, 0.99))
                        if rel.numel() else 0.0),
        "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
    }
    check(max_scaled <= tol,
          f"{name}: error {max_scaled:.3e} of the term scale > {tol:.0e}")
    return record


def phase_device() -> dict:
    import torch

    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    props = torch.cuda.get_device_properties(0)
    record = {
        "phase": "device", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "nvidia_smi": smi,
        "sm_count": props.multi_processor_count,
        "max_sm_clock_mhz": float(
            nvidia_smi("clocks.max.sm", "--format=csv,noheader,nounits")
        ),
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }
    emit(record)
    return record


def phase_build() -> dict:
    from gravity_tpu_torch.ops import direct_kernel

    t0 = time.perf_counter()
    direct_kernel.load_library()
    info = direct_kernel.BUILD_INFO
    record = {
        "phase": "build", "source": "gravity_tpu_torch/csrc/nbody_direct.cu",
        "nvcc_s": info["seconds"], "total_s": time.perf_counter() - t0,
        "ptxas": [line for line in info["ptxas"].splitlines()
                  if "registers" in line or "Compiling" in line],
    }
    emit(record)
    return record


def phase_kernel_vs_plain() -> float:
    """Every case of the kernel against the plain version; returns the
    max abs error at the main path's shape (N = 50,000, fp32)."""
    import torch

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.models import generate_random_particles
    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel
    from gravity_tpu_torch.ops.forces import (
        accelerations_vs,
        pairwise_accelerations_chunked,
    )
    from gravity_tpu_torch.simulation import make_initial_state

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(7)
    for (m, k) in ((64, 64), (1000, 1000), (100, 384)):
        base = generate_random_particles(gen, k, dtype=torch.float64,
                                         device=dev)
        for dtype in (torch.float32, torch.float64):
            pos_j = base.positions.to(dtype)
            m_j = base.masses.to(dtype)
            pos_i = pos_j[:m].contiguous()
            for eps in (0.0, 1e9):
                kern = accelerations_vs_kernel(pos_i, pos_j, m_j, eps=eps)
                plain = accelerations_vs(pos_i, pos_j, m_j, eps=eps)
                torch.cuda.synchronize()
                emit({"phase": "kernel_vs_plain", **compare(
                    f"{m}x{k} eps={eps:g}", kern, plain,
                    term_scale(pos_i, pos_j, m_j, eps),
                    str(dtype).removeprefix("torch."),
                )})

    # 16 coincident 1e30 kg bodies: every pair is below the cutoff.
    pos = torch.zeros(16, 3, device=dev)
    masses = torch.full((16,), 1e30, device=dev)
    acc = accelerations_vs_kernel(pos, pos, masses)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(acc).all()) and bool((acc == 0).all()),
          "coincident bodies: output must be all zero with no NaN")
    emit({"phase": "kernel_vs_plain", "case": "16 coincident 1e30 kg",
          "all_zero": True, "tolerance": "exact"})

    # Two bodies 1e13 m apart in fp32. The 1e5 kg body's weight on the
    # other is G m / r^3 = 6.7e-45, a subnormal (~5 x 2^-149): a build
    # that flushes subnormals returns 0 there. Tolerance: 1e-5 for the
    # normal side, 25% for the subnormal side (its precision is ~1/5).
    pos = torch.tensor([[0.0, 0.0, 0.0], [1e13, 0.0, 0.0]], device=dev)
    masses = torch.tensor([1e24, 1e5], device=dev)
    acc = accelerations_vs_kernel(pos, pos, masses).double().cpu()
    torch.cuda.synchronize()
    g = 6.67430e-11
    want = torch.tensor([g * 1e5 / 1e26, -g * 1e24 / 1e26],
                        dtype=torch.float64)
    rel = ((acc[:, 0] - want) / want).abs()
    check(bool((acc[:, 0] != 0).all()),
          "1e13 m pair: fp32 force flushed to zero (subnormal lost)")
    check(float(rel[1]) < 1e-5 and float(rel[0]) < 0.25,
          f"1e13 m pair: relative errors {rel.tolist()}")
    emit({"phase": "kernel_vs_plain", "case": "2 bodies 1e13 m fp32",
          "acc_x": acc[:, 0].tolist(), "rel_err_vs_fp64": rel.tolist(),
          "tolerance": [0.25, 1e-5]})

    # The main path's shape: the full reference-cuda random cube.
    state = make_initial_state(PRESETS["reference-cuda"], dev)
    kern = accelerations_vs_kernel(state.positions, state.positions,
                                   state.masses)
    plain = pairwise_accelerations_chunked(state.positions, state.masses)
    torch.cuda.synchronize()
    record = compare("reference-cuda N=50000", kern, plain,
                     term_scale(state.positions, state.positions,
                                state.masses, 0.0), "float32")
    emit({"phase": "kernel_vs_plain", **record})
    return record["max_abs_err"]


def phase_main_path() -> dict:
    """The reference-cuda run through the Simulator, counting launches."""
    import torch

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.ops import direct_kernel
    from gravity_tpu_torch.simulation import Simulator
    from gravity_tpu_torch.utils.logging import RunLogger

    config = PRESETS["reference-cuda"]
    sim = Simulator(config)
    log_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(log_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=log_root) as log_dir:
        logger = RunLogger(log_dir, quiet=True)
        direct_kernel.LAUNCHES = 0
        stats = sim.run(logger)
        launches = direct_kernel.LAUNCHES
        with open(logger.path) as f:
            log = f.read()
    final = stats["final_state"]
    check(sim.backend == "nbody_direct", f"backend {sim.backend}")
    check(launches >= config.steps,
          f"{launches} kernel launches for {config.steps} steps")
    check(tuple(final.positions.shape) == (config.n, 3), "final shape")
    check(bool(torch.isfinite(final.positions).all()
               & torch.isfinite(final.velocities).all()),
          "final state not finite")
    for section in ("gravity simulation at", f"Step {config.steps}/",
                    "Performance Statistics:", "Final positions:",
                    "Simulation completed successfully"):
        check(section in log, f"log lacks {section!r}")
    record = {
        "phase": "main_path", "preset": "reference-cuda", "n": config.n,
        "steps": config.steps, "integrator": config.integrator,
        "launches": launches, "total_s": stats["total_time_s"],
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "pairs_per_s": stats["pairs_per_sec"], "device": stats["device"],
    }
    emit(record)
    return record


def phase_small_reference() -> None:
    """A small fp64 run on the card against the same run on the CPU's
    plain version: 8 bodies, 20 Euler steps. Tolerance 1e-12 relative:
    the two differ only in summation order and rsqrt rounding."""
    import dataclasses

    import torch

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.simulation import Simulator

    config = dataclasses.replace(PRESETS["reference-mpi"], steps=20,
                                 dtype="float64")
    gpu = Simulator(config).run()["final_state"]
    cpu = Simulator(config, device="cpu").run()["final_state"]
    err = float(((gpu.positions.cpu() - cpu.positions).norm(dim=1)
                 / cpu.positions.norm(dim=1)).max())
    check(err < 1e-12, f"small fp64 run: card vs CPU rel err {err:.3e}")
    emit({"phase": "small_reference", "preset": "reference-mpi",
          "steps": 20, "dtype": "float64", "max_rel_err_vs_cpu": err,
          "tolerance": 1e-12})


def phase_other_entry_points() -> None:
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.ops import direct_kernel
    from gravity_tpu_torch.simulation import Simulator
    from gravity_tpu_torch.utils.trajectory import TrajectoryReader

    # The CLI on the card, with trajectories, in a process of its own.
    log_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(log_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=log_root) as log_dir:
        env = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.run(
            [sys.executable, "-m", "gravity_tpu_torch", "run",
             "--preset", "reference-spark", "--steps", "100",
             "--trajectories", "--log-dir", log_dir],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
        )
        check(proc.returncode == 0,
              f"CLI run failed ({proc.returncode}): {proc.stderr[-2000:]}")
        stats = json.loads(proc.stdout.strip().splitlines()[-1])
        frames = TrajectoryReader(stats["trajectory_dir"]).load(mmap=False)
    check(stats["backend"] == "nbody_direct" and
          stats["kernel_launches"] >= 100,
          f"CLI run did not go through the kernel: {stats}")
    check(frames.shape == (100, 1000, 3) and bool(
        torch.isfinite(torch.from_numpy(frames)).all()),
          f"trajectories: shape {frames.shape}")
    emit({"phase": "cli_reference_spark", "steps": 100,
          "launches": stats["kernel_launches"],
          "total_s": stats["total_time_s"],
          "trajectory_frames": frames.shape[0]})

    # Softened leapfrog: the mask-free specialization on the main path.
    config = SimulationConfig(model="random", n=16384, eps=1e9,
                              integrator="leapfrog", steps=50)
    sim = Simulator(config)
    direct_kernel.LAUNCHES = 0
    stats = sim.run()
    launches = direct_kernel.LAUNCHES
    final = stats["final_state"]
    check(launches >= config.steps,
          f"leapfrog: {launches} launches for {config.steps} steps")
    check(bool(torch.isfinite(final.positions).all()),
          "leapfrog: final state not finite")
    emit({"phase": "leapfrog_softened", "n": config.n, "eps": config.eps,
          "steps": config.steps, "launches": launches,
          "ms_per_step": 1e3 * stats["avg_step_s"]})


def phase_timing(device: dict) -> dict:
    """Kernel and plain version at the main path's shape, beside the
    bound: the larger of the bytes over HBM bandwidth and the operations
    over their peak rate (fp32 flops; rsqrt on the special function
    units at 16 per SM per clock)."""
    import torch

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel
    from gravity_tpu_torch.ops.forces import pairwise_accelerations_chunked
    from gravity_tpu_torch.simulation import make_initial_state

    state = make_initial_state(PRESETS["reference-cuda"],
                               torch.device("cuda", 0))
    pos, masses = state.positions, state.masses
    n = pos.shape[0]

    def kernel():
        accelerations_vs_kernel(pos, pos, masses)

    def plain():
        pairwise_accelerations_chunked(pos, masses)

    cuda_ms(kernel, 3)
    ms = cuda_ms(kernel, 30)
    cuda_ms(plain, 1)
    plain_ms = cuda_ms(plain, 5)
    ms_again = cuda_ms(kernel, 30)

    pairs = n * n
    clock_hz = device["max_sm_clock_mhz"] * 1e6
    flop_ms = 1e3 * pairs * FLOPS_PER_PAIR / PEAK_FP32_FLOPS
    sfu_ms = 1e3 * pairs / (device["sm_count"] * SFU_PER_SM_PER_CLOCK
                            * clock_hz)
    # Each input read once (positions, masses), the output written once.
    byte_ms = 1e3 * (n * 3 + n + n * 3) * 4 / PEAK_BYTES_PER_S
    bound_ms = max(flop_ms, sfu_ms, byte_ms)
    record = {
        "phase": "timing", "n": n, "dtype": "float32", "ms": ms,
        "ms_repeat": ms_again, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if byte_ms == bound_ms else "operations",
        "fp32_flop_ms": flop_ms, "sfu_rsqrt_ms": sfu_ms,
        "hbm_bytes_ms": byte_ms, "share_of_bound": bound_ms / ms,
        "library_ms": None,
        "library_note": "no single PyTorch call computes this sum",
        "nvidia_smi": device["nvidia_smi"],
    }
    emit(record)
    return record


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import gravity_tpu_torch  # noqa: F401  (fails where the repo is absent)

    # Plain-version references in full fp32 (guide: TF32 defaults).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    device = phase_device()
    phase_build()
    max_abs_err = phase_kernel_vs_plain()
    main_path = phase_main_path()
    phase_small_reference()
    phase_other_entry_points()
    timing = phase_timing(device)
    emit({"phase": "done", "wall_s": time.perf_counter() - t0,
          "kernel_share_of_main_path_step":
              timing["ms"] / main_path["ms_per_step"]})
    emit({"kernels": [{
        "name": "nbody_direct", "route": "cuda",
        "source": "gravity_tpu_torch/csrc/nbody_direct.cu",
        "replaces": "gravity_tpu/ops/pallas_forces.py:45",
        "launches": main_path["launches"],
        "max_abs_err": max_abs_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None, "checked_against_plain": True,
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
