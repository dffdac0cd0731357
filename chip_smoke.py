#!/usr/bin/env python3
"""Smoke run of gravity_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the three CUDA kernels from the checkout (one nvcc each, all
started together), holds each against its plain PyTorch version on the
card, and drives each kernel's path at full size through the Simulator,
with every launch count set to 0 just before the path and read just
after:

- the reference direct-sum run (the ``reference-cuda`` preset: N = 50,000,
  500 Euler steps) through ``nbody_direct``, plus the package's other
  entry points;
- the cutoff-radius cell-list run (N = 262,144, leapfrog, rcut = 5e10 m,
  eps = 1e9 m, 500 steps) through ``nlist_pair``;
- the Gram-form direct sum (N = 65,536, leapfrog, eps = 1e9 m, 100 steps)
  through ``nbody_mxu``.

It then times each kernel at its path's shapes beside its bound. Each
phase prints one JSON line; the last two lines are the kernels table and
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result. It needs a CUDA device and the
package beside it, and imports nothing of JAX.
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
# gravity_tpu/ops/pallas_forces.py:143): ~20 flops and one rsqrt. The
# cell-list tile: 21 (pallas_nlist.py:381); the Gram form: 22
# (pallas_forces_mxu.py:238). Each pair also takes one rsqrt.
FLOPS_PER_PAIR = 20
NLIST_FLOPS_PER_PAIR = 21
MXU_FLOPS_PER_PAIR = 22
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
DIRECT_REASON = ("in units of the row's sum of |terms|: worst-case "
                 "rounding of the kernel's two-level sum is "
                 "~(256 + K/256) ulp")
# The cell-list kernel forms r^2 and its masks with the same roundings as
# the plain version (so both take the same pairs) and sums each
# neighbor's tile row apart: ~(cap + 27) ulp of the row's sum of |terms|,
# 283 ulp = 3.4e-5 in fp32 at cap 256, plus a few ulp a term from rsqrt.
NLIST_REASON = ("in units of the row's sum of |terms|: same masks as the "
                "plain version; the kernel's per-neighbor row sums round "
                "at ~(cap + 27) ulp")
# The Gram kernel's output is [sum w x_j | sum w] before the epilogue;
# its rounding is that of a two-level fp32 sum, ~(256 + K/256) ulp of
# sum |w| |x_j| (512 ulp = 6.1e-5 at K = 65,536).
MXU_REASON = ("in units of the row's sum of |w| |[x_j | 1]|: same masks "
              "as the plain version; the two-level fp32 sum rounds at "
              "~(256 + K/256) ulp")

# The cell-list run of README.md (the JAX package's command): random cube,
# N = 262,144, leapfrog, --nlist-rcut 5e10 --eps 1e9, 500 steps.
NLIST_RUN = dict(model="random", n=262_144, integrator="leapfrog",
                 force_backend="nlist", nlist_rcut=5e10, eps=1e9, steps=500)
# The Gram-form run: README.md's flagship direct sum (N = 65,536,
# leapfrog, eps = 1e9) on the random model, through pallas-mxu.
MXU_RUN = dict(model="random", n=65_536, integrator="leapfrog",
               force_backend="pallas-mxu", eps=1e9, steps=100)


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


def reset_counts() -> None:
    from gravity_tpu_torch.ops import direct_kernel, mxu_kernel, nlist

    for module in (direct_kernel, nlist, mxu_kernel):
        module.LAUNCHES = 0


def read_counts() -> dict:
    from gravity_tpu_torch.ops import direct_kernel, mxu_kernel, nlist

    return {"nbody_direct": direct_kernel.LAUNCHES,
            "nlist_pair": nlist.LAUNCHES, "nbody_mxu": mxu_kernel.LAUNCHES}


def compare(name, kern, plain, scale, dtype_name, tol=None,
            reason=DIRECT_REASON) -> dict:
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
    tol = TOL[dtype_name] if tol is None else tol
    record = {
        "case": name, "dtype": dtype_name,
        "max_err_over_term_scale": max_scaled, "tolerance": tol,
        "tolerance_reason": reason,
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
    """All three libraries, one nvcc each, started together."""
    from gravity_tpu_torch.ops import (
        cuda_build,
        direct_kernel,
        mxu_kernel,
        nlist,
    )

    t0 = time.perf_counter()
    libraries = (direct_kernel.LIBRARY, nlist.LIBRARY, mxu_kernel.LIBRARY)
    cuda_build.build_all(libraries)
    total = time.perf_counter() - t0
    records = {}
    for lib in libraries:
        records[lib.name] = {
            "phase": "build",
            "source": f"gravity_tpu_torch/csrc/{lib.name}.cu",
            "nvcc_s": lib.info["seconds"], "total_s": total,
            "ptxas": [line for line in lib.info["ptxas"].splitlines()
                      if "registers" in line or "Compiling" in line
                      or "smem" in line],
        }
        emit(records[lib.name])
    return records


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
    from gravity_tpu_torch.simulation import Simulator
    from gravity_tpu_torch.utils.logging import RunLogger

    config = PRESETS["reference-cuda"]
    sim = Simulator(config)
    log_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(log_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=log_root) as log_dir:
        logger = RunLogger(log_dir, quiet=True)
        reset_counts()
        stats = sim.run(logger)
        launches = read_counts()["nbody_direct"]
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
    reset_counts()
    stats = sim.run()
    launches = read_counts()["nbody_direct"]
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


def nlist_tiles(positions, masses, side, cap, rcut):
    """The pair-tile kernel's arguments for the self form at a state, as
    ``nlist_accelerations_vs`` builds them."""
    from gravity_tpu_torch.constants import G
    from gravity_tpu_torch.ops import nlist

    _, _, params, _, binned = nlist.source_cells(
        positions, masses, rcut=rcut, side=side, cap=cap)
    cells_pos, cells_mass, count = binned[:3]
    return (cells_pos, count, cells_pos, cells_mass * G, count, side, params)


def nlist_compare(name, positions, masses, side, cap, rcut, eps) -> dict:
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.ops import nlist

    args = nlist_tiles(positions, masses, side, cap, rcut)
    kw = dict(cutoff=CUTOFF_RADIUS, eps=eps)
    kern = nlist.pair_cells_kernel(*args, **kw)
    plain = nlist.pair_cells_plain(*args, **kw)
    scale = nlist.pair_cells_plain(*args, absolute=True, **kw)
    torch.cuda.synchronize()
    dtype_name = str(positions.dtype).removeprefix("torch.")
    record = compare(name, kern.reshape(-1, 3), plain.reshape(-1, 3),
                     scale.reshape(-1, 3), dtype_name, reason=NLIST_REASON)
    count = args[1]
    record.update({
        "side": side, "cap": cap, "n": positions.shape[0],
        "overflowing_cells": int((count > cap).sum()),
        "max_occupancy": int(count.max()),
        "pairs_evaluated": nlist.real_pairs(count, count, side, cap, cap),
    })
    return record


def phase_nlist_kernel_vs_plain() -> float:
    """The cell-list kernel against its plain version; returns the max
    abs error at the main path's shape (the README state, fp32)."""
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.models import generate_random_particles
    from gravity_tpu_torch.ops import nlist
    from gravity_tpu_torch.simulation import make_initial_state

    dev = torch.device("cuda", 0)
    config = SimulationConfig(**NLIST_RUN)
    state = make_initial_state(config, dev)
    side, cap = nlist.resolve_nlist_sizing(state.positions, config.nlist_rcut)
    main = nlist_compare("README state N=262144", state.positions,
                         state.masses, side, cap, config.nlist_rcut,
                         config.eps)
    emit({"phase": "nlist_kernel_vs_plain", **main})

    gen = torch.Generator().manual_seed(11)
    small = generate_random_particles(gen, 20_000, dtype=torch.float64,
                                      device=dev)
    # Overflow: side 4 holds ~312 bodies a cell against a cap of 64.
    record = nlist_compare("overflow N=20000 side=4 cap=64",
                           small.positions.float(), small.masses.float(), 4,
                           64, 5e10, 1e9)
    check(record["overflowing_cells"] > 0, "overflow case did not overflow")
    emit({"phase": "nlist_kernel_vs_plain", **record})
    side64, cap64 = nlist.resolve_nlist_sizing(small.positions, 5e10)
    emit({"phase": "nlist_kernel_vs_plain", **nlist_compare(
        "fp64 N=20000", small.positions, small.masses, side64, cap64, 5e10,
        1e9)})

    # Two bodies 1e13 m apart inside the radius (a massless third body
    # widens the cube so the cell edge exceeds 1e13 m). The 1e5 kg body's
    # weight on the other, G m / r^3 = 6.7e-45, is subnormal in fp32: a
    # build that flushes subnormals returns 0. Tolerance as for the
    # direct kernel: 1e-5 normal side, 25% subnormal side.
    pos = torch.tensor([[0.0, 0.0, 0.0], [1e13, 0.0, 0.0],
                        [2.2e13, 0.0, 0.0]], device=dev)
    masses = torch.tensor([1e24, 1e5, 0.0], device=dev)
    reset_counts()
    acc = nlist.nlist_accelerations(pos, masses, rcut=1.2e13, side=2,
                                    cap=8).double().cpu()
    torch.cuda.synchronize()
    check(read_counts()["nlist_pair"] == 1, "subnormal case: no launch")
    g = 6.67430e-11
    want = torch.tensor([g * 1e5 / 1e26, -g * 1e24 / 1e26],
                        dtype=torch.float64)
    rel = ((acc[:2, 0] - want) / want).abs()
    check(bool((acc[:2, 0] != 0).all()),
          "nlist 1e13 m pair: fp32 force flushed to zero (subnormal lost)")
    check(float(rel[1]) < 1e-5 and float(rel[0]) < 0.25,
          f"nlist 1e13 m pair: relative errors {rel.tolist()}")
    emit({"phase": "nlist_kernel_vs_plain", "case": "2 bodies 1e13 m fp32",
          "acc_x": acc[:2, 0].tolist(), "rel_err_vs_fp64": rel.tolist(),
          "tolerance": [0.25, 1e-5]})

    # 16 coincident 1e30 kg bodies: r = 0 for every pair.
    pos = torch.zeros(16, 3, device=dev)
    masses = torch.full((16,), 1e30, device=dev)
    acc = nlist.nlist_accelerations(pos, masses, rcut=1e11, side=2, cap=16)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(acc).all()) and bool((acc == 0).all()),
          "nlist coincident bodies: output must be all zero with no NaN")
    emit({"phase": "nlist_kernel_vs_plain", "case": "16 coincident 1e30 kg",
          "all_zero": True, "tolerance": "exact"})
    return main["max_abs_err"]


def mxu_scale(xi, xj, gmj, eps, bf16, chunk=256):
    """Per-row sum of |w| |[x_j | 1]| of the Gram form, in fp32."""
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.ops import mxu_kernel

    xi, xj = xi.float(), xj.float()
    ni, nj = mxu_kernel._norm2(xi), mxu_kernel._norm2(xj)
    xj4 = torch.cat([xj.abs(), torch.ones_like(xj[:, :1])], dim=1)
    rows = []
    for lo in range(0, xi.shape[0], chunk):
        w = mxu_kernel._gram_weights(xi[lo:lo + chunk], ni[lo:lo + chunk],
                                     xj, nj, gmj, cutoff=CUTOFF_RADIUS,
                                     eps=eps)
        if bf16:
            w = w.to(torch.bfloat16).float()
        rows.append((w[:, :, None] * xj4[None]).sum(dim=1))
    return torch.cat(rows)


def mxu_compare(name, pos_i, pos_j, masses, eps, bf16) -> dict:
    """The Gram kernel's [S | W] against the plain version's, and the
    accelerations after the epilogue."""
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS, G
    from gravity_tpu_torch.ops import mxu_kernel

    compute = torch.bfloat16 if bf16 else torch.float32
    center = pos_j.float().mean(dim=0)
    xi = (pos_i.float() - center).to(compute).contiguous()
    xj = (pos_j.float() - center).to(compute).contiguous()
    gm = (masses.float() * G).contiguous()
    kern = mxu_kernel.gram_acc4(xi, xj, gm, cutoff=CUTOFF_RADIUS, eps=eps)
    plain = mxu_kernel.gram_acc4_plain(xi, xj, gm, cutoff=CUTOFF_RADIUS,
                                       eps=eps, bf16=bf16)
    scale = mxu_scale(xi, xj, gm, eps, bf16)
    torch.cuda.synchronize()
    record = compare(name, kern, plain, scale, "float32", reason=MXU_REASON)
    acc_k = kern[:, :3] - kern[:, 3:4] * xi.float()
    acc_p = plain[:, :3] - plain[:, 3:4] * xi.float()
    diff = (acc_k.double() - acc_p.double())
    rel = diff.norm(dim=1) / acc_p.double().norm(dim=1)
    record.update({
        "precision": "bf16" if bf16 else "fp32",
        "acc_max_abs_err": float(diff.abs().max()),
        "acc_median_rel_err": float(rel.median()),
        "acc_p99_rel_err": float(torch.quantile(rel, 0.99)),
    })
    return record


def phase_mxu_kernel_vs_plain() -> float:
    """The Gram kernel against its plain version; returns the max abs
    error of the accelerations at the main path's shape (N = 65,536,
    fp32)."""
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.models import generate_random_particles
    from gravity_tpu_torch.ops.mxu_kernel import accelerations_vs_mxu_kernel
    from gravity_tpu_torch.simulation import make_initial_state

    dev = torch.device("cuda", 0)
    state = make_initial_state(SimulationConfig(**MXU_RUN), dev)
    main_err = None
    for bf16 in (False, True):
        record = mxu_compare("N=65536", state.positions, state.positions,
                             state.masses, 1e9, bf16)
        emit({"phase": "mxu_kernel_vs_plain", **record})
        if not bf16:
            main_err = record["acc_max_abs_err"]
    gen = torch.Generator().manual_seed(13)
    small = generate_random_particles(gen, 1000, device=dev)
    for bf16 in (False, True):
        emit({"phase": "mxu_kernel_vs_plain", **mxu_compare(
            "ragged 777x1000", small.positions[:777].contiguous(),
            small.positions, small.masses, 1e9, bf16)})
    pos = torch.full((16, 3), 2.5e11, device=dev)
    masses = torch.full((16,), 1e30, device=dev)
    for eps in (0.0, 1e9):
        for precision in ("fp32", "bf16"):
            acc = accelerations_vs_mxu_kernel(pos, pos, masses, eps=eps,
                                              precision=precision)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(acc).all()) and bool((acc == 0).all()),
                  f"mxu coincident bodies ({precision}, eps={eps:g}): "
                  "output must be all zero with no NaN")
    emit({"phase": "mxu_kernel_vs_plain", "case": "16 coincident 1e30 kg",
          "eps": [0.0, 1e9], "precision": ["fp32", "bf16"],
          "all_zero": True, "tolerance": "exact"})
    return main_err


def phase_nlist_main_path() -> dict:
    """The README cell-list run through the Simulator, all 500 steps."""
    import warnings

    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.ops import nlist
    from gravity_tpu_torch.simulation import Simulator
    from gravity_tpu_torch.utils.logging import RunLogger

    config = SimulationConfig(**NLIST_RUN)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = Simulator(config)
    side, cap, slots = sim.nlist_sizing
    args = nlist_tiles(sim.state.positions, sim.state.masses, side, cap,
                       config.nlist_rcut)
    pairs0 = nlist.real_pairs(args[1], args[4], side, cap, cap)
    log_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(log_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=log_root) as log_dir:
        logger = RunLogger(log_dir, quiet=True)
        reset_counts()
        stats = sim.run(logger)
        counts = read_counts()
        with open(logger.path) as f:
            log = f.read()
    final = stats["final_state"]
    check(sim.backend == "nlist", f"backend {sim.backend}")
    check(counts["nlist_pair"] >= config.steps + 1,
          f"{counts['nlist_pair']} nlist_pair launches for "
          f"{config.steps} steps")
    check(tuple(final.positions.shape) == (config.n, 3), "final shape")
    check(bool(torch.isfinite(final.positions).all()
               & torch.isfinite(final.velocities).all()),
          "nlist run: final state not finite")
    for section in (f"Step {config.steps}/", "Performance Statistics:",
                    "Simulation completed successfully"):
        check(section in log, f"nlist log lacks {section!r}")
    record = {
        "phase": "nlist_main_path", "command": NLIST_RUN, "side": side,
        "cap": cap, "launches": counts["nlist_pair"], "counts": counts,
        "total_s": stats["total_time_s"],
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "dense_equiv_pairs_per_sec": stats["dense_equiv_pairs_per_sec"],
        "evaluated_pairs_per_sec": stats["evaluated_pairs_per_sec"],
        "tile_slots_per_eval": slots,
        "kernel_pairs_per_eval_at_t0": pairs0,
        "warnings": [str(w.message) for w in caught],
        "device": stats["device"],
    }
    emit(record)
    return record


def phase_mxu_path() -> dict:
    """The Gram-form run through the Simulator; then its forces against
    nbody_direct's on the final state."""
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel
    from gravity_tpu_torch.ops.mxu_kernel import accelerations_vs_mxu_kernel
    from gravity_tpu_torch.simulation import Simulator

    config = SimulationConfig(**MXU_RUN)
    sim = Simulator(config)
    reset_counts()
    stats = sim.run()
    counts = read_counts()
    final = stats["final_state"]
    check(sim.backend == "nbody_mxu", f"backend {sim.backend}")
    check(counts["nbody_mxu"] >= config.steps + 1,
          f"{counts['nbody_mxu']} nbody_mxu launches for "
          f"{config.steps} steps")
    check(bool(torch.isfinite(final.positions).all()
               & torch.isfinite(final.velocities).all()),
          "mxu run: final state not finite")
    pos, masses = final.positions, final.masses
    mxu = accelerations_vs_mxu_kernel(pos, pos, masses, eps=config.eps)
    direct = accelerations_vs_kernel(pos, pos, masses, eps=config.eps)
    rel = ((mxu.double() - direct.double()).norm(dim=1)
           / direct.double().norm(dim=1))
    record = {
        "phase": "mxu_path", "command": MXU_RUN,
        "launches": counts["nbody_mxu"], "counts": counts,
        "total_s": stats["total_time_s"],
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "pairs_per_s": stats["pairs_per_sec"],
        "vs_nbody_direct_median_rel_err": float(rel.median()),
        "vs_nbody_direct_p99_rel_err": float(torch.quantile(rel, 0.99)),
        "vs_nbody_direct_max_rel_err": float(rel.max()),
    }
    # The JAX suite's fp32 class for the Gram form: median ~1e-6.
    check(record["vs_nbody_direct_median_rel_err"] < 1e-4,
          f"mxu vs nbody_direct median rel err {rel.median():.3e}")
    emit(record)
    return record


def bound(pairs, flops_per_pair, n_bytes, device) -> dict:
    """The least time for the work: operations (fp32 flops, and rsqrt on
    the SFUs at 16 per SM per clock) or bytes, whichever is larger."""
    clock_hz = device["max_sm_clock_mhz"] * 1e6
    flop_ms = 1e3 * pairs * flops_per_pair / PEAK_FP32_FLOPS
    sfu_ms = 1e3 * pairs / (device["sm_count"] * SFU_PER_SM_PER_CLOCK
                            * clock_hz)
    byte_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
    bound_ms = max(flop_ms, sfu_ms, byte_ms)
    return {"bound_ms": bound_ms,
            "bound_by": "bytes" if byte_ms == bound_ms else "operations",
            "fp32_flop_ms": flop_ms, "sfu_rsqrt_ms": sfu_ms,
            "hbm_bytes_ms": byte_ms}


def phase_timing_nlist(device: dict) -> dict:
    """The cell-list kernel at the README state's tiles, beside its bound
    for the pairs this state needs, its plain version, and a whole force
    evaluation (binning and overflow channels included)."""
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.ops import nlist
    from gravity_tpu_torch.simulation import make_initial_state

    config = SimulationConfig(**NLIST_RUN)
    state = make_initial_state(config, torch.device("cuda", 0))
    side, cap = nlist.resolve_nlist_sizing(state.positions, config.nlist_rcut)
    args = nlist_tiles(state.positions, state.masses, side, cap,
                       config.nlist_rcut)
    kw = dict(cutoff=CUTOFF_RADIUS, eps=config.eps)

    def kernel():
        nlist.pair_cells_kernel(*args, **kw)

    def plain():
        nlist.pair_cells_plain(*args, **kw)

    def force_eval():
        nlist.nlist_accelerations(state.positions, state.masses,
                                  rcut=config.nlist_rcut, side=side, cap=cap,
                                  eps=config.eps)

    cuda_ms(kernel, 3)
    ms = cuda_ms(kernel, 30)
    cuda_ms(plain, 1)
    plain_ms = cuda_ms(plain, 3)
    ms_again = cuda_ms(kernel, 30)
    cuda_ms(force_eval, 3)
    eval_ms = cuda_ms(force_eval, 30)
    pairs = nlist.real_pairs(args[1], args[4], side, cap, cap)
    n_cells = side**3
    # Inputs read once (target and source slots, G*m, counts, params),
    # the output written once.
    n_bytes = (n_cells * cap * (3 + 3 + 1 + 3)) * 4 + 2 * n_cells * 8 + 4
    record = {
        "phase": "timing_nlist", "kernel": "nlist_pair", "side": side,
        "cap": cap, "n": config.n, "dtype": "float32",
        "pairs_evaluated": pairs,
        "tile_slots": nlist.evaluated_pairs_per_eval(side, cap),
        "ms": ms, "ms_repeat": ms_again, "plain_ms": plain_ms,
        **bound(pairs, NLIST_FLOPS_PER_PAIR, n_bytes, device),
        "force_eval_ms": eval_ms,
        "library_ms": None,
        "library_note": "no single PyTorch call computes a cell-list "
                        "pair sum",
        "nvidia_smi": device["nvidia_smi"],
    }
    record["share_of_bound"] = record["bound_ms"] / ms
    emit(record)
    return record


def phase_timing_mxu(device: dict) -> dict:
    """The Gram kernel at N = 65,536 (fp32 operands, the path's), its
    bf16 variant and plain version, and nbody_direct on the same inputs."""
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.constants import CUTOFF_RADIUS, G
    from gravity_tpu_torch.ops import mxu_kernel
    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel
    from gravity_tpu_torch.simulation import make_initial_state

    config = SimulationConfig(**MXU_RUN)
    state = make_initial_state(config, torch.device("cuda", 0))
    pos, masses = state.positions, state.masses
    center = pos.mean(dim=0)
    xi = (pos - center).contiguous()
    xb = xi.to(torch.bfloat16)
    gm = (masses * G).contiguous()
    kw = dict(cutoff=CUTOFF_RADIUS, eps=config.eps)

    def kernel():
        mxu_kernel.gram_acc4(xi, xi, gm, **kw)

    def kernel_bf16():
        mxu_kernel.gram_acc4(xb, xb, gm, **kw)

    def plain():
        mxu_kernel.gram_acc4_plain(xi, xi, gm, bf16=False, **kw)

    def direct():
        accelerations_vs_kernel(pos, pos, masses, eps=config.eps)

    def wrapper():
        mxu_kernel.accelerations_vs_mxu_kernel(pos, pos, masses,
                                               eps=config.eps)

    cuda_ms(kernel, 3)
    ms = cuda_ms(kernel, 30)
    cuda_ms(direct, 3)
    direct_ms = cuda_ms(direct, 30)
    ms_again = cuda_ms(kernel, 30)
    direct_again = cuda_ms(direct, 30)
    cuda_ms(kernel_bf16, 3)
    bf16_ms = cuda_ms(kernel_bf16, 30)
    wrapper_ms = cuda_ms(wrapper, 30)
    cuda_ms(plain, 1)
    plain_ms = cuda_ms(plain, 3)
    n = pos.shape[0]
    pairs = n * n
    # Inputs read once (targets, sources, G*m), the (N, 4) output once.
    n_bytes = (n * 3 + n * 3 + n) * 4 + n * 16
    record = {
        "phase": "timing_mxu", "kernel": "nbody_mxu", "n": n,
        "dtype": "float32", "ms": ms, "ms_repeat": ms_again,
        "bf16_ms": bf16_ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
        "nbody_direct_ms_same_inputs": direct_ms,
        "nbody_direct_ms_repeat": direct_again,
        **bound(pairs, MXU_FLOPS_PER_PAIR, n_bytes, device),
        "library_ms": None,
        "library_note": "no single PyTorch call computes this sum",
        "nvidia_smi": device["nvidia_smi"],
    }
    record["share_of_bound"] = record["bound_ms"] / ms
    emit(record)
    return record


def phase_profile_nlist() -> dict:
    """Where a cell-list force evaluation's device time goes: the
    PyTorch profiler over 10 evaluations at the README state: device
    time summed by kernel, and the device span of each stage that
    ``nlist_accelerations_vs`` names (the pair-tile kernel against the
    plain-PyTorch binning and overflow channels around it). The
    profiler's own cost inflates the wall time it sees."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.ops import nlist
    from gravity_tpu_torch.simulation import make_initial_state

    config = SimulationConfig(**NLIST_RUN)
    state = make_initial_state(config, torch.device("cuda", 0))
    side, cap = nlist.resolve_nlist_sizing(state.positions, config.nlist_rcut)

    def force_eval():
        nlist.nlist_accelerations(state.positions, state.masses,
                                  rcut=config.nlist_rcut, side=side, cap=cap,
                                  eps=config.eps)

    evals = 10
    for _ in range(3):
        force_eval()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(evals):
            force_eval()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / evals
    # On the device side the profiler records each "nlist.*" range as a
    # span (from its first kernel to its last, idle gaps included) and
    # each kernel as itself.
    stages, kernels = {}, []
    for item in prof.key_averages():
        if "CUDA" not in str(getattr(item, "device_type", "")):
            continue
        device_us = getattr(item, "device_time_total", None)
        if device_us is None:
            device_us = getattr(item, "cuda_time_total", 0.0)
        if item.key.startswith("nlist."):
            stages[item.key] = device_us / evals / 1e3
        else:
            kernels.append((device_us / evals / 1e3, item.key, item.count))
    kernels.sort(reverse=True)
    device_ms = sum(ms for ms, _, _ in kernels)
    measured = bool(kernels) and device_ms > 0
    record = {
        "phase": "profile_nlist", "evals": evals,
        "wall_ms_per_eval_profiled": wall_ms,
        "device_ms_per_eval": device_ms if measured else "not measured",
        "device_busy_share": (device_ms / wall_ms if measured
                              else "not measured"),
        "stage_device_span_ms_per_eval": stages,
        "device_kernels_per_eval": (sum(c for _, _, c in kernels) / evals
                                    if measured else "not measured"),
        "top_kernels_ms_per_eval": [
            {"kernel": key[:90], "ms": ms, "launches_per_eval": count / evals}
            for ms, key, count in kernels[:10]
        ],
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
    nlist_err = phase_nlist_kernel_vs_plain()
    mxu_err = phase_mxu_kernel_vs_plain()
    main_path = phase_main_path()
    nlist_path = phase_nlist_main_path()
    mxu_path = phase_mxu_path()
    phase_small_reference()
    phase_other_entry_points()
    timing = phase_timing(device)
    t_nlist = phase_timing_nlist(device)
    t_mxu = phase_timing_mxu(device)
    phase_profile_nlist()
    emit({"phase": "done", "wall_s": time.perf_counter() - t0,
          "kernel_share_of_main_path_step":
              timing["ms"] / main_path["ms_per_step"],
          "nlist_kernel_share_of_step":
              t_nlist["ms"] / nlist_path["ms_per_step"],
          "mxu_kernel_share_of_step": t_mxu["ms"] / mxu_path["ms_per_step"]})
    kernels = [
        ("nbody_direct", "gravity_tpu/ops/pallas_forces.py:45",
         main_path["launches"], max_abs_err, timing),
        ("nlist_pair", "gravity_tpu/ops/pallas_nlist.py:292",
         nlist_path["launches"], nlist_err, t_nlist),
        ("nbody_mxu", "gravity_tpu/ops/pallas_forces_mxu.py:85",
         mxu_path["launches"], mxu_err, t_mxu),
    ]
    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"gravity_tpu_torch/csrc/{name}.cu", "replaces": replaces,
        "launches": launches, "max_abs_err": err,
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None, "library_note": t["library_note"],
        "checked_against_plain": True,
    } for name, replaces, launches, err, t in kernels]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
