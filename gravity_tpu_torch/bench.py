"""Benchmark harness: pair interactions a second a chip, and time a step.

Counterpart of ``gravity_tpu/bench.py`` (:func:`run_benchmark`) and of the
root ``bench.py``'s headline line (:func:`main`). The harness builds the
Simulator, takes the first force evaluation and ``warmup_steps`` steps
(which also load the kernels), then times ``bench_steps`` steps of the
Simulator's own block (``Simulator.run_block``) between the card's
completion fences (``torch.cuda.synchronize``).

    python -m gravity_tpu_torch.bench

prints one JSON line ``{metric, value, unit, vs_baseline, ...}``: a
``plummer`` leapfrog run on the card, ``BENCH_N`` bodies (default
262,144, the JAX package's workload), ``BENCH_STEPS`` timed steps
(default 20), ``BENCH_BACKEND`` (default ``direct``: the ``nbody_direct``
kernel; ``pallas-mxu``, ``nlist``, ``auto``, ...). ``nlist`` takes its
radius from ``BENCH_NLIST_RCUT`` (m), else ``BENCH_NLIST_RCUT_FRAC``
(default 0.05) of the initial cube, and reports the dense-equivalent rate
beside the evaluated pair-tile rate. The line also carries the card's
name and power limit, the torch and CUDA versions and the SM clock,
sampled under the same load in a window of its own after the timed one. It needs a card: ``BENCH_DEVICE=cpu``
asks for the CPU, whose numbers are no device metric.

:func:`run_cadence_benchmark` is ``bench --cadence``: a whole run with
trajectories and checkpoints, the A/B of the host pipeline. Not ported:
the TPU replay cache of the root ``bench.py`` and the trend report
(ROADMAP.md Queue 1 item 10). The perf gate is ``perfgate.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import threading
import time

from .config import SimulationConfig
from .ops.integrators import FORCE_EVALS_PER_STEP
from .simulation import Simulator, make_initial_state
from .telemetry import perf
from .utils.platform import DeviceLike, device_name
from .utils.timing import (
    DIRECT_SUM_BACKENDS,
    backend_formulation,
    pairs_metric_name,
    roofline,
    sync,
    throughput,
)

NORTH_STAR = 1.0e11  # pair interactions a second a chip (BASELINE.json)
DEFAULT_N = 262_144


def run_benchmark(config: SimulationConfig, *, warmup_steps: int = 3,
                  bench_steps: int = 20, device: DeviceLike = None,
                  sm_clock: bool = False) -> dict:
    """Time ``bench_steps`` steps of ``config``'s Simulator after its
    first force evaluation and ``warmup_steps`` steps: the JAX package's
    stats keys (throughput, run facts, routing facts, roofline). Direct
    sums get their roofline from the N*(N-1) rate; the cell list from
    the pair-tile slots it evaluates (``Simulator.nlist_sizing``), its
    headline the dense-equivalent rate; other solvers report the roofline
    keys as None.

    ``sm_clock`` adds ``sm_clock_mhz`` (the median sample),
    ``sm_clock_samples`` and ``sm_clock_steps``: on the card, the SM clock
    sampled while the same run goes on for ``sm_clock_steps`` more steps
    after the timed ones (:func:`sm_clock_under_load`), so that the
    sampler's nvidia-smi processes stay out of the timed window."""
    sim = Simulator(config, device=device)
    state = sim.state
    acc = sim.initial_carry(state)
    if warmup_steps:
        state, acc = sim.run_block(state, acc, n_steps=warmup_steps)
    sync(sim.device)
    # The warm-up block was the counted one (perf ledger); the timed steps
    # and the clock's load never are.
    with perf.uncounted():
        start = time.perf_counter()
        state, acc = sim.run_block(state, acc, n_steps=bench_steps)
        sync(sim.device)
        elapsed = time.perf_counter() - start
        samples, clock_steps = [], 0
        if sm_clock and sim.device.type == "cuda":
            def load() -> int:
                nonlocal state, acc
                state, acc = sim.run_block(state, acc, n_steps=bench_steps)
                sync(sim.device)
                return bench_steps

            samples, clock_steps = sm_clock_under_load(load)

    evals_per_step = FORCE_EVALS_PER_STEP[config.integrator]
    stats = throughput(sim.n_real, bench_steps, elapsed, num_devices=1,
                       force_evals_per_step=evals_per_step)
    device_kind = device_name(sim.device)
    stats.update(
        model=config.model,
        integrator=config.integrator,
        backend=sim.backend,
        sharding=config.sharding,
        dtype=config.dtype,
        platform=sim.device.type,
        autotune_cache=sim.autotune["cache"],
        autotune_probe_ms=sim.autotune["probe_ms"],
    )
    if sm_clock:
        stats.update(
            sm_clock_mhz=statistics.median(samples) if samples else None,
            sm_clock_samples=len(samples), sm_clock_steps=clock_steps,
        )
    if sim.backend in DIRECT_SUM_BACKENDS:
        stats.update(roofline(
            stats["pairs_per_sec_per_chip"],
            formulation=backend_formulation(sim.backend),
            device_kind=device_kind, dtype=config.dtype,
        ))
    elif sim.backend == "nlist" and sim.nlist_sizing is not None:
        side, cap, slots_per_eval = sim.nlist_sizing
        tile_rate = slots_per_eval * bench_steps * evals_per_step / elapsed
        stats["dense_equiv_pairs_per_sec"] = stats["pairs_per_sec_per_chip"]
        stats["nlist_side"] = side
        stats["nlist_cap"] = cap
        stats["evaluated_pairs_per_sec_per_chip"] = tile_rate
        stats.update(roofline(
            tile_rate, formulation=backend_formulation(sim.backend),
            device_kind=device_kind, dtype=config.dtype,
        ))
    else:
        stats.update(flops_per_pair=None, achieved_tflops=None,
                     peak_tflops=None, mfu=None, device_kind=device_kind,
                     formulation=None)
    return stats


def run_cadence_benchmark(config: SimulationConfig, *,
                          device: DeviceLike = None) -> dict:
    """The cadence-heavy end-to-end benchmark: a whole ``Simulator.run``
    with trajectory recording and checkpoints into a throwaway directory,
    the workload whose host tax the pipeline exists to hide. The A/B axis
    is ``config.io_pipeline`` (on or off); the headline numbers are
    ``steps_per_sec`` and the measured ``host_gap_frac`` (the share of the
    wall clock with no block in flight, ``utils/timing.HostGapTimer``).
    The artifacts are bitwise identical either way
    (``tests/test_torch_io_pipeline.py``), so a difference in speed is
    overlap alone."""
    import shutil
    import tempfile

    from .utils.checkpoint import make_checkpoint_manager
    from .utils.trajectory import TrajectoryWriter

    sim = Simulator(config, device=device)
    sync(sim.device)
    root = tempfile.mkdtemp(prefix="gravity_bench_cadence_")
    try:
        writer = None
        if config.record_trajectories:
            writer = TrajectoryWriter(os.path.join(root, "traj"), sim.n_real,
                                      every=1)
        mgr = None
        if config.checkpoint_every:
            mgr = make_checkpoint_manager(os.path.join(root, "ckpt"))
        stats = sim.run(trajectory_writer=writer, checkpoint_manager=mgr)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    stats.pop("final_state", None)
    stats["steps_per_sec"] = (stats["steps"] / stats["total_time_s"]
                              if stats["total_time_s"] > 0 else float("inf"))
    stats.update(
        model=config.model,
        integrator=config.integrator,
        backend=sim.backend,
        dtype=config.dtype,
        platform=sim.device.type,
        record_every=config.trajectory_every,
        checkpoint_every=config.checkpoint_every,
    )
    return stats


def nvidia_smi(query: str) -> str | None:
    """``nvidia-smi --query-gpu=QUERY --format=csv,noheader`` of card 0,
    or None where nvidia-smi cannot be run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
             "--id=0"], capture_output=True, text=True, timeout=30,
            check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip()


def sm_clock_under_load(load, *, min_s: float = 0.5,
                        max_s: float = 5.0) -> tuple[list, int]:
    """The SM clock (MHz) sampled by a thread with nvidia-smi while
    ``load()`` (which runs some steps to completion and returns how many)
    repeats: for ``min_s`` seconds at least, then until a sample came,
    nvidia-smi failed or ``max_s`` passed. (The samples, the steps run.)"""
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            value = nvidia_smi("clocks.sm")
            if value is None:
                return
            samples.append(float(value.split()[0]))
            stop.wait(0.05)

    thread = threading.Thread(target=sample)
    thread.start()
    steps, t0 = 0, time.perf_counter()
    try:
        while True:
            steps += load()
            elapsed = time.perf_counter() - t0
            if elapsed >= max_s or (elapsed >= min_s and (
                    samples or not thread.is_alive())):
                break
    finally:
        stop.set()
        thread.join()
    return samples, steps


def main() -> int:
    import torch

    steps = int(os.environ.get("BENCH_STEPS", 20))
    backend = os.environ.get("BENCH_BACKEND", "direct")
    device = os.environ.get("BENCH_DEVICE") or None
    if device is None and not torch.cuda.is_available():
        print("bench: no CUDA device (BENCH_DEVICE=cpu asks for the CPU)",
              file=sys.stderr)
        return 1
    n = int(os.environ.get("BENCH_N", DEFAULT_N))
    config = SimulationConfig(
        model="plummer", n=n, dt=3600.0, eps=1.0e9, integrator="leapfrog",
        force_backend=backend, dtype="float32",
    )
    if backend == "nlist":
        rcut = float(os.environ.get("BENCH_NLIST_RCUT", 0) or 0)
        if rcut <= 0:
            frac = float(os.environ.get("BENCH_NLIST_RCUT_FRAC", 0.05))
            p = make_initial_state(config, device).positions
            rcut = float((p.max(0).values - p.min(0).values).max()) * frac
        config = dataclasses.replace(config, nlist_rcut=rcut)
    stats = run_benchmark(config, warmup_steps=3, bench_steps=steps,
                          device=device, sm_clock=True)
    result = {
        "metric": "pair_interactions_per_sec_per_chip",
        "value": stats["pairs_per_sec_per_chip"],
        "unit": "pairs/s/chip",
        "vs_baseline": stats["pairs_per_sec_per_chip"] / NORTH_STAR,
        "n": stats["n"],
        "steps": stats["steps"],
        "avg_step_s": stats["avg_step_s"],
        "backend": stats["backend"],
        "platform": stats["platform"],
        "flops_per_pair": stats.get("flops_per_pair"),
        "achieved_tflops": stats.get("achieved_tflops"),
        "peak_tflops": stats.get("peak_tflops"),
        "mfu": stats.get("mfu"),
        # bench times run_block between fences, with no host pipeline:
        # its idle share is run and bench --cadence's.
        "host_gap_frac": None,
        "autotune_cache": stats.get("autotune_cache"),
        "autotune_probe_ms": stats.get("autotune_probe_ms"),
        "device_kind": stats.get("device_kind"),
        "nvidia_smi": (nvidia_smi("name,power.limit")
                       if stats["platform"] == "cuda" else None),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "sm_clock_mhz": stats["sm_clock_mhz"],
        "sm_clock_samples": stats["sm_clock_samples"],
        "sm_clock_steps": stats["sm_clock_steps"],
    }
    if backend == "nlist":
        result["pairs_metric"] = pairs_metric_name("nlist")
        result["nlist_rcut"] = config.nlist_rcut
        result["nlist_side"] = stats.get("nlist_side")
        result["nlist_cap"] = stats.get("nlist_cap")
        result["evaluated_pairs_per_sec_per_chip"] = stats.get(
            "evaluated_pairs_per_sec_per_chip")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
