"""Command-line interface: the ``run``, ``bench`` and ``tune`` verbs.

Counterpart of ``gravity_tpu/cli.py`` for this slice, with the JAX CLI's
flag names. ``run`` writes the reference log and prints one JSON line of
run statistics on stdout; ``bench`` prints one JSON line of a timed block
(``bench.run_benchmark``); ``tune`` fills the autotuner's cache over a
size ladder, one JSON line a size. Each runs on the GPU unless
``--device cpu``.

Usage:
    python -m gravity_tpu_torch run --preset reference-cuda
    python -m gravity_tpu_torch run --preset reference-spark --steps 100
    python -m gravity_tpu_torch run --preset baseline-16k
    python -m gravity_tpu_torch run --preset baseline-16k --dtype bfloat16
    python -m gravity_tpu_torch run --preset baseline-2m --steps 3
    python -m gravity_tpu_torch run --preset baseline-1m --tree-near nlist
    python -m gravity_tpu_torch run --device cpu --preset reference-mpi
    python -m gravity_tpu_torch run --model random --n 262144 \
        --integrator leapfrog --force-backend nlist --nlist-rcut 5e10 --eps 1e9
    python -m gravity_tpu_torch run --model disk --n 1048576 --g 1.0 \
        --dt 2e-3 --eps 0.05 --force-backend p3m --pm-grid 256 \
        --p3m-cap 64 --p3m-short nlist --integrator leapfrog
    python -m gravity_tpu_torch run --preset baseline-16k \
        --integrator multirate --multirate-rungs 3
    python -m gravity_tpu_torch run --preset baseline-16k --adaptive
    python -m gravity_tpu_torch run --preset baseline-16k \
        --external plummer:gm=1.3e20,a=1e12
    python -m gravity_tpu_torch run --preset reference-cuda --merge-radius 1e9
    python -m gravity_tpu_torch run --preset baseline-1m --force-backend auto
    python -m gravity_tpu_torch bench --model plummer --n 262144 \
        --integrator leapfrog --eps 1e9 --force-backend pallas-mxu
    python -m gravity_tpu_torch tune --sizes 16384 65536
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from .config import (
    DTYPES,
    FORCE_BACKENDS,
    INTEGRATORS,
    MODELS,
    P3M_SHORT_MODES,
    PRESETS,
    TIMESTEP_CRITERIA,
    TREE_FAR_MODES,
    TREE_NEAR_MODES,
    SimulationConfig,
)


def _add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    p.add_argument("--model", choices=MODELS, default=None)
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--dt", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--g", type=float, default=None)
    p.add_argument("--cutoff", type=float, default=None)
    p.add_argument("--eps", type=float, default=None)
    p.add_argument("--integrator", choices=INTEGRATORS, default=None)
    p.add_argument("--multirate-k", dest="multirate_k", type=int,
                   default=None,
                   help="fast-rung capacity (0 = auto: n/8)")
    p.add_argument("--multirate-rungs", dest="multirate_rungs", type=int,
                   default=None,
                   help="timestep rungs (2 = classic two-rung; >2 = "
                        "power-of-two ladder, rung r at dt/2^r)")
    p.add_argument("--multirate-sub", dest="multirate_sub", type=int,
                   default=None, help="substeps per outer step")
    p.add_argument("--force-backend", dest="force_backend",
                   choices=FORCE_BACKENDS, default=None,
                   help="auto/direct/pallas = the CUDA direct-sum kernel "
                        "on the GPU; pallas-mxu = its Gram-form kernel; "
                        "nlist = the cutoff-radius cell list (needs "
                        "--nlist-rcut); p3m = the P3M solver; tree = "
                        "the octree; dense/chunked = plain PyTorch; auto = "
                        "the measured-fastest of them (autotune.py)")
    p.add_argument("--no-autotune", dest="autotune", action="store_false",
                   default=None,
                   help="with --force-backend auto, keep the static route "
                        "(no probe, no tuning cache)")
    p.add_argument("--chunk", type=int, default=None,
                   help="i-chunk of the chunked plain direct sum")
    p.add_argument("--nlist-rcut", dest="nlist_rcut", type=float,
                   default=None,
                   help="declared truncation radius (m): forces truncated "
                        "at r > rcut (short-range physics)")
    p.add_argument("--nlist-side", dest="nlist_side", type=int, default=None,
                   help="cell-list grid side (0 = fit to the initial state)")
    p.add_argument("--nlist-cap", dest="nlist_cap", type=int, default=None,
                   help="cell-list slots per cell (0 = fit to the initial "
                        "state)")
    p.add_argument("--pm-grid", dest="pm_grid", type=int, default=None)
    p.add_argument("--p3m-sigma-cells", dest="p3m_sigma_cells", type=float,
                   default=None)
    p.add_argument("--p3m-rcut-sigmas", dest="p3m_rcut_sigmas", type=float,
                   default=None)
    p.add_argument("--p3m-cap", dest="p3m_cap", type=int, default=None)
    p.add_argument("--p3m-short", dest="p3m_short", choices=P3M_SHORT_MODES,
                   default=None,
                   help="short-range pass: nlist = the cell-list kernel, "
                        "gather = per-target block gathers (auto = nlist "
                        "on the GPU, gather on the CPU; slice is not "
                        "ported)")
    p.add_argument("--tree-depth", dest="tree_depth", type=int, default=None,
                   help="octree leaf depth (0 = fit to the initial state)")
    p.add_argument("--tree-leaf-cap", dest="tree_leaf_cap", type=int,
                   default=None)
    p.add_argument("--tree-ws", dest="tree_ws", type=int, default=None,
                   help="octree opening criterion (theta ~ 0.87/ws)")
    p.add_argument("--tree-far", dest="tree_far", choices=TREE_FAR_MODES,
                   default=None,
                   help="octree far-field mode (expansion = gather-lean)")
    p.add_argument("--tree-near", dest="tree_near", choices=TREE_NEAR_MODES,
                   default=None,
                   help="octree near field: gather = per-target block "
                        "gathers; nlist = the cell-list kernel over the "
                        "leaf blocks (ws 1 only)")
    p.add_argument("--fast-chunk", dest="fast_chunk", type=int, default=None,
                   help="target chunk of the tree and of the p3m gather "
                        "pass")
    p.add_argument("--dtype", choices=DTYPES, default=None)
    p.add_argument("--external", default=None,
                   help="analytic background field spec, e.g. "
                        "'nfw:gm=1e13,rs=2e20' or "
                        "'pointmass:gm=1.3e20 + uniform:gz=-9.8'")
    p.add_argument("--merge-radius", dest="merge_radius", type=float,
                   default=None,
                   help="merge pairs closer than this radius (inelastic "
                        "collision; 0 = off)")
    p.add_argument("--merge-k", dest="merge_k", type=int, default=None)
    p.add_argument("--merge-every", dest="merge_every", type=int,
                   default=None,
                   help="steps between collision checks (physics cadence, "
                        "independent of --progress-every)")
    p.add_argument("--adaptive", action="store_true", default=None,
                   help="adaptive dt: steps*dt becomes the target "
                        "simulated time, dt the per-step ceiling")
    p.add_argument("--eta", type=float, default=None,
                   help="adaptive-timestep safety factor")
    p.add_argument("--timestep-criterion", dest="timestep_criterion",
                   choices=TIMESTEP_CRITERIA, default=None)
    p.add_argument("--progress-every", dest="progress_every", type=int,
                   default=None, help="steps per progress line and block")
    p.add_argument("--log-dir", dest="log_dir", default=None)
    p.add_argument("--trajectories", dest="record_trajectories",
                   action="store_true", default=None)
    p.add_argument("--trajectory-every", dest="trajectory_every",
                   type=int, default=None)
    p.add_argument("--no-nan-check", dest="nan_check", action="store_false",
                   default=None,
                   help="disable the per-block divergence watchdog")
    p.add_argument("--config-json", dest="config_json", default=None,
                   help="path to a SimulationConfig JSON file (this "
                        "package's or gravity_tpu's)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run "
                        "on the CPU)")


def build_config(args: argparse.Namespace) -> SimulationConfig:
    if getattr(args, "config_json", None):
        with open(args.config_json) as f:
            config = SimulationConfig.from_json(f.read())
    elif args.preset:
        config = dataclasses.replace(PRESETS[args.preset])
    else:
        config = SimulationConfig()
    for field in dataclasses.fields(SimulationConfig):
        val = getattr(args, field.name, None)
        if val is not None:
            config = dataclasses.replace(config, **{field.name: val})
    return config


def cmd_run(args: argparse.Namespace) -> int:
    from .simulation import Simulator
    from .utils.logging import RunLogger
    from .utils.trajectory import TrajectoryWriter

    config = build_config(args)
    if config.adaptive and config.merge_radius > 0.0:
        print(
            "error: --adaptive does not support --merge-radius "
            "(collision merging needs the fixed-dt block loop)",
            file=sys.stderr,
        )
        return 1
    sim = Simulator(config, device=args.device)
    logger = RunLogger(config.log_dir)
    writer = None
    if config.record_trajectories:
        # every=1: the Simulator already strides frames by
        # config.trajectory_every.
        writer = TrajectoryWriter(
            os.path.join(config.log_dir, f"trajectories_{logger.timestamp}"),
            sim.n_real, every=1,
        )
    stats = sim.run(logger, trajectory_writer=writer)
    stats.pop("final_state")
    if writer is not None:
        stats["trajectory_dir"] = writer.out_dir
    print(json.dumps(stats))
    return 0


def cmd_tune(args: argparse.Namespace) -> int:
    """Fill the autotune cache over a size ladder, one JSON line a size,
    so that a campaign pays every probe once, up front. The ladders are
    the JAX package's (its accelerator ladder on the card): sizes of a
    workload, not a claim about where a crossover lies."""
    from .autotune import probe_counters, resolve_backend_measured, tuning_dir
    from .simulation import make_initial_state
    from .utils.platform import resolve_device

    config = build_config(args)
    if not config.autotune:
        print("error: nothing to tune: autotuning disabled (--no-autotune)",
              file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    if args.sizes:
        sizes = sorted({int(s) for s in args.sizes})
    elif config.nlist_rcut > 0.0:
        sizes = ([65_536, 262_144, 1_048_576, 4_194_304] if on_card
                 else [8_192, 16_384, 32_768, 65_536, 131_072])
    elif on_card:
        sizes = [65_536, 131_072, 262_144, 524_288, 1_048_576]
    else:
        sizes = [8_192, 16_384, 32_768, 65_536]
    for n in sizes:
        cfg = dataclasses.replace(config, n=n, force_backend="auto")
        state = make_initial_state(cfg, device)
        before = probe_counters()["probe_steps"]
        decision = resolve_backend_measured(
            cfg, state, device=device, refresh=args.refresh)
        print(json.dumps({
            "n": n,
            "backend": decision.backend,
            "cache": decision.cache,
            "probe_ms": round(decision.probe_ms, 1),
            "probe_steps": probe_counters()["probe_steps"] - before,
            "timings_s": {
                k: round(v, 6) for k, v in decision.timings_s.items()
            },
            "errors": decision.errors,
            "skipped": decision.skipped,
            "tuning_dir": tuning_dir(),
        }), flush=True)
    return 0


def cmd_bench(args: argparse.Namespace) -> int:
    from .bench import run_benchmark, run_cadence_benchmark
    from .config import NotPortedError

    if args.gate:
        raise NotPortedError(
            "bench --gate (the perf regression gate, perfgate.py) is not "
            "ported to gravity_tpu_torch yet (ROADMAP.md Queue 1 item 8)")
    if args.report:
        raise NotPortedError(
            "bench --report (the trend table over round artifacts) is not "
            "ported to gravity_tpu_torch yet (ROADMAP.md Queue 1 item 10)")
    config = build_config(args)
    if args.cadence:
        result = run_cadence_benchmark(config)
    else:
        result = run_benchmark(config, warmup_steps=args.warmup,
                               bench_steps=args.bench_steps,
                               device=args.device)
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="gravity_tpu_torch",
        description="N-body gravity on PyTorch and CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p_run = sub.add_parser("run", help="run a simulation")
    _add_config_args(p_run)
    p_run.set_defaults(func=cmd_run)

    p_tune = sub.add_parser(
        "tune", help="fill the autotune cache over a size ladder")
    _add_config_args(p_tune)
    p_tune.add_argument("--sizes", type=int, nargs="+", default=None,
                        help="N ladder to fill (default: the JAX "
                             "package's ladder for this device; with "
                             "--nlist-rcut, its nlist ladder)")
    p_tune.add_argument("--refresh", action="store_true",
                        help="probe again on a cache hit (overwrite the "
                             "stored verdicts)")
    p_tune.set_defaults(func=cmd_tune)

    p_bench = sub.add_parser("bench", help="throughput benchmark")
    _add_config_args(p_bench)
    p_bench.add_argument("--warmup", type=int, default=3)
    p_bench.add_argument("--bench-steps", dest="bench_steps", type=int,
                         default=20)
    p_bench.add_argument("--cadence", action="store_true",
                         help="cadence-on end-to-end mode (not ported: "
                              "ROADMAP.md Queue 1 items 2 and 3)")
    p_bench.add_argument("--report", action="store_true",
                         help="the perf trend table (not ported: ROADMAP.md "
                              "Queue 1 item 10)")
    p_bench.add_argument("--gate", action="store_true",
                         help="the perf regression gate (not ported: "
                              "ROADMAP.md Queue 1 item 8)")
    p_bench.set_defaults(func=cmd_bench)
    args = parser.parse_args(argv)
    return args.func(args)
