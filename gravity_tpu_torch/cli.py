"""Command-line interface: the ``run`` verb.

Counterpart of ``gravity_tpu/cli.py`` for this slice, with the JAX CLI's
flag names. ``run`` writes the reference log and prints one JSON line of
run statistics on stdout. It runs on the GPU unless ``--device cpu``.

Usage:
    python -m gravity_tpu_torch run --preset reference-cuda
    python -m gravity_tpu_torch run --preset reference-spark --steps 100
    python -m gravity_tpu_torch run --device cpu --preset reference-mpi
    python -m gravity_tpu_torch run --model random --n 262144 \
        --integrator leapfrog --force-backend nlist --nlist-rcut 5e10 --eps 1e9
    python -m gravity_tpu_torch run --model disk --n 1048576 --g 1.0 \
        --dt 2e-3 --eps 0.05 --force-backend p3m --pm-grid 256 \
        --p3m-cap 64 --p3m-short nlist --integrator leapfrog
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from .config import (
    DTYPES,
    FORCE_BACKENDS,
    INTEGRATORS,
    MODELS,
    P3M_SHORT_MODES,
    PRESETS,
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
    p.add_argument("--eps", type=float, default=None)
    p.add_argument("--integrator", choices=INTEGRATORS, default=None)
    p.add_argument("--force-backend", dest="force_backend",
                   choices=FORCE_BACKENDS, default=None,
                   help="auto/direct/pallas = the CUDA direct-sum kernel "
                        "on the GPU; pallas-mxu = its Gram-form kernel; "
                        "nlist = the cutoff-radius cell list (needs "
                        "--nlist-rcut); p3m = the P3M solver; "
                        "dense/chunked = plain PyTorch")
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
    p.add_argument("--fast-chunk", dest="fast_chunk", type=int, default=None,
                   help="target chunk of the p3m gather pass")
    p.add_argument("--dtype", choices=DTYPES, default=None)
    p.add_argument("--progress-every", dest="progress_every", type=int,
                   default=None, help="steps per progress line and block")
    p.add_argument("--log-dir", dest="log_dir", default=None)
    p.add_argument("--trajectories", dest="record_trajectories",
                   action="store_true", default=None)
    p.add_argument("--trajectory-every", dest="trajectory_every",
                   type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run "
                        "on the CPU)")


def build_config(args: argparse.Namespace) -> SimulationConfig:
    config = (
        dataclasses.replace(PRESETS[args.preset]) if args.preset
        else SimulationConfig()
    )
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="gravity_tpu_torch",
        description="N-body gravity on PyTorch and CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p_run = sub.add_parser("run", help="run a simulation")
    _add_config_args(p_run)
    p_run.set_defaults(func=cmd_run)
    args = parser.parse_args(argv)
    return args.func(args)
