"""Command-line interface: the ``run``, ``resume``, ``sweep``, ``bench`` and
``tune`` verbs, the cosmology and analysis verbs ``cosmo`` and
``analyze``, the serving verbs ``serve``, ``submit``, ``status``,
``result`` and ``cancel``, the fleet verbs ``route``, ``drain``,
``fleet-status`` and ``trace-export``, and the tooling verbs
``validate``, ``traj`` and ``lint``.

Counterpart of ``gravity_tpu/cli.py`` for this slice, with the JAX CLI's
flag names. ``run`` writes the reference log and prints one JSON line of
run statistics on stdout; ``resume`` continues a checkpointed run;
``bench`` prints one JSON line of a timed block (``bench.run_benchmark``,
or with ``--cadence`` a whole run with trajectories and checkpoints;
``--report`` prints the trend table over the round artifacts instead);
``tune`` fills the autotuner's cache over a size ladder, one JSON line a
size. ``sweep`` runs the reference's size sweep (``--sizes``, default 10
100 500 1000) as jobs of an in-process ensemble scheduler, or one run
after another where the engine cannot serve the config. ``run --trace``
writes the run's spans to ``<log-dir>/traces.jsonl``; ``--trace`` or
``--error-budget`` arms a flight recorder that dumps on a divergence, an
accuracy breach or SIGTERM. ``cosmo`` runs a comoving cosmological box
(grf initial conditions, the periodic PM solver, the comoving KDK) and
prints one JSON growth report; ``analyze`` prints a diagnostics report
(energy, radii, P(k), halos, xi(r)) of a checkpoint or a fresh
realization. Each runs on the GPU unless ``--device cpu``. ``serve``
starts the ensemble daemon (serve/service.py) on the GPU unless
``--device cpu``; the client verbs find it through ``--spool-dir``. ``submit --job-type``
takes the served classes, ``integrate``, ``fit``, ``sweep``, ``watch`` and
``sharded-integrate``, with their payload in ``--params`` (a malformed one
is the daemon's 400 and exit 2). A
served ``--force-backend nlist`` job names its ``--nlist-rcut`` and
``--nlist-side`` (no state exists at admission to size the grid from;
``--nlist-cap`` defaults to 64); the daemon refuses it otherwise. ``route``
starts the pod router in front of every worker of a spool (the client
verbs find it through ``router.json``); ``drain W`` takes worker W out of
its rotation (``--undrain`` puts it back); ``fleet-status`` prints the
fleet's health, the registry's capabilities and the router's placements;
``trace-export`` writes one trace as Chrome/Perfetto JSON. ``validate``
prints the physics self-test battery as one JSON document (``--gpu``
adds the card gate); ``traj`` inspects a ``.gtrj`` file (``info``,
``stats``, ``dump``, ``export``); ``lint`` runs the AST invariant
analyzer over the port. ``traj``, ``lint`` and ``bench --report`` read
files only and touch no device.

Under ``--sharding allgather|ring`` (``--mesh-shape P`` or ``S,P/S``)
``run`` is one rank of a ``torch.distributed`` world: the launcher's
(``python -m torch.distributed.run``; ``--distributed`` joins it before
anything else), or a world of one without a launcher. Every rank runs
the same command; rank 0 alone writes the log, the trajectories, the
metrics and the JSON line.

Exit codes of ``run`` and ``resume``: 0 done; 1 a usage error; 2 a
failure of the recovery layer (divergence, an accuracy breach, an
exhausted retry budget, an unbuildable backend: one JSON line on stderr);
75 preempted by SIGTERM after a checkpoint (run ``resume``).

Usage:
    python -m gravity_tpu_torch run --preset reference-cuda
    python -m gravity_tpu_torch run --preset reference-spark --steps 100
    python -m gravity_tpu_torch run --preset baseline-16k
    python -m gravity_tpu_torch run --preset baseline-16k --dtype bfloat16
    python -m gravity_tpu_torch run --preset baseline-2m --steps 3
    python -m gravity_tpu_torch run --preset baseline-262k --steps 20
    python -m gravity_tpu_torch run --preset baseline-2m-merger --steps 2
    python -m torch.distributed.run --nproc-per-node 4 -m gravity_tpu_torch \
        run --device cpu --distributed --sharding ring --model plummer \
        --n 4096 --eps 1e9 --integrator leapfrog --steps 20
    python -m gravity_tpu_torch run --preset baseline-1m --tree-near nlist
    python -m gravity_tpu_torch run --preset baseline-1m-fmm
    python -m gravity_tpu_torch run --model random --n 1048576 --eps 1e9 \
        --integrator leapfrog --force-backend fmm --fmm-mode dense
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
    python -m gravity_tpu_torch run --model grf --n 262144 \
        --periodic-box 1e13 --force-backend pm --pm-grid 128 \
        --integrator leapfrog --eps 2e11 --dt 2e4
    python -m gravity_tpu_torch cosmo --n 2097152 --grid 256 --omega-m 0.3 \
        --a-start 0.2 --a-end 0.5 --steps 40 --li-check
    python -m gravity_tpu_torch analyze --model grf --n 262144 \
        --periodic-box 1e13 --eps 1e11 --spectrum --fof 5e11 --correlation
    python -m gravity_tpu_torch bench --model plummer --n 262144 \
        --integrator leapfrog --eps 1e9 --force-backend pallas-mxu
    python -m gravity_tpu_torch tune --sizes 16384 65536
    python -m gravity_tpu_torch run --preset reference-cuda \
        --checkpoint-every 100 --ledger --sentinel-every 5
    python -m gravity_tpu_torch resume --preset reference-cuda
    python -m gravity_tpu_torch run --preset baseline-16k --auto-recover \
        --checkpoint-every 100
    python -m gravity_tpu_torch serve --spool-dir D --slots 4 \
        --slice-steps 100 &
    python -m gravity_tpu_torch submit --spool-dir D --model plummer \
        --n 8192 --steps 500 --wait
    python -m gravity_tpu_torch submit --spool-dir D --model random \
        --n 5000 --steps 500 --integrator leapfrog --eps 1e9 \
        --force-backend nlist --nlist-rcut 5e10 --nlist-side 12 \
        --nlist-cap 32
    python -m gravity_tpu_torch status --spool-dir D
    python -m gravity_tpu_torch result --spool-dir D <job> --out final.npz
    python -m gravity_tpu_torch cancel --spool-dir D <job>
    python -m gravity_tpu_torch route --spool-dir D &
    python -m gravity_tpu_torch drain --spool-dir D <worker> [--undrain]
    python -m gravity_tpu_torch fleet-status --spool-dir D
    python -m gravity_tpu_torch trace-export --spool-dir D <job>
    python -m gravity_tpu_torch run --preset reference-cuda --trace
    python -m gravity_tpu_torch trace-export \
        --trace-file gravity_logs_gpu/traces.jsonl --trace <id>
    python -m gravity_tpu_torch sweep --sizes 10 100 500 1000
    python -m gravity_tpu_torch validate --gpu
    python -m gravity_tpu_torch validate --device cpu --gpu
    python -m gravity_tpu_torch traj stats gravity_logs_gpu/t.gtrj
    python -m gravity_tpu_torch bench --report
    python -m gravity_tpu_torch lint
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
    FMM_MODES,
    NLIST_MESH_MODES,
    P3M_SHORT_MODES,
    PM_ASSIGNMENTS,
    PRESETS,
    SHARDING_MODES,
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
                        "cpp = the host-native C++ direct sum (with "
                        "--device cpu; auto/direct take it on the CPU "
                        "above 4,096 bodies); "
                        "nlist = the cutoff-radius cell list (needs "
                        "--nlist-rcut); p3m = the P3M solver; tree = "
                        "the octree; fmm = the fast multipole solver "
                        "(layout by --fmm-mode), sfmm = its sparse layout; "
                        "pm = the particle-mesh FFT solver (isolated, or "
                        "periodic with --periodic-box); "
                        "dense/chunked = plain PyTorch; auto = the "
                        "measured-fastest of them (autotune.py)")
    p.add_argument("--fmm-mode", dest="fmm_mode", choices=FMM_MODES,
                   default=None,
                   help="fmm layout: sparse = occupied-leaf compaction for "
                        "clustered states (auto picks by occupancy)")
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
                   help="cell-list grid side (0 = fit to the initial state; "
                        "a served nlist job must give it)")
    p.add_argument("--nlist-cap", dest="nlist_cap", type=int, default=None,
                   help="cell-list slots per cell (0 = fit to the initial "
                        "state; for a served job 64)")
    p.add_argument("--pm-grid", dest="pm_grid", type=int, default=None)
    p.add_argument("--p3m-sigma-cells", dest="p3m_sigma_cells", type=float,
                   default=None)
    p.add_argument("--p3m-rcut-sigmas", dest="p3m_rcut_sigmas", type=float,
                   default=None)
    p.add_argument("--p3m-cap", dest="p3m_cap", type=int, default=None)
    p.add_argument("--p3m-short", dest="p3m_short", choices=P3M_SHORT_MODES,
                   default=None,
                   help="short-range pass: nlist = the cell-list kernel, "
                        "gather = per-target block gathers, slice = the "
                        "JAX package's gather-free shifted-slice pass "
                        "(auto = nlist on the GPU, gather on the CPU)")
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
    p.add_argument("--pm-assignment", dest="pm_assignment",
                   choices=PM_ASSIGNMENTS, default=None,
                   help="pm-solver mass assignment, periodic or isolated "
                        "(tsc = smoother, 27-point)")
    p.add_argument("--periodic-box", dest="periodic_box", type=float,
                   default=None,
                   help="periodic unit-cell side (0 = isolated BCs); "
                        "needs --force-backend pm (or nlist)")
    p.add_argument("--dtype", choices=DTYPES, default=None)
    p.add_argument("--sharding", choices=SHARDING_MODES, default=None,
                   help="the sharded direct sums over a torch.distributed "
                        "world (parallel/): allgather, or the ring (on a "
                        "two-axis --mesh-shape the hierarchical ring)")
    p.add_argument("--mesh-shape", dest="mesh_shape",
                   type=lambda s: tuple(int(x) for x in s.split(",")),
                   default=None,
                   help="device mesh shape, e.g. 8 or 2,4 (outer axis "
                        "first; default: the world on one axis)")
    p.add_argument("--nlist-mesh", dest="nlist_mesh",
                   choices=NLIST_MESH_MODES, default=None,
                   help="mesh strategy of nlist and p3m's near field: "
                        "halo = the slab decomposition's one-plane ghost "
                        "exchange (parallel/halo.py), allgather = gather "
                        "the world; auto picks halo on single-axis meshes "
                        "of >= 2 devices")
    p.add_argument("--nlist-mig-cap", dest="nlist_mig_cap", type=int,
                   default=None,
                   help="static halo migration bucket capacity per "
                        "(device, destination slab); 0 = fit from the "
                        "initial state")
    p.add_argument("--distributed", action="store_true", default=False,
                   help="join the launcher's torch.distributed world "
                        "first (python -m torch.distributed.run sets "
                        "RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and "
                        "MASTER_PORT); a world of one without one")
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
    p.add_argument("--trajectory-format", dest="trajectory_format",
                   choices=["npy", "native"], default=None,
                   help="npy = .npy shards + manifest; native = one .gtrj "
                        "file")
    p.add_argument("--io-pipeline", dest="io_pipeline",
                   choices=["auto", "on", "off"], default=None,
                   help="the host pipeline: queue block k+1, then consume "
                        "block k (watchdog, ledger, sentinel, trajectory "
                        "and checkpoint writes) while k+1 runs; off = the "
                        "serial loop (the same artifacts, bit for bit)")
    p.add_argument("--checkpoint-every", dest="checkpoint_every", type=int,
                   default=None, help="steps between checkpoints (0 = off)")
    p.add_argument("--checkpoint-dir", dest="checkpoint_dir", default=None)
    p.add_argument("--metrics", action="store_true", default=None,
                   help="write a JSONL metrics stream next to the log")
    p.add_argument("--metrics-energy", dest="metrics_energy",
                   action="store_true", default=None,
                   help="deprecated alias for --ledger")
    p.add_argument("--ledger", action="store_true", default=None,
                   help="the in-program conservation ledger: energy, "
                        "momentum, angular momentum and COM drift of "
                        "every block (metrics stream and run stats)")
    p.add_argument("--sentinel-every", dest="sentinel_every", type=int,
                   default=None,
                   help="accuracy sentinel cadence in blocks: the "
                        "backend's force error on --sentinel-k sampled "
                        "targets against the exact direct sum (0 = off)")
    p.add_argument("--sentinel-k", dest="sentinel_k", type=int,
                   default=None,
                   help="sampled sentinel targets a probe (default 64)")
    p.add_argument("--error-budget", dest="error_budget", type=float,
                   default=None,
                   help="largest acceptable sentinel p90 relative force "
                        "error; a breach exits 2, or heals under "
                        "--auto-recover")
    p.add_argument("--profile", action="store_true", default=None,
                   help="capture a torch.profiler trace of the run (host "
                        "ops and the card's kernels, a Chrome trace) into "
                        "<log-dir>/profile_<timestamp>/")
    p.add_argument("--trace", action="store_true", default=None,
                   help="emit lifecycle spans (blocks, checkpoints) as "
                        "JSONL under --log-dir, exportable with "
                        "`gravity_tpu_torch trace-export`")
    p.add_argument("--debug-check", dest="debug_check", action="store_true",
                   default=None,
                   help="the backend against the plain direct sum on the "
                        "final state")
    p.add_argument("--auto-recover", dest="auto_recover",
                   action="store_true", default=None,
                   help="self-healing supervision: divergence rolls back "
                        "to the last verified checkpoint and retries at "
                        "halved dt, transient faults retry with backoff, "
                        "an unbuildable backend degrades pallas-mxu -> "
                        "pallas -> chunked (on the card it stops at "
                        "pallas)")
    p.add_argument("--max-retries", dest="max_retries", type=int,
                   default=None,
                   help="recovery attempts a failure class (default 3)")
    p.add_argument("--on-diverge", dest="on_diverge",
                   choices=["halve-dt", "abort"], default=None)
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
    if config.metrics_energy and not config.ledger:
        print("warning: --metrics-energy is a deprecated alias for "
              "--ledger", file=sys.stderr)
    return config


def _print_failure_json(e) -> int:
    """One stderr JSON line and exit 2 for a failure of the recovery
    layer, shared by ``run`` and ``resume``."""
    from .simulation import AccuracyBreach, SimulationDiverged
    from .supervisor import EXIT_FAILED
    from .utils.faults import BackendUnavailable

    if isinstance(e, SimulationDiverged):
        payload = {"error": "diverged", "last_finite_step": e.step,
                   "message": str(e)}
    elif isinstance(e, AccuracyBreach):
        payload = {"error": "accuracy_breach", "step": e.step,
                   "backend": e.backend, "p90_rel_err": e.p90_rel_err,
                   "budget": e.budget, "message": str(e)}
    elif isinstance(e, BackendUnavailable):
        payload = {"error": "backend_unavailable", "message": str(e)}
    else:
        payload = {"error": "transient", "message": str(e)}
    print(json.dumps(payload), file=sys.stderr)
    return EXIT_FAILED


def _make_writer(config: SimulationConfig, logger, n_real: int):
    """The run's trajectory writer (every=1: the Simulator strides the
    frames by config.trajectory_every), or None."""
    if not config.record_trajectories:
        return None
    from .utils.trajectory import NativeTrajectoryWriter, TrajectoryWriter

    base = os.path.join(config.log_dir, f"trajectories_{logger.timestamp}")
    if config.trajectory_format == "native":
        return NativeTrajectoryWriter(base + ".gtrj", n_real, every=1)
    return TrajectoryWriter(base, n_real, every=1)


def _world(args, config: SimulationConfig) -> tuple:
    """(rank, world size) of this process: with ``--distributed`` or a
    sharded config the world is joined first (``parallel/mesh.py``); any
    other run is a world of one. Checkpoints, ``resume`` and
    ``--auto-recover`` run on a world of any size: rank 0 writes the
    gathered solo payload behind a barrier, and ``resume`` reads it onto
    this world's mesh."""
    if not (getattr(args, "distributed", False)
            or config.sharding != "none"):
        return 0, 1
    import torch.distributed as dist

    from .parallel import initialize_distributed

    # main() leaves a world it joined here when the verb returns.
    args.joined_world = not dist.is_initialized()
    initialize_distributed(args.device)
    return dist.get_rank(), dist.get_world_size()


def _debug_check(config: SimulationConfig, sim, final, logger) -> dict:
    """The run's backend against the plain direct sum on ``final``, at
    the as-run sizing (``utils/profiling.debug_check_forces``): for nlist
    the as-run cell list and the rcut-masked oracle; a masked direct run
    against the cell list sized from the final state; P3M by its full-set
    evaluation, the FMM's by its full-set evaluation at the as-run
    sizing (pure self-gravity, without an --external field). A periodic
    truncated run takes the minimum-image oracle; full periodic gravity
    has none, and the check is skipped (None)."""
    from .simulation import make_local_kernel
    from .utils.profiling import debug_check_forces

    def log(message):
        if logger is not None:
            logger.log_print(message)

    kernel = full_acc = None
    rcut = (config.nlist_rcut
            if sim.backend in ("nlist", "dense", "chunked") else 0.0)
    if config.periodic_box > 0.0 and rcut <= 0.0:
        log(
            "debug-check skipped: the direct-sum oracle is isolated-BC and "
            "cannot audit the periodic solver (tests/test_torch_periodic.py "
            "holds it to the Ewald pair instead)")
        return None
    if sim.backend == "nlist":
        side, cap, _ = sim.nlist_sizing
        kernel = make_local_kernel(
            dataclasses.replace(config, nlist_side=side, nlist_cap=cap),
            "nlist")
    elif sim.backend in ("dense", "chunked") and rcut > 0.0:
        kernel = make_local_kernel(config, "nlist",
                                   positions=final.positions)
    elif sim.backend in ("p3m", "fmm", "sfmm"):
        full_acc = sim.global_self_accel(final.positions, final.masses)
    elif sim.backend not in ("dense", "chunked"):
        kernel = make_local_kernel(config, sim.backend,
                                   positions=final.positions,
                                   device=sim.device)
    check = debug_check_forces(
        final.positions, final.masses, g=config.g, cutoff=config.cutoff,
        eps=config.eps, rcut=rcut, box=config.periodic_box, kernel=kernel,
        full_acc=full_acc)
    log(
        f"Force cross-check ({sim.backend} vs the plain direct sum): "
        f"max_rel_err={check['max_rel_err']:.3e} "
        f"median_rel_err={check['median_rel_err']:.3e} "
        f"(n={check['n_checked']})")
    return check


def cmd_run(args: argparse.Namespace) -> int:
    from .simulation import (
        AccuracyBreach,
        SimulationDiverged,
        SimulationPreempted,
        Simulator,
        make_initial_state,
    )
    from .supervisor import EXIT_FAILED, EXIT_PREEMPTED
    from .utils.faults import BackendUnavailable, TransientFault
    from .utils.logging import RunLogger

    config = build_config(args)
    if config.adaptive and config.merge_radius > 0.0:
        print(
            "error: --adaptive does not support --merge-radius "
            "(collision merging needs the fixed-dt block loop)",
            file=sys.stderr,
        )
        return 1
    # Every rank of a sharded world runs this same sequence, so that all
    # reach the same collectives; rank 0 alone writes and prints.
    lead = _world(args, config)[0] == 0

    def failed(e) -> int:
        return _print_failure_json(e) if lead else EXIT_FAILED

    logger = RunLogger(config.log_dir) if lead else None
    sim = state0 = None
    if not config.auto_recover:
        try:
            sim = Simulator(config, device=args.device)
        except BackendUnavailable as e:
            return failed(e)
        n_real = sim.n_real
    else:
        # The supervisor builds the Simulator (building one here would
        # die on the very fault its ladder survives); the writer still
        # needs the model's count.
        state0 = make_initial_state(config, args.device)
        n_real = state0.n
    writer = _make_writer(config, logger, n_real) if lead else None
    ckpt_mgr = None
    if config.checkpoint_every or config.auto_recover:
        # The supervisor always needs one: the watchdog's emergency save
        # is its rollback point.
        from .utils.checkpoint import make_checkpoint_manager

        ckpt_mgr = make_checkpoint_manager(config.checkpoint_dir)
    metrics_logger = None
    if config.metrics and lead:
        from .utils.profiling import MetricsLogger

        metrics_logger = MetricsLogger(os.path.join(
            config.log_dir, f"metrics_{logger.timestamp}.jsonl"))
    telemetry = _run_telemetry(config, logger) if lead else None
    sup = None
    if config.auto_recover:
        from .supervisor import RunSupervisor
        from .utils.logging import RecoveryEventLogger

        # Rank 0 alone records the supervisor's events.
        events = RecoveryEventLogger(os.path.join(
            config.log_dir, f"recovery_{logger.timestamp}.jsonl")) \
            if lead else None
        sup = RunSupervisor(config, logger=logger, events=events,
                            checkpoint_manager=ckpt_mgr,
                            trajectory_writer=writer,
                            metrics_logger=metrics_logger, state=state0,
                            device=args.device, telemetry=telemetry)
    def _go():
        if sup is not None:
            return sup.run(), sup.last_sim
        if config.adaptive:
            return sim.run_adaptive(logger, trajectory_writer=writer,
                                    checkpoint_manager=ckpt_mgr,
                                    metrics_logger=metrics_logger), sim
        return sim.run(logger, trajectory_writer=writer,
                       checkpoint_manager=ckpt_mgr,
                       metrics_logger=metrics_logger,
                       telemetry=telemetry), sim

    try:
        if config.profile and lead:
            from .utils.profiling import trace

            with trace(os.path.join(config.log_dir,
                                    f"profile_{logger.timestamp}")):
                stats, sim = _go()
        else:
            stats, sim = _go()
    except SimulationPreempted:
        # The run loop saved its last consumed block; the resumable exit
        # code lets a scheduler requeue the run.
        if writer is not None:
            writer.close()
        if not lead:
            return EXIT_PREEMPTED
        print(json.dumps({
            "preempted": True,
            "resumable": (ckpt_mgr is not None
                          and ckpt_mgr.latest_step() is not None),
            "resume": "gravity_tpu_torch resume --checkpoint-dir "
                      + config.checkpoint_dir,
        }), file=sys.stderr)
        return EXIT_PREEMPTED
    except (SimulationDiverged, AccuracyBreach, TransientFault,
            BackendUnavailable) as e:
        if writer is not None:
            writer.close()
        return failed(e)
    if config.debug_check:
        check = _debug_check(config, sim, stats["final_state"], logger)
        if check is not None:
            stats["debug_check"] = check
    stats.pop("final_state")
    if writer is not None:
        stats["trajectory_dir"] = getattr(writer, "out_dir", None) \
            or writer.path
    _add_trace_path(stats, telemetry)
    if lead:
        print(json.dumps(stats))
    return 0


def _run_telemetry(config: SimulationConfig, logger):
    """The solo run's telemetry bundle, or None: with ``--trace`` or an
    ``--error-budget`` (a breach's flight-recorder dump needs a recorder
    holding the run's history). Spans land in ``<log_dir>/traces.jsonl``
    (shared across runs; ``trace-export`` filters by trace id), dumps in
    the same directory."""
    if not (config.trace or config.error_budget > 0.0):
        return None
    from .telemetry import Telemetry

    if config.adaptive and logger is not None:
        logger.log_print("note: --trace spans cover the fixed-dt loop; "
                         "adaptive runs get flight-recorder triggers only")
    return Telemetry(out_dir=config.log_dir, worker=f"run-{os.getpid()}")


def _add_trace_path(stats: dict, telemetry) -> None:
    """Name the span file in the stats where the run emitted spans (an
    adaptive run takes recorder triggers but writes none)."""
    if telemetry is not None and telemetry.tracer.path \
            and stats.get("trace_id"):
        stats["trace_path"] = telemetry.tracer.path


def cmd_resume(args: argparse.Namespace) -> int:
    """Restore the latest (or ``--step``) checkpoint and continue to the
    configured step count (an adaptive run to its t_end)."""
    from .simulation import (
        AccuracyBreach,
        SimulationDiverged,
        SimulationPreempted,
        Simulator,
    )
    from .supervisor import EXIT_FAILED, EXIT_PREEMPTED
    from .utils.checkpoint import (
        CheckpointCorrupt,
        make_checkpoint_manager,
        restore_checkpoint_with_extra,
    )
    from .utils.faults import BackendUnavailable, TransientFault
    from .utils.logging import RunLogger

    config = build_config(args)
    # Every rank reads the solo payload; the Simulator shards it onto this
    # world's mesh. Rank 0 alone writes and prints.
    lead = _world(args, config)[0] == 0
    mgr = make_checkpoint_manager(config.checkpoint_dir)
    try:
        state, step, extra = restore_checkpoint_with_extra(mgr, args.step)
    except (FileNotFoundError, CheckpointCorrupt) as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_FAILED
    kwargs = dict(state=state, start_step=step)
    if config.adaptive:
        if "t" not in extra:
            print("error: checkpoint has no simulated-time metadata: it "
                  "was written by a fixed-dt run; resume it without "
                  "--adaptive", file=sys.stderr)
            return 1
        t_end = config.steps * config.dt
        if extra["t"] >= t_end:
            if lead:
                print(json.dumps({"resumed_at": step, "t": extra["t"],
                                  "t_end": t_end,
                                  "note": "checkpoint already at/past "
                                          "t_end"}))
            return 0
        kwargs.update(start_t=extra["t"], start_comp=extra.get("comp", 0.0))
    elif step >= config.steps:
        if lead:
            print(json.dumps({"resumed_at": step, "steps": config.steps,
                              "note": "checkpoint already at/past target"}))
        return 0
    logger = RunLogger(config.log_dir) if lead else None
    if logger is not None:
        logger.log_print(f"Resuming from checkpoint at step {step}")
    telemetry = _run_telemetry(config, logger) if lead else None
    try:
        if config.auto_recover:
            from .supervisor import RunSupervisor
            from .utils.logging import RecoveryEventLogger

            events = RecoveryEventLogger(os.path.join(
                config.log_dir, f"recovery_{logger.timestamp}.jsonl")) \
                if lead else None
            stats = RunSupervisor(config, logger=logger, events=events,
                                  checkpoint_manager=mgr,
                                  device=args.device, telemetry=telemetry,
                                  **kwargs).run()
        else:
            sim = Simulator(config, state=state, device=args.device)
            if config.adaptive:
                stats = sim.run_adaptive(
                    logger, checkpoint_manager=mgr,
                    start_t=kwargs["start_t"],
                    start_comp=kwargs["start_comp"], start_steps=step)
            else:
                stats = sim.run(logger, checkpoint_manager=mgr,
                                start_step=step, telemetry=telemetry)
    except SimulationPreempted:
        if lead:
            print(json.dumps({"preempted": True, "resumable": True}),
                  file=sys.stderr)
        return EXIT_PREEMPTED
    except (SimulationDiverged, AccuracyBreach, TransientFault,
            BackendUnavailable) as e:
        return _print_failure_json(e) if lead else EXIT_FAILED
    stats.pop("final_state", None)
    stats["resumed_at"] = step
    _add_trace_path(stats, telemetry)
    if lead:
        print(json.dumps(stats))
    return 0


def cmd_sweep(args: argparse.Namespace) -> int:
    """The reference's size sweep (its ``pyspark.py``): every size is a
    job on an in-process ensemble scheduler, so that the sizes integrate
    as batched launches of the hand-written kernels instead of one run
    after another. A config outside the ensemble envelope (the fast
    solvers, adaptive, merging, ...), which ``batch_key_for`` refuses
    with its ValueError, takes the solo loop instead. The log keeps the
    reference's sections for each size."""
    import time

    from .interop import to_numpy
    from .serve import EnsembleScheduler, batch_key_for
    from .utils.logging import RunLogger, ServingEventLogger
    from .utils.timing import pairs_per_step
    from .utils.trajectory import TrajectoryWriter

    config = build_config(args)
    logger = RunLogger(config.log_dir)
    sizes = args.sizes or [10, 100, 500, 1000]
    slots = args.slots or 4
    try:
        for n in sizes:
            batch_key_for(dataclasses.replace(config, n=n), slots=slots,
                          device=args.device)
    except ValueError as e:
        logger.log_print(f"(ensemble sweep unavailable for this config: "
                         f"{e}; running sizes solo)")
        return _sweep_solo(config, sizes, logger, args.device)

    events = ServingEventLogger(os.path.join(
        config.log_dir, f"serving_{logger.timestamp}.jsonl"))
    sched = EnsembleScheduler(
        slots=slots, slice_steps=max(1, min(config.progress_every,
                                            config.steps)),
        events=events, device=args.device)
    job_ids = {}
    for n in sizes:
        _sweep_banner(logger, config, n)
        job_ids[n] = sched.submit(dataclasses.replace(config, n=n))
    writers = {}
    if config.record_trajectories:
        for n in sizes:
            writers[n] = TrajectoryWriter(os.path.join(
                config.log_dir, f"trajectories_{logger.timestamp}_n{n}"),
                n, every=1)
    t0 = time.perf_counter()
    last_frame: dict = {}
    while sched.has_work():
        if sched.run_round() is None and not sched.has_work():
            break
        for n, w in writers.items():
            job = sched.jobs[job_ids[n]]
            state = sched.peek_state(job_ids[n])
            if (job.status in ("running", "completed") and state is not None
                    and last_frame.get(n) != job.steps_done):
                # Round-boundary frames, only where the job advanced.
                last_frame[n] = job.steps_done
                w.record(job.steps_done, to_numpy(state.positions))
    wall = time.perf_counter() - t0
    for w in writers.values():
        w.close()
    failed = []
    for n in sizes:
        st = sched.status(job_ids[n])
        if st["status"] != "completed":
            failed.append(n)
            logger.log_print(f"\nSweep job n={n} {st['status']}: "
                             f"{st.get('error') or 'not completed'}")
            continue
        # active_s counts only the rounds this job was resident in.
        job_s = st["active_s"]
        logger.performance(job_s, config.steps, pairs_per_sec=(
            pairs_per_step(n) * config.steps / job_s if job_s > 0 else None))
        logger.final_positions(sched.result(job_ids[n]).positions.numpy())
    logger.log_print(
        f"\nEnsemble sweep: {len(sizes)} jobs in {wall:.2f}s over "
        f"{sched.rounds_run} rounds ({len(sched.engine.compile_counts)} "
        f"batch programs built, "
        f"{sum(sched.engine.force_evals.values())} batched force "
        f"evaluations); serving events: {events.path}")
    if failed:
        return 1
    logger.completed()
    return 0


def _sweep_banner(logger, config: SimulationConfig, n: int) -> None:
    logger.log_print(f"\nStarting gravity simulation with {n} particles")
    logger.log_print("Configuration:")
    logger.log_print(f"- Number of steps: {config.steps}")
    logger.log_print(f"- Time step: {config.dt:g} seconds")


def _sweep_solo(config: SimulationConfig, sizes, logger, device) -> int:
    """One Simulator a size, back to back: the sweep of a config the
    ensemble engine cannot serve."""
    from .interop import to_numpy
    from .simulation import Simulator
    from .utils.trajectory import TrajectoryWriter

    for n in sizes:
        _sweep_banner(logger, config, n)
        cfg = dataclasses.replace(config, n=n)
        sim = Simulator(cfg, device=device)
        writer = None
        if cfg.record_trajectories:
            writer = TrajectoryWriter(os.path.join(
                cfg.log_dir, f"trajectories_{logger.timestamp}_n{n}"),
                sim.n_real, every=1)
        stats = sim.run(trajectory_writer=writer)
        logger.performance(stats["total_time_s"], cfg.steps,
                           pairs_per_sec=stats["pairs_per_sec"])
        logger.final_positions(to_numpy(stats["final_state"].positions))
    logger.completed()
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
    # The Simulator's routing gate: a config the router never tunes
    # (autotuning off, or periodic: pm and nlist are its only solvers)
    # has nothing to fill.
    if not config.autotune or config.periodic_box > 0.0:
        reason = ("autotuning disabled (--no-autotune)"
                  if not config.autotune
                  else "periodic runs route statically (pm is the only "
                  "periodic solver)")
        print(f"error: nothing to tune: {reason}", file=sys.stderr)
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

    if args.gate:
        # The noise-robust perf regression gate on the committed
        # PERF_BASELINE.json: exit 1 names the file and every violated
        # contract.
        from .perfgate import run_gate

        code, _ = run_gate(
            args.gate_baseline,
            contracts=([c for c in args.gate_contracts.split(",") if c]
                       if args.gate_contracts else None),
            report_path=args.gate_out or None, device=args.device)
        return code
    if args.report:
        # The trend report over the round artifacts: files only, no
        # device.
        from .bench import collect_bench_rounds, format_bench_report

        print(format_bench_report(collect_bench_rounds(args.report_dir)))
        return 0
    config = build_config(args)
    if args.cadence:
        # An end-to-end run with trajectories and checkpoints: the A/B of
        # the host pipeline (--io-pipeline on|off).
        config = dataclasses.replace(
            config, record_trajectories=True,
            checkpoint_every=config.checkpoint_every
            or max(1, config.progress_every))
        result = run_cadence_benchmark(config, device=args.device)
    else:
        result = run_benchmark(config, warmup_steps=args.warmup,
                               bench_steps=args.bench_steps,
                               device=args.device)
    print(json.dumps(result))
    return 0


def cmd_validate(args: argparse.Namespace) -> int:
    """The physics self-test battery, and with ``--gpu`` the card gate
    (``validate.py``): one JSON document ``{"ok", "checks"}``, exit 0 or
    1. On the card unless ``--device cpu``; with no card it raises."""
    from .validate import run_validate

    report = run_validate(args.device, gpu=args.gpu)
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


def cmd_traj(args: argparse.Namespace) -> int:
    """Inspect or export a ``.gtrj`` trajectory (``utils/gtrj_tool.py``,
    the JAX package's C++ inspector's output): no device."""
    from .utils.gtrj_tool import run

    return run(args.traj_command, args.file, frame=args.frame,
               count=args.count)


def cmd_lint(args: argparse.Namespace) -> int:
    """The AST invariant analyzer over the port (``analysis/``): no
    device. Its flags are the analysis driver's own."""
    from .analysis.driver import main as lint_main

    return lint_main(args.lint_args)


def _finite_or_none(values) -> list:
    """Empty bins are NaN by design; null keeps the report strict JSON."""
    import numpy as np

    return [None if not np.isfinite(v) else float(v)
            for v in np.asarray(values)]


def cmd_analyze(args: argparse.Namespace) -> int:
    """Structure and conserved-quantity report of a checkpointed state or
    a fresh model realization: energy, virial ratio, Lagrangian radii,
    velocity dispersion, centre of mass; with flags P(k), the density
    profile, the correlation function and friends-of-friends halos."""
    import numpy as np

    from .interop import to_numpy
    from .ops import diagnostics as diag
    from .simulation import Simulator
    from .utils.platform import resolve_device

    config = build_config(args)
    if args.checkpoint:
        from .utils.checkpoint import (
            make_checkpoint_manager,
            restore_checkpoint,
        )

        mgr = make_checkpoint_manager(config.checkpoint_dir)
        state, step = restore_checkpoint(mgr, args.step)
        state = state.to(resolve_device(args.device))
    else:
        state = Simulator(config, device=args.device).state
        step = 0

    lr = to_numpy(diag.lagrangian_radii(state, (0.1, 0.25, 0.5, 0.75, 0.9)))
    if config.periodic_box > 0.0:
        # The conserved potential of a periodic run is the mesh potential
        # (Simulator.energy's); the isolated pair sum and the virial
        # ratio built on it mean nothing in a box.
        from .ops.periodic import pm_periodic_potential_energy

        pot = float(pm_periodic_potential_energy(
            state.positions, state.masses, box=config.periodic_box,
            grid=config.pm_grid, g=config.g, eps=config.eps,
            assignment=config.pm_assignment))
        virial = None
    else:
        pot = float(diag.total_energy(state, g=config.g,
                                      cutoff=config.cutoff, eps=config.eps)
                    - diag.kinetic_energy(state))
        virial = float(diag.virial_ratio(state, g=config.g,
                                         cutoff=config.cutoff,
                                         eps=config.eps))
    report = {
        "step": int(step),
        "n": int(state.n),
        "kinetic_energy": float(diag.kinetic_energy(state)),
        "potential_energy": pot,
        "virial_ratio": virial,
        "center_of_mass": to_numpy(diag.center_of_mass(state)).tolist(),
        "total_momentum": to_numpy(diag.total_momentum(state)).tolist(),
        "total_angular_momentum": np.asarray(
            diag.total_angular_momentum(state)).tolist(),
        "velocity_dispersion": float(diag.velocity_dispersion(state)),
        "lagrangian_radii": {
            "0.10": float(lr[0]), "0.25": float(lr[1]),
            "0.50": float(lr[2]), "0.75": float(lr[3]),
            "0.90": float(lr[4]),
        },
    }
    if config.periodic_box > 0.0:
        report["periodic_note"] = (
            "periodic run: potential_energy is the mesh potential "
            "(matches Simulator.energy); virial_ratio is null "
            "(isolated-only diagnostic)"
        )
    if config.external:
        # analyze agrees with run and the metrics, whose total energy
        # includes the background field; virial_ratio stays self-gravity.
        from .ops.external import parse_external

        phi = parse_external(config.external, kind="potential")
        e_ext = float((state.masses * phi(state.positions)).sum())
        report["external_potential_energy"] = e_ext
        report["total_energy"] = (report["kinetic_energy"]
                                  + report["potential_energy"] + e_ext)
        report["note"] = ("virial_ratio covers self-gravity only; "
                          "total_energy includes the external field")
    if args.spectrum:
        from .ops.spectra import density_power_spectrum

        # A periodic run's P(k) takes the simulation box's volume, k_f and
        # wrap seam, not the data's bounding cube.
        spectrum_box = (((0.0, 0.0, 0.0), config.periodic_box)
                        if config.periodic_box > 0.0 else None)
        k, p, shot = density_power_spectrum(
            state.positions, state.masses, grid=args.spectrum_grid,
            box=spectrum_box, interlace=args.spectrum_interlace)
        report["power_spectrum"] = {"k": np.asarray(k).tolist(),
                                    "P": _finite_or_none(p),
                                    "shot_noise": float(shot)}
    if args.density_profile:
        r_mid, rho = diag.radial_density_profile(state,
                                                 bins=args.density_profile)
        report["density_profile"] = {"r": to_numpy(r_mid).tolist(),
                                     "rho": to_numpy(rho).tolist()}
    if args.correlation:
        from .ops.halos import correlation_function

        if args.correlation_bins < 1:
            print("error: --correlation-bins must be >= 1", file=sys.stderr)
            return 1
        if config.periodic_box <= 0.0:
            print("error: --correlation needs --periodic-box (the natural "
                  "estimator's RR term is analytic only on the torus)",
                  file=sys.stderr)
            return 1
        r_c, xi, dd = correlation_function(
            to_numpy(state.positions), box=config.periodic_box,
            n_bins=args.correlation_bins)
        report["correlation"] = {"r": r_c.tolist(),
                                 "xi": _finite_or_none(xi),
                                 "dd": dd.tolist()}
    if args.fof > 0.0:
        from .ops.halos import friends_of_friends

        masses = to_numpy(state.masses)
        fof = friends_of_friends(
            to_numpy(state.positions), masses, linking_length=args.fof,
            box=config.periodic_box, min_members=args.fof_min_members)
        m_tot = float(masses.sum())
        top = min(10, fof.n_halos)
        report["fof"] = {
            "linking_length": args.fof,
            "min_members": args.fof_min_members,
            "n_halos": fof.n_halos,
            "mass_fraction_in_halos": (float(fof.halo_masses.sum()) / m_tot
                                       if m_tot else 0.0),
            "top_halo_masses": fof.halo_masses[:top].tolist(),
            "top_halo_sizes": fof.halo_sizes[:top].tolist(),
            "top_halo_centers": fof.halo_centers[:top].tolist(),
        }
    print(json.dumps(report, indent=2))
    return 0


def _grf_generator(seed: int):
    import torch

    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return gen


def cmd_cosmo(args: argparse.Namespace) -> int:
    """Comoving cosmological run (EdS, LCDM, open or closed curvature, or
    CPL dark energy): Zel'dovich (or 2LPT) initial conditions in a
    periodic box, comoving KDK through the periodic FFT solver, and the
    measured growth against linear theory: grf, ops/periodic, ops/cosmo
    in one command. Its normal fields come from a CPU generator seeded
    with --seed; it runs on the GPU unless --device cpu."""
    import time

    import numpy as np
    import torch

    from .interop import to_numpy
    from .models import create_grf, grf_displacement_fields
    from .models.grf import grf_lattice, grf_side
    from .ops.cosmo import (
        comoving_kdk_factors,
        comoving_kdk_scan,
        growing_mode_momenta,
        layzer_irvine_residual,
        linear_growth_ratio,
    )
    from .ops.periodic import (
        pm_periodic_accelerations_vs,
        pm_periodic_potential_energy,
    )
    from .simulation import SimulationPreempted, preemption_guard
    from .supervisor import EXIT_PREEMPTED
    from .utils.checkpoint import crossed_cadence, save_checkpoint
    from .utils.platform import resolve_device, sync

    device = resolve_device(args.device)
    try:
        side = grf_side(args.n)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    grid = args.grid or side
    box, h0, a1, a2 = args.box, args.h0, args.a_start, args.a_end

    p_table = None
    if args.spectrum_file:
        # A two-column (k, P) text table (CAMB/CLASS output), shape only:
        # sigma_psi pins the amplitude.
        try:
            p_table = np.loadtxt(args.spectrum_file)
        except (OSError, ValueError) as e:
            print(f"error: cannot read --spectrum-file: {e}",
                  file=sys.stderr)
            return 1
    grf_kw = dict(box=box, spectral_index=args.spectral_index,
                  sigma_psi=args.sigma_psi, power_spectrum=p_table,
                  device=device)
    try:
        st = create_grf(_grf_generator(args.seed), args.n, total_mass=1.0e36,
                        lpt_order=args.lpt_order, **grf_kw)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    lat = to_numpy(grf_lattice(side, box, dtype=st.positions.dtype))
    disp = (to_numpy(st.positions) - lat + box / 2) % box - box / 2
    cosmo = dict(omega_k=args.omega_k, w0=args.w0, wa=args.wa)

    start_step = 0
    ckpt_mgr = None
    if args.checkpoint_every or args.resume:
        from .utils.checkpoint import make_checkpoint_manager

        ckpt_mgr = make_checkpoint_manager(args.checkpoint_dir)
    if args.resume:
        from .utils.checkpoint import (
            CheckpointCorrupt,
            restore_checkpoint_with_extra,
        )

        try:
            st, start_step, extra = restore_checkpoint_with_extra(ckpt_mgr)
        except (FileNotFoundError, CheckpointCorrupt) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        st = st.to(device)
        if "a" not in extra:
            print("error: checkpoint has no scale-factor metadata (not a "
                  "cosmo checkpoint)", file=sys.stderr)
            return 1
        if start_step >= args.steps:
            print(json.dumps({"resumed_at": start_step,
                              "note": "checkpoint already at/past a_end"}))
            return 0
    elif args.lpt_order == 2:
        # Second-order momenta: psi2 grows as D2 ~ D^2, so its rate factor
        # is f2 ~ 2 f1 (the 2LPTic EdS approximation); the split fields of
        # the same realization, from a generator seeded alike.
        psi1, psi2 = grf_displacement_fields(_grf_generator(args.seed),
                                             args.n, **grf_kw)
        st = st.replace(velocities=(
            growing_mode_momenta(psi1, a1, h0, args.omega_m, **cosmo)
            + 2.0 * growing_mode_momenta(psi2, a1, h0, args.omega_m,
                                         **cosmo)))
    else:
        st = st.replace(velocities=growing_mode_momenta(
            torch.from_numpy(disp).to(device), a1, h0, args.omega_m,
            **cosmo))
    # The closure Om rho_crit0 = mean density fixes G.
    m_tot = float(st.masses.sum())
    g_eff = 3.0 * args.omega_m * h0**2 * box**3 / (8.0 * np.pi * m_tot)
    masses = st.masses

    def accel(x):
        return pm_periodic_accelerations_vs(
            x, x, masses, box=box, grid=grid, g=g_eff, eps=0.0,
            assignment=args.pm_assignment)

    writer = None
    if args.trajectories:
        from .utils.trajectory import TrajectoryWriter

        stamp = time.strftime("%Y%m%d_%H%M%S")
        writer = TrajectoryWriter(
            os.path.join(args.out_dir, f"trajectories_cosmo_{stamp}"),
            args.n, every=1)

    # One global log-a grid of edges: blocks end on the edges a single
    # shot uses, so streaming and resume are exact.
    edges = np.exp(np.linspace(np.log(a1), np.log(a2), args.steps + 1))
    if args.resume:
        # The stored scale factor catches a resume onto another (a_start,
        # a_end, steps) grid, where the step counter means another epoch.
        a_ckpt = extra["a"]
        a_grid = float(edges[start_step])
        if abs(a_ckpt - a_grid) > 1e-9 * max(a_ckpt, a_grid):
            print(f"error: checkpoint step {start_step} was taken at "
                  f"a={a_ckpt:.9g} but the current --a-start/--a-end/"
                  f"--steps grid puts that step at a={a_grid:.9g}; resume "
                  "with the original grid", file=sys.stderr)
            return 1
    # The checkpoint cadence bounds the block too. The user's block (the
    # trajectory cadence) excludes the Layzer-Irvine shrinkage below.
    user_block = max(1, min(args.progress_every or args.steps,
                            args.checkpoint_every or args.steps, args.steps))
    # The Layzer-Irvine quadrature needs enough samples.
    block = min(user_block,
                max(1, args.steps // 16) if args.li_check else args.steps)

    li_records = []

    def li_sample(a_val, st_):
        # Peculiar KE (v_pec = p / a) and the proper potential energy of
        # the fluctuations (the comoving potential over a), in float64.
        p = st_.velocities.double().cpu().numpy()
        m = st_.masses.double().cpu().numpy()
        t_kin = 0.5 * float(np.sum(m * np.sum((p / a_val) ** 2, axis=-1)))
        w_c = pm_periodic_potential_energy(
            st_.positions, st_.masses, box=box, grid=grid, g=g_eff,
            eps=0.0, assignment=args.pm_assignment)
        li_records.append((a_val, t_kin, w_c / a_val))

    if args.li_check:
        li_sample(float(edges[start_step]), st)

    t0 = time.perf_counter()
    step_i = start_step
    # One consistent (state, step) pair, replaced in one assignment once a
    # block is committed: the only source the preemption save reads.
    snap = (st, step_i)
    try:
        with preemption_guard():
            while step_i < args.steps:
                hi = min(step_i + block, args.steps)
                k1s, drs, k2s = comoving_kdk_factors(
                    edges[step_i:hi + 1], h0, args.omega_m, **cosmo,
                    dtype=st.positions.dtype, device=device)
                st_new = comoving_kdk_scan(st, k1s, drs, k2s,
                                           accel_fn=accel)
                sync(device)
                st = st_new
                prev_i, step_i = step_i, hi
                snap = (st, step_i)
                a_now = float(edges[step_i])
                # Output cadences are gated apart from the block size.
                if (args.progress_every
                        and crossed_cadence(prev_i, step_i,
                                            args.progress_every)
                        and step_i < args.steps):
                    print(f"Step {step_i}/{args.steps} (a={a_now:.6g})",
                          file=sys.stderr)
                if args.li_check:
                    li_sample(a_now, st)
                if writer is not None and crossed_cadence(prev_i, step_i,
                                                          user_block):
                    writer.record(step_i, to_numpy(st.positions))
                if ckpt_mgr is not None and crossed_cadence(
                        prev_i, step_i, args.checkpoint_every):
                    save_checkpoint(ckpt_mgr, step_i, st,
                                    extra={"a": a_now})
    except SimulationPreempted:
        st_snap, step_snap = snap
        if ckpt_mgr is not None and step_snap > start_step:
            save_checkpoint(ckpt_mgr, step_snap, st_snap,
                            extra={"a": float(edges[step_snap])})
        if writer is not None:
            writer.close()
        print(json.dumps({
            "preempted": True,
            "resumable": (ckpt_mgr is not None
                          and ckpt_mgr.latest_step() is not None),
            "step": step_snap,
        }), file=sys.stderr)
        return EXIT_PREEMPTED
    elapsed = time.perf_counter() - t0
    if writer is not None:
        writer.close()

    disp2 = (to_numpy(st.positions) - lat + box / 2) % box - box / 2
    measured = float((disp2 * disp).sum() / (disp * disp).sum())
    linear = linear_growth_ratio(a1, a2, args.omega_m, **cosmo)
    report = {
        "n": args.n, "box": box, "grid": grid,
        "a_start": a1, "a_end": a2, "steps": args.steps,
        "omega_m": args.omega_m,
        "omega_k": args.omega_k, "w0": args.w0, "wa": args.wa,
        "assignment": args.pm_assignment,
        "growth_measured": measured,
        "growth_linear": linear,
        "rel_err": abs(measured - linear) / linear,
        "total_time_s": elapsed,
        "platform": device.type,
    }
    if args.li_check:
        report["layzer_irvine"] = {
            "residual": layzer_irvine_residual(li_records),
            "n_samples": len(li_records),
            "T_final": li_records[-1][1],
            "W_final": li_records[-1][2],
        }
    if start_step:
        report["resumed_at"] = start_step
    print(json.dumps(report))
    return 0


def _add_analysis_parsers(sub) -> None:
    """The ``analyze`` and ``cosmo`` verbs (the JAX CLI's flags)."""
    p_an = sub.add_parser(
        "analyze", help="diagnostics report for a checkpoint or model")
    _add_config_args(p_an)
    p_an.add_argument("--checkpoint", action="store_true",
                      help="analyze the latest (or --step) checkpoint "
                           "instead of a fresh model realization")
    p_an.add_argument("--step", type=int, default=None)
    p_an.add_argument("--spectrum", action="store_true",
                      help="add the radially binned density power "
                           "spectrum P(k) to the report")
    p_an.add_argument("--spectrum-grid", dest="spectrum_grid", type=int,
                      default=64)
    p_an.add_argument("--spectrum-interlace", dest="spectrum_interlace",
                      action="store_true",
                      help="interlaced deposits (alias suppression)")
    p_an.add_argument("--fof", type=float, default=0.0,
                      help="friends-of-friends halo finding with this "
                           "linking length (absolute; the cosmological "
                           "convention is ~0.2 x the mean interparticle "
                           "spacing); periodic with --periodic-box")
    p_an.add_argument("--fof-min-members", dest="fof_min_members",
                      type=int, default=20)
    p_an.add_argument("--density-profile", dest="density_profile",
                      type=int, default=0, metavar="BINS",
                      help="add the centre-of-mass radial mass-density "
                           "profile with this many log shells")
    p_an.add_argument("--correlation", action="store_true",
                      help="two-point correlation function xi(r) "
                           "(periodic boxes; natural estimator)")
    p_an.add_argument("--correlation-bins", dest="correlation_bins",
                      type=int, default=16)
    p_an.set_defaults(func=cmd_analyze)

    p = sub.add_parser(
        "cosmo", help="comoving cosmological run: Zel'dovich ICs -> "
                      "periodic PM -> growth report")
    p.add_argument("--n", type=int, default=32**3,
                   help="particle count (perfect cube)")
    p.add_argument("--box", type=float, default=1.0e13)
    p.add_argument("--grid", type=int, default=0,
                   help="PM grid (0 = the lattice side, the PM-safe "
                        "choice)")
    p.add_argument("--a-start", dest="a_start", type=float, default=0.02)
    p.add_argument("--a-end", dest="a_end", type=float, default=0.08)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--h0", type=float, default=0.05,
                   help="Hubble constant in code units (1/s scale set by "
                        "--box units)")
    p.add_argument("--omega-m", dest="omega_m", type=float, default=1.0,
                   help="matter density (1.0 = EdS; < 1 = flat LCDM)")
    p.add_argument("--sigma-psi", dest="sigma_psi", type=float,
                   default=0.004,
                   help="RMS Zel'dovich displacement at a_start, as a box "
                        "fraction")
    p.add_argument("--spectral-index", dest="spectral_index", type=float,
                   default=-2.0)
    p.add_argument("--omega-k", dest="omega_k", type=float, default=0.0,
                   help="curvature density (0 = flat)")
    p.add_argument("--w0", type=float, default=-1.0,
                   help="dark-energy equation of state today (CPL w(a) = "
                        "w0 + wa (1 - a))")
    p.add_argument("--wa", type=float, default=0.0,
                   help="dark-energy EoS evolution (CPL)")
    p.add_argument("--pm-assignment", dest="pm_assignment",
                   choices=PM_ASSIGNMENTS, default="cic")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--progress-every", dest="progress_every", type=int,
                   default=0,
                   help="steps per streaming block (0 = one shot)")
    p.add_argument("--checkpoint-every", dest="checkpoint_every", type=int,
                   default=0,
                   help="checkpoint cadence in steps (stores the scale "
                        "factor for an exact resume)")
    p.add_argument("--checkpoint-dir", dest="checkpoint_dir",
                   default="gravity_ckpt_cosmo")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest cosmo checkpoint (same "
                        "seed, cosmology and step grid)")
    p.add_argument("--trajectories", action="store_true",
                   help="record comoving positions at each block boundary")
    p.add_argument("--lpt-order", dest="lpt_order", type=int, choices=[1, 2],
                   default=1,
                   help="IC displacement order: 1 = Zel'dovich, 2 = 2LPT "
                        "(the EdS D2 = -3/7 D^2 convention)")
    p.add_argument("--spectrum-file", dest="spectrum_file", default="",
                   help="two-column (k, P) text table for the IC power "
                        "spectrum's shape (CAMB/CLASS output; log-log "
                        "interpolated, --sigma-psi sets the amplitude)")
    p.add_argument("--li-check", dest="li_check", action="store_true",
                   help="track the Layzer-Irvine cosmic energy equation "
                        "and report its normalized residual")
    p.add_argument("--out-dir", dest="out_dir", default="gravity_logs_cosmo")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on "
                        "the CPU)")
    p.set_defaults(func=cmd_cosmo)


def cmd_serve(args: argparse.Namespace) -> int:
    """Start the ensemble serving daemon: a localhost HTTP/JSON job API
    over the batched engine. Jobs and results persist under
    --spool-dir, so a restarted daemon resumes its queue."""
    from .serve import GravityDaemon

    daemon = GravityDaemon(
        args.spool_dir, host=args.host, port=args.port,
        slots=args.slots, slice_steps=args.slice_steps,
        yield_rounds=args.yield_rounds, worker_id=args.worker_id,
        lease_ttl_s=args.lease_ttl_s, max_queue=args.max_queue,
        max_requeues=args.max_requeues, slo_p99_ms=args.slo_p99_ms,
        slo_occupancy=args.slo_occupancy,
        error_budget=args.serve_error_budget,
        sentinel_every=args.serve_sentinel_every,
        sentinel_k=args.serve_sentinel_k, ledger_every=args.ledger_every,
        progress_every=args.serve_progress_every, device=args.device,
    )
    host, port = daemon.start()
    print(json.dumps({
        "serving": True, "host": host, "port": port,
        "spool_dir": args.spool_dir, "pid": os.getpid(),
        "slots": args.slots, "slice_steps": args.slice_steps,
        "worker_id": daemon.worker_id, "lease_ttl_s": args.lease_ttl_s,
        "device": str(daemon.device),
    }), flush=True)
    daemon.serve_blocking()
    return 0


def cmd_submit(args: argparse.Namespace) -> int:
    """Submit one job (the config flags describe it) to the daemon
    advertised under --spool-dir; prints the job id, or with --wait
    polls to the terminal status."""
    import uuid

    from .serve import DaemonUnreachable, request, wait_for
    from .serve.jobs import job_types

    if args.job_type not in job_types():
        print(f"error: --job-type {args.job_type!r} is not served by "
              f"gravity_tpu_torch; the served classes are {job_types()}",
              file=sys.stderr)
        return 2
    config = build_config(args)
    params = None
    if args.params:
        raw = args.params
        try:
            if raw.startswith("@"):
                with open(raw[1:]) as f:
                    raw = f.read()
            params = json.loads(raw)
        except (OSError, ValueError) as e:
            print(f"error: bad --params: {e}", file=sys.stderr)
            return 2
        if not isinstance(params, dict):
            print("error: --params must be a JSON object", file=sys.stderr)
            return 2
    if args.devices is not None:
        params = {**(params or {}), "devices": args.devices}
    try:
        resp = request(args.spool_dir, "POST", "/submit", {
            "config": json.loads(config.to_json()),
            "job_type": args.job_type,
            "params": params,
            "priority": args.priority,
            "deadline_s": args.deadline_s,
            # Client-made idempotency key: a retry after a lost response
            # re-submits the SAME job, never a duplicate.
            "job_id": f"job-{uuid.uuid4().hex[:12]}",
        }, retries=args.retries)
    except DaemonUnreachable as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if "job" not in resp:
        print(json.dumps(resp), file=sys.stderr)
        return 1
    if args.wait:
        try:
            statuses = wait_for(args.spool_dir, [resp["job"]],
                                timeout=args.timeout)
        except (DaemonUnreachable, TimeoutError) as e:
            print(json.dumps({"job": resp["job"], "error": str(e)}),
                  file=sys.stderr)
            return 2
        st = statuses[resp["job"]]
        print(json.dumps(st))
        return 0 if st["status"] == "completed" else 1
    print(json.dumps(resp))
    return 0


def cmd_job_status(args: argparse.Namespace) -> int:
    from .serve import DaemonUnreachable, request

    path = f"/status?job={args.job}" if args.job else "/status"
    try:
        resp = request(args.spool_dir, "GET", path)
    except DaemonUnreachable as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # An error answer (unknown job) has no "id"; a job's status carries an
    # "error" field of its own (null unless it failed), so the JAX CLI's
    # test for that key fails every single-job query.
    if "id" not in resp and "jobs" not in resp:
        print(json.dumps(resp), file=sys.stderr)
        return 1
    print(json.dumps(resp, indent=2))
    return 0


def cmd_result(args: argparse.Namespace) -> int:
    """Fetch a completed job's result; --out saves its arrays as .npz."""
    import numpy as np

    from .serve import DaemonUnreachable, request

    try:
        resp = request(args.spool_dir, "GET", f"/result?job={args.job}")
    except DaemonUnreachable as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    array_keys = [k for k, v in resp.items() if isinstance(v, list)]
    # A completed job's status carries "error": null; only a truthy
    # error (unknown job, not completed) is a failure.
    if resp.get("error") or not array_keys:
        print(json.dumps(resp), file=sys.stderr)
        return 1
    if args.out:
        # No dtype coercion: fp64 results keep their mantissa.
        np.savez(args.out, **{k: np.asarray(resp[k]) for k in array_keys})
    summary = {k: v for k, v in resp.items() if k not in array_keys}
    summary["arrays"] = sorted(array_keys)
    if "positions" in resp:
        summary["n"] = len(resp["positions"])
    if args.out:
        summary["saved_to"] = args.out
    print(json.dumps(summary))
    return 0


def cmd_cancel(args: argparse.Namespace) -> int:
    from .serve import DaemonUnreachable, request

    try:
        resp = request(args.spool_dir, "POST", "/cancel", {"job": args.job})
    except DaemonUnreachable as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps(resp))
    return 0 if resp.get("cancelled") else 1


def cmd_trace_export(args: argparse.Namespace) -> int:
    """Export one trace as Chrome/Perfetto ``trace_event`` JSON. The
    trace comes from a served job's spool record (``--spool-dir`` and a
    job id: the trace id, stitched across adoptions and the router's
    hop) or an explicit ``--trace`` id or ``--trace-file`` (a solo run's
    ``<log-dir>/traces.jsonl``). Exit 2 when there is no such record,
    trace id or span."""
    from .serve.leases import read_json_retry
    from .telemetry import (
        TRACES_FILE,
        chrome_trace,
        load_spans,
        span_coverage,
        trace_ids,
    )

    trace = args.trace
    trace_file = args.trace_file
    if args.job:
        rec = read_json_retry(
            os.path.join(args.spool_dir, "jobs", f"{args.job}.json"))
        if not isinstance(rec, dict):
            print(f"error: no spool record for job {args.job!r} under "
                  f"{args.spool_dir!r}", file=sys.stderr)
            return 2
        trace = rec.get("trace_id") or None
        if trace is None:
            print(f"error: job {args.job!r} has no trace id",
                  file=sys.stderr)
            return 2
    if trace_file is None:
        trace_file = os.path.join(args.spool_dir, TRACES_FILE)
    spans = load_spans(trace_file)
    if not spans:
        print(f"error: no spans in {trace_file!r}", file=sys.stderr)
        return 2
    if trace is None:
        ids = trace_ids(spans)
        if len(ids) != 1:
            print("error: --trace or a job id required; file holds "
                  f"{len(ids)} traces: {ids[:10]}", file=sys.stderr)
            return 2
        trace = ids[0]
    doc = chrome_trace(spans, trace)
    if not doc["traceEvents"]:
        print(f"error: trace {trace!r} not found in {trace_file!r}",
              file=sys.stderr)
        return 2
    out = args.out or f"{trace}.trace.json"
    with open(out, "w") as f:
        json.dump(doc, f)
    cov = span_coverage(spans, trace)
    print(json.dumps({
        "trace": trace, "out": out, "spans": cov["spans"],
        "wall_s": cov["wall_s"], "union_s": cov["union_s"],
        # The share of the trace's wall clock its top-level spans cover.
        "coverage": cov["coverage"],
    }))
    return 0


def cmd_fleet_status(args: argparse.Namespace) -> int:
    """Fleet-wide serving health: every live worker's snapshot from the
    shared spool, aggregated (``/metrics?fleet=1``), with the worker
    registry's capability and drain view and, when a pod router runs,
    its placement table (routed counts by worker, the decision ring)."""
    import urllib.request

    from .serve import DaemonUnreachable, request
    from .serve.leases import entry_alive, read_json_retry
    from .serve.service import ROUTER_FILE, WORKERS_DIR

    try:
        resp = request(args.spool_dir, "GET", "/metrics?fleet=1")
    except DaemonUnreachable as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # Capability and drain state straight from the registry files:
    # authoritative with or without a router in front.
    registry_view = {}
    workers_dir = os.path.join(args.spool_dir, WORKERS_DIR)
    try:
        names = sorted(n for n in os.listdir(workers_dir)
                       if n.endswith(".json")
                       and not n.endswith(".metrics.json"))
    except OSError:
        names = []
    for name in names:
        entry = read_json_retry(os.path.join(workers_dir, name))
        if not isinstance(entry, dict):
            continue
        wid = entry.get("worker_id") or name[:-len(".json")]
        caps = entry.get("capabilities") or {}
        registry_view[wid] = {
            "alive": entry_alive(entry),
            "draining": bool(entry.get("draining")),
            # The capabilities the router's sharded and nlist rules read.
            "sharded_capable": bool(caps.get("sharded_capable")),
            "nlist_capable": bool(caps.get("nlist_capable")),
            "capabilities": caps,
        }
    resp["worker_registry"] = registry_view
    if "router" not in resp:
        # Answered by a worker directly: ask a live router for its
        # placement table ourselves.
        rinfo = read_json_retry(os.path.join(args.spool_dir, ROUTER_FILE))
        if isinstance(rinfo, dict) and entry_alive(rinfo):
            try:
                with urllib.request.urlopen(
                        f"http://{rinfo['host']}:{rinfo['port']}/metrics",
                        timeout=10.0) as r:
                    resp["router"] = json.loads(r.read())
            except Exception:  # noqa: BLE001 — the router view is a bonus
                pass
    if not args.full:
        # The registry dumps are for machines; the default view is the
        # operator's summary.
        resp.pop("registry", None)
        if isinstance(resp.get("router"), dict):
            resp["router"].pop("registry", None)
    print(json.dumps(resp, indent=2))
    return 0


def cmd_route(args: argparse.Namespace) -> int:
    """Start the pod router: a stateless placement tier speaking the
    worker HTTP/JSON API, placing each submit onto a live worker by
    measured evidence. Clients find it through the same spool
    (``router.json``, preferred by ``find_daemon`` while its pid lives).
    It never touches a device."""
    from .serve.router import RouterDaemon

    router = RouterDaemon(args.spool_dir, host=args.host, port=args.port,
                          router_id=args.router_id,
                          proxy_timeout_s=args.proxy_timeout)
    host, port = router.start()
    print(json.dumps({
        "routing": True, "host": host, "port": port,
        "spool_dir": args.spool_dir, "pid": os.getpid(),
        "router_id": router.router_id,
    }), flush=True)
    router.serve_blocking()
    return 0


def cmd_drain(args: argparse.Namespace) -> int:
    """Flip a worker's drain state: a draining worker keeps running its
    residents and answering every client verb, but the pod router places
    no new job on it. Exit 2 when the worker is not live or not
    reachable."""
    import urllib.error
    import urllib.request

    from .serve.service import _live_workers

    drain = not args.undrain
    for info in _live_workers(args.spool_dir):
        if info.get("worker_id") != args.worker:
            continue
        req = urllib.request.Request(
            f"http://{info['host']}:{info['port']}/drain",
            data=json.dumps({"drain": drain}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=30.0) as resp:
                print(json.dumps(json.loads(resp.read())))
                return 0
        except (urllib.error.URLError, OSError) as e:
            print(f"error: worker {args.worker!r} unreachable: {e}",
                  file=sys.stderr)
            return 2
    print(f"error: no live worker {args.worker!r} in the registry under "
          f"{args.spool_dir!r}", file=sys.stderr)
    return 2


def _add_spool_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--spool-dir", dest="spool_dir", default="gravity_spool",
                   help="daemon spool directory (jobs, results, "
                        "daemon.json endpoint file)")


def _add_serving_parsers(sub) -> None:
    """The serving verbs, with the JAX CLI's flags."""
    p = sub.add_parser("serve", help="start the ensemble serving daemon "
                                     "(HTTP/JSON job API over the batched "
                                     "engine)")
    _add_spool_arg(p)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to serve "
                        "on the CPU)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = any free port (clients find it through the "
                        "spool's daemon.json)")
    p.add_argument("--slots", type=int, default=4,
                   help="batch slots per bucket")
    p.add_argument("--slice-steps", dest="slice_steps", type=int,
                   default=100, help="steps per scheduling round")
    p.add_argument("--worker-id", dest="worker_id", default=None,
                   help="stable worker identity in the shared spool")
    p.add_argument("--lease-ttl-s", dest="lease_ttl_s", type=float,
                   default=30.0, help="job-lease TTL; peers adopt this "
                                      "worker's jobs once its leases expire")
    p.add_argument("--max-queue", dest="max_queue", type=int, default=1024,
                   help="bounded admission queue: submissions beyond it "
                        "shed with HTTP 503 + Retry-After (0 = unbounded)")
    p.add_argument("--max-requeues", dest="max_requeues", type=int,
                   default=5, help="requeue cap per job before it goes "
                                   "terminal failed ('poisoned')")
    p.add_argument("--yield-rounds", dest="yield_rounds", type=int,
                   default=2, help="consecutive rounds a resident job may "
                                   "hold a contended slot before yielding")
    p.add_argument("--slo-p99-ms", dest="slo_p99_ms", type=float,
                   default=None, help="p99 completed-latency SLO in ms")
    p.add_argument("--slo-occupancy", dest="slo_occupancy", type=float,
                   default=None, help="round-occupancy SLO (0..1)")
    p.add_argument("--error-budget", dest="serve_error_budget", type=float,
                   default=0.0,
                   help="accuracy SLO: largest acceptable sentinel p90 "
                        "relative force error; a breach trips the "
                        "backend's breaker")
    p.add_argument("--sentinel-every", dest="serve_sentinel_every",
                   type=int, default=8,
                   help="accuracy-sentinel cadence in rounds (0 = off)")
    p.add_argument("--sentinel-k", dest="serve_sentinel_k", type=int,
                   default=64, help="sampled sentinel targets per probe")
    p.add_argument("--progress-every", dest="serve_progress_every",
                   type=int, default=1,
                   help="rounds between durable mid-run progress "
                        "snapshots per running job (0 disables)")
    p.add_argument("--ledger-every", dest="ledger_every", type=int,
                   default=1, help="per-slot conservation-ledger cadence "
                                   "in rounds (0 = off)")
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser("submit", help="submit a job to the serving daemon")
    _add_config_args(p)
    _add_spool_arg(p)
    p.add_argument("--job-type", dest="job_type", default="integrate",
                   help="traffic class: integrate, fit (params: "
                        "observations, iters, lr, optimizer, ...), sweep "
                        "(params: members, spread, ...), watch (params: "
                        "radius, merge_radius, followup, ...) or "
                        "sharded-integrate")
    p.add_argument("--devices", type=int, default=None,
                   help="sharded-integrate: the devices of the job's "
                        "group (params.devices; default every card "
                        "visible to the daemon, 1 on the CPU)")
    p.add_argument("--params", default=None,
                   help="job-class payload as inline JSON or @file (the "
                        "class's params; integrate takes an optional "
                        "inline 'state')")
    p.add_argument("--priority", type=int, default=0,
                   help="higher preempts lower in a full batch")
    p.add_argument("--deadline-s", dest="deadline_s", type=float,
                   default=None, help="wall-clock budget from submission")
    p.add_argument("--wait", action="store_true",
                   help="poll until the job is terminal")
    p.add_argument("--retries", type=int, default=3,
                   help="client retries with jittered exponential backoff "
                        "on an unreachable daemon or a 503 load shed")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="--wait poll budget in seconds")
    p.set_defaults(func=cmd_submit)

    p = sub.add_parser("status",
                       help="job status (all jobs when no id is given)")
    _add_spool_arg(p)
    p.add_argument("job", nargs="?", default=None)
    p.set_defaults(func=cmd_job_status)

    p = sub.add_parser("result", help="fetch a completed job's final state")
    _add_spool_arg(p)
    p.add_argument("job")
    p.add_argument("--out", default=None,
                   help="save the final state as this .npz")
    p.set_defaults(func=cmd_result)

    p = sub.add_parser("cancel", help="cancel a queued/running job")
    _add_spool_arg(p)
    p.add_argument("job")
    p.set_defaults(func=cmd_cancel)

    p = sub.add_parser("trace-export",
                       help="export a job's or a run's trace as "
                            "Chrome/Perfetto trace_event JSON")
    _add_spool_arg(p)
    p.add_argument("job", nargs="?", default=None,
                   help="served job id (its spool record carries the "
                        "trace id)")
    p.add_argument("--trace", default=None,
                   help="explicit trace id (solo runs print it in their "
                        "stats JSON)")
    p.add_argument("--trace-file", dest="trace_file", default=None,
                   help="traces.jsonl to read (default: "
                        "<spool-dir>/traces.jsonl)")
    p.add_argument("--out", default=None,
                   help="output path (default <trace>.trace.json)")
    p.set_defaults(func=cmd_trace_export)

    p = sub.add_parser("fleet-status",
                       help="aggregated fleet health across every live "
                            "worker on the spool, the worker registry's "
                            "capability and drain view, and the pod "
                            "router's placement table when one runs")
    _add_spool_arg(p)
    p.add_argument("--full", action="store_true",
                   help="include the merged metric registry dump")
    p.set_defaults(func=cmd_fleet_status)

    p = sub.add_parser("route",
                       help="start the pod router: policy-placed submits "
                            "over every worker sharing the spool, the "
                            "same HTTP/JSON API as a worker")
    _add_spool_arg(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = any free port (clients find it through the "
                        "spool's router.json)")
    p.add_argument("--router-id", dest="router_id", default=None,
                   help="stable router identity in the shared event and "
                        "trace streams (default: router-host-pid-random)")
    p.add_argument("--proxy-timeout", dest="proxy_timeout", type=float,
                   default=300.0,
                   help="a proxied worker call's budget in seconds (must "
                        "outwait an admission-time autotune probe)")
    p.set_defaults(func=cmd_route)

    p = sub.add_parser("drain",
                       help="take a worker out of the router's placement "
                            "rotation (its residents keep running; "
                            "--undrain puts it back)")
    _add_spool_arg(p)
    p.add_argument("worker", help="worker id from the registry (see "
                                  "fleet-status)")
    p.add_argument("--undrain", action="store_true",
                   help="re-enter the placement rotation")
    p.set_defaults(func=cmd_drain)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "lint":
        # Before the parser, as the JAX CLI does: lint owns its flags
        # (argparse.REMAINDER would refuse a leading option); the
        # subparser below lists it in --help.
        return cmd_lint(argparse.Namespace(lint_args=argv[1:]))
    parser = argparse.ArgumentParser(
        prog="gravity_tpu_torch",
        description="N-body gravity on PyTorch and CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p_run = sub.add_parser("run", help="run a simulation")
    _add_config_args(p_run)
    p_run.set_defaults(func=cmd_run)

    p_sweep = sub.add_parser(
        "sweep", help="the reference's size sweep, batched through the "
                      "ensemble engine")
    _add_config_args(p_sweep)
    p_sweep.add_argument("--sizes", type=int, nargs="*", default=None,
                         help="sizes to run (default 10 100 500 1000)")
    p_sweep.add_argument("--slots", type=int, default=None,
                         help="batch slots a bucket (default 4)")
    p_sweep.set_defaults(func=cmd_sweep)

    p_resume = sub.add_parser(
        "resume", help="resume from the latest checkpoint")
    _add_config_args(p_resume)
    p_resume.add_argument("--step", type=int, default=None,
                          help="checkpoint step to restore (default the "
                               "latest verified one)")
    p_resume.set_defaults(func=cmd_resume)

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
                         help="cadence-on end-to-end mode: a whole run "
                              "with trajectories and checkpoints (the "
                              "--io-pipeline on|off A/B): steps_per_sec "
                              "and host_gap_frac")
    p_bench.add_argument("--report", action="store_true",
                         help="print the perf trend table over the round "
                              "artifacts (BENCH_r*, MULTICHIP_r*, the nlist "
                              "ladders, tuning/, the perf ledger, the last "
                              "gate report) instead of running; no device")
    p_bench.add_argument("--report-dir", dest="report_dir", default=".",
                         help="directory holding the round JSON files")
    p_bench.add_argument("--gate", action="store_true",
                         help="run the noise-robust perf regression gate "
                              "against the committed PERF_BASELINE.json "
                              "(exit 1 on any violated contract)")
    p_bench.add_argument("--gate-baseline", dest="gate_baseline",
                         default="PERF_BASELINE.json",
                         help="baseline contract file for --gate")
    p_bench.add_argument("--gate-contracts", dest="gate_contracts",
                         default=None,
                         help="comma-separated contract names for --gate "
                              "(default: all)")
    p_bench.add_argument("--gate-out", dest="gate_out",
                         default="PERF_GATE_LAST_TORCH.json",
                         help="the gate's report ('' writes none)")
    p_bench.set_defaults(func=cmd_bench)

    p_val = sub.add_parser(
        "validate", help="physics self-test battery on this device")
    p_val.add_argument("--device", default=None,
                       help="torch device (default: the GPU; 'cpu' asks "
                            "for the CPU and its smaller sizes)")
    p_val.add_argument(
        "--gpu", action="store_true",
        help="append the card gate: each kernel, the octree and both "
             "FMMs against the plain direct sum, the sharded path on a "
             "world of one, a 5-step bench line and the 2M direct sum")
    p_val.set_defaults(func=cmd_validate)

    p_traj = sub.add_parser(
        "traj", help="inspect a native GTRJ trajectory file")
    p_traj.add_argument("traj_command",
                        choices=["info", "stats", "dump", "export"])
    p_traj.add_argument("file")
    p_traj.add_argument("--frame", type=int, default=0,
                        help="frame index for dump (negative = from end)")
    p_traj.add_argument("--count", type=int, default=10,
                        help="particles to dump")
    p_traj.set_defaults(func=cmd_traj)

    p_lint = sub.add_parser(
        "lint",
        help="AST invariant analyzer over the port: fenced writes, flock "
             "weight, telemetry and fault drift "
             "(gravity_tpu_torch/docs/static-analysis.md); exits 1 on "
             "findings outside the baseline")
    p_lint.add_argument("lint_args", nargs=argparse.REMAINDER)
    p_lint.set_defaults(func=cmd_lint)
    _add_analysis_parsers(sub)
    _add_serving_parsers(sub)
    args = parser.parse_args(argv)
    try:
        return args.func(args)
    finally:
        if getattr(args, "joined_world", False):
            import torch.distributed as dist

            dist.destroy_process_group()
