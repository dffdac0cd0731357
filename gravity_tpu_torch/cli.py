"""Command-line interface: the ``run``, ``resume``, ``bench`` and ``tune``
verbs, the cosmology and analysis verbs ``cosmo`` and ``analyze``, and the
serving verbs ``serve``, ``submit``, ``status``, ``result`` and
``cancel``.

Counterpart of ``gravity_tpu/cli.py`` for this slice, with the JAX CLI's
flag names. ``run`` writes the reference log and prints one JSON line of
run statistics on stdout; ``resume`` continues a checkpointed run;
``bench`` prints one JSON line of a timed block (``bench.run_benchmark``,
or with ``--cadence`` a whole run with trajectories and checkpoints);
``tune`` fills the autotuner's cache over a size ladder, one JSON line a
size. ``cosmo`` runs a comoving cosmological box (grf initial conditions,
the periodic PM solver, the comoving KDK) and prints one JSON growth
report; ``analyze`` prints a diagnostics report (energy, radii, P(k),
halos, xi(r)) of a checkpoint or a fresh realization. Each runs on the
GPU unless ``--device cpu``. ``serve`` starts the
ensemble daemon (serve/service.py) on the GPU unless ``--device cpu``;
the client verbs find it through ``--spool-dir``. ``submit --job-type``
takes ``integrate`` only: the other classes are refused with exit 2. A
served ``--force-backend nlist`` job names its ``--nlist-rcut`` and
``--nlist-side`` (no state exists at admission to size the grid from;
``--nlist-cap`` defaults to 64); the daemon refuses it otherwise.

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
    P3M_SHORT_MODES,
    PM_ASSIGNMENTS,
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
    p.add_argument("--pm-assignment", dest="pm_assignment",
                   choices=PM_ASSIGNMENTS, default=None,
                   help="pm-solver mass assignment, periodic or isolated "
                        "(tsc = smoother, 27-point)")
    p.add_argument("--periodic-box", dest="periodic_box", type=float,
                   default=None,
                   help="periodic unit-cell side (0 = isolated BCs); "
                        "needs --force-backend pm (or nlist)")
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

    kernel = full_acc = None
    rcut = (config.nlist_rcut
            if sim.backend in ("nlist", "dense", "chunked") else 0.0)
    if config.periodic_box > 0.0 and rcut <= 0.0:
        logger.log_print(
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
        full_acc = sim._self_accel(final.positions, final.masses)
    elif sim.backend not in ("dense", "chunked"):
        kernel = make_local_kernel(config, sim.backend,
                                   positions=final.positions)
    check = debug_check_forces(
        final.positions, final.masses, g=config.g, cutoff=config.cutoff,
        eps=config.eps, rcut=rcut, box=config.periodic_box, kernel=kernel,
        full_acc=full_acc)
    logger.log_print(
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
    from .supervisor import EXIT_PREEMPTED
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
    logger = RunLogger(config.log_dir)
    sim = state0 = None
    if not config.auto_recover:
        try:
            sim = Simulator(config, device=args.device)
        except BackendUnavailable as e:
            return _print_failure_json(e)
        n_real = sim.n_real
    else:
        # The supervisor builds the Simulator (building one here would
        # die on the very fault its ladder survives); the writer still
        # needs the model's count.
        state0 = make_initial_state(config, args.device)
        n_real = state0.n
    writer = _make_writer(config, logger, n_real)
    ckpt_mgr = None
    if config.checkpoint_every or config.auto_recover:
        # The supervisor always needs one: the watchdog's emergency save
        # is its rollback point.
        from .utils.checkpoint import make_checkpoint_manager

        ckpt_mgr = make_checkpoint_manager(config.checkpoint_dir)
    metrics_logger = None
    if config.metrics:
        from .utils.profiling import MetricsLogger

        metrics_logger = MetricsLogger(os.path.join(
            config.log_dir, f"metrics_{logger.timestamp}.jsonl"))
    sup = None
    if config.auto_recover:
        from .supervisor import RunSupervisor
        from .utils.logging import RecoveryEventLogger

        events = RecoveryEventLogger(os.path.join(
            config.log_dir, f"recovery_{logger.timestamp}.jsonl"))
        sup = RunSupervisor(config, logger=logger, events=events,
                            checkpoint_manager=ckpt_mgr,
                            trajectory_writer=writer,
                            metrics_logger=metrics_logger, state=state0,
                            device=args.device)
    def _go():
        if sup is not None:
            return sup.run(), sup.last_sim
        if config.adaptive:
            return sim.run_adaptive(logger, trajectory_writer=writer,
                                    checkpoint_manager=ckpt_mgr,
                                    metrics_logger=metrics_logger), sim
        return sim.run(logger, trajectory_writer=writer,
                       checkpoint_manager=ckpt_mgr,
                       metrics_logger=metrics_logger), sim

    try:
        if config.profile:
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
        return _print_failure_json(e)
    if config.debug_check:
        check = _debug_check(config, sim, stats["final_state"], logger)
        if check is not None:
            stats["debug_check"] = check
    stats.pop("final_state")
    if writer is not None:
        stats["trajectory_dir"] = getattr(writer, "out_dir", None) \
            or writer.path
    print(json.dumps(stats))
    return 0


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
            print(json.dumps({"resumed_at": step, "t": extra["t"],
                              "t_end": t_end,
                              "note": "checkpoint already at/past t_end"}))
            return 0
        kwargs.update(start_t=extra["t"], start_comp=extra.get("comp", 0.0))
    elif step >= config.steps:
        print(json.dumps({"resumed_at": step, "steps": config.steps,
                          "note": "checkpoint already at/past target"}))
        return 0
    logger = RunLogger(config.log_dir)
    logger.log_print(f"Resuming from checkpoint at step {step}")
    try:
        if config.auto_recover:
            from .supervisor import RunSupervisor
            from .utils.logging import RecoveryEventLogger

            events = RecoveryEventLogger(os.path.join(
                config.log_dir, f"recovery_{logger.timestamp}.jsonl"))
            stats = RunSupervisor(config, logger=logger, events=events,
                                  checkpoint_manager=mgr,
                                  device=args.device, **kwargs).run()
        else:
            sim = Simulator(config, state=state, device=args.device)
            if config.adaptive:
                stats = sim.run_adaptive(
                    logger, checkpoint_manager=mgr,
                    start_t=kwargs["start_t"],
                    start_comp=kwargs["start_comp"], start_steps=step)
            else:
                stats = sim.run(logger, checkpoint_manager=mgr,
                                start_step=step)
    except SimulationPreempted:
        print(json.dumps({"preempted": True, "resumable": True}),
              file=sys.stderr)
        return EXIT_PREEMPTED
    except (SimulationDiverged, AccuracyBreach, TransientFault,
            BackendUnavailable) as e:
        return _print_failure_json(e)
    stats.pop("final_state", None)
    stats["resumed_at"] = step
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
    from .config import NotPortedError

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
        raise NotPortedError(
            "bench --report (the trend table over round artifacts) is not "
            "ported to gravity_tpu_torch yet (ROADMAP.md Queue 1 item 10)")
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
    from .serve.jobs import NOT_PORTED

    if args.job_type != "integrate":
        item = NOT_PORTED.get(args.job_type)
        print(f"error: --job-type {args.job_type!r} is not served by "
              "gravity_tpu_torch" + (
                  f" yet (ROADMAP.md Queue 1 item {item})" if item
                  else "; the served class is 'integrate'"),
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
                   help="traffic class: integrate (the JAX package's fit, "
                        "sweep, watch and sharded-integrate are not "
                        "ported: exit 2)")
    p.add_argument("--params", default=None,
                   help="job-class payload as inline JSON or @file (an "
                        "optional inline 'state')")
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="gravity_tpu_torch",
        description="N-body gravity on PyTorch and CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p_run = sub.add_parser("run", help="run a simulation")
    _add_config_args(p_run)
    p_run.set_defaults(func=cmd_run)

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
                         help="the perf trend table (not ported: ROADMAP.md "
                              "Queue 1 item 10)")
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
    _add_analysis_parsers(sub)
    _add_serving_parsers(sub)
    args = parser.parse_args(argv)
    return args.func(args)
