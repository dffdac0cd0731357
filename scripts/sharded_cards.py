"""The sharded runs on P cards, one process a card: each run sharded over
the world, its ms a step, and one force evaluation of its final state
against a reference on rank 0's card.

    python -m torch.distributed.run --nproc-per-node 4 scripts/sharded_cards.py

``--set direct`` runs the sharded direct sums: ``baseline-262k``
(allgather and the ring, 20 steps) and ``baseline-2m-merger`` (the ring on
(P,) and (2, P/2), and allgather, 2 steps), then the first run again, each
evaluation against the unsharded ``nbody_direct`` one. ``--set halo`` runs
the halo slab engine and the sharded modes: the README cell list (20
steps) under ``auto`` (the halo engine) and ``--nlist-mesh allgather``, its
final forces against the solo cell list at the halo's sizing; the README
P3M run (5 steps) with the halo near field and with the allgather one,
the two evaluations of the halo run's final state against each other;
``baseline-262k --integrator multirate`` (5 steps); and the ``auto`` mesh
contest of the README cell list. ``--set all`` (the default) runs both.

The rest of the mesh layer: ``--set fmm`` runs ``baseline-1m-fmm``'s disk
sharded through the sparse FMM (``auto`` and ``sfmm``) and the dense one
(depth 6), its final evaluation against rank 0's unsharded evaluation at
the as-run sizing; ``--set resume`` writes ``baseline-262k`` on the world
(preempted), resumes it on the world and, from rank 0 in processes of
their own, on 2 ranks and on 1, each against an uninterrupted run on that
world, and times a checkpoint's gather, write and barrier; ``--set serve``
(rank 0 alone) runs the daemon with ``sharded-integrate`` jobs of
``devices`` = the world on ``pallas`` and on the halo cell list against
the solo runs, and a ``mesh_fail`` job that walks to the solo form;
``--set p3m`` also splits the halo run's P3M into its near field and its
mesh pass, each against the solo one, in fp32 and fp64.
``--device cpu --n N --steps S --pm-grid G`` runs the same on gloo ranks
at N bodies. Rank 0 prints one JSON line a run and a last line with the
cards' names and power limits (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from gravity_tpu_torch.config import PRESETS, SimulationConfig  # noqa: E402
from gravity_tpu_torch.ops import nlist  # noqa: E402
from gravity_tpu_torch.ops.direct_kernel import (  # noqa: E402
    accelerations_vs_kernel,
)
from gravity_tpu_torch.parallel import initialize_distributed  # noqa: E402
from gravity_tpu_torch.simulation import Simulator  # noqa: E402


def runs(world: int):
    half = (2, world // 2) if world % 2 == 0 and world > 2 else None
    yield "baseline-262k", "allgather", (world,), 20
    yield "baseline-262k", "ring", (world,), 20
    yield "baseline-2m-merger", "ring", (world,), 2
    if half is not None:
        yield "baseline-2m-merger", "ring", half, 2
    yield "baseline-2m-merger", "allgather", (world,), 2
    # The first run again: the first sharded run of a process pays once
    # for its collectives' first steps.
    yield "baseline-262k", "allgather", (world,), 20


# README.md's cell-list and P3M runs.
README_NLIST = dict(model="random", n=262_144, integrator="leapfrog",
                    force_backend="nlist", nlist_rcut=5e10, eps=1e9)
README_P3M = dict(model="disk", n=1_048_576, g=1.0, dt=2e-3, eps=0.05,
                  integrator="leapfrog", force_backend="p3m", pm_grid=256,
                  p3m_cap=64, p3m_short="nlist")


def mean_rel(a, b) -> float:
    """max |a - b| over mean |b| (the halo engine's contract)."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().norm(dim=1).mean())


def profiled(sim, state, evals: int = 3) -> dict:
    """Device time by kernel and by the halo engine's stages
    (``halo.*`` ranges) of ``evals`` sharded evaluations of ``state`` on
    each rank; rank 0's record (``chip_smoke.profile_record``)."""
    import time

    import chip_smoke
    from gravity_tpu_torch import parallel

    mine = parallel.shard_state(state, sim.mesh)
    sim._sharded(mine.positions, mine.masses)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(evals):
            sim._sharded(mine.positions, mine.masses)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / evals
    return chip_smoke.profile_record(prof, "halo.", evals, wall_ms)


def nlist_runs(args, rank: int, world: int):
    """The README cell list under ``auto`` (the halo engine) and
    ``allgather``: ms a step, the final forces against the solo cell list
    at the halo's sizing, and (on the card) a profile of each form's
    evaluation."""
    n_over = {"n": args.n} if args.n else {}
    for mode in ("auto", "allgather"):
        cfg = SimulationConfig(**{**README_NLIST, **n_over},
                               steps=args.steps or 20, sharding="allgather",
                               nlist_mesh=mode)
        sim = Simulator(cfg, device=args.device)
        stats = sim.run()
        final = stats["final_state"]
        acc = sim.global_self_accel(final.positions, final.masses)
        side, cap, _ = sim.nlist_sizing
        solo = nlist.nlist_accelerations(
            final.positions, final.masses, rcut=cfg.nlist_rcut, side=side,
            cap=cap, eps=cfg.eps)
        record = {
            "run": "readme_nlist", "nlist_mesh": mode,
            "halo": bool(sim._halo_devices), "side": side, "cap": cap,
            "mig_cap": sim.nlist_mig_cap, "n": cfg.n, "steps": cfg.steps,
            "ms_per_step": 1e3 * stats["avg_step_s"],
            "launches_rank0": stats["kernel_launches"],
            "final_forces_vs_solo_over_mean_a": mean_rel(acc, solo)}
        if sim.device.type == "cuda":
            record["profile_rank0"] = profiled(sim, final)
        yield record
        del sim, stats, final, acc


def exact_near(targets, positions, masses, *, alpha, rcut, g, eps, cutoff,
               chunk: int = 64):
    """P3M's erfc near field at ``targets`` in fp64 by a direct sum over
    every source (no cells, no cap): ``ops/nlist.py``'s ewald pair weight
    with the same masks (r < rcut, r^2 + eps^2 > cutoff^2, r > 0)."""
    x = positions.double()
    gm = g * masses.double()
    params = torch.tensor([rcut * rcut, alpha], dtype=torch.float64,
                          device=x.device)
    out = []
    for t in targets.double().split(chunk):
        d = x[None, :, :] - t[:, None, :]
        w = nlist._ewald_w((d * d).sum(-1), gm[None, :], params,
                           cutoff=cutoff, eps=eps)
        out.append((w[..., None] * d).sum(1))
    return torch.cat(out)


def p3m_witness(cfg, sims, final, a_halo, a_all, seed: int = 0) -> dict:
    """The halo near field held at its own sizing (rank 0, one card): the
    four-card halo run against the solo P3M at the halo's binning side,
    the allgather run against the solo P3M at its own, and all four
    against the exact P3M force (the mesh pass plus :func:`exact_near`)
    on 4,096 random bodies and on the 256 where the two runs differ
    most; gaps in units of the RMS |a| of the allgather run."""
    from gravity_tpu_torch.ops import p3m, pm

    pos, m = final.positions, final.masses
    kw = dict(grid=cfg.pm_grid, sigma_cells=cfg.p3m_sigma_cells,
              rcut_sigmas=cfg.p3m_rcut_sigmas, cap=cfg.p3m_cap, g=cfg.g,
              cutoff=cfg.cutoff, eps=cfg.eps, short_mode="nlist",
              khat=sims["allgather"]._p3m_khat)
    side_h = sims["auto"].p3m_sizing[0]
    side_a = sims["allgather"].p3m_sizing[0]
    arms = {f"halo@{side_h}": a_halo, f"allgather@{side_a}": a_all,
            f"solo@{side_h}": p3m.p3m_accelerations(pos, m, side=side_h,
                                                    **kw),
            f"solo@{side_a}": p3m.p3m_accelerations(pos, m, side=side_a,
                                                    **kw)}
    rms = a_all.double().norm(dim=1).pow(2).mean().sqrt()

    def gaps(a, b, rows=slice(None)):
        g = (a[rows] - b[rows]).double().norm(dim=1) / rms
        return {"max": float(g.max()), "median": float(g.median())}

    gen = torch.Generator(device="cpu").manual_seed(seed)
    sample = torch.randperm(pos.shape[0], generator=gen)[:4096].to(
        pos.device)
    worst = (a_halo - a_all).double().norm(dim=1).topk(256).indices
    origin, span = pm.bounding_cube(pos.double())
    sigma = cfg.p3m_sigma_cells * span / (cfg.pm_grid - 1)
    rows = torch.cat([sample, worst])
    far = p3m._mesh_accelerations(
        pos[rows], pos, m, *pm.bounding_cube(pos), grid=cfg.pm_grid,
        g=cfg.g, sigma_cells=cfg.p3m_sigma_cells, khat=kw["khat"])
    exact = far.double() + exact_near(
        pos[rows], pos, m, alpha=float(1.0 / (math.sqrt(2.0) * sigma)),
        rcut=float(cfg.p3m_rcut_sigmas * sigma), g=cfg.g, eps=cfg.eps,
        cutoff=cfg.cutoff)
    k = sample.shape[0]
    return {
        "run": "readme_p3m_witness", "sides": [side_h, side_a],
        "cap": cfg.p3m_cap,
        f"halo@{side_h}_vs_solo@{side_h}": gaps(
            arms[f"halo@{side_h}"], arms[f"solo@{side_h}"]),
        f"allgather@{side_a}_vs_solo@{side_a}": gaps(
            arms[f"allgather@{side_a}"], arms[f"solo@{side_a}"]),
        "vs_exact_random_4096": {
            name: gaps(a[rows][:k], exact[:k]) for name, a in arms.items()},
        "vs_exact_worst_256": {
            name: gaps(a[rows][k:], exact[k:]) for name, a in arms.items()},
    }


def p3m_runs(args, rank: int, world: int):
    """The README P3M run with the halo near field and with the allgather
    one: ms a step, the two evaluations of the halo run's final state
    against each other, and :func:`p3m_witness`."""
    n_over = {"n": args.n} if args.n else {}
    p3m_over = {"pm_grid": args.pm_grid} if args.pm_grid else {}
    sims = {}
    for mode in ("auto", "allgather"):
        cfg = SimulationConfig(**{**README_P3M, **n_over, **p3m_over},
                               steps=args.steps or 5, sharding="allgather",
                               nlist_mesh=mode)
        sims[mode] = sim = Simulator(cfg, device=args.device)
        stats = sim.run()
        sims[mode + "/final"] = stats["final_state"]
        yield {"run": "readme_p3m", "nlist_mesh": mode,
               "p3m_sizing": list(sim.p3m_sizing), "n": cfg.n,
               "steps": cfg.steps, "ms_per_step": 1e3 * stats["avg_step_s"],
               "launches_rank0": stats["kernel_launches"]}
    final = sims["auto/final"]
    a_halo = sims["auto"].global_self_accel(final.positions, final.masses)
    a_all = sims["allgather"].global_self_accel(final.positions,
                                                final.masses)
    # The two near fields bin at different sides (the halo's rounded down
    # to a multiple of P); the witness holds each to its own side.
    rms = a_all.double().norm(dim=1).pow(2).mean().sqrt()
    gap = (a_halo - a_all).double().norm(dim=1) / rms
    yield {"run": "readme_p3m_halo_vs_allgather",
           "sides": [sims["auto"].p3m_sizing[0],
                     sims["allgather"].p3m_sizing[0]],
           "max_gap_over_rms_a": float(gap.max()),
           "median_gap_over_rms_a": float(gap.median())}
    yield (p3m_witness(cfg, sims, final, a_halo, a_all) if rank == 0
           else {})
    yield p3m_split(cfg, sims["auto"], final)
    del sims, final, a_halo, a_all


def p3m_split(cfg, sim, final) -> dict:
    """The halo P3M run's two parts apart, on its final state: the halo
    engine's ewald near field against the solo P3M's near field at the
    halo's side (its mesh pass taken out), and the allgather mesh pass
    against the solo mesh pass, in the run's fp32 and in fp64; gaps in
    units of the RMS |a| of the solo P3M (a collective: every rank)."""
    from gravity_tpu_torch import parallel
    from gravity_tpu_torch.ops import p3m, pm
    from gravity_tpu_torch.parallel.mesh import all_gather_rows

    grid, sc = cfg.pm_grid, cfg.p3m_sigma_cells
    side = sim.p3m_sizing[0]
    out = {"run": "readme_p3m_split", "side": side, "cap": cfg.p3m_cap}
    for dtype in (torch.float32, torch.float64):
        pos, m = final.positions.to(dtype), final.masses.to(dtype)
        mine = parallel.shard_state(type(final)(pos, torch.zeros_like(pos),
                                                m), sim.mesh)
        near = parallel.make_halo_nlist_accel(
            sim.mesh, side=side, cap=cfg.p3m_cap, kind="ewald", g=cfg.g,
            cutoff=cfg.cutoff, eps=cfg.eps,
            ewald_scales=((grid - 1) / (math.sqrt(2.0) * sc),
                          cfg.p3m_rcut_sigmas * sc / (grid - 1)))
        got_near = all_gather_rows(near(mine.positions, mine.masses))
        khat = p3m.force_kernel_hat(2 * grid, sc, dtype, pos.device)

        def far_local(targets, sources, m_src):
            origin, span = pm.bounding_cube(sources)
            return p3m._mesh_accelerations(targets, sources, m_src, origin,
                                           span, grid=grid, g=cfg.g,
                                           sigma_cells=sc, khat=khat)

        far = parallel.make_sharded_accel2(sim.mesh, strategy="allgather",
                                           local_kernel=far_local)
        got_far = all_gather_rows(far(mine.positions, mine.masses))
        n = pos.shape[0]
        got_near, got_far = got_near[:n], got_far[:n]
        if dist.get_rank() != 0:
            continue
        origin, span = pm.bounding_cube(pos)
        want_far = far_local(pos, pos, m)
        mesh_pass = p3m._mesh_accelerations
        try:
            p3m._mesh_accelerations = \
                lambda targets, *a, **k: torch.zeros_like(targets)
            want_near = p3m.p3m_accelerations(
                pos, m, grid=grid, sigma_cells=sc,
                rcut_sigmas=cfg.p3m_rcut_sigmas, cap=cfg.p3m_cap, side=side,
                short_mode="nlist", g=cfg.g, cutoff=cfg.cutoff, eps=cfg.eps)
        finally:
            p3m._mesh_accelerations = mesh_pass
        rms = (want_near + want_far).double().norm(dim=1).pow(2).mean().sqrt()

        def gaps(a, b):
            g = (a - b).double().norm(dim=1) / rms
            return {"max": float(g.max()), "median": float(g.median()),
                    "bitwise_equal": bool(torch.equal(a, b))}

        name = str(dtype).removeprefix("torch.")
        out[name] = {"near_halo_vs_solo": gaps(got_near, want_near),
                     "mesh_allgather_vs_solo": gaps(got_far, want_far)}
        del want_near, want_far
    return out


def fmm_runs(args, rank: int, world: int):
    """``baseline-1m-fmm``'s disk sharded over the world: the sparse FMM
    under ``fmm_mode=auto`` and as ``sfmm``, and the dense FMM at depth 6;
    ms a step, the as-run sizing, and the final state's evaluation against
    rank 0's unsharded one at that sizing (the same bits expected: the
    split is by cells)."""
    from gravity_tpu_torch.ops import fmm, sfmm

    base = dataclasses.replace(PRESETS["baseline-1m-fmm"],
                               steps=args.steps or 2,
                               n=args.n or PRESETS["baseline-1m-fmm"].n,
                               sharding="allgather")
    for name, fields in (("auto", {}), ("sfmm", dict(force_backend="sfmm")),
                         ("dense_depth6", dict(fmm_mode="dense",
                                               tree_depth=6))):
        cfg = dataclasses.replace(base, **fields)
        sim = Simulator(cfg, device=args.device)
        stats = sim.run()
        final = stats["final_state"]
        acc = sim.global_self_accel(final.positions, final.masses)
        record = {"run": f"baseline_1m_fmm_{name}", "n": cfg.n,
                  "steps": cfg.steps, "fmm_sparse": sim.fmm_sparse,
                  "sizing": (list(sim.sfmm_sizing) if sim.fmm_sparse
                             else [sim.fmm_depth]),
                  "ms_per_step": 1e3 * stats["avg_step_s"],
                  "launches_rank0": stats["kernel_launches"]}
        if rank == 0:
            kw = dict(g=cfg.g, cutoff=cfg.cutoff, eps=cfg.eps,
                      ws=cfg.tree_ws)
            if sim.fmm_sparse:
                depth, cap, k_eff, k_chunk = sim.sfmm_sizing
                ref = sfmm.sfmm_accelerations(
                    final.positions, final.masses, depth=depth,
                    leaf_cap=cap, k_cells=k_eff, k_chunk=k_chunk, **kw)
            else:
                ref = fmm.fmm_accelerations(
                    final.positions, final.masses, depth=sim.fmm_depth,
                    leaf_cap=cfg.tree_leaf_cap, **kw)
            record.update(eval_bitwise_equal_unsharded=bool(
                torch.equal(acc, ref)),
                eval_gap_over_mean_a=mean_rel(acc, ref))
            del ref
        yield record
        del sim, stats, final, acc
        torch.cuda.empty_cache() if torch.cuda.is_available() else None


def _clean_env(**extra) -> dict:
    """This process's environment without its launcher's world."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                        "GROUP_RANK", "ROLE_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "GRAVITY_TPU_FAULTS")
           and not k.startswith("TORCHELASTIC")}
    env["PYTHONPATH"] = REPO
    env.update(extra)
    return env


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _cli(world: int, argv: list) -> int:
    """``gravity_tpu_torch ARGV`` on a world of ``world`` processes of its
    own, joined as a launcher joins them (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` and a free local ``MASTER_PORT``; one process without
    them): the worst exit code, and rank 0's stderr tail."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gravity_tpu_torch", *argv], cwd=REPO,
        env=_clean_env(**({"RANK": str(r), "LOCAL_RANK": str(r),
                           "WORLD_SIZE": str(world),
                           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port}
                          if world > 1 else {})),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs = [p.communicate(timeout=1800)[1] for p in procs]
    return max(p.returncode for p in procs), errs[0][-1500:]


def resume_runs(args, rank: int, world: int):
    """``baseline-262k`` (allgather) written on this world and preempted at
    half its steps, resumed here and, from rank 0 in processes of their
    own, on 2 ranks and on 1 (a world of one), each final checkpoint
    against an uninterrupted run on that world; and one checkpoint's
    gather, rank 0's write and the barrier, timed on every rank."""
    import contextlib
    import io
    import shutil
    import time

    from gravity_tpu_torch import cli
    from gravity_tpu_torch.utils import faults
    from gravity_tpu_torch.utils.checkpoint import (
        make_checkpoint_manager,
        restore_checkpoint,
    )

    steps = args.steps or 40
    half = steps // 2
    n = args.n or PRESETS["baseline-262k"].n
    argv = ["--preset", "baseline-262k", "--steps", str(steps), "--n",
            str(n), "--progress-every", str(max(1, half // 2)),
            "--checkpoint-every", str(max(1, half // 2))]
    if args.device:
        argv += ["--device", args.device]
    root = os.path.join(REPO, "scratch", "sharded_resume")
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
    dist.barrier()

    def run(verb, name, spec=""):
        os.environ["GRAVITY_TPU_FAULTS"] = spec
        faults.reset()
        try:
            # The verb's log and stats lines stay out of this script's.
            with contextlib.redirect_stdout(io.StringIO()):
                return cli.main([verb, *argv, "--checkpoint-dir",
                                 os.path.join(root, name), "--log-dir",
                                 os.path.join(root, "logs")])
        finally:
            os.environ.pop("GRAVITY_TPU_FAULTS", None)
            faults.reset()

    codes = {f"straight{world}": run("run", f"straight{world}"),
             "pre": run("run", "pre", f"preempt@{half}")}
    dist.barrier()
    if rank == 0:
        for w in (world, 2, 1):
            shutil.copytree(os.path.join(root, "pre"),
                            os.path.join(root, f"on{w}"))
    dist.barrier()
    codes[f"resume_on{world}"] = run("resume", f"on{world}")
    # One checkpoint alone: the gather, rank 0's write, the barrier.
    sim = Simulator(dataclasses.replace(
        PRESETS["baseline-262k"], n=n, sharding="allgather"),
        device=args.device)
    mgr = make_checkpoint_manager(os.path.join(root, "timed"))
    sim._save_checkpoint(mgr, 1, sim._checkpoint_state(sim.state))
    walls = []
    for step in range(2, 5):
        torch.cuda.synchronize() if torch.cuda.is_available() else None
        t0 = time.perf_counter()
        sim._save_checkpoint(mgr, step, sim._checkpoint_state(sim.state))
        walls.append(time.perf_counter() - t0)
    record = {"run": "baseline_262k_resume", "n": n, "steps": steps,
              "preempt_at": half, "world": world,
              "checkpoint_s_rank": [rank, walls], "exit_codes": codes}
    if rank == 0:
        for w in (2, 1):
            if w == world:
                continue
            for name, verb in ((f"straight{w}", "run"), (f"on{w}", "resume")):
                rc, err = _cli(w, [verb, *argv, "--sharding", "allgather",
                                   "--checkpoint-dir",
                                   os.path.join(root, name), "--log-dir",
                                   os.path.join(root, "logs")])
                codes[f"{name}" if verb == "run" else f"resume_on{w}"] = rc
                if rc:
                    record.setdefault("errors", {})[name] = err
        finals = {}
        for w in (world, 2, 1):
            try:
                finals[w] = (restore_checkpoint(make_checkpoint_manager(
                    os.path.join(root, f"straight{w}")), steps)[0],
                    restore_checkpoint(make_checkpoint_manager(
                        os.path.join(root, f"on{w}")), steps)[0])
            except (FileNotFoundError, RuntimeError) as e:
                record.setdefault("errors", {})[f"final{w}"] = str(e)
        record["resumed_vs_uninterrupted"] = {
            str(w): {"bitwise_equal": all(
                torch.equal(getattr(a, f), getattr(b, f))
                for f in ("positions", "velocities")),
                "max_position_gap_m": float(
                    (a.positions.double() - b.positions.double()).abs().max())}
            for w, (a, b) in finals.items()}
        record["uninterrupted_across_worlds_bitwise"] = {
            f"{world}_vs_{w}": all(torch.equal(
                getattr(finals[world][0], f), getattr(finals[w][0], f))
                for f in ("positions", "velocities"))
            for w in finals if w != world}
    yield record


def serve_runs(args, rank: int, world: int):
    """Rank 0: the daemon (a process of its own, every card visible) with
    ``sharded-integrate`` jobs of ``devices`` = the world on ``pallas``
    and on the halo cell list, each against the solo run of its padded
    state on rank 0's card, and a ``mesh_fail`` job (a second daemon with
    ``mesh_fail@0x99``) that walks the world down to the solo form; ms a
    round, the groups' build seconds, rank 0's launches against the
    force evaluations."""
    if rank != 0:
        return
    import tempfile
    import time

    import numpy as np

    from gravity_tpu_torch.serve import request, wait_for
    from gravity_tpu_torch.simulation import make_initial_state

    from gravity_tpu_torch.ops import (
        cells,
        cuda_build,
        direct_kernel,
        mxu_kernel,
        nlist,
    )

    n = args.n or 65_536
    steps = args.steps or 200
    if torch.cuda.is_available() and args.device != "cpu":
        # Built once here, so that each worker of a group loads the
        # libraries instead of compiling them in its first round.
        cuda_build.build_all((direct_kernel.LIBRARY, nlist.LIBRARY,
                              mxu_kernel.LIBRARY, cells.LIBRARY))
    common = ["--model", "random", "--n", str(n), "--integrator",
              "leapfrog", "--dt", "3600", "--eps", "1e9", "--steps",
              str(steps)]
    nl = ["--force-backend", "nlist", "--nlist-rcut", "5e10",
          "--nlist-side", "12", "--nlist-cap", "64"]
    jobs = {"pallas": (["--force-backend", "pallas"], "main"),
            "nlist_halo": (nl, "main"),
            "mesh_fail": (["--force-backend", "pallas"], "mesh_fail")}
    device = ["--device", args.device] if args.device else []
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "scratch")) \
            as root:
        spools, daemons = {}, {}
        try:
            for name, spec in (("main", ""), ("mesh_fail", "mesh_fail@0x99")):
                spools[name] = os.path.join(root, name)
                daemons[name] = subprocess.Popen(
                    [sys.executable, "-m", "gravity_tpu_torch", "serve",
                     "--spool-dir", spools[name], "--slots", "1",
                     "--slice-steps", str(min(steps, 50)), "--max-requeues",
                     "8", *device], cwd=REPO,
                    env=_clean_env(**({"GRAVITY_TPU_FAULTS": spec}
                                      if spec else {})),
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)
                json.loads(daemons[name].stdout.readline())
            t0 = time.perf_counter()
            ids = {}
            for label, (flags, d) in jobs.items():
                done = subprocess.run(
                    [sys.executable, "-m", "gravity_tpu_torch", "submit",
                     "--spool-dir", spools[d], "--job-type",
                     "sharded-integrate", "--devices", str(world), *common,
                     *flags], cwd=REPO, env=_clean_env(),
                    capture_output=True, text=True, timeout=300)
                ids[label] = json.loads(done.stdout.strip().splitlines()[-1])[
                    "job"]
            statuses = {}
            for label, (_, d) in jobs.items():
                statuses.update(wait_for(spools[d], [ids[label]],
                                         timeout=1200))
            wall = time.perf_counter() - t0
            metrics, events = {}, {}
            for name, spool in spools.items():
                metrics[name] = request(spool, "GET", "/metrics")
                with open(os.path.join(spool, "serving_events.jsonl")) as f:
                    events[name] = [json.loads(x) for x in f if x.strip()]
                for label, (_, d) in jobs.items():
                    if d == name:
                        subprocess.run(
                            [sys.executable, "-m", "gravity_tpu_torch",
                             "result", "--spool-dir", spool, ids[label],
                             "--out", os.path.join(root, f"{label}.npz")],
                            cwd=REPO, env=_clean_env(), timeout=300,
                            check=True, capture_output=True)
        finally:
            for name, daemon in daemons.items():
                try:
                    request(spools[name], "POST", "/shutdown")
                except Exception:  # noqa: BLE001 — the wait decides
                    pass
                try:
                    daemon.wait(timeout=120)
                except subprocess.TimeoutExpired:
                    daemon.kill()
        record = {"run": "serve_sharded", "n": n, "steps": steps,
                  "devices": world, "wall_s": wall, "jobs": {}}
        for label, (flags, d) in jobs.items():
            kw = dict(zip(flags[::2], flags[1::2]))
            cfg = SimulationConfig(
                model="random", n=n, integrator="leapfrog", dt=3600.0,
                eps=1e9, steps=steps, force_backend=kw["--force-backend"],
                nlist_rcut=float(kw.get("--nlist-rcut", 0.0)),
                nlist_side=int(kw.get("--nlist-side", 0)),
                nlist_cap=int(kw.get("--nlist-cap", 0)))
            want = Simulator(cfg, state=make_initial_state(cfg, "cpu"),
                             device=args.device).run()["final_state"]
            with np.load(os.path.join(root, f"{label}.npz")) as z:
                got = torch.from_numpy(z["positions"])
            ref = want.positions.cpu()
            mine = [e for e in events[d] if e.get("job") == ids[label]]
            record["jobs"][label] = {
                "status": statuses[ids[label]]["status"],
                "events": [e["event"] for e in mine],
                "breakers_opened": [e["backend"] for e in events[d]
                                    if e["event"] == "breaker_open"],
                "bitwise_equal_solo": bool(torch.equal(got, ref)),
                "max_gap_over_max_abs_x": float(
                    (got.double() - ref.double()).abs().max()
                    / ref.double().abs().max())}
        for name in spools:
            rounds = [e for e in events[name] if e.get("event") == "round"]
            by_key = {}
            for e in rounds:
                by_key.setdefault(e["backend"], []).append(e["round_s"])
            record[f"daemon_{name}"] = {
                "groups": metrics[name]["sharded_groups"],
                "force_evals": metrics[name]["engine"]["force_evals"],
                # A key's first round builds its program (and a group's
                # ranks their first launches): apart from the rest.
                "first_round_ms": {b: 1e3 * r[0] for b, r in by_key.items()},
                "ms_per_round_after_first": {
                    b: [1e3 * x for x in r[1:]] for b, r in by_key.items()},
                "steps_per_round": min(steps, 50)}
    yield record


def multirate_run(args, rank: int, world: int):
    """``baseline-262k --integrator multirate``: ms a step."""
    cfg = dataclasses.replace(PRESETS["baseline-262k"],
                              integrator="multirate",
                              steps=args.steps or 5,
                              n=args.n or PRESETS["baseline-262k"].n)
    sim = Simulator(cfg, device=args.device)
    stats = sim.run()
    yield {"run": "baseline_262k_multirate", "n": cfg.n, "steps": cfg.steps,
           "multirate_k": stats["multirate_k"],
           "ms_per_step": 1e3 * stats["avg_step_s"],
           "launches_rank0": stats["kernel_launches"]}


def contest_run(args, rank: int, world: int):
    """The ``auto`` mesh contest of the README cell list: its verdict."""
    n_over = {"n": args.n} if args.n else {}
    cfg = SimulationConfig(**{**README_NLIST, **n_over,
                              "force_backend": "auto"}, steps=1,
                           sharding="allgather")
    sim = Simulator(cfg, device=args.device)
    d = sim.autotune_decision
    yield {"run": "readme_nlist_auto_contest", "winner": d.backend,
           "cache": d.cache, "timings_s": d.timings_s,
           "skipped": d.skipped, "probe_ms": d.probe_ms,
           "nlist_mesh": sim.config.nlist_mesh}


HALO_PARTS = {"nlist": nlist_runs, "p3m": p3m_runs,
              "multirate": multirate_run, "contest": contest_run,
              "fmm": fmm_runs, "resume": resume_runs, "serve": serve_runs}
SETS = {"halo": ("nlist", "p3m", "multirate", "contest"),
        "mesh": ("fmm", "resume", "serve"),
        "all": (*HALO_PARTS, "direct")}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    parser.add_argument("--n", type=int, default=None)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--pm-grid", type=int, default=None)
    parser.add_argument("--set", default="all",
                        help="comma-separated parts: direct, nlist, p3m, "
                             "multirate, contest, fmm, resume, serve; halo "
                             "(nlist, p3m, multirate, contest), mesh (fmm, "
                             "resume, serve) or all")
    args = parser.parse_args()
    parts = [p for name in args.set.split(",")
             for p in SETS.get(name, (name,))]
    unknown = set(parts) - {*HALO_PARTS, "direct"}
    if unknown:
        parser.error(f"unknown --set parts {sorted(unknown)}")
    initialize_distributed(args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    for part in (p for p in HALO_PARTS if p in parts):
        for record in HALO_PARTS[part](args, rank, world):
            if rank == 0 and record:
                print(json.dumps({**record, "num_devices": world}),
                      flush=True)
        dist.barrier()
    for preset, sharding, mesh, steps in (runs(world) if "direct" in parts
                                          else ()):
        cfg = dataclasses.replace(
            PRESETS[preset], sharding=sharding, mesh_shape=mesh,
            steps=args.steps or steps, n=args.n or PRESETS[preset].n)
        sim = Simulator(cfg, device=args.device)
        stats = sim.run()
        final = stats["final_state"]
        acc = sim.global_self_accel(final.positions, final.masses)
        record = None
        if rank == 0:
            ref = accelerations_vs_kernel(final.positions, final.positions,
                                          final.masses, g=cfg.g,
                                          cutoff=cfg.cutoff, eps=cfg.eps)
            rel = ((acc.double() - ref.double()).norm(dim=1)
                   / ref.double().norm(dim=1))
            record = {
                "preset": preset, "sharding": sharding,
                "mesh_shape": list(mesh), "n": cfg.n, "steps": cfg.steps,
                "ms_per_step": 1e3 * stats["avg_step_s"],
                "launches_rank0": stats["kernel_launches"],
                "eval_bitwise_equal_unsharded": bool(torch.equal(acc, ref)),
                "eval_max_rel_gap": float(rel.max()),
                "eval_median_rel_gap": float(rel.median()),
                "device": stats["device"], "num_devices": world}
            print(json.dumps(record), flush=True)
        del sim, stats, final, acc
        dist.barrier()
    if rank == 0 and torch.cuda.is_available() and args.device != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        print(json.dumps({"nvidia_smi": smi}), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
