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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

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
    del sims, final, a_halo, a_all


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
              "multirate": multirate_run, "contest": contest_run}
SETS = {"halo": tuple(HALO_PARTS), "all": (*HALO_PARTS, "direct")}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    parser.add_argument("--n", type=int, default=None)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--pm-grid", type=int, default=None)
    parser.add_argument("--set", default="all",
                        help="comma-separated parts: direct, nlist, p3m, "
                             "multirate, contest; halo (the four after "
                             "direct) or all")
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
            if rank == 0:
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
