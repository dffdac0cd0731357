"""The sharded direct sums on P cards, one process a card: each preset's
run sharded over the world, its ms a step, and one force evaluation of its
final state sharded against the unsharded ``nbody_direct`` evaluation on
rank 0's card.

    python -m torch.distributed.run --nproc-per-node 4 scripts/sharded_cards.py

Runs ``baseline-262k`` (allgather and the ring, 20 steps) and
``baseline-2m-merger`` (the ring on (P,) and (2, P/2), and allgather, 2
steps), then the first run again. ``--device cpu --n N --steps S`` runs
the same on gloo ranks at N bodies. Rank 0 prints one JSON line a run
and a last line with the cards' names and power limits (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from gravity_tpu_torch.config import PRESETS  # noqa: E402
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


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    parser.add_argument("--n", type=int, default=None)
    parser.add_argument("--steps", type=int, default=None)
    args = parser.parse_args()
    initialize_distributed(args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    for preset, sharding, mesh, steps in runs(world):
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
