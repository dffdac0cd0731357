"""Gradients through the sharded engines on P cards, one process a card.

    python -m torch.distributed.run --nproc-per-node 4 scripts/sharded_grad_cards.py

The VJP of sum((a / A)^2), A the rms |a| of the world's forward, through
one evaluation of (a) the sharded dense FMM on ``baseline-1m-fmm``'s disk
and (c) the halo cell list on the 262,144-body grf box (box 1e13 m, rcut
box/16), each the Simulator's mesh accel (``Simulator._self_accel`` on a
rank's rows), against rank 0's unsharded VJP on the same global state
(the dense FMM at the sharded run's depth, the solo periodic cell list at
the halo engine's side and cap). Each rank differentiates the loss of its
own rows; the world's gradient, gathered to rank 0, is held to the
unsharded one by the fp32 gap max |difference| / max |gradient|. Rank 0
prints one JSON line a part (ms of the sharded and unsharded VJP, rank 0's
peak bytes of each, the gap) and a last line with the cards' names and
power limits (``nvidia-smi``). ``--device cpu --n-fmm N --n-halo N``
runs the same on gloo ranks at N bodies.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from gravity_tpu_torch.config import PRESETS, SimulationConfig  # noqa: E402
from gravity_tpu_torch.ops import fmm, nlist  # noqa: E402
from gravity_tpu_torch.parallel import initialize_distributed  # noqa: E402
from gravity_tpu_torch.parallel.mesh import all_gather_rows  # noqa: E402
from gravity_tpu_torch.simulation import Simulator  # noqa: E402

BOX = 1.0e13


def configs(args) -> dict:
    disk = PRESETS["baseline-1m-fmm"]
    return {
        "fmm_dense": dataclasses.replace(
            disk, n=args.n_fmm or disk.n, fmm_mode="dense",
            sharding="allgather"),
        "halo_periodic": SimulationConfig(
            model="grf", n=args.n_halo or 262_144, periodic_box=BOX,
            force_backend="nlist", nlist_rcut=BOX / 16, nlist_mesh="halo",
            integrator="leapfrog", eps=2.0e11, dt=2.0e4,
            sharding="allgather"),
    }


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_reset(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def vjp(fn, pos, m, scale, masses: bool, device):
    """(gradients, ms, peak bytes) of sum((fn(p, m) / scale)^2)."""
    p = pos.detach().clone().requires_grad_(True)
    mm = m.detach().clone().requires_grad_(masses)
    inputs = (p, mm) if masses else (p,)
    sync(device)
    peak_reset(device)
    t = time.perf_counter()
    grads = torch.autograd.grad(((fn(p, mm) / scale) ** 2).sum(), inputs)
    sync(device)
    return grads, 1e3 * (time.perf_counter() - t), peak(device)


def part(name: str, cfg, rank: int, device_arg) -> dict | None:
    sim = Simulator(cfg, device=device_arg)
    device = sim.device
    pos_l, m_l = sim.state.positions, sim.state.masses
    masses = name.startswith("fmm")
    with torch.no_grad():
        a = sim._self_accel(pos_l, m_l).double()
        total = (a * a).sum().reshape(1)
        dist.all_reduce(total)
        scale = float((total / sim.n_padded).sqrt())
    got, ms, peak_sh = vjp(sim._self_accel, pos_l, m_l, scale, masses,
                           device)
    got = [all_gather_rows(g.contiguous()) for g in got]
    pos = all_gather_rows(pos_l.contiguous())
    m = all_gather_rows(m_l.contiguous())
    record = None
    if rank == 0:
        if masses:
            depth = sim.fmm_depth

            def solo(p, mm):
                return fmm.fmm_accelerations(
                    p, mm, depth=depth, leaf_cap=cfg.tree_leaf_cap,
                    ws=cfg.tree_ws, g=cfg.g, cutoff=cfg.cutoff, eps=cfg.eps)
            sizing = {"depth": depth}
        else:
            side, cap, _ = sim.nlist_sizing

            def solo(p, mm):
                return nlist.nlist_accelerations(
                    p, mm, rcut=cfg.nlist_rcut, side=side, cap=cap,
                    box=cfg.periodic_box, g=cfg.g, cutoff=cfg.cutoff,
                    eps=cfg.eps)
            sizing = {"side": side, "cap": cap,
                      "halo_devices": sim._halo_devices}
        del sim
        want, solo_ms, peak_solo = vjp(solo, pos, m, scale, masses, device)
        gaps = {}
        for label, g, w in zip(("positions", "masses"), got, want):
            gaps[label] = float((g - w).abs().max() / w.abs().max())
        record = {"part": name, "n": cfg.n, "a_scale": scale,
                  "ms": ms, "peak_bytes_rank0": peak_sh,
                  "unsharded_ms": solo_ms, "unsharded_peak_bytes": peak_solo,
                  "gap": gaps, "finite": all(bool(torch.isfinite(g).all())
                                             for g in got),
                  **sizing}
    dist.barrier()
    return record


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    parser.add_argument("--n-fmm", type=int, default=None)
    parser.add_argument("--n-halo", type=int, default=None)
    parser.add_argument("--parts", default="fmm_dense,halo_periodic")
    args = parser.parse_args()
    initialize_distributed(args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    todo = configs(args)
    for name in args.parts.split(","):
        record = part(name, todo[name], rank, args.device)
        if record is not None:
            print(json.dumps({**record, "num_devices": world}), flush=True)
        if torch.cuda.is_available() and args.device != "cpu":
            torch.cuda.empty_cache()
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
