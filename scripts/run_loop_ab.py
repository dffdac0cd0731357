"""The run loop of this tree against another tree's (a parent commit
unpacked with ``git archive``), on one card: ms a step of the runs whose
loop differs, each tree's package in processes of its own, in turns.

    python3 scripts/run_loop_ab.py --other DIR [--pairs 3]

For each tree a process imports that tree's ``gravity_tpu_torch`` and
times, through ``Simulator.run`` with no recording, checkpoints or
observatory (what every existing path runs), three repetitions each of:
``baseline-16k`` (the direct sum, fixed dt), ``reference-cuda``, the
``baseline-16k`` modes (multirate two rungs, the 3-rung ladder cut to 100
steps, adaptive), merging (``reference-cuda`` and ``baseline-16k``, 100
steps, a check every 10, at the radius of each initial state's 20th
closest pair), the README cell list (N = 262,144, 500 steps), the Gram
form (``pallas-mxu``, N = 65,536, 100 steps), the README P3M run (the 1M
disk, grid 256, cap 64, ``--p3m-short nlist``, cut to 50 steps) and
``baseline-1m`` through the octree (``--tree-near nlist``, cut to 3
steps). A tree that honours ``io_pipeline`` also times the cell list and
P3M with it ``off`` (``nlist/serial``, ``p3m/serial``), which separates
the loop from the rest of the change. The processes run other, this,
other, this, ... (``--pairs`` of each). One JSON line a process; the last
line gives each run's median and range for each tree. ``--only NAME,...``
times only the runs of those names (``two_rung``, ``ladder``, ``nlist``,
...). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(tree: str, only=None) -> dict:
    """ms a step of each run (of ``only``'s names, else all), three
    repetitions, through ``tree``'s package (imported from ``tree``)."""
    sys.path.insert(0, tree)
    from gravity_tpu_torch.config import PRESETS, SimulationConfig
    from gravity_tpu_torch.ops.encounters import closest_pairs
    from gravity_tpu_torch.simulation import Simulator

    base = PRESETS["baseline-16k"]
    cases = {
        "baseline-16k": base,
        "reference-cuda": PRESETS["reference-cuda"],
        "two_rung": dataclasses.replace(base, integrator="multirate"),
        "ladder": dataclasses.replace(base, integrator="multirate",
                                      multirate_rungs=3, steps=100),
        "adaptive": dataclasses.replace(base, adaptive=True),
    }
    for preset in ("reference-cuda", "baseline-16k"):
        cfg = PRESETS[preset]
        s0 = Simulator(cfg).state
        d, _, _ = closest_pairs(s0.positions, s0.masses, k=20)
        cases[f"merge/{preset}"] = dataclasses.replace(
            cfg, merge_radius=float(d[19]), merge_every=10, steps=100)
    # The host-bound and large paths: the state made once, a one-step
    # run first (sizing, the kernel's first load), both untimed.
    warmed = {}
    warmed["nlist"] = SimulationConfig(
        model="random", n=262_144, integrator="leapfrog",
        force_backend="nlist", nlist_rcut=5e10, eps=1e9, steps=500)
    warmed["pallas-mxu"] = SimulationConfig(
        model="random", n=65_536, integrator="leapfrog",
        force_backend="pallas-mxu", eps=1e9, steps=100)
    warmed["p3m"] = dataclasses.replace(PRESETS["baseline-1m-p3m"],
                                       p3m_short="nlist", steps=50)
    warmed["tree"] = dataclasses.replace(PRESETS["baseline-1m"],
                                        tree_near="nlist", steps=3)
    if hasattr(Simulator, "_resolve_io_pipeline"):
        for name in ("nlist", "p3m"):
            warmed[f"{name}/serial"] = dataclasses.replace(
                warmed[name], io_pipeline="off")
    if only:
        cases = {k: v for k, v in cases.items() if k in only}
        warmed = {k: v for k, v in warmed.items() if k in only}
    Simulator(base).run()  # the kernel's first load, untimed
    out = {}
    for name, cfg in cases.items():
        out[name] = [1e3 * Simulator(cfg).run()["avg_step_s"]
                     for _ in range(3)]
    for name, cfg in warmed.items():
        state = Simulator(cfg).state
        Simulator(cfg, state=state).run(steps=1)
        out[name] = [1e3 * Simulator(cfg, state=state).run()["avg_step_s"]
                     for _ in range(3)]
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--other", required=True)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--only", default="")
    p.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    only = [name for name in args.only.split(",") if name]
    if args.measure:
        print(json.dumps(measure(os.path.abspath(args.measure), only)),
              flush=True)
        return 0
    trees = {"other": os.path.abspath(args.other), "this": REPO}
    runs = {"other": [], "this": []}
    for _ in range(args.pairs):
        for side in ("other", "this"):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--other",
                 args.other, "--only", args.only, "--measure", trees[side]],
                capture_output=True, text=True, timeout=1200, cwd=REPO)
            if proc.returncode != 0:
                print(proc.stderr[-3000:], file=sys.stderr)
                return 1
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[side].append(line)
            print(json.dumps({"tree": side, **line}), flush=True)
    summary = {}
    for side, lines in runs.items():
        for name in lines[0]:
            if any(name not in line for line in lines):
                continue
            ms = [x for line in lines for x in line[name]]
            summary.setdefault(name, {})[side] = {
                "median": statistics.median(ms), "min": min(ms),
                "max": max(ms)}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
