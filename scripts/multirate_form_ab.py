"""The multirate step functions of this tree and of another tree (a parent
commit unpacked with ``git archive``), in one process on one card: the same
state, the same force kernel (this tree's) and the same step sizes, so
that only the step's own host and device work differs.

    python3 scripts/multirate_form_ab.py --other DIR [--turns 8] [--block 50]

For ``baseline-16k``'s two-rung step and its 3-rung ladder, it first
requires one step of each form to give the same bits, then times turns of
``--block`` steps in the order other, this, this, other, ... (``--turns``
of each), between ``torch.cuda.synchronize`` fences. One JSON line a form
with each side's ms a step (median, min, max) and the card's name and
power limit. ``--device cpu --n N`` rehearses it on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402


def other_multirate(root: str):
    """The other tree's ``gravity_tpu_torch.ops.multirate``, imported as a
    package of another name so that both trees load side by side."""
    name = "other_gravity_tpu_torch"
    pkg = os.path.join(os.path.abspath(root), "gravity_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.ops.multirate")


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--other", required=True)
    p.add_argument("--turns", type=int, default=8)
    p.add_argument("--block", type=int, default=50)
    p.add_argument("--device", default=None)
    p.add_argument("--n", type=int, default=None)
    args = p.parse_args()

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.ops import multirate
    from gravity_tpu_torch.simulation import Simulator

    base = dataclasses.replace(PRESETS["baseline-16k"],
                               integrator="multirate")
    if args.n:
        base = dataclasses.replace(base, n=args.n)
    forms = {"other": other_multirate(args.other), "this": multirate}
    out = 0
    for case, rungs in (("two_rung", 2), ("ladder", 3)):
        sim = Simulator(dataclasses.replace(base, multirate_rungs=rungs),
                        device=args.device)
        k, capacities = sim._multirate_plan()
        state = sim.state
        acc = sim.accel(state.positions, state.masses)
        steps = {}
        for side, module in forms.items():
            if capacities is None:
                steps[side] = module.make_multirate_step_fn(
                    sim._kick, base.dt, k=k, n_sub=base.multirate_sub,
                    accel_full=sim.accel)
            else:
                steps[side] = module.make_rung_ladder_step_fn(
                    sim._kick, base.dt, capacities=capacities,
                    accel_full=sim.accel)
        one = {side: step(state, acc) for side, step in steps.items()}
        same = all(torch.equal(getattr(one["other"][0], f),
                               getattr(one["this"][0], f))
                   for f in ("positions", "velocities")) and torch.equal(
                       one["other"][1], one["this"][1])
        ms = {"other": [], "this": []}
        for side in ["other", "this", "this", "other"] * (args.turns // 2):
            s, a = state, acc
            sync(sim.device)
            t0 = time.perf_counter()
            for _ in range(args.block):
                s, a = steps[side](s, a)
            sync(sim.device)
            ms[side].append(1e3 * (time.perf_counter() - t0) / args.block)
        record = {"form": case, "n": state.n, "k": k,
                  "capacities": capacities, "block": args.block,
                  "bitwise_equal": same}
        for side, values in ms.items():
            record[side] = {"median": statistics.median(values),
                            "min": min(values), "max": max(values),
                            "ms": values}
        print(json.dumps(record), flush=True)
        out |= 0 if same else 1
    if torch.cuda.is_available() and args.device != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(json.dumps({"nvidia_smi": smi}), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
