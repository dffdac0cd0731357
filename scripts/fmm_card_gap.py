"""The dense FMM's fp32 gap between the card and the CPU, evaluation by
evaluation, on the 8,192-body disk of ``tests/test_torch_cuda.py::
test_fmm_on_the_card_matches_the_cpu`` (depth 5, leaf cap 16, G = 1,
eps 0.05).

    python3 scripts/fmm_card_gap.py [--other DIR] [--evals N]

For each tree (this one, and DIR, another tree's root, e.g. a parent
commit unpacked with ``git archive``) a process of its own evaluates the
FMM once on the CPU and N times on the card, and prints one JSON line an
evaluation: the median and largest relative gap |a_card - a_cpu| / |a_cpu|
over the bodies (the test's bar: median below 1e-5), and whether the card
gave the bits of its first evaluation. The trees run in turns (other,
this, this, other). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _disk(n, dtype, seed=3):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    r = rng.exponential(3.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    pos = np.stack([r * np.cos(phi), r * np.sin(phi),
                    0.3 * rng.normal(size=n)], axis=1)
    m = np.full(n, 5.0 / (n - 1))
    pos[0], m[0] = 0.0, 1.0
    return torch.from_numpy(pos).to(dtype), torch.from_numpy(m).to(dtype)


def worker(root: str, evals: int) -> None:
    sys.path.insert(0, root)
    import torch

    from gravity_tpu_torch.ops import fmm

    def fn(p, w):
        return fmm.fmm_accelerations(p, w, depth=5, leaf_cap=16, g=1.0,
                                     eps=0.05)

    pos, m = _disk(8192, torch.float32)
    want = fn(pos, m).double()
    first = None
    for i in range(evals):
        got = fn(pos.cuda(), m.cuda()).cpu().double()
        rel = (got - want).norm(dim=1) / want.norm(dim=1)
        first = got if first is None else first
        print(json.dumps({
            "tree": root, "eval": i, "median_rel": float(rel.median()),
            "max_rel": float(rel.max()), "bar_median": 1e-5,
            "same_bits_as_first": bool(torch.equal(got, first)),
            "cpu_abs_sum": float(want.abs().sum()),
            "device": torch.cuda.get_device_name(0)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another tree's root")
    ap.add_argument("--evals", type=int, default=4)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.evals)
        return 0
    roots = [REPO, REPO]
    if args.other:
        other = os.path.abspath(args.other)
        roots = [other, REPO, REPO, other]
    for root in roots:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", root, "--evals", str(args.evals)],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
