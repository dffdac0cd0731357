"""Two builds of the bf16 segment sums on one card, on the same inputs:
this tree's ``gravity_tpu_torch`` and another tree's (a parent commit
unpacked with ``git archive``), each driving its own wrapper and kernel.

    python3 scripts/segment_sum_ab.py --other DIR

DIR is the other tree's root. The two trees need not share a C interface:
each runs in a process of its own (``--worker``) that imports that tree's
package, builds its ``csrc/`` and writes its outputs to a file. The inputs
are made once, here, by this tree's ``chip_smoke.segment_sum_check_cases``
(every sum ``chip_smoke.py``'s segment-sum phase holds to the plain
version: the sums of a bf16 octree build of the baseline-1m disk, the
README nlist state's cell totals, the edge cases) and the baseline-1m disk
rounded to bf16.

Each worker takes, in the order other, this, this, other: every case
through ``cells.segment_sum_bf16``; the level-0 and leaf-level
three-column sums timed by CUDA events (the whole call); one whole bf16
tree evaluation (``--tree-near nlist``, depth 7) and its time; one bf16
build (``tree.build_octree`` with quadrupoles) timed, its segment-sum
launches, and under the profiler the device time of the segment-sum
kernels and the device spans of the sums with their sort and gather glue
(``segment_sum.*`` ranges; the other tree's calls are wrapped in one
such range each); and the README nlist run at bf16 (100 steps) and its
multirate form (20 steps), ms a step on the host clock. Requires the
same bits from both trees in every case and in the tree evaluation (a
NaN may differ in its payload only), and the same bits from a tree's two
runs. One JSON line a case; the last line sums up. Exits non-zero if a
build or launch fails or the bits differ. Needs a CUDA device. Inputs
and outputs go to ``gravity_tpu_torch/build/segment_sum_ab/``
(git-ignored).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK_DIR = os.path.join(REPO, "gravity_tpu_torch", "build", "segment_sum_ab")
DEPTH = 7
TIMED = ("level 0 (1 cells) x 3", "level 7 (2097152 cells) x 3")
# The README nlist run at bf16 (chip_smoke.NLIST_RUN), host-bound, and
# its multirate form: steps a worker runs of each.
NLIST_STEPS = 100
NLIST_MULTIRATE_STEPS = 20


def cuda_ms(fn, reps: int) -> float:
    import torch

    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def worker(root: str, inputs: str, out: str) -> None:
    """One tree's run over the saved inputs, written to ``out``."""
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import gravity_tpu_torch
    from gravity_tpu_torch.config import PRESETS, SimulationConfig
    from gravity_tpu_torch.ops import cells, cuda_build, nlist, tree
    from gravity_tpu_torch.simulation import Simulator, _tree_kwargs

    package = os.path.realpath(os.path.dirname(gravity_tpu_torch.__file__))
    if not package.startswith(os.path.realpath(root) + os.sep):
        raise RuntimeError(f"imported {package}, not the tree at {root}")
    cuda_build.build_all([cells.LIBRARY, nlist.LIBRARY])
    dev = torch.device("cuda", 0)
    data = torch.load(inputs)
    result = {"cases": {}, "ms": {}}
    for name, values, ids, n in data["cases"]:
        v, i = values.to(dev), ids.to(dev)
        result["cases"][name] = cells.segment_sum_bf16(v, i, n).cpu()
        if name in TIMED:
            def call(v=v, i=i, n=n):
                cells.segment_sum_bf16(v, i, n)

            cuda_ms(call, 2)
            result["ms"][name] = cuda_ms(call, 10)
    pos, masses = (t.to(dev) for t in data["state"])
    config = dataclasses.replace(PRESETS["baseline-1m"], tree_near="nlist",
                                 dtype="bfloat16")
    kw = _tree_kwargs(config, DEPTH)
    result["tree_eval"] = tree.tree_accelerations(pos, masses, **kw).cpu()
    result["tree_eval_ms"] = cuda_ms(
        lambda: tree.tree_accelerations(pos, masses, **kw), 3)

    def build():
        tree.build_octree(pos, masses, DEPTH, quad=True)

    cuda_ms(build, 2)
    result["build_ms"] = cuda_ms(build, 5)
    if hasattr(tree, "segment_sum"):  # a tree whose build calls it per sum
        plain_call = tree.segment_sum

        def ranged(*args, **kwargs):
            with record_function("segment_sum.sum"):
                return plain_call(*args, **kwargs)

        tree.segment_sum = ranged
    before = cells.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        build()
        torch.cuda.synchronize()
    result["launches_per_build"] = cells.LAUNCHES - before
    kernels_ms, spans = 0.0, {}
    for item in prof.key_averages():
        if "CUDA" not in str(getattr(item, "device_type", "")):
            continue
        us = getattr(item, "device_time_total", None)
        ms = (us if us is not None else item.cuda_time_total) / 1e3
        if item.key.startswith("segment_sum."):
            spans[item.key] = ms
        elif "segment_sum" in item.key:
            kernels_ms += ms
    result["build_segment_sum_kernels_ms"] = kernels_ms
    result["build_segment_sum_spans_ms"] = spans
    for name, fields in data["runs"].items():
        sim = Simulator(SimulationConfig(**fields))
        with contextlib.redirect_stdout(io.StringIO()):
            result[name + "_ms_per_step"] = 1e3 * sim.run()["avg_step_s"]
    torch.save(result, out)


def same_bits(a, b) -> bool:
    """The same bits, NaN's payload aside."""
    import torch

    if a.shape != b.shape:
        return False
    a16 = a.contiguous().view(torch.int16)
    b16 = b.contiguous().view(torch.int16)
    nan = torch.isnan(a.float())
    return bool(torch.equal(nan, torch.isnan(b.float()))
                and torch.equal(a16[~nan], b16[~nan]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", help="root of the other tree")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    parser.add_argument("--inputs", help=argparse.SUPPRESS)
    parser.add_argument("--out", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        worker(args.worker, args.inputs, args.out)
        return 0
    if not args.other:
        parser.error("--other DIR is needed")
    import torch

    if not torch.cuda.is_available():
        print("segment_sum_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    print(cs.nvidia_smi("name,power.limit"), flush=True)
    os.makedirs(WORK_DIR, exist_ok=True)
    inputs = os.path.join(WORK_DIR, "inputs.pt")
    state = cs.tree_state().astype(torch.bfloat16)
    nlist_bf16 = {**cs.NLIST_RUN, "dtype": "bfloat16"}
    torch.save({"cases": [(name, v.cpu(), i.cpu(), n) for name, v, i, n
                          in cs.segment_sum_check_cases()],
                "state": (state.positions.cpu(), state.masses.cpu()),
                "runs": {"nlist_bf16": {**nlist_bf16, "steps": NLIST_STEPS},
                         "nlist_bf16_multirate": {
                             **nlist_bf16, "integrator": "multirate",
                             "steps": NLIST_MULTIRATE_STEPS}}},
               inputs)
    cs.tree_state.cache_clear()
    del state
    torch.cuda.empty_cache()
    runs = [("other", os.path.abspath(args.other)), ("this", REPO),
            ("this", REPO), ("other", os.path.abspath(args.other))]
    results = []
    for k, (label, root) in enumerate(runs):
        out = os.path.join(WORK_DIR, f"run{k}_{label}.pt")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", root, "--inputs", inputs, "--out", out],
                       check=True, timeout=900)
        results.append(torch.load(out))
    other, this = (results[0], results[3]), (results[1], results[2])
    faults = []
    for name in results[0]["cases"]:
        a, b = this[0]["cases"][name], other[0]["cases"][name]
        record = {"case": name, "same_bits_as_other": same_bits(a, b),
                  "this_repeatable": same_bits(a, this[1]["cases"][name]),
                  "other_repeatable": same_bits(b, other[1]["cases"][name])}
        if name in TIMED:
            record["ms_other_this_this_other"] = [r["ms"][name]
                                                  for r in results]
        if not all(v for k, v in record.items() if k != "case"
                   and not k.startswith("ms")):
            faults.append(name)
        cs.emit(record)
    tree_same = same_bits(this[0]["tree_eval"], other[0]["tree_eval"]) \
        and same_bits(this[0]["tree_eval"], this[1]["tree_eval"])
    if not tree_same:
        faults.append("tree evaluation")
    keys = ("tree_eval_ms", "build_ms", "launches_per_build",
            "build_segment_sum_kernels_ms", "build_segment_sum_spans_ms",
            "nlist_bf16_ms_per_step", "nlist_bf16_multirate_ms_per_step")
    cs.emit({"summary": {
        "same_bits": not faults, "faults": faults,
        "tree_eval_same_bits": tree_same,
        **{key + "_other_this_this_other": [r[key] for r in results]
           for key in keys},
        "nvidia_smi": cs.nvidia_smi("name,power.limit")}})
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
