"""Two builds of the direct-sum and cell-list kernels on one card, in one
process: this tree's ``gravity_tpu_torch/csrc`` and another tree's (a
parent commit unpacked with ``git archive``), on the same inputs.

    python3 scripts/kernel_ab.py --other DIR

DIR is the other tree's root; its ``nbody_direct.cu`` and
``nlist_pair.cu`` are built beside this tree's and bound to the C
functions both export (an older tree lacks the newer entries). The
wrappers of this tree launch either build (their
``LIBRARY`` handle is pointed at one or the other), so both take the same
arguments, scratch and launch plans.

For each bf16 launch of ``chip_smoke.py``'s bf16 phases (``nbody_direct``
at ``baseline-16k``'s state and README's flagship state, masked and
mask-free; ``nlist_pair`` at the README nlist state, a multirate kick's
t_cap, the ``baseline-1m`` leaf blocks and the count edges) it requires
both builds to give the same bits (``nbody_direct`` at one source-chunk
plan, since the plan follows each build's occupancy), and reports each
build's share of outputs with the plain version's bits under its own
plan. It times both by CUDA events in turns (other, this, this, other),
with the fp32 and fp64 forms the path runs (the cell list's ewald kind at
the README P3M disk and the uniform cube among them), reads both builds' SASS
instructions and conversions a pair (``chip_smoke.sass_loops``), and
times the bf16 steps that run through them (``baseline-16k`` at bf16
through ``pallas``, README's nlist run at bf16, each other, this, this,
other). One JSON line a case; the last line sums up. Exits non-zero if a
build or launch fails or the bits differ. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

NLIST_STEPS = 20
DIRECT_STEPS = 200


def other_library(lib, root: str):
    """A CudaLibrary of the same name, built from the other tree's source,
    bound to the C functions of this tree's that it names."""
    from gravity_tpu_torch.ops import cuda_build

    source = os.path.join(root, "gravity_tpu_torch", "csrc",
                          f"{lib.name}.cu")
    with open(source) as f:
        text = f.read()
    other = cuda_build.CudaLibrary(lib.name, {
        name: sig for name, sig in lib.signatures.items() if name in text})
    other.source = source
    return other


@contextlib.contextmanager
def using(lib, build):
    """Point the wrapper's library handle at ``build`` for the block."""
    from gravity_tpu_torch.ops import direct_kernel

    saved = lib._lib
    lib._lib = build._lib
    direct_kernel._slots.cache_clear()
    try:
        yield
    finally:
        lib._lib = saved
        direct_kernel._slots.cache_clear()


@contextlib.contextmanager
def fixed_chunks(chunks: int):
    from gravity_tpu_torch.ops import direct_kernel

    saved = direct_kernel.chunks_for
    direct_kernel.chunks_for = lambda *a, **k: chunks
    try:
        yield
    finally:
        direct_kernel.chunks_for = saved


def turns(builds, lib, fn, reps: int) -> dict:
    """ms of ``fn`` by CUDA events with each build, other, this, this,
    other (median of ``reps`` calls a turn, after a warm-up each)."""
    ms = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        with using(lib, builds[name]):
            cs.cuda_ms(fn, 2)
            ms[name].append(cs.cuda_ms(fn, reps))
    return {"ms_other": ms["other"], "ms_this": ms["this"],
            "this_over_other": min(ms["this"]) / min(ms["other"])}


def same_bits(a, b) -> float:
    return float((a == b).float().mean())


def direct_cases(dev):
    import torch

    from gravity_tpu_torch.config import PRESETS, SimulationConfig
    from gravity_tpu_torch.simulation import make_initial_state

    base16 = PRESETS["baseline-16k"]
    b16 = make_initial_state(dataclasses.replace(base16, dtype="bfloat16"),
                             dev)
    flag = make_initial_state(SimulationConfig(**cs.MXU_RUN), dev)
    b64 = flag.astype(torch.bfloat16)
    yield "baseline-16k bf16 mask-free", b16, base16.eps, 30
    yield "baseline-16k bf16 masked eps=0", b16, 0.0, 30
    yield "flagship N=65536 bf16 mask-free", b64, cs.MXU_RUN["eps"], 10


def check_direct(builds, dev) -> list:
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.ops import direct_kernel
    from gravity_tpu_torch.ops.forces import pairwise_accelerations_chunked

    lib = direct_kernel.LIBRARY
    out = []
    for name, state, eps, reps in direct_cases(dev):
        pos, m = state.positions, state.masses

        def fn(pos=pos, m=m, eps=eps):
            return direct_kernel.accelerations_vs_kernel(pos, pos, m,
                                                         eps=eps)

        plain = pairwise_accelerations_chunked(pos, m, eps=eps)
        plans, own = {}, {}
        for b in ("other", "this"):
            with using(lib, builds[b]):
                plans[b] = direct_kernel.chunks_for(
                    pos.shape[0], pos.shape[0], dtype=torch.bfloat16,
                    cutoff=CUTOFF_RADIUS, eps=eps)
                own[b] = fn()
                cs.check(torch.equal(own[b], fn()),
                         f"{name}: {b} build not repeatable")
        with fixed_chunks(plans["this"]):
            at = {}
            for b in ("other", "this"):
                with using(lib, builds[b]):
                    at[b] = fn()
        torch.cuda.synchronize()
        cs.check(torch.equal(at["other"], at["this"]),
                 f"{name}: the builds differ at S = {plans['this']}: "
                 f"{same_bits(at['other'], at['this'])} same")
        record = {"kernel": "nbody_direct_bf16", "case": name,
                  "n": pos.shape[0], "eps": eps, "source_chunks": plans,
                  "same_bits_as_other_at_one_plan": True,
                  "same_bits_as_plain": {b: same_bits(own[b], plain)
                                         for b in own},
                  **turns(builds, lib, fn, reps)}
        cs.emit(record)
        out.append(record)
    return out


def edge_args(dev):
    """chip_smoke.count_edge_cases' side-3 grids at bf16."""
    import torch

    gen = torch.Generator().manual_seed(19)
    n = 27
    c = torch.arange(n)
    corner = torch.stack([c // 9, (c // 3) % 3, c % 3], 1).float()
    for t_cap, cap in cs.EDGE_CAPS:
        choices = [0, 31, 32, 33, t_cap, t_cap + 5, cap, cap + 7, 1, 15, 16,
                   17]
        t_count = torch.tensor([choices[i % 12] for i in range(n)])
        s_count = torch.tensor([choices[(7 * i + 2) % 12] for i in range(n)])
        tpos = corner[:, None] + torch.rand(n, t_cap, 3, generator=gen)
        spos = corner[:, None] + torch.rand(n, cap, 3, generator=gen)
        gm = (0.5 + torch.rand(n, cap, generator=gen)) / 1000
        gm = torch.where(torch.arange(cap)[None] < s_count[:, None], gm, 0.0)
        params = torch.tensor([1.0, 1.0 / (math.sqrt(2.0) * 0.25)])
        args = [t.to(dev, torch.bfloat16) if t.is_floating_point()
                else t.to(dev) for t in (tpos, t_count, spos, gm, s_count)]
        yield (f"count edges t_cap={t_cap} cap={cap}",
               (*args, 3, params.to(dev, torch.bfloat16)))


def nlist_cases(dev):
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.ops import nlist
    from gravity_tpu_torch.simulation import (
        _occupancy_t_cap,
        make_initial_state,
    )

    config = cs.nlist_bf16_config()
    state = make_initial_state(config, dev)
    side, cap = nlist.resolve_nlist_sizing(state.positions, config.nlist_rcut)
    kw = dict(cutoff=CUTOFF_RADIUS, eps=config.eps)
    yield "README state bf16", cs.nlist_tiles(
        state.positions, state.masses, side, cap, config.nlist_rcut), kw, 30
    k = config.n // 8
    t_cap = _occupancy_t_cap(cap, k, config.n, state.positions, side,
                             "nlist bf16 kick")
    gen = torch.Generator().manual_seed(29)
    idx = torch.randperm(config.n, generator=gen)[:k].to(dev)
    yield f"README kick t_cap={t_cap} bf16", cs.nlist_kick_tiles(
        state.positions, state.masses, state.positions[idx], side, cap,
        t_cap, config.nlist_rcut), kw, 30
    del state
    tstate = cs.tree_state().astype(torch.bfloat16)
    depth = cs.tree_depth_of(tstate.positions)
    yield (f"baseline-1m leaf blocks depth {depth} bf16",
           cs.tree_tiles(tstate.positions, tstate.masses, depth),
           dict(cutoff=CUTOFF_RADIUS, eps=0.05, use_rcut=False), 20)
    for name, args in edge_args(dev):
        for use_rcut in (True, False):
            yield (f"{name} use_rcut={use_rcut}", args,
                   dict(cutoff=1e-10, eps=0.05, use_rcut=use_rcut), 0)


def check_nlist(builds, dev) -> list:
    import torch

    from gravity_tpu_torch.ops import nlist

    lib = nlist.LIBRARY
    out = []
    for name, args, kw, reps in nlist_cases(dev):
        def fn(args=args, kw=kw):
            return nlist.pair_cells_kernel(*args, **kw)

        got = {}
        for b in ("other", "this"):
            with using(lib, builds[b]):
                got[b] = fn()
                cs.check(torch.equal(got[b], fn()),
                         f"{name}: {b} build not repeatable")
        plain = nlist.pair_cells_plain(*args, **kw)
        torch.cuda.synchronize()
        t_cap = args[0].shape[1]
        real = (torch.arange(t_cap, device=dev)[None, :]
                < args[1].clamp_max(t_cap)[:, None])
        cs.check(torch.equal(got["other"], got["this"]),
                 f"{name}: the builds differ: "
                 f"{same_bits(got['other'], got['this'])} same")
        record = {"kernel": "nlist_pair_bf16", "case": name,
                  "same_bits_as_other": True,
                  "same_bits_as_plain": {
                      b: same_bits(got[b][real], plain[real]) for b in got}}
        if reps:
            record.update(turns(builds, lib, fn, reps))
        cs.emit(record)
        out.append(record)
    return out


def time_unchanged_forms(by_lib, dev) -> list:
    """The fp32 and fp64 forms the paths run, at their path's shapes."""
    import torch

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.constants import CUTOFF_RADIUS, G
    from gravity_tpu_torch.ops import direct_kernel, nlist
    from gravity_tpu_torch.simulation import make_initial_state

    ref = make_initial_state(PRESETS["reference-cuda"], dev)
    base16 = PRESETS["baseline-16k"]
    p16 = make_initial_state(base16, dev)
    p16d = p16.astype(torch.float64)
    config = dataclasses.replace(cs.nlist_bf16_config(), dtype="float32")
    nstate = make_initial_state(config, dev)
    side, cap = nlist.resolve_nlist_sizing(nstate.positions, config.nlist_rcut)
    n_args = cs.nlist_tiles(nstate.positions, nstate.masses, side, cap,
                            config.nlist_rcut)
    tstate = cs.tree_state()
    t_args = cs.tree_tiles(tstate.positions, tstate.masses,
                           cs.tree_depth_of(tstate.positions))
    ewald = {}
    for name, cfg, g in (("disk", cs.P3M_RUN, 1.0),
                         ("uniform", cs.P3M_UNIFORM, G)):
        state = cs.p3m_state(name)
        ewald[name] = (cs.p3m_tiles(state.positions, state.masses,
                                    grid=cfg["pm_grid"], cap=cfg["p3m_cap"],
                                    g=g),
                       dict(cutoff=CUTOFF_RADIUS, eps=cfg["eps"],
                            kind="ewald"))

    def direct(state, eps):
        return lambda: direct_kernel.accelerations_vs_kernel(
            state.positions, state.positions, state.masses, eps=eps)

    cases = [
        ("nbody_direct fp32 masked reference-cuda N=50000",
         direct_kernel.LIBRARY, direct(ref, 0.0), 30),
        ("nbody_direct fp32 mask-free baseline-16k", direct_kernel.LIBRARY,
         direct(p16, base16.eps), 30),
        ("nbody_direct fp64 mask-free baseline-16k", direct_kernel.LIBRARY,
         direct(p16d, base16.eps), 10),
        ("nlist_pair fp32 README state", nlist.LIBRARY,
         lambda: nlist.pair_cells_kernel(
             *n_args, cutoff=CUTOFF_RADIUS, eps=config.eps), 30),
        ("nlist_pair fp32 baseline-1m leaf blocks", nlist.LIBRARY,
         lambda: nlist.pair_cells_kernel(
             *t_args, cutoff=CUTOFF_RADIUS, eps=0.05, use_rcut=False), 20),
        *((f"nlist_pair fp32 ewald P3M {name}", nlist.LIBRARY,
           lambda a=args, k=kw: nlist.pair_cells_kernel(*a, **k), 20)
          for name, (args, kw) in ewald.items()),
    ]
    out = []
    for name, lib, fn, reps in cases:
        record = {"case": name, **turns(by_lib[lib.name], lib, fn, reps)}
        cs.emit(record)
        out.append(record)
    return out


def time_steps(by_lib) -> list:
    """ms a step of the bf16 runs through each build (Simulator stats)."""
    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.ops import direct_kernel, nlist
    from gravity_tpu_torch.simulation import Simulator

    runs = [
        ("baseline-16k bf16 pallas", direct_kernel.LIBRARY,
         dataclasses.replace(PRESETS["baseline-16k"], dtype="bfloat16",
                             steps=DIRECT_STEPS)),
        ("README nlist run bf16", nlist.LIBRARY,
         cs.nlist_bf16_config(steps=NLIST_STEPS)),
    ]
    out = []
    for name, lib, config in runs:
        ms = {"other": [], "this": []}
        for b in ("other", "this", "this", "other"):
            with using(lib, by_lib[lib.name][b]):
                stats = Simulator(config).run()
            ms[b].append(1e3 * stats["avg_step_s"])
        record = {"case": name, "steps": config.steps,
                  "ms_per_step_other": ms["other"],
                  "ms_per_step_this": ms["this"],
                  "this_over_other": min(ms["this"]) / min(ms["other"])}
        cs.emit(record)
        out.append(record)
    return out


LOOPS = {
    "nbody_direct": ("nbody_direct_kernel<fLi0ELb1>",
                     "nbody_direct_kernel<fLi2ELb1>",
                     "nbody_direct_kernel<bf16Li2ELb1>",
                     "nbody_direct_kernel<bf16Li0ELb1>",
                     "nbody_direct_kernel<bf16Li1ELb1>"),
    "nlist_pair": ("nlist_pair_kernel<fLi0ELb1ELb1>",
                   "nlist_pair_kernel<fLi0ELb0ELb1>",
                   "nlist_pair_kernel<bf16Li0ELb1ELb1>",
                   "nlist_pair_kernel<bf16Li0ELb0ELb1>",
                   "nlist_near_kernel<bf16Lb1>"),
}


def sass(builds_by_lib) -> dict:
    out = {}
    for lib_name, builds in builds_by_lib.items():
        for b, build in builds.items():
            loops = cs.sass_loops(build.info["path"])
            rec = {"sass": loops}
            for loop in LOOPS[lib_name]:
                out[f"{b} {loop}"] = {
                    "instrs_per_pair": cs.per_pair({lib_name: rec}, lib_name,
                                                   loop),
                    "cvt_per_pair": cs.per_pair({lib_name: rec}, lib_name,
                                                loop, "cvt"),
                    "loops": loops.get(loop)}
            out[f"{b} {lib_name} ptxas"] = [
                line for line in build.info["ptxas"].splitlines()
                if "registers" in line or "Compiling" in line]
    cs.emit({"sass": out})
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True,
                        help="root of the other tree (its csrc is built)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from gravity_tpu_torch.ops import cuda_build, direct_kernel, nlist

    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    others = {lib.name: other_library(lib, args.other)
              for lib in (direct_kernel.LIBRARY, nlist.LIBRARY)}
    cuda_build.build_all([direct_kernel.LIBRARY, nlist.LIBRARY,
                          *others.values()])
    by_lib = {name: {"other": others[name], "this": lib}
              for name, lib in (("nbody_direct", direct_kernel.LIBRARY),
                                ("nlist_pair", nlist.LIBRARY))}
    sass(by_lib)
    direct = check_direct(by_lib["nbody_direct"], dev)
    near = check_nlist(by_lib["nlist_pair"], dev)
    fixed = time_unchanged_forms(by_lib, dev)
    steps = time_steps(by_lib)
    cs.emit({"summary": {
        "bf16_same_bits_as_other": True,
        "direct": {r["case"]: r["this_over_other"] for r in direct},
        "nlist": {r["case"]: r.get("this_over_other") for r in near
                  if "this_over_other" in r},
        "unchanged_forms": {r["case"]: r["this_over_other"] for r in fixed},
        "steps": {r["case"]: r["this_over_other"] for r in steps},
        "nvidia_smi": cs.nvidia_smi("name,power.limit")}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
