#!/usr/bin/env python3
"""Smoke run of gravity_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the four CUDA kernel libraries and the host-native C++ direct sum
from the checkout (one nvcc each and one g++, all started together),
holds each kernel against its plain PyTorch version on the card (the cell-list kernel in both of its pair kinds and
untruncated, in fp32, fp64 and bf16, the direct sum in fp32, fp64 and
bf16, the bf16 segment sums bit for bit at an octree build's sums and
their edge cases), and drives each
kernel's path at full size through the Simulator, with every launch count
set to 0 just before the path and read just after:

- the reference direct-sum run (the ``reference-cuda`` preset: N = 50,000,
  500 Euler steps) through ``nbody_direct``, plus the package's other
  entry points;
- the cutoff-radius cell-list run (N = 262,144, leapfrog, rcut = 5e10 m,
  eps = 1e9 m, 500 steps) through ``nlist_pair``;
- the Gram-form direct sum (N = 65,536, leapfrog, eps = 1e9 m, 100 steps)
  through ``nbody_mxu``;
- the P3M run of README.md (the ``baseline-1m-p3m`` preset: a 1,048,576-
  body disk, grid 256, cap 64, leapfrog) with ``--p3m-short nlist``, cut
  to 25 of its 500 steps, through the ``ewald`` kind of ``nlist_pair``;
- the ``baseline-16k`` preset (a Plummer sphere, N = 16,384, leapfrog,
  eps = 1e9 m, 500 steps) through ``nbody_direct`` mask-free, with its
  energy drift;
- the ``baseline-2m`` preset (the merger, N = 2,097,152, G = 1, eps =
  0.05) cut to 1 step, through ``nbody_direct``, held to the plain
  version on 4,096 sampled targets;
- the sharded direct sums on a world of one (NCCL, this card):
  ``baseline-262k`` (allgather, 262,144 cold-collapse bodies, cut to 20
  steps) bit for bit against the same config unsharded, and through
  pallas-mxu (5 steps); ``baseline-2m-merger`` (the ring, cut to 1
  step), one force evaluation against the unsharded ``nbody_direct``
  evaluation, its ms a step beside ``baseline-2m``'s; a (1, 1)
  hierarchical ring on a 16,384-body state; each rectangular launch held
  to the plain version at 4,096 sampled rows and timed;
- ``baseline-16k`` at bf16, 500 steps through ``nbody_direct``'s bf16
  form and 500 through ``nbody_mxu``'s, each against fp32;
- the integration modes, whose multirate fast kicks launch each kernel
  at a rectangular shape: ``baseline-16k`` with ``--integrator
  multirate`` (500 two-rung steps, 100 on the 3-rung ladder), the
  star-cluster example at full width in fp64 (30 steps each of
  leapfrog, two rungs and the ladder, then adaptive multirate), the
  nlist run multirate (cut to 50 steps; ``nlist_pair`` at a ``t_cap``
  below the cap), the Gram-form run multirate (cut to 20 steps),
  ``baseline-16k --adaptive``, ``baseline-16k`` under an external
  Plummer halo, and merging on ``reference-cuda`` (the grid) and
  ``baseline-16k`` (the chunked scan), each cut to 100 steps; each fast
  kick shape held to its plain version;
- the octree: ``baseline-1m`` (the 1M disk, G = 1, leaf_cap 32, depth 7
  fit to the state) with ``--tree-near nlist``, cut to 2 of 500 steps,
  through ``nlist_pair``'s untruncated form (``nlist_pair/near``), its
  forces held to ``nbody_direct`` at 4,096 targets and to the gather
  near field on the same state (fp32 and fp64, each piece of the near
  field also taken out in turn to show the bars catch it); the preset's
  own gather near field (1 step, no kernel); and multirate (1 step);
- bf16 states through the cell list and the octree, through
  ``nlist_pair``'s bf16 form: the README cell-list run at ``--dtype
  bfloat16`` (cut to 100 steps; multirate cut to 20), its forces against
  fp32 nlist; ``baseline-1m --dtype bfloat16 --tree-near nlist`` (cut to
  2 steps; its gather near field and multirate, 1 each), its forces
  against the fp32 tree and ``nbody_direct`` (bar: 1.5x the JAX
  package's own bf16 figure) and the two near fields against each other;
- the fast multipole solvers, plain PyTorch (no kernel may launch on
  their paths): ``baseline-1m-fmm`` (the 1M disk, fmm_mode auto, which
  must resolve sparse: depth 9) cut to 1 step, its stages profiled, its
  forces against ``nbody_direct`` at 4,096 targets; the 1M uniform cube
  through the dense grid (1 step); sparse (both far modes) against
  dense on one overflow-free state; ``baseline-1m-fmm`` multirate (1
  step, kicks through the dense grid's rectangular form, one held to
  ``nbody_direct``); ``--debug-check`` on the preset through the CLI;
  ``baseline-1m-fmm`` at bf16 (3 steps, sparse, its cell totals
  through ``segment_sum.cu``), against the fp32 sparse FMM at 4,096
  targets (at least 2^-9 apart at the median), the port's
  bf16-against-fp32 error on the CPU test's disk and on the preset's disk
  cut to 4,096 bodies each within 1.5x of the JAX package's own there,
  either way;
- P3M's rectangular kernel and slice pass: the README P3M run
  with ``--integrator multirate`` (k = 512, cut to 10 steps), its kicks
  through the ``ewald`` kind at a ``t_cap`` below the cap, one kick's
  tiles held to the plain version; one ``--p3m-short slice`` evaluation
  of the README state against the cell-list pass;
- the periodic box and cosmology, plain PyTorch and ``torch.fft``
  (no kernel may launch on their paths): cosmo-262k (262,144 grf bodies
  in a box of 1e13 m, ``--force-backend pm --pm-grid 128``, leapfrog, 100
  steps; TSC 20), its mesh spans, its positions in the box, its mesh
  energy drift and its first evaluation against the port on the CPU in
  float64; the Ewald pair at grid 128; the isolated ``pm``: the
  point-mass probe at grid 64 and a 262,144-body disk against
  ``nbody_direct``; the ``cosmo`` verb at 2,097,152 bodies and grid 256
  (flat LCDM, 40 steps, with and without ``--li-check``), EdS and 2LPT
  at 262,144, a resume from step 20 against the uninterrupted run; the
  minimum-image cell list (grf at 262,144, rcut box/16, 5 steps)
  against the minimum-image oracle and a merge across a face; and the
  ``analyze`` verb (P(k), friends-of-friends, xi(r)) in a process of its
  own started before the octree phases, its P(k) held to the CPU port's;
- the ensemble serving path (PR 15): the batched launches of
  ``nbody_direct`` (fp32 masked and mask-free, fp64, bf16) and
  ``nbody_mxu`` (fp32, bf16) at 4 slots of bucket 8,192 (a padded
  5,000-body Plummer sphere, an 8,192-body cube, the padded solar system,
  an empty slot) against their plain versions and bit for bit against
  solo launches; the daemon (``serve --slots 4 --slice-steps 100``'s, in
  this process) serving 12 jobs of 100-500 steps at buckets 8,192, 4,096 and
  1,024 through the
  ``submit``, ``status``, ``result`` and ``cancel`` verbs, ``auto`` on a
  kernel at every bucket, one build a key, the batched launches equal to
  the batched force evaluations; and served runs in process bit for bit
  against solo runs of the bucket-padded states, a diverging job failing
  alone;
- served truncated physics: the batched launch of ``nlist_pair``
  (fp32, fp64, bf16) at 4 slots of bucket 8,192 of README's cell-list
  workload (rcut 5e10 m, side 12, cap 32; a padded 5,000-body job, two
  more, an empty slot) against its plain version, bit for bit against
  solo launches, and the whole batched cell list bit for bit against the
  slots' solo evaluations; 5 nlist jobs of 100-150 steps through the
  daemon (4 fp32 at
  bucket 8,192, one bf16) beside the 12, every key's first-round peak at
  most its admission estimate; served cell lists in process bit for bit
  against padded solo runs, and one nlist round's syncs and busy share;
- the measurement layer: ``bench.main()`` (``python -m
  gravity_tpu_torch.bench``) through ``nbody_direct``, ``nbody_mxu`` and
  ``nlist_pair`` at N = 262,144 (each rate held under 1.05x its kernel's
  rate alone), and plain ``auto`` through the autotuned router in a fresh
  tuning cache: ``baseline-1m`` and ``baseline-16k`` (``--tree-near
  nlist``: pallas, pallas-mxu, tree, fmm, sfmm) and the README cell-list
  run (nlist
  against the masked direct sum), each a miss that runs the argmin's
  kernel, then a hit; and ``tune --sizes 16384`` twice;
- the run loop's host side: ``baseline-16k`` (500 steps, trajectories, a
  checkpoint every 100, the ledger, the sentinel every 5 blocks) with
  the block pipeline on and off, their artifacts bit for bit the same,
  and PERF_BASELINE.json's ``host_gap_pipelined`` configuration;
  ``reference-cuda`` preempted at step 250 through the CLI verbs in this
  process (exit 75) and resumed bit for bit, also from the older snapshot
  when the
  newest is truncated, and the README cell-list run (cut to 100 steps)
  preempted and resumed, its gap reported; ``baseline-16k`` with
  ``--auto-recover`` healing ``diverge@300`` (exit 0) and without it
  exiting 2; ``bench --cadence`` on and off on the README cell list;
  ``baseline-1m --ledger`` (1 step, the card's large-N potential, the
  FMM's, timed against the tree's); the host syncs
  a step of each path; and on the main, nlist, Gram, P3M, multirate and
  merge paths the energy drift by the conservation ledger, outside the
  timed runs;
- the performance observatory (after the serve phases): the perf-ledger
  rows of the paths above (``reference-cuda``, ``baseline-16k``, the
  cell list, the Gram form, the octree, the sparse FMM), each with
  counted flops, bytes and an allocator peak, a direct sum's
  ``model_ratio`` in 0.8-3.0, beside its ms a step and its share of the
  card's fp32 peak, and ``reference-cuda`` counted against uncounted
  (``perf_ledger``); ``bench --gate`` on PERF_BASELINE.json (the five
  contracts the port runs, then every contract, the halo exchange
  reported violated, then a planted 2x handicap that must be caught;
  ``gate_path``); ``run --preset baseline-16k --steps 20 --profile`` and
  the daemon's ``POST /profile`` around a bucket-8,192 round, each trace
  holding the ``nbody_direct`` kernel once a counted launch
  (``profile_path``);
- the rest of the mesh layer, each on an NCCL world of one: the sharded
  FMM forms (``baseline-1m-fmm``'s sparse FMM and the 1M cube's dense one
  at depth 6, 1 step each, sharded and unsharded: the same bits, no
  kernel launch, the as-run ``k_eff`` read by ``--debug-check``); the
  gradient of sum((a / A)^2) through one evaluation of each sharded
  engine JAX differentiates through (``sharded_grad_path``: the dense
  FMM on ``baseline-1m-fmm``'s disk at 1,048,576 bodies, the sparse FMM
  at 262,144, the largest power of two whose graph fits, and the halo
  engine on the 262,144-body grf box), each against the unsharded VJP,
  no kernel launch; the isolated halo engine's and the mass scale's
  refusals;
  ``baseline-16k`` sharded for 200 steps, preempted at 100 and resumed
  sharded and solo to the uninterrupted bits, and ``--auto-recover``
  healing ``diverge@150``; the ``sharded-integrate`` job class through
  three daemons at once (the solo form of ``pallas``, ``pallas-mxu`` and
  the cell list at 16,384 bodies, a ``devices: 2`` job and a
  ``mesh_fail`` job walking the elastic ladder to it, a
  ``collective_stall`` job resuming from its progress snapshot), each
  result the solo run's bits, launches = force evaluations;
- the pod router (``router_path``): two workers of this process behind
  ``route`` as a process (started before the serve phases), seven jobs
  through the client verbs on ``pallas``, ``pallas-mxu`` and the cell list
  (affinity, sweep fan-out, a drained worker, a dense job past every
  worker's memory refused at the router), each routed integrate job the
  bits of its padded solo run, launches = evaluations over both workers,
  no compute context for the router's pid, ``fleet-status`` and a routed
  job's ``trace-export``; solo tracing (``trace_path``: ``reference-cuda``
  cut to 100 steps with and without ``--trace``, the same bits and host
  syncs, a divergence's flight-recorder dump); and the ``sweep`` verb
  (``sweep_verb_path``: sizes 10 to 1,000 at 500 steps, each the bits of
  its padded solo run);
- the tooling: ``validate --gpu`` (``validate_path``: its 17 records,
  ``nbody_direct.cu`` and ``nbody_mxu.cu`` launched, its two rate bars;
  a record that misses its JAX bar held to 1.5x the JAX package's own
  figure on the same state), ``traj info|stats|dump|export`` on a
  ``.gtrj`` written on the card and ``bench --report`` over this run's
  bench line (``tooling_path``), and the examples ``solar_system``,
  ``galaxy_merger``, ``star_cluster`` and ``gradient_orbit_fit --solo``
  at their test sizes (``examples_path``);
- the host-native C++ direct sum (``host_path``): ``run --device cpu
  --force-backend cpp`` on the random cube at N = 8,192 (leapfrog, 10
  steps) in float64 and float32, its library built by g++ beside the
  nvcc builds, one call an evaluation and no card kernel launched; the
  final state's forces at 4,096 sampled rows against ``nbody_direct`` on
  the card and the plain version on the CPU within the kernel-vs-plain
  bars; ``--force-backend cpp`` on the card refused with its ValueError;
  ms an evaluation and pairs/s beside the host CPU's model, CPUs and
  bound.

It then times each kernel at its path's shapes beside its bound (the
direct sum masked at N = 50,000, mask-free at N = 16,384 and 65,536, and
its bf16 form at both; the tree's near field at its 2,097,152 leaves,
and the same launch on an empty grid; the cell list's bf16 form at the
README state, a kick's t_cap and the leaf blocks; the bf16 segment sums
at the 1M disk's level 0 and leaf level, bound by their longest chain of
dependent adds at the SM clock sampled meanwhile) and beside
the issue floor of its inner loop's SASS instructions a pair. The
bf16 octree evaluation is profiled for its segment sums' share. Each phase
prints one JSON line (the ``done`` line carries ``wall_s``); the last two
lines are the kernels table and ``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result. It needs a CUDA device and the
package beside it, and imports nothing of JAX.
"""

from __future__ import annotations

import atexit
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Per-pair cost of the direct sum (the JAX cost model of the TPU kernel,
# gravity_tpu/ops/pallas_forces.py:143): ~20 flops and one rsqrt. The
# cell-list tile: 21 (pallas_nlist.py:381); the Gram form: 22
# (pallas_forces_mxu.py:238). Each pair also takes one rsqrt.
FLOPS_PER_PAIR = 20
NLIST_FLOPS_PER_PAIR = 21
MXU_FLOPS_PER_PAIR = 22
# The Gram form's 22 split by where csrc/nbody_mxu.cu runs them: the
# accumulation [S | W] += w [x_j | 1] (4 multiply-adds) on the tensor
# cores, the rest (norms, cross term, r^2, masks, weight) on the FP32 pipe.
MXU_TC_FLOPS_PER_PAIR = 8
MXU_FP32_FLOPS_PER_PAIR = MXU_FLOPS_PER_PAIR - MXU_TC_FLOPS_PER_PAIR
# H100 SXM published peaks: fp32 outside the tensor cores, the dense
# tensor-core rates (TF32 and bf16) and HBM3.
PEAK_FP32_FLOPS = 67e12
# fp64 outside the tensor cores (NVIDIA's H100 SXM data sheet): the rate
# of nbody_direct's fp64 form, which the star-cluster path runs.
PEAK_FP64_FLOPS = 34e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# bf16 outside the tensor cores: packed bf16x2 add, multiply and fma
# issue 256 results per SM per clock on compute capability 9.0 (the CUDA
# programming guide's arithmetic throughput table), twice fp32's 128.
PEAK_BF16X2_FLOPS = 2 * PEAK_FP32_FLOPS
# rsqrt issue rate of the special function units, per SM per clock.
SFU_PER_SM_PER_CLOCK = 16
# fp32-to-bf16 conversions, per SM per clock (the CUDA guide's "all other
# type conversions" on compute capability 9.0). The conversions a pair of
# each bf16 form are read off its SASS (:func:`sass_loops`).
CVT_PER_SM_PER_CLOCK = 16
# The bf16 forms compute in packed bf16x2 ops, which round without a
# conversion; r^2 and the rsqrt are rounded from fp32, one
# cvt.rn.bf16x2.f32 for two pairs each: 1 a pair, at most 2 with slack.
BF16X2_MAX_CVT = 2.0

# Tolerances of kernel vs plain version, in units of each row's sum of
# |terms| (the scale that a row's summation rounds at). The kernel sums
# each 256-source tile in order, adds the tile sums into one total for
# each of its S source chunks, and adds the S totals in order, so its
# worst-case rounding is ~(256 + K/(256 S) + S) ulp of that scale, S <=
# 64; the plain version's reduction rounds less. fp32: at most 451 + 64
# ulp = 3.1e-5 at K = 50,000, plus a few ulp per term from rsqrt; fp64:
# 515 ulp = 5.7e-14.
TOL = {"float32": 1e-4, "float64": 1e-12}
DIRECT_REASON = ("in units of the row's sum of |terms|: worst-case "
                 "rounding of the kernel's three-level sum is "
                 "~(256 + K/(256 S) + S) ulp, S <= 64 source chunks")
# The cell-list kernel forms r^2 and its masks with the same roundings as
# the plain version (so both take the same pairs) and sums each
# neighbor's tile row apart (over 32 / G source lanes, then added by a
# butterfly): ~(cap + 27) ulp of the row's sum of |terms|, 283 ulp =
# 3.4e-5 in fp32 at cap 256, plus a few ulp a term from rsqrt.
NLIST_REASON = ("in units of the row's sum of |terms|: same masks as the "
                "plain version; the kernel's per-neighbor row sums round "
                "at ~(cap + 27) ulp")
# The Gram kernel's output is [sum w x_j | sum w] before the epilogue.
# It selects the plain version's pairs and sums on the tensor cores: each
# 256-source tile in a fresh fragment (32 mma.sync steps of 8 sources, or
# 16 of 16 in bf16, whose internal adds need not round like FADD), the
# tile totals into a chunk total, the S chunk totals in order: ~(256/8 +
# K/(256 S) + S) ulp of sum |w| |x_j|, plus ~2^-21 a term from the TF32
# split of w (fp32 operands): at most ~(32 + 256 + 64) ulp = 4.2e-5.
MXU_REASON = ("in units of the row's sum of |w| |[x_j | 1]|: same masks "
              "as the plain version; tensor-core tile sums, tile and "
              "chunk totals round at ~(256/8 + K/(256 S) + S) ulp, S <= "
              "64, plus 2^-21 a term from the TF32 hi/lo split")

# The cell-list run of README.md (the JAX package's command): random cube,
# N = 262,144, leapfrog, --nlist-rcut 5e10 --eps 1e9, 500 steps.
NLIST_RUN = dict(model="random", n=262_144, integrator="leapfrog",
                 force_backend="nlist", nlist_rcut=5e10, eps=1e9, steps=500)
# The Gram-form run: README.md's flagship direct sum (N = 65,536,
# leapfrog, eps = 1e9) on the random model, through pallas-mxu.
MXU_RUN = dict(model="random", n=65_536, integrator="leapfrog",
               force_backend="pallas-mxu", eps=1e9, steps=100)
# The P3M run: README.md's command for the JAX package (the
# baseline-1m-p3m preset: a 1,048,576-body disk in galactic units, G = 1,
# dt 2e-3, eps 0.05, grid 256, cap 64, leapfrog) with --p3m-short nlist.
# Cut to 25 of its 500 steps, to make room for the periodic phases (50
# before the sharded-gradient phase came).
P3M_STEPS = 25
P3M_RUN = dict(model="disk", n=1_048_576, g=1.0, dt=2e-3, eps=0.05,
               integrator="leapfrog", force_backend="p3m", pm_grid=256,
               p3m_cap=64, p3m_short="nlist", steps=P3M_STEPS)
# A uniform state where the ewald kernel does real work: the random cube
# at N = 1,048,576 on the same grid and cap, eps 1e9 m (SI units), mean
# occupancy 7.9 a cell.
P3M_UNIFORM = dict(model="random", n=1_048_576, eps=1e9, force_backend="p3m",
                   pm_grid=256, p3m_cap=64, p3m_short="nlist")
# Operations of the ewald pair, read off csrc/nlist_pair.cu (the JAX cost
# model's 21 flops a pair, pallas_nlist.py:381, leaves out erf and exp).
# Every evaluated pair: 3 subtractions, r^2 (3 mul, 2 add), r^2 + eps^2,
# three compares and the three accumulating FMAs: 18 flops. A pair inside
# rcut adds the weight: sqrtf and the two IEEE divisions (~7 and ~10
# FP32 operations each, one MUFU each), rsqrtf (one MUFU), expf (~6 and
# one MUFU), erff (~22, a polynomial, and one MUFU), and ~14 multiplies,
# adds, min/max and compares: 69 flops and 6 SFU operations.
EWALD_BASE_FLOPS = 18
EWALD_RANGE_FLOPS = 69
EWALD_RANGE_SFU = 6
# The ewald weight's two terms almost cancel near rcut, and erff/expf
# differ from the plain version's erf/exp by an ulp or two, so its error
# is measured against the terms before they cancel: each row's sum of
# gm (|newt| + |corr|) |d| (pair_cells_plain(absolute=True)).
EWALD_REASON = ("in units of the row's sum of gm (|newt| + |corr|) |d|: "
                "same masks as the plain version; per-neighbor row sums "
                "round at ~(cap + 27) ulp and erff/expf differ by an ulp "
                "or two from the plain erf/exp")

# The bf16 form of nbody_direct against the plain version at bf16, in
# units of each row's sum of |terms|. Both round each op of a term to
# bf16 alike (the same fp32 op, rounded to nearest), so their terms are
# the same bits except where the three squares of r^2 add in another
# order and round r^2 the other way (1.5 x 2^-8 of that term, through
# r^-3/2 ... r^-3 w d: one bf16 ulp of r^2). Their fp32 sums differ by
# the fp32 bound (1e-4 of the scale) before each rounds its row to bf16
# once (2^-8, one ulp). Sum: under 3 x 2^-8.
BF16_TOL = 3 * 2.0**-8
BF16_REASON = ("in units of the row's sum of |terms|: terms rounded to "
               "bf16 op by op as the plain version (one r^2 may round the "
               "other way: 1.5 x 2^-8), fp32 sums that agree to 1e-4, each "
               "row rounded to bf16 once (2^-8): under 3 x 2^-8")
# The two single-card baselines of the JAX package, copied into the
# port's PRESETS: a Plummer sphere (N = 16,384, leapfrog, eps 1e9 m, 500
# steps) and the 2M merger (G = 1, eps 0.05), the latter cut to 1 step:
# validate_path's 2M record runs the same preset through the same kernel
# for 3 warm-up and 3 timed steps.
BASELINE_2M_STEPS = 1
# The 2M check: the path's own N x N evaluation against the plain
# version on this many sampled rows, each against all sources.
BASELINE_2M_SAMPLE = 4096
# The bf16 bar of tests/test_bfloat16.py: the median relative error of a
# bf16 force field against fp32.
BF16_MEDIAN_BAR = 1e-2
# At the preset's dt (3,600 s) a bf16 Plummer state barely moves: v dt is
# below half a bf16 ulp of |x| for almost every body. A run meant to show
# a bf16 state evolving takes dt past 2^-9 |x| / |v|: 1e6 s, 100 steps
# (about one crossing time of the sphere), beside fp32 at the same dt.
BF16_EVOLVE = dict(dt=1e6, steps=100)
BF16_MOVED_BAR = 0.5


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def check(cond: bool, message: str) -> None:
    if not cond:
        raise RuntimeError(message)


def nvidia_smi(query: str, *extra: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
         *extra],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Median ms of ``fn`` over ``reps`` calls, each timed with events."""
    import torch

    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def term_scale(pos_i, pos_j, masses_j, eps, chunk=1024, g=None):
    """Per-component sum over sources of |w_ij * d_ij|, in float64."""
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS, G
    from gravity_tpu_torch.ops.forces import _pair_weights

    g = G if g is None else g

    pos_i, pos_j, masses_j = (t.double() for t in (pos_i, pos_j, masses_j))
    rows = []
    for pi in torch.split(pos_i, chunk):
        diff = pos_j[None, :, :] - pi[:, None, :]
        w = _pair_weights((diff * diff).sum(-1), masses_j[None, :], g,
                          CUTOFF_RADIUS, eps)
        rows.append((w[:, :, None] * diff.abs()).sum(dim=1))
    return torch.cat(rows)


def reset_counts() -> None:
    from gravity_tpu_torch.ops import cells, direct_kernel, mxu_kernel, nlist

    for module in (cells, direct_kernel, mxu_kernel):
        module.LAUNCHES = 0
    direct_kernel.BATCHED_LAUNCHES = mxu_kernel.BATCHED_LAUNCHES = 0
    for kind in nlist.LAUNCHES:
        nlist.LAUNCHES[kind] = 0


def read_counts() -> dict:
    from gravity_tpu_torch.ops import cells, direct_kernel, mxu_kernel, nlist

    return {"nbody_direct": direct_kernel.LAUNCHES,
            "nlist_pair": nlist.LAUNCHES["newton"],
            "nlist_pair/ewald": nlist.LAUNCHES["ewald"],
            "nlist_pair/near": nlist.LAUNCHES["near"],
            "nlist_pair/bf16": nlist.LAUNCHES["newton_bf16"],
            "nlist_pair/near_bf16": nlist.LAUNCHES["near_bf16"],
            "nbody_mxu": mxu_kernel.LAUNCHES,
            "nbody_direct/batched": direct_kernel.BATCHED_LAUNCHES,
            "nbody_mxu/batched": mxu_kernel.BATCHED_LAUNCHES,
            "nlist_pair/batched": nlist.LAUNCHES["newton/batched"],
            "nlist_pair/batched_bf16": nlist.LAUNCHES["newton_bf16/batched"],
            "nlist_pair/slab": nlist.LAUNCHES["newton/slab"],
            "nlist_pair/slab_ewald": nlist.LAUNCHES["ewald/slab"],
            "nlist_pair/slab_bf16": nlist.LAUNCHES["newton_bf16/slab"],
            "segment_sum/bf16": cells.LAUNCHES}


def compare(name, kern, plain, scale, dtype_name, tol=None,
            reason=DIRECT_REASON) -> dict:
    """Kernel against plain version; raises past the stated tolerance."""
    import torch

    check(bool(torch.isfinite(kern).all()), f"{name}: kernel output not finite")
    diff = (kern.double() - plain.double()).abs()
    zero_scale = scale == 0
    check(bool((diff[zero_scale] == 0).all()),
          f"{name}: nonzero output where every term is zero")
    scaled = diff[~zero_scale] / scale[~zero_scale]
    max_scaled = float(scaled.max()) if scaled.numel() else 0.0
    norm = plain.double().norm(dim=1)
    rel = (diff.norm(dim=1) / norm)[norm > 0]
    tol = TOL[dtype_name] if tol is None else tol
    record = {
        "case": name, "dtype": dtype_name,
        "max_err_over_term_scale": max_scaled, "tolerance": tol,
        "tolerance_reason": reason,
        "max_rel_err": float(rel.max()) if rel.numel() else 0.0,
        "p99_rel_err": (float(torch.quantile(rel, 0.99))
                        if rel.numel() else 0.0),
        "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
    }
    check(max_scaled <= tol,
          f"{name}: error {max_scaled:.3e} of the term scale > {tol:.0e}")
    return record


def phase_device() -> dict:
    import torch

    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    props = torch.cuda.get_device_properties(0)
    record = {
        "phase": "device", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "nvidia_smi": smi,
        "sm_count": props.multi_processor_count,
        "max_sm_clock_mhz": float(
            nvidia_smi("clocks.max.sm", "--format=csv,noheader,nounits")
        ),
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }
    emit(record)
    return record


def sass_loops(path: str) -> dict:
    """The innermost loops of each float32 (and bf16) kernel in a built
    library, read off ``cuobjdump -sass``: for each, its instructions and
    how many are MUFU (rsqrt and the other special functions), LDS
    (shared-memory loads), HMMA (tensor-core products), conversions to a
    narrower float (F2FP, F2F) and packed half-precision ops (HADD2,
    HMUL2, HFMA2) and global loads (LDG). The pair loops of the direct
    sums and of the newton kind take one MUFU.RSQ a pair, so instructions
    / MUFU is their issued instructions a pair, and conversions / MUFU
    their conversions a pair; a segment-sum loop adds one row a bf16 add
    (HADD2 or HFMA2). Keys name the kernel and its template arguments as
    mangled, ``f`` for float and ``bf16`` for __nv_bfloat16
    (``nbody_mxu_kernel<fLb0ELb1>``: float, no cutoff test, ftz rsqrt),
    or the kernel alone where it has none (``segment_sum_long_kernel``)."""
    import re

    from gravity_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {"not measured": f"{tool} not found"}
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and name:
            funcs[name].append((int(m.group(1), 16), m.group(2).strip()))
    out = {}
    for name, ins in funcs.items():
        kernel = re.search(r"([a-z_]+_kernel)I((?:f|13__nv_bfloat16)\w*?)"
                           r"EEEv", name)
        plain = re.search(r"\d(segment_sum_[a-z]+_kernel)E", name)
        if kernel is None and plain is None:
            continue
        ops = [(a, (i.split()[1] if i.startswith("@") else i.split()[0])
                .split(".")[0]) for a, i in ins]
        spans = []
        for a, i in ins:
            target = re.search(r"BRA.*?0x([0-9a-f]+)", i)
            if target and int(target.group(1), 16) < a:
                spans.append((int(target.group(1), 16), a))
        loops = []
        for lo, hi in spans:
            if any(lo < lo2 and hi2 <= hi for lo2, hi2 in spans
                   if (lo2, hi2) != (lo, hi)):
                continue  # holds another loop: not innermost
            body = [o for a, o in ops if lo <= a <= hi]
            loops.append({"instrs": len(body), "mufu": body.count("MUFU"),
                          "lds": body.count("LDS"),
                          "hmma": body.count("HMMA"),
                          "cvt": body.count("F2FP") + body.count("F2F"),
                          "hadd2": body.count("HADD2"),
                          "hmul2": body.count("HMUL2"),
                          "hfma2": body.count("HFMA2"),
                          "ldg": body.count("LDG")})
        if kernel is None:
            out[plain.group(1)] = loops
            continue
        args = kernel.group(2).replace("13__nv_bfloat16", "bf16")
        out[f"{kernel.group(1)}<{args}>"] = loops
    return out


def per_pair(build: dict, lib: str, kernel: str, what: str = "instrs"):
    """Issued instructions a pair of the innermost rsqrt loop of
    ``kernel`` (a key of :func:`sass_loops`), or of one kind of them
    (``what``: "cvt" for the conversions), or "not measured"."""
    loops = [x for x in build[lib]["sass"].get(kernel, []) if x["mufu"]]
    if not loops:
        return "not measured"
    best = min(loops, key=lambda x: x["instrs"])
    return best[what] / best["mufu"]


def issue_floor_ms(pairs, instrs_per_pair, device):
    """Least time to issue ``pairs`` x ``instrs_per_pair`` thread
    instructions: an SM issues 4 warp instructions (128 thread
    instructions) a clock, at the card's top SM clock."""
    if not isinstance(instrs_per_pair, float):
        return "not measured"
    rate = device["sm_count"] * 128 * device["max_sm_clock_mhz"] * 1e6
    return 1e3 * pairs * instrs_per_pair / rate


def phase_build() -> dict:
    """All five libraries, one compiler each, started together: the four
    CUDA libraries with nvcc and the host-native C++ direct sum with g++
    (its seconds are host_path's build figure)."""
    from gravity_tpu_torch.ops import (
        cells,
        cuda_build,
        direct_kernel,
        host_kernel,
        mxu_kernel,
        nlist,
    )

    t0 = time.perf_counter()
    libraries = (direct_kernel.LIBRARY, nlist.LIBRARY, mxu_kernel.LIBRARY,
                 cells.LIBRARY)
    cuda_build.build_all((*libraries, host_kernel.LIBRARY))
    check(host_kernel.host_forces_available(),
          "the host-native C++ direct sum did not load")
    total = time.perf_counter() - t0
    records = {}
    for lib in libraries:
        records[lib.name] = {
            "phase": "build",
            "source": f"gravity_tpu_torch/csrc/{lib.name}.cu",
            "nvcc_s": lib.info["seconds"], "total_s": total,
            "ptxas": [line for line in lib.info["ptxas"].splitlines()
                      if "registers" in line or "Compiling" in line
                      or "smem" in line or "spill" in line],
            "sass": sass_loops(lib.info["path"]),
        }
        emit(records[lib.name])
    records["host_forces"] = {
        "phase": "build", "source": "gravity_tpu_torch/csrc/host_forces.cpp",
        "gxx_s": host_kernel.BUILD_INFO["seconds"], "total_s": total,
        "flags": list(host_kernel.LIBRARY.FLAGS)}
    emit(records["host_forces"])
    return records


def phase_kernel_vs_plain() -> float:
    """Every case of the kernel against the plain version; returns the
    max abs error at the main path's shape (N = 50,000, fp32)."""
    import torch

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.models import generate_random_particles
    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel
    from gravity_tpu_torch.ops.forces import (
        accelerations_vs,
        pairwise_accelerations_chunked,
    )
    from gravity_tpu_torch.simulation import make_initial_state

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(7)
    # The last five reach the split of the sources: M << K (many chunks),
    # K << M with K shorter than one tile, M and K past a multiple of the
    # block and the tile, one tile exactly, and a grid of targets that
    # keeps one chunk.
    for (m, k) in ((64, 64), (1000, 1000), (100, 384), (7, 20_000),
                   (5_000, 3), (1_001, 4_099), (257, 256), (40_000, 600)):
        base = generate_random_particles(gen, max(m, k), dtype=torch.float64,
                                         device=dev)
        for dtype in (torch.float32, torch.float64):
            pos_j = base.positions[:k].to(dtype).contiguous()
            m_j = base.masses[:k].to(dtype).contiguous()
            pos_i = base.positions[:m].to(dtype).contiguous()
            for eps in (0.0, 1e9):
                kern = accelerations_vs_kernel(pos_i, pos_j, m_j, eps=eps)
                plain = accelerations_vs(pos_i, pos_j, m_j, eps=eps)
                torch.cuda.synchronize()
                emit({"phase": "kernel_vs_plain", **compare(
                    f"{m}x{k} eps={eps:g}", kern, plain,
                    term_scale(pos_i, pos_j, m_j, eps),
                    str(dtype).removeprefix("torch."),
                ), "source_chunks": direct_chunks(m, k, dtype, eps)})

    # 16 coincident 1e30 kg bodies: every pair is below the cutoff.
    pos = torch.zeros(16, 3, device=dev)
    masses = torch.full((16,), 1e30, device=dev)
    acc = accelerations_vs_kernel(pos, pos, masses)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(acc).all()) and bool((acc == 0).all()),
          "coincident bodies: output must be all zero with no NaN")
    emit({"phase": "kernel_vs_plain", "case": "16 coincident 1e30 kg",
          "all_zero": True, "tolerance": "exact"})

    # Two bodies 1e13 m apart in fp32. The 1e5 kg body's weight on the
    # other is G m / r^3 = 6.7e-45, a subnormal (~5 x 2^-149): a build
    # that flushes subnormals returns 0 there. Tolerance: 1e-5 for the
    # normal side, 25% for the subnormal side (its precision is ~1/5).
    pos = torch.tensor([[0.0, 0.0, 0.0], [1e13, 0.0, 0.0]], device=dev)
    masses = torch.tensor([1e24, 1e5], device=dev)
    acc = accelerations_vs_kernel(pos, pos, masses).double().cpu()
    torch.cuda.synchronize()
    g = 6.67430e-11
    want = torch.tensor([g * 1e5 / 1e26, -g * 1e24 / 1e26],
                        dtype=torch.float64)
    rel = ((acc[:, 0] - want) / want).abs()
    check(bool((acc[:, 0] != 0).all()),
          "1e13 m pair: fp32 force flushed to zero (subnormal lost)")
    check(float(rel[1]) < 1e-5 and float(rel[0]) < 0.25,
          f"1e13 m pair: relative errors {rel.tolist()}")
    emit({"phase": "kernel_vs_plain", "case": "2 bodies 1e13 m fp32",
          "acc_x": acc[:, 0].tolist(), "rel_err_vs_fp64": rel.tolist(),
          "tolerance": [0.25, 1e-5]})

    # The main path's shape: the full reference-cuda random cube; run
    # twice, the kernel must give the same bits (its chunk sums are added
    # in a fixed order, with no atomics).
    state = make_initial_state(PRESETS["reference-cuda"], dev)
    kern = accelerations_vs_kernel(state.positions, state.positions,
                                   state.masses)
    again = accelerations_vs_kernel(state.positions, state.positions,
                                    state.masses)
    plain = pairwise_accelerations_chunked(state.positions, state.masses)
    torch.cuda.synchronize()
    check(torch.equal(kern, again), "nbody_direct: two runs differ")
    record = compare("reference-cuda N=50000", kern, plain,
                     term_scale(state.positions, state.positions,
                                state.masses, 0.0), "float32")
    emit({"phase": "kernel_vs_plain", **record, "bitwise_repeatable": True,
          "source_chunks": direct_chunks(state.n, state.n, torch.float32,
                                         0.0)})

    # The baseline-16k path's shape and state: a Plummer sphere, N =
    # 16,384, mask-free (eps 1e9 m); the same bits on a second launch.
    config = PRESETS["baseline-16k"]
    p16 = make_initial_state(config, dev)
    pos, masses = p16.positions, p16.masses
    kern16 = accelerations_vs_kernel(pos, pos, masses, g=config.g,
                                     eps=config.eps)
    again16 = accelerations_vs_kernel(pos, pos, masses, g=config.g,
                                      eps=config.eps)
    plain16 = pairwise_accelerations_chunked(pos, masses, g=config.g,
                                             eps=config.eps)
    torch.cuda.synchronize()
    check(torch.equal(kern16, again16), "nbody_direct baseline-16k: two "
          "runs differ")
    emit({"phase": "kernel_vs_plain", **compare(
        "baseline-16k N=16384", kern16, plain16,
        term_scale(pos, pos, masses, config.eps, g=config.g), "float32"),
        "bitwise_repeatable": True,
        "source_chunks": direct_chunks(p16.n, p16.n, torch.float32,
                                       config.eps)})
    return record["max_abs_err"]


def direct_chunks(m: int, k: int, dtype, eps: float) -> int:
    """The source chunks S that ``accelerations_vs_kernel`` takes for an
    (M, K) call on this card, as its wrapper plans them."""
    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.ops import direct_kernel

    return direct_kernel.chunks_for(m, k, dtype=dtype, cutoff=CUTOFF_RADIUS,
                                    eps=eps)


def phase_main_path() -> dict:
    """The reference-cuda run through the Simulator, counting launches."""
    import torch

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.simulation import Simulator
    from gravity_tpu_torch.utils.logging import RunLogger

    config = PRESETS["reference-cuda"]
    sim = Simulator(config)
    s0 = ledger_start(sim)
    log_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(log_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=log_root) as log_dir:
        logger = RunLogger(log_dir, quiet=True)
        reset_counts()
        stats = sim.run(logger)
        launches = read_counts()["nbody_direct"]
        with open(logger.path) as f:
            log = f.read()
    final = stats["final_state"]
    check(sim.backend == "nbody_direct", f"backend {sim.backend}")
    check(launches >= config.steps,
          f"{launches} kernel launches for {config.steps} steps")
    check(tuple(final.positions.shape) == (config.n, 3), "final shape")
    check(bool(torch.isfinite(final.positions).all()
               & torch.isfinite(final.velocities).all()),
          "final state not finite")
    for section in ("gravity simulation at", f"Step {config.steps}/",
                    "Performance Statistics:", "Final positions:",
                    "Simulation completed successfully"):
        check(section in log, f"log lacks {section!r}")
    record = {
        "phase": "main_path", "preset": "reference-cuda", "n": config.n,
        "steps": config.steps, "integrator": config.integrator,
        "launches": launches, "total_s": stats["total_time_s"],
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "pairs_per_s": stats["pairs_per_sec"], "device": stats["device"],
        "host_gap_frac": stats["host_gap_frac"], "perf": stats["perf"],
        **ledger_energy_drift(sim, s0, final),
        # The ledger prices this N's potential with the octree; the exact
        # pair scan in fp64 beside it.
        "energy_drift_fp64_pair_scan": energy_drift_f64(s0, final, config),
    }
    emit(record)
    return record


def phase_small_reference() -> None:
    """A small fp64 run on the card against the same run on the CPU's
    plain version: 8 bodies, 20 Euler steps. Tolerance 1e-12 relative:
    the two differ only in summation order and rsqrt rounding."""
    import dataclasses

    import torch

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.simulation import Simulator

    config = dataclasses.replace(PRESETS["reference-mpi"], steps=20,
                                 dtype="float64")
    gpu = Simulator(config).run()["final_state"]
    cpu = Simulator(config, device="cpu").run()["final_state"]
    err = float(((gpu.positions.cpu() - cpu.positions).norm(dim=1)
                 / cpu.positions.norm(dim=1)).max())
    check(err < 1e-12, f"small fp64 run: card vs CPU rel err {err:.3e}")
    emit({"phase": "small_reference", "preset": "reference-mpi",
          "steps": 20, "dtype": "float64", "max_rel_err_vs_cpu": err,
          "tolerance": 1e-12})


def phase_other_entry_points() -> None:
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.simulation import Simulator
    from gravity_tpu_torch.utils.trajectory import TrajectoryReader

    # The CLI on the card, with trajectories (run_cli).
    log_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(log_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=log_root) as log_dir:
        proc = run_cli(["run", "--preset", "reference-spark", "--steps",
                        "100", "--trajectories", "--log-dir", log_dir])
        check(proc.returncode == 0,
              f"CLI run failed ({proc.returncode}): {proc.stderr[-2000:]}")
        stats = json.loads(proc.stdout.strip().splitlines()[-1])
        frames = TrajectoryReader(stats["trajectory_dir"]).load(mmap=False)
    # reference-spark is plain auto: the router measures nbody_direct
    # against nbody_mxu (a miss in this run's fresh tuning cache) and the
    # run goes through the winner's kernel
    check(stats["backend"] in ("nbody_direct", "nbody_mxu")
          and stats["autotune_cache"] == "miss"
          and stats["kernel_launches"] >= 100,
          f"CLI run did not go through the kernel: {stats}")
    check(frames.shape == (100, 1000, 3) and bool(
        torch.isfinite(torch.from_numpy(frames)).all()),
          f"trajectories: shape {frames.shape}")
    emit({"phase": "cli_reference_spark", "steps": 100,
          "backend": stats["backend"],
          "autotune_probe_ms": stats["autotune_probe_ms"],
          "launches": stats["kernel_launches"],
          "total_s": stats["total_time_s"],
          "trajectory_frames": frames.shape[0]})

    # Softened leapfrog: the mask-free specialization on the main path
    # (direct: the static route, which plain auto would now measure).
    config = SimulationConfig(model="random", n=16384, eps=1e9,
                              integrator="leapfrog", steps=50,
                              force_backend="direct")
    sim = Simulator(config)
    reset_counts()
    stats = sim.run()
    launches = read_counts()["nbody_direct"]
    final = stats["final_state"]
    check(launches >= config.steps,
          f"leapfrog: {launches} launches for {config.steps} steps")
    check(bool(torch.isfinite(final.positions).all()),
          "leapfrog: final state not finite")
    emit({"phase": "leapfrog_softened", "n": config.n, "eps": config.eps,
          "steps": config.steps, "launches": launches,
          "ms_per_step": 1e3 * stats["avg_step_s"]})


def phase_timing(device: dict, build: dict) -> dict:
    """Kernel and plain version at the main path's shape (masked, N =
    50,000), the kernel mask-free at README's flagship shape (N = 65,536,
    eps = 1e9 m) and at baseline-16k's (N = 16,384), and the bf16 form
    with its plain version at baseline-16k's and the flagship's shapes,
    each beside its bound: the larger of the bytes
    over HBM bandwidth and the operations over their peak rate (fp32
    flops, bf16x2 for the bf16 form; rsqrt on the special function units
    at 16 per SM per clock);
    and beside the issue floor of its inner loop's instructions a pair
    (read off the SASS, :func:`sass_loops`)."""
    import torch

    from gravity_tpu_torch.config import PRESETS, SimulationConfig
    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel
    from gravity_tpu_torch.ops.forces import pairwise_accelerations_chunked
    from gravity_tpu_torch.simulation import make_initial_state

    dev = torch.device("cuda", 0)
    state = make_initial_state(PRESETS["reference-cuda"], dev)
    pos, masses = state.positions, state.masses
    n = pos.shape[0]
    flagship = make_initial_state(SimulationConfig(**MXU_RUN), dev)
    eps_f = MXU_RUN["eps"]

    def kernel():
        accelerations_vs_kernel(pos, pos, masses)

    def plain():
        pairwise_accelerations_chunked(pos, masses)

    def mask_free():
        accelerations_vs_kernel(flagship.positions, flagship.positions,
                                flagship.masses, eps=eps_f)

    cuda_ms(kernel, 3)
    ms = cuda_ms(kernel, 30)
    cuda_ms(plain, 1)
    plain_ms = cuda_ms(plain, 5)
    ms_again = cuda_ms(kernel, 30)
    cuda_ms(mask_free, 3)
    free_ms = [cuda_ms(mask_free, 30), cuda_ms(mask_free, 30)]

    # The baseline-16k state (mask-free, eps 1e9 m) in fp32, its path, and
    # in bf16 with README's flagship state at bf16: the bf16 form.
    base16 = PRESETS["baseline-16k"]
    p16 = make_initial_state(base16, dev)
    b16 = make_initial_state(dataclasses.replace(base16, dtype="bfloat16"),
                             dev)
    b64 = flagship.astype(torch.bfloat16)

    def fp32_16k():
        accelerations_vs_kernel(p16.positions, p16.positions, p16.masses,
                                eps=base16.eps)

    def bf16_16k():
        accelerations_vs_kernel(b16.positions, b16.positions, b16.masses,
                                eps=base16.eps)

    def bf16_64k():
        accelerations_vs_kernel(b64.positions, b64.positions, b64.masses,
                                eps=eps_f)

    def bf16_plain():
        pairwise_accelerations_chunked(b16.positions, b16.masses,
                                       eps=base16.eps)

    cuda_ms(fp32_16k, 3)
    ms_16k = [cuda_ms(fp32_16k, 30), cuda_ms(fp32_16k, 30)]
    cuda_ms(bf16_16k, 3)
    bf16_ms = [cuda_ms(bf16_16k, 30), cuda_ms(bf16_16k, 30)]
    cuda_ms(bf16_64k, 2)
    bf16_64k_ms = [cuda_ms(bf16_64k, 10), cuda_ms(bf16_64k, 10)]
    cuda_ms(bf16_plain, 1)
    bf16_plain_ms = cuda_ms(bf16_plain, 3)

    def bounds(n_bodies, loop, item=4):
        # Each input read once (positions, masses), the output written
        # once, at ``item`` bytes an element.
        n_bytes = (n_bodies * 3 + n_bodies + n_bodies * 3) * item
        record = bound(n_bodies * n_bodies, FLOPS_PER_PAIR, n_bytes, device,
                       PEAK_BF16X2_FLOPS if item == 2 else PEAK_FP32_FLOPS)
        instrs = per_pair(build, "nbody_direct", loop)
        record.update({"sass_instrs_per_pair": instrs,
                       "issue_floor_ms": issue_floor_ms(n_bodies**2, instrs,
                                                        device)})
        if item == 2:
            cvt = per_pair(build, "nbody_direct", loop, "cvt")
            check(not isinstance(cvt, float) or cvt <= BF16X2_MAX_CVT,
                  f"{loop}: {cvt} conversions a pair")
            record.update({"conversions_per_pair": cvt,
                           "conversion_floor_ms": conversion_floor_ms(
                               n_bodies**2, cvt, device)})
        return record

    record = {
        "phase": "timing", "n": n, "dtype": "float32", "ms": ms,
        "ms_repeat": ms_again, "plain_ms": plain_ms,
        **bounds(n, "nbody_direct_kernel<fLi0ELb1>"),
        "source_chunks": direct_chunks(n, n, torch.float32, 0.0),
        "library_ms": None,
        "library_note": "no single PyTorch call computes this sum",
        "mask_free": {
            "n": flagship.n, "eps": eps_f, "ms": free_ms,
            "source_chunks": direct_chunks(flagship.n, flagship.n,
                                           torch.float32, eps_f),
            **bounds(flagship.n, "nbody_direct_kernel<fLi2ELb1>"),
        },
        "baseline16k": {
            "n": p16.n, "eps": base16.eps, "ms": ms_16k,
            "source_chunks": direct_chunks(p16.n, p16.n, torch.float32,
                                           base16.eps),
            **bounds(p16.n, "nbody_direct_kernel<fLi2ELb1>"),
        },
        # The bf16 form's bound takes the pair's 20 flops at the card's
        # bf16 rate outside the tensor cores (bf16x2, twice fp32's), its
        # bytes at 2 each; the SFU's rsqrt then binds.
        "bf16": {
            "n": b16.n, "eps": base16.eps, "ms": bf16_ms[0],
            "ms_repeat": bf16_ms[1], "plain_ms": bf16_plain_ms,
            "bound_pipe": "bf16x2 on the CUDA cores (256 results per SM "
                          "per clock) and rsqrt on the SFUs",
            "source_chunks": direct_chunks(b16.n, b16.n, torch.bfloat16,
                                           base16.eps),
            **bounds(b16.n, "nbody_direct_kernel<bf16Li2ELb1>", item=2),
            "library_ms": None,
            "library_note": "no single PyTorch call computes this sum",
            "n65536": {
                "n": b64.n, "eps": eps_f, "ms": bf16_64k_ms,
                "source_chunks": direct_chunks(b64.n, b64.n, torch.bfloat16,
                                               eps_f),
                **bounds(b64.n, "nbody_direct_kernel<bf16Li2ELb1>", item=2),
            },
        },
        "nvidia_smi": device["nvidia_smi"],
    }
    record["share_of_bound"] = record["bound_ms"] / ms
    for sub, sub_ms in ((record["mask_free"], free_ms[0]),
                        (record["baseline16k"], ms_16k[0]),
                        (record["bf16"], bf16_ms[0]),
                        (record["bf16"]["n65536"], bf16_64k_ms[0])):
        sub["share_of_bound"] = sub["bound_ms"] / sub_ms
    emit(record)
    return record


def nlist_tiles(positions, masses, side, cap, rcut):
    """The pair-tile kernel's arguments for the self form at a state, as
    ``nlist_accelerations_vs`` builds them."""
    from gravity_tpu_torch.constants import G
    from gravity_tpu_torch.ops import nlist

    _, _, params, _, binned = nlist.source_cells(
        positions, masses, rcut=rcut, side=side, cap=cap)
    cells_pos, cells_mass, count = binned[:3]
    return (cells_pos, count, cells_pos, cells_mass * G, count, side, params)


def nlist_compare(name, positions, masses, side, cap, rcut, eps) -> dict:
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.ops import nlist

    args = nlist_tiles(positions, masses, side, cap, rcut)
    kw = dict(cutoff=CUTOFF_RADIUS, eps=eps)
    kern = nlist.pair_cells_kernel(*args, **kw)
    plain = nlist.pair_cells_plain(*args, **kw)
    scale = nlist.pair_cells_plain(*args, absolute=True, **kw)
    torch.cuda.synchronize()
    dtype_name = str(positions.dtype).removeprefix("torch.")
    record = compare(name, kern.reshape(-1, 3), plain.reshape(-1, 3),
                     scale.reshape(-1, 3), dtype_name, reason=NLIST_REASON)
    count = args[1]
    record.update({
        "side": side, "cap": cap, "n": positions.shape[0],
        "overflowing_cells": int((count > cap).sum()),
        "max_occupancy": int(count.max()),
        "pairs_evaluated": nlist.real_pairs(count, count, side, cap, cap),
    })
    return record


# (t_cap, cap) of the count-edge cases: t_cap below 32 and not a
# multiple of 32 or of a warp's 16 target slots.
EDGE_CAPS = ((64, 40), (20, 33), (45, 96), (100, 70), (160, 50))


def count_edge_cases(kind: str, reason: str, dtype_name: str = "float32",
                     tol=None, phase=None) -> None:
    """The cell-list kernel against its plain version on a side-3 grid
    whose target and source counts run through 0, 31, 32, 33, the caps
    and past them, with targets apart from sources; G m is zero on every
    slot past a cell's count, as the binning leaves it."""
    import torch

    from gravity_tpu_torch.ops import nlist

    dev = torch.device("cuda", 0)
    dtype = getattr(torch, dtype_name)
    phase = phase or (f"{'nlist' if kind == 'newton' else 'p3m'}"
                      "_kernel_vs_plain")
    gen = torch.Generator().manual_seed(19)
    side, n = 3, 27
    c = torch.arange(n)
    corner = torch.stack([c // 9, (c // 3) % 3, c % 3], 1).float()
    for t_cap, cap in EDGE_CAPS:
        choices = [0, 31, 32, 33, t_cap, t_cap + 5, cap, cap + 7, 1, 15, 16,
                   17]
        t_count = torch.tensor([choices[i % 12] for i in range(n)])
        s_count = torch.tensor([choices[(7 * i + 2) % 12] for i in range(n)])
        tpos = corner[:, None] + torch.rand(n, t_cap, 3, generator=gen)
        spos = corner[:, None] + torch.rand(n, cap, 3, generator=gen)
        gm = (0.5 + torch.rand(n, cap, generator=gen)) / 1000
        gm = torch.where(torch.arange(cap)[None] < s_count[:, None], gm, 0.0)
        # newton: rcut_eff = 1 cell; ewald: rcut 1, sigma 1/4.
        params = torch.tensor([1.0, 1.0 / (math.sqrt(2.0) * 0.25)])
        args = [t.to(dev, dtype) if t.is_floating_point() else t.to(dev)
                for t in (tpos, t_count, spos, gm, s_count)]
        args = (*args, side, params.to(dev, dtype))
        for use_rcut in ((True, False) if kind == "newton" else (True,)):
            kw = dict(cutoff=1e-10, eps=0.05, kind=kind, use_rcut=use_rcut)
            kern = nlist.pair_cells_kernel(*args, **kw)
            plain = nlist.pair_cells_plain(*args, **kw)
            scale = nlist.pair_cells_plain(*args, absolute=True, **kw)
            torch.cuda.synchronize()
            record = compare(
                f"count edges t_cap={t_cap} cap={cap} use_rcut={use_rcut}",
                kern.reshape(-1, 3), plain.reshape(-1, 3),
                scale.reshape(-1, 3), dtype_name, tol=tol, reason=reason)
            empty = (torch.arange(t_cap, device=dev)[None]
                     >= args[1].clamp_max(t_cap)[:, None])
            check(bool((kern[empty] == 0).all()),
                  f"{kind}: nonzero output past a cell's count")
            emit({"phase": phase, "kind": kind, **record,
                  "t_counts": sorted(set(t_count.tolist())),
                  "s_counts": sorted(set(s_count.tolist()))})


def phase_nlist_kernel_vs_plain() -> float:
    """The cell-list kernel against its plain version; returns the max
    abs error at the main path's shape (the README state, fp32)."""
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.models import generate_random_particles
    from gravity_tpu_torch.ops import nlist
    from gravity_tpu_torch.simulation import make_initial_state

    dev = torch.device("cuda", 0)
    config = SimulationConfig(**NLIST_RUN)
    state = make_initial_state(config, dev)
    side, cap = nlist.resolve_nlist_sizing(state.positions, config.nlist_rcut)
    main = nlist_compare("README state N=262144", state.positions,
                         state.masses, side, cap, config.nlist_rcut,
                         config.eps)
    emit({"phase": "nlist_kernel_vs_plain", **main})

    gen = torch.Generator().manual_seed(11)
    small = generate_random_particles(gen, 20_000, dtype=torch.float64,
                                      device=dev)
    # Overflow: side 4 holds ~312 bodies a cell against a cap of 64.
    record = nlist_compare("overflow N=20000 side=4 cap=64",
                           small.positions.float(), small.masses.float(), 4,
                           64, 5e10, 1e9)
    check(record["overflowing_cells"] > 0, "overflow case did not overflow")
    emit({"phase": "nlist_kernel_vs_plain", **record})
    side64, cap64 = nlist.resolve_nlist_sizing(small.positions, 5e10)
    emit({"phase": "nlist_kernel_vs_plain", **nlist_compare(
        "fp64 N=20000", small.positions, small.masses, side64, cap64, 5e10,
        1e9)})

    # Two bodies 1e13 m apart inside the radius (a massless third body
    # widens the cube so the cell edge exceeds 1e13 m). The 1e5 kg body's
    # weight on the other, G m / r^3 = 6.7e-45, is subnormal in fp32: a
    # build that flushes subnormals returns 0. Tolerance as for the
    # direct kernel: 1e-5 normal side, 25% subnormal side.
    pos = torch.tensor([[0.0, 0.0, 0.0], [1e13, 0.0, 0.0],
                        [2.2e13, 0.0, 0.0]], device=dev)
    masses = torch.tensor([1e24, 1e5, 0.0], device=dev)
    reset_counts()
    acc = nlist.nlist_accelerations(pos, masses, rcut=1.2e13, side=2,
                                    cap=8).double().cpu()
    torch.cuda.synchronize()
    check(read_counts()["nlist_pair"] == 1, "subnormal case: no launch")
    g = 6.67430e-11
    want = torch.tensor([g * 1e5 / 1e26, -g * 1e24 / 1e26],
                        dtype=torch.float64)
    rel = ((acc[:2, 0] - want) / want).abs()
    check(bool((acc[:2, 0] != 0).all()),
          "nlist 1e13 m pair: fp32 force flushed to zero (subnormal lost)")
    check(float(rel[1]) < 1e-5 and float(rel[0]) < 0.25,
          f"nlist 1e13 m pair: relative errors {rel.tolist()}")
    emit({"phase": "nlist_kernel_vs_plain", "case": "2 bodies 1e13 m fp32",
          "acc_x": acc[:2, 0].tolist(), "rel_err_vs_fp64": rel.tolist(),
          "tolerance": [0.25, 1e-5]})

    count_edge_cases("newton", NLIST_REASON)

    # 16 coincident 1e30 kg bodies: r = 0 for every pair.
    pos = torch.zeros(16, 3, device=dev)
    masses = torch.full((16,), 1e30, device=dev)
    acc = nlist.nlist_accelerations(pos, masses, rcut=1e11, side=2, cap=16)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(acc).all()) and bool((acc == 0).all()),
          "nlist coincident bodies: output must be all zero with no NaN")
    emit({"phase": "nlist_kernel_vs_plain", "case": "16 coincident 1e30 kg",
          "all_zero": True, "tolerance": "exact"})
    return main["max_abs_err"]


def mxu_scale(xi, xj, gmj, eps, bf16, chunk=256):
    """Per-row sum of |w| |[x_j | 1]| of the Gram form, in fp32."""
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.ops import mxu_kernel

    xi, xj = xi.float(), xj.float()
    ni, nj = mxu_kernel._norm2(xi), mxu_kernel._norm2(xj)
    xj4 = torch.cat([xj.abs(), torch.ones_like(xj[:, :1])], dim=1)
    rows = []
    for lo in range(0, xi.shape[0], chunk):
        w = mxu_kernel._gram_weights(xi[lo:lo + chunk], ni[lo:lo + chunk],
                                     xj, nj, gmj, cutoff=CUTOFF_RADIUS,
                                     eps=eps)
        if bf16:
            w = w.to(torch.bfloat16).float()
        rows.append((w[:, :, None] * xj4[None]).sum(dim=1))
    return torch.cat(rows)


def mxu_compare(name, pos_i, pos_j, masses, eps, bf16, rows=None) -> dict:
    """The Gram kernel's [S | W] against the plain version's, and the
    accelerations after the epilogue; a second launch must give the same
    bits (the chunk sums are added in a fixed order). With ``rows``, the
    launch is the whole (M, K) one and its rows ``rows`` are held to the
    plain version on those rows alone."""
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS, G
    from gravity_tpu_torch.ops import mxu_kernel

    compute = torch.bfloat16 if bf16 else torch.float32
    center = pos_j.float().mean(dim=0)
    xi = (pos_i.float() - center).to(compute).contiguous()
    xj = (pos_j.float() - center).to(compute).contiguous()
    gm = (masses.float() * G).contiguous()
    m_launch = xi.shape[0]
    kern = mxu_kernel.gram_acc4(xi, xj, gm, cutoff=CUTOFF_RADIUS, eps=eps)
    again = mxu_kernel.gram_acc4(xi, xj, gm, cutoff=CUTOFF_RADIUS, eps=eps)
    torch.cuda.synchronize()
    check(torch.equal(kern, again), f"nbody_mxu {name}: two runs differ")
    if rows is not None:
        kern, xi = kern[rows], xi[rows].contiguous()
    plain = mxu_kernel.gram_acc4_plain(xi, xj, gm, cutoff=CUTOFF_RADIUS,
                                       eps=eps, bf16=bf16)
    scale = mxu_scale(xi, xj, gm, eps, bf16)
    torch.cuda.synchronize()
    record = compare(name, kern, plain, scale, "float32", reason=MXU_REASON)
    acc_k = kern[:, :3] - kern[:, 3:4] * xi.float()
    acc_p = plain[:, :3] - plain[:, 3:4] * xi.float()
    diff = (acc_k.double() - acc_p.double())
    norm = acc_p.double().norm(dim=1)
    rel = (diff.norm(dim=1) / norm)[norm > 0]
    record.update({
        "precision": "bf16" if bf16 else "fp32", "m": m_launch,
        "k": xj.shape[0], "rows_compared": xi.shape[0],
        "source_chunks": mxu_kernel.chunks_for(
            m_launch, xj.shape[0], bf16=bf16, cutoff=CUTOFF_RADIUS,
            eps=eps),
        "bitwise_repeatable": True,
        "acc_max_abs_err": float(diff.abs().max()),
        "acc_median_rel_err": float(rel.median()) if rel.numel() else 0.0,
        "acc_p99_rel_err": (float(torch.quantile(rel, 0.99))
                            if rel.numel() else 0.0),
    })
    return record


def phase_mxu_kernel_vs_plain() -> float:
    """The Gram kernel against its plain version; returns the max abs
    error of the accelerations at the main path's shape (N = 65,536,
    fp32)."""
    import torch

    from gravity_tpu_torch.config import PRESETS, SimulationConfig
    from gravity_tpu_torch.models import generate_random_particles
    from gravity_tpu_torch.ops.mxu_kernel import accelerations_vs_mxu_kernel
    from gravity_tpu_torch.simulation import make_initial_state

    dev = torch.device("cuda", 0)
    state = make_initial_state(SimulationConfig(**MXU_RUN), dev)
    main_err = None
    for bf16 in (False, True):
        record = mxu_compare("N=65536", state.positions, state.positions,
                             state.masses, 1e9, bf16)
        emit({"phase": "mxu_kernel_vs_plain", **record})
        if not bf16:
            main_err = record["acc_max_abs_err"]
    # The bf16 path's shape and state: baseline-16k at bf16 (N = 16,384,
    # eps 1e9 m).
    config = dataclasses.replace(PRESETS["baseline-16k"], dtype="bfloat16")
    b16 = make_initial_state(config, dev)
    emit({"phase": "mxu_kernel_vs_plain", **mxu_compare(
        "baseline-16k bf16 N=16384", b16.positions, b16.positions,
        b16.masses, config.eps, True)})
    # Ragged and chunked shapes: M past a multiple of the block's 128
    # targets (and M = 1), K past a multiple of 8 (and of 16) and of the
    # 256-source tile, K below one k-step, and M << K, which the wrapper
    # splits into many source chunks.
    gen = torch.Generator().manual_seed(13)
    small = generate_random_particles(gen, 20_011, device=dev)
    chunked = 0
    for m, k in ((777, 1000), (1, 4099), (1000, 3), (129, 20_011),
                 (4097, 20_003), (1, 257)):
        pos_i = small.positions[:m].contiguous()
        pos_j = small.positions[:k].contiguous()
        for bf16 in (False, True):
            record = mxu_compare(f"ragged {m}x{k}", pos_i, pos_j,
                                 small.masses[:k].contiguous(), 1e9, bf16)
            chunked += record["source_chunks"] > 1
            emit({"phase": "mxu_kernel_vs_plain", **record})
    check(chunked > 0, "no case split its sources into chunks")
    pos = torch.full((16, 3), 2.5e11, device=dev)
    masses = torch.full((16,), 1e30, device=dev)
    for eps in (0.0, 1e9):
        for precision in ("fp32", "bf16"):
            acc = accelerations_vs_mxu_kernel(pos, pos, masses, eps=eps,
                                              precision=precision)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(acc).all()) and bool((acc == 0).all()),
                  f"mxu coincident bodies ({precision}, eps={eps:g}): "
                  "output must be all zero with no NaN")
    emit({"phase": "mxu_kernel_vs_plain", "case": "16 coincident 1e30 kg",
          "eps": [0.0, 1e9], "precision": ["fp32", "bf16"],
          "all_zero": True, "tolerance": "exact"})
    return main_err


def phase_nlist_main_path() -> dict:
    """The README cell-list run through the Simulator, all 500 steps."""
    import warnings

    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.ops import nlist
    from gravity_tpu_torch.simulation import Simulator
    from gravity_tpu_torch.utils.logging import RunLogger

    config = SimulationConfig(**NLIST_RUN)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = Simulator(config)
    side, cap, slots = sim.nlist_sizing
    args = nlist_tiles(sim.state.positions, sim.state.masses, side, cap,
                       config.nlist_rcut)
    pairs0 = nlist.real_pairs(args[1], args[4], side, cap, cap)
    s0 = ledger_start(sim)
    log_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(log_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=log_root) as log_dir:
        logger = RunLogger(log_dir, quiet=True)
        reset_counts()
        stats = sim.run(logger)
        counts = read_counts()
        with open(logger.path) as f:
            log = f.read()
    final = stats["final_state"]
    check(sim.backend == "nlist", f"backend {sim.backend}")
    check(counts["nlist_pair"] >= config.steps + 1,
          f"{counts['nlist_pair']} nlist_pair launches for "
          f"{config.steps} steps")
    check(tuple(final.positions.shape) == (config.n, 3), "final shape")
    check(bool(torch.isfinite(final.positions).all()
               & torch.isfinite(final.velocities).all()),
          "nlist run: final state not finite")
    for section in (f"Step {config.steps}/", "Performance Statistics:",
                    "Simulation completed successfully"):
        check(section in log, f"nlist log lacks {section!r}")
    record = {
        "phase": "nlist_main_path", "command": NLIST_RUN, "side": side,
        "cap": cap, "launches": counts["nlist_pair"], "counts": counts,
        "total_s": stats["total_time_s"],
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "dense_equiv_pairs_per_sec": stats["dense_equiv_pairs_per_sec"],
        "evaluated_pairs_per_sec": stats["evaluated_pairs_per_sec"],
        "tile_slots_per_eval": slots,
        "kernel_pairs_per_eval_at_t0": pairs0,
        "warnings": [str(w.message) for w in caught],
        "device": stats["device"], "host_gap_frac": stats["host_gap_frac"],
        "perf": stats["perf"],
        **ledger_energy_drift(sim, s0, final),
    }
    emit(record)
    return record


def phase_mxu_path() -> dict:
    """The Gram-form run through the Simulator; then its forces against
    nbody_direct's on the final state."""
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel
    from gravity_tpu_torch.ops.mxu_kernel import accelerations_vs_mxu_kernel
    from gravity_tpu_torch.simulation import Simulator

    config = SimulationConfig(**MXU_RUN)
    sim = Simulator(config)
    s0 = ledger_start(sim)
    reset_counts()
    stats = sim.run()
    counts = read_counts()
    final = stats["final_state"]
    check(sim.backend == "nbody_mxu", f"backend {sim.backend}")
    check(counts["nbody_mxu"] >= config.steps + 1,
          f"{counts['nbody_mxu']} nbody_mxu launches for "
          f"{config.steps} steps")
    check(bool(torch.isfinite(final.positions).all()
               & torch.isfinite(final.velocities).all()),
          "mxu run: final state not finite")
    pos, masses = final.positions, final.masses
    mxu = accelerations_vs_mxu_kernel(pos, pos, masses, eps=config.eps)
    direct = accelerations_vs_kernel(pos, pos, masses, eps=config.eps)
    rel = ((mxu.double() - direct.double()).norm(dim=1)
           / direct.double().norm(dim=1))
    record = {
        "phase": "mxu_path", "command": MXU_RUN,
        "launches": counts["nbody_mxu"], "counts": counts,
        "total_s": stats["total_time_s"],
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "pairs_per_s": stats["pairs_per_sec"],
        "vs_nbody_direct_median_rel_err": float(rel.median()),
        "vs_nbody_direct_p99_rel_err": float(torch.quantile(rel, 0.99)),
        "vs_nbody_direct_max_rel_err": float(rel.max()),
        "host_gap_frac": stats["host_gap_frac"], "perf": stats["perf"],
        **ledger_energy_drift(sim, s0, final),
    }
    # The JAX suite's fp32 class for the Gram form: median ~1e-6.
    check(record["vs_nbody_direct_median_rel_err"] < 1e-4,
          f"mxu vs nbody_direct median rel err {rel.median():.3e}")
    emit(record)
    return record


def tile_bytes(t_count, s_count, side: int, t_cap: int, cap: int,
               item: int, n_params: int) -> int:
    """Bytes the cell-list function must move at these counts: both count
    arrays and the params read once, the real target slots (3
    coordinates) read once and their output written once, and the real
    source slots (3 coordinates and G*m) read once. Padded slots are
    neither needed nor read: the zeros the kernel writes into the dense
    (side^3, t_cap, 3) output past each count (805 MB at the octree's
    side 128, where under 1% of the leaves hold bodies) are its layout's
    cost, not the function's."""
    n_cells = side**3
    targets = int(t_count.clamp_max(t_cap).sum())
    sources = int(s_count.clamp_max(cap).sum())
    return ((targets * 6 + sources * 4 + n_params) * item
            + 2 * n_cells * t_count.element_size())


def bound(pairs, flops_per_pair, n_bytes, device,
          peak_flops=PEAK_FP32_FLOPS) -> dict:
    """The least time for the work: operations (flops at ``peak_flops``,
    fp32's by default, and rsqrt on the SFUs at 16 per SM per clock) or
    bytes, whichever is larger."""
    clock_hz = device["max_sm_clock_mhz"] * 1e6
    flop_ms = 1e3 * pairs * flops_per_pair / peak_flops
    sfu_ms = 1e3 * pairs / (device["sm_count"] * SFU_PER_SM_PER_CLOCK
                            * clock_hz)
    byte_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
    bound_ms = max(flop_ms, sfu_ms, byte_ms)
    return {"bound_ms": bound_ms,
            "bound_by": "bytes" if byte_ms == bound_ms else "operations",
            "flop_ms": flop_ms, "peak_tflops": peak_flops / 1e12,
            "sfu_rsqrt_ms": sfu_ms, "hbm_bytes_ms": byte_ms}


def phase_timing_nlist(device: dict, build: dict) -> dict:
    """The cell-list kernel at the README state's tiles, beside its bound
    for the pairs this state needs, its plain version, and a whole force
    evaluation (binning and overflow channels included)."""
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.ops import nlist
    from gravity_tpu_torch.simulation import make_initial_state

    config = SimulationConfig(**NLIST_RUN)
    state = make_initial_state(config, torch.device("cuda", 0))
    side, cap = nlist.resolve_nlist_sizing(state.positions, config.nlist_rcut)
    args = nlist_tiles(state.positions, state.masses, side, cap,
                       config.nlist_rcut)
    kw = dict(cutoff=CUTOFF_RADIUS, eps=config.eps)

    def kernel():
        nlist.pair_cells_kernel(*args, **kw)

    def plain():
        nlist.pair_cells_plain(*args, **kw)

    def force_eval():
        nlist.nlist_accelerations(state.positions, state.masses,
                                  rcut=config.nlist_rcut, side=side, cap=cap,
                                  eps=config.eps)

    cuda_ms(kernel, 3)
    ms = cuda_ms(kernel, 30)
    cuda_ms(plain, 1)
    plain_ms = cuda_ms(plain, 3)
    ms_again = cuda_ms(kernel, 30)
    cuda_ms(force_eval, 3)
    eval_ms = cuda_ms(force_eval, 30)
    pairs = nlist.real_pairs(args[1], args[4], side, cap, cap)
    n_bytes = tile_bytes(args[1], args[4], side, cap, cap, 4, 1)
    instrs = per_pair(build, "nlist_pair", "nlist_pair_kernel<fLi0ELb1ELb1>")
    record = {
        "phase": "timing_nlist", "kernel": "nlist_pair", "side": side,
        "cap": cap, "n": config.n, "dtype": "float32",
        "pairs_evaluated": pairs,
        "tile_slots": nlist.evaluated_pairs_per_eval(side, cap),
        "ms": ms, "ms_repeat": ms_again, "plain_ms": plain_ms,
        **bound(pairs, NLIST_FLOPS_PER_PAIR, n_bytes, device),
        "sass_instrs_per_pair": instrs,
        "issue_floor_ms": issue_floor_ms(pairs, instrs, device),
        "force_eval_ms": eval_ms,
        "library_ms": None,
        "library_note": "no single PyTorch call computes a cell-list "
                        "pair sum",
        "nvidia_smi": device["nvidia_smi"],
    }
    record["share_of_bound"] = record["bound_ms"] / ms
    emit(record)
    return record


def mxu_bound(pairs: int, n_bytes: int, device: dict, bf16: bool) -> dict:
    """The Gram kernel's least time, by where it runs the work: the
    accumulation's 8 flops a pair at the tensor cores' dense rate (TF32
    for fp32 operands, bf16), the other 14 at the FP32 pipe's, one rsqrt
    a pair on the SFUs, and the bytes; the largest binds. The 22-flop
    fp32 bound of the FFMA design stays beside it for comparison."""
    clock_hz = device["max_sm_clock_mhz"] * 1e6
    terms = {
        "tensor_core_ms": 1e3 * pairs * MXU_TC_FLOPS_PER_PAIR / (
            PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS),
        "fp32_pipe_ms": 1e3 * pairs * MXU_FP32_FLOPS_PER_PAIR
        / PEAK_FP32_FLOPS,
        "sfu_rsqrt_ms": 1e3 * pairs / (device["sm_count"]
                                      * SFU_PER_SM_PER_CLOCK * clock_hz),
        "hbm_bytes_ms": 1e3 * n_bytes / PEAK_BYTES_PER_S,
    }
    bound_ms = max(terms.values())
    return {"bound_ms": bound_ms,
            "bound_by": ("bytes" if terms["hbm_bytes_ms"] == bound_ms
                         else "operations"),
            "binding_term": max(terms, key=terms.get), "terms": terms,
            "fp32_22flop_bound_ms": 1e3 * pairs * MXU_FLOPS_PER_PAIR
            / PEAK_FP32_FLOPS}


def phase_timing_mxu(device: dict, build: dict) -> dict:
    """The Gram kernel at N = 65,536 (fp32 operands, the path's), its
    bf16 variant (also at baseline-16k's bf16 state, the bf16 path's
    shape) and plain version, and nbody_direct on the same inputs;
    each variant beside its bound (:func:`mxu_bound`) and the issue floor
    of its pair loop's SASS instructions, with the source chunks S the
    wrapper takes."""
    import torch

    from gravity_tpu_torch.config import PRESETS, SimulationConfig
    from gravity_tpu_torch.constants import CUTOFF_RADIUS, G
    from gravity_tpu_torch.ops import mxu_kernel
    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel
    from gravity_tpu_torch.simulation import make_initial_state

    config = SimulationConfig(**MXU_RUN)
    state = make_initial_state(config, torch.device("cuda", 0))
    pos, masses = state.positions, state.masses
    center = pos.mean(dim=0)
    xi = (pos - center).contiguous()
    xb = xi.to(torch.bfloat16)
    gm = (masses * G).contiguous()
    kw = dict(cutoff=CUTOFF_RADIUS, eps=config.eps)

    def kernel():
        mxu_kernel.gram_acc4(xi, xi, gm, **kw)

    def kernel_bf16():
        mxu_kernel.gram_acc4(xb, xb, gm, **kw)

    # The bf16 form at the shape of its path (baseline-16k at bf16), with
    # the operands the wrapper hands it there.
    base16 = PRESETS["baseline-16k"]
    b16 = make_initial_state(dataclasses.replace(base16, dtype="bfloat16"),
                             torch.device("cuda", 0))
    x16 = (b16.positions.float() - b16.positions.float().mean(dim=0)).to(
        torch.bfloat16).contiguous()
    gm16 = (b16.masses.float() * G).contiguous()
    kw16 = dict(cutoff=CUTOFF_RADIUS, eps=base16.eps)

    def kernel_bf16_16k():
        mxu_kernel.gram_acc4(x16, x16, gm16, **kw16)

    def plain():
        mxu_kernel.gram_acc4_plain(xi, xi, gm, bf16=False, **kw)

    def direct():
        accelerations_vs_kernel(pos, pos, masses, eps=config.eps)

    def wrapper():
        mxu_kernel.accelerations_vs_mxu_kernel(pos, pos, masses,
                                               eps=config.eps)

    cuda_ms(kernel, 3)
    ms = cuda_ms(kernel, 30)
    cuda_ms(direct, 3)
    direct_ms = cuda_ms(direct, 30)
    ms_again = cuda_ms(kernel, 30)
    direct_again = cuda_ms(direct, 30)
    cuda_ms(kernel_bf16, 3)
    bf16_ms = cuda_ms(kernel_bf16, 30)
    cuda_ms(kernel_bf16_16k, 3)
    bf16_16k_ms = [cuda_ms(kernel_bf16_16k, 30), cuda_ms(kernel_bf16_16k, 30)]
    wrapper_ms = cuda_ms(wrapper, 30)
    cuda_ms(plain, 1)
    plain_ms = cuda_ms(plain, 3)
    n = pos.shape[0]
    pairs = n * n

    def loop(bf16):
        # The instantiation the path takes: no cutoff test (eps^2 >
        # cutoff^2), ftz rsqrt. Its loops' HMMA, MUFU and LDS counts are
        # in the build phase's record.
        key = f"nbody_mxu_kernel<{'bf16' if bf16 else 'f'}Lb0ELb1>"
        instrs = per_pair(build, "nbody_mxu", key)
        return {"sass_loop": key, "sass_instrs_per_pair": instrs,
                "issue_floor_ms": issue_floor_ms(pairs, instrs, device)}

    record = {
        "phase": "timing_mxu", "kernel": "nbody_mxu", "n": n,
        "dtype": "float32", "ms": ms, "ms_repeat": ms_again,
        "bf16_ms": bf16_ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
        "nbody_direct_ms_same_inputs": direct_ms,
        "nbody_direct_ms_repeat": direct_again,
        "source_chunks": mxu_kernel.chunks_for(n, n, bf16=False, **kw),
        # Inputs read once (targets, sources, G*m), the (N, 4) output once.
        **mxu_bound(pairs, (n * 3 + n * 3 + n) * 4 + n * 16, device, False),
        **loop(False),
        "bf16": {"ms": bf16_ms,
                 "source_chunks": mxu_kernel.chunks_for(n, n, bf16=True,
                                                        **kw),
                 **mxu_bound(pairs, (n * 3 + n * 3) * 2 + n * 4 + n * 16,
                             device, True),
                 **loop(True),
                 "n16384": {"ms": bf16_16k_ms,
                            "source_chunks": mxu_kernel.chunks_for(
                                b16.n, b16.n, bf16=True, **kw16),
                            **mxu_bound(b16.n**2, (b16.n * 3 + b16.n * 3) * 2
                                        + b16.n * 4 + b16.n * 16, device,
                                        True)}},
        "library_ms": None,
        "library_note": "no single PyTorch call computes this sum",
        "nvidia_smi": device["nvidia_smi"],
    }
    record["share_of_bound"] = record["bound_ms"] / ms
    record["share_of_22flop_bound"] = record["fp32_22flop_bound_ms"] / ms
    record["bf16"]["share_of_bound"] = record["bf16"]["bound_ms"] / bf16_ms
    sub = record["bf16"]["n16384"]
    sub["share_of_bound"] = sub["bound_ms"] / bf16_16k_ms[0]
    emit(record)
    return record


def phase_profile_nlist() -> dict:
    """Where a cell-list force evaluation's device time goes: the
    PyTorch profiler over 10 evaluations at the README state: device
    time summed by kernel, and the device span of each stage that
    ``nlist_accelerations_vs`` names (the pair-tile kernel against the
    plain-PyTorch binning and overflow channels around it). The
    profiler's own cost inflates the wall time it sees."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.ops import nlist
    from gravity_tpu_torch.simulation import make_initial_state

    config = SimulationConfig(**NLIST_RUN)
    state = make_initial_state(config, torch.device("cuda", 0))
    side, cap = nlist.resolve_nlist_sizing(state.positions, config.nlist_rcut)

    def force_eval():
        nlist.nlist_accelerations(state.positions, state.masses,
                                  rcut=config.nlist_rcut, side=side, cap=cap,
                                  eps=config.eps)

    evals = 10
    for _ in range(3):
        force_eval()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(evals):
            force_eval()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / evals
    record = profile_record(prof, "nlist.", evals, wall_ms)
    record["phase"] = "profile_nlist"
    emit(record)
    return record


def profile_record(prof, prefix, evals: int, wall_ms: float) -> dict:
    """Per-evaluation device time by kernel and by stage from a profile.
    On the device side the profiler records each ``prefix``* range (a
    string or a tuple of them) as a span (from its first kernel to its
    last, idle gaps included) and each kernel as itself."""
    stages, kernels = {}, []
    for item in prof.key_averages():
        if "CUDA" not in str(getattr(item, "device_type", "")):
            continue
        device_us = getattr(item, "device_time_total", None)
        if device_us is None:
            device_us = getattr(item, "cuda_time_total", 0.0)
        if item.key.startswith(prefix):
            stages[item.key] = device_us / evals / 1e3
        else:
            kernels.append((device_us / evals / 1e3, item.key, item.count))
    kernels.sort(reverse=True)
    device_ms = sum(ms for ms, _, _ in kernels)
    measured = bool(kernels) and device_ms > 0
    return {
        "evals": evals,
        "wall_ms_per_eval_profiled": wall_ms,
        "device_ms_per_eval": device_ms if measured else "not measured",
        "device_busy_share": (device_ms / wall_ms if measured
                              else "not measured"),
        "stage_device_span_ms_per_eval": stages,
        "device_kernels_per_eval": (sum(c for _, _, c in kernels) / evals
                                    if measured else "not measured"),
        "top_kernels_ms_per_eval": [
            {"kernel": key[:90], "ms": ms, "launches_per_eval": count / evals}
            for ms, key, count in kernels[:10]
        ],
    }


@functools.lru_cache(maxsize=2)
def p3m_state(name: str):
    """The P3M run's initial disk ("disk") or the uniform cube
    ("uniform"), on the card; made once."""
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.simulation import make_initial_state

    config = SimulationConfig(**(P3M_RUN if name == "disk" else P3M_UNIFORM))
    return make_initial_state(config, torch.device("cuda", 0))


@functools.lru_cache(maxsize=1)
def p3m_khat():
    """The P3M run's kernel transform (grid 256, sigma 1.25 cells, fp32),
    built once for the phases that evaluate P3M forces outside a run, as
    the Simulator builds it once per run."""
    import torch

    from gravity_tpu_torch.ops import p3m

    return p3m.force_kernel_hat(2 * P3M_RUN["pm_grid"], 1.25, torch.float32,
                                torch.device("cuda", 0))


def p3m_tiles(positions, masses, *, grid, cap, g, sigma_cells=1.25,
              rcut_sigmas=4.0):
    """The ewald tile kernel's arguments for the self form at a state, as
    ``p3m_accelerations_vs`` builds them."""
    import torch

    from gravity_tpu_torch.ops import cells, p3m

    origin, span = cells.bounding_cube(positions)
    sigma = sigma_cells * (span / (grid - 1))
    alpha = 1.0 / (math.sqrt(2.0) * sigma)
    rcut = rcut_sigmas * sigma
    side = p3m.binning_side(grid, sigma_cells, rcut_sigmas)
    coords = cells.grid_coords(positions, origin, span, side)
    cells_pos, cells_mass, count = cells.bin_to_cells(
        positions, masses, coords, side, cap)[:3]
    params = torch.stack([rcut * rcut, alpha])
    return (cells_pos, count, cells_pos, g * cells_mass, count, side, params)


def in_range_pairs(args) -> int:
    """Pairs of real slots with 0 < r^2 < rcut^2 among those the ewald
    kernel evaluates (the pairs that take the erfc weight), counted plane
    by plane over the 27 offsets."""
    import torch

    cells_pos, count, _, _, _, side, params = args
    s, cap = side, cells_pos.shape[1]
    real = torch.arange(cap, device=count.device)[None, :] < count[:, None]
    pos_p = cells_pos.new_zeros((s + 2, s + 2, s + 2, cap, 3))
    pos_p[1:-1, 1:-1, 1:-1] = cells_pos.reshape(s, s, s, cap, 3)
    real_p = real.new_zeros((s + 2, s + 2, s + 2, cap))
    real_p[1:-1, 1:-1, 1:-1] = real.reshape(s, s, s, cap)
    total = torch.zeros((), dtype=torch.int64, device=count.device)
    for x0 in range(s):
        tpos = pos_p[x0 + 1, 1:-1, 1:-1].reshape(s * s, cap, 1, 3)
        treal = real_p[x0 + 1, 1:-1, 1:-1].reshape(s * s, cap, 1)
        for o in range(27):
            ox, oy, oz = o // 9, (o // 3) % 3, o % 3
            spos = pos_p[x0 + ox, oy:oy + s, oz:oz + s].reshape(
                s * s, 1, cap, 3)
            sreal = real_p[x0 + ox, oy:oy + s, oz:oz + s].reshape(
                s * s, 1, cap)
            d = spos - tpos
            r2 = (d * d).sum(dim=-1)
            total += ((r2 < params[0]) & (r2 > 0) & treal & sreal).sum()
    return int(total)


def p3m_occupancy(args, cap: int) -> dict:
    """What share of the near field the ewald kernel carries at a state:
    cells and targets past the caps (their pairs go to the monopole
    channels instead), the pairs the kernel evaluates and those of them
    inside rcut."""
    from gravity_tpu_torch.ops import nlist

    count, side = args[1], args[5]
    return {
        "side": side, "cap": cap, "t_cap": cap,
        "occupied_cells": int((count > 0).sum()),
        "overflowing_cells": int((count > cap).sum()),
        "max_occupancy": int(count.max()),
        "targets_over_t_cap": int((count - cap).clamp_min(0).sum()),
        "targets_in_slots": int(count.clamp_max(cap).sum()),
        "pairs_evaluated": nlist.real_pairs(count, count, side, cap, cap),
        "pairs_in_rcut": in_range_pairs(args),
    }


def p3m_compare(name, positions, masses, *, cap, g, eps,
                grid=256) -> dict:
    """The ewald kind of the cell-list kernel against its plain version
    at a state's P3M tiles."""
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.ops import nlist

    args = p3m_tiles(positions, masses, grid=grid, cap=cap, g=g)
    kw = dict(cutoff=CUTOFF_RADIUS, eps=eps, kind="ewald")
    kern = nlist.pair_cells_kernel(*args, **kw)
    plain = nlist.pair_cells_plain(*args, **kw)
    scale = nlist.pair_cells_plain(*args, absolute=True, **kw)
    torch.cuda.synchronize()
    dtype_name = str(positions.dtype).removeprefix("torch.")
    record = compare(name, kern.reshape(-1, 3), plain.reshape(-1, 3),
                     scale.reshape(-1, 3), dtype_name, reason=EWALD_REASON)
    record.update({"n": positions.shape[0], "grid": grid,
                   **p3m_occupancy(args, cap)})
    return record


def phase_p3m_kernel_vs_plain() -> float:
    """The ewald kind against its plain version; returns the max abs error
    at the main path's shape (the README disk state, fp32)."""
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS, G
    from gravity_tpu_torch.ops import nlist

    disk, uniform = p3m_state("disk"), p3m_state("uniform")
    main = p3m_compare("README disk state N=1048576", disk.positions,
                       disk.masses, cap=64, g=1.0, eps=0.05)
    emit({"phase": "p3m_kernel_vs_plain", **main})
    emit({"phase": "p3m_kernel_vs_plain", **p3m_compare(
        "uniform N=1048576", uniform.positions, uniform.masses, cap=64, g=G,
        eps=1e9)})
    # Overflow: cap 4 against a mean occupancy of 7.9.
    record = p3m_compare("overflow: uniform N=1048576 cap=4",
                         uniform.positions, uniform.masses, cap=4, g=G,
                         eps=1e9)
    check(record["overflowing_cells"] > 0, "overflow case did not overflow")
    emit({"phase": "p3m_kernel_vs_plain", **record})
    emit({"phase": "p3m_kernel_vs_plain", **p3m_compare(
        "fp64 README disk state", disk.positions.double(),
        disk.masses.double(), cap=64, g=1.0, eps=0.05)})
    count_edge_cases("ewald", EWALD_REASON)

    # 16 coincident 1e30 kg bodies in one cell, rcut and alpha of order
    # one: r = 0 for every pair.
    dev = torch.device("cuda", 0)
    cells_pos = torch.ones(8, 16, 3, device=dev)
    count = torch.tensor([16] + [0] * 7, device=dev)
    gm = torch.full((8, 16), 1e30 * G, device=dev)
    params = torch.tensor([1.0, 1.0], device=dev)
    acc = nlist.pair_cells_kernel(cells_pos, count, cells_pos, gm, count, 2,
                                  params, cutoff=CUTOFF_RADIUS, eps=0.0,
                                  kind="ewald")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(acc).all()) and bool((acc == 0).all()),
          "ewald coincident bodies: output must be all zero with no NaN")
    emit({"phase": "p3m_kernel_vs_plain", "case": "16 coincident 1e30 kg",
          "all_zero": True, "tolerance": "exact"})
    return main["max_abs_err"]


def phase_p3m_path() -> dict:
    """The README P3M run (--p3m-short nlist) through the Simulator; then
    its forces on the final state against nbody_direct's at 4,096
    targets."""
    import warnings

    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.ops import p3m
    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel
    from gravity_tpu_torch.simulation import Simulator
    from gravity_tpu_torch.utils.logging import RunLogger

    config = SimulationConfig(**P3M_RUN)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = Simulator(config)
    side, cap, t_cap, mode = sim.p3m_sizing
    check(mode == "nlist", f"p3m short mode {mode}")
    occupancy = p3m_occupancy(
        p3m_tiles(sim.state.positions, sim.state.masses, grid=config.pm_grid,
                  cap=cap, g=config.g), cap)
    s0 = ledger_start(sim)
    log_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(log_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=log_root) as log_dir:
        logger = RunLogger(log_dir, quiet=True)
        reset_counts()
        stats = sim.run(logger)
        counts = read_counts()
        with open(logger.path) as f:
            log = f.read()
    final = stats["final_state"]
    check(sim.backend == "p3m", f"backend {sim.backend}")
    # Leapfrog: one force evaluation a step, plus the initial one.
    check(counts["nlist_pair/ewald"] == config.steps + 1,
          f"{counts['nlist_pair/ewald']} ewald launches for "
          f"{config.steps + 1} force evaluations")
    check(stats["kernel_launches"] == config.steps + 1,
          f"stats count {stats['kernel_launches']} ewald launches")
    check(tuple(final.positions.shape) == (config.n, 3), "final shape")
    finite = bool(torch.isfinite(final.positions).all()
                  & torch.isfinite(final.velocities).all())
    check(finite, "p3m run: final state not finite")
    for section in (f"Step {config.steps}/", "Performance Statistics:",
                    "Simulation completed successfully"):
        check(section in log, f"p3m log lacks {section!r}")

    # The forces on the final state against the exact direct sum, in
    # both short-range modes: relative per target, and scaled by the RMS
    # |a| (the JAX package's accuracy metric).
    pos, masses = final.positions, final.masses
    gen = torch.Generator().manual_seed(17)
    idx = torch.randperm(config.n, generator=gen)[:4096].to(pos.device)
    ref = accelerations_vs_kernel(pos[idx].contiguous(), pos, masses,
                                  g=config.g, eps=config.eps).double()
    ref_norm = ref.norm(dim=1)
    errors = {}
    for short in ("nlist", "gather"):
        acc = p3m.p3m_accelerations(
            pos, masses, grid=config.pm_grid, cap=cap, g=config.g,
            eps=config.eps, khat=p3m_khat(), short_mode=short)[idx]
        check(bool(torch.isfinite(acc).all()), f"p3m {short} forces not "
              "finite")
        err = (acc.double() - ref).norm(dim=1)
        rel, scaled = err / ref_norm, err / ref_norm.square().mean().sqrt()
        errors[short] = {
            "median_rel_err": float(rel.median()),
            "p99_rel_err": float(torch.quantile(rel, 0.99)),
            "median_scaled_err": float(scaled.median()),
            "p99_scaled_err": float(torch.quantile(scaled, 0.99)),
        }
    record = {
        "phase": "p3m_path", "command": P3M_RUN, "steps": config.steps,
        "launches": counts["nlist_pair/ewald"],
        "force_evaluations": config.steps + 1, "counts": counts,
        "total_s": stats["total_time_s"],
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "dense_equiv_pairs_per_sec": stats["pairs_per_sec"],
        "occupancy_at_t0": occupancy,
        "final_state_finite": finite,
        "vs_nbody_direct_targets": int(idx.numel()),
        "vs_nbody_direct": errors,
        "warnings": [str(w.message) for w in caught],
        "device": stats["device"], "host_gap_frac": stats["host_gap_frac"],
        **ledger_energy_drift(sim, s0, final),
    }
    emit(record)
    # The JAX package measured a median relative error of 0.19 on this
    # disk at grid 256 and cap 64 with its gather pass, against an fp64
    # direct sum at 1,024 targets (chip_logs/cross_solver_1m_disk.log;
    # mesh-side, from the thin geometry, and from the overflowing cells'
    # monopoles). 0.3 holds both passes to that class, far below a wrong
    # sign or scale. (Its 2.4% "scaled" median divides by an RMS |a| that
    # one target near the central point mass can dominate, so it is not
    # compared.)
    for short in ("gather", "nlist"):
        got = errors[short]["median_rel_err"]
        check(got < 0.3, f"p3m {short} vs nbody_direct median relative "
              f"error {got:.3e} > 0.3")
    return record


def ewald_bound(args, device) -> dict:
    """The ewald kernel's least time at these tiles: its operations for
    the pairs this state needs (every evaluated pair's base, and the
    weight for the pairs inside rcut) or its bytes (:func:`tile_bytes`),
    whichever is larger."""
    from gravity_tpu_torch.ops import nlist

    tcells_pos, t_count, cells_pos, _, s_count, side, _ = args
    t_cap, cap = tcells_pos.shape[1], cells_pos.shape[1]
    pairs = nlist.real_pairs(t_count, s_count, side, t_cap, cap)
    in_range = in_range_pairs(args)
    clock_hz = device["max_sm_clock_mhz"] * 1e6
    flop_ms = 1e3 * (pairs * EWALD_BASE_FLOPS
                     + in_range * EWALD_RANGE_FLOPS) / PEAK_FP32_FLOPS
    sfu_ms = 1e3 * in_range * EWALD_RANGE_SFU / (
        device["sm_count"] * SFU_PER_SM_PER_CLOCK * clock_hz)
    n_bytes = tile_bytes(t_count, s_count, side, t_cap, cap,
                         tcells_pos.element_size(), 2)
    byte_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
    bound_ms = max(flop_ms, sfu_ms, byte_ms)
    return {"pairs_evaluated": pairs, "pairs_in_rcut": in_range,
            "bytes": n_bytes, "bound_ms": bound_ms,
            "bound_by": "bytes" if byte_ms == bound_ms else "operations",
            "fp32_flop_ms": flop_ms, "sfu_ms": sfu_ms,
            "hbm_bytes_ms": byte_ms}


def phase_timing_p3m(device: dict) -> dict:
    """The ewald kernel by CUDA events at the README disk state and at the
    uniform state, beside its bound and its plain version; one whole P3M
    force evaluation and its mesh part alone."""
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS, G
    from gravity_tpu_torch.ops import cells, nlist, p3m

    records = {}
    for name, cfg, g in (("disk", P3M_RUN, 1.0), ("uniform", P3M_UNIFORM, G)):
        state = p3m_state(name)
        args = p3m_tiles(state.positions, state.masses, grid=cfg["pm_grid"],
                         cap=cfg["p3m_cap"], g=g)
        kw = dict(cutoff=CUTOFF_RADIUS, eps=cfg["eps"], kind="ewald")

        def kernel():
            nlist.pair_cells_kernel(*args, **kw)

        def plain():
            nlist.pair_cells_plain(*args, **kw)

        def force_eval():
            p3m.p3m_accelerations(state.positions, state.masses,
                                  grid=cfg["pm_grid"], cap=cfg["p3m_cap"],
                                  g=g, eps=cfg["eps"], khat=p3m_khat(),
                                  short_mode="nlist")

        origin, span = cells.bounding_cube(state.positions)

        def mesh():
            p3m._mesh_accelerations(state.positions, state.positions,
                                    state.masses, origin, span,
                                    grid=cfg["pm_grid"], g=g,
                                    sigma_cells=1.25, khat=p3m_khat())

        cuda_ms(kernel, 3)
        ms = cuda_ms(kernel, 20)
        cuda_ms(plain, 1)
        plain_ms = cuda_ms(plain, 2)
        ms_again = cuda_ms(kernel, 20)
        cuda_ms(force_eval, 2)
        eval_ms = cuda_ms(force_eval, 5)
        cuda_ms(mesh, 2)
        mesh_ms = cuda_ms(mesh, 5)
        record = {
            "phase": "timing_p3m", "kernel": "nlist_pair/ewald",
            "state": name, "n": state.n, "grid": cfg["pm_grid"],
            "side": args[5], "cap": cfg["p3m_cap"], "dtype": "float32",
            "ms": ms, "ms_repeat": ms_again, "plain_ms": plain_ms,
            **ewald_bound(args, device),
            "force_eval_ms": eval_ms, "mesh_ms": mesh_ms,
            "library_ms": None,
            "library_note": "no single PyTorch call computes a cell-list "
                            "pair sum",
            "nvidia_smi": device["nvidia_smi"],
        }
        record["share_of_bound"] = record["bound_ms"] / ms
        emit(record)
        records[name] = record
    return records["disk"]


def phase_profile_p3m() -> dict:
    """Where a P3M force evaluation's device time goes at the README disk
    state: the PyTorch profiler over 5 evaluations, device time summed by
    kernel and the device span of each stage that ``ops/p3m.py`` names
    (``p3m.deposit``, ``p3m.fft``, ``p3m.mesh_gather``, ``p3m.bin``,
    ``p3m.near_tiles``, ``p3m.remainder``, ``p3m.overflow_targets``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gravity_tpu_torch.ops import p3m

    state = p3m_state("disk")

    def force_eval():
        p3m.p3m_accelerations(state.positions, state.masses,
                              grid=P3M_RUN["pm_grid"],
                              cap=P3M_RUN["p3m_cap"], g=P3M_RUN["g"],
                              eps=P3M_RUN["eps"], khat=p3m_khat(),
                              short_mode="nlist")

    evals = 5
    for _ in range(2):
        force_eval()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(evals):
            force_eval()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / evals
    record = profile_record(prof, "p3m.", evals, wall_ms)
    record["phase"] = "profile_p3m"
    emit(record)
    return record


def phase_bf16_kernel_vs_plain() -> float:
    """nbody_direct's bf16 form against the plain version at bf16 on the
    card: masked (eps = 0) and mask-free (eps = 1e9 m), ragged M and K,
    M = 1, many source chunks, a weight in bf16's subnormal range, and
    the baseline-16k state at bf16 (the bf16 path's shape); a second
    launch must give the same bits. Returns the max abs error at the
    path's shape."""
    import torch

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.models import generate_random_particles
    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel
    from gravity_tpu_torch.ops.forces import (
        accelerations_vs,
        pairwise_accelerations_chunked,
    )
    from gravity_tpu_torch.simulation import make_initial_state

    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16

    def case(name, pos_i, pos_j, m_j, eps, plain):
        kern = accelerations_vs_kernel(pos_i, pos_j, m_j, eps=eps)
        again = accelerations_vs_kernel(pos_i, pos_j, m_j, eps=eps)
        torch.cuda.synchronize()
        check(kern.dtype == bf16, f"bf16 {name}: output {kern.dtype}")
        check(torch.equal(kern, again), f"bf16 {name}: two runs differ")
        record = compare(f"bf16 {name}", kern, plain,
                         term_scale(pos_i, pos_j, m_j, eps, chunk=256),
                         "bfloat16", tol=BF16_TOL, reason=BF16_REASON)
        record.update({
            "same_bits_as_plain": float((kern == plain).float().mean()),
            "bitwise_repeatable": True,
            "source_chunks": direct_chunks(pos_i.shape[0], pos_j.shape[0],
                                           bf16, eps),
        })
        emit({"phase": "bf16_kernel_vs_plain", **record})
        return record

    gen = torch.Generator().manual_seed(11)
    base = generate_random_particles(gen, 20_000, dtype=torch.float64,
                                     device=dev)
    for (m, k) in ((64, 64), (1000, 1000), (1, 4099), (7, 20_000),
                   (1_001, 4_099), (5_000, 3), (257, 256)):
        pos_j = base.positions[:k].to(bf16).contiguous()
        m_j = base.masses[:k].to(bf16).contiguous()
        pos_i = base.positions[:m].to(bf16).contiguous()
        for eps in (0.0, 1e9):
            case(f"{m}x{k} eps={eps:g}", pos_i, pos_j, m_j, eps,
                 accelerations_vs(pos_i, pos_j, m_j, eps=eps))
    for eps in (0.0, 1e9):
        emit({"phase": "bf16_kernel_vs_plain",
              **bf16_subnormal_case(dev, "nbody_direct", eps)})
    config = dataclasses.replace(PRESETS["baseline-16k"], dtype="bfloat16")
    state = make_initial_state(config, dev)
    pos, masses = state.positions, state.masses
    record = case("baseline-16k N=16384", pos, pos, masses, config.eps,
                  pairwise_accelerations_chunked(pos, masses,
                                                 eps=config.eps))
    return record["max_abs_err"]


def energy_f64(state, config, chunk: int = 4096) -> float:
    """Total energy (KE + PE) of a state in float64 on the card, the
    potential streamed over ``chunk`` target rows (at N = 262,144 the
    default chunk would take ~50 GB of float64 temporaries)."""
    import torch

    from gravity_tpu_torch.ops import diagnostics
    from gravity_tpu_torch.ops.forces import potential_energy

    st = state.astype(torch.float64)
    return float(diagnostics.kinetic_energy(st) + potential_energy(
        st.positions, st.masses, g=config.g, cutoff=config.cutoff,
        eps=config.eps, chunk=chunk))


def energy_drift_f64(state0, final, config) -> float:
    e0 = energy_f64(state0, config)
    return abs((energy_f64(final, config) - e0) / e0)


def run_counted(config) -> tuple:
    """A Simulator run of ``config`` with every launch count set to 0 just
    before it and read just after; the energy drift of the run in float64
    (the initial state's energy taken before the counts are reset) and
    the share of bodies whose position changed at all (a bf16 state
    stands still where v dt is below half an ulp of x)."""
    import torch

    from gravity_tpu_torch.ops import diagnostics
    from gravity_tpu_torch.simulation import Simulator

    sim = Simulator(config)
    x0 = sim.state.positions
    e0 = energy_f64(sim.state, config)
    reset_counts()
    stats = sim.run()
    counts = read_counts()
    final = stats["final_state"]
    stats["moved_share"] = float(
        (final.positions != x0).any(dim=1).float().mean())
    check(bool(torch.isfinite(final.positions).all()
               & torch.isfinite(final.velocities).all()),
          f"{config.model} run: final state not finite")
    check(final.positions.dtype == sim.dtype,
          f"{config.model} run: state became {final.positions.dtype}")
    drift = diagnostics.energy_drift(e0, energy_f64(final, config))
    return sim, stats, counts, drift


def phase_baseline16k_path() -> dict:
    """The baseline-16k preset through the Simulator at full width: a
    Plummer sphere, N = 16,384, all 500 leapfrog steps, eps = 1e9 m, so
    nbody_direct's mask-free form; its energy drift in float64."""
    from gravity_tpu_torch.config import PRESETS

    config = PRESETS["baseline-16k"]
    sim, stats, counts, drift = run_counted(config)
    check(sim.backend == "nbody_direct", f"backend {sim.backend}")
    check(counts["nbody_direct"] == config.steps + 1,
          f"{counts['nbody_direct']} nbody_direct launches for "
          f"{config.steps} leapfrog steps")
    record = {
        "phase": "baseline16k_path", "preset": "baseline-16k",
        "model": config.model, "n": config.n, "steps": config.steps,
        "integrator": config.integrator, "eps": config.eps,
        "launches": counts["nbody_direct"], "counts": counts,
        "total_s": stats["total_time_s"],
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "pairs_per_s": stats["pairs_per_sec"], "energy_drift": drift,
        "moved_share": stats["moved_share"], "device": stats["device"],
        "perf": stats["perf"],
    }
    emit(record)
    return record


def phase_baseline2m_path(device: dict) -> dict:
    """The baseline-2m preset at full width (the merger, N = 2,097,152,
    G = 1, eps = 0.05), cut to BASELINE_2M_STEPS leapfrog steps; then one more evaluation
    of the final state through the path's own force function (the same
    launch shape as the run's, N x N with its S source chunks), held
    against the plain version on 4,096 sampled rows against all
    2,097,152 sources, within the fp32 tolerance."""
    import torch

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.ops.forces import accelerations_vs
    from gravity_tpu_torch.simulation import Simulator

    config = dataclasses.replace(PRESETS["baseline-2m"],
                                 steps=BASELINE_2M_STEPS)
    sim = Simulator(config)
    reset_counts()
    stats = sim.run()
    counts = read_counts()
    final = stats["final_state"]
    check(sim.backend == "nbody_direct", f"backend {sim.backend}")
    check(counts["nbody_direct"] == config.steps + 1,
          f"{counts['nbody_direct']} nbody_direct launches for "
          f"{config.steps} steps")
    check(bool(torch.isfinite(final.positions).all()
               & torch.isfinite(final.velocities).all()),
          "2M run: final state not finite")
    pos, masses = final.positions, final.masses
    full = sim.accel(pos, masses)
    gen = torch.Generator().manual_seed(5)
    idx = torch.randperm(config.n, generator=gen)[:BASELINE_2M_SAMPLE]
    idx = idx.to(pos.device)
    pos_i = pos[idx].contiguous()
    kern = full[idx]
    # The plain version, 64 targets at a time against all sources.
    plain = torch.cat([
        accelerations_vs(p, pos, masses, g=config.g, eps=config.eps)
        for p in torch.split(pos_i, 64)])
    torch.cuda.synchronize()
    scale = term_scale(pos_i, pos, masses, config.eps, chunk=32,
                       g=config.g)
    record = compare("baseline-2m N x N, 4096 rows sampled", kern, plain,
                     scale, "float32")
    pairs = config.n * config.n
    n_bytes = (config.n * 3 + config.n + config.n * 3) * 4
    record.update({
        "phase": "baseline2m_path", "preset": "baseline-2m",
        "model": config.model, "n": config.n, "steps": config.steps,
        "cut": f"{BASELINE_2M_STEPS} of 500 steps (validate_path runs "
               "3 more)",
        "launches": counts["nbody_direct"], "counts": counts,
        "total_s": stats["total_time_s"],
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "pairs_per_s": stats["pairs_per_sec"],
        "checked_launch": {"m": config.n, "k": config.n,
                           "rows_compared": BASELINE_2M_SAMPLE},
        "source_chunks": direct_chunks(config.n, config.n, torch.float32,
                                       config.eps),
        **bound(pairs, FLOPS_PER_PAIR, n_bytes, device),
        "device": stats["device"],
    })
    record["share_of_bound"] = record["bound_ms"] / record["ms_per_step"]
    emit(record)
    return record


def phase_bf16_paths() -> dict:
    """baseline-16k at --dtype bfloat16, all 500 steps, once through
    pallas (nbody_direct's bf16 form) and once through pallas-mxu
    (nbody_mxu's bf16 form); each final acceleration against fp32
    nbody_direct on the same state, and each run's energy drift. Then
    the same state at a dt where a bf16 state moves (BF16_EVOLVE), in
    bf16 through each kernel and in fp32: drift and share moved."""
    import torch

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel

    records = {}
    for backend, kernel in (("pallas", "nbody_direct"),
                            ("pallas-mxu", "nbody_mxu")):
        config = dataclasses.replace(PRESETS["baseline-16k"],
                                     dtype="bfloat16", force_backend=backend)
        sim, stats, counts, drift = run_counted(config)
        check(sim.backend == kernel, f"bf16 {backend}: backend {sim.backend}")
        check(counts[kernel] == config.steps + 1,
              f"bf16 {backend}: {counts[kernel]} {kernel} launches for "
              f"{config.steps} steps")
        final = stats["final_state"]
        acc = sim.accel(final.positions, final.masses)
        pos32, m32 = final.positions.float(), final.masses.float()
        ref = accelerations_vs_kernel(pos32, pos32, m32, eps=config.eps)
        rel = ((acc.double() - ref.double()).norm(dim=1)
               / ref.double().norm(dim=1))
        record = {
            "phase": "bf16_paths", "preset": "baseline-16k",
            "dtype": "bfloat16", "force_backend": backend, "kernel": kernel,
            "n": config.n, "steps": config.steps,
            "launches": counts[kernel], "counts": counts,
            "total_s": stats["total_time_s"],
            "ms_per_step": 1e3 * stats["avg_step_s"],
            "energy_drift": drift, "moved_share": stats["moved_share"],
            "vs_fp32_nbody_direct_median_rel_err": float(rel.median()),
            "vs_fp32_nbody_direct_p90_rel_err": float(
                torch.quantile(rel, 0.9)),
            "median_bar": BF16_MEDIAN_BAR,
        }
        check(record["vs_fp32_nbody_direct_median_rel_err"] < BF16_MEDIAN_BAR,
              f"bf16 {backend}: median rel err {float(rel.median()):.3e}")
        emit(record)
        records[kernel] = record
    # The same state at a dt where it evolves, through each bf16 kernel
    # and through fp32 nbody_direct: drift and the share of bodies moved.
    for dtype, backend, kernel in (("float32", "pallas", "nbody_direct"),
                                   ("bfloat16", "pallas", "nbody_direct"),
                                   ("bfloat16", "pallas-mxu", "nbody_mxu")):
        config = dataclasses.replace(PRESETS["baseline-16k"], dtype=dtype,
                                     force_backend=backend, **BF16_EVOLVE)
        sim, stats, counts, drift = run_counted(config)
        check(counts[kernel] == config.steps + 1,
              f"{dtype} {backend} at dt {config.dt:g}: {counts[kernel]} "
              f"{kernel} launches for {config.steps} steps")
        check(stats["moved_share"] > BF16_MOVED_BAR,
              f"{dtype} {backend} at dt {config.dt:g}: only "
              f"{stats['moved_share']:.3f} of the bodies moved")
        emit({"phase": "bf16_paths", "case": "evolving",
              "preset": "baseline-16k", "dtype": dtype,
              "force_backend": backend, "kernel": kernel, "n": config.n,
              "dt": config.dt, "steps": config.steps,
              "launches": counts[kernel],
              "ms_per_step": 1e3 * stats["avg_step_s"],
              "energy_drift": drift, "moved_share": stats["moved_share"],
              "moved_bar": BF16_MOVED_BAR})
    return records


# ---------------------------------------------------------------------------
# The integration modes: multirate block timesteps (the three kernels'
# rectangular fast kicks), adaptive dt, an external field and merging.
# ---------------------------------------------------------------------------

# The star-cluster example (examples/star_cluster.py) at full width: the
# port's Plummer N = 16,384 plus a central hard binary, fp64.
STAR_BINARY_MASS = 5.0e28
STAR_BINARY_SEP = 2.0e9
STAR_STEPS = 30
# Steps kept of each cut path.
NLIST_MULTIRATE_STEPS = 50
MXU_MULTIRATE_STEPS = 20
LADDER_STEPS = 100
MERGE_STEPS = 100
MERGE_EVERY = 10
# The merge radius: the distance of this closest pair of the initial
# state, so that the first check finds pairs inside it.
MERGE_RANK = 20
# An external Plummer halo of the cluster's own G M, scale 1e12 m.
EXTERNAL_A = 1.0e12


def logged_run(sim, name: str, *, fixed_steps=None) -> tuple:
    """``sim.run`` with a RunLogger, every launch count set to 0 just
    before and read just after; checks a finite final state of the
    right shape and the log's sections. Returns (stats, counts)."""
    import torch

    from gravity_tpu_torch.utils.logging import RunLogger

    log_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(log_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=log_root) as log_dir:
        logger = RunLogger(log_dir, quiet=True)
        reset_counts()
        stats = sim.run(logger)
        counts = read_counts()
        with open(logger.path) as f:
            log = f.read()
    final = stats["final_state"]
    check(tuple(final.positions.shape) == (sim.n_real, 3),
          f"{name}: final shape {tuple(final.positions.shape)}")
    check(bool(torch.isfinite(final.positions).all()
               & torch.isfinite(final.velocities).all()),
          f"{name}: final state not finite")
    sections = ["gravity simulation at", "Performance Statistics:",
                "Final positions:", "Simulation completed successfully"]
    if fixed_steps is not None:
        sections.append(f"Step {fixed_steps}/")
    for section in sections:
        check(section in log, f"{name}: log lacks {section!r}")
    if sim.backend in ("fmm", "sfmm", "pm") or sim.config.periodic_box > 0.0:
        # Plain PyTorch, as the JAX package's jnp (the FMM, the mesh, the
        # periodic cell list): no kernel may launch.
        check(stats["kernel_launches"] == 0 and not any(counts.values()),
              f"{name}: a kernel launched on a plain path: {counts}")
        return stats, counts
    key = {"nbody_direct": "nbody_direct", "nbody_mxu": "nbody_mxu",
           "nlist": "nlist_pair", "tree": "nlist_pair/near"}[sim.backend]
    if sim.backend in ("nlist", "tree") and sim.config.dtype == "bfloat16":
        key = {"nlist": "nlist_pair/bf16",
               "tree": "nlist_pair/near_bf16"}[sim.backend]
    check(stats["kernel_launches"] == counts[key],
          f"{name}: stats count {stats['kernel_launches']}, counts {counts}")
    return stats, counts


def energy_of(state, config, external_phi=None) -> float:
    """KE + PE (+ the external potential energy) in float64 on the card."""
    import torch

    from gravity_tpu_torch.ops import diagnostics

    return float(diagnostics.total_energy(
        state.astype(torch.float64), g=config.g, cutoff=config.cutoff,
        eps=config.eps, external_phi=external_phi))


# Target rows a pair-scan chunk of the ledger takes at once: at N = 262,144
# the ledger's default 4,096 would hold ~50 GB of temporaries.
LEDGER_CHUNK = 1024


def ledger_start(sim):
    """The initial state of ``sim``'s run, kept for its ledger. Both ends'
    ledgers are taken after the run (``ledger_energy_drift``), so that the
    ledger puts nothing on the card before the timed loop; the depth of
    the tree potential (the ledger's term above 16,384 bodies) is fit here
    to the initial state, a host pass, and kept for the final one."""
    sim._ledger_tree_depth()
    return sim.state


def ledger_energy_drift(sim, state0, final) -> dict:
    """|E - E0| / |E0| and the other drifts of the conservation ledger
    (``Simulator.ledger_of``: ``ledger_vec`` and the path's potential
    term, the pair scan up to 16,384 bodies and for the truncated family,
    the octree's scaled potential above) between ``state0`` and ``final``,
    outside the timed run."""
    from gravity_tpu_torch.ops import diagnostics

    l0 = sim.ledger_of(state0, chunk=LEDGER_CHUNK)
    l1 = sim.ledger_of(final, chunk=LEDGER_CHUNK)
    drift = diagnostics.ledger_drift(l0, l1)
    return {"energy_drift": drift["energy_drift"],
            "ledger_pe_kind": l0["pe_kind"], "ledger_drift": drift}


def fast_targets(sim, state, k: int):
    """The fast rung of ``state``: the k largest |a| of its full force."""
    from gravity_tpu_torch.ops.multirate import select_fast

    return select_fast(sim.accel(state.positions, state.masses),
                       state.masses, k=k)


def direct_kick(name, pos, masses, idx, eps, device, reps=30) -> dict:
    """nbody_direct's fast kick (the rung's targets against all sources)
    against the plain version at the term-scale limit, the same bits on a
    repeat; its time by CUDA events, the plain version's, and its bound."""
    import torch

    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel
    from gravity_tpu_torch.ops.forces import accelerations_vs

    ti = pos[idx]
    dtype_name = str(pos.dtype).replace("torch.", "")
    kern = accelerations_vs_kernel(ti, pos, masses, eps=eps)
    again = accelerations_vs_kernel(ti, pos, masses, eps=eps)
    plain = torch.cat([accelerations_vs(t, pos, masses, eps=eps)
                       for t in torch.split(ti, 256)])
    scale = term_scale(ti, pos, masses, eps)
    torch.cuda.synchronize()
    check(torch.equal(kern, again), f"{name}: two launches differ")
    record = compare(name, kern, plain, scale, dtype_name)
    m, k = ti.shape[0], pos.shape[0]

    def kernel():
        accelerations_vs_kernel(ti, pos, masses, eps=eps)

    def plain_fn():
        for t in torch.split(ti, 256):
            accelerations_vs(t, pos, masses, eps=eps)

    cuda_ms(kernel, 3)
    ms = [cuda_ms(kernel, reps), cuda_ms(kernel, reps)]
    cuda_ms(plain_fn, 1)
    plain_ms = cuda_ms(plain_fn, 3)
    item = pos.element_size()
    peak = PEAK_FP64_FLOPS if pos.dtype == torch.float64 else PEAK_FP32_FLOPS
    record.update({
        "m": m, "k": k, "bitwise_repeatable": True, "ms": ms[0],
        "ms_repeat": ms[1], "plain_ms": plain_ms,
        "source_chunks": direct_chunks(m, k, pos.dtype, eps),
        **bound(m * k, FLOPS_PER_PAIR, (m * 3 + k * 4 + m * 3) * item,
                device, peak),
        "library_ms": None,
        "library_note": "no single PyTorch call computes this sum",
    })
    record["share_of_bound"] = record["bound_ms"] / ms[0]
    return record


def phase_multirate_path(device: dict, base16k: dict) -> dict:
    """baseline-16k with --integrator multirate (auto k = 2,048, sub 4),
    all 500 steps: 4 fast kicks and one full evaluation a step; then the
    3-rung ladder (capacities 2,048 and 256), 100 steps: 6 kicks and one
    full a step. One fast kick of the final state, M = 2,048 against the
    16,384 sources, held to the plain version; a profile of the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.simulation import Simulator

    config = dataclasses.replace(PRESETS["baseline-16k"],
                                 integrator="multirate")
    sim = Simulator(config)
    s0 = ledger_start(sim)
    stats, counts = logged_run(sim, "multirate_path",
                               fixed_steps=config.steps)
    check(stats["multirate_k"] == 2048, f"k {stats['multirate_k']}")
    check(counts["nbody_direct"] == 1 + 5 * config.steps,
          f"{counts['nbody_direct']} launches for {config.steps} two-rung "
          "steps (5 a step and the carry)")
    ladder_cfg = dataclasses.replace(config, multirate_rungs=3,
                                     steps=LADDER_STEPS)
    ladder = Simulator(ladder_cfg)
    l_stats, l_counts = logged_run(ladder, "multirate_ladder",
                                   fixed_steps=LADDER_STEPS)
    check(l_stats["multirate_capacities"] == [2048, 256],
          f"capacities {l_stats['multirate_capacities']}")
    check(l_counts["nbody_direct"] == 1 + 7 * LADDER_STEPS,
          f"{l_counts['nbody_direct']} launches for {LADDER_STEPS} ladder "
          "steps (7 a step and the carry)")
    final = stats["final_state"]
    idx = fast_targets(sim, final, 2048)
    kick = direct_kick("multirate_kick_2048", final.positions, final.masses,
                       idx, config.eps, device)
    # Where a two-rung step's time goes: device time by kernel against
    # the host's wall time, over 20 steps of the final state.
    step = sim._step_fn(final.masses)
    st, acc = final, sim.accel(final.positions, final.masses)
    for _ in range(3):
        st, acc = step(st, acc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(20):
            st, acc = step(st, acc)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / 20
    step_profile = profile_record(prof, "multirate.", 20, wall_ms)
    record = {
        "phase": "multirate_path", "preset": "baseline-16k",
        "integrator": "multirate", "k": 2048, "sub": config.multirate_sub,
        "steps": config.steps, "launches": counts["nbody_direct"],
        "counts": counts, "ms_per_step": 1e3 * stats["avg_step_s"],
        "fixed_dt_ms_per_step": base16k["ms_per_step"],
        "ladder": {"rungs": 3, "capacities": [2048, 256],
                   "steps": LADDER_STEPS, "cut_from": config.steps,
                   "launches": l_counts["nbody_direct"],
                   "ms_per_step": 1e3 * l_stats["avg_step_s"]},
        "kick": kick, "step_profile": step_profile,
        "host_gap_frac": stats["host_gap_frac"],
        **ledger_energy_drift(sim, s0, final),
        "nvidia_smi": device["nvidia_smi"],
    }
    emit(record)
    return record


def star_cluster_state(device):
    """examples/star_cluster.py's state at full width: the port's Plummer
    sphere (N = 16,384, fp64) with a circular equal-mass binary at its
    centre; (state, dt = period / 5, eps = separation / 10)."""
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.constants import G
    from gravity_tpu_torch.simulation import make_initial_state
    from gravity_tpu_torch.state import ParticleState

    cluster = make_initial_state(
        SimulationConfig(model="plummer", n=16_384, dtype="float64"), device)
    m_b, a_b = STAR_BINARY_MASS, STAR_BINARY_SEP
    v_b = math.sqrt(2 * G * m_b / a_b)
    period = 2 * math.pi * math.sqrt(a_b**3 / (G * 2 * m_b))

    def rows(values):
        return torch.tensor(values, dtype=torch.float64, device=device)

    state = ParticleState(
        torch.cat([rows([[-a_b / 2, 0, 0], [a_b / 2, 0, 0]]),
                   cluster.positions]),
        torch.cat([rows([[0, -v_b / 2, 0], [0, v_b / 2, 0]]),
                   cluster.velocities]),
        torch.cat([rows([m_b, m_b]), cluster.masses]),
    )
    return state, period / 5.0, a_b / 10.0, period


def phase_star_cluster_path(device: dict) -> dict:
    """The star-cluster example at full width in fp64 through
    nbody_direct's fp64 form, 30 steps each of single-rate leapfrog, the
    two-rung scheme (k = 2, sub 4) and the ladder (rungs 3, k = 128),
    each with its energy drift; the M = 2 kick against the plain version;
    then --adaptive --integrator multirate on the same state."""
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.simulation import Simulator

    dev = torch.device("cuda", 0)
    state, dt, eps, period = star_cluster_state(dev)
    base = dict(n=state.n, steps=STAR_STEPS, dt=dt, eps=eps,
                dtype="float64", force_backend="pallas")
    e0 = energy_of(state, SimulationConfig(**base))
    runs = {}
    for name, extra, per_step in (
        ("single_rate", dict(integrator="leapfrog"), 1),
        ("two_rung", dict(integrator="multirate", multirate_k=2,
                          multirate_sub=4), 5),
        ("ladder", dict(integrator="multirate", multirate_k=128,
                        multirate_rungs=3), 7),
    ):
        config = SimulationConfig(**base, **extra)
        sim = Simulator(config, state=state)
        stats, counts = logged_run(sim, f"star_cluster_{name}",
                                   fixed_steps=STAR_STEPS)
        check(counts["nbody_direct"] == 1 + per_step * STAR_STEPS,
              f"star cluster {name}: {counts['nbody_direct']} launches")
        runs[name] = {
            "launches": counts["nbody_direct"],
            "ms_per_step": 1e3 * stats["avg_step_s"],
            "energy_drift": abs(energy_of(stats["final_state"], config) - e0)
            / abs(e0),
        }
        if name == "two_rung":
            two_rung_sim, two_rung_final = sim, stats["final_state"]
    idx = fast_targets(two_rung_sim, two_rung_final, 2)
    check(set(idx.tolist()) == {0, 1}, f"star cluster fast set {idx}")
    kick = direct_kick("star_cluster_kick_2", two_rung_final.positions,
                       two_rung_final.masses, idx, eps, device)
    adaptive_cfg = SimulationConfig(**base, integrator="multirate",
                                    adaptive=True)
    a_sim = Simulator(adaptive_cfg, state=state)
    a_stats, a_counts = logged_run(a_sim, "star_cluster_adaptive")
    drifts = [runs[k]["energy_drift"]
              for k in ("single_rate", "two_rung", "ladder")]
    record = {
        "phase": "star_cluster_path", "n": state.n, "dtype": "float64",
        "binary_period_s": period, "dt_s": dt, "eps": eps,
        "steps": STAR_STEPS, "runs": runs,
        "ordering_holds": drifts[0] > drifts[1] > drifts[2],
        "kick": kick,
        "adaptive": {
            "mode": "adaptive multirate (auto k, sub 4)",
            "k": a_stats["multirate_k"],
            "criterion": a_stats["criterion"],
            "adaptive_steps": a_stats["adaptive_steps"],
            "t_reached": a_stats["t_reached"], "t_end": a_stats["t_end"],
            "dt_min": a_stats["dt_min"],
            "dt_max_used": a_stats["dt_max_used"],
            "tail_steps": a_stats["adaptive_tail_steps"],
            "launches": a_counts["nbody_direct"],
            "ms_per_step": 1e3 * a_stats["avg_step_s"],
            "energy_drift": abs(energy_of(a_stats["final_state"],
                                          adaptive_cfg) - e0) / abs(e0),
        },
        "nvidia_smi": device["nvidia_smi"],
    }
    emit(record)
    return record


def nlist_kick_tiles(positions, masses, targets, side, cap, t_cap, rcut):
    """The pair-tile kernel's arguments of a K-target kick, as
    ``nlist_accelerations_vs`` builds them: the sources' cells at ``cap``,
    the targets binned on the same grid at ``t_cap``."""
    import torch

    from gravity_tpu_torch.constants import G
    from gravity_tpu_torch.ops import nlist
    from gravity_tpu_torch.ops.cells import bin_to_cells, grid_coords

    origin, span, params, _, binned = nlist.source_cells(
        positions, masses, rcut=rcut, side=side, cap=cap)
    cells_pos, cells_mass, cell_count = binned[:3]
    tcells_pos, _, t_count, _, _, _ = bin_to_cells(
        targets, torch.ones_like(targets[:, 0]),
        grid_coords(targets, origin, span, side), side, t_cap)
    return (tcells_pos, t_count, cells_pos, cells_mass * G, cell_count,
            side, params)


def phase_nlist_multirate_path(device: dict) -> dict:
    """README's nlist run with --integrator multirate (k = 32,768, sub 4),
    cut to 100 of its 500 steps; the t_cap the occupancy model chose and
    the share of fast targets over it; one kick's pair tiles at that
    t_cap against the plain version; the kick's kernel and the whole kick
    timed, and the kick's stages by the nlist.* profiler ranges."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.ops import nlist
    from gravity_tpu_torch.simulation import Simulator

    config = SimulationConfig(**{**NLIST_RUN, "integrator": "multirate",
                                 "steps": NLIST_MULTIRATE_STEPS})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = Simulator(config)
    side, cap, t_cap = sim.kick_sizing
    k = sim._multirate_plan()[0]
    check(k == 32_768 and t_cap < cap, f"k {k}, t_cap {t_cap}, cap {cap}")
    state0 = sim.state

    def over_share(state):
        idx = fast_targets(sim, state, k)
        args = nlist_kick_tiles(state.positions, state.masses,
                                state.positions[idx], side, cap, t_cap,
                                config.nlist_rcut)
        return idx, args, float(
            (args[1] - t_cap).clamp_min(0).sum()) / k

    _, _, share0 = over_share(state0)
    stats, counts = logged_run(sim, "nlist_multirate_path",
                               fixed_steps=config.steps)
    check(counts["nlist_pair"] == 1 + 5 * config.steps,
          f"{counts['nlist_pair']} nlist_pair launches for {config.steps} "
          "two-rung steps")
    final = stats["final_state"]
    idx, args, share = over_share(final)
    kw = dict(cutoff=CUTOFF_RADIUS, eps=config.eps)
    kern = nlist.pair_cells_kernel(*args, **kw)
    again = nlist.pair_cells_kernel(*args, **kw)
    plain = nlist.pair_cells_plain(*args, **kw)
    scale = nlist.pair_cells_plain(*args, absolute=True, **kw)
    torch.cuda.synchronize()
    check(torch.equal(kern, again), "nlist t_cap: two launches differ")
    empty = (torch.arange(t_cap, device=kern.device)[None, :]
             >= args[1].clamp_max(t_cap)[:, None])
    check(bool((kern[empty] == 0).all()), "nlist t_cap: padded slot not 0")
    check_rec = compare("nlist_kick_t_cap", kern, plain, scale, "float32",
                        reason=NLIST_REASON)
    targets = final.positions[idx]

    def kernel():
        nlist.pair_cells_kernel(*args, **kw)

    def plain_fn():
        nlist.pair_cells_plain(*args, **kw)

    def kick():
        sim._kick(targets, final.positions, final.masses)

    cuda_ms(kernel, 3)
    ms = [cuda_ms(kernel, 30), cuda_ms(kernel, 30)]
    cuda_ms(plain_fn, 1)
    plain_ms = cuda_ms(plain_fn, 3)
    cuda_ms(kick, 3)
    kick_ms = cuda_ms(kick, 20)
    pairs = nlist.real_pairs(args[1], args[4], side, t_cap, cap)
    n_bytes = tile_bytes(args[1], args[4], side, t_cap, cap, 4, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            kick()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / 5
    timing = {
        "ms": ms[0], "ms_repeat": ms[1], "plain_ms": plain_ms,
        "pairs_evaluated": pairs,
        **bound(pairs, NLIST_FLOPS_PER_PAIR, n_bytes, device),
        "library_ms": None,
        "library_note": "no single PyTorch call computes a cell-list "
                        "pair sum",
    }
    timing["share_of_bound"] = timing["bound_ms"] / ms[0]
    record = {
        "phase": "nlist_multirate_path", "command": {
            **NLIST_RUN, "integrator": "multirate"},
        "steps": config.steps, "cut_from": NLIST_RUN["steps"],
        "k": k, "side": side, "cap": cap, "t_cap": t_cap,
        "fast_over_t_cap_share_t0": share0,
        "fast_over_t_cap_share_final": share,
        "launches": counts["nlist_pair"], "counts": counts,
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "kick_ms": kick_ms, "kick_profile": profile_record(
            prof, "nlist.", 5, wall_ms),
        "check": check_rec, "timing": timing,
        "warnings": [str(w.message) for w in caught],
        "nvidia_smi": device["nvidia_smi"],
    }
    emit(record)
    return record


def phase_mxu_multirate_path(device: dict) -> dict:
    """The flagship N = 65,536 through pallas-mxu with --integrator
    multirate (k = 8,192, sub 4), cut to 20 steps; one (8,192 x 65,536)
    kick of the final state against gram_acc4_plain, timed beside its
    bound."""
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.constants import CUTOFF_RADIUS, G
    from gravity_tpu_torch.ops import mxu_kernel
    from gravity_tpu_torch.simulation import Simulator

    config = SimulationConfig(**{**MXU_RUN, "integrator": "multirate",
                                 "steps": MXU_MULTIRATE_STEPS})
    sim = Simulator(config)
    stats, counts = logged_run(sim, "mxu_multirate_path",
                               fixed_steps=config.steps)
    check(stats["multirate_k"] == 8192, f"k {stats['multirate_k']}")
    check(counts["nbody_mxu"] == 1 + 5 * config.steps,
          f"{counts['nbody_mxu']} nbody_mxu launches for {config.steps} "
          "two-rung steps")
    final = stats["final_state"]
    idx = fast_targets(sim, final, 8192)
    pos, masses = final.positions, final.masses
    check_rec = mxu_compare("mxu_kick_8192", pos[idx], pos, masses,
                            config.eps, bf16=False)
    center = pos.mean(dim=0)
    xi = (pos[idx] - center).contiguous()
    xj = (pos - center).contiguous()
    gm = (masses * G).contiguous()

    def kernel():
        mxu_kernel.gram_acc4(xi, xj, gm, cutoff=CUTOFF_RADIUS,
                             eps=config.eps)

    def plain_fn():
        mxu_kernel.gram_acc4_plain(xi, xj, gm, cutoff=CUTOFF_RADIUS,
                                   eps=config.eps, bf16=False)

    cuda_ms(kernel, 3)
    ms = [cuda_ms(kernel, 20), cuda_ms(kernel, 20)]
    cuda_ms(plain_fn, 1)
    plain_ms = cuda_ms(plain_fn, 2)
    m, k = xi.shape[0], xj.shape[0]
    timing = {"ms": ms[0], "ms_repeat": ms[1], "plain_ms": plain_ms,
              **mxu_bound(m * k, (m * 3 + k * 4 + m * 4) * 4, device,
                          False),
              "library_ms": None,
              "library_note": "no single PyTorch call computes this sum"}
    timing["share_of_bound"] = timing["bound_ms"] / ms[0]
    record = {
        "phase": "mxu_multirate_path", "command": {
            **MXU_RUN, "integrator": "multirate"},
        "steps": config.steps, "cut_from": 500, "k": 8192,
        "launches": counts["nbody_mxu"], "counts": counts,
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "check": check_rec, "timing": timing,
        "nvidia_smi": device["nvidia_smi"],
    }
    emit(record)
    return record


def phase_adaptive_path(device: dict, base16k: dict) -> dict:
    """baseline-16k --adaptive (eta 0.025, the criterion resolves to
    accel, t_end = 500 x 3,600 s): steps, dt range, drift, ms per step
    against the fixed-dt run, and the wasted tail's evaluations."""
    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.simulation import Simulator

    config = dataclasses.replace(PRESETS["baseline-16k"], adaptive=True)
    sim = Simulator(config)
    e0 = energy_of(sim.state, config)
    stats, counts = logged_run(sim, "adaptive_path")
    check(stats["criterion"] == "accel", f"criterion {stats['criterion']}")
    check(stats["t_reached"] == config.steps * config.dt,
          f"t_reached {stats['t_reached']}")
    check(counts["nbody_direct"] == 1 + stats["adaptive_steps"]
          + stats["adaptive_tail_steps"],
          f"{counts['nbody_direct']} launches for "
          f"{stats['adaptive_steps']} steps and "
          f"{stats['adaptive_tail_steps']} tail steps")
    record = {
        "phase": "adaptive_path", "preset": "baseline-16k",
        "eta": config.eta, "criterion": stats["criterion"],
        "t_end": stats["t_end"], "t_reached": stats["t_reached"],
        "adaptive_steps": stats["adaptive_steps"],
        "dt_min": stats["dt_min"], "dt_max_used": stats["dt_max_used"],
        "tail_steps": stats["adaptive_tail_steps"],
        "launches": counts["nbody_direct"],
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "fixed_dt_ms_per_step": base16k["ms_per_step"],
        "energy_drift": abs(energy_of(stats["final_state"], config) - e0)
        / abs(e0),
        "nvidia_smi": device["nvidia_smi"],
    }
    emit(record)
    return record


def phase_external_path(device: dict) -> dict:
    """baseline-16k under an external Plummer halo of the cluster's own
    G M (a = 1e12 m), all 500 steps; the drift of KE + PE_self + PE_ext
    in float64."""
    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.constants import G
    from gravity_tpu_torch.simulation import Simulator

    base = PRESETS["baseline-16k"]
    probe = Simulator(base)
    gm = G * float(probe.state.masses.double().sum())
    spec = f"plummer:gm={gm:.6e},a={EXTERNAL_A:.0e}"
    config = dataclasses.replace(base, external=spec)
    sim = Simulator(config)
    phi = sim._ext_phi
    e0 = energy_of(sim.state, config, phi)
    e0_self = energy_of(sim.state, config)
    stats, counts = logged_run(sim, "external_path",
                               fixed_steps=config.steps)
    check(counts["nbody_direct"] == config.steps + 1,
          f"{counts['nbody_direct']} launches for {config.steps} steps")
    e1 = energy_of(stats["final_state"], config, phi)
    record = {
        "phase": "external_path", "preset": "baseline-16k",
        "external": spec, "steps": config.steps,
        "launches": counts["nbody_direct"],
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "energy_drift": abs(e1 - e0) / abs(e0),
        "external_share_of_e0": (e0 - e0_self) / e0,
        "nvidia_smi": device["nvidia_smi"],
    }
    emit(record)
    return record


def phase_merge_path(device: dict) -> dict:
    """Collision merging on reference-cuda (N = 50,000: the grid
    candidates) and baseline-16k (the chunked O(N^2) scan), each cut to
    100 steps with a check every 10, at a radius of the 20th closest
    pair of its initial state: merged pairs, one check's time, and mass
    and momentum through the first check, conserved to fp32 rounding."""
    import torch

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.ops.encounters import closest_pairs
    from gravity_tpu_torch.simulation import MERGE_GRID_THRESHOLD, Simulator

    records = {}
    for preset in ("reference-cuda", "baseline-16k"):
        base = PRESETS[preset]
        probe = Simulator(base)
        state0 = probe.state
        d, _, _ = closest_pairs(state0.positions, state0.masses,
                                k=MERGE_RANK)
        radius = float(d[MERGE_RANK - 1])
        config = dataclasses.replace(base, merge_radius=radius,
                                     merge_every=MERGE_EVERY,
                                     steps=MERGE_STEPS)
        sim = Simulator(config)
        sim.merge_pass(state0)  # first use of its ops, untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.merge_pass(state0)
        n_merged = int(res.n_merged)
        check_ms = 1e3 * (time.perf_counter() - t0)
        check(n_merged > 0, f"{preset}: no pair merged at r = {radius:.4g}")
        m0 = state0.masses.double()
        m1 = res.state.masses.double()
        p0 = (m0[:, None] * state0.velocities.double()).sum(0)
        p1 = (m1[:, None] * res.state.velocities.double()).sum(0)
        p_scale = float((m0[:, None] * state0.velocities.double().abs())
                        .sum())
        mass_err = abs(float(m1.sum() - m0.sum())) / float(m0.sum())
        mom_err = float((p1 - p0).abs().max()) / p_scale
        # Each merge rounds one mass sum and one velocity to fp32.
        check(mass_err <= n_merged * 2.0**-23,
              f"{preset}: mass changed by {mass_err:.3e}")
        check(mom_err <= n_merged * 8 * 2.0**-24,
              f"{preset}: momentum changed by {mom_err:.3e}")
        s0 = ledger_start(sim)
        stats, counts = logged_run(sim, f"merge_{preset}",
                                   fixed_steps=MERGE_STEPS)
        check(stats["merged_pairs"] > 0, f"{preset}: run merged nothing")
        records[preset] = {
            "n": base.n, "form": ("grid" if base.n >= MERGE_GRID_THRESHOLD
                                  else "chunked scan"),
            "merge_radius": radius, "radius_rule": f"closest pair "
            f"#{MERGE_RANK} of the initial state",
            "first_check_merged": n_merged, "check_ms": check_ms,
            "mass_rel_change": mass_err, "momentum_rel_change": mom_err,
            "steps": MERGE_STEPS, "cut_from": base.steps,
            "merge_every": MERGE_EVERY,
            "merged_pairs": stats["merged_pairs"],
            "launches": counts["nbody_direct"],
            "ms_per_step": 1e3 * stats["avg_step_s"],
            "io_pipeline": stats["io_pipeline"],
            # Across the run's merges: a merger dissipates kinetic energy,
            # so this drift holds that physics beside the integrator's.
            **ledger_energy_drift(sim, s0, stats["final_state"]),
        }
    record = {"phase": "merge_path", "runs": records,
              "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    return record

# The octree run: the baseline-1m preset (the JAX package's 1M disk in
# galactic units, G = 1, dt 2e-3, eps 0.05, leapfrog, leaf_cap 32, the
# depth fit to the state) with --tree-near nlist, cut to 2 of its 500
# steps (3 before the sharded-gradient phase came); with the preset's own
# gather near field, 1 step; multirate, 1 (2 each before the host path
# came).
TREE_STEPS = 2
TREE_GATHER_STEPS = 1
TREE_MULTIRATE_STEPS = 1
TREE_SAMPLE = 4096
# The JAX suite's bars for the tree against the exact sum
# (tests/test_tree.py:86-87: a 2,048-body disk at depth 5, where the leaf
# grid resolves the disk): median relative < 0.05, p90 < 0.2. At
# baseline-1m's own sizing the depth rails at 7 and ~86% of the bodies
# lie past leaf_cap in their leaf, so most of the near field is overflow
# monopoles: the JAX package measured a median of 0.0563 and a p90 of
# 0.098 there (chip_logs/cross_solver_1m_disk.log, CPU, fp64 oracle, 1,024
# targets, gather near field). The 1M path keeps the p90 bar and holds
# the median to 0.1, that measured class plus the tile engine's target
# fallback; the 2,048-body disk holds both bars as stated.
TREE_MEDIAN_BAR = 0.05
TREE_P90_BAR = 0.2
TREE_1M_MEDIAN_BAR = 0.1
# Both near fields take the same pairs where nothing overflows: the JAX
# suite's case (tests/test_nlist.py:291-305: 512 bodies over 1e12 m,
# 1e25-1e26 kg, depth 3, leaf_cap 32, eps 1e9 m), max |delta a| < 1e-5 of
# the mean |a|. The 1M random cube at depth 7 (no leaf over the cap) is
# held to it in float64; in float32 its worst target is a close pair whose
# |a| is ~10^3 the mean, so that metric reads the pair's rounding there.
NEAR_MODES_BAR = 1e-5
# The two near fields on the 1M path's final state. A target in its
# leaf's first t_cap slots takes the same pairs and the same remainder
# monopoles in both, so its gap is rounding: held per target in float64,
# and by its median in float32. A target past t_cap takes the tile
# engine's whole-cell fallback in place of the gather's pairs: the median
# gap over all targets is that fallback's (0.28% on the first runs).
NEAR_GAP_IN_SLOT_F64_BAR = 1e-10
NEAR_GAP_IN_SLOT_F32_MEDIAN_BAR = 1e-5
NEAR_GAP_MEDIAN_BAR = 0.01


@functools.lru_cache(maxsize=1)
def tree_state():
    """The baseline-1m initial disk on the card; made once."""
    import torch

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.simulation import make_initial_state

    return make_initial_state(PRESETS["baseline-1m"], torch.device("cuda", 0))


def tree_depth_of(positions) -> int:
    """The depth the path fits to a state (recommended_depth_data at
    leaf_cap 32; it rails at 7 on the 1M disk, which tree_path records)."""
    import warnings

    from gravity_tpu_torch.ops import tree

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tree.recommended_depth_data(positions, 32)


def tree_tiles(positions, masses, depth: int, leaf_cap: int = 32,
               g: float = 1.0, targets=None):
    """The near field's pair-tile kernel arguments at a state, as
    tree_accelerations_vs and nlist_near_field build them: the targets
    (the sources by default; a kick's fast rung) binned on the leaf grid
    at t_cap = leaf_cap."""
    import torch

    from gravity_tpu_torch.ops import cells, tree

    side = 1 << depth
    targets = positions if targets is None else targets
    _, origin, span, coords = tree.build_octree(positions, masses, depth)
    cells_pos, cells_mass, leaf_count, *_ = cells.bin_to_cells(
        positions, masses, coords, side, leaf_cap)
    t_coords = cells.grid_coords(targets, origin, span, side)
    tcells_pos, _, t_count, *_ = cells.bin_to_cells(
        targets, torch.ones_like(targets[:, 0]), t_coords, side, leaf_cap)
    return (tcells_pos, t_count, cells_pos, g * cells_mass, leaf_count, side,
            positions.new_zeros(1))


def tree_occupancy(args, cap: int) -> dict:
    """The leaf grid's load at these tiles, and the kernel's warp items
    (a cell's 16 target slots each) against those that hold pairs."""
    from gravity_tpu_torch.ops import nlist

    t_count, side = args[1], args[5]
    occupied = int((t_count > 0).sum())
    return {
        "side": side, "leaves": side**3, "occupied_leaves": occupied,
        "mean_occupied_load": float(t_count.sum()) / occupied,
        "max_occupancy": int(t_count.max()),
        "overflowing_leaves": int((t_count > cap).sum()),
        "bodies_past_cap_share": float((t_count - cap).clamp_min(0).sum())
        / float(t_count.sum()),
        "warp_items": side**3 * -(-cap // 16),
        "warp_items_with_pairs": int(((t_count.clamp_max(cap) + 15) // 16)
                                     .sum()),
        "pairs_evaluated": nlist.real_pairs(t_count, args[4], side, cap, cap),
    }


def phase_tree_kernel_vs_plain() -> float:
    """nlist_pair's untruncated newton form (the octree's near field) on
    the leaf blocks of the baseline-1m disk at the depth the path picks,
    against the plain version, in fp32 and fp64; a second launch gives
    the same bits. Returns the fp32 max abs error."""
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.ops import nlist

    state = tree_state()
    depth = tree_depth_of(state.positions)
    kw = dict(cutoff=CUTOFF_RADIUS, eps=0.05, use_rcut=False, kind="newton")
    errors = {}
    for dtype_name in ("float32", "float64"):
        st = state if dtype_name == "float32" else state.astype(torch.float64)
        args = tree_tiles(st.positions, st.masses, depth)
        kern = nlist.pair_cells_kernel(*args, **kw)
        again = nlist.pair_cells_kernel(*args, **kw)
        plain = nlist.pair_cells_plain(*args, **kw)
        scale = nlist.pair_cells_plain(*args, absolute=True, **kw)
        torch.cuda.synchronize()
        check(torch.equal(kern, again),
              f"tree tiles {dtype_name}: two launches differ")
        t_cap = args[0].shape[1]
        empty = (torch.arange(t_cap, device=kern.device)[None, :]
                 >= args[1].clamp_max(t_cap)[:, None])
        check(bool((kern[empty] == 0).all()),
              f"tree tiles {dtype_name}: nonzero output past a count")
        record = compare(f"baseline-1m leaf blocks depth {depth}",
                         kern.reshape(-1, 3), plain.reshape(-1, 3),
                         scale.reshape(-1, 3), dtype_name,
                         reason=NLIST_REASON)
        record.update(tree_occupancy(args, 32), depth=depth,
                      same_bits_on_repeat=True)
        emit({"phase": "tree_kernel_vs_plain", **record})
        errors[dtype_name] = record["max_abs_err"]
        del kern, again, plain, scale, args
    return errors["float32"]


def rel_errors(acc, ref) -> dict:
    """Per-target relative error of ``acc`` against ``ref`` (float64)."""
    import torch

    rel = (acc.double() - ref).norm(dim=1) / ref.norm(dim=1)
    return {"median": float(rel.median()),
            "p90": float(torch.quantile(rel, 0.9)),
            "p99": float(torch.quantile(rel, 0.99)),
            "max": float(rel.max())}


def past_t_cap(positions, masses, depth: int, t_cap: int = 32):
    """Which targets (= sources) lie past their leaf's first ``t_cap``
    slots in stable sort order, in the caller's order: the targets the
    tile engine sends through its whole-cell fallback."""
    import torch

    from gravity_tpu_torch.ops import cells, tree

    side = 1 << depth
    _, origin, span, _ = tree.build_octree(positions, masses, depth)
    t_coords = cells.grid_coords(positions, origin, span, side)
    _, _, _, start, order, sorted_ids = cells.bin_to_cells(
        positions, torch.ones_like(positions[:, 0]), t_coords, side, t_cap)
    slot = (torch.arange(positions.shape[0], device=positions.device)
            - start[sorted_ids])
    past = torch.empty_like(slot, dtype=torch.bool)
    past[order] = slot >= t_cap
    return past


def near_gap(a_nlist, a_gather, past) -> dict:
    """The two near fields' per-target relative gap, over all targets and
    apart for the targets in their leaf's slots and past t_cap."""
    rel = ((a_nlist - a_gather).double().norm(dim=1)
           / a_gather.double().norm(dim=1))
    record = {"median_rel": float(rel.median())}
    for name, sel in (("in_slot", ~past), ("past_t_cap", past)):
        part = rel[sel]
        record[name] = {"targets": int(sel.sum()),
                        "median_rel": float(part.median()),
                        "max_rel": float(part.max())}
    return record


def near_gap_faults(gaps: dict) -> list:
    """The near-mode bars a float32 reading of :func:`near_gap` breaks."""
    faults = []
    if gaps["in_slot"]["median_rel"] >= NEAR_GAP_IN_SLOT_F32_MEDIAN_BAR:
        faults.append("in-slot median gap")
    if gaps["median_rel"] >= NEAR_GAP_MEDIAN_BAR:
        faults.append("median gap")
    return faults


def broken_near_fields(positions, masses, kw: dict):
    """The tile engine's forces with one piece of its near field taken out
    for one evaluation (the piece's function in ``ops/nlist.py`` replaced
    by zeros of its output's shape): what the checks read when that piece
    is broken. Yields (piece, accelerations)."""
    from unittest import mock

    import torch

    from gravity_tpu_torch.ops import nlist, tree

    def zeros(first, *args, **kwargs):
        return torch.zeros_like(first)

    for piece, name in (("near_tiles", "pair_cells_kernel"),
                        ("remainder", "_remainder_cells"),
                        ("target_fallback", "_overflow_targets")):
        with mock.patch.object(nlist, name, zeros):
            acc = tree.tree_accelerations(positions, masses, **kw)
        yield piece, acc


def phase_tree_path(device: dict) -> dict:
    """`run --preset baseline-1m --tree-near nlist` through the Simulator
    at N = 1,048,576, cut to TREE_STEPS of its 500 steps: the near field's
    launches against the force evaluations, the peak device memory, the
    energy drift by Simulator.energy() (reported), and the forces on the
    final state in both near modes against nbody_direct at 4,096 sampled
    targets and against each other (float32 and float64, the targets in
    their leaf's slots apart), the latter also with each piece of the
    near field taken out in turn, which the near-mode bars must catch;
    then the JAX suite's 2,048-body disk on the card."""
    import dataclasses
    import warnings

    import numpy as np
    import torch

    from gravity_tpu_torch.config import PRESETS, SimulationConfig
    from gravity_tpu_torch.ops import tree
    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel
    from gravity_tpu_torch.simulation import (
        Simulator,
        _tree_kwargs,
        make_initial_state,
    )

    config = dataclasses.replace(PRESETS["baseline-1m"], tree_near="nlist",
                                 steps=TREE_STEPS)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = Simulator(config)
    check(sim.backend == "tree", f"backend {sim.backend}")
    t0 = time.perf_counter()
    e0 = sim.energy()
    energy_s = time.perf_counter() - t0
    check(isinstance(e0, np.float64), f"energy is {type(e0)}, not float64")
    torch.cuda.reset_peak_memory_stats()
    stats, counts = logged_run(sim, "tree_path", fixed_steps=config.steps)
    peak = torch.cuda.max_memory_allocated()
    evals = config.steps + 1
    check(counts["nlist_pair/near"] == evals,
          f"{counts['nlist_pair/near']} near-field launches for {evals} "
          "force evaluations")
    final = stats["final_state"]
    drift = float(abs((sim.energy() - e0) / e0))

    pos, masses = final.positions, final.masses
    gen = torch.Generator().manual_seed(17)
    idx = torch.randperm(config.n, generator=gen)[:TREE_SAMPLE].to(pos.device)
    ref = accelerations_vs_kernel(pos[idx].contiguous(), pos, masses,
                                  g=config.g, eps=config.eps).double()
    kws = {near: _tree_kwargs(dataclasses.replace(config, tree_near=near),
                              sim.tree_depth)
           for near in ("nlist", "gather")}
    accs, errors = {}, {}
    for near, kw in kws.items():
        accs[near] = tree.tree_accelerations(pos, masses, **kw)
        check(bool(torch.isfinite(accs[near]).all()),
              f"tree {near}: forces not finite")
        errors[near] = rel_errors(accs[near][idx], ref)
    gap = (accs["nlist"] - accs["gather"]).double()
    mean_a = accs["gather"].double().norm(dim=1).mean()
    # The two near fields on this state, in float32 and float64, apart for
    # the targets in their leaf's slots (the same sums in both modes).
    past = past_t_cap(pos, masses, sim.tree_depth, config.tree_leaf_cap)
    gaps = {"float32": near_gap(accs["nlist"], accs["gather"], past)}
    pos64, masses64 = pos.double(), masses.double()
    acc64 = {near: tree.tree_accelerations(pos64, masses64, **kw)
             for near, kw in kws.items()}
    gaps["float64"] = near_gap(
        acc64["nlist"], acc64["gather"],
        past_t_cap(pos64, masses64, sim.tree_depth, config.tree_leaf_cap))
    del acc64, pos64, masses64
    # What the checks read with one piece of the near field taken out.
    broken = {}
    for piece, acc in broken_near_fields(pos, masses, kws["nlist"]):
        reading = {"vs_nbody_direct": rel_errors(acc[idx], ref),
                   "near_modes_gap": near_gap(acc, accs["gather"], past)}
        reading["near_gap_faults"] = near_gap_faults(
            reading["near_modes_gap"])
        broken[piece] = reading
    small = make_initial_state(SimulationConfig(model="disk", n=2048),
                               pos.device)
    small_acc = tree.tree_accelerations(small.positions, small.masses,
                                        depth=5, g=1.0, eps=0.05,
                                        near_mode="nlist")
    small_ref = accelerations_vs_kernel(small.positions, small.positions,
                                        small.masses, g=1.0,
                                        eps=0.05).double()
    suite = rel_errors(small_acc, small_ref)
    record = {
        "phase": "tree_path", "preset": "baseline-1m", "tree_near": "nlist",
        "n": config.n, "steps": config.steps, "cut_from": 500,
        "depth": sim.tree_depth, "leaf_cap": config.tree_leaf_cap,
        "launches": counts["nlist_pair/near"], "force_evaluations": evals,
        "counts": counts, "total_s": stats["total_time_s"],
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "peak_memory_bytes": peak, "energy_drift": drift,
        "energy_eval_s": energy_s,
        "vs_nbody_direct_targets": int(idx.numel()),
        "vs_nbody_direct": errors,
        "near_modes_gap_max_over_mean_a": float(gap.abs().max() / mean_a),
        "near_modes_gap": gaps,
        "near_modes_gap_bars": {
            "float64_in_slot_max_rel": NEAR_GAP_IN_SLOT_F64_BAR,
            "float32_in_slot_median_rel": NEAR_GAP_IN_SLOT_F32_MEDIAN_BAR,
            "float32_median_rel": NEAR_GAP_MEDIAN_BAR},
        "near_field_piece_taken_out": broken,
        "jax_suite_disk_2048_depth5_nlist": suite,
        "warnings": [str(w.message)[:160] for w in caught],
        "device": stats["device"], "nvidia_smi": device["nvidia_smi"],
        "perf": stats["perf"],
    }
    emit(record)
    check(suite["median"] < TREE_MEDIAN_BAR and suite["p90"] < TREE_P90_BAR,
          f"tree on the 2,048-body disk: {suite}")
    got = errors["nlist"]
    check(got["median"] < TREE_1M_MEDIAN_BAR and got["p90"] < TREE_P90_BAR,
          f"tree nlist vs nbody_direct at 1M: {got}")
    check(gaps["float64"]["in_slot"]["max_rel"] < NEAR_GAP_IN_SLOT_F64_BAR,
          f"near modes, in-slot targets, float64: {gaps['float64']}")
    faults = near_gap_faults(gaps["float32"])
    check(not faults, f"near modes, float32: {faults}: {gaps['float32']}")
    for piece, reading in broken.items():
        check(reading["near_gap_faults"],
              f"the near-mode bars pass with the {piece} taken out: "
              f"{reading}")
    return record


def phase_tree_gather_path(device: dict) -> dict:
    """`run --preset baseline-1m` (the gather near field, plain PyTorch,
    as in the JAX package) for 3 steps; then both near fields on states
    where nothing overflows, held to 1e-5 of the mean |a|: the JAX
    suite's 512-body cloud, and the 1M random cube at depth 7 in float64
    (in float32 reported, with its worst target's relative gap)."""
    import dataclasses
    import warnings

    import torch

    from gravity_tpu_torch.config import PRESETS, SimulationConfig
    from gravity_tpu_torch.constants import G
    from gravity_tpu_torch.ops import tree
    from gravity_tpu_torch.simulation import Simulator, make_initial_state

    config = dataclasses.replace(PRESETS["baseline-1m"],
                                 steps=TREE_GATHER_STEPS)
    check(config.tree_near == "gather", "the preset's near field")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sim = Simulator(config)
    stats, counts = logged_run(sim, "tree_gather_path",
                               fixed_steps=config.steps)
    check(not any(counts.values()),
          f"the gather near field launched kernels: {counts}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(23)
    cloud = torch.rand(512, 3, generator=gen, dtype=torch.float64) * 1e12
    cloud_m = 1e25 + 9e25 * torch.rand(512, generator=gen,
                                        dtype=torch.float64)
    cube = make_initial_state(SimulationConfig(model="random",
                                               n=1_048_576), dev)
    agreement = {}
    for name, pos, masses, depth in (
            ("cloud_512", cloud.float().to(dev), cloud_m.float().to(dev), 3),
            ("random_cube_1m", cube.positions, cube.masses, 7),
            ("random_cube_1m_fp64", cube.positions.double(),
             cube.masses.double(), 7)):
        kw = dict(depth=depth, leaf_cap=32, g=G, eps=1e9)
        a_g = tree.tree_accelerations(pos, masses, near_mode="gather", **kw)
        a_n = tree.tree_accelerations(pos, masses, near_mode="nlist", **kw)
        args = tree_tiles(pos, masses, depth, g=G)
        gap = (a_n - a_g).double()
        norm = a_g.double().norm(dim=1)
        worst = int(gap.norm(dim=1).argmax())
        agreement[name] = {
            "n": pos.shape[0], "depth": depth, "dtype": str(pos.dtype),
            "max_occupancy": int(args[1].max()),
            "max_over_mean_a": float(gap.abs().max() / norm.mean()),
            "worst_target_a_over_mean_a": float(norm[worst] / norm.mean()),
            "max_rel": float((gap.norm(dim=1) / norm).max()),
        }
        del a_g, a_n, args
    record = {
        "phase": "tree_gather_path", "preset": "baseline-1m",
        "tree_near": "gather", "steps": config.steps, "cut_from": 500,
        "depth": sim.tree_depth, "counts": counts,
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "near_modes_without_overflow": agreement,
        "bar": NEAR_MODES_BAR, "nvidia_smi": device["nvidia_smi"],
    }
    emit(record)
    for name in ("cloud_512", "random_cube_1m_fp64"):
        rec = agreement[name]
        check(rec["max_occupancy"] <= 32, f"{name} overflows")
        check(rec["max_over_mean_a"] < NEAR_MODES_BAR,
              f"{name}: near modes differ by {rec['max_over_mean_a']:.3e} "
              "of the mean |a| where nothing overflows")
    return record


def phase_tree_multirate_path(device: dict) -> dict:
    """baseline-1m --tree-near nlist --integrator multirate (two rungs, k
    = n / 8, sub 4), TREE_MULTIRATE_STEPS steps: each fast kick launches
    the near field at the fast targets against all sources."""
    import dataclasses
    import warnings

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.simulation import Simulator

    config = dataclasses.replace(PRESETS["baseline-1m"], tree_near="nlist",
                                 integrator="multirate",
                                 steps=TREE_MULTIRATE_STEPS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sim = Simulator(config)
    stats, counts = logged_run(sim, "tree_multirate_path",
                               fixed_steps=config.steps)
    check(counts["nlist_pair/near"] == 1 + 5 * config.steps,
          f"{counts['nlist_pair/near']} near-field launches for "
          f"{config.steps} two-rung steps")
    record = {
        "phase": "tree_multirate_path", "preset": "baseline-1m",
        "tree_near": "nlist", "steps": config.steps, "cut_from": 500,
        "k": sim._multirate_plan()[0], "launches": counts["nlist_pair/near"],
        "counts": counts, "ms_per_step": 1e3 * stats["avg_step_s"],
        "nvidia_smi": device["nvidia_smi"],
    }
    emit(record)
    return record


def tree_force_eval(state, depth: int):
    """One baseline-1m --tree-near nlist force evaluation of ``state``."""
    import dataclasses

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.ops import tree
    from gravity_tpu_torch.simulation import _tree_kwargs

    config = dataclasses.replace(PRESETS["baseline-1m"], tree_near="nlist")
    return tree.tree_accelerations(state.positions, state.masses,
                                   **_tree_kwargs(config, depth))


def phase_timing_tree(device: dict, build: dict) -> dict:
    """The near field's kernel at the baseline-1m leaf blocks by CUDA
    events, beside its bound for the pairs these counts need, its issue
    floor, its plain version, the same launch on an empty grid of the same
    side (what the items without pairs cost), and a whole evaluation."""
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.ops import nlist

    state = tree_state()
    depth = tree_depth_of(state.positions)
    args = tree_tiles(state.positions, state.masses, depth)
    side = args[5]
    empty_args = (args[0], torch.zeros_like(args[1]), args[2], args[3],
                  torch.zeros_like(args[4]), side, args[6])
    kw = dict(cutoff=CUTOFF_RADIUS, eps=0.05, use_rcut=False, kind="newton")

    def kernel():
        nlist.pair_cells_kernel(*args, **kw)

    def empty_grid():
        nlist.pair_cells_kernel(*empty_args, **kw)

    def plain():
        nlist.pair_cells_plain(*args, **kw)

    def force_eval():
        tree_force_eval(state, depth)

    cuda_ms(kernel, 3)
    ms = cuda_ms(kernel, 20)
    cuda_ms(empty_grid, 3)
    empty_ms = cuda_ms(empty_grid, 20)
    cuda_ms(plain, 1)
    plain_ms = cuda_ms(plain, 3)
    ms_again = cuda_ms(kernel, 20)
    cuda_ms(force_eval, 1)
    eval_ms = cuda_ms(force_eval, 3)
    occupancy = tree_occupancy(args, 32)
    pairs = occupancy["pairs_evaluated"]
    n_bytes = tile_bytes(args[1], args[4], side, 32, 32, 4, 0)
    instrs = per_pair(build, "nlist_pair", "nlist_pair_kernel<fLi0ELb0ELb1>")
    record = {
        "phase": "timing_tree", "kernel": "nlist_pair/near", "depth": depth,
        "n": state.n, "dtype": "float32", **occupancy,
        "ms": ms, "ms_repeat": ms_again, "empty_grid_ms": empty_ms,
        "plain_ms": plain_ms,
        **bound(pairs, NLIST_FLOPS_PER_PAIR, n_bytes, device),
        "bytes": n_bytes,
        "sass_instrs_per_pair": instrs,
        "issue_floor_ms": issue_floor_ms(pairs, instrs, device),
        "force_eval_ms": eval_ms,
        "library_ms": None,
        "library_note": "no single PyTorch call computes a cell-list "
                        "pair sum",
        "nvidia_smi": device["nvidia_smi"],
    }
    record["share_of_bound"] = record["bound_ms"] / ms
    emit(record)
    return record


def device_ms(prof, evals: int, match) -> float:
    """Device ms an evaluation of the profiled kernels whose name
    ``match`` accepts."""
    total = 0.0
    for item in prof.key_averages():
        if "CUDA" in str(getattr(item, "device_type", "")) and match(item.key):
            us = getattr(item, "device_time_total", None)
            total += us if us is not None else item.cuda_time_total
    return total / evals / 1e3


def phase_profile_tree(bf16: bool = False) -> dict:
    """Where a baseline-1m --tree-near nlist force evaluation's device
    time goes: the PyTorch profiler over 2 evaluations, device time by
    kernel and the device span of each stage ops/tree.py and
    nlist_near_field name (tree.build, tree.far, tree.bin_targets,
    tree.near_tiles, tree.remainder, tree.overflow_targets) over one
    evaluation (its ~20k launches keep the profiler busy for tens of
    seconds); the peak device memory of one evaluation. With ``bf16``
    the state is rounded to bf16 (phase profile_tree_bf16), and the
    record adds the build's bf16 segment sums: their kernels' device time,
    the spans of their plans (sort and search, ``segment_sum.plan``) and
    of their gathers and launches (``segment_sum.sum``), and their launches
    (exactly TREE_SUMS_PER_LEVEL a level)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gravity_tpu_torch.ops import cells

    state = tree_state()
    if bf16:
        state = state.astype(torch.bfloat16)
    depth = tree_depth_of(state.positions)
    tree_force_eval(state, depth)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tree_force_eval(state, depth)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    evals = 1
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(evals):
            tree_force_eval(state, depth)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / evals
    launches = cells.LAUNCHES
    record = profile_record(prof, ("tree.", "segment_sum."), evals, wall_ms)
    record.update(phase="profile_tree_bf16" if bf16 else "profile_tree",
                  depth=depth, dtype=str(state.positions.dtype),
                  peak_memory_bytes=peak, memory_before_eval_bytes=base)
    if bf16:
        record.update(
            segment_sum_kernels_ms_per_eval=device_ms(
                prof, evals, lambda key: "segment_sum_" in key),
            segment_sum_launches_per_eval=launches / evals)
        check(launches == TREE_SUMS_PER_LEVEL * (depth + 1) * evals,
              f"bf16 tree build: {launches} segment-sum launches in "
              f"{evals} evaluations at depth {depth}")
    emit(record)
    return record


# ---------------------------------------------------------------------------
# bf16 states through the cell list and the octree: nlist_pair's bf16 form.
# ---------------------------------------------------------------------------

# The bf16 form against pair_cells_plain at bf16, in units of each row's
# sum of |terms|. Both round every op of a term alike and take the same
# masks; a term differs only where rsqrt.approx and the plain rsqrt land
# one bf16 ulp apart (3 x 2^-8 of that term, through the weight's three
# products). Each row is an fp32 sum in another order (~cap 2^-24 apart),
# rounded to bf16 once and added into the bf16 accumulator: where a row
# lands one ulp (at most 2^-7 of the row's sum of |terms|) apart, the
# accumulator carries it. A few such ulps a target: 2^-5.
NLIST_BF16_TOL = 2.0**-5
NLIST_BF16_REASON = ("in units of the row's sum of |terms|: terms rounded to "
                     "bf16 op by op as the plain version, the same masks; "
                     "rsqrt may round one bf16 ulp apart (3 x 2^-8 of a "
                     "term); rows are fp32 sums in another order, each "
                     "rounded once into a bf16 accumulator: a few ulps "
                     "(2^-7) a target")
# The README nlist run at --dtype bfloat16, cut to 100 of its 500 steps;
# multirate cut to 20.
NLIST_BF16_STEPS = 100
NLIST_BF16_MULTIRATE_STEPS = 20
# baseline-1m at --dtype bfloat16: --tree-near nlist cut to 2 of 500
# steps (3 before the sharded-gradient phase came), the gather near
# field and multirate to 1 each.
TREE_BF16_STEPS = 2
TREE_BF16_GATHER_STEPS = 1
TREE_BF16_MULTIRATE_STEPS = 1
# bf16 segment-sum launches a level of an octree build: the cell masses
# and weighted positions in one, the quadrupoles in a second
# (tree.build_octree through cells.Segments).
TREE_SUMS_PER_LEVEL = 2
# The JAX package's own bf16 tree against fp32 on baseline-1m's initial
# disk rounded to bf16, at the 4,096 targets tree paths sample (seed 17),
# gather near field, direct far field, depth 7: the median and p90 of the
# per-target relative error, on the CPU, from
# scripts/jax_bf16_tree_figure.py. The bf16 path is held to at most 1.5x
# each. The reference's bf16 tree is far off at this size: its cell
# totals are bf16 segment sums, which stall once a body's m / max(m)
# (5e-6 here) falls below half an ulp of the running sum (after 256 to
# 512 such bodies, at ~2e-3 of a true total near 5), so every coarse
# cell gets too little mass and the far field is wrong by a median 71%
# of |a|.
JAX_BF16_TREE = {"vs_fp32_tree": {"median": 0.7108528233921156,
                                  "p90": 3.5809018798667203},
                 "vs_fp32_direct": {"median": 0.718638604370603,
                                    "p90": 3.515180550317095}}
TREE_BF16_FACTOR = 1.5
# The JAX package's own bf16 cell list against its fp32 one on the README
# state rounded to bf16, every target (jnp engine, side 12, cap 256), on
# the CPU, from scripts/jax_bf16_figures.py. It misses the dense bf16
# bar of tests/test_bfloat16.py (median < 1e-2) by itself: rcut_eff^2
# rounds to bf16 (2^-9 of it), so the pairs within that band of rcut, each
# as large as any other pair's term in a uniform state, enter one sum and
# not the other. The bf16 nlist path is held to at most 1.5x this figure,
# median and p90, as the tree is; the suite's bars are reported beside.
JAX_BF16_NLIST = {"median": 0.010319506496561274,
                  "p90": 0.026686674180806887}
# The two near fields at bf16 on the final state. A target in its leaf's
# slots takes the same terms in both (the same bf16 roundings of d, r^2,
# rsqrt and the weight), but the tile engine rounds its near-field sum 54
# times (27 rows, 27 accumulator adds, 2^-9 each of at most the near
# field's sum of |terms|) where the gather rounds it once: a median under
# 2^-6 of |a|. Over all targets the t_cap fallback adds its own gap (0.28%
# in fp32): a median under 2^-5.
NEAR_GAP_BF16_IN_SLOT_MEDIAN_BAR = 2.0**-6
NEAR_GAP_BF16_MEDIAN_BAR = 2.0**-5


def conversion_floor_ms(pairs, cvt_per_pair, device):
    """Least time to issue ``pairs`` x ``cvt_per_pair`` fp32-to-bf16
    conversions at their pipe's rate (16 per SM per clock): a floor of the
    design, not of the work (bf16x2 arithmetic rounds without them)."""
    if not isinstance(cvt_per_pair, float):
        return "not measured"
    return 1e3 * pairs * cvt_per_pair / (
        device["sm_count"] * CVT_PER_SM_PER_CLOCK
        * device["max_sm_clock_mhz"] * 1e6)


def nlist_bf16_check(name, args, kw) -> dict:
    """The bf16 form against pair_cells_plain at bf16 on these tiles:
    within NLIST_BF16_TOL of each row's sum of |terms|, zeros past each
    cell's count, the same bits on a second launch; the share of outputs
    with the plain version's bits."""
    import torch

    from gravity_tpu_torch.ops import nlist

    kern = nlist.pair_cells_kernel(*args, **kw)
    again = nlist.pair_cells_kernel(*args, **kw)
    plain = nlist.pair_cells_plain(*args, **kw)
    scale = nlist.pair_cells_plain(*args, absolute=True, **kw)
    torch.cuda.synchronize()
    check(kern.dtype == torch.bfloat16, f"{name}: output {kern.dtype}")
    check(torch.equal(kern, again), f"{name}: two launches differ")
    t_cap, cap, side = args[0].shape[1], args[2].shape[1], args[5]
    real = (torch.arange(t_cap, device=kern.device)[None, :]
            < args[1].clamp_max(t_cap)[:, None])
    check(bool((kern[~real] == 0).all()),
          f"{name}: nonzero output past a cell's count")
    record = compare(name, kern.reshape(-1, 3), plain.reshape(-1, 3),
                     scale.reshape(-1, 3), "bfloat16", tol=NLIST_BF16_TOL,
                     reason=NLIST_BF16_REASON)
    record.update({
        "side": side, "t_cap": t_cap, "cap": cap,
        "use_rcut": kw.get("use_rcut", True),
        "same_bits_as_plain": float((kern[real] == plain[real]).float()
                                    .mean()),
        "bitwise_repeatable": True,
        "pairs_evaluated": nlist.real_pairs(args[1], args[4], side, t_cap,
                                            cap),
    })
    return record


def nlist_bf16_config(**fields):
    from gravity_tpu_torch.config import SimulationConfig

    return SimulationConfig(**{**NLIST_RUN, "dtype": "bfloat16", **fields})


# The depth the tree paths fit to the baseline-1m disk (tree_depth_of
# rails at 7 there).
TREE_DEPTH = 7


def segment_sum_cases(state, depth: int = TREE_DEPTH):
    """(name, values, ids, n) of the bf16 segment sums an octree build of
    ``state`` takes at levels 0, 3 and ``depth``: one, three and six
    columns (mass, weighted position, a quadrupole's six)."""
    import torch

    from gravity_tpu_torch.ops import tree

    pos, m = state.positions, state.masses
    coords = tree.build_octree(pos, m, depth)[3]
    m_hat = m / m.max()
    mw = m_hat[:, None] * pos
    six = torch.cat([mw, mw * mw], dim=1)
    for d in (0, 3, depth):
        sd = 1 << d
        cd = coords >> (depth - d)
        ids = (cd[:, 0] * sd + cd[:, 1]) * sd + cd[:, 2]
        for values in (m_hat, mw, six):
            cols = 1 if values.dim() == 1 else values.shape[1]
            yield f"level {d} ({sd**3} cells) x {cols}", values, ids, sd**3


def bits_equal(a, b) -> bool:
    """The same shape and bits, NaN's bits too."""
    import torch

    return tuple(a.shape) == tuple(b.shape) and torch.equal(
        a.cpu().contiguous().view(torch.int16),
        b.cpu().contiguous().view(torch.int16))


TINY_EARLY_CASE = "1,048,576 rows, one segment, a tiny row early"


def segment_sum_edge_cases(dev):
    """(name, values, ids, n) of the bf16 sums' edge cases, made on the
    CPU from a seed and moved to ``dev``: ones that stall at 256, signed
    zeros, subnormals (flushed, as the JAX package's CPU sums flush them),
    +-inf and NaN (the kernel writes 0x7fc0, the CPU's NaN), empty
    segments, 1,048,576 rows of three columns in one segment, the same
    with a tiny row (nonzero, below 2^-119) early in three of four
    columns, which takes the kernel's flushing chain
    (:data:`TINY_EARLY_CASE`), and sums that cancel down to the least
    normal 2^-126 with no tiny row, which do not."""
    import torch

    gen = torch.Generator().manual_seed(23)
    bf16 = torch.bfloat16

    def ids_of(n_rows, n):
        return torch.randint(0, n, (n_rows,), generator=gen)

    def pick(choices, shape):
        table = torch.tensor(choices, dtype=torch.float32)
        return table[torch.randint(0, len(choices), shape, generator=gen)]

    inf = float("inf")
    nan_inf = pick([inf, -inf, 1.0, 2.0, 3e38, float("nan")], (600, 3))
    # 2^-119 and the subnormal -2^-127 open a column of signed zeros: its
    # total is 2^-119 flushed, 255 2^-127 not
    tiny_early = torch.randn(1 << 20, 4, generator=gen)
    tiny_early[3, 0] = 2.0**-130
    tiny_early[:, 1] = pick([0.0, -0.0], (1 << 20,))
    tiny_early[:2, 1] = torch.tensor([2.0**-119, -(2.0**-127)])
    tiny_early[5, 3] = -1.5 * 2.0**-126
    # pairs +m 2^-126, -(m +- 1) 2^-126, m in [129, 254]: partial sums
    # step by 2^-126 about zero
    m = torch.randint(129, 255, (1 << 17, 3), generator=gen).float()
    step = pick([-1.0, 1.0], (1 << 17, 3))
    cancel = torch.stack([m, -(m + step)], dim=1).reshape(1 << 18, 3) \
        * 2.0**-126
    cases = [
        ("ones stall at 256", torch.ones(5000, 3),
         torch.repeat_interleave(torch.arange(3), torch.tensor([4000, 700,
                                                                300])), 3),
        ("signed zeros", pick([0.0, -0.0], (400, 4)), ids_of(400, 6), 6),
        ("subnormals", pick([2.0**-130, -(2.0**-131), 2.0**-133, 2.0**-126,
                             -1.5 * 2.0**-126, 0.0], (600, 4)),
         ids_of(600, 5), 5),
        ("inf and nan", nan_inf, ids_of(600, 40), 40),
        ("empty segments", torch.randn(5000, 4, generator=gen),
         torch.tensor([3, 17, 18, 4000])[torch.randint(0, 4, (5000,),
                                                       generator=gen)],
         8192),
        ("1,048,576 rows, one segment",
         torch.randn(1 << 20, 3, generator=gen),
         torch.zeros(1 << 20, dtype=torch.int64), 1),
        (TINY_EARLY_CASE, tiny_early,
         torch.zeros(1 << 20, dtype=torch.int64), 1),
        ("cancelling to 2^-126, no tiny row", cancel,
         torch.arange(16).repeat_interleave(1 << 14), 16),
    ]
    for name, values, ids, n in cases:
        yield name, values.to(bf16).to(dev), ids.to(dev), n


@functools.lru_cache(maxsize=1)
def chain_cycles() -> float:
    """Cycles of one add.rn.bf16 in a dependent chain, measured now on the
    card by ``scripts/chain_latency.py``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chain_latency", os.path.join(REPO, "scripts", "chain_latency.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.cycles_per_step(module.FORMS.index("bf16_add"))


def with_sm_clock(fn) -> tuple:
    """``fn()`` while a thread samples the SM clock with nvidia-smi:
    (its result, the median MHz of the samples, the samples)."""
    import threading

    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(float(nvidia_smi("clocks.sm",
                                            "--format=csv,noheader,nounits")))
            stop.wait(0.05)

    thread = threading.Thread(target=sample)
    thread.start()
    try:
        result = fn()
    finally:
        stop.set()
        thread.join()
    return result, statistics.median(samples), samples


def segment_sum_sass(build: dict) -> dict:
    """The long grid's row loop, read off its SASS (``sass_loops``): its
    instructions and bf16 adds (HADD2, HFMA2) a row, a row being 1/8 of a
    16-byte load (LDG)."""
    loops = build["segment_sum"]["sass"].get("segment_sum_long_kernel")
    if not loops:
        return {"not measured": "no SASS of segment_sum_long_kernel"}
    loop = max(loops, key=lambda x: x["hadd2"] + x["hfma2"])
    adds = loop["hadd2"] + loop["hfma2"]
    rows = 8 * loop["ldg"]
    return {"loop": loop, "bf16_adds_per_row": adds / rows,
            "instrs_per_row": loop["instrs"] / rows}


def segment_sum_check_cases() -> list:
    """(name, values, ids, n) on the card of every sum the segment-sum
    phase holds to the plain version (and ``scripts/segment_sum_ab.py`` to
    another build): a bf16 octree build of the baseline-1m disk, the README
    nlist state's cell totals and the edge cases."""
    import torch

    from gravity_tpu_torch.ops import cells, nlist
    from gravity_tpu_torch.simulation import make_initial_state

    tstate = tree_state().astype(torch.bfloat16)
    nstate = make_initial_state(nlist_bf16_config(), torch.device("cuda", 0))
    side, _ = nlist.resolve_nlist_sizing(nstate.positions,
                                         NLIST_RUN["nlist_rcut"])
    origin, span = cells.bounding_cube(nstate.positions)
    nids = cells.cell_ids(cells.grid_coords(nstate.positions, origin, span,
                                            side), side)
    n_hat = nstate.masses / nstate.masses.max()
    return (list(segment_sum_cases(tstate)) + [
        (f"README nlist cells ({side**3}) x 1", n_hat, nids, side**3),
        (f"README nlist cells ({side**3}) x 3",
         n_hat[:, None] * nstate.positions, nids, side**3)]
        + list(segment_sum_edge_cases(tstate.positions.device)))


def phase_segment_sum_bf16(device: dict, build: dict) -> dict:
    """The bf16 segment-sum kernel against its plain version (the CPU's
    element-order sum, on copies of the same inputs), bit for bit and again
    on a second launch: at the sums of a bf16 octree build of the
    baseline-1m disk (levels 0, 3 and 7, one, three and six columns, and
    the build's own four-column mass and weighted-position sums), at the
    README nlist state's cell totals, and at the edge cases. Then the
    level-0 and leaf-level sums timed by CUDA events: the kernel alone
    (``segment_sum_rows`` on a made plan) and the whole wrapper call (plan,
    gather, launch), beside the plan, the plain version (host clock),
    index_add_ on the card (the library call; bf16 atomics) and the bound:
    the longest segment's rows x the latency of one add.rn.bf16 (measured
    now, ``scripts/chain_latency.py``) at the SM clock sampled while the
    kernel runs, the bytes beside it."""
    import torch

    from gravity_tpu_torch.ops import cells, tree

    tstate = tree_state().astype(torch.bfloat16)
    checked = []
    for name, values, ids, n in segment_sum_check_cases():
        kern = cells.segment_sum_bf16(values, ids, n)
        again = cells.segment_sum_bf16(values, ids, n)
        plain = cells.segment_sum_bf16_plain(values.cpu(), ids.cpu(), n)
        torch.cuda.synchronize()
        check(bits_equal(kern, again), f"segment sum {name}: runs differ")
        if name == TINY_EARLY_CASE:
            # the flush fired on the card: column 1's unflushed total
            # (index_add_ alone) is 255 2^-127, its flushed one 2^-119
            unflushed = torch.zeros(1, dtype=values.dtype).index_add_(
                0, ids.cpu(), values[:, 1].cpu())
            check(not bits_equal(kern[:, 1], unflushed),
                  f"segment sum {name}: the flush did not change column 1")
        same = bits_equal(kern, plain)
        gap = (kern.cpu().double() - plain.double())[torch.isfinite(plain)]
        checked.append({
            "case": name, "rows": values.shape[0], "segments": n,
            "same_bits_as_plain": same,
            "max_abs_err": float(gap.abs().max()) if gap.numel() else 0.0})
        check(same, f"segment sum {name}: not the plain version's bits")
    cycles = chain_cycles()
    sass = segment_sum_sass(build)
    timing = {}
    for name, parts, ids, n in timed_segment_sums(tstate):
        values = parts[0] if len(parts) == 1 else None
        segments = cells.Segments(ids, n)
        _, starts = segments.plan()
        rows = segments.gather(*parts)
        cols, n_rows = rows.shape[0], ids.shape[0]
        lengths = starts.diff()
        longest = int(lengths.max())
        merged = cells.Segments(ids, n).sum(*parts)
        check(all(bits_equal(m, cells.segment_sum_bf16_plain(
            p.cpu(), ids.cpu(), n)) for m, p in zip(merged, parts)),
            f"segment sum {name}: merged columns differ from the plain "
            "version")

        def kernel(rows=rows, starts=starts, n_rows=n_rows):
            cells.segment_sum_rows(rows, starts, n_rows)

        def wrapper(parts=parts, ids=ids, n=n):
            cells.Segments(ids, n).sum(*parts)

        def plan(ids=ids, n=n):
            cells.Segments(ids, n).plan()

        cuda_ms(kernel, 2)
        reps = 100 if n == 1 else 400
        ms, clock_mhz, samples = with_sm_clock(lambda: cuda_ms(kernel, reps))
        ms_repeat = cuda_ms(kernel, reps // 4)
        cuda_ms(wrapper, 2)
        wrapper_ms = cuda_ms(wrapper, 10)
        plan_ms = cuda_ms(plan, 10)
        library_ms = None
        if values is not None:
            def library(values=values, ids=ids, n=n, cols=cols):
                torch.zeros((n, cols), dtype=values.dtype,
                            device=values.device).index_add_(
                    0, ids, values.reshape(n_rows, cols))

            library_ms = cuda_ms(library, 1)
        host = ([p.cpu() for p in parts], ids.cpu())
        t0 = time.perf_counter()
        for p in host[0]:
            cells.segment_sum_bf16_plain(p, host[1], n)
        plain_ms = 1e3 * (time.perf_counter() - t0)
        n_bytes = n_rows * (2 * cols + 8) + n * cols * 2
        byte_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
        chain_ms = 1e3 * longest * cycles / (clock_mhz * 1e6)
        bound_ms = max(chain_ms, byte_ms)
        timing[name] = {
            "cols": cols, "rows": n_rows, "segments": n,
            "longest_segment_rows": longest,
            "occupied_segments": int((lengths > 0).sum()),
            "ms": ms, "ms_repeat": ms_repeat, "kernel_reps": reps,
            "wrapper_ms": wrapper_ms, "plan_ms": plan_ms,
            "plain_ms": plain_ms, "plain_on": "host CPU (host clock)",
            "library_ms": library_ms,
            "library_note": "index_add_ on the card: bf16 atomics, another "
                            "order of adds each run" if values is not None
                            else "not timed for merged columns",
            "bound_ms": bound_ms,
            "bound_by": "operations" if chain_ms >= byte_ms else "bytes",
            "bound_note": "the longest segment's dependent bf16 adds, one "
                          "a measured add.rn.bf16 latency at the sampled SM "
                          "clock (a chain issues no faster); the bytes "
                          "beside",
            "chain_bound_ms": chain_ms, "bytes_bound_ms": byte_ms,
            "bytes": n_bytes, "add_cycles": cycles,
            "sm_clock_mhz": clock_mhz, "sm_clock_samples": samples,
            "share_of_bound": bound_ms / ms,
            "sass": sass, "nvidia_smi": device["nvidia_smi"],
        }
    # A bf16 build's chain bound: each level's longest cell, twice (its
    # two launches), against the same launches batched over all levels.
    coords = tree.build_octree(tstate.positions, tstate.masses,
                               TREE_DEPTH)[3]
    longest_by_level = [
        int(torch.bincount(cells.cell_ids(coords >> (TREE_DEPTH - d), 1 << d),
                           minlength=8**d).max())
        for d in range(TREE_DEPTH + 1)]
    clock_mhz = timing[next(iter(timing))]["sm_clock_mhz"]
    record = {"phase": "segment_sum_bf16", "cases": checked,
              "timing": timing,
              "build_longest_segment_rows_by_level": longest_by_level,
              "build_chain_bound_ms": 1e3 * TREE_SUMS_PER_LEVEL
              * sum(longest_by_level) * cycles / (clock_mhz * 1e6),
              "build_chain_bound_batched_ms": 1e3 * TREE_SUMS_PER_LEVEL
              * max(longest_by_level) * cycles / (clock_mhz * 1e6)}
    emit(record)
    by_level = {k.split(" (")[0] + (" merged" if "merged" in k else ""): v
                for k, v in timing.items()}
    return {"max_abs_err": max(c["max_abs_err"] for c in checked),
            "timing": by_level["level 0"],
            "leaf": by_level[f"level {TREE_DEPTH}"], "timing_by_case": timing}


def timed_segment_sums(state):
    """(name, values, ids, n) of the timed sums of a bf16 octree build of
    ``state`` at levels 0 and TREE_DEPTH: three columns (the weighted
    positions) and the build's own merged launch (mass and weighted
    position, four columns)."""
    from gravity_tpu_torch.ops import tree

    pos, m = state.positions, state.masses
    coords = tree.build_octree(pos, m, TREE_DEPTH)[3]
    m_hat = m / m.max()
    mw = m_hat[:, None] * pos
    for d in (0, TREE_DEPTH):
        sd = 1 << d
        cd = coords >> (TREE_DEPTH - d)
        ids = (cd[:, 0] * sd + cd[:, 1]) * sd + cd[:, 2]
        yield f"level {d} ({sd**3} cells) x 3", (mw,), ids, sd**3
        yield (f"level {d} ({sd**3} cells) x 4 merged", (m_hat, mw), ids,
               sd**3)


def bf16_subnormal_case(dev, kernel: str = "nlist_pair/bf16",
                        eps: float = 0.0) -> dict:
    """Two bodies 1e12 m apart (inside the radius, for the cell list) at
    bf16: the 1.5e7 kg body's weight on the other, G m / r^3 = 1e-39, lies
    in fp32's and bf16's subnormal range, so a kernel that flushed
    subnormals would return 0 for its pull (1e-27 m/s^2). ``kernel``'s
    bf16 form (``nlist_pair/bf16``, or ``nbody_direct`` at softening
    ``eps``) must give the plain version's bits, nonzero, within 25% of
    float64 (a bf16 subnormal near 1e-39 holds ~4 bits)."""
    import torch

    from gravity_tpu_torch.constants import G
    from gravity_tpu_torch.ops import nlist
    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel

    pos = torch.tensor([[0.0, 0.0, 0.0], [1e12, 0.0, 0.0],
                        [2.2e12, 0.0, 0.0]], dtype=torch.bfloat16)
    masses = torch.tensor([1e24, 1.5e7, 0.0], dtype=torch.bfloat16)

    def run(p, m):
        # CPU tensors take the plain version, CUDA tensors the kernel.
        if kernel == "nbody_direct":
            return accelerations_vs_kernel(p, p, m, eps=eps)
        return nlist.nlist_accelerations(p, m, rcut=1.2e12, side=2, cap=8)

    plain = run(pos, masses)
    reset_counts()
    kern = run(pos.to(dev), masses.to(dev)).cpu()
    check(read_counts()[kernel] == 1, f"{kernel} bf16 subnormal: no launch")
    p, m = pos.double(), masses.double()
    want = G * m[1] / (p[1, 0] - p[0, 0]) ** 2
    rel = float(abs(kern[0, 0].double() - want) / want)
    check(torch.equal(kern, plain), f"{kernel} bf16 subnormal weight: "
          f"kernel {kern[:2, 0].tolist()} against plain "
          f"{plain[:2, 0].tolist()}")
    check(float(kern[0, 0]) != 0.0 and rel < 0.25,
          f"{kernel} bf16 subnormal weight flushed or off: {kern[0, 0]}, "
          f"{rel}")
    return {"case": f"{kernel}: 2 bodies 1e12 m bf16 eps={eps:g} (weight "
                    "1e-39, subnormal)",
            "acc_x": kern[:2, 0].tolist(), "same_bits_as_plain": True,
            "rel_err_vs_fp64": rel, "tolerance": 0.25}


def phase_nlist_bf16_kernel_vs_plain() -> dict:
    """nlist_pair's bf16 form against the plain version at bf16 on the
    tiles of the README nlist state (side 12, cap 256, rcut form), of a
    multirate kick there (k = n / 8 targets at the occupancy model's
    t_cap below the cap), of the baseline-1m leaf blocks (side 128, t_cap
    = cap = 32, untruncated), and on the count edge cases. Returns the
    records by launch: "readme", "t_cap", "near"."""
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.ops import nlist
    from gravity_tpu_torch.simulation import (
        _occupancy_t_cap,
        make_initial_state,
    )

    dev = torch.device("cuda", 0)
    config = nlist_bf16_config()
    state = make_initial_state(config, dev)
    side, cap = nlist.resolve_nlist_sizing(state.positions, config.nlist_rcut)
    kw = dict(cutoff=CUTOFF_RADIUS, eps=config.eps)
    records = {"readme": nlist_bf16_check(
        "README state N=262144 bf16", nlist_tiles(
            state.positions, state.masses, side, cap, config.nlist_rcut),
        kw)}
    k = config.n // 8
    t_cap = _occupancy_t_cap(cap, k, config.n, state.positions, side,
                             "nlist bf16 kick")
    check(t_cap < cap, f"kick t_cap {t_cap} not below cap {cap}")
    gen = torch.Generator().manual_seed(29)
    idx = torch.randperm(config.n, generator=gen)[:k].to(dev)
    records["t_cap"] = nlist_bf16_check(
        f"README state kick k={k} t_cap={t_cap} bf16", nlist_kick_tiles(
            state.positions, state.masses, state.positions[idx], side, cap,
            t_cap, config.nlist_rcut), kw)
    del state
    tstate = tree_state().astype(torch.bfloat16)
    depth = tree_depth_of(tstate.positions)
    records["near"] = nlist_bf16_check(
        f"baseline-1m leaf blocks depth {depth} bf16",
        tree_tiles(tstate.positions, tstate.masses, depth),
        dict(cutoff=CUTOFF_RADIUS, eps=0.05, use_rcut=False, kind="newton"))
    records["near"]["depth"] = depth
    for record in records.values():
        emit({"phase": "nlist_bf16_kernel_vs_plain", **record})
    emit({"phase": "nlist_bf16_kernel_vs_plain", **bf16_subnormal_case(dev)})
    count_edge_cases("newton", NLIST_BF16_REASON, "bfloat16", NLIST_BF16_TOL,
                     phase="nlist_bf16_kernel_vs_plain")
    return records


def nlist_bf16_timing(args, kw, device, build, loop, reps=30) -> dict:
    """The bf16 form at these tiles by CUDA events (twice), its plain
    version, its bound for the pairs these counts need (21 flops a pair at
    the bf16x2 rate, rsqrt on the SFUs, bytes at 2 an element), the
    conversions' floor and the issue floor of its SASS loop ``loop``."""
    from gravity_tpu_torch.ops import nlist

    t_cap, cap, side = args[0].shape[1], args[2].shape[1], args[5]

    def kernel():
        nlist.pair_cells_kernel(*args, **kw)

    def plain():
        nlist.pair_cells_plain(*args, **kw)

    cuda_ms(kernel, 3)
    ms = [cuda_ms(kernel, reps), cuda_ms(kernel, reps)]
    cuda_ms(plain, 1)
    plain_ms = cuda_ms(plain, 3)
    pairs = nlist.real_pairs(args[1], args[4], side, t_cap, cap)
    n_bytes = tile_bytes(args[1], args[4], side, t_cap, cap, 2,
                         1 if kw.get("use_rcut", True) else 0)
    instrs = per_pair(build, "nlist_pair", loop)
    cvt = per_pair(build, "nlist_pair", loop, "cvt")
    check(not isinstance(cvt, float) or cvt <= BF16X2_MAX_CVT,
          f"{loop}: {cvt} conversions a pair")
    record = {
        "ms": ms[0], "ms_repeat": ms[1], "plain_ms": plain_ms,
        "pairs_evaluated": pairs, "bytes": n_bytes,
        **bound(pairs, NLIST_FLOPS_PER_PAIR, n_bytes, device,
                PEAK_BF16X2_FLOPS),
        "conversions_per_pair": cvt,
        "conversion_floor_ms": conversion_floor_ms(pairs, cvt, device),
        "sass_loop": loop, "sass_instrs_per_pair": instrs,
        "issue_floor_ms": issue_floor_ms(pairs, instrs, device),
        "library_ms": None,
        "library_note": "none: no single PyTorch call computes a cell-list "
                        "pair sum",
        "nvidia_smi": device["nvidia_smi"],
    }
    record["share_of_bound"] = record["bound_ms"] / ms[0]
    return record


def phase_timing_nlist_bf16(device: dict, build: dict) -> dict:
    """The bf16 form's launches at the README nlist state's tiles and at
    the baseline-1m leaf blocks (the t_cap launch is timed by
    nlist_bf16_multirate_path on its own kick)."""
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.ops import nlist
    from gravity_tpu_torch.simulation import make_initial_state

    config = nlist_bf16_config()
    state = make_initial_state(config, torch.device("cuda", 0))
    side, cap = nlist.resolve_nlist_sizing(state.positions, config.nlist_rcut)
    records = {"readme": nlist_bf16_timing(
        nlist_tiles(state.positions, state.masses, side, cap,
                    config.nlist_rcut),
        dict(cutoff=CUTOFF_RADIUS, eps=config.eps), device, build,
        "nlist_pair_kernel<bf16Li0ELb1ELb1>")}
    del state
    tstate = tree_state().astype(torch.bfloat16)
    depth = tree_depth_of(tstate.positions)
    records["near"] = nlist_bf16_timing(
        tree_tiles(tstate.positions, tstate.masses, depth),
        dict(cutoff=CUTOFF_RADIUS, eps=0.05, use_rcut=False, kind="newton"),
        device, build, "nlist_near_kernel<bf16Lb1>", reps=20)
    for name, record in records.items():
        emit({"phase": "timing_nlist_bf16", "launch": name, **record})
    return records


def phase_nlist_bf16_path(device: dict, nlist_path: dict) -> dict:
    """README's nlist command with --dtype bfloat16 through the Simulator
    at N = 262,144, cut to 100 of its 500 steps: launches of the bf16 form
    = force evaluations (and no fp32 launch), the dtype kept, the share of
    bodies that moved, the full-gravity energy drift in float64 (reported:
    the dynamics truncate at rcut), ms/step beside the fp32 path's, and
    the final state's bf16 forces against fp32 nlist on the same state:
    at most 1.5x the JAX package's own figure (JAX_BF16_NLIST), median and
    p90, with the JAX suite's dense bars (median < 1e-2, p90 < 3e-2)
    reported beside."""
    import warnings

    import torch

    from gravity_tpu_torch.ops import diagnostics, nlist
    from gravity_tpu_torch.simulation import Simulator

    config = nlist_bf16_config(steps=NLIST_BF16_STEPS)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = Simulator(config)
    check(sim.backend == "nlist", f"backend {sim.backend}")
    x0 = sim.state.positions
    e0 = energy_f64(sim.state, config, chunk=256)
    stats, counts = logged_run(sim, "nlist_bf16_path",
                               fixed_steps=config.steps)
    evals = config.steps + 1
    # One bf16 segment-sum launch an evaluation: the overflow channels'
    # cell masses and weighted positions (nlist.cell_totals).
    check(counts["nlist_pair/bf16"] == evals and counts["nlist_pair"] == 0
          and counts["segment_sum/bf16"] == evals,
          f"bf16 nlist: {counts} for {evals} force evaluations")
    final = stats["final_state"]
    check(final.positions.dtype == torch.bfloat16,
          f"bf16 nlist: state became {final.positions.dtype}")
    moved = float((final.positions != x0).any(dim=1).float().mean())
    drift = diagnostics.energy_drift(e0, energy_f64(final, config,
                                                    chunk=256))
    side, cap, _ = sim.nlist_sizing
    acc = sim.accel(final.positions, final.masses)
    ref = nlist.nlist_accelerations(
        final.positions.float(), final.masses.float(),
        rcut=config.nlist_rcut, side=side, cap=cap, g=config.g,
        cutoff=config.cutoff, eps=config.eps).double()
    errors = rel_errors(acc, ref)
    record = {
        "phase": "nlist_bf16_path", "command": {**NLIST_RUN,
                                                "dtype": "bfloat16"},
        "steps": config.steps, "cut_from": NLIST_RUN["steps"],
        "side": side, "cap": cap, "launches": counts["nlist_pair/bf16"],
        "force_evaluations": evals, "counts": counts,
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "fp32_ms_per_step": nlist_path["ms_per_step"],
        "moved_share": moved, "energy_drift_full_gravity_f64": drift,
        "vs_fp32_nlist": errors, "jax_bf16_figure": JAX_BF16_NLIST,
        "factor": TREE_BF16_FACTOR,
        "suite_bars": {"median": BF16_MEDIAN_BAR, "p90": 3e-2,
                       "met": errors["median"] < BF16_MEDIAN_BAR
                       and errors["p90"] < 3e-2},
        "warnings": [str(w.message)[:160] for w in caught],
        "nvidia_smi": device["nvidia_smi"],
    }
    emit(record)
    check(all(errors[q] <= TREE_BF16_FACTOR * JAX_BF16_NLIST[q]
              for q in ("median", "p90")),
          f"bf16 nlist vs fp32 nlist past 1.5x the JAX figure: {errors}")
    return record


def phase_nlist_bf16_multirate_path(device: dict, build: dict) -> dict:
    """The same bf16 state with --integrator multirate (k = 32,768, sub 4),
    cut to 20 steps: the fast kicks through the bf16 form at the t_cap the
    occupancy model picks; the last kick's tiles (the final state's fast
    rung) held to the plain version, and that launch timed."""
    import warnings

    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.simulation import Simulator

    config = nlist_bf16_config(integrator="multirate",
                               steps=NLIST_BF16_MULTIRATE_STEPS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sim = Simulator(config)
    side, cap, t_cap = sim.kick_sizing
    k = sim._multirate_plan()[0]
    check(t_cap < cap, f"k {k}, t_cap {t_cap}, cap {cap}")
    stats, counts = logged_run(sim, "nlist_bf16_multirate_path",
                               fixed_steps=config.steps)
    kicks = 1 + 5 * config.steps
    check(counts["nlist_pair/bf16"] == kicks and counts["nlist_pair"] == 0
          and counts["segment_sum/bf16"] == kicks,
          f"{counts} for {config.steps} two-rung steps")
    final = stats["final_state"]
    idx = fast_targets(sim, final, k)
    args = nlist_kick_tiles(final.positions, final.masses,
                            final.positions[idx], side, cap, t_cap,
                            config.nlist_rcut)
    kw = dict(cutoff=CUTOFF_RADIUS, eps=config.eps)
    check_rec = nlist_bf16_check(f"last kick k={k} t_cap={t_cap} bf16", args,
                                 kw)
    timing = nlist_bf16_timing(args, kw, device, build,
                               "nlist_pair_kernel<bf16Li0ELb1ELb1>")
    record = {
        "phase": "nlist_bf16_multirate_path", "command": {
            **NLIST_RUN, "dtype": "bfloat16", "integrator": "multirate"},
        "steps": config.steps, "cut_from": NLIST_RUN["steps"], "k": k,
        "side": side, "cap": cap, "t_cap": t_cap,
        "launches": counts["nlist_pair/bf16"], "counts": counts,
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "dtype_kept": final.positions.dtype == sim.dtype,
        "check": check_rec, "timing": timing,
    }
    emit(record)
    return record


def tree_bf16_errors(acc, idx, acc32, ref_direct) -> dict:
    """bf16 tree forces at the sampled targets against the fp32 tree and
    the fp32 direct sum, with each reading's bars (1.5x the JAX package's
    own figure); the failed ones listed."""
    record = {"vs_fp32_tree": rel_errors(acc[idx], acc32[idx].double()),
              "vs_fp32_direct": rel_errors(acc[idx], ref_direct)}
    record["faults"] = [
        f"{ref} {q}" for ref in ("vs_fp32_tree", "vs_fp32_direct")
        for q in ("median", "p90")
        if record[ref][q] > TREE_BF16_FACTOR * JAX_BF16_TREE[ref][q]]
    return record


def phase_tree_bf16_path(device: dict) -> dict:
    """`run --preset baseline-1m --dtype bfloat16 --tree-near nlist` at N =
    1,048,576, cut to 5 of its 500 steps: the bf16 near-field launches =
    force evaluations, the dtype kept, the share of bodies that moved, the
    drift by Simulator.energy() (the tree potential at bf16, reported), the
    peak memory; on the final state both near fields' bf16 forces against
    the fp32 tree and fp32 nbody_direct at 4,096 targets (at most 1.5x the
    JAX package's own figure, JAX_BF16_TREE) and against each other (the
    targets in their leaf's slots apart). Then the gather near field for 3
    steps (no kernel) and multirate for 3 (the near kicks through the bf16
    form; the last kick's tiles held to the plain version)."""
    import dataclasses
    import warnings

    import torch

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.ops import tree
    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel
    from gravity_tpu_torch.simulation import Simulator, _tree_kwargs

    base = dataclasses.replace(PRESETS["baseline-1m"], dtype="bfloat16")
    config = dataclasses.replace(base, tree_near="nlist",
                                 steps=TREE_BF16_STEPS)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = Simulator(config)
    check(sim.backend == "tree", f"backend {sim.backend}")
    x0 = sim.state.positions
    e0 = sim.energy()
    torch.cuda.reset_peak_memory_stats()
    stats, counts = logged_run(sim, "tree_bf16_path",
                               fixed_steps=config.steps)
    peak = torch.cuda.max_memory_allocated()
    evals = config.steps + 1
    builds = TREE_SUMS_PER_LEVEL * (sim.tree_depth + 1)
    check(counts["nlist_pair/near_bf16"] == evals
          and counts["nlist_pair/near"] == 0
          and counts["segment_sum/bf16"] == builds * evals,
          f"bf16 tree: {counts} for {evals} force evaluations")
    final = stats["final_state"]
    check(final.positions.dtype == torch.bfloat16,
          f"bf16 tree: state became {final.positions.dtype}")
    moved = float((final.positions != x0).any(dim=1).float().mean())
    drift = float(abs((sim.energy() - e0) / e0))

    pos, masses = final.positions, final.masses
    pos32, masses32 = pos.float(), masses.float()
    gen = torch.Generator().manual_seed(17)
    idx = torch.randperm(config.n, generator=gen)[:TREE_SAMPLE].to(pos.device)
    ref = accelerations_vs_kernel(pos32[idx].contiguous(), pos32, masses32,
                                  g=config.g, eps=config.eps).double()
    accs, errors = {}, {}
    for near in ("nlist", "gather"):
        kw = _tree_kwargs(dataclasses.replace(config, tree_near=near),
                          sim.tree_depth)
        accs[near] = tree.tree_accelerations(pos, masses, **kw)
        check(accs[near].dtype == torch.bfloat16
              and bool(torch.isfinite(accs[near]).all()),
              f"bf16 tree {near}: forces")
        acc32 = tree.tree_accelerations(pos32, masses32, **kw)
        errors[near] = tree_bf16_errors(accs[near], idx, acc32, ref)
        del acc32
    past = past_t_cap(pos, masses, sim.tree_depth, config.tree_leaf_cap)
    gaps = near_gap(accs["nlist"], accs["gather"], past)
    del accs

    # The gather near field (no kernel) and multirate, 3 steps each.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gsim = Simulator(dataclasses.replace(base,
                                             steps=TREE_BF16_GATHER_STEPS))
    gstats, gcounts = logged_run(gsim, "tree_bf16_gather_path",
                                 fixed_steps=TREE_BF16_GATHER_STEPS)
    check(gcounts["nlist_pair/near_bf16"] == 0
          and gcounts["nlist_pair/near"] == 0
          and gcounts["segment_sum/bf16"]
          == TREE_SUMS_PER_LEVEL * (gsim.tree_depth + 1)
          * (TREE_BF16_GATHER_STEPS + 1),
          f"the bf16 gather near field: {gcounts}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        msim = Simulator(dataclasses.replace(
            base, tree_near="nlist", integrator="multirate",
            steps=TREE_BF16_MULTIRATE_STEPS))
    mstats, mcounts = logged_run(msim, "tree_bf16_multirate_path",
                                 fixed_steps=TREE_BF16_MULTIRATE_STEPS)
    kicks = 1 + 5 * TREE_BF16_MULTIRATE_STEPS
    check(mcounts["nlist_pair/near_bf16"] == kicks
          and mcounts["segment_sum/bf16"]
          == TREE_SUMS_PER_LEVEL * (msim.tree_depth + 1) * kicks,
          f"bf16 tree multirate: {mcounts}")
    mfinal = mstats["final_state"]
    k = msim._multirate_plan()[0]
    fast = fast_targets(msim, mfinal, k)
    kick = nlist_bf16_check(
        f"baseline-1m last kick k={k} bf16", tree_tiles(
            mfinal.positions, mfinal.masses, msim.tree_depth,
            targets=mfinal.positions[fast]),
        dict(cutoff=CUTOFF_RADIUS, eps=config.eps, use_rcut=False,
             kind="newton"))
    record = {
        "phase": "tree_bf16_path", "preset": "baseline-1m",
        "dtype": "bfloat16", "tree_near": "nlist", "n": config.n,
        "steps": config.steps, "cut_from": 500, "depth": sim.tree_depth,
        "launches": counts["nlist_pair/near_bf16"],
        "force_evaluations": evals, "counts": counts,
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "peak_memory_bytes": peak, "moved_share": moved,
        "energy_drift_tree_potential": drift,
        "vs_fp32_targets": int(idx.numel()), "errors": errors,
        "jax_bf16_figure": JAX_BF16_TREE, "factor": TREE_BF16_FACTOR,
        "near_modes_gap": gaps,
        "near_modes_gap_bars": {
            "in_slot_median_rel": NEAR_GAP_BF16_IN_SLOT_MEDIAN_BAR,
            "median_rel": NEAR_GAP_BF16_MEDIAN_BAR},
        "gather": {"steps": TREE_BF16_GATHER_STEPS, "counts": gcounts,
                   "ms_per_step": 1e3 * gstats["avg_step_s"],
                   "dtype_kept": gstats["final_state"].positions.dtype
                   == torch.bfloat16},
        "multirate": {"steps": TREE_BF16_MULTIRATE_STEPS, "k": k,
                      "launches": mcounts["nlist_pair/near_bf16"],
                      "counts": mcounts,
                      "ms_per_step": 1e3 * mstats["avg_step_s"],
                      "last_kick": kick},
        "warnings": [str(w.message)[:160] for w in caught],
        "nvidia_smi": device["nvidia_smi"],
    }
    emit(record)
    for near, reading in errors.items():
        check(not reading["faults"],
              f"bf16 tree {near}: past 1.5x the JAX figure: {reading}")
    check(gaps["in_slot"]["median_rel"] < NEAR_GAP_BF16_IN_SLOT_MEDIAN_BAR
          and gaps["median_rel"] < NEAR_GAP_BF16_MEDIAN_BAR,
          f"bf16 near modes: {gaps}")
    check(record["gather"]["dtype_kept"], "bf16 gather run changed dtype")
    return record


# The measurement layer: the bench entry point and the autotuned
# auto router, each driven with the counts set to 0 just before it.
BENCH_N = 262_144
BENCH_STEPS = 20
BENCH_WARMUP = 3  # bench.main's
# A bench rate may not pass its own kernel's rate alone by more than this
# (CUDA events, same N, same run): a benchmark that beats its own kernel
# has a timer that stopped early.
BENCH_RATE_SLACK = 1.05
# (BENCH_BACKEND, the counter of its kernel)
BENCH_BACKENDS = (("direct", "nbody_direct"), ("pallas-mxu", "nbody_mxu"),
                  ("nlist", "nlist_pair"))
AUTOTUNE_STEPS = 2
TUNE_SIZES = (16_384,)


def bench_kernel_rate(backend: str, line: dict) -> dict:
    """The rate of the bench line's own kernel alone, at the bench's N and
    state, by CUDA events: pairs a second for the direct sums (N(N-1) a
    launch), pair-tile slots a second for the cell list (its evaluated
    rate)."""
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.constants import CUTOFF_RADIUS, G
    from gravity_tpu_torch.ops import direct_kernel, mxu_kernel, nlist
    from gravity_tpu_torch.simulation import make_initial_state

    config = SimulationConfig(model="plummer", n=BENCH_N, dt=3600.0,
                              eps=1.0e9, integrator="leapfrog")
    state = make_initial_state(config, torch.device("cuda", 0))
    pos, masses = state.positions, state.masses
    n = pos.shape[0]
    if backend == "direct":
        def kernel():
            direct_kernel.accelerations_vs_kernel(pos, pos, masses,
                                                  eps=config.eps)
        work = n * (n - 1)
    elif backend == "pallas-mxu":
        xi = (pos - pos.mean(dim=0)).contiguous()
        gm = (masses * G).contiguous()

        def kernel():
            mxu_kernel.gram_acc4(xi, xi, gm, cutoff=CUTOFF_RADIUS,
                                 eps=config.eps)
        work = n * (n - 1)
    else:
        side, cap = line["nlist_side"], line["nlist_cap"]
        args = nlist_tiles(pos, masses, side, cap, line["nlist_rcut"])

        def kernel():
            nlist.pair_cells_kernel(*args, cutoff=CUTOFF_RADIUS,
                                    eps=config.eps)
        work = nlist.evaluated_pairs_per_eval(side, cap)
    cuda_ms(kernel, 2)
    ms = cuda_ms(kernel, 5)
    return {"kernel_ms": ms, "work_per_launch": work,
            "kernel_rate": work / (ms * 1e-3)}


def phase_bench_path(device: dict) -> dict:
    """``bench.main()`` in-process for ``direct``, ``pallas-mxu`` and
    ``nlist`` at N = 262,144 (plummer, fp32, leapfrog, 3 warm-up and 20
    timed steps): its one headline line each; each backend's kernel
    launched exactly (warm-up + bench steps + the steps of the SM clock's
    window after the timed one) x FORCE_EVALS_PER_STEP + 1 (the first
    evaluation) times, with the clock sampled in that window; the nlist line labelled with the
    dense-equivalent metric beside its evaluated-tile rate; and no rate
    above 1.05x its own kernel's rate alone (:func:`bench_kernel_rate`),
    which a timer that stopped early would give."""
    import contextlib
    import io

    from gravity_tpu_torch import bench
    from gravity_tpu_torch.ops.integrators import FORCE_EVALS_PER_STEP
    from gravity_tpu_torch.utils.timing import pairs_metric_name

    lines = {}
    saved = {k: os.environ.get(k) for k in
             ("BENCH_N", "BENCH_STEPS", "BENCH_BACKEND", "BENCH_DEVICE")}
    try:
        for backend, counter in BENCH_BACKENDS:
            os.environ.update(BENCH_N=str(BENCH_N),
                              BENCH_STEPS=str(BENCH_STEPS),
                              BENCH_BACKEND=backend)
            os.environ.pop("BENCH_DEVICE", None)
            out = io.StringIO()
            reset_counts()
            with contextlib.redirect_stdout(out):
                rc = bench.main()
            counts = read_counts()
            check(rc == 0, f"bench {backend}: exit code {rc}")
            line = json.loads(out.getvalue().strip().splitlines()[-1])
            want_launches = 1 + (BENCH_WARMUP + BENCH_STEPS
                                 + line["sm_clock_steps"]) \
                * FORCE_EVALS_PER_STEP["leapfrog"]
            rate = bench_kernel_rate(backend, line)
            bench_rate = (line["evaluated_pairs_per_sec_per_chip"]
                          if backend == "nlist" else line["value"])
            record = {"phase": "bench_path", "backend": backend,
                      "line": line, "launches": counts[counter],
                      "launches_expected": want_launches, "counts": counts,
                      "bench_rate": bench_rate, **rate,
                      "bench_over_kernel": bench_rate / rate["kernel_rate"],
                      "slack": BENCH_RATE_SLACK,
                      "nvidia_smi": device["nvidia_smi"]}
            emit(record)
            check(counts[counter] == want_launches,
                  f"bench {backend}: {counts[counter]} launches of "
                  f"{counter}, not {want_launches}")
            check(line["n"] == BENCH_N and line["steps"] == BENCH_STEPS
                  and line["platform"] == "cuda"
                  and line["autotune_cache"] == "off"
                  and line["sm_clock_samples"] > 0
                  and line["sm_clock_steps"] >= BENCH_STEPS,
                  f"bench {backend}: {line}")
            check(bench_rate <= BENCH_RATE_SLACK * rate["kernel_rate"],
                  f"bench {backend}: rate {bench_rate:.4g} above "
                  f"{BENCH_RATE_SLACK}x its kernel's {rate['kernel_rate']:.4g}")
            if backend == "nlist":
                check(line["pairs_metric"] == pairs_metric_name("nlist")
                      == "dense_equiv_pairs_per_sec"
                      and line["evaluated_pairs_per_sec_per_chip"] > 0,
                      f"bench nlist: labels {line}")
            lines[backend] = record
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return lines


# The counter of each candidate's kernel on a path (the tree's near field
# at --tree-near nlist; the plain masked direct sum and the FMM have none).
CANDIDATE_COUNTER = {"pallas": "nbody_direct", "pallas-mxu": "nbody_mxu",
                     "nlist": "nlist_pair", "tree": "nlist_pair/near",
                     "fmm": None, "sfmm": None}


def autotune_case(name: str, config, device: dict) -> dict:
    """One configuration through plain ``auto``: the first Simulator a
    miss that timed every eligible candidate (each > 0, nothing skipped
    for an exception), routed to the argmin; its run (the counts set to 0
    just before) through the winner's kernel (an FMM winner launches
    none); a second Simulator a hit that probes nothing."""
    from gravity_tpu_torch import autotune
    from gravity_tpu_torch.simulation import Simulator

    eligible, why = autotune.eligible_candidates(config, True)
    check(len(eligible) > 1, f"autotune {name}: {eligible} eligible")
    t0 = time.perf_counter()
    sim = Simulator(config)
    build_s = time.perf_counter() - t0
    d = sim.autotune_decision
    check(d.cache == "miss",
          f"autotune {name}: a {sim.autotune} decision with {eligible} "
          "eligible")
    check(set(d.timings_s) == set(eligible)
          and all(t > 0 for t in d.timings_s.values()),
          f"autotune {name}: timings {d.timings_s} for {eligible}")
    check(set(d.skipped) == set(why) and not set(d.skipped) & set(eligible),
          f"autotune {name}: skipped {d.skipped}")
    if "tree" in eligible:
        check({"fmm", "sfmm"} <= set(eligible),
              f"autotune {name}: the FMM is not a candidate: {eligible}")
    winner = min(d.timings_s, key=d.timings_s.get)
    check(d.backend == winner, f"autotune {name}: {d.backend}, not the "
          f"argmin {winner} of {d.timings_s}")
    counter = CANDIDATE_COUNTER[winner]
    reset_counts()
    stats = sim.run()
    counts = read_counts()
    check(stats["autotune_cache"] == "miss"
          and stats["autotune_probe_ms"] > 0, f"autotune {name}: {stats}")
    if counter is None:
        check(stats["backend"] == winner and not any(counts.values()),
              f"autotune {name}: the winner {winner} ran {stats['backend']}"
              f" with launches {counts}")
    else:
        check(counts[counter] > 0, f"autotune {name}: the winner {winner}'s"
              f" {counter} launched no time in the run: {counts}")
    probes = autotune.probe_counters()
    again = Simulator(config)
    check(again.autotune == {"cache": "hit", "probe_ms": 0.0}
          and autotune.probe_counters() == probes
          and again.backend == sim.backend,
          f"autotune {name}: second Simulator {again.autotune}")
    record = {"phase": "autotune_path", "case": name, "n": config.n,
              "winner": winner, "backend": sim.backend,
              "timings_s": d.timings_s, "errors": d.errors,
              "skipped": d.skipped, "probe_ms": d.probe_ms,
              "simulator_s": build_s,
              "run_launches": counts[counter] if counter else 0,
              "counter": counter, "steps": stats["steps"],
              "ms_per_step": 1e3 * stats["avg_step_s"],
              "hit": again.autotune, "key_hash": d.key_hash,
              "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    return record


def phase_autotune_path(device: dict) -> dict:
    """Plain ``auto`` through the autotuned router on the card, in a fresh
    tuning cache: ``baseline-1m`` (``--tree-near nlist``: pallas,
    pallas-mxu, tree, fmm, sfmm) and the README cell-list run (the rcut
    contest: nlist against the masked direct sum), each cut to 3 steps, a
    miss then a hit (:func:`autotune_case`); then ``tune --sizes 16384``
    twice in this process (the router keeps no verdict in memory: the
    second call's hits are the disk cache's): one line a size, misses,
    then all hits. (``baseline-16k``'s contest is the one ``tune`` runs
    at 16,384.)"""
    from gravity_tpu_torch.config import PRESETS, SimulationConfig

    saved = os.environ.get("GRAVITY_TPU_TUNE_DIR")
    cases = {}
    with tempfile.TemporaryDirectory() as tune_dir:
        os.environ["GRAVITY_TPU_TUNE_DIR"] = tune_dir
        try:
            for name, config in (
                ("baseline-1m", dataclasses.replace(
                    PRESETS["baseline-1m"], force_backend="auto",
                    tree_near="nlist", steps=AUTOTUNE_STEPS)),
                ("readme-nlist", SimulationConfig(**{
                    **NLIST_RUN, "force_backend": "auto",
                    "steps": AUTOTUNE_STEPS})),
            ):
                cases[name] = autotune_case(name, config, device)
            calls = []
            for _ in range(2):
                proc = run_cli(["tune", "--sizes", *map(str, TUNE_SIZES)])
                check(proc.returncode == 0,
                      f"tune failed ({proc.returncode}): "
                      f"{proc.stderr[-2000:]}")
                calls.append([json.loads(x) for x in
                              proc.stdout.strip().splitlines()])
        finally:
            if saved is None:
                os.environ.pop("GRAVITY_TPU_TUNE_DIR", None)
            else:
                os.environ["GRAVITY_TPU_TUNE_DIR"] = saved
    first, second = calls
    emit({"phase": "autotune_path", "case": "tune", "sizes": TUNE_SIZES,
          "first": first, "second": second,
          "nvidia_smi": device["nvidia_smi"]})
    check([x["n"] for x in first] == list(TUNE_SIZES)
          and all(x["cache"] == "miss" and len(x["timings_s"]) > 1
                  for x in first), f"tune: first call {first}")
    check([x["n"] for x in second] == list(TUNE_SIZES)
          and all(x["cache"] == "hit" and x["probe_steps"] == 0
                  and x["backend"] == y["backend"]
                  for x, y in zip(second, first)),
          f"tune: second call {second}")
    cases["tune"] = {"first": first, "second": second}
    return cases


# The run loop's host side: the block pipeline, checkpoints and resume,
# the supervisor, the ledger and the sentinel. The pipeline A/B on
# baseline-16k (500 steps, trajectories, a checkpoint every 100, the
# ledger, the sentinel every 5 blocks); PERF_BASELINE.json's
# host_gap_pipelined configuration as written there (a Plummer sphere of
# 2,048 through the plain dense sum, 150 steps, blocks of 25, a checkpoint
# every 100, 2 repetitions a mode), reported beside its 0.35.
PIPELINE_CKPT_EVERY = 100
PIPELINE_SENTINEL_EVERY = 5
HOST_GAP_CONTRACT = dict(n=2048, steps=150, reps=2, block=25,
                         ckpt_every=100, max_frac=0.35)
# The README cell-list run cut to 100 of its 500 steps for the resume and
# cadence A/Bs, in blocks of 25 (resume, preempted at 50) and 10 (the
# cadence bench, a checkpoint every 50), so that there are blocks to
# overlap and a step to resume from.
NLIST_CUT_STEPS = 100
LEDGER_TREE_STEPS = 1


def run_cli(args, faults: str = ""):
    """``gravity_tpu_torch ARGS`` through ``cli.main`` in this process, with
    ``GRAVITY_TPU_FAULTS`` set to ``faults`` for its duration (an injected
    preemption is a real SIGTERM to this process, which the verb's own
    handler takes): a CompletedProcess of its exit code and its captured
    stdout and stderr. A process of its own for each verb took ~8 s to
    reach the card; the verbs are the same."""
    import contextlib
    import io

    from gravity_tpu_torch.cli import main as cli_main
    from gravity_tpu_torch.utils import faults as fault_plan

    out, err = io.StringIO(), io.StringIO()
    saved = os.environ.pop("GRAVITY_TPU_FAULTS", None)
    if faults:
        os.environ["GRAVITY_TPU_FAULTS"] = faults
    fault_plan.reset()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = cli_main(list(args))
            except SystemExit as e:
                rc = e.code if isinstance(e.code, int) else 1
    finally:
        os.environ.pop("GRAVITY_TPU_FAULTS", None)
        if saved is not None:
            os.environ["GRAVITY_TPU_FAULTS"] = saved
        fault_plan.reset()
    return subprocess.CompletedProcess(list(args), rc, out.getvalue(),
                                       err.getvalue())


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def same_bits(a, b) -> bool:
    """Two states (or tensors) hold the same bits, wherever they lie."""
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    return all(same_bits(getattr(a, k), getattr(b, k))
               for k in ("positions", "velocities", "masses"))


def checkpoint_at(ckpt: str, step: int):
    from gravity_tpu_torch.utils.checkpoint import (
        make_checkpoint_manager,
        restore_checkpoint,
    )

    state, _ = restore_checkpoint(make_checkpoint_manager(ckpt), step)
    return state


def phase_pipeline_path(device: dict) -> dict:
    """baseline-16k (N = 16,384, fp32, pallas, 500 steps) with
    trajectories, a checkpoint every 100 steps, the ledger and the
    sentinel every 5 blocks, with ``--io-pipeline`` on, off, on, off:
    every run's checkpoints and trajectory frames bit for bit the
    first's; the ledger's final energy within 1e-6 relative of
    ``ops/diagnostics.total_energy`` in fp64 on the same final state; the
    sentinel's max relative error below 1e-5 (nbody_direct against its
    own rectangular form); launches 1 + 500 + 2 a probe. Then
    PERF_BASELINE.json's host_gap_pipelined configuration through
    ``bench.run_cadence_benchmark``, on and off."""
    from gravity_tpu_torch.bench import run_cadence_benchmark
    from gravity_tpu_torch.config import PRESETS, SimulationConfig
    from gravity_tpu_torch.simulation import Simulator
    from gravity_tpu_torch.utils.checkpoint import make_checkpoint_manager
    from gravity_tpu_torch.utils.trajectory import (
        TrajectoryReader,
        TrajectoryWriter,
    )

    config = dataclasses.replace(
        PRESETS["baseline-16k"], record_trajectories=True,
        checkpoint_every=PIPELINE_CKPT_EVERY, ledger=True,
        sentinel_every=PIPELINE_SENTINEL_EVERY)
    blocks = config.steps // config.progress_every
    probes = -(-blocks // PIPELINE_SENTINEL_EVERY)
    want_steps = list(range(PIPELINE_CKPT_EVERY, config.steps + 1,
                            PIPELINE_CKPT_EVERY))
    runs, finals = {"on": [], "off": []}, {}
    log_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(log_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=log_root) as root:
        # on, off, on, off: the first run also pays the pinned host
        # allocator's first allocations.
        for rep, mode in enumerate(("on", "off", "on", "off")):
            cfg = dataclasses.replace(config, io_pipeline=mode)
            sim = Simulator(cfg)
            run_dir = os.path.join(root, str(rep))
            writer = TrajectoryWriter(os.path.join(run_dir, "traj"),
                                      sim.n_real, every=1)
            mgr = make_checkpoint_manager(os.path.join(run_dir, "ckpt"),
                                          max_to_keep=10)
            reset_counts()
            stats = sim.run(trajectory_writer=writer,
                            checkpoint_manager=mgr)
            counts = read_counts()
            check(stats["io_pipeline"] == mode, f"pipeline {mode}: {stats}")
            check(counts["nbody_direct"] == 1 + config.steps + 2 * probes,
                  f"pipeline {mode}: {counts['nbody_direct']} launches")
            check(mgr.all_steps() == want_steps,
                  f"pipeline {mode}: checkpoints {mgr.all_steps()}")
            sent = stats["sentinel"]
            check(sent["probes"] == probes and sent["max_rel_err"] < 1e-5,
                  f"pipeline {mode}: sentinel {sent}")
            finals.setdefault(mode, stats["final_state"])
            runs[mode].append({
                "ms_per_step": 1e3 * stats["avg_step_s"],
                "host_gap_frac": stats["host_gap_frac"],
                "launches": counts["nbody_direct"],
                "ledger": stats["ledger"],
                "total_energy": stats["total_energy"],
                "sentinel": sent,
            })
            if rep == 0:
                continue
            # Every run's artifacts against the first's, bit for bit.
            for step in want_steps:
                check(same_bits(
                    checkpoint_at(os.path.join(root, "0", "ckpt"), step),
                    checkpoint_at(os.path.join(run_dir, "ckpt"), step)),
                    f"pipeline: checkpoint {step} of run {rep} ({mode}) "
                    "differs from run 0 (on)")
            first = TrajectoryReader(os.path.join(root, "0", "traj"))
            this = TrajectoryReader(os.path.join(run_dir, "traj"))
            check(first.steps == this.steps
                  == list(range(1, config.steps + 1)),
                  "pipeline: trajectory steps")
            check(first.load(mmap=False).tobytes()
                  == this.load(mmap=False).tobytes(),
                  f"pipeline: trajectory frames of run {rep} ({mode}) "
                  "differ from run 0 (on)")
    check(same_bits(finals["on"], finals["off"]),
          "pipeline: final states differ")
    e64 = energy_f64(finals["on"], config)
    ledger_e = runs["on"][0]["total_energy"]
    ledger_rel = abs(ledger_e - e64) / abs(e64)
    check(ledger_rel < 1e-6, f"ledger energy {ledger_e!r} against {e64!r} "
          f"in fp64: {ledger_rel:.3e}")
    contract = {}
    for mode in ("on", "off"):
        reps = []
        for _ in range(HOST_GAP_CONTRACT["reps"]):
            cfg = SimulationConfig(
                model="plummer", n=HOST_GAP_CONTRACT["n"],
                steps=HOST_GAP_CONTRACT["steps"], dt=3600.0, eps=1e9,
                integrator="leapfrog", force_backend="dense",
                dtype="float32", record_trajectories=True,
                trajectory_every=1, progress_every=HOST_GAP_CONTRACT["block"],
                checkpoint_every=HOST_GAP_CONTRACT["ckpt_every"],
                io_pipeline=mode)
            line = run_cadence_benchmark(cfg)
            check(line["io_pipeline"] == mode
                  and line["host_gap_frac"] is not None,
                  f"host_gap_pipelined {mode}: {line}")
            reps.append({"host_gap_frac": line["host_gap_frac"],
                         "steps_per_sec": line["steps_per_sec"]})
        contract[mode] = {
            "reps": reps, "median_host_gap_frac": statistics.median(
                r["host_gap_frac"] for r in reps)}
    record = {
        "phase": "pipeline_path", "preset": "baseline-16k",
        "steps": config.steps, "block": config.progress_every,
        "checkpoint_every": PIPELINE_CKPT_EVERY,
        "sentinel_every_blocks": PIPELINE_SENTINEL_EVERY, "runs": runs,
        "artifacts_bitwise_identical": True,
        "ledger_energy_vs_fp64_rel": ledger_rel, "energy_fp64": e64,
        "host_gap_pipelined": {
            "config": HOST_GAP_CONTRACT, "runs": contract,
            "contract_max_frac": HOST_GAP_CONTRACT["max_frac"],
            "reported_only": "the gate (ROADMAP.md Queue 1 item 8) holds "
                             "it to the bar"},
        "nvidia_smi": device["nvidia_smi"],
    }
    emit(record)
    return record


def phase_resume_path(device: dict) -> dict:
    """reference-cuda (N = 50,000, 500 Euler steps, masked, nbody_direct)
    through the CLI (``run_cli``) with a checkpoint every 100 and
    ``GRAVITY_TPU_FAULTS=preempt@250``: exit 75; ``resume`` finishes it
    with exit 0 and its step-500 checkpoint equals an uninterrupted run's
    final state bit for bit (nbody_direct repeats bit for bit); with the
    newest snapshot (300) truncated, ``resume`` falls back to 200 and ends
    bit for bit again. Then the README cell-list run, cut to 100 steps in
    blocks of 25, preempted at 50 and resumed: its max position gap
    against an uninterrupted run, which the fp32 cell totals' float
    atomics (``ops/cells.py``) leave nonzero."""
    import shutil

    import torch

    from gravity_tpu_torch.config import PRESETS, SimulationConfig
    from gravity_tpu_torch.simulation import Simulator
    from gravity_tpu_torch.utils.checkpoint import make_checkpoint_manager

    config = PRESETS["reference-cuda"]
    log_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(log_root, exist_ok=True)
    record = {"phase": "resume_path", "nvidia_smi": device["nvidia_smi"]}
    with tempfile.TemporaryDirectory(dir=log_root) as root:
        ckpt, copy = os.path.join(root, "ckpt"), os.path.join(root, "copy")
        logs = os.path.join(root, "logs")
        common = ["--preset", "reference-cuda", "--checkpoint-every", "100",
                  "--log-dir", logs]
        t0 = time.perf_counter()
        pre = run_cli(["run", *common, "--checkpoint-dir", ckpt],
                      faults="preempt@250")
        check(pre.returncode == 75, f"preempted run: exit {pre.returncode}: "
              f"{pre.stderr[-2000:]}")
        pre_line = last_json(pre.stderr)
        check(pre_line["preempted"] and pre_line["resumable"],
              f"preempted run: {pre_line}")
        saved = make_checkpoint_manager(ckpt).all_steps()
        check(saved == [100, 200, 300], f"after the preemption: {saved}")
        shutil.copytree(ckpt, copy)
        res = run_cli(["resume", *common, "--checkpoint-dir", ckpt])
        check(res.returncode == 0, f"resume: exit {res.returncode}: "
              f"{res.stderr[-2000:]}")
        res_line = last_json(res.stdout)
        check(res_line["resumed_at"] == 300 and res_line["steps"] == 200,
              f"resume: {res_line}")
        sim = Simulator(config)
        reset_counts()
        straight = sim.run()
        launches = read_counts()["nbody_direct"]
        check(launches == config.steps + 1, f"{launches} launches")
        final = straight["final_state"]
        check(same_bits(checkpoint_at(ckpt, config.steps), final),
              "resumed reference-cuda differs from the uninterrupted run")
        path = os.path.join(copy, "300", "checkpoint.pt")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        res2 = run_cli(["resume", *common, "--checkpoint-dir", copy])
        check(res2.returncode == 0, f"fallback resume: exit "
              f"{res2.returncode}: {res2.stderr[-2000:]}")
        res2_line = last_json(res2.stdout)
        check(res2_line["resumed_at"] == 200,
              f"fallback resume: {res2_line}")
        check(same_bits(checkpoint_at(copy, config.steps), final),
              "fallback resume differs from the uninterrupted run")
        record["reference_cuda"] = {
            "steps": config.steps, "preempt_at": 250,
            "preempted_exit": pre.returncode,
            "checkpoints_at_preemption": saved,
            "resume": {"resumed_at": 300, "exit": res.returncode,
                       "ms_per_step": 1e3 * res_line["avg_step_s"]},
            "fallback_resume": {"truncated": 300, "resumed_at": 200,
                                "exit": res2.returncode},
            "bitwise_equal_uninterrupted": True,
            "uninterrupted_ms_per_step": 1e3 * straight["avg_step_s"],
            "uninterrupted_launches": launches,
            "wall_s": time.perf_counter() - t0,
        }
        nl_cfg = SimulationConfig(**{**NLIST_RUN, "steps": NLIST_CUT_STEPS,
                                     "progress_every": 25})
        nl = ["--model", "random", "--n", str(nl_cfg.n), "--integrator",
              "leapfrog", "--force-backend", "nlist", "--nlist-rcut",
              str(nl_cfg.nlist_rcut), "--eps", str(nl_cfg.eps), "--steps",
              str(NLIST_CUT_STEPS), "--progress-every", "25",
              "--checkpoint-every", "25", "--log-dir", logs,
              "--checkpoint-dir", os.path.join(root, "nl")]
        pre = run_cli(["run", *nl], faults="preempt@50")
        check(pre.returncode == 75, f"nlist preempted: exit "
              f"{pre.returncode}: {pre.stderr[-2000:]}")
        res = run_cli(["resume", *nl])
        check(res.returncode == 0, f"nlist resume: exit {res.returncode}: "
              f"{res.stderr[-2000:]}")
        check(last_json(res.stdout)["resumed_at"] == 50, "nlist resume")
        nl_sim = Simulator(nl_cfg)
        reset_counts()
        nl_straight = nl_sim.run()
        check(read_counts()["nlist_pair"] == NLIST_CUT_STEPS + 1,
              "nlist uninterrupted launches")
        got = checkpoint_at(os.path.join(root, "nl"), NLIST_CUT_STEPS)
        want = nl_straight["final_state"]
        gap = (got.positions.to(want.positions.device).double()
               - want.positions.double()).abs()
        spread = float(want.positions.double().abs().max())
        check(bool(torch.isfinite(got.positions).all()), "nlist resume")
        record["readme_nlist"] = {
            "steps": NLIST_CUT_STEPS, "cut_from": 500, "block": 25,
            "preempt_at": 50, "resumed_at": 50,
            "max_position_gap_m": float(gap.max()),
            "max_gap_over_max_abs_x": float(gap.max()) / spread,
            "bodies_with_a_gap": int((gap.amax(dim=1) > 0).sum()),
            "bitwise_equal": bool(float(gap.max()) == 0.0),
            "not_held_bitwise": "reported, not held to 0: the cell "
                                "totals are one chain a cell "
                                "(nlist.cell_totals), but the check "
                                "predates them",
        }
    emit(record)
    return record


def phase_supervisor_path(device: dict) -> dict:
    """baseline-16k with ``--auto-recover --checkpoint-every 100`` and
    ``GRAVITY_TPU_FAULTS=diverge@300``, through the CLI: exit 0,
    its recovery events diverged (at 200), rolled_back (to 200), retry at
    dt/2 over the bad interval; without ``--auto-recover`` the same run
    exits 2 with the ``diverged`` stderr JSON line."""
    from gravity_tpu_torch.config import PRESETS

    config = PRESETS["baseline-16k"]
    log_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(log_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=log_root) as root:
        common = ["--preset", "baseline-16k", "--checkpoint-every", "100"]
        healed = run_cli(["run", *common, "--auto-recover",
                          "--checkpoint-dir", os.path.join(root, "a"),
                          "--log-dir", os.path.join(root, "la")],
                         faults="diverge@300")
        check(healed.returncode == 0, f"supervised: exit "
              f"{healed.returncode}: {healed.stderr[-2000:]}")
        stats = last_json(healed.stdout)
        (events_file,) = [f for f in os.listdir(os.path.join(root, "la"))
                          if f.startswith("recovery_")]
        with open(os.path.join(root, "la", events_file)) as f:
            events = [json.loads(x) for x in f if x.strip()]
        kinds = [e["event"] for e in events]
        check(kinds == ["diverged", "rolled_back", "retry"],
              f"recovery events {events}")
        check(events[0]["step"] == 200 and events[1]["to_step"] == 200
              and events[2]["dt"] == config.dt / 2
              and events[2]["span"] == config.progress_every,
              f"recovery events {events}")
        check(stats["supervisor"]["diverge_retries"] == 1
              and stats["steps"] == config.steps - 300,
              f"supervised stats {stats}")
        failed = run_cli(["run", *common,
                          "--checkpoint-dir", os.path.join(root, "b"),
                          "--log-dir", os.path.join(root, "lb")],
                         faults="diverge@300")
        check(failed.returncode == 2, f"unsupervised: exit "
              f"{failed.returncode}")
        err = last_json(failed.stderr)
        check(err["error"] == "diverged" and err["last_finite_step"] == 200,
              f"unsupervised stderr {err}")
    record = {"phase": "supervisor_path", "preset": "baseline-16k",
              "fault": "diverge@300", "supervised_exit": healed.returncode,
              "events": events, "final_leg_steps": stats["steps"],
              "final_leg_ms_per_step": 1e3 * stats["avg_step_s"],
              "unsupervised_exit": failed.returncode,
              "unsupervised_error": err,
              "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    return record


def phase_cadence_path(device: dict) -> dict:
    """``bench --cadence`` on the README cell-list run (N = 262,144), 100
    steps in blocks of 10, a trajectory frame every step and a checkpoint
    every 50, with ``--io-pipeline`` on, off, on, off: steps a second and
    host_gap_frac each; nlist_pair launched 101 times a run."""
    import contextlib
    import io

    from gravity_tpu_torch.cli import main as cli_main

    lines = {"on": [], "off": []}
    for mode in ("on", "off", "on", "off"):
        out = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out):
            rc = cli_main([
                "bench", "--cadence", "--model", "random", "--n",
                str(NLIST_RUN["n"]), "--integrator", "leapfrog",
                "--force-backend", "nlist", "--nlist-rcut",
                str(NLIST_RUN["nlist_rcut"]), "--eps", str(NLIST_RUN["eps"]),
                "--steps", str(NLIST_CUT_STEPS), "--progress-every", "10",
                "--trajectories", "--checkpoint-every", "50",
                "--io-pipeline", mode])
        counts = read_counts()
        check(rc == 0, f"cadence {mode}: exit {rc}")
        line = last_json(out.getvalue())
        check(line["io_pipeline"] == mode and line["steps"] == NLIST_CUT_STEPS
              and line["host_gap_frac"] is not None,
              f"cadence {mode}: {line}")
        check(counts["nlist_pair"] == NLIST_CUT_STEPS + 1,
              f"cadence {mode}: {counts}")
        lines[mode].append({"steps_per_sec": line["steps_per_sec"],
                            "ms_per_step": 1e3 * line["avg_step_s"],
                            "host_gap_frac": line["host_gap_frac"],
                            "launches": counts["nlist_pair"]})
    record = {"phase": "cadence_path", "command": "README cell list",
              "steps": NLIST_CUT_STEPS, "cut_from": 500, "block": 10,
              "checkpoint_every": 50, "trajectory_every": 1, "runs": lines,
              "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    return record


def phase_ledger_tree_path(device: dict) -> dict:
    """baseline-1m --tree-near nlist --ledger, 3 steps: the ledger prices
    the energy with the card's large-N potential (``LARGE_N_POTENTIAL``)
    and its final energy agrees with ``Simulator.energy()`` within 1e-6
    relative; one ledger evaluation's device ms beside the step's. Both
    large-N potentials on the final state, timed by CUDA events: the card
    must take the faster, and the two agree within the JAX suite's 0.05
    (tests/test_fmm.py:382-398)."""
    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.ops import fmm, tree
    from gravity_tpu_torch.simulation import LARGE_N_POTENTIAL, Simulator

    config = dataclasses.replace(PRESETS["baseline-1m"], tree_near="nlist",
                                 ledger=True, steps=LEDGER_TREE_STEPS)
    sim = Simulator(config)
    reset_counts()
    stats = sim.run()
    counts = read_counts()
    check(counts["nlist_pair/near"] == LEDGER_TREE_STEPS + 1,
          f"ledger tree: {counts}")
    led = stats["ledger"]
    chosen = LARGE_N_POTENTIAL["cuda"]
    check(led["pe_kind"] == chosen and led["blocks"] == 1,
          f"ledger tree: {led}")
    e_sim = float(sim.energy())
    rel = abs(stats["total_energy"] - e_sim) / abs(e_sim)
    check(rel < 1e-6, f"ledger {stats['total_energy']!r} against "
          f"Simulator.energy() {e_sim!r}: {rel:.3e}")
    final = stats["final_state"]
    ledger_ms = cuda_ms(lambda: sim._ledger_fn(final), 3)
    depth, c = sim._ledger_tree_depth(), config
    kw = dict(depth=depth, leaf_cap=c.tree_leaf_cap, ws=c.tree_ws, g=c.g,
              cutoff=c.cutoff, eps=c.eps)
    potentials = {
        "fmm": lambda: fmm.fmm_potential_energy(final.positions,
                                                final.masses, **kw),
        "tree": lambda: tree.tree_potential_energy(
            final.positions, final.masses, chunk=c.fast_chunk, **kw)}
    pe = {k: float(fn()) for k, fn in potentials.items()}
    pe_ms = {k: cuda_ms(fn, 2) for k, fn in potentials.items()}
    pe_gap = abs(pe["fmm"] - pe["tree"]) / abs(pe["tree"])
    record_pe = {"depth": depth, "ms": pe_ms, "values": pe,
                 "rel_gap": pe_gap, "chosen": chosen,
                 "faster": min(pe_ms, key=pe_ms.get)}
    record = {"phase": "ledger_tree_path", "preset": "baseline-1m",
              "large_n_potentials": record_pe,
              "tree_near": "nlist", "steps": LEDGER_TREE_STEPS,
              "cut_from": 500, "launches": counts["nlist_pair/near"],
              "energy_drift": led["energy_drift"], "ledger": led,
              "ledger_vs_energy_rel": rel,
              "ledger_eval_ms": ledger_ms,
              "ms_per_step": 1e3 * stats["avg_step_s"],
              "ledger_over_step": ledger_ms / (1e3 * stats["avg_step_s"]),
              "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    check(pe_gap < 0.05, f"large-N potentials disagree: {record_pe}")
    check(record_pe["faster"] == chosen,
          f"the card takes the {chosen} potential, not the faster: "
          f"{record_pe}")
    return record


def count_host_syncs(sim, steps: int = 2) -> float:
    """Host syncs a step in ``steps`` steps of ``sim``'s block."""
    return len(host_sync_sites(sim, steps)) / steps


def host_sync_sites(sim, steps: int) -> list:
    """The host syncs in ``steps`` steps of ``sim``'s block
    (``torch.cuda.set_sync_debug_mode("warn")`` warns at each), each as
    the source line that made it."""
    import linecache
    import warnings

    import torch

    state = sim.state
    acc = sim.initial_carry(state)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sim.run_block(state, acc, n_steps=steps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [f"{os.path.relpath(w.filename, REPO)}:{w.lineno}: "
            f"{linecache.getline(w.filename, w.lineno).strip()}"
            for w in caught if "synchroniz" in str(w.message)]


def phase_host_syncs(device: dict) -> dict:
    """The host syncs in a block on each path: what blocks the host while
    it queues the next block under the pipeline (counted, not removed)."""
    from gravity_tpu_torch.config import PRESETS, SimulationConfig
    from gravity_tpu_torch.simulation import Simulator

    base16k = PRESETS["baseline-16k"]
    paths = {
        "reference-cuda": PRESETS["reference-cuda"],
        "readme-nlist": SimulationConfig(**NLIST_RUN),
        "pallas-mxu": SimulationConfig(**MXU_RUN),
        "readme-p3m": SimulationConfig(**P3M_RUN),
        "baseline-16k": base16k,
        "baseline-16k-multirate": dataclasses.replace(
            base16k, integrator="multirate"),
        "baseline-16k-adaptive": dataclasses.replace(base16k, adaptive=True),
        "baseline-1m-tree-nlist": dataclasses.replace(
            PRESETS["baseline-1m"], tree_near="nlist"),
    }
    counts = {}
    for name, config in paths.items():
        sim = Simulator(config)
        if config.adaptive:
            # A block's budget and its one host read are the loop's.
            import warnings

            import torch

            cfg = dataclasses.replace(config, steps=4, progress_every=4)
            sim = Simulator(cfg)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    stats = sim.run()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            counts[name] = sum("synchroniz" in str(w.message)
                               for w in caught) / max(1, stats["steps"])
        else:
            counts[name] = count_host_syncs(sim)
    record = {"phase": "host_syncs", "syncs_per_step": counts,
              "how": "torch.cuda.set_sync_debug_mode('warn') over 2 steps "
                     "of run_block (adaptive: one 4-step run)",
              "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    return record

# ---------------------------------------------------------------------------
# The fast multipole solvers (PR 14): plain PyTorch on the card, as the JAX
# package's are jnp; no hand-written kernel runs on their paths.
# ---------------------------------------------------------------------------

# baseline-1m-fmm cut to 1 of its 500 steps (2 before the
# sharded-gradient phase came), multirate to 1; the 1M uniform cube
# through the dense grid, 1 step (2 each before the host path came).
FMM_STEPS = 1
FMM_DENSE_STEPS = 1
FMM_MULTIRATE_STEPS = 1
FMM_SAMPLE = 4096
FMM_DENSE_N = 1 << 20
# The sparse FMM's accuracy class at its resolving depth against the exact
# sum (tests/test_sfmm.py:90-105), beside the JAX package's own raw median
# at this disk (0.126%, on its CPU; BASELINE.md:66).
FMM_MEDIAN_BAR, FMM_P99_BAR = 5e-3, 0.1
FMM_JAX_1M_MEDIAN = 1.26e-3
# The dense FMM's at its defaults (tests/test_fmm.py:79-100).
FMM_DENSE_MEDIAN_BAR, FMM_DENSE_P90_BAR = 0.008, 0.02
# Sparse against dense on one overflow-free state: the same interaction
# sets summed in another order (tests/test_sfmm.py:69-87).
FMM_PARITY_MEDIAN_BAR, FMM_PARITY_MAX_BAR = 1e-5, 1e-3
FMM_PARITY_DEPTH = 6


def fmm_sample(n: int, device):
    import torch

    gen = torch.Generator().manual_seed(17)
    return torch.randperm(n, generator=gen)[:FMM_SAMPLE].to(device)


def fmm_vs_direct(acc, targets, pos, masses, config) -> dict:
    """Relative errors of ``acc`` at ``targets`` against the exact sum
    there (nbody_direct)."""
    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel

    ref = accelerations_vs_kernel(targets.contiguous(), pos, masses,
                                  g=config.g, cutoff=config.cutoff,
                                  eps=config.eps).double()
    return rel_errors(acc, ref)


def fmm_profile(fn, prefix: str) -> dict:
    """One evaluation under the profiler (the path's run warmed it):
    device time by kernel, the device span of each ``prefix`` stage, the
    busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return profile_record(prof, prefix, 1, wall_ms)


def fmm_run_record(name, sim, config, device, *, prefix, cut_from,
                   bars) -> dict:
    """Run ``sim`` through logged_run (no kernel may launch), then on its
    final state: one evaluation's stages by the profiler, the peak memory
    of the run, host syncs a step (one step of its block), and the forces
    against the exact sum at FMM_SAMPLE targets, held to ``bars`` (median,
    and p99 or p90)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    stats, counts = logged_run(sim, name, fixed_steps=config.steps)
    peak = torch.cuda.max_memory_allocated()
    final = stats["final_state"]
    pos, masses = final.positions, final.masses

    def evaluate():
        return sim._self_accel(pos, masses)

    acc = evaluate()
    idx = fmm_sample(pos.shape[0], pos.device)
    errors = fmm_vs_direct(acc[idx], pos[idx], pos, masses, config)
    del acc
    profile = fmm_profile(evaluate, f"{prefix}.")
    sites = host_sync_sites(sim, 1)
    record = {
        "phase": name, "n": config.n, "steps": config.steps,
        "cut_from": cut_from, "backend": sim.backend,
        "fmm_mode": stats["fmm_mode"], "depth": stats["fmm_depth"],
        "leaf_cap": stats["fmm_leaf_cap"],
        "k_cells": stats.get("sfmm_k_cells"),
        "setup_s": stats["fmm_setup_s"],
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "counts": counts, "peak_memory_bytes": peak,
        "host_syncs_per_step": len(sites), "host_sync_sites": sites,
        "profile": profile,
        "vs_nbody_direct_targets": FMM_SAMPLE, "vs_nbody_direct": errors,
        "bars": bars,
        "sfmm_final_occupancy": stats.get("sfmm_final_occupancy"),
        "nvidia_smi": device["nvidia_smi"], "perf": stats["perf"],
    }
    return record


def phase_fmm_path(device: dict) -> dict:
    """`run --preset baseline-1m-fmm`: the 1M disk through fmm with
    fmm_mode auto, which must resolve sparse, cut to FMM_STEPS steps; the
    sizing, the stages, the forces against nbody_direct."""
    import dataclasses
    import warnings

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.simulation import Simulator

    config = dataclasses.replace(PRESETS["baseline-1m-fmm"], steps=FMM_STEPS)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = Simulator(config)
    check(sim.backend == "fmm" and sim.fmm_sparse,
          f"fmm_mode=auto resolved {sim.backend}, sparse={sim.fmm_sparse}")
    record = fmm_run_record(
        "fmm_path", sim, config, device, prefix="sfmm", cut_from=500,
        bars={"median": FMM_MEDIAN_BAR, "p99": FMM_P99_BAR,
              "jax_1m_median_cpu": FMM_JAX_1M_MEDIAN})
    depth, cap, k_cells, k_chunk = sim.sfmm_sizing
    record.update(preset="baseline-1m-fmm", k_chunk=k_chunk,
                  occupied_final=record["sfmm_final_occupancy"]["occupied"],
                  warnings=[str(w.message)[:160] for w in caught])
    emit(record)
    err = record["vs_nbody_direct"]
    check(err["median"] < FMM_MEDIAN_BAR and err["p99"] < FMM_P99_BAR,
          f"sparse FMM vs nbody_direct at 1M: {err}")
    check(not record["sfmm_final_occupancy"]["overflow"],
          f"sparse FMM occupancy: {record['sfmm_final_occupancy']}")
    return record


def phase_fmm_dense_path(device: dict) -> dict:
    """`run --model random --n 1048576 --force-backend fmm --eps 1e9`: the
    uniform cube, the dense grid's regime (fmm_mode auto must resolve
    dense), cut to FMM_DENSE_STEPS steps."""
    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.simulation import Simulator

    config = SimulationConfig(model="random", n=FMM_DENSE_N, eps=1e9,
                              integrator="leapfrog", force_backend="fmm",
                              steps=FMM_DENSE_STEPS)
    sim = Simulator(config)
    check(sim.backend == "fmm" and sim.fmm_sparse is False,
          f"fmm_mode=auto on the uniform cube: sparse={sim.fmm_sparse}")
    record = fmm_run_record(
        "fmm_dense_path", sim, config, device, prefix="fmm", cut_from=None,
        bars={"median": FMM_DENSE_MEDIAN_BAR, "p90": FMM_DENSE_P90_BAR})
    emit(record)
    err = record["vs_nbody_direct"]
    check(err["median"] < FMM_DENSE_MEDIAN_BAR
          and err["p90"] < FMM_DENSE_P90_BAR,
          f"dense FMM vs nbody_direct on the cube: {err}")
    return record


def phase_fmm_parity_path(device: dict) -> dict:
    """The sparse layout in both far modes against the dense grid on one
    overflow-free state (the 1M uniform cube at a forced depth, no leaf
    past the cap), on the card."""
    import numpy as np
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.ops import fmm, sfmm
    from gravity_tpu_torch.simulation import make_initial_state

    config = SimulationConfig(model="random", n=FMM_DENSE_N, eps=1e9)
    state = make_initial_state(config, torch.device("cuda", 0))
    pos, masses = state.positions, state.masses
    ids = sfmm._host_cell_ids(pos.cpu().numpy(), FMM_PARITY_DEPTH)
    counts = np.bincount(ids)
    cap = 32
    check(int(counts.max()) <= cap, f"parity state overflows: "
          f"{int(counts.max())} > {cap}")
    kw = dict(depth=FMM_PARITY_DEPTH, leaf_cap=cap, g=config.g, eps=config.eps)
    reset_counts()
    times = {"dense": cuda_ms(lambda: fmm.fmm_accelerations(pos, masses,
                                                            **kw), 1)}
    dense = fmm.fmm_accelerations(pos, masses, **kw).double()
    norm = dense.norm(dim=1)
    gaps = {}
    for mode in ("gather", "window"):
        def sparse(mode=mode):
            return sfmm.sfmm_accelerations(
                pos, masses, k_cells=int((counts > 0).sum()),
                far_mode=mode, **kw)
        times[mode] = cuda_ms(sparse, 1)
        rel = (sparse().double() - dense).norm(dim=1) / norm
        gaps[mode] = {"median": float(rel.median()),
                      "max": float(rel.max())}
    launches = read_counts()
    record = {"phase": "fmm_parity_path", "n": config.n,
              "depth": FMM_PARITY_DEPTH, "leaf_cap": cap,
              "max_leaf_load": int(counts.max()),
              "occupied": int((counts > 0).sum()), "eval_ms": times,
              "sparse_vs_dense": gaps, "counts": launches,
              "bars": {"median": FMM_PARITY_MEDIAN_BAR,
                       "max": FMM_PARITY_MAX_BAR},
              "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    check(not any(launches.values()), f"FMM parity launched {launches}")
    for mode, gap in gaps.items():
        check(gap["median"] < FMM_PARITY_MEDIAN_BAR
              and gap["max"] < FMM_PARITY_MAX_BAR,
              f"sparse ({mode}) vs dense: {gap}")
    return record


def phase_fmm_multirate_path(device: dict) -> dict:
    """baseline-1m-fmm --integrator multirate (two rungs, k = n / 8, sub
    4), cut to FMM_MULTIRATE_STEPS steps: the full evaluations through the
    sparse layout, the fast kicks through the dense grid's rectangular
    form (make_local_kernel("fmm")); one kick of the final state's fast
    rung against the exact sum at FMM_SAMPLE of its targets, held to the
    octree's bars at this sizing (depth 7, cap 32: tree_path)."""
    import dataclasses
    import warnings

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.simulation import Simulator

    config = dataclasses.replace(PRESETS["baseline-1m-fmm"],
                                 integrator="multirate",
                                 steps=FMM_MULTIRATE_STEPS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sim = Simulator(config)
    check(sim.fmm_sparse, "multirate: the full evaluation is not sparse")
    stats, counts = logged_run(sim, "fmm_multirate_path",
                               fixed_steps=config.steps)
    final = stats["final_state"]
    pos, masses = final.positions, final.masses
    k, _ = sim._multirate_plan()
    fast = fast_targets(sim, final, k)
    targets = pos[fast].contiguous()

    def kick():
        return sim._kick(targets, pos, masses)

    acc = kick()
    idx = fmm_sample(k, pos.device)
    errors = fmm_vs_direct(acc[idx], targets[idx], pos, masses, config)
    kick_ms = cuda_ms(kick, 2)
    record = {"phase": "fmm_multirate_path", "preset": "baseline-1m-fmm",
              "steps": config.steps, "cut_from": 500, "k": k,
              "kicks_per_step": config.multirate_sub,
              "full_evaluations_per_step": 1,
              "kick_t_cap": sim._kick.keywords.get("t_cap"),
              "kick_depth": sim._kick.keywords.get("depth"),
              "ms_per_step": 1e3 * stats["avg_step_s"], "kick_ms": kick_ms,
              "counts": counts, "kick_vs_nbody_direct": errors,
              "bars": {"median": TREE_1M_MEDIAN_BAR, "p90": TREE_P90_BAR},
              "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    check(errors["median"] < TREE_1M_MEDIAN_BAR
          and errors["p90"] < TREE_P90_BAR,
          f"fmm kick vs nbody_direct: {errors}")
    return record


def phase_fmm_debug_check(device: dict) -> dict:
    """`run --preset baseline-1m-fmm --steps 1 --debug-check` through the
    CLI, in this process: the audit of the sparse layout's full-set forces
    at the as-run sizing against the plain direct sum on 2,048 rows."""
    import contextlib
    import io

    from gravity_tpu_torch.cli import main as cli_main

    log_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(log_root, exist_ok=True)
    out = io.StringIO()
    with tempfile.TemporaryDirectory(dir=log_root) as log_dir:
        with contextlib.redirect_stdout(out):
            rc = cli_main(["run", "--preset", "baseline-1m-fmm", "--steps",
                           "1", "--debug-check", "--log-dir", log_dir])
    stats = json.loads(out.getvalue().strip().splitlines()[-1])
    check(rc == 0 and stats["fmm_mode"] == "sparse", f"fmm CLI: {stats}")
    audit = stats["debug_check"]
    record = {"phase": "fmm_debug_check", "preset": "baseline-1m-fmm",
              "steps": 1, "debug_check": audit,
              "bars": {"median": FMM_MEDIAN_BAR},
              "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    check(audit["median_rel_err"] < FMM_MEDIAN_BAR, f"fmm audit: {audit}")
    return record


# The serve phases (serve/): the batched kernels at B = 4 slots of bucket
# 8,192, the daemon through the CLI verbs, and served against solo runs.
SERVE_BUCKET = 8192
SERVE_SLOTS = 4
SERVE_EPS = 1e9
SERVE_SLICE = 100
SERVE_PARITY_STEPS = 50
# Served against unpadded solo runs, max relative position gap: fp32 the
# direct-sum jobs' bar; bf16 2^-5, the cell list's bf16 kernel bar (a gap
# there is a few bf16 roundings taken otherwise, not a fault).
SERVE_UNPADDED_BAR = {"float32": 1e-5, "bfloat16": 2.0**-5}
# The daemon's traffic: (label, n, model, integrator, steps, dt, priority,
# extra submit flags). Four jobs a bucket (8,192, 4,096, 1,024). The job
# that gets cancelled waits at priority -1 behind the four priority-1
# leapfrog jobs that fill its bucket-1,024 batch (a waiter takes a
# resident's slot by yield only at an equal or higher priority); its
# cancel is piped from its submit (phase_serve_path), and the record says
# whether it was still queued.
SERVE_JOBS = (
    ("a", 8192, "plummer", "leapfrog", 500, 3600.0, 0, ()),
    ("b", 8192, "random", "leapfrog", 250, 3600.0, 0, ()),
    ("c", 8192, "hernquist", "yoshida4", 100, 1800.0, 0, ()),
    ("d", 8192, "plummer", "leapfrog", 150, 7200.0, 0,
     ("--force-backend", "pallas-mxu")),
    ("e", 3000, "random", "leapfrog", 300, 1800.0, 1, ()),
    ("f", 3000, "plummer", "leapfrog", 200, 3600.0, 0,
     ("--dtype", "bfloat16")),
    ("g", 3000, "hernquist", "euler", 150, 3600.0, 0, ()),
    ("h", 3000, "random", "yoshida4", 100, 7200.0, 0,
     ("--dtype", "float64")),
    ("i", 700, "plummer", "leapfrog", 400, 3600.0, 1, ()),
    ("j", 700, "random", "leapfrog", 500, 7200.0, 1, ()),
    ("k", 700, "hernquist", "leapfrog", 500, 1800.0, 1, ()),
    ("l", 700, "random", "leapfrog", 500, 3600.0, 1, ()),
)
# The cancel target: long enough that it is still queued or running when
# the cancel lands (admission sums a job's t0 ledger on the card and no
# longer waits on the host: at 500 steps the target can complete first).
SERVE_CANCEL = ("x", 700, "random", "leapfrog", 50_000, 3600.0, -1, ())
# Served truncated physics (SERVE_NLIST's workload through submit): four
# fp32 jobs of one key at bucket 8,192, one of them 5,000 bodies (its
# padding overflows its first body's cell), and a bf16 job.
SERVE_NLIST_FLAGS = ("--force-backend", "nlist", "--nlist-rcut", "5e10",
                     "--nlist-side", "12", "--nlist-cap", "32")
SERVE_NLIST_PATH_JOBS = tuple(
    (label, n, "random", "leapfrog", steps, 3600.0, 0,
     SERVE_NLIST_FLAGS + ("--seed", str(seed)) + extra)
    for label, n, steps, seed, extra in (
        ("m", 5000, 150, 11, ()), ("n", 8192, 150, 12, ()),
        ("o", 6000, 100, 13, ()), ("p", 7000, 100, 14, ()),
        ("q", 5000, 100, 15, ("--dtype", "bfloat16"))))


def serve_batch(dtype):
    """The serve_kernels state: (B, 8192, 3) positions and (B, 8192)
    masses of a 5,000-body Plummer sphere, an 8,192-body random cube and
    the 3-body solar system, each padded to the bucket, and an empty
    slot; in float64, cast to ``dtype``."""
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.simulation import make_initial_state

    dev = torch.device("cuda", 0)
    pos, mass = [], []
    for model, n in (("plummer", 5000), ("random", 8192), ("solar", 3)):
        state = make_initial_state(
            SimulationConfig(model=model, n=n, dtype="float64"), dev)
        padded, _ = state.pad_to(SERVE_BUCKET)
        pos.append(padded.positions)
        mass.append(padded.masses)
    pos.append(torch.zeros_like(pos[0]))
    mass.append(torch.zeros_like(mass[0]))
    return (torch.stack(pos).to(dtype).contiguous(),
            torch.stack(mass).to(dtype).contiguous())


# The served cell list: README's cell-list workload at serving size
# (random model, rcut 5e10 m, eps 1e9 m; side 12, the cell edge = rcut
# for the 6e11 m cube; cap 32) at B = 4 slots of bucket 8,192: a
# 5,000-body job padded to the bucket (3,192 zero-mass bodies parked in
# its first body's cell, far past the cap), two more jobs and an empty
# slot.
SERVE_NLIST = dict(rcut=5e10, side=12, cap=32, eps=SERVE_EPS)
SERVE_NLIST_JOBS = ((5000, 0), (8192, 1), (3000, 2))


def serve_nlist_batch(dtype):
    """(B, 8192, 3) positions and (B, 8192) masses of the served cell
    list's batch (SERVE_NLIST_JOBS and an empty slot), in float64, cast
    to ``dtype``."""
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.simulation import make_initial_state

    dev = torch.device("cuda", 0)
    pos, mass = [], []
    for n, seed in SERVE_NLIST_JOBS:
        state = make_initial_state(SimulationConfig(
            model="random", n=n, seed=seed, dtype="float64"), dev)
        padded, _ = state.pad_to(SERVE_BUCKET)
        pos.append(padded.positions)
        mass.append(padded.masses)
    pos.append(torch.zeros_like(pos[0]))
    mass.append(torch.zeros_like(mass[0]))
    return (torch.stack(pos).to(dtype).contiguous(),
            torch.stack(mass).to(dtype).contiguous())


def serve_nlist_tiles(pos, mass):
    """The batched pair kernel's arguments for the batch, as
    nlist_accelerations_vs_batched builds them, and each slot's solo
    arguments as nlist_accelerations_vs builds them."""
    from gravity_tpu_torch.constants import G
    from gravity_tpu_torch.ops import nlist

    kw = {k: SERVE_NLIST[k] for k in ("rcut", "side", "cap")}
    _, _, params, _, binned = nlist.source_cells_batched(pos, mass, **kw)
    cells_pos, cells_mass, count = binned[:3]
    batched = (cells_pos, count, cells_pos, cells_mass * G, count,
               SERVE_NLIST["side"], params)
    solo = [nlist_tiles(pos[b], mass[b], SERVE_NLIST["side"],
                        SERVE_NLIST["cap"], SERVE_NLIST["rcut"])
            for b in range(pos.shape[0])]
    return batched, solo


def serve_nlist_kernels(device: dict) -> dict:
    """The batched nlist_pair (fp32, fp64, bf16) at SERVE_NLIST's batch:
    the batch's binning the bits of each slot's solo binning; each slot
    against the plain version under the kernel table's bars (fp32 1e-4,
    fp64 1e-12 of each row's sum of |terms|, bf16 2^-5), against a solo
    launch on the slot's arrays bit for bit (twice), one launch a batched
    evaluation; the whole batched evaluation the bits of the slots' solo
    evaluations (twice), finite on the empty slot. Then fp32 and bf16 by
    CUDA events: one batched launch, the four solo launches, the plain
    batched version, beside the bound (21 flops and one SFU rsqrt a real
    pair, tile_bytes for the bytes)."""
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.ops import nlist

    kw = dict(cutoff=CUTOFF_RADIUS, eps=SERVE_NLIST["eps"])
    ev = {k: SERVE_NLIST[k] for k in ("rcut", "side", "cap", "eps")}
    side, cap = SERVE_NLIST["side"], SERVE_NLIST["cap"]
    cases, timing = [], {}
    for name, dtype, tol, reason in (
            ("fp32", torch.float32, TOL["float32"], NLIST_REASON),
            ("fp64", torch.float64, TOL["float64"], NLIST_REASON),
            ("bf16", torch.bfloat16, NLIST_BF16_TOL, NLIST_BF16_REASON)):
        pos, mass = serve_nlist_batch(dtype)
        args, solo_args = serve_nlist_tiles(pos, mass)
        for b, sa in enumerate(solo_args):
            for k in (0, 1, 3, 6):
                want = sa[k].reshape(-1) if k == 6 else sa[k]
                got = args[k][b:b + 1] if k == 6 else args[k][b]
                check(torch.equal(got, want),
                      f"nlist batched {name}: slot {b}'s binning (arg {k}) "
                      "not the bits of its solo binning")
        key = nlist.launch_key("newton", True, dtype) + "/batched"
        before = nlist.LAUNCHES[key]
        batched = nlist.pair_cells_kernel_batched(*args, **kw)
        again = nlist.pair_cells_kernel_batched(*args, **kw)
        check(nlist.LAUNCHES[key] - before == 2,
              f"nlist_pair batched {name}: {nlist.LAUNCHES[key] - before} "
              "launches for 2 batched evaluations")
        solo = torch.stack([nlist.pair_cells_kernel(*sa, **kw)
                            for sa in solo_args])
        torch.cuda.synchronize()
        check(torch.equal(batched, again),
              f"nlist_pair batched {name}: two launches differ")
        check(torch.equal(batched, solo),
              f"nlist_pair batched {name}: not the bits of solo launches")
        slots = []
        for b, sa in enumerate(solo_args):
            plain = nlist.pair_cells_plain(*sa, **kw)
            scale = nlist.pair_cells_plain(*sa, absolute=True, **kw)
            slots.append(compare(
                f"nlist_pair/batched {name} slot {b}",
                batched[b].reshape(-1, 3), plain.reshape(-1, 3),
                scale.reshape(-1, 3), str(dtype).removeprefix("torch."),
                tol=tol, reason=reason))
        # The whole evaluation: the batch's glue around the launch.
        acc = nlist.nlist_accelerations_vs_batched(pos, mass, **ev)
        acc2 = nlist.nlist_accelerations_vs_batched(pos, mass, **ev)
        acc_solo = torch.stack([nlist.nlist_accelerations_vs(
            pos[b], pos[b], mass[b], **ev) for b in range(pos.shape[0])])
        torch.cuda.synchronize()
        check(bool(torch.isfinite(acc).all()),
              f"nlist batched evaluation {name}: not finite")
        check(torch.equal(acc, acc2),
              f"nlist batched evaluation {name}: two evaluations differ")
        check(torch.equal(acc, acc_solo),
              f"nlist batched evaluation {name}: not the bits of the "
              "slots' solo evaluations")
        count = args[1]
        cases.append({
            "kernel": "nlist_pair/batched", "case": name,
            "same_bits_as_solo": True, "bitwise_repeatable": True,
            "binning_bits_as_solo": True,
            "evaluation_bits_as_solo": True,
            "launches_per_batched_eval": 1,
            "overflowing_cells_by_slot": (count > cap).sum(dim=1).tolist(),
            "max_occupancy_by_slot": count.max(dim=1).values.tolist(),
            "max_abs_err": max(r["max_abs_err"] for r in slots),
            "max_err_over_term_scale": max(
                r["max_err_over_term_scale"] for r in slots),
            "tolerance": tol})
        if name == "fp64":
            continue
        n_slots = pos.shape[0]
        item = pos.element_size()
        pairs = sum(nlist.real_pairs(count[b], count[b], side, cap, cap)
                    for b in range(n_slots))
        n_bytes = sum(tile_bytes(count[b], count[b], side, cap, cap, item, 1)
                      for b in range(n_slots))

        def batched_fn(args=args):
            nlist.pair_cells_kernel_batched(*args, **kw)

        def solo_fn(solo_args=solo_args):
            for sa in solo_args:
                nlist.pair_cells_kernel(*sa, **kw)

        def plain_fn(args=args):
            nlist.pair_cells_plain_batched(*args, **kw)

        cuda_ms(batched_fn, 3)
        ms = [cuda_ms(batched_fn, 20), cuda_ms(batched_fn, 20)]
        cuda_ms(solo_fn, 3)
        solo_ms = cuda_ms(solo_fn, 20)
        cuda_ms(plain_fn, 1)
        plain_ms = cuda_ms(plain_fn, 3)
        label = ("nlist_pair/batched" if name == "fp32"
                 else "nlist_pair/batched_bf16")
        timing[label] = {
            "ms": min(ms), "ms_runs": ms, "solo_x4_ms": solo_ms,
            "plain_ms": plain_ms,
            **bound(pairs, NLIST_FLOPS_PER_PAIR, n_bytes, device,
                    PEAK_FP32_FLOPS if name == "fp32"
                    else PEAK_BF16X2_FLOPS),
            "pairs": pairs, "bytes": n_bytes, "slots": n_slots,
            "bucket": SERVE_BUCKET, "side": side, "cap": cap,
            "dtype": name, "library_ms": None,
            "library_note": "none: no PyTorch call computes a batched "
                            "cell-list pair sum",
        }
        timing[label]["share_of_bound"] = (timing[label]["bound_ms"]
                                           / timing[label]["ms"])
    return {"cases": cases, "timing": timing,
            "max_abs_err": {
                "nlist_pair/batched": max(c["max_abs_err"] for c in cases
                                          if c["case"] != "bf16"),
                "nlist_pair/batched_bf16": max(
                    c["max_abs_err"] for c in cases if c["case"] == "bf16")}}


def phase_serve_kernels(device: dict) -> dict:
    """The batched launches of nbody_direct (fp32 masked with eps 0, fp32
    mask-free, fp64, bf16) and nbody_mxu (fp32, bf16) at B = 4 slots of
    bucket 8,192: each slot against the plain version under the kernel
    table's bars, against a solo launch on the slot's arrays bit for bit
    (twice), one launch a batched evaluation; then ms by CUDA events for
    one batched launch and for the four solo launches, fp32 mask-free
    (the serve path's form), beside the bound."""
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS, G
    from gravity_tpu_torch.ops import direct_kernel, mxu_kernel
    from gravity_tpu_torch.ops.forces import accelerations_vs

    cases = []
    for name, dtype, eps, tol, reason in (
            ("fp32 masked eps=0", torch.float32, 0.0, TOL["float32"],
             DIRECT_REASON),
            ("fp32 mask-free", torch.float32, SERVE_EPS, TOL["float32"],
             DIRECT_REASON),
            ("fp64", torch.float64, 0.0, TOL["float64"], DIRECT_REASON),
            ("bf16", torch.bfloat16, SERVE_EPS, BF16_TOL, BF16_REASON)):
        pos, mass = serve_batch(dtype)
        before = direct_kernel.BATCHED_LAUNCHES
        batched = direct_kernel.accelerations_vs_batched_kernel(
            pos, pos, mass, eps=eps)
        again = direct_kernel.accelerations_vs_batched_kernel(
            pos, pos, mass, eps=eps)
        check(direct_kernel.BATCHED_LAUNCHES - before == 2,
              f"nbody_direct batched {name}: "
              f"{direct_kernel.BATCHED_LAUNCHES - before} launches for 2 "
              "batched evaluations")
        solo = torch.stack([direct_kernel.accelerations_vs_kernel(
            pos[b], pos[b], mass[b], eps=eps) for b in range(SERVE_SLOTS)])
        torch.cuda.synchronize()
        check(torch.equal(batched, again),
              f"nbody_direct batched {name}: two launches differ")
        check(torch.equal(batched, solo),
              f"nbody_direct batched {name}: not the bits of solo launches")
        slots = []
        for b in range(SERVE_SLOTS):
            plain = accelerations_vs(pos[b], pos[b], mass[b], eps=eps)
            slots.append(compare(
                f"nbody_direct/batched {name} slot {b}", batched[b], plain,
                term_scale(pos[b], pos[b], mass[b], eps, chunk=256),
                str(dtype).removeprefix("torch."), tol=tol, reason=reason))
        cases.append({"kernel": "nbody_direct/batched", "case": name,
                      "same_bits_as_solo": True, "bitwise_repeatable": True,
                      "launches_per_batched_eval": 1,
                      "max_abs_err": max(r["max_abs_err"] for r in slots),
                      "max_err_over_term_scale": max(
                          r["max_err_over_term_scale"] for r in slots),
                      "tolerance": tol})
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        pos, mass = serve_batch(dtype)
        before = mxu_kernel.BATCHED_LAUNCHES
        batched = mxu_kernel.accelerations_vs_mxu_batched_kernel(
            pos, pos, mass, eps=SERVE_EPS)
        again = mxu_kernel.accelerations_vs_mxu_batched_kernel(
            pos, pos, mass, eps=SERVE_EPS)
        solo = torch.stack([mxu_kernel.accelerations_vs_mxu_kernel(
            pos[b], pos[b], mass[b], eps=SERVE_EPS)
            for b in range(SERVE_SLOTS)])
        # [S | W] of the batched launch against the plain version, slot by
        # slot, on the wrapper's own centred operands.
        compute = torch.bfloat16 if name == "bf16" else torch.float32
        xs, gms = [], []
        for b in range(SERVE_SLOTS):
            center = pos[b].float().mean(dim=0)
            xs.append((pos[b].float() - center).to(compute))
            gms.append(mass[b].float() * G)
        xi, gm = torch.stack(xs).contiguous(), torch.stack(gms).contiguous()
        acc4 = mxu_kernel.gram_acc4_batched(xi, xi, gm, cutoff=CUTOFF_RADIUS,
                                            eps=SERVE_EPS)
        check(mxu_kernel.BATCHED_LAUNCHES - before == 3,
              f"nbody_mxu batched {name}: "
              f"{mxu_kernel.BATCHED_LAUNCHES - before} launches for 3 "
              "batched evaluations")
        solo4 = torch.stack([mxu_kernel.gram_acc4(
            xi[b], xi[b], gm[b], cutoff=CUTOFF_RADIUS, eps=SERVE_EPS)
            for b in range(SERVE_SLOTS)])
        torch.cuda.synchronize()
        check(torch.equal(batched, again),
              f"nbody_mxu batched {name}: two launches differ")
        check(torch.equal(batched, solo),
              f"nbody_mxu batched {name}: not the bits of solo launches")
        check(torch.equal(acc4, solo4),
              f"nbody_mxu batched {name}: [S | W] not the solo bits")
        slots = []
        for b in range(SERVE_SLOTS):
            plain = mxu_kernel.gram_acc4_plain(
                xi[b], xi[b], gm[b], cutoff=CUTOFF_RADIUS, eps=SERVE_EPS,
                bf16=name == "bf16")
            slots.append(compare(
                f"nbody_mxu/batched {name} slot {b}", acc4[b], plain,
                mxu_scale(xi[b], xi[b], gm[b], SERVE_EPS, name == "bf16"),
                "float32", reason=MXU_REASON))
        cases.append({"kernel": "nbody_mxu/batched", "case": name,
                      "same_bits_as_solo": True, "bitwise_repeatable": True,
                      "launches_per_batched_eval": 1,
                      "max_abs_err": max(r["max_abs_err"] for r in slots),
                      "max_err_over_term_scale": max(
                          r["max_err_over_term_scale"] for r in slots),
                      "tolerance": TOL["float32"]})
    served_nlist = serve_nlist_kernels(device)
    cases += served_nlist["cases"]
    for case in cases:
        emit({"phase": "serve_kernels", **case})

    # Timing, fp32 mask-free: the serve path's form.
    pos, mass = serve_batch(torch.float32)
    xi = torch.stack([pos[s] - pos[s].mean(dim=0)
                      for s in range(SERVE_SLOTS)]).contiguous()
    gm = (mass * G).contiguous()
    b, n = SERVE_SLOTS, SERVE_BUCKET
    pairs = b * n * n
    n_bytes = b * (n * 3 * 4 * 2 + n * 4 + n * 3 * 4)
    timing = {}
    for kernel, batched_fn, solo_fn, plain_fn, bnd in (
            ("nbody_direct/batched",
             lambda: direct_kernel.accelerations_vs_batched_kernel(
                 pos, pos, mass, eps=SERVE_EPS),
             lambda: [direct_kernel.accelerations_vs_kernel(
                 pos[s], pos[s], mass[s], eps=SERVE_EPS) for s in range(b)],
             lambda: direct_kernel.accelerations_vs_batched(
                 pos, pos, mass, eps=SERVE_EPS),
             bound(pairs, FLOPS_PER_PAIR, n_bytes, device)),
            ("nbody_mxu/batched",
             lambda: mxu_kernel.accelerations_vs_mxu_batched_kernel(
                 pos, pos, mass, eps=SERVE_EPS),
             lambda: [mxu_kernel.accelerations_vs_mxu_kernel(
                 pos[s], pos[s], mass[s], eps=SERVE_EPS) for s in range(b)],
             lambda: torch.stack([mxu_kernel.gram_acc4_plain(
                 xi[s], xi[s], gm[s], cutoff=CUTOFF_RADIUS, eps=SERVE_EPS,
                 bf16=False) for s in range(b)]),
             mxu_bound(pairs, n_bytes + b * n * 4 * 4, device, False))):
        cuda_ms(batched_fn, 3)
        ms = [cuda_ms(batched_fn, 20), cuda_ms(batched_fn, 20)]
        cuda_ms(solo_fn, 3)
        solo_ms = cuda_ms(solo_fn, 20)
        cuda_ms(plain_fn, 1)
        plain_ms = cuda_ms(plain_fn, 3)
        timing[kernel] = {
            "ms": min(ms), "ms_runs": ms, "solo_x4_ms": solo_ms,
            "plain_ms": plain_ms, **bnd, "pairs": pairs, "slots": b,
            "bucket": n, "eps": SERVE_EPS,
            "library_ms": None,
            "library_note": "none: no PyTorch call computes a batched "
                            "softened pair sum",
        }
        emit({"phase": "serve_kernels_timing", "kernel": kernel,
              "nvidia_smi": device["nvidia_smi"], **timing[kernel]})
    for kernel, t in served_nlist["timing"].items():
        timing[kernel] = t
        emit({"phase": "serve_kernels_timing", "kernel": kernel,
              "nvidia_smi": device["nvidia_smi"], **t})
    return {"cases": cases, "timing": timing,
            "max_abs_err": {
                **{k: max(c["max_abs_err"] for c in cases
                          if c["kernel"] == k)
                   for k in ("nbody_direct/batched", "nbody_mxu/batched")},
                **served_nlist["max_abs_err"]}}


def serve_cli(spool: str, *args) -> list:
    return [sys.executable, "-m", "gravity_tpu_torch", *serve_args(spool,
                                                                   *args)]


def serve_args(spool: str, *args) -> list:
    """A client verb's arguments against the daemon of ``spool``."""
    return [*args, "--spool-dir", spool]


def run_clients(argvs) -> list:
    """Client verbs (``submit``, ``status``, ``result``) through
    ``run_cli`` in this process, one after another: (returncode, stdout,
    stderr) of each, as ``run_parallel`` gives them for processes."""
    return [(p.returncode, p.stdout, p.stderr)
            for p in (run_cli(a) for a in argvs)]


def submit_args(job) -> list:
    _, n, model, integrator, steps, dt, prio, extra = job
    return ["submit", "--model", model, "--n", str(n), "--integrator",
            integrator, "--steps", str(steps), "--dt", str(dt), "--eps",
            str(SERVE_EPS), "--priority", str(prio), *extra]


def phase_serve_path(device: dict, started) -> dict:
    """The daemon on the card through the user's verbs: ``serve --slots 4
    --slice-steps 100`` as a process (``started``: its spool and process,
    :func:`start_verb`), 12 jobs by ``submit`` at buckets
    8,192, 4,096 and 1,024 (plummer, random, hernquist; leapfrog, two
    yoshida4, one euler; priorities 0 and 1; auto but one pallas-mxu, one
    bf16 and one fp64 job) and 5 served cell-list jobs
    (SERVE_NLIST_PATH_JOBS: two nlist keys, each key reading
    backend=nlist, launches = batched evaluations, every key's measured
    first-round peak at most its admission estimate), a 13th job, queued
    behind its batch's
    priority-1 residents, cancelled by ``cancel`` (a process that has
    loaded the CLI while the submit ran, fed the job id through a pipe;
    its events say whether it was still queued), then ``status`` and
    ``result --out`` for each. The daemon's /metrics
    gives the builds, force evaluations, launches, host reads, router
    verdicts and the perf ledger's peaks; its event stream the rounds."""
    import shutil

    import numpy as np

    from gravity_tpu_torch.serve import request, wait_for

    spool, daemon = started
    env = dict(os.environ, PYTHONPATH=REPO)
    try:
        t0 = time.perf_counter()
        banner = json.loads(daemon.stdout.readline())
        check(banner.get("serving") and banner["device"].startswith(
            "cuda"), f"daemon banner {banner}")
        # The cancel target's submit, 2 s behind the traffic's (its
        # batch's priority-1 jobs resident by then), piped into a
        # process that has loaded the CLI and the serve package
        # meanwhile: the cancel lands milliseconds after the submit.
        submit = " ".join(serve_cli(spool, *submit_args(SERVE_CANCEL)))
        cancel = (f"{sys.executable} -c 'import json, sys; "
                  "from gravity_tpu_torch.cli import main; "
                  "import gravity_tpu_torch.serve; "
                  "job = json.loads(sys.stdin.read())[\"job\"]; "
                  "print(job); sys.stdout.flush(); "
                  f"sys.exit(main([\"cancel\", \"--spool-dir\", "
                  f"\"{spool}\", job]))'")
        jobs_all = SERVE_JOBS + SERVE_NLIST_PATH_JOBS
        piped = subprocess.Popen(
            ["bash", "-o", "pipefail", "-c",
             f"sleep 2; {submit} | {cancel}"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        # The traffic's submits through the CLI in this process.
        subs = run_clients([serve_args(spool, *submit_args(j))
                            for j in jobs_all])
        subs.append((piped.wait(timeout=300), *piped.communicate()))
        ids = {}
        for job, (rc, out, err) in zip(jobs_all, subs):
            check(rc == 0, f"submit {job[0]}: rc {rc}: {err[-2000:]}")
            ids[job[0]] = json.loads(out.strip().splitlines()[-1])["job"]
        rc, out, err = subs[-1]
        lines = out.strip().splitlines()
        check(rc == 0 and json.loads(lines[-1])["cancelled"],
              f"submit | cancel: rc {rc} {out} {err[-2000:]}")
        cancel_id = lines[0]
        statuses = wait_for(spool, list(ids.values()), timeout=600)
        serve_s = time.perf_counter() - t0
        rc, out, err = run_clients([serve_args(spool, "status")])[0]
        check(rc == 0, f"status: {err[-1000:]}")
        listing = {j["id"]: j for j in json.loads(out)["jobs"]}
        check(listing[cancel_id]["status"] == "cancelled",
              f"cancel target is {listing[cancel_id]['status']}")
        res_dir = os.path.join(spool, "out")
        os.makedirs(res_dir)
        results = run_clients([
            serve_args(spool, "result", jid, "--out",
                       os.path.join(res_dir, f"{label}.npz"))
            for label, jid in ids.items()])
        for (label, jid), (rc, out, err) in zip(ids.items(), results):
            check(rc == 0, f"result {label}: {err[-1000:]}")
            st = statuses[jid]
            check(st["status"] == "completed"
                  and st["steps_done"] == st["steps"],
                  f"job {label}: {st['status']} {st['steps_done']}/"
                  f"{st['steps']} {st.get('error')}")
            with np.load(os.path.join(res_dir, f"{label}.npz")) as z:
                for k in ("positions", "velocities", "masses"):
                    check(bool(np.isfinite(z[k]).all()),
                          f"job {label}: {k} not finite")
                n = dict((j[0], j[1]) for j in jobs_all)[label]
                check(z["positions"].shape == (n, 3),
                      f"job {label}: shape {z['positions'].shape}")
        metrics = request(spool, "GET", "/metrics")
        with open(os.path.join(spool, "serving_events.jsonl")) as f:
            events = [json.loads(line) for line in f if line.strip()]
        mine = [e["event"] for e in events if e.get("job") == cancel_id]
        check(mine[0] == "submitted" and mine[-1] == "cancelled",
              f"the cancelled job's events {mine}")
    finally:
        try:
            request(spool, "POST", "/shutdown")
        except Exception:  # noqa: BLE001 — the wait below decides
            pass
        try:
            daemon.wait(timeout=60)
        except subprocess.TimeoutExpired:
            daemon.kill()
            daemon.wait()
        shutil.rmtree(spool, ignore_errors=True)
    engine = metrics["engine"]
    launches = metrics["kernel_launches"]
    check(all(v == 1 for v in engine["builds"].values()),
          f"builds per key {engine['builds']}")
    for key in engine["builds"]:
        check(any(f"backend={b}," in key
                  for b in ("pallas", "pallas-mxu", "nlist")),
              f"a key off the kernels: {key}")
    nlist_keys = [k for k in engine["builds"] if "backend=nlist," in k]
    check(len(nlist_keys) == 2 and any("dtype=bfloat16" in k
                                       for k in nlist_keys),
          f"the nlist jobs' keys {nlist_keys}")
    for bucket, verdict in metrics["router"].items():
        check(verdict["backend"] in ("pallas", "pallas-mxu"),
              f"auto at {bucket} resolved to {verdict['backend']}")
    evals = engine["force_evals"]
    check(launches["nbody_direct/batched"] == evals.get("pallas", 0),
          f"nbody_direct batched launches {launches} vs evaluations "
          f"{evals}")
    check(launches["nbody_mxu/batched"] == evals.get("pallas-mxu", 0),
          f"nbody_mxu batched launches {launches} vs evaluations {evals}")
    check(launches["nlist_pair/batched"]
          + launches["nlist_pair/batched_bf16"] == evals.get("nlist", 0),
          f"nlist_pair batched launches {launches} vs evaluations {evals}")
    for kernel in ("nbody_direct/batched", "nbody_mxu/batched",
                   "nlist_pair/batched", "nlist_pair/batched_bf16"):
        check(launches[kernel] > 0, f"no {kernel} launch")
    # The serve keys' rows (the ledger also holds the admission probes'
    # block rows, site autotune_probe, since PR 17).
    peaks = {r["key"]: {"measured": r.get("peak_bytes"),
                        "estimated": r.get("estimated_bytes")}
             for r in metrics["perf_ledger"]
             if r.get("site") == "serve_round"}
    check(len(peaks) == len(engine["builds"]),
          f"{len(peaks)} ledger rows for {len(engine['builds'])} keys")
    for key, p in peaks.items():
        check(p["measured"] is not None and p["measured"] <= p["estimated"],
              f"{key}: first-round peak {p['measured']} above the "
              f"admission estimate {p['estimated']}")
    rounds = [e for e in events if e.get("event") == "round"]
    by_bucket = {}
    for e in rounds:
        name = (e["bucket"] if e["backend"] != "nlist"
                else f"nlist {e['dtype']} {e['bucket']}")
        by_bucket.setdefault(name, []).append(e)
    jobs = {j[0]: j for j in jobs_all}
    body_steps = sum(jobs[label][1] * jobs[label][4] for label in ids)
    # Direct-sum pairs of the direct-sum jobs, over their rounds.
    direct = [label for label in ids if label in {j[0] for j in SERVE_JOBS}]
    pair_evals = sum(
        jobs[label][1] * (jobs[label][1] - 1) * jobs[label][4]
        * (3 if jobs[label][3] == "yoshida4" else 1) for label in direct)
    round_s = sum(e["round_s"] for e in rounds)
    direct_round_s = sum(e["round_s"] for e in rounds
                         if e["backend"] != "nlist")
    record = {
        "phase": "serve_path", "nvidia_smi": device["nvidia_smi"],
        "jobs": len(ids), "cancelled": cancel_id,
        "cancelled_job_events": mine,
        "cancelled_while_queued": "admitted" not in mine,
        "wall_s": serve_s, "rounds": len(rounds),
        "ms_per_round_by_bucket": {
            b: {"median": 1e3 * statistics.median(e["round_s"] for e in es),
                "rounds": len(es),
                "mean_slots_used": statistics.mean(e["slots_used"]
                                                   for e in es)}
            for b, es in sorted(by_bucket.items(), key=lambda kv:
                                str(kv[0]))},
        "body_steps_per_s": body_steps / round_s,
        "pairs_per_s": pair_evals / direct_round_s,
        "round_s_total": round_s,
        "mean_occupancy": statistics.mean(e["occupancy"] for e in rounds),
        "latency_s": metrics["latency"],
        "builds": engine["builds"], "build_seconds": engine["build_seconds"],
        "force_evals": evals, "kernel_launches": launches,
        "host_reads": engine["host_reads"],
        "host_reads_per_round": {
            k: v / max(1, metrics["rounds"])
            for k, v in engine["host_reads"].items()},
        "router": metrics["router"],
        "peak_bytes_vs_estimate": peaks,
        "nlist_keys": nlist_keys,
    }
    emit(record)
    return record


def phase_serve_parity(device: dict) -> dict:
    """Served runs in process against solo Simulator runs on the card:
    four jobs of 50 steps through pallas, two through pallas-mxu (n from
    700 to 8,192) and three served cell lists (fp32 at 5,000 and 8,192
    bodies, bf16 at 5,000) each bit for bit the solo run of its
    bucket-padded state and within SERVE_UNPADDED_BAR of the unpadded
    one; a diverging job (dt = 1e30) in a full batch fails alone, rolled
    back to its last finite state, its batchmates keeping their bits.
    Then one round of each bucket and of the cell list under the sync
    debug mode (host syncs, by source line) and under the profiler (the
    device's busy share, kernels a round)."""
    import linecache
    import warnings

    import numpy as np
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.serve import EnsembleScheduler, bucket_size
    from gravity_tpu_torch.simulation import Simulator, make_initial_state

    dev = torch.device("cuda", 0)
    specs = (("pallas", "plummer", 700, "leapfrog"),
             ("pallas", "random", 1000, "yoshida4"),
             ("pallas", "hernquist", 3000, "leapfrog"),
             ("pallas", "plummer", 8192, "leapfrog"),
             ("pallas-mxu", "plummer", 2000, "leapfrog"),
             ("pallas-mxu", "plummer", 8192, "leapfrog"))
    configs = [SimulationConfig(model=m, n=n, integrator=it, steps=SERVE_PARITY_STEPS,
                                dt=3600.0, eps=SERVE_EPS, force_backend=fb)
               for fb, m, n, it in specs]
    # Served cell lists: an fp32 key at bucket 8,192 (5,000 and 8,192
    # bodies) and a bf16 one.
    nlist_kw = dict(model="random", integrator="leapfrog",
                    steps=SERVE_PARITY_STEPS, dt=3600.0, eps=SERVE_EPS,
                    force_backend="nlist", nlist_rcut=SERVE_NLIST["rcut"],
                    nlist_side=SERVE_NLIST["side"],
                    nlist_cap=SERVE_NLIST["cap"])
    configs += [SimulationConfig(n=n, seed=seed, dtype=dtype, **nlist_kw)
                for n, seed, dtype in ((5000, 21, "float32"),
                                       (8192, 22, "float32"),
                                       (5000, 23, "bfloat16"))]

    def max_rel(a, b):
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))

    sched = EnsembleScheduler(slots=SERVE_SLOTS, slice_steps=SERVE_SLICE,
                              device=dev, sentinel_every=0)
    ids = [sched.submit(c) for c in configs]
    # The diverging batch: three good jobs and one at dt = 1e30 in one key
    # (unsoftened random cubes: the close pairs overflow fp32 at once).
    div_good = [SimulationConfig(model="random", n=600 + 100 * k,
                                 integrator="leapfrog", seed=k,
                                 steps=SERVE_PARITY_STEPS, dt=3600.0,
                                 force_backend="pallas")
                for k in range(3)]
    div_bad = dataclasses.replace(div_good[0], dt=1e30, seed=9)
    div_ids = [sched.submit(c) for c in div_good] + [sched.submit(div_bad)]
    sched.run_until_idle()
    records = []
    for c, jid in zip(configs + div_good, ids + div_ids[:3]):
        st = sched.status(jid)
        check(st["status"] == "completed", f"served {c.model} n={c.n}: {st}")
        served = sched.result(jid)
        state = make_initial_state(c, dev)
        padded, _ = state.pad_to(bucket_size(c.n))
        solo_pad = Simulator(dataclasses.replace(c, n=padded.n),
                             state=padded).run()["final_state"]
        solo = Simulator(c, state=state).run()["final_state"]
        same = all(torch.equal(getattr(served, k).to(dev),
                               getattr(solo_pad, k)[:c.n])
                   for k in ("positions", "velocities"))
        check(same, f"served {c.force_backend} {c.model} n={c.n} "
                    f"{c.integrator} {c.dtype}: not the bits of the padded "
                    "solo run")
        rel = max_rel(served.positions.double().cpu().numpy(),
                      solo.positions.double().cpu().numpy())
        bar = SERVE_UNPADDED_BAR[c.dtype]
        check(rel <= bar, f"served {c.force_backend} n={c.n} {c.dtype}: "
                          f"max rel {rel:.3e} against the unpadded solo run")
        records.append({"backend": c.force_backend, "model": c.model,
                        "n": c.n, "integrator": c.integrator,
                        "dtype": c.dtype, "bits_equal_padded_solo": True,
                        "max_rel_vs_unpadded_solo": rel,
                        "unpadded_bar": bar})
    bad = sched.status(div_ids[3])
    check(bad["status"] == "failed" and "diverged" in (bad["error"] or ""),
          f"diverging job: {bad}")
    rolled = sched.jobs[div_ids[3]].state
    start = make_initial_state(div_bad, dev)
    check(bool(torch.isfinite(rolled.positions).all())
          and torch.equal(rolled.positions.to(dev), start.positions),
          "diverging job not rolled back to its last finite state")
    sched.close_io()
    # One round of each bucket, and of the served cell list at 8,192:
    # host syncs and the device's busy share.
    rounds = {}
    round_cases = [(bucket_size(n), SimulationConfig(
        model="plummer", n=n, integrator="leapfrog", steps=10 * SERVE_SLICE,
        dt=3600.0, eps=SERVE_EPS, force_backend="pallas"))
        for n in (700, 3000, 8192)]
    round_cases.append(("nlist 8192", SimulationConfig(
        n=8192, **dict(nlist_kw, steps=10 * SERVE_SLICE))))
    for name, c in round_cases:
        probe = EnsembleScheduler(slots=SERVE_SLOTS, slice_steps=SERVE_SLICE,
                                  device=dev, sentinel_every=0)
        for k in range(SERVE_SLOTS):
            probe.submit(dataclasses.replace(c, seed=k))
        probe.run_round()  # the build and first round: the steady rounds
        # below neither build nor finish a job (no result copies).
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                probe.run_round()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sites = [f"{os.path.relpath(w.filename, REPO)}:{w.lineno}: "
                 f"{linecache.getline(w.filename, w.lineno).strip()}"
                 for w in caught if "synchroniz" in str(w.message)
                 and "set_sync_debug_mode" not in
                 linecache.getline(w.filename, w.lineno)]
        # The cell list's profiler ranges are stages, not kernels.
        prof = fmm_profile(probe.run_round,
                           ("serve", "nlist.", "segment_sum."))
        probe.close_io()
        rounds[name] = {
            "host_syncs_per_round": len(sites), "sync_sites": sites,
            "stage_device_span_ms_per_round":
                prof["stage_device_span_ms_per_eval"],
            "ms_per_round_profiled": prof["wall_ms_per_eval_profiled"],
            "device_busy_share": prof["device_busy_share"],
            "device_ms_per_round": prof["device_ms_per_eval"],
            "kernels_per_round": prof["device_kernels_per_eval"],
            "top_kernels": prof["top_kernels_ms_per_eval"][:4],
        }
    record = {"phase": "serve_parity", "nvidia_smi": device["nvidia_smi"],
              "jobs": records, "diverging_job": {
                  "status": bad["status"], "error": bad["error"],
                  "rolled_back_to_start": True,
                  "batchmates_bits_equal_padded_solo": True},
              "rounds": rounds}
    emit(record)
    return record


# --- the performance observatory (PR 17) ---

# The JAX suite's band for a direct sum's model_ratio
# (tests/test_perf_observatory.py:79).
DIRECT_RATIO_BAND = (0.8, 3.0)
# The card's fp32 peak (non-tensor FMA, TFLOP/s): a row's share of it.
FP32_PEAK_TFLOPS = 67.0
# The contracts of PERF_BASELINE.json that run on the card; the sixth,
# the halo exchange, runs on gloo ranks of the host's CPU, here cut to
# GATE_HALO_CUT (the committed 8 x 2,048 bodies and 5 pairs take about a
# minute of the script's limit).
GATE_CONTRACTS = ("ledger_coverage", "nlist_vs_chunked_speedup",
                  "nlist_scaling_subquadratic", "host_gap_pipelined",
                  "serve_compile_once")
GATE_HALO_CUT = {"n_per_device": 512, "reps": 2}


def perf_row_summary(name: str, record: dict, direct: bool) -> dict:
    """A path's perf-ledger rows (its run's ``stats["perf"]``): each row's
    counted flops and bytes a step beside the path's ms a step, checked
    finite, the peak from the allocator, a direct sum's model_ratio in the
    JAX suite's band."""
    rows = record.get("perf") or []
    check(bool(rows), f"perf_ledger: {name} has no ledger row")
    out = []
    for row in rows:
        for field in ("flops", "bytes_accessed", "peak_bytes",
                      "model_ratio"):
            check(row.get(field) is not None
                  and math.isfinite(float(row[field])),
                  f"perf_ledger: {name} row {field}={row.get(field)!r}")
        check(row.get("flops_source") == "counted"
              and row.get("peak_source") == "cuda_allocator",
              f"perf_ledger: {name} sources {row.get('flops_source')}, "
              f"{row.get('peak_source')}")
        if direct:
            lo, hi = DIRECT_RATIO_BAND
            check(lo <= row["model_ratio"] <= hi,
                  f"perf_ledger: {name} model_ratio {row['model_ratio']}")
            check(row.get("kernel_launches_counted", 0) >= 1,
                  f"perf_ledger: {name} counted no kernel launch")
        ms = record["ms_per_step"]
        out.append({
            "key": row["key"], "n_steps": row.get("n_steps"),
            "flops_per_step": row["flops"],
            "bytes_per_step": row["bytes_accessed"],
            "transcendentals_per_step": row.get("transcendentals"),
            "peak_bytes": row["peak_bytes"],
            "model_ratio": row["model_ratio"],
            "kernel_launches_counted": row.get("kernel_launches_counted"),
            "ms_per_step": ms,
            "achieved_tflops": row["flops"] / (ms * 1e-3) / 1e12,
            "share_of_fp32_peak":
                row["flops"] / (ms * 1e-3) / (FP32_PEAK_TFLOPS * 1e12),
            "bytes_per_s": row["bytes_accessed"] / (ms * 1e-3)})
    return {"rows": out, "ms_per_step": record["ms_per_step"]}


def reference_cuda_ms(counted: bool) -> float:
    """ms a step of a fresh reference-cuda run, its blocks counted at their
    first call as a run is (one ledger row a block signature), or all under
    ``perf.uncounted()`` (no row)."""
    import contextlib

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.simulation import Simulator
    from gravity_tpu_torch.telemetry import perf

    sim = Simulator(PRESETS["reference-cuda"])
    before = len(perf.ledger().rows_list())
    with contextlib.nullcontext() if counted else perf.uncounted():
        stats = sim.run()
    rows = perf.ledger().rows_list()[before:]
    sigs = {(r["n_steps"], r["record_every"]) for r in rows}
    check(len(rows) == len(sigs) and bool(rows) == counted,
          f"perf_ledger: counted={counted} run's rows {rows}")
    return 1e3 * stats["avg_step_s"]


def phase_perf_ledger(device: dict, paths: dict) -> dict:
    """The ledger rows of the paths already run (reference-cuda,
    baseline-16k, the README cell list, the Gram form, the octree, the
    sparse FMM): counted flops, bytes and peaks, each beside its path's
    ms a step and its share of the card's fp32 peak; then the counted
    pass's cost: reference-cuda three times counted and three times
    uncounted, in turns (CU, UC, CU), the counted runs' mean within the
    runs' spread of the uncounted mean, and one row a signature."""
    from gravity_tpu_torch.telemetry import perf

    direct = {"main_path", "baseline16k_path", "mxu_path"}
    rows = {name: perf_row_summary(name, rec, name in direct)
            for name, rec in paths.items()}
    perf.ledger().reset()
    ms = {"counted": [], "uncounted": []}
    # In turns (counted first, then uncounted first, ...): a run's place in
    # the sequence moves it by about as much as the effect looked for.
    for i in range(3):
        for counted in ((True, False) if i % 2 == 0 else (False, True)):
            ms["counted" if counted else "uncounted"].append(
                reference_cuda_ms(counted))
    spread = max(max(v) - min(v) for v in ms.values())
    moved = (statistics.mean(ms["counted"])
             - statistics.mean(ms["uncounted"]))
    record = {"phase": "perf_ledger", "paths": rows,
              "reference_cuda_ms_per_step": ms, "counted_moved_ms": moved,
              "run_to_run_spread_ms": spread,
              "fp32_peak_tflops": FP32_PEAK_TFLOPS,
              "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    check(abs(moved) <= spread,
          f"perf_ledger: the counted pass moved reference-cuda by "
          f"{moved:.4f} ms a step, beyond the spread {spread:.4f}")
    return record


def run_gate_cli(contracts, out: str, env_extra=None,
                 baseline=None) -> tuple:
    """``bench --gate`` as a process on the committed baseline (or
    ``baseline``); (exit code, its report or None, its stdout)."""
    env = dict(os.environ, **(env_extra or {}))
    extra = ["--gate-baseline", baseline] if baseline else []
    proc = subprocess.run(
        [sys.executable, "-m", "gravity_tpu_torch", "bench", "--gate",
         "--gate-contracts", ",".join(contracts), "--gate-out", out, *extra],
        cwd=REPO, capture_output=True, text=True, timeout=900, env=env)
    report = json.load(open(out)) if os.path.exists(out) else None
    return proc.returncode, report, proc.stdout + proc.stderr[-2000:]


def phase_gate_path(device: dict) -> dict:
    """``bench --gate`` on PERF_BASELINE.json as written: the five
    contracts that run on the card, each value, CI and verdict; the halo
    exchange's contract (halo_vs_allgather_speedup), measured on 8 gloo
    ranks of the host's CPU as the JAX package measures it on a virtual
    CPU mesh, at GATE_HALO_CUT, its value, CI and verdict (the CPU's
    ratio, not the card's); a planted 2x handicap on arm b of
    nlist_vs_chunked_speedup (in this process), which must turn its
    verdict to violated. A
    timing contract that is violated is a finding (reported), not a
    failure of the phase."""
    from gravity_tpu_torch import perfgate

    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    five = os.path.join(out_dir, "perf_gate_torch.json")
    halo_out = os.path.join(out_dir, "perf_gate_torch_halo.json")
    for path in (five, halo_out):
        if os.path.exists(path):
            os.remove(path)
    rc, report, text = run_gate_cli(GATE_CONTRACTS, five)
    check(report is not None, f"gate_path: no report (rc {rc}): {text}")
    by_name = {r["name"]: r for r in report["results"]}
    check(sorted(by_name) == sorted(GATE_CONTRACTS),
          f"gate_path: contracts {sorted(by_name)}")
    for r in report["results"]:
        check("error" not in r["detail"],
              f"gate_path: {r['name']} errored: {r['detail']}")
        check(r["measured"] is not None
              and math.isfinite(float(r["measured"])),
              f"gate_path: {r['name']} measured {r['measured']}")
    check(by_name["ledger_coverage"]["ok"]
          and by_name["ledger_coverage"]["measured"] == 7.0,
          f"gate_path: ledger_coverage {by_name['ledger_coverage']}")
    check(by_name["serve_compile_once"]["ok"],
          f"gate_path: serve_compile_once {by_name['serve_compile_once']}")
    committed = perfgate.load_baseline(os.path.join(
        REPO, perfgate.BASELINE_FILE))
    names = {c["name"] for c in committed["contracts"]}
    check(names == {*GATE_CONTRACTS, "halo_vs_allgather_speedup"},
          f"gate_path: baseline contracts {sorted(names)}")
    cut = os.path.join(out_dir, "perf_baseline_halo_cut.json")
    with open(cut, "w") as f:
        json.dump({**committed, "contracts": [
            {**c, "params": {**c["params"], **GATE_HALO_CUT}}
            for c in committed["contracts"]
            if c["name"] == "halo_vs_allgather_speedup"]}, f)
    rc_halo, report_halo, text_halo = run_gate_cli(
        ["halo_vs_allgather_speedup"], halo_out, baseline=cut)
    check(report_halo is not None,
          f"gate_path: no halo report (rc {rc_halo}): {text_halo}")
    (halo,) = report_halo["results"]
    check("error" not in halo["detail"] and halo["measured"] is not None
          and math.isfinite(float(halo["measured"]))
          and rc_halo == (0 if halo["ok"] else 1),
          f"gate_path: halo contract {halo}")
    handicap = json.dumps({"contract": "nlist_vs_chunked_speedup",
                           "arm": "b", "factor": 2.0})
    planted_out = os.path.join(out_dir, "perf_gate_torch_planted.json")
    # The planted run in this process: the gate reads the handicap from the
    # environment at each call.
    os.environ["GRAVITY_TPU_PERF_HANDICAP"] = handicap
    try:
        planted_proc = run_cli(["bench", "--gate", "--gate-contracts",
                                "nlist_vs_chunked_speedup", "--gate-out",
                                planted_out])
    finally:
        os.environ.pop("GRAVITY_TPU_PERF_HANDICAP", None)
    rc_h = planted_proc.returncode
    report_h = (json.load(open(planted_out))
                if os.path.exists(planted_out) else None)
    text_h = planted_proc.stdout + planted_proc.stderr[-2000:]
    check(rc_h == 1 and report_h is None and "VIOLATED" in text_h,
          f"gate_path: the planted handicap was not caught (rc {rc_h}): "
          f"{text_h}")
    import re

    planted = re.search(r"ratio ([0-9.]+)", text_h)
    record = {
        "phase": "gate_path", "rc": rc, "ok": report["ok"],
        "contracts": {r["name"]: {"ok": r["ok"], "measured": r["measured"],
                                  "ci": r["ci"], "bound": r["bound"],
                                  "kind": r["kind"]}
                      for r in report["results"]},
        "halo": {"rc": rc_halo, "ok": halo["ok"],
                 "measured": halo["measured"], "ci": halo["ci"],
                 "bound": halo["bound"],
                 "cut": GATE_HALO_CUT,
                 **{k: halo["detail"][k] for k in (
                     "ratios", "n", "devices", "side", "cap", "platform",
                     "max_gap_over_mean_a")}},
        "planted_handicap": {
            "rc": rc_h, "ratio": float(planted.group(1)) if planted else None,
            "log_tail": text_h[-600:]},
        "ledger_rows": by_name["ledger_coverage"]["detail"].get("rows"),
        "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    return record


def trace_kernels(paths, name: str) -> list:
    """The kernel events of Chrome traces whose name holds ``name``: a
    list of (name, grid)."""
    out = []
    for path in paths:
        doc = json.load(open(path))
        for e in doc["traceEvents"] if isinstance(doc, dict) else doc:
            if e.get("cat") == "kernel" and name in e.get("name", ""):
                out.append((e["name"], (e.get("args") or {}).get("grid")))
    return out


def phase_profile_path(device: dict, started) -> dict:
    """``run --preset baseline-16k --steps 20 --profile`` as a process: its
    Chrome trace names the nbody_direct kernel once a launch the run
    counted (its stats' ``kernel_launches``, the wrapper's count over the
    run); then ``serve --slots 4 --slice-steps 20`` as a process
    (``started``: its spool and process, :func:`start_verb`), ``POST
    /profile {"rounds": 1}`` and one submit at bucket 8,192: a trace of
    that round, holding each of its batched launches (the same kernel
    with the slots on grid.z) that the daemon's /metrics counted."""
    import glob
    import shutil

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.serve import request, wait_for

    env = dict(os.environ, PYTHONPATH=REPO)
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        log_dir = os.path.join(tmp, "logs")
        # A process of its own: in this process, after the phases before,
        # the profiler's trace lost launches that the run counted.
        proc = subprocess.run(
            [sys.executable, "-m", "gravity_tpu_torch", "run", "--preset",
             "baseline-16k", "--steps", "20", "--profile", "--log-dir",
             log_dir], cwd=REPO, env=env, capture_output=True, text=True,
            timeout=300)
        check(proc.returncode == 0,
              f"profile_path: run --profile exit {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        stats = last_json(proc.stdout)
        launches = stats["kernel_launches"]
        traces = glob.glob(os.path.join(log_dir, "profile_*",
                                        "trace_*.json"))
        check(len(traces) == 1, f"profile_path: traces {traces}")
        solo = trace_kernels(traces, "nbody_direct_kernel")
        names = {}
        for name, _ in trace_kernels(traces, ""):
            names[name[:60]] = names.get(name[:60], 0) + 1
        check(launches == 21 and len(solo) == launches,
              f"profile_path: {len(solo)} nbody_direct_kernel events in the "
              f"trace, {launches} launches counted; kernels {names}")

        spool, daemon = started
        prof_dir = os.path.join(tmp, "serve_profile")
        try:
            banner = json.loads(daemon.stdout.readline())
            check(bool(banner.get("serving")), f"daemon banner {banner}")
            ans = request(spool, "POST", "/profile",
                          {"rounds": 1, "dir": prof_dir})
            check(ans == {"profiling_rounds": 1, "dir": prof_dir},
                  f"profile_path: /profile answered {ans}")
            cfg = SimulationConfig(model="plummer", n=8192, steps=20,
                                   dt=3600.0, eps=1e9,
                                   integrator="leapfrog",
                                   force_backend="pallas")
            job = request(spool, "POST", "/submit",
                          {"config": json.loads(cfg.to_json())})["job"]
            status = wait_for(spool, [job], timeout=300)[job]["status"]
            metrics = request(spool, "GET", "/metrics")
        finally:
            try:
                request(spool, "POST", "/shutdown")
            except Exception:  # noqa: BLE001 — the wait below decides
                pass
            try:
                daemon.wait(timeout=60)
            except subprocess.TimeoutExpired:
                daemon.kill()
                daemon.wait()
            shutil.rmtree(spool, ignore_errors=True)
        check(status == "completed", f"profile_path: served job {status}")
        batched = metrics["kernel_launches"]["nbody_direct/batched"]
        round_traces = glob.glob(os.path.join(prof_dir, "trace_*.json"))
        check(len(round_traces) == 1, f"profile_path: {round_traces}")
        events = trace_kernels(round_traces, "nbody_direct_kernel")
        # A batched launch: the same kernel, the slots on grid.z.
        slotted = [e for e in events if e[1] and e[1][2] == 4]
        check(batched == 20 and len(slotted) == batched,
              f"profile_path: {len(slotted)} batched nbody_direct_kernel "
              f"events in the round's trace, {batched} batched launches")
    record = {"phase": "profile_path", "run_launches": launches,
              "trace_files": [os.path.basename(t) for t in
                              traces + round_traces],
              "run_trace_kernel_events": len(solo),
              "run_ms_per_step": 1e3 * stats["avg_step_s"],
              "serve_batched_launches": batched,
              "serve_trace_batched_events": len(slotted),
              "serve_trace_kernel_events": len(events),
              "kernel_names": sorted({n[:120] for n, _ in solo + events}),
              "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    return record


# ---------------------------------------------------------------------------
# The periodic box and cosmology (plain PyTorch and torch.fft, no kernel)
# ---------------------------------------------------------------------------

# cosmo-262k of the JAX package's baselines (benchmarks/run_baselines.py):
# 262,144 grf bodies in a periodic box of 1e13 m, PM grid 128, leapfrog.
COSMO_BOX = 1.0e13
COSMO_262K = dict(model="grf", n=262_144, periodic_box=COSMO_BOX,
                  force_backend="pm", pm_grid=128, integrator="leapfrog",
                  eps=2.0e11, dt=2.0e4)
COSMO_262K_STEPS = 100
COSMO_TSC_STEPS = 20
PERIODIC_NLIST_STEPS = 5
# The fp32 mesh against fp64 on the same state: the JAX suite's bar
# (tests/test_periodic.py:199-225): |a32 - a64| <= 2e-3 |a64| + 1e-3 max|a|.
PM_FP32_RTOL, PM_FP32_ATOL = 2e-3, 1e-3
EWALD_RTOL = 0.02  # tests/test_periodic.py:59-77
PROBE_MEDIAN_BAR = 0.05  # tests/test_pm.py:18-46
COSMO_REL_ERR_BAR = 0.06  # tests/test_cosmo.py:58-78
NLIST_TERM_BAR = 1e-4  # fp32 of each row's sum of |terms|
# P(k) on the card against the CPU port on the same state: the deposits
# and bin sums differ in their last bits (float atomics on the card).
SPECTRUM_RTOL = 1e-3
ANALYZE_ARGS = ["analyze", "--model", "grf", "--n", "262144",
                "--periodic-box", "1e13", "--eps", "1e11", "--spectrum",
                "--fof", "5e11", "--correlation"]


def check_no_launch(name: str, counts: dict) -> None:
    check(not any(counts.values()),
          f"{name}: a kernel launched on a periodic path: {counts}")


def pm_profile(fn) -> dict:
    """One mesh evaluation under the profiler: the device spans of
    pm.deposit, pm.fft and pm.gather, kernels and busy share."""
    return fmm_profile(fn, "pm.")


def ewald_pair_ax(d, box, m, eps):
    """x-acceleration on particle 0 from particle 1 and all its images by
    Ewald summation, with the solver's arctan-core softening as a
    nearest-image correction (tests/test_periodic.py:18-56)."""
    import numpy as np

    from gravity_tpu_torch.constants import G

    alpha = 3.0 / box
    d = np.asarray(d, float)
    ar = np.zeros(3)
    for ix in range(-3, 4):
        for iy in range(-3, 4):
            for iz in range(-3, 4):
                rn = d + np.array([ix, iy, iz]) * box
                r = np.linalg.norm(rn)
                ar += (G * m * rn / r**3
                       * (math.erfc(alpha * r) + 2 * alpha * r
                          / math.sqrt(math.pi)
                          * math.exp(-(alpha * r) ** 2)))
    mx, my, mz = np.meshgrid(*[np.arange(-10, 11)] * 3, indexing="ij")
    k = 2 * math.pi / box * np.stack([mx, my, mz], -1).reshape(-1, 3)
    k = k[np.any(k != 0, axis=1)]
    k2 = (k * k).sum(1)
    ak = (4 * math.pi * G * m / box**3 * k / k2[:, None]
          * (np.exp(-k2 / (4 * alpha**2)) * np.sin(k @ d))[:, None]).sum(0)
    r = np.linalg.norm(d)
    f_point = G * m / r**2
    f_soft = (2 / math.pi) * G * m * (np.arctan(r / eps) / r**2
                                      - eps / (r * (r**2 + eps**2)))
    return float((ar + ak)[0] + (f_soft - f_point) * d[0] / r)


def ewald_pair_check(dtype) -> dict:
    """The periodic solver's pair force at grid 128 on the card against
    the Ewald sum (rtol 0.02), and the pair's antisymmetry."""
    import torch

    from gravity_tpu_torch.ops.periodic import pm_periodic_accelerations

    box, eps = 1.0e12, 5.0e10
    pos = torch.tensor([[0.4e12, 0.5e12, 0.5e12], [0.6e12, 0.5e12, 0.5e12]],
                       dtype=dtype, device="cuda")
    masses = torch.tensor([1e30, 1e30], dtype=dtype, device="cuda")
    reset_counts()
    acc = pm_periodic_accelerations(pos, masses, box=box, grid=128, eps=eps)
    check_no_launch("pm_periodic_path ewald", read_counts())
    acc = acc.double().cpu()
    want = ewald_pair_ax([0.2e12, 0.0, 0.0], box, 1e30, eps)
    rel = abs(float(acc[0, 0]) - want) / abs(want)
    check(rel < EWALD_RTOL,
          f"pm_periodic_path: Ewald pair ({dtype}) off by {rel:.3e}")
    asym = float((acc[0] + acc[1]).abs().max()) / abs(float(acc[0, 0]))
    return {"dtype": str(dtype).removeprefix("torch."), "ax": float(acc[0, 0]),
            "ewald_ax": want, "rel_err": rel, "bar": EWALD_RTOL,
            "antisymmetry_over_ax": asym}


def pm_vs_cpu_f64(state, config, n_targets: int = FMM_SAMPLE) -> dict:
    """The first evaluation's forces on the card (the run's dtype) against
    the port on the CPU in float64 on the same state, at ``n_targets``
    targets: per-target relative errors and the JAX suite's fp32 bar."""
    import torch

    from gravity_tpu_torch.ops.periodic import pm_periodic_accelerations_vs

    kw = dict(box=config.periodic_box, grid=config.pm_grid, g=config.g,
              eps=config.eps, assignment=config.pm_assignment)
    idx = fmm_sample(state.n, state.positions.device)
    pos, masses = state.positions, state.masses
    card = pm_periodic_accelerations_vs(pos[idx], pos, masses, **kw)
    cpu = pm_periodic_accelerations_vs(pos[idx].double().cpu(),
                                       pos.double().cpu(),
                                       masses.double().cpu(), **kw)
    card = card.double().cpu()
    errors = rel_errors(card, cpu)
    bound = PM_FP32_RTOL * cpu.abs() + PM_FP32_ATOL * float(cpu.abs().max())
    within = bool(((card - cpu).abs() <= bound).all())
    check(within, f"pm_periodic_path: card fp32 mesh off the fp64 CPU port "
                  f"past the JAX suite's bar: {errors}")
    return {"targets": n_targets, **errors,
            "bar": f"|a_card - a_cpu64| <= {PM_FP32_RTOL} |a_cpu64| + "
                   f"{PM_FP32_ATOL} max|a_cpu64|", "held": within}


def periodic_run(name: str, config, device: dict, *, profile: bool) -> tuple:
    """A periodic pm run through logged_run (no kernel may launch): ms a
    step, positions in [0, box), the mesh energy's drift, optionally one
    evaluation's spans."""
    import torch

    from gravity_tpu_torch.simulation import Simulator

    sim = Simulator(config)
    state0 = sim.state
    e0 = sim.energy()
    stats, counts = logged_run(sim, name, fixed_steps=config.steps)
    final = stats["final_state"]
    box = config.periodic_box
    inside = bool(((final.positions >= 0) & (final.positions < box)).all())
    check(inside, f"{name}: a final position outside [0, box)")
    e1 = sim.energy()
    record = {"steps": config.steps, "assignment": config.pm_assignment,
              "ms_per_step": 1e3 * stats["avg_step_s"], "counts": counts,
              "positions_in_box": inside,
              "mesh_energy_drift": abs((e1 - e0) / e0),
              "perf": stats["perf"]}
    if profile:
        record["profile"] = pm_profile(
            lambda: sim._self_accel(final.positions, final.masses))
    return sim, state0, record


def phase_pm_periodic_path(device: dict) -> dict:
    """cosmo-262k at full size: 262,144 grf bodies in the 1e13 m box
    through the periodic PM solver (grid 128, leapfrog, 100 steps), its
    spans, positions, mesh-energy drift and first evaluation against the
    CPU port in float64; the TSC form (20 steps); the Ewald pair at grid
    128 (fp32 and fp64)."""
    import torch

    from gravity_tpu_torch.config import SimulationConfig

    config = SimulationConfig(steps=COSMO_262K_STEPS,
                              progress_every=COSMO_262K_STEPS, **COSMO_262K)
    sim, state0, cic = periodic_run("pm_periodic_path", config, device,
                                    profile=True)
    first = pm_vs_cpu_f64(state0, config)
    tsc_config = dataclasses.replace(config, pm_assignment="tsc",
                                     steps=COSMO_TSC_STEPS,
                                     progress_every=COSMO_TSC_STEPS)
    _, _, tsc = periodic_run("pm_periodic_path tsc", tsc_config, device,
                             profile=True)
    record = {"phase": "pm_periodic_path", "n": config.n,
              "pm_grid": config.pm_grid, "box": config.periodic_box,
              "cic": cic, "tsc": tsc, "first_eval_vs_cpu_f64": first,
              "ewald": [ewald_pair_check(torch.float32),
                        ewald_pair_check(torch.float64)],
              "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    return record


def point_mass_probe() -> dict:
    """tests/test_pm.py:18-46 on the card: 200 massless probes 8-24 cells
    from a point mass, the isolated PM at grid 64."""
    import numpy as np
    import torch

    from gravity_tpu_torch.constants import G
    from gravity_tpu_torch.ops.pm import pm_accelerations

    m_central, grid, box = 1.0e30, 64, 1.0e12
    rng = np.random.RandomState(0)
    dirs = rng.randn(200, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    h = box / (grid - 1)
    radii = rng.uniform(8 * h, 24 * h, (200, 1))
    pos = np.concatenate([np.zeros((1, 3)), [[box / 2] * 3, [-box / 2] * 3],
                          dirs * radii]).astype(np.float32)
    masses = np.zeros(203, np.float32)
    masses[0] = m_central
    reset_counts()
    acc = pm_accelerations(torch.from_numpy(pos).cuda(),
                           torch.from_numpy(masses).cuda(), grid=grid)
    check_no_launch("pm_isolated_path probe", read_counts())
    acc = acc.double().cpu().numpy()[3:]
    r = radii[:, 0]
    a_expected = G * m_central / r**2
    rel = np.abs(-np.sum(acc * dirs, axis=1) - a_expected) / a_expected
    a_tan = np.linalg.norm(acc + a_expected[:, None] * dirs, axis=1)
    median = float(np.median(rel))
    check(median < PROBE_MEDIAN_BAR,
          f"pm_isolated_path: probe median {median:.3e}")
    return {"median_radial_rel_err": median, "bar": PROBE_MEDIAN_BAR,
            "max_radial_rel_err": float(rel.max()),
            "median_tangential_over_radial": float(np.median(
                a_tan / a_expected))}


def phase_pm_isolated_path(device: dict) -> dict:
    """The isolated pm backend: the point-mass probe at grid 64, and a
    262,144-body disk through --force-backend pm --pm-grid 128 (10
    leapfrog steps), its final forces against nbody_direct at 4,096
    targets (reported; the reference launches counted apart)."""
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.simulation import Simulator

    probe = point_mass_probe()
    config = SimulationConfig(model="disk", n=262_144, g=1.0, dt=2e-3,
                              eps=0.05, force_backend="pm", pm_grid=128,
                              integrator="leapfrog", steps=10,
                              progress_every=10)
    sim = Simulator(config)
    stats, counts = logged_run(sim, "pm_isolated_path", fixed_steps=10)
    final = stats["final_state"]
    pos, masses = final.positions, final.masses
    idx = fmm_sample(pos.shape[0], pos.device)
    reset_counts()
    acc = sim._self_accel(pos, masses)[idx]
    check_no_launch("pm_isolated_path", read_counts())
    errors = fmm_vs_direct(acc, pos[idx], pos, masses, config)
    reference_launches = read_counts()["nbody_direct"]
    record = {"phase": "pm_isolated_path", "probe": probe,
              "disk": {"n": config.n, "pm_grid": config.pm_grid,
                       "steps": config.steps,
                       "ms_per_step": 1e3 * stats["avg_step_s"],
                       "counts": counts,
                       "vs_nbody_direct_targets": FMM_SAMPLE,
                       "vs_nbody_direct": errors,
                       "reference_nbody_direct_launches":
                           reference_launches,
                       "profile": pm_profile(
                           lambda: sim._self_accel(pos, masses))},
              "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    return record


def cosmo_cli(*args) -> tuple:
    """``cosmo ARGS`` through the CLI in this process (every launch count
    set to 0 before it and read after, the card's peak memory around
    it): (report, counts, peak bytes)."""
    import contextlib
    import io

    import torch

    from gravity_tpu_torch import cli

    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["cosmo", *args])
    counts = read_counts()
    check(rc == 0, f"cosmo {' '.join(args)}: exit {rc}")
    check_no_launch(f"cosmo {' '.join(args)}", counts)
    return last_json(out.getvalue()), counts, torch.cuda.max_memory_allocated()


def cosmo_summary(report: dict, peak: int, *, bar: bool) -> dict:
    keys = ("n", "grid", "omega_m", "a_start", "a_end", "steps",
            "growth_measured", "growth_linear", "rel_err", "total_time_s",
            "platform", "layzer_irvine")
    out = {k: report[k] for k in keys if k in report}
    out["ms_per_step"] = 1e3 * report["total_time_s"] / report["steps"]
    out["peak_memory_bytes"] = peak
    if bar:
        check(report["rel_err"] < COSMO_REL_ERR_BAR,
              f"cosmo_path: rel_err {report['rel_err']:.3e} at n "
              f"{report['n']}")
        out["bar"] = COSMO_REL_ERR_BAR
    return out


def phase_cosmo_path(device: dict) -> dict:
    """The cosmo verb on the card: 128^3 bodies at grid 256, flat LCDM
    (Omega_m 0.3, a 0.2 -> 0.5, 40 steps), plain and with --li-check;
    EdS and 2LPT at 262,144; a run checkpointed at step 20, then
    --resume, against the uninterrupted run."""
    import shutil

    from gravity_tpu_torch.utils.checkpoint import (
        make_checkpoint_manager,
        restore_checkpoint_with_extra,
    )

    lcdm = ["--n", "2097152", "--grid", "256", "--omega-m", "0.3",
            "--a-start", "0.2", "--a-end", "0.5", "--steps", "40"]
    rep, _, peak = cosmo_cli(*lcdm)
    big = cosmo_summary(rep, peak, bar=True)
    rep, _, peak = cosmo_cli(*lcdm, "--li-check")
    big_li = cosmo_summary(rep, peak, bar=True)
    eds = ["--n", "262144", "--omega-m", "1", "--a-start", "0.02",
           "--a-end", "0.08", "--steps", "40"]
    small = {}
    for order in ("1", "2"):
        rep, _, peak = cosmo_cli(*eds, "--lpt-order", order)
        small[f"eds_lpt{order}"] = cosmo_summary(rep, peak, bar=True)
    log_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(log_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=log_root) as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        whole, _, _ = cosmo_cli(*eds, "--checkpoint-every", "20",
                                "--checkpoint-dir", ckpt)
        mgr = make_checkpoint_manager(ckpt)
        uninterrupted, step, _ = restore_checkpoint_with_extra(mgr, 40)
        check(step == 40, f"cosmo_path: checkpoint steps {mgr.all_steps()}")
        shutil.rmtree(os.path.join(ckpt, "40"))
        resumed_rep, _, _ = cosmo_cli(*eds, "--checkpoint-every", "20",
                                      "--checkpoint-dir", ckpt, "--resume")
        resumed, step, extra = restore_checkpoint_with_extra(
            make_checkpoint_manager(ckpt), 40)
    gap = float((resumed.positions.double()
                 - uninterrupted.positions.double()).abs().max())
    resume = {"resumed_at": resumed_rep.get("resumed_at"),
              "same_bits": same_bits(resumed.positions,
                                     uninterrupted.positions),
              "max_position_gap_m": gap,
              "gap_over_box": gap / COSMO_BOX,
              "growth_uninterrupted": whole["growth_measured"],
              "growth_resumed": resumed_rep["growth_measured"],
              "a_at_40": extra.get("a")}
    check(resume["resumed_at"] == 20, f"cosmo_path: resume {resumed_rep}")
    record = {"phase": "cosmo_path", "lcdm_2m": big, "lcdm_2m_li": big_li,
              **small, "resume": resume,
              "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    return record


def min_image_oracle(pos, masses, idx, config):
    """The minimum-image rcut-masked direct sum at targets ``idx`` over all
    sources in float64, and each component's sum of |terms|."""
    import torch

    from gravity_tpu_torch.ops.forces import _pair_weights

    p64, m64 = pos.double(), masses.double()
    box = config.periodic_box
    refs, scales = [], []
    for lo in range(0, idx.numel(), 256):
        t = p64[idx[lo:lo + 256]]
        diff = p64[None, :, :] - t[:, None, :]
        diff = diff - box * torch.round(diff / box)
        w = _pair_weights((diff * diff).sum(-1), m64[None, :], config.g,
                          config.cutoff, config.eps, config.nlist_rcut)
        refs.append((w[..., None] * diff).sum(dim=1))
        scales.append((w[..., None] * diff.abs()).sum(dim=1))
    return torch.cat(refs), torch.cat(scales)


def over_term_scale(got, ref, scale):
    return ((got.double() - ref).abs() / scale.clamp_min(1e-300)).amax(dim=1)


def clean_targets(pos, idx, side: int, cap: int, box: float):
    """Which targets sit where no cell of their 27-neighbourhood holds more
    than ``cap`` bodies (no overflow monopole reaches them), from the
    positions' cell counts on the host."""
    import numpy as np
    import torch

    from gravity_tpu_torch.interop import to_numpy

    u = np.clip((np.mod(to_numpy(pos).astype(np.float64), box) / box
                 * side).astype(int), 0, side - 1)
    counts = np.bincount((u[:, 0] * side + u[:, 1]) * side + u[:, 2],
                         minlength=side**3).reshape(side, side, side)
    over = counts > cap
    near = np.zeros_like(over)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                near |= np.roll(over, (dx, dy, dz), axis=(0, 1, 2))
    t = u[to_numpy(idx)]
    return (torch.from_numpy(~near[t[:, 0], t[:, 1], t[:, 2]]),
            int(counts.max()), int(over.sum()))


def min_image_oracle_check(pos, masses, config, sim) -> dict:
    """The cell list against the minimum-image rcut-masked direct sum at
    4,096 targets in float64, each component held to 1e-4 of its row's
    sum of |terms|: on one evaluation with a cap above every cell (the
    engine exact), and the run's own sizing on the targets no overflow
    monopole reaches (the others' error reported)."""
    from gravity_tpu_torch.ops import nlist

    side, cap, _ = sim.nlist_sizing
    idx = fmm_sample(pos.shape[0], pos.device)
    ref, scale = min_image_oracle(pos, masses, idx, config)
    clean, max_count, n_over = clean_targets(pos, idx, side, cap,
                                             config.periodic_box)
    reset_counts()
    run_sizing = sim._self_accel(pos, masses)[idx]
    wide_cap = 1 << math.ceil(math.log2(max_count))
    exact = nlist.nlist_accelerations(
        pos, masses, rcut=config.nlist_rcut, side=side, cap=wide_cap,
        box=config.periodic_box, g=config.g, cutoff=config.cutoff,
        eps=config.eps)[idx]
    check_no_launch("periodic_nlist_path", read_counts())
    exact_err = float(over_term_scale(exact, ref, scale).max())
    run_err = over_term_scale(run_sizing, ref, scale).cpu()
    clean_err = float(run_err[clean].max()) if clean.any() else 0.0
    some = ref.norm(dim=1) > 0  # a body with no neighbour feels nothing
    check(exact_err <= NLIST_TERM_BAR and clean_err <= NLIST_TERM_BAR,
          f"periodic_nlist_path: {exact_err:.3e} (cap {wide_cap}), "
          f"{clean_err:.3e} (the run's cap {cap}, clean targets) of the "
          "term scale")
    return {"targets": FMM_SAMPLE, "bar": NLIST_TERM_BAR,
            "wide_cap": wide_cap, "max_err_over_term_scale": exact_err,
            "wide_cap_vs_oracle": rel_errors(exact[some], ref[some]),
            "run_cap": cap, "cells_over_run_cap": n_over,
            "clean_targets": int(clean.sum()),
            "clean_max_err_over_term_scale": clean_err,
            "overflow_reached_targets_max_err_over_term_scale":
                float(run_err[~clean].max()) if (~clean).any() else None,
            "run_cap_vs_oracle": rel_errors(run_sizing[some],
                                                ref[some])}


def face_merge_check() -> dict:
    """tests/test_periodic.py:331: a pair across a face of the box merges
    at the face (on the card, fp64), not at the box-spanning midpoint."""
    import torch

    from gravity_tpu_torch.ops.encounters import merge_close_pairs
    from gravity_tpu_torch.state import ParticleState

    box = 1.0e12
    pos = torch.tensor([[0.005e12, 0.5e12, 0.5e12],
                        [0.995e12, 0.5e12, 0.5e12],
                        [0.5e12, 0.2e12, 0.5e12]], dtype=torch.float64,
                       device="cuda")
    state = ParticleState(pos, torch.zeros_like(pos),
                          torch.full((3,), 1e30, dtype=torch.float64,
                                     device="cuda"))
    iso = int(merge_close_pairs(state, 2e10, k=4, chunk=4).n_merged)
    res = merge_close_pairs(state, 2e10, k=4, chunk=4, box=box)
    x = float(res.state.positions[0, 0])
    ok = (iso == 0 and int(res.n_merged) == 1
          and float(res.state.masses[0]) == 2e30 and min(x, box - x) < 1e9)
    check(ok, f"periodic_nlist_path: face merge {iso}, {x}")
    return {"isolated_merged": iso, "periodic_merged": int(res.n_merged),
            "merged_x": x}


def phase_periodic_nlist_path(device: dict) -> dict:
    """grf at 262,144 in the 1e13 m box through the minimum-image cell
    list at its default sizing (rcut box/16, PERIODIC_NLIST_STEPS leapfrog
    steps, plain PyTorch: nlist_pair must not launch), its forces against
    the minimum-image oracle, and a pair merging across a face."""
    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.simulation import Simulator

    config = SimulationConfig(model="grf", n=262_144,
                              periodic_box=COSMO_BOX, force_backend="nlist",
                              nlist_rcut=COSMO_BOX / 16,
                              integrator="leapfrog", eps=2.0e11, dt=2.0e4,
                              steps=PERIODIC_NLIST_STEPS,
                              progress_every=PERIODIC_NLIST_STEPS)
    sim = Simulator(config)
    stats, counts = logged_run(sim, "periodic_nlist_path",
                               fixed_steps=config.steps)
    final = stats["final_state"]
    check(bool(((final.positions >= 0)
                & (final.positions < COSMO_BOX)).all()),
          "periodic_nlist_path: a final position outside [0, box)")
    record = {"phase": "periodic_nlist_path", "n": config.n,
              "rcut": config.nlist_rcut, "side": stats["nlist_side"],
              "cap": stats["nlist_cap"], "steps": config.steps,
              "ms_per_step": 1e3 * stats["avg_step_s"], "counts": counts,
              "vs_min_image_oracle": min_image_oracle_check(
                  final.positions, final.masses, config, sim),
              "face_merge": face_merge_check(),
              "profile": fmm_profile(
                  lambda: sim._self_accel(final.positions, final.masses),
                  "nlist."),
              "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    return record


def start_analyze():
    """The ``analyze`` verb at 262,144 bodies (P(k), halos, xi(r)), as a
    process of its own: its friends-of-friends and xi(r) run on the host
    (scipy) for minutes, so it starts early and overlaps the card's
    phases."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("GRAVITY_TPU_FAULTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "gravity_tpu_torch", *ANALYZE_ARGS],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    # A phase that fails before the report is read must not leave it on.
    atexit.register(stop)
    return time.perf_counter(), proc


def phase_analyze_path(device: dict, started) -> dict:
    """The analyze process's report (exit 0, P(k), n_halos, its wall
    time), and P(k) on the card held against the CPU port's on the same
    state (in this process)."""
    import numpy as np

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.ops.spectra import density_power_spectrum
    from gravity_tpu_torch.simulation import make_initial_state

    t0, proc = started
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    wall_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"analyze_path: exit {proc.returncode}: {err[-2000:]}")
    report = json.loads(out)
    state = make_initial_state(SimulationConfig(
        model="grf", n=262_144, periodic_box=COSMO_BOX, eps=1e11))
    box = ((0.0, 0.0, 0.0), COSMO_BOX)
    reset_counts()
    _, p_card, _ = density_power_spectrum(state.positions, state.masses,
                                          grid=64, box=box)
    check_no_launch("analyze_path", read_counts())
    _, p_cpu, _ = density_power_spectrum(state.positions.cpu(),
                                         state.masses.cpu(), grid=64,
                                         box=box)
    ok = np.isfinite(p_cpu)
    spec_rel = float(np.max(np.abs(p_card[ok] - p_cpu[ok]) / p_cpu[ok]))
    check(spec_rel < SPECTRUM_RTOL,
          f"analyze_path: P(k) card against CPU {spec_rel:.3e}")
    p_report = report["power_spectrum"]["P"]
    check(np.allclose([v for v in p_report if v is not None],
                      p_card[np.isfinite(p_card)], rtol=SPECTRUM_RTOL),
          "analyze_path: the process's P(k) is not this state's")
    record = {"phase": "analyze_path", "args": ANALYZE_ARGS,
              "wall_s": wall_s, "power_spectrum": report["power_spectrum"],
              "n_halos": report["fof"]["n_halos"],
              "fof_mass_fraction": report["fof"]["mass_fraction_in_halos"],
              "xi_first_bins": report["correlation"]["xi"][:4],
              "spectrum_card_vs_cpu_max_rel": spec_rel,
              "spectrum_bar": SPECTRUM_RTOL,
              "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    return record


# --- the sharded direct sums, P3M's kick and slice pass, bf16 FMM ----------

SHARDED_262K_STEPS = 20
SHARDED_MXU_STEPS = 5
SHARDED_2M_STEPS = 1
SHARDED_SAMPLE = 4096
# The ring's rows held to the plain version, each against all 2,097,152
# sources.
SHARDED_2M_SAMPLE = 1024
# Where the rectangular entry chunks its sources otherwise than the square
# one, the sharded and unsharded forces may differ by rounding: at most
# this much of a row's sum of |terms|.
SHARDED_GAP_BAR = 1e-6
HRING_RUN = dict(model="plummer", n=16_384, integrator="leapfrog",
                 force_backend="pallas", eps=1.0e9, steps=10,
                 sharding="ring", mesh_shape=(1, 1))
# The README P3M state's multirate run: k = 512 is the largest fast rung
# whose modeled densest-cell load fits under the cap (the disk's central
# binning cell holds 36,722 of the 1,048,576 bodies: t_cap 36 of 64 at
# k = 512, the full cap from k = 1,024).
P3M_MULTIRATE_K = 512
P3M_MULTIRATE_STEPS = 10
# The slice pass against the cell-list pass on one evaluation of the README
# P3M state, fp32: the same pair terms in another order, and the same
# remainder monopoles; per target, in units of the RMS |a| (the JAX
# package's P3M accuracy metric).
P3M_SLICE_BAR = 1e-4
FMM_BF16_STEPS = 3
# The JAX package's own bf16-against-fp32 median relative error of the FMM
# forces on the CPU, at the 1,024-body disk of
# tests/test_torch_p3m_kick_fmm_bf16.py (depth 4, leaf cap 32; the sparse
# layout k_cells 512 in chunks of 128), which pins these values; the port
# on the card is held to 1.5x of them on the same inputs.
FMM_BF16_JAX_CPU = {"fmm": 0.0420795054226199, "sfmm": 0.04460962995373498}
FMM_BF16_RATIO = 1.5
# A witness where the bf16 error has grown: the baseline-1m-fmm disk cut
# to 4,096 bodies (its initial state, drawn on the CPU, rounded to bf16 for
# both forms), the sparse FMM at the sizing a run resolves there. The JAX
# package's own bf16-against-fp32 median on the CPU (pinned by
# tests/test_torch_fmm_bf16_growth.py, which prints the figure at other
# sizes); the card's is held within 1.5x of it either way.
FMM_BF16_GROWTH_N = 4096
FMM_BF16_GROWTH_JAX_CPU = 0.06873284532614546
# The floor of the 1M figure: bf16 operands alone round each term by up
# to 2^-9, so the bf16 forces differ from the fp32 ones by more than that
# at the median; a path that quietly computed in fp32 would not.
FMM_BF16_FLOOR = 2.0**-9
FMM_BF16_STATE = dict(n=1024, seed=11)
FMM_BF16_KW = {"fmm": dict(depth=4, leaf_cap=32, g=1.0, eps=0.05),
               "sfmm": dict(depth=4, leaf_cap=32, g=1.0, eps=0.05,
                            k_cells=512, k_chunk=128)}


def fmm_bf16_disk(n: int, seed: int):
    """The CPU test's disk (tests/test_torch_p3m_kick_fmm_bf16.py::_disk):
    positions and masses in float64, drawn with numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    r = rng.exponential(3.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    pos = np.stack([r * np.cos(phi), r * np.sin(phi),
                    0.3 * rng.normal(size=n)], axis=1)
    return pos, np.full(n, 5.0 / n)


def fmm_bf16_growth_inputs(n: int = FMM_BF16_GROWTH_N):
    """(positions, masses, sfmm kwargs) of the stall's witness: the
    baseline-1m-fmm disk at ``n`` bodies, drawn on the CPU, in float64,
    and the sparse sizing a run resolves on it."""
    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.ops import sfmm
    from gravity_tpu_torch.simulation import make_initial_state

    config = dataclasses.replace(PRESETS["baseline-1m-fmm"], n=n)
    state = make_initial_state(config, "cpu")
    depth, cap, k_cells = sfmm.resolve_sfmm_sizing(
        state.positions, config.tree_depth, config.tree_leaf_cap)
    kw = dict(depth=depth, leaf_cap=cap,
              k_cells=sfmm.effective_k_cells(k_cells),
              k_chunk=sfmm.DEFAULT_K_CHUNK, ws=config.tree_ws, g=config.g,
              cutoff=config.cutoff, eps=config.eps)
    return (state.positions.double().numpy(),
            state.masses.double().numpy(), kw)


def rows_gap(a, b, scale) -> float:
    """max |a - b| over the row's term scale (0 where a and b agree)."""
    diff = (a.double() - b.double()).abs()
    return float((diff / scale.clamp_min(1e-300)).max())


def gathered_direct_row(name, pos, masses, config, device, *, mxu=False):
    """A rank's rectangular launch on a world of one: its rows against the
    sources all_gather_into_tensor gives it (the allgather path's own
    call), held to the plain version at SHARDED_SAMPLE sampled rows; the
    launch at its full (n_local, N) shape timed beside the bound, the
    plain version at the sampled rows (its whole shape would take
    minutes), the gather alone and the path's whole sharded evaluation."""
    import torch

    from gravity_tpu_torch.ops import mxu_kernel
    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel
    from gravity_tpu_torch.ops.forces import accelerations_vs
    from gravity_tpu_torch.parallel.mesh import all_gather_rows

    kw = dict(g=config.g, cutoff=config.cutoff, eps=config.eps)
    all_pos, all_m = all_gather_rows(pos), all_gather_rows(masses)
    launch = (mxu_kernel.accelerations_vs_mxu_kernel if mxu
              else accelerations_vs_kernel)
    gen = torch.Generator().manual_seed(23)
    idx = torch.randperm(pos.shape[0], generator=gen)[:SHARDED_SAMPLE].to(
        pos.device)
    pos_i = pos[idx].contiguous()
    if mxu:
        # The path's own (n_local, N) launch, its sampled rows compared.
        record = mxu_compare(name, pos, all_pos, all_m, config.eps, False,
                             rows=idx)
    else:
        kern = launch(pos, all_pos, all_m, **kw)[idx]
        plain = torch.cat([accelerations_vs(p, all_pos, all_m, **kw)
                           for p in torch.split(pos_i, 64)])
        torch.cuda.synchronize()
        record = compare(name, kern, plain,
                         term_scale(pos_i, all_pos, all_m, config.eps,
                                    chunk=32, g=config.g), "float32")

    def kernel():
        launch(pos, all_pos, all_m, **kw)

    def plain_fn():
        if mxu:
            center = all_pos.mean(dim=0)
            mxu_kernel.gram_acc4_plain(
                (pos_i - center).contiguous(), (all_pos - center).contiguous(),
                all_m * config.g, cutoff=config.cutoff, eps=config.eps,
                bf16=False)
        else:
            for p in torch.split(pos_i, 256):
                accelerations_vs(p, all_pos, all_m, **kw)

    def gather():
        all_gather_rows(pos)
        all_gather_rows(masses)

    cuda_ms(kernel, 2)
    ms = [cuda_ms(kernel, 5), cuda_ms(kernel, 5)]
    cuda_ms(plain_fn, 1)
    plain_ms = cuda_ms(plain_fn, 2)
    gather_ms = cuda_ms(gather, 20)
    m, k = pos.shape[0], all_pos.shape[0]
    n_bytes = (m * 3 + k * 4 + m * 3) * 4
    terms = (mxu_bound(m * k, n_bytes, device, False) if mxu
             else bound(m * k, FLOPS_PER_PAIR, n_bytes, device))
    record.update({
        "m": m, "k": k, "rows_compared": SHARDED_SAMPLE,
        "ms": ms[0], "ms_repeat": ms[1], "plain_ms": plain_ms,
        "plain_shape": [SHARDED_SAMPLE, k], "all_gather_ms": gather_ms,
        **terms, "library_ms": None,
        "library_note": "no single PyTorch call computes this sum",
        "nvidia_smi": device["nvidia_smi"]})
    if not mxu:
        record["source_chunks"] = direct_chunks(m, k, pos.dtype, config.eps)
    record["share_of_bound"] = record["bound_ms"] / ms[0]
    return record


def steps_profile(sim, steps: int = 3) -> dict:
    """``steps`` steps of ``sim`` from its state (``run_block``, counting
    off) under the profiler, after one warm step: the device's busy share
    of the wall clock, its kernels a step, the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gravity_tpu_torch.telemetry import perf

    with perf.uncounted():
        state = sim.state
        acc = sim.initial_carry(state)
        sim.run_block(state, acc, n_steps=1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sim.run_block(state, acc, n_steps=steps)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    return profile_record(prof, ("sharded.",), steps, wall_ms)


def sharded_run(config, name: str) -> tuple:
    """A Simulator run of ``config`` with the launch counts reset just
    before it and read just after."""
    from gravity_tpu_torch.simulation import Simulator

    sim = Simulator(config)
    stats, counts = logged_run(sim, name, fixed_steps=config.steps)
    return sim, stats, counts


def phase_sharded_path(device: dict, base2m: dict) -> dict:
    """The sharded direct sums on a world of one (NCCL, one card), through
    the presets a user runs: ``baseline-262k`` (allgather, 262,144 cold-
    collapse bodies, 20 of its steps) bit for bit against the unsharded run
    of the same config; the same through pallas-mxu (5 steps);
    ``baseline-2m-merger`` (the ring, 2,097,152 bodies, 2 steps) with one
    force evaluation's bits against the unsharded nbody_direct evaluation
    and its ms a step beside this run's baseline-2m; a (1, 1) hierarchical
    ring on a 16,384-body state, bit for bit against its unsharded run.
    Each rectangular launch is held to the plain version and timed."""
    import torch
    import torch.distributed as dist

    from gravity_tpu_torch.config import PRESETS, SimulationConfig
    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel
    from gravity_tpu_torch.ops.forces import accelerations_vs

    out = {"phase": "sharded_path", "nvidia_smi": device["nvidia_smi"]}
    # baseline-262k: allgather, against the same config unsharded.
    config = dataclasses.replace(PRESETS["baseline-262k"],
                                 steps=SHARDED_262K_STEPS)
    sim, stats, counts = sharded_run(config, "sharded_262k")
    check(sim.backend == "nbody_direct" and sim.mesh.shape == (1,),
          f"baseline-262k: backend {sim.backend}, mesh {sim.mesh.shape}")
    check(stats["num_devices"] == 1 and stats["sharding"] == "allgather",
          f"baseline-262k stats: {stats.get('sharding')}")
    check(counts["nbody_direct"] == config.steps + 1,
          f"{counts['nbody_direct']} nbody_direct launches for "
          f"{config.steps} steps")
    plain_cfg = dataclasses.replace(config, sharding="none")
    ref_sim, ref_stats, _ = sharded_run(plain_cfg, "unsharded_262k")
    # The same sharded run again: the first sharded run of a process pays
    # once for its collectives' first steps (an earlier probe: 39.25 ms a
    # step, then 36.43 against 36.39 unsharded).
    _, again_stats, _ = sharded_run(config, "sharded_262k_again")
    final, ref = stats["final_state"], ref_stats["final_state"]
    same = (torch.equal(final.positions, ref.positions)
            and torch.equal(final.velocities, ref.velocities))
    # One evaluation of the final state, sharded and not.
    a_sh = sim._self_accel(final.positions, final.masses)
    a_un = accelerations_vs_kernel(final.positions, final.positions,
                                   final.masses, g=config.g, eps=config.eps)
    gen = torch.Generator().manual_seed(29)
    idx = torch.randperm(config.n, generator=gen)[:SHARDED_SAMPLE].to(
        a_sh.device)
    scale = term_scale(final.positions[idx], final.positions, final.masses,
                       config.eps, chunk=32, g=config.g)
    gap = rows_gap(a_sh[idx], a_un[idx], scale)
    eval_same = torch.equal(a_sh, a_un)
    check(gap <= SHARDED_GAP_BAR,
          f"baseline-262k sharded vs unsharded force gap {gap:.3e} of the "
          f"term scale > {SHARDED_GAP_BAR:.0e}")
    out["baseline_262k"] = {
        "n": config.n, "steps": config.steps, "cut_from": PRESETS[
            "baseline-262k"].steps,
        "launches": counts["nbody_direct"], "counts": counts,
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "unsharded_ms_per_step": 1e3 * ref_stats["avg_step_s"],
        "again_ms_per_step": 1e3 * again_stats["avg_step_s"],
        "run_bitwise_equal_unsharded": same,
        "again_bitwise_equal": all(
            torch.equal(getattr(again_stats["final_state"], f),
                        getattr(final, f))
            for f in ("positions", "velocities")),
        "eval_bitwise_equal_unsharded": eval_same,
        "eval_gap_over_term_scale": gap,
        "source_chunks": {"rectangular": direct_chunks(
            config.n, config.n, torch.float32, config.eps),
            "square": direct_chunks(config.n, config.n, torch.float32,
                                    config.eps)},
        "gap_cause": ("none: on a world of one the gathered sources are "
                      "the state itself and the (n_local, N) launch is the "
                      "square launch's shape and chunking"),
        "perf": stats["perf"]}
    # Where a world of one's step time goes beside the unsharded one's.
    out["baseline_262k"]["step_profile"] = {
        "sharded": steps_profile(sim), "unsharded": steps_profile(ref_sim)}
    out["allgather"] = gathered_direct_row(
        "nbody_direct/allgather baseline-262k (n_local, N)", final.positions,
        final.masses, config, device)
    del a_sh, a_un, ref_sim, ref_stats
    # pallas-mxu under allgather.
    mxu_cfg = dataclasses.replace(config, force_backend="pallas-mxu",
                                  steps=SHARDED_MXU_STEPS)
    msim, mstats, mcounts = sharded_run(mxu_cfg, "sharded_262k_mxu")
    check(msim.backend == "nbody_mxu"
          and mcounts["nbody_mxu"] == mxu_cfg.steps + 1,
          f"pallas-mxu allgather: {msim.backend}, {mcounts}")
    mfinal = mstats["final_state"]
    out["mxu_262k"] = {"steps": mxu_cfg.steps, "launches":
                       mcounts["nbody_mxu"], "counts": mcounts,
                       "ms_per_step": 1e3 * mstats["avg_step_s"]}
    out["mxu_allgather"] = gathered_direct_row(
        "nbody_mxu/allgather baseline-262k (n_local, N)", mfinal.positions,
        mfinal.masses, mxu_cfg, device, mxu=True)
    del msim, mstats, mfinal
    # baseline-2m-merger: the ring.
    config = dataclasses.replace(PRESETS["baseline-2m-merger"],
                                 steps=SHARDED_2M_STEPS)
    sim, stats, counts = sharded_run(config, "sharded_2m_ring")
    check(sim.backend == "nbody_direct" and stats["sharding"] == "ring",
          f"baseline-2m-merger: {sim.backend}, {stats.get('sharding')}")
    check(counts["nbody_direct"] == config.steps + 1,
          f"{counts['nbody_direct']} nbody_direct launches (ring)")
    final = stats["final_state"]
    pos, masses = final.positions, final.masses
    kw = dict(g=config.g, cutoff=config.cutoff, eps=config.eps)
    # The ring's one hop (nothing sent on a world of one), timed by
    # events: the hop's launch and the zero it is added to.
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    ring = sim._self_accel(pos, masses)
    end.record()
    square = accelerations_vs_kernel(pos, pos, masses, **kw)
    torch.cuda.synchronize()
    hop_ms = start.elapsed_time(end)
    ring_same = torch.equal(ring, square)
    idx = torch.randperm(config.n, generator=gen)[:SHARDED_2M_SAMPLE].to(
        pos.device)
    pos_i = pos[idx].contiguous()
    scale = term_scale(pos_i, pos, masses, config.eps, chunk=32, g=config.g)
    ring_gap = rows_gap(ring[idx], square[idx], scale)
    check(ring_gap <= SHARDED_GAP_BAR,
          f"ring vs unsharded gap {ring_gap:.3e} > {SHARDED_GAP_BAR:.0e}")
    plain = torch.cat([accelerations_vs(p, pos, masses, **kw)
                       for p in torch.split(pos_i, 64)])
    torch.cuda.synchronize()
    ring_rec = compare("nbody_direct/ring hop baseline-2m-merger "
                       "(n_local, n_local)", ring[idx], plain, scale,
                       "float32")
    del ring, square

    def plain_fn():
        for p in torch.split(pos_i, 256):
            accelerations_vs(p, pos, masses, **kw)

    cuda_ms(plain_fn, 1)
    plain_ms = cuda_ms(plain_fn, 2)
    n = config.n
    ring_rec.update({
        "m": n, "k": n, "hops": sim.mesh.size, "ms": hop_ms,
        "plain_ms": plain_ms, "plain_shape": [SHARDED_2M_SAMPLE, n],
        "source_chunks": direct_chunks(n, n, torch.float32, config.eps),
        **bound(n * n, FLOPS_PER_PAIR, (n * 3 + n * 4 + n * 3) * 4, device),
        "library_ms": None,
        "library_note": "no single PyTorch call computes this sum",
        "nvidia_smi": device["nvidia_smi"]})
    ring_rec["share_of_bound"] = ring_rec["bound_ms"] / hop_ms
    out["ring"] = ring_rec
    out["baseline_2m_merger"] = {
        "n": n, "steps": config.steps, "cut_from": PRESETS[
            "baseline-2m-merger"].steps,
        "launches": counts["nbody_direct"], "counts": counts,
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "baseline_2m_ms_per_step_this_run": base2m["ms_per_step"],
        "eval_bitwise_equal_unsharded": ring_same,
        "eval_gap_over_term_scale": ring_gap}
    del sim, stats, final, pos, masses
    # A (1, 1) hierarchical mesh: the outer gather and the inner ring.
    hcfg = SimulationConfig(**HRING_RUN)
    hsim, hstats, hcounts = sharded_run(hcfg, "hierarchical_ring_1x1")
    check(hsim.mesh.shape == (1, 1), f"mesh {hsim.mesh.shape}")
    _, ustats, _ = sharded_run(dataclasses.replace(hcfg, sharding="none",
                                                   mesh_shape=None),
                               "hierarchical_ring_unsharded")
    hsame = all(torch.equal(getattr(hstats["final_state"], f),
                            getattr(ustats["final_state"], f))
                for f in ("positions", "velocities"))
    check(hsame, "(1, 1) hierarchical ring: not the unsharded run's bits")
    out["hierarchical_1x1"] = {
        "n": hcfg.n, "steps": hcfg.steps, "launches": hcounts[
            "nbody_direct"], "bitwise_equal_unsharded": hsame,
        "ms_per_step": 1e3 * hstats["avg_step_s"]}
    emit(out)
    if dist.is_initialized():
        dist.destroy_process_group()
    return out


def p3m_kick_tiles(positions, masses, targets, *, grid, cap, t_cap, g,
                   sigma_cells=1.25, rcut_sigmas=4.0):
    """The ewald kind's arguments of a K-target P3M kick, as
    ``p3m_accelerations_vs`` builds them: the sources' cells at ``cap``,
    the targets binned on the same grid at ``t_cap``."""
    import torch

    from gravity_tpu_torch.ops import cells, p3m

    origin, span = cells.bounding_cube(positions)
    sigma = sigma_cells * (span / (grid - 1))
    alpha = 1.0 / (math.sqrt(2.0) * sigma)
    rcut = rcut_sigmas * sigma
    side = p3m.binning_side(grid, sigma_cells, rcut_sigmas)
    cells_pos, cells_mass, count = cells.bin_to_cells(
        positions, masses, cells.grid_coords(positions, origin, span, side),
        side, cap)[:3]
    tcells_pos, _, t_count = cells.bin_to_cells(
        targets, torch.ones_like(targets[:, 0]),
        cells.grid_coords(targets, origin, span, side), side, t_cap)[:3]
    params = torch.stack([rcut * rcut, alpha])
    return (tcells_pos, t_count, cells_pos, g * cells_mass, count, side,
            params)


def phase_p3m_multirate_path(device: dict) -> dict:
    """The README P3M run with --integrator multirate (k = 512, sub 4), cut
    to 10 steps: every kick through make_local_kernel's p3m branch, the
    ewald kind at the t_cap the occupancy model chose on the binning grid;
    one kick's tiles at that t_cap against the plain version, timed beside
    the bound and the whole kick."""
    import warnings

    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.ops import nlist, p3m
    from gravity_tpu_torch.simulation import Simulator
    from gravity_tpu_torch.utils.logging import RunLogger

    config = SimulationConfig(**{**P3M_RUN, "integrator": "multirate",
                                 "multirate_k": P3M_MULTIRATE_K,
                                 "steps": P3M_MULTIRATE_STEPS})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = Simulator(config)
    side, cap, t_cap = sim.kick_sizing
    check(side == p3m.binning_side(config.pm_grid, config.p3m_sigma_cells,
                                   config.p3m_rcut_sigmas)
          and t_cap < cap, f"p3m kick sizing {sim.kick_sizing}")
    log_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(log_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=log_root) as log_dir:
        logger = RunLogger(log_dir, quiet=True)
        reset_counts()
        stats = sim.run(logger)
        counts = read_counts()
    evals = 1 + (1 + config.multirate_sub) * config.steps
    check(counts["nlist_pair/ewald"] == evals
          and stats["kernel_launches"] == evals,
          f"{counts['nlist_pair/ewald']} ewald launches for {evals} "
          "multirate force evaluations")
    check(not any(v for k, v in counts.items() if k != "nlist_pair/ewald"),
          f"another kernel launched: {counts}")
    final = stats["final_state"]
    check(bool(torch.isfinite(final.positions).all()
               & torch.isfinite(final.velocities).all()),
          "p3m multirate: final state not finite")
    pos, masses = final.positions, final.masses
    idx = fast_targets(sim, final, P3M_MULTIRATE_K)
    targets = pos[idx].contiguous()
    args = p3m_kick_tiles(pos, masses, targets, grid=config.pm_grid, cap=cap,
                          t_cap=t_cap, g=config.g)
    kw = dict(cutoff=config.cutoff, eps=config.eps, kind="ewald")
    kern = nlist.pair_cells_kernel(*args, **kw)
    again = nlist.pair_cells_kernel(*args, **kw)
    plain = nlist.pair_cells_plain(*args, **kw)
    scale = nlist.pair_cells_plain(*args, absolute=True, **kw)
    torch.cuda.synchronize()
    check(torch.equal(kern, again), "p3m kick: two launches differ")
    check_rec = compare("p3m kick at t_cap", kern.reshape(-1, 3),
                        plain.reshape(-1, 3), scale.reshape(-1, 3),
                        "float32", reason=EWALD_REASON)

    def kernel():
        nlist.pair_cells_kernel(*args, **kw)

    def plain_fn():
        nlist.pair_cells_plain(*args, **kw)

    def kick():
        sim._kick(targets, pos, masses)

    cuda_ms(kernel, 3)
    ms = [cuda_ms(kernel, 30), cuda_ms(kernel, 30)]
    cuda_ms(plain_fn, 1)
    plain_ms = cuda_ms(plain_fn, 3)
    cuda_ms(kick, 2)
    kick_ms = cuda_ms(kick, 5)
    timing = {"ms": ms[0], "ms_repeat": ms[1], "plain_ms": plain_ms,
              **ewald_bound(args, device), "library_ms": None,
              "library_note": "no single PyTorch call computes a cell-list "
                              "pair sum"}
    timing["share_of_bound"] = timing["bound_ms"] / ms[0]
    record = {
        "phase": "p3m_multirate_path", "command": {
            **P3M_RUN, "integrator": "multirate",
            "multirate_k": P3M_MULTIRATE_K},
        "steps": config.steps, "cut_from": P3M_RUN["steps"],
        "k": P3M_MULTIRATE_K, "side": side, "cap": cap, "t_cap": t_cap,
        "targets_over_t_cap": int((args[1] - t_cap).clamp_min(0).sum()),
        "launches": counts["nlist_pair/ewald"], "counts": counts,
        "ms_per_step": 1e3 * stats["avg_step_s"], "kick_ms": kick_ms,
        "check": check_rec, "timing": timing,
        "warnings": [str(w.message)[:160] for w in caught],
        "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    return record


def phase_p3m_slice(device: dict) -> dict:
    """One P3M evaluation of the README state through --p3m-short slice
    (the JAX package's gather-free pass, plain PyTorch) against the same
    evaluation through the cell-list kernel; no kernel may launch in the
    slice evaluation."""
    import torch

    from gravity_tpu_torch.ops import p3m

    state = p3m_state("disk")
    kw = dict(grid=P3M_RUN["pm_grid"], cap=P3M_RUN["p3m_cap"], g=1.0,
              eps=P3M_RUN["eps"], khat=p3m_khat())
    reset_counts()
    t0 = time.perf_counter()
    sliced = p3m.p3m_accelerations(state.positions, state.masses,
                                   short_mode="slice", **kw)
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    counts = read_counts()
    check(not any(counts.values()), f"slice pass launched a kernel: {counts}")
    ref = p3m.p3m_accelerations(state.positions, state.masses,
                                short_mode="nlist", **kw)
    check(bool(torch.isfinite(sliced).all()), "slice pass not finite")
    rms = ref.double().norm(dim=1).square().mean().sqrt()
    scaled = (sliced.double() - ref.double()).norm(dim=1) / rms
    record = {"phase": "p3m_slice", "n": state.n, "grid": kw["grid"],
              "cap": kw["cap"], "slice_eval_s": slice_s,
              "max_scaled_gap": float(scaled.max()),
              "median_scaled_gap": float(scaled.median()),
              "bar": P3M_SLICE_BAR, "counts": counts,
              "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    check(record["max_scaled_gap"] <= P3M_SLICE_BAR,
          f"slice vs nlist pass: {record['max_scaled_gap']:.3e} of the RMS "
          f"|a| > {P3M_SLICE_BAR:.0e}")
    return record


def sfmm_segment_sums(sim, pos, masses) -> list:
    """The bf16 segment sums one sparse-FMM evaluation of ``sim`` takes
    (``sfmm.sorted_segment_sum``'s calls), recorded as (values, ids, n)."""
    from gravity_tpu_torch.ops import sfmm

    calls = []
    inner = sfmm.sorted_segment_sum

    def record(values, ids, n):
        calls.append((values, ids, n))
        return inner(values, ids, n)

    sfmm.sorted_segment_sum = record
    try:
        sim._self_accel(pos, masses)
    finally:
        sfmm.sorted_segment_sum = inner
    return calls


def segment_sum_row(name, values, ids, n, cycles, device) -> dict:
    """segment_sum.cu at one of the sparse FMM's sums: the kernel against
    the plain version (host copies) bit for bit, timed alone on its plan
    beside the plain version (host clock), index_add_ on the card and the
    bound (the longest segment's chain of dependent bf16 adds at the SM
    clock sampled meanwhile, or the bytes)."""
    import torch

    from gravity_tpu_torch.ops import cells

    ids = ids.long()
    segments = cells.Segments(ids, n)
    _, starts = segments.plan()
    rows = segments.gather(values)
    cols, n_rows = rows.shape[0], ids.shape[0]
    longest = int(starts.diff().max())
    kern = segments.sum(values)[0]
    plain = cells.segment_sum_bf16_plain(values.cpu(), ids.cpu(), n)
    check(bits_equal(kern, plain), f"{name}: not the plain version's bits")

    def kernel():
        cells.segment_sum_rows(rows, starts, n_rows)

    def library():
        torch.zeros((n, cols), dtype=values.dtype,
                    device=values.device).index_add_(
            0, ids, values.reshape(n_rows, cols))

    cuda_ms(kernel, 2)
    ms, clock_mhz, samples = with_sm_clock(lambda: cuda_ms(kernel, 100))
    library_ms = cuda_ms(library, 3)
    host = (values.cpu(), ids.cpu())
    t0 = time.perf_counter()
    cells.segment_sum_bf16_plain(*host, n)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    n_bytes = n_rows * (2 * cols + 8) + n * cols * 2
    byte_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
    chain_ms = 1e3 * longest * cycles / (clock_mhz * 1e6)
    bound_ms = max(chain_ms, byte_ms)
    return {"case": name, "cols": cols, "rows": n_rows, "segments": n,
            "longest_segment_rows": longest, "max_abs_err": float(
                (kern.cpu().double() - plain.double())[
                    torch.isfinite(plain)].abs().max()),
            "same_bits_as_plain": True, "ms": ms, "plain_ms": plain_ms,
            "plain_on": "host CPU (host clock)", "library_ms": library_ms,
            "library_note": "index_add_ on the card: bf16 atomics, another "
                            "order of adds each run",
            "bound_ms": bound_ms,
            "bound_by": "operations" if chain_ms >= byte_ms else "bytes",
            "chain_bound_ms": chain_ms, "bytes_bound_ms": byte_ms,
            "sm_clock_mhz": clock_mhz, "sm_clock_samples": samples,
            "share_of_bound": bound_ms / ms,
            "nvidia_smi": device["nvidia_smi"]}


def phase_fmm_bf16_path(device: dict) -> dict:
    """``baseline-1m-fmm`` at --dtype bfloat16, cut to 3 steps: the sparse
    layout (fmm_mode auto) with its cell totals summed by segment_sum.cu
    (launches counted); its forces on the final state against the fp32
    sparse FMM at 4,096 targets, at least FMM_BF16_FLOOR at the median;
    the port's bf16-against-fp32 figure on the CPU test's disk, dense and
    sparse, and on the preset's disk cut to 4,096 bodies, sparse, each
    within 1.5x of the JAX package's own there, either way; the
    evaluation's largest segment sum against the plain version and
    timed."""
    import warnings

    import numpy as np
    import torch

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.ops import fmm, sfmm
    from gravity_tpu_torch.simulation import Simulator
    from gravity_tpu_torch.utils.logging import RunLogger

    config = dataclasses.replace(PRESETS["baseline-1m-fmm"],
                                 dtype="bfloat16", steps=FMM_BF16_STEPS)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = Simulator(config)
    check(sim.backend == "fmm" and sim.fmm_sparse,
          f"bf16 fmm resolved {sim.backend}, sparse={sim.fmm_sparse}")
    log_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(log_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=log_root) as log_dir:
        reset_counts()
        stats = sim.run(RunLogger(log_dir, quiet=True))
        counts = read_counts()
    check(counts["segment_sum/bf16"] > 0
          and not any(v for k, v in counts.items()
                      if k != "segment_sum/bf16"),
          f"bf16 sparse FMM launches: {counts}")
    final = stats["final_state"]
    check(final.positions.dtype == torch.bfloat16
          and bool(torch.isfinite(final.positions).all()
                   & torch.isfinite(final.velocities).all()),
          "bf16 fmm: final state")
    pos, masses = final.positions, final.masses
    depth, cap, k_cells, k_chunk = sim.sfmm_sizing
    kw = dict(depth=depth, leaf_cap=cap, k_cells=k_cells, k_chunk=k_chunk,
              ws=config.tree_ws, g=config.g, cutoff=config.cutoff,
              eps=config.eps)
    idx = fmm_sample(config.n, pos.device)
    acc16 = sim._self_accel(pos, masses)[idx]
    acc32 = sfmm.sfmm_accelerations(pos.float(), masses.float(), **kw)[idx]
    vs_f32 = rel_errors(acc16.float(), acc32.double())
    # The shared state of the CPU test, the same inputs as the JAX figure.
    p_np, m_np = fmm_bf16_disk(**FMM_BF16_STATE)
    shared = {}
    for backend, fn in (("fmm", fmm.fmm_accelerations),
                        ("sfmm", sfmm.sfmm_accelerations)):
        out = {dt: fn(torch.tensor(p_np, dtype=dt, device=pos.device),
                      torch.tensor(m_np, dtype=dt, device=pos.device),
                      **FMM_BF16_KW[backend]).double()
               for dt in (torch.bfloat16, torch.float32)}
        rel = ((out[torch.bfloat16] - out[torch.float32]).norm(dim=1)
               / out[torch.float32].norm(dim=1))
        shared[backend] = {"median": float(rel.median()),
                           "jax_cpu_median": FMM_BF16_JAX_CPU[backend],
                           "band": [FMM_BF16_JAX_CPU[backend] / FMM_BF16_RATIO,
                                    FMM_BF16_RATIO * FMM_BF16_JAX_CPU[backend]]}
    # The witness where the error has grown: both forms on one bf16 state.
    p_np, m_np, gkw = fmm_bf16_growth_inputs()
    p16, m16 = (torch.tensor(a, device=pos.device).to(torch.bfloat16)
                for a in (p_np, m_np))
    g16 = sfmm.sfmm_accelerations(p16, m16, **gkw).double()
    g32 = sfmm.sfmm_accelerations(p16.float(), m16.float(), **gkw).double()
    grel = (g16 - g32).norm(dim=1) / g32.norm(dim=1)
    growth = {"n": FMM_BF16_GROWTH_N, "sizing": gkw,
              "median": float(grel.median()),
              "p99": float(torch.quantile(grel, 0.99)),
              "jax_cpu_median": FMM_BF16_GROWTH_JAX_CPU,
              "band": [FMM_BF16_GROWTH_JAX_CPU / FMM_BF16_RATIO,
                       FMM_BF16_RATIO * FMM_BF16_GROWTH_JAX_CPU]}
    calls = sfmm_segment_sums(sim, pos, masses)
    values, ids, n = max(calls, key=lambda c: c[0].numel())
    seg = segment_sum_row("sparse FMM build, largest bf16 sum", values, ids,
                          n, chain_cycles(), device)
    record = {
        "phase": "fmm_bf16_path", "preset": "baseline-1m-fmm",
        "dtype": "bfloat16", "n": config.n, "steps": config.steps,
        "cut_from": PRESETS["baseline-1m-fmm"].steps,
        "sfmm_sizing": list(sim.sfmm_sizing), "counts": counts,
        "launches": counts["segment_sum/bf16"],
        "segment_sums_per_eval": len(calls),
        "ms_per_step": 1e3 * stats["avg_step_s"],
        "vs_fp32_sparse_fmm_targets": int(idx.numel()),
        "vs_fp32_sparse_fmm": vs_f32, "vs_fp32_floor": FMM_BF16_FLOOR,
        "shared_state_vs_fp32": shared, "growth_witness_vs_fp32": growth,
        "segment_sum": seg,
        "warnings": [str(w.message)[:160] for w in caught],
        "nvidia_smi": device["nvidia_smi"]}
    emit(record)
    for what, r in (*shared.items(), ("sfmm 4,096", growth)):
        low, high = r["band"]
        check(low <= r["median"] <= high,
              f"bf16 {what} vs fp32 median {r['median']:.3e} not within "
              f"{FMM_BF16_RATIO}x of the JAX package's "
              f"{r['jax_cpu_median']:.3e}")
    check(bool(np.isfinite(vs_f32["median"]))
          and vs_f32["median"] >= FMM_BF16_FLOOR,
          f"bf16 vs fp32 median {vs_f32['median']!r}: not finite, or under "
          f"{FMM_BF16_FLOOR!r} (a path that computed in fp32)")
    return record


# --- the halo slab engine and the sharded integration modes ---------------

# The README cell list's side 12 cut into 4 slabs of 3 planes, the README
# P3M state's binning side 51 into 3 of 17: a slab launch on each, its
# halo planes cut from the neighbouring slabs (zeros past the edge), must
# give the cubic launch's bits on its cells.
HALO_NLIST_SLABS = 4
HALO_P3M_SLABS = 3
# Evaluations of the halo engine on the world of one (D = 1) whose slab
# launches are counted, a kind.
HALO_EVALS = 10
# The D = 1 halo evaluation against the solo one where their bits differ:
# this much of each row's sum of |terms| (the engine adds no arithmetic,
# only the order of the overflow fallback's offset groups can move).
HALO_EVAL_BAR = 1e-6
# The ewald halo's near field against the solo P3M's (its full force less
# its mesh pass), per target in units of the RMS |a|: alpha and rcut are
# rounded once from the global cube, not through h and sigma.
HALO_EWALD_BAR = 1e-4
SHARDED_MODES_STEPS = 50


def cut_slabs(args, devices: int) -> list:
    """The slab launches' arguments of cubic tile arguments ``args``
    (tcells_pos, t_count, cells_pos, gm, s_count, side, params) cut into
    ``devices`` slabs of side / devices x-planes: each slab's targets and
    its x-extended sources, the planes past the grid zero."""
    import torch

    tcells_pos, t_count, cells_pos, gm, s_count, side, params = args
    sx, plane = side // devices, side * side

    def planes(t, lo, hi):
        return torch.cat([t[x * plane:(x + 1) * plane] if 0 <= x < side
                          else torch.zeros_like(t[:plane])
                          for x in range(lo, hi)])

    out = []
    for j in range(devices):
        lo, hi = j * sx * plane, (j + 1) * sx * plane
        out.append((tcells_pos[lo:hi], t_count[lo:hi],
                    planes(cells_pos, j * sx - 1, (j + 1) * sx + 1),
                    planes(gm, j * sx - 1, (j + 1) * sx + 1),
                    planes(s_count, j * sx - 1, (j + 1) * sx + 1), sx, side,
                    params))
    return out


def slab_plain(slab_args, kw):
    from gravity_tpu_torch.ops import nlist

    tpos, t_count, ext_pos, ext_gm, _, sx, side, params = slab_args
    return nlist.pair_cells_slab_plain(
        tpos, t_count, ext_pos, ext_gm, sx, side, params,
        cutoff=kw["cutoff"], eps=kw["eps"], kind=kw.get("kind", "newton"))


def slab_check(name, args, devices, kw, dtype_name, tol, reason) -> dict:
    """Slab launches on hand-cut slabs: the cubic launch's bits on their
    cells, and within ``tol`` of each row's sum of |terms| of the plain
    slab engine."""
    import torch

    from gravity_tpu_torch.ops import nlist

    solo = nlist.pair_cells_kernel(*args, **kw)
    scale = nlist.pair_cells_plain(*args, absolute=True, **kw)
    slabs = cut_slabs(args, devices)
    kern = torch.cat([nlist.pair_cells_slab_kernel(*a, **kw) for a in slabs])
    plain = torch.cat([slab_plain(a, kw) for a in slabs])
    torch.cuda.synchronize()
    same = torch.equal(kern, solo)
    check(same, f"{name}: the slab launches are not the cubic launch's bits")
    record = compare(name, kern.reshape(-1, 3), plain.reshape(-1, 3),
                     scale.reshape(-1, 3), dtype_name, tol=tol,
                     reason=reason)
    record.update({"slabs": devices, "planes_a_slab": args[5] // devices,
                   "side": args[5], "cap": args[2].shape[1],
                   "bitwise_equal_cubic_launch": same})
    return record


def slab_timing(args, kw, device, bound_fields) -> dict:
    """The slab launch of the world of one (the whole grid as one slab,
    zero halo planes) by CUDA events, beside its plain version and the
    bound of the cubic launch's work (the same pairs and bytes)."""
    from gravity_tpu_torch.ops import nlist

    (slab,) = cut_slabs(args, 1)

    def kernel():
        nlist.pair_cells_slab_kernel(*slab, **kw)

    def plain():
        slab_plain(slab, kw)

    cuda_ms(kernel, 3)
    ms = cuda_ms(kernel, 20)
    # One run: slab_check already ran the plain engine at these shapes.
    plain_ms = cuda_ms(plain, 1)
    record = {"ms": ms, "ms_repeat": cuda_ms(kernel, 20),
              "plain_ms": plain_ms, **bound_fields,
              "library_ms": None,
              "library_note": "none: no single PyTorch call computes a "
                              "cell-list pair sum",
              "nvidia_smi": device["nvidia_smi"]}
    record["share_of_bound"] = record["bound_ms"] / ms
    return record


def unbinned_scale(args, binned, kw):
    """Each body's sum of |terms| of the cubic tiles (a body past its
    cell's cap takes its cell's last slot's)."""
    import torch

    from gravity_tpu_torch.ops import nlist

    cap = args[0].shape[1]
    scale = nlist.pair_cells_plain(*args, absolute=True, **kw)
    start, sort, sorted_ids = binned[3], binned[4], binned[5]
    rank = torch.arange(sort.numel(), device=sort.device) - start[sorted_ids]
    out = torch.empty((sort.numel(), 3), dtype=scale.dtype,
                      device=scale.device)
    out[sort] = scale[sorted_ids, rank.clamp_max(cap - 1)]
    return out


def halo_eval_check(name, fn, ref_fn, positions, masses, args, binned, kw,
                    launch_key: str, bar: float) -> dict:
    """The halo engine on the world of one against the solo evaluation:
    its bits, else within ``bar`` of each row's sum of |terms|; its
    launches in HALO_EVALS evaluations, host syncs and ms an evaluation."""
    import warnings

    import torch

    a_halo = fn(positions, masses)
    a_solo = ref_fn()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(a_halo).all()), f"{name}: not finite")
    same = torch.equal(a_halo, a_solo)
    gap = 0.0
    if not same:
        gap = rows_gap(a_halo, a_solo, unbinned_scale(args, binned, kw))
        check(gap <= bar, f"{name}: halo vs solo gap {gap:.3e} of the term "
                          f"scale > {bar:.0e}")
    reset_counts()
    for _ in range(HALO_EVALS):
        fn(positions, masses)
    torch.cuda.synchronize()
    launches = read_counts()[launch_key]
    check(launches == HALO_EVALS,
          f"{name}: {launches} {launch_key} launches for {HALO_EVALS} "
          "evaluations")
    sites = {}
    for key, call in (("halo", lambda: fn(positions, masses)),
                      ("solo", ref_fn)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        sites[key] = [f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
                      for w in caught if "synchroniz" in str(w.message)]
    ms = cuda_ms(lambda: fn(positions, masses), 10)
    solo_ms = cuda_ms(ref_fn, 10)
    return {"case": name, "bitwise_equal_solo": same,
            "gap_over_term_scale": gap, "bar": bar, "launches": launches,
            "evals": HALO_EVALS, "host_syncs_per_eval": len(sites["halo"]),
            "host_sync_sites": sites["halo"],
            "solo_host_syncs_per_eval": len(sites["solo"]),
            "ms_per_eval": ms, "solo_ms_per_eval": solo_ms}


def phase_halo_path(device: dict) -> dict:
    """The halo slab engine on the card. Slab launches of nlist_pair.cu on
    hand-cut slabs of the README cell list's tiles (newton: fp32, fp64,
    bf16; 4 slabs of 3 planes) and of the README P3M state's (ewald: fp32,
    fp64; 3 slabs of 17): the cubic launch's bits, within the solo bars
    of the plain slab engine. Then make_halo_nlist_accel on the NCCL world
    of one (D = 1), each kind: against the solo evaluation, its slab
    launches counted (reset just before, read just after), its host syncs
    and ms an evaluation; and each slab launch timed."""
    import torch
    import torch.distributed as dist

    from gravity_tpu_torch import parallel
    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.constants import CUTOFF_RADIUS
    from gravity_tpu_torch.ops import cells, nlist, p3m
    from gravity_tpu_torch.simulation import make_initial_state

    out = {"phase": "halo_path", "nvidia_smi": device["nvidia_smi"]}
    config = SimulationConfig(**NLIST_RUN)
    state = make_initial_state(config, torch.device("cuda", 0))
    side, cap = nlist.resolve_nlist_sizing(state.positions, config.nlist_rcut)
    check((side, cap) == (12, 256), f"README sizing {(side, cap)}")
    kw = dict(cutoff=CUTOFF_RADIUS, eps=config.eps)
    checks = {}
    for dtype, tol, reason in (
            (torch.float32, TOL["float32"], NLIST_REASON),
            (torch.float64, TOL["float64"], NLIST_REASON),
            (torch.bfloat16, NLIST_BF16_TOL, NLIST_BF16_REASON)):
        st = state.astype(dtype)
        name = str(dtype).removeprefix("torch.")
        checks[f"newton_{name}"] = slab_check(
            f"slab_newton_{name}", nlist_tiles(
                st.positions, st.masses, side, cap, config.nlist_rcut),
            HALO_NLIST_SLABS, kw, name, tol, reason)
        emit({"phase": "halo_path", **checks[f"newton_{name}"]})
    disk = p3m_state("disk")
    pkw = dict(cutoff=CUTOFF_RADIUS, eps=P3M_RUN["eps"], kind="ewald")
    for dtype in (torch.float32, torch.float64):
        st = disk.astype(dtype)
        name = str(dtype).removeprefix("torch.")
        checks[f"ewald_{name}"] = slab_check(
            f"slab_ewald_{name}", p3m_tiles(
                st.positions, st.masses, grid=P3M_RUN["pm_grid"],
                cap=P3M_RUN["p3m_cap"], g=P3M_RUN["g"]),
            HALO_P3M_SLABS, pkw, name, TOL[name], EWALD_REASON)
        emit({"phase": "halo_path", **checks[f"ewald_{name}"]})
    out["slab_checks"] = checks

    mesh = parallel.make_particle_mesh((1,))
    evals, timing = {}, {}
    try:
        for name, st in (("newton", state),
                         ("newton_bf16", state.astype(torch.bfloat16))):
            mig = parallel.resolve_mig_cap(st.positions, side, 1)
            fn = parallel.make_halo_nlist_accel(
                mesh, side=side, cap=cap, rcut=config.nlist_rcut,
                eps=config.eps, mig_cap=mig)
            args = nlist_tiles(st.positions, st.masses, side, cap,
                               config.nlist_rcut)
            binned = nlist.source_cells(st.positions, st.masses,
                                        rcut=config.nlist_rcut, side=side,
                                        cap=cap)[4]
            bf16 = st.dtype == torch.bfloat16
            evals[name] = halo_eval_check(
                f"halo_{name}", fn, functools.partial(
                    nlist.nlist_accelerations, st.positions, st.masses,
                    rcut=config.nlist_rcut, side=side, cap=cap,
                    eps=config.eps), st.positions, st.masses, args, binned,
                kw, "nlist_pair/slab_bf16" if bf16 else "nlist_pair/slab",
                NLIST_BF16_TOL if bf16 else HALO_EVAL_BAR)
            pairs = nlist.real_pairs(args[1], args[4], side, cap, cap)
            n_bytes = tile_bytes(args[1], args[4], side, cap, cap,
                                 st.positions.element_size(), 1)
            timing[name] = slab_timing(args, kw, device, {
                "pairs_evaluated": pairs, "bytes": n_bytes,
                **bound(pairs, NLIST_FLOPS_PER_PAIR, n_bytes, device,
                        PEAK_BF16X2_FLOPS if bf16 else PEAK_FP32_FLOPS)})
        # The ewald kind: P3M's near field on the README disk.
        grid, sc = P3M_RUN["pm_grid"], 1.25
        pside = p3m.binning_side(grid, sc, 4.0)
        pcap = P3M_RUN["p3m_cap"]
        fn = parallel.make_halo_nlist_accel(
            mesh, side=pside, cap=pcap, g=P3M_RUN["g"], eps=P3M_RUN["eps"],
            kind="ewald", ewald_scales=((grid - 1) / (math.sqrt(2.0) * sc),
                                        4.0 * sc / (grid - 1)))
        khat = p3m_khat()
        origin, span = cells.bounding_cube(disk.positions)
        p3m_kw = dict(grid=grid, g=P3M_RUN["g"], sigma_cells=sc, khat=khat)
        total = p3m.p3m_accelerations(
            disk.positions, disk.masses, cap=pcap, eps=P3M_RUN["eps"],
            short_mode="nlist", **p3m_kw)
        near_ref = total - p3m._mesh_accelerations(
            disk.positions, disk.positions, disk.masses, origin, span,
            **p3m_kw)
        near = fn(disk.positions, disk.masses)
        rms = float(total.double().norm(dim=1).pow(2).mean().sqrt())
        gap = float((near - near_ref).double().norm(dim=1).max()) / rms
        check(gap <= HALO_EWALD_BAR,
              f"ewald halo near field: gap {gap:.3e} of the RMS |a| > "
              f"{HALO_EWALD_BAR:.0e}")
        reset_counts()
        for _ in range(HALO_EVALS):
            fn(disk.positions, disk.masses)
        torch.cuda.synchronize()
        launches = read_counts()["nlist_pair/slab_ewald"]
        check(launches == HALO_EVALS,
              f"ewald halo: {launches} launches for {HALO_EVALS} evals")
        pargs = p3m_tiles(disk.positions, disk.masses, grid=grid, cap=pcap,
                          g=P3M_RUN["g"])
        evals["ewald"] = {"case": "halo_ewald", "gap_over_rms_a": gap,
                          "bar": HALO_EWALD_BAR, "launches": launches,
                          "evals": HALO_EVALS,
                          "ms_per_eval": cuda_ms(
                              lambda: fn(disk.positions, disk.masses), 5)}
        timing["ewald"] = slab_timing(pargs, pkw, device,
                                      ewald_bound(pargs, device))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    out.update(evals=evals, timing=timing)
    for key, rec in timing.items():
        emit({"phase": "halo_path", "timing": key, **rec})
    emit({"phase": "halo_path", "evals": evals})
    return out


def phase_sharded_modes_path(device: dict) -> dict:
    """baseline-16k's integration modes sharded on the NCCL world of one
    (allgather), each against the same config unsharded, bit for bit:
    multirate with two rungs and with the 3-rung ladder, adaptive, and
    adaptive x multirate (two rungs), SHARDED_MODES_STEPS steps (adaptive:
    t_end = that many dt); ms a step of each."""
    import torch
    import torch.distributed as dist

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.simulation import Simulator

    base = dataclasses.replace(PRESETS["baseline-16k"],
                               steps=SHARDED_MODES_STEPS)
    modes = {
        "multirate": dict(integrator="multirate"),
        "ladder": dict(integrator="multirate", multirate_rungs=3),
        "adaptive": dict(adaptive=True),
        "adaptive_multirate": dict(adaptive=True, integrator="multirate"),
    }
    out = {"phase": "sharded_modes_path", "preset": "baseline-16k",
           "steps": SHARDED_MODES_STEPS, "cut_from": base.steps,
           "nvidia_smi": device["nvidia_smi"], "modes": {}}
    try:
        for name, fields in modes.items():
            config = dataclasses.replace(base, sharding="allgather",
                                         **fields)
            steps = None if config.adaptive else config.steps
            sim = Simulator(config)
            stats, counts = logged_run(sim, f"sharded_{name}",
                                       fixed_steps=steps)
            check(sim.mesh.shape == (1,), f"{name}: mesh {sim.mesh.shape}")
            ref, _ = logged_run(Simulator(dataclasses.replace(
                config, sharding="none")), f"unsharded_{name}",
                fixed_steps=steps)
            same = all(torch.equal(getattr(stats["final_state"], f),
                                   getattr(ref["final_state"], f))
                       for f in ("positions", "velocities"))
            check(same, f"sharded {name} on a world of one: not the "
                        "unsharded run's bits")
            out["modes"][name] = {
                "bitwise_equal_unsharded": same,
                "launches": counts["nbody_direct"],
                "steps": stats.get("adaptive_steps", stats["steps"]),
                "ms_per_step": 1e3 * stats["avg_step_s"],
                "unsharded_ms_per_step": 1e3 * ref["avg_step_s"]}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    emit(out)
    return out


# The rest of the mesh layer (the sharded FMM forms, checkpoints and
# resume on a world, the sharded-integrate job class): each its own NCCL
# world of one, destroyed at the phase's end.
SHARDED_FMM_STEPS = 1
SHARDED_FMM_DENSE_DEPTH = 6
SHARDED_RESUME_STEPS = 200
SHARDED_PREEMPT_AT = 100
SHARDED_DIVERGE_AT = 150
SERVE_SHARDED_N = 16384
SERVE_SHARDED_STEPS = 100
SERVE_SHARDED_COMMON = ("--model", "random", "--n", str(SERVE_SHARDED_N),
                        "--integrator", "leapfrog", "--dt", "3600",
                        "--eps", str(SERVE_EPS))
# (label, steps, extra submit flags, daemon): the local kernels through
# the solo form (one card: the default devices is 1), a devices: 2 job
# that walks to it, and the two mesh faults, each on a daemon of its own.
SERVE_SHARDED_NLIST = ("--force-backend", "nlist", "--nlist-rcut", "5e10",
                       "--nlist-side", "12", "--nlist-cap", "64")
SERVE_SHARDED_JOBS = (
    ("pallas", SERVE_SHARDED_STEPS, ("--force-backend", "pallas"), "main"),
    ("pallas_mxu", SERVE_SHARDED_STEPS, ("--force-backend", "pallas-mxu"),
     "main"),
    ("nlist_halo", SERVE_SHARDED_STEPS, SERVE_SHARDED_NLIST, "main"),
    ("devices2", SERVE_SHARDED_STEPS, ("--force-backend", "pallas",
                                       "--devices", "2"), "main"),
    ("mesh_fail", SERVE_SHARDED_STEPS, ("--force-backend", "pallas",
                                        "--devices", "4"), "mesh_fail"),
    ("collective_stall", 2 * SERVE_SHARDED_STEPS,
     ("--force-backend", "pallas"), "collective_stall"),
)
SERVE_SHARDED_DAEMONS = {"main": "", "mesh_fail": "mesh_fail@0x99",
                         "collective_stall": "collective_stall@1x2"}


def phase_sharded_fmm_path(device: dict) -> dict:
    """The sharded FMM forms on the NCCL world of one
    (parallel/sharded_fmm.py): baseline-1m-fmm's sparse FMM (fmm_mode
    auto on the disk, which must take the sparse route) and the 1M cube's
    dense FMM at depth SHARDED_FMM_DENSE_DEPTH, SHARDED_FMM_STEPS steps
    each sharded and unsharded: the same bits, no kernel launch, ms a
    step. The as-run sparse sizing carries the sharded k_eff and
    k_chunk_eff, which the final occupancy check and ``--debug-check``
    read (the check is run on the sharded run's final state)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from gravity_tpu_torch.cli import _debug_check
    from gravity_tpu_torch.config import PRESETS, SimulationConfig
    from gravity_tpu_torch.ops import sfmm
    from gravity_tpu_torch.simulation import Simulator

    cases = {
        "sparse_1m_disk": dataclasses.replace(
            PRESETS["baseline-1m-fmm"], steps=SHARDED_FMM_STEPS),
        "dense_1m_cube": SimulationConfig(
            model="random", n=FMM_DENSE_N, eps=1e9, integrator="leapfrog",
            force_backend="fmm", tree_depth=SHARDED_FMM_DENSE_DEPTH,
            steps=SHARDED_FMM_STEPS),
    }
    out = {"phase": "sharded_fmm_path", "nvidia_smi": device["nvidia_smi"],
           "steps": SHARDED_FMM_STEPS, "runs": {}}
    try:
        for name, config in cases.items():
            sim = Simulator(dataclasses.replace(config,
                                                sharding="allgather"))
            check(sim.mesh.shape == (1,), f"{name}: mesh {sim.mesh.shape}")
            check(sim.fmm_sparse == name.startswith("sparse"),
                  f"{name}: fmm_mode auto took sparse={sim.fmm_sparse}")
            nominal = None
            if sim.fmm_sparse:
                nominal = sfmm.resolve_sfmm_sizing(
                    sim.global_state(sim.state).positions, config.tree_depth,
                    config.tree_leaf_cap)[2]
            stats, counts = logged_run(sim, f"sharded_{name}",
                                       fixed_steps=config.steps)
            ref_sim = Simulator(config)
            ref, _ = logged_run(ref_sim, f"unsharded_{name}",
                                fixed_steps=config.steps)
            same = same_bits(stats["final_state"], ref["final_state"])
            check(same, f"sharded {name}: not the unsharded run's bits")
            run = {"bitwise_equal_unsharded": same,
                   "launches": sum(counts.values()),
                   "fmm_mode": stats["fmm_mode"],
                   "depth": stats["fmm_depth"],
                   "ms_per_step": 1e3 * stats["avg_step_s"],
                   "unsharded_ms_per_step": 1e3 * ref["avg_step_s"],
                   "setup_s": stats["fmm_setup_s"]}
            if sim.fmm_sparse:
                depth, cap, k_eff, k_chunk = sim.sfmm_sizing
                check((k_eff, k_chunk) == sfmm.sharded_k_sizing(nominal,
                                                                1)[:2],
                      f"{name}: as-run k {k_eff, k_chunk} for {nominal}")
                check(stats["sfmm_k_cells"] == k_eff
                      and stats["sfmm_k_chunk"] == k_chunk
                      and stats["sfmm_final_occupancy"]["k_cells"] == k_eff,
                      f"{name}: the stats' sizing {stats['sfmm_k_cells']}")
                reset_counts()
                audit = _debug_check(sim.config, sim, stats["final_state"],
                                     None)
                check(not any(read_counts().values()),
                      f"{name}: the debug check launched a kernel")
                check(audit["median_rel_err"] < FMM_MEDIAN_BAR,
                      f"{name}: --debug-check {audit}")
                run.update(k_eff=k_eff, k_chunk_eff=k_chunk,
                           nominal_k_cells=nominal,
                           debug_check={k: audit[k] for k in (
                               "median_rel_err", "max_rel_err",
                               "n_checked")})
            out["runs"][name] = run
            del sim, ref_sim, stats, ref
            torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    emit(out)
    return out


def phase_sharded_resume_path(device: dict) -> dict:
    """baseline-16k sharded (allgather) on the NCCL world of one for
    SHARDED_RESUME_STEPS steps with a checkpoint every 50, preempted at
    SHARDED_PREEMPT_AT (``preempt@``, a real SIGTERM to this process):
    resumed sharded and resumed solo, each the uninterrupted sharded run's
    bits, its step-200 checkpoint the unpadded global payload; nbody_direct
    launches = force evaluations of each run. Then ``run --auto-recover``
    sharded with ``diverge@SHARDED_DIVERGE_AT`` through the CLI: exit 0,
    its recovery records diverged, rolled_back, retry."""
    import dataclasses
    import shutil

    import torch.distributed as dist

    from gravity_tpu_torch.config import PRESETS
    from gravity_tpu_torch.simulation import SimulationPreempted, Simulator
    from gravity_tpu_torch.utils import faults
    from gravity_tpu_torch.utils.checkpoint import (
        make_checkpoint_manager,
        restore_checkpoint_with_extra,
    )

    base = dataclasses.replace(PRESETS["baseline-16k"],
                               steps=SHARDED_RESUME_STEPS,
                               checkpoint_every=50, progress_every=50)
    sharded = dataclasses.replace(base, sharding="allgather")
    log_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(log_root, exist_ok=True)
    out = {"phase": "sharded_resume_path", "preset": "baseline-16k",
           "steps": SHARDED_RESUME_STEPS, "cut_from": 500,
           "preempt_at": SHARDED_PREEMPT_AT,
           "nvidia_smi": device["nvidia_smi"]}

    def counted_run(sim, **kw):
        reset_counts()
        stats = sim.run(**kw)
        launches = read_counts()["nbody_direct"]
        steps = SHARDED_RESUME_STEPS - kw.get("start_step", 0)
        check(launches == steps + 1 == stats["kernel_launches"],
              f"{launches} nbody_direct launches for {steps} steps")
        return stats, launches

    try:
        with tempfile.TemporaryDirectory(dir=log_root) as root:
            mgr = {k: make_checkpoint_manager(os.path.join(root, k))
                   for k in ("straight", "pre")}
            straight, n0 = counted_run(Simulator(sharded),
                                       checkpoint_manager=mgr["straight"])
            want = straight["final_state"]
            faults.install(f"preempt@{SHARDED_PREEMPT_AT}")
            try:
                Simulator(sharded).run(checkpoint_manager=mgr["pre"])
                check(False, "the preempted run did not stop")
            except SimulationPreempted:
                pass
            finally:
                faults.reset()
            saved = mgr["pre"].all_steps()
            check(saved == [50, 100], f"after the preemption: {saved}")
            shutil.copytree(os.path.join(root, "pre"),
                            os.path.join(root, "solo"))
            runs = {}
            for name, config in (("sharded", sharded), ("solo", base)):
                m = make_checkpoint_manager(os.path.join(
                    root, "pre" if name == "sharded" else "solo"))
                state, step, _ = restore_checkpoint_with_extra(m)
                check(step == SHARDED_PREEMPT_AT
                      and tuple(state.positions.shape) == (base.n, 3),
                      f"{name}: restored {step} {state.positions.shape}")
                stats, launches = counted_run(
                    Simulator(config, state=state), start_step=step,
                    checkpoint_manager=m)
                same = (same_bits(stats["final_state"], want)
                        and same_bits(checkpoint_at(m.directory,
                                                    SHARDED_RESUME_STEPS),
                                      want))
                check(same, f"resumed {name}: not the uninterrupted bits")
                runs[name] = {"resumed_at": step, "launches": launches,
                              "bitwise_equal_uninterrupted": same,
                              "ms_per_step": 1e3 * stats["avg_step_s"]}
            out.update(uninterrupted_launches=n0,
                       uninterrupted_ms_per_step=1e3 * straight["avg_step_s"],
                       resumed=runs)
            healed = run_cli(
                ["run", "--preset", "baseline-16k", "--steps",
                 str(SHARDED_RESUME_STEPS), "--sharding", "allgather",
                 "--auto-recover", "--checkpoint-every", "50",
                 "--progress-every", "50",
                 "--checkpoint-dir", os.path.join(root, "ar"),
                 "--log-dir", os.path.join(root, "lar")],
                faults=f"diverge@{SHARDED_DIVERGE_AT}")
            check(healed.returncode == 0, f"sharded --auto-recover: exit "
                  f"{healed.returncode}: {healed.stderr[-2000:]}")
            (events_file,) = [f for f in os.listdir(os.path.join(root, "lar"))
                              if f.startswith("recovery_")]
            with open(os.path.join(root, "lar", events_file)) as f:
                kinds = [json.loads(x)["event"] for x in f if x.strip()]
            check(kinds == ["diverged", "rolled_back", "retry"],
                  f"sharded recovery events {kinds}")
            out["auto_recover"] = {"fault": f"diverge@{SHARDED_DIVERGE_AT}",
                                   "exit": healed.returncode,
                                   "events": kinds}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    emit(out)
    return out


# sharded_grad_path: the VJP of sum((a / A)^2), A the rms |a| of the
# unsharded evaluation, through one evaluation of each sharded engine the
# JAX package differentiates through (the Simulator's mesh accel on the
# NCCL world of one), held against the unsharded engine's VJP on the same
# state: baseline-1m-fmm's disk through the dense grid and the sparse FMM,
# periodic_nlist_path's grf box through the halo engine (rcut box/16 at
# its default sizing). Body counts are the largest powers of two whose
# graphs fit the card (PERF.md section 4, with the peak bytes at the size
# that did not; scripts/sharded_grad_sizes.py): the sparse FMM's graph at
# 524,288 and 1,048,576 bodies did not. Each part: one VJP's ms and peak
# bytes, sharded and unsharded, and the gap in fp32 (max |difference|
# over max |gradient|).
SHARDED_GRAD_N = {"fmm_dense": 1 << 20, "fmm_sparse": 1 << 18,
                  "halo_periodic": 262_144}
SHARDED_GRAD_BAR = 5e-4


def sharded_grad_configs(n: dict = None) -> dict:
    """Each part's unsharded config (the sharded run adds ``sharding``)."""
    import dataclasses

    from gravity_tpu_torch.config import PRESETS, SimulationConfig

    n = dict(SHARDED_GRAD_N, **(n or {}))
    disk = PRESETS["baseline-1m-fmm"]
    return {
        "fmm_dense": dataclasses.replace(disk, n=n["fmm_dense"],
                                         fmm_mode="dense"),
        "fmm_sparse": dataclasses.replace(disk, n=n["fmm_sparse"],
                                          fmm_mode="sparse"),
        "halo_periodic": SimulationConfig(
            model="grf", n=n["halo_periodic"], periodic_box=COSMO_BOX,
            force_backend="nlist", nlist_rcut=COSMO_BOX / 16,
            integrator="leapfrog", eps=2.0e11, dt=2.0e4),
    }


def sharded_grad_part(name: str, config) -> dict:
    """One part of sharded_grad_path: the VJP with respect to the positions
    (and to the masses, where JAX's form has their rule: not through the
    halo engine's mass scale) through the sharded accel and the unsharded
    Simulator's, on the same state; ms and peak bytes of each, the gaps,
    and no kernel launched. The FMM's is the sharded Simulator's own; the
    halo engine's, which the Simulator takes on two ranks or more, is
    built on the world of one at the solo cell list's sizing, as
    halo_path builds it."""
    import dataclasses

    import torch

    from gravity_tpu_torch.parallel import (
        make_halo_nlist_accel,
        make_particle_mesh,
    )
    from gravity_tpu_torch.simulation import Simulator

    masses = not name.startswith("halo")
    solo = Simulator(config)
    pos0, m0 = solo.state.positions, solo.state.masses
    out = {"n": config.n}
    if name.startswith("halo"):
        side, cap, _ = solo.nlist_sizing
        sharded_fn = make_halo_nlist_accel(
            make_particle_mesh(), side=side, cap=cap, rcut=config.nlist_rcut,
            box=config.periodic_box, g=config.g, cutoff=config.cutoff,
            eps=config.eps)
        out["side_cap"] = [side, cap]
    else:
        sharded = Simulator(dataclasses.replace(config, sharding="allgather"))
        check(sharded.mesh is not None and sharded.mesh.shape == (1,),
              f"sharded_grad_path {name}: not a world of one")
        check(sharded.fmm_sparse == (name == "fmm_sparse"),
              f"sharded_grad_path {name}: sparse={sharded.fmm_sparse}")
        check(same_bits(sharded.state.positions, pos0)
              and same_bits(sharded.state.masses, m0),
              f"sharded_grad_path {name}: the states differ")
        sharded_fn = sharded._self_accel
        out["fmm_sparse"] = sharded.fmm_sparse
    with torch.no_grad():
        scale = float(solo._self_accel(pos0, m0).double().square()
                      .sum(-1).mean().sqrt())

    def vjp(fn):
        p = pos0.detach().clone().requires_grad_(True)
        m = m0.detach().clone().requires_grad_(masses)
        inputs = (p, m) if masses else (p,)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        acc = fn(p, m)
        grads = torch.autograd.grad(((acc / scale) ** 2).sum(), inputs)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        return grads, ms, torch.cuda.max_memory_allocated()

    reset_counts()
    got, ms, peak = vjp(sharded_fn)
    want, solo_ms, solo_peak = vjp(solo._self_accel)
    counts = read_counts()
    check(not any(counts.values()),
          f"sharded_grad_path {name}: a kernel launched: {counts}")
    gaps = {}
    for part, g, w in zip(("positions", "masses"), got, want):
        check(bool(torch.isfinite(g).all()),
              f"sharded_grad_path {name}: a {part} gradient is not finite")
        top = float(w.abs().max())
        check(top > 0, f"sharded_grad_path {name}: zero {part} gradient")
        gaps[part] = float((g - w).abs().max()) / top
        check(gaps[part] <= SHARDED_GRAD_BAR,
              f"sharded_grad_path {name}: {part} gap {gaps[part]}")
    out.update(a_scale=scale, ms=ms, peak_bytes=peak, unsharded_ms=solo_ms,
               unsharded_peak_bytes=solo_peak, gap=gaps,
               launches=sum(counts.values()))
    del solo, sharded_fn, got, want
    torch.cuda.empty_cache()
    return out


def sharded_grad_refusals(mesh) -> dict:
    """(d): where JAX's halo engine has no rule, the card's raises
    NoBackwardError naming the primitive, before any launch."""
    import torch

    from gravity_tpu_torch.ops.forces import NoBackwardError
    from gravity_tpu_torch.parallel import make_halo_nlist_accel

    gen = torch.Generator().manual_seed(26)
    pos = (torch.rand((4096, 3), generator=gen) * COSMO_BOX).cuda()
    m = torch.full((4096,), 1e30, device="cuda")
    cases = {"isolated positions": ("pmin", 0.0, True, False),
             "periodic masses": ("pmax", COSMO_BOX, False, True)}
    out = {}
    reset_counts()
    for case, (prim, box, wrt_pos, wrt_m) in cases.items():
        fn = make_halo_nlist_accel(mesh, side=4, cap=64, rcut=COSMO_BOX / 16,
                                   box=box, eps=2.0e11)
        try:
            fn(pos.clone().requires_grad_(wrt_pos),
               m.clone().requires_grad_(wrt_m))
        except NoBackwardError as e:
            check(prim in str(e), f"sharded_grad_path: {case} raised {e}")
            out[case] = f"raises NoBackwardError ({prim})"
            continue
        raise RuntimeError(f"sharded_grad_path: {case} returned a tensor "
                           "instead of raising")
    counts = read_counts()
    check(not any(counts.values()),
          f"sharded_grad_path: a refusal launched: {counts}")
    return out


def phase_sharded_grad_path(device: dict) -> dict:
    """The gradients through the sharded engines on the NCCL world of one
    (SHARDED_GRAD_N above): (a) the dense FMM, (b) the sparse FMM and (c)
    the periodic halo engine against their unsharded VJPs, (d) the
    isolated halo engine's and the mass scale's refusals."""
    import gc

    import torch
    import torch.distributed as dist

    from gravity_tpu_torch.parallel import make_particle_mesh

    out = {"phase": "sharded_grad_path", "nvidia_smi": device["nvidia_smi"],
           "bar": SHARDED_GRAD_BAR, "parts": {}}
    # The dense FMM's graph at 1M bodies peaks at ~72 GiB: start with
    # nothing of the earlier phases cached.
    gc.collect()
    torch.cuda.empty_cache()
    try:
        for name, config in sharded_grad_configs().items():
            part = sharded_grad_part(name, config)
            print(json.dumps({"sharded_grad": name, **part}), flush=True)
            out["parts"][name] = part
        out["refusals"] = sharded_grad_refusals(make_particle_mesh())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    emit(out)
    return out


def phase_serve_sharded_path(device: dict) -> dict:
    """The sharded-integrate job class through the daemon on one card:
    three ``serve`` processes at once (no fault, ``mesh_fail@0x99``,
    ``collective_stall@1x2``), SERVE_SHARDED_JOBS by ``submit --job-type
    sharded-integrate`` at SERVE_SHARDED_N bodies. One card: every key is
    the solo form of its local kernel (pallas, pallas-mxu, the nlist cell
    list), run in the daemon's process; the devices: 2 job and the
    mesh_fail job (devices 4) walk the elastic ladder to it; the
    collective_stall job fails its second round and resumes from its
    progress snapshot at step 100. Each result equals the solo run of its
    state bit for bit; each daemon's launches of each kernel equal its
    force evaluations; ms a round from the event streams."""
    import numpy as np
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.serve import request, wait_for
    from gravity_tpu_torch.simulation import Simulator, make_initial_state

    spool_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(spool_root, exist_ok=True)
    out = {"phase": "serve_sharded_path", "nvidia_smi": device["nvidia_smi"],
           "n": SERVE_SHARDED_N, "jobs": {}, "daemons": {}}
    with tempfile.TemporaryDirectory(dir=spool_root) as root:
        spools, daemons = {}, {}
        try:
            for name, spec in SERVE_SHARDED_DAEMONS.items():
                spools[name] = os.path.join(root, name)
                env = dict(os.environ, PYTHONPATH=REPO)
                env.pop("GRAVITY_TPU_FAULTS", None)
                if spec:
                    env["GRAVITY_TPU_FAULTS"] = spec
                daemons[name] = subprocess.Popen(
                    serve_cli(spools[name], "serve", "--slots", "1",
                              "--slice-steps", str(SERVE_SHARDED_STEPS),
                              "--max-requeues", "8", "--progress-every",
                              "1"),
                    cwd=REPO, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)
            for name, daemon in daemons.items():
                banner = json.loads(daemon.stdout.readline())
                check(banner.get("serving"), f"{name} daemon {banner}")
            t0 = time.perf_counter()
            subs = run_clients([serve_args(
                spools[d], "submit", "--job-type", "sharded-integrate",
                *SERVE_SHARDED_COMMON, "--steps", str(steps), *extra)
                for _, steps, extra, d in SERVE_SHARDED_JOBS])
            ids = {}
            for (label, *_), (rc, text, err) in zip(SERVE_SHARDED_JOBS,
                                                    subs):
                check(rc == 0, f"submit {label}: rc {rc}: {err[-2000:]}")
                ids[label] = json.loads(text.strip().splitlines()[-1])["job"]
            statuses = {}
            for label, _, _, d in SERVE_SHARDED_JOBS:
                statuses.update(wait_for(spools[d], [ids[label]],
                                         timeout=600))
            serve_s = time.perf_counter() - t0
            results = run_clients([serve_args(
                spools[d], "result", ids[label], "--out",
                os.path.join(root, f"{label}.npz"))
                for label, _, _, d in SERVE_SHARDED_JOBS])
            for (label, *_), (rc, _, err) in zip(SERVE_SHARDED_JOBS,
                                                 results):
                check(rc == 0, f"result {label}: {err[-1000:]}")
            metrics, events = {}, {}
            for name, spool in spools.items():
                metrics[name] = request(spool, "GET", "/metrics")
                with open(os.path.join(spool, "serving_events.jsonl")) as f:
                    events[name] = [json.loads(x) for x in f if x.strip()]
        finally:
            for name, daemon in daemons.items():
                try:
                    request(spools[name], "POST", "/shutdown")
                except Exception:  # noqa: BLE001 — the wait decides
                    pass
                try:
                    daemon.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    daemon.kill()
                    daemon.wait()
        for label, steps, extra, d in SERVE_SHARDED_JOBS:
            st = statuses[ids[label]]
            check(st["status"] == "completed" and st["steps_done"] == steps,
                  f"job {label}: {st}")
            flags = dict(zip(extra[::2], extra[1::2]))
            config = SimulationConfig(
                model="random", n=SERVE_SHARDED_N, integrator="leapfrog",
                dt=3600.0, eps=SERVE_EPS, steps=steps,
                force_backend=flags["--force-backend"],
                nlist_rcut=float(flags.get("--nlist-rcut", 0.0)),
                nlist_side=int(flags.get("--nlist-side", 0)),
                nlist_cap=int(flags.get("--nlist-cap", 0)))
            solo = Simulator(config, state=make_initial_state(config, "cpu"))
            want = solo.run()["final_state"]
            with np.load(os.path.join(root, f"{label}.npz")) as z:
                got = [torch.from_numpy(z[k]) for k in ("positions",
                                                        "velocities")]
            same = (torch.equal(got[0], want.positions.cpu())
                    and torch.equal(got[1], want.velocities.cpu()))
            check(same, f"served {label}: not the solo run's bits")
            mine = [e for e in events[d] if e.get("job") == ids[label]]
            out["jobs"][label] = {
                "daemon": d, "steps": steps, "bitwise_equal_solo": same,
                "events": [e["event"] for e in mine],
                "requeues": st.get("requeues"),
                "backends_opened": [e["backend"] for e in events[d]
                                    if e["event"] == "breaker_open"],
                "resume_steps": [e.get("resume_step") for e in mine
                                 if e["event"] == "respooled"]}
        walked = out["jobs"]["mesh_fail"]["backends_opened"]
        check(walked == ["sharded/4/pallas", "sharded/2/pallas"],
              f"mesh_fail walked {walked}")
        check(out["jobs"]["devices2"]["backends_opened"]
              == ["sharded/2/pallas"], "devices 2 on one card")
        check(out["jobs"]["collective_stall"]["resume_steps"][-1:]
              == [SERVE_SHARDED_STEPS],
              f"stall resume {out['jobs']['collective_stall']}")
        for name in spools:
            engine = metrics[name]["engine"]
            evals, launches = engine["force_evals"], metrics[name][
                "kernel_launches"]
            for backend, kernel in (("pallas", "nbody_direct"),
                                    ("pallas-mxu", "nbody_mxu"),
                                    ("nlist", "nlist_pair")):
                check(launches[kernel] == evals.get(backend, 0),
                      f"{name} daemon: {kernel} {launches[kernel]} "
                      f"launches vs {evals.get(backend, 0)} evaluations")
            rounds = [e for e in events[name] if e.get("event") == "round"]
            out["daemons"][name] = {
                "fault": SERVE_SHARDED_DAEMONS[name], "force_evals": evals,
                "kernel_launches": {k: launches[k] for k in (
                    "nbody_direct", "nbody_mxu", "nlist_pair")},
                "builds": engine["builds"],
                "ms_per_round": {
                    b: 1e3 * statistics.median(e["round_s"] for e in rounds
                                               if e["backend"] == b)
                    for b in sorted({e["backend"] for e in rounds})},
                "rounds": len(rounds)}
        out["wall_s"] = serve_s
        out["kernel_launches"] = {
            k: sum(d["kernel_launches"][k] for d in out["daemons"].values())
            for k in ("nbody_direct", "nbody_mxu", "nlist_pair")}
    emit(out)
    return out


# The backward passes: the kernels' dense VJP (ops/forces.DenseVJP,
# plain PyTorch, as the JAX package's wrap_with_dense_vjp) at 4,096 rows,
# solo and 2 x 4,096 batched; the loss sum((a / A)^2) keeps the fp32 mass
# gradients normal. Bars: the gradient through each Function against
# PyTorch's through the plain sum, 1e-10 (fp64) and 5e-4 (fp32) of the
# scale of the terms a self-form position gradient sums (its target and
# source parts, which cancel to ~1e-5 of either) and of max |d masses|.
# The Gram form's forward is ~3e-5 of |a| off the exact sum, which its
# cotangent carries (5.2e-4 and 1.4e-3 of those scales at 4,096 bodies on
# an NVIDIA H100 80GB HBM3 at 700 W): its bar holds its backward to the
# plain VJP on its own cotangent, its end-to-end gap reported.
BACKWARD_N = 4096
BACKWARD_BATCH = 2
BACKWARD_A = 1e-8
BACKWARD_TOL = {"float32": 5e-4, "float64": 1e-10}
# The cell list at the bounding cube of the uniform draw (6e11 m a side):
# side 8 gives a cell edge of 7.5e10 m >= rcut, cap 64 holds every cell,
# so that its forward is the rcut-masked dense sum.
BACKWARD_NLIST = dict(rcut=5e10, side=8, cap=64)


def card():
    """The device of the backward, fit and sweep/watch phases (the card; a
    rehearsal of their control flow on the CPU replaces this function)."""
    import torch

    return torch.device("cuda", 0)


def backward_inputs(dtype, batch: tuple = ()):
    """Positions in a 6e11 m cube and masses 1e23-1e25 kg, from a seed,
    on the card."""
    import torch

    gen = torch.Generator().manual_seed(22)
    pos = torch.rand((*batch, BACKWARD_N, 3), generator=gen,
                     dtype=torch.float64) * 6e11 - 3e11
    m = torch.rand((*batch, BACKWARD_N), generator=gen,
                   dtype=torch.float64) * (1e25 - 1e23) + 1e23
    return pos.to(dtype).to(card()), m.to(dtype).to(card())


def backward_case(name, fn, counter, dtype, batch=(), rcut=0.0,
                  own_cotangent=False) -> dict:
    """One Function: its forward (one launch of ``counter``), its gradient
    against PyTorch's through the plain sum (accelerations_vs with the
    same constants; ``own_cotangent``: on the Function's cotangent), the
    backward's launches (none) and the forward's and backward's ms by
    CUDA events."""
    import torch

    from gravity_tpu_torch.constants import CUTOFF_RADIUS, G
    from gravity_tpu_torch.ops import forces

    kw = dict(g=G, cutoff=CUTOFF_RADIUS, eps=SERVE_EPS, rcut=rcut)
    pos, m = backward_inputs(dtype, batch)
    p, mm = pos.clone().requires_grad_(True), m.clone().requires_grad_(True)
    reset_counts()
    acc = fn(p, p, mm)
    forward_launches = read_counts()[counter]
    check(type(acc.grad_fn) is forces.DenseVJP._backward_cls,
          f"backward_path {name}: grad_fn {type(acc.grad_fn).__name__}")
    ct = 2.0 * acc.detach() / BACKWARD_A**2
    dp, dm = torch.autograd.grad(acc, (p, mm), ct, retain_graph=True)
    torch.cuda.synchronize()
    launches = read_counts()
    check(forward_launches == 1 and launches[counter] == 1
          and sum(launches.values()) == 1,
          f"backward_path {name}: launches {launches} (the forward one, "
          "the backward none)")
    p2, m2 = pos.clone().requires_grad_(True), m.clone().requires_grad_(True)
    plain = forces.accelerations_vs(p2, p2, m2, **kw)
    plain_ct = 2.0 * plain.detach() / BACKWARD_A**2
    gi, gj, _ = forces.accelerations_vs_vjp(pos, pos, m, plain_ct, **kw)
    scale = max(float(gi.abs().max()), float(gj.abs().max()))

    def gaps(cotangent):
        dp2, dm2 = torch.autograd.grad(plain, (p2, m2), cotangent,
                                       retain_graph=True)
        return (float((dp - dp2).abs().max()) / scale,
                float((dm - dm2).abs().max() / dm2.abs().max()))

    end_to_end = gaps(plain_ct)
    err_p, err_m = gaps(ct) if own_cotangent else end_to_end
    dtype_name = str(dtype).removeprefix("torch.")
    tol = BACKWARD_TOL[dtype_name]
    check(bool(torch.isfinite(dp).all() and torch.isfinite(dm).all()),
          f"backward_path {name}: gradient not finite")
    check(err_p <= tol and err_m <= tol,
          f"backward_path {name}: positions {err_p:.3g}, masses "
          f"{err_m:.3g} against the plain gradient (bar {tol})")
    with torch.no_grad():
        ms = cuda_ms(lambda: fn(pos, pos, m), 5)
    backward_ms = cuda_ms(lambda: torch.autograd.grad(
        acc, (p, mm), ct, retain_graph=True), 3)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(
        forces.accelerations_vs(p2, p2, m2, **kw), (p2, m2), ct), 3)
    return {"kernel": counter, "dtype": dtype_name,
            "shape": list(pos.shape), "max_err_positions": err_p,
            "max_err_masses": err_m, "tol": tol,
            "own_cotangent": own_cotangent,
            "end_to_end_gap": end_to_end,
            "parts_scale": scale, "launches_forward": forward_launches,
            "launches_backward": 0, "ms": ms, "backward_ms": backward_ms,
            "plain_forward_backward_ms": plain_ms,
            "backward_rows": forces.backward_rows(
                BACKWARD_N, BACKWARD_N, BACKWARD_BATCH if batch else 1)}


def no_backward_checks() -> dict:
    """Each kernel entry without a backward, on CUDA tensors that require
    grad: NoBackwardError naming its kernel, before any launch; the
    isolated halo engine, whose positions JAX's ``pmin`` cannot
    differentiate, the same before any collective (sharded_grad_path
    holds the sharded engines that differentiate)."""
    import torch

    from gravity_tpu_torch.ops import mxu_kernel, nlist
    from gravity_tpu_torch.ops.forces import NoBackwardError
    from gravity_tpu_torch.parallel import halo
    from gravity_tpu_torch.parallel.mesh import ParticleMesh

    def t(*shape, dtype=torch.float32):
        x = torch.zeros(shape, dtype=dtype, device=card())
        return x.requires_grad_(True) if dtype.is_floating_point else x

    c, tc, cap = 8, 4, 4
    tiles = (t(c, tc, 3), t(c, dtype=torch.int64), t(c, cap, 3), t(c, cap),
             t(c, dtype=torch.int64), 2, t(2))
    btiles = (t(2, c, tc, 3), t(2, c, dtype=torch.int64), t(2, c, cap, 3),
              t(2, c, cap), t(2, c, dtype=torch.int64), 2, t(2))
    slab = (t(4, tc, 3), t(4, dtype=torch.int64), t(12, cap, 3), t(12, cap),
            t(12, dtype=torch.int64), 1, 2, t(2))
    kw = dict(cutoff=0.0, eps=SERVE_EPS)
    mesh = ParticleMesh((1,), ("shard",), 0, card(), (0,), (0,))
    pos = t(64, 3)
    m = torch.ones(64, device=card())
    cases = {
        "nlist_pair/ewald": lambda: nlist.pair_cells_kernel(
            *tiles, kind="ewald", **kw),
        "nlist_pair/near": lambda: nlist.pair_cells_kernel(
            *tiles, use_rcut=False, **kw),
        "nlist_pair/batched": lambda: nlist.pair_cells_kernel_batched(
            *btiles, **kw),
        "nlist_pair/newton/slab": lambda: nlist.pair_cells_slab_kernel(
            *slab, **kw),
        "nlist_pair/ewald/slab": lambda: nlist.pair_cells_slab_kernel(
            *slab, kind="ewald", **kw),
        "nbody_mxu": lambda: mxu_kernel.gram_acc4(
            t(8, 3), t(8, 3), t(8), **kw),
        "nbody_mxu/batched": lambda: mxu_kernel.gram_acc4_batched(
            t(2, 8, 3), t(2, 8, 3), t(2, 8), **kw),
        "the halo cell list": lambda: halo.make_halo_nlist_accel(
            mesh, side=4, cap=8, rcut=5e10)(pos, m),
    }
    out = {}
    reset_counts()
    for name, call in cases.items():
        try:
            call()
        except NoBackwardError as e:
            check(name in str(e), f"backward_path: {name} raised {e}")
            out[name] = "raises NoBackwardError"
            continue
        raise RuntimeError(f"backward_path: {name} returned a tensor cut "
                           "from the graph instead of raising")
    counts = read_counts()
    check(not any(counts.values()),
          f"backward_path: a guarded entry launched: {counts}")
    return out


def segment_sum_backward_check() -> dict:
    """segment_sum.cu's backward (cells.SegmentSumRows: each row's
    cotangent its segment's): the gradient through the kernel's forward
    equals PyTorch's through the plain version, on CPU copies, bit for
    bit; one launch, forward only."""
    import torch

    from gravity_tpu_torch.ops import cells

    gen = torch.Generator().manual_seed(11)
    n_rows, n_seg = 200_000, 3_000
    ids = torch.sort(torch.randint(0, n_seg, (n_rows,), generator=gen))[0]
    values = torch.randn((n_rows, 3), generator=gen).to(torch.bfloat16)
    seg = cells.Segments(ids.to(card()), n_seg)
    rows = seg.gather(values.to(card())).detach()
    starts = seg.plan()[1]
    ct = torch.randn((n_seg, 3), generator=gen).to(torch.bfloat16)
    reset_counts()
    r = rows.clone().requires_grad_(True)
    out = cells.segment_sum_rows(r, starts, n_rows)
    (got,) = torch.autograd.grad(out, r, ct.to(card()))
    launches = read_counts()["segment_sum/bf16"]
    check(launches == 1, f"backward_path: segment_sum launches {launches}")
    r_cpu = rows.cpu().requires_grad_(True)
    (want,) = torch.autograd.grad(
        cells.segment_sum_rows_plain(r_cpu, starts.cpu(), n_rows), r_cpu, ct)
    same = torch.equal(got.cpu(), want)
    check(same, "backward_path: segment_sum's backward is not the plain "
          "gradient")
    return {"rows": n_rows, "segments": n_seg, "bitwise_equal_plain": same,
            "launches": launches}


def phase_backward_path(device: dict) -> dict:
    """The kernels' backward on the card (ops/forces.DenseVJP): through
    ``nbody_direct`` in fp32 and fp64, ``nbody_mxu`` (fp32), ``nlist_pair``
    with rcut and each batched form at 2 x 4,096, the gradient of
    sum((a / A)^2) against PyTorch's through the plain sum; each forward
    one launch, the backward none; the forward's and backward's ms. Then
    every entry without a backward raising on an input that requires grad,
    and segment_sum.cu's backward against the plain gradient."""
    import functools

    import torch

    from gravity_tpu_torch.ops import direct_kernel, mxu_kernel, nlist

    torch.manual_seed(0)
    b = (BACKWARD_BATCH,)
    eps = dict(eps=SERVE_EPS)
    cases = {
        "nbody_direct": (direct_kernel.make_direct_local_kernel(**eps),
                         "nbody_direct", torch.float32, (), 0.0),
        "nbody_direct/fp64": (direct_kernel.make_direct_local_kernel(**eps),
                              "nbody_direct", torch.float64, (), 0.0),
        "nbody_mxu": (mxu_kernel.make_mxu_local_kernel(**eps), "nbody_mxu",
                      torch.float32, (), 0.0, True),
        "nlist_pair": (nlist.make_nlist_local_kernel(**BACKWARD_NLIST, **eps),
                       "nlist_pair", torch.float32, (),
                       BACKWARD_NLIST["rcut"]),
        "nbody_direct/batched": (functools.partial(
            direct_kernel.accelerations_vs_batched_kernel, **eps),
            "nbody_direct/batched", torch.float32, b, 0.0),
        "nbody_direct/batched_fp64": (functools.partial(
            direct_kernel.accelerations_vs_batched_kernel, **eps),
            "nbody_direct/batched", torch.float64, b, 0.0),
        "nbody_mxu/batched": (functools.partial(
            mxu_kernel.accelerations_vs_mxu_batched_kernel, **eps),
            "nbody_mxu/batched", torch.float32, b, 0.0, True),
        "nlist_pair/batched": (nlist.make_nlist_batched_kernel(
            **BACKWARD_NLIST, **eps), "nlist_pair/batched", torch.float32, b,
            BACKWARD_NLIST["rcut"]),
    }
    record = {"phase": "backward_path", "nvidia_smi": device["nvidia_smi"],
              "n": BACKWARD_N, "cases": {}}
    for name, (fn, counter, dtype, batch, rcut, *own) in cases.items():
        record["cases"][name] = backward_case(name, fn, counter, dtype,
                                              batch, rcut, *own)
    record["no_backward"] = no_backward_checks()
    record["segment_sum"] = segment_sum_backward_check()
    emit(record)
    return record


# The served fit: one in-process daemon at slots 2 and slice_steps
# 20 (2 iterations of a 10-step rollout a round), a pallas fit at the
# engine's largest bucket on serve_path's 8,192-body model and dt, and
# pallas-mxu and cell-list fits at 4,096; gradient descent (Adam's first
# steps are sign(g) lr, whose near-zero components a rounding can flip),
# observations of each config's own 10-step trajectory at steps 5 and 10,
# a 0.95x guess. Parity with fit_solo on the card: max |dv| over max |v|.
FIT_ROLLOUT = 10
FIT_ITERS = 2
FIT_SCALE = 1e8
FIT_TOL = 1e-5
FIT_JOBS = (
    ("pallas", 8192, "plummer", ()),
    ("pallas-mxu", 4096, "plummer", ()),
    ("nlist", 4096, "random", (("nlist_rcut", 5e10), ("nlist_side", 12),
                               ("nlist_cap", 32))),
)


def fit_problem(config) -> dict:
    """A fit payload of ``config``: its own trajectory observed at steps
    5 and 10 (the solo kernel on the card), a 0.95x guess, and a gradient
    descent rate of 0.5 over the loss's curvature in v (2 sum_k t_k^2 /
    scale^2, the drift's)."""
    import torch

    from gravity_tpu_torch.ops.integrators import make_step_fn
    from gravity_tpu_torch.serve.engine import solo_batched_kernel
    from gravity_tpu_torch.simulation import make_initial_state

    st = make_initial_state(config, card())
    kernel = solo_batched_kernel(config)
    m = st.masses[None]
    with torch.no_grad():
        step = make_step_fn(config.integrator,
                            lambda p: kernel(p, p, m), config.dt)
        s = type(st)(st.positions[None], st.velocities[None], m)
        a = kernel(s.positions, s.positions, m)
        obs_steps, out = [FIT_ROLLOUT // 2, FIT_ROLLOUT], []
        for i in range(FIT_ROLLOUT):
            s, a = step(s, a)
            if i + 1 in obs_steps:
                out.append(s.positions[0].double().cpu().numpy().tolist())
    curv = 2.0 * sum((k * config.dt) ** 2 for k in obs_steps) / FIT_SCALE**2
    return {"observations": {"steps": obs_steps, "positions": out},
            "iters": FIT_ITERS, "optimizer": "gd", "lr": 0.5 / curv,
            "scale": FIT_SCALE,
            "guess_velocities": (0.95 * st.velocities).double().cpu()
            .numpy().tolist()}


def transfer_orbit_fit() -> dict:
    """tests/test_differentiability.py:81-112 through ``pallas`` in fp64 on
    the card: gradient descent on a test particle's launch velocity until
    the miss falls below 1e-4 of its first value (200 iterations at
    most)."""
    import torch

    from gravity_tpu_torch.ops import direct_kernel
    from gravity_tpu_torch.ops.integrators import make_step_fn
    from gravity_tpu_torch.state import ParticleState

    f64 = dict(dtype=torch.float64, device=card())
    m_sun, r0 = 1.989e30, 1.496e11
    masses = torch.tensor([m_sun, 1.0], **f64)
    pos = torch.tensor([[0.0, 0.0, 0.0], [r0, 0.0, 0.0]], **f64)
    target = torch.tensor([0.0, 1.3 * r0, 0.0], **f64)
    kern = direct_kernel.make_direct_local_kernel()
    accel = lambda p: kern(p, p, masses)  # noqa: E731
    step = make_step_fn("leapfrog", accel, 100_000.0)

    def miss(v0):
        st = ParticleState(pos, torch.stack([torch.zeros(3, **f64), v0]),
                           masses)
        a = accel(pos)
        for _ in range(40):
            st, a = step(st, a)
        return (((st.positions[1] - target) / r0) ** 2).sum()

    v = torch.tensor([0.0, 2.98e4, 0.0], **f64)
    reset_counts()
    t0 = time.perf_counter()
    for it in range(201):
        vp = v.requires_grad_(True)
        val = miss(vp)
        (g,) = torch.autograd.grad(val, vp)
        val = float(val.detach())
        if it == 0:
            miss0 = val
        if val < 1e-4 * miss0:
            break
        v = (v - 5e8 * g).detach()
    wall = time.perf_counter() - t0
    launches = read_counts()["nbody_direct"]
    check(val < 1e-4 * miss0,
          f"fit_path: the transfer orbit's miss {val} after {it} "
          f"iterations, first {miss0}")
    check(launches == 41 * (it + 1),
          f"fit_path: transfer orbit launches {launches} for {it + 1} "
          "rollouts of 41 evaluations")
    return {"iterations": it, "miss0": miss0, "miss": val,
            "launches": launches, "wall_s": wall}


def phase_fit_path(device: dict) -> dict:
    """The served ``fit`` class on the card: an in-process daemon (slots
    2, slice_steps 20) serves FIT_JOBS through ``submit --job-type fit``,
    each key one round; each result within FIT_TOL (of max |v|) of the
    port's ``fit_solo`` on the card, its loss below the guess's; the
    daemon's batched launches equal its force evaluations (the backward
    launches none); each fit key's first-round peak at or below its
    estimate; ms an iteration from the rounds. Then the transfer-orbit fit
    in fp64 through pallas."""
    import numpy as np
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.serve import GravityDaemon, fit_solo, request
    from gravity_tpu_torch.serve import wait_for

    spool_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(spool_root, exist_ok=True)
    configs = {backend: SimulationConfig(
        model=model, n=n, steps=FIT_ROLLOUT, dt=3600.0, eps=SERVE_EPS,
        integrator="leapfrog", force_backend=backend, **dict(extra))
        for backend, n, model, extra in FIT_JOBS}
    problems = {b: fit_problem(c) for b, c in configs.items()}
    record = {"phase": "fit_path", "nvidia_smi": device["nvidia_smi"],
              "jobs": {}}
    with tempfile.TemporaryDirectory(dir=spool_root) as spool:
        daemon = GravityDaemon(spool, slots=2,
                               slice_steps=FIT_ROLLOUT * FIT_ITERS,
                               idle_sleep_s=0.01, device=card())
        reset_counts()
        daemon.start()
        try:
            ids = {}
            for backend, config in configs.items():
                path = os.path.join(spool, f"{backend}.json")
                with open(path, "w") as f:
                    json.dump(problems[backend], f)
                flags = ["--model", config.model, "--n", str(config.n),
                         "--steps", str(FIT_ROLLOUT), "--dt", "3600",
                         "--eps", str(SERVE_EPS), "--integrator", "leapfrog",
                         "--force-backend", backend]
                if backend == "nlist":
                    flags += ["--nlist-rcut", "5e10", "--nlist-side", "12",
                              "--nlist-cap", "32"]
                rc, out, err = run_clients([serve_args(
                    spool, "submit", "--job-type", "fit", *flags,
                    "--params", f"@{path}")])[0]
                check(rc == 0, f"fit_path: submit {backend}: {err[-2000:]}")
                ids[backend] = json.loads(out.strip().splitlines()[-1])["job"]
            statuses = wait_for(spool, list(ids.values()), timeout=600)
            results = {b: request(spool, "GET", f"/result?job={j}")
                       for b, j in ids.items()}
            metrics = request(spool, "GET", "/metrics")
            with open(os.path.join(spool, "serving_events.jsonl")) as f:
                events = [json.loads(x) for x in f if x.strip()]
        finally:
            daemon.stop()
    launches = read_counts()
    engine = metrics["engine"]
    evals = engine["force_evals"]
    for backend, kernel in (("pallas", "nbody_direct/batched"),
                            ("pallas-mxu", "nbody_mxu/batched"),
                            ("nlist", "nlist_pair/batched")):
        want = (FIT_ROLLOUT + 1) * FIT_ITERS
        check(evals.get(backend) == want == launches[kernel],
              f"fit_path: {kernel} launches {launches[kernel]}, "
              f"evaluations {evals.get(backend)}, want {want}")
    check(sum(launches.values()) == 3 * (FIT_ROLLOUT + 1) * FIT_ITERS,
          f"fit_path: other launches {launches}")
    peaks = {r["key"]: {"measured": r.get("peak_bytes"),
                        "estimated": r.get("estimated_bytes")}
             for r in metrics["perf_ledger"]
             if r.get("site") == "serve_round" and "job=fit" in r["key"]}
    check(len(peaks) == 3, f"fit_path: fit ledger rows {sorted(peaks)}")
    for key, p in peaks.items():
        check(p["measured"] is not None and p["measured"] <= p["estimated"],
              f"fit_path: {key}: first-round peak {p['measured']} above "
              f"its estimate {p['estimated']}")
    rounds = [e for e in events if e.get("event") == "round"]
    for backend, config in configs.items():
        st = statuses[ids[backend]]
        check(st["status"] == "completed" and st["steps_done"] == FIT_ITERS,
              f"fit_path {backend}: {st}")
        served = np.asarray(results[backend]["velocities"], np.float64)
        t0 = time.perf_counter()
        solo = fit_solo(config, problems[backend], device=card())
        solo_s = time.perf_counter() - t0
        first = fit_solo(config, {**problems[backend], "iters": 1},
                         device=card())
        gap = float(np.abs(served - solo["velocities"]).max()
                    / np.abs(solo["velocities"]).max())
        loss = float(np.asarray(results[backend]["loss"]).reshape(-1)[0])
        check(np.isfinite(served).all() and gap <= FIT_TOL,
              f"fit_path {backend}: served vs solo {gap:.3g} (bar {FIT_TOL})")
        check(loss < first["loss"],
              f"fit_path {backend}: loss {loss} not below the guess's "
              f"{first['loss']}")
        mine = [e for e in rounds if e.get("backend") == backend]
        record["jobs"][backend] = {
            "n": config.n, "bucket": mine[0]["bucket"] if mine else None,
            "served_vs_solo": gap, "tol": FIT_TOL, "loss_guess":
            first["loss"], "loss": loss,
            "ms_per_iteration": [1e3 * e["round_s"] / FIT_ITERS
                                 for e in mine],
            "solo_s": solo_s}
    record.update(force_evals=evals, kernel_launches=launches,
                  peak_bytes_vs_estimate=peaks,
                  build_seconds=engine["build_seconds"],
                  transfer_orbit=transfer_orbit_fit())
    emit(record)
    return record


# Sweep and watch at the engine's largest bucket through pallas:
# 16 members of 8,192 bodies, 100 steps, slots 4; one watch of 8,192
# bodies for 100 steps, its radius 1.5x the initial closest pair's
# distance, a follow-up of the flagged round at dt / 2. The Plummer sphere
# of serve_path's 8,192-body jobs: a verdict's energy is a sum in the
# state's dtype, as the JAX package's is; the sphere's, -1.37e37 J, fits
# in fp32, the random cube's solar masses (-1.3e41 J) overflow it.
SWEEP_MEMBERS = 16
SWEEP_STEPS = 100
SWEEP_N = 8192


def phase_sweep_watch_path(device: dict) -> dict:
    """The served ``sweep`` and ``watch`` classes on the card, one
    in-process daemon (slots 4, slice_steps 100): every member's verdict
    equal to ``sweep_member_solo``'s on the card within the JAX bars (min
    separation 1e-5 relative, drift 1e-7 absolute, escape equal); the
    watch's events (step, i, j, kind) equal to ``watch_solo``'s exactly;
    its follow-up completes; batched launches = force evaluations."""
    import numpy as np
    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.ops.encounters import min_separation
    from gravity_tpu_torch.serve import (
        GravityDaemon,
        request,
        sweep_member_solo,
        wait_for,
        watch_solo,
    )
    from gravity_tpu_torch.simulation import make_initial_state

    config = SimulationConfig(model="plummer", n=SWEEP_N, steps=SWEEP_STEPS,
                              dt=3600.0, eps=SERVE_EPS, integrator="leapfrog",
                              force_backend="pallas")
    st = make_initial_state(config, card())
    radius = 1.5 * float(min_separation(st.positions, st.masses))
    sweep_params = {"members": SWEEP_MEMBERS, "spread": 0.05,
                    "sweep_seed": 22}
    watch_params = {"radius": radius, "followup": {"refine": 2, "max": 1}}
    spool_root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(spool_root, exist_ok=True)
    flags = ["--model", "plummer", "--n", str(SWEEP_N), "--steps",
             str(SWEEP_STEPS), "--dt", "3600", "--eps", str(SERVE_EPS),
             "--integrator", "leapfrog", "--force-backend", "pallas"]
    with tempfile.TemporaryDirectory(dir=spool_root) as spool:
        daemon = GravityDaemon(spool, slots=4, slice_steps=SWEEP_STEPS,
                               idle_sleep_s=0.01, device=card())
        reset_counts()
        daemon.start()
        t0 = time.perf_counter()
        try:
            subs = run_clients([
                serve_args(spool, "submit", "--job-type", kind, *flags,
                           "--params", json.dumps(params))
                for kind, params in (("sweep", sweep_params),
                                     ("watch", watch_params))])
            ids = {}
            for kind, (rc, out, err) in zip(("sweep", "watch"), subs):
                check(rc == 0, f"sweep_watch_path: submit {kind}: "
                      f"{err[-2000:]}")
                ids[kind] = json.loads(out.strip().splitlines()[-1])["job"]
            followup = f"{ids['watch']}.f0"
            statuses = wait_for(spool, list(ids.values()), timeout=600)
            statuses.update(wait_for(spool, [followup], timeout=600))
            serve_s = time.perf_counter() - t0
            sweep = request(spool, "GET", f"/result?job={ids['sweep']}")
            watch = request(spool, "GET", f"/result?job={ids['watch']}")
            metrics = request(spool, "GET", "/metrics")
            with open(os.path.join(spool, "serving_events.jsonl")) as f:
                events = [json.loads(x) for x in f if x.strip()]
        finally:
            daemon.stop()
    launches = read_counts()
    evals = metrics["engine"]["force_evals"]
    check(launches["nbody_direct/batched"] == evals.get("pallas"),
          f"sweep_watch_path: batched launches {launches} vs evaluations "
          f"{evals}")
    for kind in ("sweep", "watch"):
        check(statuses[ids[kind]]["status"] == "completed",
              f"sweep_watch_path {kind}: {statuses[ids[kind]]}")
    check(statuses[followup]["status"] == "completed",
          f"sweep_watch_path: follow-up {statuses[followup]}")
    gaps = []
    t1 = time.perf_counter()
    for k in range(SWEEP_MEMBERS):
        solo = sweep_member_solo(config, {**sweep_params, "member": k},
                                 device=card())
        got = {f: sweep[f][k] for f in ("min_sep", "energy_drift",
                                        "escaped")}
        gap_sep = abs(got["min_sep"] - solo["min_sep"]) / solo["min_sep"]
        gap_drift = abs(got["energy_drift"] - solo["energy_drift"])
        check(solo["finite"] and gap_sep <= 1e-5 and gap_drift <= 1e-7
              and bool(got["escaped"]) == solo["escaped"],
              f"sweep_watch_path member {k}: {got} vs {solo}")
        gaps.append((gap_sep, gap_drift))
    solo_events = watch_solo(config, watch_params, slice_steps=SWEEP_STEPS,
                             device=card())
    want = [(e["step"], e["i"], e["j"], int(e["kind"] == "merger"))
            for e in solo_events]
    served = list(zip(*(np.asarray(watch[f]).astype(int).tolist() for f in (
        "event_step", "event_i", "event_j", "event_kind"))))
    check(want and served == want,
          f"sweep_watch_path: watch events {served} vs solo {want}")
    solo_s = time.perf_counter() - t1
    rounds = [e for e in events if e.get("event") == "round"]
    record = {
        "phase": "sweep_watch_path", "nvidia_smi": device["nvidia_smi"],
        "members": SWEEP_MEMBERS, "n": SWEEP_N, "steps": SWEEP_STEPS,
        "max_min_sep_gap": max(g[0] for g in gaps),
        "max_drift_gap": max(g[1] for g in gaps),
        "drift": sweep["energy_drift"], "escaped": sweep["escaped"],
        "watch_radius": radius, "watch_events": served,
        "followup": statuses[followup]["status"],
        "ms_per_round": {jt: [1e3 * e["round_s"] for e in rounds
                              if e["job_type"] == jt]
                         for jt in sorted({e["job_type"] for e in rounds})},
        "force_evals": evals, "kernel_launches": launches,
        "serve_s": serve_s, "solo_s": solo_s}
    emit(record)
    return record


# --- the pod router, solo-run tracing and the sweep verb ---

# Two in-process workers on the card behind the router, started as a
# user starts it (``python -m gravity_tpu_torch route``). The jobs, by
# label: (n, steps, job type, extra submit flags). ``direct`` and
# ``affinity`` share one key (pallas at bucket 8,192: serve_path's model,
# dt and eps); ``drained`` goes in while w1 is drained.
ROUTER_SLOTS = 4
ROUTER_SLICE = 100
ROUTER_STEPS = 200
ROUTER_BASE = ("--model", "plummer", "--dt", "3600", "--eps", str(SERVE_EPS),
               "--integrator", "leapfrog")
ROUTER_JOBS = {
    "direct": (8192, ROUTER_STEPS, "integrate",
               ("--force-backend", "pallas", "--seed", "1")),
    "affinity": (8192, ROUTER_STEPS, "integrate",
                 ("--force-backend", "pallas", "--seed", "2")),
    "mxu": (4096, ROUTER_STEPS, "integrate",
            ("--force-backend", "pallas-mxu", "--seed", "3")),
    "nlist": (8192, ROUTER_STEPS, "integrate",
              ("--model", "random", *SERVE_NLIST_FLAGS, "--seed", "4")),
    "sweep": (4096, 100, "sweep",
              ("--force-backend", "pallas", "--params",
               json.dumps({"members": 4, "spread": 0.05}))),
    "watch": (4096, 100, "watch",
              ("--force-backend", "pallas", "--params",
               json.dumps({"radius": 1e11}))),
    "drained": (2000, ROUTER_STEPS, "integrate",
                ("--force-backend", "pallas", "--seed", "5")),
}
# Past the engine's bucket cap and every worker's memory: refused at the
# router by its sizing model against the card's real budget.
ROUTER_OVERSIZE = ("--model", "random", "--n", "262144", "--steps", "10",
                   "--force-backend", "dense")
# reference-cuda, cut to 100 of its 500 steps, in blocks of 10.
TRACE_ARGS = ("run", "--preset", "reference-cuda", "--steps", "100",
              "--progress-every", "10")
TRACE_BLOCKS = 10
TRACE_DIVERGE = "diverge@50"
# The reference's size sweep at its 500 steps of 3,600 s, through the
# direct sum's batched kernel.
SWEEP_VERB_SIZES = (10, 100, 500, 1000)
BATCHED_ROWS = ("nbody_direct/batched", "nbody_mxu/batched",
                "nlist_pair/batched")
SWEEP_VERB_ARGS = ("--steps", "500", "--dt", "3600", "--force-backend",
                   "pallas")


def router_job_args(spool: str, label: str) -> list:
    n, steps, job_type, extra = ROUTER_JOBS[label]
    return serve_args(spool, "submit", "--job-type", job_type, *ROUTER_BASE,
                      "--n", str(n), "--steps", str(steps), *extra)


def router_job_config(label: str):
    """The SimulationConfig a routed integrate job's submit describes,
    parsed by the CLI's own config flags."""
    import argparse

    from gravity_tpu_torch import cli

    n, steps, _, extra = ROUTER_JOBS[label]
    parser = argparse.ArgumentParser()
    cli._add_config_args(parser)
    return cli.build_config(parser.parse_args(
        [*ROUTER_BASE, "--n", str(n), "--steps", str(steps), *extra]))


def padded_solo_final(config, dev):
    """The solo Simulator run of ``config``'s initial state padded to its
    serving bucket: the state a served job must end on, bit for bit."""
    from gravity_tpu_torch.serve import bucket_size
    from gravity_tpu_torch.simulation import Simulator, make_initial_state

    padded, _ = make_initial_state(config, dev).pad_to(
        bucket_size(config.n))
    final = Simulator(dataclasses.replace(config, n=padded.n),
                      state=padded, device=dev).run()["final_state"]
    return final.positions[:config.n], final.velocities[:config.n]


def compute_app_pids() -> list:
    """The pids ``nvidia-smi`` lists as holding a compute context."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [int(x) for x in out.split() if x.strip().isdigit()]


def start_verb(*args):
    """``python -m gravity_tpu_torch ARGS --spool-dir D`` on a fresh spool
    D, as a process of its own, started well ahead of the phase that uses
    it, so that its start (~8 s to import the package and reach the card)
    overlaps the phases before; the daemons and the router idle until
    then. (spool, process); both go at exit."""
    import shutil

    root = os.path.join(REPO, "gravity_logs_gpu")
    os.makedirs(root, exist_ok=True)
    spool = tempfile.mkdtemp(dir=root)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("GRAVITY_TPU_FAULTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "gravity_tpu_torch", *args, "--spool-dir",
         spool], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(spool, ignore_errors=True)

    # A phase that fails before the one that uses it must not leave it on.
    atexit.register(stop)
    return spool, proc


def phase_router_path(device: dict, started) -> dict:
    """The pod router on the card: two in-process workers (``w1``, ``w2``,
    slots 4, slice 100) on one spool and the router as a process
    (``python -m gravity_tpu_torch route``), the client verbs through
    ``run_cli``. An integrate job on pallas at 8,192, then one of the same
    key, which must land on the worker that built it (``compile_affinity``,
    its compile count still 1); pallas-mxu at 4,096; the served cell list
    at 8,192 (side 12, cap 32); a sweep parent of 4 members and a watch;
    ``drain w1``, a submit that lands on w2 and the registry flag, then
    ``--undrain``; a dense job at 262,144 refused at the router with the
    typed 400 against the card's budget. Held: every job completes, each
    routed integrate job ends on the bits of its padded solo run, the
    batched launches over both workers equal their force evaluations,
    ``nvidia-smi`` lists no compute context of the router's pid,
    ``fleet-status`` shows both workers and the placements, and a routed
    job's ``trace-export`` holds the ``route`` span. Printed: ms a round
    on each worker and the router hop's p50 and p99. ``started`` is the
    router's spool and process (:func:`start_verb`)."""
    import shutil
    import signal
    import urllib.request

    import numpy as np
    import torch

    from gravity_tpu_torch.serve import GravityDaemon, request, wait_for
    from gravity_tpu_torch.telemetry import snapshot_quantile

    dev = card()
    spool, router = started
    record = {"phase": "router_path", "nvidia_smi": device["nvidia_smi"]}
    t0 = time.perf_counter()
    workers = {}
    try:
        reset_counts()
        for wid in ("w1", "w2"):
            workers[wid] = GravityDaemon(
                spool, slots=ROUTER_SLOTS, slice_steps=ROUTER_SLICE,
                idle_sleep_s=0.01, worker_id=wid, device=dev)
            workers[wid].start()
        banner = json.loads(router.stdout.readline())
        check(banner.get("routing") and banner["pid"] == router.pid,
              f"router banner {banner}")
        # What is left of the router's start once this phase begins.
        record["router_banner_wait_s"] = time.perf_counter() - t0
        ids, where = {}, {}

        def submit(label):
            rc, out, err = run_clients([router_job_args(spool,
                                                        label)])[0]
            check(rc == 0, f"router_path submit {label}: rc {rc} "
                  f"{err[-2000:]}")
            resp = last_json(out)
            check(resp.get("routed_by") == "rt",
                  f"router_path {label}: not routed: {resp}")
            ids[label], where[label] = resp["job"], resp["worker"]

        submit("direct")
        wait_for(spool, [ids["direct"]], timeout=300)
        owner = where["direct"]
        metrics_path = os.path.join(spool, "workers",
                                    f"{owner}.metrics.json")
        deadline = time.monotonic() + 30
        while not any(json.load(open(metrics_path)).get(
                "compile_counts", {}).values()):
            check(time.monotonic() < deadline,
                  f"router_path: {owner} published no compile counts")
            time.sleep(0.2)
        submit("affinity")
        for label in ("mxu", "nlist", "sweep", "watch"):
            submit(label)
        rc, out, err = run_clients([serve_args(spool, "drain",
                                               "w1")])[0]
        check(rc == 0 and last_json(out) == {
            "worker_id": "w1", "draining": True},
            f"drain w1: rc {rc} {out} {err[-500:]}")
        with open(os.path.join(spool, "workers", "w1.json")) as f:
            drained_flag = json.load(f)["draining"]
        submit("drained")
        rc, out, err = run_clients([serve_args(
            spool, "drain", "w1", "--undrain")])[0]
        with open(os.path.join(spool, "workers", "w1.json")) as f:
            undrained_flag = json.load(f)["draining"]
        check(rc == 0 and drained_flag is True
              and undrained_flag is False and where["drained"] == "w2",
              f"drain workflow: flags {drained_flag} "
              f"{undrained_flag}, drained job on {where['drained']}")
        rc, out, err = run_clients([serve_args(
            spool, "submit", *ROUTER_OVERSIZE)])[0]
        rejection = last_json(err)
        budget = json.load(open(os.path.join(
            spool, "workers", "w1.json")))["capabilities"][
            "hbm_budget_bytes"]
        check(rc == 1 and rejection.get("kind")
              == "insufficient_device_memory"
              and rejection["required_bytes"] > rejection["budget_bytes"]
              and rejection["budget_bytes"] == budget
              and budget == torch.cuda.mem_get_info()[1],
              f"the oversize job at the router: rc {rc} {rejection}")
        statuses = wait_for(spool, list(ids.values()), timeout=600)
        serve_s = time.perf_counter() - t0
        launches = read_counts()
        evals = {}
        for d in workers.values():
            for k, v in d.scheduler.engine.force_evals.items():
                evals[k] = evals.get(k, 0) + v
        compile_counts = {wid: d.metrics_snapshot()["compile_counts"]
                          for wid, d in workers.items()}
        results = {label: request(spool, "GET",
                                  f"/result?job={ids[label]}")
                   for label in ids}
        events = [json.loads(x) for x in open(os.path.join(
            spool, "serving_events.jsonl")) if x.strip()]
        apps = compute_app_pids()
        with open(os.path.join(spool, "router.json")) as f:
            rinfo = json.load(f)
        with urllib.request.urlopen(
                f"http://{rinfo['host']}:{rinfo['port']}/metrics",
                timeout=30) as r:
            rsnap = json.loads(r.read())
        with open(f"/proc/{router.pid}/maps") as f:
            router_libcuda = "libcuda.so" in f.read()
        rc, out, err = run_clients([serve_args(spool,
                                               "fleet-status")])[0]
        check(rc == 0, f"fleet-status: {err[-1000:]}")
        fleet = json.loads(out)
        trace_out = os.path.join(spool, "direct.trace.json")
        rc, out, err = run_clients([serve_args(
            spool, "trace-export", ids["affinity"], "--out",
            trace_out)])[0]
        check(rc == 0, f"trace-export: {err[-1000:]}")
        with open(trace_out) as f:
            span_names = sorted({e["name"] for e in json.load(f)[
                "traceEvents"] if e.get("ph") == "X"})
    finally:
        if router.poll() is None:
            router.send_signal(signal.SIGTERM)
            try:
                router.wait(timeout=30)
            except subprocess.TimeoutExpired:
                router.kill()
                router.wait()
        for d in workers.values():
            d.stop()
        shutil.rmtree(spool, ignore_errors=True)
    for label, st in statuses.items():
        check(st["status"] == "completed", f"router_path job {st}")
    routed = {e["job"]: e for e in events if e.get("event") == "routed"}
    aff = routed[ids["affinity"]]
    check(aff["rule"] == "compile_affinity" and aff["target"] == owner
          and compile_counts[owner].get(aff["rationale"]["compile_key"]) == 1
          and aff["rationale"]["compile_key"] not in compile_counts[
              "w2" if owner == "w1" else "w1"],
          f"affinity: {aff}, compile counts {compile_counts}")
    for backend, kernel in (("pallas", "nbody_direct/batched"),
                            ("pallas-mxu", "nbody_mxu/batched"),
                            ("nlist", "nlist_pair/batched")):
        check(launches[kernel] == evals.get(backend, 0) > 0,
              f"router_path: {kernel} launches {launches[kernel]} vs "
              f"evaluations {evals}")
    check(launches["nlist_pair/batched_bf16"] == 0,
          f"router_path: bf16 launches {launches}")
    # The container's nvidia-smi shows this process's context under
    # another pid (1 on the card's machine), so the count is the check:
    # with both workers in this process, a second context is the router's.
    check(router.pid not in apps and len(apps) <= 1,
          f"compute contexts {apps}: the router (pid {router.pid}) holds one")
    registry = fleet["worker_registry"]
    check(sorted(registry) == ["w1", "w2"]
          and all(r["alive"] and not r["draining"]
                  for r in registry.values())
          and fleet["router"]["placements"] == len(ids),
          f"fleet-status: {registry}, router {fleet.get('router')}")
    check("route" in span_names and "round" in span_names,
          f"trace-export spans {span_names}")
    bits = {}
    for label in ("direct", "affinity", "mxu", "nlist", "drained"):
        config = router_job_config(label)
        pos, vel = padded_solo_final(config, dev)
        got = results[label]
        same = (np.array_equal(np.asarray(got["positions"], np.float32),
                               pos.cpu().numpy())
                and np.array_equal(np.asarray(got["velocities"],
                                              np.float32),
                                   vel.cpu().numpy()))
        check(same, f"routed {label}: not the bits of its padded solo run")
        bits[label] = same
    rounds = [e for e in events if e.get("event") == "round"]
    hop = rsnap["registry"]
    record.update({
        "jobs": {label: {"job": ids[label], "worker": where[label],
                         "rule": routed[ids[label]]["rule"]}
                 for label in ids},
        "wall_s": serve_s, "bitwise_equal_padded_solo": bits,
        "affinity_key": aff["rationale"]["compile_key"],
        "rejection": rejection, "force_evals": evals,
        "kernel_launches": launches, "compute_app_pids": apps,
        "router_pid": router.pid,
        # Whether the listing sees this process's own context: where it
        # does not, the router's absence from it says nothing.
        "own_pid_listed": os.getpid() in apps,
        # libcuda.so comes in with torch's CUDA libraries; a context is
        # what a torch.cuda call would add, and what nvidia-smi lists.
        "router_maps_libcuda": router_libcuda,
        "ms_per_round_by_worker": {
            wid: [1e3 * e["round_s"] for e in rounds
                  if e.get("worker") == wid] for wid in workers},
        "router_hop_s": {
            "p50": snapshot_quantile(hop, "gravity_router_latency_seconds",
                                     0.5),
            "p99": snapshot_quantile(hop, "gravity_router_latency_seconds",
                                     0.99)},
        "placements": rsnap["placements"], "routed": rsnap["routed"],
        "trace_spans": span_names})
    emit(record)
    return record


def phase_trace_path(device: dict) -> dict:
    """Solo-run tracing on the card: ``reference-cuda`` cut to 100 steps
    (blocks of 10, a checkpoint every 50) through ``run`` with and without
    ``--trace``: the same final bits, the same host syncs, a ``block``
    span a block, two ``checkpoint`` spans, ``trace-export
    --trace-file`` coverage above 0.9; ms a step both ways. Then
    ``--trace`` with ``GRAVITY_TPU_FAULTS=diverge@50``: exit 2 and one
    flight-recorder dump."""
    import glob
    import warnings

    import torch

    from gravity_tpu_torch.telemetry import load_spans

    root = tempfile.mkdtemp(dir=os.path.join(REPO, "gravity_logs_gpu"))
    runs = {}
    for name, extra in (("plain", ()), ("traced", ("--trace",)),
                        ("plain_syncs", ()), ("traced_syncs",
                                              ("--trace",))):
        d = os.path.join(root, name)
        argv = [*TRACE_ARGS, "--checkpoint-every", "50", "--checkpoint-dir",
                os.path.join(d, "ck"), "--log-dir", d, *extra]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if name.endswith("_syncs"):
                torch.cuda.set_sync_debug_mode("warn")
            try:
                p = run_cli(argv)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        check(p.returncode == 0, f"trace_path {name}: {p.stderr[-2000:]}")
        runs[name] = {"stats": last_json(p.stdout), "dir": d, "syncs": sum(
            "synchroniz" in str(w.message) for w in caught)}
    plain, traced = runs["plain"], runs["traced"]
    same = same_bits(checkpoint_at(os.path.join(plain["dir"], "ck"), 100),
                     checkpoint_at(os.path.join(traced["dir"], "ck"), 100))
    check(same, "trace_path: the traced run is not the untraced bits")
    check(runs["plain_syncs"]["syncs"] == runs["traced_syncs"]["syncs"],
          f"trace_path: host syncs {runs['plain_syncs']['syncs']} untraced, "
          f"{runs['traced_syncs']['syncs']} traced")
    stats = traced["stats"]
    spans = [s for s in load_spans(stats["trace_path"])
             if s["trace"] == stats["trace_id"]]
    names = [s["name"] for s in spans]
    check(names.count("block") == TRACE_BLOCKS
          and names.count("checkpoint") == 2,
          f"trace_path spans {sorted(set(names))}: "
          f"{names.count('block')} blocks")
    check(stats["kernel_launches"] == 101,
          f"trace_path: {stats['kernel_launches']} nbody_direct launches")
    out = os.path.join(root, "solo.trace.json")
    p = run_cli(["trace-export", "--trace-file", stats["trace_path"],
                 "--trace", stats["trace_id"], "--out", out])
    check(p.returncode == 0, f"trace-export: {p.stderr[-1000:]}")
    export = last_json(p.stdout)
    check(export["coverage"] > 0.9, f"trace-export coverage {export}")
    div = os.path.join(root, "diverge")
    p = run_cli([*TRACE_ARGS, "--trace", "--log-dir", div],
                faults=TRACE_DIVERGE)
    dumps = sorted(glob.glob(os.path.join(div, "flightrec_*.json")))
    check(p.returncode == 2 and len(dumps) == 1,
          f"trace_path diverge: rc {p.returncode}, dumps {dumps}")
    with open(dumps[0]) as f:
        dump = json.load(f)
    check(dump["reason"] == "divergence", f"dump reason {dump['reason']}")
    record = {
        "phase": "trace_path", "nvidia_smi": device["nvidia_smi"],
        "ms_per_step": {"untraced": 1e3 * plain["stats"]["avg_step_s"],
                        "traced": 1e3 * stats["avg_step_s"]},
        "bitwise_equal_untraced": same,
        "host_syncs": {"untraced": runs["plain_syncs"]["syncs"],
                       "traced": runs["traced_syncs"]["syncs"]},
        "spans": {n: names.count(n) for n in sorted(set(names))},
        "export": export, "diverge_exit": p.returncode,
        "dump_entries": len(dump["entries"])}
    emit(record)
    return record


def phase_sweep_verb_path(device: dict) -> dict:
    """The ``sweep`` verb on the card through ``run_cli``: sizes 10, 100,
    500 and 1,000 at the reference's 500 steps of 3,600 s, batched on
    ``nbody_direct``; its batched launches equal the force evaluations the
    log reports, each size's final positions (the last trajectory frame)
    the bits of its padded solo run, and the log holds each size's
    sections. Printed: the wall time."""
    import glob
    import re

    import numpy as np

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.utils.trajectory import TrajectoryReader

    log_dir = tempfile.mkdtemp(dir=os.path.join(REPO, "gravity_logs_gpu"))
    reset_counts()
    t0 = time.perf_counter()
    p = run_cli(["sweep", "--sizes", *map(str, SWEEP_VERB_SIZES),
                 *SWEEP_VERB_ARGS, "--trajectories", "--log-dir", log_dir])
    wall = time.perf_counter() - t0
    launches = read_counts()
    check(p.returncode == 0, f"sweep: rc {p.returncode} {p.stderr[-2000:]}")
    (log_path,) = glob.glob(os.path.join(log_dir, "simulation_log_*.txt"))
    text = open(log_path).read()
    evals = int(re.search(r"(\d+) batched force evaluations", text)[1])
    check(launches["nbody_direct/batched"] == evals > 0,
          f"sweep: launches {launches} vs {evals} evaluations")
    for n in SWEEP_VERB_SIZES:
        check(f"Starting gravity simulation with {n} particles" in text,
              f"sweep log: no section for {n}")
    check(text.count("Final positions:") == len(SWEEP_VERB_SIZES)
          and text.rstrip().endswith("Simulation completed successfully"),
          "sweep log sections")
    steps = int(SWEEP_VERB_ARGS[1])
    bits = {}
    for n in SWEEP_VERB_SIZES:
        (traj,) = glob.glob(os.path.join(log_dir,
                                         f"trajectories_*_n{n}"))
        reader = TrajectoryReader(traj)
        check(reader.steps[-1] == steps, f"sweep n={n}: frames "
              f"{reader.steps}")
        config = SimulationConfig(n=n, steps=steps, dt=3600.0,
                                  force_backend="pallas")
        pos, _ = padded_solo_final(config, card())
        bits[n] = bool(np.array_equal(np.asarray(reader.load()[-1]),
                                      pos.cpu().numpy()))
        check(bits[n], f"sweep n={n}: not the bits of its padded solo run")
    record = {"phase": "sweep_verb_path", "nvidia_smi": device["nvidia_smi"],
              "sizes": list(SWEEP_VERB_SIZES), "steps": steps,
              "wall_s": wall, "force_evals": evals,
              "kernel_launches": launches,
              "bitwise_equal_padded_solo": bits}
    emit(record)
    return record


# validate --gpu's records, in the JAX battery's order (tpu_ -> gpu_).
VALIDATE_RECORDS = (
    "kernel_cross_check", "earth_year_closure", "leapfrog_energy_drift",
    "yoshida4_vs_leapfrog", "adaptive_t_landing", "merge_conservation",
    "gpu_pallas_parity", "gpu_pallas_mxu_parity",
    "gpu_pallas_mxu_bf16_parity", "gpu_tree_parity", "gpu_fmm_parity",
    "gpu_fmm_potential", "gpu_fmm_parity_cold", "gpu_sfmm_parity_disk",
    "gpu_sharded_mesh1", "gpu_bench_5step", "gpu_2m_direct_3step")
# The records that launch a kernel on the card, and which.
VALIDATE_KERNELS = {
    "kernel_cross_check": "nbody_direct", "gpu_pallas_parity": "nbody_direct",
    "gpu_pallas_mxu_parity": "nbody_mxu",
    "gpu_pallas_mxu_bf16_parity": "nbody_mxu",
    "gpu_sharded_mesh1": "nbody_direct", "gpu_bench_5step": "nbody_direct",
    "gpu_2m_direct_3step": "nbody_direct"}
# The JAX package's own figure for each accuracy record on the port's
# card states (scripts/jax_validate_figures.py card, on the CPU): a
# record that misses its JAX bar must stay within VALIDATE_SLACK of it.
# Of these the dense FMM alone misses its bar (0.01) there, in both
# packages.
VALIDATE_JAX_FIGURES = {
    "gpu_tree_parity": 0.011887385133945515,
    "gpu_fmm_parity": 0.012491234419567489,
    "gpu_fmm_potential": 0.006468397207538084,
    "gpu_fmm_parity_cold": 0.0013593393722381932,
    "gpu_sfmm_parity_disk": 0.0013621549805511684}
VALIDATE_SLACK = 1.5
# The .gtrj of tooling_path: reference-cuda cut to 20 steps, a frame a
# block of 5.
TOOLING_RUN = ("run", "--preset", "reference-cuda", "--steps", "20",
               "--progress-every", "5", "--trajectories",
               "--trajectory-format", "native")
# The examples at tests/test_torch_examples.py's sizes.
EXAMPLES = (
    ("solar_system", ("--steps-per-day", "2"), ("closure error",)),
    ("galaxy_merger", ("--n", "512", "--steps", "10", "--backend",
                       "chunked"), ("energy drift",)),
    ("star_cluster", ("--n", "128", "--steps", "10"), ("drift_ladder_r3",)),
    ("gradient_orbit_fit", ("--iters", "120", "--steps", "30", "--solo"),
     ("FIT OK", "[solo]")),
)


def phase_validate_path(device: dict) -> dict:
    """``validate --gpu`` through ``run_cli``: the JAX battery's 17
    records under their ``gpu_`` names; each kernel record's route its
    CUDA source and its launches non-zero, ``nbody_direct`` and
    ``nbody_mxu`` launched during the verb; the two rate bars (half of
    PERF.md's kernel-table rates) held; every record ok, or an accuracy
    record that misses its JAX bar within 1.5x of the JAX package's own
    figure on the same state. Printed: each record, the seconds."""
    reset_counts()
    t0 = time.perf_counter()
    p = run_cli(["validate", "--gpu"])
    wall = time.perf_counter() - t0
    counts = read_counts()
    report = json.loads(p.stdout)
    checks = report["checks"]
    emit({"phase": "validate_path", "nvidia_smi": device["nvidia_smi"],
          "wall_s": wall, "exit": p.returncode, "ok": report["ok"],
          "checks": checks, "counts": counts})
    check(tuple(checks) == VALIDATE_RECORDS,
          f"validate records {list(checks)}")
    check(p.returncode == (0 if report["ok"] else 1),
          f"validate: exit {p.returncode} with ok {report['ok']}")
    for name, kernel in VALIDATE_KERNELS.items():
        rec = checks[name]
        check(rec["route"] == f"{kernel}.cu" and rec["launches"] > 0,
              f"validate {name}: route {rec['route']}, "
              f"{rec['launches']} launches")
    check(counts["nbody_direct"] > 0 and counts["nbody_mxu"] > 0,
          f"validate launches {counts}")
    for name in ("gpu_bench_5step", "gpu_2m_direct_3step"):
        rec = checks[name]
        check(rec["pairs_per_sec_per_chip"] > rec["bar"],
              f"validate {name}: {rec['pairs_per_sec_per_chip']:.4g} "
              f"pairs/s under the bar {rec['bar']:.4g}")
    misses = {}
    for name, rec in checks.items():
        if rec["ok"]:
            continue
        value = rec.get("median_rel_err", rec.get("rel_err"))
        figure = VALIDATE_JAX_FIGURES.get(name)
        misses[name] = {"value": value, "jax_figure": figure}
        check(figure is not None and value is not None
              and value <= VALIDATE_SLACK * figure,
              f"validate {name} failed: {rec} (the JAX package's figure "
              f"on this state {figure})")
    record = {"phase": "validate_path", "wall_s": wall,
              "exit": p.returncode, "misses_as_jax": misses,
              "rates": {k: checks[k]["pairs_per_sec_per_chip"] for k in
                        ("gpu_bench_5step", "gpu_2m_direct_3step")},
              "bars": {k: checks[k]["bar"] for k in
                       ("gpu_bench_5step", "gpu_2m_direct_3step")},
              "card": checks["gpu_2m_direct_3step"]["card"]}
    emit(record)
    return record


def phase_tooling_path(device: dict, bench_line: dict) -> dict:
    """The device-free verbs on artifacts of this run: ``traj info``,
    ``stats``, ``dump`` (the last frame by -1, and a frame out of range:
    exit 2 and the tool's line) and ``export`` on the ``.gtrj`` that
    ``reference-cuda`` (cut to 20 steps) writes on the card, each held to
    the file read by ``NativeTrajectoryReader``; and ``bench --report``
    over a directory holding this run's bench line as its one round, a
    ``cuda`` row labelled live with its rate."""
    import glob

    import numpy as np

    from gravity_tpu_torch.utils.trajectory import NativeTrajectoryReader

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(dir=os.path.join(REPO, "gravity_logs_gpu"))
    p = run_cli([*TOOLING_RUN, "--log-dir", root])
    check(p.returncode == 0, f"tooling run: {p.stderr[-2000:]}")
    (path,) = glob.glob(os.path.join(root, "*.gtrj"))
    reader = NativeTrajectoryReader(path)
    frames, traj = reader.num_frames, reader.load()
    steps = reader.steps
    out = {}
    for cmd, extra in (("info", ()), ("stats", ()),
                       ("dump", ("--frame", "-1", "--count", "5")),
                       ("range", ("--frame", str(frames)))):
        out[cmd] = run_cli(["traj", "dump" if cmd == "range" else cmd,
                            path, *extra])
    info = out["info"]
    check(info.returncode == 0 and info.stdout.splitlines() == [
        "format: GTRJ v1", f"particles: {traj.shape[1]}", "dtype: f32",
        f"frames: {frames}", f"frame_bytes: {reader.frame_bytes}",
        f"steps: {steps[0]}..{steps[-1]}"], f"traj info: {info}")
    rows = out["stats"].stdout.splitlines()
    check(out["stats"].returncode == 0 and len(rows) == frames + 1
          and rows[0] == "frame,step,cx,cy,cz,extent,max_disp",
          f"traj stats: {rows[:3]}")
    last = [float(x) for x in rows[-1].split(",")[2:5]]
    centroid = traj[-1].astype(np.float64).mean(axis=0)
    check(np.allclose(last, centroid, rtol=1e-5,
                      atol=1e-5 * np.abs(traj[-1]).max()),
          f"traj stats centroid {last} against {centroid}")
    dump = out["dump"].stdout.splitlines()
    got = np.array([[float(v) for v in r.split(",")[1:]] for r in dump[2:]])
    check(out["dump"].returncode == 0 and dump[0] == f"step,{steps[-1]}"
          and np.array_equal(got.astype(np.float32), traj[-1][:5]),
          f"traj dump: {dump[:3]}")
    rng = out["range"]
    check(rng.returncode == 2 and rng.stdout == "" and rng.stderr ==
          f"frame {frames} out of range (0..{frames - 1})\n",
          f"traj dump out of range: {rng}")
    p = run_cli(["traj", "export", path])
    exported = last_json(p.stdout)
    check(p.returncode == 0 and np.array_equal(
        np.load(exported["positions"]), traj) and list(np.load(
            exported["steps"])) == steps, f"traj export: {exported}")
    report_dir = tempfile.mkdtemp(dir=root)
    with open(os.path.join(report_dir, "BENCH_r01.json"), "w") as f:
        json.dump({"parsed": bench_line}, f)
    p = run_cli(["bench", "--report", "--report-dir", report_dir])
    row = p.stdout.splitlines()[2].split()
    check(p.returncode == 0 and row[3] == "cuda" and row[4] == "live"
          and row[6] == f"{bench_line['value']:.2e}",
          f"bench --report: {p.stdout[:600]}")
    record = {"phase": "tooling_path", "nvidia_smi": device["nvidia_smi"],
              "frames": frames, "particles": int(traj.shape[1]),
              "report_row": row, "wall_s": time.perf_counter() - t0}
    emit(record)
    return record


def phase_examples_path(device: dict) -> dict:
    """The examples on the card, in this process at their test sizes:
    ``solar_system``, ``galaxy_merger`` and ``star_cluster`` (its ladder
    and two-rung drifts below a tenth of single-rate's), and
    ``gradient_orbit_fit --solo``; each exit 0 with its markers."""
    import contextlib
    import importlib
    import io

    t0 = time.perf_counter()
    walls = {}
    for name, argv, markers in EXAMPLES:
        module = importlib.import_module(f"gravity_tpu_torch.examples.{name}")
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = module.main(list(argv))
        walls[name] = time.perf_counter() - t
        text = out.getvalue()
        check(rc == 0 and all(m in text for m in markers),
              f"example {name}: exit {rc}, {text[-800:]}")
        if name == "star_cluster":
            rep = last_json(text)
            check(rep["drift_two_rung"] < rep["drift_single_rate"] / 10
                  and rep["drift_ladder_r3"] < rep["drift_single_rate"] / 10,
                  f"star_cluster drifts {rep}")
    record = {"phase": "examples_path", "nvidia_smi": device["nvidia_smi"],
              "wall_s": walls, "total_s": time.perf_counter() - t0}
    emit(record)
    return record


# The host-native C++ direct sum (force_backend="cpp"): the CPU's fast fp64
# oracle and mid-N direct sum, run here on the card machine's host (g++ is
# there, since nvcc needs it). The README's random cube at N = 8,192,
# leapfrog, 10 steps, in float64 and float32, through the run verb.
HOST_N = 8192
HOST_STEPS = 10
HOST_SAMPLE = 4096
HOST_REPS = 5
HOST_RUN = ("run", "--device", "cpu", "--model", "random", "--n",
            str(HOST_N), "--steps", str(HOST_STEPS), "--integrator",
            "leapfrog", "--force-backend", "cpp", "--progress-every",
            str(HOST_STEPS), "--checkpoint-every", str(HOST_STEPS))
# f64 flops a core issues a clock at its widest fused multiply-add: two FMA
# units of 8 lanes (AVX-512) or 4 (AVX2 with FMA), each FMA two flops;
# without them SSE2's 2 lanes of an add and a multiply.
HOST_F64_FLOPS_PER_CLOCK = (("avx512f", 32), ("fma", 16), ("sse2", 4))


def host_cpu() -> dict:
    """The host: its CPU model (``/proc/cpuinfo``), the CPUs this process
    may use (its affinity, capped by its cgroup's CPU quota where one is
    set), the physical cores those stand for, the highest clock
    ``/proc/cpuinfo`` reads, and its f64 flops a core a clock by ISA."""
    import re

    with open("/proc/cpuinfo") as f:
        text = f.read()

    def field(name):
        found = re.findall(rf"^{name}\s*:\s*(.+)$", text, re.M)
        value = found[0].strip() if found else "unknown"
        return None if value == "unknown" else value

    # Where the model name is not given (a virtual machine's /proc/cpuinfo
    # may read "unknown"), the CPUID vendor, family, model and stepping it
    # does give name the part.
    model = field("model name") or " ".join(
        f"{k} {field(k)}" for k in ("vendor_id", "cpu family", "model",
                                    "stepping") if field(k))
    mhz = [float(x) for x in re.findall(r"^cpu MHz\s*:\s*([\d.]+)$", text,
                                        re.M)]
    flags = set((re.findall(r"^flags\s*:\s*(.+)$", text, re.M)
                 or [""])[0].split())
    per_clock = next((v for k, v in HOST_F64_FLOPS_PER_CLOCK if k in flags),
                     2)
    cpus = len(os.sched_getaffinity(0))
    quota = None
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            q, period = f.read().split()
        if q != "max":
            quota = float(q) / float(period)
            cpus = min(cpus, max(1, math.ceil(quota)))
    except (OSError, ValueError):
        pass
    siblings = re.findall(r"^siblings\s*:\s*(\d+)$", text, re.M)
    cores = re.findall(r"^cpu cores\s*:\s*(\d+)$", text, re.M)
    smt = (int(siblings[0]) // int(cores[0])
           if siblings and cores and int(cores[0]) > 0 else 1)
    return {"model": model or "unknown",
            "cpus": cpus, "cpu_quota": quota,
            "os_cpu_count": os.cpu_count(), "threads_per_core": smt,
            "cores": max(1, cpus // max(1, smt)),
            "max_mhz": max(mhz) if mhz else None,
            "f64_flops_per_core_clock": per_clock}


def host_bytes_per_s() -> float:
    """The host's copy rate, bytes read and written over a 512 MiB float64
    copy (best of 3): the memory rate of the bytes bound."""
    import torch

    a = torch.ones(1 << 26, dtype=torch.float64)
    b = torch.empty_like(a)
    best = math.inf
    for _ in range(3):
        t = time.perf_counter()
        b.copy_(a)
        best = min(best, time.perf_counter() - t)
    return 2 * a.numel() * a.element_size() / best


def host_ms(fn, reps: int) -> float:
    """Median ms of ``fn`` on the host clock, after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return 1e3 * statistics.median(times)


def phase_host_path(device: dict, build: dict) -> dict:
    """``run --device cpu --force-backend cpp`` (HOST_RUN) in float64 and
    float32, with every launch count set to 0 just before each run and
    read just after: the row sum called once an evaluation, no card kernel
    launched. The final state's forces at HOST_SAMPLE sampled rows by the
    row sum against ``nbody_direct`` on the card and against the plain
    version on the CPU, each within the kernel-vs-plain bars (TOL) of each
    row's sum of |terms|. ``--force-backend cpp`` without ``--device cpu``
    (the card, the default) exits non-zero with the ValueError. Timed on
    the host clock: ms an evaluation at N = 8,192 and pairs/s, the sampled
    rows' call and the plain version's, beside the bound at the host's CPU
    count, clock and f64 rate (:func:`host_cpu`) and its copy rate."""
    import torch

    from gravity_tpu_torch import simulation
    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.ops import host_kernel
    from gravity_tpu_torch.ops.direct_kernel import accelerations_vs_kernel
    from gravity_tpu_torch.ops.forces import accelerations_vs_chunked

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(dir=os.path.join(REPO, "gravity_logs_gpu"))
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("GRAVITY_TPU_FAULTS", None)
    # The refusal on the card, a process of its own started first, so that
    # its start overlaps the host runs.
    refusal = subprocess.Popen(
        [sys.executable, "-m", "gravity_tpu_torch", "run", "--model",
         "random", "--n", str(HOST_N), "--steps", "1", "--force-backend",
         "cpp", "--log-dir", os.path.join(root, "refused")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        simulation.make_local_kernel(SimulationConfig(force_backend="cpp"),
                                     "cpp", device="cuda")
        check(False, "make_local_kernel('cpp') took a card device")
    except ValueError as e:
        in_process = str(e)
    cpu = host_cpu()
    rate = host_bytes_per_s()
    peak = (cpu["cores"] * cpu["max_mhz"] * 1e6
            * cpu["f64_flops_per_core_clock"]) if cpu["max_mhz"] else None
    gen = torch.Generator().manual_seed(25)
    idx = torch.randperm(HOST_N, generator=gen)[:HOST_SAMPLE]
    runs = {}
    for dtype in ("float64", "float32"):
        ck = os.path.join(root, f"ck_{dtype}")
        reset_counts()
        host_kernel.LAUNCHES = 0
        p = run_cli([*HOST_RUN, "--dtype", dtype, "--checkpoint-dir", ck,
                     "--log-dir", os.path.join(root, dtype)])
        launches, counts = host_kernel.LAUNCHES, read_counts()
        check(p.returncode == 0, f"host run {dtype}: {p.stderr[-2000:]}")
        stats = last_json(p.stdout)
        check(stats["backend"] == "cpp" and stats["device"] == "cpu"
              and stats["dtype"] == dtype, f"host run {dtype}: {stats}")
        check(launches == stats["kernel_launches"] == HOST_STEPS + 1,
              f"host run {dtype}: {launches} calls of the row sum for "
              f"{HOST_STEPS} leapfrog steps")
        check(not any(counts.values()),
              f"host run {dtype} launched card kernels: {counts}")
        final = checkpoint_at(ck, HOST_STEPS)
        pos = final.positions.cpu().contiguous()
        masses = final.masses.cpu().contiguous()
        check(pos.dtype == getattr(torch, dtype)
              and bool(torch.isfinite(pos).all()),
              f"host run {dtype}: final state {pos.dtype}, not finite?")
        config = SimulationConfig(model="random", n=HOST_N, dtype=dtype)
        kw = dict(g=config.g, cutoff=config.cutoff, eps=config.eps)
        targets = pos[idx].contiguous()
        host = host_kernel.host_accelerations_vs(targets, pos, masses, **kw)
        dev = torch.device("cuda", 0)
        card = accelerations_vs_kernel(targets.to(dev), pos.to(dev),
                                       masses.to(dev), **kw).cpu()
        t = time.perf_counter()
        plain = accelerations_vs_chunked(targets, pos, masses, chunk=512,
                                         **kw)
        plain_ms = 1e3 * (time.perf_counter() - t)
        scale = term_scale(targets.to(dev), pos.to(dev), masses.to(dev),
                           config.eps, g=config.g).cpu()
        vs_card = compare(f"host_forces/{dtype}/vs_nbody_direct", host,
                          card, scale, dtype)
        vs_plain = compare(f"host_forces/{dtype}/vs_plain_cpu", host, plain,
                           scale, dtype)
        sample_ms = host_ms(lambda: host_kernel.host_accelerations_vs(
            targets, pos, masses, **kw), HOST_REPS)
        eval_ms = host_ms(lambda: host_kernel.host_pairwise_accelerations(
            pos, masses, **kw), HOST_REPS)
        m, k = HOST_SAMPLE, HOST_N
        flops, nbytes, _ = host_kernel.cost_estimate(m, k,
                                                     pos.element_size())
        ops_ms = 1e3 * flops / peak if peak else None
        bytes_ms = 1e3 * nbytes / rate
        runs[dtype] = {
            "launches": launches, "card_launches": counts,
            "ms_per_step": 1e3 * stats["avg_step_s"],
            "run_pairs_per_s": stats["pairs_per_sec"],
            "ms_per_eval": eval_ms,
            "pairs_per_s": HOST_N * (HOST_N - 1) / (eval_ms / 1e3),
            "threads": host_kernel.threads(HOST_N),
            "vs_nbody_direct": vs_card, "vs_plain_cpu": vs_plain,
            "timing": {
                "shape": [m, k], "ms": sample_ms, "plain_ms": plain_ms,
                "bound_ms": max(x for x in (ops_ms, bytes_ms) if x),
                "bound_by": ("operations" if ops_ms and ops_ms >= bytes_ms
                             else "bytes"),
                "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                "library_ms": None,
                "library_note": "none: no single PyTorch call computes "
                                "this sum",
                "route": "host",
                "source": "gravity_tpu_torch/csrc/host_forces.cpp"},
        }
        runs[dtype]["timing"]["share_of_bound"] = (
            runs[dtype]["timing"]["bound_ms"] / sample_ms)
    out, err = refusal.communicate(timeout=300)
    check(refusal.returncode != 0 and "ValueError" in err
          and "force_backend='cpp'" in err and "--device cpu" in err
          and '"backend"' not in out,
          f"cpp on the card: exit {refusal.returncode}, {err[-1500:]}")
    record = {
        "phase": "host_path", "nvidia_smi": device["nvidia_smi"],
        "host_cpu": cpu, "host_copy_bytes_per_s": rate,
        "host_f64_peak_flops": peak,
        "build_s": build["host_forces"]["gxx_s"],
        "runs": runs, "refused_on_card": {
            "exit": refusal.returncode,
            "error": err.strip().splitlines()[-1]},
        "refused_in_process": in_process,
        "wall_s": time.perf_counter() - t0}
    emit(record)
    return record


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import gravity_tpu_torch  # noqa: F401  (fails where the repo is absent)

    # Plain-version references in full fp32 (guide: TF32 defaults).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Every auto run of this script routes through a tuning cache of its
    # own, empty at the start and removed at the end (subprocesses inherit
    # it), never a cache left on the machine.
    with tempfile.TemporaryDirectory() as tune_dir:
        os.environ["GRAVITY_TPU_TUNE_DIR"] = tune_dir
        return run_phases(torch)


def run_phases(torch) -> int:
    t0 = time.perf_counter()
    # Seconds of each phase, in the done line (a phase run twice, as
    # profile_tree, keeps one entry a run).
    phase_s = {}

    def timed(fn, *args, **kwargs):
        t = time.perf_counter()
        result = fn(*args, **kwargs)
        name = fn.__name__.removeprefix("phase_")
        while name in phase_s:
            name += "+"
        phase_s[name] = time.perf_counter() - t
        return result

    device = timed(phase_device)
    build = timed(phase_build)
    max_abs_err = timed(phase_kernel_vs_plain)
    bf16_err = timed(phase_bf16_kernel_vs_plain)
    nlist_err = timed(phase_nlist_kernel_vs_plain)
    mxu_err = timed(phase_mxu_kernel_vs_plain)
    p3m_err = timed(phase_p3m_kernel_vs_plain)
    tree_err = timed(phase_tree_kernel_vs_plain)
    nlist_bf16 = timed(phase_nlist_bf16_kernel_vs_plain)
    seg_bf16 = timed(phase_segment_sum_bf16, device, build)
    main_path = timed(phase_main_path)
    nlist_path = timed(phase_nlist_main_path)
    mxu_path = timed(phase_mxu_path)
    p3m_path = timed(phase_p3m_path)
    p3m_mr = timed(phase_p3m_multirate_path, device)
    p3m_slice = timed(phase_p3m_slice, device)
    base16k = timed(phase_baseline16k_path)
    base2m = timed(phase_baseline2m_path, device)
    sharded = timed(phase_sharded_path, device, base2m)
    halo = timed(phase_halo_path, device)
    sharded_modes = timed(phase_sharded_modes_path, device)
    sharded_fmm = timed(phase_sharded_fmm_path, device)
    sharded_resume = timed(phase_sharded_resume_path, device)
    sharded_grad = timed(phase_sharded_grad_path, device)
    bf16_paths = timed(phase_bf16_paths)
    multirate = timed(phase_multirate_path, device, base16k)
    star = timed(phase_star_cluster_path, device)
    nlist_mr = timed(phase_nlist_multirate_path, device)
    mxu_mr = timed(phase_mxu_multirate_path, device)
    timed(phase_adaptive_path, device, base16k)
    timed(phase_external_path, device)
    timed(phase_merge_path, device)
    # The analyze verb's host analysis (minutes of scipy) overlaps the
    # card-bound octree and FMM phases from here on.
    analyze = start_analyze()
    tree_path = timed(phase_tree_path, device)
    timed(phase_tree_gather_path, device)
    tree_mr = timed(phase_tree_multirate_path, device)
    nlist_bf16_path = timed(phase_nlist_bf16_path, device, nlist_path)
    nlist_bf16_mr = timed(phase_nlist_bf16_multirate_path, device, build)
    tree_bf16 = timed(phase_tree_bf16_path, device)
    fmm_path = timed(phase_fmm_path, device)
    fmm_dense = timed(phase_fmm_dense_path, device)
    fmm_parity = timed(phase_fmm_parity_path, device)
    fmm_mr = timed(phase_fmm_multirate_path, device)
    timed(phase_fmm_debug_check, device)
    fmm_bf16 = timed(phase_fmm_bf16_path, device)
    pm_periodic = timed(phase_pm_periodic_path, device)
    pm_isolated = timed(phase_pm_isolated_path, device)
    cosmo = timed(phase_cosmo_path, device)
    # The processes of serve_path, profile_path and router_path start
    # here, their imports overlapping the phases up to the serve phases.
    started = {"serve": start_verb("serve", "--slots", str(SERVE_SLOTS),
                                   "--slice-steps", str(SERVE_SLICE)),
               "profile": start_verb("serve", "--slots", "4",
                                     "--slice-steps", "20"),
               "router": start_verb("route", "--router-id", "rt")}
    periodic_nlist = timed(phase_periodic_nlist_path, device)
    analyze_path = timed(phase_analyze_path, device, analyze)
    serve_kernels = timed(phase_serve_kernels, device)
    serve_path = timed(phase_serve_path, device, started["serve"])
    serve_parity = timed(phase_serve_parity, device)
    serve_sharded = timed(phase_serve_sharded_path, device)
    backward = timed(phase_backward_path, device)
    fit = timed(phase_fit_path, device)
    sweep_watch = timed(phase_sweep_watch_path, device)
    perf_ledger = timed(phase_perf_ledger, device, {
        "main_path": main_path, "baseline16k_path": base16k,
        "nlist_main_path": nlist_path, "mxu_path": mxu_path,
        "tree_path": tree_path, "fmm_path": fmm_path})
    gate = timed(phase_gate_path, device)
    timed(phase_profile_path, device, started["profile"])
    timed(phase_small_reference)
    timed(phase_other_entry_points)
    bench_path = timed(phase_bench_path, device)
    autotune_path = timed(phase_autotune_path, device)
    pipeline = timed(phase_pipeline_path, device)
    resume = timed(phase_resume_path, device)
    timed(phase_supervisor_path, device)
    cadence = timed(phase_cadence_path, device)
    ledger_tree = timed(phase_ledger_tree_path, device)
    syncs = timed(phase_host_syncs, device)
    timing = timed(phase_timing, device, build)
    t_nlist = timed(phase_timing_nlist, device, build)
    t_mxu = timed(phase_timing_mxu, device, build)
    t_p3m = timed(phase_timing_p3m, device)
    t_tree = timed(phase_timing_tree, device, build)
    t_nlist_bf16 = timed(phase_timing_nlist_bf16, device, build)
    timed(phase_profile_nlist)
    timed(phase_profile_p3m)
    timed(phase_profile_tree)
    profile_bf16 = timed(phase_profile_tree, bf16=True)
    routed = timed(phase_router_path, device, started["router"])
    traced = timed(phase_trace_path, device)
    sweep_verb = timed(phase_sweep_verb_path, device)
    validated = timed(phase_validate_path, device)
    tooling = timed(phase_tooling_path, device, bench_path["direct"]["line"])
    examples = timed(phase_examples_path, device)
    host = timed(phase_host_path, device, build)
    emit({"phase": "done", "wall_s": time.perf_counter() - t0,
          "phase_s": phase_s,
          "kernel_share_of_main_path_step":
              timing["ms"] / main_path["ms_per_step"],
          "nlist_kernel_share_of_step":
              t_nlist["ms"] / nlist_path["ms_per_step"],
          "mxu_kernel_share_of_step": t_mxu["ms"] / mxu_path["ms_per_step"],
          "p3m_ewald_kernel_share_of_step":
              t_p3m["ms"] / p3m_path["ms_per_step"],
          "baseline16k_kernel_share_of_step":
              timing["baseline16k"]["ms"][0] / base16k["ms_per_step"],
          "baseline2m_ms_per_step": base2m["ms_per_step"],
          "sharded": {
              "baseline_262k_ms_per_step":
                  sharded["baseline_262k"]["ms_per_step"],
              "unsharded_262k_ms_per_step":
                  sharded["baseline_262k"]["unsharded_ms_per_step"],
              "baseline_262k_again_ms_per_step":
                  sharded["baseline_262k"]["again_ms_per_step"],
              "baseline_262k_bitwise_unsharded":
                  sharded["baseline_262k"]["run_bitwise_equal_unsharded"],
              "baseline_2m_merger_ms_per_step":
                  sharded["baseline_2m_merger"]["ms_per_step"],
              "baseline_2m_merger_eval_bitwise_unsharded":
                  sharded["baseline_2m_merger"][
                      "eval_bitwise_equal_unsharded"],
              "hierarchical_1x1_bitwise_unsharded":
                  sharded["hierarchical_1x1"]["bitwise_equal_unsharded"]},
          "halo": {
              k: {f: v[f] for f in ("bitwise_equal_solo", "ms_per_eval",
                                    "solo_ms_per_eval", "host_syncs_per_eval",
                                    "gap_over_rms_a") if f in v}
              for k, v in halo["evals"].items()},
          "sharded_modes_ms_per_step": {
              k: [v["ms_per_step"], v["unsharded_ms_per_step"]]
              for k, v in sharded_modes["modes"].items()},
          "sharded_fmm": {k: [v["ms_per_step"], v["unsharded_ms_per_step"],
                              v["bitwise_equal_unsharded"]]
                          for k, v in sharded_fmm["runs"].items()},
          "sharded_resume": {k: v["bitwise_equal_uninterrupted"]
                             for k, v in sharded_resume["resumed"].items()},
          "sharded_grad": {k: [v["ms"], v["unsharded_ms"], v["peak_bytes"],
                               v["gap"]["positions"]]
                           for k, v in sharded_grad["parts"].items()},
          "serve_sharded": {
              "bitwise_equal_solo": {k: v["bitwise_equal_solo"] for k, v in
                                     serve_sharded["jobs"].items()},
              "ms_per_round": {k: v["ms_per_round"] for k, v in
                               serve_sharded["daemons"].items()}},
          "p3m_multirate_ms_per_step": p3m_mr["ms_per_step"],
          "p3m_slice_max_scaled_gap": p3m_slice["max_scaled_gap"],
          "fmm_bf16": {
              "ms_per_step": fmm_bf16["ms_per_step"],
              "vs_fp32_median_1m": fmm_bf16["vs_fp32_sparse_fmm"]["median"],
              "shared_state_vs_fp32": {
                  k: v["median"] for k, v in
                  fmm_bf16["shared_state_vs_fp32"].items()}},
          "bf16_kernel_share_of_step":
              timing["bf16"]["ms"]
              / bf16_paths["nbody_direct"]["ms_per_step"],
          "multirate_ms_per_step": {
              "baseline16k_two_rung": multirate["ms_per_step"],
              "baseline16k_ladder": multirate["ladder"]["ms_per_step"],
              "nlist": nlist_mr["ms_per_step"],
              "pallas_mxu": mxu_mr["ms_per_step"]},
          "star_cluster_ordering_holds": star["ordering_holds"],
          "tree_ms_per_step": tree_path["ms_per_step"],
          "tree_multirate_ms_per_step": tree_mr["ms_per_step"],
          "tree_near_kernel_share_of_step":
              t_tree["ms"] / tree_path["ms_per_step"],
          "bf16_ms_per_step": {
              "nlist": nlist_bf16_path["ms_per_step"],
              "nlist_multirate": nlist_bf16_mr["ms_per_step"],
              "tree_nlist": tree_bf16["ms_per_step"],
              "tree_gather": tree_bf16["gather"]["ms_per_step"],
              "tree_multirate": tree_bf16["multirate"]["ms_per_step"]},
          "bf16_tree_segment_sums_ms_per_eval":
              profile_bf16["segment_sum_kernels_ms_per_eval"],
          "bf16_tree_segment_sum_share_of_step":
              profile_bf16["segment_sum_kernels_ms_per_eval"]
              / tree_bf16["ms_per_step"],
          "bench_pairs_per_sec": {k: v["line"]["value"]
                                  for k, v in bench_path.items()},
          "autotune_winners": {k: v["winner"] for k, v in
                               autotune_path.items() if k != "tune"},
          "host_gap_frac": {
              "baseline16k_pipeline": {
                  m: [r["host_gap_frac"] for r in pipeline["runs"][m]]
                  for m in ("on", "off")},
              "host_gap_pipelined": {
                  m: v["median_host_gap_frac"] for m, v in
                  pipeline["host_gap_pipelined"]["runs"].items()},
              "readme_nlist_cadence": {
                  m: [r["host_gap_frac"] for r in v]
                  for m, v in cadence["runs"].items()}},
          "resume_bitwise_reference_cuda":
              resume["reference_cuda"]["bitwise_equal_uninterrupted"],
          "resume_nlist_max_gap_m":
              resume["readme_nlist"]["max_position_gap_m"],
          "ledger_tree_eval_over_step": ledger_tree["ledger_over_step"],
          "large_n_potentials_ms": ledger_tree["large_n_potentials"]["ms"],
          "fmm": {
              "baseline_1m_fmm_ms_per_step": fmm_path["ms_per_step"],
              "sparse_stages_ms": fmm_path["profile"][
                  "stage_device_span_ms_per_eval"],
              "dense_cube_ms_per_step": fmm_dense["ms_per_step"],
              "multirate_ms_per_step": fmm_mr["ms_per_step"],
              "parity_sparse_vs_dense": fmm_parity["sparse_vs_dense"],
              "vs_nbody_direct": {
                  "sparse_1m": fmm_path["vs_nbody_direct"],
                  "dense_cube": fmm_dense["vs_nbody_direct"]},
              "host_syncs_per_step": {
                  "sparse": fmm_path["host_syncs_per_step"],
                  "dense": fmm_dense["host_syncs_per_step"]}},
          "periodic": {
              "cosmo_262k_ms_per_step": pm_periodic["cic"]["ms_per_step"],
              "cosmo_262k_tsc_ms_per_step":
                  pm_periodic["tsc"]["ms_per_step"],
              "pm_spans_ms": pm_periodic["cic"]["profile"][
                  "stage_device_span_ms_per_eval"],
              "mesh_energy_drift": pm_periodic["cic"]["mesh_energy_drift"],
              "first_eval_vs_cpu_f64": pm_periodic["first_eval_vs_cpu_f64"],
              "ewald_rel_err": [e["rel_err"] for e in pm_periodic["ewald"]],
              "isolated_probe_median":
                  pm_isolated["probe"]["median_radial_rel_err"],
              "isolated_disk_vs_nbody_direct":
                  pm_isolated["disk"]["vs_nbody_direct"],
              "cosmo_2m_rel_err": cosmo["lcdm_2m"]["rel_err"],
              "cosmo_2m_ms_per_step": cosmo["lcdm_2m"]["ms_per_step"],
              "cosmo_2m_peak_bytes": cosmo["lcdm_2m"]["peak_memory_bytes"],
              "layzer_irvine": cosmo["lcdm_2m_li"]["layzer_irvine"][
                  "residual"],
              "cosmo_resume": cosmo["resume"],
              "periodic_nlist_ms_per_step": periodic_nlist["ms_per_step"],
              "periodic_nlist_vs_oracle":
                  periodic_nlist["vs_min_image_oracle"][
                      "max_err_over_term_scale"],
              "analyze_wall_s": analyze_path["wall_s"],
              "analyze_n_halos": analyze_path["n_halos"]},
          "serve": {
              "batched_ms": {k: v["ms"] for k, v in
                             serve_kernels["timing"].items()},
              "ms_per_round_by_bucket": {
                  b: v["median"] for b, v in
                  serve_path["ms_per_round_by_bucket"].items()},
              "body_steps_per_s": serve_path["body_steps_per_s"],
              "latency_s": serve_path["latency_s"],
              "host_syncs_per_round": {
                  b: v["host_syncs_per_round"]
                  for b, v in serve_parity["rounds"].items()}},
          "backward_ms": {k: [v["ms"], v["backward_ms"]]
                          for k, v in backward["cases"].items()},
          "fit": {k: [v["served_vs_solo"], v["loss_guess"], v["loss"],
                      v["ms_per_iteration"]]
                  for k, v in fit["jobs"].items()},
          "fit_transfer_orbit_iterations":
              fit["transfer_orbit"]["iterations"],
          "sweep_watch": [sweep_watch["max_min_sep_gap"],
                          sweep_watch["max_drift_gap"],
                          sweep_watch["watch_events"]],
          "router": {"ms_per_round_by_worker": {
              w: statistics.median(v) if v else None for w, v in
              routed["ms_per_round_by_worker"].items()},
              "hop_s": routed["router_hop_s"],
              "rules": {k: v["rule"] for k, v in routed["jobs"].items()}},
          "trace_ms_per_step": traced["ms_per_step"],
          "sweep_verb_wall_s": sweep_verb["wall_s"],
          "validate": {"exit": validated["exit"],
                       "misses_as_jax": validated["misses_as_jax"],
                       "rates": validated["rates"],
                       "wall_s": validated["wall_s"]},
          "tooling_wall_s": tooling["wall_s"],
          "examples_wall_s": examples["wall_s"],
          "host_path": {
              "cpu": host["host_cpu"]["model"],
              "cpus": host["host_cpu"]["cpus"], "build_s": host["build_s"],
              "ms_per_eval": {k: v["ms_per_eval"]
                              for k, v in host["runs"].items()},
              "pairs_per_s": {k: v["pairs_per_s"]
                              for k, v in host["runs"].items()}},
          "host_syncs_per_step": syncs["syncs_per_step"],
          "perf_ledger_share_of_fp32_peak": {
              k: [r["share_of_fp32_peak"] for r in v["rows"]]
              for k, v in perf_ledger["paths"].items()},
          "gate": {**{k: [v["ok"], v["measured"]]
                      for k, v in gate["contracts"].items()},
                   "halo_vs_allgather_speedup": [gate["halo"]["ok"],
                                                 gate["halo"]["measured"]]}})
    kernels = [
        ("nbody_direct", "gravity_tpu/ops/pallas_forces.py:45",
         main_path["launches"], max_abs_err, timing),
        ("nlist_pair", "gravity_tpu/ops/pallas_nlist.py:292",
         nlist_path["launches"], nlist_err, t_nlist),
        ("nbody_mxu", "gravity_tpu/ops/pallas_forces_mxu.py:85",
         mxu_path["launches"], mxu_err, t_mxu),
        ("nlist_pair/ewald", "gravity_tpu/ops/pallas_nlist.py:292",
         p3m_path["launches"], p3m_err, t_p3m),
        ("nbody_direct/bf16", "gravity_tpu/ops/pallas_forces.py:45",
         bf16_paths["nbody_direct"]["launches"], bf16_err, timing["bf16"]),
        # The multirate fast kicks, the rectangular entry points
        # (make_pallas_local_kernel, make_nlist_local_kernel with a
        # k_targets hint, make_pallas_mxu_local_kernel).
        ("nbody_direct/kick", "gravity_tpu/ops/pallas_forces.py:45",
         multirate["launches"],
         multirate["kick"]["max_abs_err"], multirate["kick"]),
        ("nlist_pair/t_cap", "gravity_tpu/ops/pallas_nlist.py:292",
         nlist_mr["launches"], nlist_mr["check"]["max_abs_err"],
         nlist_mr["timing"]),
        ("nbody_mxu/kick", "gravity_tpu/ops/pallas_forces_mxu.py:85",
         mxu_mr["launches"], mxu_mr["check"]["max_abs_err"],
         mxu_mr["timing"]),
        # The octree's near field (nlist_near_field): the untruncated
        # newton form.
        ("nlist_pair/near", "gravity_tpu/ops/pallas_nlist.py:292",
         tree_path["launches"], tree_err, t_tree),
        # The bf16 form on a bf16 state: the nlist run, its multirate
        # kicks at t_cap, and the octree's near field.
        ("nlist_pair/bf16", "gravity_tpu/ops/pallas_nlist.py:292",
         nlist_bf16_path["launches"], nlist_bf16["readme"]["max_abs_err"],
         t_nlist_bf16["readme"]),
        ("nlist_pair/t_cap_bf16", "gravity_tpu/ops/pallas_nlist.py:292",
         nlist_bf16_mr["launches"], nlist_bf16_mr["check"]["max_abs_err"],
         nlist_bf16_mr["timing"]),
        ("nlist_pair/near_bf16", "gravity_tpu/ops/pallas_nlist.py:292",
         tree_bf16["launches"], nlist_bf16["near"]["max_abs_err"],
         t_nlist_bf16["near"]),
        # The bf16 cell totals (cells.segment_sum_bf16): no TPU kernel.
        ("segment_sum/bf16",
         "none: jax.ops.segment_sum at gravity_tpu/ops/tree.py:137 is an "
         "XLA scatter-add, not a Pallas kernel",
         tree_bf16["counts"]["segment_sum/bf16"], seg_bf16["max_abs_err"],
         seg_bf16["timing"]),
        # The serve engine's batched force evaluations (the TPU kernels
        # under vmap from gravity_tpu/serve/engine.py:418): one launch a
        # batch, counted on the daemon's serve path.
        ("nbody_direct/batched", "gravity_tpu/ops/pallas_forces.py:45",
         serve_path["kernel_launches"]["nbody_direct/batched"],
         serve_kernels["max_abs_err"]["nbody_direct/batched"],
         serve_kernels["timing"]["nbody_direct/batched"]),
        ("nbody_mxu/batched", "gravity_tpu/ops/pallas_forces_mxu.py:85",
         serve_path["kernel_launches"]["nbody_mxu/batched"],
         serve_kernels["max_abs_err"]["nbody_mxu/batched"],
         serve_kernels["timing"]["nbody_mxu/batched"]),
        # The served cell list's pair tiles, fp32 and bf16 (the batched
        # _nlist_kernel), counted on the daemon's serve path.
        ("nlist_pair/batched", "gravity_tpu/ops/pallas_nlist.py:292",
         serve_path["kernel_launches"]["nlist_pair/batched"],
         serve_kernels["max_abs_err"]["nlist_pair/batched"],
         serve_kernels["timing"]["nlist_pair/batched"]),
        ("nlist_pair/batched_bf16", "gravity_tpu/ops/pallas_nlist.py:292",
         serve_path["kernel_launches"]["nlist_pair/batched_bf16"],
         serve_kernels["max_abs_err"]["nlist_pair/batched_bf16"],
         serve_kernels["timing"]["nlist_pair/batched_bf16"]),
        # The sharded direct sums on a world of one: the allgather's
        # (n_local, N) launches (baseline-262k, pallas and pallas-mxu) and
        # the ring's (n_local, n_local) hops (baseline-2m-merger).
        ("nbody_direct/allgather", "gravity_tpu/ops/pallas_forces.py:45",
         sharded["baseline_262k"]["launches"],
         sharded["allgather"]["max_abs_err"], sharded["allgather"]),
        ("nbody_direct/ring", "gravity_tpu/ops/pallas_forces.py:45",
         sharded["baseline_2m_merger"]["launches"],
         sharded["ring"]["max_abs_err"], sharded["ring"]),
        ("nbody_mxu/allgather", "gravity_tpu/ops/pallas_forces_mxu.py:85",
         sharded["mxu_262k"]["launches"],
         sharded["mxu_allgather"]["max_abs_err"], sharded["mxu_allgather"]),
        # P3M's multirate kicks: the ewald kind at t_cap < cap.
        ("nlist_pair/p3m_kick", "gravity_tpu/ops/pallas_nlist.py:292",
         p3m_mr["launches"], p3m_mr["check"]["max_abs_err"],
         p3m_mr["timing"]),
        # The halo engine's slab launches on the world of one: the
        # isolated pair tiles of a slab (JAX's _jnp_pair_cells_slab is
        # jnp, no Pallas kernel; it shares _pair_w with _nlist_kernel).
        ("nlist_pair/slab",
         "none: _jnp_pair_cells_slab at gravity_tpu/ops/pallas_nlist.py:623 "
         "is jnp, not a Pallas kernel",
         halo["evals"]["newton"]["launches"],
         halo["slab_checks"]["newton_float32"]["max_abs_err"],
         halo["timing"]["newton"]),
        ("nlist_pair/slab_bf16",
         "none: _jnp_pair_cells_slab at gravity_tpu/ops/pallas_nlist.py:623 "
         "is jnp, not a Pallas kernel",
         halo["evals"]["newton_bf16"]["launches"],
         halo["slab_checks"]["newton_bfloat16"]["max_abs_err"],
         halo["timing"]["newton_bf16"]),
        ("nlist_pair/slab_ewald",
         "none: _jnp_pair_cells_slab at gravity_tpu/ops/pallas_nlist.py:623 "
         "is jnp, not a Pallas kernel",
         halo["evals"]["ewald"]["launches"],
         halo["slab_checks"]["ewald_float32"]["max_abs_err"],
         halo["timing"]["ewald"]),
        # The bf16 sparse FMM's cell totals.
        ("segment_sum/sfmm_bf16",
         "none: jax.ops.segment_sum at gravity_tpu/ops/sfmm.py:187 is an "
         "XLA scatter-add, not a Pallas kernel",
         fmm_bf16["launches"], fmm_bf16["segment_sum"]["max_abs_err"],
         fmm_bf16["segment_sum"]),
        # The host-native C++ direct sum, float64, on the host's CPU: the
        # JAX package's runtime/ffi_forces.cpp row sum (AccelRows).
        ("host_forces",
         "none: runtime/ffi_forces.cpp:35 (AccelRows) is a CPU XLA-FFI row "
         "sum, not a Pallas kernel",
         host["runs"]["float64"]["launches"],
         host["runs"]["float64"]["vs_plain_cpu"]["max_abs_err"],
         host["runs"]["float64"]["timing"]),
    ]
    emit({"kernels": [{
        "name": name, "route": t.get("route", "cuda"),
        "source": t.get("source",
                        f"gravity_tpu_torch/csrc/{name.split('/')[0]}.cu"),
        "replaces": replaces,
        "launches": launches, "max_abs_err": err,
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t.get("library_ms"), "library_note": t["library_note"],
        "checked_against_plain": True,
        # The backward: the dense VJP in plain PyTorch, as the JAX
        # package's wrap_with_dense_vjp; no kernel, launches 0.
        "backward_ms": backward["cases"].get(name, {}).get("backward_ms"),
        # The batched rows' launches on the later serving paths, each
        # counted from 0 over its phase: the two routed workers, and the
        # sweep verb.
        "other_paths_launches": {
            path: counts[name] for path, counts in (
                ("router_path", routed["kernel_launches"]),
                ("sweep_verb_path", sweep_verb["kernel_launches"]))
            if name in BATCHED_ROWS},
    } for name, replaces, launches, err, t in kernels]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
