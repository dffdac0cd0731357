"""Checkpoints, ``resume`` and ``--auto-recover`` on a world of more than one
rank (gravity_tpu_torch/simulation.py, cli.py, supervisor.py), on the CPU.

Ranks are spawned with ``torch.multiprocessing``, joined through a
``FileStore`` in the test's temporary directory, and each runs a plan of
CLI invocations (``cli.main``, the verbs a user calls) in order, recording
their exit codes; runs compare the checkpoints they write at step 40.

A mesh run's checkpoint is the solo payload: the real bodies of the
gathered state, written by rank 0 while every rank waits at a barrier.
The allgather direct sum gives each row the same sum on any world (N is a
multiple of every world size, so no world pads), so:

- a run written on 2 ranks and preempted at step 20 resumes on 1 (a world
  of one), 2 and 4 ranks and solo (no mesh) to the uninterrupted run's
  bits on that world, which are the solo run's bits;
- a solo checkpoint and a world of one's resume on 2 ranks;
- ``--auto-recover`` on 2 ranks heals ``diverge@25`` and exits 0, with one
  recovery record, rank 0's.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from gravity_tpu_torch import cli
from gravity_tpu_torch.utils import faults
from gravity_tpu_torch.utils.checkpoint import (
    make_checkpoint_manager,
    restore_checkpoint,
)

SPAWN_TIMEOUT_S = 240
COMMON = ["--device", "cpu", "--model", "plummer", "--n", "256", "--eps",
          "1e9", "--integrator", "leapfrog", "--steps", "40",
          "--progress-every", "10", "--checkpoint-every", "10",
          "--force-backend", "dense"]
SHARDED = ["--sharding", "allgather"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _verb(root: str, verb: str, ckpt: str, *extra) -> list:
    return [verb, *COMMON, *extra, "--checkpoint-dir",
            os.path.join(root, ckpt), "--log-dir",
            os.path.join(root, "logs", ckpt)]


def _run_plan(plan: list, log) -> list:
    """Each (argv, fault plan) through ``cli.main``: the exit codes."""
    codes = []
    for argv, spec in plan:
        os.environ["GRAVITY_TPU_FAULTS"] = spec
        faults.reset()
        try:
            codes.append(cli.main(argv))
        except SystemExit as e:
            codes.append(int(e.code or 0))
        print(f"{argv[0]} {argv[-3]}: exit {codes[-1]}", file=log,
              flush=True)
    os.environ.pop("GRAVITY_TPU_FAULTS", None)
    faults.reset()
    return codes


def _rank_main(rank: int, world: int, out_dir: str, tag: str,
               plan: list) -> None:
    with open(os.path.join(out_dir, f"rank{tag}_{rank}.log"), "w") as log:
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(
                os.path.join(out_dir, f"store{tag}"), world),
            rank=rank, world_size=world)
        codes = _run_plan(plan, log)
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"codes{tag}_{rank}.json"), "w") as f:
        json.dump(codes, f)


def _spawn(out_dir: str, world: int, plan: list, tag: str) -> list:
    """Run ``plan`` on ``world`` spawned ranks: each rank's exit codes.
    ``tag`` names this spawn's store, logs and codes. A FileStore file
    that outlives its world keeps that world's rank addresses, which a
    later world on the same file would read and dial: every spawn takes
    a file of its own."""
    ctx = tmp.start_processes(_rank_main, args=(world, out_dir, tag, plan),
                              nprocs=world, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                logs = "\n".join(
                    open(p).read()[-2000:] for p in sorted(glob.glob(
                        os.path.join(out_dir, f"rank{tag}_*.log"))))
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{SPAWN_TIMEOUT_S} s:\n{logs}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [json.load(open(os.path.join(out_dir, f"codes{tag}_{r}.json")))
            for r in range(world)]


def _copy(root: str, src: str, dst: str) -> None:
    shutil.copytree(os.path.join(root, src), os.path.join(root, dst))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run's exit codes, by name; checkpoints under ``root``."""
    root = str(tmp_path_factory.mktemp("ckpt", numbered=True))
    codes = {}
    plan1 = [
        (_verb(root, "run", "solo"), ""),
        (_verb(root, "run", "solo_pre"), "preempt@20"),
        (_verb(root, "run", "mesh1", *SHARDED), ""),
        (_verb(root, "run", "mesh1_pre", *SHARDED), "preempt@20"),
    ]
    got = _spawn(root, 1, plan1, "w1")
    codes.update(zip(("solo", "solo_pre", "mesh1", "mesh1_pre"), got[0]))
    _copy(root, "solo_pre", "solo_pre_on2")
    _copy(root, "mesh1_pre", "mesh1_pre_on2")
    plan2 = [
        (_verb(root, "run", "mesh2", *SHARDED), ""),
        (_verb(root, "run", "mesh2_pre", *SHARDED), "preempt@20"),
    ]
    got = _spawn(root, 2, plan2, "w2_runs")
    codes.update({f"{k}@{r}": c for r, cs in enumerate(got)
                  for k, c in zip(("mesh2", "mesh2_pre"), cs)})
    for world in (1, 2, 4):
        _copy(root, "mesh2_pre", f"mesh2_pre_on{world}")
    _copy(root, "mesh2_pre", "mesh2_pre_solo")
    plan2 = [
        (_verb(root, "resume", "mesh2_pre_on2", *SHARDED), ""),
        (_verb(root, "resume", "solo_pre_on2", *SHARDED), ""),
        (_verb(root, "resume", "mesh1_pre_on2", *SHARDED), ""),
        (_verb(root, "run", "recover2", *SHARDED, "--auto-recover"),
         "diverge@25"),
    ]
    got = _spawn(root, 2, plan2, "w2_resumes")
    codes.update({f"{k}@{r}": c for r, cs in enumerate(got)
                  for k, c in zip(("resume_mesh2_on2", "resume_solo_on2",
                                   "resume_mesh1_on2", "recover2"), cs)})
    plan4 = [
        (_verb(root, "run", "mesh4", *SHARDED), ""),
        (_verb(root, "resume", "mesh2_pre_on4", *SHARDED), ""),
    ]
    got = _spawn(root, 4, plan4, "w4")
    codes.update({f"{k}@{r}": c for r, cs in enumerate(got)
                  for k, c in zip(("mesh4", "resume_mesh2_on4"), cs)})
    # Resumed in this process: on a world of one (no launcher) and solo.
    codes["resume_mesh2_on1"] = cli.main(
        _verb(root, "resume", "mesh2_pre_on1", *SHARDED))
    codes["resume_mesh2_solo"] = cli.main(
        _verb(root, "resume", "mesh2_pre_solo"))
    return root, codes


def _final(root: str, ckpt: str, step: int = 40):
    state, _ = restore_checkpoint(
        make_checkpoint_manager(os.path.join(root, ckpt)), step)
    return state


def _same(a, b) -> None:
    assert torch.equal(a.positions, b.positions)
    assert torch.equal(a.velocities, b.velocities)
    assert torch.equal(a.masses, b.masses)


def test_preempted_runs_exit_75_with_rank_0s_snapshot(runs):
    root, codes = runs
    assert codes["solo_pre"] == codes["mesh1_pre"] == 75
    assert codes["mesh2_pre@0"] == codes["mesh2_pre@1"] == 75
    assert make_checkpoint_manager(
        os.path.join(root, "mesh2_pre")).all_steps() == [10, 20]
    snap = _final(root, "mesh2_pre", 20)
    # The unpadded global payload a solo run writes.
    assert snap.positions.shape == (256, 3)
    _same(snap, _final(root, "solo", 20))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_a_two_rank_checkpoint_resumes_on_any_world(runs, world):
    root, codes = runs
    if world == 1:
        assert codes["resume_mesh2_on1"] == 0
    else:
        assert all(codes[f"resume_mesh2_on{world}@{r}"] == 0
                   for r in range(world))
    got = _final(root, f"mesh2_pre_on{world}")
    _same(got, _final(root, f"mesh{world}"))
    _same(got, _final(root, "solo"))


@pytest.mark.parametrize("written", ["solo", "mesh1"])
def test_solo_and_sharded_checkpoints_are_interchangeable(runs, written):
    root, codes = runs
    assert codes[f"resume_{written}_on2@0"] == 0
    _same(_final(root, f"{written}_pre_on2"), _final(root, "mesh2"))
    # And the other way: a two-rank checkpoint resumed solo.
    assert codes["resume_mesh2_solo"] == 0
    _same(_final(root, "mesh2_pre_solo"), _final(root, "solo"))


def test_auto_recover_on_two_ranks_heals_with_one_record(runs):
    root, codes = runs
    assert codes["recover2@0"] == codes["recover2@1"] == 0
    records = glob.glob(os.path.join(root, "logs", "recover2",
                                     "recovery_*.jsonl"))
    assert len(records) == 1
    kinds = [json.loads(line)["event"] for line in open(records[0])]
    assert "diverged" in kinds and "rolled_back" in kinds
    final = _final(root, "recover2")
    assert final.positions.shape == (256, 3)
    assert np.all(np.isfinite(final.positions.numpy()))
