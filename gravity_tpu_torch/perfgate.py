"""Noise-robust performance regression gate.

Counterpart of ``gravity_tpu/perfgate.py``, behind ``bench --gate``. It
reads the committed ``PERF_BASELINE.json`` as it is written and checks
each contract on the card (``--device cpu`` asks for the CPU). Every
contract gates on a quantity that a slow window cannot move:

- **paired ratios** (``paired_ratio_min``): both arms run interleaved in
  one process (A, B, A, B, ...), each rep gives one A/B time ratio, and
  the gate checks the bootstrap confidence interval of the median ratio;
- **scaling exponents** (``scaling_exponent_max``): log(t_large /
  t_small) / log(n_large / n_small) from the same paired structure;
- **fractions** (``frac_max``): the pipelined cadence run's
  ``host_gap_frac``, a ratio of one run's wall clock;
- **counts** (``count_max``): builds a serve key (``EnsembleEngine.
  compile_counts``);
- **ledger coverage** (``ledger_coverage``): every named family has a
  perf-ledger row with counted flops, bytes, peak bytes and a finite
  ``model_ratio`` (``InstrumentedBlock`` for the solo families, the
  engine's first round for ``serve``).

The timing arms are the port's own ``nlist_accelerations`` and
``pairwise_accelerations_chunked`` on a seeded uniform cube on the run's
device, each fenced by ``utils/timing.sync``; the perf counter is off in
every arm. ``mesh_paired_ratio_min`` (the halo exchange against the
allgather, :func:`run_mesh_paired_ratio`) runs, as the JAX package's
runs on a virtual CPU mesh in a subprocess, on ``devices`` gloo ranks of
the CPU spawned for it and joined by a ``FileStore`` in a temporary
directory (no TCP port), whatever device the rest of the gate runs on.

``GRAVITY_TPU_PERF_HANDICAP`` (JSON ``{"contract": name or "*", "arm":
"a"|"b"|"both", "factor": F}``) multiplies the named arm's measured
values: the planted regression of the tests and ``chip_smoke.py``. A
handicapped run never writes its report. The report goes to
``PERF_GATE_LAST_TORCH.json`` by default, never to the JAX package's
``PERF_GATE_LAST.json``.

    python -m gravity_tpu_torch bench --gate [--gate-baseline F]
        [--gate-contracts a,b] [--device cpu]
    python -m gravity_tpu_torch.perfgate [--baseline F] [--contracts a,b]
        [--out PATH] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import random
import statistics
import time
from typing import Callable, Optional

from .utils.platform import DeviceLike, resolve_device

BASELINE_FILE = "PERF_BASELINE.json"
REPORT_FILE = "PERF_GATE_LAST_TORCH.json"

BOOTSTRAP_RESAMPLES = 1000
CI_LO, CI_HI = 2.5, 97.5


def _handicap() -> Optional[dict]:
    raw = os.environ.get("GRAVITY_TPU_PERF_HANDICAP")
    if not raw:
        return None
    try:
        doc = json.loads(raw)
    except ValueError:
        return None
    if not isinstance(doc, dict) or "factor" not in doc:
        return None
    return doc


def apply_handicap(contract: str, arm: str, value: float,
                   both_applies: bool = True) -> float:
    """Scale one arm's measured value by the injected handicap (no-op
    without it). ``arm`` is "a"/"b" for paired contracts, "a" for
    single-armed ones. A single-armed RATIO passes ``both_applies=False``:
    a "both"-arm handicap models a slow window, which leaves a fraction
    unchanged. Count contracts take no handicap."""
    h = _handicap()
    if h is None or h.get("contract") not in ("*", contract):
        return value
    wanted = h.get("arm", "both")
    if wanted == "both" and not both_applies:
        return value
    if wanted not in (arm, "both"):
        return value
    return value * float(h["factor"])


def bootstrap_ci(samples: list, lo: float = CI_LO, hi: float = CI_HI,
                 resamples: int = BOOTSTRAP_RESAMPLES) -> tuple:
    """Percentile bootstrap CI of the median (seeded: a gate is
    reproducible for a given set of measurements)."""
    rng = random.Random(0)
    meds = sorted(statistics.median(rng.choice(samples) for _ in samples)
                  for _ in range(resamples))

    def pct(p):
        return meds[min(len(meds) - 1, max(0, int(p / 100.0 * len(meds))))]

    return pct(lo), pct(hi)


@dataclasses.dataclass
class ContractResult:
    name: str
    kind: str
    ok: bool
    measured: Optional[float]
    bound: Optional[float]
    ci: Optional[tuple]
    detail: dict

    def to_json(self) -> dict:
        return {"name": self.name, "kind": self.kind, "ok": self.ok,
                "measured": self.measured, "bound": self.bound,
                "ci": list(self.ci) if self.ci else None,
                "detail": self.detail}


# --- measurement arms -------------------------------------------------
#
# The committed evidence's workload (benchmarks/nlist_sweep.py --scaling):
# a uniform unit-density cube, rcut = ``rcut_spacings`` mean
# inter-particle spacings (~65 neighbours at 2.5).


def _uniform_state(n: int, seed: int = 0, device: DeviceLike = None):
    """(positions (n, 3), masses (n,)) fp32 on ``device``: a cube of side
    n^(1/3) (unit density) and masses in [0.5, 1.5), from a seeded
    ``torch.Generator`` on the device."""
    import torch

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    span = float(n) ** (1.0 / 3.0)
    pos = torch.rand((n, 3), generator=gen, device=dev) * span
    m = torch.rand((n,), generator=gen, device=dev) + 0.5
    return pos, m


def _pair_arm(backend: str, n: int, rcut_spacings: float, eps: float,
              device: DeviceLike = None):
    """A zero-arg callable returning seconds per force evaluation of
    ``backend`` (nlist | chunked, rcut-masked) on the unit-density cube,
    warmed (kernel built, first launch done) before the first timed call."""
    from functools import partial

    from .ops.forces import pairwise_accelerations_chunked
    from .ops.nlist import nlist_accelerations, resolve_nlist_sizing
    from .utils.timing import sync, warm_sync

    dev = resolve_device(device)
    pos, m = _uniform_state(n, device=dev)
    rcut = float(rcut_spacings)
    if backend == "nlist":
        side, cap = resolve_nlist_sizing(pos, rcut)
        fn = partial(nlist_accelerations, rcut=rcut, side=side, cap=cap,
                     g=1.0, eps=eps)
    elif backend == "chunked":
        fn = partial(pairwise_accelerations_chunked, g=1.0, eps=eps,
                     rcut=rcut, chunk=min(1024, n))
    else:
        raise ValueError(f"no gate arm for backend {backend!r}")
    fn(pos, m)
    warm_sync(dev)

    def timed() -> float:
        t0 = time.perf_counter()
        fn(pos, m)
        sync(dev)
        return time.perf_counter() - t0

    return timed


def run_paired_ratio(contract: dict, log: Callable,
                     device: DeviceLike = None) -> ContractResult:
    """min-ratio contract: arm "a" (the reference, the masked chunked
    direct sum) over arm "b" (the contender, nlist), interleaved reps; the
    bootstrap CI of the median t_a / t_b must stay >= min_ratio."""
    p = contract.get("params", {})
    n = int(p.get("n", 8192))
    reps = int(p.get("reps", 5))
    spacings = float(p.get("rcut_spacings", 2.5))
    eps = float(p.get("eps", 0.05))
    backend_a = p.get("backend_a", "chunked")
    backend_b = p.get("backend_b", "nlist")
    arm_a = _pair_arm(backend_a, n, spacings, eps, device)
    arm_b = _pair_arm(backend_b, n, spacings, eps, device)
    ratios = []
    for _ in range(reps):
        t_a = apply_handicap(contract["name"], "a", arm_a())
        t_b = apply_handicap(contract["name"], "b", arm_b())
        ratios.append(t_a / max(t_b, 1e-12))
    med = statistics.median(ratios)
    ci = bootstrap_ci(ratios)
    bound = float(contract["min_ratio"])
    log(f"  {contract['name']}: median {backend_a}/{backend_b} ratio "
        f"{med:.2f} (CI [{ci[0]:.2f}, {ci[1]:.2f}]) vs min {bound}")
    return ContractResult(
        contract["name"], "paired_ratio_min", ci[0] >= bound, med, bound,
        ci, {"ratios": [round(r, 4) for r in ratios], "n": n,
             "backend_a": backend_a, "backend_b": backend_b})


def run_scaling_exponent(contract: dict, log: Callable,
                         device: DeviceLike = None) -> ContractResult:
    """max-exponent contract: one backend timed at two sizes (at fixed
    density) in interleaved pairs; the per-pair exponent's bootstrap CI
    must stay below max_exponent (2.0 is quadratic)."""
    p = contract.get("params", {})
    n_s = int(p.get("n_small", 4096))
    n_l = int(p.get("n_large", 16384))
    reps = int(p.get("reps", 5))
    backend = p.get("backend", "nlist")
    spacings = float(p.get("rcut_spacings", 2.5))
    eps = float(p.get("eps", 0.05))
    arm_s = _pair_arm(backend, n_s, spacings, eps, device)
    arm_l = _pair_arm(backend, n_l, spacings, eps, device)
    span = math.log(n_l / n_s)
    exps = []
    for _ in range(reps):
        t_s = apply_handicap(contract["name"], "a", arm_s())
        t_l = apply_handicap(contract["name"], "b", arm_l())
        exps.append(math.log(max(t_l, 1e-12) / max(t_s, 1e-12)) / span)
    med = statistics.median(exps)
    ci = bootstrap_ci(exps)
    bound = float(contract["max_exponent"])
    log(f"  {contract['name']}: {backend} scaling exponent {med:.2f} "
        f"(CI [{ci[0]:.2f}, {ci[1]:.2f}]) over n={n_s}->{n_l} vs max "
        f"{bound}")
    return ContractResult(
        contract["name"], "scaling_exponent_max", ci[1] <= bound, med,
        bound, ci, {"exponents": [round(e, 4) for e in exps],
                    "n_small": n_s, "n_large": n_l, "backend": backend})


def run_frac_max(contract: dict, log: Callable,
                 device: DeviceLike = None) -> ContractResult:
    """max-fraction contract: the pipelined cadence run's host_gap_frac
    (a within-run ratio), median over reps."""
    from .bench import run_cadence_benchmark
    from .config import SimulationConfig
    from .telemetry import perf

    p = contract.get("params", {})
    n = int(p.get("n", 512))
    steps = int(p.get("steps", 200))
    reps = int(p.get("reps", 2))
    fracs = []
    for _ in range(reps):
        cfg = SimulationConfig(
            model="plummer", n=n, steps=steps, dt=3600.0, eps=1e9,
            integrator="leapfrog", force_backend="dense", dtype="float32",
            record_trajectories=True, trajectory_every=1,
            progress_every=int(p.get("block", 25)),
            checkpoint_every=int(p.get("ckpt_every", 100)),
            io_pipeline="on")
        with perf.uncounted():
            stats = run_cadence_benchmark(cfg, device=device)
        frac = stats.get("host_gap_frac")
        if frac is None:
            continue
        fracs.append(apply_handicap(contract["name"], "a", frac,
                                    both_applies=False))
    bound = float(contract["max_frac"])
    if not fracs:
        return ContractResult(contract["name"], "frac_max", False, None,
                              bound, None,
                              {"error": "no host_gap_frac measured"})
    med = statistics.median(fracs)
    log(f"  {contract['name']}: median host_gap_frac {med:.3f} over "
        f"{len(fracs)} pipelined runs vs max {bound}")
    return ContractResult(
        contract["name"], "frac_max", med <= bound, med, bound, None,
        {"fracs": [round(f, 4) for f in fracs], "n": n, "steps": steps})


def run_count_max(contract: dict, log: Callable,
                  device: DeviceLike = None) -> ContractResult:
    """max-count contract: two same-bucket jobs through an in-process
    scheduler build each BatchKey exactly once."""
    from .config import SimulationConfig
    from .serve.scheduler import EnsembleScheduler

    p = contract.get("params", {})
    n = int(p.get("n", 12))
    steps = int(p.get("steps", 30))
    with EnsembleScheduler(slots=2, slice_steps=int(p.get("slice_steps", 10)),
                           device=device) as sched:
        for seed in (1, 2):
            sched.submit(SimulationConfig(
                model="random", n=n, steps=steps, dt=3600.0,
                integrator="leapfrog", force_backend="dense", seed=seed))
        sched.run_until_idle()
        statuses = {j.id: j.status for j in sched.jobs.values()}
        counts = dict(sched.engine.compile_counts)
    bound = float(contract["max_count"])
    if not counts or any(s != "completed" for s in statuses.values()):
        return ContractResult(
            contract["name"], "count_max", False, None, bound, None,
            {"statuses": statuses, "error": "jobs did not complete"})
    worst = float(max(counts.values()))
    log(f"  {contract['name']}: max builds per BatchKey {worst:g} over "
        f"{len(counts)} keys vs max {bound:g}")
    return ContractResult(contract["name"], "count_max", worst <= bound,
                          worst, bound, None, {"keys": len(counts)})


def run_ledger_coverage(contract: dict, log: Callable,
                        device: DeviceLike = None) -> ContractResult:
    """Every named family produces a perf-ledger row with counted flops,
    bytes, peak bytes and a FINITE model_ratio."""
    from .telemetry import perf

    p = contract.get("params", {})
    n = int(p.get("n", 256))
    families = p.get("families", ["dense", "chunked", "pallas", "nlist",
                                  "tree", "sfmm", "serve"])
    missing: dict = {}
    rows: dict = {}
    for fam in families:
        try:
            row = (_serve_ledger_row(n, device) if fam == "serve"
                   else _solo_ledger_row(fam, n, device))
        except Exception as e:  # noqa: BLE001 — a family that cannot
            missing[fam] = f"{type(e).__name__}: {e}"  # run is a finding,
            continue  # reported as this contract's violation
        probs = []
        if row is None:
            probs.append("no ledger row")
        else:
            rows[fam] = {k: row.get(k) for k in (
                "flops", "bytes_accessed", "peak_bytes", "model_ratio",
                "flops_source", "peak_source")}
            for field in ("flops", "bytes_accessed", "peak_bytes"):
                if row.get(field) is None:
                    probs.append(f"missing {field}")
            if not perf.finite(row.get("model_ratio")):
                probs.append(f"model_ratio {row.get('model_ratio')!r} not "
                             "finite")
        if probs:
            missing[fam] = "; ".join(probs)
    log(f"  {contract['name']}: {len(families) - len(missing)}/"
        f"{len(families)} families ledgered"
        + (f" (missing: {missing})" if missing else ""))
    return ContractResult(
        contract["name"], "ledger_coverage", not missing,
        float(len(families) - len(missing)), float(len(families)), None,
        {"families": families, "missing": missing, "rows": rows})


def _solo_ledger_row(backend: str, n: int, device: DeviceLike = None):
    """One solo family's block through the real Simulator: its first
    call's perf-ledger row."""
    from .config import SimulationConfig
    from .simulation import Simulator, make_initial_state
    from .telemetry import perf

    kw: dict = {}
    if backend == "nlist":
        # A state-derived truncation radius (a fifth of the bounding
        # cube): the model's units are astronomical.
        probe = SimulationConfig(model="random", n=n, dt=3600.0,
                                 integrator="leapfrog", force_backend="dense")
        pos = make_initial_state(probe, "cpu").positions
        kw["nlist_rcut"] = float(
            (pos.max(dim=0).values - pos.min(dim=0).values).max()) * 0.2
    cfg = SimulationConfig(model="random", n=n, steps=4, dt=3600.0,
                           integrator="leapfrog", force_backend=backend,
                           dtype="float32", **kw)
    sim = Simulator(cfg, device=device)
    st = sim.state
    sim.run_block(st, sim.initial_carry(st), n_steps=1)
    return perf.ledger().row_for(sim._run_block.key)


def _serve_ledger_row(n: int, device: DeviceLike = None):
    """One serve key's first round through the engine; its ledger row."""
    from .config import SimulationConfig
    from .serve.engine import EnsembleEngine, batch_key_for
    from .simulation import make_initial_state
    from .telemetry import perf

    cfg = SimulationConfig(model="random", n=min(n, 64), steps=4, dt=3600.0,
                           integrator="leapfrog", force_backend="dense")
    engine = EnsembleEngine(device)
    key = batch_key_for(cfg, slots=2, device=engine.device)
    batch = engine.new_batch(key)
    batch = engine.load_slot(batch, 0, make_initial_state(cfg, engine.device),
                             dt=cfg.dt, steps=4)
    engine.run_slice(batch, 4)
    return perf.ledger().row_for(perf.engine_key_str(key))


def mesh_ab_pairs(params: dict, mesh) -> dict:
    """Interleaved (t_allgather, t_halo) second-pairs of the sharded cell
    list on ``mesh``, one rank of a world of ``devices``: both arms at the
    same halo sizing (side, cap) and the same rows, differing only in the
    exchange (every remote position gathered against one ghost plane each
    way). An arm's time is the slowest rank's (an ``all_reduce`` MAX), as
    the evaluation ends when its last rank does."""
    import torch
    import torch.distributed as dist

    from .ops.nlist import make_nlist_local_kernel
    from .parallel import (
        make_halo_nlist_accel,
        make_sharded_accel2,
        resolve_halo_sizing,
    )
    from .parallel.mesh import all_gather_rows

    devices = mesh.size
    n = int(params.get("n_per_device", 2048)) * devices
    reps = int(params.get("reps", 5))
    rcut = float(params.get("rcut_spacings", 2.5))  # unit density
    eps = float(params.get("eps", 0.05))
    pos, m = _uniform_state(n, device="cpu")
    side, cap = resolve_halo_sizing(pos, rcut, devices=devices)
    rows = mesh.rows(n)
    pos_l, m_l = pos[rows].contiguous(), m[rows].contiguous()
    halo = make_halo_nlist_accel(mesh, side=side, cap=cap, rcut=rcut, g=1.0,
                                 eps=eps)
    allgather = make_sharded_accel2(
        mesh, strategy="allgather", local_kernel=make_nlist_local_kernel(
            rcut=rcut, side=side, cap=cap, g=1.0, eps=eps))

    def timed(fn) -> float:
        dist.barrier()
        t0 = time.perf_counter()
        acc = fn(pos_l, m_l)
        t = torch.tensor([time.perf_counter() - t0], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t[0]), acc

    _, a_ref = timed(allgather)
    _, a_halo = timed(halo)
    # The two arms compute one force: the worst row gap over mean |a|.
    gap = all_gather_rows((a_halo - a_ref).abs().max(dim=1).values)
    scale = all_gather_rows(a_ref.norm(dim=1))
    pairs = []
    for _ in range(reps):
        t_a, _ = timed(allgather)
        t_b, _ = timed(halo)
        pairs.append([t_a, t_b])
    return {"pairs": pairs, "n": n, "devices": devices, "side": side,
            "cap": cap, "max_gap_over_mean_a": float(gap.max()
                                                     / scale.mean())}


def _mesh_ab_rank(rank: int, devices: int, workdir: str,
                  params: dict) -> None:
    """One gloo rank of the gate's mesh worker; rank 0 writes the pairs to
    ``workdir/pairs.json``."""
    import torch
    import torch.distributed as dist

    from .parallel import make_particle_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"),
                                     devices),
        rank=rank, world_size=devices)
    try:
        doc = mesh_ab_pairs(params, make_particle_mesh((devices,),
                                                       device="cpu"))
        if rank == 0:
            with open(os.path.join(workdir, "pairs.json"), "w") as f:
                json.dump(doc, f)
    finally:
        dist.destroy_process_group()


def _spawn_mesh_worker(params: dict) -> dict:
    """Run :func:`mesh_ab_pairs` on ``devices`` spawned gloo ranks of the
    CPU within ``worker_timeout`` seconds; returns rank 0's document.
    Raises ``RuntimeError`` when a rank fails or the time runs out."""
    import tempfile

    import torch.multiprocessing as tmp

    devices = int(params.get("devices", 8))
    timeout = float(params.get("worker_timeout", 600))
    with tempfile.TemporaryDirectory() as workdir:
        ctx = tmp.start_processes(_mesh_ab_rank,
                                  args=(devices, workdir, params),
                                  nprocs=devices, join=False,
                                  start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"mesh worker: {devices} ranks still running after "
                        f"{timeout:g} s")
        except tmp.ProcessRaisedException as e:
            raise RuntimeError(f"mesh worker rank failed: {e}") from e
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=10)
        with open(os.path.join(workdir, "pairs.json")) as f:
            return json.load(f)


def run_mesh_paired_ratio(contract: dict, log: Callable,
                          device: DeviceLike = None) -> ContractResult:
    """min-ratio contract of the halo exchange: arm "a" the allgather
    sharded cell list, arm "b" the halo form, interleaved pairs measured
    on ``devices`` gloo ranks of the CPU (:func:`_spawn_mesh_worker`;
    ``device`` is not read). The handicap is applied here in the parent,
    a pair at a time; the workers never see it. A worker that fails is
    reported violated with its error."""
    del device
    p = contract.get("params", {})
    bound = float(contract["min_ratio"])
    try:
        doc = _spawn_mesh_worker(p)
    except (RuntimeError, OSError, ValueError) as e:
        log(f"  {contract['name']}: mesh worker FAILED: {e}")
        return ContractResult(
            contract["name"], "mesh_paired_ratio_min", False, None, bound,
            None, {"error": f"worker_failed: {e}"})
    ratios = []
    for t_a, t_b in doc["pairs"]:
        t_a = apply_handicap(contract["name"], "a", t_a)
        t_b = apply_handicap(contract["name"], "b", t_b)
        ratios.append(t_a / max(t_b, 1e-12))
    med = statistics.median(ratios)
    ci = bootstrap_ci(ratios)
    ok = ci[0] >= bound
    log(f"  {contract['name']}: median allgather/halo ratio {med:.2f} "
        f"(CI [{ci[0]:.2f}, {ci[1]:.2f}]) vs min {bound} [n={doc['n']}, "
        f"{doc['devices']} gloo ranks, side={doc['side']}]")
    return ContractResult(
        contract["name"], "mesh_paired_ratio_min", ok, med, bound, ci,
        {"ratios": [round(r, 4) for r in ratios], "n": doc["n"],
         "devices": doc["devices"], "side": doc["side"], "cap": doc["cap"],
         "pairs_s": doc["pairs"], "platform": "cpu-gloo",
         "max_gap_over_mean_a": doc["max_gap_over_mean_a"]})


KIND_RUNNERS = {
    "paired_ratio_min": run_paired_ratio,
    "scaling_exponent_max": run_scaling_exponent,
    "frac_max": run_frac_max,
    "count_max": run_count_max,
    "ledger_coverage": run_ledger_coverage,
    "mesh_paired_ratio_min": run_mesh_paired_ratio,
}


def load_baseline(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not isinstance(doc.get("contracts"),
                                                   list):
        raise ValueError(
            f"{path}: baseline must be {{'v': 1, 'contracts': [...]}}")
    for c in doc["contracts"]:
        if c.get("kind") not in KIND_RUNNERS:
            raise ValueError(
                f"{path}: contract {c.get('name')!r} has unknown kind "
                f"{c.get('kind')!r} (one of {sorted(KIND_RUNNERS)})")
    return doc


def run_gate(baseline_path: str = BASELINE_FILE, *,
             contracts: Optional[list] = None,
             report_path: Optional[str] = REPORT_FILE,
             log: Callable = print,
             device: DeviceLike = None) -> tuple[int, dict]:
    """Run the gate on ``device`` (the card unless the CPU is asked for);
    returns (exit code, report). Exit 1 names the baseline file and every
    violated contract."""
    doc = load_baseline(baseline_path)
    selected = doc["contracts"]
    if contracts:
        wanted = set(contracts)
        selected = [c for c in selected if c["name"] in wanted]
        unknown = wanted - {c["name"] for c in selected}
        if unknown:
            raise ValueError(
                f"unknown contract(s) {sorted(unknown)}; baseline has "
                f"{[c['name'] for c in doc['contracts']]}")
    dev = resolve_device(device)
    log(f"== perf gate: {len(selected)} contract(s) from {baseline_path} "
        f"on {dev} ==")
    results = [KIND_RUNNERS[c["kind"]](c, log, dev) for c in selected]
    ok = all(r.ok for r in results)
    report = {
        "v": 1, "baseline": baseline_path, "ok": ok, "device": str(dev),
        "ran_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "handicap": _handicap(),
        "results": [r.to_json() for r in results],
    }
    if report_path and _handicap() is not None:
        # A handicapped run is a test injection, not a gate record.
        log(f"perf gate: handicap active — not writing {report_path}")
        report_path = None
    if report_path:
        try:
            from .utils.hostio import atomic_write_json

            atomic_write_json(report_path, report, fault_injection=False)
        except OSError:
            pass  # a read-only tree still gates; only the artifact is lost
    for r in results:
        if not r.ok:
            log(f"{baseline_path}: contract '{r.name}' VIOLATED: measured "
                f"{r.measured}" + (f" (CI {list(r.ci)})" if r.ci else "")
                + f" vs bound {r.bound} [{r.kind}]")
    if ok:
        log("perf gate: all contracts hold")
    return (0 if ok else 1), report


def main(argv: Optional[list] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="noise-robust perf regression gate")
    ap.add_argument("--baseline", default=BASELINE_FILE)
    ap.add_argument("--contracts", default=None,
                    help="comma-separated contract names (default all)")
    ap.add_argument("--out", default=REPORT_FILE,
                    help="report artifact path ('' disables)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "on the CPU)")
    args = ap.parse_args(argv)
    code, _ = run_gate(
        args.baseline,
        contracts=([c for c in args.contracts.split(",") if c]
                   if args.contracts else None),
        report_path=args.out or None, device=args.device)
    return code


if __name__ == "__main__":
    raise SystemExit(main())
