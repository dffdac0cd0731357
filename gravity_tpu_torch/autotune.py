"""Measurement-driven backend autotuner: probe, persist, route.

Counterpart of ``gravity_tpu/autotune.py``. ``--force-backend auto``
means the measured-fastest eligible solver. On the first encounter of a
configuration key (the candidates, n, dtype, platform, device name, the
occupancy signature and the solver knobs) this module times every
eligible candidate on the Simulator's own step (one untimed step, then
:data:`PROBE_STEPS` timed behind the card's completion fence), audits its
forces against the plain direct sum on a sample, picks the fastest, and
keeps the verdict in an on-disk cache, so that every later run of the
same configuration routes at once: probe on a miss, instant on a hit.

Cache layout: one JSON file a key under :func:`tuning_dir` (default
``~/.cache/gravity_tpu_torch/tuning/``, apart from the JAX package's, so
that the two never overwrite each other's records; ``GRAVITY_TPU_TUNE_DIR``
overrides it), named by a SHA-256 of the canonical key. Each record
carries the torch, CUDA and nvcc versions and the digests of the kernel
sources that produced it: a record from other versions or other kernels
is a miss, and the next run probes again and overwrites it.

A candidate is skipped, with its reason recorded, only when its
Simulator refuses to be built: a ``ValueError`` raised while it is
constructed (``NotPortedError``, the config's and the cell list's sizing
refusals), before any of its steps runs. Whatever the candidate raises
once it runs propagates: a kernel's build or launch error (a
``RuntimeError`` from ``ops/cuda_build.py``, a wrapper's status check or
CUDA itself) and a wrapper's refusal of a launch (a ``ValueError`` of its
shape, contiguity or device checks) alike. The run fails rather than go
on by another route that would hide the kernel. This departs on purpose
from the JAX package, which skips a candidate on any exception.

On a ``torch.distributed`` world of several ranks (a sharded run) every
rank probes the same candidates, in the same order, since the sharded
candidates are collectives; rank 0 alone reads and writes the cache, and
its hit or its measured winner is broadcast, so that every rank builds
the same program. On a single-axis mesh the cell list's mesh strategy is
itself a contest: the composite candidates ``nlist@halo`` (the slab
decomposition, ``parallel/halo.py``) and ``nlist@allgather``.

The serve stack's admission routing (:func:`resolve_engine_backend`)
times its candidates through the same probe and cache, keyed on the
job's padded bucket. A probe's block rows in the perf ledger carry the
site ``autotune_probe``; its timed steps are never counted; the probe's
milliseconds go to the attached registry
(``perf.ledger().observe_probe``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .telemetry import perf as _perf
from .utils.platform import DeviceLike, resolve_device

# Timed steps a candidate, after one untimed step that also loads its
# kernel: the candidates differ by integer factors, not percent.
PROBE_STEPS = 2

# Below this n the fast solvers do not enter the candidate set: a cap on
# what probing costs, not a routing threshold. GRAVITY_TPU_AUTOTUNE_MIN_N
# overrides it (the tests lower it to probe at cheap sizes).
FAST_PROBE_MIN = 16_384


def fast_probe_min() -> int:
    try:
        return int(os.environ["GRAVITY_TPU_AUTOTUNE_MIN_N"])
    except (KeyError, ValueError):
        return FAST_PROBE_MIN


# Pair budget above which a direct-sum candidate is skipped rather than
# probed (n*(n-1) directed pairs an evaluation). CPU: the JAX package's,
# ~3.4e10 pairs, already ~10 s an evaluation on host cores. The card:
# 1 << 42 = 4.4e12 pairs (baseline-2m's 2,097,152 bodies just inside),
# about 2.4 s an evaluation at nbody_direct's 1.79e12 pairs/s (N = 65,536
# mask-free, 2.394 ms on an NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py,
# PERF.md section 6).
DIRECT_PROBE_PAIR_BUDGET = {"cpu": 1 << 35, "cuda": 1 << 42}

_mem_cache: dict[str, dict] = {}
_counters = {"probes": 0, "probe_steps": 0}


def tuning_dir() -> str:
    """The on-disk tuning cache directory; ``GRAVITY_TPU_TUNE_DIR``
    overrides the default."""
    return os.environ.get("GRAVITY_TPU_TUNE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "gravity_tpu_torch", "tuning"
    )


def probe_counters() -> dict:
    """Process-lifetime probe counters: ``probes`` (candidates timed) and
    ``probe_steps`` (timed steps run). A cache hit leaves both as they
    were."""
    return dict(_counters)


def versions() -> dict:
    """The facts that invalidate a tuning record: another torch, CUDA or
    nvcc, or another source of one of the candidates' kernels (the
    digest that also names its built library; the host-native C++ direct
    sum's too, the CPU's ``cpp`` member), can reorder the candidates."""
    from .ops import (
        cells,
        cuda_build,
        direct_kernel,
        host_kernel,
        mxu_kernel,
        nlist,
    )

    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": cuda_build.nvcc_version(),
            "kernels": {lib.name: lib.digest() for lib in (
                direct_kernel.LIBRARY, mxu_kernel.LIBRARY, nlist.LIBRARY,
                cells.LIBRARY, host_kernel.LIBRARY)}}


def _host_positions(positions) -> Optional[np.ndarray]:
    """Positions as a host float64 array, or None where there are none to
    read (None, the wrong rank, empty or not finite)."""
    if positions is None:
        return None
    if isinstance(positions, torch.Tensor):
        positions = positions.detach().cpu().double().numpy()
    pos = np.asarray(positions, dtype=np.float64)
    if pos.ndim != 2 or pos.shape[0] == 0 or not np.all(np.isfinite(pos)):
        return None
    return pos


def occupancy_signature(positions, side: int = 16) -> str:
    """Coarse clustering bucket for the cache key: the occupied share of a
    ``side``^3 grid over the bounding cube, rounded to a power of two, so
    that a clustered state and a uniform cube do not share a verdict but
    two seeds of one distribution do. ``"na"`` when the positions cannot
    be read."""
    pos = _host_positions(positions)
    if pos is None:
        return "na"
    lo = pos.min(axis=0)
    span = float(np.max(pos.max(axis=0) - lo)) or 1.0
    u = np.clip(
        ((pos - lo[None, :]) / span * side).astype(np.int64), 0, side - 1
    )
    ids = (u[:, 0] * side + u[:, 1]) * side + u[:, 2]
    occ = np.unique(ids).size / float(side**3)
    return f"occ2^{int(round(math.log2(max(occ, side ** -3.0))))}"


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _nlist_mesh_candidates(config) -> list:
    """The cell-list candidate(s) of this configuration: on a single-axis
    mesh of >= 2 devices the mesh strategy is itself measured, the
    composite ``nlist@halo`` / ``nlist@allgather`` (a pinned
    ``nlist_mesh`` keeps its own side); elsewhere the lone ``nlist``."""
    if config.sharding != "allgather":
        return ["nlist"]
    shape = tuple(config.mesh_shape or (_world_size(),))
    if len(shape) != 1 or shape[0] < 2:
        return ["nlist"]
    if config.nlist_mesh == "halo":
        return ["nlist@halo"]
    if config.nlist_mesh == "allgather":
        return ["nlist@allgather"]
    return ["nlist@halo", "nlist@allgather"]


def _candidate_config(config, backend: str):
    """The probe config of one candidate: a composite candidate
    (``nlist@halo``) carries its mesh strategy after the ``@``; a plain
    name is the force_backend."""
    if "@" in backend:
        base, strategy = backend.split("@", 1)
        return dataclasses.replace(config, force_backend=base,
                                   nlist_mesh=strategy)
    return dataclasses.replace(config, force_backend=backend)


def eligible_candidates(config, on_card: bool) -> tuple[tuple, dict]:
    """(candidates, skipped): the backends worth timing for this
    configuration, and why anything obvious was left out.

    - The exact direct sum contributes the static route's member
      (``simulation._resolve_direct``: ``pallas``, the ``nbody_direct``
      kernel, on the card; on the CPU ``dense``, and above 4,096 bodies
      ``cpp``, the host-native C++ row sum, where it builds) and, beside
      ``pallas`` on the card, the Gram form ``pallas-mxu``
      (``nbody_mxu``), as the JAX package adds the
      MXU form on a TPU; not for a float64 state, which the Gram form
      would compute in float32. A direct sum over the pair budget is
      skipped.
    - The fast solvers join from :func:`fast_probe_min` up: ``tree``,
      ``fmm`` (its layout by ``fmm_mode``) and ``sfmm``.
    - ``nlist_rcut`` > 0 declares truncated physics: the contest is the
      cell list (``nlist``, from the floor up; on a single-axis mesh
      :func:`_nlist_mesh_candidates`) against the rcut-masked direct sum,
      and the full-gravity fast solvers are left out.
    - The ring streams source shards and can assemble no global tree,
      grid or cell list: it leaves the fast solvers and the cell list
      out.
    """
    from .simulation import _resolve_direct

    skipped: dict[str, str] = {}
    budget = DIRECT_PROBE_PAIR_BUDGET["cuda" if on_card else "cpu"]
    pairs = config.n * (config.n - 1)
    cands: list[str] = []
    direct = _resolve_direct(config, on_card)
    if pairs <= budget:
        cands.append(direct)
        if direct == "pallas" and config.dtype != "float64":
            cands.append("pallas-mxu")
    else:
        skipped[direct] = (
            f"direct sum: {pairs:.3g} pairs/eval exceeds the "
            f"{budget:.3g} probe budget on this platform"
        )
    floor = fast_probe_min()
    if config.nlist_rcut > 0.0:
        skipped["tree/fmm/sfmm"] = (
            "nlist_rcut declares truncated short-range physics; the "
            "full-gravity fast solvers are not comparable"
        )
        if config.sharding == "ring":
            skipped["nlist"] = (
                "ring sharding streams sources and cannot build the "
                "global cell list"
            )
        elif config.n >= floor:
            cands += _nlist_mesh_candidates(config)
        else:
            skipped["nlist"] = (
                f"n={config.n} below the fast-probe floor {floor} (the "
                "masked direct sum is cheap there)"
            )
        return tuple(cands), skipped
    if config.sharding == "ring":
        skipped["tree/fmm/sfmm"] = (
            "ring sharding streams sources and cannot build a global "
            "tree/mesh"
        )
    elif config.n >= floor:
        cands += ["tree", "fmm", "sfmm"]
    else:
        skipped["tree/fmm/sfmm"] = (
            f"n={config.n} below the fast-probe floor {floor} (the direct "
            "sum is cheap there)"
        )
    return tuple(cands), skipped


def make_key(
    config, *, candidates, platform: str, device_kind: str, occupancy: str
) -> dict:
    """The canonical configuration key: everything whose change should
    re-open the question which backend is fastest here, the solver knobs
    included (a forced tree depth, FMM layout or cell-list sizing builds a
    materially different candidate), and the mesh's shape as it runs
    (``mesh_shape``, else the world's size, which a launcher sets anew each
    launch) and strategy."""
    mesh_shape = None
    if config.mesh_shape:
        mesh_shape = list(config.mesh_shape)
    elif config.sharding != "none":
        mesh_shape = [_world_size()]
    return {
        "candidates": list(candidates),
        "n": config.n,
        "dtype": config.dtype,
        "mesh_shape": mesh_shape,
        "strategy": config.sharding,
        "platform": platform,
        "device_kind": device_kind,
        "occupancy": occupancy,
        "knobs": {
            "tree_depth": config.tree_depth,
            "tree_leaf_cap": config.tree_leaf_cap,
            "tree_ws": config.tree_ws,
            "tree_far": config.tree_far,
            "tree_near": config.tree_near,
            "fmm_mode": config.fmm_mode,
            "chunk": config.chunk,
            "fast_chunk": config.fast_chunk,
            "cutoff": config.cutoff,
            "nlist_rcut": config.nlist_rcut,
            "nlist_side": config.nlist_side,
            "nlist_cap": config.nlist_cap,
            # The halo form's knobs, only off their defaults (the
            # composite candidates already key a mesh contest).
            **({"nlist_mesh": config.nlist_mesh}
               if config.nlist_mesh != "auto" else {}),
            **({"nlist_mig_cap": config.nlist_mig_cap}
               if config.nlist_mig_cap else {}),
        },
    }


def key_hash(key: dict) -> str:
    return hashlib.sha256(
        json.dumps(key, sort_keys=True).encode()
    ).hexdigest()[:20]


def _record_path(h: str) -> str:
    return os.path.join(tuning_dir(), f"{h}.json")


def _read_record_file(path: str, attempts: int = 3,
                      delay_s: float = 0.002) -> Optional[dict]:
    """Lock-free torn-read retry: writers replace a record atomically, but
    a cache directory that ever saw another writer can hand a reader a
    partial document. A parse failure is retried briefly; a document
    still torn after that is a miss (the probe overwrites it), never an
    exception into the run."""
    for i in range(attempts):
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            if i + 1 < attempts:
                time.sleep(delay_s)
    return None


def _load_record(h: str, key: dict) -> Optional[dict]:
    """A cached verdict, or None on a miss: a record from other versions,
    whose winner is no longer a candidate, or unreadable, is a miss."""
    rec = _mem_cache.get(h)
    if rec is None:
        rec = _read_record_file(_record_path(h))
        if rec is None:
            return None
    if not isinstance(rec, dict):
        return None
    if rec.get("versions") != versions():
        return None
    if rec.get("winner") not in key["candidates"]:
        return None
    _mem_cache[h] = rec
    return rec


def _store_record(h: str, rec: dict, stamp_ns: Optional[int] = None) -> None:
    """Fenced write: a record carries the time its probe started, and a
    writer that finds a record stamped after its own probe began yields
    to it, so that a slow prober does not overwrite a peer's fresher
    verdict. A read-only cache directory never fails the run."""
    rec = dict(rec, stamp_ns=int(stamp_ns or time.time_ns()))
    try:
        os.makedirs(tuning_dir(), exist_ok=True)
        path = _record_path(h)
        existing = _read_record_file(path, attempts=1)
        if (
            isinstance(existing, dict)
            and existing.get("versions") == versions()
            and int(existing.get("stamp_ns", 0) or 0) > rec["stamp_ns"]
        ):
            _mem_cache[h] = existing
            return
        _mem_cache[h] = rec
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(rec, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        _mem_cache[h] = rec


class AutotuneDecision(NamedTuple):
    backend: str
    # "hit" (cache), "miss" (probed and stored), "static" (no timeable
    # candidate: the static route), "off" (autotune off or not applicable:
    # ``backend`` is then the configured force_backend)
    cache: str
    probe_ms: float
    timings_s: dict
    skipped: dict
    key_hash: str
    # Each candidate's measured force error (median, p90 and max relative
    # error against the plain direct sum); empty for static and off.
    errors: Optional[dict] = None


def off(backend: str) -> AutotuneDecision:
    """The decision of a run that does not consult the router."""
    return AutotuneDecision(backend, "off", 0.0, {}, {}, "")


def _candidate_simulator(config, backend: str, state, device: DeviceLike):
    """One candidate's Simulator around the shared initial state. Its
    ``ValueError`` is the one refusal the probe records as a skip."""
    from .simulation import Simulator

    return Simulator(_candidate_config(config, backend), state=state,
                     device=device)


def _time_backend(sim, probe_steps: int) -> tuple[float, dict]:
    """(seconds a step, sampled force error) of one candidate's own step:
    one untimed step, then ``probe_steps`` steps between the card's
    completion fences. The error is its forces on the initial state
    against the plain (rcut-masked) direct sum at 128 sampled targets."""
    from .utils.profiling import debug_check_forces
    from .utils.timing import sync, warm_sync

    config = sim.config
    st = sim.state
    # The untimed step is the block's counted first call, labelled as a
    # probe's (JAX autotune.py:448); the timed steps run uncounted.
    with _perf.site("autotune_probe"):
        acc = sim.initial_carry(st)
        st, acc = sim.run_block(st, acc, n_steps=1)
    warm_sync(sim.device)
    with _perf.uncounted():
        t0 = time.perf_counter()
        for _ in range(probe_steps):
            st, acc = sim.run_block(st, acc, n_steps=1)
            _counters["probe_steps"] += 1
        sync(sim.device)
        per_step = (time.perf_counter() - t0) / max(1, probe_steps)
    # The whole state (gathered on a mesh), its force the run's own.
    probe_state = sim.global_state(sim.state)
    full = sim.global_self_accel(probe_state.positions, probe_state.masses)
    err = debug_check_forces(
        probe_state.positions, probe_state.masses,
        g=config.g, cutoff=config.cutoff, eps=config.eps,
        rcut=config.nlist_rcut, sample=128, full_acc=full,
    )
    return per_step, {
        k: err[k] for k in ("median_rel_err", "p90_rel_err", "max_rel_err")
    }


def resolve_backend_measured(
    config,
    state,
    *,
    device: DeviceLike = None,
    candidates: Optional[tuple] = None,
    occupancy: Optional[str] = None,
    probe_steps: int = PROBE_STEPS,
    refresh: bool = False,
) -> AutotuneDecision:
    """The measured-fastest backend for this configuration, by its
    force_backend name: from the cache when the key is known, by a probe
    of every eligible candidate when it is not.

    ``state`` is the run's initial state (or a zero-argument function
    that makes it, called only when a probe or the occupancy signature
    needs it): every candidate probes the same bodies. ``device``: the
    card unless the CPU is asked for. ``candidates`` and ``occupancy``
    override the derived values; ``refresh`` probes again on a hit. With
    no candidate left, the static route with ``cache="static"``."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    skipped: dict[str, str] = {}
    if candidates is None:
        candidates, skipped = eligible_candidates(config, on_card)
    if occupancy is None:
        if callable(state):
            state = state()
        occupancy = occupancy_signature(
            state.positions if state is not None else None
        )
    key = make_key(
        config, candidates=candidates,
        platform="cuda" if on_card else dev.type,
        device_kind=torch.cuda.get_device_name(dev) if on_card else "cpu",
        occupancy=occupancy,
    )
    h = key_hash(key)
    several = _world_size() > 1
    if not refresh:
        rec = _load_record(h, key) if not several or dist.get_rank() == 0 \
            else None
        if several:
            # Rank 0's hit or miss, so that every rank probes or none.
            rec = _broadcast(rec)
        if rec is not None:
            return AutotuneDecision(
                rec["winner"], "hit", 0.0,
                rec.get("timings_s", {}), rec.get("skipped", {}), h,
                rec.get("errors"),
            )

    def _static() -> str:
        from .simulation import _resolve_direct

        return _resolve_direct(config, on_card)

    if not candidates:
        return AutotuneDecision(_static(), "static", 0.0, {}, skipped, h)
    if len(candidates) == 1:
        # Nothing to choose between: the common small-n case stays free.
        return AutotuneDecision(candidates[0], "static", 0.0, {}, skipped, h)
    if callable(state):
        state = state()

    t0 = time.perf_counter()
    probe_started_ns = time.time_ns()  # the record's fencing stamp
    timings: dict[str, float] = {}
    errors: dict[str, dict] = {}
    for backend in candidates:
        try:
            sim = _candidate_simulator(config, backend, state, dev)
        except ValueError as e:  # NotPortedError, a sizing refusal
            skipped[backend] = f"{type(e).__name__}: {e}"
            continue
        timings[backend], errors[backend] = _time_backend(sim, probe_steps)
        _counters["probes"] += 1
    probe_ms = (time.perf_counter() - t0) * 1e3
    _perf.ledger().observe_probe(probe_ms)
    if not timings:
        return AutotuneDecision(_static(), "static", probe_ms, {}, skipped, h)
    winner = min(timings, key=timings.get)
    if several:
        winner = _broadcast(winner)
        if dist.get_rank() != 0:
            return AutotuneDecision(winner, "miss", probe_ms, timings,
                                    skipped, h, errors)
    _store_record(h, {
        "key": key,
        "winner": winner,
        "timings_s": timings,
        "errors": errors,
        "skipped": skipped,
        "probe_steps": probe_steps,
        "probe_ms": round(probe_ms, 3),
        "versions": versions(),
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }, stamp_ns=probe_started_ns)
    return AutotuneDecision(winner, "miss", probe_ms, timings, skipped, h,
                            errors)


def _broadcast(obj):
    """Rank 0's ``obj`` on every rank of the world."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def engine_candidates(on_card: bool, dtype: str = "float32") -> tuple:
    """The engine backends worth timing for a serve bucket: on the card
    the two kernels, ``pallas`` and ``pallas-mxu`` (``pallas`` alone for
    a float64 key, which the Gram form would compute in float32, as
    :func:`eligible_candidates` decides a solo run); on the CPU the plain
    batched ``dense`` form alone, so admission routing is free.
    Module-level so that tests can widen the set."""
    if not on_card:
        return ("dense",)
    return ("pallas",) if dtype == "float64" else ("pallas", "pallas-mxu")


def resolve_engine_backend(config, *, min_bucket: int = 16,
                           job_type: str = "integrate",
                           device: DeviceLike = None) -> AutotuneDecision:
    """Serve-admission routing: the measured-fastest engine backend for a
    job's padded bucket, by the JAX package's names. Jobs sharing a
    bucket share a verdict (keyed on the bucket with the ``"serve"``
    occupancy marker, as they share a batch). The probe runs here, at
    submit time, never inside a scheduling round; what it times is the
    solo kernel at the bucket size on the Simulator's own step, a proxy
    for the batched round (the slot count is not fixed at admission).
    A candidate's build or launch error propagates (this module's rule):
    admission fails rather than route around a kernel."""
    from .serve.engine import bucket_size
    from .simulation import make_initial_state

    dev = resolve_device(device)
    candidates = engine_candidates(dev.type == "cuda", config.dtype)
    if len(candidates) == 1:
        return AutotuneDecision(candidates[0], "static", 0.0, {}, {}, "")
    cfg = dataclasses.replace(
        config, n=bucket_size(config.n, min_bucket), force_backend="auto",
        integrator=(config.integrator if config.integrator in (
            "euler", "leapfrog", "verlet", "yoshida4") else "leapfrog"),
    )
    occupancy = "serve" if job_type == "integrate" else f"serve:{job_type}"
    decision = resolve_backend_measured(
        cfg, lambda: make_initial_state(cfg, dev), device=dev,
        candidates=candidates, occupancy=occupancy,
    )
    name = f"bucket={cfg.n},dtype={cfg.dtype}"
    if decision.cache == "miss" or name not in _engine_verdicts:
        _engine_verdicts[name] = {
            "backend": decision.backend, "cache": decision.cache,
            "probe_ms": round(decision.probe_ms, 3),
            "timings_s": decision.timings_s,
        }
    return decision


# The admission verdict of each (bucket, dtype) in this process: its
# probe (a miss) when this process made one, else its first hit.
_engine_verdicts: dict[str, dict] = {}


def engine_verdicts() -> dict:
    """The serve admission router's verdict of each bucket and dtype in
    this process: backend, cache (miss/hit), probe ms and the timings,
    as a daemon's /metrics shows them."""
    return {k: dict(v) for k, v in _engine_verdicts.items()}
