"""The ``sharded-integrate`` job class: one big-n job across the devices of
a ``torch.distributed`` group, under the same lease, adoption, breaker
and round-accounting contracts as every other traffic class.

Counterpart of ``gravity_tpu/serve/jobs/sharded.py``. The vmap ensemble
engine stops at ``MAX_BUCKET``; above it a job should not share a bucket
with anyone, it should BE the bucket. This class keys every job into an
exclusive single-slot batch (``slots=1``) whose force shards the particle
axis: the allgather or ring direct sum over a local kernel
(``parallel/sharded.py``), or the cell list's halo slab engine
(``parallel/halo.py``), the programs ``run`` uses on a world.

The mesh of a key. The daemon stays one process that handles HTTP and the
scheduler. A key with D >= 2 devices runs on a :class:`ShardedGroup`: D
worker processes, one a card (gloo ranks with ``--device cpu``), joined in
a world of their own through a ``FileStore`` in a temporary directory.
The group is built at slot load (the JAX package's ``_mesh_for``) and
cached for the key; fewer visible cards than D, or an injected
``mesh_fail``, raise :class:`~gravity_tpu_torch.utils.faults.
BackendUnavailable` there. A slice sends (dt, steps) to the group and
receives the finite flag (the round's one host read) and the round's
launches; the slot snapshot gathers the state to rank 0, which ships it
to the daemon. A group whose reply does not come within its watchdog (an
injected ``collective_stall`` holds rank 0 back past it), or whose
process dies, is torn down and raises ``BackendUnavailable``; the breaker
and the requeue then re-key the job one rung down the elastic ladder
(``supervisor.next_rung``): ``sharded/D/local -> sharded/D//2/local ->
... -> local`` (the solo form, run in the daemon's process), then the
exact-physics ladder with the port's on-card rule. A resumed job starts
from its last progress snapshot, not from step 0.

A worker process per rank, rather than the daemon as rank 0 of a
launcher's world: one daemon serves keys of different D (each its own
group, each torn down alone), and a hung or dead group cannot take the
daemon's HTTP thread with it.

The solo form's force is the solo Simulator's own self-gravity call, so a
``sharded/1`` job follows the solo run of its padded state bit for bit;
on a group the allgather sum gives each row the solo row's sum (on the
card the kernel's launch plan follows the rows a rank holds).
"""

from __future__ import annotations

import dataclasses
import functools
import multiprocessing
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from ...state import ParticleState
from ...utils.faults import (
    BackendUnavailable,
    collective_stall_secs,
    mesh_fail_due,
)
from .registry import (
    JobClass,
    JobValidationError,
    register,
    validate_params_state,
)

# Local kernels the sharded form runs per shard (each speaks the
# rectangular (targets, sources, m_sources) signature the strategies
# feed). 'auto'/'direct' resolve at keying time. 'nlist' is the truncated
# cell list: its rungs stay rcut-masked to the chunked floor.
SHARDED_LOCAL_BACKENDS = ("dense", "chunked", "pallas", "pallas-mxu",
                          "nlist")

# 'halo' is the domain-decomposed cell list (parallel/halo.py), nlist
# only; a rung whose world no longer divides the cell grid falls back to
# allgather with the same nlist local kernel.
STRATEGIES = ("allgather", "ring", "halo")

# Where 'auto' flips the local kernel from the one-shot dense sum to the
# chunked form (the engine's MAX_BUCKET reasoning applied a shard).
AUTO_DENSE_MAX = 8192

# Seconds a group may take to start or to answer a command before it is
# torn down as stalled (a first slice may build kernels in each worker).
GROUP_TIMEOUT_S = 600.0


def sharded_backend_name(devices: int, local: str) -> str:
    return f"sharded/{devices}/{local}" if devices > 1 else local


def parse_backend(backend: str) -> tuple:
    """(devices, local kernel) of any sharded-class backend string; a bare
    local name is the solo form (devices 1)."""
    from ...supervisor import parse_sharded_backend

    devices, local = parse_sharded_backend(backend)
    if devices is None:
        return 1, backend
    return devices, local


def _key_config(key, local: str):
    """The physics of a key as a config at its bucket; the nlist knobs
    ride every rung, so the dense/chunked floor masks at rcut too."""
    from ...config import SimulationConfig

    extra = dict(key.extra)
    return SimulationConfig(
        n=key.bucket_n, force_backend=local, dtype=key.dtype, g=key.g,
        eps=key.eps, cutoff=key.cutoff,
        nlist_rcut=float(extra.get("nlist_rcut", 0.0)),
        nlist_side=int(extra.get("nlist_side", 0)),
        nlist_cap=int(extra.get("nlist_cap", 0)))


def _solo_accel(cfg, local: str):
    """``(positions, masses) -> acc`` of the solo form: the calls of the
    solo Simulator's self-gravity (``Simulator._self_accel``) for the
    local backends, so that a solo-form job has the solo run's bits."""
    from ...ops import nlist
    from ...ops.direct_kernel import accelerations_vs_kernel
    from ...ops.forces import accelerations_vs, pairwise_accelerations_chunked
    from ...ops.mxu_kernel import accelerations_vs_mxu_kernel
    from ...simulation import _resolve_nlist_config

    common = dict(g=cfg.g, cutoff=cfg.cutoff, eps=cfg.eps)
    if local == "pallas":
        return lambda p, m: accelerations_vs_kernel(p, p, m, **common)
    if local == "pallas-mxu":
        return lambda p, m: accelerations_vs_mxu_kernel(p, p, m, **common)
    if local == "nlist":
        side, cap = _resolve_nlist_config(cfg, None)
        return functools.partial(nlist.nlist_accelerations,
                                 rcut=cfg.nlist_rcut, side=side, cap=cap,
                                 **common)
    if cfg.nlist_rcut > 0.0:
        common["rcut"] = cfg.nlist_rcut
    if local == "dense":
        return lambda p, m: accelerations_vs(p, p, m, **common)
    return functools.partial(pairwise_accelerations_chunked,
                             chunk=cfg.chunk, **common)


def _mesh_accel(key, mesh):
    """``accel2(pos_l, m_l)`` of a key on ``mesh``: the halo slab engine
    (nlist with the halo strategy, where the world divides the cell grid),
    else the allgather or ring sum over the local kernel."""
    from ... import parallel
    from ...serve.engine import _resolved
    from ...simulation import make_local_kernel

    devices, local = parse_backend(key.backend)
    extra = dict(key.extra)
    strategy = extra.get("strategy", "allgather")
    cfg = _key_config(key, local)
    if local == "nlist" and strategy == "halo":
        side = int(extra.get("nlist_side") or 0)
        if side % mesh.size == 0 and side >= mesh.size:
            return parallel.make_halo_nlist_accel(
                mesh, side=side, cap=int(extra.get("nlist_cap") or 0),
                rcut=float(extra.get("nlist_rcut") or 0.0), g=key.g,
                cutoff=key.cutoff, eps=key.eps)
        # The world no longer splits the grid into whole planes: degrade
        # the exchange, not the physics.
    return parallel.make_sharded_accel2(
        mesh, strategy="allgather" if strategy == "halo" else strategy,
        local_kernel=make_local_kernel(cfg, _resolved(local)))


def _launches() -> int:
    """Launches of the three force kernels in this process."""
    from ...ops import direct_kernel, mxu_kernel, nlist

    return (direct_kernel.LAUNCHES + mxu_kernel.LAUNCHES
            + sum(nlist.LAUNCHES.values()))


def _advance(accel, integrator: str, pos, vel, mass, acc, dt: float,
             steps: int, real, all_true=None):
    """``steps`` fixed-dt steps of one system, then the finite flag over
    its real rows and the in-round rollback: (pos, vel, acc, finite)."""
    from ...ops.integrators import make_step_fn

    step = make_step_fn(integrator, lambda p: accel(p, mass), dt)
    st, a = ParticleState(pos, vel, mass), acc
    for _ in range(steps):
        st, a = step(st, a)
    fin = (torch.where(real[:, None], torch.isfinite(st.positions), True)
           .all() & torch.where(real[:, None], torch.isfinite(st.velocities),
                                True).all())
    if all_true is not None:
        fin = all_true(fin)
    return (torch.where(fin, st.positions, pos),
            torch.where(fin, st.velocities, vel),
            torch.where(fin, a, acc), fin)


# --- the worker group ---


def _worker_main(rank: int, world: int, device_type: str, store_dir: str,
                 key, conn) -> None:
    """One rank of a key's group: join the group's world, build the key's
    sharded force, answer the daemon's commands until ``close``."""
    os.environ.pop("GRAVITY_TPU_FAULTS", None)  # the daemon's plan alone
    torch.set_num_threads(1)
    import torch.distributed as dist

    from ... import parallel
    from ...simulation import resolve_dtype

    try:
        if device_type == "cuda":
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
            backend = "nccl"
        else:
            device, backend = torch.device("cpu"), "gloo"
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(store_dir, "store"),
                                          world), rank=rank,
            world_size=world)
        mesh = parallel.make_particle_mesh((world,), device=device)
        accel = _mesh_accel(key, mesh)
        dtype = resolve_dtype(key.dtype)
        conn.send(("ready", None))
    except Exception as e:  # noqa: BLE001 — reported, then the rank ends
        conn.send(("error", f"{type(e).__name__}: {e}"))
        return
    st = acc = real = None
    rows = mesh.rows(key.bucket_n)
    try:
        while True:
            cmd, *args = conn.recv()
            if cmd == "close":
                break
            if cmd == "load":
                pos, vel, m, n_real = args
                whole = ParticleState(*(torch.from_numpy(a).to(dtype)
                                        for a in (pos, vel, m)))
                st = parallel.shard_state(whole, mesh)
                real = torch.arange(rows.start, rows.stop,
                                    device=device) < n_real
                before = _launches()
                acc = accel(st.positions, st.masses)
                conn.send(("ok", _launches() - before))
            elif cmd == "slice":
                dt, steps, stall = args
                if stall and rank == 0:
                    # An injected hung collective: every other rank waits
                    # in the first collective of the slice.
                    time.sleep(stall)
                before = _launches()
                pos, vel, acc, fin = _advance(
                    accel, key.integrator, st.positions, st.velocities,
                    st.masses, acc, dt, steps, real,
                    all_true=parallel.mesh.all_ranks_true)
                st = ParticleState(pos, vel, st.masses)
                conn.send(("ok", (bool(fin), _launches() - before)))
            elif cmd == "snapshot":
                whole = parallel.replicate_state(st, mesh)
                conn.send(("ok", tuple(t.cpu().numpy() for t in (
                    whole.positions, whole.velocities, whole.masses))
                    if rank == 0 else None))
            else:
                conn.send(("error", f"unknown command {cmd!r}"))
    except Exception as e:  # noqa: BLE001 — reported, then the rank ends
        try:
            conn.send(("error", f"{type(e).__name__}: {e}"))
        except OSError:
            pass
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class ShardedGroup:
    """The D worker processes of one key (module docstring). Every rank
    answers every command, so the daemon sees a dead or stalled rank;
    rank 0's answer carries the data."""

    def __init__(self, key, devices: int, device_type: str,
                 timeout_s: float = GROUP_TIMEOUT_S):
        self.key, self.devices, self.timeout_s = key, devices, timeout_s
        self.build_s = 0.0
        self.launches = 0
        self._dir = tempfile.mkdtemp(prefix="gravity_tpu_group_")
        ctx = multiprocessing.get_context("spawn")
        self._conns, self._procs = [], []
        t0 = time.perf_counter()
        for rank in range(devices):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_worker_main, daemon=True,
                args=(rank, devices, device_type, self._dir, key, child),
                name=f"gravity-sharded-{rank}")
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)
        self._replies("start", self.timeout_s)
        self.build_s = time.perf_counter() - t0

    def _replies(self, what: str, timeout_s: float) -> list:
        """Every rank's answer, or the group torn down and
        BackendUnavailable when one fails, dies or outlasts the
        watchdog."""
        deadline = time.monotonic() + timeout_s
        out = []
        for rank, conn in enumerate(self._conns):
            while not conn.poll(0.05):
                if not self._procs[rank].is_alive() and not conn.poll(0):
                    self.close(kill=True)
                    raise BackendUnavailable(
                        self.key.backend,
                        f"rank {rank} of the group died during {what}")
                if time.monotonic() > deadline:
                    self.close(kill=True)
                    raise BackendUnavailable(
                        self.key.backend,
                        f"collective stalled: no answer from rank {rank} "
                        f"to {what} within {timeout_s:.1f}s; the group is "
                        "torn down")
            try:
                status, payload = conn.recv()
            except (EOFError, OSError) as e:
                self.close(kill=True)
                raise BackendUnavailable(
                    self.key.backend,
                    f"rank {rank} of the group lost during {what}: "
                    f"{e}") from None
            if status == "error":
                self.close(kill=True)
                raise BackendUnavailable(
                    self.key.backend,
                    f"rank {rank} failed during {what}: {payload}")
            out.append(payload)
        return out

    def _command(self, what: str, *args, timeout_s: Optional[float] = None):
        for conn in self._conns:
            try:
                conn.send((what, *args))
            except (OSError, ValueError):
                self.close(kill=True)
                raise BackendUnavailable(
                    self.key.backend,
                    f"the group is gone ({what})") from None
        return self._replies(what, timeout_s or self.timeout_s)[0]

    def load(self, state: ParticleState, n_real: int) -> None:
        """Every rank takes its rows of the padded ``state`` and seeds its
        carried acceleration (one force evaluation)."""
        self.launches += self._command("load", *(
            t.detach().cpu().numpy() for t in (
                state.positions, state.velocities, state.masses)), n_real)

    def run(self, dt: float, steps: int, stall: float = 0.0) -> bool:
        """``steps`` steps; the group's finite flag. An injected stall
        holds rank 0 back for ``stall`` seconds, twice the watchdog of
        this slice."""
        finite, launches = self._command(
            "slice", dt, steps, stall,
            timeout_s=0.5 * stall if stall else None)
        self.launches += launches
        return finite

    def snapshot(self) -> ParticleState:
        pos, vel, m = self._command("snapshot")
        return ParticleState(*(torch.from_numpy(a) for a in (pos, vel, m)))

    @property
    def alive(self) -> bool:
        return bool(self._procs) and all(p.is_alive() for p in self._procs)

    def close(self, kill: bool = False) -> None:
        """End every rank (a clean ``close`` first unless ``kill``) and
        remove the group's store."""
        if not kill:
            for conn in self._conns:
                try:
                    conn.send(("close",))
                except (OSError, ValueError):
                    pass
        for proc in self._procs:
            proc.join(timeout=0 if kill else 30)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        shutil.rmtree(self._dir, ignore_errors=True)


@dataclasses.dataclass
class ShardedBatch:
    """The exclusive single-'slot' batch: ONE system. The solo form keeps
    its state here on the engine's device; a group keeps it on its ranks
    (``positions`` None). remaining / n_real keep the engine's (slots,)
    shape, so the scheduler's accounting indexes them as any batch's."""

    key: object
    positions: Optional[torch.Tensor]  # (bucket, 3), solo form only
    velocities: Optional[torch.Tensor]
    masses: Optional[torch.Tensor]
    acc: Optional[torch.Tensor]
    dt: np.ndarray  # (1,)
    remaining: np.ndarray  # (1,) int64
    n_real: np.ndarray  # (1,) int32
    slices_run: int = 0

    @property
    def slots(self) -> int:
        return 1


class ShardedIntegrateJob(JobClass):
    name = "sharded-integrate"
    units = "steps"
    # The sharded batch is one system, not a (slots, n) batch: the
    # engine's per-slot ledger and sentinel opt out, as in the JAX
    # package (conservation is the solo ledger's job).
    conserves = False

    # --- admission ---

    def validate(self, config, params):
        params = dict(params or {})
        unknown = set(params) - {"devices", "strategy", "state"}
        if unknown:
            raise JobValidationError(
                f"sharded-integrate params {sorted(unknown)} unknown "
                "(takes devices, strategy, and an optional inline "
                "'state')"
            )
        devices = params.get("devices")
        if devices is not None:
            try:
                devices = int(devices)
            except (TypeError, ValueError):
                raise JobValidationError(
                    "sharded-integrate: devices must be an integer "
                    "(omit it to use every local device)"
                ) from None
            if not 1 <= devices <= 65536:
                raise JobValidationError(
                    f"sharded-integrate: devices={devices} out of "
                    "range [1, 65536]"
                )
            params["devices"] = devices
        default_strategy = (
            "halo" if config.force_backend == "nlist" else "allgather"
        )
        strategy = params.get("strategy", default_strategy)
        if strategy not in STRATEGIES:
            raise JobValidationError(
                f"sharded-integrate: strategy {strategy!r} is not one "
                f"of {STRATEGIES}"
            )
        if strategy == "halo" and config.force_backend != "nlist":
            raise JobValidationError(
                "sharded-integrate: strategy 'halo' is the domain-"
                "decomposed CELL-LIST exchange — it needs "
                "force_backend='nlist' (the other kernels have no cell "
                "grid to slab-partition)"
            )
        if strategy == "ring" and config.force_backend == "nlist":
            raise JobValidationError(
                "sharded-integrate: strategy 'ring' cannot run the "
                "nlist kernel (per-chunk source binning changes the "
                "cell-cap overflow contract); use 'halo' or "
                "'allgather'"
            )
        params["strategy"] = strategy
        if config.force_backend not in ("auto", "direct") \
                and config.force_backend not in SHARDED_LOCAL_BACKENDS:
            raise JobValidationError(
                f"sharded-integrate: force_backend "
                f"{config.force_backend!r} has no per-shard local "
                f"kernel (one of auto/direct/"
                f"{'/'.join(SHARDED_LOCAL_BACKENDS)})"
            )
        validate_params_state(config, params)
        return params

    def batch_key(self, config, params, *, slots: int, min_bucket: int,
                  reroute=None, device=None):
        """The exclusive key: ``slots`` is always 1, the backend carries
        the elastic form (``sharded/<devices>/<local>``), and the bucket
        pads n up to a multiple of the form's device count. No bucket
        cap. ``devices`` defaults to the cards visible (1 on the CPU)."""
        from ...models import MODELS
        from ...ops.nlist import DEFAULT_CAP
        from ...utils.platform import resolve_device
        from .. import engine as _engine

        if config.model not in MODELS:
            raise JobValidationError(
                f"unknown model {config.model!r}; one of "
                f"{sorted(MODELS)}"
            )
        if config.integrator not in (
            "euler", "leapfrog", "verlet", "yoshida4"
        ):
            raise JobValidationError(
                f"integrator {config.integrator!r} is not servable "
                "(fixed-dt euler/leapfrog/verlet/yoshida4)"
            )
        for knob, val, default in (
            ("adaptive", config.adaptive, False),
            ("merge_radius", config.merge_radius, 0.0),
            ("periodic_box", config.periodic_box, 0.0),
            ("external", config.external, ""),
            ("sharding", config.sharding, "none"),
        ):
            if val != default:
                raise JobValidationError(
                    f"config.{knob}={val!r} is not servable by "
                    "sharded-integrate; run it solo via `run`"
                )
        local = config.force_backend
        if local in ("auto", "direct"):
            local = "dense" if config.n <= AUTO_DENSE_MAX else "chunked"
        # Truncated physics is keyed explicitly: an nlist job declares
        # rcut AND side (no state exists at admission to size from), and
        # only nlist jobs may declare them.
        if local == "nlist":
            if config.nlist_rcut <= 0.0 or config.nlist_side <= 0:
                raise JobValidationError(
                    "sharded-integrate with force_backend='nlist' "
                    "needs nlist_rcut > 0 AND nlist_side > 0 (serve "
                    "jobs size blind at admission: no initial state "
                    "exists to fit the cell grid from)"
                )
        elif config.nlist_rcut != 0.0:
            raise JobValidationError(
                f"config.nlist_rcut={config.nlist_rcut!r} is not "
                "servable by sharded-integrate unless "
                "force_backend='nlist'; run it solo via `run`"
            )
        devices = params.get("devices")
        if not devices:
            on_card = resolve_device(device).type == "cuda"
            devices = torch.cuda.device_count() if on_card else 1
        backend = sharded_backend_name(max(1, int(devices)), local)
        if reroute is not None:
            rerouted = reroute(backend)
            d, loc = parse_backend(rerouted)
            if d == 1 and loc not in SHARDED_LOCAL_BACKENDS:
                raise JobValidationError(
                    f"reroute {backend!r} -> {rerouted!r} left the "
                    "sharded-integrate ladder"
                )
            backend = rerouted
        d, _loc = parse_backend(backend)
        bucket = -(-config.n // d) * d  # ceil to a multiple of d
        default_strategy = "halo" if local == "nlist" else "allgather"
        extra = (("strategy", params.get("strategy", default_strategy)),)
        if local == "nlist":
            extra += (
                ("nlist_rcut", float(config.nlist_rcut)),
                ("nlist_side", int(config.nlist_side)),
                ("nlist_cap", int(config.nlist_cap or DEFAULT_CAP)),
            )
        return _engine.BatchKey(
            bucket_n=bucket,
            slots=1,
            backend=backend,
            dtype=config.dtype,
            integrator=config.integrator,
            g=config.g,
            eps=config.eps,
            cutoff=config.cutoff,
            job_type=self.name,
            extra=extra,
        )

    # --- engine-side program family ---

    def _group_for(self, engine, key) -> Optional[ShardedGroup]:
        """The key's worker group (None for the solo form), cached for the
        key. Failure here (too few cards, an injected ``mesh_fail``, a
        rank that cannot start) is the mesh-loss event the elastic ladder
        degrades on."""
        devices, _local = parse_backend(key.backend)
        if devices <= 1:
            return None
        groups = engine.sharded_groups
        group = groups.get(key)
        if group is not None and group.alive:
            return group
        groups.pop(key, None)
        if mesh_fail_due():
            raise BackendUnavailable(
                key.backend, "mesh build failed (injected mesh_fail)"
            )
        if engine.device.type == "cuda":
            visible = torch.cuda.device_count()
            if visible < devices:
                raise BackendUnavailable(
                    key.backend,
                    f"mesh wants {devices} devices, {visible} visible",
                )
        groups[key] = group = ShardedGroup(key, devices,
                                           engine.device.type)
        return group

    def build_round_fn(self, engine, key):
        """The solo form's force in the daemon's process; None for a
        group, whose ranks build their own."""
        devices, local = parse_backend(key.backend)
        if devices > 1:
            return None
        from ..engine import _resolved
        from ...utils import faults

        faults.check_backend(key.backend, _resolved(local))
        return _solo_accel(_key_config(key, local), local)

    def new_batch(self, engine, key):
        """The all-empty exclusive batch. The group is not built here:
        batch creation runs outside the admission try, and a group that
        cannot build must surface as the slot load's BackendUnavailable."""
        return ShardedBatch(
            key=key, positions=None, velocities=None, masses=None,
            acc=None, dt=np.zeros((1,), np.float64),
            remaining=np.zeros((1,), np.int64),
            n_real=np.zeros((1,), np.int32))

    def load_slot(self, engine, batch, slot, state, *, dt, steps, job):
        from ...simulation import resolve_dtype

        key = batch.key
        group = self._group_for(engine, key)  # BackendUnavailable here
        accel = engine.round_fn(key)  # the key's one build, counted
        n_real = state.n
        padded, _ = state.astype(resolve_dtype(key.dtype)).pad_to(
            key.bucket_n)
        fields = dict(dt=np.array([dt], np.float64),
                      remaining=np.array([steps], np.int64),
                      n_real=np.array([n_real], np.int32))
        if group is not None:
            group.load(padded, n_real)
            engine.force_evals[key.backend] = \
                engine.force_evals.get(key.backend, 0) + 1
            return dataclasses.replace(batch, positions=None,
                                       velocities=None, masses=None,
                                       acc=None, **fields)
        padded = padded.to(engine.device)
        acc0 = accel(padded.positions, padded.masses)
        engine.force_evals[key.backend] = \
            engine.force_evals.get(key.backend, 0) + 1
        return dataclasses.replace(
            batch, positions=padded.positions,
            velocities=padded.velocities, masses=padded.masses, acc=acc0,
            **fields)

    def clear_slot(self, engine, batch, slot):
        return dataclasses.replace(
            batch, positions=None, velocities=None, masses=None, acc=None,
            remaining=np.zeros((1,), np.int64),
            n_real=np.zeros((1,), np.int32))

    def slot_snapshot(self, engine, batch, slot):
        """The job's unpadded state: fresh tensors of the solo form, or
        the group's state gathered to rank 0 and shipped here."""
        n = int(batch.n_real[0])
        group = engine.sharded_groups.get(batch.key)
        if batch.positions is None and group is not None:
            whole = group.snapshot()
        else:
            whole = ParticleState(batch.positions, batch.velocities,
                                  batch.masses)
        return ParticleState(whole.positions[:n].clone(),
                             whole.velocities[:n].clone(),
                             whole.masses[:n].clone()), {}

    def run_slice(self, engine, batch, slice_steps):
        """Up to ``slice_steps`` steps of the job (its budget caps them):
        on the group, or on the solo form's state with the in-round
        rollback of a non-finite slice. One host read: the finite flag."""
        from ..engine import SliceResult, account_slice, budget_i32

        key = batch.key
        steps = int(min(slice_steps, budget_i32(batch.remaining)[0]))
        stall = collective_stall_secs(batch.slices_run)
        group = engine.sharded_groups.get(key)
        evals = engine.force_evals
        evals.setdefault(key.backend, 0)
        if batch.positions is None and group is not None:
            finite = group.run(float(batch.dt[0]), steps, stall)
            pos = vel = acc = None
        else:
            if stall > 0:
                # A hung collective of the solo form: the slice blocks,
                # then fails with the typed error the breaker counts.
                time.sleep(stall)
                raise BackendUnavailable(
                    key.backend,
                    f"collective stalled {stall:.1f}s (injected)")
            accel = engine.round_fn(key)
            real = torch.arange(key.bucket_n,
                                device=batch.positions.device) \
                < int(batch.n_real[0])
            pos, vel, acc, fin = _advance(
                accel, key.integrator, batch.positions, batch.velocities,
                batch.masses, batch.acc, float(batch.dt[0]), steps, real)
            finite = bool(fin)
        evals[key.backend] += steps * _evals_per_step(key.integrator)
        engine.host_reads["finite"] += 1
        advanced, remaining, finite_np = account_slice(
            batch.remaining, batch.n_real, slice_steps,
            np.array([finite]))
        if batch.positions is not None:
            batch = dataclasses.replace(batch, positions=pos,
                                        velocities=vel, acc=acc)
        return dataclasses.replace(
            batch, remaining=remaining, slices_run=batch.slices_run + 1,
        ), SliceResult(advanced=advanced, finite=finite_np)


def _evals_per_step(integrator: str) -> int:
    from ...simulation import FORCE_EVALS_PER_STEP

    return FORCE_EVALS_PER_STEP[integrator]


def group_stats(engine) -> dict:
    """Each live group's devices, build seconds and kernel launches of
    rank 0, by backend (the daemon's ``/metrics`` and the smoke's
    reading)."""
    return {key.backend: {"devices": g.devices, "build_s": g.build_s,
                          "launches_rank0": g.launches}
            for key, g in engine.sharded_groups.items()}


register(ShardedIntegrateJob())

