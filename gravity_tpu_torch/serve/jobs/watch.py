"""The ``watch`` job class: event-driven runs, served.

Counterpart of ``gravity_tpu/serve/jobs/watch.py``. A watch job integrates
like any other, but every step its program also finds the closest massive
pair (``sweep.masked_min_pair``) and records an ``encounter`` event on the
step the pair first comes inside ``radius``: a rising-edge detector whose
"was inside" flag is carried across rounds (and through evict and resume
in the job's extras), so a round boundary neither duplicates nor drops a
crossing. An optional ``merge_radius`` records ``merger`` events the same
way at the tighter radius. Events stream through the scheduler's
``serving_events.jsonl`` (``utils/logging.ServingEventLogger`` kinds
``encounter``, ``merger``) with the job id, global step, pair indices and
distance.

With ``params["followup"]`` set, the first flagged round submits a
high-resolution ``integrate`` job over the flagged interval: its initial
state the round-START state of this job (carried inline in the follow-up's
params), ``dt / refine`` and ``refine`` x the steps, at priority + 1 so
that it preempts queued background work; ``followup_submitted`` records
it. A shed follow-up (``QueueFull``) is dropped: the event has landed.

Solo parity: :func:`watch_solo` runs the same program in the same round
structure, so a served watch records exactly the events of a solo run:
(step, i, j, kind) equality is the gate, not a tolerance. A round reads
the host once: the finite flags, event counts and buffers together.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...interop import to_numpy
from ...state import ParticleState
from ..engine import (
    EnsembleBatch,
    SliceResult,
    account_slice,
    native_key,
    real_lanes_finite,
    slot_args,
)
from .registry import (
    JobClass,
    JobValidationError,
    register,
    validate_params_state,
)
from .sweep import masked_min_pair_batched, take_masks

MAX_EVENTS_CAP = 64
# The event buffers' fields, in the order of a round's host read.
EVENT_FIELDS = ("step", "i", "j", "distance", "kind")


@dataclasses.dataclass
class WatchBatch:
    """An EnsembleBatch of the key's integrate twin plus the per-slot
    detector carries, and the last round's events on the host for
    :meth:`WatchJob.post_round`."""

    key: object
    base: EnsembleBatch
    radius: torch.Tensor   # (B,) encounter radius a slot
    mradius: torch.Tensor  # (B,) merger radius (0 disables)
    in_enc: torch.Tensor   # (B,) bool: the closest pair inside radius
    in_mrg: torch.Tensor   # (B,) bool
    last_events: object = None  # (fields (B, 5, E), counts (B,)) host


def watch_program(kernel, integrator: str, max_events: int):
    """The watch program over B systems: ``(pos, vel, mass, acc, slot_args,
    radius, mradius, in_enc, in_mrg, *, n_steps, all_take, any_take) ->
    (pos, vel, acc, in_enc, in_mrg, packed)``: an integrate round with the
    rising-edge closest-pair detector, at most ``max_events`` events a
    slot a round, a non-finite slot rolled back to its round-start carry.
    ``packed`` (B, 2 + 5 E) float64 holds each slot's finite flag, event
    count and event buffers (:data:`EVENT_FIELDS`, E each; step in the
    round, 1-based), for one host read. ONE definition for the served
    rounds and :func:`watch_solo`."""
    from ...ops.integrators import make_step_fn

    e = max_events

    def run(pos, vel, mass, acc, args, radius, mradius, in_enc, in_mrg, *,
            n_steps, all_take, any_take):
        b, dev = pos.shape[0], pos.device
        dt = args[:, 0].reshape(-1, 1, 1)
        remaining, n_real = args[:, 1], args[:, 2]
        step = make_step_fn(integrator, lambda p: kernel(p, p, mass), dt)
        lanes = torch.arange(e, device=dev)[None, :]
        bufs = torch.stack([torch.full((b, e), -1.0, dtype=torch.float64,
                                       device=dev)] * 3
                           + [torch.zeros((b, e), dtype=torch.float64,
                                          device=dev)] * 2, dim=1)
        count = torch.zeros((b,), dtype=torch.int64, device=dev)

        def record(bufs, count, fire, i_step, bi, bj, d, kind):
            can = fire & (count < e)
            sel = (can[:, None] & (lanes == count.clamp_max(e - 1)[:, None])
                   )[:, None, :]
            vals = torch.stack([
                torch.full_like(d, float(i_step), dtype=torch.float64),
                bi.double(), bj.double(), d.double(),
                torch.full_like(d, float(kind), dtype=torch.float64)],
                dim=1)[:, :, None]
            return torch.where(sel, vals, bufs), count + can.long()

        st, a, pe, pm = ParticleState(pos, vel, mass), acc, in_enc, in_mrg
        for i in range(n_steps):
            if not any_take[i]:
                break
            new_st, new_a = step(st, a)
            if all_take[i]:
                take = torch.ones_like(pe)
                st, a = new_st, new_a
            else:
                take = i < remaining
                t3 = take.reshape(-1, 1, 1)
                st = st.replace(
                    positions=torch.where(t3, new_st.positions, st.positions),
                    velocities=torch.where(t3, new_st.velocities,
                                           st.velocities))
                a = torch.where(t3, new_a, a)
            d2, bi, bj = masked_min_pair_batched(st.positions, mass)
            d = torch.sqrt(torch.where(torch.isfinite(d2), d2, 0.0))
            has = bi >= 0
            enc_in = has & (d2 < radius * radius)
            bufs, count = record(bufs, count, take & enc_in & ~pe, i + 1,
                                 bi, bj, d, 0)
            pe = torch.where(take, enc_in, pe)
            mrg_in = has & (mradius > 0) & (d2 < mradius * mradius)
            bufs, count = record(bufs, count, take & mrg_in & ~pm, i + 1,
                                 bi, bj, d, 1)
            pm = torch.where(take, mrg_in, pm)
        fin = real_lanes_finite(n_real, st.positions, st.velocities)
        keep = fin.reshape(-1, 1, 1)
        packed = torch.cat([fin.double()[:, None], count.double()[:, None],
                            bufs.reshape(b, 5 * e)], dim=1)
        return (torch.where(keep, st.positions, pos),
                torch.where(keep, st.velocities, vel),
                torch.where(keep, a, acc), torch.where(fin, pe, in_enc),
                torch.where(fin, pm, in_mrg), packed)

    return run


def unpack_events(packed: np.ndarray, max_events: int):
    """(finite (B,) bool, counts (B,), fields (B, 5, E)) of a round's
    host read."""
    b = packed.shape[0]
    return (packed[:, 0] > 0.5, packed[:, 1].astype(np.int64),
            packed[:, 2:].reshape(b, 5, max_events))


def event_records(fields: np.ndarray, count: int, base_step: int) -> list:
    """One slot's events as records {step, i, j, distance, kind}: the
    round's step made global by the units done before the round."""
    out = []
    for k in range(count):
        s, i, j, d, kind = fields[:, k]
        out.append({"step": base_step + int(s), "i": int(i), "j": int(j),
                    "distance": float(d),
                    "kind": "merger" if int(kind) else "encounter"})
    return out


class WatchJob(JobClass):
    name = "watch"
    units = "steps"
    snapshot_before_round = True

    def validate(self, config, params):
        params = dict(params or {})
        unknown = set(params) - {
            "radius", "merge_radius", "max_events", "followup", "state",
        }
        if unknown:
            raise JobValidationError(
                f"watch: unknown params {sorted(unknown)}")
        if "radius" not in params:
            raise JobValidationError(
                "watch requires params.radius (the encounter distance to "
                "watch for)")
        validate_params_state(config, params)
        try:
            radius = float(params["radius"])
            mradius = float(params.get("merge_radius", 0.0))
            max_events = int(params.get("max_events", 16))
        except (TypeError, ValueError) as e:
            raise JobValidationError(f"watch: bad param: {e}") from e
        if radius <= 0:
            raise JobValidationError("watch: radius must be > 0")
        if mradius < 0:
            raise JobValidationError(
                "watch: merge_radius must be >= 0 (0 disables)")
        if not 1 <= max_events <= MAX_EVENTS_CAP:
            raise JobValidationError(
                f"watch: max_events must be in [1, {MAX_EVENTS_CAP}]")
        followup = params.get("followup")
        if followup is not None:
            if not isinstance(followup, dict):
                raise JobValidationError("watch: followup must be an object")
            try:
                refine = int(followup.get("refine", 4))
                fmax = int(followup.get("max", 1))
            except (TypeError, ValueError) as e:
                raise JobValidationError(f"watch: bad followup: {e}") from e
            if refine < 2:
                raise JobValidationError(
                    "watch: followup.refine must be >= 2")
            if fmax < 1:
                raise JobValidationError("watch: followup.max must be >= 1")
            params["followup"] = {"refine": refine, "max": fmax}
        params["radius"] = radius
        params["merge_radius"] = mradius
        params["max_events"] = max_events
        return params

    def key_extra(self, config, params) -> tuple:
        return (("events", int(params["max_events"])),)

    # --- the program family ---

    def build_round_fn(self, engine, key):
        from ...utils import faults
        from ..engine import _resolved

        faults.check_backend(key.backend, _resolved(key.backend))
        return watch_program(engine.counted_kernel(native_key(key)),
                             key.integrator, dict(key.extra)["events"])

    def new_batch(self, engine, key):
        base = engine.new_batch(native_key(key))
        b, dtype, dev = key.slots, base.positions.dtype, engine.device
        return WatchBatch(
            key=key, base=base,
            radius=torch.zeros((b,), dtype=dtype, device=dev),
            mradius=torch.zeros((b,), dtype=dtype, device=dev),
            in_enc=torch.zeros((b,), dtype=torch.bool, device=dev),
            in_mrg=torch.zeros((b,), dtype=torch.bool, device=dev))

    @staticmethod
    def _set(batch, slot, **values):
        out = {}
        for name, value in values.items():
            t = getattr(batch, name).clone()
            t[slot] = value
            out[name] = t
        return out

    def load_slot(self, engine, batch, slot, state, *, dt, steps, job):
        extra = (job.extra_state or {}) if job is not None else {}
        params = job.params if job is not None else {}
        base = engine.load_slot(batch.base, slot, state, dt=dt, steps=steps)
        return dataclasses.replace(batch, base=base, **self._set(
            batch, slot, radius=float(params.get("radius", 0.0)),
            mradius=float(params.get("merge_radius", 0.0)),
            in_enc=bool(extra.get("in_enc", False)),
            in_mrg=bool(extra.get("in_mrg", False))))

    def clear_slot(self, engine, batch, slot):
        return dataclasses.replace(
            batch, base=engine.clear_slot(batch.base, slot), **self._set(
                batch, slot, radius=0.0, mradius=0.0, in_enc=False,
                in_mrg=False))

    def slot_snapshot(self, engine, batch, slot):
        return engine.slot_state(batch.base, slot), {
            "in_enc": bool(batch.in_enc[slot]),
            "in_mrg": bool(batch.in_mrg[slot]),
        }

    def round_snapshot(self, scheduler, batch, slot_jobs):
        """Round-start states (host) of the slots whose job can still
        submit a follow-up: the zoom-in starts from the state the flagged
        round STARTED from. Jobs with no follow-up left cost nothing
        here (this runs every round)."""
        out = {}
        for slot, job_id in enumerate(slot_jobs):
            job = scheduler.jobs.get(job_id) if job_id is not None else None
            if job is None:
                continue
            followup = job.params.get("followup")
            if not followup or int((job.extra_state or {}).get(
                    "followups_done", 0)) >= int(followup["max"]):
                continue
            st = scheduler.engine.slot_state(batch.base, slot)
            out[slot] = ParticleState(*(to_numpy(t) for t in (
                st.positions, st.velocities, st.masses)))
        return out

    def run_slice(self, engine, batch, slice_steps):
        engine._check_thread()
        b = batch.base
        fn = engine.round_fn(batch.key)
        args, all_take = slot_args(b.dt, b.remaining, b.n_real, slice_steps,
                                   engine.device)
        pos, vel, acc, in_enc, in_mrg, packed = fn(
            b.positions, b.velocities, b.masses, b.acc, args, batch.radius,
            batch.mradius, batch.in_enc, batch.in_mrg, n_steps=slice_steps,
            all_take=all_take, any_take=take_masks(b.remaining, slice_steps))
        finite, counts, fields = unpack_events(
            packed.cpu().numpy(), dict(batch.key.extra)["events"])
        engine.host_reads["finite"] += 1
        advanced, remaining, finite_np = account_slice(
            b.remaining, b.n_real, slice_steps, finite)
        base = dataclasses.replace(b, positions=pos, velocities=vel, acc=acc,
                                   remaining=remaining)
        return (dataclasses.replace(batch, base=base, in_enc=in_enc,
                                    in_mrg=in_mrg,
                                    last_events=(fields, counts)),
                SliceResult(advanced=advanced, finite=finite_np))

    # --- scheduler hooks ---

    def post_round(self, scheduler, key, batch, slot_jobs, res,
                   start_units, round_start) -> None:
        """This round's events into the serving stream and the job's log,
        and the configured follow-up of a newly flagged job."""
        if batch.last_events is None:
            return
        fields, counts = batch.last_events
        for slot, job_id in enumerate(slot_jobs):
            if job_id is None or not bool(res.finite[slot]):
                continue
            job = scheduler.jobs.get(job_id)
            if job is None or int(counts[slot]) == 0:
                continue
            base_step = start_units.get(job_id, job.steps_done)
            extra = job.extra_state = dict(job.extra_state or {})
            log = extra.setdefault("events", [])
            for record in event_records(fields[slot], int(counts[slot]),
                                        base_step):
                log.append(record)
                scheduler._event(record["kind"], job=job_id,
                                 step=record["step"], i=record["i"],
                                 j=record["j"], distance=record["distance"])
            self._maybe_followup(
                scheduler, job, base_step, int(res.advanced[slot]),
                None if round_start is None else round_start.get(slot))

    def _maybe_followup(self, scheduler, job, base_step, advanced,
                        start_state) -> None:
        followup = job.params.get("followup")
        if not followup or start_state is None or advanced < 1:
            return
        extra = job.extra_state = dict(job.extra_state or {})
        done = int(extra.get("followups_done", 0))
        if done >= int(followup["max"]):
            return
        refine = int(followup["refine"])
        config = dataclasses.replace(job.config, dt=job.config.dt / refine,
                                     steps=advanced * refine)
        child_id = f"{job.id}.f{done}"
        from ..scheduler import QueueFull

        try:
            scheduler.submit(
                config, job_type="integrate",
                params={"state": {
                    "positions": np.asarray(start_state.positions).tolist(),
                    "velocities": np.asarray(start_state.velocities).tolist(),
                    "masses": np.asarray(start_state.masses).tolist(),
                }},
                priority=job.priority + 1, job_id=child_id)
        except (ValueError, QueueFull):
            # Shed, duplicate or out of the envelope: the event stream has
            # the encounter; the zoom-in is best-effort. QueueFull is a
            # RuntimeError: escaping here, mid-round after the batch
            # advanced and before any job was credited, it would desync
            # the bucket's budgets.
            return
        extra["followups_done"] = done + 1
        scheduler._event("followup_submitted", job=job.id, followup=child_id,
                         from_step=base_step, steps=config.steps,
                         dt=config.dt, refine=refine)

    def finalize(self, job, state, extra):
        events = (extra or {}).get("events") \
            or (job.extra_state or {}).get("events") or []
        pos, vel, m = (to_numpy(t) for t in (
            state.positions, state.velocities, state.masses))
        arrays = {
            "positions": pos, "velocities": vel, "masses": m,
            "event_step": np.asarray([e["step"] for e in events], np.int64),
            "event_i": np.asarray([e["i"] for e in events], np.int64),
            "event_j": np.asarray([e["j"] for e in events], np.int64),
            "event_distance": np.asarray([e["distance"] for e in events]),
            "event_kind": np.asarray(
                [int(e["kind"] == "merger") for e in events], np.int64),
        }
        payload = {
            "events": len(events),
            "encounters": sum(1 for e in events if e["kind"] == "encounter"),
            "mergers": sum(1 for e in events if e["kind"] == "merger"),
            "followups": int((job.extra_state or {}).get(
                "followups_done", 0)),
        }
        return arrays, payload


def watch_solo(config, params, slice_steps=None, *, device=None) -> list:
    """Solo reference: :func:`watch_program` on one system at n, unpadded,
    in the rounds of ``slice_steps`` a daemon with that setting runs (None:
    one round), on the card unless ``device`` asks for the CPU. Returns the
    events [{step, i, j, distance, kind}] an inline-detection run records:
    a served watch must match them exactly."""
    from ...simulation import make_initial_state, resolve_dtype
    from ...utils.platform import resolve_device
    from ..engine import solo_batched_kernel
    from .registry import params_state

    dev = resolve_device(device)
    params = WatchJob().validate(config, params)
    dtype = resolve_dtype(config.dtype)
    ics = (params_state(params) or make_initial_state(
        config, device="cpu")).astype(dtype).to(dev)
    kernel = solo_batched_kernel(config)
    max_events = int(params["max_events"])
    program = watch_program(kernel, config.integrator, max_events)
    p, v, m = (t[None] for t in (ics.positions, ics.velocities, ics.masses))
    acc = kernel(p, p, m)
    scalar = dict(dtype=dtype, device=dev)
    radius = torch.full((1,), params["radius"], **scalar)
    mradius = torch.full((1,), params["merge_radius"], **scalar)
    in_enc = in_mrg = torch.zeros((1,), dtype=torch.bool, device=dev)
    slice_steps = slice_steps or config.steps
    events, done = [], 0
    while done < config.steps:
        n_steps = min(slice_steps, config.steps - done)
        args = torch.tensor([[float(config.dt), float(n_steps),
                              float(ics.n)]], dtype=torch.float64).to(dev)
        takes = np.ones(n_steps, bool)
        p, v, acc, in_enc, in_mrg, packed = program(
            p, v, m, acc, args, radius, mradius, in_enc, in_mrg,
            n_steps=n_steps, all_take=takes, any_take=takes)
        _, counts, fields = unpack_events(packed.cpu().numpy(), max_events)
        events += event_records(fields[0], int(counts[0]), done)
        done += n_steps
    return events


register(WatchJob())
