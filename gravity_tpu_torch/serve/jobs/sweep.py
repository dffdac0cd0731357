"""The ``sweep`` job class: ensemble stability surveys, served.

Counterpart of ``gravity_tpu/serve/jobs/sweep.py``. One submission is
hundreds to thousands of perturbed initial conditions ("members") of one
base system, fanned into the scheduler as ordinary jobs, so that a sweep
drives the continuous batching (priority, deadlines, backfill, yields,
per-slot divergence isolation, leases, adoption) at real occupancy.
Member k's ICs are the base model state with a deterministic velocity
perturbation (``spread`` x RMS speed) drawn from a ``torch.Generator``
seeded from (``sweep_seed``, k): the JAX package's ``fold_in`` threefry
bits cannot be had without JAX, so a member's draw is not the JAX
package's (ROADMAP.md Queue 3); any worker reproduces any member from its
spool record alone.

Members run a program family of their own: the integrate round plus the
closest massive pair carried every step (the minimum separation over the
WHOLE trajectory: a check at round boundaries would miss close passages
inside a round), over a batch of the key's integrate twin
(``engine.native_key``). The per-member verdict (energy drift, escape,
minimum separation) is computed at completion from the recomputed ICs
and the final state, by one definition for a served member and for the
solo reference (:func:`sweep_member_solo`), which is the parity gate.

The parent ``sweep`` job never takes a slot: it tracks its members and
aggregates their verdicts (per-member arrays and a summary payload) when
the last member lands.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...interop import to_numpy
from ...state import ParticleState
from ..engine import (
    EnsembleBatch,
    SliceResult,
    account_slice,
    budget_i32,
    native_key,
    real_lanes_finite,
    slot_args,
)
from .registry import JobClass, JobValidationError, register

MAX_MEMBERS = 4096  # one submission; the queue bound still applies


def masked_min_pair(positions, masses):
    """(d2, i, j) of the closest pair among the massive bodies of one
    system (n, 3), (n,): ``ops/encounters.closest_pairs`` at k = 1, so
    that served detection and the standalone diagnostics share one
    definition; zero-mass bodies (bucket padding, merge donors) are
    excluded by its mass mask; (inf, -1, -1) with fewer than two massive
    bodies. d2 is the square of the distance that op returns, as the JAX
    package's is."""
    from ...ops.encounters import closest_pairs

    n = positions.shape[0]
    d, bi, bj = closest_pairs(positions, masses, k=1, chunk=min(n, 1024))
    return d[0] * d[0], bi[0], bj[0]


def masked_min_pair_batched(positions, masses):
    """:func:`masked_min_pair` of each system of a batch (B, n, 3), (B, n):
    ((B,) d2, (B,) i, (B,) j), the JAX package's under ``vmap``, through
    ``ops/encounters.closest_pair_batched`` (closest_pairs at k = 1 over
    the batch at once)."""
    from ...ops.encounters import closest_pair_batched

    d, bi, bj = closest_pair_batched(positions, masses)
    return d * d, bi, bj


@dataclasses.dataclass
class SweepBatch:
    """An EnsembleBatch of the key's integrate twin (``base``: the engine's
    own slot lifecycle, padding, carried-acceleration seed and zero-mass
    clear serve it) and the per-slot minimum-separation carry; ``key`` is
    the sweep-member key the scheduler and the build counts see."""

    key: object
    base: EnsembleBatch
    min_d2: torch.Tensor  # (B,)


def member_program(kernel, integrator: str):
    """The member program over B systems: ``(pos, vel, mass, acc, min_d2,
    slot_args, *, n_steps, all_take, any_take) -> (pos, vel, acc, min_d2,
    finite)``: an integrate round that carries each system's closest-pair
    d2 over the steps it takes, a non-finite slot rolled back to its
    round-start carry. ONE definition for the served rounds and
    :func:`sweep_member_solo`. ``any_take`` (host): the steps in which
    some slot takes (the others change nothing)."""
    from ...ops.integrators import make_step_fn

    def run(pos, vel, mass, acc, min_d2, args, *, n_steps, all_take,
            any_take):
        dt = args[:, 0].reshape(-1, 1, 1)
        remaining, n_real = args[:, 1], args[:, 2]
        step = make_step_fn(integrator, lambda p: kernel(p, p, mass), dt)
        st, a, md2 = ParticleState(pos, vel, mass), acc, min_d2
        for i in range(n_steps):
            if not any_take[i]:
                break
            new_st, new_a = step(st, a)
            if all_take[i]:
                st, a = new_st, new_a
                d2, _, _ = masked_min_pair_batched(st.positions, mass)
                md2 = torch.minimum(md2, d2)
                continue
            take = i < remaining
            t3 = take.reshape(-1, 1, 1)
            st = st.replace(
                positions=torch.where(t3, new_st.positions, st.positions),
                velocities=torch.where(t3, new_st.velocities, st.velocities))
            a = torch.where(t3, new_a, a)
            d2, _, _ = masked_min_pair_batched(st.positions, mass)
            md2 = torch.where(take, torch.minimum(md2, d2), md2)
        fin = real_lanes_finite(n_real, st.positions, st.velocities)
        keep = fin.reshape(-1, 1, 1)
        return (torch.where(keep, st.positions, pos),
                torch.where(keep, st.velocities, vel),
                torch.where(keep, a, acc), torch.where(fin, md2, min_d2), fin)

    return run


def take_masks(remaining: np.ndarray, units: int) -> np.ndarray:
    """The round's units in which some slot takes (host budgets)."""
    return np.arange(units) < budget_i32(remaining).max(initial=0)


def _validate_common(params: dict) -> dict:
    """The member-verdict knobs shared by parent and member params."""
    out = {}
    try:
        out["spread"] = float(params.get("spread", 0.01))
        out["drift_tol"] = float(params.get("drift_tol", 0.05))
        out["escape_radius"] = float(params.get("escape_radius", 0.0))
        out["sweep_seed"] = int(params.get("sweep_seed", 0))
    except (TypeError, ValueError) as e:
        raise JobValidationError(f"sweep: bad numeric param: {e}") from e
    if out["spread"] < 0:
        raise JobValidationError("sweep: spread must be >= 0")
    if out["drift_tol"] <= 0:
        raise JobValidationError("sweep: drift_tol must be > 0")
    if out["escape_radius"] < 0:
        raise JobValidationError("sweep: escape_radius must be >= 0")
    return out


def member_seed(sweep_seed: int, member: int) -> int:
    """The seed of member ``member``'s perturbation generator: a
    ``numpy.random.SeedSequence`` of (sweep seed, member), so that nearby
    members' draws are independent."""
    seq = np.random.SeedSequence([int(sweep_seed) % 2**64, int(member)])
    return int(seq.generate_state(1, np.uint64)[0] % 2**63)


def member_initial_state(config, params) -> ParticleState:
    """Member ICs on the CPU: the base model state plus a velocity kick of
    ``spread`` x RMS speed, standard normals from a generator seeded by
    :func:`member_seed`; a pure function of (config, params)."""
    from ...simulation import make_initial_state

    base = make_initial_state(config, device="cpu")
    spread = float(params.get("spread", 0.0))
    if spread <= 0.0:
        return base
    gen = torch.Generator().manual_seed(member_seed(
        int(params.get("sweep_seed", 0)), int(params.get("member", 0))))
    v = base.velocities
    v_rms = torch.sqrt(torch.clamp_min(torch.mean(torch.sum(v * v, dim=-1)),
                                       1e-30))
    normal = torch.randn(v.shape, generator=gen, dtype=torch.float64)
    return base.replace(velocities=v + spread * v_rms * normal.to(v.dtype))


def member_verdict(config, params, ics: ParticleState,
                   final: ParticleState, min_sep: float) -> dict:
    """The per-member stability verdict: ONE definition for the served
    finalize and the solo reference. Both energies are summed on the
    final state's device in its dtype (the ICs moved there), so that a
    served member and its solo run sum their energies alike."""
    from ...ops.diagnostics import total_energy

    ics = ics.astype(final.positions.dtype).to(final.positions.device)
    e0 = float(total_energy(ics, g=config.g, cutoff=config.cutoff,
                            eps=config.eps))
    e1 = float(total_energy(final, g=config.g, cutoff=config.cutoff,
                            eps=config.eps))
    drift = abs(e1 - e0) / max(abs(e0), 1e-30)
    m = to_numpy(ics.masses).astype(np.float64)
    x0 = to_numpy(ics.positions).astype(np.float64)
    w = m / max(m.sum(), 1e-30)
    com0 = (w[:, None] * x0).sum(0)
    r0 = np.linalg.norm(x0 - com0, axis=1)
    esc_r = float(params.get("escape_radius", 0.0)) or 4.0 * float(
        r0.max() if r0.size else 0.0)
    r1 = np.linalg.norm(to_numpy(final.positions).astype(np.float64) - com0,
                        axis=1)
    mass1 = to_numpy(final.masses).astype(np.float64)
    escaped = bool(((r1 > esc_r) & (mass1 > 0)).any()) if esc_r > 0 \
        else False
    return {
        "member": int(params.get("member", 0)),
        "min_sep": float(min_sep),
        "energy_drift": float(drift),
        "escaped": escaped,
        "drift_exceeded": bool(drift > float(params.get("drift_tol", 0.05))),
    }


def _min_sep(min_d2: float) -> float:
    return math.sqrt(max(min_d2, 0.0)) if math.isfinite(min_d2) \
        else float("inf")


class SweepMemberJob(JobClass):
    """One member of a sweep: an internal class (clients submit the parent
    ``sweep``; members show in /status as ``<parent>.m<k>``)."""

    name = "sweep-member"
    units = "steps"
    submittable = False

    def validate(self, config, params):
        params = dict(params or {})
        out = _validate_common(params)
        try:
            out["member"] = int(params.get("member", 0))
        except (TypeError, ValueError) as e:
            raise JobValidationError(f"sweep: bad member: {e}") from e
        if "parent" in params:
            out["parent"] = str(params["parent"])
        return out

    def initial_state(self, job):
        return member_initial_state(job.config, job.params)

    # --- the program family ---

    def build_round_fn(self, engine, key):
        from ...utils import faults
        from ..engine import _resolved

        faults.check_backend(key.backend, _resolved(key.backend))
        return member_program(engine.counted_kernel(native_key(key)),
                              key.integrator)

    def new_batch(self, engine, key):
        base = engine.new_batch(native_key(key))
        return SweepBatch(key=key, base=base, min_d2=torch.full(
            (key.slots,), math.inf, dtype=base.positions.dtype,
            device=engine.device))

    def load_slot(self, engine, batch, slot, state, *, dt, steps, job):
        extra = (job.extra_state or {}) if job is not None else {}
        base = engine.load_slot(batch.base, slot, state, dt=dt, steps=steps)
        min_d2 = batch.min_d2.clone()
        min_d2[slot] = float(extra.get("min_d2", math.inf))
        return dataclasses.replace(batch, base=base, min_d2=min_d2)

    def clear_slot(self, engine, batch, slot):
        min_d2 = batch.min_d2.clone()
        min_d2[slot] = math.inf
        return dataclasses.replace(
            batch, base=engine.clear_slot(batch.base, slot), min_d2=min_d2)

    def slot_snapshot(self, engine, batch, slot):
        return (engine.slot_state(batch.base, slot),
                {"min_d2": float(batch.min_d2[slot])})

    def run_slice(self, engine, batch, slice_steps):
        engine._check_thread()
        b = batch.base
        fn = engine.round_fn(batch.key)
        args, all_take = slot_args(b.dt, b.remaining, b.n_real, slice_steps,
                                   engine.device)
        pos, vel, acc, min_d2, finite = fn(
            b.positions, b.velocities, b.masses, b.acc, batch.min_d2, args,
            n_steps=slice_steps, all_take=all_take,
            any_take=take_masks(b.remaining, slice_steps))
        finite_host = finite.cpu().numpy()
        engine.host_reads["finite"] += 1
        advanced, remaining, finite_np = account_slice(
            b.remaining, b.n_real, slice_steps, finite_host)
        base = dataclasses.replace(b, positions=pos, velocities=vel, acc=acc,
                                   remaining=remaining)
        return (dataclasses.replace(batch, base=base, min_d2=min_d2),
                SliceResult(advanced=advanced, finite=finite_np))

    def finalize(self, job, state, extra):
        ics = self.initial_state(job)
        verdict = member_verdict(
            job.config, job.params, ics, state,
            _min_sep(float(extra.get("min_d2", math.inf))))
        pos, vel, m = (to_numpy(t) for t in (
            state.positions, state.velocities, state.masses))
        arrays = {
            "positions": pos, "velocities": vel, "masses": m,
            "min_sep": np.asarray([verdict["min_sep"]]),
            "energy_drift": np.asarray([verdict["energy_drift"]]),
            "escaped": np.asarray([int(verdict["escaped"])]),
        }
        return arrays, verdict


class SweepJob(JobClass):
    """The parent: validated at submit, expanded into members by the
    scheduler, aggregated when its last member lands. Never resident."""

    name = "sweep"
    units = "members"
    resident = False

    def validate(self, config, params):
        params = dict(params or {})
        unknown = set(params) - {
            "members", "spread", "drift_tol", "escape_radius", "sweep_seed",
        }
        if unknown:
            raise JobValidationError(
                f"sweep: unknown params {sorted(unknown)}")
        try:
            members = int(params.get("members", 0))
        except (TypeError, ValueError) as e:
            raise JobValidationError(f"sweep: bad members: {e}") from e
        if members < 1:
            raise JobValidationError(
                "sweep: members must be >= 1 (a sweep with zero members "
                "has nothing to survey)")
        if members > MAX_MEMBERS:
            raise JobValidationError(
                f"sweep: members {members} > cap {MAX_MEMBERS}; split the "
                "survey across submissions")
        out = _validate_common(params)
        out["members"] = members
        return out

    def budget(self, job) -> int:
        return int(job.params["members"])

    def member_params(self, job, k: int) -> dict:
        return {
            "member": k, "parent": job.id,
            "spread": job.params["spread"],
            "drift_tol": job.params["drift_tol"],
            "escape_radius": job.params["escape_radius"],
            "sweep_seed": job.params["sweep_seed"],
        }

    @staticmethod
    def member_id(parent_id: str, k: int) -> str:
        return f"{parent_id}.m{k}"

    @staticmethod
    def aggregate(job, member_payloads: list) -> tuple[dict, dict]:
        """(arrays, payload) of the completed parent from its members'
        verdicts (None for a failed or cancelled member)."""
        m = len(member_payloads)
        min_sep = np.full((m,), np.nan)
        drift = np.full((m,), np.nan)
        escaped = np.zeros((m,), np.int8)
        exceeded = np.zeros((m,), np.int8)
        done = np.zeros((m,), np.int8)
        for k, p in enumerate(member_payloads):
            if not p:
                continue
            done[k] = 1
            min_sep[k] = p.get("min_sep", np.nan)
            drift[k] = p.get("energy_drift", np.nan)
            escaped[k] = int(bool(p.get("escaped")))
            exceeded[k] = int(bool(p.get("drift_exceeded")))
        arrays = {"min_sep": min_sep, "energy_drift": drift,
                  "escaped": escaped, "drift_exceeded": exceeded,
                  "completed": done}
        payload = {
            "members": m, "completed": int(done.sum()),
            "failed": int(m - done.sum()), "escaped": int(escaped.sum()),
            "drift_exceeded": int(exceeded.sum()),
        }
        return arrays, payload


def sweep_member_solo(config, params, *, ics=None, device=None) -> dict:
    """Solo reference of one member: :func:`member_program` on one system
    at n, unpadded, run once (the card unless ``device`` asks for the
    CPU), with :func:`member_verdict`: the per-member parity oracle.
    ``ics`` (a ParticleState) replaces :func:`member_initial_state`'s."""
    from ...simulation import resolve_dtype
    from ...utils.platform import resolve_device
    from ..engine import solo_batched_kernel

    dev = resolve_device(device)
    params = SweepMemberJob().validate(config, params)
    dtype = resolve_dtype(config.dtype)
    if ics is None:
        ics = member_initial_state(config, params)
    ics = ics.astype(dtype).to(dev)
    kernel = solo_batched_kernel(config)
    program = member_program(kernel, config.integrator)
    p, v, m = (t[None] for t in (ics.positions, ics.velocities, ics.masses))
    acc0 = kernel(p, p, m)
    args = torch.tensor([[float(config.dt), float(config.steps),
                          float(ics.n)]], dtype=torch.float64).to(dev)
    takes = np.ones(config.steps, bool)
    pos, vel, _, min_d2, fin = program(
        p, v, m, acc0, torch.full((1,), math.inf, dtype=dtype, device=dev),
        args, n_steps=config.steps, all_take=takes, any_take=takes)
    final = ParticleState(pos[0], vel[0], ics.masses)
    verdict = member_verdict(config, params, ics, final,
                             _min_sep(float(min_d2[0])))
    verdict["finite"] = bool(fin[0])
    return verdict


register(SweepMemberJob())
register(SweepJob())
