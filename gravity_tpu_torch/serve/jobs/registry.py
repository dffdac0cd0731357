"""Job-class registry: the traffic classes the serving stack speaks.

Counterpart of ``gravity_tpu/serve/jobs/registry.py``. A
:class:`JobClass` packages one served capability: its admission
contract (``validate``, typed rejections at submit), its program family
(``build_round_fn``, keyed by the extended BatchKey: one build per key),
its batch layout (``new_batch``, ``load_slot``, ``clear_slot``,
``slot_snapshot``), its budget (``budget``, in the class's units), its
initial state (``initial_state``), its scheduler hooks (``post_round``,
``round_snapshot``) and its result schema (``finalize``). The port serves
every class of the JAX package: ``integrate``, ``fit``, ``sweep`` (with
its internal ``sweep-member``), ``watch`` and ``sharded-integrate``
(:data:`NOT_PORTED` is empty).
"""

from __future__ import annotations

from typing import Optional

from ...config import NotPortedError, SimulationConfig
from ...state import ParticleState

# The JAX package's classes that the port does not serve yet, with the
# ROADMAP.md Queue 1 item that ports each: none.
NOT_PORTED: dict = {}


class JobValidationError(ValueError):
    """A malformed job-type payload, rejected at admission (HTTP 400).
    A ValueError, so every submit-time rejection path handles it."""


class JobClass:
    """One served traffic class. Stateless: per-job state lives in the
    scheduler's Job record and the engine's batches."""

    #: registry name == the wire-format ``job_type``
    name: str = "?"
    #: what ``steps``/``steps_done`` count for this class
    units: str = "steps"
    #: internal classes (sweep members) are not submittable over the API
    submittable: bool = True
    #: whether the class's jobs occupy a slot (a sweep parent does not)
    resident: bool = True
    #: whether the class's batch lanes hold an integrating state whose
    #: conserved quantities are meaningful (the ledger and sentinel gate)
    conserves: bool = True
    #: whether the scheduler takes :meth:`round_snapshot` before a round
    snapshot_before_round: bool = False

    def validate(self, config: SimulationConfig, params: dict) -> dict:
        """Normalize + validate the class payload; raises
        :class:`JobValidationError`. The result is persisted verbatim in
        the job record (JSON)."""
        return dict(params)

    def batch_key(self, config: SimulationConfig, params: dict, *,
                  slots: int, min_bucket: int, reroute=None, device=None):
        from ..engine import batch_key_for

        return batch_key_for(
            config, slots=slots, min_bucket=min_bucket, reroute=reroute,
            job_type=self.name, extra=self.key_extra(config, params),
            device=device,
        )

    def key_extra(self, config: SimulationConfig, params: dict) -> tuple:
        """The class's additional static program parameters: part of the
        build key (``BatchKey.extra``)."""
        return ()

    def budget(self, job) -> int:
        """Total work units for this job; ``job.steps_done`` counts
        against it."""
        return job.config.steps

    def initial_state(self, job) -> ParticleState:
        """Deterministic ICs from the job record alone (config + params):
        a respooled job reproduces the same trajectory from unit 0."""
        from ...simulation import make_initial_state

        return params_state(job.params) or make_initial_state(
            job.config, device="cpu")

    # --- the program family of a class with its own rounds ---

    def build_round_fn(self, engine, key):
        raise NotImplementedError

    def new_batch(self, engine, key):
        raise NotImplementedError

    def load_slot(self, engine, batch, slot, state, *, dt, steps, job):
        raise NotImplementedError

    def clear_slot(self, engine, batch, slot):
        raise NotImplementedError

    def slot_snapshot(self, engine, batch, slot):
        raise NotImplementedError

    def run_slice(self, engine, batch, slice_steps):
        raise NotImplementedError

    # --- scheduler hooks ---

    def slice_units(self, key, slice_steps: int) -> int:
        """Work units a round for this key, from the scheduler's
        ``slice_steps``, so that every class does a comparable amount of
        device work a round; a pure function of (key, slice_steps)."""
        return slice_steps

    def pairs_per_unit(self, job) -> float:
        """Dense-equivalent pair interactions per work unit (the round
        throughput metric)."""
        from ...utils.timing import pairs_per_step

        return pairs_per_step(job.config.n)

    def round_snapshot(self, scheduler, batch, slot_jobs):
        """Host snapshot taken before a round for :meth:`post_round` (only
        where ``snapshot_before_round``)."""
        return None

    def post_round(self, scheduler, key, batch, slot_jobs, res,
                   start_units: dict, round_start) -> None:
        """After a round of this key's batch, before its accounting: the
        class's events and follow-ups (watch). ``start_units`` maps job id
        -> units done before the round."""

    def finalize(self, job, state: Optional[ParticleState],
                 extra: dict) -> tuple[dict, Optional[dict]]:
        """(result arrays for the spool .npz, small JSON verdict) of a
        completed job; the arrays are host numpy (bf16 as float32)."""
        from ...interop import state_to_numpy

        pos, vel, m = state_to_numpy(state)
        return {"positions": pos, "velocities": vel, "masses": m}, None


def params_state(params: dict) -> Optional[ParticleState]:
    """Inline initial state carried in a job payload, already validated
    by :func:`validate_params_state`. None when absent."""
    st = (params or {}).get("state")
    if not st:
        return None
    import torch

    return ParticleState.create(
        st["positions"], st["velocities"], st["masses"],
        dtype=torch.float64, device="cpu",
    )


def validate_params_state(config: SimulationConfig, params: dict) -> None:
    """Validate an optional inline ``params["state"]`` against the
    config's n (typed 400s, not an admission-round crash)."""
    st = params.get("state")
    if st is None:
        return
    if not isinstance(st, dict) or not all(
        k in st for k in ("positions", "velocities", "masses")
    ):
        raise JobValidationError(
            "params.state must carry positions/velocities/masses arrays"
        )
    import numpy as np

    try:
        pos = np.asarray(st["positions"], dtype=np.float64)
        vel = np.asarray(st["velocities"], dtype=np.float64)
        m = np.asarray(st["masses"], dtype=np.float64)
    except (TypeError, ValueError) as e:
        raise JobValidationError(f"params.state is not numeric: {e}") \
            from e
    if pos.shape != (config.n, 3) or vel.shape != (config.n, 3) \
            or m.shape != (config.n,):
        raise JobValidationError(
            f"params.state shapes {pos.shape}/{vel.shape}/{m.shape} "
            f"do not match config.n={config.n}"
        )
    params["state"] = {
        "positions": pos.tolist(), "velocities": vel.tolist(),
        "masses": m.tolist(),
    }


REGISTRY: dict[str, JobClass] = {}


def register(cls: JobClass) -> JobClass:
    REGISTRY[cls.name] = cls
    return cls


def get_class(name: str) -> JobClass:
    if name in NOT_PORTED:
        raise NotPortedError(
            f"job type {name!r} is not ported to gravity_tpu_torch yet "
            f"(ROADMAP.md Queue 1 item {NOT_PORTED[name]})"
        )
    if name not in REGISTRY:
        raise JobValidationError(
            f"unknown job type {name!r}; one of {sorted(REGISTRY)}"
        )
    return REGISTRY[name]


def job_types() -> list[str]:
    return sorted(REGISTRY)
