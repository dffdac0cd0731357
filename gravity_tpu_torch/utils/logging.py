"""Run logging — the reference's ``log_print`` contract.

Counterpart of ``gravity_tpu/utils/logging.py`` (``RunLogger`` and the
JSONL spine it writes its sidecar on), with the same sections and
formats: a timestamped file in a ``gravity_logs_*`` directory, every
message mirrored to stdout, a start banner, ``Step k/STEPS`` progress
lines, a ``Performance Statistics:`` section, a ``Final positions:``
section and a closing ``Simulation completed successfully`` line. The
banner names the platform the run is on (GPU or CPU) and its device.
:class:`RecoveryEventLogger` is the supervisor's JSONL audit trail.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import Optional

import numpy as np


class JsonlEventLogger:
    """Append-only JSONL stream of structured events, one JSON object per
    line: ``{"v": <schema version>, "ts": <unix seconds>, "event": <kind>,
    ...}``, with ``kind`` restricted to the subclass's ``KINDS``."""

    KINDS: tuple = ()
    SCHEMA_VERSION = 1

    def __init__(self, path: str, context: Optional[dict] = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        # Fields stamped on every record: the serving daemon's worker id,
        # so that workers appending to one shared spool stream stay
        # attributable.
        self.context = dict(context or {})

    def event(self, kind: str, /, **fields) -> None:
        if kind not in self.KINDS:
            raise ValueError(
                f"unknown event kind {kind!r}; one of {self.KINDS}"
            )
        record = {
            "v": self.SCHEMA_VERSION,
            "ts": round(time.time(), 3), "event": kind,
            **self.context, **fields,
        }
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=str) + "\n")

    def read(self) -> list[dict]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


class RunEventLogger(JsonlEventLogger):
    """The run log's structured sidecar."""

    KINDS = ("banner", "progress", "performance", "completed")


class RecoveryEventLogger(JsonlEventLogger):
    """Recovery events: the audit trail of the self-healing supervisor, in
    the JAX package's JSONL schema. Event-specific keys ride along (step,
    dt, backend, backoff_s, ...)."""

    KINDS = (
        "diverged", "rolled_back", "retry", "degraded", "preempted",
        "accuracy_breach",
    )


class ServingEventLogger(JsonlEventLogger):
    """Serving events: the ensemble scheduler's and daemon's metrics
    stream (``serving_events.jsonl``), in the JAX package's schema.
    ``round`` events carry queue depth, occupancy, pairs/s and the
    completed-job latency percentiles; the job lifecycle, the fleet
    kinds (adoption, fencing, breakers, load shedding, the requeue cap),
    the SLO and accuracy breaches and memory rejections have their own.
    The JAX package's watch and router kinds stay in the list so that
    one tooling path reads both packages' streams."""

    KINDS = (
        "submitted", "admitted", "yielded", "round", "completed",
        "failed", "cancelled", "respooled", "spool_error",
        "adopted", "adopted_resumed", "fenced",
        "breaker_open", "breaker_closed",
        "shed", "poisoned", "worker_reaped",
        "encounter", "merger", "followup_submitted",
        "slo_breach", "accuracy_breach",
        "recompile_storm", "memory_rejected",
        "routed", "router_rejected", "drained",
    )


class RunLogger:
    """Mirrors messages to stdout and a timestamped log file, plus a JSONL
    sidecar (``<prefix>_<ts>.jsonl``) of the structured sections."""

    def __init__(
        self,
        log_dir: str = "gravity_logs_gpu",
        prefix: str = "simulation_log",
        quiet: bool = False,
        timestamp: Optional[str] = None,
        jsonl: bool = True,
    ):
        os.makedirs(log_dir, exist_ok=True)
        self.timestamp = timestamp or datetime.datetime.now().strftime(
            "%Y%m%d_%H%M%S"
        )
        self.path = os.path.join(log_dir, f"{prefix}_{self.timestamp}.txt")
        self.quiet = quiet
        self.events: Optional[RunEventLogger] = (
            RunEventLogger(
                os.path.join(log_dir, f"{prefix}_{self.timestamp}.jsonl")
            )
            if jsonl else None
        )

    def _emit(self, kind: str, /, **fields) -> None:
        if self.events is not None:
            self.events.event(kind, **fields)

    def log_print(self, message: str) -> None:
        if not self.quiet:
            print(message)
        with open(self.path, "a") as f:
            f.write(message + "\n")

    # --- the reference log sections ---

    def start_banner(
        self, *, platform: str, device: str, num_devices: int,
        num_particles: int, steps: int, dt: float, model: str,
        integrator: str, backend: str, dtype: str, sharding: str = "none",
    ) -> None:
        self.log_print(
            f"Starting {platform} gravity simulation at {self.timestamp}"
        )
        self.log_print(f"Device: {device}")
        self.log_print(f"Number of devices: {num_devices}")
        self.log_print(f"Number of particles: {num_particles}")
        self.log_print(f"Steps: {steps}")
        self.log_print(f"Timestep: {dt:f} seconds")
        self.log_print(
            f"Model: {model} | Integrator: {integrator} | "
            f"Force backend: {backend} | Sharding: {sharding} | Dtype: {dtype}"
        )
        self.log_print("")
        self._emit(
            "banner", platform=platform, device=device,
            num_devices=num_devices, num_particles=num_particles,
            steps=steps, dt=dt, model=model, integrator=integrator,
            backend=backend, sharding=sharding, dtype=dtype,
        )

    def progress(self, step: int, total_steps: int) -> None:
        self.log_print(f"Step {step}/{total_steps}")
        self._emit("progress", step=step, total_steps=total_steps)

    def performance(self, total_time: float, steps: int,
                    pairs_per_sec: Optional[float] = None) -> None:
        self.log_print("\nPerformance Statistics:")
        self.log_print(f"Total execution time: {total_time:.2f} seconds")
        self.log_print(
            f"Average time per step: {total_time / max(steps, 1):.4f} seconds"
        )
        if pairs_per_sec is not None:
            self.log_print(
                f"Pair interactions per second: {pairs_per_sec:.4e}"
            )
        self._emit(
            "performance", total_time_s=total_time, steps=steps,
            avg_step_s=total_time / max(steps, 1),
            pairs_per_sec=pairs_per_sec,
        )

    def final_positions(self, positions, max_particles: int = 10) -> None:
        positions = np.asarray(positions)
        self.log_print("\nFinal positions:")
        n = min(len(positions), max_particles)
        for i in range(n):
            x, y, z = positions[i]
            self.log_print(f"Particle {i}: ({x:e}, {y:e}, {z:e})")
        if len(positions) > n:
            self.log_print(
                f"... ({len(positions) - n} more particles omitted)"
            )

    def completed(self) -> None:
        self.log_print("\nSimulation completed successfully")
        self._emit("completed")
