"""Checkpoint and resume with content-integrity checks.

Counterpart of ``gravity_tpu/utils/checkpoint.py``, with torch
serialization in place of Orbax. A snapshot holds (positions, velocities,
masses) and any ``extra_*`` scalars (an adaptive run's simulated time
``t`` and its Kahan compensation ``comp``), plus a SHA-256 checksum of
that payload. Each step goes in a directory of its own,
``<directory>/<step>/checkpoint.pt``, written to a temporary file,
fsync'd, then moved into place with ``os.replace``; the newest
``max_to_keep`` steps are kept.

:func:`payload_checksum` gives the JAX package's digest bytes on the same
numpy payload (the same key order, names, dtype names, shapes and raw
bytes). Restore re-computes and checks it; the latest-checkpoint restore
falls back step by step to older snapshots when the newest is corrupt or
unreadable, so a half-written checkpoint from a killed process does not
lose the run. A snapshot is loaded with ``torch.load(...,
weights_only=True)`` onto the CPU; the caller moves it to its device.
"""

from __future__ import annotations

import hashlib
import os
import shutil
from typing import Optional

import numpy as np
import torch

from ..state import ParticleState

_INTEGRITY_KEY = "integrity_sha256"
_FILE = "checkpoint.pt"


class CheckpointCorrupt(RuntimeError):
    """A checkpoint whose payload does not match its stored checksum, or
    that cannot be read back at all."""


class CheckpointManager:
    """A directory of per-step snapshots, the newest ``max_to_keep`` kept
    (the role of Orbax's ``CheckpointManager``)."""

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), _FILE)

    def all_steps(self) -> list:
        """Steps whose snapshot file exists (a step left with only its
        temporary file by a killed writer is not one)."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(self._path(int(name))):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: dict) -> None:
        """Write ``payload`` (CPU tensors) at ``step``: a temporary file,
        fsync, ``os.replace``; then drop the oldest other steps past
        ``max_to_keep`` (never the one just written, even where newer
        steps of another run share the directory)."""
        step_dir = os.path.join(self.directory, str(step))
        os.makedirs(step_dir, exist_ok=True)
        tmp = os.path.join(step_dir, f"{_FILE}.tmp.{os.getpid()}")
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(step))
        others = [s for s in self.all_steps() if s != step]
        for old in others[:max(0, len(others) + 1 - self.max_to_keep)]:
            self.delete(old)

    def restore(self, step: int) -> dict:
        """The payload at ``step`` as CPU tensors."""
        path = self._path(step)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no checkpoint at step {step} in {self.directory}")
        return torch.load(path, map_location="cpu", weights_only=True)

    def delete(self, step: int) -> None:
        shutil.rmtree(os.path.join(self.directory, str(step)),
                      ignore_errors=True)


def make_checkpoint_manager(directory: str, *,
                            max_to_keep: int = 3) -> CheckpointManager:
    return CheckpointManager(directory, max_to_keep=max_to_keep)


def crossed_cadence(prev_step: int, step: int, every: int) -> bool:
    """True when [prev_step, step] crossed a multiple of ``every``: the
    block loop's checkpoint predicate (a block size need not divide the
    cadence)."""
    return every > 0 and (step // every) > (prev_step // every)


def _hash_view(a) -> tuple:
    """(dtype name, shape, raw bytes) of an array or tensor, as the JAX
    package's digest sees its numpy form. A bf16 tensor hashes as the
    ``ml_dtypes`` bfloat16 array a JAX bf16 state fetches to: dtype name
    ``bfloat16`` and its 2-byte words."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return ("bfloat16", tuple(t.shape),
                    t.view(torch.int16).numpy().tobytes())
        a = t.numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return str(a.dtype), a.shape, a.tobytes()


def payload_checksum(payload: dict) -> np.ndarray:
    """SHA-256 over the payload's canonical bytes (sorted keys; each key
    hashed with its name, dtype name, shape and raw bytes) as a (32,)
    uint8 array: the JAX package's digest of the same numpy payload."""
    h = hashlib.sha256()
    for k in sorted(payload):
        dtype, shape, raw = _hash_view(payload[k])
        h.update(k.encode())
        h.update(dtype.encode())
        h.update(repr(shape).encode())
        h.update(raw)
    return np.frombuffer(h.digest(), dtype=np.uint8).copy()


def _host_payload(state: ParticleState, extra: Optional[dict]) -> dict:
    """The snapshot's payload as CPU tensors (a copy of device state)."""
    payload = {
        "positions": state.positions.detach().to("cpu", copy=True),
        "velocities": state.velocities.detach().to("cpu", copy=True),
        "masses": state.masses.detach().to("cpu", copy=True),
    }
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = torch.tensor(float(v), dtype=torch.float64)
    return payload


def save_checkpoint(
    manager: CheckpointManager,
    step: int,
    state: ParticleState,
    *,
    extra: Optional[dict] = None,
) -> None:
    """Snapshot (positions, velocities, masses) at ``step``.

    Idempotent a step: the divergence watchdog's emergency save can land
    on the step the cadence path just wrote, and an identical re-save is a
    no-op. A different payload at the same step raises (a stale or foreign
    directory); a step that cannot be read back (a torn write) is
    replaced. ``extra`` holds scalar metadata, stored as float64
    ``extra_<key>`` entries."""
    payload = _host_payload(state, extra)
    digest = payload_checksum(payload)
    if step in set(manager.all_steps()):
        try:
            old = dict(manager.restore(step))
            old_digest = old.pop(_INTEGRITY_KEY, None)
            readable = True
        except Exception:  # noqa: BLE001 — any unreadable snapshot is
            old_digest, readable = None, False  # a torn one
        if not readable:
            manager.delete(step)
        else:
            if old_digest is not None and not np.array_equal(
                    np.asarray(old_digest, np.uint8).reshape(-1), digest):
                raise ValueError(
                    f"checkpoint directory {manager.directory} already "
                    f"holds a DIFFERENT state at step {step}: stale or "
                    "foreign checkpoints; point checkpoint_dir at a clean "
                    "directory (or delete the old one)"
                )
            return
    payload[_INTEGRITY_KEY] = torch.from_numpy(digest)
    manager.save(step, payload)


def restore_checkpoint(manager: CheckpointManager,
                       step: Optional[int] = None) -> tuple:
    state, step, _ = restore_checkpoint_with_extra(manager, step)
    return state, step


def restore_checkpoint_with_extra(
    manager: CheckpointManager, step: Optional[int] = None,
    *, max_step: Optional[int] = None,
) -> tuple:
    """(state on the CPU, step, extra scalars) of a snapshot.

    With ``step=None`` (the latest) snapshots are tried newest first: one
    that fails to read back or fails its checksum is skipped for the next
    older one. ``max_step`` bounds that walk (the supervisor's rollback
    passes the last finite step, so that a newer snapshot of a previous
    run sharing the directory is never adopted). An explicit ``step`` is
    restored strictly: corruption there raises
    :class:`CheckpointCorrupt`."""
    if step is not None:
        try:
            return _restore_verified(manager, step)
        except (FileNotFoundError, CheckpointCorrupt):
            raise
        except Exception as e:  # noqa: BLE001 — an unreadable file
            raise CheckpointCorrupt(
                f"checkpoint at step {step} in {manager.directory} "
                f"failed to restore: {type(e).__name__}: {e}"
            ) from e
    steps = sorted(set(manager.all_steps()), reverse=True)
    if max_step is not None:
        steps = [s for s in steps if s <= max_step]
    if not steps:
        bound = "" if max_step is None else f" at step <= {max_step}"
        raise FileNotFoundError(
            f"no checkpoint found{bound} in {manager.directory}"
        )
    failures = []
    for s in steps:
        try:
            state, _, extra = _restore_verified(manager, s)
            return state, s, extra
        except Exception as e:  # noqa: BLE001 — fall back one step
            failures.append(f"step {s}: {type(e).__name__}: {e}")
    raise CheckpointCorrupt(
        f"all {len(steps)} checkpoint(s) in {manager.directory} failed "
        "to restore: " + "; ".join(failures)
    )


def _restore_verified(manager: CheckpointManager, step: int) -> tuple:
    restored = dict(manager.restore(step))
    digest = restored.pop(_INTEGRITY_KEY, None)
    if digest is not None:
        expected = payload_checksum(restored)
        got = np.asarray(digest, np.uint8).reshape(-1)
        if not np.array_equal(got, expected):
            raise CheckpointCorrupt(
                f"checkpoint at step {step} in {manager.directory} "
                "failed its content checksum (payload corrupted on disk)"
            )
    state = ParticleState(
        positions=restored["positions"],
        velocities=restored["velocities"],
        masses=restored["masses"],
    )
    extra = {
        k[len("extra_"):]: float(v)
        for k, v in restored.items()
        if k.startswith("extra_")
    }
    return state, step, extra
