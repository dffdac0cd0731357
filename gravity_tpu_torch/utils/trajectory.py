"""Trajectory recording: ``.npy`` shards plus a JSON manifest.

Counterpart of ``TrajectoryWriter`` and ``TrajectoryReader`` in
``gravity_tpu/utils/trajectory.py``, in the same on-disk layout, so
either package reads what the other wrote. Frames arrive as host numpy
arrays, stored as float32 like the JAX writer's (exact for bf16 states).
The native ``.gtrj`` writer is ROADMAP Queue 1 item 3.
"""

from __future__ import annotations

import json
import os

import numpy as np


class TrajectoryWriter:
    """Streams (step, positions) snapshots to sharded .npy files."""

    def __init__(
        self,
        out_dir: str,
        n_particles: int,
        *,
        every: int = 1,
        flush_every: int = 64,
        dtype=np.float32,
    ):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.n = n_particles
        self.every = max(1, every)
        self.flush_every = flush_every
        self.dtype = np.dtype(dtype)
        self._buffer: list[np.ndarray] = []
        self._steps: list[int] = []
        self._shards: list[dict] = []

    def record(self, step: int, positions) -> None:
        if step % self.every != 0:
            return
        self._buffer.append(np.asarray(positions, dtype=self.dtype))
        self._steps.append(step)
        if len(self._buffer) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if not self._buffer:
            return
        shard_idx = len(self._shards)
        path = os.path.join(self.out_dir, f"trajectory_{shard_idx:05d}.npy")
        np.save(path, np.stack(self._buffer, axis=0))
        self._shards.append(
            {"file": os.path.basename(path), "steps": self._steps}
        )
        self._buffer, self._steps = [], []

    def close(self) -> None:
        self.flush()
        manifest = {
            "n_particles": self.n,
            "dtype": self.dtype.name,
            "every": self.every,
            "shards": self._shards,
        }
        with open(os.path.join(self.out_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)


class TrajectoryReader:
    """Reads trajectories written by :class:`TrajectoryWriter`."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        with open(os.path.join(out_dir, "manifest.json")) as f:
            self.manifest = json.load(f)

    @property
    def steps(self) -> list[int]:
        return [s for shard in self.manifest["shards"] for s in shard["steps"]]

    def load(self, mmap: bool = True) -> np.ndarray:
        """Full (T, N, 3) trajectory array."""
        arrays = [
            np.load(
                os.path.join(self.out_dir, shard["file"]),
                mmap_mode="r" if mmap else None,
            )
            for shard in self.manifest["shards"]
        ]
        if not arrays:
            return np.zeros((0, self.manifest["n_particles"], 3))
        return np.concatenate(arrays, axis=0)

    def particle_track(self, i: int) -> np.ndarray:
        """(T, 3) track of one particle."""
        return self.load()[:, i, :]
