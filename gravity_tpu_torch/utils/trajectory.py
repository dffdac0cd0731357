"""Trajectory recording: ``.npy`` shards plus a JSON manifest, or one
``.gtrj`` file.

Counterpart of ``gravity_tpu/utils/trajectory.py``, in the same on-disk
layouts, so either package reads what the other wrote. Frames arrive as
host numpy arrays, stored as float32 like the JAX writer's (exact for
bf16 states).

The ``.gtrj`` format (``trajectory_format="native"``) is the JAX
package's C++ writer's (``runtime/trajectory_writer.cpp``), written here
in Python and numpy: a 24-byte little-endian header (``GTRJ``, u32
version 1, u64 N, u32 itemsize 4 or 8, u32 reserved 0), then one
fixed-size record a frame (i64 step, N x 3 values), flushed a frame at a
time. :class:`AsyncTrajectoryWriter` hands ``record`` calls to the run
loop's :class:`~gravity_tpu_torch.utils.hostio.HostWriter` thread, so that
either format is written off the block loop's critical path.
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


def record_frames(writer, steps, frames) -> None:
    """``writer.record(step, frame)`` for each of a block's frames, as one
    hand-off where the writer takes a block at once (``record_many``)."""
    record_many = getattr(writer, "record_many", None)
    if record_many is not None:
        record_many(steps, frames)
        return
    for step, frame in zip(steps, frames):
        writer.record(step, frame)


class AsyncTrajectoryWriter:
    """Replays ``record`` calls of a writer with the ``record``/``close``
    interface on a shared :class:`~gravity_tpu_torch.utils.hostio.
    HostWriter`. Its one thread keeps their order, so the files are
    bitwise identical to the wrapped writer's serial output. ``close``
    drains the queue (raising any background write failure) before it
    closes the inner writer."""

    def __init__(self, inner, writer):
        self._inner = inner
        self._writer = writer

    def record(self, step: int, positions) -> None:
        # ``positions``: a host array the caller no longer changes.
        self._writer.submit(self._inner.record, step, positions)

    def record_many(self, steps, frames) -> None:
        """A block's frames as one task: one queue slot and one hand-off
        between the threads for all of them."""
        self._writer.submit(record_frames, self._inner, list(steps), frames)

    def close(self) -> None:
        self._writer.barrier()
        self._inner.close()


GTRJ_MAGIC = b"GTRJ"
GTRJ_VERSION = 1


class NativeTrajectoryWriter:
    """Writes the ``.gtrj`` format (module docstring) to ``path``, plus
    ``path + ".manifest.json"`` on close, as the JAX package's native
    writer does."""

    def __init__(self, path: str, n_particles: int, *, every: int = 1,
                 dtype=np.float32):
        self.path = path
        self.n = n_particles
        self.every = max(1, every)
        self.dtype = np.dtype(dtype)
        if self.dtype.itemsize not in (4, 8):
            raise ValueError("the .gtrj format holds f32 or f64 only")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._file = open(path, "wb")
        self._file.write(
            GTRJ_MAGIC
            + np.array([GTRJ_VERSION], "<u4").tobytes()
            + np.array([n_particles], "<u8").tobytes()
            + np.array([self.dtype.itemsize, 0], "<u4").tobytes()
        )
        self._file.flush()
        self._steps: list[int] = []

    def record(self, step: int, positions) -> None:
        if step % self.every != 0:
            return
        arr = np.ascontiguousarray(positions,
                                   dtype=self.dtype.newbyteorder("<"))
        if arr.shape != (self.n, 3):
            raise ValueError(f"expected ({self.n}, 3), got {arr.shape}")
        self._file.write(np.array([step], "<i8").tobytes() + arr.tobytes())
        self._file.flush()
        self._steps.append(step)

    def close(self) -> None:
        if self._file is None:
            return
        self._file.close()
        self._file = None
        manifest = {
            "format": "GTRJ",
            "n_particles": self.n,
            "dtype": self.dtype.name,
            "every": self.every,
            "steps": self._steps,
        }
        with open(self.path + ".manifest.json", "w") as f:
            json.dump(manifest, f, indent=2)


class NativeTrajectoryReader:
    """Reads ``.gtrj`` files (either package's)."""

    HEADER = 24  # magic(4) + version(4) + n(8) + itemsize(4) + reserved(4)

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(self.HEADER)
        if head[:4] != GTRJ_MAGIC:
            raise ValueError(f"{path}: not a GTRJ file")
        self.version = int.from_bytes(head[4:8], "little")
        self.n = int.from_bytes(head[8:16], "little")
        itemsize = int.from_bytes(head[16:20], "little")
        self.dtype = np.dtype("<f4" if itemsize == 4 else "<f8")
        self.frame_bytes = 8 + self.n * 3 * itemsize
        size = os.path.getsize(path) - self.HEADER
        self.num_frames = size // self.frame_bytes

    def _records(self) -> np.ndarray:
        rec_dtype = np.dtype(
            [("step", "<i8"), ("pos", self.dtype, (self.n, 3))])
        return np.fromfile(self.path, dtype=rec_dtype, offset=self.HEADER,
                           count=self.num_frames)

    @property
    def steps(self) -> list[int]:
        return [int(s) for s in self._records()["step"]]

    def load(self) -> np.ndarray:
        """(T, N, 3) array of all frames."""
        return self._records()["pos"]

    def particle_track(self, i: int) -> np.ndarray:
        return self.load()[:, i, :]


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
