"""The ``traj`` verb: inspect and export a ``.gtrj`` trajectory file.

Counterpart of ``gravity_tpu/cli.py``'s ``cmd_traj`` and of the C++
inspector it runs, ``runtime/gtrj_tool.cpp``: ``info`` (the header and
the frame index), ``stats`` (each frame's centroid, extent and largest
displacement from frame 0), ``dump`` (the first K bodies of one frame)
print what the tool prints, byte for byte (C's ``%g`` and ``%.9g``,
sums in double in index order), with its stderr lines and exit codes: 0
ok, 2 a file that cannot be opened or is not GTRJ v1, or a frame out of
range. ``export`` writes ``<base>_positions.npy`` and ``<base>_steps.npy``
and prints one JSON line, as the JAX verb does.

Host I/O in numpy on :class:`~.trajectory.NativeTrajectoryReader`: no
device, no build.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np

from .trajectory import GTRJ_MAGIC, NativeTrajectoryReader


def c_g(x: float, spec: str = "%g") -> str:
    """C's printf of one double: Python's ``%`` formatting is C's, but for
    the sign of a NaN, which glibc prints."""
    x = float(x)
    if math.isnan(x):
        return "-nan" if math.copysign(1.0, x) < 0 else "nan"
    return spec % x


def _header_ok(path: str) -> bool:
    """The tool's ``read_header``: magic, version 1, dtype 4 or 8."""
    try:
        with open(path, "rb") as f:
            head = f.read(NativeTrajectoryReader.HEADER)
    except IsADirectoryError:
        return False
    if len(head) < NativeTrajectoryReader.HEADER or head[:4] != GTRJ_MAGIC:
        return False
    version = int.from_bytes(head[4:8], "little")
    itemsize = int.from_bytes(head[16:20], "little")
    return version == 1 and itemsize in (4, 8)


def info(reader: NativeTrajectoryReader) -> int:
    frames = reader.num_frames
    lines = ["format: GTRJ v1", f"particles: {reader.n}",
             f"dtype: f{reader.dtype.itemsize * 8}", f"frames: {frames}",
             f"frame_bytes: {reader.frame_bytes}"]
    if frames > 0:
        steps = reader.steps
        lines.append(f"steps: {steps[0]}..{steps[-1]}")
    sys.stdout.write("\n".join(lines) + "\n")
    return 0


def _bounds(col: np.ndarray) -> tuple:
    """The tool's running min and max from +-1e300: NaN never replaces
    either, nor does a value past the start."""
    lo_v = col[col < 1e300]
    hi_v = col[col > -1e300]
    return (float(lo_v.min()) if lo_v.size else 1e300,
            float(hi_v.max()) if hi_v.size else -1e300)


def stats(reader: NativeTrajectoryReader) -> int:
    out = sys.stdout
    out.write("frame,step,cx,cy,cz,extent,max_disp\n")
    n = reader.n
    first = None
    for idx, rec in enumerate(reader._records()):
        step, xyz = int(rec["step"]), rec["pos"].astype(np.float64)
        # Sums in index order, as the tool's loop (cumsum is sequential);
        # no bodies is the tool's 0 / 0.
        with np.errstate(invalid="ignore"):
            c = (xyz.cumsum(axis=0)[-1] if n else np.zeros(3)) / float(n)
        extent = 0.0
        for d in range(3):
            lo, hi = _bounds(xyz[:, d])
            if hi - lo > extent:
                extent = hi - lo
        max_disp = 0.0
        if first is None:
            first = xyz
        else:
            dv = xyz - first
            dd = (dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1]
                  + dv[:, 2] * dv[:, 2])
            dd = dd[dd > 0.0]
            max_disp = math.sqrt(float(dd.max())) if dd.size else 0.0
        out.write(f"{idx},{step}," + ",".join(
            c_g(v) for v in (c[0], c[1], c[2], extent, max_disp)) + "\n")
    return 0


def dump(reader: NativeTrajectoryReader, frame: int, count: int) -> int:
    frames = reader.num_frames
    if frame < 0:
        frame += frames  # python-style negative index
    if frame < 0 or frame >= frames:
        sys.stderr.write(f"frame {frame} out of range (0..{frames - 1})\n")
        return 2
    rec = reader._records()[frame]
    xyz = np.asarray(rec["pos"], dtype=np.float64)
    # The tool reads K as an unsigned 64-bit count: 0, a negative count
    # (a huge unsigned one) or one past N dumps all N bodies.
    k = reader.n if count <= 0 or count > reader.n else count
    lines = [f"step,{int(rec['step'])}", "i,x,y,z"]
    lines += [f"{i}," + ",".join(c_g(v, "%.9g") for v in xyz[i])
              for i in range(k)]
    sys.stdout.write("\n".join(lines) + "\n")
    return 0


def export(path: str) -> int:
    """GTRJ -> (positions.npy, steps.npy) for numpy and matplotlib."""
    reader = NativeTrajectoryReader(path)
    base = path[:-5] if path.endswith(".gtrj") else path
    traj = reader.load()
    np.save(base + "_positions.npy", traj)
    np.save(base + "_steps.npy", np.asarray(reader.steps))
    print(json.dumps({
        "frames": int(traj.shape[0]), "particles": int(traj.shape[1]),
        "positions": base + "_positions.npy",
        "steps": base + "_steps.npy",
    }))
    return 0


def run(command: str, path: str, *, frame: int = 0, count: int = 10) -> int:
    """One ``traj`` command on ``path``, printed to stdout and stderr as
    the tool prints it: its exit code."""
    if command == "export":
        return export(path)
    # fopen opens a directory (its reads fail: not GTRJ), not a missing
    # or unreadable file.
    if not os.path.isdir(path):
        try:
            open(path, "rb").close()
        except OSError:
            sys.stderr.write(f"cannot open {path}\n")
            return 2
    if not _header_ok(path):
        sys.stderr.write(f"not a GTRJ v1 file: {path}\n")
        return 2
    reader = NativeTrajectoryReader(path)
    if command == "info":
        return info(reader)
    if command == "stats":
        return stats(reader)
    return dump(reader, frame, count)
