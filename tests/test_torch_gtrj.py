"""The port's ``.gtrj`` trajectory format (``gravity_tpu_torch/utils/
trajectory.py``), written in Python, against the JAX package's C++ writer
(``runtime/trajectory_writer.cpp``) and reader, on the CPU: a file the
port writes is read by the JAX package to the same arrays and holds the
C++ writer's bytes; a file the C++ writer writes is read by the port; the
async wrapper writes the same bytes as the serial writer; and ``run
--trajectory-format native`` writes one."""

import glob
import json
import os

import numpy as np
import pytest

from gravity_tpu.utils.native import native_available
from gravity_tpu.utils.trajectory import (
    NativeTrajectoryReader as JaxNativeReader,
)
from gravity_tpu.utils.trajectory import (
    NativeTrajectoryWriter as JaxNativeWriter,
)
from gravity_tpu_torch.cli import main
from gravity_tpu_torch.utils.hostio import HostWriter
from gravity_tpu_torch.utils.trajectory import (
    AsyncTrajectoryWriter,
    NativeTrajectoryReader,
    NativeTrajectoryWriter,
    TrajectoryReader,
    TrajectoryWriter,
)

N = 37


def _frames(dtype, count=6):
    rng = np.random.default_rng(11)
    return [rng.standard_normal((N, 3)).astype(dtype) for _ in range(count)]


def _write(writer, frames, steps):
    for step, frame in zip(steps, frames):
        writer.record(step, frame)
    writer.close()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_port_file_read_by_jax_reader(tmp_path, dtype):
    frames, steps = _frames(dtype), [2, 4, 6, 8, 10, 12]
    path = str(tmp_path / "t.gtrj")
    _write(NativeTrajectoryWriter(path, N, dtype=dtype), frames, steps)
    reader = JaxNativeReader(path)
    assert reader.n == N and reader.version == 1
    assert reader.num_frames == len(frames) and reader.steps == steps
    np.testing.assert_array_equal(reader.load(), np.stack(frames))
    np.testing.assert_array_equal(reader.particle_track(3),
                                  np.stack(frames)[:, 3])
    manifest = json.load(open(path + ".manifest.json"))
    assert manifest["format"] == "GTRJ" and manifest["steps"] == steps


@pytest.mark.skipif(not native_available(),
                    reason="the JAX package's C++ writer did not build (g++)")
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bytes_equal_the_cpp_writer_and_each_reads_the_other(tmp_path,
                                                             dtype):
    frames, steps = _frames(dtype), [1, 2, 3, 5, 8, 13]
    ours, theirs = str(tmp_path / "ours.gtrj"), str(tmp_path / "cpp.gtrj")
    _write(NativeTrajectoryWriter(ours, N, dtype=dtype), frames, steps)
    _write(JaxNativeWriter(theirs, N, dtype=dtype), frames, steps)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert json.load(open(ours + ".manifest.json")) == \
        json.load(open(theirs + ".manifest.json"))
    reader = NativeTrajectoryReader(theirs)
    assert reader.steps == steps
    np.testing.assert_array_equal(reader.load(), np.stack(frames))


def test_header_layout(tmp_path):
    path = str(tmp_path / "h.gtrj")
    NativeTrajectoryWriter(path, N).close()
    head = open(path, "rb").read()
    assert len(head) == 24 and head[:4] == b"GTRJ"
    assert int.from_bytes(head[4:8], "little") == 1
    assert int.from_bytes(head[8:16], "little") == N
    assert int.from_bytes(head[16:20], "little") == 4
    assert head[20:24] == b"\0\0\0\0"
    assert NativeTrajectoryReader(path).num_frames == 0


def test_writer_strides_and_refuses_bad_shapes(tmp_path):
    w = NativeTrajectoryWriter(str(tmp_path / "s.gtrj"), N, every=2)
    w.record(1, np.zeros((N, 3)))  # not a multiple of every: dropped
    w.record(2, np.zeros((N, 3)))
    with pytest.raises(ValueError):
        w.record(4, np.zeros((N + 1, 3)))
    w.close()
    assert NativeTrajectoryReader(str(tmp_path / "s.gtrj")).steps == [2]
    with pytest.raises(ValueError):
        NativeTrajectoryWriter(str(tmp_path / "b.gtrj"), N, dtype=np.float16)


@pytest.mark.parametrize("native", [True, False])
def test_async_writer_writes_the_serial_bytes(tmp_path, native):
    frames, steps = _frames(np.float32), [1, 2, 3, 4, 5, 6]
    if native:
        serial = NativeTrajectoryWriter(str(tmp_path / "a.gtrj"), N)
        inner = NativeTrajectoryWriter(str(tmp_path / "b.gtrj"), N)
    else:
        serial = TrajectoryWriter(str(tmp_path / "a"), N, flush_every=4)
        inner = TrajectoryWriter(str(tmp_path / "b"), N, flush_every=4)
    host = HostWriter()
    _write(serial, frames, steps)
    _write(AsyncTrajectoryWriter(inner, host), frames, steps)
    host.close()
    if native:
        assert open(tmp_path / "a.gtrj", "rb").read() == \
            open(tmp_path / "b.gtrj", "rb").read()
    else:
        np.testing.assert_array_equal(
            TrajectoryReader(str(tmp_path / "a")).load(mmap=False),
            TrajectoryReader(str(tmp_path / "b")).load(mmap=False))


def test_run_writes_a_gtrj_file(tmp_path, capsys):
    log_dir = str(tmp_path / "logs")
    assert main(["run", "--device", "cpu", "--model", "random", "--n", "24",
                 "--steps", "6", "--trajectories", "--trajectory-format",
                 "native", "--log-dir", log_dir]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (path,) = glob.glob(os.path.join(log_dir, "trajectories_*.gtrj"))
    assert stats["trajectory_dir"] == path
    reader = JaxNativeReader(path)
    assert reader.steps == [1, 2, 3, 4, 5, 6] and reader.n == 24
    assert np.isfinite(reader.load()).all()
