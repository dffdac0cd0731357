"""The port's ``traj`` verb (``gravity_tpu_torch/utils/gtrj_tool.py``)
against the JAX package's (``gravity_tpu/cli.py`` ``cmd_traj``, which
builds and runs the C++ inspector ``runtime/gtrj_tool.cpp`` with g++), on
the CPU. On ``.gtrj`` files written by the port and by the JAX package's
C++ writer, f32 and f64, one frame and several, the port's stdout,
stderr and exit code equal the JAX verb's byte for byte: ``info``,
``stats`` (C's ``%g`` of sums in double in index order), ``dump`` (its
``%.9g``; frames from the end, out of range on either side, every count
form), the tool's errors; and ``export`` writes the same arrays. The
verb touches no device.
"""

import os
import shutil

import numpy as np
import pytest

from gravity_tpu.cli import main as jax_main
from gravity_tpu.utils.native import gtrj_tool_path
from gravity_tpu.utils.trajectory import (
    NativeTrajectoryWriter as JaxNativeWriter,
)
from gravity_tpu_torch.cli import main as port_main
from gravity_tpu_torch.utils.trajectory import NativeTrajectoryWriter

N = 23


def frames(dtype, count, seed=3):
    """Positions over many decades and signs, so that %g takes each of
    its forms (fixed, exponent, trailing zeros stripped)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        x = rng.standard_normal((N, 3)) * 10.0 ** rng.integers(-6, 14,
                                                               (N, 1))
        x[0] = (1.0, -0.0, 12345.678)
        out.append(x.astype(dtype))
    return out


def write(path, writer, dtype, count):
    w = writer(str(path), N, dtype=dtype)
    for i, x in enumerate(frames(dtype, count)):
        w.record(10 * (i + 1), x)
    w.close()
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(name, path) of each file: both writers, f32 and f64, 1 and 7
    frames; a frame with inf and NaN; a torn last frame; and three that
    are not GTRJ v1."""
    assert gtrj_tool_path() is not None, "g++ builds the JAX inspector"
    root = tmp_path_factory.mktemp("gtrj")
    out = {}
    for wname, writer in (("port", NativeTrajectoryWriter),
                          ("jax", JaxNativeWriter)):
        for dtype in (np.float32, np.float64):
            for count in (1, 7):
                name = f"{wname}_{np.dtype(dtype).name}_{count}"
                out[name] = write(root / f"{name}.gtrj", writer, dtype,
                                  count)
    odd = NativeTrajectoryWriter(str(root / "odd.gtrj"), N,
                                 dtype=np.float64)
    x = frames(np.float64, 2)
    odd.record(0, x[0])
    x[1][3] = (np.inf, np.nan, -np.inf)
    odd.record(5, x[1])
    odd.close()
    out["odd"] = str(root / "odd.gtrj")
    torn = root / "torn.gtrj"
    shutil.copy(out["port_float32_7"], torn)
    with open(torn, "r+b") as f:
        f.truncate(os.path.getsize(torn) - 17)
    out["torn"] = str(torn)
    good = open(out["port_float32_1"], "rb").read()
    (root / "notgtrj.gtrj").write_bytes(b"NOPE" + good[4:])
    (root / "v2.gtrj").write_bytes(good[:4] + b"\x02" + good[5:])
    (root / "short.gtrj").write_bytes(good[:10])
    for name in ("notgtrj", "v2", "short"):
        out[name] = str(root / f"{name}.gtrj")
    out["missing"] = str(root / "missing.gtrj")
    return out


def both(capfd, argv):
    """(stdout, stderr, exit code) of the JAX verb, then the port's."""
    results = []
    for main in (jax_main, port_main):
        rc = main(["traj", *argv])
        out, err = capfd.readouterr()
        results.append((out, err, rc))
    return results


VALID = [f"{w}_{d}_{c}" for w in ("port", "jax")
         for d in ("float32", "float64") for c in (1, 7)] + ["odd", "torn"]


@pytest.mark.parametrize("name", VALID)
@pytest.mark.parametrize("command", ["info", "stats"])
def test_info_and_stats_are_the_tools_bytes(files, capfd, name, command):
    jax, port = both(capfd, [command, files[name]])
    assert jax[2] == 0 and jax[0]
    assert port == jax


@pytest.mark.parametrize("name", ["port_float32_7", "jax_float64_7",
                                  "port_float64_1", "odd", "torn"])
@pytest.mark.parametrize("frame,count", [
    (0, 10), (-1, 5), (3, 0), (-7, -3), (2, 1000), (-2, 23), (6, 1),
    (7, 10), (-8, 10), (1, 10)])
def test_dump_is_the_tools_bytes(files, capfd, name, frame, count):
    jax, port = both(capfd, ["dump", files[name], "--frame", str(frame),
                             "--count", str(count)])
    assert port == jax
    if jax[2] == 2:
        assert jax[0] == "" and "out of range" in jax[1]


@pytest.mark.parametrize("name", ["notgtrj", "v2", "short", "missing"])
@pytest.mark.parametrize("command", ["info", "stats", "dump"])
def test_errors_are_the_tools(files, capfd, name, command):
    jax, port = both(capfd, [command, files[name]])
    assert jax[2] == 2 and jax[0] == "" and jax[1]
    assert port == jax


@pytest.mark.parametrize("name", ["port_float32_7", "jax_float64_1"])
def test_export_writes_the_same_arrays(files, capfd, tmp_path, name):
    arrays = []
    for main, sub in ((jax_main, "jax"), (port_main, "port")):
        d = tmp_path / sub
        d.mkdir()
        path = str(d / "t.gtrj")
        shutil.copy(files[name], path)
        assert main(["traj", "export", path]) == 0
        out, _ = capfd.readouterr()
        arrays.append((np.load(str(d / "t_positions.npy")),
                       np.load(str(d / "t_steps.npy")),
                       out.replace(str(d), "D")))
    (jp, js, jout), (pp, ps, pout) = arrays
    assert jp.dtype == pp.dtype and np.array_equal(jp, pp)
    assert np.array_equal(js, ps) and pout == jout


def test_the_verb_touches_no_device(files, capfd, monkeypatch):
    """traj never resolves a device: it runs where CUDA cannot be asked."""
    import torch

    def no_cuda(*a, **k):
        raise AssertionError("traj asked for a device")

    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    monkeypatch.setattr("gravity_tpu_torch.utils.platform.resolve_device",
                        no_cuda)
    assert port_main(["traj", "stats", files["port_float32_7"]]) == 0
    capfd.readouterr()
