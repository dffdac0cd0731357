"""The port's host I/O layer on the CPU: ``utils/hostio.py``'s
``HostWriter`` (order, backpressure, error surfacing, barrier, close),
its JSON helpers, and ``utils/timing.HostGapTimer``'s shapes, each
mirroring the JAX package's contract (``tests/test_io_pipeline.py``)."""

import json
import threading
import time

import pytest

from gravity_tpu.utils.timing import HostGapTimer as JaxHostGapTimer
from gravity_tpu_torch.utils.hostio import (
    HostWriter,
    atomic_write_json,
    read_json_retry,
)
from gravity_tpu_torch.utils.timing import HostGapTimer


def test_hostwriter_orders_and_propagates_errors():
    out = []
    w = HostWriter(max_queue=2)
    for i in range(20):
        w.submit(out.append, i)
    w.barrier()
    assert out == list(range(20))

    def boom():
        raise OSError("disk full")

    w.submit(boom)
    w.submit(out.append, 99)  # skipped: nothing is written past a failure
    with pytest.raises(OSError, match="disk full"):
        w.barrier()
    assert 99 not in out
    with pytest.raises(OSError, match="disk full"):
        w.submit(out.append, 100)
    with pytest.raises(OSError, match="disk full"):
        w.close()


def test_hostwriter_close_without_raising_and_after_close():
    w = HostWriter()
    w.submit(lambda: (_ for _ in ()).throw(ValueError("bad")))
    w.close(raise_errors=False)  # an error path: swallowed here
    with pytest.raises(ValueError, match="bad"):
        w.submit(print)
    w2 = HostWriter()
    w2.close()
    with pytest.raises(RuntimeError, match="closed"):
        w2.submit(print)


def test_hostwriter_backpressure_blocks_the_producer():
    """A full queue blocks submit until the worker frees a slot."""
    gate = threading.Event()
    w = HostWriter(max_queue=1)
    w.submit(gate.wait)  # taken by the worker, which blocks
    time.sleep(0.05)
    w.submit(lambda: None)  # fills the one slot
    done = threading.Event()

    def producer():
        w.submit(lambda: None)
        done.set()

    t = threading.Thread(target=producer)
    t.start()
    assert not done.wait(0.2)  # blocked: the queue is full
    gate.set()
    assert done.wait(5.0)
    t.join()
    w.close()


def test_hostwriter_rejects_empty_queue():
    with pytest.raises(ValueError):
        HostWriter(max_queue=0)


def test_atomic_write_and_read_json_retry(tmp_path):
    path = str(tmp_path / "x.json")
    assert read_json_retry(path) is None
    atomic_write_json(path, {"a": 1})
    assert read_json_retry(path) == {"a": 1}
    assert [p.name for p in tmp_path.iterdir()] == ["x.json"]
    (tmp_path / "torn.json").write_text('{"a": ')
    assert read_json_retry(str(tmp_path / "torn.json"), attempts=2) is None


def _drive(timer, pipelined: bool, blocks=5, dt=0.01):
    """Simulate a loop: a block takes dt of device time; the consume step
    takes dt of host time."""
    if pipelined:
        timer.dispatched()
        for _ in range(blocks - 1):
            timer.dispatched()
            time.sleep(dt)  # block k+1 runs while block k is consumed
            timer.completed()
            time.sleep(dt)
        time.sleep(dt)
        timer.completed()
    else:
        for _ in range(blocks):
            timer.dispatched()
            time.sleep(dt)
            timer.completed()
            time.sleep(dt)  # host work with nothing in flight
    timer.finish()
    return timer.host_gap_frac


@pytest.mark.parametrize("cls", [HostGapTimer, JaxHostGapTimer])
def test_host_gap_timer_sync_vs_pipelined_shapes(cls):
    """The serial loop shows its host tax (~half here); the pipeline keeps
    a block in flight and shows (almost) none. The same shapes in both
    packages' timers."""
    serial = _drive(cls(), pipelined=False)
    pipelined = _drive(cls(), pipelined=True)
    assert 0.3 < serial < 0.7
    assert pipelined < 0.1
    assert cls().host_gap_frac is None


def test_host_gap_timer_finish_counts_the_tail():
    timer = HostGapTimer()
    timer.dispatched()
    timer.completed()
    time.sleep(0.05)  # the last block's writes: idle
    timer.finish()
    assert timer.host_gap_frac > 0.9
    assert timer.inflight == 0 and timer.span_s >= 0.05


def test_read_json_retry_recovers_a_concurrent_replace(tmp_path):
    path = str(tmp_path / "r.json")
    atomic_write_json(path, {"v": 0})

    def writer():
        for i in range(50):
            atomic_write_json(path, {"v": i})

    t = threading.Thread(target=writer)
    t.start()
    for _ in range(50):
        got = read_json_retry(path)
        assert got is not None and "v" in got
    t.join()
    assert json.loads(open(path).read()) == {"v": 49}
