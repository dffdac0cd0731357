"""Bounded-queue background host I/O: the writer half of the block pipeline.

Counterpart of ``gravity_tpu/utils/hostio.py``. The block loop's host
work (trajectory writes, checkpoint checksum and save) would otherwise
run between device blocks with nothing in flight. :class:`HostWriter`
moves it onto one background thread behind a bounded queue:

- **Ordering**: one FIFO queue, one worker, so tasks run in submission
  order: checkpoint steps stay monotone and trajectory frames land in
  step order.
- **Backpressure**: a producer that outruns the disk blocks in
  :meth:`HostWriter.submit` instead of buffering frames without limit (a
  frame of 1M bodies is 12 MB).
- **Failure**: the first task exception is kept, every later task is
  skipped, and the error re-raises on the producer at the next
  :meth:`~HostWriter.submit`, :meth:`~HostWriter.barrier` or
  :meth:`~HostWriter.close`: a full disk fails the run.
- **Hard barrier**: :meth:`HostWriter.barrier` drains the queue; the run
  loop calls it before every emergency checkpoint.

The worker is handed host (numpy or CPU tensor) data only, already
fenced by the run loop: it never touches a CUDA tensor.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Optional

_SENTINEL = object()


def read_json_retry(
    path: str, attempts: int = 4, delay_s: float = 0.002
) -> Optional[dict]:
    """Read a JSON file that a concurrent writer may be replacing: retry a
    torn or partial parse a few times, then give up with None (also None
    for a missing file)."""
    for i in range(attempts):
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            if i + 1 < attempts:
                time.sleep(delay_s)
    return None


def atomic_write_json(path: str, obj: dict, *,
                      fault_injection: bool = True) -> None:
    """Write ``obj`` as JSON to ``path`` through a temporary file and
    ``os.replace``, so that readers never see a half-written file.

    An armed ``torn_spool_write`` fault (utils/faults.py) makes this call
    write a truncated document straight to ``path`` and return, like a
    writer that died mid-write; ``fault_injection=False`` opts a
    best-effort stream (metrics publication, progress meta records) out
    of that injection point."""
    payload = json.dumps(obj)
    if fault_injection:
        from .faults import torn_write_due

        if torn_write_due():
            with open(path, "w") as f:
                f.write(payload[: max(1, len(payload) // 3)])
            return
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(payload)
    os.replace(tmp, path)


class HostWriter:
    """One background thread executing submitted callables in order."""

    def __init__(self, max_queue: int = 4, name: str = "gravity-hostio"):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._error: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name=name, daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while True:
            task = self._q.get()
            try:
                if task is _SENTINEL:
                    return
                if self._error is None:
                    fn, args, kwargs = task
                    try:
                        fn(*args, **kwargs)
                    except BaseException as e:  # noqa: BLE001 — kept and
                        self._error = e  # re-raised on the producer
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._error is not None:
            raise self._error

    def submit(self, fn, *args, **kwargs) -> None:
        """Enqueue ``fn(*args, **kwargs)``; blocks while the queue is full.
        Raises any earlier background failure."""
        self._raise_pending()
        if self._closed:
            raise RuntimeError("HostWriter is closed")
        self._q.put((fn, args, kwargs))

    def try_submit(self, fn, *args, reserve: int = 0, **kwargs) -> bool:
        """Non-blocking :meth:`submit` for best-effort work (progress
        snapshots): False instead of blocking when the queue is full.
        ``reserve`` keeps that many slots free for the mandatory writers'
        blocking submits."""
        self._raise_pending()
        if self._closed:
            raise RuntimeError("HostWriter is closed")
        if reserve > 0 and \
                self._q.qsize() >= max(1, self._q.maxsize - reserve):
            return False
        try:
            self._q.put_nowait((fn, args, kwargs))
            return True
        except queue.Full:
            return False

    def barrier(self) -> None:
        """Block until every submitted task has run; raise the first
        background failure if one occurred."""
        self._q.join()
        self._raise_pending()

    def close(self, raise_errors: bool = True) -> None:
        """Drain the remaining tasks and stop the thread. With
        ``raise_errors=False`` (an exception may already be propagating)
        a background failure is not raised here."""
        if not self._closed:
            self._closed = True
            self._q.put(_SENTINEL)
            self._thread.join()
        if raise_errors:
            self._raise_pending()
