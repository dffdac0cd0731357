"""Lease-based job ownership — the fleet-resilience substrate.

Copied from ``gravity_tpu/serve/leases.py`` (host only; the port keeps its
own copy).

The PR-3 spool made jobs *durable*; this module makes their *ownership*
explicit, so N daemon processes can share one spool directory (and a
pod-level router later can shard it) without ever running a job twice
or losing one to a dead host. Multi-node GPU simulation stacks treat
node loss as a framework event, not a user event (HOOMD-blue on GPU
clusters, arXiv 1009.4330; FDPS, arXiv 1907.02290) — the same posture
here, CPU-chaos-testable via utils/faults.py.

Contract (docs/robustness.md "Fleet failure modes"):

- **Claim**: a worker owns a job only while it holds the job's lease —
  ``leases/<job>.json`` with a TTL ``expires_ts``, the owner's
  ``worker``/``pid``, and a **fencing token**: an integer that
  increments on every (re)claim of that job, never reset. Claims are
  serialized through an ``fcntl.flock`` on ``leases/.lock`` (one spool
  = one host or one POSIX-lock filesystem — the pod router of ROADMAP
  item 1 replicates spools instead of stretching one over NFS).
- **Heartbeat**: the owner renews its leases (atomic ``os.replace``)
  every ``ttl/3``. The serving daemon renews from a dedicated thread so
  a minutes-long first compile cannot starve renewal.
- **Expiry / adoption**: a lease is dead when its TTL passed *or* its
  owning pid no longer exists (the same-host fast path — a SIGKILLed
  worker's jobs are adoptable immediately, no TTL wait). Any peer may
  then claim the job; the claim bumps the fence.
- **Fencing**: every spool write of a leased job carries the writer's
  fence. A write with a fence lower than the job's current one (lease
  file, or the fence persisted in the job record once the lease is
  gone) is rejected — a paused-then-resurrected worker cannot clobber
  its adopter's result. Validation and the ``os.replace`` happen under
  the same flock, so there is no check-then-write window.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

from ..utils.hostio import atomic_write_json, read_json_retry  # noqa: F401
# (read_json_retry re-exported: the serve modules read every lease /
# job / registry record through the one shared torn-read helper.)

try:
    import fcntl
except ImportError:  # non-POSIX: in-process locking only (documented)
    fcntl = None

# Same-host liveness: a lease whose owning pid is gone is dead NOW —
# adoption does not wait out the TTL for a kill -9'd worker.


def _local_host() -> str:
    import socket

    return socket.gethostname()


def _proc_stat_fields(pid: int) -> Optional[list]:
    """/proc/<pid>/stat fields AFTER the parenthesized (possibly
    space-ridden) comm — split after the last ')'. None off-Linux or
    when the pid is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()
    except (OSError, IndexError):
        return None


def pid_start(pid: int) -> Optional[str]:
    """The kernel's process start time (clock ticks since boot) — the
    (pid, starttime) pair identifies a process INSTANCE, so a recycled
    pid never impersonates the dead owner of a lease or registry
    entry. None when unknowable (off-Linux, process gone)."""
    fields = _proc_stat_fields(pid)
    # starttime is stat field 22; after the comm split, index 19.
    return fields[19] if fields is not None and len(fields) > 19 \
        else None


def _pid_alive(pid: int, start: Optional[str] = None) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, other uid
    except OSError:
        return True  # unknowable: err toward alive (TTL still bounds)
    fields = _proc_stat_fields(pid)
    if fields:
        # A SIGKILLed child that nobody reaped yet is a zombie: it
        # holds a pid but runs nothing — for lease purposes it is dead.
        if fields[0] == "Z":
            return False
        # Start-time identity: a RECYCLED pid (new process, same
        # number) is not the recorded process.
        if start is not None and len(fields) > 19 \
                and fields[19] != start:
            return False
    return True


def entry_alive(info: dict) -> bool:
    """Is a registry/daemon.json endpoint record's worker still alive,
    as far as we can tell from HERE? Same-host entries get the precise
    (pid, starttime) instance probe; a REMOTE host's pid cannot be
    probed locally — treat it as alive and let TTLs / connection
    attempts decide. The ONE liveness rule shared by client failover
    (service.find_daemon/_live_workers) and the scheduler's
    worker-registry reaper, so the two can never disagree about which
    workers are dead."""
    host = info.get("host_name")
    if host is not None and host != _local_host():
        return True
    try:
        pid = int(info.get("pid", 0) or 0)
    except (TypeError, ValueError):
        pid = 0
    return _pid_alive(pid, info.get("pid_start"))


@dataclasses.dataclass(frozen=True)
class Lease:
    job_id: str
    worker: str
    pid: int
    fence: int
    expires_ts: float
    renewed_ts: float
    # Owner process start time (see pid_start): with the pid it
    # identifies the process INSTANCE, so pid recycling cannot make a
    # dead owner look alive.
    pid_start: Optional[str] = None
    # Owner hostname: the pid-liveness fast path only applies to
    # leases owned by THIS host — on a multi-host shared spool a
    # remote worker's pid is meaningless locally, and probing it would
    # falsely declare a live peer dead. Remote leases expire by TTL
    # only.
    host: Optional[str] = None
    # Worker id of the lease this claim displaced (None for a fresh
    # claim) — the scheduler logs 'adopted' vs 'respooled' off it.
    adopted_from: Optional[str] = None

    def to_record(self) -> dict:
        return {
            "job": self.job_id, "worker": self.worker, "pid": self.pid,
            "pid_start": self.pid_start, "host": self.host,
            "fence": self.fence, "expires_ts": self.expires_ts,
            "renewed_ts": self.renewed_ts,
        }


class LeaseManager:
    """Claim / renew / release / adopt leases for one worker over one
    spool directory. Cross-process safety via flock; in-process safety
    (daemon worker thread vs heartbeat thread) via an RLock."""

    def __init__(self, root: str, worker_id: str, ttl_s: float = 30.0,
                 recorder=None):
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        self.dir = os.path.join(root, "leases")
        os.makedirs(self.dir, exist_ok=True)
        self.worker_id = worker_id
        self.ttl_s = float(ttl_s)
        # Telemetry hook (a FlightRecorder, or anything with
        # .record(kind, **fields)): lease transitions — claim/adopt,
        # release, loss-to-a-peer — are exactly what a crash
        # postmortem needs to sequence, so they join the ring.
        self.recorder = recorder
        self._lock_path = os.path.join(self.dir, ".lock")
        self._mu = threading.RLock()
        self._held: dict[str, Lease] = {}
        # Leases discovered LOST during any renewal (a peer adopted
        # while we were out) — queued here so the scheduler's
        # housekeeping reacts even when the renewal ran on the
        # dedicated heartbeat thread (whose return value nobody reads).
        self._lost_pending: list[str] = []
        self._last_renew = 0.0
        # Heartbeats suspended until this wall-clock time (stall /
        # stale_lease fault injection: "the process is paused").
        self._suspended_until = 0.0
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        # Callers holding the heartbeat (the daemon for its lifetime, a
        # result write while its bytes are in flight): it runs while any
        # does.
        self._hb_users = 0
        self._hb_mu = threading.Lock()

    def _record(self, op: str, /, **fields) -> None:
        if self.recorder is not None:
            try:
                self.recorder.record("lease", op=op, **fields)
            except Exception:  # noqa: BLE001 — telemetry never takes
                pass  # down the ownership protocol it observes

    # --- locking ---

    @contextmanager
    def locked(self):
        """The spool-wide lease critical section: every claim, renewal,
        release, and fenced spool write runs inside it."""
        with self._mu:
            if fcntl is None:
                yield
                return
            fd = os.open(self._lock_path, os.O_CREAT | os.O_RDWR)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX)
                yield
            finally:
                os.close(fd)  # closing drops the flock

    # --- lease file primitives ---

    def _path(self, job_id: str) -> str:
        return os.path.join(self.dir, f"{job_id}.json")

    def peek(self, job_id: str) -> Optional[Lease]:
        """The job's current on-disk lease (None: unleased or
        unreadable-after-retries — callers treat unreadable as expired
        and rely on ``min_fence`` to keep the token monotonic)."""
        rec = read_json_retry(self._path(job_id))
        if not isinstance(rec, dict) or "fence" not in rec:
            return None
        try:
            return Lease(
                job_id=rec.get("job", job_id),
                worker=str(rec.get("worker", "")),
                pid=int(rec.get("pid", 0)),
                pid_start=rec.get("pid_start"),
                host=rec.get("host"),
                fence=int(rec["fence"]),
                expires_ts=float(rec.get("expires_ts", 0.0)),
                renewed_ts=float(rec.get("renewed_ts", 0.0)),
            )
        except (TypeError, ValueError):
            return None

    def expired(self, lease: Lease, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        if now >= lease.expires_ts:
            return True
        if lease.host is not None and lease.host != _local_host():
            # A remote worker's pid cannot be probed from here: its
            # lease lives or dies by TTL alone.
            return False
        return not _pid_alive(lease.pid, lease.pid_start)

    # --- the ownership protocol ---

    def claim(self, job_id: str, *, min_fence: int = 0) -> Optional[Lease]:
        """Claim the job if it is unleased, expired, or already ours
        (re-claim refreshes). Returns the held lease (fence bumped past
        both the prior lease and ``min_fence`` — pass the job record's
        persisted fence so tokens stay monotonic even when a released
        lease file no longer carries history), or None while a live
        peer holds it."""
        with self.locked():
            now = time.time()
            cur = self.peek(job_id)
            adopted_from = None
            floor = min_fence
            if cur is None and os.path.exists(self._path(job_id)):
                # Present but unreadable after retries (corruption or
                # an injected torn write — real writes are atomic): the
                # live fence is invisible. The job record lags a live
                # lease by at most ONE claim (every claimant persists
                # the record immediately after claiming), so one extra
                # bump guarantees the minted token clears whatever the
                # unreadable file holds — two claimants can never mint
                # the same fence off a torn lease.
                floor = min_fence + 1
            if cur is not None:
                floor = max(floor, cur.fence)
                if cur.worker == self.worker_id:
                    # Re-claim of our own lease: keep the fence (it is
                    # still the newest grant), refresh the expiry AND
                    # the pid — a restarted worker reusing a fixed
                    # --worker-id must not keep advertising its dead
                    # predecessor's pid, or every peer's pid-liveness
                    # check would treat the live worker as adoptable.
                    lease = dataclasses.replace(
                        cur, pid=os.getpid(),
                        pid_start=pid_start(os.getpid()),
                        host=_local_host(),
                        expires_ts=now + self.ttl_s, renewed_ts=now,
                    )
                    atomic_write_json(
                        self._path(job_id), lease.to_record()
                    )
                    self._held[job_id] = lease
                    return lease
                if not self.expired(cur, now):
                    return None
                adopted_from = cur.worker
            lease = Lease(
                job_id=job_id, worker=self.worker_id, pid=os.getpid(),
                pid_start=pid_start(os.getpid()), host=_local_host(),
                fence=floor + 1, expires_ts=now + self.ttl_s,
                renewed_ts=now, adopted_from=adopted_from,
            )
            atomic_write_json(self._path(job_id), lease.to_record())
            self._held[job_id] = lease
            self._record("claim", job=job_id, fence=lease.fence,
                         adopted_from=adopted_from)
            return lease

    def release(self, job_id: str) -> None:
        """Drop our lease (job went terminal and its bytes are durable).
        Only deletes the file while OUR fence is still current — an
        adopter's lease is never removed by its zombie."""
        with self.locked():
            held = self._held.pop(job_id, None)
            if held is None:
                return
            cur = self.peek(job_id)
            if cur is not None and cur.fence == held.fence \
                    and cur.worker == self.worker_id:
                try:
                    os.remove(self._path(job_id))
                except OSError:
                    pass
            self._record("release", job=job_id, fence=held.fence)

    def renew_all(self, now: Optional[float] = None) -> list[str]:
        """Heartbeat: extend every held lease's TTL. Returns the job
        ids we discovered we LOST (a peer adopted while we were out) —
        the zombie drops them from its held set here; its in-flight
        writes are rejected by fencing regardless."""
        now = time.time() if now is None else now
        lost: list[str] = []
        with self.locked():
            if now < self._suspended_until:
                return []  # injected stall: the "paused process"
            self._last_renew = now
            for job_id, held in list(self._held.items()):
                cur = self.peek(job_id)
                if cur is None or cur.fence != held.fence \
                        or cur.worker != self.worker_id:
                    self._held.pop(job_id, None)
                    lost.append(job_id)
                    self._record(
                        "lost", job=job_id, our_fence=held.fence,
                        holder=None if cur is None else cur.worker,
                    )
                    continue
                lease = dataclasses.replace(
                    held, expires_ts=now + self.ttl_s, renewed_ts=now
                )
                atomic_write_json(self._path(job_id), lease.to_record())
                self._held[job_id] = lease
            self._lost_pending.extend(lost)
        return lost

    def take_lost(self) -> list[str]:
        """Drain the lost-lease queue (every renewal path feeds it —
        including the heartbeat thread's). The scheduler calls this
        from housekeeping and evicts the zombies locally; without the
        queue, a loss discovered on the heartbeat thread would go
        unnoticed until the fenced write at job completion."""
        with self._mu:
            out, self._lost_pending = self._lost_pending, []
        return out

    def maybe_renew(self) -> list[str]:
        """Rate-limited renewal for single-threaded consumers (the
        in-process scheduler heartbeats from its round loop; the daemon
        uses the dedicated thread)."""
        now = time.time()
        if now - self._last_renew < self.ttl_s / 3.0:
            return []
        return self.renew_all(now)

    def forget(self, job_id: str) -> None:
        """Drop a lease from the HELD set without touching its file —
        the zombie's reaction to discovering it was fenced out (the
        adopter's lease file must stay exactly as it is)."""
        with self._mu:
            self._held.pop(job_id, None)

    def held_fence(self, job_id: str) -> Optional[int]:
        with self._mu:
            held = self._held.get(job_id)
            return None if held is None else held.fence

    def held_ids(self) -> list[str]:
        with self._mu:
            return list(self._held)

    # --- fencing ---

    def fence_ok(self, job_id: str, fence: int, record_fence=0) -> bool:
        """Is ``fence`` still the newest grant for this job? Callers
        hold :meth:`locked` across this check AND their ``os.replace``
        so the validation cannot be overtaken mid-write. The job
        record's persisted fence backstops the released-lease case —
        pass it as a zero-arg callable to defer that (full-record) read
        to the rare no-lease path: a live lease always carries a fence
        >= the record's (the record is stamped FROM the lease), so the
        common case decides on the lease file alone."""
        cur = self.peek(job_id)
        if cur is not None:
            return fence >= cur.fence
        floor = record_fence() if callable(record_fence) else record_fence
        return fence >= int(floor or 0)

    # --- fault-injection surface (stall_worker / stale_lease) ---

    def suspend(self, secs: float) -> None:
        """Stop heartbeats for ``secs`` — the injected 'paused process'
        window (the heartbeat thread keeps running but renews nothing)."""
        with self._mu:
            self._suspended_until = max(
                self._suspended_until, time.time() + float(secs)
            )

    def backdate(self) -> None:
        """Rewrite every held lease as already-expired (fence kept):
        deterministic expiry for tests/chaos — peers can adopt NOW, no
        real sleep needed."""
        with self.locked():
            now = time.time()
            for job_id, held in list(self._held.items()):
                lease = dataclasses.replace(
                    held, expires_ts=now - 1.0, renewed_ts=now - 1.0
                )
                atomic_write_json(self._path(job_id), lease.to_record())
                self._held[job_id] = lease

    # --- heartbeat thread (daemon mode) ---

    def start_heartbeat(self) -> None:
        """Renew held leases every ttl/3 from a dedicated thread, so a
        long compile on the round thread cannot let leases lapse (a
        lapse is never UNSAFE — fencing catches the zombie — but it
        double-runs work). Counted: the thread runs until every
        ``start_heartbeat`` has had its ``stop_heartbeat``."""
        with self._hb_mu:
            self._hb_users += 1
            if self._hb_thread is not None:
                return
            stop = self._hb_stop = threading.Event()

            def _beat() -> None:
                while not stop.wait(self.ttl_s / 3.0):
                    try:
                        self.renew_all()
                    except Exception:  # noqa: BLE001 — a failed beat must
                        pass  # not kill the thread; the next one retries

            self._hb_thread = threading.Thread(
                target=_beat, daemon=True, name="gravity-lease-heartbeat"
            )
            self._hb_thread.start()

    def stop_heartbeat(self) -> None:
        with self._hb_mu:
            self._hb_users = max(0, self._hb_users - 1)
            thread = self._hb_thread
            if self._hb_users or thread is None:
                return
            self._hb_thread = None
            self._hb_stop.set()
        thread.join(timeout=5)

    @contextmanager
    def kept(self):
        """Hold the heartbeat while the body runs: a completed job's
        result write, which the round thread's renewal does not wait
        for, cannot outlive the lease it is fenced by."""
        self.start_heartbeat()
        try:
            yield
        finally:
            self.stop_heartbeat()

    def release_all(self) -> None:
        """Clean-shutdown path: release every held lease so a restarted
        or peer worker claims the jobs immediately (a SIGKILL skips
        this by definition — that is what expiry/adoption are for)."""
        for job_id in self.held_ids():
            self.release(job_id)
