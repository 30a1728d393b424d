"""Cross-process writer lease over one store root.

Several processes can point at one store directory (pre-forked serving
slots, the dead-letter drainer, the worker's tee), and the commit
protocol in :mod:`store` is serialised only by an in-process lock: two
processes compacting the same partition would interleave ``seq`` bumps
and manifest rewrites, and one writer's committed segment would vanish
from the manifest the other writes last. So every mutating entry point
(``append``/``ingest_*``/``compact``) must hold a single ``.lease`` file
in the store root. The port of ``reporter_tpu/datastore/lease.py``.

Protocol — deadline lease, flock-guarded critical section:

- The lease STATE is the file's JSON body ``{"pid", "deadline"}``
  (wall-clock epoch seconds; monotonic clocks are not comparable
  across processes). Holding the lease means *your pid is in the file
  and the deadline has not passed*.
- Every read-modify-write of that state runs under an exclusive
  ``fcntl.flock`` on the file — the flock serialises acquire attempts,
  so two stealers can never both write themselves in; it is NOT held
  between mutations (a SIGKILL'd holder would otherwise pin it until
  fd close anyway, but the deadline must also bound a *stuck* live
  holder).
- A non-holder may STEAL when the recorded deadline has expired or the
  recorded pid no longer exists (``os.kill(pid, 0)``): a holder
  SIGKILLed mid-compaction is taken over cleanly by the next process.
- The holder refreshes its deadline lazily: a mutation only rewrites
  the file when less than half the TTL remains, so an append-heavy
  tee pays one flock'd write per ``ttl/2``, not per flush.

``StoreLease(ttl_s=)`` is the TTL (``DEFAULT_TTL_S``, 30 s, as the JAX
package's ``REPORTER_TPU_STORE_LEASE_S`` default; ``0`` disables the
lease entirely: every acquire succeeds without touching disk, the
single-process fast path). Counters surface as
``datastore.lease.*`` and the holder state on ``/health``.

The lease file is coordination state, not data: a torn body parses as
"no holder" and the flock around every read/write keeps that from ever
granting two live writers at once — so it deliberately skips the fsio
durability protocol.
"""
from __future__ import annotations

import errno
import json
import logging
import os
import time
from typing import Optional

from ..utils import faults, metrics
from ..utils import locks as _locks

try:  # pragma: no cover - fcntl is always present on the Linux targets
    import fcntl
except ImportError:  # non-POSIX fallback: flock degrades to a no-op
    fcntl = None

logger = logging.getLogger("reporter_tpu_torch.datastore")

LEASE_NAME = ".lease"


#: the TTL a lease takes unless given one (seconds)
DEFAULT_TTL_S = 30.0


class LeaseHeldElsewhere(RuntimeError):
    """A mutating store call was refused: another live process holds the
    writer lease. The worker tee catches this like any tee failure and
    spools the tile body to the dead-letter layout (replayable once the
    lease frees up); ``ingest_dir`` aborts WITHOUT quarantining."""


class StoreLease:
    """The writer lease of one store root (see module docstring).

    One instance per :class:`~.store.HistogramStore`;
    holder identity is the PROCESS (pid), so several store objects in
    one process share holdership — exactly the scope the old in-process
    lock pretended to cover. ``owner_pid`` is overridable so tests can
    impersonate a foreign live process without forking.
    """

    def __init__(self, root: str, ttl_s: float = DEFAULT_TTL_S):
        self.root = root
        self.path = os.path.join(root, LEASE_NAME)
        self._ttl = float(ttl_s)
        #: None = this process (``os.getpid()`` read at use time, so a
        #: forked child automatically identifies as itself); tests set
        #: a foreign live pid to simulate another process's holdership
        #: without forking
        self.owner_pid: Optional[int] = None
        # local belief: the wall-clock deadline we last wrote for
        # ourselves (0 = not holding) and the identity that wrote it.
        # Guarded by _lock; a belief written under another identity
        # (pre-fork parent) is discarded, never inherited.
        self._deadline = 0.0
        self._belief_pid = 0
        self._lock = _locks.new_lock("datastore.lease")

    def _me(self) -> int:
        return self.owner_pid if self.owner_pid is not None \
            else os.getpid()

    @property
    def ttl_s(self) -> float:
        return self._ttl

    def enabled(self) -> bool:
        return self.ttl_s > 0

    # -- acquisition -------------------------------------------------------
    def acquire(self) -> bool:
        """Take or refresh the lease; False when a live, unexpired
        foreign holder has it. Fast path: while more than half our TTL
        remains, no disk is touched."""
        ttl = self.ttl_s
        if ttl <= 0:
            return True
        with self._lock:
            if self._belief_pid != self._me():
                # forked child (or re-identified test lease): the
                # recorded holdership belief is not ours
                self._deadline = 0.0
            now = time.time()
            if self._deadline - now > ttl / 2.0:
                return True
            return self._acquire_slow(now, ttl)

    def require(self) -> None:
        """``acquire`` or raise :class:`LeaseHeldElsewhere`."""
        if not self.acquire():
            metrics.count("datastore.lease.rejected")
            raise LeaseHeldElsewhere(
                f"writer lease on {self.root} held by another process "
                f"(see {self.path}); spool or retry after expiry")

    def _acquire_slow(self, now: float, ttl: float) -> bool:
        """Flock'd read-modify-write of the lease file; _lock held."""
        # failure domain: an injected lease fault or a real I/O
        # error on the lease file refuses the mutation — callers spool/
        # retry, they never tear a manifest on an unknown lease state
        faults.failpoint("datastore.lease")
        me = self._me()
        os.makedirs(self.root, exist_ok=True)
        fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            if fcntl is not None:
                fcntl.flock(fd, fcntl.LOCK_EX)
            state = self._read_state(fd)
            holder = state.get("pid")
            deadline = float(state.get("deadline") or 0.0)
            if holder is not None and holder != me \
                    and deadline > now and _pid_alive(holder):
                self._deadline = 0.0
                return False
            if holder is None or holder == me:
                if self._deadline <= 0.0:
                    metrics.count("datastore.lease.acquires")
                else:
                    metrics.count("datastore.lease.renewals")
            else:
                # foreign holder, but expired or dead: take over
                metrics.count("datastore.lease.steals")
                if deadline <= now:
                    metrics.count("datastore.lease.expired")
                logger.warning(
                    "stealing writer lease on %s from pid %s (%s)",
                    self.root, holder,
                    "expired" if deadline <= now else "dead")
            self._deadline = now + ttl
            self._belief_pid = me
            self._write_state(fd, {"pid": me,
                                   "deadline": self._deadline})
            return True
        finally:
            os.close(fd)  # releases the flock

    def release(self) -> None:
        """Give the lease up (clean shutdown); no-op when not held."""
        if self.ttl_s <= 0:
            return
        with self._lock:
            if self._deadline <= 0.0:
                return
            self._deadline = 0.0
            try:
                fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
            except OSError:
                return
            try:
                if fcntl is not None:
                    fcntl.flock(fd, fcntl.LOCK_EX)
                if self._read_state(fd).get("pid") == self._me():
                    self._write_state(fd, {})
                metrics.count("datastore.lease.releases")
            finally:
                os.close(fd)

    # -- introspection -----------------------------------------------------
    def held(self) -> bool:
        """Do WE currently believe we hold an unexpired lease (no disk
        I/O — the /health gauge, not an acquisition)."""
        if self.ttl_s <= 0:
            return True
        with self._lock:
            return self._belief_pid == self._me() \
                and self._deadline > time.time()

    def snapshot(self) -> dict:
        """Holder view for /health: who the FILE says holds it, plus
        whether this process is that holder."""
        ttl = self.ttl_s
        if ttl <= 0:
            return {"enabled": False}
        state = {}
        try:
            with open(self.path, encoding="utf-8") as f:
                state = json.loads(f.read() or "{}")
        except (OSError, ValueError):
            pass
        deadline = float(state.get("deadline") or 0.0)
        return {"enabled": True, "ttl_s": ttl,
                "holder_pid": state.get("pid"),
                "expires_in_s": round(deadline - time.time(), 3)
                if deadline else None,
                "held_by_us": self.held()}

    # -- file body ---------------------------------------------------------
    @staticmethod
    def _read_state(fd: int) -> dict:
        try:
            os.lseek(fd, 0, os.SEEK_SET)
            raw = os.read(fd, 4096)
            got = json.loads(raw.decode("utf-8") or "{}")
            return got if isinstance(got, dict) else {}
        except (OSError, ValueError):
            # a torn body is "no holder": safe, because every writer of
            # this file sits behind the same flock we hold right now
            return {}

    @staticmethod
    def _write_state(fd: int, state: dict) -> None:
        body = json.dumps(state).encode("utf-8")
        os.lseek(fd, 0, os.SEEK_SET)
        os.truncate(fd, 0)
        os.write(fd, body)


def _pid_alive(pid) -> bool:
    try:
        os.kill(int(pid), 0)
    except (ProcessLookupError, ValueError):
        return False
    except OSError as e:  # EPERM: alive, owned by someone else
        return e.errno == errno.EPERM
    return True


__all__ = ["StoreLease", "LeaseHeldElsewhere", "LEASE_NAME",
           "DEFAULT_TTL_S"]
