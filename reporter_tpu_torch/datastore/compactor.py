"""Background compaction: the delta-pressure policy off the flush path.

An inline pressure check on the worker tee's ingest would make every
flush that tips a partition over pressure pay the whole merge (hundreds
of ms of staged fsyncs) inside the flush. This thread takes it off that
path: a paced loop, owned by WHICHEVER process holds the writer lease
(:mod:`lease`), that sweeps the store for partitions over the same
``max_deltas`` / ``max_delta_bytes`` thresholds and compacts them out of
band. A process that does not hold the lease skips its pass (counted)
instead of contending, so exactly one compactor is live per store root.
The port of ``reporter_tpu/datastore/compactor.py``.

The sweep also maintains the delta-pressure BACKLOG gauge
(``pending()``): how many partitions sit over pressure and how many
uncompacted delta segments/bytes they carry — surfaced on ``/health``
and the worker heartbeat, so "compaction is falling behind" is a gauge
long before it is a slow query.

``BackgroundCompactor(interval_s=)`` paces the loop (``DEFAULT_INTERVAL_S``,
5 s, the JAX package's ``REPORTER_TPU_COMPACT_INTERVAL_S`` default; ``0``
disables the thread: callers then keep an inline policy).
"""
from __future__ import annotations

import logging
import threading
from typing import Optional

from ..utils import metrics
from .lease import LeaseHeldElsewhere

logger = logging.getLogger("reporter_tpu_torch.datastore")


#: seconds between two passes unless given (0 = no thread)
DEFAULT_INTERVAL_S = 5.0


class BackgroundCompactor:
    """Paced compaction thread over one store (see module docstring)."""

    def __init__(self, store, max_deltas: Optional[int] = None,
                 max_delta_bytes: Optional[int] = None,
                 interval_s: float = DEFAULT_INTERVAL_S):
        self.store = store
        self.max_deltas = max_deltas
        self.max_delta_bytes = max_delta_bytes
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # last completed sweep's backlog gauge (plain dict swap under
        # the GIL: readers get the old or the new snapshot, never a
        # mix) + the flagged partition list that sweep found
        self._backlog = {"partitions_over": 0, "delta_segments": 0,
                         "delta_bytes": 0}
        self._over: list = []

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "BackgroundCompactor":
        if self._thread is None and self.interval_s > 0:
            # a stop()ed compactor must be restartable: a set event
            # would make the fresh thread's first wait() return
            # immediately and die silently
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="datastore-compactor", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Signal + JOIN (the worker's drain order: no thread may outlive
        the store handles its owner is about to drop)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.run_once()
            except Exception as e:  # keep pacing through transient I/O
                logger.error("compactor pass failed (will retry): %s", e)

    # -- one pass ----------------------------------------------------------
    def run_once(self) -> dict:
        """One sweep: refresh the backlog gauge, then compact exactly
        the partitions that sweep flagged — IF this process holds the
        lease. The gauge's flagged list DRIVES the compaction (no
        second whole-store walk); ``_maybe_compact_partition``
        re-checks each flagged partition's pressure at compaction
        time, through the same shared predicate, so a partition
        another process compacted meanwhile is skipped, not
        re-merged."""
        metrics.count("datastore.compactor.passes")
        # freshness maintenance rides the paced pass, BEFORE the
        # lease-gated compaction (both are read-only — every process
        # runs them, leased or not): viewport materialisations refresh
        # off the hot path, and the feed's store watcher publishes
        # tile events for commits other processes made
        fresh = getattr(self.store, "freshness", None)
        if fresh is not None:
            try:
                fresh.on_compactor_pass()
            except Exception as e:
                logger.error("freshness pass failed (will retry): %s", e)
        backlog = self.pending(refresh=True)
        if not backlog["partitions_over"]:
            return {"compacted": 0, "backlog": backlog}
        if not self.store.lease.acquire():
            # another process owns the store right now; it runs the
            # compactor, we keep gauging
            metrics.count("datastore.compactor.unleased")
            return {"compacted": 0, "backlog": backlog, "unleased": True}
        compacted = 0
        try:
            for level, index in self._over:
                if self.store._maybe_compact_partition(
                        level, index, self.max_deltas,
                        self.max_delta_bytes) is not None:
                    compacted += 1
            if compacted:
                metrics.count("datastore.compactor.compacted", compacted)
        except LeaseHeldElsewhere:
            # stolen between acquire and commit (expiry under load):
            # drop the pass, the new holder's compactor takes over
            metrics.count("datastore.compactor.unleased")
        self.pending(refresh=True)
        return {"compacted": compacted, "backlog": self._backlog}

    # -- backlog gauge -----------------------------------------------------
    def pending(self, refresh: bool = False) -> dict:
        """{"partitions_over", "delta_segments", "delta_bytes"} of the
        last sweep (cached — /health and heartbeats must never pay a
        store walk); ``refresh=True`` recomputes (the paced loop) and
        records the flagged partition list run_once compacts from."""
        if refresh:
            from .store import pressure_exceeded
            over: list = []
            segs = nbytes = 0
            for level, index in list(self.store.partitions()):
                pdir = self.store.partition_dir(level, index)
                names = self.store._read_manifest(pdir)["segments"]
                n, total = self.store._delta_pressure(pdir, names)
                if pressure_exceeded(n, total, self.max_deltas,
                                     self.max_delta_bytes):
                    over.append((level, index))
                    segs += n
                    nbytes += total
            self._over = over
            self._backlog = {"partitions_over": len(over),
                             "delta_segments": segs,
                             "delta_bytes": nbytes}
        return dict(self._backlog)


__all__ = ["BackgroundCompactor", "DEFAULT_INTERVAL_S"]
