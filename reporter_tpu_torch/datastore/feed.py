"""The change feed: a monotone per-store cursor over recent ingests.

A dashboard polling ``/histogram?bbox=…`` on a timer pays a full bbox
sweep whether anything changed or not. The feed inverts that: ``/feed?bbox=…&cursor=N`` long-polls until an ingest
lands inside the viewport (or the timeout elapses), and each response
carries the next cursor, so a subscriber sees every change exactly once
in order and sweeps only when told something moved.

Two event sources, one cursor:

- **delta events** — the in-process ingest hook (freshness.py): the
  worker tee's flush publishes the touched partition + its segment ids
  the instant the append commits. In-process delivery is a condition
  notify — no sleep-polling anywhere on this path.
- **tile events** — the store watcher: the pre-fork fleet's overlays
  are per-process, so a serving process long-polling on behalf of a
  subscriber periodically diffs every partition's manifest ``seq``
  (``ChangeFeed(poll_s=)`` paces it; one designated waiter
  scans per tick, never the whole herd) and publishes a segment-less
  "this tile changed" event for commits another process made.

Cursor semantics: the cursor
is a monotone per-process integer; ``cursor=N`` returns events with
``seq > N``; ``cursor=-1`` means "from now". The event ring is bounded
(``RING_EVENTS``); a subscriber whose cursor fell behind the ring gets
``resync: true`` and must re-query its viewport once — loss is always
EXPLICIT, never silent.

Load shedding: the waiter table is bounded (``ChangeFeed(max_waiters_n=)``);
past it, a poll sheds
immediately with :class:`FeedOverload` → 429 + ``Retry-After`` — an
explicit retry signal, before the long-poll would pin another handler
thread. The serving layer additionally sheds subscribers when the
pressure ladder climbs (server.py), so feed fan-out degrades before
the match path does. The port of ``reporter_tpu/datastore/feed.py``; the
JAX package's ``REPORTER_TPU_FRESHNESS_WAITERS`` and
``REPORTER_TPU_FRESHNESS_POLL_S`` are the arguments ``max_waiters_n``
(``DEFAULT_MAX_WAITERS``) and ``poll_s`` (``DEFAULT_POLL_S``).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import metrics
from ..utils import locks as _locks
from .schema import CELLS_PER_SEGMENT

#: bounded event ring: a subscriber further behind than this must
#: resync (re-query its viewport) — the bound is what keeps an idle
#: subscriber from pinning unbounded history in memory
RING_EVENTS = 4096

#: max segment ids carried per delta event (a huge flush truncates,
#: explicitly — the subscriber re-queries the tile instead)
EVENT_SEGMENTS_CAP = 256

#: back-off handed to a shed subscriber (seconds) — the same
#: Retry-After contract the admission gate's 429s carry
FEED_RETRY_AFTER_S = 5


#: long-poll waiters a feed holds before it sheds
DEFAULT_MAX_WAITERS = 1024

#: seconds between two store-watch scans, and a long-poll's wait slice
DEFAULT_POLL_S = 0.25


class FeedOverload(RuntimeError):
    """A shed subscriber's explicit retry signal (mirrors
    service.admission.Overload's shape so the HTTP layer maps both to
    429 + Retry-After through one path)."""

    def __init__(self, reason: str, retry_after_s: int):
        super().__init__(reason)
        self.reason = reason
        self.retry_after_s = retry_after_s


class FeedEvent:
    """One change: a partition that gained data. ``kind`` is ``delta``
    (in-process ingest, carries segment ids) or ``tile`` (store
    watcher, another process committed — segment ids unknown here, the
    subscriber sweeps the tile)."""

    __slots__ = ("seq", "kind", "level", "index", "segments",
                 "truncated", "rows", "arrival", "map_version")

    def __init__(self, seq: int, kind: str, level: int, index: int,
                 segments: List[int], truncated: bool, rows: int,
                 arrival: float, map_version: Optional[str] = None):
        self.seq = seq
        self.kind = kind
        self.level = level
        self.index = index
        self.segments = segments
        self.truncated = truncated
        self.rows = rows
        self.arrival = arrival
        # graph epoch of the producing ingest (graph/version.py); an
        # ``epoch`` event announces a hot swap and carries the NEW
        # version — a cursor held across the swap sees the boundary
        # explicitly instead of merging deltas from two maps
        self.map_version = map_version

    def to_wire(self) -> dict:
        out = {"seq": self.seq, "kind": self.kind, "level": self.level,
               "tile_index": self.index, "segments": self.segments,
               "rows": self.rows, "arrival": round(self.arrival, 3)}
        if self.truncated:
            out["truncated"] = True
        if self.map_version is not None:
            out["map_version"] = self.map_version
        return out


class ChangeFeed:
    """Monotone cursor + bounded event ring + long-poll waiters over
    one store (see module docstring)."""

    def __init__(self, store, clock=None,
                 max_waiters_n: int = DEFAULT_MAX_WAITERS,
                 poll_s: float = DEFAULT_POLL_S,
                 ring_events: int = RING_EVENTS):
        self.store = store
        self.clock = clock or time.time
        self.max_waiters = int(max_waiters_n)
        self.poll_s = float(poll_s)
        self._cond = threading.Condition(_locks.new_lock("freshness.feed"))
        self._ring: "deque[FeedEvent]" = deque(maxlen=ring_events)
        self._seq = 0
        self._waiters = 0
        self._shed = 0
        # store watcher state: per-partition manifest seq at last scan;
        # None until the first scan baselines (which emits nothing — a
        # fresh feed must not replay the store's whole history)
        self._watch_seqs: Optional[Dict[Tuple[int, int], int]] = None
        self._watch_lock = _locks.new_lock("freshness.feed.watch")
        self._watch_last = 0.0

    # -- publishing --------------------------------------------------------
    def publish_delta(self, entry) -> None:
        """In-process ingest hook: one committed OverlayEntry becomes
        one delta event; every waiter is notified (condition — the
        e2e freshness proof's "no sleep-polling" path)."""
        segs = np.unique(
            np.asarray(entry.delta.hist_key) // CELLS_PER_SEGMENT)
        truncated = segs.shape[0] > EVENT_SEGMENTS_CAP
        self._publish("delta", entry.level, entry.index,
                      segs[:EVENT_SEGMENTS_CAP].tolist(), truncated,
                      int(entry.delta.rows),
                      map_version=getattr(entry, "map_version", None))

    def publish_epoch(self, map_version: str) -> None:
        """Announce a graph epoch boundary (a city hot swap flipped):
        one ``epoch`` event carrying the NEW map_version. Delivered to
        EVERY subscriber regardless of bbox/level filter — the
        resync-style contract: whatever viewport a dashboard watches,
        its history predates the new map, so it must re-query once and
        drop cross-epoch merges."""
        metrics.count("datastore.epoch.events")
        self._publish("epoch", -1, -1, [], False, 0,
                      map_version=str(map_version))

    def _publish(self, kind: str, level: int, index: int,
                 segments: List[int], truncated: bool, rows: int,
                 map_version: Optional[str] = None) -> None:
        with self._cond:
            self._seq += 1
            self._ring.append(FeedEvent(self._seq, kind, int(level),
                                        int(index), segments, truncated,
                                        rows, self.clock(),
                                        map_version=map_version))
            metrics.count("feed.events")
            self._cond.notify_all()

    # -- store watcher -----------------------------------------------------
    def watch_store(self, force: bool = False) -> int:
        """One manifest-seq diff over the store's partitions; publishes
        a tile event per partition whose seq moved since the last scan
        (commits made by OTHER processes — in-process commits already
        published richer delta events, so the watcher only reports a
        seq this process's publishes have not already covered… it
        cannot tell, so cross-process subscribers may see a tile event
        duplicating a delta event; the cursor makes that harmless:
        delivery is at-least-once per change).

        Paced: callers invoke this freely (every long-poll wait slice,
        every compactor pass); a non-forced call inside the pace window
        or while another thread scans is a no-op (pacing is wall-clock
        — time.monotonic — for the same frozen-fake reason as the poll
        deadline). Returns events published."""
        now = time.monotonic()
        if not self._watch_lock.acquire(blocking=False):
            return 0
        try:
            if not force and now - self._watch_last < self.poll_s:
                return 0
            self._watch_last = now
            metrics.count("feed.watch.passes")
            seqs: Dict[Tuple[int, int], int] = {}
            for level, index in list(self.store.partitions()):
                pdir = self.store.partition_dir(level, index)
                seqs[(level, index)] = \
                    self.store._read_manifest(pdir)["seq"]
            if self._watch_seqs is None:
                self._watch_seqs = seqs  # baseline: emit nothing
                return 0
            published = 0
            for part, seq in seqs.items():
                if seq > self._watch_seqs.get(part, 0):
                    self._publish("tile", part[0], part[1], [], False, 0)
                    published += 1
            self._watch_seqs = seqs
            return published
        finally:
            self._watch_lock.release()

    # -- subscribing -------------------------------------------------------
    def _collect(self, cursor: int, level: Optional[int],
                 ranges: Optional[list], max_events: int
                 ) -> Tuple[List[FeedEvent], bool]:
        """(matching events with seq > cursor, resync) — caller holds
        the condition. ``resync`` is True when events older than the
        ring's tail were dropped past this cursor: the subscriber's
        next step is one full viewport query, not trust in the gap."""
        base = self._seq - len(self._ring)
        resync = cursor < base
        out: List[FeedEvent] = []
        for ev in self._ring:
            if ev.seq <= cursor:
                continue
            if ev.kind == "epoch":
                # epoch boundaries bypass viewport filters: every
                # subscriber's held history predates the new map
                out.append(ev)
                if len(out) >= max_events:
                    break
                continue
            if level is not None and ev.level != level:
                continue
            if ranges is not None and not any(
                    r0 <= ev.index // ncols <= r1
                    and c0 <= ev.index % ncols <= c1
                    for r0, r1, c0, c1, ncols in ranges):
                continue
            out.append(ev)
            if len(out) >= max_events:
                break
        return out, resync

    def poll(self, bbox: Optional[Sequence[float]] = None,
             level: Optional[int] = None, cursor: int = -1,
             timeout_s: float = 25.0, max_events: int = 256) -> dict:
        """One long-poll: block until an event lands past ``cursor``
        inside the bbox (condition-notified in process; the store
        watcher picks up cross-process commits between wait slices) or
        the timeout elapses. Raises :class:`FeedOverload` past the
        waiter cap — shed BEFORE waiting, so a shed costs headers, not
        a pinned slot.

        The timeout is wall-clock by design — ``time.monotonic``, NOT
        the injected ``clock`` (which stamps arrivals and can be a
        test-frozen fake: a frozen deadline would spin this loop
        forever)."""
        ranges = None
        if bbox is not None:
            from .query import _bbox_ranges
            if level is None:
                raise ValueError("bbox subscriptions need a level")
            ranges = _bbox_ranges(bbox, int(level))
        cursor = int(cursor)
        metrics.count("feed.polls")
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        with self._cond:
            if self._waiters >= self.max_waiters:
                self._shed += 1
                metrics.count("feed.shed.waiters")
                raise FeedOverload("feed_waiters", FEED_RETRY_AFTER_S)
            if cursor < 0:
                cursor = self._seq  # "from now"
            self._waiters += 1
        try:
            while True:
                with self._cond:
                    events, resync = self._collect(cursor, level, ranges,
                                                   int(max_events))
                    now = time.monotonic()
                    if events or resync or now >= deadline:
                        new_cursor = events[-1].seq if events \
                            else max(cursor, self._seq - len(self._ring))
                        if events:
                            metrics.count("feed.delivered", len(events))
                        else:
                            metrics.count("feed.timeouts")
                        if resync:
                            metrics.count("feed.resync")
                        return {"cursor": new_cursor,
                                "events": [e.to_wire() for e in events],
                                "resync": resync,
                                "timeout": not events and not resync}
                    self._cond.wait(min(self.poll_s,
                                        max(0.0, deadline - now)))
                # outside the condition: the paced cross-process scan
                # (manifest reads must never run under the waiter lock)
                self.watch_store()
        finally:
            with self._cond:
                self._waiters -= 1

    @property
    def cursor(self) -> int:
        return self._seq

    def snapshot(self) -> dict:
        with self._cond:
            return {"cursor": self._seq, "events": len(self._ring),
                    "waiters": self._waiters,
                    "max_waiters": self.max_waiters,
                    "shed": self._shed}


__all__ = ["ChangeFeed", "FeedEvent", "FeedOverload", "RING_EVENTS",
           "FEED_RETRY_AFTER_S", "DEFAULT_MAX_WAITERS", "DEFAULT_POLL_S"]
