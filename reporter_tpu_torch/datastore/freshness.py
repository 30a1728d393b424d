"""The freshness tier: a bounded recent-delta overlay over the store.

The compacted store (store.py) answers "what is this segment's
hour-of-week profile" from history; a live dashboard asks "what is it
doing *right now*". The gap is the compaction interval: a probe the
worker tee ingested seconds ago sits in a committed delta segment, but
nothing distinguishes it from last month's data, so "the last five
minutes" would mean a full historical query.

This module closes that gap with a **recent-delta overlay**: a bounded
in-memory ring of the per-partition :class:`~.aggregate.Delta` objects
the ingest path committed, stamped with their arrival time and their
``ingest_key`` (the same exactly-once identity the partition manifests
ledger — so a crash-replayed tee flush dedupes here exactly like it
dedupes on disk, and the overlay can never double-count what the store
refused). Query-time merge happens through :class:`OverlayView`, a
read-only object satisfying the three-method store protocol the query
layer (query.py) is written against — ``partitions()`` /
``live_segments()`` / ``resident_segments()`` — so ``window=`` queries
reuse the sweep/assembler stack unchanged and window-less queries do
not touch this module at all (byte-identical to the pre-overlay
behaviour by construction).

Window semantics (served via ``/histogram?window=…`` and the CLI's
``--window``):

- finite (``5m``, ``300s``, ``2h``): ONLY overlay entries that arrived
  inside the window — the "what changed just now" view;
- ``inf`` (``∞``): the compacted store PLUS overlay entries whose
  append never committed (the tile was spooled for dead-letter replay)
  — so after every append committed and a compaction ran, ``window=∞``
  is byte-identical to the plain query (tests pin this). An
  uncommitted entry re-checks the partition's ``ingested`` ledger at
  query time and drops out permanently once the replay lands.

Memory is bounded and observable: ``budget_bytes`` (``DEFAULT_BUDGET_MB``,
64 MiB, the JAX package's ``REPORTER_TPU_FRESHNESS_MB`` default) caps the
overlay's byte footprint; hitting it evicts oldest-first with an
``overlay.evicted`` count — never an OOM, never an unbounded queue.

**Materialised viewport summaries** (:class:`ViewportSummaries`) ride
the same tier: tile-level aggregates over each partition's live
segments, refreshed by the background compactor's paced pass (keyed by
manifest seq, so an unchanged partition costs one JSON read), served
as ``/histogram?viewport=1&bbox=…`` — a whole-city dashboard paints
from one read per tile instead of hundreds of segment sweeps. The port
of ``reporter_tpu/datastore/freshness.py``; the JAX package's
``REPORTER_TPU_FRESHNESS`` gate is ``LocalDatastore(freshness=)``.
"""
from __future__ import annotations

import logging
import math
import time
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import metrics
from ..utils import locks as _locks
from .aggregate import Delta, merge_deltas
from .feed import DEFAULT_MAX_WAITERS, DEFAULT_POLL_S, ChangeFeed
from .schema import CELLS_PER_SEGMENT, N_SPEED_BINS, SPEED_BIN_KPH

logger = logging.getLogger("reporter_tpu_torch.datastore")

#: per-entry bookkeeping overhead charged against the byte budget on
#: top of the arrays themselves (dict slot, key strings, slots object)
_ENTRY_OVERHEAD_BYTES = 256


#: the overlay's byte budget unless given one, in MiB
DEFAULT_BUDGET_MB = 64


def parse_window(spec) -> float:
    """Parse a ``window`` argument into seconds: ``300`` / ``'300'`` /
    ``'90s'`` / ``'5m'`` / ``'2h'`` / ``'1d'``, or ``'inf'`` /
    ``'infinity'`` / ``'∞'`` for the overlay+compacted merge. Shared by
    the /histogram surface and the CLI so the spellings cannot drift."""
    if isinstance(spec, (int, float)) and not isinstance(spec, bool):
        w = float(spec)
    else:
        text = str(spec).strip().lower()
        if text in ("inf", "infinity", "∞"):
            return math.inf
        mult = 1.0
        if text and text[-1] in "smhd":
            mult = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}[text[-1]]
            text = text[:-1]
        try:
            w = float(text) * mult
        except ValueError:
            raise ValueError(f"bad window {spec!r}: use seconds, "
                             "'<n>s|m|h|d', or 'inf'")
    if w <= 0 or math.isnan(w):
        raise ValueError(f"window must be positive, got {spec!r}")
    return w


class OverlayEntry:
    """One recorded ingest: a partition's delta + its exactly-once key.

    ``in_store`` tracks whether the matching append committed (or was
    deduped by the manifest ledger — either way the compacted store
    carries the rows). ``False`` means the append raised and the tile
    was spooled: those rows exist ONLY here until the dead-letter
    drainer replays them, which is exactly the set ``window=∞`` must
    add on top of the compacted store."""

    __slots__ = ("seq", "ingest_key", "level", "index", "delta",
                 "arrival", "in_store", "map_version", "nbytes")

    def __init__(self, seq: int, ingest_key: Optional[str], level: int,
                 index: int, delta: Delta, arrival: float,
                 in_store: bool, map_version: Optional[str] = None):
        self.seq = seq
        self.ingest_key = ingest_key
        self.level = level
        self.index = index
        self.delta = delta
        self.arrival = arrival
        self.in_store = in_store
        # graph epoch of the producing store (graph/version.py): rides
        # into every /feed event, and a version-pinned window query
        # filters on it — a dashboard spanning a hot swap must not
        # merge deltas from two maps
        self.map_version = map_version
        self.nbytes = _ENTRY_OVERHEAD_BYTES + sum(
            np.asarray(getattr(delta, col)).nbytes
            for col in ("hist_key", "hist_count", "hist_speed_sum",
                        "trans_from", "trans_to", "trans_count"))


class RecentDeltaOverlay:
    """Bounded in-memory ring of recent per-partition deltas.

    Insertion order IS arrival order (one writer path per process), so
    the ring and the dedupe map are one insertion-ordered dict keyed by
    ``(ingest_key, level, index)`` — one flush key spans every
    partition its batch touched, so the partition must be part of the
    identity. Re-offering a recorded key is a counted no-op (the same
    contract the manifest ledger gives the store), which is what makes
    a crash-restarted tee replay safe: the store dedupes on disk, the
    overlay dedupes here, and neither ever double-counts."""

    def __init__(self, budget_bytes: Optional[int] = None,
                 clock=time.time):
        self.budget_bytes = budget_bytes if budget_bytes is not None \
            else DEFAULT_BUDGET_MB * (1 << 20)
        self.clock = clock
        self._lock = _locks.new_lock("freshness.overlay")
        self._entries: "OrderedDict[tuple, OverlayEntry]" = OrderedDict()
        self._bytes = 0
        self._seq = 0
        self._evicted = 0

    @property
    def cursor(self) -> int:
        """Monotone per-store record counter (the feed's cursor base)."""
        return self._seq

    def record(self, level: int, index: int, delta: Delta,
               ingest_key: Optional[str],
               in_store: bool = True,
               map_version: Optional[str] = None
               ) -> Optional[OverlayEntry]:
        """Record one ingested partition delta; None when the key was
        already recorded (the dedupe no-op — a True ``in_store`` still
        upgrades the existing entry, so a spooled-then-replayed flush
        stops counting as overlay-only once its replay commits)."""
        arrival = self.clock()
        with self._lock:
            if ingest_key is not None:
                key = (ingest_key, int(level), int(index))
                got = self._entries.get(key)
                if got is not None:
                    metrics.count("overlay.deduped")
                    if in_store and not got.in_store:
                        got.in_store = True
                    return None
            else:
                # keyless ingest (ad-hoc CSV): no cross-restart identity
                # to dedupe on — record under a per-process unique key
                key = ("_anon", self._seq + 1, int(level), int(index))
            self._seq += 1
            entry = OverlayEntry(self._seq, ingest_key, int(level),
                                 int(index), delta, arrival, in_store,
                                 map_version=map_version)
            self._entries[key] = entry
            self._bytes += entry.nbytes
            metrics.count("overlay.records")
            while self._bytes > self.budget_bytes and len(self._entries) > 1:
                _, old = self._entries.popitem(last=False)
                self._bytes -= old.nbytes
                self._evicted += 1
                metrics.count("overlay.evicted")
            return entry

    def window_deltas(self, window_s: float,
                      now: Optional[float] = None,
                      map_version: Optional[str] = None
                      ) -> Dict[Tuple[int, int], List[Delta]]:
        """Per-partition deltas that arrived within ``window_s`` of now
        — the finite-window view's entire contents. A ``map_version``
        pin drops entries stamped with a DIFFERENT epoch (untagged
        legacy entries pass, matching EpochView's on-disk rule)."""
        horizon = (now if now is not None else self.clock()) - window_s
        out: Dict[Tuple[int, int], List[Delta]] = {}
        with self._lock:
            for e in self._entries.values():
                if map_version is not None \
                        and e.map_version is not None \
                        and e.map_version != map_version:
                    continue
                if e.arrival >= horizon:
                    out.setdefault((e.level, e.index), []).append(e.delta)
        return out

    def uncommitted_deltas(self, store,
                           map_version: Optional[str] = None
                           ) -> Dict[Tuple[int, int], List[Delta]]:
        """Per-partition deltas the compacted store does NOT carry —
        the only thing ``window=∞`` adds on top of it. Each candidate
        re-checks its partition's ``ingested`` ledger (one manifest
        read per touched partition, memoised across the call) and
        flips to committed permanently once the replay landed, so the
        merged view converges back to byte-identity with the plain
        query on its own."""
        with self._lock:
            pending = [e for e in self._entries.values()
                       if not e.in_store]
        out: Dict[Tuple[int, int], List[Delta]] = {}
        ledgers: Dict[str, dict] = {}
        for e in pending:
            if map_version is not None and e.map_version is not None \
                    and e.map_version != map_version:
                continue
            pdir = store.partition_dir(e.level, e.index)
            if pdir not in ledgers:
                ledgers[pdir] = store._read_manifest(pdir).get(
                    "ingested", {})
            if e.ingest_key is not None and e.ingest_key in ledgers[pdir]:
                # benign race with a concurrent flip: idempotent write
                e.in_store = True
                metrics.count("overlay.committed")
                continue
            out.setdefault((e.level, e.index), []).append(e.delta)
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "budget_bytes": self.budget_bytes,
                    "cursor": self._seq, "evicted": self._evicted}


class OverlayView:
    """Read-only store facade over in-memory deltas, optionally stacked
    on the compacted store — satisfies exactly the three-method
    protocol the query layer uses (``partitions`` / ``live_segments``
    / ``resident_segments``), so ``query_segment`` / ``query_many`` /
    ``query_bbox`` serve windowed answers through the same swept code
    path as historical ones."""

    def __init__(self, extra: Dict[Tuple[int, int], List[Delta]],
                 base=None):
        self._extra = extra
        self._base = base

    def partitions(self) -> Iterator[Tuple[int, int]]:
        seen = set()
        if self._base is not None:
            for part in self._base.partitions():
                seen.add(part)
                yield part
        for part in sorted(self._extra):
            if part not in seen:
                yield part

    def live_segments(self, level: int, index: int) -> List[Delta]:
        out: List[Delta] = []
        if self._base is not None:
            out.extend(self._base.live_segments(level, index))
        out.extend(self._extra.get((int(level), int(index)), []))
        return out

    def resident_segments(self, level: int, index: int) -> np.ndarray:
        parts = []
        if self._base is not None:
            parts.append(np.asarray(
                self._base.resident_segments(level, index),
                dtype=np.int64))
        for delta in self._extra.get((int(level), int(index)), []):
            parts.append(np.unique(
                np.asarray(delta.hist_key) // CELLS_PER_SEGMENT))
        return np.unique(np.concatenate(parts)) if parts \
            else np.zeros(0, dtype=np.int64)


class ViewportSummaries:
    """Materialised tile-level aggregates over the compacted store.

    ``refresh()`` (the background compactor's paced pass — never the
    request path) merges each partition's live segments into one
    summary dict, memoised by the partition manifest's ``seq`` so an
    unchanged partition costs one small JSON read. ``summarise()``
    intersects a bbox with the materialised tiles — a whole-city
    viewport is one dict lookup per covered tile, not hundreds of
    per-segment sweeps."""

    def __init__(self, store):
        self._store = store
        self._lock = _locks.new_lock("freshness.viewports")
        self._tiles: Dict[Tuple[int, int], dict] = {}
        self._seqs: Dict[Tuple[int, int], int] = {}
        self._refreshes = 0

    def refresh(self) -> dict:
        """One materialisation pass; returns {"tiles", "refreshed"}."""
        refreshed = 0
        live = set()
        for level, index in list(self._store.partitions()):
            live.add((level, index))
            pdir = self._store.partition_dir(level, index)
            seq = self._store._read_manifest(pdir)["seq"]
            with self._lock:
                if self._seqs.get((level, index)) == seq:
                    continue
            summary = self._summarise_partition(level, index)
            with self._lock:
                self._tiles[(level, index)] = summary
                self._seqs[(level, index)] = seq
            refreshed += 1
        with self._lock:
            for gone in [k for k in self._tiles if k not in live]:
                del self._tiles[gone]
                del self._seqs[gone]
            self._refreshes += 1
            n = len(self._tiles)
        if refreshed:
            metrics.count("viewport.refreshed_tiles", refreshed)
        return {"tiles": n, "refreshed": refreshed}

    def _summarise_partition(self, level: int, index: int) -> dict:
        parts = self._store.live_segments(level, index)
        if not parts:
            return {"level": int(level), "tile_index": int(index),
                    "n_segments": 0, "count": 0, "mean_kph": None,
                    "hours_covered": 0,
                    "histogram": {"bin_kph": SPEED_BIN_KPH,
                                  "counts": [0] * N_SPEED_BINS}}
        merged = merge_deltas(parts)
        keys = np.asarray(merged.hist_key)
        counts = np.asarray(merged.hist_count)
        sums = np.asarray(merged.hist_speed_sum)
        cell = keys % CELLS_PER_SEGMENT
        bins = np.zeros(N_SPEED_BINS, dtype=np.int64)
        np.add.at(bins, cell % N_SPEED_BINS, counts)
        total = int(counts.sum())
        return {
            "level": int(level), "tile_index": int(index),
            "n_segments": int(np.unique(keys
                                        // CELLS_PER_SEGMENT).shape[0]),
            "count": total,
            "mean_kph": round(float(sums.sum()) / total, 3)
            if total else None,
            "hours_covered": int(np.unique(cell
                                           // N_SPEED_BINS).shape[0]),
            "histogram": {"bin_kph": SPEED_BIN_KPH,
                          "counts": bins.tolist()},
        }

    def summarise(self, bbox: Sequence[float], level: int) -> dict:
        """Viewport answer from the materialised tiles (refreshing
        lazily exactly once if no compactor pass ran yet). The bbox
        intersection reuses the query layer's antimeridian-aware
        row/col range math."""
        from .query import _bbox_ranges
        with self._lock:
            fresh_needed = self._refreshes == 0
        if fresh_needed:
            self.refresh()
        metrics.count("viewport.queries")
        ranges = _bbox_ranges(bbox, int(level))
        with self._lock:
            tiles = [dict(summary) for (lvl, index), summary
                     in sorted(self._tiles.items())
                     if lvl == int(level)
                     and any(r0 <= index // ncols <= r1
                             and c0 <= index % ncols <= c1
                             for r0, r1, c0, c1, ncols in ranges)]
        return {"bbox": [float(v) for v in bbox], "level": int(level),
                "n_tiles": len(tiles),
                "count": sum(t["count"] for t in tiles),
                "tiles": tiles}

    def snapshot(self) -> dict:
        with self._lock:
            return {"tiles": len(self._tiles),
                    "refreshes": self._refreshes}


class FreshnessTier:
    """The per-process bundle: overlay + change feed + viewport
    summaries, attached to a store as ``store.freshness`` (the ingest
    path's hook point — store.py records every appended delta here,
    whatever producer drove it: the worker tee, a dead-letter replay,
    the CLI)."""

    def __init__(self, store, clock=None,
                 budget_bytes: Optional[int] = None,
                 max_waiters_n: int = DEFAULT_MAX_WAITERS,
                 poll_s: float = DEFAULT_POLL_S):
        self.store = store
        self.clock = clock or time.time
        self.overlay = RecentDeltaOverlay(budget_bytes=budget_bytes,
                                          clock=self.clock)
        self.feed = ChangeFeed(store, clock=self.clock,
                               max_waiters_n=max_waiters_n, poll_s=poll_s)
        self.viewports = ViewportSummaries(store)

    def record(self, level: int, index: int, delta: Delta,
               ingest_key: Optional[str], in_store: bool = True,
               map_version: Optional[str] = None) -> None:
        """Ingest-path hook (store.py): record + publish. Never raises
        — a freshness failure must not fail the durable ingest."""
        try:
            entry = self.overlay.record(level, index, delta, ingest_key,
                                        in_store=in_store,
                                        map_version=map_version)
            if entry is not None:
                self.feed.publish_delta(entry)
        except Exception as e:
            metrics.count("overlay.record_errors")
            logger.error("freshness record failed for %d/%d: %s",
                         level, index, e)

    def query_view(self, window_s: float,
                   map_version: Optional[str] = None):
        """The store-protocol view a ``window=`` query sweeps: finite →
        overlay-only entries inside the window; ``inf`` → compacted
        store + overlay entries the store does not carry. A
        ``map_version`` pin filters both layers to one graph epoch."""
        metrics.count("overlay.window_queries")
        if math.isinf(window_s):
            base = self.store
            if map_version is not None:
                from .store import EpochView
                base = EpochView(self.store, map_version)
            return OverlayView(
                self.overlay.uncommitted_deltas(
                    self.store, map_version=map_version),
                base=base)
        return OverlayView(self.overlay.window_deltas(
            window_s, map_version=map_version))

    def on_compactor_pass(self) -> None:
        """The background compactor's paced hook: refresh viewport
        materialisations and run one store-watch sweep so feed
        subscribers in THIS process see commits other processes made
        (the pre-fork fleet's overlays are per-process)."""
        self.viewports.refresh()
        self.feed.watch_store()

    def snapshot(self) -> dict:
        return {"overlay": self.overlay.snapshot(),
                "feed": self.feed.snapshot(),
                "viewports": self.viewports.snapshot()}


__all__ = ["FreshnessTier", "RecentDeltaOverlay", "OverlayView",
           "OverlayEntry", "ViewportSummaries", "parse_window",
           "DEFAULT_BUDGET_MB"]
