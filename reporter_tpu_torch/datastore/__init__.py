"""The datastore: the consumer of flushed traffic tiles.

The reporter half (matcher + streaming worker) emits anonymised,
time-quantised segment tiles; this subsystem closes the loop the way the
reference ecosystem's companion datastore service did — turning tiles
into per-segment speed histograms and answering queries:

- :mod:`schema`     — histogram axes, composite keys, columnar batch
- :mod:`ingest`     — tile CSV / in-process ``Segment`` ingestion
- :mod:`aggregate`  — whole-batch searchsorted/add.at histogram kernel
- :mod:`store`      — append-only columnar partitions, atomic commits,
  mmap reads, compaction
- :mod:`query`      — mean / percentiles / coverage / transitions,
  batched multi-segment + bbox sweeps
- :mod:`lease`      — the cross-process writer lease every mutating
  entry point holds
- :mod:`compactor`  — background delta-pressure compaction (lease-owned)
- :mod:`freshness`  — recent-delta overlay (``window=`` queries) +
  materialised viewport summaries
- :mod:`feed`       — bbox change feed: monotone cursor, long-poll,
  bounded waiters
- :mod:`profile`    — per-city route-memo pre-warm artifact

:class:`LocalDatastore` is the one-stop facade the service's
``/histogram`` action, ``datastore_cli``, and the streaming worker's tee
all share.

The port of ``reporter_tpu/datastore/``: plain numpy on the host, as in
the JAX package. It imports no torch (spawned pipeline children import
it) and nothing of the JAX package. The JAX package's environment knobs
are arguments of :class:`LocalDatastore` (``DATASTORE_KEYS``, the keys
of the service config's ``datastore`` object), with the same defaults:

  handle_cache_size  REPORTER_TPU_DATASTORE_HANDLES    (64)
  ledger_max         REPORTER_TPU_INGEST_LEDGER_MAX    (4096)
  lease_ttl_s        REPORTER_TPU_STORE_LEASE_S        (30.0)
  freshness          REPORTER_TPU_FRESHNESS            (true)
  freshness_mb       REPORTER_TPU_FRESHNESS_MB         (64)
  freshness_waiters  REPORTER_TPU_FRESHNESS_WAITERS    (1024)
  freshness_poll_s   REPORTER_TPU_FRESHNESS_POLL_S     (0.25)

and ``REPORTER_TPU_COMPACT_INTERVAL_S`` is
``BackgroundCompactor(interval_s=)`` (5.0).
"""
from __future__ import annotations

from typing import Optional, Sequence

from .aggregate import Delta, aggregate, merge_deltas
from .compactor import BackgroundCompactor
from .feed import ChangeFeed, FeedOverload
from .feed import DEFAULT_MAX_WAITERS, DEFAULT_POLL_S
from .freshness import (
    DEFAULT_BUDGET_MB,
    FreshnessTier,
    OverlayView,
    RecentDeltaOverlay,
    parse_window,
)
from .ingest import ingest_dir, ingest_file, parse_tile_csv, scan_tiles
from .lease import DEFAULT_TTL_S, LeaseHeldElsewhere, StoreLease
from .profile import export_profile, load_profile, profile_path, warm_matcher
from .query import (
    DEFAULT_PERCENTILES,
    hours_for_range,
    parse_hours_spec,
    query_bbox,
    query_many,
    query_segment,
)
from .schema import ObservationBatch
from .store import DEFAULT_HANDLES, DEFAULT_LEDGER_MAX, EpochView, \
    HistogramStore

#: the service config's ``datastore`` object: ``root`` and these knobs
DATASTORE_KEYS = ("handle_cache_size", "ledger_max", "lease_ttl_s",
                  "freshness", "freshness_mb", "freshness_waiters",
                  "freshness_poll_s")


class LocalDatastore(HistogramStore):
    """A histogram store plus its query surface, rooted at a directory.
    ``freshness=False`` turns :meth:`enable_freshness` into a no-op;
    ``freshness_mb``, ``freshness_waiters`` and ``freshness_poll_s`` size
    the tier it attaches."""

    def __init__(self, root: str,
                 handle_cache_size: int = DEFAULT_HANDLES,
                 ledger_max: int = DEFAULT_LEDGER_MAX,
                 lease_ttl_s: float = DEFAULT_TTL_S, freshness: bool = True,
                 freshness_mb: int = DEFAULT_BUDGET_MB,
                 freshness_waiters: int = DEFAULT_MAX_WAITERS,
                 freshness_poll_s: float = DEFAULT_POLL_S):
        super().__init__(root, handle_cache_size=handle_cache_size,
                         ledger_max=ledger_max, lease_ttl_s=lease_ttl_s)
        self.freshness_on = bool(freshness)
        self.freshness_mb = int(freshness_mb)
        self.freshness_waiters = int(freshness_waiters)
        self.freshness_poll_s = float(freshness_poll_s)

    def ingest_segments(self, segments,
                        max_deltas: Optional[int] = None,
                        max_delta_bytes: Optional[int] = None,
                        ingest_key: Optional[str] = None) -> int:
        """Zero-serialisation path: aggregate culled ``Segment`` structs
        straight out of the anonymiser's flush, no CSV round trip. With
        compaction thresholds, the touched partitions are pressure-
        checked inline (the worker tee's automatic-compaction knobs).
        ``ingest_key`` — the flush identity the anonymiser passes its
        tee — makes the ingest idempotent (partition manifest ledger):
        a crash-replayed flush re-offers the same key and no-ops."""
        return self.ingest(ObservationBatch.from_segments(segments),
                           max_deltas=max_deltas,
                           max_delta_bytes=max_delta_bytes,
                           ingest_key=ingest_key)

    def ingest_csv(self, payload: str) -> int:
        return self.ingest(parse_tile_csv(payload))

    def ingest_dir(self, root: str, delete: bool = False,
                   limit: Optional[int] = None) -> dict:
        return ingest_dir(self, root, delete=delete, limit=limit)

    def enable_freshness(self, clock=None, budget_bytes=None):
        """Attach the freshness tier (freshness.py) — the recent-delta
        overlay, change feed and viewport summaries — unless the store
        was built with ``freshness=False``. Idempotent; returns the tier
        (or None when it is off)."""
        if self.freshness is None and self.freshness_on:
            self.freshness = FreshnessTier(
                self, clock=clock,
                budget_bytes=self.freshness_mb * (1 << 20)
                if budget_bytes is None else budget_bytes,
                max_waiters_n=self.freshness_waiters,
                poll_s=self.freshness_poll_s)
        return self.freshness

    def _query_store(self, window, map_version: Optional[str] = None,
                     merge: bool = False):
        """The store the query layer should sweep for this request:
        ``window=None`` is ALWAYS ``self`` (the pre-freshness path,
        byte-identical by construction); a window resolves through the
        overlay. A process without the tier serves ``inf`` as the
        plain compacted store (the overlay would add nothing) and a
        finite window as empty (it has witnessed no recent ingests:
        windows need the tee co-located).

        Epoch pin/merge semantics (graph versioning): the effective
        pin is the explicit ``map_version=`` if given, else the store's
        ACTIVE version (the latest map build this process serves) —
        histograms never silently mix epochs. ``merge=True`` is the
        explicit opt-in that sweeps every epoch (and is mutually
        exclusive with an explicit pin); a store with no version
        (every pre-versioning deployment) behaves exactly as before."""
        from ..utils import metrics
        if merge and map_version is not None:
            raise ValueError(
                "merge and map_version are mutually exclusive")
        pin = None
        if not merge:
            pin = map_version if map_version is not None \
                else self.map_version
        if pin is not None:
            metrics.count("datastore.epoch.pinned_queries")
        elif merge:
            metrics.count("datastore.epoch.merged_queries")
        if window is None:
            if pin is not None:
                from .store import EpochView
                return EpochView(self, pin)
            return self
        import math
        w = parse_window(window)
        if self.freshness is not None:
            return self.freshness.query_view(w, map_version=pin)
        if math.isinf(w):
            if pin is not None:
                from .store import EpochView
                return EpochView(self, pin)
            return self
        return OverlayView({})

    def query(self, segment_id: int,
              hours: Optional[Sequence[int]] = None,
              percentiles: Sequence[float] = DEFAULT_PERCENTILES,
              max_transitions: int = 32, window=None,
              map_version: Optional[str] = None,
              merge: bool = False) -> dict:
        return query_segment(
            self._query_store(window, map_version, merge), segment_id,
            hours=hours, percentiles=percentiles,
            max_transitions=max_transitions)

    def query_many(self, segment_ids,
                   hours: Optional[Sequence[int]] = None,
                   percentiles: Sequence[float] = DEFAULT_PERCENTILES,
                   max_transitions: int = 32, window=None,
                   map_version: Optional[str] = None,
                   merge: bool = False) -> list:
        """Batched spelling of :meth:`query`: one sweep per partition's
        live segment files serves the whole id list (datastore/query.py)
        — answer-identical to N single queries by construction."""
        return query_many(
            self._query_store(window, map_version, merge), segment_ids,
            hours=hours, percentiles=percentiles,
            max_transitions=max_transitions)

    def query_bbox(self, bbox, level: int,
                   hours: Optional[Sequence[int]] = None,
                   percentiles: Sequence[float] = DEFAULT_PERCENTILES,
                   max_transitions: int = 32,
                   max_segments: Optional[int] = None,
                   window=None,
                   map_version: Optional[str] = None,
                   merge: bool = False) -> dict:
        kwargs = {}
        if max_segments is not None:
            kwargs["max_segments"] = max_segments
        return query_bbox(
            self._query_store(window, map_version, merge), bbox, level,
            hours=hours, percentiles=percentiles,
            max_transitions=max_transitions, **kwargs)


__all__ = [
    "BackgroundCompactor", "ChangeFeed", "Delta", "EpochView",
    "FeedOverload",
    "FreshnessTier", "HistogramStore", "LeaseHeldElsewhere",
    "LocalDatastore", "ObservationBatch", "OverlayView",
    "RecentDeltaOverlay", "parse_window", "DATASTORE_KEYS",
    "StoreLease", "aggregate", "merge_deltas", "parse_tile_csv",
    "scan_tiles", "ingest_file", "ingest_dir", "query_segment",
    "query_many", "query_bbox", "hours_for_range", "parse_hours_spec",
    "export_profile", "load_profile", "warm_matcher", "profile_path",
    "DEFAULT_PERCENTILES",
]
