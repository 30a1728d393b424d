"""Datastore value layout: speed-histogram axes, composite keys, and the
columnar observation batch.

The datastore aggregates tile observations (one CSV row / one ``Segment``
each) into per-segment speed histograms over two fixed axes:

- **hour-of-week**: 168 buckets, Monday 00:00 UTC = 0 (the serving
  granularity of the reference ecosystem's datastore — traffic is
  periodic by week, so a week of hours is the smallest cycle that keeps
  rush hours apart without storing raw timestamps).
- **speed bin**: ``SPEED_BIN_KPH``-wide bins from 0 to ``SPEED_MAX_KPH``
  plus one overflow bin (``N_SPEED_BINS`` total). Bin ``i`` covers
  ``[i*SPEED_BIN_KPH, (i+1)*SPEED_BIN_KPH)``.

A histogram cell is addressed by one int64 composite key::

    key = segment_id * CELLS_PER_SEGMENT + hour_of_week * N_SPEED_BINS + bin

``segment_id`` is a 46-bit OSMLR id and ``CELLS_PER_SEGMENT`` is
168 * 25 = 4200 < 2**13, so the product stays below 2**59 — comfortably
inside int64. Composite keys sort by (segment, hour, bin), which is what
makes per-segment query a binary-searched contiguous slice of every
sorted partition file (store.py).

Transitions (segment -> next segment counts) keep two id columns; two
46-bit ids cannot share an int64.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..core.osmlr import (
    INVALID_SEGMENT_ID,
    LEVEL_BITS,
    TILE_INDEX_BITS,
)

HOURS_PER_WEEK = 168

SPEED_BIN_KPH = 5.0
SPEED_MAX_KPH = 120.0
#: 24 regular bins + 1 overflow for speeds >= SPEED_MAX_KPH
N_SPEED_BINS = int(SPEED_MAX_KPH / SPEED_BIN_KPH) + 1

CELLS_PER_SEGMENT = HOURS_PER_WEEK * N_SPEED_BINS

#: upper edges of the regular bins — searchsorted target (overflow bin is
#: everything at or past the last edge)
SPEED_BIN_EDGES_KPH = np.arange(
    SPEED_BIN_KPH, SPEED_MAX_KPH + SPEED_BIN_KPH / 2, SPEED_BIN_KPH)

#: 25-bit (level | tile index) mask — the partition key lives in the low
#: bits of every segment id (core/osmlr.py)
GRAPH_TILE_MASK = (1 << (LEVEL_BITS + TILE_INDEX_BITS)) - 1

#: epoch 0 is Thursday; shift so hour-of-week 0 is Monday 00:00 UTC
_EPOCH_DOW_OFFSET_H = 3 * 24


def hour_of_week(epoch_s: np.ndarray) -> np.ndarray:
    """Vectorised epoch seconds -> hour-of-week (0..167, Monday 00:00=0)."""
    return ((np.asarray(epoch_s, dtype=np.int64) // 3600
             + _EPOCH_DOW_OFFSET_H) % HOURS_PER_WEEK).astype(np.int64)


def speed_bin(speed_kph: np.ndarray) -> np.ndarray:
    """Vectorised speed -> bin index (last bin catches the overflow)."""
    return np.minimum(
        np.searchsorted(SPEED_BIN_EDGES_KPH, speed_kph, side="right"),
        N_SPEED_BINS - 1).astype(np.int64)


def hist_key(segment_id: np.ndarray, hour: np.ndarray,
             sbin: np.ndarray) -> np.ndarray:
    return (np.asarray(segment_id, dtype=np.int64) * CELLS_PER_SEGMENT
            + np.asarray(hour, dtype=np.int64) * N_SPEED_BINS
            + np.asarray(sbin, dtype=np.int64))


def split_hist_key(key: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Composite key -> (segment_id, hour_of_week, speed_bin) columns."""
    key = np.asarray(key, dtype=np.int64)
    seg, cell = np.divmod(key, CELLS_PER_SEGMENT)
    hour, sbin = np.divmod(cell, N_SPEED_BINS)
    return seg, hour, sbin


def segment_key_range(segment_id: int) -> Tuple[int, int]:
    """Half-open composite-key range covering one segment's cells."""
    lo = int(segment_id) * CELLS_PER_SEGMENT
    return lo, lo + CELLS_PER_SEGMENT


def bin_centers_kph() -> np.ndarray:
    """Representative speed per bin (overflow pinned to its lower edge)."""
    centers = (np.arange(N_SPEED_BINS, dtype=np.float64) + 0.5) * SPEED_BIN_KPH
    centers[-1] = SPEED_MAX_KPH
    return centers


@dataclass
class ObservationBatch:
    """Columnar tile observations — the datastore's zero-dict wire format.

    One element per tile CSV row / ``Segment`` observation. All arrays
    share length; ``next_id`` uses ``INVALID_SEGMENT_ID`` for "no next
    segment" exactly like the 40-byte binary layout.
    """

    segment_id: np.ndarray   # int64
    next_id: np.ndarray      # int64
    duration_s: np.ndarray   # float64 (CSV carries round(max-min) seconds)
    count: np.ndarray        # int64 (tile CSV count column; 1 per raw row)
    length_m: np.ndarray     # int64
    queue_m: np.ndarray      # int64
    min_ts: np.ndarray       # int64 epoch seconds
    max_ts: np.ndarray       # int64 epoch seconds

    def __len__(self) -> int:
        return int(self.segment_id.shape[0])

    @classmethod
    def empty(cls) -> "ObservationBatch":
        z64 = np.zeros(0, dtype=np.int64)
        return cls(z64, z64.copy(), np.zeros(0, dtype=np.float64),
                   z64.copy(), z64.copy(), z64.copy(), z64.copy(),
                   z64.copy())

    @classmethod
    def from_segments(cls, segments: List) -> "ObservationBatch":
        """Columnarise ``core.types.Segment`` structs — the worker's
        in-process flush path, no CSV in between (one bulk pass)."""
        n = len(segments)
        if n == 0:
            return cls.empty()
        seg = np.fromiter((s.id for s in segments), dtype=np.int64, count=n)
        nxt = np.fromiter((s.next_id for s in segments), dtype=np.int64,
                          count=n)
        mn = np.fromiter((s.min for s in segments), dtype=np.float64, count=n)
        mx = np.fromiter((s.max for s in segments), dtype=np.float64, count=n)
        ln = np.fromiter((s.length for s in segments), dtype=np.int64,
                         count=n)
        qu = np.fromiter((s.queue for s in segments), dtype=np.int64, count=n)
        # same duration quantisation as Segment.csv_row (Java half-up
        # rounding), so the in-process path and the CSV path aggregate
        # identically
        dur = np.floor((mx - mn) + 0.5)
        return cls(seg, nxt, dur, np.ones(n, dtype=np.int64), ln, qu,
                   np.floor(mn).astype(np.int64),
                   np.ceil(mx).astype(np.int64))

    def speeds_kph(self) -> np.ndarray:
        """Harmonic-consistent per-observation speed: length/duration.
        Zero-duration observations yield inf and are dropped by the
        aggregator's validity mask."""
        with np.errstate(divide="ignore"):
            return np.where(self.duration_s > 0,
                            self.length_m / np.maximum(self.duration_s, 1e-9),
                            np.inf) * 3.6

    def valid_mask(self) -> np.ndarray:
        """Observations the aggregator accepts: positive duration and
        length, non-negative queue (Segment.valid semantics, columnar)."""
        return ((self.duration_s > 0) & (self.length_m > 0)
                & (self.queue_m >= 0) & (self.min_ts > 0)
                & (self.max_ts > 0))


__all__ = [
    "HOURS_PER_WEEK", "SPEED_BIN_KPH", "SPEED_MAX_KPH", "N_SPEED_BINS",
    "CELLS_PER_SEGMENT", "SPEED_BIN_EDGES_KPH", "GRAPH_TILE_MASK",
    "INVALID_SEGMENT_ID", "hour_of_week", "speed_bin", "hist_key",
    "split_hist_key", "segment_key_range", "bin_centers_kph",
    "ObservationBatch",
]
