"""Columnar trace batches: the matcher's input format.

:class:`TraceBatch` holds one flat float64 column per coordinate
(``lat``/``lon``/``time``, optional ``accuracy``) over ALL traces, with a
``(B+1,)`` offsets array marking trace boundaries. Request dicts convert
to columns once, at the edge, and the matcher consumes the columns.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def points_to_columns(points: Sequence[dict]):
    """One pass over a point-dict list -> (lat, lon, time, accuracy) f64/f32
    arrays."""
    n = len(points)
    lat = np.fromiter((p["lat"] for p in points), np.float64, n)
    lon = np.fromiter((p["lon"] for p in points), np.float64, n)
    time = np.fromiter((p["time"] for p in points), np.float64, n)
    if points and "accuracy" in points[0]:
        try:
            acc = np.fromiter((p.get("accuracy", 0) for p in points),
                              np.float32, n)
        except (TypeError, ValueError):
            acc = None
    else:
        acc = None
    return lat, lon, time, acc


class TraceBatch:
    """B traces as flat columns + offsets.

    ``options`` is either one shared match_options dict for every trace
    (lets the matcher resolve params once for the whole batch) or a
    per-trace list; ``uuids`` is optional.
    """

    __slots__ = ("offsets", "lat", "lon", "time", "accuracy", "uuids",
                 "options")

    def __init__(self, offsets, lat, lon, time, accuracy=None, uuids=None,
                 options=None):
        self.offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        self.lat = np.ascontiguousarray(lat, dtype=np.float64)
        self.lon = np.ascontiguousarray(lon, dtype=np.float64)
        self.time = np.ascontiguousarray(time, dtype=np.float64)
        self.accuracy = accuracy
        self.uuids = uuids
        self.options = options

    @classmethod
    def from_requests(cls, reqs: Sequence[dict]) -> "TraceBatch":
        """Convert request dicts once, at the edge."""
        counts = [len(r["trace"]) for r in reqs]
        offsets = np.zeros(len(reqs) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        n = int(offsets[-1])
        lat = np.fromiter(
            (p["lat"] for r in reqs for p in r["trace"]), np.float64, n)
        lon = np.fromiter(
            (p["lon"] for r in reqs for p in r["trace"]), np.float64, n)
        time = np.fromiter(
            (p["time"] for r in reqs for p in r["trace"]), np.float64, n)
        uuids = [r.get("uuid") for r in reqs]
        options = [r.get("match_options") for r in reqs]
        return cls(offsets, lat, lon, time, uuids=uuids, options=options)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def gather(self, idx) -> "TraceBatch":
        """New TraceBatch of the traces at ``idx``, in that order — one
        vectorised ragged gather, no per-point work."""
        idx = np.asarray(idx, dtype=np.int64)
        counts = self.lengths()[idx]
        offsets = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        total = int(offsets[-1])
        flat = np.arange(total, dtype=np.int64) + np.repeat(
            self.offsets[idx] - offsets[:-1], counts)
        acc = self.accuracy[flat] if self.accuracy is not None else None
        opts = self.options if self.options is None \
            or isinstance(self.options, dict) \
            else [self.options[int(i)] for i in idx]
        uu = None if self.uuids is None else [self.uuids[int(i)] for i in idx]
        return TraceBatch(offsets, self.lat[flat], self.lon[flat],
                          self.time[flat], accuracy=acc, uuids=uu,
                          options=opts)


def as_trace_batch(traces) -> TraceBatch:
    """Normalise a match_many input: TraceBatch passes through, request
    dicts convert once."""
    if isinstance(traces, TraceBatch):
        return traces
    return TraceBatch.from_requests(traces)


__all__ = ["TraceBatch", "as_trace_batch", "points_to_columns"]
