"""Columnar trace batches: the matcher's input format.

:class:`TraceBatch` holds one flat float64 column per coordinate
(``lat``/``lon``/``time``, optional ``accuracy``) over ALL traces, with a
``(B+1,)`` offsets array marking trace boundaries. Request dicts convert
to columns once, at the edge, and the matcher consumes the columns.

``TraceView`` / ``PointsView`` give one trace of a batch the request-dict
surface (``trace["trace"][-1]["time"]`` etc.), so ``report()`` works on
either representation without materialising points.
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


class PointsView:
    """Sequence view over one trace's points in a :class:`TraceBatch`.

    Materialises a dict per *accessed* point only — consumers like
    ``report()`` touch two points per trace, not all of them.
    """

    __slots__ = ("_tb", "_lo", "_hi")

    def __init__(self, tb: "TraceBatch", lo: int, hi: int):
        self._tb = tb
        self._lo = lo
        self._hi = hi

    def __len__(self) -> int:
        return self._hi - self._lo

    def _point(self, j: int) -> dict:
        tb = self._tb
        p = {"lat": float(tb.lat[j]), "lon": float(tb.lon[j]),
             "time": float(tb.time[j])}
        if tb.accuracy is not None:
            p["accuracy"] = int(tb.accuracy[j])
        return p

    def __getitem__(self, i):
        n = len(self)
        if isinstance(i, slice):
            return [self._point(self._lo + j) for j in range(*i.indices(n))]
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return self._point(self._lo + i)

    def __iter__(self):
        for j in range(self._lo, self._hi):
            yield self._point(j)


class TraceView:
    """Dict-shaped view of one trace in a :class:`TraceBatch` — quacks like
    the request dict ({"uuid", "trace", "match_options"}) for ``report()``,
    without materialising points."""

    __slots__ = ("_tb", "_i")

    def __init__(self, tb: "TraceBatch", i: int):
        self._tb = tb
        self._i = i

    def __getitem__(self, key):
        v = self.get(key, _MISSING)
        if v is _MISSING:
            raise KeyError(key)
        return v

    def get(self, key, default=None):
        tb = self._tb
        if key == "uuid":
            u = tb.uuid(self._i)
            return u if u is not None else default
        if key == "trace":
            lo, hi = int(tb.offsets[self._i]), int(tb.offsets[self._i + 1])
            return PointsView(tb, lo, hi)
        if key == "match_options":
            o = tb.option(self._i)
            return o if o is not None else default
        return default

    def __contains__(self, key) -> bool:
        return self.get(key, _MISSING) is not _MISSING

    def to_request(self) -> dict:
        """The plain request dict (a quarantined trace's spool body)."""
        out = {"trace": list(self["trace"])}
        u = self.get("uuid")
        if u is not None:
            out["uuid"] = u
        o = self.get("match_options")
        if o is not None:
            out["match_options"] = o
        return out


_MISSING = object()


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
        """Convert request dicts once, at the edge. Accepts anything whose
        elements support ["trace"]/.get — including TraceViews."""
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

    @classmethod
    def concat(cls, parts: Sequence[tuple]) -> "TraceBatch":
        """Build from per-trace pieces: (uuid, lat, lon, time, accuracy,
        options) with array coordinates — the dispatcher path, where each
        request thread columnarised its own trace already."""
        counts = [len(p[1]) for p in parts]
        offsets = np.zeros(len(parts) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        lat = np.concatenate([np.asarray(p[1], np.float64) for p in parts]) \
            if parts else np.zeros(0)
        lon = np.concatenate([np.asarray(p[2], np.float64) for p in parts]) \
            if parts else np.zeros(0)
        time = np.concatenate([np.asarray(p[3], np.float64) for p in parts]) \
            if parts else np.zeros(0)
        accs = [p[4] for p in parts]
        acc = np.concatenate([np.asarray(a, np.float32) for a in accs]) \
            if parts and all(a is not None for a in accs) else None
        opts = [p[5] for p in parts]
        if opts and all(o is opts[0] for o in opts):
            # one shared options object collapses so the matcher resolves
            # params once for the whole batch
            opts = opts[0]
        return cls(offsets, lat, lon, time, accuracy=acc,
                   uuids=[p[0] for p in parts], options=opts)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def uuid(self, i: int):
        return self.uuids[i] if self.uuids is not None else None

    def option(self, i: int):
        if self.options is None or isinstance(self.options, dict):
            return self.options
        return self.options[i]

    def __getitem__(self, i: int) -> TraceView:
        return TraceView(self, i)

    def __iter__(self):
        for i in range(len(self)):
            yield TraceView(self, i)

    def trace_columns(self, i: int):
        """(lat, lon, time) slices of one trace — zero copy."""
        lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
        return self.lat[lo:hi], self.lon[lo:hi], self.time[lo:hi]

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


__all__ = ["TraceBatch", "TraceView", "PointsView", "as_trace_batch",
           "points_to_columns"]
