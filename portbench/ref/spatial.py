"""Frozen copy of the port's ``reporter_tpu_torch/graph/spatial.py`` (the plain
reference of the benchmark; imports nothing of the program).

Spatial candidate lookup: probe point -> K nearest road edges.

This is the host-side front half of the matcher. The reference delegates it
to Valhalla's candidate search inside ``SegmentMatcher.Match``
(reference: py/reporter_service.py:240); here it is a uniform grid over
projected meters that emits **fixed-width (T, K) candidate tensors** ready to
ship to the device — padded with sentinel values so every trace in a batch
has identical shape.

The candidate search is a numpy whole-batch query: every probe of every
trace in a chunk resolves in one fixed set of array ops.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from .network import RoadNetwork

PAD_EDGE = -1
PAD_DIST = 1.0e9


@dataclass
class CandidateSet:
    """Fixed-width candidates for one trace of T points, K per point.

    Padding: ``edge_ids == PAD_EDGE`` marks unused slots; their ``dist_m``
    is PAD_DIST so Gaussian emission scores underflow to ~-inf on device.
    """
    edge_ids: np.ndarray   # (T, K) i32
    dist_m: np.ndarray     # (T, K) f32 point->edge distance
    offset_m: np.ndarray   # (T, K) f32 along-edge offset of projection
    proj_x: np.ndarray     # (T, K) f32 projected-point coords, meters
    proj_y: np.ndarray     # (T, K) f32

    @property
    def T(self) -> int:
        return self.edge_ids.shape[0]

    @property
    def K(self) -> int:
        return self.edge_ids.shape[1]

    def valid(self) -> np.ndarray:
        return self.edge_ids != PAD_EDGE


# cell key encoding: one int64 per (i, j) grid cell. |i|,|j| stay far
# below 2**30 for any terrestrial network at >=1 m cells
_KEY_M = np.int64(1) << np.int64(31)


class SpatialGrid:
    """Uniform grid over projected meters mapping cells -> edge ids.

    The cell map is stored as a CSR over SORTED int64 cell keys
    (``_cell_keys`` / ``_cell_off`` / ``_cell_edges``) so a whole batch of
    probe points resolves its neighborhoods with one ``searchsorted`` —
    the grid query itself is columnar, no Python per point.
    """

    def __init__(self, net: RoadNetwork, cell_m: float):
        self.net = net
        self.cell_m = float(cell_m)
        nx, ny = net.node_xy()
        self.ax = nx[net.edge_start]
        self.ay = ny[net.edge_start]
        self.bx = nx[net.edge_end]
        self.by = ny[net.edge_end]
        # segment direction and squared length, precomputed for projection
        self.dx = self.bx - self.ax
        self.dy = self.by - self.ay
        self.len2 = np.maximum(self.dx * self.dx + self.dy * self.dy, 1e-9)

        lo_i = np.floor(np.minimum(self.ax, self.bx) / self.cell_m).astype(np.int64)
        hi_i = np.floor(np.maximum(self.ax, self.bx) / self.cell_m).astype(np.int64)
        lo_j = np.floor(np.minimum(self.ay, self.by) / self.cell_m).astype(np.int64)
        hi_j = np.floor(np.maximum(self.ay, self.by) / self.cell_m).astype(np.int64)
        buckets: Dict[Tuple[int, int], list] = {}
        for e in range(net.num_edges):
            for i in range(lo_i[e], hi_i[e] + 1):
                for j in range(lo_j[e], hi_j[e] + 1):
                    buckets.setdefault((i, j), []).append(e)

        # CSR over sorted cell keys — the grid's ONLY runtime structure
        keys = np.array([np.int64(i) * _KEY_M + np.int64(j)
                         for i, j in buckets], dtype=np.int64)
        order = np.argsort(keys)
        self._cell_keys = keys[order]
        groups = [np.asarray(ids, dtype=np.int32)
                  for ids in buckets.values()]
        counts = np.array([len(groups[o]) for o in order], dtype=np.int64)
        self._cell_off = np.zeros(len(order) + 1, dtype=np.int64)
        np.cumsum(counts, out=self._cell_off[1:])
        self._cell_edges = (np.concatenate([groups[o] for o in order])
                            if len(order) else np.zeros(0, np.int32))

    def _pair_candidates(self, px: np.ndarray, py: np.ndarray,
                         radius_m: float):
        """All (point, edge) pairs whose grid neighborhoods intersect:
        returns (pt, edge) index arrays, deduplicated and sorted by
        (pt, edge). Fully vectorised — the per-point Python loop this
        replaces was 62% of host prep on the fallback path."""
        T = len(px)
        reach = int(np.ceil(radius_m / self.cell_m))
        ci = np.floor(px / self.cell_m).astype(np.int64)
        cj = np.floor(py / self.cell_m).astype(np.int64)
        span = np.arange(-reach, reach + 1, dtype=np.int64)
        di = np.repeat(span, len(span))
        dj = np.tile(span, len(span))
        # (T, C) neighborhood cell keys -> CSR slots via one searchsorted
        keys = ((ci[:, None] + di[None, :]) * _KEY_M
                + (cj[:, None] + dj[None, :])).ravel()
        pos = np.searchsorted(self._cell_keys, keys)
        pos_c = np.minimum(pos, len(self._cell_keys) - 1) \
            if len(self._cell_keys) else pos
        hit = (pos < len(self._cell_keys))
        if len(self._cell_keys):
            hit &= self._cell_keys[pos_c] == keys
        if not hit.any():
            return (np.zeros(0, np.int64), np.zeros(0, np.int64))
        slot = pos[hit]
        pt_of_cell = np.repeat(np.arange(T, dtype=np.int64),
                               len(span) * len(span))[hit]
        starts = self._cell_off[slot]
        counts = self._cell_off[slot + 1] - starts
        total = int(counts.sum())
        # ragged gather of every occupied cell's edge list
        off = np.zeros(len(counts), dtype=np.int64)
        np.cumsum(counts[:-1], out=off[1:])
        flat = np.arange(total, dtype=np.int64) + np.repeat(starts - off,
                                                            counts)
        e = self._cell_edges[flat].astype(np.int64)
        pt = np.repeat(pt_of_cell, counts)
        # dedup (pt, edge): an edge spans several neighborhood cells. The
        # unique sort also fixes the tie order (ascending edge id within a
        # point), matching the old per-point np.unique exactly.
        pair = pt * np.int64(self.net.num_edges) + e
        pair = np.unique(pair)
        return (pair // np.int64(self.net.num_edges),
                pair % np.int64(self.net.num_edges))

    def candidates(self, lat: np.ndarray, lon: np.ndarray, k: int,
                   search_radius_m: float = 50.0) -> CandidateSet:
        """K nearest edges within ``search_radius_m`` for each probe point.

        ``search_radius_m`` mirrors the matcher knob of the same name
        (reference: Dockerfile:14-17, generate_test_trace.py:51). One call
        serves any number of points — of one trace or a whole batch of
        traces (flat columns) — in a fixed set of numpy ops.
        """
        to_xy, _ = self.net.projection()
        px, py = to_xy(np.asarray(lat, dtype=np.float64),
                       np.asarray(lon, dtype=np.float64))
        px = np.atleast_1d(px).astype(np.float64)
        py = np.atleast_1d(py).astype(np.float64)
        T = len(px)

        edge_ids = np.full((T, k), PAD_EDGE, dtype=np.int32)
        dist_m = np.full((T, k), PAD_DIST, dtype=np.float32)
        offset_m = np.zeros((T, k), dtype=np.float32)
        proj_x = np.zeros((T, k), dtype=np.float32)
        proj_y = np.zeros((T, k), dtype=np.float32)

        pt, e = self._pair_candidates(px, py, search_radius_m)
        if not len(pt):
            return CandidateSet(edge_ids, dist_m, offset_m, proj_x, proj_y)

        # project every (point, edge) pair at once
        ax, ay = self.ax[e], self.ay[e]
        frac = ((px[pt] - ax) * self.dx[e] + (py[pt] - ay) * self.dy[e]) \
            / self.len2[e]
        frac = np.clip(frac, 0.0, 1.0)
        qx = ax + frac * self.dx[e]
        qy = ay + frac * self.dy[e]
        d = np.hypot(px[pt] - qx, py[pt] - qy)
        inside = d <= search_radius_m
        if not inside.any():
            return CandidateSet(edge_ids, dist_m, offset_m, proj_x, proj_y)
        pt, e, frac, qx, qy, d = (a[inside]
                                  for a in (pt, e, frac, qx, qy, d))

        # top-k per point: sort by (point, distance, edge) — the stable
        # per-point argsort over ascending-edge pairs this replaces broke
        # distance ties by edge id, so the tertiary key preserves it —
        # then rank within each point's group and keep ranks < k
        order = np.lexsort((e, d, pt))
        pt, e, frac, qx, qy, d = (a[order]
                                  for a in (pt, e, frac, qx, qy, d))
        first = np.r_[True, pt[1:] != pt[:-1]]
        group_start = np.maximum.accumulate(
            np.where(first, np.arange(len(pt)), 0))
        rank = np.arange(len(pt)) - group_start
        keep = rank < k
        rows = pt[keep]
        cols = rank[keep]
        e, frac, qx, qy, d = (a[keep] for a in (e, frac, qx, qy, d))
        edge_ids[rows, cols] = e
        dist_m[rows, cols] = d
        offset_m[rows, cols] = frac * self.net.edge_length_m[e]
        proj_x[rows, cols] = qx
        proj_y[rows, cols] = qy

        return CandidateSet(edge_ids, dist_m, offset_m, proj_x, proj_y)
