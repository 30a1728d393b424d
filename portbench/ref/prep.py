"""Frozen copy of the port's numpy prep (``reporter_tpu_torch/matcher/
batchpad.py``: ``bucket_length``, ``PreparedTrace``, ``_select_kept``,
``_prepare_from_candidates`` without candidate pruning, ``_f16_safe``), for
one trace at a time."""
from __future__ import annotations

import bisect
from dataclasses import dataclass

import numpy as np

from .consts import (LENGTH_BUCKETS, NORMAL, RESTART, SKIP,
                     UNREACHABLE_THRESHOLD, WIRE_MAX_M)
from .geo import equirectangular_m
from .route import UNREACHABLE, candidate_route_matrices
from .spatial import PAD_DIST, PAD_EDGE, CandidateSet


def bucket_length(n: int) -> int:
    """Smallest bucket >= n (the last bucket caps the trace length)."""
    idx = bisect.bisect_left(LENGTH_BUCKETS, n)
    return LENGTH_BUCKETS[min(idx, len(LENGTH_BUCKETS) - 1)]


@dataclass
class PreparedTrace:
    """One trace's fixed-width tensors, padded to bucket length T.

    Tensor rows 0..num_kept-1 correspond to the *kept* points;
    ``kept_idx`` maps them back to indices in the original trace.
    """
    num_raw: int           # points in the original trace
    num_kept: int          # points included in the HMM
    kept_idx: np.ndarray   # (num_kept,) i32 original indices
    times: np.ndarray      # (num_raw,) f64 epoch seconds
    edge_ids: np.ndarray   # (T, K) i32
    dist_m: np.ndarray     # (T, K) f32
    offset_m: np.ndarray   # (T, K) f32
    route_m: np.ndarray    # (T-1, K, K) f32
    gc_m: np.ndarray       # (T-1,) f32
    case: np.ndarray       # (T,) i32
    # seconds the raw tail verifiably dwelt at the last kept point (jitter
    # drops only; 0 when the tail was off-network or bucket-truncated)
    trailing_jitter_dwell_s: float = 0.0
    # (num_raw,) bool: raw point had any candidate edge
    has_cands: "np.ndarray | None" = None

    @property
    def T(self) -> int:
        return self.edge_ids.shape[0]


def _select_kept(lat, lon, has_cands, interpolation_distance):
    """Indices of points that enter the HMM: drop candidate-less points and
    points within ``interpolation_distance`` of the last kept point.

    Vectorised common case: when every consecutive pair of candidate-
    bearing points is at least the interpolation distance apart (a moving
    vehicle), the anchor never skips a point and the answer is one array
    op. The sequential scan only runs from the first violation onward,
    where the moving-anchor semantics are irreducibly order-dependent.
    """
    has = np.asarray(has_cands, dtype=bool)
    idx = np.flatnonzero(has)
    if idx.size <= 1:
        return idx.astype(np.int32)
    lat = np.asarray(lat)
    lon = np.asarray(lon)
    gc = np.atleast_1d(equirectangular_m(lat[idx[:-1]], lon[idx[:-1]],
                                         lat[idx[1:]], lon[idx[1:]]))
    viol = np.flatnonzero(gc < interpolation_distance)
    if viol.size == 0:
        return idx.astype(np.int32)
    j = int(viol[0])  # pairs before the first violation are all kept
    kept = idx[:j + 1].tolist()
    for i in idx[j + 1:].tolist():
        gc_i = equirectangular_m(lat[kept[-1]], lon[kept[-1]],
                                 lat[i], lon[i])
        if gc_i < interpolation_distance:
            continue
        kept.append(i)
    return np.asarray(kept, dtype=np.int32)


def _prepare_from_candidates(net, lat, lon, times, all_cands, has_cands,
                             params, cache,
                             prune_margin_m: float) -> PreparedTrace:
    """Kept-point selection, route tensors, case codes and padding for one
    trace whose candidate lookup already happened."""
    num_raw = len(lat)
    K = params.max_candidates
    kept = _select_kept(lat, lon, has_cands, params.interpolation_distance)
    n = len(kept)
    T = bucket_length(max(n, 1))
    truncated = n > T
    if truncated:  # cap at the largest bucket
        kept = kept[:T]
        n = T

    # dwell time of a *jitter-only* trailing tail: every raw point after the
    # last kept one must have candidates and sit within the interpolation
    # distance of that kept point — i.e. the vehicle verifiably stayed put.
    # Tails dropped for lacking candidates (off-network driving) or by
    # bucket truncation carry no such guarantee and count no dwell. Used by
    # segment assembly to detect a vehicle queued at trace end.
    trailing_jitter_dwell_s = 0.0
    if n and not truncated and int(kept[-1]) < num_raw - 1:
        lk = int(kept[-1])
        tail = np.arange(lk + 1, num_raw)
        tail_gc = equirectangular_m(lat[lk], lon[lk], lat[tail], lon[tail])
        if bool(has_cands[tail].all()) and \
                bool((np.atleast_1d(tail_gc)
                      < params.interpolation_distance).all()):
            trailing_jitter_dwell_s = float(times[num_raw - 1] - times[lk])

    cands = CandidateSet(
        edge_ids=all_cands.edge_ids[kept], dist_m=all_cands.dist_m[kept],
        offset_m=all_cands.offset_m[kept], proj_x=all_cands.proj_x[kept],
        proj_y=all_cands.proj_y[kept])

    gc = equirectangular_m(lat[kept[:-1]], lon[kept[:-1]],
                           lat[kept[1:]], lon[kept[1:]]) if n > 1 else np.zeros(0)
    gc = np.atleast_1d(np.asarray(gc, dtype=np.float32))

    # probe time deltas between consecutive KEPT points feed Meili's
    # max_route_time_factor admissibility bound; None disables the bound
    # entirely (factor <= 0)
    dt = None
    if params.max_route_time_factor > 0 and n > 1:
        dt = np.diff(times[kept])

    route = candidate_route_matrices(
        net, cands, gc,
        max_route_distance_factor=params.max_route_distance_factor,
        cache=cache,
        backward_tolerance_m=params.backward_tolerance_m,
        dt=dt, max_route_time_factor=params.max_route_time_factor,
        min_time_bound_s=params.min_time_bound_s,
        turn_penalty_factor=params.turn_penalty_factor)

    # case codes over kept points: RESTART at the first point and after
    # breakage-sized gaps; SKIP only in the padding tail
    case = np.full(T, SKIP, dtype=np.int32)
    if n:
        case[:n] = NORMAL
        case[0] = RESTART
        if n > 1:
            case[1:n][gc[:n - 1] > params.breakage_distance] = RESTART

    # pad to bucket
    edge_ids = np.full((T, K), PAD_EDGE, dtype=np.int32)
    dist = np.full((T, K), PAD_DIST, dtype=np.float32)
    offset = np.zeros((T, K), dtype=np.float32)
    route_p = np.full((max(T - 1, 0), K, K), UNREACHABLE, dtype=np.float32)
    gc_p = np.zeros(max(T - 1, 0), dtype=np.float32)

    edge_ids[:n] = cands.edge_ids
    dist[:n] = cands.dist_m
    offset[:n] = cands.offset_m
    if n > 1:
        route_p[:n - 1] = route
        gc_p[:n - 1] = gc

    return PreparedTrace(num_raw=num_raw, num_kept=n, kept_idx=kept,
                         times=times, edge_ids=edge_ids, dist_m=dist,
                         offset_m=offset, route_m=route_p, gc_m=gc_p,
                         case=case,
                         trailing_jitter_dwell_s=trailing_jitter_dwell_s,
                         has_cands=np.asarray(has_cands))


def _f16_safe(p: PreparedTrace) -> bool:
    """True when every finite distance in the trace fits the f16 wire
    undistorted (sentinel values >= UNREACHABLE_THRESHOLD travel as +inf)."""
    if p.gc_m.size and float(np.amax(p.gc_m)) > WIRE_MAX_M:
        return False
    for arr in (p.route_m, p.dist_m):
        if arr.size and float(np.amax(
                arr, initial=0.0,
                where=arr < UNREACHABLE_THRESHOLD)) > WIRE_MAX_M:
            return False
    return True
