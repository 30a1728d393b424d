"""Query surface over the histogram store.

A segment query binary-searches each live segment file of the owning
partition for the segment's contiguous composite-key range (the keys are
sorted — schema.py), scatters the slices into a dense
``(168, N_SPEED_BINS)`` grid, and answers:

- observation count + exact mean speed (from the stored speed sums),
- interpolated percentiles from the binned CDF,
- the speed histogram itself (per requested hour set),
- hour-of-week coverage (distinct hours with data / hours asked),
- next-segment transition counts.

``hours`` restricts to a subset of the week (e.g. the morning peak);
:func:`hours_for_range` converts an epoch time range into that subset.

Batched serving (the multi-city dashboard path): :func:`query_many`
answers hundreds of segments in ONE sweep — segment ids group by owning
partition, each partition's live segment files are opened once (through
the handle LRU), and every file pays a single vectorised
``searchsorted`` over ALL requested key ranges instead of a re-open +
re-search per segment. :func:`query_bbox` resolves a lon/lat bounding
box to the graph tiles it covers (the same ``Tiles`` row/column math
the flush layout uses), enumerates the segments resident in those
partitions, and serves them through the same sweep.
:func:`query_segment` is the single-segment spelling of the same code
path, so batched and single answers are identical by construction.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.osmlr import tile_index, tile_level
from ..core.tiles import LEVEL_SIZES, TileHierarchy
from ..utils import metrics
from .schema import (
    CELLS_PER_SEGMENT,
    HOURS_PER_WEEK,
    N_SPEED_BINS,
    SPEED_BIN_KPH,
    hour_of_week,
)

DEFAULT_PERCENTILES = (25.0, 50.0, 75.0, 95.0)

#: bbox queries refuse to fan out past this many segments by default —
#: the truncation is EXPLICIT in the response ("truncated": true), never
#: a silently shorter list
DEFAULT_BBOX_MAX_SEGMENTS = 1024

#: per-sweep allocation bound: query_many processes a partition's id
#: list in chunks of this many segments (the dense grids cost ~70 KB a
#: segment — a huge request must cost time, never unbounded memory)
SWEEP_CHUNK_SEGMENTS = 1024


def hours_for_range(t0: int, t1: int) -> np.ndarray:
    """Hour-of-week subset covered by an epoch range [t0, t1)."""
    if t1 <= t0:
        return np.zeros(0, dtype=np.int64)
    n_hours = min((int(t1) - 1) // 3600 - int(t0) // 3600 + 1,
                  HOURS_PER_WEEK)
    first = hour_of_week(np.asarray([int(t0)]))[0]
    return np.unique((first + np.arange(n_hours)) % HOURS_PER_WEEK)


def parse_hours_spec(spec: Optional[str]):
    """Parse an hours argument: ``'7-9'`` (inclusive range) or ``'7,8,9'``.
    Shared by the CLI and the /histogram GET surface; range bounds are
    validated here, membership in [0, 167] by :func:`query_segment`."""
    if spec is None:
        return None
    if "-" in spec:
        lo, hi = spec.split("-", 1)
        lo, hi = int(lo), int(hi)
        if hi < lo:
            raise ValueError(f"empty hours range {spec!r}")
        return list(range(lo, hi + 1))
    return [int(h) for h in spec.split(",") if h]


def _percentiles(counts: np.ndarray, qs: Sequence[float]) -> dict:
    """Interpolated percentiles from one segment's per-bin counts (kph)
    — the n=1 spelling of :func:`_batch_percentiles`, so there is ONE
    interpolation implementation to keep correct."""
    counts = np.asarray(counts, dtype=np.int64).reshape(1, -1)
    totals = counts.sum(axis=1)
    vals = _batch_percentiles(counts, totals, qs)
    total = int(totals[0])
    return {f"p{q:g}": round(float(vals[q][0]), 3) if total else None
            for q in qs}


def _hour_selection(hours: Optional[Sequence[int]]) -> np.ndarray:
    if hours is not None:
        hour_sel = np.unique(np.asarray(list(hours), dtype=np.int64))
        if hour_sel.size and (hour_sel.min() < 0
                              or hour_sel.max() >= HOURS_PER_WEEK):
            raise ValueError("hours must be in [0, 167]")
        return hour_sel
    return np.arange(HOURS_PER_WEEK)


def _range_gather(starts: np.ndarray, stops: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Flatten N half-open index ranges into one fancy-index array:
    (indices, owner-of-each-index, total). The whole batch's slices of
    a segment file become ONE gather instead of N memmap slice reads."""
    lens = (stops - starts).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, 0
    shift = np.repeat(starts - np.concatenate(
        ([0], np.cumsum(lens)[:-1])), lens)
    idx = np.arange(total, dtype=np.int64) + shift
    owner = np.repeat(np.arange(starts.shape[0], dtype=np.int64), lens)
    return idx, owner, total


def _sweep_partition(store, level: int, index: int, seg_ids: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, list]:
    """One binary-searched sweep of a partition's live segment files
    for EVERY requested segment at once: per file, a single vectorised
    ``searchsorted`` over all key ranges, ONE fancy-index gather per
    column, and one batched scatter into the dense per-segment grids.
    Returns ``(grid_count (n, CELLS), grid_speed (n, CELLS),
    trans_parts [(owner, to, count)])``."""
    n = seg_ids.shape[0]
    los = seg_ids * CELLS_PER_SEGMENT
    grid_count = np.zeros((n, CELLS_PER_SEGMENT), dtype=np.int64)
    grid_speed = np.zeros((n, CELLS_PER_SEGMENT), dtype=np.float64)
    trans_parts: list = []
    for part in store.live_segments(level, index):
        i0s = np.searchsorted(part.hist_key, los, side="left")
        i1s = np.searchsorted(part.hist_key, los + CELLS_PER_SEGMENT,
                              side="left")
        idx, owner, total = _range_gather(i0s, i1s)
        if total:
            keys = np.asarray(part.hist_key[idx])
            cell = keys - los[owner]
            np.add.at(grid_count, (owner, cell),
                      np.asarray(part.hist_count[idx]))
            np.add.at(grid_speed, (owner, cell),
                      np.asarray(part.hist_speed_sum[idx]))
        j0s = np.searchsorted(part.trans_from, seg_ids, side="left")
        j1s = np.searchsorted(part.trans_from, seg_ids, side="right")
        tidx, towner, ttotal = _range_gather(j0s, j1s)
        if ttotal:
            trans_parts.append((towner,
                                np.asarray(part.trans_to[tidx]),
                                np.asarray(part.trans_count[tidx])))
    return grid_count, grid_speed, trans_parts


def _batch_percentiles(bin_counts: np.ndarray, totals: np.ndarray,
                       qs: Sequence[float]) -> Dict[float, np.ndarray]:
    """Vectorised percentile interpolation over (n, N_SPEED_BINS) bin
    counts — element-for-element the same arithmetic as
    :func:`_percentiles` (validated there), so the batched answer
    carries identical values."""
    for q in qs:
        if not 0.0 < float(q) <= 100.0:
            raise ValueError(f"percentile {q} out of range (0, 100]")
    cdf = np.cumsum(bin_counts, axis=1)
    lower = np.arange(N_SPEED_BINS) * SPEED_BIN_KPH
    rows = np.arange(bin_counts.shape[0])
    out = {}
    for q in qs:
        target = totals * (float(q) / 100.0)
        # rows' searchsorted(cdf, target, "left") == count of cdf < t
        b = np.minimum((cdf < target[:, None]).sum(axis=1),
                       N_SPEED_BINS - 1)
        prev = np.where(b > 0, cdf[rows, np.maximum(b - 1, 0)], 0)
        frac = (target - prev) / np.maximum(bin_counts[rows, b], 1)
        out[q] = lower[b] + frac * SPEED_BIN_KPH
    return out


def _assemble_results(seg_ids: np.ndarray, grid_count: np.ndarray,
                      grid_speed: np.ndarray, trans_parts: list,
                      hour_sel: np.ndarray,
                      percentiles: Sequence[float],
                      max_transitions: int) -> List[dict]:
    """Batched response assembly over one partition's swept grids: all
    grid reductions and percentile math run across segments at once;
    only dict building (and the transition ranking of segments that
    have any) stays per segment."""
    n = seg_ids.shape[0]
    sel_count = grid_count.reshape(
        n, HOURS_PER_WEEK, N_SPEED_BINS)[:, hour_sel, :]
    sel_speed = grid_speed.reshape(
        n, HOURS_PER_WEEK, N_SPEED_BINS)[:, hour_sel, :]
    bin_counts = sel_count.sum(axis=1)
    totals = bin_counts.sum(axis=1)
    speed_sums = sel_speed.sum(axis=(1, 2))
    hours_covered = (sel_count.sum(axis=2) > 0).sum(axis=1)
    pct = _batch_percentiles(bin_counts, totals, percentiles)

    # transitions: concatenate every part's gathered rows, then rank
    # per segment that has any (most segments in a bbox sweep have few)
    per_seg_trans: Dict[int, list] = {}
    if trans_parts:
        owner = np.concatenate([o for o, _t, _c in trans_parts])
        tos = np.concatenate([t for _o, t, _c in trans_parts])
        cnts = np.concatenate([c for _o, _t, c in trans_parts])
        # ONE sort groups every owner's rows (a per-owner boolean mask
        # would rescan the whole array once per owner); np.unique per
        # group re-sorts the slice, so row order within a group is
        # immaterial and the stable sort only keeps this deterministic
        order = np.argsort(owner, kind="stable")
        so, st, sc = owner[order], tos[order], cnts[order]
        uniq, starts = np.unique(so, return_index=True)
        ends = np.append(starts[1:], so.shape[0])
        for k, s, e in zip(uniq.tolist(), starts.tolist(),
                           ends.tolist()):
            uto, inv = np.unique(st[s:e], return_inverse=True)
            csum = np.zeros(uto.shape[0], dtype=np.int64)
            np.add.at(csum, inv, sc[s:e])
            rank = np.argsort(-csum, kind="stable")[:max_transitions]
            per_seg_trans[k] = [
                {"next_id": int(uto[j]), "count": int(csum[j])}
                for j in rank]

    hours_queried = int(hour_sel.size)
    out = []
    for k in range(n):
        seg = int(seg_ids[k])
        total = int(totals[k])
        # final rounding stays in Python round() — np.round's scaled
        # rint can differ in the last ulp, and the single-segment path
        # has always answered with Python rounding
        out.append({
            "segment_id": seg,
            "level": tile_level(seg),
            "tile_index": tile_index(seg),
            "count": total,
            "mean_kph": round(float(speed_sums[k] / total), 3)
            if total else None,
            "percentiles": {f"p{q:g}": round(float(pct[q][k]), 3)
                            if total else None
                            for q in percentiles},
            "histogram": {
                "bin_kph": SPEED_BIN_KPH,
                "counts": bin_counts[k].tolist(),
            },
            "hours_queried": hours_queried,
            "hours_covered": int(hours_covered[k]),
            "coverage": round(int(hours_covered[k]) / hours_queried, 4)
            if hours_queried else 0.0,
            "transitions": per_seg_trans.get(k, []),
        })
    return out


def query_many(store, segment_ids: Sequence[int],
               hours: Optional[Sequence[int]] = None,
               percentiles: Sequence[float] = DEFAULT_PERCENTILES,
               max_transitions: int = 32) -> List[dict]:
    """Answer MANY segments' histogram queries in one store sweep;
    results in input order (duplicates answered from the one sweep)."""
    with metrics.timer("datastore.query.many"):
        ids = [int(s) for s in segment_ids]
        metrics.count("datastore.query.batched_segments", len(ids))
        hour_sel = _hour_selection(hours)
        # group the unique ids by owning partition so each partition's
        # manifest read + handle fetch + per-file sweep happens ONCE
        by_part: Dict[Tuple[int, int], list] = {}
        for seg in dict.fromkeys(ids):  # unique, insertion-ordered
            by_part.setdefault((tile_level(seg), tile_index(seg)),
                               []).append(seg)
        results: Dict[int, dict] = {}
        for (level, index), segs in by_part.items():
            # chunk the sweep: the dense (n, 4200) grids cost ~70 KB a
            # segment, so an unbounded id list must not become one
            # unbounded allocation — each chunk's grids free before the
            # next (answers are per-segment, chunking cannot change
            # them)
            for i in range(0, len(segs), SWEEP_CHUNK_SEGMENTS):
                seg_arr = np.asarray(segs[i:i + SWEEP_CHUNK_SEGMENTS],
                                     dtype=np.int64)
                grid_count, grid_speed, trans_parts = _sweep_partition(
                    store, level, index, seg_arr)
                for res in _assemble_results(seg_arr, grid_count,
                                             grid_speed, trans_parts,
                                             hour_sel, percentiles,
                                             max_transitions):
                    results[res["segment_id"]] = res
        # duplicate ids get their OWN dicts (deep): an in-place
        # consumer mutating one answer must not contaminate its twins
        out, seen = [], set()
        for seg in ids:
            if seg in seen:
                out.append(copy.deepcopy(results[seg]))
            else:
                seen.add(seg)
                out.append(results[seg])
        return out


def query_segment(store, segment_id: int,
                  hours: Optional[Sequence[int]] = None,
                  percentiles: Sequence[float] = DEFAULT_PERCENTILES,
                  max_transitions: int = 32) -> dict:
    """Answer one segment's histogram query; see module docstring.

    This IS the batched path at n=1 (one shared sweep + assembler), so
    ``query_many`` stays answer-identical to per-segment queries by
    construction."""
    with metrics.timer("datastore.query"):
        segment_id = int(segment_id)
        seg_arr = np.asarray([segment_id], dtype=np.int64)
        hour_sel = _hour_selection(hours)
        grid_count, grid_speed, trans_parts = _sweep_partition(
            store, tile_level(segment_id), tile_index(segment_id),
            seg_arr)
        return _assemble_results(seg_arr, grid_count, grid_speed,
                                 trans_parts, hour_sel, percentiles,
                                 max_transitions)[0]


def bbox_tile_range(bbox: Sequence[float], level: int
                    ) -> Tuple[int, int, int, int, int]:
    """(row_lo, row_hi, col_lo, col_hi, ncolumns) — inclusive tile
    row/column bounds of ``level`` covering a (min_lon, min_lat,
    max_lon, max_lat) bbox, using the same row/column math (and edge
    clamps) as the tile layout (core/tiles.py). Out-of-world
    coordinates clamp to the tile system's bounds rather than erroring:
    a dashboard viewport may hang off the map edge."""
    minx, miny, maxx, maxy = (float(v) for v in bbox)
    if maxx < minx or maxy < miny:
        raise ValueError(f"empty bbox {list(bbox)!r}")
    if level not in LEVEL_SIZES:
        raise ValueError(f"level must be one of {sorted(LEVEL_SIZES)}")
    t = TileHierarchy().tiles(level)
    minx = min(max(minx, t.bbox.minx), t.bbox.maxx)
    maxx = min(max(maxx, t.bbox.minx), t.bbox.maxx)
    miny = min(max(miny, t.bbox.miny), t.bbox.maxy)
    maxy = min(max(maxy, t.bbox.miny), t.bbox.maxy)
    return t.row(miny), t.row(maxy), t.col(minx), t.col(maxx), t.ncolumns


def _bbox_ranges(bbox: Sequence[float], level: int) -> List[tuple]:
    """Antimeridian-aware :func:`bbox_tile_range`: a viewport with
    ``maxx`` STRICTLY below ``minx`` wraps ±180 (the reference
    semantics — ``core.tiles._split_antimeridian``, the same helper
    the tile enumeration uses) and yields one row/col range per split
    box. ``maxx == minx`` is a degenerate zero-width viewport, NOT a
    whole-world wrap (the split helper's ``>=`` test would read it as
    one)."""
    from ..core.tiles import _split_antimeridian
    minx, miny, maxx, maxy = (float(v) for v in bbox)
    if maxy < miny:
        raise ValueError(f"empty bbox {list(bbox)!r}")
    if maxx >= minx:
        return [bbox_tile_range([minx, miny, maxx, maxy], level)]
    return [bbox_tile_range([b.minx, b.miny, b.maxx, b.maxy], level)
            for b in _split_antimeridian([minx, miny, maxx, maxy])]


def bbox_partitions(bbox: Sequence[float], level: int) -> List[int]:
    """Graph tile indices of ``level`` intersecting a lon/lat bbox
    (the dense enumeration — tests and small viewports; the query path
    instead intersects the row/col RANGE with on-disk partitions so a
    whole-world bbox never enumerates a million tile ids)."""
    out: List[int] = []
    for r0, r1, c0, c1, ncols in _bbox_ranges(bbox, level):
        out.extend(r * ncols + c
                   for r in range(r0, r1 + 1)
                   for c in range(c0, c1 + 1))
    return sorted(set(out))


def resident_segments(store, level: int, index: int) -> np.ndarray:
    """Distinct segment ids with histogram cells in one partition
    (cached in the store keyed by manifest content — store.py)."""
    return store.resident_segments(level, index)


def query_bbox(store, bbox: Sequence[float], level: int,
               hours: Optional[Sequence[int]] = None,
               percentiles: Sequence[float] = DEFAULT_PERCENTILES,
               max_transitions: int = 32,
               max_segments: int = DEFAULT_BBOX_MAX_SEGMENTS) -> dict:
    """Every resident segment of ``level`` inside a lon/lat bbox, served
    through the :func:`query_many` sweep. The segment list is bounded by
    ``max_segments`` with an explicit ``truncated`` flag."""
    with metrics.timer("datastore.query.bbox"):
        ranges = _bbox_ranges(bbox, level)
        seg_lists = []
        # intersect the bbox's row/col RANGE(s) with what is on disk:
        # O(resident partitions), never O(bbox tiles)
        for lvl, index in store.partitions():
            if lvl != level:
                continue
            if any(r0 <= index // ncols <= r1
                   and c0 <= index % ncols <= c1
                   for r0, r1, c0, c1, ncols in ranges):
                seg_lists.append(resident_segments(store, level, index))
        ids = (np.unique(np.concatenate(seg_lists)).tolist()
               if seg_lists else [])
        truncated = len(ids) > max_segments
        if truncated:
            ids = ids[:max_segments]
        return {
            "bbox": [float(v) for v in bbox],
            "level": int(level),
            "n_segments": len(ids),
            "truncated": truncated,
            "segments": query_many(store, ids, hours=hours,
                                   percentiles=percentiles,
                                   max_transitions=max_transitions),
        }


__all__ = ["query_segment", "query_many", "query_bbox",
           "bbox_partitions", "bbox_tile_range",
           "resident_segments", "hours_for_range",
           "parse_hours_spec", "DEFAULT_PERCENTILES",
           "DEFAULT_BBOX_MAX_SEGMENTS"]
