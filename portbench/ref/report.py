"""Frozen copy of the port's ``report()`` (``reporter_tpu_torch/service/
report.py``: the pairwise emission state machine over a match's segment
dicts, the reference's reporter_service.py:79-179), and of the batched
pipeline's tile rows and windows (``pipeline/simple_reporter.py``
``_window_spans``, ``_emit_rows`` and the seam dedupe of ``_match_into``).
"""
from __future__ import annotations

import math
import os
from typing import Iterable, List, Optional

import numpy as np

from .osmlr import INVALID_SEGMENT_ID, tile_index, tile_level


class _Scan:
    """Output of one pass of the emission state machine: the holdback
    cut, the datastore reports as parallel lists, and the stats."""

    __slots__ = ("last_idx", "shape_used", "r_id", "r_t0", "r_t1",
                 "r_len", "r_queue", "r_next", "successful",
                 "successful_km", "unreported", "unreported_km",
                 "discontinuities", "invalid_times", "invalid_speeds",
                 "unassociated")


def _segment_columns(match) -> tuple:
    """(seg_id, internal, start, end, length, queue, begin_idx, end_idx)
    parallel lists over plain segment dicts."""
    segs = match["segments"]
    return ([s.get("segment_id") for s in segs],
            [s.get("internal", False) for s in segs],
            [s.get("start_time") for s in segs],
            [s.get("end_time") for s in segs],
            [s.get("length") for s in segs],
            [s.get("queue_length") for s in segs],
            [s.get("begin_shape_index") for s in segs],
            [s.get("end_shape_index") for s in segs])


def _scan_segments(seg_id: list, internal: list, start: list, end: list,
                   length: list, queue: list, begin_idx: list,
                   end_idx: list, trace_end, threshold_sec: float,
                   report_levels: set, transition_levels: set) -> _Scan:
    """The reference's pairwise emission state machine
    (reporter_service.py:79-179) over columnar inputs."""
    n = len(seg_id)

    # ---- trailing holdback (reference: reporter_service.py:83-92) --------
    last_idx = n - 1
    while last_idx >= 0 and trace_end - start[last_idx] < threshold_sec:
        last_idx -= 1
    shape_used: Optional[int] = None
    if last_idx >= 0:
        # keep the boundary-straddling probe: the reference trims at the
        # in-progress segment's first point (reporter_service.py:92), but
        # without the last probe of the PRECEDING segment the next window
        # can never interpolate this segment's entry time, so every
        # window-boundary segment would be reported partial (length -1)
        # and dropped — a systematic hole in the datastore stream at
        # every batch trim. The preceding run's end_shape_index is the
        # straddling probe even when jitter-dropped points sit between
        # the runs.
        if last_idx > 0:
            shape_used = end_idx[last_idx - 1]
        else:
            shape_used = max(begin_idx[0] - 1, 0)

    out = _Scan()
    out.last_idx = last_idx
    out.shape_used = shape_used
    r_id: List = []
    r_t0: List = []
    r_t1: List = []
    r_len: List = []
    r_queue: List = []
    r_next: List = []
    successful = unreported = 0
    successful_km = unreported_km = 0.0
    discontinuities = invalid_times = invalid_speeds = unassociated = 0

    # the pending segment awaiting its successor before being reported
    have_pending = False
    p_sid = p_start = p_end = p_len = p_queue = None
    p_level = -1
    first = True
    for idx in range(last_idx + 1):
        sid = seg_id[idx]
        if sid is not None and sid < 0:
            sid = None  # column sentinel for "no OSMLR id"
        intern = internal[idx]
        start_time = start[idx]

        # a partial end followed by a partial start marks a discontinuity
        # (reference: reporter_service.py:114-116)
        if idx > 0 and start_time == -1 and end[idx - 1] == -1:
            discontinuities += 1

        level = (sid & 0x7) if sid is not None else -1

        # emit the pending segment now that its successor is visible;
        # an internal successor defers emission (reference: :122-127)
        if have_pending and p_sid is not None and p_len is not None \
                and p_len > 0 and not intern:
            if p_level in report_levels:
                t1 = start_time if level in transition_levels else p_end
                dt = float(t1) - float(p_start)
                if dt <= 0 or math.isinf(dt) or math.isnan(dt):
                    invalid_times += 1
                elif (p_len / dt) * 3.6 > 160:
                    invalid_speeds += 1
                else:
                    r_id.append(p_sid)
                    r_t0.append(p_start)
                    r_t1.append(t1)
                    r_len.append(p_len)
                    r_queue.append(p_queue)
                    r_next.append(sid if (level in transition_levels
                                          and sid is not None) else None)
                    successful += 1
                    successful_km += round(p_len * 0.001, 3)
            else:
                unreported += 1
                unreported_km += round(p_len * 0.001, 3)

        # internal segments bridge: keep the pending prior
        # (reference: :144-156)
        if not (intern and not first):
            p_sid = sid
            p_start = start_time
            p_end = end[idx]
            p_len = length[idx]
            p_queue = queue[idx]
            p_level = level
            have_pending = True
        first = False

        # service roads etc: matched edges with no OSMLR id
        # (reference: :159-162)
        if sid is None and not intern:
            unassociated += 1

    out.r_id, out.r_t0, out.r_t1 = r_id, r_t0, r_t1
    out.r_len, out.r_queue, out.r_next = r_len, r_queue, r_next
    out.successful, out.successful_km = successful, successful_km
    out.unreported, out.unreported_km = unreported, unreported_km
    out.discontinuities = discontinuities
    out.invalid_times = invalid_times
    out.invalid_speeds = invalid_speeds
    out.unassociated = unassociated
    return out


def report_body(match: dict, trace_end: float, threshold_sec: float,
                report_levels: Iterable[int],
                transition_levels: Iterable[int]) -> dict:
    """The ``/report`` answer ``report()`` builds, without the embedded
    match: ``stats``, ``shape_used`` (when truthy) and
    ``datastore.reports``."""
    scan = _scan_segments(
        *_segment_columns(match), trace_end, threshold_sec,
        set(report_levels), set(transition_levels))
    reports = [
        {"id": i, "t0": t0, "t1": t1, "length": ln, "queue_length": q,
         **({"next_id": nx} if nx is not None else {})}
        for i, t0, t1, ln, q, nx in zip(scan.r_id, scan.r_t0, scan.r_t1,
                                        scan.r_len, scan.r_queue,
                                        scan.r_next)]
    out = {
        "stats": {
            "successful_matches": {
                "count": scan.successful,
                "length": round(scan.successful_km, 3),
            },
            "unreported_matches": {
                "count": scan.unreported,
                "length": round(scan.unreported_km, 3),
            },
            "match_errors": {
                "discontinuities": scan.discontinuities,
                "invalid_speeds": scan.invalid_speeds,
                "invalid_times": scan.invalid_times,
            },
            "unassociated_segments": scan.unassociated,
        },
    }
    if scan.shape_used:
        out["shape_used"] = scan.shape_used
    out["datastore"] = {"mode": "auto", "reports": reports}
    return out


MAX_WINDOW_POINTS = 1024


def _window_spans(times, inactivity: int,
                  max_window: int = MAX_WINDOW_POINTS,
                  holdback_s: int = 15) -> Iterable[tuple]:
    """Index spans ``(lo, hi)`` of matcher windows over a sorted times
    array: split at gaps > ``inactivity`` seconds (reference:
    simple_reporter.py:149-163), then chunk long windows with a
    trailing-holdback overlap (see :func:`_windows_of`). Operating on
    index spans keeps the columnar pipeline zero-copy: each window is a
    slice of the uuid's coordinate arrays, never a list of point dicts.
    """
    times = np.asarray(times, dtype=np.float64)
    n = len(times)

    def chunked(start: int, end: int) -> Iterable[tuple]:
        while end - start > max_window:
            yield (start, start + max_window)
            end_t = times[start + max_window - 1]
            j = max_window - 1
            while j > 0 and end_t - times[start + j] <= holdback_s:
                j -= 1
            # progress floor: a pathological burst (>max_window points
            # inside one holdback span) must not degrade to 1-point steps
            # and ~N chunks; advancing at least half a window caps the
            # re-presented overlap at 2x total work
            j = max(max_window // 2, min(j, max_window - 1))
            start += j
        if end - start >= 2:
            yield (start, end)

    gap_at = np.flatnonzero(np.diff(times) > inactivity) + 1
    lo = 0
    for g in gap_at.tolist() + [n]:
        if g - lo >= 2:
            yield from chunked(lo, g)
        lo = g



def emit_rows(reports: list, times, quantisation: int, source: str,
               mode: str, tiles: dict) -> None:
    """Usable reports -> per-bucket tile rows
    (reference: simple_reporter.py:176-196)."""
    max_buckets = (int(times[-1]) - int(times[0])) // quantisation + 1
    for r in reports:
        if not (r["t0"] > 0 and r["t1"] > 0 and r["t1"] - r["t0"] > 0.5
                and r["length"] > 0 and r["queue_length"] >= 0):
            continue
        duration = int(round(r["t1"] - r["t0"]))
        start = int(math.floor(r["t0"]))
        end = int(math.ceil(r["t1"]))
        lo_b, hi_b = start // quantisation, end // quantisation
        if hi_b - lo_b > max_buckets:
            continue
        for b in range(lo_b, hi_b + 1):
            tile_file = os.path.join(
                f"{b * quantisation}_{(b + 1) * quantisation - 1}",
                str(tile_level(r["id"])), str(tile_index(r["id"])))
            row = ",".join([
                str(r["id"]), str(r.get("next_id", INVALID_SEGMENT_ID)),
                str(duration), "1", str(r["length"]),
                str(r["queue_length"]), str(start), str(end),
                source, mode.upper()]) + "\n"
            tiles.setdefault(tile_file, []).append(row)
