"""Datastore report generation from matcher output: the ``/report`` body.

Behavioral port of the reference's ``report()``
(reference: py/reporter_service.py:79-179). Preserved semantics:

- trailing holdback: segments whose start_time is within ``threshold_sec``
  of the trace end are withheld (the vehicle may still be on them), and
  ``shape_used`` marks how much of the trace may be trimmed
- emission is *pairwise*: a segment is reported only once its successor is
  known; ``t1`` is the successor's start time when the successor's level is
  in ``transition_levels``, else the segment's own end time
- internal segments (turn channels, roundabouts) never clear the pending
  prior segment — they are bridged over
- validity: positive finite dt and speed <= 160 km/h
- the stats block (successful/unreported counts, discontinuities, invalid
  times/speeds, unassociated segments)

One deliberate deviation: the reference *assigns* the last segment's km to
the stats ``length`` fields instead of accumulating
(reporter_service.py:138,142); here lengths are summed, which is the
evident intent of the telemetry.

The ``/report`` response body is :func:`report_json` (a string) or
:func:`report_wire` (bytes), byte-equal to
``json.dumps(report(...), separators=(",", ":"))``: a MatchRuns from the
native path is written by the C writer straight from its run columns.
"""
from __future__ import annotations

import json
import math
from typing import Iterable, List, Optional, Tuple

from ..matcher import matcher as _matcher
from ..utils import metrics
from . import wire


class _Scan:
    """Output of one pass of the emission state machine: the holdback
    cut, the datastore reports as parallel lists, and the stats."""

    __slots__ = ("last_idx", "shape_used", "r_id", "r_t0", "r_t1",
                 "r_len", "r_queue", "r_next", "successful",
                 "successful_km", "unreported", "unreported_km",
                 "discontinuities", "invalid_times", "invalid_speeds",
                 "unassociated")


def _segment_columns(match) -> Tuple[list, ...]:
    """(seg_id, internal, start, end, length, queue, begin_idx, end_idx)
    parallel lists for the scan: straight slices of a MatchRuns's run
    columns, or one comprehension pass per field over plain segment dicts
    (the numpy path). Absent segment ids are -1 (columns) or None
    (dicts); the scan treats both as unassociated."""
    if isinstance(match, _matcher.MatchRuns):
        c, lo, hi = match.cols, match.lo, match.hi
        return (c.seg_id[lo:hi], c.internal[lo:hi], c.start[lo:hi],
                c.end[lo:hi], c.length[lo:hi], c.queue[lo:hi],
                c.begin_idx[lo:hi], c.end_idx[lo:hi])
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


def report(match: dict, trace: dict, threshold_sec: float,
           report_levels: Iterable[int],
           transition_levels: Iterable[int]) -> dict:
    """Turn a match result into datastore reports + stats. Stamps
    ``match["mode"] = "auto"`` and embeds ``match`` as ``segment_matcher``,
    as the reference does."""
    scan = _scan_segments(
        *_segment_columns(match), trace["trace"][-1]["time"],
        threshold_sec, set(report_levels), set(transition_levels))
    match["mode"] = "auto"
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
    # reference quirk preserved: shape_used omitted when falsy (index 0)
    if scan.shape_used:
        out["shape_used"] = scan.shape_used
    out["segment_matcher"] = match
    out["datastore"] = {"mode": "auto", "reports": reports}
    return out


def report_json(match, trace: dict, threshold_sec: float,
                report_levels: Iterable[int],
                transition_levels: Iterable[int]) -> str:
    """The ``/report`` response body, byte-equal to
    ``json.dumps(report(...), separators=(",", ":"))``: a plain-dict match
    (the numpy path) takes exactly that route, a MatchRuns the C writer
    (:func:`report_wire`)."""
    if not isinstance(match, _matcher.MatchRuns):
        return json.dumps(report(match, trace, threshold_sec, report_levels,
                                 transition_levels), separators=(",", ":"))
    return bytes(report_wire(match, trace, threshold_sec, report_levels,
                             transition_levels)).decode("utf-8")


def report_wire(match, trace: dict, threshold_sec: float,
                report_levels: Iterable[int],
                transition_levels: Iterable[int]):
    """The ``/report`` response body as bytes: for a MatchRuns, the C
    writer's buffer (a memoryview, no re-encode), or the Python columnar
    writer's (counted ``wire.fallback``) where the level sets are not a
    bitmask or the writer's failure domain declines; for a dict, the
    encoded :func:`report_json`. Stamps ``match["mode"] = "auto"``."""
    if not isinstance(match, _matcher.MatchRuns):
        return report_json(match, trace, threshold_sec, report_levels,
                           transition_levels).encode("utf-8")
    out = wire.maybe_native_report(
        match.cols.arrays, match.lo, match.hi, trace["trace"][-1]["time"],
        threshold_sec, report_levels, transition_levels)
    if out is None:
        metrics.count("wire.fallback")
        return _report_json_py(match, trace, threshold_sec, report_levels,
                               transition_levels).encode("utf-8")
    match["mode"] = "auto"  # the same side effect as report()
    return out


def _report_json_py(match, trace: dict, threshold_sec: float,
                    report_levels: Iterable[int],
                    transition_levels: Iterable[int]) -> str:
    """The Python columnar writer for a MatchRuns, the oracle the C writer
    is held against: the body straight from the run columns, byte-equal to
    ``json.dumps(report(...))``."""
    scan = _scan_segments(
        *_segment_columns(match), trace["trace"][-1]["time"],
        threshold_sec, set(report_levels), set(transition_levels))
    match["mode"] = "auto"  # the same side effect as report()
    r_t0, r_t1 = scan.r_t0, scan.r_t1
    parts = []
    for i in range(len(scan.r_id)):
        # t0/t1 are columnar start/end values, always finite floats here,
        # so bare repr matches json.dumps byte for byte
        nx = scan.r_next[i]
        parts.append(
            f'{{"id":{scan.r_id[i]},"t0":{r_t0[i]!r},'
            f'"t1":{r_t1[i]!r},"length":{scan.r_len[i]},'
            f'"queue_length":{scan.r_queue[i]}'
            + (f',"next_id":{nx}}}' if nx is not None else "}"))
    jnum = _matcher._jnum
    body = (
        '{"stats":{"successful_matches":{"count":%d,"length":%s},'
        '"unreported_matches":{"count":%d,"length":%s},'
        '"match_errors":{"discontinuities":%d,"invalid_speeds":%d,'
        '"invalid_times":%d},"unassociated_segments":%d}'
        % (scan.successful, jnum(round(scan.successful_km, 3)),
           scan.unreported, jnum(round(scan.unreported_km, 3)),
           scan.discontinuities, scan.invalid_speeds, scan.invalid_times,
           scan.unassociated))
    if scan.shape_used:
        body += f',"shape_used":{scan.shape_used}'
    # the holdback cut is over reported segments only; the echoed
    # segment_matcher carries every run, as report() does
    body += (',"segment_matcher":'
             + _matcher.render_segments_json_py(match.cols, match.lo,
                                                match.hi, "auto")
             + ',"datastore":{"mode":"auto","reports":['
             + ",".join(parts) + "]}}")
    return body
