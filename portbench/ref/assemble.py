"""Frozen copy of the port's ``reporter_tpu_torch/matcher/assemble.py`` (the plain
reference of the benchmark; imports nothing of the program).

Decoded candidate path -> OSMLR segment sequence (the match output).

Produces the ``segment_matcher`` schema the reference's clients consume
(reference: README.md "Reporter Output"; consumed by report() at
py/reporter_service.py:103-162):

  segments: [{segment_id?, way_ids, start_time, end_time, length,
              queue_length, internal, begin_shape_index, end_shape_index}]

Semantics preserved:
- ``start_time == -1``  — the path got onto the segment mid-segment
- ``end_time == -1``    — the path left the segment mid-segment
- ``length == -1``      — the segment was not completely traversed
- ``internal`` entries (turn channels etc.) carry no segment_id
- entry/exit times are interpolated along the route between the two probe
  points straddling the segment boundary.

This walk is pure host-side post-processing over the device's decoded
(T,) candidate indices; it runs per trace after the batched Viterbi.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .network import RoadNetwork
from .route import UNREACHABLE
from .spatial import PAD_EDGE
from .consts import RESTART

# how close (meters) an observation must be to a segment boundary to count
# as having been observed at the boundary itself
_BOUNDARY_EPS = 1.0

# queue_length extrapolates from the queue's observed back edge to the
# segment end (reference README.md:283 anchors the field at the end); a
# stall observed further than this from the end says nothing about the end
# of the segment, so no queue is reported
_QUEUE_END_PROXIMITY_M = 100.0


def _interp_time(pos: float, pos_a: float, pos_b: float,
                 time_a: float, time_b: float) -> float:
    if pos_b <= pos_a:
        return float(time_a)
    frac = (pos - pos_a) / (pos_b - pos_a)
    frac = min(max(frac, 0.0), 1.0)
    return float(time_a + frac * (time_b - time_a))


class _Run:
    """Consecutive decoded points on the same OSMLR segment (or the same
    non-associated stretch)."""

    __slots__ = ("segment_id", "internal", "first_idx", "last_idx",
                 "first_pos", "last_pos", "first_time", "last_time",
                 "first_cum", "last_cum", "edges",
                 "start_time", "end_time", "queue_start")

    def __init__(self, segment_id: Optional[int], internal: bool, idx: int,
                 pos: float, time: float, cum: float, edge: int):
        self.segment_id = segment_id
        self.internal = internal
        self.first_idx = self.last_idx = idx
        self.first_pos = self.last_pos = pos
        self.first_time = self.last_time = time
        self.first_cum = self.last_cum = cum
        self.edges = [edge]
        self.start_time: float = -1.0
        self.end_time: float = -1.0
        # segment position where the current trailing slow stretch began;
        # None while traffic is moving (reference: README.md:283 —
        # queue_length is the slow tail measured from the segment end)
        self.queue_start: Optional[float] = None

    def queue_length(self, seg_len: float) -> int:
        if self.segment_id is None or self.queue_start is None \
                or seg_len <= 0.0:
            return 0
        # only extrapolate to the segment end when the queue was actually
        # observed near it (last observation within the proximity bound)
        if seg_len - self.last_pos > _QUEUE_END_PROXIMITY_M:
            return 0
        return int(round(max(seg_len - self.queue_start, 0.0)))


def assemble_segments(net: RoadNetwork, prepared, path: np.ndarray,
                      mode: str = "auto",
                      queue_threshold_kph: float = 10.0,
                      interpolation_distance_m: float = 10.0,
                      backward_tolerance_m: float = 25.0,
                      turn_penalty_factor: float = 0.0) -> dict:
    """Build the match dict for one trace.

    ``prepared`` is a PreparedTrace (host tensors incl. times);
    ``path`` is the device-decoded (T,) candidate index per point.
    ``turn_penalty_factor`` must echo the matcher's: route_m prices
    heading changes INTO its distances for Viterbi ranking (Meili
    semantics), but cumulative route positions here must be geometric —
    the penalty is subtracted back out along the decoded path, else
    boundary interpolation and the traversal-consistency checks read
    penalty meters as road meters.
    """
    n = int(prepared.num_kept)
    if n == 0:
        return {"segments": [], "mode": mode}

    # one vectorised gather pass, then plain-scalar control flow: per-element
    # numpy indexing/int()/float() dominates this walk otherwise
    ks = np.asarray(path[:n], dtype=np.int64)
    rows = np.arange(n)
    edges = prepared.edge_ids[rows, ks].astype(np.int64)
    pad = edges == PAD_EDGE
    safe = np.where(pad, 0, edges)
    seg_ids = net.edge_segment_id[safe]
    seg_pos = net.edge_segment_offset_m[safe].astype(np.float64) + \
        prepared.offset_m[rows, ks]
    internal = net.edge_internal[safe]
    kept = np.asarray(prepared.kept_idx[:n], dtype=np.int64)
    times_kept = np.asarray(prepared.times)[kept]
    restarts = prepared.case[:n] == RESTART
    steps = prepared.route_m[np.arange(n - 1), ks[:-1], ks[1:]] if n > 1 \
        else np.zeros(0, dtype=np.float32)
    if turn_penalty_factor > 0 and n > 1:
        # strip the ranking-only turn penalty from the decoded steps
        # (reachable ones; same-edge transitions price no penalty and
        # their cos term is 1, so the correction is uniformly safe)
        heads = net.headings()
        cos_th = np.einsum("ij,ij->i", heads[safe[:-1]], heads[safe[1:]])
        penalty = turn_penalty_factor * 0.5 * (1.0 - cos_th)
        steps = np.where(steps < UNREACHABLE / 2,
                         np.maximum(steps - penalty, 0.0), steps)

    segments: List[dict] = []

    # a vehicle stalled at trace end emits points the jitter filter drops
    # (all within interpolation_distance of the last kept point), so the
    # kept-point speeds never see the stall; the dwell time of that raw
    # tail bounds its speed and marks the queue instead. batchpad computes
    # the dwell only for verifiably-jitter tails (0 for off-network or
    # bucket-truncated tails, which carry no stay-put guarantee). Mid-trace
    # stalls need no special case: dropped points stretch dt between kept
    # points.
    trailing_dwell_s = float(getattr(prepared, "trailing_jitter_dwell_s",
                                     0.0))

    # chains of kept points, split at RESTART boundaries, decoded-pad
    # points and unroutable decoded transitions; excluded points BETWEEN
    # runs are attributed to spans by the fix-up after the walk (dropped
    # points inside one run's span need nothing). The scan is a fixed set
    # of array ops: a chain is a maximal run of consecutive non-pad
    # points with no break flag, so boundaries fall out of one mask and
    # each chain is a contiguous slice of the gathered columns.
    nonpad_idx = np.flatnonzero(~pad)
    if nonpad_idx.size:
        break_before = np.ones(n, dtype=bool)
        if n > 1:
            break_before[1:] = (restarts[1:] | pad[:-1]
                                | (steps >= UNREACHABLE / 2))
        chain_pos = np.flatnonzero(break_before[nonpad_idx])
        chain_lo = nonpad_idx[chain_pos]
        chain_hi = np.r_[nonpad_idx[chain_pos[1:] - 1] + 1,
                         nonpad_idx[-1] + 1]
        # within-chain cumulative route position: sequential f64
        # accumulation (np.cumsum), matching the scalar walk bit-for-bit;
        # chains reset to 0 (only intra-chain differences are consumed)
        steps64 = np.asarray(steps, dtype=np.float64)
        last_chain = len(chain_lo) - 1
        # the trailing dwell belongs to the chain still open at trace end
        dwell_ok = int(nonpad_idx[-1]) == n - 1
        for k in range(len(chain_lo)):
            lo, hi = int(chain_lo[k]), int(chain_hi[k])
            cum = np.zeros(hi - lo, dtype=np.float64)
            if hi - lo > 1:
                np.cumsum(steps64[lo:hi - 1], out=cum[1:])
            final = k == last_chain and dwell_ok
            segments.extend(_chain_to_segments(
                net,
                (kept[lo:hi], edges[lo:hi], seg_ids[lo:hi],
                 seg_pos[lo:hi], times_kept[lo:hi], cum, internal[lo:hi]),
                queue_threshold_kph,
                trailing_dwell_s=trailing_dwell_s if final else 0.0,
                interpolation_distance_m=interpolation_distance_m,
                backward_tolerance_m=backward_tolerance_m))

    # attribute the jitter points the HMM excluded: gap points between
    # runs join the FOLLOWING run (keeping the preceding run's end at
    # its last kept probe — the shape_used trim anchor), and a
    # verifiably-jitter trailing tail joins the final run. Candidate-
    # less probes — off-network — stay unattributed wherever they occur:
    # leading ones, and any in a between-run gap together with the
    # jitter points BEFORE them (spans are contiguous and cannot
    # hole-punch). Without this fix-up, every dropped point between
    # runs reads as unmatched to consumers walking the spans.
    hc = getattr(prepared, "has_cands", None)
    for prev, cur in zip(segments, segments[1:]):
        lo = prev["end_shape_index"] + 1
        hi = cur["begin_shape_index"]
        start = lo
        if hc is not None:
            # candidate-less (off-network) gap points stay unattributed;
            # spans are contiguous, so attribution reaches back only to
            # just after the last off-network point in the gap
            for j in range(hi - 1, lo - 1, -1):
                if not hc[j]:
                    start = j + 1
                    break
        cur["begin_shape_index"] = start
    if segments and trailing_dwell_s > 0.0:
        segments[-1]["end_shape_index"] = int(prepared.num_raw) - 1

    return {"segments": segments, "mode": mode}


def _chain_to_segments(net: RoadNetwork, chain: tuple,
                       queue_threshold_kph: float = 10.0,
                       trailing_dwell_s: float = 0.0,
                       interpolation_distance_m: float = 10.0,
                       backward_tolerance_m: float = 25.0) -> List[dict]:
    """``chain``: column arrays (idx, edge, seg_id, seg_pos, time, cum,
    internal) for one contiguous chain of decoded points."""
    idxs, edges_a, sids_raw, poss, times_a, cums, internals = chain
    m = len(idxs)
    # a re-entry onto the same segment starts a new run — but apparent
    # backward movement within the matcher's backward tolerance is
    # along-track GPS noise (the same phenomenon route_distance prices as
    # staying put), not a loop back onto the segment; splitting on it
    # shatters one traversal into several partial runs and loses the
    # complete-traversal report
    reentry_tol = max(_BOUNDARY_EPS, backward_tolerance_m)
    # run boundaries in one vector pass: every negative segment id means
    # "unassociated", so they collapse to one sentinel before comparing
    sids = np.where(sids_raw < 0, np.int64(-1), sids_raw)
    new_run = np.ones(m, dtype=bool)
    if m > 1:
        new_run[1:] = ((sids[1:] != sids[:-1])
                       | (internals[1:] != internals[:-1])
                       | ((sids[1:] >= 0)
                          & (poss[1:] < poss[:-1] - reentry_tol)))
    run_lo = np.flatnonzero(new_run)
    run_hi = np.r_[run_lo[1:], m]
    runs: List[_Run] = []
    for a, b in zip(run_lo.tolist(), run_hi.tolist()):
        sid_v = int(sids[a])
        r = _Run(sid_v if sid_v >= 0 else None, bool(internals[a]),
                 int(idxs[a]), float(poss[a]), float(times_a[a]),
                 float(cums[a]), int(edges_a[a]))
        if b - a > 1:
            r.last_idx = int(idxs[b - 1])
            r.last_pos = float(poss[b - 1])
            r.last_time = float(times_a[b - 1])
            r.last_cum = float(cums[b - 1])
            e = edges_a[a:b]
            r.edges = e[np.r_[True, e[1:] != e[:-1]]].tolist()
            # queue detection: the trailing maximal streak of slow
            # intervals (dt > 0) anchors queue_start at the position
            # where the streak began; any fast interval resets it
            dts = times_a[a + 1:b] - times_a[a:b - 1]
            act = dts > 0.0
            with np.errstate(divide="ignore", invalid="ignore"):
                speed = (poss[a + 1:b] - poss[a:b - 1]) / dts * 3.6
            slow = act & (speed < queue_threshold_kph)
            fast = act & ~slow
            lf = np.flatnonzero(fast)
            start_j = int(lf[-1]) + 1 if lf.size else 0
            sl = np.flatnonzero(slow[start_j:])
            if sl.size:
                r.queue_start = float(poss[a + start_j + int(sl[0])])
        runs.append(r)

    # trailing raw-point dwell (see assemble_segments): the dropped tail
    # stayed within interpolation_distance for dwell seconds — if even the
    # upper-bound speed is below the queue threshold, the vehicle is queued
    # at its last decoded position
    if trailing_dwell_s > 0.0 and runs:
        last_run = runs[-1]
        # tail points sit anywhere in a disc of one interpolation distance
        # around the last kept point, so net displacement is bounded by the
        # disc's diameter (2r), not its radius
        bound_kph = 2.0 * interpolation_distance_m / trailing_dwell_s * 3.6
        if bound_kph < queue_threshold_kph and last_run.queue_start is None:
            last_run.queue_start = last_run.last_pos

    # interpolate boundary times between adjacent runs. The boundary
    # crossing must actually lie on the route between the two straddling
    # probes: a claimed exit (segment end) beyond the next probe's route
    # position, or a claimed entry (segment start) before the previous
    # probe's, means the route never traversed that part of the segment —
    # a one-point flicker onto a crossing way at an intersection would
    # otherwise read as a COMPLETE traversal of the whole crossing
    # segment (clamped interpolation hid the contradiction). The
    # reference's native matcher derives completeness from actual edge
    # traversal (starts/ends flags); this check is the time-domain
    # equivalent.
    for a, b in zip(runs[:-1], runs[1:]):
        # time as a function of cumulative route position between the two
        # probes straddling the boundary
        pos_a, pos_b = a.last_cum, b.first_cum
        ta, tb = a.last_time, b.first_time
        if a.segment_id is not None:
            seg_len = net.segment_length_m.get(a.segment_id, 0.0)
            exit_cum = a.last_cum + max(seg_len - a.last_pos, 0.0)
            if exit_cum <= pos_b + _BOUNDARY_EPS:
                a.end_time = _interp_time(exit_cum, pos_a, pos_b, ta, tb)
            # else: exit unobserved; end_time stays -1
        else:
            a.end_time = ta
        if b.segment_id is not None:
            entry_cum = b.first_cum - b.first_pos
            if entry_cum >= pos_a - _BOUNDARY_EPS:
                b.start_time = _interp_time(entry_cum, pos_a, pos_b, ta, tb)
            # else: entry unobserved; start_time stays -1
        else:
            b.start_time = tb

    # chain endpoints: partial entry/exit => -1 sentinels. The "at the
    # boundary" test tolerates THREE interpolation distances: a trace
    # that genuinely starts/ends at a segment node projects a few meters
    # inside it (candidate projection carries the GPS noise), the jitter
    # filter may have dropped the true final probe (anything within one
    # interpolation distance of the last kept point), and sampling stops
    # up to a probe interval before the physical route end — a 1 m eps
    # would mark nearly every genuine end-to-end traversal partial
    end_tol = max(_BOUNDARY_EPS, 3.0 * interpolation_distance_m)
    if runs:
        # a single-point run that is BOTH chain endpoints gets no grants:
        # one probe cannot witness a traversal, and with the widened
        # tolerance a short segment's lone re-fed straddling probe (the
        # shape_used overlap) would otherwise read as a second complete
        # traversal at every window boundary
        lone_point = (len(runs) == 1
                      and runs[0].first_idx == runs[0].last_idx)
        first = runs[0]
        if first.segment_id is not None and first.first_pos <= end_tol:
            if not lone_point:
                first.start_time = first.first_time
        elif first.segment_id is None:
            first.start_time = first.first_time
        # else stays -1 (got on mid-segment)
        last = runs[-1]
        if last.segment_id is not None:
            seg_len = net.segment_length_m.get(last.segment_id, 0.0)
            if last.last_pos >= seg_len - end_tol and not lone_point:
                last.end_time = last.last_time
            # else stays -1 (still on the segment when the trace ended)
        else:
            last.end_time = last.last_time

    out = []
    for r in runs:
        complete = r.segment_id is not None \
            and r.start_time != -1.0 and r.end_time != -1.0
        seg_len = net.segment_length_m.get(r.segment_id, -1.0) \
            if r.segment_id is not None else -1.0
        entry = {
            "way_ids": [int(e) for e in r.edges],
            "start_time": round(r.start_time, 3),
            "end_time": round(r.end_time, 3),
            "length": int(round(seg_len)) if complete else -1,
            "queue_length": r.queue_length(max(seg_len, 0.0)),
            "internal": r.internal,
            "begin_shape_index": int(r.first_idx),
            "end_shape_index": int(r.last_idx),
        }
        if r.segment_id is not None:
            entry["segment_id"] = int(r.segment_id)
        out.append(entry)
    return out
