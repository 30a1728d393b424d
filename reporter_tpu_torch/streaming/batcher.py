"""Per-uuid point batching and report triggering.

The streaming analog of the reference's Batch + BatchingProcessor
(reference: Batch.java, BatchingProcessor.java). Semantics preserved:

- a per-uuid window accumulates points, tracking the max separation from
  the *first* point by equirectangular distance (Batch.java:34-47)
- a report fires once the window spans >= 500 m AND >= 10 points AND
  >= 60 s (BatchingProcessor.java:26-28); on response, the consumed prefix
  is trimmed at ``shape_used`` so match context overlaps windows
  (Batch.java:73-80)
- batches idle past the 60 s session gap are evicted with relaxed
  thresholds (0 m, 2 points, 0 s) (BatchingProcessor.java:87-106)
- valid (id, next_id) report pairs are forwarded keyed "id next_id"
  (BatchingProcessor.java:108-141)
- an unparseable matcher response drops the whole batch (Batch.java:83-87)

One reference behavior is deliberately NOT preserved: a failed submit no
longer silently drops the batch. Transient failures requeue the batch
under a small retry budget (``retry_budget``, counted as
``batch.requeued``); an exhausted budget dead-letters the trace JSON to
a spool directory for replay and counts ``batch.dropped`` — the matcher
outage failure domain has a defined degraded mode instead of data loss.

The matcher call is pluggable: an in-process
``ReporterService.report_incremental`` (one device batch across uuids)
instead of one HTTP POST per trace, though an HTTP submitter is provided
for split deployments.

The port of ``reporter_tpu/streaming/batcher.py``; the JAX package's
``REPORTER_TPU_SUBMIT_RETRIES`` is the ``retry_budget`` argument (2). The
``batcher.flush`` span's durations also go to the ``batcher.flush``
timer, so its quantiles read from ``/stats`` with tracing off.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.geo import equirectangular_m
from ..core.osmlr import INVALID_SEGMENT_ID
from ..core.tracebatch import TraceBatch, TraceView
from ..core.types import Point, Segment
from ..obs import flightrec
from ..obs import trace as obs_trace
from ..utils import faults, metrics, spool
from .backpressure import BackpressureGovernor

logger = logging.getLogger("reporter_tpu_torch.streaming")

REPORT_TIME = 60       # seconds       (BatchingProcessor.java:26)
REPORT_COUNT = 10      # points        (:27)
REPORT_DIST = 500      # meters        (:28)
SESSION_GAP_MS = 60000  # milliseconds (:29)


class Batch:
    __slots__ = ("max_separation", "last_update", "points", "retries")

    def __init__(self, point: Optional[Point] = None):
        self.max_separation = 0.0
        self.last_update = 0
        # consecutive failed submit attempts (bounded-requeue budget);
        # carried in the state snapshot so a restart keeps the bound
        self.retries = 0
        self.points: List[Point] = [point] if point is not None else []

    def update(self, p: Point) -> None:
        if self.points:
            self.max_separation = max(
                self.max_separation,
                equirectangular_m(p.lat, p.lon,
                                  self.points[0].lat, self.points[0].lon))
        self.points.append(p)

    def request_body(self, uuid: str, mode: str, report_on: str,
                     transition_on: str) -> dict:
        return {
            "uuid": uuid,
            "match_options": {
                "mode": mode,
                "report_levels": [int(x) for x in report_on.split(",")],
                "transition_levels": [int(x) for x in transition_on.split(",")],
            },
            "trace": [p.to_json_obj() for p in self.points],
        }

    def request_columns(self, uuid: str, options: dict) -> tuple:
        """Columnar request part (uuid, lat, lon, time, accuracy,
        options) straight from the Point objects — the zero-dict batched
        flush path (TraceBatch.concat consumes these)."""
        pts = self.points
        n = len(pts)
        # Point stores f32-rounded lat/lon on the binary wire; the json
        # body rounds to 6 decimals identically, so columns == dict path
        lat = np.fromiter((round(float(p.lat), 6) for p in pts),
                          np.float64, n)
        lon = np.fromiter((round(float(p.lon), 6) for p in pts),
                          np.float64, n)
        tm = np.fromiter((p.time for p in pts), np.float64, n)
        acc = np.fromiter((p.accuracy for p in pts), np.float32, n)
        return (uuid, lat, lon, tm, acc, options)

    def should_report(self, min_dist: float, min_size: int,
                      min_elapsed: float) -> bool:
        return not (self.max_separation < min_dist
                    or len(self.points) < min_size
                    or self.points[-1].time - self.points[0].time
                    < min_elapsed)

    def drop(self) -> None:
        self.max_separation = 0.0
        self.points.clear()

    def apply_response(self, uuid: str,
                       response: Optional[dict]) -> Optional[dict]:
        """Trim consumed points per the response's ``shape_used``; a None
        (failed round trip) or unusable response drops the batch, like an
        unparseable response does in the reference (Batch.java:83-87)."""
        if response is None:
            logger.error("Match submit failed for %s", uuid)
            self.drop()
            return None
        try:
            sm = response.get("segment_matcher")
            # MatchRuns exposes a lazy emptiness probe; only plain-dict
            # matches (HTTP split deployments) pay the segments lookup
            has_segments = sm.has_runs() if hasattr(sm, "has_runs") \
                else bool(sm.get("segments")) if sm else False
            if "shape_used" in response:
                trim_to = response["shape_used"]
            elif has_segments:
                # segments matched but none consumed yet (the service
                # omits a falsy shape_used — reference quirk): everything
                # is still in-progress context, so keep it all. Trimming
                # to len(points) here would throw away the in-progress
                # segment AND the straddling probe the next window needs.
                trim_to = 0
            else:
                # nothing matched at all: the context is worthless;
                # consume it for forward progress (reference behavior)
                trim_to = len(self.points)
            del self.points[:trim_to]
            self.max_separation = 0.0
            pts = self.points
            if len(pts) > 1:
                # one columnar pass (reporter-lint HP001: the old
                # per-point loop re-ran scalar equirectangular_m per
                # surviving point on every trim)
                n = len(pts)
                lat = np.fromiter((p.lat for p in pts), np.float64, n)
                lon = np.fromiter((p.lon for p in pts), np.float64, n)
                self.max_separation = float(np.max(
                    equirectangular_m(lat[1:], lon[1:], lat[0], lon[0])))
            return response
        except Exception:
            self.drop()
            return None

    def report(self, uuid: str, submit: Callable[[dict], Optional[dict]],
               mode: str, report_on: str, transition_on: str,
               min_dist: float, min_size: int, min_elapsed: float
               ) -> Optional[dict]:
        """Fire a report if thresholds are met; trim consumed points."""
        if not self.should_report(min_dist, min_size, min_elapsed):
            return None
        try:
            response = submit(self.request_body(uuid, mode, report_on,
                                                transition_on))
        except Exception as e:
            # a failed round trip drops the batch, like an unparseable
            # response does in the reference
            logger.error("Match submit failed for %s: %s", uuid, e)
            self.drop()
            return None
        return self.apply_response(uuid, response)


def segments_from_response(response: Optional[dict]) -> List[Tuple[str, Segment]]:
    """datastore.reports[] -> [(key, Segment)] with validity filtering
    (reference: BatchingProcessor.java:108-141)."""
    out: List[Tuple[str, Segment]] = []
    if response is None:
        return out
    datastore = response.get("datastore")
    reports = datastore.get("reports") if datastore else None
    if reports is None:
        if response:
            logger.error("Unusable report %s", json.dumps(response)[:200])
        return out
    for entry in reports:
        try:
            seg = Segment(
                id=int(entry["id"]),
                next_id=(int(entry["next_id"])
                         if entry.get("next_id") is not None else None),
                min=float(entry["t0"]), max=float(entry["t1"]),
                length=int(entry["length"]),
                queue=int(entry["queue_length"]))
        except Exception as e:
            logger.error("Unusable reported segment pair: %s (%s)", entry, e)
            continue
        if seg.valid():
            out.append((f"{seg.id} {seg.next_id}", seg))
        else:
            logger.warning("Got back invalid segment: %s", entry)
    return out


class PointBatcher:
    """Stateful (uuid -> Batch) processor with eviction.

    ``submit`` performs the match+report round trip and returns the parsed
    response dict (or None). ``forward`` receives (key, Segment) pairs.
    """

    def __init__(self, submit: Callable[[dict], Optional[dict]],
                 forward: Callable[[str, Segment], None],
                 mode: str = "auto", report_on: str = "0,1",
                 transition_on: str = "0,1",
                 session_gap_ms: int = SESSION_GAP_MS,
                 submit_many: Optional[Callable[
                     [List[dict]], List[Optional[dict]]]] = None,
                 report_flush: int = 64,
                 retry_budget: int = 2,
                 deadletter_dir: Optional[str] = None,
                 governor: Optional[BackpressureGovernor] = None,
                 on_evict: Optional[Callable[[str], None]] = None):
        self.submit = submit
        # session-end hook: called once per uuid evicted at the session
        # gap, AFTER its final relaxed-threshold report flushed — the
        # worker wires this to the matcher's carried-state eviction so
        # incremental decode state dies with the session, not the budget
        self.on_evict = on_evict
        # batched submit for flush paths (one device batch for a whole
        # punctuate/pending flush); falls back to per-uuid submit
        self.submit_many = submit_many or (
            lambda bodies: [self._submit_safe(b) for b in bodies])
        self.forward = forward
        self.mode = mode
        self.report_on = report_on
        self.transition_on = transition_on
        self.session_gap_ms = session_gap_ms
        self.store: Dict[str, Batch] = {}
        # ONE shared match_options dict for every request this batcher
        # emits — lets the matcher resolve params once per device batch
        self.options = {
            "mode": mode,
            "report_levels": [int(x) for x in report_on.split(",")],
            "transition_levels": [int(x) for x in transition_on.split(",")],
        }
        # uuids whose batches crossed the report thresholds, awaiting the
        # next batched flush (ordered set). The reference fires one
        # matcher call per crossing (Batch.java:66-68); deferring them a
        # moment batches many sessions into one padded device decode —
        # same results, the window just extends by a few probes.
        self.pending: Dict[str, None] = {}
        self.report_flush = max(1, int(report_flush))
        # bounded requeue: how many consecutive failed submits a live
        # batch survives before its trace JSON dead-letters (the
        # reference silently dropped the batch on the FIRST failure,
        # Batch.java:83-87)
        self.retry_budget = max(0, retry_budget)
        # spool for exhausted batches' trace JSON (None = log-and-drop);
        # files replay by POSTing their body to any /report endpoint
        self.deadletter_dir = deadletter_dir
        self._deadletter_seq = 0
        # backpressure governor (streaming/backpressure.py): submit-
        # latency EWMA + requeue depth -> bounded offer delays and,
        # past the shed threshold, report-ready sessions dead-letter
        # instead of joining a pending set that can only grow
        self.governor = governor if governor is not None \
            else BackpressureGovernor()
        # sessions currently carrying a failed-submit retry — the
        # governor's requeue-depth sensor, maintained O(1) here instead
        # of scanned O(store) per flush
        self._retrying: Dict[str, None] = {}
        # traces submitted by batched flushes and segment pairs forwarded
        # (the worker's summary)
        self.reports = 0
        self.forwarded = 0

    def offer_delay(self) -> float:
        """The governor's current per-offer block (the worker's offer
        loop sleeps this before accepting the next message)."""
        return self.governor.offer_delay()

    def _submit_safe(self, body) -> Optional[dict]:
        if isinstance(body, TraceView):
            body = body.to_request()  # per-trace HTTP path wants JSON
        try:
            return self.submit(body)
        except Exception as e:
            logger.error("Match submit failed for %s: %s",
                         body.get("uuid"), e)
            return None

    def _forward_all(self, response: Optional[dict]) -> int:
        n = 0
        for key, seg in segments_from_response(response):
            self.forward(key, seg)
            n += 1
        self.forwarded += n
        return n

    def process(self, uuid: str, point: Point, stream_time_ms: int) -> None:
        batch = self.store.pop(uuid, None)
        if batch is None:
            batch = Batch(point)
        else:
            batch.update(point)
            if batch.should_report(REPORT_DIST, REPORT_COUNT, REPORT_TIME):
                if self.governor.should_shed():
                    # backpressure past the shed threshold: the matcher
                    # cannot keep up, so a report-ready session dead-
                    # letters its trace JSON NOW (replayable, bounded
                    # by the spool cap) instead of joining a pending
                    # set that can only grow while submits fail
                    metrics.count("backpressure.shed")
                    self._retrying.pop(uuid, None)
                    self._deadletter(uuid, batch)
                    batch.drop()
                    batch.retries = 0
                    return
                # defer to the next batched flush instead of matching
                # this one session at batch=1 (the reference's only mode)
                self.pending[uuid] = None
        if batch.points:
            batch.last_update = stream_time_ms
            self.store[uuid] = batch
        if len(self.pending) >= self.report_flush:
            self.flush_pending()

    def _flush_due(self, due) -> None:
        """ONE batched submit for (uuid, batch) pairs -> forward the
        resulting segment pairs; bodies go columnar (TraceBatch), so the
        in-process service path never builds a point dict.

        Failure domain: a failed round trip (a whole-submit exception or
        a per-trace None) requeues the batch under the retry budget and
        then dead-letters it — an infrastructure hiccup must neither
        kill the stream thread nor silently lose the trace."""
        if not due:
            return
        t_flush = time.perf_counter()
        self.reports += len(due)
        with obs_trace.span("batcher.flush", sessions=len(due)):
            tb = TraceBatch.concat([
                batch.request_columns(uuid, self.options)
                for uuid, batch in due])
            t0 = time.monotonic()
            try:
                faults.failpoint("matcher.submit")
                responses = self.submit_many(tb)
            except Exception as e:
                logger.error("batched submit failed for %d traces: %s",
                             len(due), e)
                responses = [None] * len(due)
            elapsed = time.monotonic() - t0
            failures = 0
            for (uuid, batch), response in zip(due, responses):
                if response is None:
                    failures += 1
                    self._submit_failed(uuid, batch)
                    continue
                batch.retries = 0
                self._retrying.pop(uuid, None)
                self._forward_all(batch.apply_response(uuid, response))
            # feed the backpressure sensors AFTER the retry bookkeeping
            # so the requeue depth reflects this flush's outcome
            self.governor.note_flush(len(due), elapsed, failures,
                                     len(self._retrying))
        metrics.observe("batcher.flush", time.perf_counter() - t_flush)

    def _submit_failed(self, uuid: str, batch: Batch) -> None:
        """One failed round trip: requeue a live batch under the budget,
        dead-letter it (and evicted batches, which have no next flush to
        ride) once the budget is spent."""
        if self.store.get(uuid) is batch \
                and batch.retries < self.retry_budget:
            batch.retries += 1
            self.pending[uuid] = None
            self._retrying[uuid] = None
            metrics.count("batch.requeued")
            logger.warning("submit failed for %s; requeued (%d/%d)",
                           uuid, batch.retries, self.retry_budget)
            return
        metrics.count("batch.dropped")
        self._retrying.pop(uuid, None)
        self._deadletter(uuid, batch)
        batch.drop()
        # the budget is per report attempt: a session that re-qualifies
        # after this drop gets a fresh budget, not a permanent ban
        batch.retries = 0

    def _deadletter(self, uuid: str, batch: Batch) -> None:
        """Spool the batch's request JSON for replay; best-effort — the
        spool failing must not take the stream down with it."""
        if self.deadletter_dir is None or not batch.points:
            logger.error("Dropping batch for %s after %d failed submits "
                         "(%d points, no dead-letter spool)",
                         uuid, batch.retries + 1, len(batch.points))
            return
        body = batch.request_body(uuid, self.mode, self.report_on,
                                  self.transition_on)
        self._deadletter_seq += 1
        # pid-qualified: the sequence restarts with the process, and a
        # colliding name would os.replace an earlier spooled trace away
        name = f"trace-{os.getpid()}-{self._deadletter_seq:06d}" \
               f".{uuid}.json"
        try:
            # shared spool layer: atomic commit (these bodies replay
            # through the drainer / replay_cli) + the byte cap with
            # oldest-first shedding (the ``deadletter_max_mb`` key)
            path = spool.write(self.deadletter_dir, name,
                               json.dumps(body, separators=(",", ":")))
            metrics.count("batch.deadletter")
            logger.warning("Dead-lettered trace for %s -> %s", uuid, path)
            # a dead-lettered trace means the matcher stayed down past
            # the retry budget — postmortem what was in flight
            flightrec.dump("deadletter.trace", {"uuid": uuid})
        except Exception as e:
            logger.error("Trace dead-letter spool failed for %s: %s",
                         uuid, e)

    def flush_pending(self) -> None:
        """Flush every session that crossed the report thresholds since
        the last flush through ONE device batch. Sessions evicted or
        trimmed in the meantime re-qualify on their next point."""
        if not self.pending:
            return
        due = []
        for uuid in self.pending:
            batch = self.store.get(uuid)
            if batch is not None and batch.should_report(
                    REPORT_DIST, REPORT_COUNT, REPORT_TIME):
                due.append((uuid, batch))
        self.pending.clear()
        self._flush_due(due)

    def punctuate(self, stream_time_ms: int) -> None:
        """Evict batches idle past the session gap, reporting what we can
        with relaxed thresholds (reference: BatchingProcessor.java:87-106).

        Evicted uuids AND pending mid-stream reports flush through ONE
        ``submit_many`` call, so a punctuate cycle over N sessions
        decodes as one padded device batch of N, not N batches of 1 (the
        reference can only do one C++ call per trace, Batch.java:66-68).
        """
        due = []
        evicted = []
        for uuid in list(self.store):
            batch = self.store[uuid]
            if stream_time_ms - batch.last_update > self.session_gap_ms:
                del self.store[uuid]
                self.pending.pop(uuid, None)
                # an evicted session leaves the requeue-depth sensor
                # (its dead-letter path re-accounts it if the final
                # report fails too)
                self._retrying.pop(uuid, None)
                evicted.append(uuid)
                if batch.should_report(0, 2, 0):
                    due.append((uuid, batch))
        for uuid in self.pending:  # still live, thresholds crossed
            batch = self.store.get(uuid)
            if batch is not None and batch.should_report(
                    REPORT_DIST, REPORT_COUNT, REPORT_TIME):
                due.append((uuid, batch))
        self.pending.clear()
        self._flush_due(due)
        if self.on_evict is not None:
            # after the flush: the session's FINAL report still rides
            # its carried incremental state; only then is it dropped
            for uuid in evicted:
                try:
                    self.on_evict(uuid)
                except Exception as e:
                    logger.error("on_evict failed for %s: %s", uuid, e)
