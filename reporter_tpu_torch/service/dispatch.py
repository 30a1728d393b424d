"""Micro-batching dispatcher: many concurrent requests -> one device batch.

Request threads enqueue traces and block; a single dispatch loop drains
the queue into a batch (flushing on ``max_batch``, on ``max_wait_ms``
since the first pending trace, or once the queue has stayed empty for
``idle_grace_ms``), runs the batched matcher, and wakes each requester
with its own result. The card wants large batches; the handler threads
each hold one request.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional, Sequence

from ..core.tracebatch import TraceBatch
from ..obs import profiler
from ..obs import trace as obs_trace
from ..utils import locks as _locks
from ..utils import metrics
from .admission import Overload, retry_after_s

#: dispatcher queue bound in traces (0 = unbounded): an unbounded queue
#: under overload is latency debt every later request pays — better to
#: say no at the door
DEFAULT_QUEUE_MAX = 4096
#: what happens when the bounded queue is full: "reject" sheds the NEW
#: submit (Overload -> HTTP 429 upstream), "oldest" sheds the oldest
#: queued slot to make room (its waiter gets the Overload — freshest
#: work wins). Both are counted; nothing is ever dropped silently.
QUEUE_POLICIES = ("reject", "oldest")
#: EWMA smoothing for the per-trace service-time model
_EWMA_ALPHA = 0.2

#: queue sentinel close() enqueues AFTER the closed flag flips: every
#: real slot precedes it, so the loop drains all in-flight work, then
#: exits — shutdown is a drain, not an abandonment
_STOP = object()

class _Slot:
    __slots__ = ("trace", "columns", "event", "result", "error", "ctx")

    def __init__(self, trace, columns: Optional[tuple] = None):
        self.trace = trace
        # (uuid, lat, lon, time, accuracy, options) column arrays, built
        # by the submitting request thread (so columnarisation fans out
        # across the handler pool); None for callers that submit plain
        # dicts — a whole batch of columnar slots reaches the matcher as
        # ONE TraceBatch with zero per-point Python in the dispatch loop
        self.columns = columns
        self.event = threading.Event()
        self.result: Optional[dict] = None
        self.error: Optional[Exception] = None
        # the submitter's trace context (None when tracing is disarmed):
        # the batch's spans parent to one submitter's
        self.ctx = obs_trace.current()


class BatchDispatcher:
    """Accumulates traces and runs ``match_many`` over the accumulated batch.

    ``match_many``: callable taking a list of trace dicts (or a
    :class:`TraceBatch`) and returning a list of match results (dicts, or
    the matcher's lazy ``MatchRuns`` views — e.g.
    ``SegmentMatcher.match_many``).

    ``queue_max`` bounds the queue in traces (0: unbounded);
    ``queue_policy`` is "reject" or "oldest" (see ``QUEUE_POLICIES``);
    ``latency_budget_ms`` > 0 caps each batch at the traces the EWMA
    per-trace service time says fit the budget (0: fixed
    ``max_batch``/``max_wait_ms`` flushing).
    """

    def __init__(self, match_many: Callable[[Sequence[dict]], List[dict]],
                 max_batch: int = 256, max_wait_ms: float = 20.0,
                 idle_grace_ms: float = 2.0,
                 queue_max: int = DEFAULT_QUEUE_MAX,
                 queue_policy: str = "reject",
                 latency_budget_ms: float = 0.0):
        if queue_policy not in QUEUE_POLICIES:
            raise ValueError(f"queue_policy must be one of {QUEUE_POLICIES}, "
                             f"not {queue_policy!r}")
        self._match_many = match_many
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        # flush early once the queue has stayed empty this long: callers
        # that were going to batch enqueue within a moment of each other,
        # so an idle queue means waiting out the full max_wait would add
        # latency without adding batch — max_wait stays the hard bound
        # for a steady trickle of arrivals
        self.idle_grace = min(idle_grace_ms / 1000.0, self.max_wait)
        self._batches = 0
        self.queue_max = queue_max
        self.queue_policy = queue_policy
        self._queue: "queue.Queue[_Slot]" = queue.Queue(
            maxsize=max(0, queue_max))
        # latency-targeted micro-batching: an EWMA of per-trace service
        # time turns the flush decision into "how many traces fit the
        # budget" — batch size shrinks under load (service time inflates)
        # and grows back when idle
        self.latency_budget = latency_budget_ms / 1000.0
        # written only by the dispatch loop thread; read cross-thread
        # for the Retry-After estimate (a torn read of a float cannot
        # happen in CPython, and the reader only wants an estimate)
        self._ewma_per_trace: Optional[float] = None
        # traces in the batch currently being matched: queue_depth()
        # includes them — a drained-but-in-service batch is wait a new
        # arrival pays just like queued slots
        self._in_service = 0
        self._closed = False
        self._stopping = False  # loop consumed the _STOP sentinel
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="match-dispatch")
        self._thread.start()

    # ---- load sensors ----------------------------------------------------
    def queue_depth(self) -> int:
        """Live backlog in traces — queued slots PLUS the batch in
        service (both are wait a new arrival pays before its own batch
        dispatches)."""
        return self._queue.qsize() + self._in_service

    def queued_depth(self) -> int:
        """Queued slots only — what ``queue_max`` bounds. The batch in
        service does not count against it (a max_batch larger than the
        bound would otherwise read as permanently full)."""
        return self._queue.qsize()

    def service_ewma_s(self) -> Optional[float]:
        """EWMA per-trace service time (None before the first batch)."""
        return self._ewma_per_trace

    def _effective_cap(self) -> int:
        """Traces the latency budget allows per batch: min(max_batch,
        budget / per-trace EWMA), floored at 1 so the dispatcher always
        makes progress even when one trace alone busts the budget."""
        if self.latency_budget <= 0.0 or not self._ewma_per_trace:
            return self.max_batch
        return max(1, min(self.max_batch,
                          int(self.latency_budget
                              / self._ewma_per_trace)))

    # ---- request side ----------------------------------------------------
    def submit(self, trace: dict, timeout: float = 60.0,
               columns: Optional[tuple] = None) -> dict:
        """Block until the trace's match result is ready. ``columns`` is
        the trace's pre-built (uuid, lat, lon, time, accuracy, options)
        column tuple when the caller already columnarised the wire."""
        if self._closed:
            raise RuntimeError("dispatcher is closed")
        slot = _Slot(trace, columns)
        _locks.fuzz_point("dispatch.queue.put")
        self._enqueue_nowait(slot)
        if not slot.event.wait(timeout):
            raise TimeoutError("match result not ready in time")
        if slot.error is not None:
            raise slot.error
        return slot.result  # type: ignore[return-value]

    def submit_many(self, traces: Sequence[dict], timeout: float = 60.0,
                    return_exceptions: bool = False) -> List[dict]:
        """Enqueue a whole list, then wait: the dispatch loop drains them
        into ONE device batch (up to max_batch; a longer list spans
        several batches back-to-back).

        ``timeout`` is per device batch; the aggregate deadline scales
        with how many batches the list needs, so a huge flush cannot time
        out merely for being large. With ``return_exceptions`` failures
        come back in-place (the exception object in that trace's slot)
        instead of raising — a one-batch failure then costs only that
        batch's traces, not the whole list.
        """
        if self._closed:
            raise RuntimeError("dispatcher is closed")
        if isinstance(traces, TraceBatch):
            acc = traces.accuracy
            off = traces.offsets
            slots = [
                _Slot(traces[i], (traces.uuid(i), *traces.trace_columns(i),
                                  acc[off[i]:off[i + 1]]
                                  if acc is not None else None,
                                  traces.option(i)))
                for i in range(len(traces))]
        else:
            slots = [_Slot(tr) for tr in traces]
        for slot in slots:  # enqueue ALL before waiting on any
            _locks.fuzz_point("dispatch.queue.put")
            self._enqueue_blocking(slot, timeout)
        # deadline scales with the batches the list will ACTUALLY need:
        # under a latency budget the drain loop flushes at the EWMA-
        # shrunk cap, not max_batch
        n_batches = max(1, -(-len(slots) // self._effective_cap()))
        deadline = time.monotonic() + timeout * n_batches
        results: List = []
        for slot in slots:
            if not slot.event.wait(max(0.0, deadline - time.monotonic())):
                err: Exception = TimeoutError(
                    "match result not ready in time")
                if not return_exceptions:
                    raise err
                results.append(err)
                continue
            if slot.error is not None:
                if not return_exceptions:
                    raise slot.error
                results.append(slot.error)
                continue
            results.append(slot.result)
        return results

    # ---- bounded enqueue -------------------------------------------------
    def _overload(self) -> Overload:
        return Overload("queue", retry_after_s(self._queue.qsize(),
                                               self._ewma_per_trace))

    def _enqueue_nowait(self, slot: _Slot) -> None:
        """The request-path enqueue: a full bounded queue sheds — the
        NEW slot under the "reject" policy, the OLDEST queued slot
        under "oldest" (freshest work wins; the displaced waiter gets
        the Overload). Every shed is counted; nothing silent."""
        while True:
            try:
                self._queue.put_nowait(slot)
                return
            except queue.Full:
                pass
            if self.queue_policy != "oldest":
                metrics.count("dispatch.queue.rejected")
                raise self._overload()
            try:
                old = self._queue.get_nowait()
            except queue.Empty:
                continue  # the loop drained it first — retry the put
            if old is _STOP:
                # close() raced us: restore the sentinel, refuse ours
                self._queue.put(old)
                metrics.count("dispatch.queue.rejected")
                raise self._overload()
            old.error = self._overload()
            old.event.set()
            metrics.count("dispatch.queue.evicted")

    def _enqueue_blocking(self, slot: _Slot, timeout: float) -> None:
        """The batch-caller enqueue: a full queue BLOCKS (bounded by
        ``timeout``) — the queue bound propagates to the producer as
        backpressure instead of shedding its flush. A wait that times
        out raises Overload."""
        try:
            self._queue.put_nowait(slot)
            return
        except queue.Full:
            metrics.count("dispatch.queue.waits")
        try:
            self._queue.put(slot, timeout=timeout)
        except queue.Full:
            metrics.count("dispatch.queue.rejected")
            raise self._overload() from None

    # ---- dispatch loop ---------------------------------------------------
    def _drain_batch(self) -> List[_Slot]:
        """Block for the first trace, then collect until a flush
        condition: the effective batch cap reached (``max_batch``, or
        fewer when the latency budget's EWMA model says a full batch
        would bust it), ``max_wait`` elapsed since the first trace, the
        queue stayed empty for ``idle_grace``, or the close() sentinel
        surfaced (every slot before it still flushes). Runs on the
        dispatch thread only."""
        _locks.fuzz_point("dispatch.queue.get")
        first = self._queue.get()
        if first is _STOP:
            self._stopping = True
            return []
        slots = [first]
        cap = self._effective_cap()
        if cap < self.max_batch:
            metrics.count("batch.latency.capped_batches")
        t0 = time.monotonic()
        while len(slots) < cap:
            remaining = self.max_wait - (time.monotonic() - t0)
            if remaining <= 0:
                break
            try:
                _locks.fuzz_point("dispatch.queue.get")
                got = self._queue.get(
                    timeout=min(remaining, self.idle_grace))
            except queue.Empty:
                break  # idle past the grace window — flush what we have
            if got is _STOP:
                self._stopping = True
                break
            slots.append(got)
        return slots

    def _loop(self):
        while not self._stopping:
            slots = self._drain_batch()
            if not slots:
                continue  # woke on the close() sentinel alone
            self._batches += 1
            metrics.count("dispatch.batches")
            metrics.count("dispatch.traces", len(slots))
            # the backlog left behind: the queue depth at dispatch that
            # the profiler stamps into its wide events
            profiler.note_queue_depth(self._queue.qsize())
            # the batch's spans parent to one submitter: a request whose
            # tree will be exported when there is one; every other such
            # request gets a link to the batch's subtree
            ctxs = [s.ctx for s in slots if s.ctx is not None]
            ctx = next((c for c in ctxs if obs_trace.watched(c)),
                       ctxs[0] if ctxs else None)
            self._in_service = len(slots)
            try:
                with obs_trace.attach(ctx), \
                        obs_trace.span("dispatch.batch",
                                       batch=self._batches,
                                       traces=len(slots)) as bspan:
                    for c in {c[0]: c for c in ctxs}.values():
                        obs_trace.link(c, bspan)
                    # a batch of columnar slots concatenates into ONE
                    # TraceBatch (flat arrays, no per-point Python); plain
                    # dict submissions go as the request dicts
                    if all(s.columns is not None for s in slots):
                        batch = TraceBatch.concat(
                            [s.columns for s in slots])
                    else:
                        batch = [s.trace for s in slots]
                    t_match = time.monotonic()
                    with metrics.timer("dispatch.match_many"):
                        results = self._match_many(batch)
                    self._note_service_time(
                        time.monotonic() - t_match, len(slots))
                    for slot, res in zip(slots, results):
                        slot.result = res
            except Exception as e:  # propagate to every waiter in the batch
                metrics.count("dispatch.errors")
                for slot in slots:
                    slot.error = e
            finally:
                self._in_service = 0
                for slot in slots:
                    slot.event.set()

    def _note_service_time(self, elapsed_s: float, n: int) -> None:
        """Feed one batch's wall into the per-trace EWMA service-time
        model (dispatch-loop thread only). The EWMA drives both the
        latency-budget flush cap and the Retry-After estimate."""
        if n <= 0:
            return
        per_trace = elapsed_s / n
        prev = self._ewma_per_trace
        self._ewma_per_trace = per_trace if prev is None else \
            (1.0 - _EWMA_ALPHA) * prev + _EWMA_ALPHA * per_trace
        metrics.observe("batch.latency.per_trace", per_trace)
        if self.latency_budget > 0.0 and elapsed_s > self.latency_budget:
            metrics.count("batch.latency.over_budget")

    def close(self, timeout: float = 30.0) -> bool:
        """Shut down by DRAINING, not abandoning: refuse new submits,
        let the loop flush every slot already enqueued (waiters wake
        with real results), then join the dispatch thread — no dispatch
        thread may outlive the matcher handles its batches touch. Any
        slot that raced past the closed check after the sentinel is
        woken with an error rather than left to hit its wait timeout.
        Idempotent; returns True when the loop thread fully stopped."""
        if not self._closed:
            self._closed = True
            self._queue.put(_STOP)
        self._thread.join(timeout)
        stopped = not self._thread.is_alive()
        if stopped:
            while True:
                try:
                    slot = self._queue.get_nowait()
                except queue.Empty:
                    break
                if slot is _STOP:
                    continue
                slot.error = RuntimeError("dispatcher is closed")
                slot.event.set()
        return stopped
