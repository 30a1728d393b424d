"""Request tracing: trace_id/span_id contexts and trace-event export.

A span is one timed stage of one request's life: the service opens a
root span per ``/report`` request, and every ``metrics.timer`` site
(dispatch, prep, decode, assemble, report serialisation) nests a child
span under it, so the stage timers are the span tree. Spans propagate
through a contextvar; thread hops (the dispatcher queue, the matcher's
device lanes) carry the context explicitly with :func:`current` and
:func:`attach`, because a queue handoff does not copy contexts.

Disarmed, every span site pays one module-flag load: :func:`span`
returns a shared no-op and :func:`current` returns None without touching
the contextvar. Arming is persistent (:func:`configure`, the service
config's ``trace`` key) or per request (:func:`force_begin` /
:func:`force_end`, the ``?trace=1`` flag: it arms the whole process for
the request's lifetime, so spans on worker threads record too, and the
exporter filters by trace id).

The dispatcher serves many requests with one batch, and a span has one
parent: the batch's span tree parents to one request. For every other
request whose tree was asked for (:func:`watch`), :func:`link` records
that the batch served it too, and :func:`export_trace` copies the linked
subtree into that request's tree.

Closed spans land in :mod:`flightrec`'s bounded ring, and
:func:`export_trace` renders one trace's spans as Chrome/Perfetto
trace-event JSON (``ph:"X"`` complete events on epoch microseconds, the
host's wall clock; nothing lines these up with a ``torch.profiler``
trace).

The profiler mirror (``configure(True, profiler=True)``) is what puts
spans on the device trace's clock: every span then also opens a
``torch.profiler.record_function`` range named
:data:`PROFILER_PREFIX` + its name, so a running profile records each
span beside the kernels and copies, on the profiler's own clock (torch's
CPU profile records the ranges of the thread that started it). The
range opens when the span is entered and ends when it is detached from
the entering thread, so it ends on the thread that opened it: a
:func:`hold` span's range covers its block, while its flight-recorder
record ends at ``close()``. :func:`phase_spans` records are made after
the fact and have no range.
"""
from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..utils import locks as _locks
from . import flightrec

_ENABLED = False   # the one flag every disarmed span site loads
_ARMED = False     # persistent arming (configure)
_FORCED = 0        # ?trace=1 requests in flight
_lock = _locks.new_lock("trace.arm")
#: trace ids whose tree a caller will export (watch/unwatch)
_watched: set = set()

#: (trace_id, span_id) of the innermost open span in this context
_ctx: "contextvars.ContextVar[Optional[Tuple[str, int]]]" = \
    contextvars.ContextVar("reporter_tpu_torch_trace", default=None)

#: process-unique span ids (itertools.count is atomic under the GIL)
_ids = itertools.count(1)

#: maps perf_counter_ns onto epoch ns, so span timestamps compare across
#: processes
_EPOCH_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


def _recompute_locked() -> None:
    global _ENABLED
    _ENABLED = _ARMED or _FORCED > 0


def configure(on: bool, profiler: bool = False) -> None:
    """Persistently arm or disarm tracing; ``profiler`` (with ``on``)
    mirrors every span into the ``torch.profiler`` timeline."""
    global _ARMED, _SPAN, _record_function
    span_cls, rf = _Span, None
    if on and profiler:
        from torch.profiler import record_function as rf
        span_cls = _MirroredSpan
    with _lock:
        _ARMED = bool(on)
        _SPAN, _record_function = span_cls, rf or _record_function
        _recompute_locked()


def force_begin() -> None:
    """Arm tracing for one in-flight request (``?trace=1``)."""
    global _FORCED
    with _lock:
        _FORCED += 1
        _recompute_locked()


def force_end() -> None:
    global _FORCED
    with _lock:
        _FORCED = max(0, _FORCED - 1)
        _recompute_locked()


def enabled() -> bool:
    return _ENABLED


class _Noop:
    """Shared do-nothing span/attach: the disarmed path allocates
    nothing."""

    __slots__ = ()
    trace_id = None
    span_id = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self) -> None:
        pass


_NOOP = _Noop()


def new_trace_id() -> str:
    """Process-qualified trace id (the pid keeps ids unique across the
    pre-fork workers without coordination)."""
    return f"{os.getpid():x}-{next(_ids):012x}"


class _Span:
    __slots__ = ("name", "attrs", "trace_id", "span_id", "parent_id",
                 "_token", "_t0", "dur_ns", "_closed")

    def __init__(self, name: str, attrs: Optional[dict]):
        self.name = name
        self.attrs = attrs
        self.dur_ns = 0
        self._token = None
        self._closed = False

    def __enter__(self):
        cur = _ctx.get()
        if cur is None:
            self.trace_id = new_trace_id()
            self.parent_id = 0
        else:
            self.trace_id, self.parent_id = cur
        self.span_id = next(_ids)
        self._token = _ctx.set((self.trace_id, self.span_id))
        self._t0 = time.perf_counter_ns()
        flightrec.span_opened(self.span_id, {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "t0_ns": self._t0 + _EPOCH_OFFSET_NS,
            "tid": threading.get_ident(),
            **({"attrs": self.attrs} if self.attrs else {})})
        return self

    def detach(self) -> None:
        """Leave this span's context on the entering thread; the span
        stays open until :meth:`close`."""
        if self._token is not None:
            _ctx.reset(self._token)
            self._token = None

    def close(self) -> None:
        """End the span (once; later calls do nothing). Any thread may
        close a span it was handed."""
        if self._closed:
            return
        self._closed = True
        self.dur_ns = time.perf_counter_ns() - self._t0
        flightrec.span_closed(self.span_id, self.dur_ns)

    def __exit__(self, *exc):
        self.detach()
        self.close()
        return False


#: the name prefix of a span's ``torch.profiler`` range
PROFILER_PREFIX = "reporter_tpu_torch.span:"


class _MirroredSpan(_Span):
    """A span that also holds a ``record_function`` range from entry to
    detach, on the entering thread (``configure(profiler=True)``)."""

    __slots__ = ("_range",)

    def __init__(self, name: str, attrs: Optional[dict]):
        super().__init__(name, attrs)
        self._range = None

    def __enter__(self):
        super().__enter__()
        self._range = _record_function(PROFILER_PREFIX + self.name)
        self._range.__enter__()
        return self

    def detach(self) -> None:
        super().detach()
        rng, self._range = self._range, None
        if rng is not None:
            rng.__exit__(None, None, None)


#: the armed span's class (:class:`_MirroredSpan` under the mirror) and
#: torch's ``record_function``, both set by :func:`configure`
_SPAN = _Span
_record_function = None


def span(name: str, **attrs):
    """A timed span context. Disarmed: one flag check, a shared no-op."""
    if not _ENABLED:
        return _NOOP
    return _SPAN(name, attrs or None)


class _Hold:
    __slots__ = ("sp",)

    def __init__(self, sp: _Span):
        self.sp = sp

    def __enter__(self):
        return self.sp.__enter__()

    def __exit__(self, exc_type, *exc):
        self.sp.detach()
        if exc_type is not None:
            self.sp.close()
        return False


def hold(sp):
    """Enter ``sp`` for a block and keep it open past the block: spans
    opened in the block, and contexts captured there for thread hops,
    parent to it; whoever finishes its work calls ``sp.close()`` (an
    exception in the block closes it at once). The no-op passes
    through."""
    if sp is _NOOP:
        return _NOOP
    return _Hold(sp)


def current() -> Optional[Tuple[str, int]]:
    """The (trace_id, span_id) context to carry across a thread hop;
    None when disarmed or outside any span."""
    if not _ENABLED:
        return None
    return _ctx.get()


class _Attach:
    __slots__ = ("ctx", "_token")

    def __init__(self, ctx: Tuple[str, int]):
        self.ctx = ctx

    def __enter__(self):
        self._token = _ctx.set(self.ctx)
        return self

    def __exit__(self, *exc):
        _ctx.reset(self._token)
        return False


def attach(ctx: Optional[Tuple[str, int]]):
    """Adopt a context captured by :func:`current` on another thread."""
    if ctx is None:
        return _NOOP
    return _Attach(ctx)


def phase_spans(names: Sequence[str], ns_list: Sequence[int]) -> None:
    """Synthesize back-to-back child spans of the current span, ending
    now, from phase durations measured inside an opaque call (the native
    prep's ``phase_ns``: ``prep.candidates``/``select``/``routes``). The
    native phases are summed over its worker threads; where that sum
    exceeds the time the enclosing span has been open, the phases are
    scaled to fit inside it, and each keeps its summed nanoseconds in
    ``attrs["thread_ns"]``. Flagged ``synthetic`` in the attrs."""
    if not _ENABLED:
        return
    cur = _ctx.get()
    if cur is None:
        return
    pairs = [(n, int(ns)) for n, ns in zip(names, ns_list) if ns > 0]
    if not pairs:
        return
    trace_id, parent_id = cur
    tid = threading.get_ident()
    end_ns = time.perf_counter_ns() + _EPOCH_OFFSET_NS
    total = sum(ns for _, ns in pairs)
    parent = flightrec.open_record(parent_id)
    room = end_ns - parent["t0_ns"] if parent is not None else total
    scale = min(1.0, room / total) if total else 1.0
    durs = [int(ns * scale) for _, ns in pairs]
    offsets = list(itertools.accumulate(durs))
    base_ns = end_ns - offsets[-1]
    flightrec.record_closed([
        {"name": name, "trace_id": trace_id, "span_id": next(_ids),
         "parent_id": parent_id, "t0_ns": base_ns + off - dur,
         "dur_ns": dur, "tid": tid,
         "attrs": {"synthetic": True,
                   **({"thread_ns": ns} if dur != ns else {})}}
        for (name, ns), dur, off in zip(pairs, durs, offsets)])


# ---- links across requests --------------------------------------------------

def watch(root) -> None:
    """Mark the trace ``root`` belongs to as one whose tree will be
    exported: batches that serve it link their subtree into it."""
    if getattr(root, "trace_id", None) is not None:
        with _lock:
            _watched.add(root.trace_id)


def unwatch(root) -> None:
    if getattr(root, "trace_id", None) is not None:
        with _lock:
            _watched.discard(root.trace_id)


def watched(ctx: Optional[Tuple[str, int]]) -> bool:
    """Is ``ctx`` a context of a watched trace?"""
    return ctx is not None and ctx[0] in _watched


def link(ctx: Optional[Tuple[str, int]], sp) -> None:
    """Record that ``sp`` (open under another trace) also serves the
    watched request whose context is ``ctx``: :func:`export_trace` of
    that request copies ``sp``'s subtree under ``ctx``'s span."""
    if ctx is None or sp.trace_id is None or ctx[0] == sp.trace_id \
            or not watched(ctx):
        return
    flightrec.record_closed([{
        "name": "link", "trace_id": ctx[0], "span_id": next(_ids),
        "parent_id": ctx[1], "t0_ns": time.time_ns(), "dur_ns": 0,
        "tid": threading.get_ident(),
        "link": [sp.trace_id, sp.span_id]}])


# ---- export ----------------------------------------------------------------

def events_for(trace_id: str) -> List[dict]:
    """Closed span records for one trace, oldest first, from the ring."""
    return [r for r in flightrec.events() if r["trace_id"] == trace_id]


def _expand_links(records: List[dict], trace_id: str) -> List[dict]:
    """``records`` with each link replaced by a copy of the linked
    subtree, re-stamped with ``trace_id`` and parented to the link's
    parent span."""
    out = [r for r in records if "link" not in r]
    links = [r for r in records if "link" in r]
    if not links:
        return out
    ring = flightrec.events()
    for lk in links:
        other, root_id = lk["link"]
        theirs = [r for r in ring if r["trace_id"] == other]
        keep = {root_id}
        changed = True   # to a fixed point: a deferred close reorders
        while changed:
            changed = False
            for r in theirs:
                if r["parent_id"] in keep and r["span_id"] not in keep:
                    keep.add(r["span_id"])
                    changed = True
        for r in theirs:
            if r["span_id"] not in keep:
                continue
            parent = lk["parent_id"] if r["span_id"] == root_id \
                else r["parent_id"]
            # lint: ignore[HP002] — the ?trace=1 export of one request
            attrs = {**r.get("attrs", {}), "linked_from": other}
            # lint: ignore[HP002] — the ?trace=1 export of one request
            out.append({**r, "trace_id": trace_id, "parent_id": parent,
                        "attrs": attrs})
    return out


def to_trace_events(records: Iterable[dict],
                    in_flight: Iterable[dict] = ()) -> Dict[str, object]:
    """Chrome/Perfetto trace-event JSON: closed spans as ``ph:"X"``
    events (epoch-µs timestamps, µs durations), open spans as ``ph:"B"``
    begin events; load it in ``chrome://tracing`` or
    https://ui.perfetto.dev."""
    pid = os.getpid()
    events = [
        {"name": r["name"], "ph": "X", "cat": "reporter_tpu",
         "pid": r.get("pid", pid), "tid": r["tid"],
         "ts": r["t0_ns"] / 1e3, "dur": r["dur_ns"] / 1e3,
         "args": {"trace_id": r["trace_id"], "span_id": r["span_id"],
                  "parent_id": r["parent_id"], **r.get("attrs", {})}}
        for r in records]
    events += [
        {"name": r["name"], "ph": "B", "cat": "reporter_tpu",
         "pid": r.get("pid", pid), "tid": r["tid"],
         "ts": r["t0_ns"] / 1e3,
         "args": {"trace_id": r["trace_id"], "span_id": r["span_id"],
                  "parent_id": r["parent_id"], "in_flight": True,
                  **r.get("attrs", {})}}
        for r in in_flight]
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_trace(root) -> Dict[str, object]:
    """The trace-event JSON for the trace ``root`` belongs to (the
    ``?trace=1`` payload), linked subtrees included; empty when the span
    never armed."""
    if root is None or getattr(root, "trace_id", None) is None:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    return to_trace_events(_expand_links(events_for(root.trace_id),
                                         root.trace_id))
