"""Admission control and the graceful-degradation ladder.

The port of ``reporter_tpu/service/admission.py``, with its decisions,
counters and snapshots. It is armed by the service's ``admission``
config key (``ReporterService(admission=True)``), never from the
environment, and off by default.

- :class:`AdmissionGate`, the front door. Before a ``/report`` request's
  body is read, the gate reads three live sensors and sheds with HTTP 429
  and a computed ``Retry-After`` instead of queueing work that cannot
  meet its deadline:

  * ``queue``     the dispatcher backlog, as a hard bound (the bounded
                  queue is full) and as a deadline check: the predicted
                  queue wait (depth x the dispatcher's EWMA per-trace
                  service time) over ``DEADLINE_FRACTION`` of the
                  tightest SLO budget;
  * ``slo``       the windowed p99 of a budgeted stage over its
                  ``slo_ms`` target (:class:`WindowedQuantile`: bucket
                  deltas of the cumulative histograms, so the sensor
                  recovers when load drops);
  * ``inflight``  admitted-but-unanswered requests over ``inflight_max``.

  Every shed counts per reason (``admission.shed.{queue,slo,inflight}``).
  A gate failure (the ``admission.gate`` failpoint, a sensor exception)
  fails open: admit, and count ``admission.errors``.

- :class:`PressureLadder`. Under sustained pressure the service steps
  down one named rung at a time, with hysteresis (a condition holds for
  ``hold_s`` before the next step down; stepping back up needs twice
  that calm)::

      normal -> shed_shadow -> shed_trace -> coarse_buckets -> oracle_decode

  * ``shed_shadow``    the decode shadow's sampling suspended;
  * ``shed_trace``     ``?trace=1`` refused (the report still serves) and
                       the incremental path steps aside;
  * ``coarse_buckets`` the adaptive bucket splitter off;
  * ``oracle_decode``  reached and reported, but inert: in the JAX
                       package every chunk then decodes by the numpy
                       oracle on the host; the port keeps every decode on
                       its device (``pressure.oracle_chunks`` stays 0).

  Transitions are logged, counted (``pressure.transitions``,
  ``pressure.enter.<rung>``) and shown as ``/health``'s and
  ``/profile``'s ``pressure`` block.

The ladder is process-wide (one a process, like the profiler) and resets
in forked pre-fork workers (``utils.forksafe``). A request the bounded
dispatcher queue cannot take raises :class:`Overload` too.
"""
from __future__ import annotations

import logging
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..obs import slo
from ..utils import faults, metrics
from ..utils import forksafe as _forksafe
from ..utils import locks as _locks

logger = logging.getLogger("reporter_tpu_torch.admission")

#: fraction of the tightest SLO budget the predicted queue wait may take
#: before the gate sheds on the deadline check; the other half covers the
#: admitted request's own batch
DEADLINE_FRACTION = 0.5

#: Retry-After clamp: at least 1 s (sub-second retries re-arrive inside
#: the same overload), at most 30 s (a misestimated EWMA must not park
#: honest clients for minutes)
RETRY_AFTER_MIN_S = 1
RETRY_AFTER_MAX_S = 30

#: how often the gate refreshes its windowed-p99 sensor; between
#: refreshes admit() costs two integer reads and a few compares
EVAL_INTERVAL_S = 0.25

#: the ladder's default hold (the service's ``pressure_hold_s``)
DEFAULT_HOLD_S = 2.0


class Overload(RuntimeError):
    """A request shed by load management (the admission gate or the
    bounded dispatcher queue). ``reason`` is the counted shed family; the
    serving layer answers 429 with ``Retry-After: retry_after_s``."""

    def __init__(self, reason: str, retry_after_s: float):
        super().__init__(f"overloaded ({reason}); retry after "
                         f"{retry_after_s:.0f}s")
        self.reason = reason
        self.retry_after_s = retry_after_s


def retry_after_s(depth: int, ewma_s: Optional[float]) -> int:
    """The computed back-off a shed response carries: the expected time
    for the current backlog to drain (depth x per-trace EWMA), clamped.
    With no service-time estimate yet, the floor."""
    if not ewma_s or depth <= 0:
        return RETRY_AFTER_MIN_S
    return int(min(max(math.ceil(depth * ewma_s), RETRY_AFTER_MIN_S),
                   RETRY_AFTER_MAX_S))


# ---- windowed p99 ----------------------------------------------------------

class WindowedQuantile:
    """p99 over a sliding window of a cumulative stage histogram.

    The metrics timers never forget, so a lifetime p99 that breached once
    stays breached. This diffs the fixed log-bucket counts between
    evaluations: the diff is the window's histogram, and its p99 the
    window's p99. An idle window reports None: an idle stage is not a
    slow one.
    """

    def __init__(self, registry: Optional[metrics.Registry] = None):
        self._registry = registry if registry is not None \
            else metrics.default
        self._prev: Dict[str, Tuple[int, List[int]]] = {}

    def update(self, stages: List[str]) -> Dict[str, Optional[float]]:
        """One evaluation: {stage: windowed p99 seconds or None}."""
        _counters, timers = self._registry.export_state()
        out: Dict[str, Optional[float]] = {}
        for stage in stages:
            got = timers.get(stage)
            if got is None:
                out[stage] = None
                continue
            count, _total, max_s, buckets = got
            prev_count, prev_buckets = self._prev.get(stage, (0, None))
            self._prev[stage] = (count, buckets)
            window = count - prev_count
            if window <= 0:
                out[stage] = None
                continue
            if prev_buckets is None:
                diff = buckets
            else:
                diff = [b - p for b, p in zip(buckets, prev_buckets)]
            out[stage] = self._quantile(diff, window, 0.99, max_s)
        return out

    @staticmethod
    def _quantile(diff: List[int], total: int, q: float,
                  max_s: float) -> float:
        """Linear interpolation within the bucket, as the metrics timers'
        quantiles: the raw log2 bucket bound would read up to 2x high."""
        bounds = metrics.BUCKET_BOUNDS_S
        target = q * total
        cum = 0
        for idx, n in enumerate(diff):
            below = cum
            cum += n
            if cum >= target:
                lo = bounds[idx - 1] if 0 < idx <= len(bounds) else 0.0
                hi = bounds[idx] if idx < len(bounds) else max_s
                frac = (target - below) / n if n else 1.0
                return min(lo + frac * (hi - lo), max_s)
        return max_s


# ---- the degradation ladder ------------------------------------------------

#: the named rungs, mildest first; index == pressure level
RUNGS = ("normal", "shed_shadow", "shed_trace", "coarse_buckets",
         "oracle_decode")


class PressureLadder:
    """Sustained-pressure step-down with hysteresis.

    :meth:`observe` feeds one boolean pressure sample. A condition must
    hold for ``hold_s`` before the ladder steps down one rung, and calm
    for ``2 * hold_s`` before it steps back up; at most one rung moves per
    hold, so a spike cannot slam the service to the last rung and a lull
    cannot snap every feature back at once.
    """

    def __init__(self, hold_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.hold_s = hold_s if hold_s is not None else DEFAULT_HOLD_S
        self.clock = clock
        self._lock = _locks.new_lock("admission.ladder")
        self.level = 0
        now = clock()
        self._cond = False      # last observed pressure condition
        self._cond_t = now      # when that condition began
        self._trans_t = now     # last transition time
        self.transitions = 0

    def observe(self, pressured: bool) -> int:
        """Feed one pressure sample; returns the (possibly new) level.
        Transitions apply their rung effects outside the ladder lock."""
        new_level = None
        with self._lock:
            now = self.clock()
            if pressured != self._cond:
                self._cond = pressured
                self._cond_t = now
            dwell = now - self._cond_t
            since_trans = now - self._trans_t
            if pressured and self.level < len(RUNGS) - 1 \
                    and dwell >= self.hold_s \
                    and since_trans >= self.hold_s:
                self.level += 1
                self._trans_t = now
                self.transitions += 1
                new_level = self.level
            elif not pressured and self.level > 0 \
                    and dwell >= 2.0 * self.hold_s \
                    and since_trans >= 2.0 * self.hold_s:
                self.level -= 1
                self._trans_t = now
                self.transitions += 1
                new_level = self.level
            level = self.level
        if new_level is not None:
            _apply_level(new_level)
            metrics.count("pressure.transitions")
            metrics.count(f"pressure.enter.{RUNGS[new_level]}")
            logger.warning("pressure ladder -> %s (level %d/%d)",
                           RUNGS[new_level], new_level, len(RUNGS) - 1)
        return level

    def snapshot(self) -> dict:
        with self._lock:
            return {"level": self.level,
                    "state": RUNGS[self.level],
                    "rungs": list(RUNGS),
                    "transitions": self.transitions,
                    "hold_s": self.hold_s}


def _apply_level(level: int) -> None:
    """Push the rung effects into their owning modules (runs only on a
    transition). Each effect is a module flag the hot path reads with one
    global load; lazy imports keep this module free of matcher and
    profiler import cycles."""
    global _trace_shed
    from ..obs import profiler
    profiler.set_shadow_suspended(level >= 1)
    with _module_lock:
        _trace_shed = level >= 2
    from ..matcher import incremental
    incremental.set_pressure_shed(level >= 2)
    from ..matcher import batchpad
    batchpad.set_pressure_coarse(level >= 3)
    from ..matcher import matcher as matcher_mod
    matcher_mod.set_pressure_oracle(level >= 4)


# ---- process-wide ladder state ---------------------------------------------

_module_lock = _locks.new_lock("admission.module")
_ladder: Optional[PressureLadder] = None
_trace_shed = False


def ladder(hold_s: Optional[float] = None,
           clock: Callable[[], float] = time.monotonic) -> PressureLadder:
    """The process-wide ladder, made on first use: every gate of the
    process feeds it, and every consumer reads it."""
    global _ladder
    with _module_lock:
        if _ladder is None:
            _ladder = PressureLadder(hold_s=hold_s, clock=clock)
        return _ladder


def current_level() -> int:
    lad = _ladder
    return lad.level if lad is not None else 0


def allow_request_trace() -> bool:
    """Whether ``?trace=1`` is allowed now (the ``shed_trace`` rung
    refuses it)."""
    return not _trace_shed


def pressure_snapshot() -> dict:
    """``/health``'s and ``/profile``'s ``pressure`` block: the ladder's
    state, or the quiescent shape when no ladder was ever made."""
    lad = _ladder
    if lad is None:
        return {"level": 0, "state": RUNGS[0], "transitions": 0}
    return lad.snapshot()


def _reset_module() -> None:
    """Fork and test reset: a forked worker (or the next test) starts at
    pressure zero with every rung effect withdrawn. The effects are
    withdrawn only when a ladder existed: the hook runs on every fork of
    the process and must not import the matcher stack into a child that
    never armed admission."""
    global _ladder, _trace_shed
    with _module_lock:
        had = _ladder is not None
        _ladder = None
        _trace_shed = False
    if had:
        _apply_level(0)


_forksafe.register(_reset_module)


# ---- the admission gate ----------------------------------------------------

class AdmissionGate:
    """The ``/report`` front door: admit (and track in flight) or shed.

    ``dispatcher`` duck-types :class:`.dispatch.BatchDispatcher`
    (``queue_depth()``, ``queued_depth()``, ``service_ewma_s()``,
    ``queue_max``, ``max_batch``). ``inflight_max`` None or 0 means four
    full dispatcher batches. The gate is built per service (a pre-fork
    worker builds its own after the fork) and feeds the one process-wide
    ladder, made with ``hold_s``.
    """

    def __init__(self, dispatcher, inflight_max: Optional[int] = None,
                 hold_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[metrics.Registry] = None):
        self.dispatcher = dispatcher
        if not inflight_max or inflight_max <= 0:
            # four full batches of admitted work: the dispatcher stays fed
            # without the handler pool becoming an unbounded queue
            inflight_max = 4 * max(1, getattr(dispatcher, "max_batch", 64))
        self.inflight_max = inflight_max
        self.clock = clock
        self._lock = _locks.new_lock("admission.gate")
        self._inflight = 0
        self._window = WindowedQuantile(registry)
        self._last_eval = 0.0
        self._slo_breaches: List[str] = []
        self.ladder = ladder(hold_s=hold_s, clock=clock)
        self._shed_in_window = False

    # -- sensors ----------------------------------------------------------
    def _maybe_refresh(self, now: float) -> None:
        """Rate-limited sensor refresh: one thread per interval wins the
        locked check-and-set, recomputes the windowed p99s and feeds the
        ladder one pressure sample."""
        with self._lock:
            if now - self._last_eval < EVAL_INTERVAL_S:
                return
            self._last_eval = now
            shed_seen = self._shed_in_window
            self._shed_in_window = False
        targets = slo.thresholds()
        breaches: List[str] = []
        if targets:
            p99s = self._window.update(sorted(targets))
            breaches = [stage for stage, budget in targets.items()
                        if p99s.get(stage) is not None
                        and p99s[stage] > budget]
        self._slo_breaches = breaches
        self.ladder.observe(bool(breaches) or shed_seen)

    def _evaluate(self) -> Optional[Overload]:
        self._maybe_refresh(self.clock())
        depth = self.dispatcher.queue_depth()
        ewma = self.dispatcher.service_ewma_s()
        qmax = getattr(self.dispatcher, "queue_max", 0)
        # the hard bound watches queued work only: queue_depth() counts
        # the batch in service too, and a max_batch over the bound would
        # read as permanently full
        queued = getattr(self.dispatcher, "queued_depth",
                         self.dispatcher.queue_depth)()
        if qmax and queued >= qmax:
            return Overload("queue", retry_after_s(depth, ewma))
        targets = slo.thresholds()
        if targets and ewma and depth:
            budget = min(targets.values())
            if depth * ewma > DEADLINE_FRACTION * budget:
                # the deadline check: this request would spend its budget
                # waiting in the queue; shed it while the 429 is cheap
                return Overload("queue", retry_after_s(depth, ewma))
        if self._slo_breaches:
            return Overload("slo", retry_after_s(depth, ewma))
        return None

    # -- the gate ---------------------------------------------------------
    def admit(self) -> Optional[Overload]:
        """None = admitted (an in-flight slot held until
        :meth:`release`); an :class:`Overload` = shed, counted per
        reason. A gate failure fails open."""
        try:
            faults.failpoint("admission.gate")
            verdict = self._evaluate()
            if verdict is None:
                # compare and increment at once: N concurrent admits must
                # not all pass at inflight_max - 1
                with self._lock:
                    if self._inflight >= self.inflight_max:
                        verdict = Overload(
                            "inflight",
                            retry_after_s(
                                self.dispatcher.queue_depth(),
                                self.dispatcher.service_ewma_s()))
                    else:
                        self._inflight += 1
        except Exception as e:
            metrics.count("admission.errors")
            logger.error("admission gate failed open: %s", e)
            # a fail-open admit still holds a slot: the caller will call
            # release()
            with self._lock:
                self._inflight += 1
            metrics.count("admission.admitted")
            return None
        if verdict is None:
            metrics.count("admission.admitted")
            return None
        metrics.count(f"admission.shed.{verdict.reason}")
        with self._lock:
            self._shed_in_window = True
        return verdict

    def release(self) -> None:
        """The admitted request answered (any status): free its slot."""
        with self._lock:
            if self._inflight > 0:
                self._inflight -= 1

    def tick(self) -> None:
        """The sensors' and ladder's heartbeat for idle periods:
        ``/health`` calls it, so a service that stopped receiving traffic
        still steps the ladder back up."""
        self._maybe_refresh(self.clock())

    def snapshot(self) -> dict:
        with self._lock:
            inflight = self._inflight
        reg = metrics.default
        return {
            "armed": True,
            "inflight": inflight,
            "inflight_max": self.inflight_max,
            "queue_depth": self.dispatcher.queue_depth(),
            "queue_max": getattr(self.dispatcher, "queue_max", 0),
            "service_ewma_ms": round(
                (self.dispatcher.service_ewma_s() or 0.0) * 1000.0, 3),
            "slo_breaches": list(self._slo_breaches),
            "admitted": reg.counter("admission.admitted"),
            "shed": {reason: reg.counter(f"admission.shed.{reason}")
                     for reason in ("queue", "slo", "inflight")},
            "errors": reg.counter("admission.errors"),
        }


__all__ = ["AdmissionGate", "PressureLadder", "WindowedQuantile",
           "Overload", "RUNGS", "DEFAULT_HOLD_S", "retry_after_s", "ladder",
           "current_level", "allow_request_trace", "pressure_snapshot",
           "RETRY_AFTER_MIN_S", "RETRY_AFTER_MAX_S"]
