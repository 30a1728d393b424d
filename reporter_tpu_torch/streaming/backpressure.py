"""Streaming backpressure: the batcher slows down instead of spooling.

The port of ``reporter_tpu/streaming/backpressure.py``. The governor
turns sustained submit pressure into flow control:

- **Sensors.** :meth:`BackpressureGovernor.note_flush` feeds every
  batched submit's wall time into an EWMA of per-trace submit latency,
  and tracks the *requeue depth*: how many sessions carry a
  failed-submit retry (the batcher keeps the live set).

- **Slow offer acceptance.** When the submit-latency EWMA crosses
  ``latency_high_s`` or the requeue depth crosses ``depth_high``, the
  worker's offer loop sleeps :meth:`offer_delay` per message, a bounded
  block (``max_delay_s``) that propagates the slowdown upstream instead
  of letting memory absorb it. The delay scales with how far past the
  threshold the sensor sits.

- **Shed, accounted.** Past ``SHED_FACTOR`` times either threshold the
  governor declares :meth:`should_shed`: sessions whose batches cross
  the report thresholds dead-letter their trace JSON at once
  (``backpressure.shed``; the drainer replays them when the matcher
  recovers) instead of joining a pending set that can only grow.

The JAX package's ``REPORTER_TPU_BACKPRESSURE`` and
``REPORTER_TPU_BACKPRESSURE_LATENCY_S`` are the constructor arguments
``enabled`` and ``latency_high_s`` here (the worker's config keys
``backpressure`` and ``backpressure_latency_s``).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from ..utils import metrics

#: per-trace submit-latency EWMA above which offers slow down
DEFAULT_LATENCY_HIGH_S = 1.0
#: sessions carrying a failed-submit retry before offers slow down
DEFAULT_DEPTH_HIGH = 32
#: hard bound on the per-offer block: flow control, not a stall
DEFAULT_MAX_DELAY_S = 0.05
#: sensor multiple past the slow-down threshold at which report-ready
#: sessions dead-letter instead of joining the pending set
SHED_FACTOR = 4.0
_EWMA_ALPHA = 0.3


class BackpressureGovernor:
    """Submit-pressure sensors -> bounded offer delay + shed verdicts.

    Single-threaded by design, like the batcher that owns it: every
    method runs on the stream-processing thread, so there is no lock."""

    def __init__(self,
                 latency_high_s: float = DEFAULT_LATENCY_HIGH_S,
                 depth_high: int = DEFAULT_DEPTH_HIGH,
                 max_delay_s: float = DEFAULT_MAX_DELAY_S,
                 clock: Callable[[], float] = time.monotonic,
                 enabled: bool = True):
        self.enabled = bool(enabled)
        self.latency_high_s = latency_high_s
        self.depth_high = depth_high
        self.max_delay_s = max_delay_s
        self.clock = clock
        self.ewma_s: Optional[float] = None  # per-trace submit latency
        self.requeue_depth = 0
        self.flushes = 0
        self.failed_flushes = 0

    # -- sensors ----------------------------------------------------------
    def note_flush(self, n_traces: int, elapsed_s: float,
                   failures: int, requeue_depth: int) -> None:
        """One batched submit's outcome: wall time over ``n_traces``
        (EWMA input), how many traces failed, and the live requeue
        depth after the batcher's retry bookkeeping."""
        self.flushes += 1
        if failures:
            self.failed_flushes += 1
        self.requeue_depth = int(requeue_depth)
        if n_traces > 0 and elapsed_s >= 0.0:
            per_trace = elapsed_s / n_traces
            self.ewma_s = per_trace if self.ewma_s is None else \
                (1.0 - _EWMA_ALPHA) * self.ewma_s \
                + _EWMA_ALPHA * per_trace

    def _pressure(self) -> float:
        """How far past the slow-down thresholds the worst sensor sits
        (1.0 = at threshold; <1 = calm)."""
        ratio = 0.0
        if self.ewma_s is not None and self.latency_high_s > 0:
            ratio = self.ewma_s / self.latency_high_s
        if self.depth_high > 0:
            ratio = max(ratio, self.requeue_depth / self.depth_high)
        return ratio

    # -- verdicts ---------------------------------------------------------
    def offer_delay(self) -> float:
        """Seconds the offer loop should block before accepting the
        next message: 0 when calm, scaling linearly to ``max_delay_s``
        at ``SHED_FACTOR`` times the threshold."""
        if not self.enabled:
            return 0.0
        ratio = self._pressure()
        if ratio <= 1.0:
            return 0.0
        frac = min((ratio - 1.0) / (SHED_FACTOR - 1.0), 1.0)
        return frac * self.max_delay_s

    def should_shed(self) -> bool:
        """Whether report-ready sessions should dead-letter instead of
        queueing: the bounded block was not enough."""
        return self.enabled and self._pressure() >= SHED_FACTOR

    def snapshot(self) -> dict:
        return {
            "enabled": self.enabled,
            "submit_ewma_ms": round(self.ewma_s * 1000.0, 3)
            if self.ewma_s is not None else None,
            "latency_high_ms": round(self.latency_high_s * 1000.0, 1),
            "requeue_depth": self.requeue_depth,
            "depth_high": self.depth_high,
            "pressure": round(self._pressure(), 4),
            "delaying": self.offer_delay() > 0.0,
            "shedding": self.should_shed(),
            "delays": metrics.default.counter("backpressure.delays"),
            "shed": metrics.default.counter("backpressure.shed"),
        }


__all__ = ["BackpressureGovernor", "SHED_FACTOR"]
