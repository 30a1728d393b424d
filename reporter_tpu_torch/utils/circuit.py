"""Circuit breaker: bounded failure counting for a failure domain.

A three-state breaker (closed -> open -> half-open), generic over the
domain it guards: the protected operation asks :meth:`CircuitBreaker.allow`
before each attempt and reports the outcome with
:meth:`record_success` / :meth:`record_failure`.

- closed: attempts allowed; ``threshold`` consecutive failures open it.
- open: attempts denied until ``cooldown_s`` elapses, then the breaker
  half-opens.
- half-open: exactly one probe attempt is admitted at a time; success
  closes the breaker, failure re-opens it for another cooldown.

Every transition and probe counts into the metrics registry under
``{name}.*`` (``opened``/``closed``/``probes``/``failures``), and an
opening breaker dumps the flight recorder. The port of
``reporter_tpu/utils/circuit.py``.

What a denied attempt does is the domain's business. Where the JAX
package degrades to another implementation on the host, the port does
too; where it would move work off the card (the decode's numpy oracle,
a re-prep with host routes), the port refuses the work instead and
raises :class:`CircuitOpen`, which the front door answers with 503 and a
``Retry-After`` of the cooldown left.
"""
from __future__ import annotations

import math
import time
from typing import Callable

from . import locks as _locks
from . import metrics

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: consecutive failures that open a breaker, and the seconds it stays
#: open before a probe (the JAX package's defaults; the service's
#: ``circuit_threshold`` and ``circuit_cooldown_s`` config keys)
DEFAULT_THRESHOLD = 5
DEFAULT_COOLDOWN_S = 30.0


class CircuitOpen(RuntimeError):
    """Work refused because the breaker of ``domain`` is open: nothing was
    launched. The front door answers 503 with ``Retry-After:
    retry_after_s``."""

    def __init__(self, domain: str, retry_after_s: int):
        super().__init__(f"{domain} circuit open; retry after "
                         f"{retry_after_s}s")
        self.domain = domain
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    def __init__(self, name: str, threshold: int = DEFAULT_THRESHOLD,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 clock: Callable[[], float] = time.monotonic,
                 registry: metrics.Registry = metrics.default):
        self.name = name
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._registry = registry
        self._lock = _locks.new_lock(f"circuit.{name}")
        # the whole mutable state rides one Guarded dict: the device
        # lanes, the dispatch loop and direct callers all consult one
        # instance, and the lock witness checks every access is locked
        self._mut = _locks.Guarded(
            {"state": CLOSED, "failures": 0, "opened_at": 0.0,
             "probe_inflight": False}, self._lock, f"circuit.{name}")
        # lock-free steady-state flag, kept under the lock at every state
        # or failure change: True only while closed with zero recorded
        # failures. allow()/record_success() read it without the lock on
        # per-response hot paths; a reader seeing a just-stale True admits
        # one extra attempt or skips one failure-count reset, and every
        # state write stays under the lock
        self._fast_ok = True

    def configure(self, threshold: int, cooldown_s: float) -> None:
        """Set the threshold and cooldown (a process-wide breaker's
        settings come from the service's config)."""
        with self._lock:
            self.threshold = max(1, int(threshold))
            self.cooldown_s = float(cooldown_s)

    @property
    def state(self) -> str:
        with self._lock:
            # an open breaker past its cooldown is reported half-open: the
            # next allow() would admit a probe
            if self._mut["state"] == OPEN and \
                    self._clock() - self._mut["opened_at"] \
                    >= self.cooldown_s:
                return HALF_OPEN
            return self._mut["state"]

    def allow(self) -> bool:
        """May the protected operation run now? Open denies; half-open
        admits one probe at a time."""
        if self._fast_ok:
            return True
        with self._lock:
            st = self._mut
            if st["state"] == CLOSED:
                return True
            if st["state"] == OPEN:
                if self._clock() - st["opened_at"] < self.cooldown_s:
                    return False
                st["state"] = HALF_OPEN
                st["probe_inflight"] = False
            if st["probe_inflight"]:
                return False
            st["probe_inflight"] = True
        self._registry.count(f"{self.name}.probes")
        return True

    def record_success(self) -> None:
        if self._fast_ok:  # already closed with nothing to reset
            return
        closed_now = False
        with self._lock:
            st = self._mut
            st["failures"] = 0
            st["probe_inflight"] = False
            if st["state"] != CLOSED:
                st["state"] = CLOSED
                closed_now = True
            self._fast_ok = True
        if closed_now:
            self._registry.count(f"{self.name}.closed")

    def record_failure(self) -> None:
        opened_now = False
        with self._lock:
            st = self._mut
            st["probe_inflight"] = False
            st["failures"] += 1
            self._fast_ok = False
            if st["state"] == HALF_OPEN or (
                    st["state"] == CLOSED
                    and st["failures"] >= self.threshold):
                st["state"] = OPEN
                st["opened_at"] = self._clock()
                st["failures"] = 0
                opened_now = True
        self._registry.count(f"{self.name}.failures")
        if opened_now:
            self._registry.count(f"{self.name}.opened")
            # the moment an operator asks "what was happening?": leave
            # the flight recorder's answer (lazy import: obs is off the
            # breaker's hot path)
            from ..obs import flightrec
            flightrec.dump(f"circuit_open.{self.name}")

    def retry_after_s(self) -> int:
        """Whole seconds until a probe may run (at least 1): the
        ``Retry-After`` of work the open breaker refuses."""
        with self._lock:
            left = self.cooldown_s - (self._clock() - self._mut["opened_at"])
        return max(1, math.ceil(left))

    def refuse(self, domain: str) -> CircuitOpen:
        """The :class:`CircuitOpen` for work this open breaker denies."""
        return CircuitOpen(domain, self.retry_after_s())

    def snapshot(self) -> dict:
        """State summary for /health."""
        with self._lock:
            state = self._mut["state"]
            failures = self._mut["failures"]
            remaining = 0.0
            if state == OPEN:
                remaining = max(
                    0.0, self.cooldown_s
                    - (self._clock() - self._mut["opened_at"]))
                if remaining == 0.0:
                    state = HALF_OPEN
        return {"state": state, "consecutive_failures": failures,
                "threshold": self.threshold,
                "cooldown_remaining_s": round(remaining, 3)}


__all__ = ["CircuitBreaker", "CircuitOpen", "CLOSED", "OPEN", "HALF_OPEN"]
