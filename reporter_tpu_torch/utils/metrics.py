"""Lightweight metrics: counters and histogram stage timers.

- ``Registry``: named monotonically-increasing counters and stage
  timers. A timer is a fixed log-bucketed histogram (power-of-2 bounds,
  one numpy bucket increment per observation) plus count/total/max, so
  ``snapshot()`` reports p50/p95/p99 per stage — count/total/max alone
  cannot distinguish "steady 10 ms" from "9 ms with a 2 s tail".
- ``timer(name)``: context manager recording a stage duration.

Snapshots report raw floats; ``/stats`` serialises through
:func:`snapshot_rounded` (9 decimals, nanosecond resolution), so
sub-microsecond stages stay visible.

All state lives in a process-global default registry (``metrics.default``)
because every consumer is process-wide (one matcher, one dispatcher);
tests construct private ``Registry`` instances. A forked child's default
registry starts empty (``utils.forksafe``).
"""
from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Dict, Iterator, Tuple

import numpy as np

from . import forksafe

#: histogram bucket upper bounds in seconds: powers of two from ~1 µs
#: (2^-20) to 128 s (2^7). Log-spaced buckets keep relative error
#: bounded (<= 2x anywhere) with a bucket index that is one frexp — no
#: search. One extra overflow bucket catches anything slower.
_BUCKET_EXP_MIN = -20
_BUCKET_EXP_MAX = 7
BUCKET_BOUNDS_S: Tuple[float, ...] = tuple(
    2.0 ** e for e in range(_BUCKET_EXP_MIN, _BUCKET_EXP_MAX + 1))
_N_BUCKETS = len(BUCKET_BOUNDS_S) + 1  # + overflow


def bucket_index(elapsed_s: float) -> int:
    """Histogram bucket for a duration: ``frexp`` exponent, clipped.
    A value in (2^(e-1), 2^e] lands in the bucket bounded by 2^e."""
    if elapsed_s <= 0.0:
        return 0
    # frexp(x) = (m, e) with x = m * 2^e, m in [0.5, 1) — so e is the
    # ceil of log2(x) for non-powers; exact powers land one higher,
    # which still satisfies the le-bound contract (x <= 2^e)
    e = math.frexp(elapsed_s)[1]
    idx = e - _BUCKET_EXP_MIN
    if idx < 0:
        return 0
    if idx >= _N_BUCKETS:
        return _N_BUCKETS - 1
    return idx


class _Timer:
    __slots__ = ("count", "total_s", "max_s", "buckets")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.buckets = np.zeros(_N_BUCKETS, dtype=np.int64)

    def add(self, elapsed_s: float) -> None:
        self.count += 1
        self.total_s += elapsed_s
        if elapsed_s > self.max_s:
            self.max_s = elapsed_s
        self.buckets[bucket_index(elapsed_s)] += 1

    def quantile(self, q: float) -> float:
        """Histogram quantile: find the bucket holding the q-th ranked
        observation, interpolate linearly inside it, clamp to the
        observed max (the last bucket is open-ended)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = np.cumsum(self.buckets)
        idx = int(np.searchsorted(cum, target, side="left"))
        lo = BUCKET_BOUNDS_S[idx - 1] if idx > 0 else 0.0
        hi = BUCKET_BOUNDS_S[idx] if idx < len(BUCKET_BOUNDS_S) \
            else self.max_s
        below = int(cum[idx - 1]) if idx > 0 else 0
        in_bucket = int(self.buckets[idx])
        frac = (target - below) / in_bucket if in_bucket else 1.0
        return min(lo + frac * (hi - lo), self.max_s)


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._timers: Dict[str, _Timer] = {}

    def count(self, name: str, n: int = 1) -> int:
        """Increment a counter; returns the new value."""
        with self._lock:
            v = self._counters.get(name, 0) + n
            self._counters[name] = v
            return v

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def observe(self, name: str, elapsed_s: float) -> None:
        """Record a duration measured externally."""
        with self._lock:
            t = self._timers.get(name)
            if t is None:
                t = self._timers[name] = _Timer()
            t.add(elapsed_s)

    def snapshot(self) -> dict:
        """{"counters": {...}, "timers": {name: {count, total_s, mean_s,
        max_s, p50_s, p95_s, p99_s}}} — raw floats (see module doc)."""
        with self._lock:
            counters = dict(self._counters)
            timers = {
                name: {
                    "count": t.count,
                    "total_s": t.total_s,
                    "mean_s": t.total_s / t.count if t.count else 0.0,
                    "max_s": t.max_s,
                    "p50_s": t.quantile(0.50),
                    "p95_s": t.quantile(0.95),
                    "p99_s": t.quantile(0.99),
                }
                for name, t in self._timers.items()
            }
        return {"counters": counters, "timers": timers}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timers.clear()

    def reset_after_fork(self) -> None:
        """The child's reset: a parent thread may have held the lock at
        the fork, and it would stay held forever here."""
        self._lock = threading.Lock()
        self.reset()


def snapshot_rounded(registry: "Registry | None" = None,
                     ndigits: int = 9) -> dict:
    """The /stats wire form: :meth:`Registry.snapshot` with timer floats
    rounded for the JSON body. 9 decimals = nanosecond resolution, so
    sub-microsecond stages stay visible."""
    snap = (registry if registry is not None else default).snapshot()
    snap["timers"] = {
        name: {k: round(v, ndigits) if isinstance(v, float) else v
               for k, v in t.items()}
        for name, t in snap["timers"].items()}
    return snap


#: the device route kernel's counters (graph/route_device.py): chunks
#: routed, live candidate pairs and relaxation sources in them, node-kernel
#: cache rows served and relaxed, chunks left on the device for the
#: decode stage, chunks with nothing to route, relaxations that ran out of
#: sweeps, chunks over the state budget, and relaxations and their sweeps
ROUTE_DEVICE_COUNTERS = (
    "route.device.chunks", "route.device.pairs", "route.device.sources",
    "route.device.cache_hit_rows", "route.device.cache_miss_rows",
    "route.device.deferred_chunks",
    "route.device.empty_chunks", "route.device.nonconverged",
    "route.device.budget_exceeded", "route.device.relaxes",
    "route.device.sweeps")

#: process-global registry used by the service
default = Registry()
count = default.count
timer = default.timer
observe = default.observe
snapshot = default.snapshot

# a forked worker's /stats must report ITS work, not a copy-on-write
# snapshot of the parent's: the child's default registry starts empty
forksafe.register(default.reset_after_fork)
