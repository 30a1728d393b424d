"""Load shedding at the dispatcher's bounded queue.

A request the bounded dispatcher queue cannot take raises
:class:`Overload`; the HTTP handler answers it with 429 and a
``Retry-After`` of :func:`retry_after_s` seconds: the expected time for
the backlog to drain, clamped.
"""
from __future__ import annotations

import math
from typing import Optional

#: Retry-After clamp: at least 1 s (sub-second retries re-arrive inside
#: the same overload), at most 30 s (a misestimated EWMA must not park
#: honest clients for minutes)
RETRY_AFTER_MIN_S = 1
RETRY_AFTER_MAX_S = 30


class Overload(RuntimeError):
    """A request shed by load management (the bounded dispatcher queue).
    ``reason`` is the counted shed family; the serving layer maps this to
    HTTP 429 with ``Retry-After: retry_after_s``."""

    def __init__(self, reason: str, retry_after_s: float):
        super().__init__(f"overloaded ({reason}); retry after "
                         f"{retry_after_s:.0f}s")
        self.reason = reason
        self.retry_after_s = retry_after_s


def retry_after_s(depth: int, ewma_s: Optional[float]) -> int:
    """The computed back-off a shed response carries: the expected time
    for the current backlog to drain (depth x per-trace EWMA), clamped.
    With no service-time estimate yet, the floor — an honest "soon"."""
    if not ewma_s or depth <= 0:
        return RETRY_AFTER_MIN_S
    return int(min(max(math.ceil(depth * ewma_s), RETRY_AFTER_MIN_S),
                   RETRY_AFTER_MAX_S))


__all__ = ["Overload", "retry_after_s", "RETRY_AFTER_MIN_S",
           "RETRY_AFTER_MAX_S"]
