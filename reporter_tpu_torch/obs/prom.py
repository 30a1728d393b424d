"""Prometheus text exposition rendered from the metrics registry.

``/metrics`` serves exposition-format 0.0.4 text: every counter becomes
``reporter_tpu_<name>_total`` and every histogram timer the
``reporter_tpu_<name>_seconds`` ``_bucket``/``_sum``/``_count`` family,
with the power-of-2 bucket bounds of :mod:`..utils.metrics` as the
``le`` labels. The prefix and the names are the JAX package's, so a
dashboard built on one reads the other. The registry's one
``export_state()`` copy is the scrape, so a scrape never sees a
half-updated histogram.
"""
from __future__ import annotations

import re
from typing import List, Optional

from ..utils import metrics

PREFIX = "reporter_tpu"

_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize(name: str) -> str:
    """A registry name as a Prometheus metric name component (dots and
    dashes become underscores)."""
    return _INVALID.sub("_", name)


def _fmt(v: float) -> str:
    """A float sample value in exposition format (repr round-trips)."""
    return repr(float(v))


def render(registry: Optional[metrics.Registry] = None) -> str:
    """The exposition body for one registry (default: the process
    registry), sorted by name so scrapes diff cleanly."""
    reg = registry if registry is not None else metrics.default
    counters, timers = reg.export_state()
    lines: List[str] = []
    for name in sorted(counters):
        base = f"{PREFIX}_{sanitize(name)}_total"
        lines.append(f"# TYPE {base} counter")
        lines.append(f"{base} {counters[name]}")
    for name in sorted(timers):
        count, total_s, _max_s, buckets = timers[name]
        base = f"{PREFIX}_{sanitize(name)}_seconds"
        lines.append(f"# TYPE {base} histogram")
        cum = 0
        for bound, n in zip(metrics.BUCKET_BOUNDS_S, buckets):
            cum += n
            lines.append(f'{base}_bucket{{le="{_fmt(bound)}"}} {cum}')
        lines.append(f'{base}_bucket{{le="+Inf"}} {count}')
        lines.append(f"{base}_sum {_fmt(total_s)}")
        lines.append(f"{base}_count {count}")
    return "\n".join(lines) + "\n"


CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
