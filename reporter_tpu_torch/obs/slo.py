"""Per-stage latency SLOs: p99 targets that turn /health degraded.

The service config's ``slo_ms`` key declares targets as a
comma-separated spec, the grammar of the JAX package's
``REPORTER_TPU_SLO_MS``::

    service.handle=250,matcher.prep=50,dispatch.match_many=120

Each entry names a stage timer and its p99 budget in milliseconds.
``/health`` calls :func:`check`; a stage whose histogram p99 exceeds its
budget is a breach, and any breach turns ``/health`` 503.

A malformed spec is counted (``slo.malformed``) and logged, and arms no
target: a typo'd SLO string must not rotate a healthy fleet out of
service.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

from ..utils import metrics

logger = logging.getLogger("reporter_tpu_torch.obs")

_spec = ""
_parsed: Dict[str, float] = {}


def parse_spec(spec: str) -> Dict[str, float]:
    """``stage=ms[,stage=ms...]`` -> {stage: budget seconds}; raises
    ValueError on any malformed entry."""
    out: Dict[str, float] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        stage, sep, ms = entry.partition("=")
        if not sep or not stage.strip():
            raise ValueError(f"bad SLO entry {entry!r} (want stage=ms)")
        try:
            budget_ms = float(ms)
        except ValueError:
            raise ValueError(f"bad SLO budget in {entry!r} "
                             "(want milliseconds)") from None
        if budget_ms <= 0:
            raise ValueError(f"SLO budget must be > 0 in {entry!r}")
        out[stage.strip()] = budget_ms / 1000.0
    return out


def configure(spec: Optional[str]) -> None:
    """Arm the targets of ``spec`` (None or "" disarms). A malformed spec
    fails open: counted, logged, no target."""
    global _spec, _parsed
    spec = spec or ""
    try:
        parsed = parse_spec(spec)
    except ValueError as e:
        metrics.count("slo.malformed")
        logger.error("ignoring malformed slo_ms %r: %s", spec, e)
        parsed = {}
    _spec, _parsed = spec, parsed


def thresholds() -> Dict[str, float]:
    """The armed targets ({} when none)."""
    return _parsed


def check(registry: Optional[metrics.Registry] = None) -> dict:
    """{"targets": {stage: budget_s}, "breaches": [...]}: a breach is a
    stage whose histogram p99 exceeds its budget. A stage with no
    observations never breaches (an idle stage is not a slow one)."""
    targets = thresholds()
    if not targets:
        return {"targets": {}, "breaches": []}
    snap = (registry if registry is not None
            else metrics.default).snapshot()["timers"]
    breaches = [
        {"stage": stage,
         "p99_s": round(snap[stage]["p99_s"], 6),
         "slo_s": budget_s,
         "count": snap[stage]["count"]}
        for stage, budget_s in sorted(targets.items())
        if stage in snap and snap[stage]["count"]
        and snap[stage]["p99_s"] > budget_s]
    return {"targets": targets, "breaches": breaches}
