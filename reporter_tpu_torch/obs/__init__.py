"""Observability: request tracing, the flight recorder, Prometheus
exposition, latency SLOs and the device-facing profiler.

- :mod:`trace` — ``trace_id``/``span_id`` contexts (contextvar
  propagated, one module-flag check when disarmed), spans threaded
  through the service, dispatcher, matcher lanes and native prep phases,
  and a Chrome/Perfetto trace-event exporter.
- :mod:`flightrec` — a bounded ring of recent span events and the open
  spans, dumped atomically as a postmortem (``flightrec-<pid>-<seq>-*``).
- :mod:`prom` — ``/metrics`` Prometheus text rendered from the metrics
  registry.
- :mod:`slo` — per-stage p99 targets that turn ``/health`` 503 on a
  breach.
- :mod:`profiler` — kernel-build and launch telemetry per decode shape,
  per-chunk wide events served on ``/profile``, and the decode shadow
  that holds the card's kernel against the plain scan while serving.

Each module is configured by an argument, never by the environment; the
service's config keys reach them through ``service.server.configure_obs``.
Only the metrics-free modules load here: ``utils.metrics`` imports
:mod:`trace` (every ``metrics.timer`` site doubles as a span site), and
:mod:`prom`, :mod:`slo` and :mod:`profiler` import ``utils.metrics``.
"""
from . import flightrec, trace  # noqa: F401

__all__ = ["trace", "flightrec"]
