"""Chrome and Perfetto trace-event export of the port's request traces.

Two commands:

  convert   Turn recorded span JSON into a trace-event file that
            chrome://tracing or https://ui.perfetto.dev loads. It takes
            any of the three shapes the port writes:
              - a flight-recorder dump (``flightrec-<pid>-*.json``:
                ``spans`` and ``in_flight``)
              - a ``?trace=1`` /report response ({"report":..,"trace":..})
              - a bare span-record list, or a {"traceEvents": [...]}
                object (an exported trace passes through unchanged)

  record    Run synthetic /report requests through the real stack (a
            ``ReporterService`` over a ``SegmentMatcher`` on ``--device``,
            ``cuda`` unless ``--device cpu``) with tracing armed, and
            write their trace events: the service, the dispatcher, the
            matcher's prep, decode and assembly (on the card the
            ``kernel.viterbi_decode`` launch under the decode) and the
            serialisation, on one timeline.

Usage::

  python -m reporter_tpu_torch.tools.trace_cli convert <in.json> [-o out.json]
  python -m reporter_tpu_torch.tools.trace_cli record [-o out.json]
      [--traces N] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def spans_from_payload(payload):
    """(closed spans, in-flight spans) from any recognised JSON shape; an
    exported trace comes back as (None, its events)."""
    if isinstance(payload, list):
        return payload, []
    if not isinstance(payload, dict):
        raise ValueError("unrecognised trace payload (want a JSON object "
                         "or span list)")
    if "traceEvents" in payload:
        return None, payload["traceEvents"]
    if isinstance(payload.get("trace"), dict) \
            and "traceEvents" in payload["trace"]:
        return None, payload["trace"]["traceEvents"]
    if "spans" in payload:  # a flight-recorder dump
        return payload.get("spans", []), payload.get("in_flight", [])
    raise ValueError("unrecognised trace payload (no spans, traceEvents "
                     "or trace key)")


def convert(payload) -> dict:
    """The trace-event object for one payload."""
    from ..obs import trace as obs_trace
    spans, extra = spans_from_payload(payload)
    if spans is None:
        return {"traceEvents": extra, "displayTimeUnit": "ms"}
    return obs_trace.to_trace_events(spans, in_flight=extra)


def cmd_convert(args) -> int:
    with open(args.input, encoding="utf-8") as f:
        obj = convert(json.load(f))
    out = args.output or (os.path.splitext(args.input)[0] + ".trace.json")
    with open(out, "w", encoding="utf-8") as f:
        json.dump(obj, f, separators=(",", ":"))
    print(f"{len(obj['traceEvents'])} events -> {out} "
          "(load in chrome://tracing or ui.perfetto.dev)")
    return 0


def record(n_traces: int = 1, device: str = "cuda") -> dict:
    """Serve ``n_traces`` synthetic requests under one traced root span;
    their trace-event object. The first request, served before the
    recording, builds the kernels."""
    import numpy as np

    from ..matcher import SegmentMatcher
    from ..obs import trace as obs_trace
    from ..service.server import ReporterService
    from ..synth import build_grid_city, generate_trace

    city = build_grid_city(rows=8, cols=8, spacing_m=200.0, seed=5,
                           service_road_fraction=0.0, internal_fraction=0.0)
    rng = np.random.default_rng(7)
    reqs = []
    for i in range(n_traces):
        tr = None
        while tr is None:
            tr = generate_trace(city, f"trace-cli-{i}", rng, noise_m=3.0,
                                min_route_edges=8)
        reqs.append({"uuid": tr.uuid, "trace": tr.points,
                     "match_options": {"mode": "auto",
                                       "report_levels": [0, 1, 2],
                                       "transition_levels": [0, 1, 2]}})
    service = ReporterService(SegmentMatcher(city, device=device),
                              threshold_sec=15, max_batch=64,
                              max_wait_ms=5.0)
    try:
        service.handle(reqs[0])  # builds outside the recording
        obs_trace.force_begin()
        try:
            with obs_trace.span("service.request",
                                source="trace_cli") as root:
                for req in reqs:
                    code, _body = service.handle(req)
                    if code != 200:
                        raise RuntimeError(f"request {req['uuid']} failed "
                                           f"({code})")
            return obs_trace.export_trace(root)
        finally:
            obs_trace.force_end()
    finally:
        service.dispatcher.close()
        service.matcher.close()


def cmd_record(args) -> int:
    try:
        obj = record(args.traces, args.device)
    except RuntimeError as e:
        print(f"trace_cli: {e}", file=sys.stderr)
        return 1
    out = args.output or "reporter_trace.json"
    with open(out, "w", encoding="utf-8") as f:
        json.dump(obj, f, separators=(",", ":"))
    print(f"{len(obj['traceEvents'])} events over {args.traces} "
          f"request(s) -> {out} (load in chrome://tracing or "
          "ui.perfetto.dev)")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m reporter_tpu_torch.tools.trace_cli",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_conv = sub.add_parser("convert", help="span JSON -> trace events")
    p_conv.add_argument("input")
    p_conv.add_argument("-o", "--output")
    p_rec = sub.add_parser("record", help="record traced requests")
    p_rec.add_argument("-o", "--output")
    p_rec.add_argument("--traces", type=int, default=1)
    p_rec.add_argument("--device", default="cuda",
                       help="the matcher's device (default cuda)")
    args = parser.parse_args(argv)
    if args.cmd == "convert":
        return cmd_convert(args)
    return cmd_record(args)


if __name__ == "__main__":
    sys.exit(main())
