"""Synthetic-trace generator CLI.

Equivalent of the reference's ``py/generate_test_trace.py`` (route ->
per-second interpolation -> Gaussian noise -> POST /report,
generate_test_trace.py:181-203), against this framework's synthetic road
networks instead of a live Valhalla server. Emits, per trace:

  sv      one ``uuid|lat|lon|time|accuracy`` line per probe point — pipe
          into ``python -m reporter_tpu_torch stream -f ',sv,\\|,0,1,2,3,4'``
  json    one /report request body per line (Batch.java:56-66 shape)
  post    POST each body to --url and print the datastore response
          (generate_test_trace.py:192-199)
"""
from __future__ import annotations

import argparse
import json
import sys
import urllib.request

import numpy as np


def emit_sv(trace, out):
    for p in trace.points:
        out.write(f"{trace.uuid}|{p['lat']}|{p['lon']}|{p['time']}"
                  f"|{p['accuracy']}\n")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="reporter-synth",
        description="Generate noisy synthetic GPS traces with ground truth")
    parser.add_argument("--traces", type=int, default=10)
    parser.add_argument("--noise-m", type=float, default=5.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rows", type=int, default=20)
    parser.add_argument("--cols", type=int, default=20)
    parser.add_argument("--spacing-m", type=float, default=200.0)
    parser.add_argument("--graph", help="RoadNetwork file; omit for a "
                        "generated grid city")
    parser.add_argument("--format", choices=("sv", "json", "post"),
                        default="sv")
    parser.add_argument("--url", help="reporter /report url (format=post)")
    parser.add_argument("--mode", default="auto")
    args = parser.parse_args(argv)

    from ..synth import build_grid_city, generate_trace
    if args.graph:
        from ..graph.network import RoadNetwork
        net = RoadNetwork.load(args.graph)
    else:
        net = build_grid_city(rows=args.rows, cols=args.cols,
                              spacing_m=args.spacing_m, seed=args.seed)

    rng = np.random.default_rng(args.seed)
    made = 0
    while made < args.traces:
        tr = generate_trace(net, f"synth-{made}", rng, noise_m=args.noise_m)
        if tr is None:
            continue
        made += 1
        if args.format == "sv":
            emit_sv(tr, sys.stdout)
        elif args.format == "json":
            print(json.dumps(tr.request_json(mode=args.mode)))
        else:
            if not args.url:
                parser.error("--url is required with --format post")
            body = json.dumps(tr.request_json(mode=args.mode)).encode()
            req = urllib.request.Request(
                args.url, data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                print(resp.read().decode())
    return 0


if __name__ == "__main__":
    sys.exit(main())
