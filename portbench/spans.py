"""Run one cell once as a ``--trace 1`` run with the program's spans in the
device trace, and label the card's idle time by them.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on a machine with an NVIDIA card. The window
runs under the program's profiler mirror (``obs.trace.configure(True,
profiler=True)``, armed as the first unit starts and disarmed after the
last); the rest is ``run.py``'s ``--trace 1`` run. Its result line gains
three keys:

- ``idle_program``: the window's idle seconds by the innermost program
  span on the window's thread (``lib/progtrace.py``);
- ``program_spans``: ``opened``, the spans the program opened in the
  window on every thread, and ``recorded``, the ranges the window's
  thread left in the profile;
- ``span_cost_us``: what one armed, mirrored ``metrics.timer`` costs over
  a disarmed one under a running CPU and CUDA profile, in microseconds
  (the median of 5 rounds of 10,000).

It takes its hooks by wrapping the harness's timed window and trace
reduction in its own process: no file of the harness changes.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import statistics
import sys
import time


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    return p.parse_args(argv)


def span_cost_us(rounds: int = 5, n: int = 10_000) -> float:
    """Microseconds one armed, mirrored ``metrics.timer`` costs over a
    disarmed one, inside a running CPU and CUDA profile."""
    from torch.profiler import ProfilerActivity, profile

    from reporter_tpu_torch.obs import trace as obs_trace
    from reporter_tpu_torch.utils.metrics import Registry
    reg = Registry()

    def loop() -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with reg.timer("portbench.span_cost"):
                pass
        return time.perf_counter() - t0

    costs = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(rounds):
            obs_trace.configure(False)
            off = loop()
            obs_trace.configure(True, profiler=True)
            try:
                on = loop()
            finally:
                obs_trace.configure(False)
            costs.append((on - off) / n * 1e6)
    return statistics.median(costs)


def main(argv=None) -> int:
    args = parse(argv)
    from reporter_tpu_torch.obs import trace as obs_trace

    from . import run
    from .lib import bench, devtrace, progtrace

    seen = {"idle": {}, "recorded": 0}
    opened = itertools.count()   # next() is atomic: spans open on lanes too
    timed_units, summarise, span = (bench.timed_units, devtrace.summarise,
                                    obs_trace.span)

    def counted(name, **attrs):
        next(opened)
        return span(name, **attrs)

    def armed_window(*a, **kw):
        obs_trace.span = counted
        obs_trace.configure(True, profiler=True)
        try:
            return timed_units(*a, **kw)
        finally:
            obs_trace.configure(False)
            obs_trace.span = span

    def summarise_with_program(prof):
        seen["idle"], seen["recorded"] = progtrace.idle_by_program(
            prof.events())
        return summarise(prof)

    bench.timed_units = armed_window
    devtrace.summarise = summarise_with_program
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = run.main(["--workload", args.workload, "--seed",
                           str(args.seed), "--seconds", str(args.seconds),
                           "--trace", "1"])
    finally:
        bench.timed_units, devtrace.summarise = timed_units, summarise
    if rc:
        return rc
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    result["idle_program"] = dict(sorted(seen["idle"].items(),
                                         key=lambda kv: -kv[1]))
    result["program_spans"] = {"opened": next(opened),
                               "recorded": seen["recorded"]}
    result["span_cost_us"] = span_cost_us()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
