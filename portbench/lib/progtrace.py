"""The card's idle time labelled by the program's own spans.

With the program's profiler mirror armed (``obs.trace.configure(True,
profiler=True)``), each of its spans is a ``record_function`` range named
``reporter_tpu_torch.span:<name>`` in the same profile as the kernels and
copies. :func:`idle_by_program` labels each idle gap of the window, as
``devtrace.summarise`` finds them, by the innermost such range that covers
its midpoint on the thread that opened ``portbench.window``: the caller's
thread, which sets the pace in a host-bound cell (and the only thread
whose ranges torch's CPU profile records when it was started there).
"""
from __future__ import annotations

import bisect

from . import devtrace

#: the program's span prefix (``obs.trace.PROFILER_PREFIX``), copied so
#: that reading a profile imports nothing of the program
PROGRAM_PREFIX = "reporter_tpu_torch.span:"
#: the label of idle time that no program span covers
UNCOVERED = "outside the program's spans"


def idle_by_program(events) -> tuple:
    """({program span: idle seconds}, the program's ranges on the window's
    thread inside the window) of a finished profile's ``events()``;
    ({}, 0) when the profile has no ``portbench.window``. The gaps and
    their seconds are ``devtrace.summarise``'s: the labels alone differ."""
    from torch.autograd import DeviceType
    host = [e for e in events if e.device_type == DeviceType.CPU]
    win = [e for e in host if e.name == devtrace.WINDOW]
    if not win:
        return {}, 0
    lo, hi = win[0].time_range.start, win[0].time_range.end
    notes = {e.name for e in host}
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name not in notes
           and not getattr(e, "is_user_annotation", False)
           and e.time_range.end > lo and e.time_range.start < hi]
    _busy, merged = devtrace._union((max(lo, e.time_range.start),
                                     min(hi, e.time_range.end)) for e in dev)
    spans = sorted((e.time_range.start, e.time_range.end,
                    e.name[len(PROGRAM_PREFIX):]) for e in host
                   if e.thread == win[0].thread
                   and e.name.startswith(PROGRAM_PREFIX)
                   and e.time_range.end > lo and e.time_range.start < hi)
    starts = [s[0] for s in spans]
    idle: dict = {}
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label, best = UNCOVERED, None
        for s in spans[:bisect.bisect_right(starts, mid)]:
            if s[1] >= mid and (best is None or s[1] - s[0] < best):
                label, best = s[2], s[1] - s[0]
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return idle, len(spans)
