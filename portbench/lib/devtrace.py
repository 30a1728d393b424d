"""The device trace of a run: ``torch.profiler`` over the measured window
(in every run of an entry with a device metric end to end, else with
``--trace 1``), reduced to the busy share, kernel time by name and the
idle gaps by what the host was doing.

Busy is the union of the CUDA kernel, memcpy and memset intervals inside
the window (frozen from ``chip_smoke.py`` ``device_busy``, :2714-2757).
The host's side is the harness's own spans: ``record_function`` regions
named ``portbench.<layer>`` around each call into the program. An idle
gap is labelled by the innermost such span that covers its midpoint.
"""
from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

SPAN_PREFIX = "portbench."
WINDOW = SPAN_PREFIX + "window"


@dataclass
class DeviceSummary:
    """What the readers take from a trace: ``busy_s`` and ``window_s``,
    ``kernels`` [(name, seconds, launches)] by device time, ``idle``
    {host span: idle seconds}."""
    busy_s: float
    window_s: float
    kernels: list = field(default_factory=list)
    idle: dict = field(default_factory=dict)

    def kernel_seconds(self, needle: str) -> tuple:
        """(seconds, launches) of the kernels whose name holds
        ``needle``."""
        s = n = 0
        for name, sec, count in self.kernels:
            if needle in name:
                s += sec
                n += count
        return s, n


def span(name: str):
    """A host span of the harness around a call into the program
    (``record_function``: nearly free when no profiler runs)."""
    from torch.profiler import record_function
    return record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def traced(on: bool, cuda: bool = True):
    """Profile the enclosed window when ``on`` (the card's activity too
    when ``cuda``); yields a holder whose ``summary`` is set on exit (None
    when off)."""
    holder = type("Holder", (), {"summary": None})()
    if not on:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield holder
        if cuda:
            torch.cuda.synchronize()
    holder.summary = summarise(prof)


def _union(spans):
    busy, cur, merged = 0.0, None, []
    for a, b in sorted(spans):
        if cur is None or a > cur[1]:
            if cur is not None:
                merged.append(cur)
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        merged.append(cur)
    for a, b in merged:
        busy += b - a
    return busy, merged


def summarise(prof) -> DeviceSummary:
    """Reduce a finished profile to a :class:`DeviceSummary` over the
    ``portbench.window`` region (the whole profile if it has none)."""
    from torch.autograd import DeviceType
    evs = prof.events()
    host = [e for e in evs if e.device_type == DeviceType.CPU]
    notes = {e.name for e in host}
    win = [e for e in host if e.name == WINDOW]
    if win:
        lo, hi = win[0].time_range.start, win[0].time_range.end
    else:
        lo = min(e.time_range.start for e in evs)
        hi = max(e.time_range.end for e in evs)
    dev = [e for e in evs if e.device_type == DeviceType.CUDA
           and e.name not in notes
           and not getattr(e, "is_user_annotation", False)
           and e.time_range.end > lo and e.time_range.start < hi]
    if not dev and not win:
        return DeviceSummary(busy_s=0.0, window_s=0.0)
    busy, merged = _union((max(lo, e.time_range.start),
                           min(hi, e.time_range.end)) for e in dev)
    by_name: dict = {}
    for e in dev:
        s = by_name.setdefault(e.name, [0.0, 0])
        s[0] += (e.time_range.end - e.time_range.start) / 1e6
        s[1] += 1
    kernels = sorted(((n, s, c) for n, (s, c) in by_name.items()),
                     key=lambda r: -r[1])
    # idle gaps between busy intervals, labelled by the innermost harness
    # span (the shortest covering one) at the gap's midpoint
    spans = sorted((e.time_range.start, e.time_range.end,
                    e.name[len(SPAN_PREFIX):]) for e in host
                   if e.name.startswith(SPAN_PREFIX) and e.name != WINDOW)
    starts = [s[0] for s in spans]
    idle: dict = {}
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label, best = "host outside the harness spans", None
        for s in spans[:bisect.bisect_right(starts, mid)]:
            if s[1] >= mid and (best is None or s[1] - s[0] < best):
                label, best = s[2], s[1] - s[0]
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return DeviceSummary(busy_s=busy / 1e6, window_s=(hi - lo) / 1e6,
                         kernels=kernels, idle=idle)
