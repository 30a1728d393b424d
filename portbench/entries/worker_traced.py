"""The streaming worker catching up on a partition's backlog, with the card
traced in every run on it: ``entries/worker.py``'s run (set-up, warm-up,
the closed-loop window of ``StreamWorker.offer`` batches, the judged
sample), with its window profiled whether or not ``--trace`` asks, as
``replay.py`` profiles its window.

A probe here is a message the worker consumed in the window: the window's
whole units of ``unit_messages`` lines. ``card_busy_ns_per_probe`` is the
card's busy time in the window (the union of its kernels, copies and
memsets) over those messages (``replay.card_busy``), and ``Obs.work``, the
per-layer readers' probes, is the same count. The batcher re-sends a
vehicle's held points in its next report after a trim, so the answered
requests hold more points than the messages consumed: their count goes to
the readers as ``Obs.extra["request_points"]``, beside the configuration's
K (``"K"``), for the incremental step's bytes.
"""
from __future__ import annotations

import copy
from unittest import mock

from ..lib import bench
from . import worker
from .replay import card_busy


def run(env) -> bench.Outcome:
    traced = copy.copy(env)
    # the card is traced in every run on it: its busy time is an
    # end-to-end metric
    traced.trace = env.trace or env.on_card
    timed_units = bench.timed_units
    units = []

    def counted(starts, do_unit, seconds):
        t0, elapsed, n = timed_units(starts, do_unit, seconds)
        units.append(n)
        return t0, elapsed, n

    # worker.run takes its window from bench.timed_units; the units it ran
    # give the messages consumed
    with mock.patch.object(bench, "timed_units", counted):
        out = worker.run(traced)
    messages = float(units[0] * int(env.cell["unit_messages"]))
    out.obs.extra["K"] = int(env.config["matcher"]["max_candidates"])
    out.obs.extra["request_points"] = out.obs.work
    out.obs.work = messages
    out.e2e = card_busy(out.obs.device, messages)
    return out
