"""The streaming worker catching up on a partition's backlog:
``StreamWorker.offer`` over raw probe lines in time order.

Set-up builds the configuration's city, the program's matcher and
``ReporterService`` on the card, the worker as its ``main`` wires it
(in-process submit, batched ``submit_many`` through
``report_incremental``, the anonymiser over a tile sink in the run's
directory), and the mix's fleet from the run seed as raw lines
``uuid|lat|lon|time|accuracy`` in time order (ties by uuid), as a
partition holds them. The worker's clock is the stream's: each offer
first sets it to the message's time, so the session gap, the report
flush and the tile flush run on stream time, whatever the wall clock
does. Set-up first builds the card's kernels with one batch of windows
from another stream of the seed, then offers the stream's first
``warm_stream_s`` seconds,
so the window starts on a worker in steady state: carried decode state
for every vehicle, the route memo and every kernel warm.

The window offers whole batches of ``unit_messages`` lines, closed loop:
the next batch as soon as the last returns. ``stream_probes_per_s``
counts the probes in the report requests the matcher answered in the
window (the harness wraps the ``submit_many`` callable the worker is
handed) over the window's elapsed time; messages still held in the
batcher are not counted. After the window a sample of the answered
requests drawn from the seed, the longest among them, is judged: each
request's points must be the stream's (as the point format quantises
them), and its answer's datastore reports must equal the reference's for
those points (``answers_mismatch_share``).

No cell of ``BENCHMARK.json`` runs this entry yet: the streaming
deployment it served wants a sourced graph and fleet first (PERF.md,
Open questions). Its CPU tests hold it on a small configuration.
"""
from __future__ import annotations

import gc
import os
import time

import numpy as np

from ..lib import bench, devtrace, textio, traffic
from ..ref.city import build_grid_city
from .replay import UUID_DIGITS, UUID_PREFIX, grid_of

#: the raw line format: ``uuid|lat|lon|time|accuracy``
FORMAT = r",sv,\|,0,1,2,3,4"


def stream_lines(fleet, order) -> list:
    """The fleet's probes as raw lines, in ``order``."""
    veh = fleet.vehicle[order]
    raw = textio.text(
        len(veh), textio.labels(UUID_PREFIX, veh, UUID_DIGITS), b"|",
        textio.fixed(fleet.lat[order], 3, 6), b"|",
        textio.fixed(fleet.lon[order], 3, 6), b"|",
        textio.digits(fleet.time[order], 10), b"|",
        textio.digits(np.full(len(veh), fleet.accuracy), 3))
    return raw.decode().splitlines(keepends=True)


def f32_point(x: float) -> float:
    """A coordinate as the point format holds it: float32, then the
    request's 6 decimals."""
    return round(float(np.float32(x)), 6)


def run(env) -> bench.Outcome:
    import torch

    from reporter_tpu_torch.graph.network import network_from_arrays
    from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
    from reporter_tpu_torch.service.server import ReporterService
    from reporter_tpu_torch.streaming.anonymiser import Anonymiser, TileSink
    from reporter_tpu_torch.streaming.formatter import Formatter
    from reporter_tpu_torch.streaming.worker import (StreamWorker,
                                                     inproc_submitter)
    from reporter_tpu_torch.utils import metrics

    cfg, cell, mix = env.config, env.cell, env.mix
    wk = cfg["worker"]
    arrays = build_grid_city(**cfg["city"])
    matcher = SegmentMatcher(network_from_arrays(arrays),
                             MatchParams(**cfg["matcher"]), device=env.device,
                             **cfg.get("runtime", {}))
    service = ReporterService(matcher, threshold_sec=wk["threshold_sec"])
    env.lap("matcher built")
    # the first call into the matcher builds the card's kernels: make it
    # here, on windows of another stream of the seed, and not under the
    # worker, whose backpressure governor would read the build as a slow
    # matcher and hold every offer back for minutes
    warm = traffic.fleet(dict(mix, vehicles=cell["prebuild_vehicles"]),
                         grid_of(cfg), env.seed, stream=1)
    service.report_many([{
        "uuid": f"warm-{v}", "match_options": {
            "mode": wk["mode"],
            "report_levels": [int(x) for x in wk["reports"].split(",")],
            "transition_levels": [int(x) for x in
                                  wk["transitions"].split(",")]},
        "trace": [{"lat": float(warm.lat[i]), "lon": float(warm.lon[i]),
                   "time": int(warm.time[i]), "accuracy": warm.accuracy}
                  for i in range(warm.offsets[v], warm.offsets[v] + 16)]}
        for v in range(warm.vehicles)])
    env.sync()
    fleet = traffic.fleet(mix, grid_of(cfg), env.seed)
    order = np.lexsort((fleet.vehicle, fleet.time))
    lines = stream_lines(fleet, order)
    times = fleet.time[order]

    env.lap("traffic staged")
    now = [float(times[0])]
    answered = []           # (TraceBatch, responses) of the window
    in_window = [False]
    seconds = [0.0]

    def submit_many(tb):
        t0 = time.perf_counter()
        with devtrace.span("submit_many"):
            out = service.report_incremental(tb)
        if in_window[0]:
            seconds[0] += time.perf_counter() - t0
            answered.append((tb, out))
        return out

    def on_evict(uuid):
        t = matcher._incremental_table
        if t is not None:
            t.evict(uuid, "session gap")

    worker = StreamWorker(
        Formatter.from_config(FORMAT), inproc_submitter(service),
        Anonymiser(TileSink(os.path.join(env.rundir, "tiles")),
                   wk["privacy"], wk["quantisation"], mode=wk["mode"],
                   source=wk["source"]),
        mode=wk["mode"], reports=wk["reports"],
        transitions=wk["transitions"],
        flush_interval_s=wk["flush_interval_s"],
        session_gap_ms=wk["session_gap_ms"], clock=lambda: now[0],
        submit_many=submit_many,
        report_flush_interval_s=wk["report_flush_interval_s"],
        on_evict=on_evict)

    def offer(lo, hi):
        for i in range(lo, hi):
            now[0] = float(times[i])
            worker.offer(lines[i])

    warm_end = int(np.searchsorted(times, times[0] + cell["warm_stream_s"]))
    offer(0, warm_end)
    env.sync()

    env.lap("warm")
    step = int(cell["unit_messages"])
    starts = range(warm_end, len(lines) - step + 1, step)

    def do_unit(lo):
        with devtrace.span("offer"):
            offer(lo, lo + step)

    metrics.default.reset()
    in_window[0] = True
    with devtrace.traced(env.trace, env.on_card) as tr:
        with devtrace.span("window"):
            t0, elapsed, n_units = bench.timed_units(starts, do_unit,
                                                     env.seconds)
            env.sync()
    in_window[0] = False
    setup_s = t0 - env.t_start
    peak = env.memory_peak()
    snap = metrics.snapshot()
    probes = attempted = failed = 0
    for tb, out in answered:
        lens = np.diff(tb.offsets)
        for n, rep in zip(lens.tolist(), out):
            attempted += 1
            if rep is None:
                failed += 1
            else:
                probes += n
    obs = bench.Obs(window_s=elapsed, work=float(probes),
                    counters=snap["counters"], timers=snap["timers"],
                    spans={"submit_many": seconds[0]}, device=tr.summary)
    service.dispatcher.close()
    matcher.close()
    del worker, service, matcher
    gc.collect()
    if env.on_card:
        torch.cuda.empty_cache()

    share = judge_answers(env, arrays, fleet, answered)
    return bench.Outcome(
        e2e={"stream_probes_per_s": probes / elapsed}, setup_s=setup_s,
        attempted=attempted, failed=failed,
        checks=[("answers_mismatch_share", share,
                 env.limits()["answers_mismatch_share"])],
        memory_peak_bytes=peak, obs=obs)


def judge_answers(env, arrays, fleet, answered) -> float:
    """The share of a seeded sample of the window's answered requests
    (the longest among them) whose points are not the stream's or whose
    answers (stats, shape_used, reports) differ from the reference's; 1.0 when nothing was answered."""
    from ..ref.match import same_answer
    from ..ref.pool import ReferencePool
    wk = env.config["worker"]
    slots = [(tb, i, rep) for tb, out in answered
             for i, rep in enumerate(out) if rep is not None]
    if not slots:
        return 1.0
    rng = np.random.default_rng([env.seed % 2 ** 64, 0x1d9e])
    n = min(int(env.cell["judge"]["requests"]), len(slots))
    pick = set(rng.choice(len(slots), n, replace=False).tolist())
    pick.add(max(range(len(slots)),
                 key=lambda k: slots[k][0].offsets[slots[k][1] + 1]
                 - slots[k][0].offsets[slots[k][1]]))
    levels = [int(x) for x in wk["reports"].split(",")]
    trans = [int(x) for x in wk["transitions"].split(",")]
    bad = 0
    tasks, got = [], []
    for k in sorted(pick):
        tb, i, rep = slots[k]
        lo, hi = int(tb.offsets[i]), int(tb.offsets[i + 1])
        v = int(str(tb.uuid(i))[len(UUID_PREFIX):])
        a, b = fleet.offsets[v], fleet.offsets[v + 1]
        idx = np.minimum(a + np.searchsorted(fleet.time[a:b],
                                             tb.time[lo:hi]), b - 1)
        lat = [f32_point(x) for x in fleet.lat[idx]]
        lon = [f32_point(x) for x in fleet.lon[idx]]
        if not (np.array_equal(fleet.time[idx], tb.time[lo:hi])
                and np.array_equal(lat, tb.lat[lo:hi])
                and np.array_equal(lon, tb.lon[lo:hi])):
            bad += 1   # the request is not the stream's points
            continue
        tasks.append((np.asarray(lat), np.asarray(lon),
                      np.asarray(tb.time[lo:hi], np.float64),
                      wk["threshold_sec"], levels, trans))
        got.append(rep)
    with ReferencePool(arrays, env.config["matcher"]) as pool:
        wants = pool.answers(tasks)
    bad += sum(not same_answer(g, w) for g, w in zip(got, wants))
    return bad / len(pick)
