"""The batched pipeline's match stage: ``match_traces`` over shard files.

Set-up builds the configuration's city from its seed (the frozen builder,
``ref/city.py``), the program's matcher on the card, and the mix's fleet
from the run seed, and stages the fleet as shard files, one directory of
vehicles per unit. It warms up on units of a second fleet drawn from
another stream of the seed (the cell's own shapes, none of the measured
probes). The window runs whole units: one ``match_traces`` call each,
handed a timing proxy as its ``matcher`` (the stage takes anything with
``match_many``).

The window counts the probes in the windows whose rows the calls wrote
(windows of two points or more). ``card_busy_ns_per_probe`` is the
card's busy time in the traced window over those probes; the wall rate,
probes over the window's elapsed time, is read per layer. The staged units are distinct vehicles; a window that outruns them
goes on over the same unit files again, in order, rather than stop.
After the window, whole units drawn from the seed among those it ran are
judged: the reference builds every vehicle's reports and tile rows (with
the seam dedupe), and ``rows_mismatch_share`` counts the rows that the
call and the reference do not share, missing or surplus, against the
reference's rows.
"""
from __future__ import annotations

import gc
import itertools
import os
import shutil
import time
from collections import Counter

import numpy as np

from ..lib import bench, devtrace, textio, traffic
from ..ref.city import build_grid_city

UUID_PREFIX = "veh-"
UUID_DIGITS = 6


def grid_of(config: dict) -> dict:
    c = config["city"]
    return {k: c[k] for k in ("rows", "cols", "spacing_m", "lat0", "lon0")}


def stage_units(fleet, units: int, root: str) -> list:
    """Write the fleet as ``units`` directories of one shard file each
    (vehicle v in unit v % units), in the gathered format
    ``uuid,epoch,lat,lon,accuracy``; returns [(dir, vehicles)]."""
    V = fleet.vehicles
    veh = fleet.vehicle
    line = textio.text(
        len(veh), textio.labels(UUID_PREFIX, veh, UUID_DIGITS), b",",
        textio.digits(fleet.time, 10), b",", textio.fixed(fleet.lat, 3, 6),
        b",", textio.fixed(fleet.lon, 3, 6), b",",
        textio.digits(np.full(len(veh), fleet.accuracy), 3))
    width = len(line) // max(len(veh), 1)
    rows = np.frombuffer(line, np.uint8).reshape(len(veh), width)
    unit_of = veh % units
    out = []
    for u in range(units):
        d = os.path.join(root, f"unit{u:04d}")
        os.makedirs(d)
        sel = unit_of == u
        with open(os.path.join(d, f"{u:03x}.0"), "wb") as f:
            f.write(rows[sel].tobytes())
        out.append((d, np.arange(u, V, units)))
    return out


def window_probes(fleet, inactivity: int) -> np.ndarray:
    """Per vehicle, its probes in windows of two points or more (a window
    ends at a gap over ``inactivity`` seconds)."""
    t = fleet.time
    new = np.ones(len(t), bool)
    new[1:] = (fleet.vehicle[1:] != fleet.vehicle[:-1]) | \
        (np.diff(t) > inactivity)
    seg = np.cumsum(new) - 1
    size = np.bincount(seg)
    first = np.flatnonzero(new)
    counted = np.where(size >= 2, size, 0)
    return np.bincount(fleet.vehicle[first], weights=counted,
                       minlength=fleet.vehicles)


class TimedMatcher:
    """The matcher ``match_traces`` is handed: the program's, with the
    seconds inside ``match_many`` summed and a harness span around each
    call."""

    def __init__(self, matcher):
        self.matcher = matcher
        self.seconds = 0.0

    def match_many(self, traces):
        t0 = time.perf_counter()
        with devtrace.span("match_many"):
            out = self.matcher.match_many(traces)
        self.seconds += time.perf_counter() - t0
        return out


def read_rows(root: str) -> Counter:
    """{(tile file, row fields): count} of a row directory; numeric
    fields as floats."""
    out = Counter()
    for dirpath, _d, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            with open(path) as f:
                for line in f:
                    out[(rel, row_key(line))] += 1
    return out


def row_key(line: str) -> tuple:
    parts = line.rstrip("\n").split(",")
    return tuple(float(x) for x in parts[:8]) + tuple(parts[8:])


def vehicle_tasks(fleet, vehicles, pipe: dict) -> list:
    """Reference tasks (lat, lon, times, pipe) of ``vehicles``."""
    out = []
    for v in vehicles:
        lo, hi = fleet.offsets[v], fleet.offsets[v + 1]
        out.append((fleet.lat[lo:hi], fleet.lon[lo:hi],
                    fleet.time[lo:hi].astype(np.float64), pipe))
    return out


def reference_rows(tiles_list: list) -> Counter:
    """{(tile file, row fields): count} of the reference's tile rows of
    a set of vehicles ({tile file: [row, ...]} each)."""
    out = Counter()
    for tiles in tiles_list:
        for tile, rows in tiles.items():
            for row in rows:
                out[(tile, row_key(row))] += 1
    return out


def mismatched_rows(got: Counter, want: Counter) -> tuple:
    """(rows that one side has and the other lacks, each copy counted,
    reference rows): a missing row, a surplus row and a row written
    twice each count one."""
    return (sum(abs(got.get(k, 0) - want.get(k, 0))
                for k in set(got) | set(want)), sum(want.values()))


def card_busy(summary, probes: float) -> dict:
    """``card_busy_ns_per_probe``: the card's busy time over the window
    (the union of its kernels, copies and memsets) per probe counted;
    nothing where the card did no work (a run off the card)."""
    if summary is None or summary.busy_s <= 0 or probes <= 0:
        return {}
    return {"card_busy_ns_per_probe": summary.busy_s * 1e9 / probes}


def run(env) -> bench.Outcome:
    import torch

    from reporter_tpu_torch.graph.network import network_from_arrays
    from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
    from reporter_tpu_torch.obs import profiler
    from reporter_tpu_torch.pipeline.simple_reporter import match_traces
    from reporter_tpu_torch.utils import metrics

    cfg, cell, mix = env.config, env.cell, env.mix
    pipe = cfg["pipeline"]
    arrays = build_grid_city(**cfg["city"])
    matcher = SegmentMatcher(network_from_arrays(arrays),
                             MatchParams(**cfg["matcher"]), device=env.device,
                             **cfg.get("runtime", {}))
    env.lap("matcher built")
    grid = grid_of(cfg)
    fleet = traffic.fleet(mix, grid, env.seed)
    units = stage_units(fleet, int(cell["units"]),
                        os.path.join(env.rundir, "units"))
    probes_of = window_probes(fleet, pipe["inactivity"])
    warm_mix = dict(mix, vehicles=int(cell["warm_vehicles"]))
    warm = traffic.fleet(warm_mix, grid, env.seed, stream=1)
    warm_units = stage_units(warm, int(cell["warm_units"]),
                             os.path.join(env.rundir, "warm"))
    env.lap("traffic staged")
    proxy = TimedMatcher(matcher)

    def call(unit_dir):
        return match_traces(
            unit_dir, proxy, pipe["mode"], set(pipe["report_levels"]),
            set(pipe["transition_levels"]), pipe["quantisation"],
            pipe["inactivity"], pipe["source"], pipe["threshold_sec"],
            pipe["device_batch"])

    for d, _v in warm_units:
        shutil.rmtree(call(d))
    env.sync()

    env.lap("warm")
    done = []          # (unit index, row directory)
    probes = [0.0]

    def do_unit(u):
        d, vehicles = units[u]
        with devtrace.span("match_traces"):
            done.append((u, call(d)))
        probes[0] += float(probes_of[vehicles].sum())

    metrics.default.reset()
    stage0 = dict(matcher.stage_seconds)
    shapes0 = {(s["B"], s["T"], s["K"]): s["dispatches"]
               for s in profiler.snapshot()["shapes"]}
    proxy.seconds = 0.0
    # the card is traced in every run on it: its busy time is an
    # end-to-end metric
    with devtrace.traced(env.trace or env.on_card, env.on_card) as tr:
        with devtrace.span("window"):
            t0, elapsed, n_units = bench.timed_units(
                itertools.cycle(range(len(units))), do_unit, env.seconds)
            env.sync()
    setup_s = t0 - env.t_start
    peak = env.memory_peak()
    snap = metrics.snapshot()
    shapes = [(s["B"], s["T"], s["K"],
               s["dispatches"] - shapes0.get((s["B"], s["T"], s["K"]), 0))
              for s in profiler.snapshot()["shapes"]]
    obs = bench.Obs(
        window_s=elapsed, work=probes[0], counters=snap["counters"],
        timers=snap["timers"],
        stage_seconds={k: matcher.stage_seconds[k] - stage0[k]
                       for k in stage0},
        spans={"match_many": proxy.seconds},
        shapes=[s for s in shapes if s[3] > 0], device=tr.summary)
    attempted = int(snap["counters"].get("pipeline.windows", 0))
    matcher.close()
    del matcher, proxy
    gc.collect()
    if env.on_card:
        torch.cuda.empty_cache()

    # judge whole units drawn from the seed among those the window ran
    # (a unit run twice is judged on its first run)
    rng = np.random.default_rng([env.seed % 2 ** 64, 0x1d9e])
    first = {}
    for u, rows_dir in done:
        first.setdefault(u, rows_dir)
    ran = sorted(first)
    picked = sorted(rng.choice(ran, min(cell["judge"]["units"], len(ran)),
                               replace=False).tolist())
    got = [read_rows(first[u]) for u in picked]
    for _u, rows_dir in done:
        shutil.rmtree(rows_dir, ignore_errors=True)
    from ..ref.pool import ReferencePool
    with ReferencePool(arrays, cfg["matcher"]) as pool:
        outs = pool.rows(vehicle_tasks(
            fleet, [v for u in picked for v in units[u][1]], pipe))
    wrong = total = 0
    for u, rows in zip(picked, got):
        n = len(units[u][1])
        w, t = mismatched_rows(rows, reference_rows(outs[:n]))
        outs = outs[n:]
        wrong += w
        total += t
    share = wrong / total if total else 1.0
    return bench.Outcome(
        e2e=card_busy(tr.summary, probes[0]), setup_s=setup_s,
        attempted=attempted, failed=0,
        checks=[("rows_mismatch_share", share,
                 env.limits()["rows_mismatch_share"])],
        memory_peak_bytes=peak, obs=obs)
