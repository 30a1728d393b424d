"""The controls of ``correct``: the reference itself, put in the program's
place, at the precision below the configuration's (the decode's wire in
float8 e5m2 instead of float16), judged by the same comparison a run
makes against the reference at the configuration's precision.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3

prints one JSON line per seed with the control's reading and the cell's
limit: a limit that holds has the control above it. It runs at the cell's
own size on the cell's own traffic, with no window: for a replay cell
every vehicle of whole units drawn from the seed among its first 16; for
a ``/report`` cell the requests a run would judge; for the worker cell
windows of the stream cut as the batcher cuts its first report of each vehicle (the
first point at least 60 s, 10 points and 500 m from the window's start).
The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    __package__ = "portbench"

from portbench.entries import replay  # noqa: E402
from portbench.lib import bench, traffic  # noqa: E402
from portbench.ref.city import build_grid_city  # noqa: E402
from portbench.ref.geo import equirectangular_m  # noqa: E402
from portbench.ref.match import same_answer  # noqa: E402
from portbench.ref.pool import ReferencePool  # noqa: E402

CONTROL = "float8_e5m2"
#: the requests a ``/report`` run answers in its window come from the
#: front of the stream: the control draws its sample from these
REPORT_FRONT = 5000


def both(arrays, params, run):
    """``run(pool)`` on the reference at the configuration's precision
    and at the control's: (sound, control)."""
    out = []
    for precision in ("float16", CONTROL):
        with ReferencePool(arrays, params, precision) as pool:
            out.append(run(pool))
    return out


def replay_reading(env, arrays) -> float:
    cfg, cell = env.config, env.cell
    pipe = cfg["pipeline"]
    fl = traffic.fleet(env.mix, replay.grid_of(cfg), env.seed)
    rng = np.random.default_rng([env.seed % 2 ** 64, 0x1d9e])
    units = int(cell["units"])
    picked = rng.choice(min(units, 16), min(cell["judge"]["units"], units),
                        replace=False).tolist()
    tasks = replay.vehicle_tasks(
        fl, [v for u in picked for v in range(u, fl.vehicles, units)], pipe)
    sound, control = both(arrays, cfg["matcher"],
                          lambda pool: pool.rows(tasks))
    wrong, total = replay.mismatched_rows(replay.reference_rows(control),
                                          replay.reference_rows(sound))
    return wrong / total


def first_report_windows(fl, bt: dict) -> list:
    """Per vehicle, its first window as the batcher reports it: from its
    first probe to the first probe at least ``report_min_s`` seconds,
    ``report_min_points`` points and ``report_min_m`` metres out."""
    out = []
    for v in range(fl.vehicles):
        a, b = int(fl.offsets[v]), int(fl.offsets[v + 1])
        sep = np.atleast_1d(equirectangular_m(fl.lat[a:b], fl.lon[a:b],
                                              fl.lat[a], fl.lon[a]))
        ok = ((fl.time[a:b] - fl.time[a] >= bt["report_min_s"])
              & (np.arange(b - a) + 1 >= bt["report_min_points"])
              & (np.maximum.accumulate(sep) >= bt["report_min_m"]))
        if ok.any():
            out.append((v, a, a + int(np.argmax(ok)) + 1))
    return out


def answers_reading(env, arrays, fl, wins, args) -> float:
    rng = np.random.default_rng([env.seed % 2 ** 64, 0x1d9e])
    n = min(int(env.cell["judge"]["requests"]), len(wins))
    tasks = [(fl.lat[a:b], fl.lon[a:b], fl.time[a:b].astype(np.float64),
              *args) for _v, a, b in
             (wins[k] for k in rng.choice(len(wins), n, replace=False))]
    sound, control = both(arrays, env.config["matcher"],
                          lambda pool: pool.answers(tasks))
    return sum(not same_answer(c, s)
               for c, s in zip(control, sound)) / len(tasks)


def reading(env) -> float:
    cfg = env.config
    arrays = build_grid_city(**cfg["city"])
    entry = env.cell["entry"]
    if entry == "replay":
        return replay_reading(env, arrays)
    fl = traffic.fleet(env.mix, replay.grid_of(cfg), env.seed)
    if entry == "report":
        sv = cfg["service"]
        wins = traffic.windows(fl, env.mix).tolist()[:REPORT_FRONT]
        args = (sv["threshold_sec"], sv["report_levels"],
                sv["transition_levels"])
    else:
        wk = cfg["worker"]
        wins = first_report_windows(fl, cfg["batcher"])
        args = (wk["threshold_sec"],
                [int(x) for x in wk["reports"].split(",")],
                [int(x) for x in wk["transitions"].split(",")])
    return answers_reading(env, arrays, fl, wins, args)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        env = bench.Env(args.workload, seed, 0.0, False, t0, os.getcwd(),
                        "cpu")
        value = reading(env)
        check, limit = next(iter(env.limits().items()))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": CONTROL, "check": check,
                          "value": value, "limit": limit,
                          "fails": value > limit,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
