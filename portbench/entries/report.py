"""The ``/report`` front door: ``POST /report`` from closed-loop clients.

Set-up builds the configuration's city, the program's matcher and
``ReporterService`` on the card behind its HTTP server (``serve``: the
handler pool, the dispatcher), and the mix's requests from the run seed:
each vehicle's probes cut into report windows, sent in the order of
their last probe's time. The load generator (``lib/client.py``) runs in a
process of its own: ``clients`` connections, each waiting for its
answer before it sends again. It first sends the warm requests, a second
fleet drawn from another stream of the seed, once each; then the timed
requests in turn for ``--seconds``.

``report_requests_per_s`` counts the answers with status 200 over the
window, from the first timed send to the last answer; a refused or failed
request is attempted and failed. After the window a sample of the 200
answers drawn from the seed, the longest request among them, is judged:
each answer's datastore reports must equal the reference's for the
request's points (``answers_mismatch_share``).

No cell of ``BENCHMARK.json`` runs this entry yet: the streaming
deployment it served wants a sourced graph and fleet first (PERF.md,
Open questions). Its CPU tests hold it on a small configuration.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

from ..lib import bench, devtrace, traffic
from ..ref.city import build_grid_city
from .replay import UUID_DIGITS, UUID_PREFIX, grid_of

#: seconds a client process may take beyond its window before it is
#: stopped and the run fails
CLIENT_GRACE_S = 120


def bodies(fl, wins, opts: dict) -> list:
    """Request bodies (JSON strings) of the windows ``wins``."""
    out = []
    lat, lon, tm = fl.lat.tolist(), fl.lon.tolist(), fl.time.tolist()
    for v, a, b in wins.tolist():
        out.append(json.dumps({
            "uuid": f"{UUID_PREFIX}{v:0{UUID_DIGITS}d}",
            "trace": [{"lat": lat[i], "lon": lon[i], "time": tm[i],
                       "accuracy": fl.accuracy} for i in range(a, b)],
            "match_options": opts}, separators=(",", ":")))
    return out


def run(env) -> bench.Outcome:
    import torch

    from reporter_tpu_torch.graph.network import network_from_arrays
    from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
    from reporter_tpu_torch.service.server import ReporterService, serve
    from reporter_tpu_torch.utils import metrics

    cfg, cell, mix = env.config, env.cell, env.mix
    sv = cfg["service"]
    opts = {"mode": sv["mode"], "report_levels": sv["report_levels"],
            "transition_levels": sv["transition_levels"]}
    arrays = build_grid_city(**cfg["city"])
    matcher = SegmentMatcher(network_from_arrays(arrays),
                             MatchParams(**cfg["matcher"]), device=env.device,
                             **cfg.get("runtime", {}))
    service = ReporterService(matcher, threshold_sec=sv["threshold_sec"])
    httpd = serve(service, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/report"
    env.lap("matcher built")
    grid = grid_of(cfg)
    fleet = traffic.fleet(mix, grid, env.seed)
    wins = traffic.windows(fleet, mix)
    warm_mix = dict(mix, vehicles=int(cell["warm_vehicles"]))
    warm = traffic.fleet(warm_mix, grid, env.seed, stream=1)
    reqs = {"warm": bodies(warm, traffic.windows(warm, warm_mix), opts),
            "timed": bodies(fleet, wins, opts)}
    reqs_path = os.path.join(env.rundir, "requests.json")
    out_path = os.path.join(env.rundir, "answers.json")
    with open(reqs_path, "w") as f:
        json.dump(reqs, f)

    env.lap("traffic staged")
    with devtrace.traced(env.trace, env.on_card) as tr:
        proc = subprocess.Popen(
            [sys.executable, "-m", "portbench.lib.client", url, reqs_path,
             out_path, str(cell["clients"]), "1", str(env.seconds)],
            cwd=bench.ROOT)
        try:
            deadline = time.monotonic() + cell["warm_limit_s"]
            while not os.path.exists(out_path + ".timed"):
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise RuntimeError("the client never began its window")
                time.sleep(0.001)
            # the warm answers are all in: count the timed phase alone
            metrics.default.reset()
            with devtrace.span("window"):
                rc = proc.wait(timeout=env.seconds + CLIENT_GRACE_S)
                env.sync()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if rc != 0:
        raise RuntimeError(f"the client process exited {rc}")
    with open(out_path) as f:
        res = json.load(f)
    answers = res["answers"]
    t0 = res["t0"]
    t_end = max(a[3] for a in answers)
    elapsed = t_end - t0
    ok = [a for a in answers if a[1] == 200]
    setup_s = t0 - env.t_start
    peak = env.memory_peak()
    snap = metrics.snapshot()
    lat_ms = sorted((a[3] - a[2]) * 1e3 for a in answers)
    obs = bench.Obs(window_s=elapsed, work=float(len(ok)),
                    counters=snap["counters"], timers=snap["timers"],
                    device=tr.summary, extra={"latency_ms": lat_ms})
    httpd.shutdown()
    httpd.server_close()
    service.dispatcher.close()
    matcher.close()
    del service, matcher
    gc.collect()
    if env.on_card:
        torch.cuda.empty_cache()

    share = judge(env, arrays, fleet, wins, ok)
    return bench.Outcome(
        e2e={"report_requests_per_s": len(ok) / elapsed}, setup_s=setup_s,
        attempted=len(answers), failed=len(answers) - len(ok),
        checks=[("answers_mismatch_share", share,
                 env.limits()["answers_mismatch_share"])],
        memory_peak_bytes=peak, obs=obs)


def judge(env, arrays, fleet, wins, ok) -> float:
    """The share of a seeded sample of the 200 answers (the longest
    request's among them) whose answer (stats, shape_used, datastore
    reports) differs from the reference's for the request's points; 1.0 with no 200 answer."""
    from ..ref.match import same_answer
    from ..ref.pool import ReferencePool
    if not ok:
        return 1.0
    sv = env.config["service"]
    rng = np.random.default_rng([env.seed % 2 ** 64, 0x1d9e])
    n = min(int(env.cell["judge"]["requests"]), len(ok))
    pick = set(rng.choice(len(ok), n, replace=False).tolist())
    size = [int(np.diff(wins[a[0] % len(wins), 1:])[0]) for a in ok]
    pick.add(int(np.argmax(size)))
    tasks, got = [], []
    for k in sorted(pick):
        _v, a, b = wins[ok[k][0] % len(wins)].tolist()
        tasks.append((fleet.lat[a:b], fleet.lon[a:b],
                      fleet.time[a:b].astype(np.float64),
                      sv["threshold_sec"], sv["report_levels"],
                      sv["transition_levels"]))
        got.append(json.loads(ok[k][4]))
    with ReferencePool(arrays, env.config["matcher"]) as pool:
        wants = pool.answers(tasks)
    return sum(not same_answer(g, w) for g, w in zip(got, wants)) / len(pick)
