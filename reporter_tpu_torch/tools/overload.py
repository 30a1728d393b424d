"""The overload proof: admission control keeps p99 inside the SLO.

The port of the JAX repo's ``tools/overload.py``. An open-loop arrival
generator (arrivals keep coming whether or not responses return; a
closed loop self-throttles and hides the queue) drives the port's real
service stack at a multiple of its measured capacity, twice:

  unshed  admission off, dispatcher queue unbounded. Every request is
          admitted, the queue grows for the whole leg, and p99 blows
          through the SLO budget: the leg MUST breach, or the harness
          has no overload to prove anything about.
  armed   ``admission: true`` and a bounded queue. The gate sheds at the
          door with 429 and Retry-After; the requests it ADMITS ride a
          bounded queue and must meet the budget.

Gates (all hard):
  - armed-leg p99 over admitted (200) responses <= the SLO budget;
  - armed-leg goodput (200s inside the budget, per second) >= the
    unshed leg's: shedding must BUY something;
  - the unshed leg breaches the same budget (the control);
  - zero silent loss: every arrival is a 200, a counted 429 carrying a
    positive ``retry_after_s``, or a counted error, and the shed
    counters (``admission.shed.*`` and ``dispatch.queue.{rejected,
    evicted}``) cover every 429;
  - the pressure ladder stepped down at least one rung in the armed leg.

Usage::

    python -m reporter_tpu_torch.tools.overload [--device cuda|cpu]
        [--smoke] [--duration S] [--factor F] [--service-floor-ms MS]
        [--out overload.json]

``--smoke`` is the short shape (4 s legs, rate clamped at 80/s). The
device is ``cuda`` unless ``--device cpu`` is given; without a card the
tool raises. ``--service-floor-ms`` (default 20) adds a deterministic
per-trace service time around the real match call, the stand-in for a
device's decode cost, so capacity, and with it the proof, does not hang
on how fast the host is; 0 runs the raw stack, whose rate clamp (150/s,
80/s with ``--smoke``) may sit below a card's capacity, and then the
control leg cannot breach. The artifact records both legs;
``tools/chaos.py``'s ``overload_recovery`` proves the recovery half.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time

#: the gates of :func:`check_gates` that read only the accounting of
#: every arrival; the others ("unshed_breach", "armed_p99", "goodput",
#: "admitted", "ladder") read latencies, rates or whether shedding was
#: sustained, and so how fast the host runs the match
ACCOUNTING_GATES = ("errors", "retry_after", "silent_loss", "reconcile")


def log(msg: str) -> None:
    print(f"overload: {msg}", flush=True)


def fail(msg: str) -> int:
    sys.stderr.write(f"overload: FAIL: {msg}\n")
    return 1


def _city():
    from ..synth import build_grid_city
    return build_grid_city(rows=10, cols=10, spacing_m=200.0, seed=11,
                           service_road_fraction=0.0, internal_fraction=0.0)


def _requests(city, n: int):
    import numpy as np

    from ..synth import generate_trace
    out = []
    seed = 0
    while len(out) < n:
        seed += 1
        rng = np.random.default_rng(seed)
        tr = generate_trace(city, f"veh-{seed}", rng, noise_m=3.0,
                            min_route_edges=6)
        if tr is None:
            continue
        out.append({"uuid": tr.uuid, "trace": tr.points,
                    "match_options": {"mode": "auto",
                                      "report_levels": [0, 1],
                                      "transition_levels": [0, 1]}})
    return out


def _fresh_service(matcher, max_batch: int, floor_per_trace_s: float = 0.0,
                   **knobs):
    """A fresh ReporterService (a fresh dispatcher and gate, built from
    ``knobs``, the service config's keys) over a shared, warm matcher.

    ``floor_per_trace_s`` adds a deterministic per-trace service-time
    floor around the REAL match call: the stand-in for device decode
    cost. The control plane under test (gate, EWMA model, bounded queue,
    ladder) sees what it would see there, while a small host reaches
    saturation at a few hundred open-loop threads. ``0`` runs the raw
    stack."""
    from ..service.server import ReporterService
    service = ReporterService(matcher, threshold_sec=15,
                              max_batch=max_batch, max_wait_ms=10.0, **knobs)
    if floor_per_trace_s > 0.0:
        orig = service.dispatcher._match_many

        def floored(batch):
            time.sleep(floor_per_trace_s * len(batch))
            return orig(batch)

        service.dispatcher._match_many = floored
    return service


def _call(service, trace):
    """One request through the gate -> handle -> release path the HTTP
    handler runs; returns (status, retry_after_s or None, latency_s)."""
    t0 = time.monotonic()
    gate = service.admission
    if gate is not None:
        shed = gate.admit()
        if shed is not None:
            return 429, shed.retry_after_s, time.monotonic() - t0
    try:
        code, body = _handle_timed(service, dict(trace))
    finally:
        if gate is not None:
            gate.release()
    retry = None
    if code == 429:  # the bounded-queue backstop inside handle()
        retry = json.loads(body).get("retry_after_s")
    return code, retry, time.monotonic() - t0


def _handle_timed(service, trace):
    """service.handle under the stage timer the HTTP handler uses, so the
    gate's windowed-p99 SLO sensor sees the histogram a deployment
    feeds it."""
    from ..utils import metrics
    with metrics.timer("service.handle"):
        return service.handle(trace)


def _warm(service, reqs, n: int = 4) -> None:
    """Prime a fresh leg's dispatcher EWMA (and the windowed SLO sensor)
    with a few sequential requests, outside the measurement: a gate with
    no service-time estimate cannot run its deadline check, and a real
    fleet is never cold when the spike arrives. The batched warm-ups
    cover the batch shapes the open loop will form."""
    for size in (1, 2, 3, 4, 6, 8, 16, 32):
        service.dispatcher.submit_many([dict(r) for r in reqs[:size]])
    for req in reqs[:n]:
        _call(service, req)


def _open_loop(service, reqs, rate_hz: float, n: int):
    """Fire ``n`` arrivals at a fixed open-loop rate, one thread per
    arrival (arrivals never wait for responses); returns the result list
    [(status, retry_after_s, latency_s)]."""
    results = []
    res_lock = threading.Lock()

    def one(req):
        got = _call(service, req)
        with res_lock:
            results.append(got)

    threads = []
    t0 = time.monotonic()
    for i in range(n):
        wait = (t0 + i / rate_hz) - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        th = threading.Thread(target=one, args=(reqs[i % len(reqs)],),
                              daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=120.0)
    alive = sum(1 for th in threads if th.is_alive())
    if alive:
        raise RuntimeError(f"{alive} requests never completed")
    return results


def _p99(latencies):
    if not latencies:
        return None
    ordered = sorted(latencies)
    return ordered[min(len(ordered) - 1,
                       max(0, int(0.99 * len(ordered)) - 1))]


def _leg_stats(results, budget_s: float, wall_s: float) -> dict:
    oks = [r for r in results if r[0] == 200]
    sheds = [r for r in results if r[0] == 429]
    errors = [r for r in results if r[0] not in (200, 429)]
    ok_lat = [r[2] for r in oks]
    in_budget = sum(1 for lt in ok_lat if lt <= budget_s)
    return {
        "sent": len(results),
        "ok": len(oks),
        "shed": len(sheds),
        "errors": len(errors),
        "shed_missing_retry_after": sum(
            1 for r in sheds if not r[1] or r[1] <= 0),
        "p50_ms": round(sorted(ok_lat)[len(ok_lat) // 2] * 1000.0, 1)
        if ok_lat else None,
        "p99_ms": round(_p99(ok_lat) * 1000.0, 1) if ok_lat else None,
        "goodput_per_s": round(in_budget / wall_s, 2),
        "in_budget": in_budget,
    }


def measure(device, smoke: bool = False, duration=None, factor: float = 2.0,
            max_requests: int = 600, service_floor_ms: float = 20.0) -> dict:
    """Calibrate, then run the unshed and the armed leg; the artifact."""
    from ..matcher import SegmentMatcher
    from ..obs import slo
    from ..service import admission
    from ..utils import metrics

    floor_s = max(0.0, service_floor_ms / 1000.0)
    duration = duration if duration is not None else (4.0 if smoke else 8.0)
    city = _city()
    matcher = SegmentMatcher(city, device=device)
    reqs = _requests(city, 24)
    try:
        # ---- calibration: sequential closed loop, admission off ------
        slo.configure("")
        service = _fresh_service(matcher, max_batch=32,
                                 floor_per_trace_s=floor_s)
        for req in reqs[:4]:   # warm the caches out of the timing
            _call(service, req)
        t0 = time.monotonic()
        n_cal = 24
        for i in range(n_cal):
            code, _retry, _lat = _call(service, reqs[i % len(reqs)])
            if code != 200:
                raise RuntimeError(f"calibration request failed with {code}")
        mean_s = (time.monotonic() - t0) / n_cal
        service.dispatcher.close()
        capacity_hz = 1.0 / mean_s
        rate_hz = min(factor * capacity_hz, 80.0 if smoke else 150.0)
        n_arrivals = min(int(rate_hz * duration), max_requests)
        # SLO budget: generous against the unloaded mean (12x: room for
        # the bounded queue, the admitted request's own batch and a busy
        # host's jitter), tiny against the queue an unshed 2x leg builds
        budget_s = max(0.3, 12.0 * mean_s)
        budget_ms = int(budget_s * 1000.0)
        log(f"calibrated: mean {mean_s * 1000.0:.1f} ms -> capacity "
            f"{capacity_hz:.1f}/s; driving {rate_hz:.1f}/s x {n_arrivals} "
            f"arrivals, SLO {budget_ms} ms")

        artifact = {"kind": "overload",
                    "mean_service_ms": round(mean_s * 1000.0, 2),
                    "rate_hz": round(rate_hz, 2), "arrivals": n_arrivals,
                    "slo_budget_ms": budget_ms, "legs": {}}
        wall = n_arrivals / rate_hz

        # ---- leg 1: unshed (the control) -----------------------------
        metrics.default.reset()
        admission._reset_module()
        slo.configure(f"service.handle={budget_ms}")
        service = _fresh_service(matcher, max_batch=32,
                                 floor_per_trace_s=floor_s, queue_max=0)
        _warm(service, reqs)
        unshed = _leg_stats(_open_loop(service, reqs, rate_hz, n_arrivals),
                            budget_s, wall)
        service.dispatcher.close()
        artifact["legs"]["unshed"] = unshed
        log(f"unshed: {unshed}")

        # ---- leg 2: admission armed ----------------------------------
        metrics.default.reset()
        admission._reset_module()
        # bound the queue so even a full one drains inside about a third
        # of the budget; the in-flight backstop binds from the first
        # arrival (the deadline check needs an EWMA; this cap does not)
        qmax = max(6, int(0.35 * budget_s * capacity_hz))
        service = _fresh_service(
            matcher, max_batch=32, floor_per_trace_s=floor_s,
            queue_max=qmax, admission=True, pressure_hold_s=1.0,
            inflight_max=qmax,
            # latency-targeted micro-batching: batches shrink so no
            # admitted request hides behind a whole fixed-size batch
            latency_budget_ms=float(max(40, budget_ms // 4)))
        _warm(service, reqs)
        armed = _leg_stats(_open_loop(service, reqs, rate_hz, n_arrivals),
                           budget_s, wall)
        reg = metrics.default
        armed["counters"] = {
            name: reg.counter(name) for name in
            ("admission.admitted", "admission.shed.queue",
             "admission.shed.slo", "admission.shed.inflight",
             "admission.errors", "dispatch.queue.rejected",
             "dispatch.queue.evicted")}
        armed["pressure_level_seen"] = admission.current_level()
        service.dispatcher.close()
        artifact["legs"]["armed"] = armed
        log(f"armed: {armed}")
        return artifact
    finally:
        slo.configure("")
        admission._reset_module()
        matcher.close()


def check_gates(artifact: dict) -> list:
    """[(gate, message)] of every gate the artifact fails (empty: all
    pass), in the order the JAX harness checks them."""
    unshed, armed = artifact["legs"]["unshed"], artifact["legs"]["armed"]
    budget = artifact["slo_budget_ms"]
    out = []
    if unshed["errors"]:
        out.append(("errors", f"unshed leg had {unshed['errors']} hard "
                              f"errors"))
    if unshed["p99_ms"] is None or unshed["p99_ms"] <= budget:
        out.append(("unshed_breach",
                    f"unshed leg did not breach the SLO (p99 "
                    f"{unshed['p99_ms']} ms <= {budget} ms): no overload "
                    f"was generated; the armed leg proves nothing"))
    if armed["errors"]:
        out.append(("errors", f"armed leg had {armed['errors']} hard "
                              f"errors"))
    if armed["ok"] == 0:
        out.append(("admitted", "armed leg admitted nothing: the gate "
                                "sheds everything"))
    if armed["p99_ms"] is None or armed["p99_ms"] > budget:
        out.append(("armed_p99",
                    f"admitted-request p99 {armed['p99_ms']} ms breached "
                    f"the SLO budget {budget} ms with admission armed"))
    if armed["goodput_per_s"] < unshed["goodput_per_s"]:
        out.append(("goodput",
                    f"armed goodput {armed['goodput_per_s']}/s fell below "
                    f"unshed {unshed['goodput_per_s']}/s: shedding made "
                    f"things worse"))
    if armed["shed_missing_retry_after"]:
        out.append(("retry_after",
                    f"{armed['shed_missing_retry_after']} shed responses "
                    f"carried no positive Retry-After"))
    counted = sum(v for k, v in armed["counters"].items()
                  if k.startswith(("admission.shed.",
                                   "dispatch.queue.rejected",
                                   "dispatch.queue.evicted")))
    if counted < armed["shed"]:
        out.append(("silent_loss", f"{armed['shed']} sheds but only "
                                   f"{counted} counted"))
    if armed["sent"] != armed["ok"] + armed["shed"] + armed["errors"]:
        out.append(("reconcile",
                    f"armed leg arrivals do not reconcile: {armed['sent']} "
                    f"!= {armed['ok']} + {armed['shed']} + "
                    f"{armed['errors']}"))
    if armed["pressure_level_seen"] < 1:
        out.append(("ladder", "sustained shedding never stepped the "
                              "pressure ladder down a rung"))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m reporter_tpu_torch.tools.overload",
        description="open-loop overload proof of the admission gate")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default), cuda:I or cpu")
    parser.add_argument("--smoke", action="store_true",
                        help="short legs, clamped rate")
    parser.add_argument("--duration", type=float, default=None,
                        help="seconds per open-loop leg")
    parser.add_argument("--factor", type=float, default=2.0,
                        help="arrival rate as a multiple of capacity")
    parser.add_argument("--max-requests", type=int, default=600,
                        help="cap on arrivals per leg (thread bound)")
    parser.add_argument("--service-floor-ms", type=float, default=20.0,
                        help="deterministic per-trace service floor "
                             "(device-cost stand-in; 0 = raw stack)")
    parser.add_argument("--out", default=None,
                        help="write the artifact JSON here")
    args = parser.parse_args(argv)
    from .chaos import check_device
    device = check_device(args.device)

    artifact = measure(device, smoke=args.smoke, duration=args.duration,
                       factor=args.factor, max_requests=args.max_requests,
                       service_floor_ms=args.service_floor_ms)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(artifact, f, indent=1, sort_keys=True)
        log(f"artifact -> {args.out}")
    failures = check_gates(artifact)
    if failures:
        for _gate, msg in failures[1:]:
            sys.stderr.write(f"overload: also: {msg}\n")
        return fail(failures[0][1])
    armed, unshed = artifact["legs"]["armed"], artifact["legs"]["unshed"]
    log(f"ok: armed p99 {armed['p99_ms']} ms <= "
        f"{artifact['slo_budget_ms']} ms with goodput "
        f"{armed['goodput_per_s']}/s (unshed breached at "
        f"{unshed['p99_ms']} ms, goodput {unshed['goodput_per_s']}/s); "
        f"{armed['shed']} sheds, all counted, all with Retry-After")
    return 0


if __name__ == "__main__":
    sys.exit(main())
