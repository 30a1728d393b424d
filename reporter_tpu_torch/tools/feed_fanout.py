"""The change feed's fan-out proof: N concurrent bbox subscribers against
a pre-fork fleet while a writer commits.

At least 1,000 concurrent ``/feed`` long-polls held open across a
``SO_REUSEPORT`` pre-fork fleet (``service/prefork.py``), one measured
store commit, and every subscriber accounted for: it received the event,
was shed with the explicit 429 and ``Retry-After``, or failed loudly.
``silent_lost`` (a subscriber that saw neither the event nor a shed by
its deadline) must be 0: the feed's cursor replay over its event ring
means a subscriber shed and retried still receives the commit it missed.

Method, in one fresh interpreter: a seed flush lands in a temporary
store, the fleet forks with the freshness tier on, a priming loop makes
one paced watcher scan happen on every worker (so each worker's
store-watcher baseline predates the measured commit), N subscriber
threads open world-bbox long-polls from ``cursor=0``, and the writer
commits once at T0. A subscriber's delivery latency is its receipt time
less T0; the line reports p50 and p99 and ``fanout_ratio = delivered /
subscribers``. Each worker's service holds its ``SegmentMatcher`` on
``--device`` (``cuda`` unless ``--device cpu``); the fleet's parent
touches no CUDA before it forks.

Prints one JSON line::

    {"kind": "feed_fanout", "waiter_cap": W, "pool": P, "subscribers": N,
     "procs": P, "delivered": D, "shed": S, "shed_events": SE,
     "errors": E, "error_kinds": {...}, "silent_lost": 0,
     "delivery_p50_ms": ..., "delivery_p99_ms": ..., "fanout_ratio": D/N}

Usage::

    python -m reporter_tpu_torch.tools.feed_fanout [--feed-fanout 1000]
        [--procs 2] [--waiters 400] [--pool 700] [--ramp 6]
        [--deadline 60] [--min-fanout 0] [--out FILE] [--events FILE]
        [--device cpu]

``--waiters`` caps each worker's feed waiter table below its subscriber
share on purpose: the run must take the shed path (``shed_events`` > 0 at
full scale) and still close the accounting. ``--min-fanout R`` gates the
run: exit 1 when ``fanout_ratio`` < R; ``silent_lost`` or ``errors`` > 0
always fail it. ``--events FILE`` writes each delivered subscriber's
events, one JSON list a line.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
#: the store watcher's pace in the fleet: delivery latency measures the
#: fan-out, not the scan timer
WATCH_POLL_S = 0.1
#: seconds the whole child may run
CHILD_TIMEOUT_S = 900
#: the commit's partition (level 2) and its segments
T0H = 1483344000  # Monday 08:00 UTC


def _flush(n: int, start: int):
    from ..core.osmlr import make_segment_id
    from ..core.types import Segment
    sid = make_segment_id(2, 756425, 10)
    nid = make_segment_id(2, 756425, 11)
    return [Segment(sid, nid, start + i * 30, start + i * 30 + 10.0, 100,
                    0) for i in range(n)]


def _pct(lat_ms: list, p: float):
    if not lat_ms:
        return None
    return round(lat_ms[min(len(lat_ms) - 1, int(p / 100 * len(lat_ms)))],
                 1)


def _drive(cfg: dict, base: str, writer, result: dict) -> None:
    """The measured leg, run beside the fleet's supervisor: prime every
    worker, open the subscribers, commit once, account for each."""
    deadline = time.time() + 240
    while True:
        try:
            urllib.request.urlopen(base + "/stats", timeout=5).read()
            break
        except Exception:
            if time.time() > deadline:
                result["err"] = "service never came up"
                return
            time.sleep(0.3)

    # prime every worker's store watcher: a poll of at least one pace
    # slice scans on whichever worker answered, and its first scan is the
    # silent baseline; a worker that baselined after the commit would
    # fold it into its baseline and never publish it
    primed = set()
    for _ in range(400):
        with urllib.request.urlopen(base + "/feed?cursor=-1&timeout=0.5",
                                    timeout=30) as r:
            r.read()
            tag = r.headers.get("X-Reporter-Proc", "p?")
        primed.add(tag.split(":")[0])
        if len(primed) >= cfg["procs"]:
            break
    if len(primed) < cfg["procs"]:
        result["err"] = f"primed only {sorted(primed)} of {cfg['procs']}"
        return

    n = cfg["subscribers"]
    lock = threading.Lock()
    lat = []
    states = {"delivered": 0, "shed": 0, "error": 0, "silent": 0}
    shed_events = [0]
    errs: dict = {}
    events: list = []
    t0_box = [None]

    def subscriber(i: int) -> None:
        cursor, sheds = 0, 0
        stop = time.monotonic() + cfg["deadline"]
        outcome = "silent"
        while time.monotonic() < stop:
            url = (base + f"/feed?cursor={cursor}"
                   "&bbox=-180,-90,180,90&level=2&timeout=10")
            try:
                with urllib.request.urlopen(url, timeout=40) as r:
                    body = json.loads(r.read())
            except urllib.error.HTTPError as e:
                if e.code == 429 and e.headers.get("Retry-After"):
                    # the explicit shed: back off (jittered, so the
                    # retries do not arrive together) and retry; the
                    # cursor replay recovers the missed event
                    sheds += 1
                    time.sleep(0.2 + (i % 20) * 0.05)
                    continue
                outcome = "error"
                key = f"http {e.code}"
                with lock:
                    errs[key] = errs.get(key, 0) + 1
                break
            except Exception as e:
                outcome = "error"
                with lock:
                    key = type(e).__name__
                    errs[key] = errs.get(key, 0) + 1
                break
            cursor = body["cursor"]
            if body["events"]:
                t = time.monotonic()
                outcome = "delivered"
                with lock:
                    if t0_box[0] is not None:
                        lat.append(t - t0_box[0])
                    events.append(body["events"])
                break
        if outcome == "silent" and sheds:
            outcome = "shed"  # never delivered, but never silent
        with lock:
            states[outcome] += 1
            shed_events[0] += sheds

    threads = [threading.Thread(target=subscriber, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    time.sleep(cfg["ramp"])  # let the long-polls establish

    t0_box[0] = time.monotonic()
    writer.ingest_segments(_flush(3, T0H + 3600), ingest_key="fanout-live")
    for t in threads:
        t.join(timeout=cfg["deadline"] + 60)
    if any(t.is_alive() for t in threads):
        result["err"] = "subscriber threads outlived their deadline"
        return

    lat_ms = sorted(x * 1000 for x in lat)
    result.update(
        subscribers=n, procs=cfg["procs"], device=cfg["device"],
        delivered=states["delivered"], shed=states["shed"],
        shed_events=shed_events[0], errors=states["error"],
        error_kinds=errs, silent_lost=states["silent"],
        delivery_p50_ms=_pct(lat_ms, 50), delivery_p99_ms=_pct(lat_ms, 99),
        fanout_ratio=round(states["delivered"] / n, 4))
    if cfg.get("events"):
        with open(cfg["events"], "w", encoding="utf-8") as f:
            for ev in events:
                f.write(json.dumps(ev, separators=(",", ":")) + "\n")


def child_main(cfg: dict) -> int:
    """The fleet's interpreter: seed the store, fork the workers, drive
    the subscribers from a thread of the supervisor, print ``FANOUT:``
    and the result."""
    from ..datastore import LocalDatastore
    from ..service.prefork import serve_prefork
    from ..synth import build_grid_city

    root = tempfile.mkdtemp(prefix="feed_fanout_")
    store_dir = str(Path(root) / "store")
    # the seed flush exists before the fleet forks: it is in every
    # worker's watcher baseline, so the only event the run can produce is
    # the measured commit
    writer = LocalDatastore(store_dir)
    writer.ingest_segments(_flush(5, T0H), ingest_key="fanout-seed")
    city = build_grid_city(rows=4, cols=4, spacing_m=200.0, seed=5,
                           service_road_fraction=0.0, internal_fraction=0.0)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = f"http://127.0.0.1:{port}"

    def make_service(slot: int, procs: int):
        from ..matcher import SegmentMatcher
        from ..service.server import ReporterService
        return ReporterService(
            SegmentMatcher(city, device=cfg["device"], prep_threads=1),
            datastore=LocalDatastore(
                store_dir, freshness_waiters=cfg["waiters"],
                freshness_poll_s=WATCH_POLL_S))

    result: dict = {}

    def drive() -> None:
        time.sleep(2.0)  # the workers fork from a quiet parent
        try:
            _drive(cfg, base, writer, result)
        except Exception as e:
            result["err"] = f"{type(e).__name__}: {e}"

    try:
        urllib.request.urlopen(base + "/stats", timeout=0.2)
    except Exception:
        pass  # warm the opener machinery before the fork, in this thread
    t = threading.Thread(target=drive, daemon=True)
    t.start()

    def reaper() -> None:
        t.join()
        os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=reaper, daemon=True).start()
    serve_prefork(make_service, "127.0.0.1", port, cfg["procs"], cfg["pool"])
    print("FANOUT:" + json.dumps(result), flush=True)
    return 0 if "err" not in result else 1


def run_fanout(subscribers: int, procs: int, waiters: int, pool: int,
               ramp: float, sub_deadline: float, device: str = "cuda",
               events: "str | None" = None) -> dict:
    """Run the fleet in a child interpreter; its result dict. Raises
    SystemExit when the child failed or reported an error."""
    cfg = {"subscribers": subscribers, "procs": procs, "waiters": waiters,
           "pool": pool, "ramp": ramp, "deadline": sub_deadline,
           "device": device, "events": events}
    proc = subprocess.run(
        [sys.executable, "-m", "reporter_tpu_torch.tools.feed_fanout",
         "--child", json.dumps(cfg)], cwd=REPO, capture_output=True,
        text=True, timeout=CHILD_TIMEOUT_S)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("FANOUT:")]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"fanout leg failed rc={proc.returncode}: "
                         f"{(proc.stdout + proc.stderr)[-2000:]}")
    out = json.loads(lines[-1][len("FANOUT:"):])
    if "err" in out:
        raise SystemExit(f"fanout leg: {out['err']}")
    return out


def check(art: dict, min_fanout: float = 0.0) -> list:
    """The run's failures (empty: it passed), the JAX harness's gates."""
    failures = []
    if art["silent_lost"]:
        failures.append(f"silent_lost {art['silent_lost']} != 0")
    if art["errors"]:
        failures.append(f"errors {art['errors']} != 0 "
                        f"({art['error_kinds']})")
    accounted = art["delivered"] + art["shed"] + art["errors"] \
        + art["silent_lost"]
    if accounted != art["subscribers"]:
        failures.append(f"accounting open: {accounted} != "
                        f"{art['subscribers']} subscribers")
    if min_fanout and art["fanout_ratio"] < min_fanout:
        failures.append(f"fanout_ratio {art['fanout_ratio']} < floor "
                        f"{min_fanout}")
    return failures


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m reporter_tpu_torch.tools.feed_fanout",
        description=__doc__.splitlines()[0])
    parser.add_argument("--feed-fanout", dest="subscribers", type=int,
                        default=1000, metavar="N",
                        help="concurrent bbox subscribers (default 1000)")
    parser.add_argument("--procs", type=int, default=2)
    parser.add_argument("--waiters", type=int, default=400,
                        help="each worker's feed waiter cap; below its "
                             "subscriber share so the shed path runs")
    parser.add_argument("--pool", type=int, default=700,
                        help="each worker's server thread pool")
    parser.add_argument("--ramp", type=float, default=6.0,
                        help="seconds between the subscribers' start and "
                             "the measured commit")
    parser.add_argument("--deadline", type=float, default=60.0,
                        help="each subscriber's overall deadline, s")
    parser.add_argument("--min-fanout", type=float, default=0.0,
                        help="fail below this fanout_ratio (loss and "
                             "errors always fail)")
    parser.add_argument("--out", default=None)
    parser.add_argument("--events", default=None,
                        help="write each delivered subscriber's events "
                             "here, one JSON list a line")
    parser.add_argument("--device", default="cuda",
                        help="the workers' matcher device (default cuda)")
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child is not None:
        return child_main(json.loads(args.child))

    res = run_fanout(args.subscribers, args.procs, args.waiters, args.pool,
                     args.ramp, args.deadline, args.device, args.events)
    art = {"kind": "feed_fanout", "waiter_cap": args.waiters,
           "pool": args.pool, **res}
    body = json.dumps(art, separators=(",", ":"))
    print(body)
    if args.out:
        Path(args.out).write_text(body, encoding="utf-8")
    failures = check(art, args.min_fanout)
    for f in failures:
        sys.stderr.write(f"feed_fanout: FAIL: {f}\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
