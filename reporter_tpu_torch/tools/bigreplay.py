"""bigreplay: the multi-city chaos replay harness.

The port of the JAX repo's ``tools/bigreplay.py``. It generates a seeded
synthetic METRO of three city profiles with distinct failure textures:

  urban   dense 150 m grid, 12 m canyon noise (candidate ambiguity),
          1 Hz probes
  rural   sparse 800 m grid, light noise, 0.2 Hz probes (long gaps: the
          jitter and SKIP machinery's worst case)
  queue   mid grid with injected stop-and-go dwells (the queue-length
          detector's case)

and replays it through real multi-writer streaming workers (one
ReporterService a city shared by N writer workers, per-writer epoch tile
names, one SHARED histogram datastore fed by every worker's tee) twice:
a clean leg, then a chaos leg under a bounded fault storm
(``DEFAULT_FAULTS``, every error-kind failure domain) with the
dead-letter replayer armed.

Asserted, not just measured:

  * segment-ID agreement between the serving decode and the pure-numpy
    oracle (``matcher/cpu_ref.py``) >= ``--min-agreement`` on a trace
    sample;
  * END-TO-END EXACTLY-ONCE: the tee-fed datastore equals a fresh store
    built from the sinks' final tile trees cell for cell (count and
    speed sums), and re-ingesting every tile tree into the SAME store
    changes nothing (the manifest ledger dedupes every flush);
  * empty dead-letter spools after the replayer drains (the storm is
    bounded, so recovery must complete);
  * the chaos leg's throughput over the clean leg's, written to the
    artifact, at least ``MIN_FAULT_RATIO`` (0.2, the JAX repo's smoke
    floor).

In the port a failed decode chunk raises (the card's domains never
degrade to a host decode), so the storm's ``decode.dispatch`` errors
reach the streaming worker as failed submits: those traces go through
the bounded requeue, the dead letter and the replayer. The oracle is
forced by a matcher subclass inside this tool whose dispatch stage
decodes every chunk with ``cpu_ref``; nothing in the serving path calls
it.

Usage::

    python -m reporter_tpu_torch.tools.bigreplay [--device cuda|cpu]
        [--probes N] [--writers W] [--agreement-sample S]
        [--min-agreement A] [--out artifact.json]

The smoke scale is ``--probes 3000``; the paper scale ``--probes 1000000
--writers 4``. The device is ``cuda`` unless ``--device cpu`` is given;
without a card the tool raises.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

FMT = r",sv,\|,0,1,2,3,4"  # uuid|lat|lon|time|accuracy

#: the bounded default storm: every error-kind failure domain fires,
#: every site's storm ENDS (#limit), so the run must recover; crash
#: kinds live in tools/chaos.py, where a child process absorbs them
DEFAULT_FAULTS = ",".join([
    "decode.dispatch=error:0.5@3#10",
    "matcher.assemble=error:0.05@5#6",
    "native.prep=error:0.3@13#10",
    "matcher.submit=error:0.15@11#25",
    "egress.http=error:0.4@7#40",
    "datastore.commit=error:0.05@17#4",
])

#: (name, grid kwargs, noise_m, sample_period_s, queue_dwell): the three
#: textures; anchors far apart so tile indexes never collide across cities
CITY_PROFILES = [
    ("urban", dict(rows=14, cols=14, spacing_m=150.0, seed=21,
                   lat0=14.60, lon0=120.98), 12.0, 1.0, False),
    ("rural", dict(rows=7, cols=7, spacing_m=800.0, seed=22,
                   lat0=14.90, lon0=121.40), 4.0, 5.0, False),
    ("queue", dict(rows=10, cols=10, spacing_m=200.0, seed=23,
                   lat0=14.30, lon0=120.60), 5.0, 1.0, True),
]

#: the floor of the chaos leg's throughput over the clean leg's: the JAX
#: CI's smoke floor (short legs swing the ratio; its full-scale gate was
#: 0.4)
MIN_FAULT_RATIO = 0.2

#: the dead-letter replayer of both legs: paced and end-of-stream
#: drains, and an attempt budget a bounded storm cannot exhaust
REPLAY_INTERVAL_S = 0.5
REPLAY_ATTEMPTS = 10


def log(msg: str) -> None:
    print(f"bigreplay: {msg}", flush=True)


def fail(msg: str) -> int:
    sys.stderr.write(f"bigreplay: FAIL: {msg}\n")
    return 1


def _inject_queue(points, rng):
    """Stop-and-go: dwell the vehicle about mid-trace for a creeping
    stretch (sub-meter steps, 2 s apart) so the queue detector sees a
    trailing slow streak; later probe times shift by the dwell."""
    if len(points) < 8:
        return points
    j = len(points) // 2
    dwell = []
    base = points[j]
    steps = int(rng.integers(6, 12))
    for k in range(steps):
        dwell.append({
            "lat": round(base["lat"] + float(rng.normal(0.0, 3e-6)), 6),
            "lon": round(base["lon"] + float(rng.normal(0.0, 3e-6)), 6),
            "time": int(base["time"] + (k + 1) * 2),
            "accuracy": base["accuracy"],
        })
    shift = steps * 2
    tail = [dict(p, time=int(p["time"] + shift)) for p in points[j + 1:]]
    return points[:j + 1] + dwell + tail


def build_metro(probes_budget: int, seed: int):
    """[(name, city, traces, lines)] totalling about ``probes_budget``
    probes split evenly across the city profiles; fully seeded."""
    import numpy as np

    from ..synth import build_grid_city, generate_trace

    out = []
    per_city = probes_budget // len(CITY_PROFILES)
    for name, grid_kw, noise_m, period_s, queue in CITY_PROFILES:
        city = build_grid_city(service_road_fraction=0.0,
                               internal_fraction=0.0, **grid_kw)
        rng = np.random.default_rng(seed * 1000 + grid_kw["seed"])
        traces, lines, n = [], [], 0
        i = 0
        while n < per_city:
            tr = generate_trace(city, f"{name}-veh-{i}", rng,
                                noise_m=noise_m, sample_period_s=period_s,
                                min_route_edges=8)
            i += 1
            if tr is None:
                continue
            pts = _inject_queue(tr.points, rng) if queue else tr.points
            traces.append((tr.uuid, pts))
            for p in pts:
                lines.append("|".join([tr.uuid, str(p["lat"]),
                                       str(p["lon"]), str(p["time"]),
                                       str(p["accuracy"])]))
            n += len(pts)
        out.append((name, city, traces, lines))
        log(f"city {name}: {len(traces)} traces, {n} probes")
    return out


def run_leg(metro, writers: int, workdir: str, device, faults_spec=None,
            flush_interval_s: float = 2.0,
            report_flush_interval_s: float = 0.5):
    """One full replay of the metro through C cities x W writer workers
    (threads; one shared service a city, one shared datastore for the
    whole metro). Returns a result dict."""
    from ..datastore import LocalDatastore
    from ..matcher import SegmentMatcher
    from ..service.server import ReporterService
    from ..streaming.anonymiser import Anonymiser, TileSink
    from ..streaming.formatter import Formatter
    from ..streaming.worker import StreamWorker, inproc_submitter
    from ..utils import faults, metrics
    from ..utils.spool import backlog
    from .chaos import shard_lines

    metrics.default.reset()
    store = LocalDatastore(os.path.join(workdir, "store"))

    def tee(_tile, segments, ingest_key=None, _ds=store):
        return _ds.ingest_segments(segments, ingest_key=ingest_key)

    services, workers, threads, out_dirs, spools = [], [], [], [], []
    total_probes = 0
    for name, city, _traces, lines in metro:
        out_dir = os.path.join(workdir, f"out-{name}")
        out_dirs.append(out_dir)
        service = ReporterService(SegmentMatcher(city, device=device),
                                  threshold_sec=15, max_batch=64,
                                  max_wait_ms=5.0)
        services.append(service)
        for w, shard in enumerate(shard_lines(lines, writers)):
            if not shard:
                continue
            spool = os.path.join(workdir, f"spool-{name}-w{w}")
            spools.append(spool)
            anon = Anonymiser(TileSink(out_dir, deadletter=spool),
                              privacy=1, quantisation=3600,
                              source=f"big-{name}", tee=tee,
                              writer_id=f"w{w}")
            worker = StreamWorker(
                Formatter.from_config(FMT), inproc_submitter(service),
                anon, reports="0,1,2", transitions="0,1,2",
                flush_interval_s=flush_interval_s,
                submit_many=service.report_many,
                report_flush_interval_s=report_flush_interval_s,
                circuit_probe=lambda m=service.matcher: m.circuit.state,
                degraded_probe=service.matcher.open_domains,
                replay_interval_s=REPLAY_INTERVAL_S,
                replay_attempts=REPLAY_ATTEMPTS, datastore=store)
            # the spool globals are last-writer-wins, so in this
            # multi-worker process a poisoned trace is routed explicitly
            # to a spool of ITS OWN city (its graph): the first writer's
            if service.matcher.quarantine_spool is None:
                service.matcher.quarantine_spool = worker._trace_spool
            workers.append(worker)
            total_probes += len(shard)
            threads.append(threading.Thread(
                target=worker.run, args=(iter(shard),), daemon=True))

    if faults_spec:
        faults.configure(faults_spec)
    t0 = time.monotonic()
    fired = {}
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        fired = faults.fired_counts()
    finally:
        faults.clear()
    wall = time.monotonic() - t0

    # post-storm drain: the storm is bounded, so every spool must now
    # drain clean. A FULL worker drain: replayed traces forward segments
    # into the anonymiser, which must then flush them to tiles and tee
    leftover = 0
    try:
        for worker in workers:
            if worker.drainer is not None:
                worker.drain()
        for spool in spools:
            b = backlog(spool)
            t = backlog(os.path.join(spool, ".traces"))
            leftover += b["files"] + t["files"]
    finally:
        for service in services:
            service.dispatcher.close()
            service.matcher.close()

    snap = metrics.default.snapshot()["counters"]
    return {
        "wall_s": round(wall, 3),
        "probes": total_probes,
        "probes_per_s": round(total_probes / wall, 1) if wall else None,
        "workers": len(workers),
        "store": store,
        "out_dirs": out_dirs,
        "spools": spools,
        "spooled_left": leftover,
        "fired": fired,
        "parse_failures": sum(w.parse_failures for w in workers),
        "counters": {k: v for k, v in sorted(snap.items())
                     if k.startswith(("egress.", "batch.", "replay.",
                                      "matcher.circuit", "deadletter.",
                                      "datastore.ingest.deduped",
                                      "matcher.assemble.quarantined"))},
    }


def check_exactly_once(leg, workdir: str):
    """The tee store equals a fresh store over the sink trees, and
    re-ingesting the sink trees into the tee store changes nothing (the
    ledger dedupes). Returns (verdict, None) or (None, error)."""
    from ..datastore import LocalDatastore, ingest_dir

    file_store = LocalDatastore(os.path.join(workdir, "file_store"))
    for out_dir in leg["out_dirs"]:
        ingest_dir(file_store, out_dir)
    tee_cells = leg["store"].merged_cells()
    file_cells = file_store.merged_cells()
    if tee_cells != file_cells:
        only_tee = len(set(tee_cells) - set(file_cells))
        only_file = len(set(file_cells) - set(tee_cells))
        differ = sum(1 for k in set(tee_cells) & set(file_cells)
                     if tee_cells[k] != file_cells[k])
        return (None, f"tee store != tile-file store: {only_tee} cells "
                f"only in tee, {only_file} only in files, {differ} differ: "
                f"observations were lost or duplicated")
    # the double-ingest proof: every flush is already in the ledger
    deduped_files = 0
    for out_dir in leg["out_dirs"]:
        got = ingest_dir(leg["store"], out_dir)
        deduped_files += got["files"]
        if got["rows"]:
            return (None, f"re-ingest of {out_dir} appended {got['rows']} "
                    "rows: the ledger failed to dedupe")
    if leg["store"].merged_cells() != tee_cells:
        return (None, "re-ingest changed store contents despite 0 rows")
    return ({"cells": len(tee_cells),
             "count_total": sum(c for c, _s in tee_cells.values()),
             "reingest_files_deduped": deduped_files}, None)


def oracle_matcher(city):
    """A matcher on the host whose every chunk decodes by the pure-numpy
    oracle (``cpu_ref.decode_chunk_numpy``), with the numpy prep."""
    import torch

    from ..matcher import SegmentMatcher
    from ..matcher.cpu_ref import decode_chunk_numpy

    class OracleMatcher(SegmentMatcher):
        def _dispatch_stage(self, batch, sigma, beta):
            return (torch.from_numpy(decode_chunk_numpy(batch, sigma, beta)),
                    None, None, None)

    return OracleMatcher(city, device="cpu", native=False)


def check_agreement(metro, sample: int, seed: int, device):
    """The serving decode against the pure-numpy oracle on a per-city
    trace sample; returns (agreement_ratio, traces_compared,
    ids_compared)."""
    import numpy as np

    from ..matcher import SegmentMatcher

    rng = np.random.default_rng(seed)
    agree = total = traces_n = 0
    per_city = max(1, sample // len(metro))
    for _name, city, traces, _lines in metro:
        picks = rng.choice(len(traces), size=min(per_city, len(traces)),
                           replace=False)
        reqs = []
        for i in picks:
            uuid, pts = traces[int(i)]
            reqs.append({"uuid": uuid, "trace": pts,
                         "match_options": {"mode": "auto",
                                           "report_levels": [0, 1, 2],
                                           "transition_levels": [0, 1, 2]}})
        served, oracle = SegmentMatcher(city, device=device), \
            oracle_matcher(city)
        try:
            got = served.match_many(reqs)
            want = oracle.match_many(reqs)
            for rd, ro in zip(got, want):
                sd = [s["segment_id"] for s in rd["segments"]
                      if "segment_id" in s]
                so = [s["segment_id"] for s in ro["segments"]
                      if "segment_id" in s]
                n = max(len(sd), len(so))
                total += n
                agree += sum(1 for a, b in zip(sd, so) if a == b)
                traces_n += 1
        finally:
            served.close()
            oracle.close()
    return (agree / total if total else 1.0), traces_n, total


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m reporter_tpu_torch.tools.bigreplay",
        description="multi-city chaos replay: exactly-once and oracle "
                    "agreement")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default), cuda:I or cpu")
    parser.add_argument("--probes", type=int, default=1_000_000,
                        help="total probe budget across the metro "
                             "(default the paper-scale 1M; smoke 3000)")
    parser.add_argument("--writers", type=int, default=2,
                        help="writer workers per city (default 2)")
    parser.add_argument("--seed", type=int, default=9)
    parser.add_argument("--faults", default=DEFAULT_FAULTS,
                        help="fault spec of the chaos leg (default: a "
                             "bounded every-domain storm)")
    parser.add_argument("--agreement-sample", type=int, default=30,
                        help="traces sampled for the oracle-agreement "
                             "gate (default 30)")
    parser.add_argument("--min-agreement", type=float, default=0.99)
    parser.add_argument("--out", help="artifact JSON path")
    parser.add_argument("--keep", help="keep working dirs under this path "
                                       "instead of a temp dir")
    args = parser.parse_args(argv)
    from .chaos import check_device
    device = check_device(args.device)

    metro = build_metro(args.probes, args.seed)

    agreement, traces_n, ids_n = check_agreement(
        metro, args.agreement_sample, args.seed, device)
    log(f"oracle agreement: {agreement:.4f} over {traces_n} traces "
        f"({ids_n} segment ids)")
    if agreement < args.min_agreement:
        return fail(f"segment-ID agreement {agreement:.4f} < "
                    f"{args.min_agreement} against the numpy oracle")

    tmp = args.keep or tempfile.mkdtemp(prefix="bigreplay-")
    try:
        clean_dir = os.path.join(tmp, "clean")
        chaos_dir = os.path.join(tmp, "chaos")
        os.makedirs(clean_dir, exist_ok=True)
        os.makedirs(chaos_dir, exist_ok=True)

        log(f"clean leg: {args.writers} writers/city x {len(metro)} cities")
        clean = run_leg(metro, args.writers, clean_dir, device)
        log(f"clean: {clean['probes']} probes in {clean['wall_s']} s "
            f"({clean['probes_per_s']}/s)")
        if clean["parse_failures"]:
            return fail(f"clean leg parse failures: "
                        f"{clean['parse_failures']}")

        log(f"chaos leg under storm: {args.faults}")
        chaos = run_leg(metro, args.writers, chaos_dir, device,
                        faults_spec=args.faults)
        log(f"chaos: {chaos['probes']} probes in {chaos['wall_s']} s "
            f"({chaos['probes_per_s']}/s); counters: "
            f"{json.dumps(chaos['counters'])}")

        if chaos["spooled_left"] or clean["spooled_left"]:
            return fail(f"{chaos['spooled_left'] + clean['spooled_left']} "
                        f"dead-letter entries left after the replayer "
                        f"drained")
        for leg_name, leg, workdir in (("clean", clean, clean_dir),
                                       ("chaos", chaos, chaos_dir)):
            verdict, err = check_exactly_once(leg, workdir)
            if err:
                return fail(f"{leg_name} leg: {err}")
            leg["exactly_once"] = verdict
            log(f"{leg_name} exactly-once ok: {verdict}")

        ratio = (chaos["probes_per_s"] / clean["probes_per_s"]
                 if clean["probes_per_s"] else None)
        artifact = {
            "kind": "bigreplay",
            "probes": args.probes,
            "writers": args.writers,
            "cities": [name for name, *_ in metro],
            "seed": args.seed,
            "agreement": round(agreement, 5),
            "agreement_traces": traces_n,
            "min_agreement": args.min_agreement,
            "faults": args.faults,
            "clean": {k: clean[k] for k in
                      ("wall_s", "probes", "probes_per_s", "workers",
                       "exactly_once")},
            "chaos": {k: chaos[k] for k in
                      ("wall_s", "probes", "probes_per_s", "workers",
                       "exactly_once", "counters", "fired")},
            "fault_throughput_ratio": round(ratio, 4) if ratio else None,
        }
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                json.dump(artifact, f, indent=2)
            log(f"artifact -> {args.out}")
        if ratio is None or ratio < MIN_FAULT_RATIO:
            return fail(f"chaos-leg throughput fell to {ratio} x the clean "
                        f"leg (floor {MIN_FAULT_RATIO})")
        log(f"ok: agreement {agreement:.4f}, exactly-once proven on both "
            f"legs, fault throughput ratio {ratio:.4f}")
        return 0
    finally:
        if not args.keep:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
