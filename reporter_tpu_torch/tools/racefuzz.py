"""Schedule-perturbation fuzzer and the disarmed-overhead gate.

The port of the JAX repo's ``tools/racefuzz.py``. The runtime witness
(``analysis/racecheck.py``) only reports interleavings that happen. This
harness makes unlikely ones happen: the config key ``racefuzz``
(``seed[:prob][@max_us]``) injects seeded microsecond yields at every
tracked lock acquire and at the dispatcher's queue put and get sites
(each site's generator seeded ``crc32(site) ^ seed``, so draw sequences
replay by seed), and the scenarios below run with the witness and the
guarded-state audit armed (``lockcheck: true``). ANY finding fails the
run and prints the replay seed.

Scenarios, each in its own interpreter (a ``--drive`` child whose
``--config`` file arms it, so the held-before graph starts clean):

  replay        traced multi-writer replay: 2 writer workers x one shared
                service + datastore tee and a background compactor (the
                bigreplay topology at smoke scale), ``trace`` on and the
                decode shadow at 0.5 -> the witness must find nothing and
                the perturbation must have fired
  submit_burst  ``tools/chaos.py`` submit_burst under perturbation
  storm         ``tools/chaos.py`` storm under perturbation

Usage::

    python -m reporter_tpu_torch.tools.racefuzz [--device cuda|cpu]
        [--seeds N | --seed S ...] [--scenarios ...]
    python -m reporter_tpu_torch.tools.racefuzz --overhead [--repeats R]

``--overhead`` is the disarmed-cost gate: the serialized
(``pipeline: false``) 512-trace match with tracked-but-disarmed locks
(the shipped default) against ``lockcheck: "raw"`` bare
``threading.Lock`` objects, interleaved repeats, pinned under 2%. Its
shape differs from the JAX harness's (a fresh process a call, warmed
with 32 traces, the least of three a leg), whose calls swung by +-15%
on the card with the shared host's load. Here ``OVERHEAD_PROCS``
processes a leg stay alive for the whole A/B, each warmed with the whole
workload at the shipped prep-thread count; each call is timed as
``timeit`` times, the garbage collected before it and the collector off
during it; every round calls raw process i and disarmed process i back
to back for each i, the order reversed every other round. The A/B is
the median over those adjacent pairs of disarmed / raw - 1, which takes
the host's slow drift out; the same pool gives two A/A controls, raw
process i+1 against raw process i and the same for disarmed, which read
what the harness alone puts between two legs. Beside it the gate holds
the wrappers' cost read directly: each disarmed process counts its
tracked-lock acquisitions a call and times a lock pair of each flavour
(:func:`lock_overhead` reads the same in one process, the card run's
check). The device is ``cuda`` unless ``--device cpu`` is given; without
a card the tool raises.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

DEFAULT_SCENARIOS = ("replay", "submit_burst", "storm")
FMT = r",sv,\|,0,1,2,3,4"  # uuid|lat|lon|time|accuracy
OVERHEAD_TRACES = 512
OVERHEAD_LIMIT_PCT = 2.0
#: the A/B's shape: OVERHEAD_PROCS live processes a leg, OVERHEAD_ROUNDS
#: rounds of one call each, the A/B the median over the rounds' adjacent
#: (raw i, disarmed i) pairs. On an H100's shared host the log of a
#: pair's ratio spreads with a standard deviation near 0.13, so the
#: median of n pairs carries about 1.25 * 0.13 / sqrt(n): 600 pairs put
#: a 2% reading three of those past a true 0; 48 pairs read -2.69% to
#: +4.14%, and their A/A controls up to +4.83%
OVERHEAD_ROUNDS = 150
OVERHEAD_PROCS = 4
#: both legs' matcher keys: serialized, as the JAX harness's
#: REPORTER_TPU_PIPELINE=0; the prep threads stay the shipped count
OVERHEAD_KEYS = {"pipeline": False}
CHILD_TIMEOUT_S = 900
#: the service keys a --drive child's config may hold: the process-wide
#: observability keys and the matcher's pipeline switch
CHILD_KEYS = ("trace", "shadow_sample", "lockcheck", "racefuzz", "pipeline")


def log(msg: str) -> None:
    print(f"racefuzz: {msg}", flush=True)


# ---- child legs (a fresh interpreter, armed by its --config) ----------------

def _arm_child(path: str) -> dict:
    """Read a child's config and arm it; returns its service keys. Raw
    locks are set before any module that makes locks is imported, so
    every lock of the process is a bare one."""
    with open(path, encoding="utf-8") as f:
        keys = dict(json.load(f).get("service") or {})
    unknown = set(keys) - set(CHILD_KEYS)
    if unknown:
        raise ValueError(f"unknown keys {sorted(unknown)}")
    if keys.get("lockcheck") == "raw":
        from ..utils import locks
        locks.set_raw()
    from ..service.server import OBS_KEYS, configure_obs
    configure_obs({k: v for k, v in keys.items() if k in OBS_KEYS})
    return keys


def _check_findings(context: str) -> int:
    """The zero-findings gate every drive leg ends on, each finding in
    the ``path:line: RULE-ID`` form."""
    from ..analysis import racecheck
    lines = racecheck.render()
    for line in lines:
        print(line)
    if lines:
        sys.stderr.write(f"racefuzz: FAIL: {len(lines)} witness "
                         f"finding(s) in {context}\n")
        return 1
    log(f"{context}: 0 findings (held-before edges observed: "
        f"{racecheck.edge_count()})")
    return 0


def drive_replay(device, keys: dict) -> int:
    """Traced multi-writer replay: two writer workers share one service
    (one dispatcher, one matcher, its device lanes), one datastore tee
    and a background compactor; each writer owns its anonymiser and
    sink. The perturbed schedule must give a clean run AND a clean
    witness."""
    import threading

    import numpy as np

    from ..datastore import BackgroundCompactor, LocalDatastore
    from ..matcher import SegmentMatcher
    from ..service.server import ReporterService
    from ..streaming.anonymiser import Anonymiser, TileSink
    from ..streaming.formatter import Formatter
    from ..streaming.worker import StreamWorker, inproc_submitter
    from ..synth import build_grid_city, generate_trace
    from ..utils import locks

    if not locks.armed():
        sys.stderr.write("racefuzz: FAIL: witness not armed in child "
                         "(lockcheck lost?)\n")
        return 1

    city = build_grid_city(rows=8, cols=8, spacing_m=200.0, seed=5,
                           service_road_fraction=0.0, internal_fraction=0.0)
    rng = np.random.default_rng(11)
    shards = [[], []]
    for i in range(12):
        tr = None
        while tr is None:
            tr = generate_trace(city, f"veh-{i}", rng, noise_m=3.0,
                                min_route_edges=8)
        shards[i % 2].extend(
            "|".join([tr.uuid, str(p["lat"]), str(p["lon"]),
                      str(p["time"]), str(p["accuracy"])])
            for p in tr.points)

    with tempfile.TemporaryDirectory() as workdir:
        store = LocalDatastore(os.path.join(workdir, "store"))
        # the serving tier's thread topology: a background compactor
        # paced fast enough to contend with both writers' tee ingests on
        # the shared store, under the witness and the perturbation
        compactor = BackgroundCompactor(store, max_deltas=1,
                                        interval_s=0.02).start()

        def tee(_tile, segments, ingest_key=None):
            return store.ingest_segments(segments, ingest_key=ingest_key)

        service = ReporterService(
            SegmentMatcher(city, device=device,
                           pipeline=keys.get("pipeline", True)),
            threshold_sec=15, max_batch=64, max_wait_ms=5.0)
        workers, threads = [], []
        for w, shard in enumerate(shards):
            anon = Anonymiser(
                TileSink(os.path.join(workdir, "out"),
                         deadletter=os.path.join(workdir, f"spool-w{w}")),
                privacy=1, quantisation=3600, source="fuzz", tee=tee,
                writer_id=f"w{w}")
            worker = StreamWorker(
                Formatter.from_config(FMT), inproc_submitter(service),
                anon, reports="0,1,2", transitions="0,1,2",
                flush_interval_s=1e9, submit_many=service.report_many,
                report_flush_interval_s=0.5, datastore=store)
            workers.append(worker)
            threads.append(threading.Thread(target=worker.run,
                                            args=(iter(shard),),
                                            daemon=True))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        compactor.stop()
        service.dispatcher.close()
        service.matcher.close()

        fails = sum(w.parse_failures for w in workers)
        if fails:
            sys.stderr.write(f"racefuzz: FAIL: {fails} parse failures in "
                             "the replay\n")
            return 1
        yields = locks.fuzz_yields()
        if keys.get("racefuzz") and yields == 0:
            sys.stderr.write("racefuzz: FAIL: perturbation armed but zero "
                             "yields fired: the hooks are dead\n")
            return 1
        log(f"replay: {sum(len(s) for s in shards)} probes, 2 writers, "
            f"{yields} perturbation yields")
        return _check_findings("replay")


def drive_chaos(scenario: str, device) -> int:
    """One ``tools/chaos.py`` scenario under the armed witness and fuzz."""
    from ..utils import locks
    from . import chaos
    rc = chaos.SCENARIOS[scenario](str(device))
    if rc != 0:
        sys.stderr.write(f"racefuzz: FAIL: chaos {scenario} rc={rc} under "
                         "perturbation\n")
        return rc
    log(f"{scenario}: chaos leg clean, {locks.fuzz_yields()} "
        f"perturbation yields")
    return _check_findings(scenario)


def overhead_workload(device, pipeline: bool = False):
    """The A/B's workload on ``device``: an 8x8 city, 64 seeded traces
    repeated to ``OVERHEAD_TRACES`` requests, a matcher at the shipped
    prep-thread count (serialized unless ``pipeline``); returns
    (matcher, requests)."""
    import numpy as np

    from ..matcher import SegmentMatcher
    from ..synth import build_grid_city, generate_trace

    city = build_grid_city(rows=8, cols=8, spacing_m=200.0, seed=5,
                           service_road_fraction=0.0, internal_fraction=0.0)
    rng = np.random.default_rng(23)
    reqs = []
    for i in range(64):
        tr = None
        while tr is None:
            tr = generate_trace(city, f"veh-{i}", rng, noise_m=3.0,
                                min_route_edges=8)
        reqs.append(tr.request_json())
    reqs = (reqs * ((OVERHEAD_TRACES // len(reqs)) + 1))[:OVERHEAD_TRACES]
    return SegmentMatcher(city, device=device, pipeline=pipeline), reqs


def count_acquires(matcher, reqs) -> int:
    """The tracked-lock acquisitions of one ``match_many(reqs)``."""
    from ..utils import locks
    count = [0]
    acquire = locks.TrackedLock.acquire

    def counted(self, *args, **kw):
        count[0] += 1
        return acquire(self, *args, **kw)

    locks.TrackedLock.acquire = counted
    try:
        matcher.match_many(reqs)
    finally:
        locks.TrackedLock.acquire = acquire
    return count[0]


def timed_call(matcher, reqs):
    """One ``match_many(reqs)`` timed as ``timeit`` times, the garbage
    collected before it and the collector off during it; returns
    (milliseconds, results)."""
    import gc
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        out = matcher.match_many(reqs)
        return (time.perf_counter() - t0) * 1e3, out
    finally:
        gc.enable()


def lock_pair_ns(n: int = 100_000, blocks: int = 5) -> dict:
    """A disarmed :class:`TrackedLock`'s and a bare ``threading.Lock``'s
    acquire-and-release, in nanoseconds: the least of ``blocks``
    interleaved timings of ``n`` pairs each."""
    import threading

    from ..utils import locks
    best = {"tracked_ns": float("inf"), "bare_ns": float("inf")}
    held = (("tracked_ns", locks.TrackedLock("racefuzz.probe")),
            ("bare_ns", threading.Lock()))
    for _ in range(blocks):
        for name, lock in held:
            t0 = time.perf_counter()
            for _ in range(n):
                with lock:
                    pass
            best[name] = min(best[name],
                             (time.perf_counter() - t0) / n * 1e9)
    return best


def wrapper_pct(acquires: int, cost: dict, call_ms: float) -> float:
    """What the disarmed wrappers add to a call, in percent: its
    tracked-lock acquisitions times a pair's extra cost over a bare
    lock's."""
    extra_ns = max(0.0, cost["tracked_ns"] - cost["bare_ns"])
    return acquires * extra_ns / (call_ms * 1e6) * 100.0


def lock_overhead(device, calls: int = 5) -> dict:
    """The disarmed wrappers' cost a call, measured directly in this
    process (whose locks must be tracked and disarmed): the workload's
    tracked-lock acquisitions a call, a pair's cost beside a bare
    lock's, and the median of ``calls`` timed calls. Returns
    {"acquires", "tracked_ns", "bare_ns", "call_ms", "pct"}."""
    from ..utils import locks
    if locks.raw() or locks.armed():
        raise RuntimeError("the direct lock cost needs disarmed tracked "
                           "locks")
    matcher, reqs = overhead_workload(device)
    try:
        matcher.match_many(reqs)
        acquires = count_acquires(matcher, reqs)
        call_ms = statistics.median(timed_call(matcher, reqs)[0]
                                    for _ in range(calls))
    finally:
        matcher.close()
    cost = lock_pair_ns()
    return {"acquires": acquires, **cost, "call_ms": call_ms,
            "pct": wrapper_pct(acquires, cost, call_ms)}


def drive_overhead(device, keys: dict) -> int:
    """One leg of the A/B, kept alive for the whole measurement: build
    :func:`overhead_workload`, warm it with one whole call (the builds,
    the route memo and the allocator's blocks off the clock), count the
    tracked-lock acquisitions of a second and time a lock pair of each
    flavour, print a ready line with the lock flavour (so the parent can
    prove the leg runs what it thinks it runs) and those, then time one
    match_many (:func:`timed_call`) for each ``go`` line on stdin, a JSON
    line each, until stdin ends."""
    from ..utils import metrics

    matcher, reqs = overhead_workload(device, keys.get("pipeline", True))
    try:
        matcher.match_many(reqs)
        ready = {"ready": True,
                 "lock_type": type(metrics.default._lock).__name__,
                 "acquires": count_acquires(matcher, reqs),
                 **lock_pair_ns()}
        print(json.dumps(ready), flush=True)
        for line in sys.stdin:
            if line.strip() != "go":
                break
            ms, out = timed_call(matcher, reqs)
            print(json.dumps({"ms": round(ms, 3), "traces": len(out)}),
                  flush=True)
    finally:
        matcher.close()
    return 0


# ---- parent orchestration ---------------------------------------------------

def _run_child(scenario: str, device, service: dict):
    """A ``--drive`` child in a fresh interpreter, armed by a config
    file of ``service`` keys."""
    from .chaos import PYTHON, REPO
    with tempfile.TemporaryDirectory() as tmp:
        conf = os.path.join(tmp, "child.json")
        with open(conf, "w", encoding="utf-8") as f:
            json.dump({"service": service}, f)
        return subprocess.run(
            [*PYTHON, "-m", "reporter_tpu_torch.tools.racefuzz",
             "--drive", scenario, "--config", conf, "--device", str(device)],
            cwd=REPO, capture_output=True, text=True,
            timeout=CHILD_TIMEOUT_S)


def run_fuzz(seeds, scenarios, prob: float, max_us: float, device) -> int:
    failures = []
    for seed in seeds:
        for scenario in scenarios:
            spec = f"{seed}:{prob}@{max_us:g}"
            log(f"seed {seed} / {scenario} (racefuzz {spec}) ...")
            t0 = time.monotonic()
            proc = _run_child(scenario, device, {
                "lockcheck": True, "racefuzz": spec, "trace": True,
                "shadow_sample": 0.5})
            dt = time.monotonic() - t0
            if proc.returncode != 0:
                failures.append((seed, scenario))
                sys.stdout.write(proc.stdout)
                sys.stderr.write(proc.stderr)
                log(f"seed {seed} / {scenario}: FAIL ({dt:.1f}s); replay "
                    f"with: python -m reporter_tpu_torch.tools.racefuzz "
                    f"--device {device} --seed {seed} --scenarios "
                    f"{scenario}")
            else:
                tail = [ln for ln in proc.stdout.splitlines()
                        if ln.startswith("racefuzz:")]
                for ln in tail[-2:]:
                    print("  " + ln)
                log(f"seed {seed} / {scenario}: ok ({dt:.1f}s)")
    if failures:
        sys.stderr.write("racefuzz: FAIL: findings under "
                         + ", ".join(f"seed {s} ({sc})"
                                     for s, sc in failures) + "\n")
        return 1
    log(f"clean: {len(seeds)} seed(s) x {len(scenarios)} scenario(s), "
        "0 findings")
    return 0


class _Leg:
    """A live ``--drive overhead`` child: one JSON line a request, read
    with a deadline."""

    def __init__(self, name: str, device, service: dict, tmp: str):
        from .chaos import PYTHON, REPO
        self.name = name
        conf = os.path.join(tmp, f"{name}.json")
        with open(conf, "w", encoding="utf-8") as f:
            json.dump({"service": service}, f)
        self.err = open(os.path.join(tmp, f"{name}.err"), "w+")
        self.proc = subprocess.Popen(
            [*PYTHON, "-m", "reporter_tpu_torch.tools.racefuzz", "--drive",
             "overhead", "--config", conf, "--device", str(device)],
            cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.err, bufsize=0)
        self._buf = b""

    def read(self, timeout_s: float = CHILD_TIMEOUT_S) -> dict:
        """The next JSON object line of the child's stdout (other lines
        skipped); raises when it exits or the deadline passes first."""
        import select
        deadline = time.monotonic() + timeout_s
        while True:
            while b"\n" in self._buf:
                line, self._buf = self._buf.split(b"\n", 1)
                if line.startswith(b"{"):
                    return json.loads(line)
            left = deadline - time.monotonic()
            ready = select.select([self.proc.stdout], [], [], max(0.0, left))[0]
            chunk = os.read(self.proc.stdout.fileno(), 65536) if ready else b""
            if not chunk:
                self.err.seek(0)
                raise RuntimeError(
                    f"overhead {self.name} leg "
                    f"{'exited' if ready else 'timed out'} (rc "
                    f"{self.proc.poll()}): {self.err.read()[-2000:]}")
            self._buf += chunk

    def call(self) -> dict:
        self.proc.stdin.write(b"go\n")
        rec = self.read()
        if rec.get("traces") != OVERHEAD_TRACES:
            raise RuntimeError(f"overhead {self.name} leg matched "
                               f"{rec.get('traces')} traces")
        return rec

    def close(self) -> None:
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self.err.close()


def _median_pct(pairs) -> float:
    """The median of b / a - 1 over (a, b) pairs, in percent."""
    return (statistics.median(b / a for a, b in pairs) - 1.0) * 100.0


def measure_overhead(repeats: int, device,
                     procs: int = OVERHEAD_PROCS) -> dict:
    """Interleaved A/B: raw ``threading.Lock`` (A) against
    tracked-but-disarmed :class:`TrackedLock` (B, the shipped default).
    ``procs`` processes a leg start and warm first; then ``repeats``
    rounds each call raw process i and disarmed process i back to back
    for each i, the order reversed every other round. Returns {"pct": the
    median of disarmed / raw - 1 over those adjacent pairs, in percent;
    "aa_raw_pct", "aa_disarmed_pct": the same over (process i, process
    i+1) of one leg in a round, the A/A controls (None with one process);
    "raw_ms", "disarmed_ms": each leg's median call; "acquires": the
    disarmed legs' tracked-lock acquisitions a call; "wrapper_pct": the
    direct reading, :func:`wrapper_pct` of a disarmed process's count and
    pair costs against the disarmed median call (the largest of the
    processes'); "types"; "legs": a leg's calls, a list a process}.
    Raises when a leg fails or matches the wrong count."""
    names = [(leg, i) for i in range(procs) for leg in ("raw", "disarmed")]
    calls = {name: [] for name in names}
    types, acquires, costs = {}, set(), []
    with tempfile.TemporaryDirectory() as tmp:
        live = {}
        try:
            for leg, i in names:
                service = dict(OVERHEAD_KEYS)
                if leg == "raw":
                    service["lockcheck"] = "raw"
                live[leg, i] = _Leg(f"{leg}{i}", device, service, tmp)
            for (leg, _i), child in live.items():
                ready = child.read()
                got = ready["lock_type"]
                if types.setdefault(leg, got) != got:
                    raise RuntimeError(f"{leg} legs ran {types[leg]} and "
                                       f"{got}")
                if leg == "disarmed":
                    acquires.add(ready["acquires"])
                    costs.append(ready)
            for r in range(repeats):
                for name in (names if r % 2 == 0 else names[::-1]):
                    calls[name].append(live[name].call()["ms"])
                log(f"overhead round {r + 1}/{repeats}: raw "
                    f"{[calls['raw', i][-1] for i in range(procs)]} ms "
                    f"({types['raw']}), disarmed "
                    f"{[calls['disarmed', i][-1] for i in range(procs)]} ms "
                    f"({types['disarmed']})")
        finally:
            for child in live.values():
                child.close()
    legs = {leg: [calls[leg, i] for i in range(procs)]
            for leg in ("raw", "disarmed")}
    rounds = range(repeats)
    out = {"pct": _median_pct((legs["raw"][i][r], legs["disarmed"][i][r])
                              for r in rounds for i in range(procs)),
           "raw_ms": statistics.median(t for c in legs["raw"] for t in c),
           "disarmed_ms": statistics.median(
               t for c in legs["disarmed"] for t in c),
           "acquires": sorted(acquires), "types": types, "legs": legs}
    # the direct reading: each disarmed process's acquisitions and pair
    # costs against the disarmed legs' median call
    out["wrapper_pct"] = max(wrapper_pct(c["acquires"], c,
                                         out["disarmed_ms"]) for c in costs)
    for leg in ("raw", "disarmed"):
        out[f"aa_{leg}_pct"] = _median_pct(
            (legs[leg][i][r], legs[leg][i + 1][r])
            for r in rounds for i in range(procs - 1)) if procs > 1 else None
    return out


def run_overhead(repeats: int, device) -> int:
    try:
        got = measure_overhead(repeats, device)
    except RuntimeError as e:
        sys.stderr.write(f"racefuzz: FAIL: {e}\n")
        return 1
    types = got["types"]
    if types.get("raw") != "lock" or types.get("disarmed") != "TrackedLock":
        sys.stderr.write(f"racefuzz: FAIL: A/B legs ran the wrong lock "
                         f"flavours ({types}): the comparison is "
                         f"meaningless\n")
        return 1
    pct = got["pct"]
    log(f"serialized {OVERHEAD_TRACES}-trace A/B: raw {got['raw_ms']:.1f} "
        f"ms vs disarmed TrackedLock {got['disarmed_ms']:.1f} ms (leg "
        f"medians); paired {pct:+.2f}% over {repeats * OVERHEAD_PROCS} "
        f"pairs (limit +{OVERHEAD_LIMIT_PCT:.0f}%); A/A controls raw "
        f"{got['aa_raw_pct']:+.2f}%, disarmed {got['aa_disarmed_pct']:+.2f}%; "
        f"{got['acquires']} tracked-lock acquisitions a call, the wrappers "
        f"{got['wrapper_pct']:+.4f}% of it")
    for what, value in (("disarmed lock overhead", pct),
                        ("disarmed wrappers' direct cost",
                         got["wrapper_pct"])):
        if value > OVERHEAD_LIMIT_PCT:
            sys.stderr.write(f"racefuzz: FAIL: {what} {value:+.2f}% "
                             f"exceeds {OVERHEAD_LIMIT_PCT}%\n")
            return 1
    log("overhead gate: ok")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m reporter_tpu_torch.tools.racefuzz",
        description="schedule-perturbation fuzzer and the disarmed-"
                    "overhead gate")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default), cuda:I or cpu")
    parser.add_argument("--seeds", type=int, default=None,
                        help="run seeds base..base+N-1 (default 3 when "
                             "neither --seeds nor --seed is given)")
    parser.add_argument("--seed", type=int, action="append", default=None,
                        help="run exactly this seed (repeatable): the "
                             "replay knob a failure report prints")
    parser.add_argument("--base-seed", type=int, default=1,
                        help="first seed for --seeds (default 1)")
    parser.add_argument("--prob", type=float, default=0.25,
                        help="per-site yield probability (default 0.25)")
    parser.add_argument("--max-us", type=float, default=200.0,
                        help="max injected yield in microseconds")
    parser.add_argument("--scenarios", nargs="+",
                        default=list(DEFAULT_SCENARIOS),
                        choices=list(DEFAULT_SCENARIOS),
                        help="scenario subset (default: all)")
    parser.add_argument("--overhead", action="store_true",
                        help="run the disarmed-overhead A/B gate instead "
                             "of fuzzing")
    parser.add_argument("--repeats", type=int, default=OVERHEAD_ROUNDS,
                        help="interleaved rounds of the overhead A/B, a "
                             "call of each process a round (default "
                             f"{OVERHEAD_ROUNDS})")
    parser.add_argument("--drive", default=None,
                        help=argparse.SUPPRESS)  # internal child mode
    parser.add_argument("--config", default=None,
                        help=argparse.SUPPRESS)  # the child's arming
    args = parser.parse_args(argv)

    if args.drive:
        # arm first: raw locks must precede every lock-making import
        keys = _arm_child(args.config) if args.config else {}
        from .chaos import check_device
        device = check_device(args.device)
        if args.drive == "replay":
            return drive_replay(device, keys)
        if args.drive == "overhead":
            return drive_overhead(device, keys)
        return drive_chaos(args.drive, device)
    from .chaos import check_device
    device = check_device(args.device)
    if args.overhead:
        return run_overhead(args.repeats, device)
    if args.seed:
        seeds = args.seed
    else:
        seeds = list(range(args.base_seed,
                           args.base_seed + (args.seeds or 3)))
    return run_fuzz(seeds, args.scenarios, args.prob, args.max_us, device)


if __name__ == "__main__":
    sys.exit(main())
