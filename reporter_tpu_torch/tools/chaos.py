"""Chaos harness: scripted failure scenarios over the port's real stack.

The port of the JAX repo's ``tools/chaos.py``. The deterministic
failpoint layer (``utils/faults.py``) arms named faults with seeded
specs, and each scenario replays a synthetic stream under one failure
domain and asserts the defined degraded behaviour, with output parity
against a fault-free run where the mechanism promises it.

Scenarios (run the named ones; default ``storm kill_restore``; ``all``
runs every one):

  storm             native prep error storm -> the prep breaker OPENS ->
                    chunks served by the numpy prep byte-identically ->
                    cooldown -> half-open probe -> breaker re-closes
  kill_restore      crash failpoint (``os._exit(137)``, SIGKILL-grade) at
                    an exact mid-stream offer -> restart -> snapshot
                    restore -> tiles byte-identical to a fault-free run
  stream_resume     incremental matcher: a commit-site error -> batch-path
                    fallback with byte-identical tiles; then a mid-stream
                    SIGKILL -> the snapshot restores the carried per-trace
                    decode states (onto the matcher's device) -> final
                    tiles byte-identical to fault-free
  submit_burst      matcher 5xx burst -> bounded requeue -> recovery
                    without loss; a dead matcher -> trace-JSON dead letters
  egress_outage     sink down -> every tile dead-letters -> ``ingest_dir
                    --delete`` replay -> store parity with fault-free
  decode_poison     decode storm -> 500, then 503 with Retry-After while
                    the decode breaker is open (nothing launched, never a
                    host decode) -> probe re-closes it with the healthy
                    bytes; a poisoned assemble quarantines exactly ONE
                    trace while every other trace's bytes stay identical
  double_ingest     the (epoch, tile) dedupe ledger: a ``--delete`` re-run
                    appends nothing; a crash between tee ingest and epoch
                    commit re-offers every flush, deduped
  replay_drain      the dead-letter replayer drains a matcher + sink
                    outage: spools empty, store equal to a fresh ingest
  prefork_kill      2-process ``SO_REUSEPORT`` serving: one worker is
                    SIGKILLed under load, restarted in its slot, and its
                    successor (which opens the device after the fork)
                    answers the bytes of an in-process CPU service; with
                    ``mesh=True`` each worker decodes over a mesh naming
                    the device twice
  lease_kill        SIGKILL the datastore lease holder mid-compaction ->
                    manifests untorn -> lease stolen -> ledger-deduped
                    recovery -> store cells equal a fresh ingest
  swap_kill         SIGKILL a registry process inside ``CityRegistry.swap``
                    (candidate loaded and gated, old version serving, lease
                    held) -> clean steal -> both epochs recovered to
                    parity -> a pre-swap trace spool drains on the new map
  overload_recovery admission sheds past capacity (every 429 counted, with
                    Retry-After), the ladder steps down, a gate fault fails
                    open, the ladder steps back up, a backpressure spool
                    drains

Where the port departs from the JAX package on purpose the scenario
holds the port's contract: ``decode_poison``'s decode half (the card's
domains refuse; they never degrade to a host decode), ``prefork_kill``'s
identity half (writer ids are the ``worker.writer_id`` key), and
``swap_kill`` (a swap is started in process, as no endpoint starts one).

Usage::

    python -m reporter_tpu_torch.tools.chaos [--device cuda|cpu] [name ...]

The device is ``cuda`` unless ``--device cpu`` is given; without a card
the tool raises. Child processes get the device and every knob through
their command lines and ``--config`` files. The native host runtime is
built at first use; a scenario that needs it fails without it. Exit 0
when every named scenario passed, 1 at the first failure.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import zlib
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the interpreter prefix of every child process; a caller that counts
#: the children's kernel launches (chip_smoke.py) swaps in its own shim
PYTHON = [sys.executable]

FMT = r",sv,\|,0,1,2,3,4"  # uuid|lat|lon|time|accuracy
CHILD_TIMEOUT_S = 600
OPTS = {"mode": "auto", "report_levels": [0, 1, 2],
        "transition_levels": [0, 1, 2]}


def log(msg: str) -> None:
    print(f"chaos: {msg}", flush=True)


def fail(msg: str) -> int:
    sys.stderr.write(f"chaos: FAIL: {msg}\n")
    return 1


def _put(keep: Optional[dict], **kw) -> None:
    """Hand a scenario's comparands to the caller (tests, the card run)."""
    if keep is not None:
        keep.update(kw)


def _city():
    from ..synth import build_grid_city
    return build_grid_city(rows=10, cols=10, spacing_m=200.0, seed=5,
                           service_road_fraction=0.0, internal_fraction=0.0)


def _lines(city, n_traces: int, seed: int = 9):
    import numpy as np
    from ..synth import generate_trace
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_traces):
        tr = None
        while tr is None:
            tr = generate_trace(city, f"veh-{i}", rng, noise_m=3.0,
                                min_route_edges=8)
        for p in tr.points:
            lines.append("|".join([tr.uuid, str(p["lat"]), str(p["lon"]),
                                   str(p["time"]), str(p["accuracy"])]))
    return lines


def _requests(city, prefix: str, seed: int, n: int = 8,
              min_route_edges: int = 8, opts=OPTS):
    import numpy as np
    from ..synth import generate_trace
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        tr = None
        while tr is None:
            tr = generate_trace(city, f"{prefix}-{i}", rng, noise_m=3.0,
                                min_route_edges=min_route_edges)
        reqs.append({"uuid": tr.uuid, "trace": tr.points,
                     "match_options": dict(opts)})
    return reqs


def _matcher(city, device, **kw):
    from ..matcher import SegmentMatcher
    return SegmentMatcher(city, device=device, **kw)


def _make_worker(city, out_dir: str, device, state_path=None,
                 report_flush_interval_s: float = 1e9,
                 replay_interval_s: float = 0.0, replay_attempts: int = 5,
                 datastore=None, tee=None):
    from ..streaming.anonymiser import Anonymiser, TileSink
    from ..streaming.formatter import Formatter
    from ..streaming.state import StateStore
    from ..streaming.worker import StreamWorker, inproc_submitter

    service = _service(_matcher(city, device))
    worker = StreamWorker(
        Formatter.from_config(FMT), inproc_submitter(service),
        Anonymiser(TileSink(out_dir), privacy=1, quantisation=3600,
                   source="chaos", tee=tee),
        reports="0,1,2", transitions="0,1,2", flush_interval_s=1e9,
        state=StateStore(state_path, interval_s=0.0) if state_path else None,
        submit_many=service.report_many,
        report_flush_interval_s=report_flush_interval_s,
        replay_interval_s=replay_interval_s,
        replay_attempts=replay_attempts, datastore=datastore)
    worker.service = service
    return worker


def _close(worker) -> None:
    """Stop an in-process worker's dispatcher and matcher."""
    worker.service.dispatcher.close()
    worker.service.matcher.close()


def tile_tree(root: str) -> dict:
    """{relpath: bytes} of every tile file under a sink dir (spools
    excluded): the byte-parity comparand."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in (".deadletter", ".traces",
                                          ".flightrec"))
        for name in sorted(filenames):
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _as_plain(result) -> dict:
    """A match result (dict or lazy MatchRuns) as a canonical dict."""
    return {"segments": [dict(s) for s in result["segments"]],
            "mode": result["mode"]}


def _write(path: str, text: str) -> str:
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return path


def _config(path: str, graph: str, service=None, worker=None,
            datastore=None) -> str:
    """A child's ``--config`` file: the knobs the JAX harness sets in the
    environment, as the port's config keys."""
    conf = {"graph": graph}
    if service:
        conf["service"] = service
    if worker:
        conf["worker"] = worker
    if datastore:
        conf["datastore"] = datastore
    return _write(path, json.dumps(conf))


def stream_argv(graph: str, inp: str, out: str, device, conf=None,
                state=None, flush="1000000000", interval="1000000000",
                store=None, extra=()):
    """``python -m reporter_tpu_torch stream`` over a flat file, as the
    scenarios run it."""
    argv = [*PYTHON, "-m", "reporter_tpu_torch", "stream", "-f", FMT,
            "--graph", graph, "--device", str(device), "-p", "1",
            "-q", "3600", "-i", interval, "-s", "chaos", "-o", out,
            "--input", inp, "--uuid-filter", "off", "-r", "0,1,2",
            "-x", "0,1,2", "--report-flush-interval", flush]
    if conf:
        argv += ["--config", conf]
    if state:
        argv += ["--state-file", state, "--state-interval", "0"]
    if store:
        argv += ["--datastore", store]
    return argv + list(extra)


def run_child(argv) -> "subprocess.CompletedProcess":
    return subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT_S)


def _diverge(ref: dict, got: dict) -> str:
    only_ref = sorted(set(ref) - set(got))
    only_got = sorted(set(got) - set(ref))
    differ = sorted(k for k in set(ref) & set(got) if ref[k] != got[k])
    return (f"missing={only_ref[:5]} extra={only_got[:5]} "
            f"differ={differ[:5]}")


def _swap_city():
    """swap_kill's v2 graph: the same geometry and segment ids, a new
    speed profile, so a new content hash."""
    city = _city()
    city.edge_speed_kph = city.edge_speed_kph * 1.1
    return city


def _service(matcher):
    from ..service.server import ReporterService
    return ReporterService(matcher, threshold_sec=15, max_batch=64,
                           max_wait_ms=5.0)


def stream_tiles(device, lines, service=None, flush="1000000000") -> dict:
    """The tile tree of a fault-free ``stream`` child over ``lines`` on
    ``device``, its state snapshotted as the scenarios run it (``service``:
    the config's service keys); raises when the child fails."""
    with tempfile.TemporaryDirectory() as tmp:
        graph = os.path.join(tmp, "city.npz")
        _city().save(graph)
        inp = _write(os.path.join(tmp, "full.txt"), "\n".join(lines) + "\n")
        conf = _config(os.path.join(tmp, "ref.json"), graph,
                       service=service) if service else None
        out = os.path.join(tmp, "ref")
        p = run_child(stream_argv(graph, inp, out, device, conf=conf,
                                  state=os.path.join(tmp, "s_ref"),
                                  flush=flush))
        if p.returncode != 0:
            raise RuntimeError(f"fault-free run on {device} "
                               f"rc={p.returncode}: {p.stderr[-2000:]}")
        return tile_tree(out)


def worker_tiles(city, lines, device, out: str, flush: float = 1e9) -> dict:
    """The tile tree ``lines`` make through an in-process worker on
    ``device`` in ``out``."""
    worker = _make_worker(city, out, device, report_flush_interval_s=flush)
    try:
        worker.run(iter(lines))
    finally:
        _close(worker)
    return tile_tree(out)


def service_bodies(city, device, reqs):
    """(status, body text) of ``reqs`` through a fresh service on
    ``device``."""
    service = _service(_matcher(city, device))
    try:
        return _handle_all(service, reqs)
    finally:
        service.dispatcher.close()
        service.matcher.close()


def fault_free(name: str, device, keep: dict):
    """Scenario ``name``'s fault-free comparand (its ``keep["ref"]``)
    made anew on ``device`` from the inputs its run left in ``keep``: how
    a card run's comparand is held to the CPU. None for a scenario
    without one (prefork_kill holds every answer to the CPU service's
    bytes itself)."""
    if name == "kill_restore":
        return stream_tiles(device, keep["lines"])
    if name == "stream_resume":
        return stream_tiles(device, keep["lines"],
                            service={"incremental_lag": RESUME_LAG},
                            flush="0")
    if name == "storm":
        matcher = _matcher(_city(), device)
        try:
            return [_as_plain(r) for r in matcher.match_many(keep["reqs"])]
        finally:
            matcher.close()
    if name == "decode_poison":
        return service_bodies(_city(), device, keep["reqs"])
    with tempfile.TemporaryDirectory() as tmp:
        if name in ("egress_outage", "double_ingest"):
            return worker_tiles(_city(), keep["lines"], device, tmp)
        if name == "swap_kill":
            return [worker_tiles(city, lines, device,
                                 os.path.join(tmp, f"v{i}"), 0.0)
                    for i, (city, lines) in enumerate((
                        (_city(), keep["lines_a"]),
                        (_swap_city(), keep["lines_b"])))]
    return None


# ---------------------------------------------------------------------------
def scenario_storm(device="cuda", keep=None) -> int:
    """Native error storm on a host-route matcher: the prep breaker
    opens, the numpy prep serves byte-identical results, the cooldown
    passes, a probe re-closes the breaker."""
    from ..utils import faults, metrics

    city = _city()
    # cooldown sized so storm calls land well inside it on a slow box
    matcher = _matcher(city, device, circuit_threshold=3,
                       circuit_cooldown_s=3.0)
    try:
        if matcher.runtime is None:
            return fail("native runtime did not attach")
        reqs = _requests(city, "storm", 11)
        want = [_as_plain(r) for r in matcher.match_many(reqs)]
        metrics.default.reset()

        # every native prep errors until the breaker trips; no fire
        # limit, the breaker itself must stop the bleeding
        faults.configure("native.prep=error@0")
        stormed = []
        for _ in range(5):
            stormed.append([_as_plain(r) for r in matcher.match_many(reqs)])
        snap = metrics.default.snapshot()["counters"]
        if matcher.circuit.snapshot()["state"] not in ("open", "half_open"):
            return fail(f"circuit did not open: {matcher.circuit.snapshot()}")
        if not snap.get("matcher.circuit.opened"):
            return fail(f"no open transition counted: {snap}")
        if not snap.get("matcher.circuit.fallback_chunks"):
            return fail(f"no chunk was short-circuited to the numpy prep: "
                        f"{snap}")
        for got in stormed:
            if got != want:
                return fail("numpy-prep results diverged from the "
                            "fault-free native run")
        log(f"storm: circuit opened after "
            f"{snap.get('matcher.circuit.native_errors', 0)} native "
            f"errors, {snap.get('matcher.circuit.fallback_chunks')} "
            f"chunks served by the numpy prep, results byte-identical")

        faults.clear()
        time.sleep(3.2)
        after = [_as_plain(r) for r in matcher.match_many(reqs)]
        snap = metrics.default.snapshot()["counters"]
        if matcher.circuit.snapshot()["state"] != "closed":
            return fail(f"circuit did not re-close: "
                        f"{matcher.circuit.snapshot()}")
        if not snap.get("matcher.circuit.probes") \
                or not snap.get("matcher.circuit.closed"):
            return fail(f"no half-open probe/close recorded: {snap}")
        if after != want:
            return fail("post-recovery results diverged")
        _put(keep, reqs=reqs, want=want, ref=want, counters=snap)
        log(f"storm ok: probe re-closed the circuit "
            f"(probes={snap['matcher.circuit.probes']})")
        return 0
    finally:
        faults.clear()
        matcher.close()


# ---------------------------------------------------------------------------
def scenario_kill_restore(device="cuda", keep=None) -> int:
    """SIGKILL-grade crash mid-stream, restart, restore: the tiles must
    be byte-identical to an uninterrupted run."""
    from ..utils import faults

    with tempfile.TemporaryDirectory() as tmp:
        city = _city()
        graph = os.path.join(tmp, "city.npz")
        city.save(graph)
        lines = _lines(city, n_traces=8)
        k = len(lines) // 2
        full = _write(os.path.join(tmp, "full.txt"), "\n".join(lines) + "\n")
        tail = _write(os.path.join(tmp, "tail.txt"),
                      "\n".join(lines[k:]) + "\n")

        log(f"kill_restore: fault-free run over {len(lines)} probes")
        try:
            ref = stream_tiles(device, lines)
        except RuntimeError as e:
            return fail(str(e))

        out_chaos = os.path.join(tmp, "chaos")
        state = os.path.join(tmp, "s_chaos")
        log(f"kill_restore: crashing at offer {k + 1}")
        # tracing armed on the crash leg only: the flight recorder's
        # postmortem must name the exact span in flight at the kill
        conf = _config(os.path.join(tmp, "crash.json"), graph, service={
            "trace": True, "faults": f"worker.offer=crash+{k}#1"})
        p = run_child(stream_argv(graph, full, out_chaos, device,
                                  conf=conf, state=state))
        if p.returncode != faults.CRASH_EXIT_CODE:
            return fail(f"crash run rc={p.returncode} "
                        f"(want {faults.CRASH_EXIT_CODE}): "
                        f"{p.stderr[-2000:]}")
        if not os.path.exists(state):
            return fail("no state snapshot survived the crash")
        rec_dir = os.path.join(out_chaos, ".deadletter", ".flightrec")
        dumps = sorted(os.listdir(rec_dir)) if os.path.isdir(rec_dir) \
            else []
        if not dumps:
            return fail(f"crash left no flight-recorder dump in {rec_dir}")
        with open(os.path.join(rec_dir, dumps[-1]), encoding="utf-8") as f:
            post = json.load(f)
        inflight = [s["name"] for s in post.get("in_flight", [])]
        if not post["reason"].startswith("crash.worker.offer") \
                or "worker.offer" not in inflight:
            return fail(f"postmortem does not name the killed span: "
                        f"reason={post['reason']!r} in_flight={inflight}")
        log(f"kill_restore: postmortem {dumps[-1]} names in-flight "
            f"span worker.offer")

        log("kill_restore: restarting from the snapshot")
        p = run_child(stream_argv(graph, tail, out_chaos, device,
                                  state=state))
        if p.returncode != 0:
            return fail(f"restore run rc={p.returncode}: "
                        f"{p.stderr[-2000:]}")
        if "Restored state" not in p.stderr:
            return fail("restore run did not restore the snapshot")

        got = tile_tree(out_chaos)
        if not ref:
            return fail("fault-free run wrote no tiles")
        if got != ref:
            return fail(f"tile trees diverge: {_diverge(ref, got)}")
        _put(keep, lines=lines, ref=ref, got=got)
        log(f"kill_restore ok: {len(ref)} tile files byte-identical "
            f"across crash+restore")
        return 0


# ---------------------------------------------------------------------------
#: the incremental lag of stream_resume's children: fixed-lag commits
#: fire well inside the synthetic windows (so the armed commit site is
#: hot) while the decode still converges
RESUME_LAG = 16


def scenario_stream_resume(device="cuda", keep=None) -> int:
    """Incremental matcher crash-resume, two legs over the
    ``match.incremental.commit`` fault site.

    Leg A arms an error on a fixed-lag commit: the advance aborts, the
    carried states drop, and the trace serves through the windowed batch
    path, with tiles byte-identical to a fault-free run. Leg B kills the
    worker mid-stream after several incremental reports, so the last
    snapshot carries live per-trace decode states; the restarted worker
    restores them onto its device, resumes the incremental decode and
    still writes byte-identical final tiles."""
    from ..utils import faults

    with tempfile.TemporaryDirectory() as tmp:
        city = _city()
        graph = os.path.join(tmp, "city.npz")
        city.save(graph)
        lines = _lines(city, n_traces=6)
        k = len(lines) * 2 // 3  # past several incremental flushes
        full = _write(os.path.join(tmp, "full.txt"), "\n".join(lines) + "\n")
        tail = _write(os.path.join(tmp, "tail.txt"),
                      "\n".join(lines[k:]) + "\n")

        def conf(name, **service):
            return _config(os.path.join(tmp, f"{name}.json"), graph,
                           service={"incremental_lag": RESUME_LAG,
                                    **service})

        def argv(inp, out, cfg, state):
            # flush report-ready sessions at once: mid-stream reports are
            # what build and snapshot carried state
            return stream_argv(graph, inp, out, device, conf=cfg,
                               state=state, flush="0")

        plain = conf("plain")
        log(f"stream_resume: fault-free run over {len(lines)} probes")
        try:
            ref = stream_tiles(device, lines,
                               service={"incremental_lag": RESUME_LAG},
                               flush="0")
        except RuntimeError as e:
            return fail(str(e))
        if not ref:
            return fail("fault-free run wrote no tiles")

        # -- leg A: commit error -> batch-path fallback, same bytes ----
        out_err = os.path.join(tmp, "err")
        log("stream_resume: leg A, an error on a fixed-lag commit")
        p = run_child(argv(full, out_err, conf(
            "err", faults="match.incremental.commit=error#1"),
            os.path.join(tmp, "s_err")))
        if p.returncode != 0:
            return fail(f"commit-error run rc={p.returncode}: "
                        f"{p.stderr[-2000:]}")
        if "incremental match failed" not in p.stderr:
            return fail("commit fault never fired (the leg proved "
                        "nothing): no fallback warning in stderr")
        err = tile_tree(out_err)
        if err != ref:
            return fail(f"commit-error tiles diverge from fault-free: "
                        f"{_diverge(ref, err)}")
        log(f"stream_resume: leg A ok, {len(ref)} tile files "
            f"byte-identical under a commit fault")

        # -- leg B: kill mid-stream, restore the carried states, resume -
        out_chaos = os.path.join(tmp, "chaos")
        state = os.path.join(tmp, "s_chaos")
        log(f"stream_resume: leg B, crashing at offer {k + 1}")
        p = run_child(argv(full, out_chaos, conf(
            "crash", faults=f"worker.offer=crash+{k}#1"), state))
        if p.returncode != faults.CRASH_EXIT_CODE:
            return fail(f"crash run rc={p.returncode} "
                        f"(want {faults.CRASH_EXIT_CODE}): "
                        f"{p.stderr[-2000:]}")
        if not os.path.exists(state):
            return fail("no state snapshot survived the crash")
        # the snapshot must actually carry decode state: an empty section
        # would make the restore leg vacuously pass
        from ..streaming.anonymiser import Anonymiser, TileSink
        from ..streaming.batcher import PointBatcher
        from ..streaming.state import restore_bytes
        with open(state, "rb") as f:
            frames = restore_bytes(
                f.read(), PointBatcher(lambda t: None, lambda a, b: None),
                Anonymiser(TileSink(os.path.join(tmp, "probe")), 1, 3600))
        if not frames:
            return fail("crash snapshot carries no incremental decode "
                        "state")
        log(f"stream_resume: snapshot carries {len(frames)} carried "
            f"decode state(s)")

        log("stream_resume: restarting from the snapshot")
        p = run_child(argv(tail, out_chaos, plain, state))
        if p.returncode != 0:
            return fail(f"restore run rc={p.returncode}: "
                        f"{p.stderr[-2000:]}")
        if "Restored state" not in p.stderr:
            return fail("restore run did not restore the snapshot")
        if "carried incremental decode state" not in p.stderr:
            return fail("restore run did not restore the carried "
                        "incremental decode states")

        got = tile_tree(out_chaos)
        if got != ref:
            return fail(f"tile trees diverge: {_diverge(ref, got)}")
        _put(keep, lines=lines, ref=ref, err=err, got=got,
             frames=len(frames))
        log(f"stream_resume ok: {len(ref)} tile files byte-identical "
            f"across commit fault AND crash+resume")
        return 0


# ---------------------------------------------------------------------------
def scenario_submit_burst(device="cuda", keep=None) -> int:
    """Transient matcher failures requeue under the budget and recover;
    a dead matcher dead-letters trace JSON instead of dropping."""
    from ..utils import faults, metrics

    with tempfile.TemporaryDirectory() as tmp:
        city = _city()
        lines = _lines(city, n_traces=4)

        # part 1: a 2-failure burst (within the default budget of 2)
        metrics.default.reset()
        out = os.path.join(tmp, "burst")
        worker = _make_worker(city, out, device, report_flush_interval_s=0.0)
        faults.configure("matcher.submit=error@0#2")
        try:
            worker.run(iter(lines))
        finally:
            faults.clear()
            _close(worker)
        snap = metrics.default.snapshot()["counters"]
        if not snap.get("batch.requeued"):
            return fail(f"burst did not requeue: {snap}")
        if snap.get("batch.dropped"):
            return fail(f"burst within budget still dropped: {snap}")
        tiles = tile_tree(out)
        if not tiles:
            return fail("no tiles written after requeue recovery")
        log(f"submit_burst: {snap['batch.requeued']} requeues, 0 drops, "
            f"tiles written after recovery")

        # part 2: the matcher stays dead: the budget runs out, the trace
        # JSON dead-letters, the stream itself survives
        metrics.default.reset()
        out2 = os.path.join(tmp, "dead")
        worker = _make_worker(city, out2, device,
                              report_flush_interval_s=0.0)
        faults.configure("matcher.submit=error@0")
        try:
            worker.run(iter(lines))
        finally:
            faults.clear()
            _close(worker)
        snap2 = metrics.default.snapshot()["counters"]
        if not snap2.get("batch.dropped") or not snap2.get("batch.deadletter"):
            return fail(f"dead matcher did not dead-letter: {snap2}")
        spool = worker.batcher.deadletter_dir
        names = sorted(os.listdir(spool)) if os.path.isdir(spool) else []
        if not names:
            return fail("no trace JSON in the dead-letter spool")
        with open(os.path.join(spool, names[0]), encoding="utf-8") as f:
            body = json.load(f)
        if not body.get("uuid") or not body.get("trace"):
            return fail(f"unreplayable dead-letter body: {body}")
        _put(keep, lines=lines, tiles=tiles, burst=snap, dead=snap2,
             spooled=len(names))
        log(f"submit_burst ok: dead matcher -> {len(names)} trace(s) "
            f"spooled for replay, stream survived")
        return 0


# ---------------------------------------------------------------------------
def scenario_egress_outage(device="cuda", keep=None) -> int:
    """Sink outage: every tile dead-letters; ``ingest_dir(delete=True)``
    replays the spool into a store that matches a fault-free run's."""
    from ..datastore import LocalDatastore, ingest_dir
    from ..utils import faults, metrics

    with tempfile.TemporaryDirectory() as tmp:
        city = _city()
        lines = _lines(city, n_traces=6)

        metrics.default.reset()
        out = os.path.join(tmp, "out")
        worker = _make_worker(city, out, device)
        faults.configure("egress.http=error@0")
        try:
            worker.run(iter(lines))
        finally:
            faults.clear()
            _close(worker)
        snap = metrics.default.snapshot()["counters"]
        if not snap.get("egress.fail") or not snap.get("egress.deadletter"):
            return fail(f"outage not spooled: {snap}")
        if tile_tree(out):
            return fail("tiles reached a dead sink")
        spool = worker.anonymiser.sink.deadletter

        ds = LocalDatastore(os.path.join(tmp, "store"))
        got = ingest_dir(ds, spool, delete=True)
        if not got["rows"] or got["failures"]:
            return fail(f"dead-letter replay failed: {got}")
        leftover = list(tile_tree(spool))
        if leftover:
            return fail(f"replayed spool not drained: {leftover[:5]}")

        # fault-free control run -> the same aggregate store contents
        out2 = os.path.join(tmp, "out2")
        ref = worker_tiles(city, lines, device, out2)
        ds2 = LocalDatastore(os.path.join(tmp, "store2"))
        ingest_dir(ds2, out2)
        s1, s2 = ds.stats(), ds2.stats()
        for key in ("rows", "cells", "transitions"):
            if s1[key] != s2[key]:
                return fail(f"replayed store diverges on {key}: "
                            f"{s1[key]} != {s2[key]}")
        _put(keep, lines=lines, tiles=ref, ref=ref,
             cells=ds.merged_cells(), stats=s1)
        log(f"egress_outage ok: {got['files']} tiles replayed from the "
            f"spool, store parity with fault-free run ({s1['rows']} rows)")
        return 0


# ---------------------------------------------------------------------------
def _handle_all(service, reqs):
    """(status, body text) of each request through the service's
    handler, one at a time."""
    out = []
    for req in reqs:
        code, body = service.handle(dict(req))
        if not isinstance(body, str):
            body = bytes(body).decode("utf-8")
        out.append((code, body))
    return out


def scenario_decode_poison(device="cuda", keep=None) -> int:
    """The decode and assemble failure domains. A decode storm answers
    500 until the decode breaker opens, then 503 with ``Retry-After``
    while it is open, with no chunk decoded anywhere (the port's card
    domains never degrade to a host decode); after the cooldown a probe
    re-closes it and answers the healthy bytes. Then a poisoned assemble
    quarantines exactly ONE trace to the dead-letter spool while every
    other trace's bytes stay identical."""
    from ..utils import faults, metrics

    city = _city()
    matcher = _matcher(city, device, circuit_threshold=3,
                       circuit_cooldown_s=3.0)
    service = _service(matcher)
    try:
        reqs = _requests(city, "poison", 12)
        healthy = _handle_all(service, reqs)
        if any(code != 200 for code, _b in healthy):
            return fail(f"fault-free answers {[c for c, _b in healthy]}")
        metrics.default.reset()

        # part 1: decode storm; every dispatch errors until the breaker
        # trips, then every request is refused before its launch
        faults.configure("decode.dispatch=error@0")
        stormed = []
        for _ in range(5):
            stormed += _handle_all(service, reqs)
        snap = metrics.default.snapshot()["counters"]
        codes = [code for code, _b in stormed]
        if matcher.circuit_decode.snapshot()["state"] not in ("open",
                                                             "half_open"):
            return fail(f"decode circuit did not open: "
                        f"{matcher.circuit_decode.snapshot()}")
        if not snap.get("matcher.circuit.decode.opened"):
            return fail(f"no decode open transition counted: {snap}")
        if set(codes) != {500, 503}:
            return fail(f"storm answers {sorted(set(codes))}, want 500 "
                        f"then 503")
        for code, body in stormed:
            err = json.loads(body)
            if code == 500 and "injected error" not in err["error"]:
                return fail(f"a 500 that is not the injected error: {body}")
            if code == 503 and (err.get("domain") != "decode.dispatch"
                                or not err.get("retry_after_s")
                                or err["retry_after_s"] <= 0):
                return fail(f"a 503 without its domain or Retry-After: "
                            f"{body}")
        if snap.get("matcher.circuit.decode.errors") != codes.count(500):
            return fail(f"{codes.count(500)} answers 500 but "
                        f"{snap.get('matcher.circuit.decode.errors')} "
                        f"decode errors counted")
        if not snap.get("matcher.circuit.decode.refused_chunks"):
            return fail(f"no chunk refused while open: {snap}")
        if snap.get("matcher.circuit.decode.fallback_chunks"):
            return fail(f"a chunk degraded to a host decode: {snap}")
        log(f"decode_poison: decode circuit opened after "
            f"{codes.count(500)} errors (500), then {codes.count(503)} "
            f"requests refused (503, Retry-After), no decode elsewhere")

        faults.clear()
        time.sleep(3.2)
        after = _handle_all(service, reqs)
        snap = metrics.default.snapshot()["counters"]
        if matcher.circuit_decode.snapshot()["state"] != "closed":
            return fail(f"decode circuit did not re-close: "
                        f"{matcher.circuit_decode.snapshot()}")
        if not snap.get("matcher.circuit.decode.probes") \
                or not snap.get("matcher.circuit.decode.closed"):
            return fail(f"no decode probe/close recorded: {snap}")
        if after != healthy:
            return fail("post-recovery answers diverged")
        log("decode_poison: probe re-closed the decode circuit, answers "
            "byte-identical")

        # part 2: poisoned assemble. On the native path the first
        # eligible call is the whole-batch assembler (breaker failure ->
        # trace-by-trace), so one more firing poisons exactly one trace;
        # the numpy path goes straight to the per-trace loop
        want = [_as_plain(r) for r in matcher.match_many(reqs)]
        metrics.default.reset()
        with tempfile.TemporaryDirectory() as spool:
            matcher.quarantine_spool = spool
            limit = 2 if matcher.runtime is not None else 1
            faults.configure(f"matcher.assemble=error@0#{limit}")
            try:
                got = [_as_plain(r) for r in matcher.match_many(reqs)]
            finally:
                faults.clear()
                matcher.quarantine_spool = None
            snap = metrics.default.snapshot()["counters"]
            if snap.get("matcher.assemble.quarantined") != 1:
                return fail(f"expected exactly 1 quarantined trace: {snap}")
            poisoned = [i for i, (g, w) in enumerate(zip(got, want))
                        if g != w]
            if len(poisoned) != 1:
                return fail(f"poison leaked past one trace: {poisoned}")
            if got[poisoned[0]]["segments"]:
                return fail("poisoned trace did not degrade to an empty "
                            "match")
            names = sorted(os.listdir(spool))
            if len(names) != 1:
                return fail(f"expected 1 spooled poison body: {names}")
            with open(os.path.join(spool, names[0]), encoding="utf-8") as f:
                body = json.load(f)
            if body.get("uuid") != reqs[poisoned[0]]["uuid"] \
                    or not body.get("trace"):
                return fail(f"unreplayable poison body: {str(body)[:200]}")
        _put(keep, reqs=reqs, healthy=healthy, ref=healthy, codes=codes,
             want=want,
             got=got, poisoned=poisoned[0])
        log(f"decode_poison ok: 1 trace quarantined "
            f"({reqs[poisoned[0]]['uuid']}), other {len(reqs) - 1} "
            f"traces byte-identical")
        return 0
    finally:
        faults.clear()
        service.dispatcher.close()
        matcher.close()


# ---------------------------------------------------------------------------
def store_fingerprint(root: str) -> dict:
    """{relpath: bytes} of a datastore tree: the byte-parity comparand
    (meta.json excluded: it carries a wall-clock 'created' stamp; dot
    files and dirs excluded: the lease, the profile memo, stage dirs and
    orphan asides are control state, not data)."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith("."))
        for name in sorted(filenames):
            if name == "meta.json" or name.startswith("."):
                continue
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def scenario_double_ingest(device="cuda", keep=None) -> int:
    """The (epoch, tile) dedupe ledger: a ``delete=True`` re-run of an
    already-ingested directory appends NOTHING (store byte-identical),
    and a worker crash-replayed between tee ingest and epoch commit
    re-offers every flush, deduped, the store equal to a fault-free
    run's."""
    from ..datastore import LocalDatastore, ingest_dir
    from ..utils import faults, metrics

    with tempfile.TemporaryDirectory() as tmp:
        city = _city()
        lines = _lines(city, n_traces=6)

        # leg 1: directory replay idempotence
        out = os.path.join(tmp, "out")
        tiles = worker_tiles(city, lines, device, out)
        store_dir = os.path.join(tmp, "store")
        ds = LocalDatastore(store_dir)
        first = ingest_dir(ds, out)
        if not first["rows"]:
            return fail(f"first ingest empty: {first}")
        before = store_fingerprint(store_dir)
        metrics.default.reset()
        again = ingest_dir(ds, out, delete=True)
        snap = metrics.default.snapshot()["counters"]
        if again["rows"] != 0:
            return fail(f"re-ingest appended rows: {again}")
        if not snap.get("datastore.ingest.deduped"):
            return fail(f"no dedupe counted: {snap}")
        if store_fingerprint(store_dir) != before:
            return fail("re-ingest changed store bytes")
        if tile_tree(out):
            return fail("delete left tile files behind")
        log(f"double_ingest: delete re-run of {again['files']} files "
            f"deduped to 0 rows, store byte-identical")

        # leg 2: crash between tee ingest + egress and the epoch commit
        # (worker.post_egress) -> restart re-emits the whole flush ->
        # the ledger dedupes the tee, the sink overwrites the tiles
        graph = os.path.join(tmp, "city.npz")
        city.save(graph)
        full = _write(os.path.join(tmp, "full.txt"), "\n".join(lines) + "\n")
        empty = _write(os.path.join(tmp, "empty.txt"), "")

        out_ref = os.path.join(tmp, "ref_out")
        store_ref = os.path.join(tmp, "ref_store")
        p = run_child(stream_argv(graph, full, out_ref, device,
                                  state=os.path.join(tmp, "s_ref"),
                                  store=store_ref))
        if p.returncode != 0:
            return fail(f"fault-free run rc={p.returncode}: "
                        f"{p.stderr[-2000:]}")

        out_chaos = os.path.join(tmp, "chaos_out")
        store_chaos = os.path.join(tmp, "chaos_store")
        state = os.path.join(tmp, "s_chaos")
        conf = _config(os.path.join(tmp, "crash.json"), graph, service={
            "faults": "worker.post_egress=crash#1"})
        p = run_child(stream_argv(graph, full, out_chaos, device, conf=conf,
                                  state=state, store=store_chaos))
        if p.returncode != faults.CRASH_EXIT_CODE:
            return fail(f"crash run rc={p.returncode} "
                        f"(want {faults.CRASH_EXIT_CODE}): "
                        f"{p.stderr[-2000:]}")
        # restart over an EMPTY stream: everything re-emitted comes from
        # the restored snapshot, the pure crash-replay window
        p = run_child(stream_argv(graph, empty, out_chaos, device,
                                  state=state, store=store_chaos))
        if p.returncode != 0:
            return fail(f"restore run rc={p.returncode}: "
                        f"{p.stderr[-2000:]}")
        if "dedupe" not in p.stderr:
            return fail("restore run logged no ledger dedupe: the tee "
                        "replay was not deduplicated")

        ref_t, got_t = tile_tree(out_ref), tile_tree(out_chaos)
        if not ref_t or got_t != ref_t:
            return fail(f"tile trees diverge across crash-replay: "
                        f"ref={len(ref_t)} got={len(got_t)}")
        s_ref = LocalDatastore(store_ref).stats()
        s_got = LocalDatastore(store_chaos).stats()
        for key in ("rows", "cells", "transitions"):
            if s_ref[key] != s_got[key]:
                return fail(f"crash-replayed store diverges on {key}: "
                            f"{s_got[key]} != {s_ref[key]}")
        _put(keep, lines=lines, tiles=tiles, ref=tiles, ref_tiles=ref_t,
             cells=LocalDatastore(store_chaos).merged_cells(),
             ref_cells=LocalDatastore(store_ref).merged_cells())
        log(f"double_ingest ok: crash-replayed tee deduped "
            f"({s_got['rows']} rows, {len(got_t)} tile files "
            f"byte-identical to fault-free)")
        return 0


# ---------------------------------------------------------------------------
def scenario_replay_drain(device="cuda", keep=None) -> int:
    """The dead-letter replayer: a full matcher + sink outage spools
    every trace and tile; once the outage clears, the drainer empties
    both spools (re-submitting traces through the live pipeline,
    re-egressing tiles) and the datastore ends equal to a fresh ingest
    of the final tile tree: nothing lost, nothing duplicated."""
    from ..datastore import LocalDatastore, ingest_dir
    from ..utils import faults, metrics

    with tempfile.TemporaryDirectory() as tmp:
        city = _city()
        lines = _lines(city, n_traces=6)
        metrics.default.reset()
        out = os.path.join(tmp, "out")
        store = LocalDatastore(os.path.join(tmp, "store"))

        def tee(_tile, segments, ingest_key=None):
            return store.ingest_segments(segments, ingest_key=ingest_key)

        worker = _make_worker(city, out, device, report_flush_interval_s=0.0,
                              replay_interval_s=1e6, replay_attempts=10,
                              datastore=store, tee=tee)
        try:
            if worker.drainer is None:
                return fail("drainer did not arm")

            # phase 1: total matcher outage: every submit (live and
            # replayed alike) fails, so every qualifying trace
            # dead-letters; nothing reports, so no tiles exist yet
            faults.configure("matcher.submit=error@0,egress.http=error@0")
            try:
                worker.run(iter(lines))
            finally:
                faults.clear()
            snap = metrics.default.snapshot()["counters"]
            if not snap.get("batch.deadletter"):
                return fail(f"outage spooled no traces: {snap}")
            backlog = worker.drainer.backlog()
            if not backlog["traces"]:
                return fail(f"trace spool empty before drain: {backlog}")
            log(f"replay_drain: matcher outage spooled "
                f"{backlog['traces']} trace(s)")

            # phase 2: matcher back, sink still down: the drainer
            # re-submits every spooled trace; their segments flush to
            # tiles, which fail egress and seed the TILE spool
            faults.configure("egress.http=error@0")
            try:
                worker.drain()
            finally:
                faults.clear()
            snap = metrics.default.snapshot()["counters"]
            if not snap.get("replay.traces.ok"):
                return fail(f"drainer re-submitted no traces: {snap}")
            if not snap.get("egress.deadletter"):
                return fail(f"recovered flush spooled no tiles: {snap}")
            backlog = worker.drainer.backlog()
            if backlog["traces"]:
                return fail(f"trace spool not drained: {backlog}")
            if not backlog["tiles"]:
                return fail(f"tile spool empty before drain: {backlog}")
            log(f"replay_drain: sink outage spooled {backlog['tiles']} "
                f"tile(s) from the recovered flush")

            # phase 3: everything back: one drain cycle re-egresses the
            # spooled tiles and leaves both spools empty
            worker.drain()
        finally:
            _close(worker)
        snap = metrics.default.snapshot()["counters"]
        backlog = worker.drainer.backlog()
        if backlog["traces"] or backlog["tiles"]:
            return fail(f"spools not drained: {backlog}")
        if snap.get("replay.quarantined"):
            return fail(f"recoverable entries were quarantined: {snap}")
        if not snap.get("replay.traces.ok") \
                or not snap.get("replay.tiles.ok"):
            return fail(f"drainer replayed nothing: {snap}")
        tiles = tile_tree(out)
        if not tiles:
            return fail("no tiles reached the sink after drain")

        # store parity: the tee-fed store must equal a fresh store built
        # from the final tile tree (end-to-end exactly-once)
        fresh = LocalDatastore(os.path.join(tmp, "fresh"))
        got = ingest_dir(fresh, out)
        if got["failures"]:
            return fail(f"tile-tree ingest failed: {got}")
        s1, s2 = store.stats(), fresh.stats()
        for key in ("rows", "cells", "transitions"):
            if s1[key] != s2[key]:
                return fail(f"store diverges on {key}: "
                            f"{s1[key]} != {s2[key]}")
        _put(keep, lines=lines, tiles=tiles, cells=store.merged_cells(),
             counters=snap)
        log(f"replay_drain ok: {snap['replay.traces.ok']} trace(s) "
            f"re-submitted, {snap['replay.tiles.ok']} tile(s) "
            f"re-egressed, spools empty, store parity ({s1['rows']} rows)")
        return 0


# ---------------------------------------------------------------------------
#: prefork_kill's child: ``python -c SCRIPT <device> <mesh 0|1>``. The
#: parent builds the city and the request bodies (numpy only) and forks;
#: each worker opens the device after the fork. It prints one VERDICT
#: line: the worker tags, the restarted slot's new tag, the retries and
#: every answer's body text by request number.
_PREFORK_SCRIPT = r"""
import json, os, signal, socket, sys, threading, time, urllib.request

import numpy as np

from reporter_tpu_torch.service.prefork import serve_prefork
from reporter_tpu_torch.synth import build_grid_city, generate_trace

device, mesh = sys.argv[1], sys.argv[2] == "1"
city = build_grid_city(rows=8, cols=8, spacing_m=200.0, seed=3,
                       service_road_fraction=0.0, internal_fraction=0.0)
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
base = f"http://127.0.0.1:{port}"


def make_service(slot, procs):
    # after the fork, in each worker: the device opens here
    import torch
    from reporter_tpu_torch.matcher import SegmentMatcher
    from reporter_tpu_torch.service.server import ReporterService
    dev = torch.device(device)
    m = SegmentMatcher(city, device=dev,
                       mesh_devices=[dev, dev] if mesh else None)
    if mesh:
        assert m.decode_mesh is not None \
            and len(m.decode_mesh.devices) == 2, m.decode_mesh
    return ReporterService(m, threshold_sec=15, max_batch=64,
                           max_wait_ms=5.0)


def req_body(seed):
    rng = np.random.default_rng(seed)
    tr = None
    while tr is None:
        tr = generate_trace(city, f"veh-{seed}", rng, noise_m=3.0)
    return json.dumps(tr.request_json()).encode()


def call(path, body=None, timeout=120.0):
    r = urllib.request.Request(base + path, data=body,
                               method="POST" if body else "GET")
    with urllib.request.urlopen(r, timeout=timeout) as resp:
        return resp.status, resp.headers.get("X-Reporter-Proc"), resp.read()


verdict = {"ok": False, "bodies": {}}


def note(i, tag, body):
    verdict["bodies"].setdefault(str(i), {})[tag] = body.decode()


def probe():
    time.sleep(2.0)  # fork window: the workers fork off a quiet parent
    try:
        _probe()
    except Exception as e:
        verdict["err"] = f"{type(e).__name__}: {e}"


def _probe():
    deadline = time.time() + 300
    while True:
        try:
            call("/stats", timeout=5)
            break
        except Exception:
            if time.time() > deadline:
                verdict["err"] = "service never came up"
                return
            time.sleep(0.2)
    bodies = [req_body(i) for i in range(6)]
    tags = {}
    for i in range(300):
        st, tag, raw = call("/report", bodies[i % len(bodies)])
        assert st == 200 and tag
        note(i % len(bodies), tag, raw)
        tags.setdefault(tag.split(":")[0], tag)
        if len(tags) == 2 and i >= 10:
            break
    if len(tags) < 2:
        verdict["err"] = f"one worker answered everything: {tags}"
        return
    os.kill(int(tags["p0"].split(":")[1]), signal.SIGKILL)
    retried = 0
    for i in range(30):
        try:
            st, tag, raw = call("/report", bodies[i % len(bodies)])
        except Exception:
            retried += 1
            st, tag, raw = call("/report", bodies[i % len(bodies)])
        assert st == 200
        note(i % len(bodies), tag, raw)
        time.sleep(0.02)
    new_tag = None
    deadline = time.time() + 300
    while time.time() < deadline:
        _st, tag, _ = call("/stats", timeout=10)
        if tag and tag.startswith("p0:") and tag != tags["p0"]:
            new_tag = tag
            break
        time.sleep(0.1)
    # the successor answers under load too
    answered = 0
    for i in range(300):
        if answered >= len(bodies):
            break
        st, tag, raw = call("/report", bodies[i % len(bodies)])
        assert st == 200
        note(i % len(bodies), tag, raw)
        answered += tag == new_tag
    verdict.update(ok=bool(new_tag) and answered > 0, retried=retried,
                   tags=sorted(tags.values()), new_tag=new_tag,
                   successor_answers=answered)


t = threading.Thread(target=probe, daemon=True)
try:
    urllib.request.urlopen(base + "/stats", timeout=0.2)
except Exception:
    pass  # warms the opener machinery in the MAIN thread, pre-fork
t.start()


def reaper():
    t.join()
    os.kill(os.getpid(), signal.SIGTERM)


threading.Thread(target=reaper, daemon=True).start()
rc = serve_prefork(make_service, "127.0.0.1", port, 2, 16)
print("VERDICT:" + json.dumps(verdict))
sys.exit(0 if verdict.get("ok") and rc == 0 else 1)
"""


def prefork_requests():
    """prefork_kill's city and its six requests, as its service script
    makes them."""
    import numpy as np
    from ..synth import build_grid_city, generate_trace
    city = build_grid_city(rows=8, cols=8, spacing_m=200.0, seed=3,
                           service_road_fraction=0.0, internal_fraction=0.0)
    reqs = []
    for seed in range(6):
        rng = np.random.default_rng(seed)
        tr = None
        while tr is None:
            tr = generate_trace(city, f"veh-{seed}", rng, noise_m=3.0)
        reqs.append(tr.request_json())
    return city, reqs


def prefork_bodies():
    """The answers to :func:`prefork_requests` from an in-process service
    on the CPU: the bytes every worker must give."""
    city, reqs = prefork_requests()
    return service_bodies(city, "cpu", reqs)


def scenario_prefork_kill(device="cuda", keep=None, mesh=False,
                          want=None) -> int:
    """2-process ``SO_REUSEPORT`` serving under load: both workers
    answer, one is SIGKILLed mid-load, the supervisor restarts it in its
    slot (new pid), no request fails after one retry, and every answer,
    the successor's among them, is the CPU service's bytes. With
    ``mesh`` each worker's matcher decodes over a mesh naming its device
    twice. ``want`` is :func:`prefork_bodies` (made here when None). Then
    the identity half: two workers sharing one sink with distinct
    ``writer_id`` keys never emit colliding epoch tile names."""
    if want is None:
        want = prefork_bodies()
    if any(code != 200 for code, _b in want):
        return fail(f"CPU service answered {[c for c, _b in want]}")
    p = run_child([*PYTHON, "-c", _PREFORK_SCRIPT, str(device),
                   "1" if mesh else "0"])
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("VERDICT:")]
    if p.returncode != 0 or not lines:
        return fail(f"prefork service leg rc={p.returncode}: "
                    f"{(p.stdout + p.stderr)[-2000:]}")
    verdict = json.loads(lines[-1][len("VERDICT:"):])
    for i, by_tag in verdict["bodies"].items():
        for tag, body in by_tag.items():
            if body != want[int(i)][1]:
                return fail(f"worker {tag} answered request {i} with "
                            f"other bytes than the CPU service")
    answered = {tag for by_tag in verdict["bodies"].values()
                for tag in by_tag}
    if verdict["new_tag"] not in answered:
        return fail(f"the restarted worker {verdict['new_tag']} answered "
                    f"nothing")
    log(f"prefork_kill: workers {verdict['tags']} -> SIGKILL p0 -> "
        f"restarted as {verdict['new_tag']} "
        f"({verdict['retried']} request(s) needed their one retry), "
        f"{verdict['successor_answers']} answers from the successor, "
        f"every body the CPU service's"
        + (", each worker on a 2-entry mesh" if mesh else ""))

    # the identity half: each writer's epoch names are its own
    from ..streaming.anonymiser import Anonymiser, TileSink
    with tempfile.TemporaryDirectory() as tmp:
        names = {}
        for slot in range(2):
            a = Anonymiser(TileSink(os.path.join(tmp, "out")), privacy=1,
                           quantisation=3600, source="chaos",
                           writer_id=f"p{slot}")
            names[slot] = a.epoch_file_name(0)
        if names[0] == names[1]:
            return fail(f"slot writer ids collide: {names}")
    _put(keep, verdict=verdict, names=names)
    log(f"prefork_kill ok: epoch file names per slot {names}")
    return 0


# ---------------------------------------------------------------------------
def _assert_untorn(store):
    """Every manifest parses and every segment it lists loads with all
    its columns: the 'no torn manifest' post-crash invariant. Returns
    an error string or None."""
    for level, index in store.partitions():
        pdir = store.partition_dir(level, index)
        manifest = store._read_manifest(pdir)
        for name in manifest["segments"]:
            if store.load_segment(pdir, name) is None:
                return (f"manifest {level}/{index} lists {name} but its "
                        "columns are missing: a torn commit")
    return None


def shard_lines(lines, writers: int):
    """Writer shards by uuid crc32 (each line's uuid is its first
    field): the multi-writer ownership contract, pre-partitioned."""
    shards = [[] for _ in range(writers)]
    for line in lines:
        uuid = line.split("|", 1)[0]
        shards[zlib.crc32(uuid.encode()) % writers].append(line)
    return shards


def scenario_lease_kill(device="cuda", keep=None) -> int:
    """The cross-process writer lease under SIGKILL: two writer workers,
    the dead-letter drainer and the background compactor all pointed at
    ONE store; the compaction holder is killed mid-commit (crash
    failpoint in the widest window); another process steals the dead
    holder's lease, the manifests are untorn, the exactly-once ledger
    still dedupes every flush, and the recovered store's cells equal a
    fault-free ingest of the same tile trees."""
    from ..datastore import LocalDatastore, ingest_dir
    from ..utils import faults, metrics

    with tempfile.TemporaryDirectory() as tmp:
        city = _city()
        lines = _lines(city, n_traces=8)
        graph = os.path.join(tmp, "city.npz")
        city.save(graph)
        inputs = [_write(os.path.join(tmp, f"in-{w}.txt"),
                         "\n".join(lns) + "\n")
                  for w, lns in enumerate(shard_lines(lines, 2))]

        def run_shard(w, store, fault=None):
            out_dir = os.path.join(tmp, f"chaos-{w}")
            service = {"faults": fault} if fault else None
            conf = _config(
                os.path.join(tmp, f"w{w}.json"), graph, service=service,
                worker={"writer_id": f"w{w}", "compact_interval_s": 0.05,
                        "replay_interval_s": 0.2},
                datastore={"root": store, "lease_ttl_s": 30.0})
            # continuous report flushes -> many tee ingests a partition
            # -> real delta pressure for the paced compactor to crash in
            p = run_child(stream_argv(
                graph, inputs[w], out_dir, device, conf=conf, flush="0",
                interval="0", store=store,
                extra=("--datastore-max-deltas", "1")))
            return out_dir, p

        # writer 0 crashes mid-compaction HOLDING the lease; writer 1
        # then runs fault-free against the dead holder's store
        store_chaos = os.path.join(tmp, "store_chaos")
        outs = []
        out_dir, p = run_shard(0, store_chaos, "datastore.compact=crash#1")
        outs.append(out_dir)
        if p.returncode != faults.CRASH_EXIT_CODE:
            return fail(f"chaos writer 0 rc={p.returncode} "
                        f"(want {faults.CRASH_EXIT_CODE}): "
                        f"{p.stderr[-2000:]}")

        ds = LocalDatastore(store_chaos)
        err = _assert_untorn(ds)
        if err:
            return fail(err)

        # THIS process is "another process": the killed holder never
        # released, so our first mutation must STEAL the dead pid's lease
        metrics.default.reset()
        ingest_dir(ds, out_dir)
        snap = metrics.default.snapshot()["counters"]
        if not snap.get("datastore.lease.steals"):
            return fail(f"no lease steal counted after holder death: "
                        f"{ {k: v for k, v in snap.items() if 'lease' in k} }")
        # hand it back so writer 1 serves the same store cleanly
        ds.lease.release()

        out_dir, p = run_shard(1, store_chaos)
        outs.append(out_dir)
        if p.returncode != 0:
            return fail(f"chaos writer 1 rc={p.returncode}: "
                        f"{p.stderr[-2000:]}")

        # recovery converges the store: replay every sink tree (deduped
        # for flushes the tees committed, appended for any the crash
        # lost) and finish the interrupted compaction
        metrics.default.reset()
        for out_dir in outs:
            ingest_dir(ds, out_dir)
        ds.compact(max_deltas=0)
        snap = metrics.default.snapshot()["counters"]
        if not snap.get("datastore.ingest.deduped"):
            return fail("ledger deduped nothing on the recovery replay: "
                        "the exactly-once ledger was lost in the crash")

        # end-to-end exactly-once: the recovered store equals a FRESH
        # fault-free ingest of the same tile trees, cell for cell
        ref = LocalDatastore(os.path.join(tmp, "store_fresh"))
        for out_dir in outs:
            ingest_dir(ref, out_dir)
        cells = ds.merged_cells()
        if cells != ref.merged_cells():
            return fail("recovered store cells differ from a fresh "
                        "fault-free ingest of the same tiles")
        # and a SECOND replay into the recovered store appends nothing
        for out_dir in outs:
            got = ingest_dir(ds, out_dir)
            if got["rows"]:
                return fail(f"re-ingest appended {got['rows']} rows: the "
                            "ledger failed to dedupe after the crash")
        if ds.merged_cells() != cells:
            return fail("re-ingest changed store cells despite 0 rows")

        # the datastore.lease failpoint: an injected lease-layer fault
        # refuses the mutation loudly instead of proceeding on an
        # unknown lease state
        faults.configure("datastore.lease=error#1")
        refused = None
        try:
            ds.lease._deadline = 0.0  # force the slow path
            try:
                ds.compact(max_deltas=0)
            except Exception as e:
                refused = e
        finally:
            faults.clear()
        if refused is None:
            return fail("datastore.lease=error did not refuse the mutation")
        log(f"lease_kill: the lease fault refused the compaction: "
            f"{refused}")
        _put(keep, lines=lines, tiles=[tile_tree(o) for o in outs],
             cells=cells)

    log("lease_kill ok: mid-compaction SIGKILL left no torn manifest, "
        "the next process stole the dead holder's lease, the ledger "
        "deduped the replay, store cells equal a fresh fault-free ingest "
        "of the same tiles")
    return 0


# ---------------------------------------------------------------------------
#: swap_kill's child: ``python -c SCRIPT <store> <g1> <g2> <tiles>
#: <device> <faults>``. No endpoint starts a swap, so the victim drives
#: CityRegistry in process: load v1 (stamping the store's epoch), commit
#: the pre-swap tile tree, then swap to v2 with the city.swap crash
#: failpoint armed. The failpoint sits in the WIDEST window (candidate
#: loaded and shadow-gated, nothing flipped), so the exit lands with the
#: datastore lease still held and both versions resident.
_SWAP_CHILD_SCRIPT = r"""
import sys

from reporter_tpu_torch.datastore import ingest_dir
from reporter_tpu_torch.service.cities import CityRegistry
from reporter_tpu_torch.utils import faults

store, g1, g2, out_a, device, spec = sys.argv[1:7]
faults.configure(spec)
reg = CityRegistry(config={"metro": {"graph": g1, "datastore": store}},
                   budget_bytes=1 << 40, device=device)
entry = reg.get("metro")
assert entry.map_version, "v1 load did not mint a map version"
got = ingest_dir(entry.service.datastore, out_a)
assert got["rows"] and not got["failures"], got
reg.swap("metro", {"graph": g2, "datastore": store})
sys.exit(3)  # unreachable when the failpoint is armed
"""


def scenario_swap_kill(device="cuda", keep=None) -> int:
    """Zero-downtime map lifecycle under SIGKILL: a registry process
    dies at the ``city.swap`` crash failpoint, the widest swap window
    (candidate v2 loaded and shadow-gated, v1 still serving, lease
    held). Recovery steals the dead holder's lease, replays the pre-swap
    tile tree under v1's epoch (ledger-deduped: it committed before the
    crash) and the post-swap tree under v2's, and ends with store cells
    equal to a fault-free run's, every base segment tagged exactly ONE
    epoch, and per-epoch pinned views matching the reference. A pre-swap
    dead-letter trace spool then drains through the NEW graph."""
    from ..datastore import EpochView, LocalDatastore, ingest_dir
    from ..graph.version import map_version
    from ..utils import faults, metrics

    def pinned_cells(store, mv):
        # merged_cells only sweeps partitions()/live_segments(), the
        # protocol EpochView serves: call it unbound on the view
        return LocalDatastore.merged_cells(EpochView(store, mv))

    with tempfile.TemporaryDirectory() as tmp:
        city = _city()
        # v2: same geometry and segment ids (shadow scores agree), new
        # speed profile -> a genuinely different content hash
        city2 = _swap_city()
        g1 = os.path.join(tmp, "city-v1.npz")
        g2 = os.path.join(tmp, "city-v2.npz")
        city.save(g1)
        city2.save(g2)
        mv1, mv2 = map_version(city), map_version(city2)
        if mv1 == mv2:
            return fail("speed change did not mint a new map version")

        # tile trees: A is pre-swap (v1) traffic, B post-swap (v2)
        lines_a = _lines(city, n_traces=6, seed=9)
        lines_b = _lines(city2, n_traces=6, seed=31)
        out_a = os.path.join(tmp, "tiles-v1")
        out_b = os.path.join(tmp, "tiles-v2")
        trees = [worker_tiles(c, lns, device, out, 0.0) for c, lns, out in (
            (city, lines_a, out_a), (city2, lines_b, out_b))]
        if not all(trees):
            return fail("tile trees empty before the chaos leg")

        # chaos leg: the victim ingests tree A under v1, then dies at the
        # city.swap failpoint holding the lease
        store_chaos = os.path.join(tmp, "store_chaos")
        p = run_child([*PYTHON, "-c", _SWAP_CHILD_SCRIPT, store_chaos, g1,
                       g2, out_a, str(device), "city.swap=crash#1"])
        if p.returncode != faults.CRASH_EXIT_CODE:
            return fail(f"swap victim rc={p.returncode} "
                        f"(want {faults.CRASH_EXIT_CODE}): "
                        f"{p.stderr[-2000:]}")

        ds = LocalDatastore(store_chaos)
        err = _assert_untorn(ds)
        if err:
            return fail(err)

        # recovery is "another process": the first mutation must STEAL
        # the lease; the pre-swap tree re-ingests under v1's epoch and
        # every flush the victim committed dedupes through the
        # epoch-qualified ledger
        metrics.default.reset()
        ds.set_map_version(mv1)
        ingest_dir(ds, out_a)
        snap = metrics.default.snapshot()["counters"]
        if not snap.get("datastore.lease.steals"):
            return fail(f"no lease steal counted after victim death: "
                        f"{ {k: v for k, v in snap.items() if 'lease' in k} }")
        if not snap.get("datastore.ingest.deduped"):
            return fail("epoch-qualified ledger deduped nothing on the v1 "
                        "recovery replay: exactly-once lost")
        ds.set_map_version(mv2)
        got = ingest_dir(ds, out_b)
        if not got["rows"] or got["failures"]:
            return fail(f"v2 ingest after recovery failed: {got}")
        ds.compact(max_deltas=0)

        # epoch integrity: every post-compaction segment carries exactly
        # one tag, both epochs exist, nothing mixes
        tags_seen = set()
        for level, index in ds.partitions():
            manifest = ds._read_manifest(ds.partition_dir(level, index))
            tags = manifest.get("epochs", {})
            for name in manifest["segments"]:
                tag = tags.get(name)
                if tag not in (mv1, mv2):
                    return fail(f"segment {level}/{index}/{name} has epoch "
                                f"tag {tag!r} (want {mv1} or {mv2}): a "
                                f"mixed or missing epoch")
                tags_seen.add(tag)
        if tags_seen != {mv1, mv2}:
            return fail(f"expected both epochs in the recovered store, "
                        f"got {sorted(tags_seen)}")

        # parity with a fault-free run of the same two epochs: merged
        # cells AND each pinned view, cell for cell
        ref = LocalDatastore(os.path.join(tmp, "store_fresh"))
        ref.set_map_version(mv1)
        ingest_dir(ref, out_a)
        ref.set_map_version(mv2)
        ingest_dir(ref, out_b)
        ref.compact(max_deltas=0)
        cells = ds.merged_cells()
        if cells != ref.merged_cells():
            return fail("recovered store cells differ from a fresh "
                        "fault-free two-epoch ingest")
        pinned = {}
        for mv in (mv1, mv2):
            pinned[mv] = pinned_cells(ds, mv)
            if pinned[mv] != pinned_cells(ref, mv):
                return fail(f"pinned view {mv} differs from the fault-free "
                            f"reference: epochs mixed across the crash")
        # a second replay of BOTH trees appends nothing (either epoch)
        for mv, out_dir in ((mv1, out_a), (mv2, out_b)):
            ds.set_map_version(mv)
            got = ingest_dir(ds, out_dir)
            if got["rows"]:
                return fail(f"re-ingest under {mv} appended {got['rows']} "
                            f"rows: the ledger failed after the crash")
        _put(keep, lines_a=lines_a, lines_b=lines_b, tiles_v1=trees[0],
             tiles_v2=trees[1], ref=trees,
             mv1=mv1, mv2=mv2, cells=cells, pinned=pinned)

        # drainer leg: trace JSON spooled on v1 (dead matcher) replays
        # through the NEW graph's pipeline without crashing
        metrics.default.reset()
        out_sw = os.path.join(tmp, "swapspool")
        w1 = _make_worker(city, out_sw, device, report_flush_interval_s=0.0)
        faults.configure("matcher.submit=error@0")
        try:
            w1.run(iter(lines_a))
        finally:
            faults.clear()
            _close(w1)
        snap = metrics.default.snapshot()["counters"]
        if not snap.get("batch.deadletter"):
            return fail(f"dead matcher spooled no pre-swap traces: {snap}")
        w2 = _make_worker(city2, out_sw, device, report_flush_interval_s=0.0,
                          replay_interval_s=1e6, replay_attempts=10)
        try:
            if w2.drainer is None:
                return fail("post-swap drainer did not arm")
            backlog = w2.drainer.backlog()
            if not backlog["traces"]:
                return fail(f"pre-swap spool empty before the post-swap "
                            f"drain: {backlog}")
            w2.drain()
        finally:
            _close(w2)
        snap = metrics.default.snapshot()["counters"]
        if not snap.get("replay.traces.ok"):
            return fail(f"post-swap drainer replayed no pre-swap traces: "
                        f"{snap}")
        backlog = w2.drainer.backlog()
        if backlog["traces"]:
            return fail(f"pre-swap spool not drained on the new graph: "
                        f"{backlog}")

    log(f"swap_kill ok: mid-swap SIGKILL (epochs {mv1} -> {mv2}) left no "
        "torn manifest, the lease steal was clean, both epochs recovered "
        "to fault-free parity with single-tagged segments, and the "
        "pre-swap spool drained through the new graph")
    return 0


# ---------------------------------------------------------------------------
def scenario_overload_recovery(device="cuda", keep=None) -> int:
    """Load management end to end: drive the service past capacity with
    admission armed -> the gate sheds (counted, every 429 carrying
    Retry-After) and the pressure ladder steps DOWN with its rung effects
    applied; an injected ``admission.gate`` fault fails OPEN (admitted,
    counted); cut the load -> the ladder steps back UP under hysteresis
    through /health ticks, /health answers 200 with no open breaker, and
    a backpressure-shed streaming spool drains to empty through the
    dead-letter drainer."""
    import threading

    from ..obs import profiler, slo
    from ..service import admission
    from ..service.server import ReporterService
    from ..utils import faults, metrics

    service = None
    try:
        # the health-SLO budget is generous on purpose: pressure here
        # comes from the bounded queue, and recovery must be able to
        # show a 200 /health
        slo.configure("service.handle=5000")
        metrics.default.reset()
        admission._reset_module()

        city = _city()
        reqs = _requests(city, "ovl", 23, n=6, min_route_edges=6,
                         opts={"mode": "auto", "report_levels": [0, 1],
                               "transition_levels": [0, 1]})
        service = ReporterService(_matcher(city, device), threshold_sec=15,
                                  max_batch=8, max_wait_ms=5.0, queue_max=4,
                                  admission=True, inflight_max=4,
                                  pressure_hold_s=0.1)
        if service.admission is None:
            return fail("admission: true built no gate")
        # deterministic capacity: a per-trace service floor stands in
        # for device decode cost (the model tools/overload.py uses)
        orig_match = service.dispatcher._match_many
        service.dispatcher._match_many = \
            lambda b: (time.sleep(0.03 * len(b)), orig_match(b))[1]

        def call(req):
            gate = service.admission
            shed = gate.admit()
            if shed is not None:
                return 429, shed.retry_after_s
            try:
                code, body = service.handle(dict(req))
            finally:
                gate.release()
            retry = None
            if code == 429:
                # the dispatcher-backstop shed: its Retry-After rides the
                # body (the HTTP handler lifts it into the header)
                retry = json.loads(body).get("retry_after_s")
            return code, retry

        # ---- phase 1: drive past capacity -------------------------
        results = []
        res_lock = threading.Lock()
        stop = threading.Event()

        def hammer(idx):
            while not stop.is_set():
                got = call(reqs[idx % len(reqs)])
                with res_lock:
                    results.append(got)
                if got[0] == 429:
                    # a well-behaved client backs off
                    time.sleep(0.01)

        threads = [threading.Thread(target=hammer, args=(i,), daemon=True)
                   for i in range(12)]
        for th in threads:
            th.start()
        time.sleep(1.5)
        stop.set()
        for th in threads:
            th.join(timeout=60.0)
        sheds = [r for r in results if r[0] == 429]
        oks = [r for r in results if r[0] == 200]
        errors = [r for r in results if r[0] not in (200, 429)]
        if errors:
            return fail(f"{len(errors)} hard errors under overload")
        if not sheds or not oks:
            return fail(f"expected both sheds and admits: {len(sheds)} "
                        f"sheds / {len(oks)} oks")
        if any(not r[1] or r[1] <= 0 for r in sheds):
            return fail("a shed carried no positive Retry-After")
        reg = metrics.default
        counted = sum(reg.counter(f"admission.shed.{r}") for r in
                      ("queue", "slo", "inflight")) \
            + reg.counter("dispatch.queue.rejected") \
            + reg.counter("dispatch.queue.evicted")
        if counted < len(sheds):
            return fail(f"{len(sheds)} sheds but only {counted} counted: "
                        "silent loss on the shed path")
        level_down = admission.current_level()
        if level_down < 1:
            return fail("sustained sheds never stepped the ladder down")
        if not profiler.shadow_stats()["suspended"]:
            return fail("shed_shadow rung did not suspend the sampler")
        log(f"overload: {len(oks)} admitted, {len(sheds)} shed (all "
            f"counted, Retry-After set), ladder at "
            f"{admission.RUNGS[level_down]}")

        # ---- phase 2: an injected gate fault fails OPEN -------------
        faults.configure("admission.gate=error#1")
        code, _retry = call(reqs[0])
        faults.clear()
        if code != 200:
            return fail(f"gate fault did not fail open (got {code})")
        if not reg.counter("admission.errors"):
            return fail("gate fault was not counted")
        log("gate fault failed open: request admitted, error counted")

        # ---- phase 3: cut load; the ladder steps back up via /health -
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            service.health()
            if admission.current_level() == 0:
                break
            time.sleep(0.05)
        if admission.current_level() != 0:
            return fail(f"ladder stuck at level {admission.current_level()} "
                        f"after load cut")
        code, body = service.health()
        health = json.loads(body)
        if code != 200:
            return fail(f"/health {code} after recovery: {body[:300]}")
        if health["degraded"]["open"]:
            return fail(f"open breakers after recovery: "
                        f"{health['degraded']['open']}")
        if health["pressure"]["level"] != 0 \
                or health["pressure"]["transitions"] < 2:
            return fail(f"pressure block wrong: {health['pressure']}")
        if profiler.shadow_stats()["suspended"]:
            return fail("shadow sampling still suspended at level 0")
        log(f"recovered: /health 200, ladder at normal after "
            f"{health['pressure']['transitions']} transitions")

        # ---- phase 4: a backpressure-shed spool drains --------------
        from ..core.types import Point
        from ..streaming.backpressure import BackpressureGovernor
        from ..streaming.batcher import PointBatcher
        from ..streaming.drainer import DeadLetterDrainer
        with tempfile.TemporaryDirectory() as spool_dir:
            trace_spool = os.path.join(spool_dir, ".traces")

            def resubmit(body):
                code, resp = service.handle(dict(body))
                if code != 200:
                    return None
                if not isinstance(resp, str):
                    resp = bytes(resp).decode("utf-8")
                return json.loads(resp)

            governor = BackpressureGovernor(latency_high_s=0.001,
                                            depth_high=1)
            governor.ewma_s = 1.0  # pinned severe pressure
            batcher = PointBatcher(resubmit, lambda k, s: None,
                                   deadletter_dir=trace_spool,
                                   governor=governor)
            if not batcher.governor.should_shed():
                return fail("governor not shedding at pinned pressure")
            t0 = 1700000000
            for i in range(12):
                batcher.process("bp-veh", Point(
                    lat=0.001 * i, lon=0.0, accuracy=5,
                    time=t0 + 30 * i), (t0 + 30 * i) * 1000)
            shed_count = metrics.default.counter("backpressure.shed")
            files = [f for f in os.listdir(trace_spool)
                     if f.endswith(".json")] \
                if os.path.isdir(trace_spool) else []
            if not shed_count or not files:
                return fail(f"backpressure shed nothing (count="
                            f"{shed_count}, files={files})")
            drainer = DeadLetterDrainer(spool_dir, trace_root=trace_spool,
                                        submit=resubmit,
                                        forward=lambda key, seg: None)
            drainer.drain_now()
            left = [f for f in os.listdir(trace_spool) if f.endswith(".json")]
            if left:
                return fail(f"spool did not drain: {left}")
            log(f"backpressure: {shed_count} session(s) shed to the spool "
                f"under pinned pressure, drained to empty on recovery")
        _put(keep, admitted=len(oks), shed=len(sheds), counted=counted,
             level_down=level_down, backpressure_shed=shed_count)
        return 0
    finally:
        faults.clear()
        slo.configure("")
        if service is not None:
            service.dispatcher.close()
            service.matcher.close()
        metrics.default.reset()
        admission._reset_module()


SCENARIOS = {
    "storm": scenario_storm,
    "kill_restore": scenario_kill_restore,
    "stream_resume": scenario_stream_resume,
    "prefork_kill": scenario_prefork_kill,
    "submit_burst": scenario_submit_burst,
    "egress_outage": scenario_egress_outage,
    "decode_poison": scenario_decode_poison,
    "double_ingest": scenario_double_ingest,
    "replay_drain": scenario_replay_drain,
    "lease_kill": scenario_lease_kill,
    "swap_kill": scenario_swap_kill,
    "overload_recovery": scenario_overload_recovery,
}


def check_device(name: str):
    """The tools' device: ``cuda`` (or ``cuda:I``) needs a card and
    raises without one; ``cpu`` is taken as asked."""
    from ..matcher import resolve_device
    return resolve_device(name)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m reporter_tpu_torch.tools.chaos",
        description="scripted failure scenarios over the port's stack")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:I or cpu")
    ap.add_argument("scenarios", nargs="*",
                    help=f"'all' or any of {sorted(SCENARIOS)} "
                         "(default: storm kill_restore)")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    names = args.scenarios or ["storm", "kill_restore"]
    if names == ["all"]:
        names = list(SCENARIOS)
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        return fail(f"unknown scenario(s) {unknown}; one of "
                    f"{sorted(SCENARIOS)} or 'all'")
    for name in names:
        log(f"=== scenario {name} ===")
        rc = SCENARIOS[name](str(device))
        if rc:
            return rc
    log(f"all {len(names)} scenario(s) passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
