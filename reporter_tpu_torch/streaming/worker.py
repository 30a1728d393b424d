"""The streaming worker: raw probe stream -> anonymised traffic tiles.

The port of ``reporter_tpu/streaming/worker.py``. Single-process topology
mirroring the reference's Kafka Streams worker (reference:
Reporter.java:21-39 topology diagram, :138-194 wiring):

    raw -> [Formatter] -> (uuid, Point) -> [PointBatcher] -> (key, Segment)
        -> [Anonymiser] -> tiles -> file / http / s3

with the matcher reached either in-process (the default: report-ready
sessions flush as one ``ReporterService.report_incremental`` call, the
carried-state decode on the card) or over HTTP for split deployments
(the reference's only mode, Batch.java:66-72).

Run::

    python -m reporter_tpu_torch.streaming.worker -f <formatter>
        --graph city.npz -p <privacy> -q <quantisation> -i <flush s>
        -s <source> -o <output> [--config conf.json] [--device cpu]

CLI options named after the reference's (Reporter.java:43-136):
  --formatter/-f   one-string formatter config
  --reporter-url/-u  http endpoint; omit for in-process matching
  --mode/-m --reports/-r --transitions/-x
  --privacy/-p --quantisation/-q --flush-interval/-i
  --source/-s --output-location/-o --duration/-d
plus --input (flat file / '-' for stdin replay) or --bootstrap/-b with
--topics/-t for Kafka, --state-file/--state-interval,
--report-flush-interval and --deadletter as in the JAX package, and the
port's --state-every (a snapshot every N processed messages).

``--config`` takes the service's config file (``service/server.py``
``read_config``: ``graph``, which ``--graph`` overrides, ``matcher`` and
``service``) plus a ``worker`` block whose keys stand for the JAX
package's environment knobs (``WORKER_KEYS``):

  heartbeat_s             REPORTER_TPU_HEARTBEAT_S            (0.0, off)
  retry_budget            REPORTER_TPU_SUBMIT_RETRIES         (2)
  backpressure            REPORTER_TPU_BACKPRESSURE           (true)
  backpressure_latency_s  REPORTER_TPU_BACKPRESSURE_LATENCY_S (1.0)
  writer_id               REPORTER_TPU_WRITER_ID              ("")
  replay_interval_s       REPORTER_TPU_REPLAY_INTERVAL_S      (0.0, off)
  replay_attempts         REPORTER_TPU_REPLAY_ATTEMPTS        (5)
  aws_access_key_id,      AWS_ACCESS_KEY_ID,                  (none)
  aws_secret_access_key   AWS_SECRET_ACCESS_KEY
  session_gap_ms          (StreamWorker's argument)           (60000)

The in-process matcher runs on ``cuda`` unless given ``--device cpu``,
and the worker exits non-zero without CUDA. The JAX package's
``--datastore*`` flags and the tee, and ``--uuid-filter`` with the
multi-host init, are not ported yet (``StreamWorker(uuid_filter=)``
is).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
import time
from typing import Callable, Iterable, Optional

from ..obs import flightrec, profiler
from ..obs import trace as obs_trace
from ..utils import faults, metrics
from ..utils import http as http_egress
from ..utils import spool as spool_mod
from .anonymiser import Anonymiser, TileSink
from .backpressure import DEFAULT_LATENCY_HIGH_S, BackpressureGovernor
from .batcher import SESSION_GAP_MS, PointBatcher
from .drainer import DeadLetterDrainer
from .formatter import Formatter

logger = logging.getLogger("reporter_tpu_torch.streaming")

#: the config file's ``worker`` block: StreamWorker's, the anonymiser's
#: and the tile sink's knobs
WORKER_KEYS = ("heartbeat_s", "retry_budget", "backpressure",
               "backpressure_latency_s", "writer_id", "replay_interval_s",
               "replay_attempts", "aws_access_key_id",
               "aws_secret_access_key", "session_gap_ms")


def _pressure_level() -> dict:
    """The process-wide degradation-ladder state for the heartbeat (a
    pure-streaming process without the serving tier loaded reports the
    quiescent shape without importing it)."""
    admission = sys.modules.get("reporter_tpu_torch.service.admission")
    if admission is None:
        return {"level": 0, "state": "normal", "transitions": 0}
    return admission.pressure_snapshot()


def http_submitter(url: str) -> Callable[[dict], Optional[dict]]:
    """POST the trace to a matcher service, with the reference's retry
    policy; returns parsed JSON or None (reference: HttpClient.java:65-103).
    """
    def submit(trace: dict) -> Optional[dict]:
        body = json.dumps(trace, separators=(",", ":"))
        text = http_egress.post(url, body, content_type="application/json")
        if text is None:
            return None
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            logger.error("unparseable matcher response from %s: %s", url, e)
            return None
    return submit


def inproc_submitter(service) -> Callable[[dict], Optional[dict]]:
    """Use a ReporterService in this process."""
    def submit(trace: dict) -> Optional[dict]:
        code, body = service.handle(trace)
        if code != 200:
            logger.error("in-process match failed (%d): %s", code, body)
            return None
        # the native wire path hands back a memoryview of the chunk
        # buffer (zero-copy for sockets); json.loads wants bytes/str
        return json.loads(bytes(body) if isinstance(body, memoryview)
                          else body)
    return submit


class StreamWorker:
    """Wires formatter -> batcher -> anonymiser and drives punctuation.

    ``heartbeat_s`` paces the structured heartbeat (0: off);
    ``retry_budget`` and ``governor`` go to the :class:`PointBatcher`;
    ``replay_interval_s`` (0: off) and ``replay_attempts`` arm the
    :class:`DeadLetterDrainer`."""

    def __init__(self, formatter: Formatter,
                 submit: Callable[[dict], Optional[dict]],
                 anonymiser: Anonymiser,
                 mode: str = "auto", reports: str = "0,1",
                 transitions: str = "0,1",
                 flush_interval_s: float = 3600.0,
                 session_gap_ms: int = SESSION_GAP_MS,
                 clock=time.time,
                 state=None,
                 uuid_filter: Optional[Callable[[str], bool]] = None,
                 submit_many=None,
                 report_flush_interval_s: float = 1.0,
                 trace_deadletter: Optional[str] = None,
                 circuit_probe: Optional[Callable[[], str]] = None,
                 degraded_probe: Optional[Callable[[], list]] = None,
                 incremental_probe: Optional[
                     Callable[[], Optional[dict]]] = None,
                 on_evict: Optional[Callable[[str], None]] = None,
                 map_version: Optional[str] = None,
                 heartbeat_s: float = 0.0,
                 retry_budget: int = 2,
                 governor: Optional[BackpressureGovernor] = None,
                 replay_interval_s: float = DeadLetterDrainer
                 .DEFAULT_INTERVAL_S,
                 replay_attempts: int = DeadLetterDrainer.DEFAULT_ATTEMPTS):
        self.formatter = formatter
        # content-derived identity of the graph this worker matches
        # against (graph/version.py), surfaced in the heartbeat; None
        # when the owner wired no graph probe
        self.map_version = map_version
        # predicate deciding which uuids this worker owns; None = all
        self.uuid_filter = uuid_filter
        self.skipped_other_host = 0
        self.anonymiser = anonymiser
        spool = getattr(getattr(anonymiser, "sink", None),
                        "deadletter", None)
        if trace_deadletter is None:
            # default next to the tile dead-letter spool, dot-prefixed so
            # a tile replay over that spool never mistakes a trace JSON
            # for a tile CSV; stub sinks without a spool leave it off
            # (log-and-drop)
            if spool:
                trace_deadletter = os.path.join(spool, ".traces")
        # the flight recorder dumps its postmortems next to the spools
        # (dot-prefixed like them); an explicit ``flightrec_dir`` config
        # key wins (main re-applies it after building the worker)
        if spool:
            flightrec.set_dump_dir(os.path.join(spool, ".flightrec"))
        # register the spool roots so the matcher's poisoned-trace
        # quarantine and /health's backlog gauges find them. Last writer
        # wins: main wires matcher.quarantine_spool per matcher, and the
        # heartbeat reads the per-instance roots, not the globals
        self._tile_spool = spool or None
        self._trace_spool = trace_deadletter
        spool_mod.set_tile_dir(spool or None)
        spool_mod.set_trace_dir(trace_deadletter)
        # automated dead-letter replay: paced on THIS thread via
        # maybe_punctuate (the anonymiser/batcher have no locks),
        # re-submitting spooled traces through the live submit path and
        # re-egressing spooled tiles through the live sink
        self.drainer = None
        if replay_interval_s > 0 and (spool or trace_deadletter):
            self.drainer = DeadLetterDrainer(
                spool or None, trace_root=trace_deadletter,
                submit=submit,
                forward=lambda key, seg: self.anonymiser.process(key, seg),
                sink=getattr(anonymiser, "sink", None),
                interval_s=replay_interval_s,
                max_attempts=replay_attempts)
        self.batcher = PointBatcher(
            submit, lambda key, seg: self.anonymiser.process(key, seg),
            mode=mode, report_on=reports, transition_on=transitions,
            session_gap_ms=session_gap_ms, submit_many=submit_many,
            retry_budget=retry_budget, governor=governor,
            deadletter_dir=trace_deadletter, on_evict=on_evict)
        self.flush_interval_s = flush_interval_s
        self.session_gap_ms = session_gap_ms
        self.clock = clock
        self.processed = 0
        self.parse_failures = 0
        self._last_flush = clock()
        self._last_evict = clock()
        # wall-clock bound on how long a threshold-crossed session may sit
        # in the batcher's pending set before a batched flush
        self.report_flush_interval_s = report_flush_interval_s
        self._last_report_flush = clock()
        # structured heartbeat: wall-clock paced (monotonic, independent
        # of injected replay clocks), one JSON line a beat; 0 disables
        self.heartbeat_s = float(heartbeat_s)
        # circuit-state probe for the heartbeat (in-process deployments
        # pass the matcher's breaker; HTTP splits have none to read);
        # degraded_probe names the OPEN domains (matcher.open_domains)
        self.circuit_probe = circuit_probe
        self.degraded_probe = degraded_probe
        # carried-state gauge for the incremental matcher path
        # (IncrementalTable.gauge(); None until the table exists)
        self.incremental_probe = incremental_probe
        self._hb_last = time.monotonic()
        self._hb_processed = 0
        # durable state (StateStore): restore open batches + tile slices
        # from the last snapshot; the reference instead loses in-memory
        # state on crash (BatchingProcessor.java:20-22)
        self.state = state
        self.restored = bool(
            state and state.restore(self.batcher, self.anonymiser))

    def offer(self, message: str) -> None:
        """One raw message through the topology."""
        # the per-message span opens BEFORE the crash failpoint so a
        # SIGKILL-grade death lands inside it: the flight-recorder
        # postmortem then names this exact span as in flight
        with obs_trace.span("worker.offer"):
            # chaos hook: kill the worker at an exact stream position
            # ("crash at the Nth offer"); one flag check when off
            faults.failpoint("worker.offer")
            now_ms = int(self.clock() * 1000)
            try:
                uuid, point = self.formatter.format(message)
            except Exception:
                self.parse_failures += 1
                if self.parse_failures % 1000 == 1:
                    logger.warning("Could not parse message: %r",
                                   message[:200])
                return
            if self.uuid_filter is not None and not self.uuid_filter(uuid):
                self.skipped_other_host += 1
                return
            self.batcher.process(uuid, point, now_ms)
            self.processed += 1
            if self.processed % 10000 == 0:
                logger.info("Processed %d messages", self.processed)
            self.maybe_punctuate()
            # backpressure: when the submit-latency EWMA or requeue depth
            # crosses its threshold, the offer loop BLOCKS (bounded)
            # before the next message. Real wall sleep on purpose:
            # injected replay clocks must not defeat flow control
            delay = self.batcher.offer_delay()
            if delay > 0.0:
                metrics.count("backpressure.delays")
                time.sleep(delay)

    def maybe_punctuate(self, force: bool = False) -> None:
        now = self.clock()
        flushed = False
        if self.batcher.pending and (
                force or now - self._last_report_flush
                >= self.report_flush_interval_s):
            self.batcher.flush_pending()
            self._last_report_flush = now
        if force or (now - self._last_evict) * 1000 >= 2 * self.session_gap_ms:
            self.batcher.punctuate(int(now * 1000))
            self._last_evict = now
            flushed = True
        if force or now - self._last_flush >= self.flush_interval_s:
            self._flush_tiles()
            self._last_flush = now
            flushed = True
        if self.state is not None:
            # tiles just egressed (an external side effect): snapshot
            # NOW, else a crash would restore and re-emit them. A failed
            # snapshot degrades (wider replay window, counted) instead
            # of killing the stream; the flush-epoch marker keeps the
            # widened window duplicate-free
            try:
                if flushed:
                    self.state.save(self.batcher, self.anonymiser)
                else:
                    self.state.maybe_save(self.batcher, self.anonymiser)
            except Exception as e:
                metrics.count("state.save.fail")
                logger.error("state snapshot failed (will retry): %s", e)
        if self.drainer is not None:
            self.drainer.maybe_drain()
        if self.heartbeat_s > 0:
            self._maybe_heartbeat()

    def _maybe_heartbeat(self) -> None:
        """Emit the structured heartbeat when its wall interval elapsed:
        one JSON line with throughput, in-flight state, the flush epoch
        and the circuit state. Paced by message arrival (the worker is
        single threaded by design): a stalled input emits none, which IS
        the stall signal."""
        now = time.monotonic()
        dt = now - self._hb_last
        if dt < self.heartbeat_s:
            return
        rate = (self.processed - self._hb_processed) / dt if dt > 0 else 0.0
        self._hb_last = now
        self._hb_processed = self.processed
        waste = profiler.padding_waste()
        logger.info("heartbeat %s", json.dumps({
            "processed": self.processed,
            "msgs_per_s": round(rate, 1),
            "batches_in_flight": len(self.batcher.store),
            "pending_reports": len(self.batcher.pending),
            "flush_epoch": self.anonymiser.flush_epoch,
            "circuit": self.circuit_probe() if self.circuit_probe
            else None,
            # which guarded domains are serving degraded right now
            # (open breakers; [] = all closed, None = no probe wired)
            "degraded": self.degraded_probe() if self.degraded_probe
            else None,
            # dead-letter backlog gauges of THIS worker's roots
            "deadletter": {
                "tiles": spool_mod.backlog_cached(self._tile_spool),
                "traces": spool_mod.backlog_cached(self._trace_spool)},
            "parse_failures": self.parse_failures,
            # the JAX package's background-compaction backlog: no
            # datastore in the port yet
            "datastore_backlog": None,
            # the device-compute vitals (obs/profiler.py)
            "padding_waste": round(waste, 4) if waste is not None
            else None,
            "compile_count": profiler.compile_count(),
            "shadow_mismatches": profiler.shadow_mismatches(),
            # load management: the process-wide degradation ladder and
            # this worker's backpressure sensors
            "pressure": _pressure_level(),
            "backpressure": self.batcher.governor.snapshot(),
            # carried incremental decode state (None = no probe wired,
            # or the table was never built)
            "incremental": self.incremental_probe()
            if self.incremental_probe else None,
            "map_version": self.map_version,
        }, separators=(",", ":")))

    def _flush_tiles(self) -> None:
        """Tile egress bracketed by durability barriers.

        Pre-egress snapshot: the reports that fed this flush already
        trimmed their batches; making those trims durable BEFORE the
        tiles leave the process means a crash anywhere in the flush
        cannot restore untrimmed batches that would re-report (and so
        re-emit) segments the sink already has. Post-egress, the
        committed-epoch marker lands AFTER the sink ack and BEFORE the
        next snapshot, so restore can tell "flushed then crashed"
        (skip the epoch) from "crashed mid-flush" (re-emit under the
        same deterministic names: an overwrite, not a duplicate)."""
        # the barrier only matters when something can actually egress
        if self.state is not None and self.anonymiser.slice_of:
            try:
                self.state.save(self.batcher, self.anonymiser)
            except Exception as e:
                metrics.count("state.save.fail")
                logger.error("pre-flush snapshot failed (flushing "
                             "anyway): %s", e)
        epoch = self.anonymiser.flush_epoch
        written = self.anonymiser.punctuate()
        # chaos hook: tiles at the sink, nothing durable about it yet
        faults.failpoint("worker.post_egress")
        # only a flush that fully reached the sink commits its epoch
        if self.state is not None and written > 0:
            try:
                self.state.commit_epoch(epoch)
            except Exception as e:
                # degraded: a restore would re-emit this epoch under the
                # same deterministic names (overwrite, not duplicate)
                metrics.count("state.epoch_commit.fail")
                logger.error("flush-epoch commit failed for %d: %s",
                             epoch, e)

    def drain(self) -> None:
        """End of stream: evict every open batch, then stop in
        dependency order: join the shadow pool and give the dead-letter
        replayer a final drain + pause before the final flush, so no
        thread outlives the handles that flush is about to release."""
        self.batcher.punctuate(int(self.clock() * 1000)
                               + 10 * self.session_gap_ms)
        profiler.shutdown_shadow_pool()
        if self.drainer is not None:
            self.drainer.drain_now()
            self.drainer.pause()
        self._flush_tiles()
        if self.state is not None:
            self.state.save(self.batcher, self.anonymiser)

    def run(self, messages: Iterable[str],
            duration_s: Optional[float] = None) -> None:
        deadline = self.clock() + duration_s if duration_s else None
        try:
            for message in messages:
                self.offer(message)
                if deadline is not None and self.clock() > deadline:
                    break
        except Exception as e:
            # an unhandled exception is about to kill the stream: leave
            # a postmortem naming the span that was in flight
            flightrec.dump("worker.exception", {"error": repr(e)})
            raise
        self.drain()

    def summary(self) -> dict:
        """What the run did: messages, reports and flushes, segments
        forwarded, kept and culled, tiles written, the flush epoch and
        the carried-state gauge (None without a probe or a table)."""
        b, a = self.batcher, self.anonymiser
        return {"processed": self.processed,
                "parse_failures": self.parse_failures,
                "skipped_other_host": self.skipped_other_host,
                "reports": b.reports, "flushes": b.governor.flushes,
                "segments": b.forwarded, "kept": a.kept, "culled": a.culled,
                "tiles": a.tiles_written, "flush_epoch": a.flush_epoch,
                "restored": self.restored,
                "incremental": self.incremental_probe()
                if self.incremental_probe else None}


def read_worker_config(path: str, graph: Optional[str] = None):
    """(the service's :func:`~..service.server.parse_config` of the file,
    its ``worker`` block): ``graph`` overrides the file's; an unknown
    key in either raises."""
    from ..service.server import parse_config
    with open(path) as f:
        raw = json.load(f)
    knobs = dict(raw.pop("worker", None) or {})
    unknown = set(knobs) - set(WORKER_KEYS)
    if unknown:
        raise ValueError(f"unknown worker keys {sorted(unknown)}")
    if graph:
        raw["graph"] = graph
    return parse_config(raw), knobs


def main(argv=None) -> int:
    import torch
    parser = argparse.ArgumentParser(
        prog="python -m reporter_tpu_torch.streaming.worker",
        description="streaming reporter worker: raw probes -> tiles")
    parser.add_argument("-f", "--formatter", required=True,
                        help="one-string formatter config (see README)")
    parser.add_argument("-u", "--reporter-url",
                        help="matcher service URL; omit to match in-process")
    parser.add_argument("--graph",
                        help="RoadNetwork .npz for in-process matching")
    parser.add_argument("--config",
                        help="JSON config: the service's keys (graph, "
                             "matcher, service) and a worker block")
    parser.add_argument("--device", type=torch.device, default="cuda",
                        help="cuda (default), cuda:I or cpu")
    parser.add_argument("-m", "--mode", default="auto")
    parser.add_argument("-r", "--reports", default="0,1")
    parser.add_argument("-x", "--transitions", default="0,1")
    parser.add_argument("-p", "--privacy", type=int, required=True)
    parser.add_argument("-q", "--quantisation", type=int, required=True)
    parser.add_argument("-i", "--flush-interval", type=int, required=True)
    parser.add_argument("-s", "--source", required=True)
    parser.add_argument("-o", "--output-location", required=True)
    parser.add_argument("-d", "--duration", type=int)
    parser.add_argument("--input", default="-",
                        help="flat file to replay, '-' for stdin")
    parser.add_argument("-b", "--bootstrap", help="Kafka bootstrap servers")
    parser.add_argument("-t", "--topics",
                        help="comma-separated topics; first is raw input")
    parser.add_argument("--state-file",
                        help="durable state snapshot path; restored on "
                             "start, saved every --state-interval seconds")
    parser.add_argument("--state-interval", type=float, default=30.0)
    parser.add_argument("--state-every", type=int, default=0,
                        help="snapshot every N processed messages instead "
                             "of every --state-interval seconds: a crashed "
                             "replay resumes exactly after the Nth, 2Nth, "
                             "... message")
    parser.add_argument("--report-flush-interval", type=float, default=1.0,
                        help="wall-clock bound (s) on how long a "
                             "threshold-crossed session waits for a "
                             "batched report flush; a huge value makes "
                             "flush boundaries a pure function of the "
                             "stream (deterministic replays)")
    parser.add_argument("--deadletter",
                        help="directory spooling tile bodies whose egress "
                             "failed (default <output>/.deadletter for "
                             "file sinks, <tmpdir>/reporter_tpu_deadletter "
                             "for remote)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    conf, knobs = None, {}
    if args.config:
        try:
            conf, knobs = read_worker_config(args.config, args.graph)
        except Exception as e:
            sys.stderr.write(f"Problem with config file: {e}\n")
            return 1
    elif not args.reporter_url:
        if not args.graph:
            parser.error("--graph is required for in-process matching")
        from ..service.server import parse_config
        conf = parse_config({"graph": args.graph})
    if conf is not None:
        from ..service.server import configure_faults, configure_obs
        configure_obs(conf["obs"])
        try:
            configure_faults(conf["faults"])
        except ValueError as e:
            sys.stderr.write(f"Problem with config file: {e}\n")
            return 1

    service = None
    circuit_probe = degraded_probe = incremental_probe = None
    incremental_provider = on_evict = None
    if args.reporter_url:
        submit = http_submitter(args.reporter_url)
        submit_many = None  # HTTP path: one POST per trace (split deploy)
    else:
        from ..service.server import ReporterService, matcher_from_config
        try:
            service = ReporterService(
                matcher_from_config(conf, args.device), **conf["service"])
        except Exception as e:
            sys.stderr.write(f"could not start the matcher: {e}\n")
            return 1
        submit = inproc_submitter(service)
        # batched submit for flushes: one dispatcher round trip -> one
        # device batch. report_incremental routes report-ready sessions
        # through the carried-state path and the windowed report_many
        # for every slot it declines (``incremental: false`` sends all)
        submit_many = service.report_incremental
        circuit_probe = lambda: service.matcher.circuit.state  # noqa: E731
        degraded_probe = service.matcher.open_domains

        def incremental_probe(_m=service.matcher):
            t = _m._incremental_table
            return t.gauge() if t is not None else None

        # session-gap eviction drops the session's carried decode state
        # with it, AFTER its final relaxed-threshold report flushed
        def on_evict(uuid, _m=service.matcher):
            t = _m._incremental_table
            if t is not None:
                t.evict(uuid, "session gap")

        # snapshot v3 provider: restore must BUILD the table (frames in
        # the snapshot need somewhere to live); constructing the empty
        # table is dict bookkeeping only
        incremental_provider = lambda: service.matcher.incremental_table  # noqa: E731

    state = None
    if args.state_file:
        from .state import StateStore
        state = StateStore(args.state_file, interval_s=args.state_interval,
                           incremental=incremental_provider,
                           every=args.state_every)

    credentials = None
    if knobs.get("aws_access_key_id") or knobs.get("aws_secret_access_key"):
        credentials = (knobs.get("aws_access_key_id"),
                       knobs.get("aws_secret_access_key"))
    try:
        worker = StreamWorker(
            Formatter.from_config(args.formatter), submit,
            Anonymiser(TileSink(args.output_location,
                                deadletter=args.deadletter,
                                credentials=credentials),
                       args.privacy, args.quantisation, mode=args.mode,
                       source=args.source,
                       writer_id=knobs.get("writer_id", "")),
            mode=args.mode, reports=args.reports,
            transitions=args.transitions,
            flush_interval_s=args.flush_interval, state=state,
            submit_many=submit_many,
            report_flush_interval_s=args.report_flush_interval,
            session_gap_ms=knobs.get("session_gap_ms", SESSION_GAP_MS),
            circuit_probe=circuit_probe, degraded_probe=degraded_probe,
            incremental_probe=incremental_probe, on_evict=on_evict,
            heartbeat_s=knobs.get("heartbeat_s", 0.0),
            retry_budget=knobs.get("retry_budget", 2),
            governor=BackpressureGovernor(
                latency_high_s=knobs.get("backpressure_latency_s",
                                         DEFAULT_LATENCY_HIGH_S),
                enabled=knobs.get("backpressure", True)),
            replay_interval_s=knobs.get(
                "replay_interval_s", DeadLetterDrainer.DEFAULT_INTERVAL_S),
            replay_attempts=knobs.get(
                "replay_attempts", DeadLetterDrainer.DEFAULT_ATTEMPTS))
        if conf is not None and "flightrec_dir" in conf["obs"]:
            flightrec.set_dump_dir(conf["obs"]["flightrec_dir"])
        if service is not None:
            from ..graph.version import map_version
            # the heartbeat carries the graph's content-derived version
            worker.map_version = map_version(service.matcher.net)
            # poisoned-trace quarantine lands in THIS worker's trace
            # spool (explicit beats the last-writer-wins global)
            service.matcher.quarantine_spool = worker._trace_spool

        # the flat-file input is opened under an ExitStack so the handle
        # closes on every exit path (drain, exception, --duration)
        with contextlib.ExitStack() as stack:
            if args.bootstrap:
                from .broker import KafkaBroker
                broker = KafkaBroker(args.bootstrap)
                raw_topic = (args.topics or "raw").split(",")[0]
                messages = (value.decode()
                            for _key, value in broker.consume(raw_topic))
            elif args.input == "-":
                messages = (line for line in sys.stdin)
            else:
                messages = stack.enter_context(open(args.input))
            worker.run(messages, duration_s=args.duration)
    finally:
        if service is not None:
            service.dispatcher.close()
    logger.info("Done: %d processed, %d parse failures",
                worker.processed, worker.parse_failures)
    logger.info("summary %s", json.dumps(worker.summary(),
                                          separators=(",", ":")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
