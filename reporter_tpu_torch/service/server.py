"""The /report HTTP service.

The same URL surface, request validation and error bodies as the JAX
package's service (``GET /report?json=...`` and ``POST /report`` with a
JSON body, plus ``/stats`` and ``/health``), so the streaming worker and
the test harnesses post to either. Handler threads parse and validate a
request, columnarise its points and hand them to a
:class:`~.dispatch.BatchDispatcher`, which batches concurrent requests
into one ``SegmentMatcher.match_many`` call on the card; each handler
then writes its own body from the batch's run columns
(``report_wire``).

Run::

    python -m reporter_tpu_torch.service.server <config.json> <host:port>
        [--procs N] [--device cuda|cuda:I|cpu]

The config file holds ``graph`` (a road network ``.npz``), optionally
``matcher`` (``MatchParams`` fields) and optionally ``service``, whose
keys stand for the JAX package's environment knobs:

  threshold_sec      THRESHOLD_SEC                  (15)
  max_batch          MATCH_BATCH_MAX                (MATCH_BATCH_DEFAULT)
  max_wait_ms        MATCH_BATCH_WAIT_MS            (20.0)
  idle_grace_ms      MATCH_BATCH_GRACE_MS           (2.0)
  queue_max          REPORTER_TPU_QUEUE_MAX         (4096)
  queue_policy       REPORTER_TPU_QUEUE_POLICY      ("reject")
  latency_budget_ms  REPORTER_TPU_BATCH_LATENCY_MS  (0.0, off)
  pool_size          THREAD_POOL_COUNT              (64)
  native, pipeline,  REPORTER_TPU_NATIVE, _PIPELINE, (SegmentMatcher's
  chunk,             _DECODE_CHUNK,                  defaults)
  prep_threads       _PREP_THREADS
  route_device       REPORTER_TPU_ROUTE_DEVICE      (false)
  prune_sigma        REPORTER_TPU_ROUTE_PRUNE_SIGMA (0.0, off)
  incremental        REPORTER_TPU_INCREMENTAL       (true)
  incremental_lag    REPORTER_TPU_INCREMENTAL_LAG   (32)
  incremental_mb     REPORTER_TPU_INCREMENTAL_MB    (64.0)
  trace              REPORTER_TPU_TRACE             (false)
  slo_ms             REPORTER_TPU_SLO_MS            ("", no targets)
  shadow_sample      REPORTER_TPU_SHADOW_SAMPLE     (0.0, off)
  profile_events     REPORTER_TPU_PROFILE_EVENTS    (512)
  flightrec_dir      REPORTER_TPU_FLIGHTREC         (none: no dumps)
  lockcheck          REPORTER_TPU_LOCKCHECK         (false)
  faults             REPORTER_TPU_FAULTS            (none: disarmed)
  deadletter_dir     (the worker's trace spool)     (none)
  deadletter_max_mb  REPORTER_TPU_DEADLETTER_MAX_MB (0, unbounded)
  circuit_threshold  REPORTER_TPU_CIRCUIT_THRESHOLD (5)
  circuit_cooldown_s REPORTER_TPU_CIRCUIT_COOLDOWN_S (30.0)
  admission          REPORTER_TPU_ADMISSION         (false)
  inflight_max       REPORTER_TPU_INFLIGHT_MAX      (0: 4 x max_batch)
  pressure_hold_s    REPORTER_TPU_PRESSURE_HOLD_S   (2.0)

``trace`` to ``lockcheck`` are process-wide (``configure_obs``), and so
are ``faults`` to ``circuit_cooldown_s`` (``configure_faults``; the two
circuit keys also set the matcher's breakers). Besides ``/report``,
``/stats`` and ``/health`` the server answers ``/metrics`` (Prometheus
text), ``/profile`` (the device profiler's snapshot, with the
``pressure`` and ``admission`` blocks) and ``/report?trace=1`` (the
report wrapped as ``{"report": ..., "trace": <Chrome trace events of the
request's spans>}``).

Failure answers: a decode or device route failure is a 500; while its
breaker is open a request is refused with 503 and a ``Retry-After`` of
the cooldown left, and nothing is launched for it. With ``admission``
the gate sheds before the body is read: 429 with ``Retry-After``.

The service decodes on ``cuda`` unless given ``--device cpu``, and exits
non-zero when CUDA is missing. With ``--procs N`` the process forks N
workers that share the port (``service/prefork.py``); each builds its
matcher after the fork, on the first card of its share of the visible
cards.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from ..core.tracebatch import as_trace_batch, points_to_columns
from ..graph.network import RoadNetwork
from ..graph.version import map_version
from ..matcher.matcher import MATCH_BATCH_DEFAULT, SegmentMatcher
from ..matcher.params import MatchParams
from ..obs import flightrec
from ..obs import trace as obs_trace
from ..utils import faults, locks, metrics, spool
from ..utils.circuit import (DEFAULT_COOLDOWN_S, DEFAULT_THRESHOLD,
                             CircuitOpen)
from . import wire
from .admission import (DEFAULT_HOLD_S, AdmissionGate, Overload,
                        allow_request_trace, pressure_snapshot)
from .dispatch import DEFAULT_QUEUE_MAX, BatchDispatcher
from .report import report, report_wire

logger = logging.getLogger("reporter_tpu_torch.service")

#: /report is the reference service's action; /stats is a metrics
#: snapshot (counters + stage-timer histograms), /metrics the same
#: registry as Prometheus text, /profile the device profiler's snapshot
#: (per-shape build and launch telemetry, wide events, shadow verdicts),
#: /health the liveness probe
ACTIONS = {"report", "stats", "metrics", "health", "profile"}

#: handler threads per process: they parse JSON and then wait on the
#: dispatcher, so they are IO-bound and the pool is not sized by cores
POOL_SIZE = 64

#: the config's "service" keys, by the constructor each one goes to
SERVICE_KEYS = ("threshold_sec", "max_batch", "max_wait_ms",
                "idle_grace_ms", "queue_max", "queue_policy",
                "latency_budget_ms", "admission", "inflight_max",
                "pressure_hold_s")
MATCHER_KEYS = ("native", "pipeline", "chunk", "prep_threads",
                "route_device", "prune_sigma", "incremental",
                "incremental_lag", "incremental_mb", "circuit_threshold",
                "circuit_cooldown_s")
SERVER_KEYS = ("pool_size",)
#: process-wide observability settings (configure_obs)
OBS_KEYS = ("trace", "slo_ms", "shadow_sample", "profile_events",
            "flightrec_dir", "lockcheck")
#: process-wide failure-domain settings (configure_faults); the circuit
#: keys go to the matcher too
FAULT_KEYS = ("faults", "deadletter_dir", "deadletter_max_mb",
              "circuit_threshold", "circuit_cooldown_s")

#: the spellings of "off" of a trace flag (the JAX package's)
_FALSY = ("", "0", "off", "false")


def _on(value) -> bool:
    """A config flag or ``?trace=`` value: a bool, or a string that is
    not one of the falsy spellings."""
    if isinstance(value, str):
        return value.strip().lower() not in _FALSY
    return bool(value)


def configure_obs(keys: dict) -> None:
    """Apply the config's observability keys (``OBS_KEYS``) to the
    process: ``trace`` -> ``obs.trace.configure``, ``slo_ms`` ->
    ``obs.slo.configure``, ``shadow_sample`` and ``profile_events`` ->
    ``obs.profiler.configure``, ``flightrec_dir`` ->
    ``obs.flightrec.set_dump_dir``, ``lockcheck`` -> ``utils.locks.arm``.
    A key left out keeps its current setting."""
    from ..obs import profiler, slo
    if "trace" in keys:
        obs_trace.configure(_on(keys["trace"]))
    if "slo_ms" in keys:
        slo.configure(keys["slo_ms"])
    if "shadow_sample" in keys or "profile_events" in keys:
        profiler.configure(shadow_sample=keys.get("shadow_sample"),
                           events=keys.get("profile_events"))
    if "flightrec_dir" in keys:
        flightrec.set_dump_dir(keys["flightrec_dir"])
    if "lockcheck" in keys:
        if _on(keys["lockcheck"]):
            locks.arm()
        else:
            locks.disarm()


def configure_faults(keys: dict) -> None:
    """Apply the config's failure-domain keys (``FAULT_KEYS``) to the
    process: ``faults`` -> ``utils.faults.configure`` (the spec string;
    a malformed one raises), ``deadletter_dir`` ->
    ``utils.spool.set_trace_dir`` (where quarantined traces land),
    ``deadletter_max_mb`` -> ``utils.spool.set_cap_mb``, and the circuit
    keys -> the wire writer's breaker (``service.wire``). A key left out
    keeps its current setting."""
    if "faults" in keys:
        faults.configure(keys["faults"] or None)
    if "deadletter_dir" in keys:
        spool.set_trace_dir(keys["deadletter_dir"])
    if "deadletter_max_mb" in keys:
        spool.set_cap_mb(float(keys["deadletter_max_mb"]))
    if "circuit_threshold" in keys or "circuit_cooldown_s" in keys:
        wire.circuit.configure(
            keys.get("circuit_threshold", DEFAULT_THRESHOLD),
            keys.get("circuit_cooldown_s", DEFAULT_COOLDOWN_S))


class ReporterService:
    """Owns the matcher + dispatcher; shared by all handler threads.

    ``admission`` arms the admission gate (``service/admission.py``) with
    ``inflight_max`` (0: four dispatcher batches) and the process-wide
    pressure ladder's ``pressure_hold_s``; off, every request is admitted
    and the bounded dispatcher queue is the only shed."""

    def __init__(self, matcher: SegmentMatcher, threshold_sec: int = 15,
                 max_batch: int = MATCH_BATCH_DEFAULT,
                 max_wait_ms: float = 20.0, idle_grace_ms: float = 2.0,
                 queue_max: int = DEFAULT_QUEUE_MAX,
                 queue_policy: str = "reject",
                 latency_budget_ms: float = 0.0, admission: bool = False,
                 inflight_max: int = 0,
                 pressure_hold_s: float = DEFAULT_HOLD_S):
        self.matcher = matcher
        self.threshold_sec = threshold_sec
        self.dispatcher = BatchDispatcher(
            matcher.match_many, max_batch=max_batch,
            max_wait_ms=max_wait_ms, idle_grace_ms=idle_grace_ms,
            queue_max=queue_max, queue_policy=queue_policy,
            latency_budget_ms=latency_budget_ms)
        # pre-fork identity ("p<slot>:<pid>", set by prefork.worker_main):
        # stamped on responses as X-Reporter-Proc so load tests can see
        # which worker answered; None (one process) adds no header
        self.proc_tag: str | None = None
        self.admission = (AdmissionGate(self.dispatcher,
                                        inflight_max=inflight_max,
                                        hold_s=pressure_hold_s)
                          if admission else None)

    def handle(self, trace: dict) -> "tuple[int, str | bytes | memoryview]":
        """Validate + match + report; (status, body). The 200 body is
        bytes (a memoryview of the chunk buffer on the native wire path)
        that ``_respond`` writes to the socket as is; error bodies stay
        str. The validation messages are the reference service's."""
        if trace.get("city") is not None:
            return 400, json.dumps(
                {"error": "no city registry attached; this fleet "
                          "serves a single city"})
        if trace.get("uuid") is None:
            return 400, '{"error":"uuid is required"}'
        try:
            trace["trace"][1]
        except Exception:
            return 400, ('{"error":"trace must be a non zero length array of '
                         'object each of which must have at least lat, lon '
                         'and time"}')
        try:
            report_levels = set(trace["match_options"]["report_levels"])
        except Exception:
            return 400, '{"error":"match_options must include report_levels array"}'
        try:
            transition_levels = set(trace["match_options"]["transition_levels"])
        except Exception:
            return 400, '{"error":"match_options must include transition_levels array"}'
        try:
            # columnarise the wire ONCE, in this request thread — the
            # dispatch loop and matcher never touch point dicts again
            lat, lon, tm, acc = points_to_columns(trace["trace"])
            match = self.dispatcher.submit(
                trace, columns=(trace.get("uuid"), lat, lon, tm, acc,
                                trace.get("match_options")))
            with obs_trace.span("report.serialise"):
                return 200, report_wire(match, trace, self.threshold_sec,
                                        report_levels, transition_levels)
        except Overload as e:
            # the bounded dispatcher queue shed this request: 429, with
            # the computed back-off in the body — the HTTP handler lifts
            # it into the Retry-After header
            return 429, json.dumps({"error": "overloaded",
                                    "reason": e.reason,
                                    "retry_after_s": e.retry_after_s})
        except CircuitOpen as e:
            # an open decode or device-route breaker refused this
            # request's chunk before its launch: 503, with the cooldown
            # left in the body (and the Retry-After header)
            return 503, json.dumps({"error": str(e), "domain": e.domain,
                                    "retry_after_s": e.retry_after_s})
        except Exception as e:
            return 500, json.dumps({"error": str(e)})

    def health(self) -> tuple[int, str]:
        """Liveness and degradation probe; (status, JSON body), with the
        JAX package's blocks in its order: the graph (nodes, edges, its
        content-derived ``map_version``), the host runtime ("native", or
        "fallback" for the numpy prep), the native prep's breaker
        (``circuit``), every failure domain's breaker and the open ones
        (``degraded``), the dead-letter backlog, the armed fault spec, the
        decode shadow's verdicts, the incremental decode (``enabled``, and
        once its table exists the table's gauge), the pressure ladder, the
        admission gate, the SLO targets with their breaches and the
        datastore (absent). An open domain or an SLO breach answers 503,
        "degraded": a load balancer should rotate away. A shedding gate
        is doing its job and stays 200. The call also ticks the gate, so
        an idle service's ladder steps back up."""
        from ..matcher import incremental as _inc
        from ..obs import profiler, slo
        m = self.matcher
        open_domains = m.open_domains()
        body = {
            "graph": {"loaded": True,
                      "nodes": int(m.net.num_nodes),
                      "edges": int(m.net.num_edges),
                      "map_version": map_version(m.net)},
            "native": {"status": "native" if m.runtime is not None
                       else "fallback"},
            "circuit": m.circuit.snapshot(),
            "degraded": {"open": open_domains,
                         "domains": m.circuit_snapshots()},
            "deadletter": spool.backlog_snapshot(),
            "faults": faults.active_spec(),
            "shadow": profiler.shadow_stats(),
            "incremental": {"enabled": m.incremental
                            and not _inc.pressure_shed()},
        }
        table = m._incremental_table
        if table is not None:
            body["incremental"].update(table.gauge())
        if self.admission is not None:
            self.admission.tick()
        body["pressure"] = pressure_snapshot()
        body["admission"] = (self.admission.snapshot()
                             if self.admission is not None
                             else {"armed": False})
        slo_check = slo.check()
        body["slo"] = {"targets": {k: round(v * 1000.0, 3) for k, v
                                   in slo_check["targets"].items()},
                       "breaches": slo_check["breaches"]}
        body["datastore"] = {"status": "absent"}
        healthy = not open_domains and not slo_check["breaches"]
        body["status"] = "ok" if healthy else "degraded"
        return (200 if healthy else 503,
                json.dumps(body, separators=(",", ":")))

    def report_incremental(self, traces) -> list:
        """:meth:`report_many` through the carried-state decode: the
        traces ``SegmentMatcher.match_incremental`` serves are reported
        from its matches, and every slot it declines goes through ONE
        :meth:`report_many` call. A slot's report is the same either way;
        only the latency and the ``match.incremental.*`` counters tell
        the paths apart. An error from ``match_incremental`` raises."""
        tb = as_trace_batch(traces)
        matches = self.matcher.match_incremental(tb)
        unserved = [i for i, mt in enumerate(matches) if mt is None]
        out: list = [None] * len(tb)
        if unserved:
            for i, rep in zip(unserved,
                              self.report_many(tb.gather(unserved))):
                out[i] = rep
        for i, mt in enumerate(matches):
            if mt is not None:
                out[i] = self._report(mt, tb[i])
        return out

    def report_many(self, traces) -> list:
        """Match + report a whole list — or a columnar
        :class:`~..core.tracebatch.TraceBatch` — in ONE dispatcher round
        trip; returns parsed report dicts, None for a trace that failed —
        a one-batch failure costs only that batch's traces, and the cause
        is logged. The in-process path for batch callers: no per-trace
        HTTP, no per-trace JSON."""
        matches = self.dispatcher.submit_many(traces,
                                              return_exceptions=True)
        out = []
        for trace, match in zip(traces, matches):
            if isinstance(match, Exception):
                logger.error("batched match failed for %s: %s",
                          trace.get("uuid"), match)
                out.append(None)
                continue
            out.append(self._report(match, trace))
        return out

    def _report(self, match, trace):
        """One trace's parsed report, or None (logged) when it cannot be
        built, as from a trace without report levels."""
        try:
            opts = trace["match_options"]
            return report(match, trace, self.threshold_sec,
                          set(opts["report_levels"]),
                          set(opts["transition_levels"]))
        except Exception as e:
            logger.error("report build failed for %s: %s",
                         trace.get("uuid"), e)
            return None


def make_handler(service: ReporterService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _parse(self, post: bool) -> dict:
            split = urllib.parse.urlsplit(self.path)
            if split.path.split("/")[-1] not in ACTIONS:
                raise ValueError("Try a valid action: " + str(sorted(ACTIONS)))
            if post:
                length = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(length).decode("utf-8"))
            params = urllib.parse.parse_qs(split.query)
            if "json" in params:
                return json.loads(params["json"][0])
            raise ValueError("No json provided")

        def _respond(self, code: int, body, headers=None,
                     content_type="application/json;charset=utf-8"):
            # str bodies encode here; bytes/memoryview bodies (the C
            # writer's buffer) go to the socket as they are
            raw = body.encode("utf-8") if isinstance(body, str) else body
            # one request per connection: keep-alive would pin a bounded
            # pool slot idle
            self.close_connection = True
            self.send_response(code)
            self.send_header("Access-Control-Allow-Origin", "*")
            if service.proc_tag is not None:
                self.send_header("X-Reporter-Proc", service.proc_tag)
            for key, value in (headers or {}).items():
                self.send_header(key, value)
            self.send_header("Content-type", content_type)
            self.send_header("Content-length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

        def _respond_shed(self, code: int, body, retry_after_s=None):
            """A shed or refused response: every 429, and every 503 of an
            open breaker, carries ``Retry-After``: ``retry_after_s`` when
            the caller holds it, else its body's."""
            retry = retry_after_s
            if retry is None:
                try:
                    retry = json.loads(body).get("retry_after_s")
                except Exception:
                    pass
            headers = {"Retry-After": str(int(retry))} \
                if retry is not None else None
            self._respond(code, body, headers=headers)

        def _do(self, post: bool):
            split = urllib.parse.urlsplit(self.path)
            action = split.path.split("/")[-1]
            if action == "stats":
                self._respond(200, json.dumps(metrics.snapshot_rounded()))
                return
            if action == "metrics":
                from ..obs import prom
                self._respond(200, prom.render(),
                              content_type=prom.CONTENT_TYPE)
                return
            if action == "profile":
                from ..obs import profiler
                prof = profiler.snapshot()
                # the load-management view: the ladder, and the gate's
                # sensors and sheds when it is armed
                prof["pressure"] = pressure_snapshot()
                if service.admission is not None:
                    prof["admission"] = service.admission.snapshot()
                self._respond(200, json.dumps(prof, separators=(",", ":")))
                return
            if action == "health":
                code, body = service.health()
                if code != 200:
                    metrics.count(f"service.errors.{code}")
                self._respond(code, body)
                return
            # the admission gate sheds before the body is read: a 429
            # costs headers, not work. An admitted request's in-flight
            # slot is released when its answer is written, whatever its
            # status
            gate = service.admission
            if gate is not None:
                shed = gate.admit()
                if shed is not None:
                    metrics.count("service.errors.429")
                    self._respond_shed(
                        429, json.dumps({"error": "overloaded",
                                         "reason": shed.reason,
                                         "retry_after_s":
                                             shed.retry_after_s}),
                        retry_after_s=shed.retry_after_s)
                    return
            # ?trace=1: arm tracing for this request and answer with its
            # span tree (Chrome/Perfetto trace events) beside the report.
            # The shed_trace rung refuses the flag (the report serves)
            want_trace = _on(urllib.parse.parse_qs(split.query).get(
                "trace", ["0"])[0])
            if want_trace and not allow_request_trace():
                metrics.count("pressure.trace_suppressed")
                want_trace = False
            if want_trace:
                obs_trace.force_begin()
            root = None
            try:
                # the root span: one per /report request, parse ->
                # dispatch -> match -> serialisation, so every stage span
                # below it shares the request's trace id
                with obs_trace.span("service.request") as root:
                    if want_trace:
                        obs_trace.watch(root)
                    try:
                        with obs_trace.span("service.parse"):
                            trace = self._parse(post)
                    except Exception as e:
                        self._respond(400, json.dumps({"error": str(e)}))
                        return
                    metrics.count("service.requests")
                    with metrics.timer("service.handle"):
                        code, body = service.handle(trace)
                if want_trace and code == 200:
                    if not isinstance(body, str):  # the C writer's bytes
                        body = bytes(body).decode("utf-8")
                    body = ('{"report":' + body + ',"trace":'
                            + json.dumps(obs_trace.export_trace(root),
                                         separators=(",", ":")) + "}")
            finally:
                if want_trace:
                    obs_trace.unwatch(root)
                    obs_trace.force_end()
                if gate is not None:
                    gate.release()
            if code != 200:
                metrics.count(f"service.errors.{code}")
            if code in (429, 503):
                self._respond_shed(code, body)
            else:
                self._respond(code, body)

        def do_GET(self):
            self._do(False)

        def do_POST(self):
            self._do(True)

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


class BoundedThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a cap on concurrent handler threads
    (``pool_size``, default ``POOL_SIZE``). Excess connections queue in
    the listen backlog until a slot frees."""

    daemon_threads = True
    # accepts queue here while all pool slots are busy
    request_queue_size = 128

    def __init__(self, addr, handler, pool_size: int = POOL_SIZE):
        self._slots = threading.BoundedSemaphore(max(1, pool_size))
        super().__init__(addr, handler)

    def process_request(self, request, client_address):
        self._slots.acquire()
        super().process_request(request, client_address)

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            self._slots.release()


class ReusePortThreadingHTTPServer(BoundedThreadingHTTPServer):
    """BoundedThreadingHTTPServer binding with ``SO_REUSEPORT``: N
    processes each bind the same (host, port) and the kernel spreads
    accepted connections across them — the pre-fork mode's listener."""

    def server_bind(self):
        import socket
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()


def make_server(service: ReporterService, host: str, port: int,
                pool_size: int = POOL_SIZE,
                reuse_port: bool = False) -> BoundedThreadingHTTPServer:
    """The one server constructor every entry point goes through.
    ``reuse_port`` binds with SO_REUSEPORT (the pre-fork mode)."""
    cls = ReusePortThreadingHTTPServer if reuse_port \
        else BoundedThreadingHTTPServer
    return cls((host, port), make_handler(service), pool_size)


def serve(service: ReporterService, host: str, port: int,
          pool_size: int = POOL_SIZE) -> BoundedThreadingHTTPServer:
    """Serve on a daemon thread; returns the server (``shutdown()`` and
    ``server_close()`` stop it)."""
    httpd = make_server(service, host, port, pool_size)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd


def slot_device(device: torch.device, slot: int,
                procs: int) -> torch.device:
    """The device worker ``slot`` of ``procs`` decodes on: for a bare
    ``cuda``, the first card of the slot's contiguous share of the
    visible cards (``cuda:{slot * n // procs}``); any other device as
    given. Reads the card count, so it runs only after the fork."""
    if procs > 1 and device == torch.device("cuda"):
        return torch.device("cuda", slot * torch.cuda.device_count() // procs)
    return device


def read_config(path: str) -> dict:
    """The config file as {"graph": path, "params": MatchParams,
    "service": {...}, "matcher": {...}, "server": {...}, "obs": {...},
    "faults": {...}}, each of the last five holding the ``service`` keys
    that go to one constructor (``obs``: to :func:`configure_obs`,
    ``faults``: to :func:`configure_faults`).
    Raises on a missing graph or an unknown key (this service has no
    datastore and no city registry)."""
    with open(path) as f:
        return parse_config(json.load(f))


def parse_config(conf: dict) -> dict:
    """:func:`read_config` of an already loaded config object."""
    if "graph" not in conf:
        raise ValueError('no "graph": the road network .npz to serve')
    unknown = set(conf) - {"graph", "matcher", "service"}
    if unknown:
        raise ValueError(f"unknown keys {sorted(unknown)}")
    given = dict(conf.get("service") or {})
    unknown = set(given) - set(SERVICE_KEYS + MATCHER_KEYS + SERVER_KEYS
                               + OBS_KEYS + FAULT_KEYS)
    if unknown:
        raise ValueError(f"unknown service keys {sorted(unknown)}")
    return {"graph": conf["graph"],
            "params": MatchParams(**conf.get("matcher", {})),
            **{name: {k: given[k] for k in keys if k in given}
               for name, keys in (("service", SERVICE_KEYS),
                                  ("matcher", MATCHER_KEYS),
                                  ("server", SERVER_KEYS),
                                  ("obs", OBS_KEYS),
                                  ("faults", FAULT_KEYS))}}


def matcher_from_config(conf: dict, device) -> SegmentMatcher:
    """The matcher a :func:`read_config` result describes, on ``device``:
    the graph loaded from its ``.npz``, its ``MatchParams`` and the
    ``service`` keys that go to the matcher."""
    return SegmentMatcher(RoadNetwork.load(conf["graph"]), conf["params"],
                          device=device, **conf["matcher"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m reporter_tpu_torch.service.server",
        description="Serve /report, /stats, /metrics, /profile and "
                    "/health.")
    ap.add_argument("config", help="JSON config file")
    ap.add_argument("address", help="host:port to listen on")
    ap.add_argument("--procs", type=int, default=1,
                    help="pre-forked worker processes sharing the port")
    ap.add_argument("--device", type=torch.device, default="cuda",
                    help="cuda (default), cuda:I or cpu")
    args = ap.parse_args(argv)
    try:
        conf = read_config(args.config)
        host, port = args.address.split("/")[-1].split(":")
        port = int(port)
    except Exception as e:
        sys.stderr.write(f"Problem with config file: {e}\n")
        return 1
    pool_size = conf["server"].get("pool_size", POOL_SIZE)
    configure_obs(conf["obs"])
    try:
        configure_faults(conf["faults"])
    except ValueError as e:
        sys.stderr.write(f"Problem with config file: {e}\n")
        return 1

    def make_service(slot: int, procs: int) -> ReporterService:
        """Everything heavy — the device, the graph load, the native
        build, the matcher's lanes, the dispatcher thread — happens
        here, which in pre-fork mode runs after the fork in each worker:
        no child inherits a CUDA context, a native worker pool or a
        dispatcher thread."""
        matcher = matcher_from_config(
            conf, slot_device(args.device, slot, procs))
        return ReporterService(matcher, **conf["service"])

    if args.procs > 1:
        from .prefork import serve_prefork
        return serve_prefork(make_service, host, port, args.procs,
                             pool_size)
    try:
        service = make_service(0, 1)
    except Exception as e:
        sys.stderr.write(f"could not start the service: {e}\n")
        return 1
    httpd = make_server(service, host, port, pool_size)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
