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
from ..utils import metrics
from .admission import Overload
from .dispatch import DEFAULT_QUEUE_MAX, BatchDispatcher
from .report import report, report_wire

logger = logging.getLogger("reporter_tpu_torch.service")

#: /report is the reference service's action; /stats is a metrics
#: snapshot (counters + stage-timer histograms), /health the liveness
#: probe
ACTIONS = {"report", "stats", "health"}

#: handler threads per process: they parse JSON and then wait on the
#: dispatcher, so they are IO-bound and the pool is not sized by cores
POOL_SIZE = 64

#: the config's "service" keys, by the constructor each one goes to
SERVICE_KEYS = ("threshold_sec", "max_batch", "max_wait_ms",
                "idle_grace_ms", "queue_max", "queue_policy",
                "latency_budget_ms")
MATCHER_KEYS = ("native", "pipeline", "chunk", "prep_threads",
                "route_device", "prune_sigma", "incremental",
                "incremental_lag", "incremental_mb")
SERVER_KEYS = ("pool_size",)


class ReporterService:
    """Owns the matcher + dispatcher; shared by all handler threads."""

    def __init__(self, matcher: SegmentMatcher, threshold_sec: int = 15,
                 max_batch: int = MATCH_BATCH_DEFAULT,
                 max_wait_ms: float = 20.0, idle_grace_ms: float = 2.0,
                 queue_max: int = DEFAULT_QUEUE_MAX,
                 queue_policy: str = "reject",
                 latency_budget_ms: float = 0.0):
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
            return 200, report_wire(match, trace, self.threshold_sec,
                                    report_levels, transition_levels)
        except Overload as e:
            # the bounded dispatcher queue shed this request: 429, with
            # the computed back-off in the body — the HTTP handler lifts
            # it into the Retry-After header
            return 429, json.dumps({"error": "overloaded",
                                    "reason": e.reason,
                                    "retry_after_s": e.retry_after_s})
        except Exception as e:
            return 500, json.dumps({"error": str(e)})

    def health(self) -> tuple[int, str]:
        """Liveness probe; (200, JSON body): the graph (nodes, edges, its
        content-derived ``map_version``), the host runtime ("native", or
        "fallback" for the numpy prep), the incremental decode
        (``enabled``, and once its table exists the table's gauge:
        traces, state bytes against the budget, lag, evictions,
        fallbacks, resets), admission control (not armed) and the
        datastore (absent)."""
        m = self.matcher
        body = {
            "graph": {"loaded": True,
                      "nodes": int(m.net.num_nodes),
                      "edges": int(m.net.num_edges),
                      "map_version": map_version(m.net)},
            "native": {"status": "native" if m.runtime is not None
                       else "fallback"},
            "incremental": {"enabled": m.incremental},
            "admission": {"armed": False},
            "datastore": {"status": "absent"},
            "status": "ok",
        }
        table = m._incremental_table
        if table is not None:
            body["incremental"].update(table.gauge())
        return 200, json.dumps(body, separators=(",", ":"))

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

        def _respond(self, code: int, body, headers=None):
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
            self.send_header("Content-type", "application/json;charset=utf-8")
            self.send_header("Content-length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

        def _respond_shed(self, code: int, body):
            """A load-shed response: every 429 carries its body's
            ``retry_after_s`` as the ``Retry-After`` header."""
            retry = json.loads(body).get("retry_after_s")
            headers = {"Retry-After": str(int(retry))} \
                if retry is not None else None
            self._respond(code, body, headers=headers)

        def _do(self, post: bool):
            action = urllib.parse.urlsplit(self.path).path.split("/")[-1]
            if action == "stats":
                self._respond(200, json.dumps(metrics.snapshot_rounded()))
                return
            if action == "health":
                code, body = service.health()
                self._respond(code, body)
                return
            try:
                trace = self._parse(post)
            except Exception as e:
                self._respond(400, json.dumps({"error": str(e)}))
                return
            metrics.count("service.requests")
            with metrics.timer("service.handle"):
                code, body = service.handle(trace)
            if code != 200:
                metrics.count(f"service.errors.{code}")
            if code == 429:
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
    "service": {...}, "matcher": {...}, "server": {...}}, each of the
    last three holding the ``service`` keys that go to one constructor.
    Raises on a missing graph or an unknown key (this service has no
    datastore and no city registry)."""
    with open(path) as f:
        conf = json.load(f)
    if "graph" not in conf:
        raise ValueError('no "graph": the road network .npz to serve')
    unknown = set(conf) - {"graph", "matcher", "service"}
    if unknown:
        raise ValueError(f"unknown keys {sorted(unknown)}")
    given = dict(conf.get("service") or {})
    unknown = set(given) - set(SERVICE_KEYS + MATCHER_KEYS + SERVER_KEYS)
    if unknown:
        raise ValueError(f"unknown service keys {sorted(unknown)}")
    return {"graph": conf["graph"],
            "params": MatchParams(**conf.get("matcher", {})),
            **{name: {k: given[k] for k in keys if k in given}
               for name, keys in (("service", SERVICE_KEYS),
                                  ("matcher", MATCHER_KEYS),
                                  ("server", SERVER_KEYS))}}


def matcher_from_config(conf: dict, device) -> SegmentMatcher:
    """The matcher a :func:`read_config` result describes, on ``device``:
    the graph loaded from its ``.npz``, its ``MatchParams`` and the
    ``service`` keys that go to the matcher."""
    return SegmentMatcher(RoadNetwork.load(conf["graph"]), conf["params"],
                          device=device, **conf["matcher"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m reporter_tpu_torch.service.server",
        description="Serve /report, /stats and /health.")
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
