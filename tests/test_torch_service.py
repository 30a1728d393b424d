"""The port's /report front door against the JAX package's, over HTTP.

The JAX package's ``ReporterService`` (its ``SegmentMatcher`` on the
CPU) and the port's (``SegmentMatcher(device="cpu")``) serve the
report-parity fixture's city on ephemeral ports, each on the same prep
path (numpy, and the native host runtime). Every request answers with
equal status codes and byte-equal bodies, by GET ``?json=`` and by POST,
one at a time and from many threads at once; so do the error cases. The
dispatcher's flush and shedding policy, the per-trace ``TraceBatch``
surface, the metrics layout and the graph version are held to the JAX
package's. Tolerance: exact.
"""
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from reporter_tpu.core.tracebatch import TraceBatch as JaxTraceBatch
from reporter_tpu.graph.version import map_version as jax_map_version
from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.service import admission as jax_admission
from reporter_tpu.service.dispatch import BatchDispatcher as JaxDispatcher
from reporter_tpu.service.server import ReporterService as JaxService
from reporter_tpu.service.server import serve as jax_serve
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu.synth import generate_trace as jax_trace
from reporter_tpu.utils import metrics as jax_metrics
from reporter_tpu_torch.core.tracebatch import PointsView, TraceBatch
from reporter_tpu_torch.graph.network import RoadNetwork
from reporter_tpu_torch.graph.version import map_version
from reporter_tpu_torch.matcher import SegmentMatcher
from reporter_tpu_torch.matcher.matcher import MATCH_BATCH_DEFAULT
from reporter_tpu_torch.service import admission
from reporter_tpu_torch.service.dispatch import BatchDispatcher
from reporter_tpu_torch.service.report import report_json
from reporter_tpu_torch.service.server import (ACTIONS, ReporterService,
                                               main, serve)
from reporter_tpu_torch.synth import build_grid_city, generate_trace
from reporter_tpu_torch.utils import forksafe, metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "report_parity.json")
LEVELS = {"mode": "auto", "report_levels": [0, 1, 2],
          "transition_levels": [0, 1, 2]}


@pytest.fixture(scope="module")
def fixture():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cities(fixture):
    return jax_city(**fixture["city"]), build_grid_city(**fixture["city"])


@pytest.fixture(scope="module")
def requests(fixture, cities):
    """The fixture's requests (T=64 and one T=256) plus short traces from
    one seeded numpy stream through each package's synth (T=16)."""
    ref_city, city = cities
    reqs = list(fixture["requests"])
    rng_ref, rng = np.random.default_rng(11), np.random.default_rng(11)
    while len(reqs) < len(fixture["requests"]) + 6:
        tr_ref = jax_trace(ref_city, f"short-{len(reqs)}", rng_ref)
        tr = generate_trace(city, f"short-{len(reqs)}", rng)
        assert (tr_ref is None) == (tr is None)
        if tr is None:
            continue
        assert tr.points == tr_ref.points
        req = tr.request_json(report_levels=(0, 1, 2),
                              transition_levels=(0, 1, 2))
        req["trace"] = tr.points[:12]
        reqs.append(req)
    return reqs


def _start(service, serve_fn):
    httpd = serve_fn(service, "127.0.0.1", 0)
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, service):
    httpd.shutdown()
    httpd.server_close()
    assert service.dispatcher.close()


@pytest.fixture(scope="module", params=["numpy", "native"])
def servers(cities, request):
    """(reference URL, port URL, reference service, port service) on one
    prep path, both with threshold 15, max_batch 64, max_wait 30 ms."""
    ref_city, city = cities
    native = request.param == "native"
    kw = dict(threshold_sec=15, max_batch=64, max_wait_ms=30.0)
    ref = JaxService(JaxMatcher(net=ref_city, use_native=native), **kw)
    port = ReporterService(SegmentMatcher(city, device="cpu", native=native),
                           **kw)
    (h_ref, u_ref), (h_port, u_port) = (_start(ref, jax_serve),
                                        _start(port, serve))
    yield u_ref, u_port, ref, port
    _stop(h_ref, ref)
    _stop(h_port, port)


def call(url, path, body=None):
    """(status, headers, raw body) of one request: POST when ``body`` is
    given, GET otherwise."""
    req = urllib.request.Request(url + path, data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def get_report(url, req):
    return call(url, "/report?json=" + urllib.parse.quote(json.dumps(req)))


def post_report(url, req):
    return call(url, "/report", json.dumps(req).encode())


def counters():
    return metrics.snapshot()["counters"]


# -- /report over HTTP ---------------------------------------------------------
def test_report_get_and_post_byte_equal(servers, requests):
    u_ref, u_port = servers[:2]
    for req in requests:
        for send in (get_report, post_report):
            st_ref, h_ref, b_ref = send(u_ref, req)
            st, h, b = send(u_port, req)
            assert st == st_ref == 200
            assert b == b_ref, req["uuid"]
            assert h["Content-type"] == h_ref["Content-type"]
            assert h["Access-Control-Allow-Origin"] == "*"
    assert len(requests) == 19


def test_concurrent_posts_byte_equal_and_batched(servers, requests):
    u_ref, u_port = servers[:2]
    want = {r["uuid"]: post_report(u_ref, r)[2] for r in requests}
    reqs = [requests[i % len(requests)] for i in range(32)]
    before = counters()
    got = [None] * len(reqs)
    barrier = threading.Barrier(len(reqs))

    def client(i):
        barrier.wait(30)
        got[i] = post_report(u_port, reqs[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    after = counters()
    for req, (st, _h, body) in zip(reqs, got):
        assert st == 200
        assert body == want[req["uuid"]], req["uuid"]
    traces = after["dispatch.traces"] - before.get("dispatch.traces", 0)
    batches = after["dispatch.batches"] - before.get("dispatch.batches", 0)
    assert traces == len(reqs)
    assert batches < len(reqs)


def _trace_of(requests, n):
    return [dict(p) for p in requests[0]["trace"][:n]]


ERROR_CASES = {
    "missing uuid": lambda rq: ("POST", {"trace": _trace_of(rq, 5),
                                         "match_options": LEVELS}),
    "one-point trace": lambda rq: ("POST", {"uuid": "a",
                                            "trace": _trace_of(rq, 1),
                                            "match_options": LEVELS}),
    "missing report_levels": lambda rq: (
        "POST", {"uuid": "a", "trace": _trace_of(rq, 5),
                 "match_options": {"transition_levels": [0]}}),
    "missing transition_levels": lambda rq: (
        "POST", {"uuid": "a", "trace": _trace_of(rq, 5),
                 "match_options": {"report_levels": [0]}}),
    "point without lat": lambda rq: (
        "POST", {"uuid": "a", "trace": [{"lon": 0.0, "time": 1}] * 3,
                 "match_options": LEVELS}),
    "a city key": lambda rq: ("POST", {"uuid": "a", "city": "x",
                                       "trace": _trace_of(rq, 5),
                                       "match_options": LEVELS}),
    "malformed JSON": lambda rq: ("RAW", b'{"uuid": '),
    "GET without json": lambda rq: ("GET", None),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_bodies_byte_equal(servers, requests, case):
    u_ref, u_port = servers[:2]
    kind, payload = ERROR_CASES[case](requests)
    out = []
    for url in (u_ref, u_port):
        if kind == "POST":
            out.append(post_report(url, payload))
        elif kind == "RAW":
            out.append(call(url, "/report", payload))
        else:
            out.append(call(url, "/report"))
    (st_ref, _h, b_ref), (st, _h2, b) = out
    assert st == st_ref
    assert st in (400, 500)
    assert b == b_ref


def test_bad_action_lists_the_ports_actions(servers):
    u_ref, u_port = servers[:2]
    st_ref, _h, _b = call(u_ref, "/nope?json={}")
    st, _h, body = call(u_port, "/nope?json={}")
    assert st == st_ref == 400
    assert sorted(ACTIONS) == ["health", "report", "stats"]
    assert json.loads(body) == {
        "error": "Try a valid action: ['health', 'report', 'stats']"}


# -- /stats and /health ----------------------------------------------------------
def test_stats_after_a_request(servers, requests):
    u_ref, u_port = servers[:2]
    assert post_report(u_port, requests[0])[0] == 200
    st, _h, body = call(u_port, "/stats")
    assert st == 200
    snap = json.loads(body)
    assert snap["counters"]["service.requests"] >= 1
    assert snap["counters"]["dispatch.traces"] >= 1
    assert snap["timers"]["dispatch.match_many"]["count"] >= 1
    ref = json.loads(call(u_ref, "/stats")[2])
    for name in ("dispatch.match_many", "service.handle"):
        assert set(snap["timers"][name]) == set(ref["timers"][name])


def test_health(servers, cities):
    u_ref, u_port = servers[:2]
    ref_city, city = cities
    st_ref, _h, b_ref = call(u_ref, "/health")
    st, _h, body = call(u_port, "/health")
    assert st == st_ref == 200
    got, want = json.loads(body), json.loads(b_ref)
    assert got["graph"]["map_version"] == jax_map_version(ref_city)
    assert got["graph"]["nodes"] == city.num_nodes == 100
    assert got["graph"]["edges"] == city.num_edges
    for key in ("graph", "native", "incremental", "admission",
                "datastore", "status"):
        assert got[key] == want[key], key
    assert list(got) == ["graph", "native", "incremental", "admission",
                         "datastore", "status"]


def test_map_version_survives_a_save_and_load(cities, tmp_path):
    ref_city, _city = cities
    ref_city.save(str(tmp_path / "city.npz"))
    loaded = RoadNetwork.load(str(tmp_path / "city.npz"))
    assert map_version(loaded) == jax_map_version(ref_city)
    assert loaded._map_version == map_version(loaded)


def test_save_writes_the_reference_format(cities, tmp_path):
    """The port's ``RoadNetwork.save`` writes the arrays the JAX package's
    ``save`` writes (keys, dtypes, values), and both packages' ``load``
    read it back to the same network."""
    from reporter_tpu.graph.network import RoadNetwork as JaxNetwork
    ref_city, city = cities
    ref_city.save(str(tmp_path / "ref.npz"))
    city.save(str(tmp_path / "port.npz"))
    with np.load(tmp_path / "ref.npz") as ref, \
            np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(ref.files)
        for key in ref.files:
            assert got[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    back = RoadNetwork.load(str(tmp_path / "port.npz"))
    assert map_version(back) == map_version(city) \
        == jax_map_version(JaxNetwork.load(str(tmp_path / "port.npz")))
    assert back.segment_length_m == city.segment_length_m


def test_report_many_equals_reference(servers, requests):
    ref, port = servers[2:]
    want = ref.report_many(requests)
    tb = TraceBatch.from_requests(requests)
    for got in (port.report_many(requests), port.report_many(tb)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert dict(g["segment_matcher"]) == dict(w["segment_matcher"])
            strip = ({k: v for k, v in d.items() if k != "segment_matcher"}
                     for d in (g, w))
            assert next(strip) == next(strip)


# -- the dispatcher's policy -----------------------------------------------------
class Blocked:
    """A match_many that blocks until released, counting its calls."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.calls = 0

    def match_many(self, traces):
        self.calls += 1
        self.entered.set()
        assert self.release.wait(30)
        return [{"segments": [], "mode": "auto"} for _ in traces]


def _wait(cond, timeout=10.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "timed out"
        time.sleep(0.002)


def test_idle_queue_flushes_before_max_wait():
    d = BatchDispatcher(lambda traces: [{"ok": True}] * len(traces),
                        max_batch=64, max_wait_ms=500.0, idle_grace_ms=5.0)
    try:
        t0 = time.perf_counter()
        assert d.submit({"uuid": "solo"}) == {"ok": True}
        assert time.perf_counter() - t0 < 0.25
    finally:
        assert d.close()


def test_burst_still_batches():
    sizes = []

    def match_many(traces):
        sizes.append(len(traces))
        return [{"i": i} for i in range(len(traces))]

    d = BatchDispatcher(match_many, max_batch=64, max_wait_ms=200.0,
                        idle_grace_ms=5.0)
    try:
        out = d.submit_many([{"uuid": f"u{i}"} for i in range(16)])
        assert len(out) == 16
        assert max(sizes) >= 8, sizes
    finally:
        assert d.close()


def _fill(d, stub, n_queued):
    """One slot in service (the stub blocks it) and ``n_queued`` slots
    queued behind it, each submitted from its own thread; returns the
    threads and their outcomes by name."""
    out = {}

    def submit(name):
        try:
            out[name] = d.submit({"uuid": name})
        except Exception as e:
            out[name] = e

    threads = [threading.Thread(target=submit, args=("a",))]
    threads[0].start()
    assert stub.entered.wait(10)
    for i in range(n_queued):
        t = threading.Thread(target=submit, args=(f"q{i}",))
        t.start()
        threads.append(t)
        _wait(lambda: d.queued_depth() == i + 1)
    return threads, out


@pytest.mark.parametrize("policy", ["reject", "oldest"])
def test_full_queue_sheds(policy):
    stub = Blocked()
    d = BatchDispatcher(stub.match_many, max_batch=1, max_wait_ms=1.0,
                        queue_max=2, queue_policy=policy)
    before = counters()
    try:
        threads, out = _fill(d, stub, 2)
        assert d.queue_depth() == 3 and d.queued_depth() == 2
        if policy == "reject":
            with pytest.raises(admission.Overload) as e:
                d.submit({"uuid": "late"})
            assert (e.value.reason, e.value.retry_after_s) == ("queue", 1)
        else:
            late = threading.Thread(
                target=lambda: out.update(late=d.submit({"uuid": "late"})))
            late.start()
            threads.append(late)
            _wait(lambda: "q0" in out)
            assert isinstance(out["q0"], admission.Overload)
        stub.release.set()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
    finally:
        stub.release.set()
        assert d.close()
    served = [k for k, v in out.items() if isinstance(v, dict)]
    assert sorted(served) == (["a", "q0", "q1"] if policy == "reject"
                              else ["a", "late", "q1"])
    name = ("dispatch.queue.rejected" if policy == "reject"
            else "dispatch.queue.evicted")
    assert counters()[name] == before.get(name, 0) + 1


def test_http_shed_is_429_with_retry_after(cities):
    """One request in service, one queued (queue_max=1), the next shed:
    the same 429, body and Retry-After from both services."""
    answers = []
    for pkg in ("reference", "port"):
        stub = Blocked()
        if pkg == "port":
            svc = ReporterService(stub, max_batch=1, queue_max=1)
            httpd, url = _start(svc, serve)
        else:
            svc = JaxService(stub, max_batch=1)
            svc.dispatcher.close()
            svc.dispatcher = JaxDispatcher(stub.match_many, max_batch=1,
                                           queue_max=1)
            httpd, url = _start(svc, jax_serve)
        req = {"uuid": "u", "trace": [{"lat": 0.0, "lon": 0.0, "time": t}
                                      for t in range(3)],
               "match_options": LEVELS}
        first = []
        threads = [threading.Thread(
            target=lambda: first.append(post_report(url, req)))
            for _ in range(2)]
        try:
            threads[0].start()
            assert stub.entered.wait(10)
            threads[1].start()
            _wait(lambda: svc.dispatcher.queued_depth() == 1)
            answers.append(post_report(url, req))
            stub.release.set()
            for t in threads:
                t.join(10)
                assert not t.is_alive()
        finally:
            stub.release.set()
            _stop(httpd, svc)
        assert [st for st, _h, _b in first] == [200, 200]
    (st_ref, h_ref, b_ref), (st, h, b) = answers
    assert st == st_ref == 429
    assert b == b_ref
    assert json.loads(b) == {"error": "overloaded", "reason": "queue",
                             "retry_after_s": 1}
    assert h["Retry-After"] == h_ref["Retry-After"] == "1"


def test_match_failure_is_500_for_every_waiter():
    calls = []

    def boom(traces):
        calls.append(len(traces))
        raise RuntimeError("boom")

    class Stub:
        match_many = staticmethod(boom)

    svc = ReporterService(Stub(), max_wait_ms=500.0, idle_grace_ms=200.0)
    ref = JaxService(Stub())
    httpd, url = _start(svc, serve)
    h_ref, u_ref = _start(ref, jax_serve)
    before = counters()
    req = {"uuid": "u", "trace": [{"lat": 0.0, "lon": 0.0, "time": t}
                                  for t in range(3)],
           "match_options": LEVELS}
    got = []
    try:
        threads = [threading.Thread(target=lambda: got.append(
            post_report(url, req))) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
        want = post_report(u_ref, req)
    finally:
        _stop(httpd, svc)
        _stop(h_ref, ref)
    assert want[0] == 500 and want[2] == b'{"error": "boom"}'
    assert [(st, b) for st, _h, b in got] == [(500, want[2])] * 4
    after = counters()
    batches = after["dispatch.batches"] - before.get("dispatch.batches", 0)
    # one match_many call per batch: nothing retried the failure
    assert len(calls) - 1 == batches  # the reference's own call included
    assert sum(calls) == 5
    assert after["dispatch.errors"] - before.get("dispatch.errors", 0) \
        == batches
    assert after["service.errors.500"] \
        - before.get("service.errors.500", 0) == 4


def test_close_drains_and_refuses():
    stub = Blocked()
    d = BatchDispatcher(stub.match_many, max_batch=1, max_wait_ms=1.0)
    threads, out = _fill(d, stub, 2)
    closed = []
    closer = threading.Thread(target=lambda: closed.append(d.close()))
    closer.start()
    _wait(lambda: d._closed)
    with pytest.raises(RuntimeError, match="dispatcher is closed"):
        d.submit({"uuid": "late"})
    stub.release.set()
    for t in threads + [closer]:
        t.join(10)
        assert not t.is_alive()
    assert closed == [True]
    assert out == {k: {"segments": [], "mode": "auto"}
                   for k in ("a", "q0", "q1")}
    assert stub.calls == 3


def test_retry_after_equals_reference():
    assert (admission.RETRY_AFTER_MIN_S, admission.RETRY_AFTER_MAX_S) == (
        jax_admission.RETRY_AFTER_MIN_S, jax_admission.RETRY_AFTER_MAX_S)
    for depth in (0, 1, 3, 100, 4096, 10**6):
        for ewma in (None, 0.0, 1e-5, 0.004, 0.3, 2.0, 50.0):
            assert admission.retry_after_s(depth, ewma) \
                == jax_admission.retry_after_s(depth, ewma)


def test_service_defaults_are_the_references():
    svc = ReporterService(Blocked())
    try:
        d = svc.dispatcher
        assert svc.threshold_sec == 15
        assert (d.max_batch, d.max_wait, d.idle_grace, d.queue_max,
                d.queue_policy, d.latency_budget) == (
            MATCH_BATCH_DEFAULT, 0.02, 0.002, 4096, "reject", 0.0)
        assert MATCH_BATCH_DEFAULT == 256
    finally:
        d.close()
    with pytest.raises(ValueError, match="queue_policy"):
        BatchDispatcher(lambda t: t, queue_policy="newest")


def test_latency_budget_caps_the_batch():
    d = BatchDispatcher(lambda traces: [{}] * len(traces), max_batch=64,
                        latency_budget_ms=10.0)
    try:
        assert d._effective_cap() == 64  # no estimate yet
        d._note_service_time(0.04, 20)   # 2 ms a trace
        assert d._effective_cap() == 5
        assert d.service_ewma_s() == pytest.approx(0.002)
    finally:
        assert d.close()


# -- the per-trace surface, metrics, fork safety ---------------------------------
def test_trace_batch_surface_matches_reference(requests):
    from reporter_tpu.core.tracebatch import points_to_columns as jax_cols

    from reporter_tpu_torch.core.tracebatch import points_to_columns
    shared = {"mode": "auto"}
    for opts in ("shared", "own"):
        parts, ref_parts = [], []
        for r in requests[:4]:
            o = shared if opts == "shared" else dict(r["match_options"])
            parts.append((r["uuid"], *points_to_columns(r["trace"]), o))
            ref_parts.append((r["uuid"], *jax_cols(r["trace"]), o))
        tb, ref = TraceBatch.concat(parts), JaxTraceBatch.concat(ref_parts)
        for name in ("offsets", "lat", "lon", "time"):
            np.testing.assert_array_equal(getattr(tb, name),
                                          getattr(ref, name))
        assert (tb.accuracy is None) == (ref.accuracy is None)
        assert tb.uuids == ref.uuids
        assert (tb.options is shared) == (opts == "shared")
        assert tb.options == ref.options
        for i in range(len(tb)):
            assert tb.uuid(i) == ref.uuid(i)
            assert tb.option(i) is ref.option(i)
            for a, b in zip(tb.trace_columns(i), ref.trace_columns(i)):
                np.testing.assert_array_equal(a, b)
            view, ref_view = tb[i], ref[i]
            assert isinstance(view["trace"], PointsView)
            for key in ("uuid", "match_options"):
                assert view[key] == ref_view[key]
            assert list(view["trace"]) == list(ref_view["trace"])
            assert view["trace"][-1] == ref_view["trace"][-1]
            assert view["trace"][1:3] == ref_view["trace"][1:3]
            assert ("city" in view) == ("city" in ref_view)
        assert [v["uuid"] for v in tb] == [r["uuid"] for r in requests[:4]]
        again = TraceBatch.from_requests(list(tb))
        np.testing.assert_array_equal(again.lat, tb.lat)
        np.testing.assert_array_equal(again.offsets, tb.offsets)
    with pytest.raises(IndexError):
        tb[0]["trace"][10**6]


def test_metrics_layout_matches_reference():
    assert metrics.BUCKET_BOUNDS_S == jax_metrics.BUCKET_BOUNDS_S
    for x in (0.0, -1.0, 1e-9, 2.0 ** -20, 3e-6, 0.001, 0.5, 1.0, 2.0,
              127.9, 128.0, 1e4):
        assert metrics.bucket_index(x) == jax_metrics.bucket_index(x)
    reg, ref = metrics.Registry(), jax_metrics.Registry()
    rng = np.random.default_rng(3)
    for x in rng.exponential(0.01, 500).tolist():
        reg.observe("stage", x)
        ref.observe("stage", x)
    for r in (reg, ref):
        r.count("hits", 3)
        with r.timer("timed"):
            pass
    got = metrics.snapshot_rounded(reg)
    want = jax_metrics.snapshot_rounded(ref)
    assert got["counters"] == want["counters"]
    assert got["timers"]["stage"] == want["timers"]["stage"]
    assert set(got["timers"]) == set(want["timers"])


def test_forked_child_counts_its_own_work():
    assert forksafe.hook_count() >= 1
    metrics.count("fork.sentinel", 9)
    pid = os.fork()
    if pid == 0:
        code = 1
        try:
            fresh = metrics.snapshot()["counters"] == {}
            metrics.count("child.work")
            code = 0 if fresh and metrics.snapshot()["counters"] == {
                "child.work": 1} else 3
        finally:
            os._exit(code)
    _pid, status = os.waitpid(pid, 0)
    assert os.WEXITSTATUS(status) == 0
    assert counters()["fork.sentinel"] >= 9


# -- main in a subprocess --------------------------------------------------------
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_main(cfg, port, *args):
    return subprocess.Popen(
        [sys.executable, "-m", "reporter_tpu_torch.service.server", str(cfg),
         f"127.0.0.1:{port}", *args], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def wait_up(proc, url, timeout=120.0):
    t0 = time.monotonic()
    while True:
        if proc.poll() is not None:
            pytest.fail(f"server exited rc {proc.returncode}: "
                        f"{proc.stderr.read()[-2000:]}")
        try:
            return call(url, "/health")
        except OSError:
            assert time.monotonic() - t0 < timeout, "server never came up"
            time.sleep(0.1)


@pytest.mark.parametrize("service", [None, {"pipeline": False, "chunk": 4,
                                            "max_wait_ms": 5.0}])
def test_main_serves_the_ports_bytes(cities, requests, tmp_path, service):
    ref_city, _city = cities
    ref_city.save(str(tmp_path / "city.npz"))
    conf = {"graph": str(tmp_path / "city.npz"),
            "matcher": {"max_candidates": 8}}
    if service is not None:
        conf["service"] = service
    (tmp_path / "cfg.json").write_text(json.dumps(conf))
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    local = SegmentMatcher(RoadNetwork.load(str(tmp_path / "city.npz")),
                           device="cpu")
    reqs = requests[:2] + requests[-2:]
    want = [report_json(m, r, 15, {0, 1, 2}, {0, 1, 2}).encode()
            for m, r in zip(local.match_many(reqs), reqs)]
    proc = start_main(tmp_path / "cfg.json", port, "--device", "cpu")
    try:
        st, _h, health = wait_up(proc, url)
        assert st == 200
        assert json.loads(health)["graph"]["map_version"] \
            == jax_map_version(ref_city)
        for req, body in zip(reqs, want):
            assert post_report(url, req)[2] == body
            assert get_report(url, req)[2] == body
    finally:
        proc.terminate()
        proc.wait(30)


@pytest.mark.parametrize("conf, message", [
    ({}, "graph"),
    ({"graph": "x.npz", "datastore": "/d"}, "datastore"),
    ({"graph": "x.npz", "service": {"max_bacth": 1}}, "max_bacth"),
    ({"graph": "x.npz", "matcher": {"sigma": 1}}, "sigma"),
])
def test_main_refuses_a_bad_config(tmp_path, capsys, conf, message):
    (tmp_path / "cfg.json").write_text(json.dumps(conf))
    assert main([str(tmp_path / "cfg.json"), "127.0.0.1:1",
                 "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "Problem with config file" in err
    assert message in err


def test_main_without_cuda_exits_nonzero(cities, tmp_path, capsys):
    """No fallback to the CPU: without --device cpu the service needs a
    card, and main says so and exits 1."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the service would start")
    cities[0].save(str(tmp_path / "city.npz"))
    (tmp_path / "cfg.json").write_text(
        json.dumps({"graph": str(tmp_path / "city.npz")}))
    assert main([str(tmp_path / "cfg.json"), f"127.0.0.1:{free_port()}"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
