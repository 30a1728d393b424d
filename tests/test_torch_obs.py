"""The port's observability layer against the JAX package's.

Spans and their export, the flight recorder, the Prometheus text, the
SLO check, the ``/report?trace=1``, ``/metrics``, ``/stats``, ``/profile``
and ``/health`` surfaces of the two services on the same city, and the
runtime lock witness. The JAX package is configured through its
environment (``monkeypatch.setenv``), the port through its config keys
(``service.server.configure_obs``). Tolerances: the Prometheus text is
byte-identical, SLO verdicts equal, span names and nesting equal, and a
traced ``report`` member byte-equal to the untraced body.
"""
import json
import os
import re
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest

from reporter_tpu.analysis import racecheck as jax_racecheck
from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.obs import flightrec as jax_flightrec
from reporter_tpu.obs import prom as jax_prom
from reporter_tpu.obs import slo as jax_slo
from reporter_tpu.obs import trace as jax_trace
from reporter_tpu.service.server import ReporterService as JaxService
from reporter_tpu.service.server import serve as jax_serve
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu.utils import locks as jax_locks
from reporter_tpu.utils import metrics as jax_metrics
from reporter_tpu_torch.analysis import racecheck
from reporter_tpu_torch.matcher import SegmentMatcher
from reporter_tpu_torch.obs import flightrec, profiler, prom, slo
from reporter_tpu_torch.obs import trace as obs_trace
from reporter_tpu_torch.service.server import (ReporterService,
                                               configure_obs, read_config,
                                               serve)
from reporter_tpu_torch.synth import build_grid_city
from reporter_tpu_torch.utils import locks, metrics
from reporter_tpu_torch.utils.metrics import Registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "report_parity.json")
#: the stage timers the repair added to the port's matcher
STAGE_TIMERS = {"matcher.prep", "matcher.decode_dispatch",
                "matcher.decode_wait", "matcher.assemble"}


@pytest.fixture(autouse=True)
def _clean_obs():
    """Both packages start and end disarmed with empty rings."""
    for tr, fr in ((obs_trace, flightrec), (jax_trace, jax_flightrec)):
        tr.configure(False)
        fr.reset()
    yield
    for tr, fr in ((obs_trace, flightrec), (jax_trace, jax_flightrec)):
        tr.configure(False)
        fr.reset()
    configure_obs({"slo_ms": None})


def tree(events):
    """Sorted (name, parent name) pairs of a trace's span records."""
    name = {e["span_id"]: e["name"] for e in events}
    return sorted((e["name"], name.get(e["parent_id"])) for e in events)


# ---------------------------------------------------------------------------
class TestSpans:
    def test_disarmed_is_shared_noop(self):
        assert obs_trace.span("a") is obs_trace.span("b")
        assert obs_trace.current() is None
        with obs_trace.span("a"):
            pass
        assert flightrec.events() == []

    def test_nesting_and_parent_ids(self):
        for tr, fr in ((obs_trace, flightrec), (jax_trace, jax_flightrec)):
            tr.configure(True)
            with tr.span("root") as root:
                with tr.span("child") as child:
                    with tr.span("grandchild"):
                        pass
                with tr.span("sibling"):
                    pass
            evs = {e["name"]: e for e in fr.events()}
            assert evs["root"]["parent_id"] == 0
            assert evs["child"]["parent_id"] == root.span_id
            assert evs["sibling"]["parent_id"] == root.span_id
            assert evs["grandchild"]["parent_id"] == child.span_id
            assert {e["trace_id"] for e in evs.values()} == {root.trace_id}
            assert evs["root"]["dur_ns"] >= evs["child"]["dur_ns"] \
                >= evs["grandchild"]["dur_ns"]
        assert tree(flightrec.events()) == tree(jax_flightrec.events())

    def test_force_begin_end_arms_per_request(self):
        obs_trace.force_begin()
        try:
            assert obs_trace.enabled()
            with obs_trace.span("forced"):
                pass
        finally:
            obs_trace.force_end()
        assert not obs_trace.enabled()
        assert [e["name"] for e in flightrec.events()] == ["forced"]

    def test_attach_carries_context_across_threads(self):
        obs_trace.configure(True)
        seen = {}

        def worker(ctx):
            with obs_trace.attach(ctx):
                with obs_trace.span("lane") as sp:
                    seen["ids"] = (sp.trace_id, sp.parent_id)

        with obs_trace.span("root") as root:
            t = threading.Thread(target=worker, args=(obs_trace.current(),))
            t.start()
            t.join()
        assert seen["ids"] == (root.trace_id, root.span_id)

    def test_metrics_timer_doubles_as_span(self):
        obs_trace.configure(True)
        r = Registry()
        with obs_trace.span("root") as root:
            with r.timer("stage.x"):
                pass
        ev = next(e for e in flightrec.events() if e["name"] == "stage.x")
        assert ev["parent_id"] == root.span_id
        assert r.snapshot()["timers"]["stage.x"]["count"] == 1

    def test_hold_keeps_a_span_open_past_its_block(self):
        obs_trace.configure(True)
        with obs_trace.span("root") as root:
            sp = obs_trace.span("chunk")
            with obs_trace.hold(sp):
                ctx = obs_trace.current()
            assert obs_trace.current() == (root.trace_id, root.span_id)
            assert [r["name"] for r in flightrec.in_flight()] == ["root",
                                                                 "chunk"]
            with obs_trace.attach(ctx), obs_trace.span("lane"):
                pass
            sp.close()
            sp.close()  # once only
        evs = {e["name"]: e for e in flightrec.events()}
        assert evs["lane"]["parent_id"] == evs["chunk"]["span_id"]
        assert evs["chunk"]["t0_ns"] <= evs["lane"]["t0_ns"]
        assert evs["lane"]["t0_ns"] + evs["lane"]["dur_ns"] \
            <= evs["chunk"]["t0_ns"] + evs["chunk"]["dur_ns"]
        assert len(flightrec.events()) == 3

    def test_phase_spans_as_the_jax_module(self):
        """Same names, nesting and durations for the same phases inside a
        span that has been open longer than their sum."""
        for tr, fr in ((obs_trace, flightrec), (jax_trace, jax_flightrec)):
            tr.configure(True)
            with tr.span("prep") as prep:
                time.sleep(0.002)
                tr.phase_spans(("c", "s", "r"), [1000, 0, 3000])
            evs = {e["name"]: e for e in fr.events() if e["name"] != "prep"}
            assert set(evs) == {"c", "r"}
            assert evs["c"]["parent_id"] == prep.span_id
            assert (evs["c"]["dur_ns"], evs["r"]["dur_ns"]) == (1000, 3000)
            assert evs["c"]["t0_ns"] + evs["c"]["dur_ns"] == evs["r"]["t0_ns"]
            assert evs["c"]["attrs"] == {"synthetic": True}
        assert tree(flightrec.events()) == tree(jax_flightrec.events())

    def test_phase_spans_fit_inside_their_parent(self):
        """Phases summed over worker threads that exceed the parent's
        open time are scaled into it, keeping their sums."""
        obs_trace.configure(True)
        with obs_trace.span("prep"):
            time.sleep(0.001)
            obs_trace.phase_spans(("c", "r"), [10**9, 3 * 10**9])
        evs = {e["name"]: e for e in flightrec.events()}
        c, r, prep = evs["c"], evs["r"], evs["prep"]
        assert prep["t0_ns"] <= c["t0_ns"]
        assert c["t0_ns"] + c["dur_ns"] == r["t0_ns"]
        assert r["t0_ns"] + r["dur_ns"] <= prep["t0_ns"] + prep["dur_ns"]
        assert c["attrs"]["thread_ns"] == 10**9
        assert r["attrs"]["thread_ns"] == 3 * 10**9
        assert 2.5 <= r["dur_ns"] / c["dur_ns"] <= 3.5


class TestTraceEvents:
    def test_export_shape_as_the_jax_module(self):
        objs = []
        for tr in (obs_trace, jax_trace):
            tr.configure(True)
            with tr.span("root", kind="t") as root:
                with tr.span("child"):
                    pass
            with tr.span("other"):
                pass
            objs.append((tr.export_trace(root), root.trace_id))
        for obj, trace_id in objs:
            assert obj["displayTimeUnit"] == "ms"
            assert {e["name"] for e in obj["traceEvents"]} == {"root",
                                                                "child"}
            for e in obj["traceEvents"]:
                assert e["ph"] == "X" and e["pid"] == os.getpid()
                assert isinstance(e["ts"], float)
                assert e["args"]["trace_id"] == trace_id
            json.dumps(obj)
        strip = [sorted((e["name"], e["ph"], e["cat"],
                         sorted(set(e["args"]) - {"trace_id", "span_id",
                                                  "parent_id"}))
                        for e in obj["traceEvents"]) for obj, _ in objs]
        assert strip[0] == strip[1]
        noop = obs_trace.span("x") if not obs_trace.enabled() else None
        assert obs_trace.export_trace(noop) == {"traceEvents": [],
                                                "displayTimeUnit": "ms"}

    def test_in_flight_rendered_as_begin_events(self):
        obs_trace.configure(True)
        sp = obs_trace.span("open")
        sp.__enter__()
        try:
            obj = obs_trace.to_trace_events([], flightrec.in_flight())
            assert obj["traceEvents"][0]["ph"] == "B"
            assert obj["traceEvents"][0]["args"]["in_flight"] is True
        finally:
            sp.__exit__(None, None, None)

    def test_link_copies_a_shared_subtree_into_a_watched_trace(self):
        """A batch serving two watched requests parents to one; the
        other's export holds a copy of its subtree under its own span."""
        obs_trace.configure(True)
        with obs_trace.span("req.a") as a:
            ctx_a = obs_trace.current()
        with obs_trace.span("req.b") as b:
            ctx_b = obs_trace.current()
        with obs_trace.span("req.c"):
            ctx_c = obs_trace.current()
        obs_trace.watch(a)
        obs_trace.watch(b)
        with obs_trace.attach(ctx_a), obs_trace.span("batch") as batch:
            for ctx in (ctx_a, ctx_b, ctx_c):
                obs_trace.link(ctx, batch)
            with obs_trace.span("inner"):
                pass
        obs_trace.unwatch(a)
        obs_trace.unwatch(b)
        got = obs_trace.export_trace(b)["traceEvents"]
        assert sorted(e["name"] for e in got) == ["batch", "inner", "req.b"]
        byname = {e["name"]: e["args"] for e in got}
        assert byname["batch"]["parent_id"] == b.span_id
        assert byname["inner"]["parent_id"] == batch.span_id
        assert {e["args"]["trace_id"] for e in got} == {b.trace_id}
        assert byname["batch"]["linked_from"] == a.trace_id
        # the adopted trace holds the batch once, the unwatched none
        names_a = [e["name"] for e in obs_trace.export_trace(a)
                   ["traceEvents"]]
        assert sorted(names_a) == ["batch", "inner", "req.a"]
        assert not [r for r in flightrec.events()
                    if r["trace_id"] == ctx_c[0] and "link" in r]


# ---------------------------------------------------------------------------
class TestFlightRecorder:
    def test_ring_is_bounded(self):
        obs_trace.configure(True)
        for _ in range(flightrec.RING_EVENTS + 50):
            with obs_trace.span("s"):
                pass
        assert len(flightrec.events()) == flightrec.RING_EVENTS
        assert flightrec.RING_EVENTS == jax_flightrec.RING_EVENTS

    def test_dump_names_in_flight_span_and_wide_events(self, tmp_path,
                                                       monkeypatch):
        """Both packages' postmortems: the in-flight span, the closed
        spans, the counters and the last wide events."""
        from reporter_tpu.obs import profiler as jax_profiler
        monkeypatch.setattr(jax_flightrec, "_dump_dir",
                            str(tmp_path / "jax"))
        configure_obs({"flightrec_dir": str(tmp_path / "port")})
        posts = []
        try:
            for tr, fr, prof in ((obs_trace, flightrec, profiler),
                                 (jax_trace, jax_flightrec, jax_profiler)):
                prof.reset()
                prof.chunk_event(bucket_T=64, K=8, traces=2, rows=2,
                                 kept_points=60, raw_points=70)
                tr.configure(True)
                with tr.span("done"):
                    pass
                sp = tr.span("inflight")
                sp.__enter__()
                try:
                    path = fr.dump("test.reason", {"k": 1})
                finally:
                    sp.__exit__(None, None, None)
                assert os.path.basename(path).startswith(
                    f"flightrec-{os.getpid()}-")
                assert path.endswith("-test.reason.json")
                with open(path, encoding="utf-8") as f:
                    posts.append(json.load(f))
                prof.reset()
        finally:
            configure_obs({"flightrec_dir": None})
        for post in posts:
            assert post["reason"] == "test.reason"
            assert post["extra"] == {"k": 1}
            assert [s["name"] for s in post["in_flight"]] == ["inflight"]
            assert [s["name"] for s in post["spans"]] == ["done"]
            assert post["counters"]["profile.chunks"] >= 1
            (ev,) = post["wide_events"]
            assert (ev["bucket_T"], ev["kept_points"]) == (64, 60)
        assert sorted(posts[0]) == sorted(posts[1])
        assert metrics.default.counter("flightrec.dumps") >= 1

    def test_dump_without_dir_is_skipped(self):
        configure_obs({"flightrec_dir": None})
        assert flightrec.dump("nowhere") is None


# ---------------------------------------------------------------------------
SPECS = ["a.b=250,c=1.5", "", "stage=100", "stage=1",
         "stage=1,never_ran=1", "no.such.stage=1,stage=5000", " stage = 2 ",
         "a", "a=", "a=x", "a=-5", "a=0", "stage=0", "surely=not=a=spec"]


class TestSLO:
    @pytest.mark.parametrize("spec", SPECS)
    def test_parse_spec_as_the_jax_module(self, spec):
        def run(mod):
            try:
                return mod.parse_spec(spec)
            except ValueError as e:
                return ("ValueError", str(e))
        assert run(slo) == run(jax_slo)

    @pytest.mark.parametrize("spec", SPECS)
    def test_check_as_the_jax_module(self, spec, monkeypatch):
        regs = Registry(), jax_metrics.Registry()
        for r in regs:
            for s in (0.004, 0.004, 0.5, 0.004):
                r.observe("stage", s)
            r.observe("a.b", 0.3)
        monkeypatch.setenv(jax_slo.ENV_VAR, spec)
        jax_slo._cache_spec = None
        configure_obs({"slo_ms": spec})
        assert slo.check(regs[0]) == jax_slo.check(regs[1])

    def test_malformed_spec_fails_open_and_counts(self):
        before = metrics.default.counter("slo.malformed")
        configure_obs({"slo_ms": "surely=not=a=spec"})
        assert slo.thresholds() == {}
        assert slo.check(Registry()) == {"targets": {}, "breaches": []}
        assert metrics.default.counter("slo.malformed") == before + 1


# ---------------------------------------------------------------------------
_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{le="[^"]+"\})? [0-9eE.+-]+$')
_META_RE = re.compile(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|histogram)$")


def scrape_clean(text: str) -> None:
    """Every line a TYPE line or a sample, every histogram's buckets
    monotone and its +Inf bucket equal to its count."""
    assert text.endswith("\n")
    buckets, counts = {}, {}
    for line in text.splitlines():
        assert _META_RE.match(line) or _SAMPLE_RE.match(line), line
        m = re.match(r'^(\S+)_bucket\{le="([^"]+)"\} (\d+)$', line)
        if m:
            buckets.setdefault(m.group(1), []).append((m.group(2),
                                                       int(m.group(3))))
        m = re.match(r"^(\S+)_count (\d+)$", line)
        if m:
            counts[m.group(1)] = int(m.group(2))
    assert set(buckets) == set(counts)
    for base, bs in buckets.items():
        vals = [n for _, n in bs]
        assert vals == sorted(vals), base
        assert bs[-1] == ("+Inf", counts[base]), base


class TestProm:
    def test_render_byte_identical_to_the_jax_module(self):
        regs = Registry(), jax_metrics.Registry()
        for r in regs:
            r.count("service.requests", 3)
            r.count("dispatch.queue-rejected")
            r.count("decode.shadow.sampled", 128)
            for s in (0.0, 1e-7, 0.004, 0.5, 3.0, 500.0):
                r.observe("service.handle", s)
            r.observe("decode.occupancy.t64", 0.53125)
        text = prom.render(regs[0])
        assert text == jax_prom.render(regs[1])
        assert prom.CONTENT_TYPE == jax_prom.CONTENT_TYPE
        assert prom.sanitize("a.b-c") == jax_prom.sanitize("a.b-c")
        scrape_clean(text)

    def test_empty_registry(self):
        assert prom.render(Registry()) == jax_prom.render(
            jax_metrics.Registry())


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fixture():
    with open(FIXTURE) as f:
        return json.load(f)


def _start(service, serve_fn):
    httpd = serve_fn(service, "127.0.0.1", 0)
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module", params=["numpy", "native"])
def servers(fixture, request):
    """(JAX URL, port URL) serving the report-parity city on one prep
    path, threshold 15, max_batch 64, max_wait 30 ms."""
    native = request.param == "native"
    kw = dict(threshold_sec=15, max_batch=64, max_wait_ms=30.0)
    ref = JaxService(JaxMatcher(net=jax_city(**fixture["city"]),
                                use_native=native), **kw)
    port = ReporterService(SegmentMatcher(
        build_grid_city(**fixture["city"]), device="cpu", native=native),
        **kw)
    started = [_start(ref, jax_serve), _start(port, serve)]
    # one request through each first: the JAX package's first decode of
    # a shape compiles
    body = json.dumps(fixture["requests"][0]).encode()
    for _h, url in started:
        assert call(url, "/report", body)[0] == 200
    yield started[0][1], started[1][1]
    for (httpd, _u), svc in zip(started, (ref, port)):
        httpd.shutdown()
        httpd.server_close()
        assert svc.dispatcher.close()


def call(url, path, body=None):
    req = urllib.request.Request(url + path, data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def span_tree(envelope):
    """(sorted names, sorted (name, parent name)) of a ?trace=1 answer."""
    evs = envelope["trace"]["traceEvents"]
    name = {e["args"]["span_id"]: e["name"] for e in evs}
    return (sorted(e["name"] for e in evs),
            sorted((e["name"], name.get(e["args"]["parent_id"]))
                   for e in evs))


class TestServiceObservability:
    def test_trace_flag_ships_the_jax_span_tree(self, fixture, servers):
        u_ref, u_port = servers
        body = json.dumps(fixture["requests"][1]).encode()
        trees = []
        for url in (u_ref, u_port):
            st, _h, plain = call(url, "/report", body)
            st2, _h, traced = call(url, "/report?trace=1", body)
            assert (st, st2) == (200, 200)
            assert traced.startswith(b'{"report":' + plain + b',"trace":')
            env = json.loads(traced)
            evs = env["trace"]["traceEvents"]
            assert len({e["args"]["trace_id"] for e in evs}) == 1
            trees.append(span_tree(env))
        assert trees[0] == trees[1]
        names = set(trees[1][0])
        assert {"service.request", "service.parse", "service.handle",
                "dispatch.batch", "dispatch.match_many", "matcher.chunk",
                "report.serialise"} | STAGE_TIMERS <= names

    def test_falsy_spellings_stay_plain(self, fixture, servers):
        _u_ref, u_port = servers
        body = json.dumps(fixture["requests"][2]).encode()
        plain = call(u_port, "/report", body)[2]
        for flag in ("0", "off", "false", ""):
            got = call(u_port, f"/report?trace={flag}", body)[2]
            assert got == plain

    def test_stats_timer_names_as_the_jax_service(self, fixture, servers):
        """The port's /stats carries the JAX service's timers, the
        matcher's four stage timers among them."""
        u_ref, u_port = servers
        jax_metrics.default.reset()
        metrics.default.reset()
        for req in fixture["requests"][:5]:
            body = json.dumps(req).encode()
            for url in (u_ref, u_port):
                assert call(url, "/report", body)[0] == 200
        names = [set(json.loads(call(url, "/stats")[2])["timers"])
                 for url in (u_ref, u_port)]
        assert names[0] == names[1]
        assert STAGE_TIMERS <= names[1]

    def test_metrics_endpoint_scrape_clean(self, fixture, servers):
        _u_ref, u_port = servers
        call(u_port, "/report", json.dumps(fixture["requests"][0]).encode())
        st, headers, body = call(u_port, "/metrics")
        assert st == 200
        assert headers["Content-type"] == prom.CONTENT_TYPE
        text = body.decode()
        scrape_clean(text)
        assert "reporter_tpu_matcher_prep_seconds_count" in text

    def test_profile_carries_the_chunks(self, fixture, servers):
        _u_ref, u_port = servers
        profiler.reset()
        call(u_port, "/report", json.dumps(fixture["requests"][3]).encode())
        prof = json.loads(call(u_port, "/profile")[2])
        assert {"shapes", "compile_episodes", "events", "totals", "shadow",
                "routes", "queue_depth", "queue_depths"} <= set(prof)
        (ev,) = prof["events"]
        assert (ev["traces"], ev["K"]) == (1, 8)
        (shape,) = prof["shapes"]
        assert (shape["platform"], shape["backend"]) == ("cpu", "plain")
        assert shape["compiles"] == 0

    def test_health_slo_breach_degrades(self, fixture, servers,
                                        monkeypatch):
        u_ref, u_port = servers
        body = json.dumps(fixture["requests"][0]).encode()
        for url in (u_ref, u_port):
            call(url, "/report", body)
        healthy = json.loads(call(u_port, "/health")[2])
        assert healthy["status"] == "ok" and "shadow" in healthy
        monkeypatch.setenv(jax_slo.ENV_VAR, "service.handle=0.001")
        configure_obs({"slo_ms": "service.handle=0.001"})
        got = []
        for url in (u_ref, u_port):
            st, _h, raw = call(url, "/health")
            h = json.loads(raw)
            got.append((st, h["status"], h["slo"]["targets"],
                        [b["stage"] for b in h["slo"]["breaches"]]))
        assert got[0] == got[1] == (503, "degraded",
                                    {"service.handle": 0.001},
                                    ["service.handle"])


def test_config_keys_reach_the_modules(tmp_path):
    """The six observability keys of a config file, through read_config
    and configure_obs."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"graph": "city.npz", "service": {
        "trace": "1", "slo_ms": "service.handle=250",
        "shadow_sample": 0.25, "profile_events": 32,
        "flightrec_dir": str(tmp_path / "rec"), "lockcheck": False}}))
    conf = read_config(str(cfg))
    assert set(conf["obs"]) == {"trace", "slo_ms", "shadow_sample",
                                "profile_events", "flightrec_dir",
                                "lockcheck"}
    try:
        configure_obs(conf["obs"])
        assert obs_trace.enabled()
        assert slo.thresholds() == {"service.handle": 0.25}
        assert profiler.shadow_fraction() == 0.25
        assert flightrec.dump_dir() == str(tmp_path / "rec")
        assert not locks.armed()
        for _ in range(40):
            profiler.chunk_event(bucket_T=16, K=8, traces=1, rows=1,
                                 kept_points=8, raw_points=10)
        assert len(profiler.recent_events(None)) == 32
    finally:
        configure_obs({"trace": False, "slo_ms": None, "shadow_sample": 0.0,
                       "profile_events": profiler.DEFAULT_EVENTS,
                       "flightrec_dir": None})
        profiler.reset()


# ---------------------------------------------------------------------------
@pytest.fixture(params=["port", "jax"])
def witness(request):
    """(locks module, racecheck module) of one package, armed with a
    100 ms RC002 threshold; restored and cleared afterwards."""
    lk, rc = (locks, racecheck) if request.param == "port" \
        else (jax_locks, jax_racecheck)
    was_armed = lk.armed()
    rc.reset()
    lk.arm(hold_ms=100.0)
    yield lk, rc
    rc.reset()
    if not was_armed:
        lk.disarm()


class TestLockWitness:
    def test_inversion_is_rc001(self, witness):
        lk, rc = witness
        a, b = lk.TrackedLock("t.inv.a"), lk.TrackedLock("t.inv.b")
        with a:
            with b:
                pass
        assert rc.findings() == []

        def reverse():
            with b:
                with a:
                    pass
        t = threading.Thread(target=reverse, name="reverse")
        t.start()
        t.join()
        (f,) = rc.findings()
        assert f.rule == "RC001"
        assert "t.inv.a" in f.message and "t.inv.b" in f.message
        assert re.match(r"^tests/test_torch_obs\.py:\d+: RC001 ",
                        f.render())

    def test_unguarded_access_is_rc003(self, witness):
        lk, rc = witness
        lock = lk.TrackedLock("t.guard.lock")
        state = lk.Guarded({}, lock, "t.guard.state")
        with lock:
            state["k"] = 1
        assert rc.findings() == []
        state["k"] = 2
        (f,) = rc.findings()
        assert f.rule == "RC003" and "t.guard.state" in f.message

    def test_foreign_thread_is_rc004_and_hold_is_rc002(self, witness):
        lk, rc = witness

        class Owned:
            @lk.thread_affine
            def touch(self):
                pass

        obj = Owned()
        obj.touch()
        t = threading.Thread(target=obj.touch)
        t.start()
        t.join()
        slow = lk.TrackedLock("t.slow")
        with slow:
            time.sleep(0.15)
        assert sorted(f.rule for f in rc.findings()) == ["RC002", "RC004"]

    def test_port_findings_feed_metrics_and_flightrec(self, tmp_path):
        racecheck.reset()
        locks.arm(hold_ms=100.0)
        configure_obs({"flightrec_dir": str(tmp_path)})
        try:
            c0 = metrics.default.counter("racecheck.RC003")
            locks.Guarded({}, locks.TrackedLock("t.m.lock"),
                          "t.m.state")["k"] = 1
            assert metrics.default.counter("racecheck.RC003") == c0 + 1
            assert [p.name for p in tmp_path.iterdir()
                    if "racecheck.RC003" in p.name]
        finally:
            configure_obs({"flightrec_dir": None})
            locks.disarm()
            racecheck.reset()


def test_prefork_slot_dumps_into_its_own_directory(tmp_path):
    """A pre-forked worker's postmortems go under ``p<slot>/`` of the
    dump directory, where the supervisor finds a dead worker's by pid."""
    from reporter_tpu_torch.service import prefork
    assert prefork.slot_dump_dir(str(tmp_path), 3) == str(tmp_path / "p3")
    configure_obs({"flightrec_dir": str(tmp_path)})
    try:
        slot_dir = tmp_path / "p3"
        slot_dir.mkdir()
        for name in ("flightrec-41-0001-a.json", "flightrec-41-0002-b.json",
                     "flightrec-42-0001-a.json"):
            (slot_dir / name).write_text("{}")
        assert [os.path.basename(p) for p in prefork._flightrec_dumps(3, 41)] \
            == ["flightrec-41-0001-a.json", "flightrec-41-0002-b.json"]
        assert prefork._flightrec_dumps(2, 41) == []
    finally:
        configure_obs({"flightrec_dir": None})
    assert prefork._flightrec_dumps(3, 41) == []
