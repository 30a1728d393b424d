"""The port's failure domains against the JAX package's.

Each test runs the JAX package and the port in one process on the same
seeded inputs, with the same fault spec armed in both packages'
``utils.faults`` (the JAX side's breaker knobs through
``monkeypatch.setenv``, the port's as arguments), and compares what
comes out:

- the spec grammar, the malformed specs and the fire positions (the
  probability replaying the same calls);
- the breaker's state machine, driven by one injected clock;
- the host-to-host domains ``native.prep``, ``matcher.assemble`` (one
  poisoned trace, its quarantine file) and ``wire.native``: ``/report``
  bodies byte-equal, the same counters and the same
  ``circuit_snapshots()``;
- the dead-letter spool's cap and ``fsio``'s atomic writes;
- ``/health``'s blocks and status codes, per domain.

The port's own contract where it departs on purpose: ``decode.dispatch``
and ``route.device``, and ``native.prep`` on a device-route matcher,
never degrade to the host. A failure answers 500; while the breaker is
open a request answers 503 with ``Retry-After`` and nothing is launched
for it; after the cooldown a probe closes the breaker, also when the
probe's chunk failed in the neighbouring stage. A wire probe that a
chunk memo hit serves closes its breaker. Tolerance: exact.
"""
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from reporter_tpu.matcher import MatchParams as JaxParams
from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.service import wire as jax_wire
from reporter_tpu.service.report import report_wire as jax_report_wire
from reporter_tpu.service.server import ReporterService as JaxService
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu.synth import generate_trace as jax_trace
from reporter_tpu.utils import faults as jax_faults
from reporter_tpu.utils import fsio as jax_fsio
from reporter_tpu.utils import metrics as jax_metrics
from reporter_tpu.utils import spool as jax_spool
from reporter_tpu.utils.circuit import CircuitBreaker as JaxBreaker
from reporter_tpu_torch import ops
from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
from reporter_tpu_torch.matcher import matcher as matcher_mod
from reporter_tpu_torch.service import wire
from reporter_tpu_torch.service.report import report_wire
from reporter_tpu_torch.service.server import ReporterService, serve
from reporter_tpu_torch.synth import build_grid_city, generate_trace
from reporter_tpu_torch.utils import faults, fsio, metrics, spool
from reporter_tpu_torch.utils.circuit import CircuitBreaker

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "report_parity.json")
LEVELS = (15, {0, 1, 2}, {0, 1, 2})
COOLDOWN_S = 10.0


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test starts and ends with both fault tables empty."""
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


@pytest.fixture(scope="module")
def cities():
    with open(FIXTURE) as f:
        city = json.load(f)["city"]
    return jax_city(**city), build_grid_city(**city)


@pytest.fixture(scope="module")
def requests(cities):
    """Eighteen requests from one seeded numpy stream through each
    package's synth, cut to 12, 40 and 100 points in turn: three length
    buckets, so the native path preps three chunks."""
    ref_city, city = cities
    rng_ref, rng = np.random.default_rng(21), np.random.default_rng(21)
    reqs = []
    while len(reqs) < 18:
        n = (12, 40, 100)[len(reqs) % 3]
        tr_ref = jax_trace(ref_city, f"fd-{len(reqs)}", rng_ref,
                           min_route_edges=8)
        tr = generate_trace(city, f"fd-{len(reqs)}", rng, min_route_edges=8)
        assert (tr_ref is None) == (tr is None)
        if tr is None or len(tr.points) < n:
            continue
        assert tr.points == tr_ref.points
        req = tr.request_json(report_levels=(0, 1, 2),
                              transition_levels=(0, 1, 2))
        req["trace"] = tr.points[:n]
        reqs.append(req)
    return reqs


def matcher_pair(cities, monkeypatch, native=True, threshold=2):
    """(the JAX package's matcher, the port's, the clock list) with the
    same breaker threshold and cooldown, every breaker on one injected
    clock (``now[0]`` seconds)."""
    ref_city, city = cities
    monkeypatch.setenv("REPORTER_TPU_CIRCUIT_THRESHOLD", str(threshold))
    monkeypatch.setenv("REPORTER_TPU_CIRCUIT_COOLDOWN_S", str(COOLDOWN_S))
    jm = JaxMatcher(net=ref_city, params=JaxParams(max_candidates=8),
                    use_native=native)
    m = SegmentMatcher(city, MatchParams(max_candidates=8), device="cpu",
                       native=native, circuit_threshold=threshold,
                       circuit_cooldown_s=COOLDOWN_S)
    now = [0.0]
    for matcher in (jm, m):
        for _domain, attr in matcher.CIRCUIT_DOMAINS:
            getattr(matcher, attr)._clock = lambda: now[0]
    return jm, m, now


def domain_counters(registry) -> dict:
    """The failure domains' counters of one package's registry."""
    return {k: v for k, v in registry.snapshot()["counters"].items()
            if "circuit" in k or k.startswith(("wire.", "deadletter"))
            or k in ("matcher.assemble.quarantined",
                     "route.device.errors")}


def reset_counters():
    metrics.default.reset()
    jax_metrics.default.reset()


def bodies_pair(jm, m, reqs):
    """(JAX bodies, port bodies) of one match_many each, by the serving
    path's writer."""
    want = [bytes(jax_report_wire(r, q, *LEVELS))
            for r, q in zip(jm.match_many(reqs), reqs)]
    got = [bytes(report_wire(r, q, *LEVELS))
           for r, q in zip(m.match_many(reqs), reqs)]
    return want, got


def arm(spec):
    faults.configure(spec)
    jax_faults.configure(spec)


def assert_same_state(jm, m):
    assert m.circuit_snapshots() == jm.circuit_snapshots()
    assert m.open_domains() == jm.open_domains()
    assert domain_counters(metrics.default) \
        == domain_counters(jax_metrics.default)


# -- the spec grammar and firing ---------------------------------------------
@pytest.mark.parametrize("spec", [
    "native.prep=error:0.5@7#10+3,egress.http=timeout",
    "s=crash+669#1", "s=crash#1+669", "wire.native=partial@3",
    "a.b=error:0.25@42#5, decode.dispatch=timeout+2"])
def test_spec_parses_as_the_jax_package(spec):
    def fields(sites):
        return {k: (fp.kind, fp.prob, fp.seed, fp.limit, fp.skip)
                for k, fp in sites.items()}
    assert fields(faults.parse_spec(spec)) \
        == fields(jax_faults.parse_spec(spec))


@pytest.mark.parametrize("bad", [
    "nope", "site=explode", "site=error:2.0", "site=error:x",
    "=error", "site=error@seed"])
def test_malformed_spec_rejected(bad):
    with pytest.raises(ValueError):
        jax_faults.parse_spec(bad)
    with pytest.raises(ValueError):
        faults.parse_spec(bad)
    with pytest.raises(ValueError):
        faults.configure(bad)
    assert faults.active_spec() is None


def fire_pattern(mod, spec, calls, after=False):
    """[fired?] of ``calls`` failpoint calls at site ``s`` under
    ``spec``, and the fired counts."""
    mod.configure(spec)
    out = []
    for _ in range(calls):
        try:
            mod.failpoint("s", after=after)
            out.append(False)
        except mod.FaultError:
            out.append(True)
    return out, mod.fired_counts()


@pytest.mark.parametrize("spec,after", [
    ("s=error:0.4@42", False), ("s=error:0.1@7#3", False),
    ("s=error#2", False), ("s=error+3#1", False), ("s=timeout:0.5@1", False),
    ("s=partial", False), ("s=partial", True), ("s=error", True),
    ("other=error", False)])
def test_fires_on_the_same_calls(spec, after):
    got = fire_pattern(faults, spec, 60, after)
    assert got == fire_pattern(jax_faults, spec, 60, after)
    assert got == fire_pattern(faults, spec, 60, after)  # replays
    assert faults.active_spec() == spec


def test_timeout_is_both_kinds_and_clear_disarms():
    faults.configure("s=timeout")
    with pytest.raises(TimeoutError):
        faults.failpoint("s")
    with pytest.raises(faults.FaultError):
        faults.failpoint("s")
    faults.clear()
    assert faults.active_spec() is None and faults.fired_counts() == {}
    faults.failpoint("s")


# -- the breaker --------------------------------------------------------------
#: (clock, op) steps; op is allow, success, failure or snapshot
BREAKER_WALK = [
    (0.0, "failure"), (0.0, "allow"), (0.0, "snapshot"), (0.0, "failure"),
    (0.0, "allow"), (4.0, "snapshot"), (9.9, "allow"), (10.0, "snapshot"),
    (10.0, "allow"), (10.0, "allow"), (10.5, "failure"), (12.0, "snapshot"),
    (20.4, "allow"), (20.5, "allow"), (20.5, "allow"), (21.0, "success"),
    (21.0, "allow"), (21.0, "snapshot"), (22.0, "failure"),
    (22.0, "success"), (22.0, "failure"), (22.0, "snapshot")]


@pytest.mark.parametrize("threshold", [1, 2, 3])
def test_breaker_walks_as_the_jax_package(threshold):
    now = [0.0]
    sides = []
    for cls, reg in ((CircuitBreaker, metrics.Registry()),
                     (JaxBreaker, jax_metrics.Registry())):
        sides.append((cls("t.circuit", threshold=threshold,
                          cooldown_s=COOLDOWN_S, clock=lambda: now[0],
                          registry=reg), reg))
    for t, op in BREAKER_WALK:
        now[0] = t
        seen = []
        for cb, _reg in sides:
            if op == "allow":
                seen.append(cb.allow())
            elif op == "snapshot":
                seen.append((cb.snapshot(), cb.state))
            else:
                getattr(cb, f"record_{op}")()
                seen.append(cb.state)
        assert seen[0] == seen[1], (t, op)
    assert sides[0][1].snapshot()["counters"] \
        == sides[1][1].snapshot()["counters"]


def test_open_breaker_refuses_with_the_cooldown_left():
    now = [0.0]
    cb = CircuitBreaker("t.refuse", threshold=1, cooldown_s=COOLDOWN_S,
                        clock=lambda: now[0], registry=metrics.Registry())
    cb.record_failure()
    now[0] = 3.5
    err = cb.refuse("decode.dispatch")
    assert (err.domain, err.retry_after_s) == ("decode.dispatch", 7)
    now[0] = 9.99
    assert cb.retry_after_s() == 1


# -- the host-to-host domains ---------------------------------------------------
def test_native_prep_domain_degrades_as_the_jax_package(cities, requests,
                                                        monkeypatch):
    """Two prep errors open the breaker (threshold 2); the third chunk
    takes the numpy prep without trying; after the cooldown the first
    chunk is the probe that closes it. Bodies equal the healthy run's in
    every call."""
    jm, m, now = matcher_pair(cities, monkeypatch)
    healthy, got = bodies_pair(jm, m, requests)
    assert got == healthy
    reset_counters()
    arm("native.prep=error#2")
    want, got = bodies_pair(jm, m, requests)
    assert got == want == healthy
    assert_same_state(jm, m)
    assert m.open_domains() == ["native.prep"]
    assert metrics.counter("matcher.circuit.fallback_chunks") == 1
    now[0] = COOLDOWN_S
    want, got = bodies_pair(jm, m, requests)
    assert got == want == healthy
    assert_same_state(jm, m)
    assert m.circuit.state == "closed"
    assert metrics.counter("matcher.circuit.closed") == 1


@pytest.mark.parametrize("native,spec", [
    (True, "matcher.assemble=error#2"),      # the batch call, then trace 0
    (True, "matcher.assemble=error@0#7"),    # two batch calls and traces
    (False, "matcher.assemble=error+1#1")])  # the second trace of a chunk
def test_assemble_domain_quarantines_as_the_jax_package(
        cities, requests, monkeypatch, tmp_path, native, spec):
    jm, m, _now = matcher_pair(cities, monkeypatch, native=native)
    healthy, _ = bodies_pair(jm, m, requests)
    jax_spool.set_trace_dir(str(tmp_path / "jax"))
    spool.set_trace_dir(str(tmp_path / "port"))
    reset_counters()
    arm(spec)
    try:
        want, got = bodies_pair(jm, m, requests)
    finally:
        jax_spool.set_trace_dir(None)
        spool.set_trace_dir(None)
    assert got == want
    assert_same_state(jm, m)
    poisoned = [i for i, (g, h) in enumerate(zip(got, healthy)) if g != h]
    assert len(poisoned) == metrics.counter(
        "matcher.assemble.quarantined") >= 1
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) \
        == sorted(f"poison.{requests[i]['uuid']}.json" for i in poisoned)
    by_uuid = {r["uuid"]: r for r in requests}
    for name in names:
        raw = (tmp_path / "port" / name).read_bytes()
        assert raw == (tmp_path / "jax" / name).read_bytes()
        body = json.loads(raw)
        sent = by_uuid[body["uuid"]]["trace"]
        assert [(p["lat"], p["lon"], p["time"]) for p in body["trace"]] \
            == [(p["lat"], p["lon"], p["time"]) for p in sent]


def test_wire_domain_degrades_as_the_jax_package(cities, requests,
                                                 monkeypatch):
    """Writer faults serve the Python writer's bytes; the second opens the
    breaker (threshold 2), an open breaker skips the C writer, a failed
    probe re-opens it and the next probe closes it."""
    now = [0.0]
    monkeypatch.setattr(jax_wire, "circuit", JaxBreaker(
        "wire.circuit", threshold=2, cooldown_s=COOLDOWN_S,
        clock=lambda: now[0]))
    monkeypatch.setattr(wire, "circuit", CircuitBreaker(
        "wire.circuit", threshold=2, cooldown_s=COOLDOWN_S,
        clock=lambda: now[0]))
    jm, m, _ = matcher_pair(cities, monkeypatch)
    healthy, _ = bodies_pair(jm, m, requests)
    j_runs, runs = jm.match_many(requests), m.match_many(requests)
    reset_counters()
    arm("wire.native=error#3")
    for i, req in enumerate(requests):
        if i in (6, 12):  # past the cooldown: a probe
            now[0] += COOLDOWN_S
        want = bytes(jax_report_wire(j_runs[i], req, *LEVELS))
        assert bytes(report_wire(runs[i], req, *LEVELS)) == want \
            == healthy[i]
        assert wire.circuit.snapshot() == jax_wire.circuit.snapshot(), i
        assert domain_counters(metrics.default) \
            == domain_counters(jax_metrics.default), i
    assert metrics.counter("wire.errors") == 3
    assert metrics.counter("wire.circuit.opened") == 2
    assert wire.circuit.state == "closed"


def test_segments_writer_degrades_as_the_jax_package(cities, requests,
                                                     monkeypatch):
    """``Match()``'s segments writer shares the writer's failure domain:
    a fault serves the Python writer's bytes and counts alike."""
    from reporter_tpu.matcher.matcher import \
        render_segments_json as jax_render
    from reporter_tpu_torch.matcher.matcher import render_segments_json
    monkeypatch.setattr(jax_wire, "circuit", JaxBreaker("wire.circuit"))
    monkeypatch.setattr(wire, "circuit", CircuitBreaker("wire.circuit"))
    jm, m, _ = matcher_pair(cities, monkeypatch)
    j_runs, runs = jm.match_many(requests), m.match_many(requests)
    reset_counters()
    arm("wire.native=error+1#2")
    for jr, r in zip(j_runs, runs):
        got = render_segments_json(r.cols, r.lo, r.hi, r.mode)
        assert got == jax_render(jr.cols, jr.lo, jr.hi, jr.mode)
    assert domain_counters(metrics.default) \
        == domain_counters(jax_metrics.default)
    assert metrics.counter("wire.errors") == 2


def test_wire_probe_served_by_the_chunk_memo_closes_the_breaker(
        cities, requests, monkeypatch):
    """A half-open probe that a chunk memo hit serves closes the breaker:
    the bytes are the C writer's. The JAX package leaves that probe in
    flight, so its breaker stays half-open with the C writer skipped; the
    bytes agree either way."""
    now = [0.0]
    monkeypatch.setattr(jax_wire, "circuit", JaxBreaker(
        "wire.circuit", threshold=1, cooldown_s=COOLDOWN_S,
        clock=lambda: now[0]))
    monkeypatch.setattr(wire, "circuit", CircuitBreaker(
        "wire.circuit", threshold=1, cooldown_s=COOLDOWN_S,
        clock=lambda: now[0]))
    jm, m, _ = matcher_pair(cities, monkeypatch)
    j_runs, runs = jm.match_many(requests), m.match_many(requests)

    def both(i, levels):
        want = bytes(jax_report_wire(j_runs[i], requests[i], *levels))
        assert bytes(report_wire(runs[i], requests[i], *levels)) == want
        return want

    both(0, LEVELS)  # the chunk of requests 0, 3, 6, ... memoises
    arm("wire.native=error#1")
    both(0, (15, {0, 1}, {0, 1}))  # another key: the C call, which fails
    assert wire.circuit.state == jax_wire.circuit.state == "open"
    now[0] = COOLDOWN_S
    both(3, LEVELS)  # the probe: a memo hit
    assert wire.circuit.state == "closed"
    assert jax_wire.circuit.state == "half_open"
    assert metrics.counter("wire.circuit.closed") == 1


# -- the port's own contract: decode and device routes ------------------------
def call(url, path, body=None):
    req = urllib.request.Request(url + path, data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


#: domain -> (route_device, its errors counter, its breaker's prefix).
#: ``native.prep`` on a device-route matcher: its numpy prep would search
#: the routes on the host, so there it raises like the card's domains
CARD_DOMAINS = {
    "decode.dispatch": (False, "matcher.circuit.decode.errors",
                        "matcher.circuit.decode"),
    "route.device": (True, "route.device.errors", "matcher.circuit.route"),
    "native.prep": (True, "matcher.circuit.native_errors",
                    "matcher.circuit")}


def card_service(cities, monkeypatch, route_device):
    """(matcher, service, server, url, clock, launches, host preps): a
    threshold-1 port matcher on one injected clock behind a served front
    door. ``launches`` records each decode (``ops.decode_batch``), or with
    device routes each route kernel call; ``host preps`` each numpy prep,
    which would search the routes on the host."""
    m = SegmentMatcher(cities[1], MatchParams(max_candidates=8),
                       device="cpu", route_device=route_device,
                       circuit_threshold=1, circuit_cooldown_s=COOLDOWN_S)
    now = [0.0]
    for _d, attr in m.CIRCUIT_DOMAINS:
        getattr(m, attr)._clock = lambda: now[0]
    launches, host_preps = [], []
    if route_device:
        fill = m.route_kernel.fill_prep
        monkeypatch.setattr(m.route_kernel, "fill_prep", lambda *a, **k: (
            launches.append(1), fill(*a, **k))[1])
    else:
        decode = ops.decode_batch
        monkeypatch.setattr(ops, "decode_batch", lambda *a: (
            launches.append(1), decode(*a))[1])
    numpy_prep = matcher_mod.prepare_traces_numpy
    monkeypatch.setattr(matcher_mod, "prepare_traces_numpy", lambda *a: (
        host_preps.append(1), numpy_prep(*a))[1])
    svc = ReporterService(m, max_batch=64, max_wait_ms=1.0)
    httpd = serve(svc, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    return m, svc, httpd, url, now, launches, host_preps


def close_service(svc, httpd):
    httpd.shutdown()
    httpd.server_close()
    assert svc.dispatcher.close()


@pytest.mark.parametrize("domain", sorted(CARD_DOMAINS))
def test_card_domains_refuse_and_never_degrade(cities, requests,
                                               monkeypatch, domain):
    """A failure answers 500; the open breaker answers 503 with
    Retry-After (the cooldown left) and /health names the domain, and
    nothing is launched; after the cooldown the probe launches, answers
    200 with the healthy bytes and closes the breaker. No chunk takes the
    numpy prep."""
    route_device, errors, breaker = CARD_DOMAINS[domain]
    m, svc, httpd, url, now, launches, host_preps = card_service(
        cities, monkeypatch, route_device)
    body = json.dumps(requests[1]).encode()
    try:
        st, _h, healthy = call(url, "/report", body)
        assert st == 200 and launches
        faults.configure(f"{domain}=error#1")
        reset_counters()
        st, _h, raw = call(url, "/report", body)
        assert st == 500 and "injected error" in json.loads(raw)["error"]
        assert metrics.counter(errors) == 1
        st, _h, raw = call(url, "/health")
        assert st == 503 and json.loads(raw)["degraded"]["open"] == [domain]
        launches.clear()
        now[0] = 2.5
        st, headers, raw = call(url, "/report", body)
        assert st == 503 and headers["Retry-After"] == "8"
        assert json.loads(raw)["domain"] == domain
        assert json.loads(raw)["retry_after_s"] == 8
        assert not launches
        now[0] = COOLDOWN_S
        st, _h, raw = call(url, "/report", body)
        assert st == 200 and raw == healthy and launches
        st, _h, _raw = call(url, "/health")
        assert st == 200
        assert m.open_domains() == []
        assert metrics.counter(f"{breaker}.closed") == 1
        assert not host_preps
    finally:
        close_service(svc, httpd)


@pytest.mark.parametrize("opened,next_door", [
    ("native.prep", "route.device"), ("route.device", "native.prep")])
def test_a_probe_failing_next_door_strands_no_breaker(
        cities, requests, monkeypatch, opened, next_door):
    """On a device-route matcher the native prep and the route kernel are
    neighbouring stages of one chunk. Open one breaker, then let its
    half-open probe fail in the other stage: the probe's breaker records
    what its own stage did (the native call ran, so it closes; the route
    kernel was never reached, so no probe was taken), /health names
    exactly the open domain, and after the cooldown both breakers close
    and /health answers 200."""
    m, svc, httpd, url, now, _launches, host_preps = card_service(
        cities, monkeypatch, True)
    body = json.dumps(requests[1]).encode()
    try:
        st, _h, healthy = call(url, "/report", body)
        assert st == 200
        faults.configure(f"{opened}=error#1")
        assert call(url, "/report", body)[0] == 500
        assert m.open_domains() == [opened]
        now[0] = COOLDOWN_S
        faults.configure(f"{next_door}=error#1")
        assert call(url, "/report", body)[0] == 500
        assert m.open_domains() == [next_door]
        st, _h, raw = call(url, "/health")
        assert st == 503 and json.loads(raw)["degraded"]["open"] \
            == [next_door]
        if opened == "native.prep":
            assert m.circuit.state == "closed"
        now[0] = 2 * COOLDOWN_S
        st, _h, raw = call(url, "/report", body)
        assert st == 200 and raw == healthy
        assert {s["state"] for s in m.circuit_snapshots().values()} \
            == {"closed"}
        assert call(url, "/health")[0] == 200
        assert not host_preps
    finally:
        close_service(svc, httpd)


def test_commit_failpoint_declines_every_slot_to_match_many(
        cities, requests, monkeypatch):
    """``match.incremental.commit``: the JAX package and the port decline
    the same slots, the breaker counts the same failure, and the declined
    slots' bodies through match_many equal the JAX package's."""
    jm, m, _now = matcher_pair(cities, monkeypatch)
    monkeypatch.setenv("REPORTER_TPU_INCREMENTAL_LAG", "8")
    m.incremental_lag = 8
    reqs = [dict(r, trace=r["trace"][:30]) for r in requests[2::3]]
    served = [x is not None for x in m.match_incremental(reqs)]
    assert served == [x is not None for x in jm.match_incremental(reqs)]
    assert any(served)
    reset_counters()
    arm("match.incremental.commit=error#1")
    longer = [dict(r, trace=r["trace"][:60]) for r in requests[2::3]]
    assert jm.match_incremental(longer) == [None] * len(longer) \
        == m.match_incremental(longer)
    assert faults.fired_counts() == jax_faults.fired_counts() \
        == {"match.incremental.commit": 1}
    assert_same_state(jm, m)
    assert metrics.counter("matcher.circuit.incremental.failures") == 1
    want, got = bodies_pair(jm, m, longer)
    assert got == want


# -- the remaining sites, armed in both packages ------------------------------
def test_submit_failpoint_dead_letters_as_the_jax_package(tmp_path):
    """``matcher.submit``: a failed flush of two evicted sessions drops
    and dead-letters both in each package (an evicted session has no next
    flush to ride), the submit is never called, and the spooled request
    bodies are equal."""
    from reporter_tpu.core.types import Point as JaxPoint
    from reporter_tpu.streaming.batcher import PointBatcher as JaxBatcher
    from reporter_tpu_torch.core.types import Point
    from reporter_tpu_torch.streaming.batcher import PointBatcher
    arm("matcher.submit=error#1")
    runs = []
    for name, P, cls, reg in (("jax", JaxPoint, JaxBatcher, jax_metrics),
                              ("port", Point, PointBatcher, metrics)):
        reg.default.reset()
        calls = []
        spool_dir = tmp_path / name
        b = cls(lambda t: None, lambda k, s: None, report_on="0,1,2",
                transition_on="0,1,2", deadletter_dir=str(spool_dir),
                submit_many=lambda tb, calls=calls: calls.append(len(tb))
                or [None] * len(tb))
        for v in range(2):
            for i in range(6):
                t = 1000 + 10 * i
                b.process(f"veh-{v}", P(lat=0.01 * i, lon=0.001 * v,
                                        accuracy=5, time=t),
                          stream_time_ms=t * 1000)
        b.punctuate(stream_time_ms=10 ** 13)
        bodies = []
        for dirpath, _dirs, files in sorted(os.walk(spool_dir)):
            for f in sorted(files):
                with open(os.path.join(dirpath, f)) as fh:
                    bodies.append(json.load(fh))
        counters = reg.default.snapshot()["counters"]
        runs.append((calls, bodies, {k: counters.get(k) for k in (
            "batch.dropped", "batch.requeued", "batch.deadletter")}))
    assert runs[0] == runs[1]
    calls, bodies, counters = runs[1]
    assert calls == [] and len(bodies) == 2
    assert counters == {"batch.dropped": 2, "batch.requeued": None,
                        "batch.deadletter": 2}
    assert faults.fired_counts() == jax_faults.fired_counts() \
        == {"matcher.submit": 1}


def _observations(mod):
    return mod.ObservationBatch(
        segment_id=np.array([1 << 25], dtype=np.int64),
        next_id=np.array([2 << 25], dtype=np.int64),
        duration_s=np.array([30.0]), count=np.array([1], dtype=np.int64),
        length_m=np.array([500], dtype=np.int64),
        queue_m=np.array([0], dtype=np.int64),
        min_ts=np.array([1500000000], dtype=np.int64),
        max_ts=np.array([1500000030], dtype=np.int64))


@pytest.mark.parametrize("site", ["datastore.commit", "datastore.lease"])
def test_store_failpoints_refuse_then_commit_as_the_jax_package(tmp_path,
                                                                site):
    """``datastore.commit`` and ``datastore.lease``: the armed mutation
    raises in both packages and the next one commits."""
    import reporter_tpu.datastore as jax_ds
    import reporter_tpu_torch.datastore as port_ds
    arm(f"{site}=error#1")
    got = []
    for name, ds_mod, f_mod in (("jax", jax_ds, jax_faults),
                                ("port", port_ds, faults)):
        ds = ds_mod.LocalDatastore(str(tmp_path / name))
        ds.lease._deadline = 0.0  # the lease's slow path: its I/O runs
        with pytest.raises(f_mod.FaultError):
            ds.ingest(_observations(ds_mod), ingest_key="k")
        got.append(ds.ingest(_observations(ds_mod), ingest_key="k"))
    assert got[0] == got[1] == 1
    assert faults.fired_counts() == jax_faults.fired_counts() == {site: 1}


def test_gate_failpoint_fails_open_as_the_jax_package():
    """``admission.gate``: a gate failure admits and counts the error in
    both packages."""
    from reporter_tpu.service import admission as jax_admission
    from reporter_tpu_torch.service import admission

    class Sensors:
        def queue_depth(self):
            return 4

        def queued_depth(self):
            return 4

        def service_ewma_s(self):
            return None

        queue_max, max_batch = 1, 32

    arm("admission.gate=error#1")
    reset_counters()
    regs = (metrics.Registry(), jax_metrics.Registry())
    # each gate makes its package's process-wide pressure ladder; both go
    # when the test ends, or a later test in this process reads them
    try:
        gates = (admission.AdmissionGate(Sensors(), hold_s=1.0,
                                         clock=lambda: 0.0,
                                         registry=regs[0]),
                 jax_admission.AdmissionGate(Sensors(), hold_s=1.0,
                                             clock=lambda: 0.0,
                                             registry=regs[1]))
        verdicts = [[None if v is None else v.reason
                     for v in (g.admit(), g.admit())] for g in gates]
        assert verdicts[0] == verdicts[1] and verdicts[0][0] is None
        assert regs[0].snapshot()["counters"] \
            == regs[1].snapshot()["counters"]
        assert metrics.default.counter("admission.errors") \
            == jax_metrics.default.counter("admission.errors") == 1
        assert gates[0].snapshot() == gates[1].snapshot()
    finally:
        admission._reset_module()
        jax_admission._reset_module()


def test_gate_failpoint_leaves_no_pressure_ladder_behind():
    """The gate test above leaves neither package's pressure ladder: a
    port ladder left while a JAX test file reset only the JAX package's
    made ``/health``'s ``pressure`` blocks differ in a later test of the
    same process (``test_torch_service.py::test_health``)."""
    from reporter_tpu.service import admission as jax_admission
    from reporter_tpu_torch.service import admission
    test_gate_failpoint_fails_open_as_the_jax_package()
    assert admission._ladder is None and jax_admission._ladder is None
    quiet = {"level": 0, "state": "normal", "transitions": 0}
    assert admission.pressure_snapshot() == quiet \
        == jax_admission.pressure_snapshot()


def test_swap_failpoint_keeps_the_old_map_as_the_jax_package(cities):
    """``city.swap``: the armed swap raises after its gate in both
    packages, the old map keeps serving, and the next swap flips."""
    from reporter_tpu.service.cities import CityRegistry as JaxRegistry
    from reporter_tpu_torch.service.cities import CityRegistry
    ref_city, city = cities
    arm("city.swap=error#1")
    results = []
    for cls, f_mod, make in (
            (JaxRegistry, jax_faults,
             lambda: JaxService(JaxMatcher(net=ref_city, use_native=False))),
            (CityRegistry, faults,
             lambda: ReporterService(SegmentMatcher(city, device="cpu",
                                                    native=False)))):
        reg = cls(loader=lambda n, s=make(): (s, 100), budget_bytes=1 << 30)
        old = reg.get("metro")
        with pytest.raises(f_mod.FaultError):
            reg.swap("metro", lambda: (make(), 100))
        assert reg.get("metro") is old
        results.append(reg.swap("metro", lambda: (make(), 100))["result"])
        assert reg.get("metro") is not old
        reg.evict("metro")
    assert results == ["flipped", "flipped"]
    assert faults.fired_counts() == jax_faults.fired_counts() \
        == {"city.swap": 1}


# -- the dead-letter spool ------------------------------------------------------
def spool_case(mod, root, case, cap_mb, set_cap):
    """Run one spool scenario through ``mod``; returns (files left with
    their sizes, backlog)."""
    set_cap(cap_mb)
    if case == "nested":
        os.makedirs(os.path.join(root, ".traces"))
        with open(os.path.join(root, ".traces", "t.json"), "w") as f:
            f.write("y" * 4000)
        mod.write(root, "a/tile", "x" * 100)
    elif case == "restart":
        os.makedirs(os.path.join(root, "old"))
        with open(os.path.join(root, "old", "stale"), "w") as f:
            f.write("x" * 1400)
        os.utime(os.path.join(root, "old", "stale"), (1, 1))
        mod.write(root, "a/fresh", "y" * 600)
    else:
        for i, name in enumerate(("a/oldest", "b/mid", "c/newest", "d/last")):
            mod.write(root, name, "x" * 600)
            os.utime(os.path.join(root, name), (i + 1, i + 1))
    left = sorted((os.path.relpath(p, root), size)
                  for p, size, _m in mod.walk_files(root, False))
    return left, mod.backlog(root)


@pytest.mark.parametrize("case,cap_bytes", [
    ("oldest", 1500), ("oldest", 0), ("nested", 1000), ("restart", 1500)])
def test_spool_cap_as_the_jax_package(tmp_path, monkeypatch, case,
                                      cap_bytes):
    cap_mb = cap_bytes / (1024 * 1024)
    reset_counters()
    got = spool_case(spool, str(tmp_path / "port"), case, cap_mb,
                     spool.set_cap_mb)
    want = spool_case(
        jax_spool, str(tmp_path / "jax"), case, cap_mb,
        lambda mb: monkeypatch.setenv("REPORTER_TPU_DEADLETTER_MAX_MB",
                                      str(mb)))
    spool.set_cap_mb(0)
    assert got == want
    assert metrics.counter("deadletter.shed") \
        == jax_metrics.default.counter("deadletter.shed")
    if case == "oldest" and cap_bytes:
        assert [name for name, _ in got[0]] == ["c/newest", "d/last"]
    if case == "nested":
        assert got[1] == {"files": 1, "bytes": 100}


def test_backlog_snapshot_reads_the_registered_roots(tmp_path):
    spool.write(str(tmp_path / "tr"), "poison.a.json", "{}")
    spool.set_trace_dir(str(tmp_path / "tr"))
    try:
        assert spool.backlog_snapshot() == {
            "tiles": {"files": 0, "bytes": 0},
            "traces": {"files": 1, "bytes": 2}}
        # the streaming worker's tile spool (its nested trace spool and
        # flight-recorder dumps are not tiles)
        root = str(tmp_path / "tiles")
        spool.write(root, "1_2/0/3/t.e00000000", "x" * 5)
        spool.write(root, ".traces/trace-1.u.json", "{}")
        spool.set_tile_dir(root)
        assert spool.tile_dir() == root
        assert spool.backlog_snapshot()["tiles"] == {"files": 1,
                                                     "bytes": 5}
    finally:
        spool.set_trace_dir(None)
        spool.set_tile_dir(None)


# -- fsio ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["text", "bytes"])
def test_atomic_writes_as_the_jax_package(tmp_path, monkeypatch, kind):
    def run(mod, root):
        os.makedirs(root)
        path = os.path.join(root, "f")
        write = (mod.atomic_write_text if kind == "text"
                 else lambda p, d: mod.atomic_write_bytes(p, d.encode()))
        write(path, "first")
        write(path, "second")
        with monkeypatch.context() as mp:
            def broken(src, dst):
                raise OSError("replace failed")
            mp.setattr(os, "replace", broken)
            with pytest.raises(OSError):
                write(path, "third")
        mod.fsync_path(path)
        mod.fsync_dir(root)
        mod.fsync_dir(os.path.join(root, "missing"))
        return sorted(os.listdir(root)), open(path).read()
    assert run(fsio, str(tmp_path / "port")) \
        == run(jax_fsio, str(tmp_path / "jax")) == (["f"], "second")


# -- /health -------------------------------------------------------------------
@pytest.mark.parametrize("attr", [None, "circuit", "circuit_decode",
                                  "circuit_assemble", "circuit_route",
                                  "circuit_incremental"])
def test_health_blocks_and_codes_as_the_jax_package(cities, monkeypatch,
                                                    attr):
    jm, m, _now = matcher_pair(cities, monkeypatch)
    ref, port = (JaxService(jm, threshold_sec=15, max_batch=8),
                 ReporterService(m, max_batch=8))
    try:
        if attr is not None:
            for matcher in (jm, m):
                for _ in range(2):
                    getattr(matcher, attr).record_failure()
        (st_ref, b_ref), (st, body) = ref.health(), port.health()
        got, want = json.loads(body), json.loads(b_ref)
        assert st == st_ref == (200 if attr is None else 503)
        assert list(got) == list(want)
        for key in ("circuit", "degraded", "deadletter", "faults",
                    "pressure", "admission", "slo", "datastore", "status"):
            assert got[key] == want[key], key
        assert len(got["degraded"]["open"]) == (attr is not None)
    finally:
        ref.dispatcher.close()
        port.dispatcher.close()


def test_health_shows_the_armed_spec(cities):
    port = ReporterService(SegmentMatcher(cities[1], device="cpu",
                                          native=False))
    try:
        faults.configure("native.prep=error#1")
        body = json.loads(port.health()[1])
        assert body["faults"] == "native.prep=error#1"
        assert body["status"] == "ok"
    finally:
        port.dispatcher.close()


# -- the streaming worker's failure domains --------------------------------------
@pytest.fixture
def worker_globals():
    """The worker registers process-wide spool roots and a flight-recorder
    directory; each test leaves them as it found them."""
    from reporter_tpu_torch.obs import flightrec
    yield
    spool.set_tile_dir(None)
    spool.set_trace_dir(None)
    flightrec.set_dump_dir(None)


def stream_parts(root, both=False):
    """A batcher and an anonymiser over a file sink under ``root`` (the
    JAX package's too with ``both``)."""
    from reporter_tpu_torch.streaming.anonymiser import Anonymiser, TileSink
    from reporter_tpu_torch.streaming.batcher import PointBatcher
    out = [(PointBatcher(lambda t: None, lambda k, s: None),
            Anonymiser(TileSink(str(root / "t")), privacy=1,
                       quantisation=3600))]
    if both:
        from reporter_tpu.streaming.anonymiser import Anonymiser as JA
        from reporter_tpu.streaming.anonymiser import TileSink as JS
        from reporter_tpu.streaming.batcher import PointBatcher as JB
        out.append((JB(lambda t: None, lambda k, s: None),
                    JA(JS(str(root / "jt")), privacy=1, quantisation=3600)))
    return out


@pytest.mark.parametrize("kind", ["error", "partial"])
def test_state_save_failpoint_as_the_jax_package(tmp_path, kind):
    """``state.save``: an error before the write leaves no snapshot; a
    partial after it leaves the snapshot written and the caller told it
    failed. Both packages alike."""
    from reporter_tpu.streaming.state import StateStore as JaxStore
    from reporter_tpu_torch.streaming.state import StateStore
    (b, a), (jb, ja) = stream_parts(tmp_path, both=True)
    got = []
    for store, args, err in (
            (StateStore(str(tmp_path / "s.bin")), (b, a), faults.FaultError),
            (JaxStore(str(tmp_path / "j.bin")), (jb, ja),
             jax_faults.FaultError)):
        arm(f"state.save={kind}")
        with pytest.raises(err):
            store.save(*args)
        got.append(os.path.exists(store.path))
        faults.clear()
        jax_faults.clear()
        store.save(*args)
        assert os.path.exists(store.path)
    assert got == [kind == "partial"] * 2


def test_worker_post_egress_failpoint(tmp_path, worker_globals):
    """``worker.post_egress`` sits after the sink ack and before the
    epoch marker: a fault there leaves the epoch uncommitted, so a
    restore re-emits it under the same deterministic names."""
    from reporter_tpu_torch.streaming.anonymiser import Anonymiser, TileSink
    from reporter_tpu_torch.streaming.formatter import Formatter
    from reporter_tpu_torch.streaming.state import StateStore
    from reporter_tpu_torch.streaming.worker import StreamWorker
    from reporter_tpu_torch.core.types import Segment
    state = StateStore(str(tmp_path / "s.bin"), interval_s=0.0)
    w = StreamWorker(
        Formatter.from_config(r",sv,\|,0,1,2,3,4"), lambda t: None,
        Anonymiser(TileSink(str(tmp_path / "t")), privacy=1,
                   quantisation=3600),
        flush_interval_s=1e9, state=state)
    w.anonymiser.process("k", Segment(1 << 25, 2 << 25, 1500000000,
                                      1500000030, 500, 0))
    faults.configure("worker.post_egress=error")
    with pytest.raises(faults.FaultError):
        w._flush_tiles()
    faults.clear()
    assert state.committed_epoch() == -1
    assert w.anonymiser.tiles_written == 1


def test_egress_partial_spools_despite_committed_write(tmp_path):
    """``egress.http=partial``: the tile reaches the file sink, yet the
    caller sees failure and spools it, in both packages."""
    from reporter_tpu.streaming.anonymiser import TileSink as JaxSink
    from reporter_tpu_torch.streaming.anonymiser import TileSink
    reset_counters()
    for name, cls in (("port", TileSink), ("jax", JaxSink)):
        arm("egress.http=partial")
        sink = cls(str(tmp_path / name))
        assert sink.store("1_2/0/1", "f", "payload") is False
        assert (tmp_path / name / "1_2" / "0" / "1" / "f").exists()
        assert (tmp_path / name / ".deadletter" / "1_2" / "0" / "1"
                / "f").read_text() == "payload"
    for registry in (metrics, jax_metrics.default):
        assert (registry.counter("egress.fail"),
                registry.counter("egress.deadletter")) == (1, 1)


def kill_lines(n=4):
    """``n`` vehicles' probe lines on an 8x8 city, and the city."""
    city = build_grid_city(rows=8, cols=8, spacing_m=200.0, seed=3)
    rng = np.random.default_rng(13)
    rows = []
    for i in range(n):
        tr = None
        while tr is None:
            tr = generate_trace(city, f"veh-{i}", rng, noise_m=3.0,
                                sample_period_s=5.0, min_route_edges=8,
                                start_time=1_500_000_000 + 11 * i)
        rows += [(p["time"], tr.uuid, p) for p in tr.points]
    rows.sort(key=lambda r: (r[0], r[1]))
    return city, [f"{u}|{p['lat']}|{p['lon']}|{p['time']}|{p['accuracy']}"
                  for _t, u, p in rows]


@pytest.mark.parametrize("snapshots", [("--state-interval", "0"),
                                       ("--state-every", "64")])
def test_worker_offer_crash_restores_to_the_same_tiles(tmp_path,
                                                       worker_globals,
                                                       snapshots):
    """``worker.offer=crash+k#1`` kills a worker process at its (k+1)th
    message (exit 137) with a postmortem naming the in-flight
    ``worker.offer`` span; a new worker restores the snapshot (taken
    after every message, or after every 64th with k a multiple of 64;
    the carried decode frames in it) and reads the rest: the tiles of an
    unbroken run, byte for byte."""
    import subprocess
    import sys
    from reporter_tpu_torch.streaming import worker
    city, lines = kill_lines()
    graph = str(tmp_path / "city.npz")
    city.save(graph)
    k = len(lines) * 2 // 3
    if snapshots[0] == "--state-every":
        k -= k % int(snapshots[1])
    for name, part in (("full", lines), ("tail", lines[k:])):
        (tmp_path / f"{name}.txt").write_text("\n".join(part) + "\n")

    def args(inp, out, *extra):
        return ["-f", r",sv,\|,0,1,2,3,4", "--graph", graph, "-p", "1",
                "-q", "3600", "-i", "1000000000", "-s", "c", "-o", out,
                "--input", str(tmp_path / inp), "-r", "0,1,2",
                "-x", "0,1,2", "--report-flush-interval", "0",
                "--device", "cpu", *extra]

    ref = str(tmp_path / "ref")
    assert worker.main(args("full.txt", ref)) == 0
    conf = tmp_path / "crash.json"
    conf.write_text(json.dumps({"graph": graph, "service": {
        "trace": True, "faults": f"worker.offer=crash+{k}#1"}}))
    out, state = str(tmp_path / "chaos"), str(tmp_path / "state.bin")
    p = subprocess.run(
        [sys.executable, "-m", "reporter_tpu_torch.streaming.worker",
         *args("full.txt", out, "--config", str(conf), "--state-file",
               state, *snapshots)],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert p.returncode == faults.CRASH_EXIT_CODE, p.stderr[-2000:]
    rec = os.path.join(out, ".deadletter", ".flightrec")
    (dump,) = os.listdir(rec)
    post = json.load(open(os.path.join(rec, dump)))
    assert post["reason"] == "crash.worker.offer"
    assert "worker.offer" in [s["name"] for s in post["in_flight"]]
    from reporter_tpu_torch.streaming.anonymiser import Anonymiser, TileSink
    from reporter_tpu_torch.streaming.batcher import PointBatcher
    from reporter_tpu_torch.streaming.state import restore_bytes
    frames = restore_bytes(open(state, "rb").read(),
                           PointBatcher(lambda t: None, lambda k, s: None),
                           Anonymiser(TileSink(str(tmp_path / "x")), 1,
                                      3600))
    assert frames, "the snapshot carries no decode frames"
    assert worker.main(args("tail.txt", out, "--state-file", state)) == 0

    def tiles(root):
        return {os.path.relpath(os.path.join(r, f), root):
                open(os.path.join(r, f), "rb").read()
                for r, dirs, fs in os.walk(root) for f in fs
                if ".deadletter" not in r}
    assert tiles(out) == tiles(ref) and tiles(ref)


class TestDrainer:
    """The dead-letter replayer (``streaming/drainer.py``) against the
    JAX package's: the same entries replayed, backed off, quarantined,
    the same counters."""

    def _response(self):
        return {"datastore": {"reports": [
            {"id": 1 << 25, "next_id": 2 << 25, "t0": 1500000000,
             "t1": 1500000030, "length": 500, "queue_length": 0}]},
            "segment_matcher": {"segments": []}}

    def _seed_trace(self, root):
        os.makedirs(os.path.join(root, ".traces"), exist_ok=True)
        with open(os.path.join(root, ".traces", "trace-1.u.json"),
                  "w", encoding="utf-8") as f:
            json.dump({"uuid": "u", "trace": [
                {"lat": 14.6, "lon": 120.98, "time": 1500000000},
                {"lat": 14.601, "lon": 120.981, "time": 1500000030}],
                "match_options": {"mode": "auto", "report_levels": [0],
                                  "transition_levels": [0]}}, f)

    def _both(self, tmp_path, run):
        """``run(DeadLetterDrainer, root, registry)`` in each package;
        returns the port's outcome, equal to the JAX package's."""
        from reporter_tpu.streaming.drainer import \
            DeadLetterDrainer as JaxDrainer
        from reporter_tpu_torch.streaming.drainer import DeadLetterDrainer
        reset_counters()
        got = run(DeadLetterDrainer, str(tmp_path / "port"), metrics)
        want = run(JaxDrainer, str(tmp_path / "jax"), jax_metrics.default)
        assert got == want
        return got

    def test_trace_replay_forwards_and_deletes(self, tmp_path):
        def run(cls, root, reg):
            self._seed_trace(root)
            fwd = []
            d = cls(root, submit=lambda body: self._response(),
                    forward=lambda key, seg: fwd.append((key,
                                                         seg.to_bytes())))
            return (d.drain_now(), d.backlog(), fwd,
                    reg.counter("replay.traces.ok"))
        n, backlog, fwd, ok = self._both(tmp_path, run)
        assert (n, backlog, len(fwd), ok) == (1, {"tiles": 0, "traces": 0},
                                              1, 1)

    def test_backoff_then_quarantine(self, tmp_path):
        def run(cls, root, reg):
            self._seed_trace(root)
            now = [0.0]
            d = cls(root, submit=lambda body: None, interval_s=10.0,
                    max_attempts=3, base_backoff_s=5.0, backoff_jitter=0.0,
                    clock=lambda: now[0])
            seen = []
            for t in (0.0, 2.0, 10.0, 20.0):
                now[0] = t
                d.maybe_drain()
                seen.append((reg.counter("replay.traces.fail"),
                             reg.counter("replay.quarantined")))
            return seen, d.backlog(), os.listdir(
                os.path.join(root, ".traces", ".quarantine"))
        seen, backlog, quarantined = self._both(tmp_path, run)
        assert seen == [(1, 0), (1, 0), (2, 0), (3, 1)]
        assert backlog["traces"] == 0 and quarantined == ["trace-1.u.json"]

    def test_poison_replay_loop_terminates_and_quarantines(self, tmp_path):
        def run(cls, root, reg):
            self._seed_trace(root)
            tdir = os.path.join(root, ".traces")

            def poisoned_submit(body):
                with open(os.path.join(tdir, "poison.u.json"), "w",
                          encoding="utf-8") as f:
                    json.dump(body, f)
                reg.count("matcher.assemble.quarantined")
                return self._response()

            d = cls(root, submit=poisoned_submit, max_attempts=3)
            first = (d.drain_now(), d.backlog()["traces"])
            for _ in range(10):
                d._pass(d.clock(), ignore_backoff=True)
            return first, d.backlog()["traces"], sorted(
                os.listdir(os.path.join(tdir, ".quarantine")))
        assert self._both(tmp_path, run) == (
            (0, 2), 0, ["poison.u.json", "trace-1.u.json"])

    def test_budget_key_survives_dotted_uuids(self, tmp_path):
        def run(cls, root, reg):
            d = cls(root)
            troot = d.trace_root
            return [os.path.relpath(d._budget_key(
                troot, os.path.join(troot, name)), root)
                    if not d._budget_key(troot, os.path.join(
                        troot, name)).startswith("uuid:")
                    else d._budget_key(troot, os.path.join(troot, name))
                    for name in ("trace-1-000001.fleet7.bus12.json",
                                 "trace-1-000002.fleet9.bus12.json",
                                 "poison.fleet7.bus12.json", "weird")]
        a, b, c, weird = self._both(tmp_path, run)
        assert a != b and a == c and weird == os.path.join(".traces",
                                                           "weird")

    def test_paced_pass_bounded_by_max_per_pass(self, tmp_path,
                                                monkeypatch):
        def run(cls, root, reg):
            os.makedirs(os.path.join(root, ".traces"))
            for i in range(5):
                with open(os.path.join(root, ".traces", f"t{i}.u{i}.json"),
                          "w", encoding="utf-8") as f:
                    json.dump({"uuid": f"u{i}"}, f)
            monkeypatch.setattr(cls, "MAX_PER_PASS", 2)
            cls(root, submit=lambda body: None, interval_s=0.0
                ).maybe_drain()
            return reg.counter("replay.traces.fail")
        assert self._both(tmp_path, run) == 2

    def test_externally_removed_entry_drops_attempt_state(self, tmp_path):
        def run(cls, root, reg):
            self._seed_trace(root)
            d = cls(root, submit=lambda body: None, max_attempts=10)
            d._pass(0.0, ignore_backoff=True)
            before = (len(d._attempts), len(d._due))
            os.unlink(os.path.join(root, ".traces", "trace-1.u.json"))
            d._pass(100.0, ignore_backoff=True)
            return before, d._attempts, d._due
        assert self._both(tmp_path, run) == ((1, 1), {}, {})

    def test_tile_replay_reaches_the_sink(self, tmp_path):
        from reporter_tpu_torch.core.types import Segment
        from reporter_tpu_torch.streaming.anonymiser import TileSink
        from reporter_tpu_torch.streaming.drainer import DeadLetterDrainer
        reset_counters()
        root = str(tmp_path / "dl")
        seg = Segment(1 << 25, 2 << 25, 1500000000, 1500000030, 500, 0)
        payload = "\n".join([Segment.column_layout(),
                             seg.csv_row("AUTO", "t")])
        tile_rel = "1500000000_1500003599/0/100"
        os.makedirs(os.path.join(root, tile_rel))
        with open(os.path.join(root, tile_rel, "t.e00000003"), "w") as f:
            f.write(payload)
        out = str(tmp_path / "out")
        d = DeadLetterDrainer(root, sink=TileSink(out))
        assert d.drain_now() == 1
        assert open(os.path.join(out, tile_rel, "t.e00000003")).read() \
            == payload
        assert d.backlog()["tiles"] == 0
        assert metrics.counter("replay.tiles.ok") == 1

    def test_worker_drains_its_spools_at_the_replay_interval(
            self, tmp_path, worker_globals):
        """``replay_interval_s`` arms the worker's drainer: a spooled
        trace replays through the live submit path into the tiles."""
        from reporter_tpu_torch.streaming.anonymiser import (Anonymiser,
                                                             TileSink)
        from reporter_tpu_torch.streaming.formatter import Formatter
        from reporter_tpu_torch.streaming.worker import StreamWorker
        out = str(tmp_path / "out")
        sink = TileSink(out)
        self._seed_trace(sink.deadletter)
        w = StreamWorker(Formatter.from_config(r",sv,\|,0,1,2,3,4"),
                         lambda body: self._response(),
                         Anonymiser(sink, privacy=1, quantisation=3600),
                         flush_interval_s=1e9, replay_interval_s=0.001,
                         replay_attempts=2)
        assert w.drainer.max_attempts == 2
        assert StreamWorker(Formatter.from_config(r",sv,\|,0,1,2,3,4"),
                            lambda body: None,
                            Anonymiser(TileSink(str(tmp_path / "o2")), 1,
                                       3600)).drainer is None
        w.run([])
        assert w.drainer.backlog() == {"tiles": 0, "traces": 0}
        assert w.anonymiser.tiles_written == 1


def test_health_reads_the_worker_spools_as_the_jax_package(
        cities, tmp_path, worker_globals):
    """A tile and a trace in each package's registered worker spools:
    ``/health``'s ``deadletter`` block counts them alike (the nested
    trace spool is not a tile)."""
    from reporter_tpu.utils import spool as jax_spool_mod
    ref_city, city = cities
    ref = JaxService(JaxMatcher(net=ref_city), threshold_sec=15, max_batch=8)
    port = ReporterService(SegmentMatcher(city, device="cpu"), max_batch=8)
    try:
        got = []
        for mod, svc, name in ((spool, port, "port"),
                               (jax_spool_mod, ref, "jax")):
            root = str(tmp_path / name)
            mod.write(root, "1_2/0/3/t.e00000000", "x" * 7)
            mod.write(root, ".traces/trace-1-000001.u.json", "{}")
            mod.set_tile_dir(root)
            mod.set_trace_dir(os.path.join(root, ".traces"))
            got.append(json.loads(svc.health()[1])["deadletter"])
        assert got[0] == got[1] == {"tiles": {"files": 1, "bytes": 7},
                                    "traces": {"files": 1, "bytes": 2}}
    finally:
        jax_spool_mod.set_tile_dir(None)
        jax_spool_mod.set_trace_dir(None)
        ref.dispatcher.close()
        port.dispatcher.close()
