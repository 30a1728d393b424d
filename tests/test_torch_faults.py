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
    finally:
        spool.set_trace_dir(None)


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
