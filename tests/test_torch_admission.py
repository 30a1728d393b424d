"""The port's overload control against the JAX package's.

The same observation sequences go to both packages' ``WindowedQuantile``,
``PressureLadder`` and ``AdmissionGate`` (one injected clock; the JAX
side's SLO targets and knobs through ``monkeypatch.setenv``, the port's
through ``obs.slo.configure`` and arguments), and their decisions,
snapshots and counters are held equal. Then the rung effects on the
port's matcher and service (rung 4 reached and reported, the decode left
on its device: as many decode calls as a healthy call makes), a 429 with
``Retry-After`` over HTTP from both front doors, the config keys, and
the fork reset in a pre-fork worker. Tolerance: exact.
"""
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from reporter_tpu.matcher import MatchParams as JaxParams
from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.matcher import batchpad as jax_batchpad
from reporter_tpu.matcher import incremental as jax_inc
from reporter_tpu.matcher import matcher as jax_matcher_mod
from reporter_tpu.obs import profiler as jax_profiler
from reporter_tpu.service import admission as jax_admission
from reporter_tpu.service.server import ReporterService as JaxService
from reporter_tpu.service.server import serve as jax_serve
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu.synth import generate_trace as jax_trace
from reporter_tpu.utils import faults as jax_faults
from reporter_tpu.utils import metrics as jax_metrics
from reporter_tpu_torch import ops
from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
from reporter_tpu_torch.matcher import batchpad
from reporter_tpu_torch.matcher import incremental as inc
from reporter_tpu_torch.obs import profiler, slo
from reporter_tpu_torch.service import admission, wire
from reporter_tpu_torch.service.report import report_json
from reporter_tpu_torch.service.server import (ReporterService,
                                               configure_faults, read_config,
                                               serve)
from reporter_tpu_torch.synth import build_grid_city, generate_trace
from reporter_tpu_torch.utils import faults, metrics, spool

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "report_parity.json")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Every test starts at pressure zero in both packages, with no SLO
    target, no fault spec and fresh counters, and leaves it so."""
    def reset():
        admission._reset_module()
        jax_admission._reset_module()
        slo.configure(None)
        faults.clear()
        jax_faults.clear()
        metrics.default.reset()
        jax_metrics.default.reset()
    monkeypatch.delenv("REPORTER_TPU_SLO_MS", raising=False)
    reset()
    yield
    reset()


def set_slo(monkeypatch, spec):
    slo.configure(spec)
    monkeypatch.setenv("REPORTER_TPU_SLO_MS", spec)


# -- the windowed p99 ----------------------------------------------------------
@pytest.mark.parametrize("windows", [
    [[0.9] * 50, [], [0.001] * 50],
    [[0.002, 0.004, 0.5] * 20, [0.03] * 7, [1e-7, 300.0], [0.0625] * 3],
    [[0.01 * i for i in range(1, 200)], [0.2] * 99 + [5.0], []]])
def test_windowed_p99_as_the_jax_package(windows):
    regs = (metrics.Registry(), jax_metrics.Registry())
    wqs = (admission.WindowedQuantile(regs[0]),
           jax_admission.WindowedQuantile(regs[1]))
    for window in windows:
        for reg in regs:
            for x in window:
                reg.observe("stage", x)
        got, want = (w.update(["stage", "never"]) for w in wqs)
        assert got == want
        assert got["never"] is None
        assert (got["stage"] is None) == (not window)


# -- the pressure ladder -----------------------------------------------------------
def rung_effects_port():
    """The port's rung flags; rung 4 has none (it is inert), so the
    tuple stops at ``coarse_buckets``."""
    return (profiler.shadow_stats()["suspended"],
            not admission.allow_request_trace(), inc.pressure_shed(),
            batchpad.split_threshold() == 1.0)


def rung_effects_jax():
    return (jax_profiler.shadow_stats()["suspended"],
            not jax_admission.allow_request_trace(),
            jax_inc.pressure_shed(),
            jax_batchpad.bucket_ladder()[1] == 1.0,
            jax_matcher_mod._pressure_oracle)


#: (clock, pressured) samples: a climb to the top rung and back, and a
#: stretch of samples that flip faster than the hold
LADDER_WALKS = {
    "climb": [(0.0, True), (1.0, True), (1.5, True), (2.0, True),
              (3.0, True), (4.0, True), (5.0, True), (5.0, False),
              (6.5, False), (7.0, False), (9.0, False), (11.0, False),
              (13.0, False), (14.0, False)],
    "flap": [(0.3 * i, i % 2 == 0) for i in range(1, 41)],
    "partial": [(0.0, True), (1.0, True), (2.0, True), (2.5, False),
                (4.5, False), (5.0, True), (6.0, True), (8.0, False)]}


@pytest.mark.parametrize("walk", sorted(LADDER_WALKS))
def test_ladder_takes_the_jax_packages_steps(walk):
    clk = [0.0]
    port = admission.PressureLadder(hold_s=1.0, clock=lambda: clk[0])
    ref = jax_admission.PressureLadder(hold_s=1.0, clock=lambda: clk[0])
    levels = []
    for t, pressured in LADDER_WALKS[walk]:
        clk[0] = t
        level = port.observe(pressured)
        assert level == ref.observe(pressured), (t, pressured)
        assert rung_effects_jax() == (level >= 1, level >= 2, level >= 2,
                                      level >= 3, level >= 4), (t, level)
        assert rung_effects_port() == rung_effects_jax()[:4], (t, level)
        levels.append(level)
    assert port.snapshot() == ref.snapshot()
    assert metrics.default.snapshot()["counters"] \
        == jax_metrics.default.snapshot()["counters"]
    if walk == "climb":
        assert max(levels) == 4 and levels[-1] == 0
        assert port.transitions == 8
    if walk == "flap":
        assert set(levels) == {0}


# -- the admission gate ----------------------------------------------------------
class StubDispatcher:
    """The dispatcher's sensors, set by hand."""

    def __init__(self, depth=0, ewma=None, queue_max=0, max_batch=32,
                 queued=None):
        self.depth, self.ewma = depth, ewma
        self.queue_max, self.max_batch = queue_max, max_batch
        self.queued = depth if queued is None else queued

    def queue_depth(self):
        return self.depth

    def queued_depth(self):
        return self.queued

    def service_ewma_s(self):
        return self.ewma


def verdict(v):
    return None if v is None else (v.reason, v.retry_after_s)


#: (name, SLO spec, stub settings, inflight_max, steps); a step is
#: ("admit", clock), ("release", clock), ("observe", seconds, n) into the
#: gates' registries, ("stub", attr, value) or ("arm", spec)
GATE_CASES = [
    ("queue_bound", "", dict(depth=5, ewma=0.01, queue_max=5), 0,
     [("admit", 0.0), ("admit", 0.1), ("stub", "queued", 2),
      ("admit", 0.2)]),
    ("in_service_not_queued", "", dict(depth=300, queued=3, ewma=0.01,
                                       queue_max=64), 0,
     [("admit", 0.0), ("release", 0.0), ("admit", 0.3)]),
    ("deadline", "service.handle=100", dict(depth=10, ewma=0.02), 0,
     [("admit", 0.0), ("stub", "ewma", 0.001), ("admit", 0.5),
      ("release", 0.5)]),
    ("windowed_slo", "service.handle=50", {}, 0,
     [("observe", 0.5, 30), ("admit", 1.0), ("observe", 0.001, 30),
      ("admit", 2.0), ("release", 2.0), ("admit", 2.1)]),
    ("inflight", "", {}, 2,
     [("admit", 0.0), ("admit", 0.0), ("admit", 0.0), ("release", 0.0),
      ("admit", 0.0), ("release", 0.0), ("release", 0.0),
      ("release", 0.0), ("admit", 0.0)]),
    ("fails_open", "", dict(queue_max=1, depth=4), 0,
     [("arm", "admission.gate=error#1"), ("admit", 0.0), ("admit", 0.1),
      ("release", 0.1)]),
    ("sheds_climb_the_ladder", "", dict(depth=9, queue_max=1, ewma=0.5),
     0, [("admit", 0.3 * i) for i in range(40)]),
]


@pytest.mark.parametrize("case", GATE_CASES, ids=[c[0] for c in GATE_CASES])
def test_gate_takes_the_jax_packages_decisions(monkeypatch, case):
    _name, spec, stub, inflight_max, steps = case
    if spec:
        set_slo(monkeypatch, spec)
    clk = [0.0]
    regs = (metrics.Registry(), jax_metrics.Registry())
    stubs = (StubDispatcher(**stub), StubDispatcher(**stub))
    gates = (admission.AdmissionGate(stubs[0], inflight_max=inflight_max,
                                     hold_s=1.0, clock=lambda: clk[0],
                                     registry=regs[0]),
             jax_admission.AdmissionGate(
                 stubs[1], inflight_max=inflight_max or None, hold_s=1.0,
                 clock=lambda: clk[0], registry=regs[1]))
    for step in steps:
        if step[0] == "observe":
            for reg in regs:
                for _ in range(step[2]):
                    reg.observe("service.handle", step[1])
        elif step[0] == "stub":
            for s in stubs:
                setattr(s, step[1], step[2])
        elif step[0] == "arm":
            faults.configure(step[1])
            jax_faults.configure(step[1])
        else:
            clk[0] = step[1]
            if step[0] == "admit":
                got, want = (verdict(g.admit()) for g in gates)
                assert got == want, step
            else:
                for g in gates:
                    g.release()
        assert gates[0].snapshot() == gates[1].snapshot(), step
        assert admission.pressure_snapshot() \
            == jax_admission.pressure_snapshot(), step
    assert metrics.default.snapshot()["counters"] \
        == jax_metrics.default.snapshot()["counters"]


# -- rung effects on the port's matcher and front door --------------------------
@pytest.fixture(scope="module")
def cities():
    with open(FIXTURE) as f:
        city = json.load(f)["city"]
    return jax_city(**city), build_grid_city(**city)


@pytest.fixture(scope="module")
def requests(cities):
    """Twelve requests of 12 and 40 points from one seeded numpy stream
    through each package's synth."""
    ref_city, city = cities
    rng_ref, rng = np.random.default_rng(31), np.random.default_rng(31)
    reqs = []
    while len(reqs) < 12:
        n = (12, 40)[len(reqs) % 2]
        tr_ref = jax_trace(ref_city, f"ad-{len(reqs)}", rng_ref,
                           min_route_edges=6)
        tr = generate_trace(city, f"ad-{len(reqs)}", rng, min_route_edges=6)
        assert (tr_ref is None) == (tr is None)
        if tr is None or len(tr.points) < n:
            continue
        req = tr.request_json(report_levels=(0, 1, 2),
                              transition_levels=(0, 1, 2))
        req["trace"] = tr.points[:n]
        reqs.append(req)
    return reqs


def bodies(matcher, reqs, writer=report_json):
    return [writer(m, r, 15, {0, 1, 2}, {0, 1, 2})
            for m, r in zip(matcher.match_many(reqs), reqs)]


@pytest.mark.parametrize("native", [True, False])
def test_top_rung_leaves_the_decode_on_its_device(cities, requests,
                                                  monkeypatch, native):
    """At ``oracle_decode`` the JAX package decodes by the numpy oracle;
    the port reaches and reports the rung, but every chunk still goes
    through its decode (``ops.decode_batch``: as many calls as in the
    healthy call), and the bytes equal the JAX package's."""
    from reporter_tpu.service.report import report_json as jax_report_json
    ref_city, city = cities
    jm = JaxMatcher(net=ref_city, params=JaxParams(max_candidates=8),
                    use_native=native)
    m = SegmentMatcher(city, MatchParams(max_candidates=8), device="cpu",
                       native=native)
    launches = []
    decode = ops.decode_batch
    monkeypatch.setattr(ops, "decode_batch", lambda *a: (
        launches.append(1), decode(*a))[1])
    healthy = bodies(m, requests)
    healthy_launches = len(launches)
    launches.clear()
    clk = [0.0]
    port = admission.ladder(hold_s=1.0, clock=lambda: clk[0])
    ref = jax_admission.ladder(hold_s=1.0, clock=lambda: clk[0])
    for t in range(6):
        clk[0] = float(t)
        port.observe(True)
        ref.observe(True)
    assert admission.pressure_snapshot()["state"] == "oracle_decode" \
        == jax_admission.pressure_snapshot()["state"]
    got = bodies(m, requests)
    want = bodies(jm, requests, jax_report_json)
    assert got == want == healthy
    assert len(launches) == healthy_launches > 0
    assert jax_metrics.default.counter("pressure.oracle_chunks") > 0
    assert m.match_incremental(requests) == [None] * len(requests)


def test_coarse_rung_stops_the_splitter(cities):
    m = SegmentMatcher(cities[1], device="cpu")
    group = np.arange(8)
    raw = np.array([17, 17, 17, 17, 200, 200, 17, 17])
    assert len(m._split_bucket(256, group, raw)) == 2
    batchpad.set_pressure_coarse(True)
    try:
        assert m._split_bucket(256, group, raw) == [(256, group)]
    finally:
        batchpad.set_pressure_coarse(False)


def call(url, path, body=None):
    req = urllib.request.Request(url + path, data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


@pytest.fixture
def front_doors(cities, monkeypatch):
    """Both packages' front doors with admission armed (the JAX side by
    its environment), each dispatcher's queued depth read as 10,000."""
    ref_city, city = cities
    monkeypatch.setenv("REPORTER_TPU_ADMISSION", "1")
    ref = JaxService(JaxMatcher(net=ref_city,
                                params=JaxParams(max_candidates=8)),
                     threshold_sec=15, max_batch=8, max_wait_ms=1.0)
    port = ReporterService(SegmentMatcher(city, MatchParams(max_candidates=8),
                                          device="cpu"),
                           max_batch=8, max_wait_ms=1.0, admission=True)
    servers = [(jax_serve(ref, "127.0.0.1", 0), ref),
               (serve(port, "127.0.0.1", 0), port)]
    yield [(f"http://127.0.0.1:{h.server_address[1]}", svc)
           for h, svc in servers]
    for httpd, svc in servers:
        httpd.shutdown()
        httpd.server_close()
        svc.dispatcher.close()


def test_front_door_sheds_429_with_retry_after(front_doors, requests):
    body = json.dumps(requests[0]).encode()
    answers = []
    for url, svc in front_doors:
        assert svc.admission is not None
        st, _h, _b = call(url, "/report", body)
        assert st == 200
        svc.dispatcher.queued_depth = lambda: 10_000
        st, headers, raw = call(url, "/report", body)
        answers.append((st, headers["Retry-After"], json.loads(raw)))
        st, _h, prof = call(url, "/profile")
        prof = json.loads(prof)
        assert prof["admission"]["shed"]["queue"] == 1
        assert prof["pressure"]["state"] == "normal"
        health = json.loads(call(url, "/health")[2])
        assert health["admission"]["armed"] is True
        assert health["admission"]["shed"] == prof["admission"]["shed"]
    assert answers[0] == answers[1]
    st, retry, parsed = answers[1]
    assert st == 429 and 1 <= int(retry) <= 30
    assert parsed["reason"] == "queue" and parsed["error"] == "overloaded"
    assert metrics.counter("service.errors.429") == 1


def test_shed_trace_rung_refuses_trace_and_serves_the_report(front_doors,
                                                             requests):
    body = json.dumps(requests[1]).encode()
    got = []
    for (url, _svc), mod in zip(front_doors, (jax_admission, admission)):
        plain = call(url, "/report", body)[2]
        mod._apply_level(2)
        st, _h, traced = call(url, "/report?trace=1", body)
        assert st == 200 and traced == plain
        got.append(plain)
    assert got[0] == got[1]
    assert metrics.counter("pressure.trace_suppressed") == 1 \
        == jax_metrics.default.counter("pressure.trace_suppressed")


# -- config keys -------------------------------------------------------------------
def test_config_keys_reach_their_layers(cities, tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"graph": "city.npz", "service": {
        "admission": True, "inflight_max": 3, "pressure_hold_s": 0.5,
        "circuit_threshold": 2, "circuit_cooldown_s": 7.0,
        "faults": "native.prep=error#1", "deadletter_dir": str(tmp_path),
        "deadletter_max_mb": 1.5}}))
    conf = read_config(str(cfg))
    assert conf["service"] == {"admission": True, "inflight_max": 3,
                               "pressure_hold_s": 0.5}
    assert conf["matcher"] == {"circuit_threshold": 2,
                               "circuit_cooldown_s": 7.0}
    assert conf["faults"] == {"faults": "native.prep=error#1",
                              "deadletter_dir": str(tmp_path),
                              "deadletter_max_mb": 1.5,
                              "circuit_threshold": 2,
                              "circuit_cooldown_s": 7.0}
    try:
        configure_faults(conf["faults"])
        assert faults.active_spec() == "native.prep=error#1"
        assert spool.trace_dir() == str(tmp_path)
        assert spool.cap_bytes() == int(1.5 * 1024 * 1024)
        assert (wire.circuit.threshold, wire.circuit.cooldown_s) == (2, 7.0)
        m = SegmentMatcher(cities[1], device="cpu", native=False,
                           **conf["matcher"])
        assert m.circuit_decode.snapshot()["threshold"] == 2
        svc = ReporterService(m, **conf["service"])
        try:
            assert svc.admission.inflight_max == 3
            assert svc.admission.ladder.hold_s == 0.5
        finally:
            svc.dispatcher.close()
        with pytest.raises(ValueError):
            configure_faults({"faults": "native.prep=explode"})
    finally:
        configure_faults({"faults": None, "deadletter_dir": None,
                          "deadletter_max_mb": 0, "circuit_threshold": 5,
                          "circuit_cooldown_s": 30.0})
    cfg.write_text(json.dumps({"graph": "g", "service": {"admision": 1}}))
    with pytest.raises(ValueError, match="admision"):
        read_config(str(cfg))


# -- the fork reset ------------------------------------------------------------------
def test_fork_resets_in_a_worker(tmp_path):
    """A worker forked while the parent's ladder sits at ``shed_trace``,
    with a fault spec half spent and spool estimates, starts at
    ``normal`` with every rung effect withdrawn, the same spec from its
    first call and no estimates; the parent keeps its own."""
    clk = [0.0]
    lad = admission.ladder(hold_s=1.0, clock=lambda: clk[0])
    for t in range(3):
        clk[0] = float(t)
        lad.observe(True)
    assert admission.current_level() == 2
    faults.configure("s=error#2")
    with pytest.raises(faults.FaultError):
        faults.failpoint("s")
    spool.set_cap_mb(1.0)
    spool.write(str(tmp_path), "a", "x" * 10)
    assert str(tmp_path) in spool._approx_bytes
    rd, wr = os.pipe()
    pid = os.fork()
    if pid == 0:  # the worker: report what it sees, then leave at once
        try:
            seen = {"level": admission.current_level(),
                    "trace": admission.allow_request_trace(),
                    "effects": rung_effects_port(),
                    "spec": faults.active_spec(),
                    "fired": faults.fired_counts(),
                    "estimates": len(spool._approx_bytes)}
            os.write(wr, json.dumps(seen).encode())
        finally:
            os._exit(0)
    os.close(wr)
    with os.fdopen(rd) as f:
        seen = json.loads(f.read())
    os.waitpid(pid, 0)
    spool.set_cap_mb(0)
    assert seen == {"level": 0, "trace": True,
                    "effects": [False] * 4, "spec": "s=error#2",
                    "fired": {"s": 0}, "estimates": 0}
    assert admission.current_level() == 2
    assert faults.fired_counts() == {"s": 1}
