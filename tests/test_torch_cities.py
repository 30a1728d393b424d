"""The port's multi-city serving (``reporter_tpu_torch.service.cities``,
``city=`` routing in ``service/server.py``) against the JAX package's.

The first part ports the JAX package's city cases (``TestCityRegistry``,
``TestMapSwap`` and ``TestServiceRouting`` of ``tests/test_serving_tier.py``
and the city gate case of ``tests/test_admission.py``) onto the port, on
the CPU; where a JAX case sets an environment knob, the port's case passes
the registry argument that stands for it. The second part drives both
packages' registries with one budget and one sequence of requests and
swaps and holds them equal: bodies byte for byte, the resident order, the
``datastore.city.*`` counters, the swap records and the ``cities`` key
sets of ``/health`` and ``/profile``. Then the port's own contract: a
closed city releases its threads, the config's ``CITY_KEYS`` size the
registry as the JAX package's environment does, and the server's ``main``
serves ``city=`` from a ``cities`` config. Tolerance: exact.
"""
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.service.cities import CityRegistry as JaxRegistry
from reporter_tpu.service.server import ReporterService as JaxService
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu.utils import metrics as jax_metrics
from reporter_tpu_torch.core.osmlr import make_segment_id
from reporter_tpu_torch.datastore import (BackgroundCompactor,
                                          LocalDatastore, ObservationBatch,
                                          export_profile)
from reporter_tpu_torch.datastore.profile import profile_path
from reporter_tpu_torch.graph.version import map_version
from reporter_tpu_torch.matcher import SegmentMatcher
from reporter_tpu_torch.service.admission import Overload
from reporter_tpu_torch.service.cities import (DEFAULT_BUDGET_BYTES,
                                               CityRegistry)
from reporter_tpu_torch.service.server import (CITY_KEYS, ReporterService,
                                               cities_from_config,
                                               parse_config, read_config,
                                               serve)
from reporter_tpu_torch.synth import build_grid_city, generate_trace
from reporter_tpu_torch.utils import faults, metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Monday 2017-01-02 08:00:00 UTC -> hour-of-week 8
MON_8AM = 1483344000
CITY = dict(rows=7, cols=7, spacing_m=220.0, seed=11,
            service_road_fraction=0.0, internal_fraction=0.0)
ALIEN = dict(rows=5, cols=5, spacing_m=150.0, seed=2,
             service_road_fraction=0.0, internal_fraction=0.0)
COUNTERS = ("datastore.city.hits", "datastore.city.misses",
            "datastore.city.loads", "datastore.city.evictions",
            "swap.flips", "swap.refusals", "swap.shadow.checks",
            "swap.shadow.agree", "swap.shadow.mismatch",
            "swap.shadow.sampled")


@pytest.fixture(autouse=True)
def _fresh():
    faults.clear()
    metrics.default.reset()
    jax_metrics.default.reset()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def synth_city():
    return build_grid_city(**CITY)


def _obs(seg_ids, rng, n_obs, batch=ObservationBatch):
    """Random observations over the given segment ids."""
    seg_arr = np.asarray(seg_ids, dtype=np.int64)
    dur = rng.uniform(5, 30, n_obs)
    return batch(
        segment_id=rng.choice(seg_arr, size=n_obs),
        next_id=rng.choice(seg_arr, size=n_obs),
        duration_s=dur,
        count=np.ones(n_obs, dtype=np.int64),
        length_m=(dur * rng.uniform(3, 20, n_obs)).astype(np.int64) + 1,
        queue_m=np.zeros(n_obs, dtype=np.int64),
        min_ts=rng.integers(MON_8AM, MON_8AM + 600000, n_obs),
        max_ts=rng.integers(MON_8AM + 600000, MON_8AM + 700000, n_obs))


def _seed_store(root, seg_ids, deltas=3, n_obs=256, seed=3,
                store=LocalDatastore, batch=ObservationBatch):
    ds = store(str(root))
    rng = np.random.default_rng(seed)
    for d in range(deltas):
        ds.ingest(_obs(seg_ids, rng, n_obs, batch), ingest_key=f"seed-{d}")
    return ds


def _city_requests(city, n=6, seed=23):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        tr = None
        while tr is None:
            tr = generate_trace(city, f"warm-{i}", rng, noise_m=3.0,
                                min_route_edges=8)
        reqs.append(tr.request_json())
    return reqs


def _svc(city, root=None, native=False, **kw):
    """A port service on the CPU, with a seeded store at ``root``."""
    ds = None
    if root is not None:
        ds = _seed_store(root, [make_segment_id(2, 100, 1)], deltas=1,
                         n_obs=16)
    return ReporterService(SegmentMatcher(city, device="cpu", native=native),
                           datastore=ds, **kw)


def _text(body):
    return bytes(body).decode() if not isinstance(body, str) else body


def _closed(service):
    with pytest.raises(RuntimeError):
        service.dispatcher.submit({"uuid": "x", "trace": []})
    return True


# ---- the JAX package's cases, on the port ----------------------------------

class TestCityRegistry:
    def _registry(self, synth_city, tmp_path, budget):
        built = []

        def loader(name):
            seg = make_segment_id(2, 100 + len(name), 1)
            ds = _seed_store(tmp_path / f"store-{name}", [seg], deltas=1,
                             n_obs=16)
            svc = ReporterService(
                SegmentMatcher(synth_city, device="cpu", native=False),
                datastore=ds)
            built.append(name)
            return svc, 100  # 100 "bytes" per city

        return CityRegistry(budget_bytes=budget, loader=loader), built

    def test_lru_eviction_under_budget(self, synth_city, tmp_path):
        registry, built = self._registry(synth_city, tmp_path, budget=250)
        a = registry.get("a")
        registry.get("b")
        registry.get("a")  # refresh a's recency
        registry.get("c")  # 300 > 250: evicts b (LRU), not a
        snap = registry.snapshot()
        assert sorted(snap["resident"]) == ["a", "c"]
        assert metrics.default.counter("datastore.city.evictions") == 1
        assert registry.get("a") is a  # still resident, same entry
        registry.get("b")  # b reloads on demand
        assert built.count("b") == 2

    def test_most_recent_never_evicted(self, synth_city, tmp_path):
        registry, _ = self._registry(synth_city, tmp_path, budget=1)
        registry.get("a")
        registry.get("b")
        assert sorted(registry.snapshot()["resident"]) == ["b"]

    def test_unknown_city_raises(self):
        registry = CityRegistry({"x": {"graph": "nope.npz"}})
        with pytest.raises(KeyError):
            registry.get("unconfigured")

    def test_eviction_closes_dispatcher(self, synth_city, tmp_path):
        registry, _ = self._registry(synth_city, tmp_path, budget=1)
        a = registry.get("a")
        registry.get("b")
        assert _closed(a.service)

    def test_pinned_entry_closes_at_release_not_eviction(self, synth_city,
                                                        tmp_path):
        """An LRU eviction must not stop a city's dispatcher while a
        handler thread still serves through it: the close defers to the
        last release()."""
        registry, _ = self._registry(synth_city, tmp_path, budget=1)
        a = registry.acquire("a")  # pinned, as server._route does
        assert a._refs == 1  # the pin lands inside the map lock
        registry.get("b")  # evicts a from the map...
        assert sorted(registry.snapshot()["resident"]) == ["b"]
        # ...but a's dispatcher is still alive for the in-flight request
        a.service.dispatcher.submit_many([], return_exceptions=True)
        registry.release(a)
        assert _closed(a.service)
        # a pinned hit also pins atomically
        b = registry.acquire("b")
        b2 = registry.acquire("b")
        assert b is b2 and b._refs == 2
        registry.release(b)
        registry.release(b2)
        assert b._refs == 0


class TestMapSwap:
    """The swap flips at a request boundary behind the shadow gate,
    refuses rather than evict a pinned unrelated city, and in-flight pins
    keep the old stack alive through the flip."""

    def test_swap_flips_to_new_version(self, synth_city, tmp_path):
        city2 = build_grid_city(**CITY)
        city2.edge_speed_kph = city2.edge_speed_kph * 1.2
        assert map_version(city2) != map_version(synth_city)
        svc1 = _svc(synth_city, tmp_path / "v1")
        svc2 = _svc(city2, tmp_path / "v2")
        reg = CityRegistry(loader=lambda n: (svc1, 100),
                           budget_bytes=1 << 30)
        old = reg.get("metro")
        assert old.map_version == map_version(synth_city)
        # the load stamped the city's store
        assert old.service.datastore.map_version == old.map_version
        rec = reg.swap("metro", lambda: (svc2, 100))
        assert rec["result"] == "flipped"
        assert rec["from"] == map_version(synth_city)
        assert rec["to"] == map_version(city2)
        assert metrics.default.counter("swap.flips") == 1
        new = reg.get("metro")
        assert new is not old and new.map_version == rec["to"]
        assert new.service.datastore.map_version == rec["to"]
        assert _closed(old.service)  # unpinned: closed at the flip
        snap = reg.snapshot()
        assert snap["swap"]["flips"] == 1
        assert snap["swap"]["last"]["metro"]["result"] == "flipped"
        assert snap["resident"]["metro"]["map_version"] == rec["to"]

    def test_pin_on_old_survives_flip_until_release(self, synth_city,
                                                    tmp_path):
        svc1 = _svc(synth_city, tmp_path / "p1")
        svc2 = _svc(synth_city, tmp_path / "p2")
        reg = CityRegistry(loader=lambda n: (svc1, 100),
                           budget_bytes=1 << 30)
        old = reg.acquire("metro")
        rec = reg.swap("metro", lambda: (svc2, 100))
        assert rec["result"] == "flipped"
        # the old version still serves the in-flight request...
        old.service.dispatcher.submit_many([], return_exceptions=True)
        # ...while new requests route to the new one
        assert reg.get("metro").service is svc2
        reg.release(old)
        assert _closed(old.service)

    def test_shadow_gate_refuses_divergent_graph(self, synth_city,
                                                 tmp_path):
        alien = build_grid_city(**ALIEN)
        svc1 = _svc(synth_city, tmp_path / "s1")
        svc2 = _svc(alien, tmp_path / "s2")
        # swap_sample=1.0: the JAX case's REPORTER_TPU_SWAP_SAMPLE=1
        reg = CityRegistry(loader=lambda n: (svc1, 100),
                           budget_bytes=1 << 30, swap_sample=1.0)
        old = reg.get("metro")
        for req in _city_requests(synth_city, n=4):
            old.observe(req)  # as server._route does on admitted 200s
        rec = reg.swap("metro", lambda: (svc2, 100))
        assert rec["result"] == "refused_shadow"
        assert rec["checks"] == 4 and rec["agreement"] < rec["floor"]
        assert metrics.default.counter("swap.refusals") == 1
        # the old version keeps serving; the candidate was closed
        assert reg.get("metro") is old
        snap = reg.snapshot()["swap"]
        assert snap["refusals"] == 1
        assert snap["last"]["metro"]["result"] == "refused_shadow"
        assert _closed(svc2)
        # the operator's override: an intentional map change flips anyway
        svc3 = _svc(alien, tmp_path / "s3")
        rec = reg.swap("metro", lambda: (svc3, 100), force=True)
        assert rec["result"] == "flipped" and rec["forced"]

    def test_eviction_flushes_incremental_state(self, synth_city,
                                                tmp_path):
        services = {"a": _svc(synth_city, tmp_path / "e1"),
                    "b": _svc(synth_city, tmp_path / "e2")}
        reg = CityRegistry(loader=lambda n: (services[n], 100),
                           budget_bytes=100)
        a = reg.get("a")
        req = _city_requests(synth_city, n=1)[0]
        a.service.matcher.match_incremental(
            [{"uuid": "evict-1", "trace": req["trace"]}])
        table = a.service.matcher.incremental_table
        assert table.gauge()["traces"] == 1
        reg.get("b")  # a budget of one city: evicts and closes a
        assert table.gauge()["traces"] == 0
        assert metrics.default.counter("match.incremental.evictions") == 1

    def test_swap_publishes_epoch_feed_event(self, synth_city, tmp_path):
        svc1 = _svc(synth_city, tmp_path / "f1")
        svc2 = _svc(synth_city, tmp_path / "f2")
        tier = svc2.datastore.enable_freshness()
        assert tier is not None
        reg = CityRegistry(loader=lambda n: (svc1, 100),
                           budget_bytes=1 << 30)
        reg.get("metro")
        rec = reg.swap("metro", lambda: (svc2, 100))
        assert rec["result"] == "flipped"
        out = tier.feed.poll(cursor=0, timeout_s=0)
        epochs = [e for e in out["events"] if e["kind"] == "epoch"]
        assert epochs and epochs[-1]["map_version"] == rec["to"]

    def test_budget_refusal_spares_pinned_city(self, synth_city, tmp_path):
        built = []

        def loader(name):
            svc = _svc(synth_city, tmp_path / f"b{len(built)}")
            built.append(name)
            return svc, 100

        reg = CityRegistry(loader=loader, budget_bytes=250)
        reg.get("metro")
        other = reg.acquire("other")  # a pinned unrelated city
        rec = reg.swap("metro")  # 100 * 3 > 250 with 'other' pinned
        assert rec["result"] == "refused_budget"
        assert rec["pinned"] == ["other"]
        assert sorted(reg.snapshot()["resident"]) == ["metro", "other"]
        assert metrics.default.counter("datastore.city.evictions") == 0
        # unpinned: the unrelated LRU city is evicted and the swap proceeds
        reg.release(other)
        rec = reg.swap("metro")
        assert rec["result"] == "flipped"
        assert sorted(reg.snapshot()["resident"]) == ["metro"]
        assert metrics.default.counter("datastore.city.evictions") == 1

    def test_swap_failpoint_keeps_the_old_version(self, synth_city,
                                                  tmp_path):
        """``city.swap`` fires after the gate and before the flip: the
        swap raises, the candidate closes, the old version serves."""
        svc1 = _svc(synth_city, tmp_path / "c1")
        svc2 = _svc(synth_city, tmp_path / "c2")
        reg = CityRegistry(loader=lambda n: (svc1, 100),
                           budget_bytes=1 << 30)
        old = reg.get("metro")
        faults.configure("city.swap=error#1")
        with pytest.raises(faults.FaultError):
            reg.swap("metro", lambda: (svc2, 100))
        assert reg.get("metro") is old
        assert _closed(svc2)
        assert reg.swap("metro", lambda: (_svc(synth_city), 100))[
            "result"] == "flipped"


class TestServiceRouting:
    @pytest.fixture()
    def routed_service(self, synth_city, tmp_path):
        seg = make_segment_id(2, 301, 4)
        ds_b = _seed_store(tmp_path / "store-b", [seg], deltas=1, n_obs=32)

        def loader(name):
            if name != "b":
                raise KeyError(name)
            return ReporterService(
                SegmentMatcher(synth_city, device="cpu", native=False),
                datastore=ds_b), 1
        service = ReporterService(
            SegmentMatcher(synth_city, device="cpu", native=False),
            cities=CityRegistry(loader=loader))
        yield service, seg, ds_b
        service.dispatcher.close()

    def test_histogram_routes_by_city(self, routed_service):
        service, seg, ds_b = routed_service
        code, _ = service.histogram({"segment_id": seg})
        assert code == 503  # no city, no default datastore
        code, body = service.histogram({"segment_id": seg, "city": "b"})
        assert code == 200
        assert json.loads(body) == ds_b.query(seg)

    def test_batched_histogram_params(self, routed_service):
        service, seg, ds_b = routed_service
        code, body = service.histogram({"segments": [seg, seg + 8],
                                        "city": "b"})
        assert code == 200
        assert json.loads(body)["results"] == ds_b.query_many([seg, seg + 8])
        code, body = service.histogram(
            {"bbox": [-180, -90, 180, 90], "level": 2, "city": "b"})
        assert code == 200
        assert {r["segment_id"] for r in json.loads(body)["segments"]} \
            >= {seg}
        # bbox without level is a 400, as is nothing at all
        assert service.histogram({"bbox": [0, 0, 1, 1],
                                  "city": "b"})[0] == 400
        assert service.histogram({"city": "b"})[0] == 400

    def test_unknown_city_is_400(self, routed_service):
        service, seg, _ = routed_service
        code, body = service.histogram({"segment_id": seg,
                                        "city": "atlantis"})
        assert code == 400 and "atlantis" in body

    def test_report_routes_by_city(self, routed_service, synth_city):
        service, _seg, _ds = routed_service
        req = _city_requests(synth_city, n=1)[0]
        code, body = service.handle(dict(req, city="b"))
        assert code == 200
        code_direct, body_direct = service.handle(req)
        assert code_direct == 200
        # the same graph both sides: the routed answer is the default's
        assert _text(body) == _text(body_direct)

    def test_health_carries_lease_and_compactor(self, synth_city,
                                                tmp_path):
        seg = make_segment_id(2, 305, 4)
        ds = _seed_store(tmp_path / "s", [seg], deltas=2, n_obs=16)
        service = ReporterService(
            SegmentMatcher(synth_city, device="cpu", native=False),
            datastore=ds)
        service.compactor = BackgroundCompactor(ds, max_deltas=1,
                                                interval_s=0.0)
        service.compactor.pending(refresh=True)
        try:
            got = json.loads(service.health()[1])
            assert got["datastore"]["lease"]["enabled"]
            assert got["compaction"]["partitions_over"] == 1
        finally:
            service.dispatcher.close()

    def test_health_surfaces_map_versions(self, routed_service,
                                          synth_city):
        service, _seg, _ds = routed_service
        service.cities.get("b")  # make the routed city resident
        got = json.loads(service.health()[1])
        assert got["graph"]["map_version"] == map_version(synth_city)
        resident = got["cities"]["resident"]["b"]
        assert resident["map_version"] == map_version(synth_city)
        assert got["cities"]["swap"] == {"flips": 0, "refusals": 0,
                                         "last": {}}


def test_city_routed_requests_hit_their_own_gate(synth_city):
    """A ``city=`` request is shed by that city's gate: the front-door
    gate only watches the default dispatcher."""
    inner = ReporterService(SegmentMatcher(synth_city, device="cpu"),
                            threshold_sec=15, max_batch=8)

    class ShedGate:
        released = 0

        def admit(self):
            return Overload("queue", 11.0)

        def release(self):
            ShedGate.released += 1

    inner.admission = ShedGate()

    class Entry:
        service = inner

    class FakeRegistry:
        def acquire(self, name):
            assert name == "metro"
            return Entry()

        def release(self, entry):
            pass

    outer = ReporterService(SegmentMatcher(synth_city, device="cpu"),
                            threshold_sec=15, max_batch=8)
    outer.cities = FakeRegistry()
    try:
        req = dict(_city_requests(synth_city, n=1, seed=9)[0], city="metro")
        code, body = outer.handle(req)
        assert code == 429
        parsed = json.loads(body)
        assert parsed["reason"] == "queue"
        assert parsed["retry_after_s"] == 11.0
        assert ShedGate.released == 0  # a shed never holds a slot
        # an admitting city gate serves
        inner.admission = None
        assert outer.handle(req)[0] == 200
    finally:
        inner.dispatcher.close()
        outer.dispatcher.close()


# ---- both packages' registries on one sequence -----------------------------

def _write_cities(tmp_path, profile=True):
    """Three cities saved as ``.npz`` (metro, its re-profiled twin and an
    alien build), each with a seeded store and, with ``profile``, a
    ``.profile`` exported by the port's native matcher after a few
    requests. Returns ({name: config}, requests of metro)."""
    metro = build_grid_city(**CITY)
    reqs = _city_requests(metro, n=6)
    confs = {}
    for name, city, seed in (("metro", metro, 3), ("twin", metro, 4),
                             ("alien", build_grid_city(**ALIEN), 5)):
        path = str(tmp_path / f"{name}.npz")
        city.save(path)
        root = tmp_path / f"store-{name}"
        _seed_store(root, [make_segment_id(2, 300, 1)], deltas=1, n_obs=16,
                    seed=seed)
        if profile:
            m = SegmentMatcher(city, device="cpu", prep_threads=1)
            m.match_many(reqs[:seed - 1])
            export_profile(m, profile_path(str(root)), city=name)
            m.close()
        confs[name] = {"graph": path, "datastore": str(root)}
    return confs, reqs


def _counters(mod):
    return {name: mod.default.counter(name) for name in COUNTERS}


def _jax_confs(confs, tmp_path):
    """``confs`` with each store copied for the JAX package's registry."""
    out = {}
    for name, conf in confs.items():
        root = tmp_path / "jax" / os.path.basename(conf["datastore"])
        shutil.copytree(conf["datastore"], root)
        out[name] = dict(conf, datastore=str(root))
    return out


def _jax_registry(confs, budget, monkeypatch):
    monkeypatch.setenv("REPORTER_TPU_PREP_THREADS", "1")
    monkeypatch.setenv("REPORTER_TPU_SWAP_SAMPLE", "1")
    return JaxRegistry({"metro": confs["metro"], "other": confs["alien"]},
                       budget_bytes=budget)


def _port_registry(confs, budget):
    reg = CityRegistry({"metro": confs["metro"], "other": confs["alien"]},
                       budget_bytes=budget, device="cpu", swap_sample=1.0)
    return reg


def _drive(service, registry, reqs, swaps):
    """One sequence of routed requests and swaps; returns the bodies, the
    resident order after each step and the swap records."""
    bodies, order, records = [], [], []
    for step in ("metro", "other", "metro", "other"):
        for req in reqs[:3]:
            code, body = service.handle(dict(req, city=step))
            bodies.append((code, _text(body)))
        code, body = service.histogram(
            {"segment_id": make_segment_id(2, 300, 1), "city": step})
        bodies.append((code, body))
        code, body = service.handle(dict(reqs[0], city="atlantis"))
        bodies.append((code, body))
        order.append(list(registry._resident))
    for conf, force in swaps:
        rec = registry.swap("metro", conf, force=force)
        records.append({k: rec.get(k) for k in ("result", "agreement",
                                                 "checks", "from", "to",
                                                 "forced")})
        for req in reqs[:2]:
            code, body = service.handle(dict(req, city="metro"))
            bodies.append((code, _text(body)))
        order.append(list(registry._resident))
    return bodies, order, records


@pytest.mark.parametrize("budget", [1 << 30, 1],
                         ids=["resident", "evicting"])
def test_registries_agree_on_one_sequence(tmp_path, monkeypatch, budget):
    """The same cities config, budget and sequence of requests and swaps
    (the re-profiled twin: flipped at agreement 1.0, or loaded where
    metro was evicted; the alien build: refused by the shadow gate; the
    alien forced: flipped) through both
    packages' registries: bodies, resident order, counters and swap
    records equal. A budget of 1 byte holds one city, so every change of
    city evicts."""
    confs, reqs = _write_cities(tmp_path)
    jconfs = _jax_confs(confs, tmp_path)
    ref_city = jax_city(**CITY)
    city = build_grid_city(**CITY)
    jreg = _jax_registry(jconfs, budget, monkeypatch)
    jsvc = JaxService(JaxMatcher(net=ref_city), cities=jreg)
    preg = _port_registry(confs, budget)
    psvc = ReporterService(SegmentMatcher(city, device="cpu",
                                          prep_threads=1), cities=preg)
    try:
        want = _drive(jsvc, jreg, reqs, [
            (jconfs["twin"], None), (jconfs["alien"], None),
            (jconfs["alien"], True)])
        got = _drive(psvc, preg, reqs, [
            (confs["twin"], None), (confs["alien"], None),
            (confs["alien"], True)])
    finally:
        jsvc.dispatcher.close()
        psvc.dispatcher.close()
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    # evicting: the sequence ends on "other", so the twin loads beside
    # no resident metro
    first = "flipped" if budget > 1 else "loaded"
    assert [r["result"] for r in got[2]] == [first, "refused_shadow",
                                              "flipped"]
    if first == "flipped":
        assert got[2][0]["agreement"] == 1.0 and got[2][0]["checks"] > 0
        assert got[2][0]["from"] != got[2][0]["to"]  # a new .profile
    assert _counters(metrics) == _counters(jax_metrics)
    assert metrics.default.counter("datastore.city.loads") > 0


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health_and_profile_carry_the_same_cities_block(tmp_path,
                                                        monkeypatch):
    """``/health`` and ``/profile`` over HTTP: the ``cities`` block's keys,
    each resident city's keys, the map versions, the warmed pairs and the
    swap block equal the JAX service's."""
    from reporter_tpu.service.server import serve as jax_serve
    confs, reqs = _write_cities(tmp_path)
    jconfs = _jax_confs(confs, tmp_path)
    jreg = _jax_registry(jconfs, 1 << 30, monkeypatch)
    jsvc = JaxService(JaxMatcher(net=jax_city(**CITY)), cities=jreg)
    preg = _port_registry(confs, 1 << 30)
    psvc = ReporterService(SegmentMatcher(build_grid_city(**CITY),
                                          device="cpu"), cities=preg)
    servers = [(jax_serve(jsvc, "127.0.0.1", 0), jsvc, jconfs),
               (serve(psvc, "127.0.0.1", 0), psvc, confs)]
    try:
        blocks = []
        for httpd, svc, cf in servers:
            assert svc.handle(dict(reqs[0], city="metro"))[0] == 200
            svc.cities.swap("metro", cf["twin"])
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            _st, health = _get(url + "/health")
            _st, prof = _get(url + "/profile")
            blocks.append((health["cities"], prof["cities"]))
        (jh, jp), (ph, pp) = blocks
        for want, got in ((jh, ph), (jp, pp)):
            assert set(got) == set(want)
            assert got["swap"] == want["swap"]
            assert got["configured"] == want["configured"]
            for name, entry in want["resident"].items():
                mine = got["resident"][name]
                assert set(mine) == set(entry)
                for key in ("map_version", "warmed_pairs", "datastore"):
                    assert mine[key] == entry[key]
        assert ph["resident"]["metro"]["warmed_pairs"] > 0
    finally:
        for httpd, svc, _cf in servers:
            httpd.shutdown()
            httpd.server_close()
            svc.dispatcher.close()


def test_feed_routes_by_city_as_the_jax_service_does(tmp_path,
                                                     monkeypatch):
    """``/feed`` with ``city=``: the routed city's change feed, the JAX
    service's body; an unknown city 400 with its message."""
    confs, _reqs = _write_cities(tmp_path, profile=False)
    jreg = _jax_registry(_jax_confs(confs, tmp_path), 1 << 30, monkeypatch)
    jsvc = JaxService(JaxMatcher(net=jax_city(**CITY), use_native=False),
                      cities=jreg)
    preg = _port_registry(confs, 1 << 30)
    psvc = ReporterService(SegmentMatcher(build_grid_city(**CITY),
                                          device="cpu", native=False),
                           cities=preg)
    try:
        for params in ({"city": "metro", "cursor": 0, "timeout": 0},
                       {"city": "atlantis", "cursor": 0, "timeout": 0},
                       {"cursor": 0, "timeout": 0}):
            assert psvc.feed(dict(params)) == jsvc.feed(dict(params))
    finally:
        jsvc.dispatcher.close()
        psvc.dispatcher.close()


# ---- the port's own contract -----------------------------------------------

def test_closed_matcher_releases_its_lanes_and_raises(synth_city):
    m = SegmentMatcher(synth_city, device="cpu")
    req = _city_requests(synth_city, n=1)[0]
    m.match_many([req])
    lanes = [t for lane in m._lanes for t in lane._threads]
    assert len(lanes) == 2 and all(t.is_alive() for t in lanes)
    m.close()
    m.close()  # idempotent
    assert not any(t.is_alive() for t in lanes)
    with pytest.raises(RuntimeError, match="closed"):
        m.match_many([req])
    with pytest.raises(RuntimeError, match="closed"):
        m.match_incremental([req])


def test_registry_locks_are_the_jax_registrys():
    """The registry's locks carry the JAX package's names; the load lock
    is a documented long holder (the store's commit lock is the other),
    the resident map's lock is not."""
    jreg, reg = JaxRegistry(), CityRegistry()
    for mine, theirs in ((reg._lock, jreg._lock),
                         (reg._res_lock, jreg._reslock)):
        assert mine.name == theirs.name
        assert mine.long_hold_ok == theirs.long_hold_ok
    assert reg._lock.long_hold_ok and not reg._res_lock.long_hold_ok


def test_load_evict_cycles_return_the_thread_count(tmp_path):
    """Config-built cities loaded and evicted round-robin under a budget
    of one city: every evicted stack's dispatcher and lanes stop, so after
    eight cycles the process holds the threads it held after the first."""
    confs, reqs = _write_cities(tmp_path, profile=False)
    reg = CityRegistry({"a": confs["metro"], "b": confs["twin"]},
                       budget_bytes=1, device="cpu")
    svc = ReporterService(SegmentMatcher(build_grid_city(**CITY),
                                         device="cpu"), cities=reg)
    try:
        def cycle():
            for name in ("a", "b"):
                assert svc.handle(dict(reqs[0], city=name))[0] == 200
        cycle()
        base = threading.active_count()
        for _ in range(8):
            cycle()
        assert threading.active_count() == base
        assert metrics.default.counter("datastore.city.evictions") == 17
        assert sorted(reg.snapshot()["resident"]) == ["b"]
    finally:
        svc.dispatcher.close()


def test_snapshot_pins_what_it_reads(synth_city):
    """An entry evicted while ``snapshot`` reads it closes only at the
    snapshot's release, never under the read."""
    seen = []

    def loader(name):
        return _svc(synth_city), 100

    reg = CityRegistry(loader=loader, budget_bytes=1 << 30)
    a = reg.get("a")
    real = a.snapshot

    def snap():
        reg.evict("a")
        seen.append(a.service.dispatcher._closed)
        return real()

    a.snapshot = snap
    assert "a" in reg.snapshot()["resident"]
    assert seen == [False] and _closed(a.service)


def test_city_keys_size_the_registry_as_the_jax_env_does(tmp_path,
                                                         monkeypatch):
    """The config's ``CITY_KEYS`` give the registry the JAX package's
    ``REPORTER_TPU_CITY_BUDGET_MB``, and the registry's swap arguments
    its swap knobs: the same budget, sample, floor, window and force,
    and so the same forced flip of a divergent build; without them the
    defaults; an unknown key, a swap knob among them, is refused."""
    from reporter_tpu.service import cities as jax_cities
    knobs = {"city_budget_mb": 1.5}
    assert set(knobs) == set(CITY_KEYS)
    swap = {"swap_sample": 0.5, "swap_agreement": 0.75, "swap_window": 3,
            "swap_force": True}
    confs, reqs = _write_cities(tmp_path, profile=False)
    jconfs = _jax_confs(confs, tmp_path)
    conf = {"graph": confs["metro"]["graph"], "service": knobs,
            "cities": {"metro": confs["metro"]}}
    env = {"REPORTER_TPU_CITY_BUDGET_MB": "1.5",
           "REPORTER_TPU_SWAP_SAMPLE": "0.5",
           "REPORTER_TPU_SWAP_AGREEMENT": "0.75",
           "REPORTER_TPU_SWAP_WINDOW": "3", "REPORTER_TPU_SWAP_FORCE": "1"}
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    sized = cities_from_config(parse_config(conf), "cpu")
    reg = CityRegistry(sized.config, budget_bytes=sized.budget_bytes,
                       device="cpu", **swap)
    jreg = JaxRegistry({"metro": jconfs["metro"]})
    assert sized.budget_bytes == jreg.budget_bytes == int(1.5 * 1024 * 1024)
    assert reg.swap_sample == jax_cities.swap_sample_fraction()
    assert reg.swap_agreement == jax_cities.swap_agreement_floor()
    assert reg.swap_window == jax_cities.swap_window()
    assert reg.swap_force is jax_cities.swap_force()
    records = []
    for r, cf in ((jreg, jconfs), (reg, confs)):
        entry = r.get("metro")
        for req in reqs:
            entry.observe(req)
        assert len(entry.capture_samples()) == 3  # 6 x 0.5, window 3
        rec = r.swap("metro", cf["alien"])
        records.append({k: rec[k] for k in ("result", "agreement",
                                             "checks", "forced", "from",
                                             "to")})
        r.evict("metro")
    assert records[0] == records[1]
    assert records[1]["result"] == "flipped" and records[1]["forced"]
    for key in env:
        monkeypatch.delenv(key)
    plain = cities_from_config(parse_config(dict(conf, service={})), "cpu")
    assert (plain.budget_bytes, plain.swap_sample, plain.swap_agreement,
            plain.swap_window, plain.swap_force) == (
        DEFAULT_BUDGET_BYTES, jax_cities.swap_sample_fraction(),
        jax_cities.swap_agreement_floor(), jax_cities.swap_window(),
        jax_cities.swap_force())
    assert cities_from_config(parse_config({"graph": "x.npz"}), "cpu") \
        is None
    for bad in ({"service": {"swap_floor": 0.5}},
                *({"service": {k: v}} for k, v in swap.items()),
                {"cities": {"metro": {"graph": "x", "grpah": "y"}}},
                {"cities": {"metro": "x.npz"}}):
        with pytest.raises(ValueError):
            parse_config(dict({"graph": "x.npz"}, **bad))
    path = tmp_path / "conf.json"
    path.write_text(json.dumps(conf))
    assert read_config(str(path))["city"] == knobs


def test_server_main_serves_city_from_a_cities_config(tmp_path):
    """``python -m reporter_tpu_torch.service.server`` with a ``cities``
    config and ``--device cpu``: a ``city=`` /report answers the JAX
    service's bytes, /histogram of the city its store's answer, an
    unknown city 400; a config without ``cities`` keeps the single-city
    400."""
    import socket
    confs, reqs = _write_cities(tmp_path, profile=False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"graph": confs["alien"]["graph"],
                               "cities": {"metro": confs["metro"]}}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "reporter_tpu_torch.service.server",
         str(cfg), f"127.0.0.1:{port}", "--device", "cpu"], cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    url = f"http://127.0.0.1:{port}"
    ref = JaxService(JaxMatcher(net=jax_city(**CITY)))
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                urllib.request.urlopen(url + "/health", timeout=5).read()
                break
            except urllib.error.HTTPError:
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read().decode()
                assert time.monotonic() < deadline
                time.sleep(0.2)
        for req in reqs[:3]:
            body = json.dumps(dict(req, city="metro")).encode()
            with urllib.request.urlopen(urllib.request.Request(
                    url + "/report", data=body, method="POST"),
                    timeout=60) as r:
                got = r.read()
            code, want = ref.handle(dict(req))
            assert code == 200 and got == _text(want).encode()
        seg = make_segment_id(2, 300, 1)
        st, hist = _get(f"{url}/histogram?segment_id={seg}&city=metro")
        assert st == 200
        assert hist == LocalDatastore(confs["metro"]["datastore"]).query(seg)
        st, err = _get(f"{url}/histogram?segment_id={seg}&city=atlantis")
        assert st == 400 and "atlantis" in err["error"]
        st, health = _get(url + "/health")
        assert st == 200 and sorted(health["cities"]["resident"]) \
            == ["metro"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        ref.dispatcher.close()
    single = ReporterService(SegmentMatcher(build_grid_city(**CITY),
                                            device="cpu"))
    try:
        code, body = single.handle(dict(reqs[0], city="metro"))
        assert code == 400 and "single city" in body
    finally:
        single.dispatcher.close()
