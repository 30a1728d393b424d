"""The port's streaming worker against the JAX package's.

Each test drives the JAX package's ``reporter_tpu.streaming`` and the
port's ``reporter_tpu_torch.streaming`` on the same seeded inputs and
compares what comes out (tolerance: exact; bytes and CSV text equal):

- the value types' 20/40/16-byte layouts and the tile CSV rows;
- the formatter's sv and json grammars;
- the batcher's thresholds, trims, eviction, batched flushes, retry
  budget and dead-letter spool (the JAX package's
  ``tests/test_streaming.py`` and ``tests/test_microbatch.py``);
- the privacy cull;
- whole streams through both packages' ``streaming.worker.main`` on a
  12x12 city: the tile trees (paths and bytes) equal, with the
  carried-state decode on and off.
"""
import json
import os

import numpy as np
import pytest

from reporter_tpu.core import types as jax_types
from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.service.server import ReporterService as JaxService
from reporter_tpu.streaming import anonymiser as jax_anon
from reporter_tpu.streaming import batcher as jax_batcher
from reporter_tpu.streaming import formatter as jax_formatter
from reporter_tpu.streaming import worker as jax_worker
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu.synth import generate_trace as jax_trace
from reporter_tpu_torch.core.types import (Point, Segment, TimeQuantisedTile,
                                           _fmt_float)
from reporter_tpu_torch.matcher import SegmentMatcher
from reporter_tpu_torch.service.server import ReporterService
from reporter_tpu_torch.streaming import anonymiser as port_anon
from reporter_tpu_torch.streaming import worker
from reporter_tpu_torch.streaming.anonymiser import (Anonymiser, TileSink,
                                                     privacy_cull)
from reporter_tpu_torch.streaming.batcher import (Batch, PointBatcher,
                                                  segments_from_response)
from reporter_tpu_torch.streaming.formatter import (Formatter,
                                                    java_date_to_strptime)
from reporter_tpu_torch.synth import build_grid_city, generate_trace
from reporter_tpu_torch.utils import metrics

SV = r",sv,\|,0,1,2,3,4"
CITY = dict(rows=12, cols=12, spacing_m=200.0, seed=7)


@pytest.fixture(autouse=True)
def _worker_globals():
    """A worker registers its spool roots and flight-recorder directory
    process-wide (both packages'); every test leaves them unregistered."""
    yield
    from reporter_tpu.obs import flightrec as jax_flightrec
    from reporter_tpu.utils import spool as jax_spool
    from reporter_tpu_torch.obs import flightrec
    from reporter_tpu_torch.utils import spool
    for mod in (spool, jax_spool):
        mod.set_tile_dir(None)
        mod.set_trace_dir(None)
    for mod in (flightrec, jax_flightrec):
        mod.set_dump_dir(None)


def tile_tree(root):
    """{relative path: bytes} of every tile file under ``root`` (the
    dead-letter spool, a dot directory, left out)."""
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if not d.startswith(".")]
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def stream_lines(city, make_trace, n, seed, period=5.0, spread=20,
                 noise=4.0):
    """``n`` vehicles' probes as sv lines ``uuid|lat|lon|time|accuracy``,
    merged in time order (ties by uuid), vehicle i starting ``spread``*i
    seconds after the first."""
    rng = np.random.default_rng(seed)
    rows = []
    i = 0
    while i < n:
        tr = make_trace(city, f"veh-{i}", rng, noise_m=noise,
                        sample_period_s=period,
                        start_time=1_500_000_000 + spread * i)
        if tr is None:
            continue
        rows += [(p["time"], tr.uuid, p) for p in tr.points]
        i += 1
    rows.sort(key=lambda r: (r[0], r[1]))
    return [f"{u}|{p['lat']}|{p['lon']}|{p['time']}|{p['accuracy']}"
            for _t, u, p in rows]


# -- value types ----------------------------------------------------------
class TestTypes:
    def test_point_bytes_and_json_equal(self):
        rng = np.random.default_rng(3)
        for lat, lon, acc, t in zip(rng.uniform(-80, 80, 64),
                                    rng.uniform(-179, 179, 64),
                                    rng.integers(0, 100, 64),
                                    rng.integers(0, 2 ** 40, 64)):
            args = (float(lat), float(lon), int(acc), int(t))
            a, b = jax_types.Point(*args), Point(*args)
            assert b.to_bytes() == a.to_bytes() and len(b.to_bytes()) == 20
            assert b.to_json_str() == a.to_json_str()
            assert b.to_json_obj() == a.to_json_obj()
            q = Point.from_bytes(b.to_bytes())
            assert (q.lat, q.lon, q.accuracy, q.time) == \
                (b.lat, b.lon, b.accuracy, b.time)

    def test_segment_bytes_csv_and_tiles_equal(self):
        rng = np.random.default_rng(4)
        for i in range(64):
            sid = int(rng.integers(0, 2 ** 40))
            nid = None if i % 5 == 0 else int(rng.integers(0, 2 ** 40))
            t0 = 1.5e9 + float(rng.uniform(0, 7200))
            args = (sid, nid, t0, t0 + float(rng.uniform(0.4, 900)),
                    int(rng.integers(1, 2000)), int(rng.integers(0, 50)))
            a, b = jax_types.Segment(*args), Segment(*args)
            assert b.to_bytes() == a.to_bytes() and len(b.to_bytes()) == 40
            assert b.csv_row("AUTO", "src") == a.csv_row("AUTO", "src")
            assert (b.valid(), b.tile_id(), b.sort_key()) == \
                (a.valid(), a.tile_id(), a.sort_key())
            for q in (60, 900, 3600):
                got = TimeQuantisedTile.tiles_for(b, q)
                want = jax_types.TimeQuantisedTile.tiles_for(a, q)
                assert [str(t) for t in got] == [str(t) for t in want]
                assert [t.to_bytes() for t in got] == \
                    [t.to_bytes() for t in want]
                assert [(t.tile_level(), t.tile_index()) for t in got] == \
                    [(t.tile_level(), t.tile_index()) for t in want]
        assert Segment.column_layout() == jax_types.Segment.column_layout()

    def test_fmt_float_equal(self):
        for v in (0.0, -0.0, 1.5, -1e-9, 14.6000001, 121.123456789, 3e7,
                  -76.5135033):
            assert _fmt_float(v) == jax_types._fmt_float(v)


# -- formatter ------------------------------------------------------------
def both_formatters(config):
    return (jax_formatter.Formatter.from_config(config),
            Formatter.from_config(config))


def formatted(fmts, message):
    (ua, pa), (ub, pb) = (f.format(message) for f in fmts)
    assert ua == ub and pa.to_bytes() == pb.to_bytes()
    return ub, pb


class TestFormatter:
    def test_sv_with_date(self):
        fmts = both_formatters(",sv,\\|,1,9,10,0,5,yyyy-MM-dd HH:mm:ss")
        uuid, p = formatted(fmts, "2017-01-31 16:00:00|uuid_abcdef|x|x|x|"
                                  "51.3|x|x|x|3.465725|-76.5135033|x|x|x")
        assert uuid == "uuid_abcdef"
        assert p.lat == pytest.approx(3.465725)
        assert p.accuracy == 52  # ceil(51.3)
        assert p.time == 1485878400  # 2017-01-31T16:00:00Z
        assert java_date_to_strptime("yyyy-MM-dd HH:mm:ss.SSS") == \
            jax_formatter.java_date_to_strptime("yyyy-MM-dd HH:mm:ss.SSS")

    def test_json_epoch(self):
        fmts = both_formatters(
            "@json@id@latitude@longitude@timestamp@accuracy")
        uuid, p = formatted(fmts, json.dumps({
            "timestamp": 1495037969, "id": "uuid_abcdef",
            "accuracy": 51.305, "latitude": 3.465725,
            "longitude": -76.5135033}))
        assert uuid == "uuid_abcdef"
        assert p.time == 1495037969 and p.accuracy == 52

    @pytest.mark.parametrize("config", [",nope,a,b", "|json|a"])
    def test_bogus_config_rejected(self, config):
        for cls in (jax_formatter.Formatter, Formatter):
            with pytest.raises(Exception):
                cls.from_config(config)

    def test_bogus_message_raises(self):
        for f in both_formatters(",sv,\\|,1,9,10,0,5"):
            with pytest.raises(Exception):
                f.format("not|enough|fields")


# -- batcher --------------------------------------------------------------
def _pt(mod, t, lat=14.6, lon=121.0):
    return mod.Point(lat, lon, 10, t)


class TestBatchThresholds:
    @pytest.mark.parametrize("pkg", ["jax", "port"])
    def test_no_report_below_thresholds(self, pkg):
        P, cls = ((jax_types.Point, jax_batcher.Batch) if pkg == "jax"
                  else (Point, Batch))
        calls = []
        b = cls(P(14.6, 121.0, 10, 0))
        for i in range(1, 5):
            b.update(P(14.6 + i * 1e-4, 121.0, 10, i))
        out = b.report("u", lambda t: calls.append(t) or {"shape_used": 1},
                       "auto", "0,1", "0,1", 500, 10, 60)
        assert out is None and not calls

    def test_report_fires_trims_and_bodies_equal(self):
        got = []
        for P, cls in ((jax_types.Point, jax_batcher.Batch), (Point, Batch)):
            b = cls(P(14.6, 121.0, 10, 0))
            for i in range(1, 12):
                b.update(P(14.6 + i * 0.001, 121.0, 10, i * 10))
            body = b.request_body("u", "auto", "0,1", "0,1")
            cols = b.request_columns("u", {"mode": "auto"})
            out = b.report("u", lambda t: {"shape_used": 5}, "auto", "0,1",
                           "0,1", 500, 10, 60)
            assert out == {"shape_used": 5} and len(b.points) == 7
            got.append((json.dumps(body), [c.tobytes() for c in cols[1:5]],
                        b.max_separation,
                        [p.to_bytes() for p in b.points]))
        assert got[0] == got[1]

    def test_bad_response_drops_batch(self):
        def boom(t):
            raise RuntimeError("match exploded")
        for P, cls in ((jax_types.Point, jax_batcher.Batch), (Point, Batch)):
            b = cls(P(14.6, 121.0, 10, 0))
            for i in range(1, 12):
                b.update(P(14.6 + i * 0.001, 121.0, 10, i * 10))
            out = b.report("u", boom, "auto", "0,1", "0,1", 500, 10, 60)
            assert out is None and b.points == []

    def test_eviction_with_relaxed_thresholds(self):
        for P, cls in ((jax_types.Point, jax_batcher.PointBatcher),
                       (Point, PointBatcher)):
            submitted = []
            pb = cls(lambda t: submitted.append(t) or None,
                     lambda k, s: None)
            pb.process("veh", P(14.6, 121.0, 10, 0), stream_time_ms=0)
            pb.process("veh", P(14.601, 121.0, 10, 5), stream_time_ms=5000)
            assert not submitted  # thresholds not met
            pb.punctuate(stream_time_ms=200000)  # past the 60 s gap
            assert len(submitted) == 1  # evicted with (0, 2, 0)
            assert pb.store == {}


def test_segments_from_response_equal():
    rng = np.random.default_rng(12)
    reports = []
    for i in range(40):
        t0 = 1.5e9 + float(rng.uniform(0, 600))
        entry = {"id": int(rng.integers(1, 2 ** 30)),
                 "next_id": (None if i % 7 == 0
                             else int(rng.integers(1, 2 ** 30))),
                 "t0": t0, "t1": t0 + float(rng.uniform(-5, 60)),
                 "length": int(rng.integers(-1, 900)),
                 "queue_length": int(rng.integers(0, 20))}
        if i % 11 == 0:
            del entry["length"]  # unusable
        reports.append(entry)
    resp = {"datastore": {"reports": reports}}
    got = segments_from_response(resp)
    want = jax_batcher.segments_from_response(resp)
    assert [(k, s.to_bytes()) for k, s in got] == \
        [(k, s.to_bytes()) for k, s in want]
    assert 0 < len(got) < len(reports)
    assert segments_from_response(None) == []
    assert segments_from_response({"x": 1}) == []


# -- privacy cull ---------------------------------------------------------
def _segs(pairs):
    return [Segment(i, n, 10.0, 20.0, 100, 0) for i, n in pairs]


class TestPrivacyCull:
    @pytest.mark.parametrize("pairs,privacy,kept", [
        ([(1, 2)] * 3 + [(1, 3)] + [(2, 2)] * 2, 2, 5),   # below threshold
        ([(1, 2), (1, 3)], 1, 2),                         # privacy 1
        ([(1, 2)] * 4, 4, 4),                             # exactly at it
        ([(1, 2)] * 3, 4, 0),                             # one below
        ([(1, 2)] * 2 + [(1, 3)] * 2, 3, 0),              # runs don't merge
        ([(1, 2)] * 2 + [(1, 3)] * 2, 2, 4),
        ([(1, 2)] * 3 + [(1, 3)] * 2 + [(2, 4)] * 3, 3, 6),  # mixed
    ])
    def test_cull_equals_the_jax_package(self, pairs, privacy, kept):
        segs = sorted(_segs(pairs), key=Segment.sort_key)
        ref = sorted([jax_types.Segment(i, n, 10.0, 20.0, 100, 0)
                      for i, n in pairs], key=jax_types.Segment.sort_key)
        out = privacy_cull(segs, privacy)
        assert len(out) == kept
        assert [s.to_bytes() for s in out] == \
            [s.to_bytes() for s in jax_anon.privacy_cull(ref, privacy)]


def test_anonymiser_flush_writes_equal_tiles(tmp_path):
    """Seeded segments through both anonymisers: the same tile files
    (epoch names, CSV bytes), culls and slice rollover."""
    rng = np.random.default_rng(8)
    segs = []
    for _ in range(300):
        t0 = 1.5e9 + float(rng.uniform(0, 7000))
        segs.append(((int(rng.integers(0, 6)) << 25) | int(rng.integers(1, 4)),
                     int(rng.integers(1, 4)), t0,
                     t0 + float(rng.uniform(1, 200)), 300, 0))
    outs = []
    for name, (A, S, Seg) in {"jax": (jax_anon.Anonymiser, jax_anon.TileSink,
                                      jax_types.Segment),
                              "port": (Anonymiser, TileSink, Segment)}.items():
        a = A(S(str(tmp_path / name)), privacy=2, quantisation=900,
              source="src")
        for args in segs:
            s = Seg(*args)
            a.process(f"{s.id} {s.next_id}", s)
        assert a.punctuate() > 0
        assert a.punctuate() == 0 and a.flush_epoch == 2
        outs.append(tile_tree(str(tmp_path / name)))
    assert outs[0] == outs[1] and outs[1]


# -- batched flushes (the JAX package's tests/test_microbatch.py) ---------
def _feed(batcher, P, uuid, t0, n=8, step=0.0004, lat0=0.0):
    """n points 7 s apart: at n=8 about 310 m / 49 s, below the report
    trigger (500 m, 10 points, 60 s) but above the eviction gate; at
    n=14 with step 0.0006 past the trigger."""
    for i in range(n):
        batcher.process(uuid, P(lat=lat0 + i * step, lon=0.0, accuracy=10,
                                time=t0 + i * 7),
                        stream_time_ms=(t0 + i * 7) * 1000)


def _big(batcher, P, uuid, t0):
    _feed(batcher, P, uuid, t0, n=14, step=0.0006, lat0=14.6)


PKGS = {"jax": (jax_types.Point, jax_batcher.PointBatcher),
        "port": (Point, PointBatcher)}


def both(fn):
    """Run ``fn(Point, PointBatcher)`` for each package; the outcomes
    must be equal."""
    got = [fn(*PKGS[name]) for name in ("jax", "port")]
    assert got[0] == got[1], got
    return got[1]


def _bodies(bodies):
    """Uuid and points of each body, dict or columnar."""
    out = []
    for b in bodies:
        tr = b["trace"]
        out.append((b["uuid"], [(p["lat"], p["lon"], p["time"])
                                for p in tr]))
    return out


class TestMicrobatch:
    def test_punctuate_flushes_one_submit_many_call(self):
        def run(P, cls):
            calls, single = [], []
            b = cls(lambda body: single.append(body["uuid"]),
                    lambda k, s: None,
                    submit_many=lambda bodies: calls.append(
                        sorted(x["uuid"] for x in bodies))
                    or [None] * len(bodies))
            for j in range(5):
                _feed(b, P, f"veh-{j}", 1000)
            b.punctuate(stream_time_ms=(1000 + 8 * 7 + 120) * 1000)
            return calls, single, len(b.store)
        calls, single, left = both(run)
        assert calls == [[f"veh-{j}" for j in range(5)]]
        assert not single and left == 0

    def test_punctuate_bodies_carry_full_sessions(self):
        def run(P, cls):
            seen = []
            b = cls(lambda body: None, lambda k, s: None,
                    submit_many=lambda bodies: seen.extend(
                        _bodies(bodies)) or [None] * len(bodies))
            _feed(b, P, "veh-full", 1000)
            b.punctuate(stream_time_ms=10_000_000)
            return seen
        seen = both(run)
        assert len(seen) == 1 and len(seen[0][1]) == 8

    def test_punctuate_skips_below_relaxed_thresholds(self):
        def run(P, cls):
            calls = []
            b = cls(lambda body: None, lambda k, s: None,
                    submit_many=lambda bodies: calls.append(len(bodies))
                    or [None] * len(bodies))
            b.process("lonely", P(0.0, 0.0, 10, 1000), 1000 * 1000)
            b.punctuate(stream_time_ms=10_000_000)
            return calls, len(b.store)
        assert both(run) == ([], 0)

    def test_midstream_reports_flush_as_one_batch(self):
        def run(P, cls):
            calls, single = [], []
            b = cls(lambda body: single.append(body), lambda k, s: None,
                    submit_many=lambda bodies: calls.append(
                        sorted(x["uuid"] for x in bodies))
                    or [{"shape_used": 0} for _ in bodies])
            for j in range(4):
                _big(b, P, f"veh-{j}", 1000)
            pending = len(b.pending)
            b.flush_pending()
            return (calls, single, pending, len(b.pending),
                    all(x.points for x in b.store.values()))
        calls, single, pending, after, kept = both(run)
        assert calls == [[f"veh-{j}" for j in range(4)]]
        assert not single and pending == 4 and after == 0 and kept

    def test_failed_midstream_flush_requeues_not_drops(self):
        def run(P, cls):
            b = cls(lambda body: None, lambda k, s: None,
                    submit_many=lambda bodies: [None] * len(bodies),
                    retry_budget=2)
            for j in range(4):
                _big(b, P, f"veh-{j}", 1000)
            b.flush_pending()
            return (sorted(b.pending),
                    [(len(x.points), x.retries) for x in b.store.values()],
                    len(b._retrying))
        pending, state, retrying = both(run)
        assert pending == [f"veh-{j}" for j in range(4)]
        assert all(n and r == 1 for n, r in state) and retrying == 4

    def test_exhausted_budget_deadletters_trace_json(self, tmp_path):
        def run(P, cls):
            spool = str(tmp_path / cls.__module__ / "spool")
            b = cls(lambda body: None, lambda k, s: None,
                    submit_many=lambda bodies: [None] * len(bodies),
                    retry_budget=1, deadletter_dir=spool)
            _big(b, P, "veh-0", 1000)
            b.flush_pending()          # failure 1: requeued (budget 1)
            r1 = b.store["veh-0"].retries
            b.flush_pending()          # failure 2: dead-letter
            names = sorted(os.listdir(spool))
            with open(os.path.join(spool, names[0])) as f:
                body = f.read()
            return (r1, len(b.store["veh-0"].points),
                    b.store["veh-0"].retries, len(names),
                    names[0].split(".", 1)[1], body)
        r1, n, r2, files, suffix, body = both(run)
        assert (r1, n, r2, files, suffix) == (1, 0, 0, 1, "veh-0.json")
        assert json.loads(body)["match_options"]["report_levels"] == [0, 1]
        assert len(json.loads(body)["trace"]) >= 10

    def test_evicted_batch_failure_deadletters_immediately(self, tmp_path):
        def run(P, cls):
            spool = str(tmp_path / cls.__module__ / "spool")
            b = cls(lambda body: None, lambda k, s: None,
                    submit_many=lambda bodies: [None] * len(bodies),
                    retry_budget=5, deadletter_dir=spool)
            _feed(b, P, "veh-gone", 1000)
            b.punctuate(stream_time_ms=10_000_000)
            return ("veh-gone" in b.store, len(b.pending),
                    [n.split(".", 1)[1] for n in os.listdir(spool)])
        assert both(run) == (False, 0, ["veh-gone.json"])

    def test_pending_flush_trims_consumed_prefix(self):
        def run(P, cls):
            seen = []
            b = cls(lambda body: None, lambda k, s: None,
                    submit_many=lambda bodies: seen.extend(bodies)
                    or [{"shape_used": 5} for _ in bodies])
            _big(b, P, "veh-x", 1000)
            n_before = len(b.store["veh-x"].points)
            b.flush_pending()
            return len(seen), n_before - len(b.store["veh-x"].points)
        assert both(run) == (1, 5)

    def test_pending_autoflush_at_report_flush_size(self):
        def run(P, cls):
            calls = []
            b = cls(lambda body: None, lambda k, s: None,
                    submit_many=lambda bodies: calls.append(len(bodies))
                    or [None] * len(bodies), report_flush=3)
            for j in range(3):
                _big(b, P, f"veh-{j}", 1000)
            return calls[:1], len(b.pending)
        assert both(run) == ([3], 0)

    def test_punctuate_merges_pending_and_evictions_into_one_batch(self):
        def run(P, cls):
            calls = []
            b = cls(lambda body: None, lambda k, s: None,
                    submit_many=lambda bodies: calls.append(
                        sorted(x["uuid"] for x in bodies))
                    or [None] * len(bodies))
            _big(b, P, "live", 10_000_000)   # pending, recent
            _feed(b, P, "idle", 1000)        # below thresholds, stale
            b.punctuate(stream_time_ms=10_000_000 * 1000 + 14 * 7000 + 1)
            return calls
        assert both(run) == [["idle", "live"]]


class TestServiceBatches:
    """The batched submit through the port's dispatcher and service (the
    JAX package's test_microbatch.py cases on its ReporterService)."""

    def test_submit_many_failure_granularity(self):
        from reporter_tpu_torch.service.dispatch import BatchDispatcher

        def match_many(traces):
            if any(t.get("poison") for t in traces):
                raise RuntimeError("boom")
            return [{"segments": [], "mode": "auto"} for _ in traces]

        d = BatchDispatcher(match_many, max_batch=2, max_wait_ms=2000.0)
        try:
            traces = [{"uuid": "a"}, {"uuid": "b"},
                      {"uuid": "c", "poison": True}, {"uuid": "d"}]
            results = d.submit_many(traces, return_exceptions=True)
            assert results[:2] == [{"segments": [], "mode": "auto"}] * 2
            assert isinstance(results[2], RuntimeError)
            assert isinstance(results[3], RuntimeError)
            with pytest.raises(RuntimeError):
                d.submit_many([{"uuid": "x", "poison": True}])
        finally:
            d.close()

    def test_report_many_partial_failure_keeps_good_traces(self):
        class FakeMatcher:
            def match_many(self, traces):
                if any(t.get("poison") for t in traces):
                    raise RuntimeError("boom")
                return [{"segments": [], "mode": "auto"} for _ in traces]

        svc = ReporterService(FakeMatcher(), threshold_sec=15, max_batch=2,
                              max_wait_ms=2000.0)
        try:
            opts = {"report_levels": [0, 1], "transition_levels": [0, 1]}
            mk = lambda uuid, poison=False: {  # noqa: E731
                "uuid": uuid, "poison": poison, "match_options": opts,
                "trace": [{"lat": 0.0, "lon": 0.0, "time": 0},
                          {"lat": 0.0, "lon": 0.0, "time": 5}]}
            out = svc.report_many([mk("a"), mk("b"),
                                   mk("c", poison=True), mk("d")])
            assert out[0] is not None and out[1] is not None
            assert "datastore" in out[0]
            assert out[2] is None and out[3] is None
        finally:
            svc.dispatcher.close()

    def test_eviction_batch_reaches_matcher_as_one_call(self):
        """Six sessions evicted in one punctuate decode as ONE matcher
        batch in both packages, and forward the same segment pairs."""
        forwarded = {}
        for name in ("jax", "port"):
            if name == "jax":
                city = jax_city(rows=8, cols=8, spacing_m=200.0, seed=6)
                matcher = JaxMatcher(net=city)
                P, cls, make, svc_cls = (jax_types.Point,
                                         jax_batcher.PointBatcher,
                                         jax_trace, JaxService)
            else:
                city = build_grid_city(rows=8, cols=8, spacing_m=200.0,
                                       seed=6)
                matcher = SegmentMatcher(city, device="cpu")
                P, cls, make, svc_cls = (Point, PointBatcher,
                                         generate_trace, ReporterService)
            sizes = []
            real = matcher.match_many
            matcher.match_many = lambda traces, _r=real: (
                sizes.append(len(traces)) or _r(traces))
            service = svc_cls(matcher, max_wait_ms=200.0)
            out = []
            b = cls(lambda t: None, lambda k, s: out.append(
                (k, s.to_bytes())), report_on="0,1,2",
                transition_on="0,1,2", submit_many=service.report_many)
            rng = np.random.default_rng(4)
            made = 0
            while made < 6:
                tr = make(city, f"veh-{made}", rng, noise_m=3.0,
                          min_route_edges=8, max_route_edges=20)
                if tr is None or len(tr.points) < 12:
                    continue
                t0 = tr.points[0]["time"]
                for p in tr.points:
                    pt = P(lat=p["lat"], lon=p["lon"], accuracy=10,
                           time=int(1000 + p["time"] - t0))
                    b.process(f"veh-{made}", pt,
                              stream_time_ms=int(pt.time) * 1000)
                made += 1
            sizes.clear()
            b.punctuate(stream_time_ms=10_000_000_000)
            service.dispatcher.close()
            assert sizes == [6] and not b.store
            forwarded[name] = out
        assert forwarded["port"] == forwarded["jax"] and forwarded["port"]


# -- the worker -----------------------------------------------------------
def test_replay_writes_tiles(tmp_path):
    """Six vehicles through StreamWorker + inproc_submitter in both
    packages (the reference's tests/circle.sh asserts): equal tile
    trees, with the reference's CSV header and 10 columns a row."""
    trees = []
    for name in ("jax", "port"):
        if name == "jax":
            city = jax_city(rows=10, cols=10, spacing_m=200.0, seed=5,
                            service_road_fraction=0.0,
                            internal_fraction=0.0)
            service = JaxService(JaxMatcher(net=city), threshold_sec=15,
                                 max_batch=64, max_wait_ms=5.0)
            mods = (jax_worker, jax_formatter.Formatter, jax_anon)
            make = jax_trace
        else:
            city = build_grid_city(rows=10, cols=10, spacing_m=200.0,
                                   seed=5, service_road_fraction=0.0,
                                   internal_fraction=0.0)
            service = ReporterService(SegmentMatcher(city, device="cpu"),
                                      threshold_sec=15, max_batch=64,
                                      max_wait_ms=5.0)
            mods = (worker, Formatter, port_anon)
            make = generate_trace
        rng = np.random.default_rng(9)
        lines = []
        for i in range(6):
            tr = None
            while tr is None:
                tr = make(city, f"veh-{i}", rng, noise_m=3.0,
                          min_route_edges=8)
            lines += ["|".join(["x", tr.uuid, str(p["lat"]), str(p["lon"]),
                                str(p["time"]), str(p["accuracy"])])
                      for p in tr.points]
        out = str(tmp_path / name)
        w = mods[0].StreamWorker(
            mods[1].from_config(",sv,\\|,1,2,3,4,5"),
            mods[0].inproc_submitter(service),
            mods[2].Anonymiser(mods[2].TileSink(out), privacy=1,
                               quantisation=3600, source="test"),
            flush_interval_s=1e9)
        w.run(lines)
        service.dispatcher.close()
        assert w.processed == len(lines) and w.parse_failures == 0
        trees.append(tile_tree(out))
    assert trees[0] == trees[1]
    assert trees[1], "no tiles written"
    for body in trees[1].values():
        rows = body.decode().split("\n")
        assert rows[0] == Segment.column_layout()
        assert all(len(r.split(",")) == 10 and r.endswith(",test,AUTO")
                   for r in rows[1:])


@pytest.fixture(scope="module")
def city_stream(tmp_path_factory):
    """The 12x12 city (seed 7), saved, and 16 vehicles' stream in a
    file: both packages' synth give the same probes."""
    root = tmp_path_factory.mktemp("stream")
    city = build_grid_city(**CITY)
    path = str(root / "city.npz")
    city.save(path)
    lines = stream_lines(city, generate_trace, 16, seed=7)
    assert lines == stream_lines(jax_city(**CITY), jax_trace, 16, seed=7)
    stream = str(root / "stream.txt")
    with open(stream, "w") as f:
        f.write("\n".join(lines) + "\n")
    return root, path, stream, len(lines)


def worker_args(graph, stream, out, *extra):
    return ["-f", SV, "--graph", graph, "-p", "1", "-q", "3600",
            "-i", "1000000000", "-s", "t", "-o", out, "--input", stream,
            "-r", "0,1,2", "-x", "0,1,2", "--report-flush-interval", "0",
            *extra]


@pytest.mark.parametrize("incremental", [True, False])
def test_worker_main_tiles_equal_the_jax_workers(city_stream, tmp_path,
                                                 monkeypatch, incremental):
    """The headline parity: one stream through the JAX package's
    ``streaming.worker.main`` (CPU, ``--uuid-filter off``) and the port's
    ``main --device cpu``: the same tile files, byte for byte. Reports
    flush as soon as a session crosses the thresholds, so each uuid's
    carried decode state advances over several reports."""
    root, graph, stream, n = city_stream
    monkeypatch.setenv("REPORTER_TPU_INCREMENTAL", "1" if incremental
                       else "0")
    ref = str(tmp_path / "jax")
    assert jax_worker.main(worker_args(graph, stream, ref,
                                       "--uuid-filter", "off")) == 0
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"service": {"incremental": incremental}}))
    out = str(tmp_path / "port")
    served0 = metrics.counter("match.incremental.matches")
    assert worker.main(worker_args(graph, stream, out, "--config",
                                   str(conf), "--device", "cpu")) == 0
    want, got = tile_tree(ref), tile_tree(out)
    assert got == want and len(got) >= 2
    served = metrics.counter("match.incremental.matches") - served0
    assert (served > 0) == incremental


def test_worker_main_refuses_a_bad_config_and_a_missing_card(city_stream,
                                                             tmp_path):
    import torch
    root, graph, stream, _n = city_stream
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"worker": {"heartbeat": 1}}))
    out = str(tmp_path / "out")
    assert worker.main(worker_args(graph, stream, out, "--config",
                                   str(conf))) == 1
    conf.write_text(json.dumps({"service": {"threshold": 1}}))
    assert worker.main(worker_args(graph, stream, out, "--config",
                                   str(conf))) == 1
    if not torch.cuda.is_available():
        assert worker.main(worker_args(graph, stream, out)) == 1
    assert not tile_tree(out)


def test_worker_config_keys_reach_the_worker(city_stream, tmp_path):
    """The ``worker`` block's knobs land on StreamWorker, the governor,
    the anonymiser and the sink; the ``service`` block's on the matcher
    (``incremental_lag``) and the process (``faults``)."""
    _root, graph, _stream, _n = city_stream
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({
        "graph": graph,
        "service": {"incremental_lag": 8},
        "worker": {"heartbeat_s": 0.5, "retry_budget": 4,
                   "backpressure": False, "backpressure_latency_s": 2.0,
                   "writer_id": "w7", "replay_interval_s": 3.0,
                   "replay_attempts": 9, "aws_access_key_id": "AK",
                   "aws_secret_access_key": "SK",
                   "session_gap_ms": 1000}}))
    conf_parsed, knobs = worker.read_worker_config(str(conf))
    assert conf_parsed["matcher"] == {"incremental_lag": 8}
    assert knobs["writer_id"] == "w7" and len(knobs) == 10
    assert set(knobs) == set(worker.WORKER_KEYS)
    graph2 = str(tmp_path / "other.npz")
    assert worker.read_worker_config(str(conf), graph2)[0]["graph"] == graph2
