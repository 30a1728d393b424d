"""The port's freshness tier (``reporter_tpu_torch.datastore.freshness``
and ``.feed``: the recent-delta overlay and ``window=`` queries, the
change feed's cursor, long-poll and shedding, the viewport summaries,
``/feed`` and ``/histogram?window=`` over HTTP, the CLI's ``--window``
and ``feed``, and the worker tee's flush reaching the feed) against the
JAX package's.

The first part runs the JAX package's own freshness cases (its
``tests/test_freshness.py``, less the benchmark-artifact cases of the
feed fan-out ledger, which read the TPU round's ``BENCH_*`` files) as
cases over both packages, bound by the ``pkg`` fixture as in
``test_torch_datastore.py``. Every long-poll runs with a timeout of at
most 1 s on the real clock; arrivals run on the injected ``_Clock``. The
JAX package's ``REPORTER_TPU_FRESHNESS=0`` is the port's
``LocalDatastore(freshness=False)``. The second part drives both
packages with the same ingests under one fake clock and holds the
cursors, events, windows and viewport summaries equal.
"""
import json
import math
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from reporter_tpu_torch.core.osmlr import make_segment_id
# the package binding (the ``pkg`` fixture) and the JAX cases' shared
# helpers live in test_torch_datastore.py
from test_torch_datastore import (  # noqa: F401  (pkg: a fixture)
    MON_8AM,
    SID,
    _imp,
    _jax,
    _matcher,
    _segs,
    pkg,
)


def _store_without_tier(root):
    """A store whose freshness tier is off: the JAX package's
    REPORTER_TPU_FRESHNESS (set by the case), the port's argument."""
    if _jax():
        return LocalDatastore(str(root))
    return LocalDatastore(str(root), freshness=False)


# ---- the JAX package's cases, over both packages ---------------------------

WORLD = [-180.0, -90.0, 180.0, 90.0]


def _delta(n=3, **kw):
    """One aggregated partition delta for overlay/feed unit tests."""
    return aggregate(ObservationBatch.from_segments(_segs(n, **kw)))[
        (2, 756425)]


class _Clock:
    """Injectable arrival clock (the feed/poll timeouts deliberately
    ignore it — they are wall-clock, so freezing this cannot hang)."""

    def __init__(self, t=float(MON_8AM)):
        self.t = float(t)

    def __call__(self):
        return self.t


@pytest.mark.usefixtures("pkg")
class TestParseWindow:
    def test_spellings(self):
        assert parse_window(300) == 300.0
        assert parse_window("300") == 300.0
        assert parse_window("90s") == 90.0
        assert parse_window("5m") == 300.0
        assert parse_window("2h") == 7200.0
        assert parse_window("1d") == 86400.0
        for inf in ("inf", "INF", "infinity", "∞"):
            assert math.isinf(parse_window(inf))

    def test_rejects_junk(self):
        for bad in ("bogus", "", "nan", "-5", 0, -1, "5x"):
            with pytest.raises(ValueError):
                parse_window(bad)


@pytest.mark.usefixtures("pkg")
class TestOverlay:
    def test_dedupe_by_ingest_key(self):
        ov = RecentDeltaOverlay(budget_bytes=1 << 20, clock=_Clock())
        assert ov.record(2, 756425, _delta(), "flush-1") is not None
        assert ov.record(2, 756425, _delta(), "flush-1") is None
        assert ov.snapshot()["entries"] == 1
        # keyless (ad-hoc CSV) ingests have no cross-restart identity:
        # each records
        assert ov.record(2, 756425, _delta(), None) is not None
        assert ov.record(2, 756425, _delta(), None) is not None
        assert ov.snapshot()["entries"] == 3

    def test_in_store_upgrade_on_dedupe(self):
        ov = RecentDeltaOverlay(budget_bytes=1 << 20, clock=_Clock())
        e = ov.record(2, 756425, _delta(), "spooled", in_store=False)
        assert e.in_store is False
        # the dead-letter replay re-offers the same key after its
        # append commits: the no-op still flips the entry to committed
        assert ov.record(2, 756425, _delta(), "spooled",
                         in_store=True) is None
        assert e.in_store is True

    def test_window_deltas_age_out(self):
        clk = _Clock()
        ov = RecentDeltaOverlay(budget_bytes=1 << 20, clock=clk)
        ov.record(2, 756425, _delta(), "f1")
        assert list(ov.window_deltas(300.0)) == [(2, 756425)]
        clk.t += 301.0
        assert ov.window_deltas(300.0) == {}
        assert math.isinf(parse_window("inf"))  # inf never ages out

    def test_eviction_bounds_bytes(self):
        ov = RecentDeltaOverlay(budget_bytes=2000, clock=_Clock())
        before = metrics.default.counter("overlay.evicted")
        for i in range(16):
            ov.record(2, 756425, _delta(), f"flush-{i}")
        snap = ov.snapshot()
        assert snap["evicted"] > 0
        assert snap["bytes"] <= 2000
        assert snap["entries"] >= 1  # never evicts to empty
        assert metrics.default.counter("overlay.evicted") \
            == before + snap["evicted"]


@pytest.mark.usefixtures("pkg")
class TestWindowQueries:
    def test_windowless_byte_identity(self, tmp_path, monkeypatch):
        """window=None never touches the tier: answers are
        byte-identical to a store where the tier is gate-disabled."""
        ds_on = LocalDatastore(str(tmp_path / "on"))
        assert ds_on.enable_freshness() is not None
        monkeypatch.setenv("REPORTER_TPU_FRESHNESS", "0")
        ds_off = _store_without_tier(tmp_path / "off")
        assert ds_off.enable_freshness() is None
        for ds in (ds_on, ds_off):
            ds.ingest_segments(_segs(20), ingest_key="seed")
        a = json.dumps(ds_on.query(SID), sort_keys=True)
        b = json.dumps(ds_off.query(SID), sort_keys=True)
        assert a == b
        a = json.dumps(ds_on.query_bbox(WORLD, 2), sort_keys=True)
        b = json.dumps(ds_off.query_bbox(WORLD, 2), sort_keys=True)
        assert a == b

    def test_finite_window_sees_recent_only(self, tmp_path):
        clk = _Clock()
        ds = LocalDatastore(str(tmp_path))
        ds.enable_freshness(clock=clk)
        ds.ingest_segments(_segs(5), ingest_key="f1")
        assert ds.query(SID, window="5m")["count"] == 5
        assert ds.query(SID, window=60)["count"] == 5
        clk.t += 600.0
        assert ds.query(SID, window="5m")["count"] == 0
        # the durable store is unaffected by overlay aging
        assert ds.query(SID)["count"] == 5

    def test_inf_parity_after_flush_and_compact(self, tmp_path):
        """The acceptance pin: once every append committed and a
        compaction ran, window=∞ is byte-identical to the plain
        query."""
        ds = LocalDatastore(str(tmp_path))
        ds.enable_freshness()
        ds.ingest_segments(_segs(7), ingest_key="a")
        ds.ingest_segments(_segs(4, t0=MON_8AM + 3600), ingest_key="b")
        ds.compact()
        plain = json.dumps(ds.query(SID), sort_keys=True)
        merged = json.dumps(ds.query(SID, window="inf"), sort_keys=True)
        assert merged == plain
        plain = json.dumps(ds.query_bbox(WORLD, 2), sort_keys=True)
        merged = json.dumps(ds.query_bbox(WORLD, 2, window="inf"),
                            sort_keys=True)
        assert merged == plain

    def test_inf_serves_uncommitted_until_replay_lands(self, tmp_path):
        """A spooled flush (append failed -> in_store=False) exists only
        in the overlay: window=∞ must serve it on top of the compacted
        store, and stop the moment the dead-letter replay commits."""
        ds = LocalDatastore(str(tmp_path))
        tier = ds.enable_freshness()
        ds.ingest_segments(_segs(5), ingest_key="committed")
        tier.overlay.record(2, 756425, _delta(3, t0=MON_8AM + 3600),
                            "spooled-flush", in_store=False)
        assert ds.query(SID)["count"] == 5
        assert ds.query(SID, window="inf")["count"] == 8
        # the replay lands (same ledger key): ∞ converges back
        ds.ingest_segments(_segs(3, t0=MON_8AM + 3600),
                           ingest_key="spooled-flush")
        assert ds.query(SID)["count"] == 8
        assert json.dumps(ds.query(SID, window="inf"), sort_keys=True) \
            == json.dumps(ds.query(SID), sort_keys=True)

    def test_crash_restart_replay_never_double_counts(self, tmp_path):
        """A restarted tee replays its flushes with the same ingest
        keys: the store ledger dedupes on disk, the fresh overlay
        records each replayed delta as already-committed — so merged
        ∞ reads stay byte-identical to compacted-only."""
        ds = LocalDatastore(str(tmp_path))
        ds.enable_freshness()
        for i in range(3):
            ds.ingest_segments(_segs(4, t0=MON_8AM + i * 60),
                               ingest_key=f"flush-{i}")
        rows_before = ds.stats()["rows"]
        # "crash": a new process = new store handle + empty overlay
        ds2 = LocalDatastore(str(tmp_path))
        tier2 = ds2.enable_freshness()
        for i in range(3):  # the replay
            ds2.ingest_segments(_segs(4, t0=MON_8AM + i * 60),
                                ingest_key=f"flush-{i}")
        assert ds2.stats()["rows"] == rows_before
        assert json.dumps(ds2.query(SID, window="inf"), sort_keys=True) \
            == json.dumps(ds2.query(SID), sort_keys=True)
        # a second replay of the same keys no-ops in the overlay too
        n = tier2.overlay.snapshot()["entries"]
        ds2.ingest_segments(_segs(4), ingest_key="flush-0")
        assert tier2.overlay.snapshot()["entries"] == n

    def test_window_without_tier(self, tmp_path, monkeypatch):
        """Gate-disabled: ∞ degrades to the plain store (the overlay
        would add nothing), finite windows are empty (this process has
        witnessed no recent ingests), windowless untouched."""
        monkeypatch.setenv("REPORTER_TPU_FRESHNESS", "off")
        ds = _store_without_tier(tmp_path)
        ds.ingest_segments(_segs(5))
        assert ds.query(SID, window="inf")["count"] == 5
        assert ds.query(SID, window="5m")["count"] == 0
        assert ds.query(SID)["count"] == 5


@pytest.mark.usefixtures("pkg")
class TestChangeFeed:
    def _feed(self, **kw):
        return ChangeFeed(store=None, clock=_Clock(), **kw)

    def test_cursor_monotone_and_from_now(self):
        feed = self._feed()
        for i in range(3):
            feed._publish("delta", 2, 756425, [SID], False, 1)
        out = feed.poll(cursor=0, timeout_s=0)
        assert [e["seq"] for e in out["events"]] == [1, 2, 3]
        assert out["cursor"] == 3 and not out["resync"]
        # nothing past the returned cursor
        again = feed.poll(cursor=out["cursor"], timeout_s=0)
        assert again["events"] == [] and again["timeout"]
        # cursor=-1 means "from now": the 3 old events are skipped
        assert feed.poll(cursor=-1, timeout_s=0)["events"] == []

    def test_ring_overflow_is_explicit_resync(self):
        feed = self._feed(ring_events=2)
        for _ in range(5):
            feed._publish("delta", 2, 756425, [SID], False, 1)
        out = feed.poll(cursor=0, timeout_s=0)
        assert out["resync"] is True  # loss is never silent
        assert [e["seq"] for e in out["events"]] == [4, 5]
        # a cursor inside the ring does not resync
        assert feed.poll(cursor=4, timeout_s=0)["resync"] is False

    def test_bbox_filter(self):
        feed = self._feed()
        feed._publish("delta", 2, 756425, [SID], False, 1)
        hit = feed.poll(bbox=WORLD, level=2, cursor=0, timeout_s=0)
        assert len(hit["events"]) == 1
        # a far-away viewport sees nothing (but the cursor advances
        # with the ring so the subscriber never replays the miss)
        miss = feed.poll(bbox=[0.0, 0.0, 0.1, 0.1], level=2, cursor=0,
                         timeout_s=0)
        assert miss["events"] == []
        with pytest.raises(ValueError):
            feed.poll(bbox=WORLD, cursor=0, timeout_s=0)  # needs level

    def test_delta_events_carry_map_version(self, tmp_path):
        """A stamped store's ingest hook threads the active epoch into
        every delta event."""
        ds = LocalDatastore(str(tmp_path))
        tier = ds.enable_freshness()
        ds.set_map_version("aaaa00000001")
        ds.ingest_segments(_segs(2), ingest_key="k1")
        out = tier.feed.poll(cursor=0, timeout_s=0)
        (ev,) = out["events"]
        assert ev["kind"] == "delta"
        assert ev["map_version"] == "aaaa00000001"

    def test_epoch_event_bypasses_viewport_filters(self):
        """publish_epoch announces a map flip to EVERY subscriber —
        whatever bbox/level a dashboard watches, its history predates
        the new map, so the event must reach it."""
        metrics = _imp("utils", "metrics")
        c0 = metrics.default.counter("datastore.epoch.events")
        feed = self._feed()
        feed.publish_epoch("bbbb00000002")
        assert metrics.default.counter(
            "datastore.epoch.events") == c0 + 1
        # a far-away viewport that filters out every delta still sees
        # the epoch boundary
        out = feed.poll(bbox=[0.0, 0.0, 0.1, 0.1], level=2, cursor=0,
                        timeout_s=0)
        (ev,) = out["events"]
        assert ev["kind"] == "epoch"
        assert ev["map_version"] == "bbbb00000002"
        assert ev["segments"] == [] and ev["rows"] == 0

    def test_waiter_cap_sheds_explicitly(self):
        feed = self._feed(max_waiters_n=0)
        with pytest.raises(FeedOverload) as exc:
            feed.poll(cursor=0, timeout_s=0)
        assert exc.value.reason == "feed_waiters"
        assert exc.value.retry_after_s >= 1
        assert feed.snapshot()["shed"] == 1

    def test_condition_notified_delivery(self, tmp_path):
        """The no-sleep-polling pin: a blocked poll is woken by the
        ingest hook's condition notify, not by a timer — delivery
        latency is a small fraction of the poll timeout."""
        ds = LocalDatastore(str(tmp_path))
        tier = ds.enable_freshness()
        got = {}

        def subscribe():
            t0 = time.monotonic()
            got["out"] = tier.feed.poll(bbox=WORLD, level=2, cursor=0,
                                        timeout_s=1)
            got["elapsed"] = time.monotonic() - t0

        th = threading.Thread(target=subscribe)
        th.start()
        deadline = time.monotonic() + 1
        while tier.feed.snapshot()["waiters"] == 0:
            assert time.monotonic() < deadline, "subscriber never waited"
            time.sleep(0.005)
        ds.ingest_segments(_segs(3), ingest_key="live")
        th.join(timeout=1)
        assert not th.is_alive()
        assert got["elapsed"] < 1.0
        (ev,) = got["out"]["events"]
        assert ev["kind"] == "delta" and ev["tile_index"] == 756425
        assert SID in ev["segments"] and ev["rows"] == 3

    def test_store_watcher_cross_process(self, tmp_path):
        """A second store handle on the same root (the pre-fork fleet
        shape): its feed surfaces the writer's commits as tile events
        via the manifest-seq diff — after a silent baseline scan."""
        writer = LocalDatastore(str(tmp_path))
        writer.ingest_segments(_segs(2), ingest_key="old")
        reader = LocalDatastore(str(tmp_path))
        tier = reader.enable_freshness()
        # first scan baselines: history is not replayed
        assert tier.feed.watch_store(force=True) == 0
        writer.ingest_segments(_segs(3, t0=MON_8AM + 3600),
                               ingest_key="new")
        assert tier.feed.watch_store(force=True) == 1
        (ev,) = tier.feed.poll(cursor=0, timeout_s=0)["events"]
        assert ev["kind"] == "tile" and ev["tile_index"] == 756425
        assert ev["segments"] == []  # sweep the tile, ids unknown here


@pytest.mark.usefixtures("pkg")
class TestViewportSummaries:
    def test_compactor_pass_materialises(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        tier = ds.enable_freshness()
        ds.ingest_segments(_segs(20), ingest_key="seed")
        BackgroundCompactor(ds).run_once()
        assert tier.viewports.snapshot() == {"tiles": 1, "refreshes": 1}
        out = tier.viewports.summarise(WORLD, 2)
        assert out["n_tiles"] == 1 and out["count"] == 20
        (tile,) = out["tiles"]
        assert tile["tile_index"] == 756425 and tile["n_segments"] == 1
        assert tile["mean_kph"] == pytest.approx(36.0)
        assert sum(tile["histogram"]["counts"]) == 20

    def test_refresh_memoised_by_manifest_seq(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        tier = ds.enable_freshness()
        ds.ingest_segments(_segs(5), ingest_key="a")
        assert tier.viewports.refresh()["refreshed"] == 1
        assert tier.viewports.refresh()["refreshed"] == 0  # unchanged
        ds.ingest_segments(_segs(5, t0=MON_8AM + 60), ingest_key="b")
        assert tier.viewports.refresh()["refreshed"] == 1
        assert tier.viewports.summarise(WORLD, 2)["count"] == 10

    def test_empty_viewport(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        tier = ds.enable_freshness()
        out = tier.viewports.summarise(WORLD, 2)
        assert out == {"bbox": WORLD, "level": 2, "n_tiles": 0,
                       "count": 0, "tiles": []}


class _StubMatcher:
    def match_many(self, traces):
        return [[] for _ in traces]


@pytest.fixture
def fresh_server(pkg, tmp_path):
    """A served stack with the freshness tier live: the store's ingests
    happen IN the serving process, so finite windows and delta events
    work (the co-located-tee shape)."""
    ReporterService = _imp("service.server", "ReporterService")
    serve = _imp("service.server", "serve")
    ds = LocalDatastore(str(tmp_path / "store"))
    ds.enable_freshness()
    ds.ingest_segments(_segs(20), ingest_key="seed-flush")
    service = ReporterService(_StubMatcher(), datastore=ds)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = serve(service, "127.0.0.1", port)
    yield f"http://127.0.0.1:{port}", ds
    httpd.shutdown()


def _get(url):
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


@pytest.mark.usefixtures("pkg")
class TestFreshnessHTTP:
    def test_window_param(self, fresh_server):
        url, _ds = fresh_server
        code, body, _ = _get(f"{url}/histogram?segment_id={SID}&window=5m")
        assert code == 200 and body["count"] == 20
        code, body, _ = _get(f"{url}/histogram?bbox=-180,-90,180,90"
                             "&level=2&window=300s")
        assert code == 200 and body["segments"][0]["count"] == 20

    def test_inf_window_byte_identical_over_http(self, fresh_server):
        url, _ds = fresh_server
        plain = urllib.request.urlopen(
            f"{url}/histogram?segment_id={SID}").read()
        merged = urllib.request.urlopen(
            f"{url}/histogram?segment_id={SID}&window=inf").read()
        assert merged == plain

    def test_bad_window_400(self, fresh_server):
        url, _ds = fresh_server
        code, body, _ = _get(f"{url}/histogram?segment_id={SID}"
                             "&window=fortnight")
        assert code == 400 and "window" in body["error"]

    def test_viewport_summaries(self, fresh_server):
        url, _ds = fresh_server
        code, body, _ = _get(f"{url}/histogram?viewport=1"
                             "&bbox=-180,-90,180,90&level=2")
        assert code == 200
        assert body["n_tiles"] == 1 and body["count"] == 20
        code, body, _ = _get(f"{url}/histogram?viewport=1")
        assert code == 400 and "bbox" in body["error"]

    def test_feed_delivers_seed_events(self, fresh_server):
        url, _ds = fresh_server
        code, body, _ = _get(f"{url}/feed?cursor=0&timeout=0.2"
                             "&bbox=-180,-90,180,90&level=2")
        assert code == 200
        (ev,) = body["events"]
        assert ev["kind"] == "delta" and SID in ev["segments"]
        assert body["cursor"] == ev["seq"]

    def test_feed_long_poll_end_to_end(self, fresh_server):
        """The e2e freshness proof at the HTTP surface: an open /feed
        cursor is delivered the ingest the moment it lands (condition
        notify through the whole stack), and ``window=5m`` serves the
        same rows immediately after."""
        url, ds = fresh_server
        cur = ds.freshness.feed.cursor
        got = {}

        def subscribe():
            t0 = time.monotonic()
            got["resp"] = _get(f"{url}/feed?cursor={cur}&timeout=1"
                               "&bbox=-180,-90,180,90&level=2")
            got["elapsed"] = time.monotonic() - t0

        th = threading.Thread(target=subscribe)
        th.start()
        deadline = time.monotonic() + 1
        while ds.freshness.feed.snapshot()["waiters"] == 0:
            assert time.monotonic() < deadline, "no waiter registered"
            time.sleep(0.005)
        ds.ingest_segments(_segs(5, t0=MON_8AM + 7200),
                           ingest_key="live-flush")
        th.join(timeout=1)
        assert not th.is_alive() and got["elapsed"] < 1.0
        code, body, _ = got["resp"]
        assert code == 200
        (ev,) = body["events"]
        assert ev["kind"] == "delta" and ev["rows"] == 5
        code, body, _ = _get(f"{url}/histogram?segment_id={SID}"
                             "&window=5m")
        assert code == 200 and body["count"] == 25

    def test_feed_waiter_shed_429_retry_after(self, fresh_server):
        url, ds = fresh_server
        feed = ds.freshness.feed
        old = feed.max_waiters
        feed.max_waiters = 0
        try:
            code, body, headers = _get(f"{url}/feed?cursor=0&timeout=0.1")
            assert code == 429
            assert body["reason"] == "feed_waiters"
            assert headers.get("Retry-After") == str(body["retry_after_s"])
        finally:
            feed.max_waiters = old

    def test_feed_pressure_shed_before_match_path(self, fresh_server):
        """At the FEED_SHED_LEVEL rung the feed
        sheds subscribers with the explicit 429 + Retry-After contract
        — fan-out is the first load dropped under pressure."""
        admission = _imp("service", "admission")
        url, _ds = fresh_server
        lad = admission.ladder()
        lad.level = 2
        try:
            code, body, headers = _get(f"{url}/feed?cursor=0&timeout=0.1")
            assert code == 429 and body["reason"] == "pressure"
            assert "Retry-After" in headers
        finally:
            admission._reset_module()

    def test_health_freshness_block(self, fresh_server):
        url, ds = fresh_server
        snap = ds.freshness.snapshot()
        assert snap["overlay"]["entries"] == 1
        assert snap["feed"]["cursor"] >= 1
        assert set(snap) == {"overlay", "feed", "viewports"}


@pytest.mark.usefixtures("pkg")
class TestFreshnessCLI:
    def _seed(self, tmp_path, n=5):
        ds = LocalDatastore(str(tmp_path / "s"))
        ds.enable_freshness()
        ds.ingest_segments(_segs(n), ingest_key="cli-seed")
        return ds

    def test_query_window_inf_cross_process(self, tmp_path, capsys):
        datastore_cli = _imp("tools", "datastore_cli")
        self._seed(tmp_path)
        assert datastore_cli.main(
            ["query", str(tmp_path / "s"), "--segment", str(SID),
             "--window", "inf"]) == 0
        got = json.loads(capsys.readouterr().out.strip())
        assert got["count"] == 5

    def test_query_finite_window_needs_colocated_tee(self, tmp_path,
                                                     capsys):
        # a fresh CLI process has witnessed no recent ingests: finite
        # windows are empty there (documented), ∞/windowless are not
        datastore_cli = _imp("tools", "datastore_cli")
        self._seed(tmp_path)
        assert datastore_cli.main(
            ["query", str(tmp_path / "s"), "--segment", str(SID),
             "--window", "5m"]) == 0
        assert json.loads(capsys.readouterr().out.strip())["count"] == 0

    def test_query_bad_window_exits_cleanly(self, tmp_path, capsys):
        datastore_cli = _imp("tools", "datastore_cli")
        self._seed(tmp_path)
        with pytest.raises(SystemExit):
            datastore_cli.main(["query", str(tmp_path / "s"),
                                "--segment", str(SID),
                                "--window", "fortnight"])

    def test_feed_tails_cross_process_commits(self, tmp_path, capsys):
        """`datastore feed` long-polls a store another handle is
        writing to: the in-poll store watcher surfaces the commit as a
        tile event before the poll times out."""
        datastore_cli = _imp("tools", "datastore_cli")
        writer = self._seed(tmp_path)

        def late_ingest():
            time.sleep(0.4)  # after the feed's baseline scan
            writer.ingest_segments(_segs(3, t0=MON_8AM + 3600),
                                   ingest_key="late")

        th = threading.Thread(target=late_ingest)
        th.start()
        try:
            assert datastore_cli.main(
                ["feed", str(tmp_path / "s"), "--cursor", "0",
                 "--timeout", "1", "--max-polls", "1"]) == 0
        finally:
            th.join()
        got = json.loads(capsys.readouterr().out.strip())
        assert got["events"], "commit not delivered within one poll"
        assert got["events"][0]["kind"] == "tile"
        assert got["events"][0]["tile_index"] == 756425

    def test_feed_timeout_line(self, tmp_path, capsys):
        datastore_cli = _imp("tools", "datastore_cli")
        self._seed(tmp_path)
        assert datastore_cli.main(
            ["feed", str(tmp_path / "s"), "--cursor", "-1",
             "--timeout", "0.05", "--max-polls", "2"]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 2
        for line in lines:
            got = json.loads(line)
            assert got["timeout"] is True and got["events"] == []


@pytest.mark.usefixtures("pkg")
class TestWorkerTeeFreshness:
    """The acceptance proof at the real producer: a probe
    flushed by a StreamWorker's tee is (a) delivered on an open /feed
    cursor and (b) visible via window=5m — within one tee cycle, with
    delivery via condition notify (the subscriber blocks in poll(),
    never sleep-polls), while windowless queries stay untouched."""

    def test_tee_flush_reaches_feed_and_window(self, tmp_path):
        SegmentMatcher = _imp("matcher", "SegmentMatcher")
        ReporterService = _imp("service.server", "ReporterService")
        Anonymiser = _imp("streaming.anonymiser", "Anonymiser")
        TileSink = _imp("streaming.anonymiser", "TileSink")
        Formatter = _imp("streaming.formatter", "Formatter")
        StreamWorker = _imp("streaming.worker", "StreamWorker")
        inproc_submitter = _imp("streaming.worker", "inproc_submitter")
        build_grid_city = _imp("synth", "build_grid_city")
        generate_trace = _imp("synth", "generate_trace")

        city = build_grid_city(rows=10, cols=10, spacing_m=200.0, seed=5,
                               service_road_fraction=0.0,
                               internal_fraction=0.0)
        service = ReporterService(_matcher(city),
                                  threshold_sec=15, max_batch=64,
                                  max_wait_ms=5.0)
        store = LocalDatastore(str(tmp_path / "store"))
        tier = store.enable_freshness()

        rng = np.random.default_rng(9)
        lines = []
        for i in range(6):
            tr = None
            while tr is None:
                tr = generate_trace(city, f"veh-{i}", rng, noise_m=3.0,
                                    min_route_edges=8)
            for p in tr.points:
                lines.append("|".join([
                    "x", tr.uuid, str(p["lat"]), str(p["lon"]),
                    str(p["time"]), str(p["accuracy"])]))

        # the worker's matching runs before the cursor opens, so that no
        # poll waits out a CPU match: its tee records each flush, and
        # the recorded flushes are ingested while the cursor is open
        flushes = []

        def tee(_tile, segments, ingest_key=None):
            flushes.append((segments, ingest_key))

        def run_worker(out_dir):
            anon = Anonymiser(TileSink(str(tmp_path / out_dir)),
                              privacy=1, quantisation=3600,
                              source="test", tee=tee)
            worker = StreamWorker(
                Formatter.from_config(",sv,\\|,1,2,3,4,5"),
                inproc_submitter(service), anon, flush_interval_s=1e9)
            worker.run(lines)
            assert worker.parse_failures == 0

        # the open cursor: subscribed BEFORE any flush lands (no bbox
        # filter — the synthetic city's segments live at level 1 and
        # viewport filtering has its own tests)
        got = {}

        def subscribe():
            got["out"] = tier.feed.poll(cursor=0, timeout_s=1)

        run_worker("results")
        assert flushes, "the worker flushed nothing"
        th = threading.Thread(target=subscribe)
        th.start()
        deadline = time.monotonic() + 1
        while tier.feed.snapshot()["waiters"] == 0:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        try:
            for segments, ingest_key in flushes:
                store.ingest_segments(segments, ingest_key=ingest_key)
        finally:
            th.join(timeout=1)
        assert not th.is_alive()
        assert got["out"]["events"], "tee flush never reached the feed"
        ev = got["out"]["events"][0]
        assert ev["kind"] == "delta" and ev["rows"] > 0

        # the flushed probe is queryable through the 5m window NOW
        sid = ev["segments"][0]
        fresh = store.query(sid, window="5m")
        assert fresh["count"] > 0
        plain = store.query(sid)
        assert plain["count"] >= fresh["count"]
        assert json.dumps(store.query(sid, window="inf"),
                          sort_keys=True) \
            == json.dumps(plain, sort_keys=True)

        # crash-restart replay: the same flushes (same deterministic
        # ingest keys) through a restarted handle never double-count
        rows_before = store.stats()["rows"]
        assert rows_before > 0
        restarted = LocalDatastore(str(tmp_path / "store"))
        restarted.enable_freshness()

        def tee2(_tile, segments, ingest_key=None,
                 _ds=restarted):
            _ds.ingest_segments(segments, ingest_key=ingest_key)

        tee_fn = tee2

        anon = Anonymiser(TileSink(str(tmp_path / "results2")),
                          privacy=1, quantisation=3600, source="test",
                          tee=tee_fn)
        worker = StreamWorker(
            Formatter.from_config(",sv,\\|,1,2,3,4,5"),
            inproc_submitter(service), anon, flush_interval_s=1e9)
        worker.run(lines)
        assert restarted.stats()["rows"] == rows_before
        assert json.dumps(restarted.query(sid, window="inf"),
                          sort_keys=True) \
            == json.dumps(restarted.query(sid), sort_keys=True)




# ---- parity: the same ingests under one fake clock -------------------------

import reporter_tpu.datastore as jax_ds  # noqa: E402
import reporter_tpu_torch.datastore as port_ds  # noqa: E402
from reporter_tpu.core import types as jax_types  # noqa: E402
from reporter_tpu_torch.core import types as port_types  # noqa: E402

BOTH = ((jax_ds, jax_types), (port_ds, port_types))
#: two level-2 tiles near each other and one far away
TILES = (756425, 756426, 310000)


def _flush(types, seed, n=40):
    """A seeded flush: segments on the three tiles, a week of hours."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tile = int(rng.choice(TILES))
        sid = make_segment_id(2, tile, int(rng.integers(0, 6)))
        nxt = make_segment_id(2, tile, int(rng.integers(0, 6)))
        t0 = MON_8AM + float(rng.uniform(0, 7 * 86400))
        out.append(types.Segment(sid, nxt, t0,
                                 t0 + float(rng.uniform(2, 90)),
                                 int(rng.integers(20, 600)), 0))
    return out


def _ids():
    return [make_segment_id(2, t, i) for t in TILES for i in range(6)]


def _run(script, tmp_path, **store_kw):
    """Drive both packages' stores through ``script(ds, types, clock)``
    under one fake clock each; return what the script returns, per
    package."""
    out = []
    for m, types in BOTH:
        clock = _Clock()
        ds = m.LocalDatastore(str(tmp_path / m.__name__))
        ds.enable_freshness(clock=clock, **store_kw)
        out.append(script(ds, types, clock))
    return out


def _timeline(ds, types, clock):
    """Five flushes a minute apart, one re-offered (dedupe) and one
    keyless, then windows, viewports and the feed read at each step."""
    answers = []
    ids = _ids()
    for k in range(5):
        clock.t += 60
        ds.ingest_segments(_flush(types, k), ingest_key=f"f-{k}")
        if k == 2:
            ds.ingest_segments(_flush(types, 1), ingest_key="f-1")
        if k == 3:
            ds.ingest_segments(_flush(types, 9))
        for window in ("90s", "5m", 150, "inf"):
            answers.append(ds.query_many(ids, window=window))
        answers.append(ds.query_bbox([-180, -90, 180, 90], 2,
                                     window="2m"))
        answers.append(ds.freshness.viewports.summarise(
            [-180, -90, 180, 90], 2))
        answers.append(ds.freshness.viewports.summarise(
            [6.5, 46.5, 8.0, 47.5], 2))
        answers.append(ds.freshness.feed.poll(cursor=k, timeout_s=0))
        answers.append(ds.freshness.feed.poll(
            bbox=[6.5, 46.5, 8.0, 47.5], level=2, cursor=0, timeout_s=0,
            max_events=3))
        answers.append({k: v for k, v in ds.freshness.snapshot().items()})
    ds.compact()
    ds.freshness.on_compactor_pass()
    answers.append(ds.freshness.viewports.summarise([-180, -90, 180, 90],
                                                    2))
    answers.append(ds.query_many(ids, window="inf"))
    answers.append(ds.query_many(ids))
    return json.dumps(answers, sort_keys=True)


def test_windows_viewports_and_feed_answer_equal(tmp_path):
    want, got = _run(_timeline, tmp_path)
    assert got == want
    answers = json.loads(got)
    assert answers[-1] == answers[-2]  # inf == the compacted store
    assert any(a.get("events") for a in answers if isinstance(a, dict))


def test_overlay_eviction_under_a_small_budget_is_equal(tmp_path):
    want, got = _run(_timeline, tmp_path, budget_bytes=6_000)
    assert got == want
    snaps = [a for a in json.loads(got)
             if isinstance(a, dict) and "overlay" in a]
    assert snaps[-1]["overlay"]["evicted"] > 0


def test_windows_without_the_tier_answer_equal(tmp_path, monkeypatch):
    """No tier (the JAX package's REPORTER_TPU_FRESHNESS=0, the port's
    ``freshness=False``): ``inf`` is the compacted store, a finite window
    empty, in both."""
    monkeypatch.setenv("REPORTER_TPU_FRESHNESS", "0")
    answers = []
    for (m, types), kw in zip(BOTH, ({}, {"freshness": False})):
        ds = m.LocalDatastore(str(tmp_path / m.__name__), **kw)
        assert ds.enable_freshness() is None
        ds.ingest_segments(_flush(types, 4), ingest_key="k")
        answers.append(json.dumps(
            [ds.query_many(_ids(), window=w) for w in ("5m", "inf", 30)]
            + [ds.query_many(_ids())], sort_keys=True))
    assert answers[1] == answers[0]


def test_feed_overload_and_resync_equal(tmp_path):
    def script(ds, types, clock):
        feed = port_ds.ChangeFeed if ds.__class__ is port_ds.LocalDatastore \
            else jax_ds.ChangeFeed
        out = []
        small = feed(ds, clock=clock, max_waiters_n=0, ring_events=4)
        for k in range(6):
            small._publish("delta", 2, TILES[k % 3], [k], False, 1)
        try:
            small.poll(cursor=0, timeout_s=0)
        except Exception as e:
            out.append([type(e).__name__, e.reason, e.retry_after_s])
        small.max_waiters = 1
        out.append(small.poll(cursor=0, timeout_s=0))
        out.append(small.poll(cursor=5, timeout_s=0))
        out.append(small.snapshot())
        return json.dumps(out, sort_keys=True)
    want, got = _run(script, tmp_path)
    assert got == want
    got = json.loads(got)
    assert got[0][0] == "FeedOverload" and got[1]["resync"] is True


def test_store_watcher_tile_events_equal(tmp_path):
    """Commits by another handle of the same root surface as ``tile``
    events through the store watcher, equally in both packages."""
    def script(ds, types, clock):
        m = jax_ds if isinstance(ds, jax_ds.LocalDatastore) else port_ds
        other = m.LocalDatastore(ds.root)
        ds.freshness.feed.watch_store(force=True)      # baseline
        other.ingest_segments(_flush(types, 2), ingest_key="elsewhere")
        published = ds.freshness.feed.watch_store(force=True)
        return json.dumps([published, ds.freshness.feed.poll(
            cursor=0, timeout_s=0)], sort_keys=True)
    want, got = _run(script, tmp_path)
    assert got == want and json.loads(got)[0] == len(TILES)
