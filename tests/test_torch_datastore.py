"""The port's histogram datastore (``reporter_tpu_torch.datastore``, the
``/histogram`` action, the worker's tee, the drainer's store replay, the
``.profile`` pre-warm and the ``datastore`` CLI) against the JAX
package's.

The first part runs the JAX package's own datastore cases (its
``tests/test_datastore.py``, the datastore cases of
``test_serving_tier.py``, ``test_faults.py`` and ``test_tools.py``) as
cases over both packages: the ``pkg`` fixture binds the names a case
uses to one package or the other, so each case runs as ``[jax]`` and as
``[torch]``. Where the JAX case sets an environment knob, the port's
case passes the argument that stands for it. The second part gives both
packages the same seeded inputs and holds their outputs equal: the
``.npy`` columns byte for byte, query answers and CLI lines as JSON
text, and manifests with their wall-clock fields masked (``meta.json``'s
``created``, and so ``stats()``'s byte count; the CLI's ``metrics``
timers).
"""
import importlib
import json
import os
import socket
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from reporter_tpu_torch.core.osmlr import INVALID_SEGMENT_ID, make_segment_id

#: the package the current case runs against (set by the ``pkg`` fixture)
PKG = "reporter_tpu_torch"
PACKAGES = {"jax": "reporter_tpu", "torch": "reporter_tpu_torch"}
#: the port's matcher prep threads (the JAX side's
#: REPORTER_TPU_PREP_THREADS), set by _one_prep_thread
_PREP_THREADS = None

#: names the JAX package's cases (here and in test_torch_freshness.py)
#: import at their top, by module
_BOUND = {
    "core.types": ("Segment",),
    "core.tiles": ("TileHierarchy",),
    "datastore": ("LocalDatastore", "ObservationBatch", "aggregate",
                  "hours_for_range", "merge_deltas", "parse_tile_csv",
                  "BackgroundCompactor", "LeaseHeldElsewhere",
                  "export_profile", "load_profile", "query_bbox",
                  "query_many", "warm_matcher", "OverlayView",
                  "parse_window"),
    "datastore.feed": ("ChangeFeed", "FeedOverload"),
    "datastore.freshness": ("RecentDeltaOverlay",),
    "datastore.ingest": ("ingest_dir", "scan_tiles"),
    "datastore.query": ("_percentiles", "bbox_partitions",
                        "bbox_tile_range"),
    "datastore.lease": ("LEASE_NAME", "StoreLease"),
    "datastore.profile": ("PROFILE_NAME", "profile_path"),
    "streaming.anonymiser": ("Anonymiser", "TileSink"),
}
_MODULES = {"schema": "datastore.schema", "metrics": "utils.metrics",
            "faults": "utils.faults"}


def _imp(path, name):
    """``from <package under test>.<path> import <name>``."""
    base = f"{PKG}.{path}" if path else PKG
    module = importlib.import_module(base)
    try:
        return getattr(module, name)
    except AttributeError:
        return importlib.import_module(f"{base}.{name}")


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """Run the case against one package: bind its names here and in the
    case's own module (test_torch_freshness.py imports this fixture),
    clear its fault table and metrics."""
    global PKG, _PREP_THREADS
    PKG = PACKAGES[request.param]
    _PREP_THREADS = None
    for g in {id(d): d for d in (globals(), vars(request.module))}.values():
        for path, names in _BOUND.items():
            for name in names:
                g[name] = _imp(path, name)
        for name, path in _MODULES.items():
            g[name] = importlib.import_module(f"{PKG}.{path}")
    faults.clear()
    metrics.default.reset()
    yield request.param
    faults.clear()


def _jax():
    return PKG == "reporter_tpu"


def _matcher(net, native=True):
    """The package's SegmentMatcher on the CPU."""
    SegmentMatcher = _imp("matcher", "SegmentMatcher")
    if _jax():
        return SegmentMatcher(net=net, use_native=native)
    return SegmentMatcher(net, device="cpu", native=native,
                          prep_threads=_PREP_THREADS)


def _one_prep_thread(monkeypatch):
    """One prep slot: REPORTER_TPU_PREP_THREADS=1 for the JAX package,
    ``prep_threads=1`` for the port."""
    global _PREP_THREADS
    monkeypatch.setenv("REPORTER_TPU_PREP_THREADS", "1")
    _PREP_THREADS = 1


@pytest.fixture
def city(pkg):
    return _imp("synth", "build_grid_city")(
        rows=6, cols=6, spacing_m=200.0, seed=5,
        service_road_fraction=0.0, internal_fraction=0.0)


# ---- the JAX package's cases, over both packages ---------------------------

# Monday 2017-01-02 08:00:00 UTC -> hour-of-week 8

# Monday 2017-01-02 08:00:00 UTC -> hour-of-week 8
MON_8AM = 1483344000

SID = make_segment_id(2, 756425, 10)
NID = make_segment_id(2, 756425, 11)


def _segs(n, t0=MON_8AM, duration=10.0, length=100, sid=SID, nid=NID,
          spacing=30):
    """n observations of `length` m in `duration` s (36 kph at defaults)."""
    return [Segment(sid, nid, t0 + i * spacing, t0 + i * spacing + duration,
                    length, 0) for i in range(n)]


@pytest.mark.usefixtures("pkg")
class TestSchema:
    def test_hist_key_roundtrip(self):
        seg = np.array([SID, NID, 1], dtype=np.int64)
        hour = np.array([0, 8, 167])
        sbin = np.array([0, 7, schema.N_SPEED_BINS - 1])
        key = schema.hist_key(seg, hour, sbin)
        s2, h2, b2 = schema.split_hist_key(key)
        assert (s2 == seg).all() and (h2 == hour).all() and (b2 == sbin).all()

    def test_keys_sort_by_segment_then_hour_then_bin(self):
        lo, hi = schema.segment_key_range(SID)
        assert hi - lo == schema.CELLS_PER_SEGMENT
        below = schema.hist_key(np.array([SID - 1]), np.array([167]),
                                np.array([schema.N_SPEED_BINS - 1]))[0]
        assert below < lo

    def test_max_key_fits_int64(self):
        key = schema.hist_key(np.array([INVALID_SEGMENT_ID]),
                              np.array([167]),
                              np.array([schema.N_SPEED_BINS - 1]))
        assert key.dtype == np.int64 and key[0] > 0

    def test_hour_of_week_monday_epoch(self):
        assert schema.hour_of_week(np.array([MON_8AM]))[0] == 8
        # epoch 0 is Thursday 00:00 -> hour 72
        assert schema.hour_of_week(np.array([0]))[0] == 72
        # a week later, same hour
        assert schema.hour_of_week(np.array([MON_8AM + 7 * 86400]))[0] == 8

    def test_speed_bins(self):
        kph = np.array([0.0, 4.99, 5.0, 36.0, 119.99, 120.0, 500.0])
        bins = schema.speed_bin(kph)
        assert bins.tolist() == [0, 0, 1, 7, 23, 24, 24]

    def test_from_segments_matches_csv_parse(self):
        segs = _segs(5, duration=9.2)  # fractional: exercises rounding
        obs_a = ObservationBatch.from_segments(segs)
        payload = "\n".join([Segment.column_layout()]
                            + [s.csv_row("AUTO", "t") for s in segs])
        obs_b = parse_tile_csv(payload)
        for col in ("segment_id", "next_id", "duration_s", "count",
                    "length_m", "queue_m", "min_ts", "max_ts"):
            np.testing.assert_array_equal(getattr(obs_a, col),
                                          getattr(obs_b, col), err_msg=col)

    def test_valid_mask_drops_bad_rows(self):
        segs = _segs(2) + [Segment(SID, NID, MON_8AM, MON_8AM, 100, 0),
                           Segment(SID, NID, MON_8AM, MON_8AM + 10, 0, 0)]
        obs = ObservationBatch.from_segments(segs)
        assert obs.valid_mask().tolist() == [True, True, False, False]


@pytest.mark.usefixtures("pkg")
class TestAggregate:
    def test_counts_and_speed_sums(self):
        deltas = aggregate(ObservationBatch.from_segments(_segs(20)))
        assert list(deltas) == [(2, 756425)]
        d = deltas[(2, 756425)]
        assert len(d) == 1  # one (segment, hour, bin) cell
        assert d.hist_count[0] == 20
        assert d.hist_speed_sum[0] == pytest.approx(20 * 36.0)
        seg, hour, sbin = schema.split_hist_key(d.hist_key)
        assert seg[0] == SID and hour[0] == 8 and sbin[0] == 7

    def test_transitions_exclude_invalid_next(self):
        segs = _segs(3) + [Segment(SID, None, MON_8AM, MON_8AM + 10, 100, 0)]
        d = aggregate(ObservationBatch.from_segments(segs))[(2, 756425)]
        assert d.trans_from.tolist() == [SID]
        assert d.trans_to.tolist() == [NID]
        assert d.trans_count.tolist() == [3]
        # the invalid-next observation still lands in the histogram
        assert d.hist_count.sum() == 4

    def test_multi_partition_split(self):
        other = make_segment_id(0, 99, 1)
        segs = _segs(2) + _segs(3, sid=other, nid=None)
        deltas = aggregate(ObservationBatch.from_segments(segs))
        assert set(deltas) == {(2, 756425), (0, 99)}
        assert deltas[(0, 99)].hist_count.sum() == 3

    def test_merge_deltas_equals_single_pass(self):
        a = _segs(10, duration=10.0)           # 36 kph
        b = _segs(10, duration=20.0, spacing=60)  # 18 kph
        d_all = aggregate(ObservationBatch.from_segments(a + b))[(2, 756425)]
        d_merged = merge_deltas([
            aggregate(ObservationBatch.from_segments(a))[(2, 756425)],
            aggregate(ObservationBatch.from_segments(b))[(2, 756425)]])
        np.testing.assert_array_equal(d_all.hist_key, d_merged.hist_key)
        np.testing.assert_array_equal(d_all.hist_count, d_merged.hist_count)
        np.testing.assert_allclose(d_all.hist_speed_sum,
                                   d_merged.hist_speed_sum)
        np.testing.assert_array_equal(d_all.trans_count, d_merged.trans_count)

    def test_empty_batch(self):
        assert aggregate(ObservationBatch.empty()) == {}


@pytest.mark.usefixtures("pkg")
class TestStore:
    def test_append_commit_is_atomic(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        ds.ingest_segments(_segs(5))
        pdir = ds.partition_dir(2, 756425)
        manifest = json.load(open(os.path.join(pdir, "MANIFEST.json")))
        assert manifest["segments"] == ["delta-000001"]
        # no temp debris after a clean commit
        assert not [d for d in os.listdir(pdir) if d.startswith(".tmp")]
        assert not os.path.exists(os.path.join(pdir, ".MANIFEST.tmp"))

    def test_reads_are_mmapped(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        ds.ingest_segments(_segs(5))
        (part,) = ds.live_segments(2, 756425)
        assert isinstance(part.hist_key, np.memmap)
        assert isinstance(part.hist_speed_sum, np.memmap)

    def test_compact_merges_and_preserves_query(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        for _ in range(4):
            ds.ingest_segments(_segs(5))
        before = ds.query(SID)
        assert ds.stats()["segments"] == 4
        out = ds.compact()
        assert out == {"partitions": 1, "merged_segments": 4, "skipped": 0}
        assert ds.stats()["segments"] == 1
        after = ds.query(SID)
        assert after == before
        # idempotent: single-segment partitions are left alone
        assert ds.compact()["merged_segments"] == 0

    def test_compact_filters_by_partition(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        other = make_segment_id(0, 99, 1)
        for _ in range(2):
            ds.ingest_segments(_segs(2))
            ds.ingest_segments(_segs(2, sid=other, nid=None))
        assert ds.compact(level=0)["merged_segments"] == 2
        assert ds.stats()["segments"] == 3  # level-2 partition untouched

    def test_stats_counts(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        ds.ingest_segments(_segs(20))
        s = ds.stats()
        assert s["partitions"] == 1 and s["segments"] == 1
        assert s["rows"] == 20 and s["cells"] == 1 and s["bytes"] > 0

    def test_unknown_partition_queries_empty(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        r = ds.query(SID)
        assert r["count"] == 0 and r["mean_kph"] is None
        assert r["transitions"] == []


@pytest.mark.usefixtures("pkg")
class TestEpochs:
    """Epoch'd histograms: the store's active map_version
    stamps manifests and ledger keys, compaction groups by epoch, and
    queries pin to ONE epoch by default with ``merge=`` the explicit
    opt-in — histograms never silently mix map builds."""

    MV_A = "aaaa00000001"
    MV_B = "bbbb00000002"

    def _two_epoch_store(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        ds.set_map_version(self.MV_A)
        ds.ingest_segments(_segs(4), ingest_key="k1")
        ds.set_map_version(self.MV_B)
        # same cell, slower traffic: the epochs must stay tellable
        ds.ingest_segments(_segs(4, duration=20.0), ingest_key="k2")
        return ds

    def test_ledger_keys_are_epoch_qualified(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        ds.set_map_version(self.MV_A)
        assert ds.ingest_segments(_segs(3), ingest_key="k") == 3
        # same key, same epoch: exactly-once dedupe as ever
        assert ds.ingest_segments(_segs(3), ingest_key="k") == 0
        # same key, NEW epoch: the post-swap re-score of the same
        # traffic is new data, not a duplicate
        ds.set_map_version(self.MV_B)
        assert ds.ingest_segments(_segs(3), ingest_key="k") == 3

    def test_manifest_epoch_tags_and_counter(self, tmp_path):
        metrics = _imp("utils", "metrics")
        c0 = metrics.default.counter("datastore.epoch.stamped_segments")
        ds = self._two_epoch_store(tmp_path)
        pdir = ds.partition_dir(2, 756425)
        manifest = json.load(open(os.path.join(pdir, "MANIFEST.json")))
        assert manifest["map_version"] == self.MV_B
        tags = manifest["epochs"]
        assert set(tags) == set(manifest["segments"])
        assert sorted(tags.values()) == [self.MV_A, self.MV_B]
        assert metrics.default.counter(
            "datastore.epoch.stamped_segments") == c0 + 2

    def test_default_pin_is_active_version_merge_is_opt_in(self,
                                                          tmp_path):
        metrics = _imp("utils", "metrics")
        ds = self._two_epoch_store(tmp_path)
        p0 = metrics.default.counter("datastore.epoch.pinned_queries")
        m0 = metrics.default.counter("datastore.epoch.merged_queries")
        latest = ds.query(SID)
        pin_a = ds.query(SID, map_version=self.MV_A)
        pin_b = ds.query(SID, map_version=self.MV_B)
        merged = ds.query(SID, merge=True)
        assert latest == pin_b  # default = the ACTIVE version
        assert pin_a["mean_kph"] != pin_b["mean_kph"]
        assert merged["count"] == pin_a["count"] + pin_b["count"]
        assert metrics.default.counter(
            "datastore.epoch.pinned_queries") == p0 + 3
        assert metrics.default.counter(
            "datastore.epoch.merged_queries") == m0 + 1
        with pytest.raises(ValueError):
            ds.query(SID, map_version=self.MV_A, merge=True)

    def test_query_many_and_bbox_thread_the_pin(self, tmp_path):
        ds = self._two_epoch_store(tmp_path)
        (one_a,) = ds.query_many([SID], map_version=self.MV_A)
        assert one_a == ds.query(SID, map_version=self.MV_A)
        (one_m,) = ds.query_many([SID], merge=True)
        assert one_m == ds.query(SID, merge=True)
        bb = ds.query_bbox((-180, -90, 180, 90), 2,
                           map_version=self.MV_A)
        assert bb["segments"][0] == dict(one_a, segment_id=SID)

    def test_compaction_groups_by_epoch(self, tmp_path):
        """One base per EPOCH — compaction never merges across map
        versions, and every pinned answer is byte-stable across it."""
        ds = LocalDatastore(str(tmp_path))
        ds.set_map_version(self.MV_A)
        for k in range(2):
            ds.ingest_segments(_segs(3), ingest_key=f"a{k}")
        ds.set_map_version(self.MV_B)
        for k in range(2):
            ds.ingest_segments(_segs(3, duration=20.0),
                               ingest_key=f"b{k}")
        pin_a = ds.query(SID, map_version=self.MV_A)
        pin_b = ds.query(SID, map_version=self.MV_B)
        merged = ds.query(SID, merge=True)
        assert ds.compact()["merged_segments"] == 4
        pdir = ds.partition_dir(2, 756425)
        manifest = json.load(open(os.path.join(pdir, "MANIFEST.json")))
        assert len(manifest["segments"]) == 2
        assert sorted(manifest["epochs"].values()) \
            == [self.MV_A, self.MV_B]
        assert ds.query(SID, map_version=self.MV_A) == pin_a
        assert ds.query(SID, map_version=self.MV_B) == pin_b
        assert ds.query(SID, merge=True) == merged

    def test_untagged_legacy_segments_pass_any_pin(self, tmp_path):
        """Enabling versioning on an existing store hides nothing:
        pre-versioning segments (no epoch tag) serve under every pin."""
        ds = LocalDatastore(str(tmp_path))
        ds.ingest_segments(_segs(3), ingest_key="legacy")
        before = ds.query(SID)
        ds.set_map_version(self.MV_A)
        assert ds.query(SID) == before  # default pin
        assert ds.query(SID, map_version="ffff00000009") == before
        assert ds.query(SID, merge=True) == before


@pytest.mark.usefixtures("pkg")
class TestIngestDir:
    def _flush_layout(self, root, segs, name="rtpu.abc123"):
        tile_dir = os.path.join(root, "1483344000_1483347599", "2", "756425")
        os.makedirs(tile_dir, exist_ok=True)
        payload = "\n".join([Segment.column_layout()]
                            + [s.csv_row("AUTO", "t") for s in segs])
        with open(os.path.join(tile_dir, name), "w") as f:
            f.write(payload)

    def test_scan_skips_deadletter_and_dotfiles(self, tmp_path):
        self._flush_layout(str(tmp_path), _segs(2))
        self._flush_layout(os.path.join(str(tmp_path), ".deadletter"),
                           _segs(2), name="rtpu.spooled")
        open(os.path.join(str(tmp_path), ".state"), "w").close()
        files = list(scan_tiles(str(tmp_path)))
        assert len(files) == 1 and files[0].endswith("rtpu.abc123")

    def test_scan_skips_flightrec_dumps(self, tmp_path):
        """The flight recorder's postmortems share the spool layout —
        an ingest replay must never mistake span JSON for tile CSV
        (same contract as .traces/.deadletter)."""
        self._flush_layout(str(tmp_path), _segs(2))
        rec = os.path.join(str(tmp_path), ".flightrec")
        os.makedirs(rec)
        with open(os.path.join(rec, "flightrec-1-0001-crash.json"),
                  "w") as f:
            f.write('{"reason":"crash.worker.offer","spans":[]}')
        files = list(scan_tiles(str(tmp_path)))
        assert len(files) == 1 and files[0].endswith("rtpu.abc123")
        # and the same holds scanning a dead-letter spool that carries
        # a nested .flightrec (the default dump location)
        dl = tmp_path / "dl"
        self._flush_layout(str(dl), _segs(2), name="rtpu.spooled")
        os.makedirs(str(dl / ".flightrec"))
        with open(str(dl / ".flightrec" / "flightrec-1-0002-x.json"),
                  "w") as f:
            f.write("{}")
        files = list(scan_tiles(str(dl)))
        assert len(files) == 1 and files[0].endswith("rtpu.spooled")

    def test_ingest_dir_and_delete(self, tmp_path):
        out_dir = tmp_path / "results"
        self._flush_layout(str(out_dir), _segs(5))
        self._flush_layout(str(out_dir), _segs(3), name="rtpu.def456")
        ds = LocalDatastore(str(tmp_path / "store"))
        got = ingest_dir(ds, str(out_dir), delete=True)
        assert got == {"files": 2, "rows": 8, "failures": 0}
        assert list(scan_tiles(str(out_dir))) == []  # replay-safe
        assert ds.query(SID)["count"] == 8

    def test_corrupt_file_counted_not_fatal(self, tmp_path):
        out_dir = tmp_path / "results"
        self._flush_layout(str(out_dir), _segs(2))
        bad = os.path.join(str(out_dir), "1483344000_1483347599", "2",
                           "756425", "rtpu.bad")
        with open(bad, "w") as f:
            f.write("segment_id,\nnot,a,tile")
        ds = LocalDatastore(str(tmp_path / "store"))
        got = ingest_dir(ds, str(out_dir))
        # short rows are dropped row-wise, so the bad file parses to empty
        assert got["files"] == 2 and got["rows"] == 2

    def test_failing_file_quarantined_not_replayed(self, tmp_path):
        # a 10-column row with a non-numeric id raises in the columnar
        # conversion — the file must be quarantined so the next replay
        # cannot double-count any partially committed partitions
        out_dir = tmp_path / "results"
        self._flush_layout(str(out_dir), _segs(2))
        bad = os.path.join(str(out_dir), "1483344000_1483347599", "2",
                           "756425", "rtpu.poison")
        with open(bad, "w") as f:
            f.write("nan?,,1,1,100,0,10,20,s,AUTO")
        ds = LocalDatastore(str(tmp_path / "store"))
        got = ingest_dir(ds, str(out_dir))
        assert got["failures"] == 1 and got["files"] == 1
        assert not os.path.exists(bad)
        assert os.path.exists(os.path.join(os.path.dirname(bad),
                                           ".rtpu.poison.failed"))
        # the quarantined file is invisible to the next replay — and the
        # good file's relpath is already in the partition ledger, so the
        # re-replay is a counted no-op instead of a double count
        metrics = _imp("utils", "metrics")
        before = metrics.default.counter("datastore.ingest.deduped")
        again = ingest_dir(ds, str(out_dir))
        assert again == {"files": 1, "rows": 0, "failures": 0}
        assert metrics.default.counter("datastore.ingest.deduped") > before


@pytest.mark.usefixtures("pkg")
class TestDeadLetterReplay:
    def test_failed_egress_spools_and_replays(self, tmp_path, monkeypatch):
        metrics = _imp("utils", "metrics")
        metrics.default.reset()
        # an http sink whose endpoint is down, spooling under tmp
        dl = str(tmp_path / "dl")
        monkeypatch.setattr(f"{PKG}.utils.http.egress_tile",
                            lambda *a, **kw: False)
        sink = TileSink("http://127.0.0.1:9", deadletter=dl)
        anon = Anonymiser(sink, privacy=1, quantisation=3600, source="t")
        for s in _segs(6):
            anon.process("k", s)
        assert anon.punctuate() == 0  # nothing written to the sink
        snap = metrics.snapshot()["counters"]
        assert snap["egress.fail"] == 1 and "egress.ok" not in snap
        assert snap["egress.deadletter"] == 1
        # the spool replays into a store with the standard ingest
        ds = LocalDatastore(str(tmp_path / "store"))
        got = ingest_dir(ds, dl, delete=True)
        assert got["files"] == 1 and got["rows"] == 6
        assert ds.query(SID)["count"] == 6
        assert list(scan_tiles(dl)) == []

    def test_ok_egress_counts(self, tmp_path):
        metrics = _imp("utils", "metrics")
        metrics.default.reset()
        sink = TileSink(str(tmp_path / "out"))
        assert sink.store("1_2/2/756425", "t.x", "payload")
        assert metrics.snapshot()["counters"]["egress.ok"] == 1

    def test_local_sink_default_deadletter_inside_output(self, tmp_path):
        sink = TileSink(str(tmp_path / "out"))
        assert sink.deadletter == str(tmp_path / "out" / ".deadletter")

    def test_remote_sink_default_deadletter_is_absolute(self):
        # a cwd-relative spool would scatter across launch dirs (or hit
        # an unwritable / under a service manager)
        sink = TileSink("http://example.invalid/tiles")
        assert os.path.isabs(sink.deadletter)


@pytest.mark.usefixtures("pkg")
class TestQuery:
    def test_mean_and_percentiles_two_speed_cohorts(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        # 30 obs at 36 kph (bin 7) + 10 obs at 72 kph (bin 14)
        ds.ingest_segments(_segs(30, duration=10.0)
                           + _segs(10, duration=5.0, spacing=40))
        r = ds.query(SID)
        assert r["count"] == 40
        assert r["mean_kph"] == pytest.approx((30 * 36 + 10 * 72) / 40)
        # p50 inside bin 7: 35 + (20-0)/30 * 5
        assert r["percentiles"]["p50"] == pytest.approx(35 + 20 / 30 * 5,
                                                        abs=1e-3)
        # p95: target 38 -> bin 14: 70 + (38-30)/10 * 5
        assert r["percentiles"]["p95"] == pytest.approx(70 + 8 / 10 * 5,
                                                        abs=1e-3)
        hist = np.array(r["histogram"]["counts"])
        assert hist[7] == 30 and hist[14] == 10 and hist.sum() == 40

    def test_hours_filter_and_coverage(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        ds.ingest_segments(_segs(10))                       # hour 8
        ds.ingest_segments(_segs(5, t0=MON_8AM + 7200))     # hour 10
        r_all = ds.query(SID)
        assert r_all["count"] == 15 and r_all["hours_covered"] == 2
        r_8 = ds.query(SID, hours=[8])
        assert r_8["count"] == 10 and r_8["coverage"] == 1.0
        r_peak = ds.query(SID, hours=range(7, 10))
        assert r_peak["count"] == 10
        assert r_peak["coverage"] == pytest.approx(1 / 3, abs=1e-4)
        with pytest.raises(ValueError):
            ds.query(SID, hours=[400])

    def test_hours_for_range(self):
        np.testing.assert_array_equal(
            hours_for_range(MON_8AM, MON_8AM + 3 * 3600), [8, 9, 10])
        # mid-hour end still covers its hour
        np.testing.assert_array_equal(
            hours_for_range(MON_8AM, MON_8AM + 3600 + 1), [8, 9])
        # a full week (or more) is every hour
        assert hours_for_range(MON_8AM, MON_8AM + 8 * 86400).size == 168
        assert hours_for_range(MON_8AM, MON_8AM).size == 0

    def test_transitions_ranked(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        nid2 = make_segment_id(2, 756425, 12)
        ds.ingest_segments(_segs(3) + _segs(8, nid=nid2, spacing=40))
        r = ds.query(SID)
        assert r["transitions"] == [{"next_id": nid2, "count": 8},
                                    {"next_id": NID, "count": 3}]

    def test_percentiles_empty(self):
        out = _percentiles(np.zeros(schema.N_SPEED_BINS, dtype=np.int64),
                           (50.0,))
        assert out == {"p50": None}

    def test_percentiles_out_of_range_rejected(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        ds.ingest_segments(_segs(5))
        for bad in (150, 0, -5):
            with pytest.raises(ValueError):
                ds.query(SID, percentiles=(bad,))

    def test_parse_hours_spec(self):
        parse_hours_spec = _imp("datastore", "parse_hours_spec")
        assert parse_hours_spec(None) is None
        assert parse_hours_spec("7-9") == [7, 8, 9]
        assert parse_hours_spec("7,8,9") == [7, 8, 9]
        with pytest.raises(ValueError):
            parse_hours_spec("9-7")


class _StubMatcher:
    def match_many(self, traces):
        return [[] for _ in traces]


@pytest.fixture
def histogram_server(pkg, tmp_path):
    ReporterService = _imp("service.server", "ReporterService")
    serve = _imp("service.server", "serve")
    ds = LocalDatastore(str(tmp_path / "store"))
    ds.ingest_segments(_segs(20))
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
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.usefixtures("pkg")
class TestHistogramAction:
    def test_get_flat_params(self, histogram_server):
        url, _ds = histogram_server
        code, body = _get(f"{url}/histogram?segment_id={SID}")
        assert code == 200
        assert body["count"] == 20
        assert body["mean_kph"] == pytest.approx(36.0)
        assert body["transitions"][0]["next_id"] == NID

    def test_epoch_pin_and_merge_params(self, histogram_server):
        """/histogram grows map_version= (pin) and merge=1 (explicit
        cross-epoch opt-in); the default pins to the store's active
        version, and pin+merge together is a 400."""
        url, ds = histogram_server
        ds.set_map_version("aaaa00000001")
        ds.ingest_segments(_segs(4), ingest_key="ea")
        ds.set_map_version("bbbb00000002")
        ds.ingest_segments(_segs(4, duration=20.0), ingest_key="eb")
        _, latest = _get(f"{url}/histogram?segment_id={SID}")
        _, pin_a = _get(f"{url}/histogram?segment_id={SID}"
                        f"&map_version=aaaa00000001")
        _, pin_b = _get(f"{url}/histogram?segment_id={SID}"
                        f"&map_version=bbbb00000002")
        _, merged = _get(f"{url}/histogram?segment_id={SID}&merge=1")
        assert latest == pin_b  # default = the active epoch
        # 20 legacy (untagged, pre-versioning) rows serve under every
        # pin; each epoch adds its own 4
        assert pin_a["count"] == 24 and pin_b["count"] == 24
        assert merged["count"] == 28
        code, body = _get(f"{url}/histogram?segment_id={SID}"
                          f"&map_version=aaaa00000001&merge=1")
        assert code == 400 and "mutually exclusive" in body["error"]

    def test_get_hours_range(self, histogram_server):
        url, _ds = histogram_server
        code, body = _get(f"{url}/histogram?segment_id={SID}&hours=7-9")
        assert code == 200 and body["count"] == 20
        code, body = _get(f"{url}/histogram?segment_id={SID}&hours=10,11")
        assert code == 200 and body["count"] == 0

    def test_get_time_range(self, histogram_server):
        url, _ds = histogram_server
        code, body = _get(
            f"{url}/histogram?segment_id={SID}&t0={MON_8AM}"
            f"&t1={MON_8AM + 3600}")
        assert code == 200 and body["count"] == 20

    def test_post_json_body(self, histogram_server):
        url, _ds = histogram_server
        req = urllib.request.Request(
            url + "/histogram",
            data=json.dumps({"segment_id": SID,
                             "percentiles": [50]}).encode(),
            method="POST")
        with urllib.request.urlopen(req) as r:
            body = json.loads(r.read())
        assert list(body["percentiles"]) == ["p50"]

    def test_get_json_param(self, histogram_server):
        url, _ds = histogram_server
        q = urllib.parse.urlencode({"json": json.dumps({"segment_id": SID})})
        code, body = _get(f"{url}/histogram?{q}")
        assert code == 200 and body["count"] == 20

    def test_bad_percentiles_400(self, histogram_server):
        url, _ds = histogram_server
        code, body = _get(f"{url}/histogram?segment_id={SID}"
                          "&percentiles=150")
        assert code == 400 and "percentile" in body["error"]

    def test_missing_segment_id_400(self, histogram_server):
        url, _ds = histogram_server
        code, body = _get(url + "/histogram")
        assert code == 400 and "segment_id" in body["error"]

    def test_no_datastore_503(self):
        ReporterService = _imp("service.server", "ReporterService")
        service = ReporterService(_StubMatcher())
        code, body = service.histogram({"segment_id": SID})
        assert code == 503


@pytest.mark.usefixtures("pkg")
class TestWorkerRoundTrip:
    """The acceptance proof: a StreamWorker flush is ingested (both via
    the tee and via CSV files), compacted, and queried with the expected
    mean speed — and the two ingest paths agree exactly."""

    def test_flush_ingest_compact_query(self, tmp_path):
        SegmentMatcher = _imp("matcher", "SegmentMatcher")
        ReporterService = _imp("service.server", "ReporterService")
        Formatter = _imp("streaming.formatter", "Formatter")
        StreamWorker = _imp("streaming.worker", "StreamWorker")
        inproc_submitter = _imp("streaming.worker", "inproc_submitter")
        build_grid_city = _imp("synth", "build_grid_city")
        generate_trace = _imp("synth", "generate_trace")

        city = build_grid_city(rows=10, cols=10, spacing_m=200.0, seed=5,
                               service_road_fraction=0.0,
                               internal_fraction=0.0)
        service = ReporterService(_matcher(city), threshold_sec=15,
                                  max_batch=64, max_wait_ms=5.0)
        out_dir = str(tmp_path / "results")
        tee_store = LocalDatastore(str(tmp_path / "store_tee"))

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

        anon = Anonymiser(TileSink(out_dir), privacy=1, quantisation=3600,
                          source="test",
                          tee=lambda _t, segs:
                          tee_store.ingest_segments(segs))
        worker = StreamWorker(
            Formatter.from_config(",sv,\\|,1,2,3,4,5"),
            inproc_submitter(service), anon, flush_interval_s=1e9)
        worker.run(lines)
        assert worker.parse_failures == 0

        # CSV path: ingest the flushed tiles into a second store
        csv_store = LocalDatastore(str(tmp_path / "store_csv"))
        got = ingest_dir(csv_store, out_dir)
        assert got["files"] > 0 and got["failures"] == 0
        assert got["rows"] > 0

        # both paths agree before and after compaction
        tee_stats = tee_store.stats()
        assert tee_stats["rows"] == got["rows"]
        csv_store.compact()
        tee_store.compact()
        seg_ids = set()
        for level, index in csv_store.partitions():
            for part in csv_store.live_segments(level, index):
                seg_ids.update(
                    schema.split_hist_key(np.asarray(part.hist_key))[0]
                    .tolist())
        assert seg_ids, "no segments aggregated"
        total = 0
        for sid in sorted(seg_ids):
            a = csv_store.query(sid)
            b = tee_store.query(sid)
            assert a == b
            total += a["count"]
            if a["count"]:
                # synthetic city traces drive ~10-60 kph; a histogram
                # mean outside that band means the speed math broke
                assert 5.0 < a["mean_kph"] < 80.0
                ps = a["percentiles"]
                assert ps["p25"] <= ps["p50"] <= ps["p75"] <= ps["p95"]
        assert total == got["rows"]


@pytest.mark.usefixtures("pkg")
class TestQueryHandleCache:
    """/histogram does not re-open mmaps per request:
    a bounded partition-handle LRU keyed by the manifest's segment list,
    with a datastore.query.cache.* metric pair."""

    def test_repeat_query_hits_cache(self, tmp_path):
        metrics = _imp("utils", "metrics")
        ds = LocalDatastore(str(tmp_path))
        ds.ingest_segments(_segs(5))
        metrics.default.reset()
        want = ds.query(SID)
        assert ds.query(SID) == want and ds.query(SID) == want
        c = metrics.snapshot()["counters"]
        assert c.get("datastore.query.cache.misses") == 1
        assert c.get("datastore.query.cache.hits") == 2

    def test_append_invalidates_handles(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        ds.ingest_segments(_segs(5))
        assert ds.query(SID)["count"] == 5
        ds.ingest_segments(_segs(5))  # new manifest -> new cache key
        assert ds.query(SID)["count"] == 10

    def test_compaction_invalidates_handles(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        for _ in range(3):
            ds.ingest_segments(_segs(5))
        before = ds.query(SID)
        ds.compact()
        assert ds.query(SID) == before
        # and the cached handle list now reflects the single base segment
        assert len(ds.live_segments(2, 756425)) == 1

    def test_lru_bound_holds(self, tmp_path):
        metrics = _imp("utils", "metrics")
        ds = LocalDatastore(str(tmp_path), handle_cache_size=1)
        other = make_segment_id(0, 99, 1)
        ds.ingest_segments(_segs(5))
        ds.ingest_segments(_segs(5, sid=other, nid=None))
        a = ds.query(SID)
        b = ds.query(other)
        metrics.default.reset()
        # alternating partitions with a 1-entry cache: every read misses,
        # results stay correct
        assert ds.query(SID) == a and ds.query(other) == b
        assert len(ds._handles) == 1
        c = metrics.snapshot()["counters"]
        assert c.get("datastore.query.cache.hits") is None

    def test_cache_disabled_at_zero(self, tmp_path):
        ds = LocalDatastore(str(tmp_path), handle_cache_size=0)
        ds.ingest_segments(_segs(5))
        assert ds.query(SID)["count"] == 5
        assert ds.query(SID)["count"] == 5
        assert len(ds._handles) == 0


@pytest.mark.usefixtures("pkg")
class TestCompactPolicy:
    """`datastore compact` takes --max-deltas / --max-delta-bytes
    thresholds (and the worker tee the same knobs), so compaction needs
    no manual operator pass."""

    def test_max_deltas_threshold(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        for _ in range(3):
            ds.ingest_segments(_segs(5))
        out = ds.compact(max_deltas=5)  # 3 deltas <= 5: below pressure
        assert out == {"partitions": 0, "merged_segments": 0, "skipped": 1}
        out = ds.compact(max_deltas=2)  # 3 > 2: compacts
        assert out["partitions"] == 1 and out["merged_segments"] == 3
        # a lone base segment exerts no delta pressure
        out = ds.compact(max_deltas=0)
        assert out["partitions"] == 0 and out["skipped"] == 1

    def test_max_delta_bytes_threshold(self, tmp_path):
        ds = LocalDatastore(str(tmp_path))
        ds.ingest_segments(_segs(5))
        ds.ingest_segments(_segs(5))
        assert ds.compact(max_delta_bytes=1 << 30)["partitions"] == 0
        out = ds.compact(max_delta_bytes=16)  # any real delta is bigger
        assert out["partitions"] == 1 and out["merged_segments"] == 2

    def test_cli_passes_thresholds(self, tmp_path, capsys):
        datastore_cli = _imp("tools", "datastore_cli")
        ds = LocalDatastore(str(tmp_path))
        for _ in range(4):
            ds.ingest_segments(_segs(5))
        assert datastore_cli.main(
            ["compact", str(tmp_path), "--max-deltas", "8"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["skipped"] == 1 and out["partitions"] == 0
        assert datastore_cli.main(
            ["compact", str(tmp_path), "--max-deltas", "3"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["partitions"] == 1 and out["merged_segments"] == 4

    def test_worker_tee_auto_compacts(self, tmp_path):
        """The worker --datastore tee with thresholds keeps the
        partition's delta count bounded without any manual compact —
        pressure-checked inline on the partitions each flush touched."""
        LDS = _imp("datastore", "LocalDatastore")
        ds = LDS(str(tmp_path))
        for _ in range(6):
            ds.ingest_segments(_segs(5), max_deltas=2)
        # never more than max_deltas+1 segments linger (the policy kicks
        # in as soon as pressure crosses the bound)
        assert ds.stats()["segments"] <= 3
        assert ds.query(SID)["count"] == 30


def _obs(seg_ids, rng, n_obs, with_transitions=True):
    """Random observations over the given segment ids."""
    seg_arr = np.asarray(seg_ids, dtype=np.int64)
    dur = rng.uniform(5, 30, n_obs)
    return ObservationBatch(
        segment_id=rng.choice(seg_arr, size=n_obs),
        next_id=rng.choice(seg_arr, size=n_obs) if with_transitions
        else np.full(n_obs, -1, dtype=np.int64),
        duration_s=dur,
        count=np.ones(n_obs, dtype=np.int64),
        length_m=(dur * rng.uniform(3, 20, n_obs)).astype(np.int64) + 1,
        queue_m=np.zeros(n_obs, dtype=np.int64),
        min_ts=rng.integers(MON_8AM, MON_8AM + 600000, n_obs),
        max_ts=rng.integers(MON_8AM + 600000, MON_8AM + 700000, n_obs))


def _seed_store(root, seg_ids, deltas=3, n_obs=256, seed=3):
    ds = LocalDatastore(str(root))
    rng = np.random.default_rng(seed)
    for d in range(deltas):
        ds.ingest(_obs(seg_ids, rng, n_obs), ingest_key=f"seed-{d}")
    return ds


#: a live pid that is NOT this process — the foreign-holder impostor
FOREIGN_PID = os.getppid()


@pytest.mark.usefixtures("pkg")
class TestStoreLease:
    def test_acquire_creates_file_and_fast_path(self, tmp_path):
        lease = StoreLease(str(tmp_path), ttl_s=30.0)
        assert lease.acquire()
        assert os.path.exists(lease.path)
        state = json.loads(open(lease.path).read())
        assert state["pid"] == os.getpid()
        # fast path: well inside the TTL no disk I/O happens — mangle
        # the file and acquire() must not notice
        os.unlink(lease.path)
        assert lease.acquire()
        assert not os.path.exists(lease.path)

    def test_disabled_ttl_zero_touches_nothing(self, tmp_path):
        lease = StoreLease(str(tmp_path), ttl_s=0.0)
        assert lease.acquire() and lease.held()
        assert not os.path.exists(lease.path)
        assert lease.snapshot() == {"enabled": False}

    def test_foreign_live_holder_rejected(self, tmp_path):
        other = StoreLease(str(tmp_path), ttl_s=60.0)
        other.owner_pid = FOREIGN_PID
        assert other.acquire()
        mine = StoreLease(str(tmp_path), ttl_s=60.0)
        assert not mine.acquire()
        assert not mine.held()
        with pytest.raises(LeaseHeldElsewhere):
            mine.require()

    def test_dead_holder_stolen_immediately(self, tmp_path):
        lease = StoreLease(str(tmp_path), ttl_s=60.0)
        with open(lease.path, "w") as f:
            json.dump({"pid": 999999999, "deadline": 9e18}, f)
        c0 = metrics.default.counter("datastore.lease.steals")
        assert lease.acquire()
        assert metrics.default.counter("datastore.lease.steals") == c0 + 1

    def test_expired_live_holder_stolen(self, tmp_path):
        other = StoreLease(str(tmp_path), ttl_s=60.0)
        other.owner_pid = FOREIGN_PID
        assert other.acquire()
        # expire it on disk (the holder is alive — getppid — but stale)
        with open(other.path, "w") as f:
            json.dump({"pid": FOREIGN_PID, "deadline": 1.0}, f)
        mine = StoreLease(str(tmp_path), ttl_s=60.0)
        e0 = metrics.default.counter("datastore.lease.expired")
        assert mine.acquire()
        assert metrics.default.counter("datastore.lease.expired") == e0 + 1

    def test_release_frees_for_next_holder(self, tmp_path):
        a = StoreLease(str(tmp_path), ttl_s=60.0)
        a.owner_pid = FOREIGN_PID
        assert a.acquire()
        b = StoreLease(str(tmp_path), ttl_s=60.0)
        assert not b.acquire()
        a.release()
        s0 = metrics.default.counter("datastore.lease.steals")
        assert b.acquire()
        # a released lease is vacant, not stolen
        assert metrics.default.counter("datastore.lease.steals") == s0

    def test_torn_lease_body_is_no_holder(self, tmp_path):
        lease = StoreLease(str(tmp_path), ttl_s=60.0)
        with open(lease.path, "w") as f:
            f.write('{"pid": 12')  # torn mid-write
        assert lease.acquire()

    def test_forked_child_does_not_inherit_belief(self, tmp_path):
        lease = StoreLease(str(tmp_path), ttl_s=60.0)
        assert lease.acquire()
        # simulate the fork: belief was recorded under another identity
        lease._belief_pid = 12345
        assert not lease.held()
        assert lease.acquire()  # re-acquires under its own identity

    def test_worker_drain_releases_the_lease(self, synth_city,
                                             tmp_path):
        """A CLEAN worker exit hands the lease back, so routine
        restarts acquire a vacant lease — steals stay a crash
        signal."""
        SegmentMatcher = _imp("matcher", "SegmentMatcher")
        ReporterService = _imp("service.server", "ReporterService")
        Anonymiser = _imp("streaming.anonymiser", "Anonymiser")
        TileSink = _imp("streaming.anonymiser", "TileSink")
        Formatter = _imp("streaming.formatter", "Formatter")
        StreamWorker = _imp("streaming.worker", "StreamWorker")
        inproc_submitter = _imp("streaming.worker", "inproc_submitter")
        ds = LocalDatastore(str(tmp_path / "store"))
        service = ReporterService(
            _matcher(synth_city, native=False))
        worker = StreamWorker(
            Formatter.from_config(r",sv,\|,0,1,2,3,4"),
            inproc_submitter(service),
            Anonymiser(TileSink(str(tmp_path / "out")), privacy=1,
                       quantisation=3600, source="t",
                       tee=lambda _t, segs, ingest_key=None:
                       ds.ingest_segments(segs, ingest_key=ingest_key)),
            reports="0,1,2", transitions="0,1,2",
            flush_interval_s=1e9, datastore=ds)
        generate_trace = _imp("synth", "generate_trace")
        rng = np.random.default_rng(2)
        tr = None
        while tr is None:
            tr = generate_trace(synth_city, "rel-1", rng, noise_m=3.0,
                                min_route_edges=8)
        lines = ["|".join([tr.uuid, str(p["lat"]), str(p["lon"]),
                           str(p["time"]), str(p["accuracy"])])
                 for p in tr.points]
        worker.run(iter(lines))
        service.dispatcher.close()
        state = json.loads(open(ds.lease.path).read() or "{}")
        assert state.get("pid") is None  # released, not left to rot
        s0 = metrics.default.counter("datastore.lease.steals")
        LocalDatastore(str(tmp_path / "store")).lease.acquire()
        assert metrics.default.counter("datastore.lease.steals") == s0

    def test_snapshot_holder_view(self, tmp_path):
        lease = StoreLease(str(tmp_path), ttl_s=60.0)
        lease.acquire()
        snap = lease.snapshot()
        assert snap["enabled"] and snap["held_by_us"]
        assert snap["holder_pid"] == os.getpid()
        assert 0 < snap["expires_in_s"] <= 60.0

    def test_lease_failpoint_refuses_mutation(self, tmp_path):
        faults = _imp("utils", "faults")
        seg = make_segment_id(2, 9, 1)
        ds = _seed_store(tmp_path / "s", [seg], deltas=1, n_obs=8)
        ds.lease._deadline = 0.0  # force the slow path
        faults.configure("datastore.lease=error#1")
        try:
            with pytest.raises(Exception):
                ds.ingest(_obs([seg], np.random.default_rng(0), 4),
                          ingest_key="x")
        finally:
            faults.clear()
        # after the injected fault the store serves mutations again
        assert ds.ingest(_obs([seg], np.random.default_rng(0), 4),
                         ingest_key="x") > 0


@pytest.mark.usefixtures("pkg")
class TestTornManifestRegression:
    """The pre-lease hole, pinned: two writers each passing their OWN
    in-process lock can interleave a compaction's commit window with an
    append, and without the lease the last manifest write would drop
    the append's committed segment AND its exactly-once ledger key.
    Defense in depth: the lease REFUSES the foreign mutation up
    front, and the seq fence catches any interleave that slips past it
    (lease disabled, or a holder stalled beyond its TTL) by aborting
    LOUDLY before the manifest write — the racing writer's committed
    data survives either way."""

    def _seeded(self, root, ttl):
        seg = make_segment_id(2, 44, 7)
        a = LocalDatastore(str(root))
        a.lease._ttl = ttl
        rng = np.random.default_rng(1)
        for d in range(3):
            a.ingest(_obs([seg], rng, 16, with_transitions=False),
                     ingest_key=f"seed-{d}")
        b = LocalDatastore(str(root))
        b.lease._ttl = ttl
        return a, b, seg

    def test_interleaved_commit_aborts_via_seq_fence(self, tmp_path,
                                                     monkeypatch):
        """The pre-lease hole scenario, replayed with the lease OFF:
        B's append lands inside A's compaction commit window, where A's
        last manifest write would drop B's committed delta and ledger
        key; the seq fence detects the
        moved manifest and aborts A LOUDLY — B's data survives."""
        a, b, seg = self._seeded(tmp_path / "store", ttl=0.0)  # no lease
        level, index = 2, 44
        pdir = a.partition_dir(level, index)
        delta_b = _obs([seg], np.random.default_rng(2), 8,
                       with_transitions=False)

        orig_commit = a._commit_segment

        def commit_with_race(pdir_, tmp_, name):
            orig_commit(pdir_, tmp_, name)
            # B's append lands INSIDE A's compaction commit window
            # (between A's segment rename and A's manifest write) —
            # trivially possible across processes, where A's _lock
            # means nothing to B
            assert b.ingest(delta_b, ingest_key="b-key") > 0

        monkeypatch.setattr(a, "_commit_segment", commit_with_race)
        with pytest.raises(RuntimeError, match="stale commit"):
            a._compact_partition(level, index)

        # B's committed delta and its exactly-once ledger key SURVIVE;
        # A's merged base- dir is ignorable manifest-invisible garbage
        manifest = a._read_manifest(pdir)
        assert "b-key" in manifest.get("ingested", {})
        assert manifest["ingested"]["b-key"] in manifest["segments"]
        assert all(a.load_segment(pdir, n) is not None
                   for n in manifest["segments"])

    def test_stale_holder_fails_loudly_at_commit(self, tmp_path,
                                                 monkeypatch):
        """A holder that stalls past its TTL inside the staged write
        and is stolen from must fail LOUDLY at the commit point — the
        orphan-clearing rmtree must never fire against a live new
        holder's committed data."""
        a, _b, seg = self._seeded(tmp_path / "store", ttl=60.0)
        orig_stage = a._stage_segment

        def stage_and_lose_lease(pdir_, delta):
            tmp_ = orig_stage(pdir_, delta)
            # the stall: our on-disk deadline lapses mid-stage and a
            # live foreign process steals the lease
            with open(a.lease.path, "w") as f:
                json.dump({"pid": os.getpid(), "deadline": 1.0}, f)
            a.lease._deadline = 0.0
            thief = StoreLease(a.lease.root, ttl_s=60.0)
            thief.owner_pid = FOREIGN_PID
            assert thief.acquire()
            return tmp_

        monkeypatch.setattr(a, "_stage_segment", stage_and_lose_lease)
        manifest_before = a._read_manifest(a.partition_dir(2, 44))
        with pytest.raises(LeaseHeldElsewhere):
            a.ingest(_obs([seg], np.random.default_rng(3), 8,
                          with_transitions=False), ingest_key="late")
        # nothing committed: manifest untouched, no new segment dirs
        after = a._read_manifest(a.partition_dir(2, 44))
        assert after == manifest_before

    def test_lease_refuses_the_interleave(self, tmp_path, monkeypatch):
        a, b, seg = self._seeded(tmp_path / "store", ttl=60.0)
        # A is a foreign live process holding the lease; B is us (the
        # seeding ran under our real pid — hand the lease over first)
        a.lease.release()
        a.lease.owner_pid = FOREIGN_PID
        assert a.lease.acquire()
        delta_b = _obs([seg], np.random.default_rng(2), 8,
                       with_transitions=False)
        with pytest.raises(LeaseHeldElsewhere):
            b.ingest(delta_b, ingest_key="b-key")
        with pytest.raises(LeaseHeldElsewhere):
            b.compact()
        # and ingest_dir refuses up front without quarantining anything
        spool = tmp_path / "spool"
        spool.mkdir()
        (spool / "tilefile").write_text("segment_id\n")
        with pytest.raises(LeaseHeldElsewhere):
            ingest_dir(b, str(spool))
        assert (spool / "tilefile").exists()



def _multi_partition_ids():
    """Segment ids spanning two level-2 partitions and one level-1."""
    return ([make_segment_id(2, 100, i) for i in range(6)]
            + [make_segment_id(2, 101, i) for i in range(5)]
            + [make_segment_id(1, 40, i) for i in range(4)])


@pytest.mark.usefixtures("pkg")
class TestBatchedQueries:
    def test_query_many_parity_with_singles(self, tmp_path):
        ids = _multi_partition_ids()
        ds = _seed_store(tmp_path / "s", ids, deltas=3, n_obs=400)
        many = ds.query_many(ids)
        singles = [ds.query(s) for s in ids]
        assert many == singles

    def test_hours_subset_and_percentiles_parity(self, tmp_path):
        ids = _multi_partition_ids()
        ds = _seed_store(tmp_path / "s", ids, deltas=2, n_obs=300)
        hours = list(range(5, 40))
        pcts = (10.0, 50.0, 99.0)
        many = ds.query_many(ids, hours=hours, percentiles=pcts)
        singles = [ds.query(s, hours=hours, percentiles=pcts)
                   for s in ids]
        assert many == singles

    def test_duplicates_and_input_order(self, tmp_path):
        ids = _multi_partition_ids()
        ds = _seed_store(tmp_path / "s", ids, deltas=1, n_obs=100)
        asked = [ids[3], ids[0], ids[3], ids[7]]
        got = ds.query_many(asked)
        assert [g["segment_id"] for g in got] == asked
        assert got[0] == got[2] == ds.query(ids[3])
        # duplicates are equal but independent dicts: mutating one
        # answer must not contaminate its twin
        assert got[0] is not got[2]
        got[0]["transitions"].append({"next_id": -1, "count": 0})
        assert got[2] == ds.query(ids[3])

    def test_empty_results(self, tmp_path):
        ids = _multi_partition_ids()
        ds = _seed_store(tmp_path / "s", ids, deltas=1, n_obs=100)
        absent_same_partition = make_segment_id(2, 100, 4000)
        absent_partition = make_segment_id(2, 777, 1)
        got = ds.query_many([absent_same_partition, absent_partition])
        for g, seg in zip(got, (absent_same_partition, absent_partition)):
            assert g == ds.query(seg)
            assert g["count"] == 0 and g["mean_kph"] is None
            assert g["percentiles"]["p50"] is None
            assert g["transitions"] == []
        assert ds.query_many([]) == []

    def test_handle_lru_survives_mid_sweep_compaction(self, tmp_path):
        """The compactor swapping a manifest mid-sweep must not tear a
        reader: handles fetched before the swap stay valid mmaps
        (POSIX unlink), and answers are count-preserving across it."""
        ids = [make_segment_id(2, 100, i) for i in range(4)]
        ds = _seed_store(tmp_path / "s", ids, deltas=4, n_obs=200)
        before = ds.query_many(ids)
        parts = ds.live_segments(2, 100)  # the mid-sweep handles
        assert len(parts) == 4
        ds.compact()  # manifest swap + segment dir deletion
        # the pre-swap handles still read (old mmaps)
        total_pre = sum(int(np.asarray(p.hist_count).sum())
                        for p in parts)
        after = ds.query_many(ids)
        assert sum(r["count"] for r in after) == total_pre
        for b, a in zip(before, after):
            assert b["count"] == a["count"]
            assert b["mean_kph"] == a["mean_kph"]

    def test_batched_segment_counter(self, tmp_path):
        ids = _multi_partition_ids()
        ds = _seed_store(tmp_path / "s", ids, deltas=1, n_obs=64)
        c0 = metrics.default.counter("datastore.query.batched_segments")
        ds.query_many(ids)
        assert metrics.default.counter(
            "datastore.query.batched_segments") == c0 + len(ids)


@pytest.mark.usefixtures("pkg")
class TestBboxQueries:
    def _geo_store(self, tmp_path):
        t = TileHierarchy().tiles(2)
        tiles = {"berlin": t.tile_id(52.5, 13.4),
                 "nearby": t.tile_id(52.5, 13.7),
                 "far": t.tile_id(-33.9, 151.2)}
        ids = {name: [make_segment_id(2, tile, i) for i in range(3)]
               for name, tile in tiles.items()}
        ds = LocalDatastore(str(tmp_path / "geo"))
        rng = np.random.default_rng(5)
        for name, segs in ids.items():
            ds.ingest(_obs(segs, rng, 60), ingest_key=f"geo-{name}")
        return ds, tiles, ids

    def test_bbox_selects_resident_partitions(self, tmp_path):
        ds, tiles, ids = self._geo_store(tmp_path)
        out = ds.query_bbox([13.0, 52.0, 14.0, 53.0], 2)
        got = {r["segment_id"] for r in out["segments"]}
        assert got == set(ids["berlin"]) | set(ids["nearby"])
        assert out["n_segments"] == 6 and not out["truncated"]
        # each answer equals its single query
        for r in out["segments"]:
            assert r == ds.query(r["segment_id"])

    def test_world_bbox_clamps_and_catches_everything(self, tmp_path):
        ds, _tiles, ids = self._geo_store(tmp_path)
        out = ds.query_bbox([-500.0, -200.0, 500.0, 200.0], 2)
        assert {r["segment_id"] for r in out["segments"]} \
            == {s for segs in ids.values() for s in segs}

    def test_resident_ids_cached_and_invalidated(self, tmp_path):
        """The bbox enumeration's resident-id list caches keyed by
        manifest content — an append re-keys it (new ids appear), the
        cache never serves a stale set."""
        ds, tiles, ids = self._geo_store(tmp_path)
        tile = tiles["berlin"]
        got1 = ds.resident_segments(2, tile)
        assert set(got1.tolist()) == set(ids["berlin"])
        got2 = ds.resident_segments(2, tile)
        assert got2 is got1  # cache hit: same array object
        new_seg = make_segment_id(2, tile, 99)
        ds.ingest(_obs([new_seg], np.random.default_rng(8), 10),
                  ingest_key="fresh")
        got3 = ds.resident_segments(2, tile)
        assert new_seg in got3.tolist()

    def test_truncation_is_explicit(self, tmp_path):
        ds, _tiles, _ids = self._geo_store(tmp_path)
        out = ds.query_bbox([-180, -90, 180, 90], 2, max_segments=2)
        assert out["truncated"] and len(out["segments"]) == 2

    def test_validation(self, tmp_path):
        ds, _t, _i = self._geo_store(tmp_path)
        with pytest.raises(ValueError):
            query_bbox(ds, [10, 10, 5, 5], 2)  # empty box (lat)
        with pytest.raises(ValueError):
            query_bbox(ds, [0, 0, 1, 1], 9)  # unknown level

    def test_antimeridian_bbox_wraps(self, tmp_path):
        """maxx < minx is an antimeridian crossing, not an error —
        the reference _split_antimeridian semantics (core/tiles.py)."""
        t = TileHierarchy().tiles(2)
        fiji_e = [make_segment_id(2, t.tile_id(-17.8, 179.6), i)
                  for i in range(2)]
        fiji_w = [make_segment_id(2, t.tile_id(-17.8, -179.6), i)
                  for i in range(2)]
        ds = LocalDatastore(str(tmp_path / "fiji"))
        rng = np.random.default_rng(6)
        ds.ingest(_obs(fiji_e + fiji_w, rng, 40), ingest_key="fiji")
        out = ds.query_bbox([179.0, -19.0, -179.0, -16.0], 2)
        assert {r["segment_id"] for r in out["segments"]} \
            == set(fiji_e) | set(fiji_w)

    def test_zero_width_bbox_is_not_a_world_wrap(self, tmp_path):
        """min_lon == max_lon is a degenerate one-column viewport —
        it must NOT trip the antimeridian wrap into a whole-world
        sweep."""
        ds, _tiles, ids = self._geo_store(tmp_path)
        out = ds.query_bbox([13.4, 52.0, 13.4, 53.0], 2)
        got = {r["segment_id"] for r in out["segments"]}
        assert got == set(ids["berlin"])  # never 'far' (Sydney)

    def test_bbox_tile_range_matches_tile_bbox_edges(self):
        """Boundary clamps agree with Tiles.tile_bbox round trips: a
        bbox equal to one tile's own bbox selects exactly that tile
        (the shared max edge belongs to the neighbour, which the range
        includes — same contract as tiles_for_bbox)."""
        t = TileHierarchy().tiles(2)
        tile = t.tile_id(52.5, 13.4)
        bb = t.tile_bbox(tile)
        r0, r1, c0, c1, ncols = bbox_tile_range(
            [bb.minx, bb.miny, bb.maxx, bb.maxy], 2)
        assert r0 * ncols + c0 == tile
        ids = bbox_partitions([bb.minx, bb.miny, bb.maxx, bb.maxy], 2)
        assert tile in ids and len(ids) == 4  # + max-edge neighbours
        # world max corner clamps instead of erroring
        r0b, r1b, c0b, c1b, _ = bbox_tile_range([179.9, 89.9, 999, 999],
                                                2)
        assert r1b == t.nrows - 1 and c1b == t.ncolumns - 1


@pytest.mark.usefixtures("pkg")
class TestBackgroundCompactor:
    def _pressured(self, tmp_path, deltas=4):
        seg = make_segment_id(2, 61, 2)
        return _seed_store(tmp_path / "s", [seg], deltas=deltas,
                           n_obs=64), seg

    def test_run_once_compacts_over_pressure(self, tmp_path):
        ds, _seg = self._pressured(tmp_path)
        comp = BackgroundCompactor(ds, max_deltas=1, interval_s=0.0)
        backlog = comp.pending(refresh=True)
        assert backlog["partitions_over"] == 1
        assert backlog["delta_segments"] == 4
        assert backlog["delta_bytes"] > 0
        got = comp.run_once()
        assert got["compacted"] == 1
        assert comp.pending()["partitions_over"] == 0
        names = ds._read_manifest(ds.partition_dir(2, 61))["segments"]
        assert names == ["base-000005"]

    def test_below_pressure_skips(self, tmp_path):
        ds, _seg = self._pressured(tmp_path, deltas=2)
        comp = BackgroundCompactor(ds, max_deltas=4, interval_s=0.0)
        got = comp.run_once()
        assert got["compacted"] == 0

    def test_unleased_process_gauges_but_never_compacts(self, tmp_path):
        ds, _seg = self._pressured(tmp_path)
        ds.lease.release()  # the seeding held it under our real pid
        other = StoreLease(ds.root, ttl_s=60.0)
        other.owner_pid = FOREIGN_PID
        assert other.acquire()
        comp = BackgroundCompactor(ds, max_deltas=1, interval_s=0.0)
        u0 = metrics.default.counter("datastore.compactor.unleased")
        got = comp.run_once()
        assert got.get("unleased") and got["compacted"] == 0
        assert got["backlog"]["partitions_over"] == 1  # still gauging
        assert metrics.default.counter(
            "datastore.compactor.unleased") == u0 + 1
        names = ds._read_manifest(ds.partition_dir(2, 61))["segments"]
        assert len(names) == 4  # untouched

    def test_thread_lifecycle(self, tmp_path):
        ds, _seg = self._pressured(tmp_path)
        comp = BackgroundCompactor(ds, max_deltas=1,
                                   interval_s=0.005).start()
        deadline = 200
        while comp.pending(refresh=True)["partitions_over"] \
                and deadline > 0:
            import time
            time.sleep(0.01)
            deadline -= 1
        comp.stop()
        assert comp.pending()["partitions_over"] == 0
        assert comp._thread is None

    def test_crashed_commit_orphan_is_cleared(self, tmp_path):
        """A holder SIGKILLed between segment rename and manifest
        write leaves an orphan dir at the NEXT seq's name; the next
        holder's commit at that seq must replace it, not ENOTEMPTY."""
        import shutil
        ds, _seg = self._pressured(tmp_path, deltas=3)
        pdir = ds.partition_dir(2, 61)
        # fabricate the crash artifact: the would-be base-000004 dir
        # renamed in place, manifest never rewritten
        src = os.path.join(pdir, "delta-000001")
        orphan = os.path.join(pdir, "base-000004")
        shutil.copytree(src, orphan)
        before = ds.query(make_segment_id(2, 61, 2))
        assert ds.compact()["partitions"] == 1  # no ENOTEMPTY
        manifest = ds._read_manifest(pdir)
        assert manifest["segments"] == ["base-000004"]
        assert ds.query(make_segment_id(2, 61, 2)) == before

    def test_zero_interval_never_starts(self, tmp_path):
        ds, _seg = self._pressured(tmp_path)
        comp = BackgroundCompactor(ds, max_deltas=1, interval_s=0.0)
        comp.start()
        assert comp._thread is None
        comp.stop()

    def test_stop_then_start_compacts_again(self, tmp_path):
        """A stopped compactor must be restartable — a set stop event
        carried into the fresh thread would kill it on its first
        wait() and compaction would silently cease."""
        import time
        ds, seg = self._pressured(tmp_path, deltas=4)
        comp = BackgroundCompactor(ds, max_deltas=1,
                                   interval_s=0.005).start()
        comp.stop()
        rng = np.random.default_rng(9)
        for d in range(4):  # fresh pressure after the stop
            ds.ingest(_obs([seg], rng, 32), ingest_key=f"again-{d}")
        comp.start()
        deadline = 200
        while comp.pending(refresh=True)["partitions_over"] \
                and deadline > 0:
            time.sleep(0.01)
            deadline -= 1
        comp.stop()
        assert comp.pending()["partitions_over"] == 0


@pytest.mark.usefixtures("pkg")
class TestWalkerSkips:
    def test_scan_tiles_skips_lease_and_profile(self, tmp_path):
        root = tmp_path / "store"
        seg = make_segment_id(2, 9, 1)
        ds = _seed_store(root, [seg], deltas=1, n_obs=8)
        ds.lease._deadline = 0.0
        ds.lease.acquire()  # writes .lease
        (root / PROFILE_NAME).write_text('{"version":1,"pairs":[]}')
        names = {os.path.basename(p) for p in scan_tiles(str(root))}
        assert LEASE_NAME not in names
        assert PROFILE_NAME not in names

    def test_spool_accounting_skips_control_files(self, tmp_path):
        spool = _imp("utils", "spool")
        root = tmp_path / "spool"
        root.mkdir()
        (root / "tile1").write_text("data")
        (root / LEASE_NAME).write_text('{"pid": 1}')
        (root / PROFILE_NAME).write_text("{}")
        got = spool.backlog(str(root))
        assert got["files"] == 1 and got["bytes"] == 4


@pytest.fixture
def synth_city(pkg):
    build_grid_city = _imp("synth", "build_grid_city")
    return build_grid_city(rows=7, cols=7, spacing_m=220.0, seed=11,
                           service_road_fraction=0.0,
                           internal_fraction=0.0)


def _native_matcher(city):
    m = _matcher(city)
    assert m.runtime is not None, "the native runtime did not build"
    return m


def _city_requests(city, n=6, seed=23):
    generate_trace = _imp("synth", "generate_trace")
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        tr = None
        while tr is None:
            tr = generate_trace(city, f"warm-{i}", rng, noise_m=3.0,
                                min_route_edges=8)
        reqs.append(tr.request_json())
    return reqs


@pytest.mark.usefixtures("pkg")
class TestProfileWarm:
    def test_export_load_warm_roundtrip(self, synth_city, tmp_path,
                                        monkeypatch):
        _one_prep_thread(monkeypatch)
        matcher = _native_matcher(synth_city)
        reqs = _city_requests(synth_city)
        matcher.match_many(reqs)
        path = profile_path(str(tmp_path))
        art = export_profile(matcher, path, city="testville")
        assert art["n_pairs"] > 0
        assert art["memo_stats"]["size"] > 0
        loaded = load_profile(path)
        assert loaded["city"] == "testville"
        assert loaded["pairs"] == art["pairs"]

        # a FRESH matcher (cold memo): the pre-warm inserts the pairs,
        # and the same first request batch now hits the shared memo —
        # where a cold matcher's first batch records zero shared hits
        cold = _native_matcher(synth_city)
        assert cold.runtime.route_memo_stats()["hits"] == 0
        cold.match_many(reqs)
        cold_hits = cold.runtime.route_memo_stats()["hits"]
        assert cold_hits == 0  # single prep slot: local memo soaks all

        warm = _native_matcher(synth_city)
        warmed = warm_matcher(warm, loaded)
        assert warmed == art["n_pairs"]
        assert warm.runtime.route_memo_stats()["size"] >= warmed
        warm.match_many(reqs)
        assert warm.runtime.route_memo_stats()["hits"] > 0

    def test_warm_results_bit_identical(self, synth_city, monkeypatch,
                                        tmp_path):
        """The pre-warm changes latency, never answers: a warmed
        matcher's reports equal a cold matcher's byte-for-byte."""
        _one_prep_thread(monkeypatch)
        report_json = _imp("service.report", "report_json")
        matcher = _native_matcher(synth_city)
        reqs = _city_requests(synth_city)
        matcher.match_many(reqs)
        path = profile_path(str(tmp_path))
        export_profile(matcher, path)

        def bodies(m):
            out = []
            for req, match in zip(reqs, m.match_many(reqs)):
                out.append(report_json(match, req, 15, {0, 1, 2},
                                       {0, 1, 2}))
            return out

        cold = _native_matcher(synth_city)
        warm = _native_matcher(synth_city)
        warm_matcher(warm, load_profile(path))
        assert bodies(cold) == bodies(warm)

    def test_load_profile_absent_and_corrupt(self, tmp_path):
        assert load_profile(str(tmp_path / "nope")) is None
        bad = tmp_path / PROFILE_NAME
        bad.write_text("{not json")
        assert load_profile(str(bad)) is None
        bad.write_text('{"version": 99}')
        assert load_profile(str(bad)) is None

    def test_malformed_pairs_cost_only_the_warm(self, synth_city,
                                                monkeypatch):
        """Ragged / non-pair 'pairs' in a version-1 artifact skip the
        pre-warm instead of raising out of the city load."""
        _one_prep_thread(monkeypatch)
        matcher = _native_matcher(synth_city)
        assert warm_matcher(matcher, {"version": 1,
                                      "pairs": [[1, 2], [3]]}) == 0
        assert warm_matcher(matcher, {"version": 1,
                                      "pairs": [1, 2]}) == 0

    def test_warm_on_fallback_is_zero(self, synth_city, tmp_path):
        SegmentMatcher = _imp("matcher", "SegmentMatcher")
        m = _matcher(synth_city, native=False)
        prof = {"version": 1, "pairs": [[0, 1]]}
        assert warm_matcher(m, prof) == 0
        assert warm_matcher(m, None) == 0

    def test_foreign_graph_pairs_skipped(self, synth_city, monkeypatch):
        _one_prep_thread(monkeypatch)
        matcher = _native_matcher(synth_city)
        n_edges = int(matcher.net.num_edges)
        prof = {"version": 1,
                "pairs": [[0, 1], [n_edges + 5, 0], [-3, 2]]}
        assert warm_matcher(matcher, prof) == 1



@pytest.mark.usefixtures("pkg")
class TestHealthDatastoreBlocks:
    def test_health_carries_lease_and_compactor(self, synth_city,
                                                tmp_path):
        SegmentMatcher = _imp("matcher", "SegmentMatcher")
        ReporterService = _imp("service.server", "ReporterService")
        seg = make_segment_id(2, 305, 4)
        ds = _seed_store(tmp_path / "s", [seg], deltas=2, n_obs=16)
        service = ReporterService(
            _matcher(synth_city, native=False),
            datastore=ds)
        service.compactor = BackgroundCompactor(ds, max_deltas=1,
                                                interval_s=0.0)
        service.compactor.pending(refresh=True)
        try:
            code, body = service.health()
            got = json.loads(body)
            assert got["datastore"]["lease"]["enabled"]
            assert got["compaction"]["partitions_over"] == 1
        finally:
            service.dispatcher.close()


@pytest.mark.usefixtures("pkg")
class TestDatastoreCliBatched:
    def test_query_segments_and_bbox(self, tmp_path, capsys):
        datastore_cli = _imp("tools", "datastore_cli")
        t = TileHierarchy().tiles(2)
        tile = t.tile_id(52.5, 13.4)
        ids = [make_segment_id(2, tile, i) for i in range(3)]
        ds = _seed_store(tmp_path / "s", ids, deltas=1, n_obs=60)
        assert datastore_cli.main(
            ["query", str(tmp_path / "s"),
             "--segments", ",".join(str(i) for i in ids)]) == 0
        got = json.loads(capsys.readouterr().out.strip())
        assert got["results"] == ds.query_many(ids)
        assert datastore_cli.main(
            ["query", str(tmp_path / "s"),
             "--bbox", "13.0,52.0,14.0,53.0", "--bbox-level", "2"]) == 0
        got = json.loads(capsys.readouterr().out.strip())
        assert {r["segment_id"] for r in got["segments"]} == set(ids)

    def test_profile_show_absent(self, tmp_path, capsys):
        datastore_cli = _imp("tools", "datastore_cli")
        seg = make_segment_id(2, 9, 1)
        _seed_store(tmp_path / "s", [seg], deltas=1, n_obs=8)
        assert datastore_cli.main(["profile", str(tmp_path / "s")]) == 0
        got = json.loads(capsys.readouterr().out.strip())
        assert got["present"] is False

    def test_profile_export_via_replay(self, synth_city, tmp_path,
                                       capsys, monkeypatch):
        _one_prep_thread(monkeypatch)
        datastore_cli = _imp("tools", "datastore_cli")
        seg = make_segment_id(2, 9, 1)
        store = tmp_path / "s"
        _seed_store(store, [seg], deltas=1, n_obs=8)
        graph = tmp_path / "city.npz"
        synth_city.save(str(graph))
        replay = tmp_path / "traces.jsonl"
        with open(replay, "w") as f:
            for r in _city_requests(synth_city, n=3):
                f.write(json.dumps(r) + "\n")
        assert datastore_cli.main(
            ["profile", str(store), "--graph", str(graph),
             "--replay", str(replay), "--city", "cli-town"]
            + ([] if _jax() else ["--device", "cpu"])) == 0
        got = json.loads(capsys.readouterr().out.strip())
        assert got["replayed"] == 3 and got["n_pairs"] > 0
        art = load_profile(str(store / PROFILE_NAME))
        assert art["city"] == "cli-town"
        assert len(art["pairs"]) == got["n_pairs"]


@pytest.mark.usefixtures("pkg")
class TestDatastoreFaults:
    def test_datastore_health(self, city, tmp_path):
        LocalDatastore = _imp("datastore", "LocalDatastore")
        SegmentMatcher = _imp("matcher", "SegmentMatcher")
        ReporterService = _imp("service.server", "ReporterService")
        ds = LocalDatastore(str(tmp_path / "store"))
        service = ReporterService(_matcher(city), datastore=ds)
        code, body = service.health()
        assert code == 200
        assert json.loads(body)["datastore"]["status"] == "ok"

    def test_datastore_commit_failpoint(self, tmp_path):
        import numpy as np
        LocalDatastore = _imp("datastore", "LocalDatastore")
        ObservationBatch = _imp("datastore.schema", "ObservationBatch")
        ds = LocalDatastore(str(tmp_path / "store"))
        obs = ObservationBatch(
            segment_id=np.array([1 << 25], dtype=np.int64),
            next_id=np.array([2 << 25], dtype=np.int64),
            duration_s=np.array([30.0]),
            count=np.array([1], dtype=np.int64),
            length_m=np.array([500], dtype=np.int64),
            queue_m=np.array([0], dtype=np.int64),
            min_ts=np.array([1500000000], dtype=np.int64),
            max_ts=np.array([1500000030], dtype=np.int64))
        faults.configure("datastore.commit=error")
        with pytest.raises(faults.FaultError):
            ds.ingest(obs)
        faults.clear()
        assert ds.ingest(obs) == 1


    def test_tile_replay_reaches_sink_and_store(self, tmp_path):
        Segment = _imp("core.types", "Segment")
        LocalDatastore = _imp("datastore", "LocalDatastore")
        TileSink = _imp("streaming.anonymiser", "TileSink")
        DeadLetterDrainer = _imp("streaming.drainer", "DeadLetterDrainer")
        metrics.default.reset()
        root = str(tmp_path / "dl")
        seg = Segment(1 << 25, 2 << 25, 1500000000, 1500000030, 500, 0)
        payload = "\n".join([Segment.column_layout(),
                             seg.csv_row("AUTO", "t")])
        tile_rel = "1500000000_1500003599/0/100"
        os.makedirs(os.path.join(root, tile_rel))
        with open(os.path.join(root, tile_rel, "t.e00000003"), "w") as f:
            f.write(payload)
        out = str(tmp_path / "out")
        store = LocalDatastore(str(tmp_path / "store"))
        d = DeadLetterDrainer(root, sink=TileSink(out), datastore=store)
        assert d.drain_now() == 1
        assert os.path.exists(os.path.join(out, tile_rel, "t.e00000003"))
        assert d.backlog()["tiles"] == 0
        assert store.stats()["rows"] == 1
        # the replay recorded its ledger key: re-ingesting the sink
        # tree into the same store is a pure no-op
        ingest_dir = _imp("datastore", "ingest_dir")
        assert ingest_dir(store, out)["rows"] == 0


@pytest.mark.usefixtures("pkg")
class TestIngestLedger:
    """The manifest (source, writer, epoch, tile) dedupe ledger."""

    def _obs(self):
        ObservationBatch = _imp("datastore.schema", "ObservationBatch")
        return ObservationBatch(
            segment_id=np.array([1 << 25], dtype=np.int64),
            next_id=np.array([2 << 25], dtype=np.int64),
            duration_s=np.array([30.0]),
            count=np.array([1], dtype=np.int64),
            length_m=np.array([500], dtype=np.int64),
            queue_m=np.array([0], dtype=np.int64),
            min_ts=np.array([1500000000], dtype=np.int64),
            max_ts=np.array([1500000030], dtype=np.int64))

    def test_keyed_ingest_dedupes_and_survives_compaction(self,
                                                          tmp_path):
        LocalDatastore = _imp("datastore", "LocalDatastore")
        metrics.default.reset()
        ds = LocalDatastore(str(tmp_path / "store"))
        assert ds.ingest(self._obs(), ingest_key="a/b/c/t.e0") == 1
        assert ds.ingest(self._obs(), ingest_key="a/b/c/t.e0") == 0
        assert metrics.default.counter("datastore.ingest.deduped") == 1
        assert ds.ingest(self._obs(), ingest_key="a/b/c/t.e1") == 1
        ds.compact()
        # the ledger rides the compacted manifest: old keys still dedupe
        assert ds.ingest(self._obs(), ingest_key="a/b/c/t.e0") == 0
        assert ds.ingest(self._obs(), ingest_key="a/b/c/t.e2") == 1
        assert ds.stats()["rows"] == 3

    def test_ledger_cap_slides_dedupe_window(self, tmp_path,
                                             monkeypatch):
        """REPORTER_TPU_INGEST_LEDGER_MAX bounds the per-partition
        ledger: oldest keys age out (counted), the newest N keep
        deduping — the manifest cannot grow one key per flush forever."""
        LocalDatastore = _imp("datastore", "LocalDatastore")
        metrics.default.reset()
        monkeypatch.setenv("REPORTER_TPU_INGEST_LEDGER_MAX", "2")
        ds = (LocalDatastore(str(tmp_path / "store")) if _jax()
              else LocalDatastore(str(tmp_path / "store"), ledger_max=2))
        for epoch in range(3):
            assert ds.ingest(self._obs(),
                             ingest_key=f"a/b/c/t.e{epoch}") == 1
        assert metrics.default.counter(
            "datastore.ingest.ledger_evicted") == 1
        # newest two keys still dedupe...
        assert ds.ingest(self._obs(), ingest_key="a/b/c/t.e2") == 0
        assert ds.ingest(self._obs(), ingest_key="a/b/c/t.e1") == 0
        # ...the evicted oldest is outside the window again (documented
        # slide: replays older than the cap rely on `ingest --delete`)
        assert ds.ingest(self._obs(), ingest_key="a/b/c/t.e0") == 1

    def test_unkeyed_ingest_never_dedupes(self, tmp_path):
        LocalDatastore = _imp("datastore", "LocalDatastore")
        ds = LocalDatastore(str(tmp_path / "store"))
        assert ds.ingest(self._obs()) == 1
        assert ds.ingest(self._obs()) == 1
        assert ds.stats()["rows"] == 2

    def test_anonymiser_threads_flush_identity_to_tee(self, tmp_path):
        import re

        Segment = _imp("core.types", "Segment")
        Anonymiser = _imp("streaming.anonymiser", "Anonymiser")
        TileSink = _imp("streaming.anonymiser", "TileSink")
        keys = []

        def tee(_tile, segments, ingest_key=None):
            keys.append(ingest_key)

        a = Anonymiser(TileSink(str(tmp_path / "out")), privacy=1,
                       quantisation=3600, source="src", tee=tee)
        a.process("k", Segment(1 << 25, 2 << 25, 1500000000,
                               1500000030, 500, 0))
        a.punctuate()
        assert len(keys) == 1
        # the key IS the tile file's relpath: {t0}_{t1}/{level}/{tile}/
        # {source}.e{epoch:08d} — what ingest_dir derives on a replay
        assert re.fullmatch(r"\d+_\d+/\d/\d+/src\.e00000000", keys[0])
        rel = os.path.join(str(tmp_path / "out"),
                           keys[0].replace("/", os.sep))
        assert os.path.exists(rel)

    def test_legacy_two_arg_tee_still_works(self, tmp_path):
        Segment = _imp("core.types", "Segment")
        Anonymiser = _imp("streaming.anonymiser", "Anonymiser")
        TileSink = _imp("streaming.anonymiser", "TileSink")
        seen = []
        a = Anonymiser(TileSink(str(tmp_path / "out")), privacy=1,
                       quantisation=3600, source="src",
                       tee=lambda t, segs: seen.append(len(segs)))
        a.process("k", Segment(1 << 25, 2 << 25, 1500000000,
                               1500000030, 500, 0))
        a.punctuate()
        assert seen == [1]


@pytest.mark.usefixtures("pkg")
class TestHealthDegradedBlock:
    def test_open_decode_circuit_flips_health(self):
        SegmentMatcher = _imp("matcher", "SegmentMatcher")

    def _flush(self, root, segs):
        tile_dir = os.path.join(root, "1483344000_1483347599", "2", "756425")
        os.makedirs(tile_dir, exist_ok=True)
        with open(os.path.join(tile_dir, "t.abc"), "w") as f:
            f.write("\n".join([Segment.column_layout()]
                              + [s.csv_row("AUTO", "t") for s in segs]))

    def test_ingest_compact_query_stats(self, capsys, tmp_path):
        make_segment_id = _imp("core.osmlr", "make_segment_id")
        main = _imp("tools.datastore_cli", "main")
        sid = make_segment_id(2, 756425, 10)
        segs = [Segment(sid, None, 1483344000 + i * 30,
                        1483344000 + i * 30 + 10, 100, 0) for i in range(8)]
        results = tmp_path / "results"
        store = str(tmp_path / "store")
        self._flush(str(results), segs)

        assert main(["ingest", store, str(results), "--delete"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["files"] == 1 and out["rows"] == 8
        assert "datastore.ingest.parse" in out["metrics"]
        # --delete consumed the tile file (replay-safe)
        assert not any(files for _r, _d, files in os.walk(results))

        assert main(["compact", store]) == 0
        assert json.loads(capsys.readouterr().out)["partitions"] == 1

        assert main(["query", store, "--segment", str(sid),
                     "--hours", "7-9", "--percentiles", "50"]) == 0
        q = json.loads(capsys.readouterr().out)
        assert q["count"] == 8 and q["mean_kph"] == pytest.approx(36.0)
        assert list(q["percentiles"]) == ["p50"]

        assert main(["stats", store]) == 0
        s = json.loads(capsys.readouterr().out)
        assert s["partitions"] == 1 and s["rows"] == 8



# ---- parity: the same seeded inputs through both packages ------------------

import reporter_tpu.datastore as jax_ds  # noqa: E402
import reporter_tpu_torch.datastore as port_ds  # noqa: E402
from reporter_tpu.core import types as jax_types  # noqa: E402
from reporter_tpu_torch.core import types as port_types  # noqa: E402

BOTH = (jax_ds, port_ds)
#: level-2 tiles around Berlin and one far away, and a level-1 and a
#: level-0 tile: bbox queries at every level find something
_TILES = ((2, 2_000_000 + 2 * 1440 + 5), (2, 2_000_000 + 2 * 1440 + 6),
          (2, 310_000), (1, 123_456 // 16), (0, 1_000))


def _seg_ids():
    return [make_segment_id(level, tile % (1 << 22), i)
            for level, tile in _TILES for i in range(7)]


def _obs_batch(mod, seed, n=600, ids=None):
    """A seeded batch over ``ids``: a third invalid rows (zero duration,
    zero length or no next segment), speeds 0-130 kph over a week."""
    rng = np.random.default_rng(seed)
    ids = np.asarray(ids if ids is not None else _seg_ids(), np.int64)
    dur = rng.uniform(0, 60, n).round()
    nxt = rng.choice(ids, n)
    nxt[rng.random(n) < 0.2] = INVALID_SEGMENT_ID
    t0 = rng.integers(MON_8AM, MON_8AM + 7 * 86400, n)
    return mod.ObservationBatch(
        segment_id=rng.choice(ids, n), next_id=nxt,
        duration_s=dur, count=rng.integers(1, 4, n),
        length_m=(dur * rng.uniform(0, 36, n)).astype(np.int64),
        queue_m=rng.integers(-1, 40, n), min_ts=t0,
        max_ts=t0 + dur.astype(np.int64))


def _store_tree(root):
    """{relpath: bytes} of a store: every ``.npy`` column and manifest as
    they are, ``meta.json`` with its wall-clock ``created`` masked; dot
    entries (the lease, stage dirs) left out."""
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith("."))
        for name in sorted(files):
            if name.startswith("."):
                continue
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                raw = f.read()
            if name == "meta.json":
                meta = json.loads(raw)
                meta.pop("created")
                raw = json.dumps(meta, sort_keys=True).encode()
            out[os.path.relpath(path, root)] = raw
    return out


def _js(obj):
    return json.dumps(obj, sort_keys=True)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_aggregate_gives_equal_deltas(seed):
    want = jax_ds.aggregate(_obs_batch(jax_ds, seed))
    got = port_ds.aggregate(_obs_batch(port_ds, seed))
    assert sorted(got) == sorted(want) and len(got) == len(_TILES)
    for part in want:
        for col in ("hist_key", "hist_count", "hist_speed_sum",
                    "trans_from", "trans_to", "trans_count"):
            a, b = getattr(want[part], col), getattr(got[part], col)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), col
    merged = [m.merge_deltas(list(m.aggregate(_obs_batch(m, seed))
                                  .values())[:2]) for m in BOTH]
    assert merged[0].hist_key.tobytes() == merged[1].hist_key.tobytes()
    assert merged[0].hist_speed_sum.tobytes() \
        == merged[1].hist_speed_sum.tobytes()


def _ingest_history(mod, root):
    ds = mod.LocalDatastore(str(root))
    for seed in range(4):
        ds.ingest(_obs_batch(mod, seed), ingest_key=f"flush-{seed}")
    return ds


def test_store_columns_equal_after_ingest_compaction_and_reingest(
        tmp_path):
    stores = [_ingest_history(m, tmp_path / m.__name__) for m in BOTH]
    trees = [_store_tree(s.root) for s in stores]
    assert trees[1] == trees[0]
    assert sum(p.endswith(".npy") for p in trees[0]) == 6 * 4 * len(_TILES)
    for s in stores:
        s.compact()
    trees = [_store_tree(s.root) for s in stores]
    assert trees[1] == trees[0]
    # a keyed re-ingest dedupes in both; a new key lands in both
    for m, s in zip(BOTH, stores):
        assert s.ingest(_obs_batch(m, 2), ingest_key="flush-2") == 0
        assert s.ingest(_obs_batch(m, 9), ingest_key="flush-9") > 0
    trees = [_store_tree(s.root) for s in stores]
    assert trees[1] == trees[0]
    stats = [s.stats() for s in stores]
    # meta.json's wall-clock "created" is in the byte count: its digits
    # vary from run to run
    assert abs(stats[1].pop("bytes") - stats[0].pop("bytes")) < 64
    assert _js(stats[1]) == _js(stats[0])
    assert stores[1].merged_cells() == stores[0].merged_cells()


def _query_cases():
    ids = _seg_ids()
    berlin = [13.0, 52.0, 14.0, 53.0]
    return {
        "single": lambda ds: ds.query(ids[3]),
        "single_absent": lambda ds: ds.query(make_segment_id(2, 7, 7)),
        "many": lambda ds: ds.query_many(ids + ids[:5] + [12345]),
        "hours": lambda ds: ds.query_many(ids, hours=[7, 8, 9, 30, 167]),
        "time_range": lambda ds: ds.query(
            ids[1], hours=jax_ds.hours_for_range(
                MON_8AM, MON_8AM + 3 * 86400).tolist()),
        "percentiles": lambda ds: ds.query_many(
            ids[:9], percentiles=(5.0, 50.0, 99.5)),
        "transitions": lambda ds: ds.query(ids[0], max_transitions=2),
        "bbox_l0": lambda ds: ds.query_bbox([-180, -90, 180, 90], 0),
        "bbox_l1": lambda ds: ds.query_bbox([-180, -90, 180, 90], 1),
        "bbox_l2": lambda ds: ds.query_bbox([-180, -90, 180, 90], 2),
        "bbox_berlin": lambda ds: ds.query_bbox(berlin, 2),
        "bbox_wrap": lambda ds: ds.query_bbox([170, -90, -170, 90], 2),
        "bbox_truncated": lambda ds: ds.query_bbox(
            [-180, -90, 180, 90], 2, max_segments=5),
        "window_inf": lambda ds: ds.query_many(ids, window="inf"),
        "window_5m": lambda ds: ds.query_many(ids, window="5m"),
    }


@pytest.mark.parametrize("case", sorted(_query_cases()))
def test_queries_answer_equal_json(tmp_path, case):
    fn = _query_cases()[case]
    stores = [_ingest_history(m, tmp_path / m.__name__) for m in BOTH]
    assert _js(fn(stores[1])) == _js(fn(stores[0]))
    for s in stores:
        s.compact()
    assert _js(fn(stores[1])) == _js(fn(stores[0]))


def test_epoch_pin_and_merge_answer_equal(tmp_path):
    stores = []
    for m in BOTH:
        ds = m.LocalDatastore(str(tmp_path / m.__name__))
        ds.ingest(_obs_batch(m, 0), ingest_key="legacy")
        ds.set_map_version("aaaa00000001")
        ds.ingest(_obs_batch(m, 1), ingest_key="a")
        ds.set_map_version("bbbb00000002")
        ds.ingest(_obs_batch(m, 2), ingest_key="a")
        ds.compact()
        stores.append(ds)
    assert _store_tree(stores[1].root) == _store_tree(stores[0].root)
    ids = _seg_ids()
    for kw in ({}, {"map_version": "aaaa00000001"}, {"merge": True},
               {"map_version": "bbbb00000002", "window": "inf"}):
        assert _js(stores[1].query_many(ids, **kw)) \
            == _js(stores[0].query_many(ids, **kw)), kw
        assert _js(stores[1].query_bbox([-180, -90, 180, 90], 2, **kw)) \
            == _js(stores[0].query_bbox([-180, -90, 180, 90], 2, **kw)), kw
    for s in stores:
        with pytest.raises(ValueError, match="mutually exclusive"):
            s.query(ids[0], map_version="x", merge=True)


def _segments(types, seed, n=300):
    rng = np.random.default_rng(seed)
    ids = _seg_ids()
    out = []
    for _ in range(n):
        t0 = MON_8AM + float(rng.uniform(0, 7 * 86400))
        nxt = None if rng.random() < 0.2 else int(rng.choice(ids))
        out.append(types.Segment(int(rng.choice(ids)), nxt, t0,
                                 t0 + float(rng.uniform(0.4, 120)),
                                 int(rng.integers(1, 900)),
                                 int(rng.integers(0, 30))))
    return out


def test_csv_and_segment_paths_give_the_same_store(tmp_path):
    """Both ingest paths of both packages: ``ingest_segments`` of the
    structs and ``ingest_csv`` of their tile CSV land the same cells."""
    stores = {}
    for m, types in ((jax_ds, jax_types), (port_ds, port_types)):
        segs = _segments(types, 5)
        csv = "\n".join([types.Segment.column_layout()]
                        + [s.csv_row("AUTO", "t") for s in segs])
        a = m.LocalDatastore(str(tmp_path / m.__name__ / "segments"))
        b = m.LocalDatastore(str(tmp_path / m.__name__ / "csv"))
        assert a.ingest_segments(segs) == b.ingest_csv(csv) > 0
        stores[m] = (a, b)
    cells = {s.merged_cells().__repr__() for pair in stores.values()
             for s in pair}
    assert len(cells) == 1
    ids = _seg_ids()
    answers = {_js(s.query_many(ids)) for pair in stores.values()
               for s in pair}
    assert len(answers) == 1
    assert _store_tree(stores[port_ds][0].root) \
        == _store_tree(stores[jax_ds][0].root)
    assert _store_tree(stores[port_ds][1].root) \
        == _store_tree(stores[jax_ds][1].root)


def test_tile_bbox_equals_the_jax_package():
    from dataclasses import astuple
    from reporter_tpu.core.tiles import TileHierarchy as JaxHierarchy
    from reporter_tpu_torch.core.tiles import TileHierarchy as Hierarchy
    rng = np.random.default_rng(8)
    for level in (0, 1, 2):
        a, b = JaxHierarchy().tiles(level), Hierarchy().tiles(level)
        ids = [0, a.max_tile_id] + rng.integers(0, a.max_tile_id,
                                                64).tolist()
        for tid in ids:
            assert astuple(b.tile_bbox(int(tid))) \
                == astuple(a.tile_bbox(int(tid)))
            box = b.tile_bbox(int(tid))
            assert b.tile_id((box.miny + box.maxy) / 2,
                             (box.minx + box.maxx) / 2) == tid
        for bad in (-1, a.max_tile_id + 1):
            with pytest.raises(ValueError):
                b.tile_bbox(bad)


def test_long_hold_ok_locks_are_exempt_from_rc002(tmp_path):
    import time as _time
    from reporter_tpu_torch.analysis import racecheck
    from reporter_tpu_torch.utils import locks
    ok = locks.new_lock("test.long_ok", long_hold_ok=True)
    plain = locks.new_lock("test.long_plain")
    racecheck.reset()
    locks.arm(hold_ms=1.0)
    try:
        with ok:
            _time.sleep(0.01)
        assert not [f for f in racecheck.findings() if f.rule == "RC002"]
        with plain:
            _time.sleep(0.01)
        assert [f for f in racecheck.findings() if f.rule == "RC002"]
    finally:
        locks.disarm()
        racecheck.reset()
    # the store's commit lock is the documented long holder
    store = port_ds.HistogramStore(str(tmp_path))
    assert store._lock.long_hold_ok and not store._handle_lock.long_hold_ok


class _FakeClock:
    def __init__(self, t=float(MON_8AM)):
        self.t = float(t)

    def __call__(self):
        return self.t


@pytest.fixture
def both_servers(tmp_path):
    """The JAX package's ReporterService and the port's, each over its
    own store of the same seeded ingests (freshness on, one fake clock),
    served on ephemeral ports."""
    from reporter_tpu.service import server as jax_server
    from reporter_tpu_torch.service import server as port_server
    clock = _FakeClock()
    out = []
    for m, srv in ((jax_ds, jax_server), (port_ds, port_server)):
        ds = m.LocalDatastore(str(tmp_path / m.__name__))
        ds.enable_freshness(clock=clock)
        for seed in range(3):
            ds.ingest(_obs_batch(m, seed), ingest_key=f"flush-{seed}")
        service = srv.ReporterService(_StubMatcher(), datastore=ds)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        httpd = srv.serve(service, "127.0.0.1", port)
        out.append((f"http://127.0.0.1:{port}", ds, service, httpd))
    yield out, clock
    for _url, _ds, service, httpd in out:
        httpd.shutdown()
        httpd.server_close()


def _call(url, path, body=None):
    req = urllib.request.Request(
        url + path, data=None if body is None else body.encode(),
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read().decode(), r.headers.get("Retry-After")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), e.headers.get("Retry-After")


def _histogram_paths():
    ids = _seg_ids()
    q = urllib.parse.urlencode
    return [
        f"/histogram?segment_id={ids[2]}",
        f"/histogram?segment_id={ids[2]}&hours=7-9&percentiles=10,90",
        f"/histogram?segment_id={ids[4]}&t0={MON_8AM}&t1={MON_8AM + 86400}",
        "/histogram?" + "&".join(f"segment={i}" for i in ids),
        "/histogram?bbox=-180,-90,180,90&level=0",
        "/histogram?bbox=-180,-90,180,90&level=1",
        "/histogram?bbox=-180,-90,180,90&level=2&max_segments=4",
        "/histogram?bbox=13,52,14,53&level=2&window=inf",
        f"/histogram?segment_id={ids[2]}&window=5m",
        "/histogram?viewport=1&bbox=-180,-90,180,90&level=2",
        f"/histogram?segment_id={ids[2]}&map_version=abc&merge=1",
        "/histogram?" + q({"json": json.dumps({"segments": ids[:5]})}),
        # the 400s
        "/histogram",
        f"/histogram?segment_id={ids[2]}&percentiles=150",
        "/histogram?bbox=-180,-90,180,90",
        "/histogram?viewport=1",
        f"/histogram?segment_id={ids[2]}&window=fortnight",
        "/histogram?bbox=1,1,0,0&level=2",
        "/histogram?segment_id=notanumber",
        f"/histogram?segment_id={ids[2]}&city=elsewhere",
        "/histogram?json=notjson",
    ]


def test_histogram_bodies_and_codes_equal_the_jax_service(both_servers):
    (ref, port), _clock = both_servers
    paths = _histogram_paths()
    codes = []
    for path in paths:
        want, got = _call(ref[0], path), _call(port[0], path)
        assert got[:2] == want[:2], path
        codes.append(got[0])
    assert codes.count(200) == 11 and set(codes) == {200, 400}
    for body in ({"segment_id": _seg_ids()[0], "percentiles": [50]},
                 {"bbox": [-180, -90, 180, 90], "level": 2,
                  "hours": [8, 9]},
                 {"segments": _seg_ids()[:3], "window": "inf"},
                 {"time_range": [1, 2, 3], "segment_id": 1}):
        want = _call(ref[0], "/histogram", json.dumps(body))
        got = _call(port[0], "/histogram", json.dumps(body))
        assert got[:2] == want[:2], body


def test_feed_bodies_cursors_and_sheds_equal(both_servers):
    """The same ingests under one fake clock: equal cursors and events
    over HTTP, the waiter shed and the pressure shed equal (429 with
    Retry-After), and a second ingest delivered to both."""
    from reporter_tpu.service import admission as jax_admission
    from reporter_tpu_torch.service import admission as port_admission
    (ref, port), clock = both_servers
    paths = ["/feed?cursor=0&timeout=0.05",
             "/feed?cursor=0&timeout=0.05&bbox=13,52,14,53&level=2",
             "/feed?cursor=1&timeout=0.05&max_events=2",
             "/feed?cursor=-1&timeout=0.05",
             "/feed?cursor=0&timeout=0.05&bbox=13,52,14,53",
             "/feed?cursor=0&timeout=0.05&city=x",
             "/feed?" + urllib.parse.urlencode({"json": json.dumps(
                 {"cursor": 2, "timeout": 0.05, "level": 1})})]
    for path in paths:
        assert _call(port[0], path)[:2] == _call(ref[0], path)[:2], path
    clock.t += 600
    for (url, ds, _s, _h), m in zip((ref, port), BOTH):
        ds.ingest(_obs_batch(m, 7, ids=_seg_ids()[:7]), ingest_key="late")
    path = "/feed?cursor=3&timeout=0.05&bbox=-180,-90,180,90&level=2"
    want, got = _call(ref[0], path), _call(port[0], path)
    assert got[:2] == want[:2] and json.loads(got[1])["events"]
    for _url, ds, _s, _h in (ref, port):
        ds.freshness.feed.max_waiters = 0
    want, got = (_call(u, "/feed?cursor=0&timeout=0.05")
                 for u in (ref[0], port[0]))
    assert got == want and got[0] == 429 and got[2] is not None
    for _url, ds, _s, _h in (ref, port):
        ds.freshness.feed.max_waiters = 1024
    for adm in (jax_admission, port_admission):
        adm.ladder().level = 2
    try:
        want, got = (_call(u, "/feed?cursor=0&timeout=0.05")
                     for u in (ref[0], port[0]))
        assert got == want and got[0] == 429
        assert json.loads(got[1])["reason"] == "pressure"
    finally:
        jax_admission._reset_module()
        port_admission._reset_module()


def test_no_datastore_answers_503_in_both():
    from reporter_tpu.service.server import ReporterService as JaxService
    from reporter_tpu_torch.service.server import ReporterService
    for params in ({"segment_id": 1}, {"bbox": [0, 0, 1, 1], "level": 2}):
        assert ReporterService(_StubMatcher()).histogram(params) \
            == JaxService(_StubMatcher()).histogram(params)
    got = ReporterService(_StubMatcher()).feed({"cursor": 0})
    assert got == JaxService(_StubMatcher()).feed({"cursor": 0})
    assert got[0] == 503


def test_health_datastore_blocks_have_the_jax_keys(tmp_path):
    from reporter_tpu.synth import build_grid_city as jax_city
    from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
    from reporter_tpu.service.server import ReporterService as JaxService
    from reporter_tpu_torch.matcher import SegmentMatcher
    from reporter_tpu_torch.service.server import ReporterService
    from reporter_tpu_torch.synth import build_grid_city
    bodies = []
    for m, service in (
            (jax_ds, lambda ds: JaxService(
                JaxMatcher(net=jax_city(rows=4, cols=4)), datastore=ds)),
            (port_ds, lambda ds: ReporterService(
                SegmentMatcher(build_grid_city(rows=4, cols=4),
                               device="cpu"), datastore=ds))):
        ds = _ingest_history(m, tmp_path / m.__name__)
        ds.enable_freshness(clock=_FakeClock())
        svc = service(ds)
        svc.compactor = m.BackgroundCompactor(ds, max_deltas=2,
                                              interval_s=0.0)
        svc.compactor.pending(refresh=True)
        try:
            code, body = svc.health()
        finally:
            svc.dispatcher.close()
        assert code == 200
        bodies.append(json.loads(body))
    want, got = bodies
    assert list(got) == list(want)
    for key in ("datastore", "compaction", "freshness"):
        assert set(got[key]) == set(want[key]), key
    assert set(got["datastore"]["lease"]) == set(want["datastore"]["lease"])
    # delta_bytes counts meta.json, whose wall-clock "created" varies
    assert abs(got["compaction"].pop("delta_bytes")
               - want["compaction"].pop("delta_bytes")) < 256
    assert got["compaction"] == want["compaction"]
    assert got["compaction"]["partitions_over"] == len(_TILES)
    for block in ("overlay", "feed", "viewports"):
        assert got["freshness"][block] == want["freshness"][block]
    assert got["datastore"]["rows"] == want["datastore"]["rows"] > 0


def test_health_answers_503_when_the_store_errors(tmp_path, monkeypatch):
    from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
    from reporter_tpu.service.server import ReporterService as JaxService
    from reporter_tpu.synth import build_grid_city as jax_city
    from reporter_tpu_torch.matcher import SegmentMatcher
    from reporter_tpu_torch.service.server import ReporterService
    from reporter_tpu_torch.synth import build_grid_city

    def broken():
        raise OSError("disk gone")
    answers = []
    for m, make in (
            (jax_ds, lambda ds: JaxService(
                JaxMatcher(net=jax_city(rows=3, cols=3)), datastore=ds)),
            (port_ds, lambda ds: ReporterService(
                SegmentMatcher(build_grid_city(rows=3, cols=3),
                               device="cpu"), datastore=ds))):
        ds = m.LocalDatastore(str(tmp_path / m.__name__))
        monkeypatch.setattr(ds, "stats", broken)
        svc = make(ds)
        try:
            code, body = svc.health()
        finally:
            svc.dispatcher.close()
        answers.append((code, json.loads(body)))
    (code_ref, want), (code, got) = answers
    assert code == code_ref == 503
    assert got["datastore"] == want["datastore"] \
        == {"status": "error", "error": "disk gone"}
    assert got["status"] == want["status"] == "degraded"


# ---- the worker's tee, the drainer, the profile and the CLI -----------------

SV = r",sv,\|,0,1,2,3,4"


def _stream_lines(city, make_trace, n, seed):
    rng = np.random.default_rng(seed)
    rows = []
    i = 0
    while i < n:
        tr = make_trace(city, f"veh-{i}", rng, noise_m=4.0,
                        sample_period_s=5.0,
                        start_time=1_500_000_000 + 20 * i)
        if tr is None:
            continue
        rows += [(p["time"], tr.uuid, p) for p in tr.points]
        i += 1
    rows.sort(key=lambda r: (r[0], r[1]))
    return [f"{u}|{p['lat']}|{p['lon']}|{p['time']}|{p['accuracy']}"
            for _t, u, p in rows]


@pytest.fixture(scope="module")
def city_stream(tmp_path_factory):
    """A 12x12 city, saved, and 16 vehicles' probes in a file (both
    packages' synth give the same probes)."""
    from reporter_tpu.synth import build_grid_city as jax_city
    from reporter_tpu.synth import generate_trace as jax_trace
    from reporter_tpu_torch.synth import build_grid_city, generate_trace
    root = tmp_path_factory.mktemp("stream")
    city = build_grid_city(rows=12, cols=12, spacing_m=200.0, seed=7)
    graph = str(root / "city.npz")
    city.save(graph)
    lines = _stream_lines(city, generate_trace, 16, seed=7)
    assert lines == _stream_lines(
        jax_city(rows=12, cols=12, spacing_m=200.0, seed=7), jax_trace,
        16, seed=7)
    stream = str(root / "stream.txt")
    with open(stream, "w") as f:
        f.write("\n".join(lines) + "\n")
    return graph, stream


@pytest.fixture
def _worker_globals():
    """A worker registers its spool roots and flight-recorder directory
    process-wide (both packages'); leave them unregistered."""
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


def _worker_args(graph, stream, out, store, *extra, source="t"):
    return ["-f", SV, "--graph", graph, "-p", "1", "-q", "3600",
            "-i", "1000000000", "-s", source, "-o", out, "--input", stream,
            "-r", "0,1,2", "-x", "0,1,2", "--report-flush-interval", "0",
            "--datastore", store, *extra]


def _tile_tree(root):
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if not d.startswith(".")]
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _resident_ids(ds):
    return sorted({int(i) for lvl, idx in ds.partitions()
                   for i in ds.resident_segments(lvl, idx)})


@pytest.mark.parametrize("compaction", ["off", "inline"])
def test_worker_tee_stores_equal_the_jax_workers(city_stream, tmp_path,
                                                 monkeypatch,
                                                 _worker_globals,
                                                 compaction):
    """One stream through both packages' ``worker.main --datastore``
    (the port's with ``--device cpu``): the tile files byte-equal, the
    tee stores' columns byte-equal and every segment answered equally;
    with ``--datastore-max-deltas 1`` and the compactor thread off
    (``compact_interval_s`` 0, the JAX package's
    REPORTER_TPU_COMPACT_INTERVAL_S=0) a second source's flush makes
    the tee compact inline in both. A run of the same stream into the
    same store re-offers every flush under the same ledger keys: nothing
    counts twice."""
    from reporter_tpu.streaming import worker as jax_worker
    from reporter_tpu_torch.streaming import worker
    graph, stream = city_stream
    extra = []
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"worker": {"compact_interval_s": 0}}))
    if compaction == "inline":
        monkeypatch.setenv("REPORTER_TPU_COMPACT_INTERVAL_S", "0")
        extra = ["--datastore-max-deltas", "1"]
    ref_out, ref_store = str(tmp_path / "jax"), str(tmp_path / "jax_store")
    out, store = str(tmp_path / "port"), str(tmp_path / "port_store")
    assert jax_worker.main(_worker_args(graph, stream, ref_out, ref_store,
                                        "--uuid-filter", "off",
                                        *extra)) == 0
    assert worker.main(_worker_args(graph, stream, out, store, "--config",
                                    str(conf), "--device", "cpu",
                                    *extra)) == 0
    assert _tile_tree(out) == _tile_tree(ref_out) and _tile_tree(out)
    assert _store_tree(store) == _store_tree(ref_store)
    a, b = jax_ds.LocalDatastore(ref_store), port_ds.LocalDatastore(store)
    ids = _resident_ids(a)
    assert ids == _resident_ids(b) and ids
    assert _js(b.query_many(ids)) == _js(a.query_many(ids))
    # the tee store equals a store built by ingesting the tile files
    csv_store = port_ds.LocalDatastore(str(tmp_path / "from_tiles"))
    got = csv_store.ingest_dir(out)
    assert got["failures"] == 0 and got["rows"] == b.stats()["rows"]
    assert _js(csv_store.query_many(ids)) == _js(b.query_many(ids))
    if compaction == "inline":
        assert jax_worker.main(_worker_args(
            graph, stream, str(tmp_path / "jax2"), ref_store,
            "--uuid-filter", "off", *extra, source="t2")) == 0
        assert worker.main(_worker_args(
            graph, stream, str(tmp_path / "port2"), store, "--config",
            str(conf), "--device", "cpu", *extra, source="t2")) == 0
        assert _store_tree(store) == _store_tree(ref_store)
        assert all(n.startswith("base-") for lvl, idx in b.partitions()
                   for n in b._read_manifest(
                       b.partition_dir(lvl, idx))["segments"])
        assert _js(b.query_many(ids)) == _js(a.query_many(ids))
    rows = b.stats()["rows"]
    assert worker.main(_worker_args(graph, stream, str(tmp_path / "again"),
                                    store, "--config", str(conf),
                                    "--device", "cpu", *extra)) == 0
    b = port_ds.LocalDatastore(store)
    assert b.stats()["rows"] == rows
    assert _js(b.query_many(ids)) == _js(a.query_many(ids))


def test_a_failed_tee_spools_the_tile_and_the_drainer_replays_it(
        tmp_path):
    """The tee raises on its first flush (the ``datastore.commit``
    failpoint): the tile still reaches the sink, its body is spooled
    with reason ``tee``, and the port's drainer replays it into the
    store under the tee's ledger key, as the JAX package's does."""
    from reporter_tpu.streaming.anonymiser import Anonymiser as JaxAnon
    from reporter_tpu.streaming.anonymiser import TileSink as JaxSink
    from reporter_tpu.streaming.drainer import DeadLetterDrainer as JaxDr
    from reporter_tpu.utils import faults as jax_faults
    from reporter_tpu_torch.streaming.anonymiser import Anonymiser, TileSink
    from reporter_tpu_torch.streaming.drainer import DeadLetterDrainer
    from reporter_tpu_torch.utils import faults as port_faults
    trees, stores = [], []
    for m, types, anon_cls, sink_cls, drainer_cls, fl in (
            (jax_ds, jax_types, JaxAnon, JaxSink, JaxDr, jax_faults),
            (port_ds, port_types, Anonymiser, TileSink, DeadLetterDrainer,
             port_faults)):
        root = tmp_path / m.__name__
        ds = m.LocalDatastore(str(root / "store"))
        spool = str(root / "dl")
        sink = sink_cls(str(root / "out"), deadletter=spool)
        anon = anon_cls(sink, privacy=1, quantisation=3600, source="t",
                        tee=lambda _t, segs, ingest_key=None, _ds=ds:
                        _ds.ingest_segments(segs, ingest_key=ingest_key))
        for s in _segments(types, 11, n=40):
            anon.process("k", s)
        fl.configure("datastore.commit=error#1")
        try:
            anon.punctuate()
        finally:
            fl.clear()
        spooled = _tile_tree(spool)
        assert len(spooled) == 1
        rows = ds.stats()["rows"]
        drainer = drainer_cls(spool, datastore=ds)
        assert drainer.drain_now() == 1
        assert ds.stats()["rows"] > rows
        trees.append((_tile_tree(str(root / "out")), spooled))
        stores.append(ds)
    assert trees[1] == trees[0]
    assert _store_tree(stores[1].root) == _store_tree(stores[0].root)
    assert stores[1].merged_cells() == stores[0].merged_cells()


def _profile_requests(generate_trace, city, n=8, seed=23):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        tr = None
        while tr is None:
            tr = generate_trace(city, f"warm-{i}", rng, noise_m=3.0,
                                min_route_edges=8)
        reqs.append(tr.request_json())
    return reqs


def test_profile_pairs_and_warm_equal_the_jax_package(tmp_path,
                                                      monkeypatch):
    """The same ``match_many`` replay on both native runtimes exports
    the same route-memo pairs; ``warm_matcher`` warms as many into a
    fresh matcher of each package; the port's warmed matcher hits its
    memo on its first call and answers byte for byte as a cold one."""
    from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
    from reporter_tpu.synth import build_grid_city as jax_city
    from reporter_tpu.synth import generate_trace as jax_trace
    from reporter_tpu_torch.matcher import SegmentMatcher
    from reporter_tpu_torch.service.report import report_json
    from reporter_tpu_torch.synth import build_grid_city, generate_trace
    monkeypatch.setenv("REPORTER_TPU_PREP_THREADS", "1")
    kw = dict(rows=7, cols=7, spacing_m=220.0, seed=11,
              service_road_fraction=0.0, internal_fraction=0.0)
    jcity, city = jax_city(**kw), build_grid_city(**kw)
    reqs = _profile_requests(generate_trace, city)
    assert reqs == _profile_requests(jax_trace, jcity)

    def port_matcher():
        return SegmentMatcher(city, device="cpu", prep_threads=1)

    arts = []
    for mod, m in ((jax_ds, JaxMatcher(net=jcity)),
                   (port_ds, port_matcher())):
        m.match_many(reqs)
        path = mod.profile_path(str(tmp_path / mod.__name__))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        arts.append(mod.export_profile(m, path, city="town"))
        assert mod.load_profile(path)["pairs"] == arts[-1]["pairs"]
    want, got = arts
    assert got["n_pairs"] == want["n_pairs"] > 0
    assert got["pairs"] == want["pairs"]
    assert got["memo_stats"] == want["memo_stats"]
    assert got["route_table"] is want["route_table"] is None
    warmed_ref = jax_ds.warm_matcher(JaxMatcher(net=jcity), want)
    warm, cold = port_matcher(), port_matcher()
    assert port_ds.warm_matcher(warm, got) == warmed_ref == got["n_pairs"]
    assert warm.runtime.route_memo_stats()["size"] >= got["n_pairs"]

    def bodies(m):
        return [report_json(match, req, 15, {0, 1, 2}, {0, 1, 2})
                for req, match in zip(reqs, m.match_many(reqs))]
    assert bodies(warm) == bodies(cold)
    assert warm.runtime.route_memo_stats()["hits"] > 0
    assert cold.runtime.route_memo_stats()["hits"] == 0
    # the artifact's route_bound_m raises the warm bound (no sweep cap)
    table = dict(got, route_table={"route_hops": 3,
                                   "route_bound_m": 900.0})
    assert port_ds.warm_matcher(port_matcher(), table) == got["n_pairs"]


def _cli_lines(main, argv, capsys):
    """The JSON lines a CLI command prints, its ``metrics`` timers (wall
    clock) masked to their names; both packages' registries start empty."""
    from reporter_tpu.utils import metrics as jax_metrics
    from reporter_tpu_torch.utils import metrics as port_metrics
    jax_metrics.default.reset()
    port_metrics.default.reset()
    assert main(argv) == 0
    out = []
    for line in capsys.readouterr().out.strip().splitlines():
        obj = json.loads(line)
        if isinstance(obj, dict) and "metrics" in obj:
            obj["metrics"] = sorted(obj["metrics"])
        if isinstance(obj, dict) and "path" in obj:
            obj["path"] = os.path.basename(obj["path"])
        out.append(obj)
    return out


def _results_trees(tmp_path):
    """{package: results dir}: three seeded tile files in the
    anonymiser's layout, written by each package's ``Segment``."""
    tiles = {}
    for m, types in ((jax_ds, jax_types), (port_ds, port_types)):
        root = tmp_path / m.__name__ / "results"
        for k, seed in enumerate((1, 2, 3)):
            segs = _segments(types, seed, n=120)
            d = root / f"{MON_8AM}_{MON_8AM + 3599}" / "2" / str(k)
            d.mkdir(parents=True)
            (d / f"t.e{k:08d}").write_text("\n".join(
                [types.Segment.column_layout()]
                + [s.csv_row("AUTO", "t") for s in segs]))
        tiles[m] = root
    return tiles


def test_datastore_cli_lines_equal_the_jax_cli(tmp_path, capsys):
    from reporter_tpu.tools import datastore_cli as jax_cli
    from reporter_tpu_torch.tools import datastore_cli as cli
    tiles = _results_trees(tmp_path)
    ids = _seg_ids()
    commands = [
        lambda st, res: ["ingest", st, res],
        lambda st, res: ["ingest", st, res],       # a replay: all dedupe
        lambda st, res: ["query", st, "--segment", str(ids[1])],
        lambda st, res: ["query", st, "--segments",
                         ",".join(map(str, ids)), "--hours", "7-9"],
        lambda st, res: ["query", st, "--segment", str(ids[1]),
                         "--t0", str(MON_8AM), "--t1",
                         str(MON_8AM + 86400), "--percentiles", "50,90"],
        lambda st, res: ["query", st, "--bbox=-180,-90,180,90",
                         "--bbox-level", "2", "--max-segments", "9"],
        lambda st, res: ["query", st, "--segment", str(ids[1]),
                         "--window", "inf"],
        lambda st, res: ["compact", st, "--max-deltas", "5"],
        lambda st, res: ["compact", st],
        lambda st, res: ["query", st, "--bbox=-180,-90,180,90",
                         "--bbox-level", "0"],
        lambda st, res: ["feed", st, "--cursor", "0", "--timeout", "0.05",
                         "--max-polls", "1"],
        lambda st, res: ["profile", st],
        lambda st, res: ["ingest", st, res, "--delete"],
    ]
    for i, cmd in enumerate(commands):
        want = _cli_lines(jax_cli.main, cmd(
            str(tmp_path / "jax_ds_store"), str(tiles[jax_ds])), capsys)
        got = _cli_lines(cli.main, cmd(
            str(tmp_path / "port_ds_store"), str(tiles[port_ds])), capsys)
        assert got == want, i
    stats = [_cli_lines(c.main, ["stats", str(tmp_path / p)], capsys)[0]
             for c, p in ((jax_cli, "jax_ds_store"),
                          (cli, "port_ds_store"))]
    assert abs(stats[1].pop("bytes") - stats[0].pop("bytes")) < 64
    assert stats[1] == stats[0] and stats[0]["rows"] > 0
    assert _store_tree(str(tmp_path / "port_ds_store")) \
        == _store_tree(str(tmp_path / "jax_ds_store"))
    assert not _tile_tree(str(tiles[port_ds]))


def _ledgers(root):
    """{partition manifest: its ingest ledger's keys} of a store."""
    return {rel: sorted(json.loads(raw).get("ingested", {}))
            for rel, raw in _store_tree(root).items()
            if rel.endswith("MANIFEST.json")}


def test_cli_config_sizes_the_store_as_the_jax_env_does(tmp_path, capsys,
                                                        monkeypatch):
    """``--config``'s ``datastore`` object sizes the CLI's store as it
    does the worker's: an ingest under ``ledger_max`` 2 keeps each
    partition's two newest keys and writes the JAX CLI's store under
    REPORTER_TPU_INGEST_LEDGER_MAX=2; without the config the port's
    ledger keeps all three; an unknown knob is refused."""
    from reporter_tpu.tools import datastore_cli as jax_cli
    from reporter_tpu_torch.tools import datastore_cli as cli
    tiles = _results_trees(tmp_path)
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"graph": "city.npz", "datastore": {
        "root": str(tmp_path / "elsewhere"), "ledger_max": 2}}))
    monkeypatch.setenv("REPORTER_TPU_INGEST_LEDGER_MAX", "2")
    want = _cli_lines(jax_cli.main, ["ingest", str(tmp_path / "jax"),
                                     str(tiles[jax_ds])], capsys)
    monkeypatch.delenv("REPORTER_TPU_INGEST_LEDGER_MAX")
    got = _cli_lines(cli.main, ["ingest", str(tmp_path / "port"),
                                str(tiles[port_ds]), "--config",
                                str(conf)], capsys)
    assert got == want and want[0]["rows"] > 0
    assert not os.path.exists(tmp_path / "elsewhere")
    assert _store_tree(str(tmp_path / "port")) \
        == _store_tree(str(tmp_path / "jax"))
    bounded = _ledgers(str(tmp_path / "port"))
    assert bounded and all(len(keys) <= 2 for keys in bounded.values())
    _cli_lines(cli.main, ["ingest", str(tmp_path / "free"),
                          str(tiles[port_ds])], capsys)
    free = _ledgers(str(tmp_path / "free"))
    assert max(len(keys) for keys in free.values()) == 3
    assert all(set(bounded[rel]) <= set(keys) for rel, keys in free.items())
    conf.write_text(json.dumps({"graph": "city.npz", "datastore": {
        "root": "x", "ledger_maxx": 2}}))
    with pytest.raises(SystemExit) as exc:
        cli.main(["stats", str(tmp_path / "port"), "--config", str(conf)])
    assert exc.value.code == 2
    assert "ledger_maxx" in capsys.readouterr().err


def test_cli_profile_replay_equals_the_jax_cli(tmp_path, capsys,
                                               monkeypatch):
    """``datastore profile --replay`` (the port's with ``--device cpu``;
    without it the replay needs the card) prints the JAX CLI's line and
    writes the same pairs."""
    import torch
    from reporter_tpu.tools import datastore_cli as jax_cli
    from reporter_tpu_torch.synth import build_grid_city, generate_trace
    from reporter_tpu_torch.tools import datastore_cli as cli
    monkeypatch.setenv("REPORTER_TPU_PREP_THREADS", "1")
    city = build_grid_city(rows=6, cols=6, spacing_m=220.0, seed=3,
                           service_road_fraction=0.0, internal_fraction=0.0)
    graph = str(tmp_path / "city.npz")
    city.save(graph)
    replay = tmp_path / "traces.jsonl"
    replay.write_text("".join(json.dumps(r) + "\n" for r in
                              _profile_requests(generate_trace, city, n=4)))
    args = ["--graph", graph, "--replay", str(replay), "--city", "c"]
    want = _cli_lines(jax_cli.main, ["profile", str(tmp_path / "a")]
                      + args, capsys)
    got = _cli_lines(cli.main, ["profile", str(tmp_path / "b")] + args
                     + ["--device", "cpu"], capsys)
    # the memo counters depend on the prep threads, which the JAX CLI
    # takes from the environment and the port's matcher defaults
    assert got[0]["replayed"] == want[0]["replayed"] == 4
    assert got[0]["n_pairs"] == want[0]["n_pairs"] > 0
    pairs = [port_ds.load_profile(str(tmp_path / d / ".profile"))["pairs"]
             for d in ("a", "b")]
    assert sorted(map(tuple, pairs[1])) == sorted(map(tuple, pairs[0]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["profile", str(tmp_path / "c")] + args)
