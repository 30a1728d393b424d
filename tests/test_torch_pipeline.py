"""The port's batched pipeline (``reporter_tpu_torch.pipeline``) against
the JAX package's: the window chunker, the three stages on the same
seeded archive (shard rows, match rows and tile bytes), and the port's
own contract where it departs on purpose: a ``match_many`` failure
raises, the CLI needs a card only to match, bucket credentials come from
the config's ``pipeline`` block, and the module imports no torch."""
import gzip
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.pipeline import simple_reporter as jax_pipeline
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu_torch.core.geo import equirectangular_m
from reporter_tpu_torch.core.types import Segment
from reporter_tpu_torch.matcher import SegmentMatcher
from reporter_tpu_torch.pipeline import simple_reporter
from reporter_tpu_torch.pipeline.simple_reporter import (
    MAX_WINDOW_POINTS, _window_spans, _windows_of, gather_traces,
    match_traces, report_tiles)
from reporter_tpu_torch.synth import build_grid_city, generate_trace
from reporter_tpu_torch.utils import faults, metrics

CITY = dict(rows=10, cols=10, spacing_m=200.0, seed=4,
            service_road_fraction=0.0, internal_fraction=0.0)
T0 = 1_500_000_000
#: a stitched drive's next trip starts within this many metres of the
#: last trip's end
SEAM_M = 800.0


@pytest.fixture(scope="module")
def city():
    return build_grid_city(**CITY)


def make_part_file(city, path, n_traces=5, seed=0):
    """Pipe-separated part file shaped like the reference's default valuer
    expects: col1=uuid, col0=time, col9=lat, col10=lon, col5=accuracy."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_traces):
        tr = None
        while tr is None:
            tr = generate_trace(city, f"veh-{seed}-{i}", rng, noise_m=3.0,
                                min_route_edges=8)
        for p in tr.points:
            cols = ["x"] * 11
            cols[0] = str(p["time"])
            cols[1] = tr.uuid
            cols[5] = str(p["accuracy"])
            cols[9] = str(p["lat"])
            cols[10] = str(p["lon"])
            lines.append("|".join(cols))
    with gzip.open(path, "wt") as f:
        f.write("\n".join(lines))
    return lines


def tree(root, by_dir=False):
    """{relative path: bytes} of the files under ``root``; ``by_dir`` keys
    each file by its directory instead (stage 3 names a tile file by
    hashing a temporary path, one file a directory)."""
    out = {}
    for dirpath, _d, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            key = os.path.dirname(rel) if by_dir else rel
            assert key not in out
            with open(path, "rb") as f:
                out[key] = f.read()
    return out


def sorted_rows(root, prefix_of=lambda rel: rel):
    """{key: sorted lines} of the files under ``root``, the lines of files
    with one key together."""
    out = {}
    for rel, body in tree(root).items():
        out.setdefault(prefix_of(rel), []).extend(
            body.decode().splitlines())
    return {k: sorted(v) for k, v in out.items()}


# -- the JAX package's cases -------------------------------------------------

class TestWindows:
    def test_split_at_inactivity(self):
        pts = [{"time": t} for t in (0, 10, 20, 300, 310, 320)]
        wins = list(_windows_of(pts, inactivity=120))
        assert [len(w) for w in wins] == [3, 3]

    def test_short_windows_dropped(self):
        pts = [{"time": t} for t in (0, 300, 310)]
        wins = list(_windows_of(pts, inactivity=120))
        assert [len(w) for w in wins] == [2]


class TestPipelineEndToEnd:
    def test_three_stages(self, city, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        src_dir = tmp_path / "src"
        src_dir.mkdir()
        make_part_file(city, str(src_dir / "part-000.gz"), n_traces=4, seed=1)
        make_part_file(city, str(src_dir / "part-001.gz"), n_traces=4, seed=2)

        trace_dir = gather_traces(str(src_dir), ".*",
                                  "lambda l: (lambda c: [c[1], c[0], c[9], "
                                  "c[10], c[5]])(l.split('|'))",
                                  "%Y-%m-%d %H:%M:%S",
                                  [-90.0, -180.0, 90.0, 180.0], concurrency=2)
        shard_files = [os.path.join(r, f)
                       for r, _d, fs in os.walk(trace_dir) for f in fs]
        assert shard_files, "stage 1 produced no shards"

        matcher = SegmentMatcher(net=city, device="cpu")
        match_dir = match_traces(
            trace_dir, matcher, "auto", {0, 1, 2}, {0, 1, 2},
            quantisation=3600, inactivity=120, source="test")
        tile_files = [os.path.join(r, f)
                      for r, _d, fs in os.walk(match_dir) for f in fs]
        assert tile_files, "stage 2 produced no tile rows"
        # rows have the 10-column layout with uppercased mode
        with open(tile_files[0]) as f:
            cols = f.readline().strip().split(",")
        assert len(cols) == 10 and cols[9] == "AUTO" and cols[3] == "1"

        dest = tmp_path / "dest"
        report_tiles(match_dir, str(dest), privacy=1, concurrency=2)
        out_files = [os.path.join(r, f)
                     for r, _d, fs in os.walk(dest) for f in fs]
        assert out_files, "stage 3 wrote nothing"
        with open(out_files[0]) as f:
            assert f.readline().strip() == Segment.column_layout()

    def test_privacy_cull_removes_rare_pairs(self, city, tmp_path):
        match_dir = tmp_path / "matches" / "0_3599" / "0"
        match_dir.mkdir(parents=True)
        rows = (["5,6,10,1,600,0,0,10,src,AUTO\n"] * 3
                + ["7,8,10,1,600,0,0,10,src,AUTO\n"])
        with open(match_dir / "42", "w") as f:
            f.writelines(rows)
        dest = tmp_path / "out"
        report_tiles(str(tmp_path / "matches"), str(dest), privacy=2,
                     concurrency=1)
        out_files = [os.path.join(r, f)
                     for r, _d, fs in os.walk(dest) for f in fs]
        (path,) = out_files
        with open(path) as f:
            body = f.read()
        assert body.count("5,6,") == 3
        assert "7,8," not in body


class TestLongWindowChunking:
    """Windows beyond the largest padding bucket are chunked with a
    holdback overlap rather than truncated."""

    def _points(self, n, dt=1):
        return [{"time": 1500000000 + i * dt, "lat": 14.0 + i * 1e-4,
                 "lon": 121.0} for i in range(n)]

    def test_short_window_untouched(self):
        pts = self._points(500)
        ws = list(_windows_of(pts, inactivity=120))
        assert len(ws) == 1 and len(ws[0]) == 500

    def test_long_window_chunks_cover_all_points(self):
        pts = self._points(2500)
        ws = list(_windows_of(pts, inactivity=120))
        assert all(len(w) <= MAX_WINDOW_POINTS for w in ws)
        covered = {p["time"] for w in ws for p in w}
        assert covered == {p["time"] for p in pts}

    def test_chunk_overlap_spans_holdback(self):
        pts = self._points(2500)
        ws = list(_windows_of(pts, inactivity=120, holdback_s=15))
        for a, b in zip(ws[:-1], ws[1:]):
            overlap_start = b[0]["time"]
            assert a[-1]["time"] - overlap_start > 15  # covers holdback
            assert overlap_start > a[0]["time"]        # but makes progress

    def test_inactivity_split_still_applies(self):
        pts = self._points(100)
        pts[50]["time"] += 1000  # gap
        for p in pts[51:]:
            p["time"] += 1000
        ws = list(_windows_of(pts, inactivity=120))
        assert len(ws) == 2


# -- the chunker against the JAX package's -----------------------------------

def random_times(seed):
    """A sorted times array of 1-3,000 points: probes 1-10 s apart, gaps
    past the inactivity, and bursts of up to 1,500 points inside one
    15 s holdback."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 3001))
    dt = rng.uniform(1.0, 10.0, n)
    gaps = rng.random(n) < 0.004
    dt[gaps] = rng.uniform(121.0, 2000.0, int(gaps.sum()))
    for _ in range(int(rng.integers(0, 3))):
        lo = int(rng.integers(0, n))
        hi = min(n, lo + int(rng.integers(10, 1500)))
        dt[lo:hi] = rng.uniform(0.0, 15.0 / max(1, hi - lo), hi - lo)
    return np.round(T0 + np.cumsum(dt), 3)


@pytest.mark.parametrize("max_window", [MAX_WINDOW_POINTS, 64])
@pytest.mark.parametrize("seed", range(8))
def test_window_spans_equal_the_jax_packages(seed, max_window):
    times = random_times(seed)
    want = list(jax_pipeline._window_spans(times, 120, max_window, 15))
    got = list(_window_spans(times, 120, max_window, 15))
    assert got == want
    assert all(b - a >= 2 and b - a <= max_window for a, b in got)


# -- the three stages against the JAX package's ------------------------------

def fleet(city, n_vehicles, seed, long_points):
    """{uuid: probe dicts}: ``n_vehicles`` vehicles of 1-2 trips each,
    300-900 s apart, and one long drive past ``long_points`` points
    stitched from those trips (each next trip starting within SEAM_M of
    the last one's end, or the nearest start when none does, 5-30 s
    later)."""
    rng = np.random.default_rng(seed)
    vehicles, pool = {}, []
    for i in range(n_vehicles):
        uuid = f"veh-{i}"
        t = T0 + int(rng.integers(0, 3 * 3600))
        pts = []
        for _ in range(int(rng.integers(1, 3))):
            tr = None
            while tr is None:
                tr = generate_trace(city, uuid, rng, noise_m=3.0,
                                    start_time=t, min_route_edges=6)
            pts.extend(tr.points)
            pool.append(tr.points)
            t = tr.points[-1]["time"] + int(rng.integers(300, 901))
        vehicles[uuid] = pts
    starts = np.array([[p[0]["lat"], p[0]["lon"]] for p in pool])
    drive = list(pool[0])
    k = 0
    while len(drive) <= long_points:
        end = drive[-1]
        jump = equirectangular_m(end["lat"], end["lon"], starts[:, 0],
                                 starts[:, 1])
        near = np.flatnonzero(jump <= SEAM_M)
        j = int(near[k % len(near)]) if len(near) else int(np.argmin(jump))
        nxt = pool[j]
        t = end["time"] + int(min(30.0, max(5.0, jump[j] / 10.0)))
        drive.extend(dict(p, time=p["time"] - nxt[0]["time"] + t)
                     for p in nxt)
        k += 1
    vehicles["drive-0"] = drive
    return vehicles


def write_archive(vehicles, root, n_files=4):
    """The fleet as ``n_files`` part files in the reference's pipe layout
    (uuid col 1, time col 0, lat 9, lon 10, accuracy 5), every other one
    gzipped: times alternate between ``%Y-%m-%d %H:%M:%S`` and epoch
    integers, every 37th accuracy is past 1,000 m, and malformed and
    out-of-bbox lines are mixed in."""
    lines = []
    for uuid, pts in vehicles.items():
        for j, p in enumerate(pts):
            cols = ["x"] * 11
            cols[0] = (time.strftime("%Y-%m-%d %H:%M:%S",
                                     time.gmtime(p["time"]))
                       if len(lines) % 2 else str(p["time"]))
            cols[1] = uuid
            cols[5] = "1500.5" if j % 37 == 5 else str(p["accuracy"])
            cols[9] = str(p["lat"])
            cols[10] = str(p["lon"])
            lines.append("|".join(cols))
            if j % 97 == 3:      # out of the bbox
                cols[9] = str(p["lat"] + 2.0)
                lines.append("|".join(cols))
            if j % 101 == 7:     # malformed
                lines.extend(["garbage", "|".join(cols[:6]),
                              "|".join(cols[:9] + ["lat?", cols[10]])])
    os.makedirs(root, exist_ok=True)
    for i in range(n_files):
        part = "\n".join(lines[i::n_files]) + "\n"
        path = os.path.join(root, f"part-{i:03d}" + (".gz" if i % 2 else ""))
        opener = gzip.open if i % 2 else open
        with opener(path, "wt") as f:
            f.write(part)
    return len(lines)


@pytest.fixture(scope="module")
def archive(city, tmp_path_factory):
    root = tmp_path_factory.mktemp("archive")
    vehicles = fleet(city, 24, seed=13, long_points=MAX_WINDOW_POINTS + 200)
    assert len(vehicles["drive-0"]) > MAX_WINDOW_POINTS
    lat = [p["lat"] for pts in vehicles.values() for p in pts]
    lon = [p["lon"] for pts in vehicles.values() for p in pts]
    bbox = [min(lat) - 0.01, min(lon) - 0.01, max(lat) + 0.01,
            max(lon) + 0.01]
    write_archive(vehicles, str(root / "src"))
    return root, bbox


def three_stages(mod, matcher, src, bbox, dest):
    """gather, match and report through ``mod``'s stage functions:
    (trace dir, match dir)."""
    trace_dir = mod.gather_traces(src, ".*", mod.DEFAULT_VALUER,
                                  "%Y-%m-%d %H:%M:%S", bbox, concurrency=2)
    match_dir = mod.match_traces(trace_dir, matcher, "auto", {0, 1}, {0, 1},
                                 quantisation=3600, inactivity=120,
                                 source="test")
    mod.report_tiles(match_dir, dest, privacy=2, concurrency=2)
    return trace_dir, match_dir


def test_three_stages_equal_the_jax_packages(city, archive, tmp_path,
                                             monkeypatch):
    """The headline parity: one archive through both packages' stages on
    the CPU. The shard rows are equal per shard prefix, the match rows as
    sorted lines per tile-row file, and the tile files byte for byte by
    directory; a window past 1,024 points was chunked. (On such data the
    chunks' overlap equals report()'s holdback and no seam duplicate
    arises: ``test_seam_duplicates_dropped_as_the_jax_package_drops_them``
    makes them.)"""
    root, bbox = archive
    monkeypatch.chdir(tmp_path)
    src = str(root / "src")
    before = {k: metrics.counter(f"pipeline.{k}")
              for k in ("windows", "chunks", "batches", "seam_dropped")}
    port = three_stages(simple_reporter, SegmentMatcher(city, device="cpu"),
                        src, bbox, str(tmp_path / "port"))
    got = {k: metrics.counter(f"pipeline.{k}") - v
           for k, v in before.items()}
    ref = three_stages(jax_pipeline, JaxMatcher(net=jax_city(**CITY)), src,
                       bbox, str(tmp_path / "jax"))
    shard = lambda rel: rel.split(".")[0]  # noqa: E731
    want_shards = sorted_rows(ref[0], shard)
    assert sorted_rows(port[0], shard) == want_shards
    probes = [ln.split(",") for rows in want_shards.values() for ln in rows]
    # the out-of-bbox and malformed lines are gone, the accuracy capped
    assert all(bbox[0] <= float(c[2]) <= bbox[2] for c in probes)
    assert max(int(c[4]) for c in probes) == 1000
    want_rows = sorted_rows(ref[1])
    assert sorted_rows(port[1]) == want_rows and len(want_rows) >= 4
    want = tree(str(tmp_path / "jax"), by_dir=True)
    assert tree(str(tmp_path / "port"), by_dir=True) == want and want
    assert got["chunks"] >= 2
    assert got["windows"] >= 25 and got["batches"] >= 1


def test_main_runs_the_three_stages_on_the_cpu(city, archive, tmp_path,
                                               monkeypatch):
    """``main --device cpu`` writes the stage functions' tiles and cleans
    up its temporary directories; a resume from ``--match-dir`` needs no
    card."""
    root, bbox = archive
    monkeypatch.chdir(tmp_path)
    graph = str(tmp_path / "city.npz")
    city.save(graph)
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"graph": graph}))
    args = ["--src", str(root / "src"), "--match-config", str(conf),
            "--bbox", ",".join(map(str, bbox)), "--concurrency", "2",
            "--privacy", "2", "--source-id", "test"]
    assert simple_reporter.main(args + ["--dest", str(tmp_path / "out"),
                                        "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path)) == ["city.npz", "conf.json", "out"]
    _trace_dir, match_dir = three_stages(
        simple_reporter, SegmentMatcher(city, device="cpu"),
        str(root / "src"), bbox, str(tmp_path / "stages"))
    want = tree(str(tmp_path / "stages"), by_dir=True)
    assert tree(str(tmp_path / "out"), by_dir=True) == want
    # resume from the match rows: no matcher, so no card either way
    assert simple_reporter.main(["--match-config", str(conf), "--match-dir",
                                 match_dir, "--dest",
                                 str(tmp_path / "resumed"), "--privacy",
                                 "2"]) == 0
    assert tree(str(tmp_path / "resumed"), by_dir=True) == want


class SameRuns:
    """A stand-in matcher (``match_traces`` takes anything with
    ``match_many``) that answers every window with the same three
    complete segments: each chunk of a long window reports them again,
    so every report after a uuid's first window is a seam duplicate."""

    SEGMENTS = [
        {"segment_id": (7 << 25) | (42 << 3) | 1, "start_time": T0 + 10.0,
         "end_time": T0 + 40.0, "length": 300, "queue_length": 0,
         "begin_shape_index": 0, "end_shape_index": 3, "internal": False},
        {"segment_id": (8 << 25) | (42 << 3) | 0, "start_time": T0 + 40.0,
         "end_time": T0 + 70.0, "length": 400, "queue_length": 5,
         "begin_shape_index": 3, "end_shape_index": 6, "internal": False},
        {"segment_id": (9 << 25) | (42 << 3) | 1, "start_time": T0 + 70.0,
         "end_time": T0 + 95.0, "length": 350, "queue_length": 0,
         "begin_shape_index": 6, "end_shape_index": 9, "internal": False}]

    def match_many(self, traces):
        return [{"segments": [dict(s) for s in self.SEGMENTS],
                 "mode": "auto"} for _t in traces]


def test_seam_duplicates_dropped_as_the_jax_package_drops_them(tmp_path,
                                                               monkeypatch):
    """A drive of 3,000 one-second probes, chunked into overlapping
    windows, through both packages' match stage with the same stand-in
    matcher: the rows are equal, each segment lands once, and the port
    counts the dropped duplicates."""
    monkeypatch.chdir(tmp_path)
    trace_dir = tmp_path / "traces"
    trace_dir.mkdir()
    (trace_dir / "abc.1").write_text("".join(
        f"drive-0,{T0 + i},14.6,121.0,10\n" for i in range(3000)))
    dropped0 = metrics.counter("pipeline.seam_dropped")
    chunks0 = metrics.counter("pipeline.chunks")
    dirs = [mod.match_traces(str(trace_dir), SameRuns(), "auto", {0, 1},
                             {0, 1}, 3600, 120, "test")
            for mod in (simple_reporter, jax_pipeline)]
    got, want = (sorted_rows(d) for d in dirs)
    assert got == want
    assert sum(len(v) for v in got.values()) == 2   # two reported pairs
    assert metrics.counter("pipeline.chunks") - chunks0 == 3
    assert metrics.counter("pipeline.seam_dropped") - dropped0 == 4


def seam_reports(matcher, make_report, TraceBatch, drive, max_window):
    """The complete reports of one drive matched as one window, and as
    the chunker's windows of at most ``max_window`` points with the match
    stage's seam dedupe: ({(id, t0)} whole, {(id, t0)} chunked)."""
    tm = np.array([p["time"] for p in drive], dtype=np.float64)
    la = np.array([p["lat"] for p in drive])
    lo = np.array([p["lon"] for p in drive])
    ac = np.full(len(drive), 8.0, dtype=np.float32)
    levels = {0, 1, 2}

    def reports(spans):
        tb = TraceBatch.concat([("u", la[a:b], lo[a:b], tm[a:b], ac[a:b],
                                 {"mode": "auto"}) for a, b in spans])
        out, floor = set(), None
        for trace, match in zip(tb, matcher.match_many(tb)):
            reps = make_report(match, trace, 15, levels,
                               levels)["datastore"]["reports"]
            if floor is not None:
                reps = [r for r in reps if r["t0"] > floor]
            if reps:
                floor = max(r["t0"] for r in reps)
            out |= {(r["id"], round(r["t0"], 3)) for r in reps
                    if r["length"] > 0}
        return out

    return (reports([(0, len(drive))]),
            reports(list(_window_spans(tm, 120, max_window, 15))))


def test_a_segment_across_a_chunk_seam_is_lost_in_both_packages(city):
    """Queue 3 (ROADMAP): a chunk withholds the segment still pending in
    its last 15 s, and the next chunk, which starts at the last probe
    before that holdback, sees it begun before its first probe, so
    partial: a complete traversal across a seam is reported by neither
    chunk. Both packages lose the same reports; this pins that, not
    why."""
    from reporter_tpu.core.tracebatch import TraceBatch as JaxBatch
    from reporter_tpu.service.report import report as jax_report
    from reporter_tpu_torch.core.tracebatch import TraceBatch
    from reporter_tpu_torch.service.report import report
    rng = np.random.default_rng(5)
    drive = []
    while len(drive) < 256:
        tr = generate_trace(city, "u", rng, noise_m=3.0, sample_period_s=5.0,
                            start_time=(drive[-1]["time"] + 10 if drive
                                        else T0), min_route_edges=6)
        if tr is not None:
            drive.extend(tr.points)
    drive = drive[:256]
    whole, chunked = seam_reports(SegmentMatcher(city, device="cpu"),
                                  report, TraceBatch, drive, 64)
    jax_whole, jax_chunked = seam_reports(JaxMatcher(net=jax_city(**CITY)),
                                          jax_report, JaxBatch, drive, 64)
    assert (whole, chunked) == (jax_whole, jax_chunked)
    assert len(whole - chunked) >= 1 and len(whole) >= 10


# -- the port's own contract -------------------------------------------------

@pytest.fixture
def clean_faults():
    yield
    faults.clear()


def test_a_failed_match_many_raises_and_main_exits_non_zero(
        city, archive, tmp_path, monkeypatch, clean_faults):
    """The JAX package logs "Batch match failed" and skips the batch; the
    port raises out of ``match_traces`` (its partial rows removed), and
    ``main`` exits 1 with the gathered traces kept for a resume."""
    root, bbox = archive
    monkeypatch.chdir(tmp_path)
    trace_dir = gather_traces(str(root / "src"), ".*",
                              simple_reporter.DEFAULT_VALUER,
                              "%Y-%m-%d %H:%M:%S", bbox, concurrency=1)
    faults.configure("decode.dispatch=error")
    with pytest.raises(Exception, match="decode.dispatch"):
        match_traces(trace_dir, SegmentMatcher(city, device="cpu"), "auto",
                     {0, 1}, {0, 1}, 3600, 120, "test")
    assert not [d for d in os.listdir(tmp_path) if d.startswith("matches_")]
    faults.clear()
    graph = str(tmp_path / "city.npz")
    city.save(graph)
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"graph": graph, "service": {
        "faults": "decode.dispatch=error"}}))
    assert simple_reporter.main(["--trace-dir", trace_dir, "--match-config",
                                 str(conf), "--dest", str(tmp_path / "out"),
                                 "--device", "cpu"]) == 1
    assert not (tmp_path / "out").exists() and os.path.isdir(trace_dir)
    assert faults.fired_counts().get("decode.dispatch", 0) >= 1


def test_main_needs_a_card_only_to_match(city, tmp_path, monkeypatch):
    import torch
    monkeypatch.chdir(tmp_path)
    graph = str(tmp_path / "city.npz")
    city.save(graph)
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"graph": graph}))
    src = tmp_path / "src"
    src.mkdir()
    make_part_file(city, str(src / "part-000.gz"), n_traces=2)
    if not torch.cuda.is_available():
        assert simple_reporter.main(["--src", str(src), "--match-config",
                                     str(conf), "--dest",
                                     str(tmp_path / "out")]) == 1
        # nothing was gathered before the refusal
        assert sorted(os.listdir(tmp_path)) == ["city.npz", "conf.json",
                                                "src"]
    rows = tmp_path / "rows" / "0_3599" / "0"
    rows.mkdir(parents=True)
    (rows / "42").write_text("5,6,10,1,600,0,0,10,src,AUTO\n" * 2)
    assert simple_reporter.main(["--match-config", str(conf), "--match-dir",
                                 str(tmp_path / "rows"), "--dest",
                                 str(tmp_path / "out")]) == 0
    assert list(tree(str(tmp_path / "out"), by_dir=True)) == [
        os.path.join("0_3599", "0", "42")]


def test_the_pipeline_block_holds_only_bucket_credentials(city, tmp_path):
    graph = str(tmp_path / "city.npz")
    city.save(graph)
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({
        "graph": graph, "service": {"chunk": 64},
        "pipeline": {"aws_access_key_id": "AK",
                     "aws_secret_access_key": "SK"}}))
    parsed, knobs = simple_reporter.read_pipeline_config(str(conf))
    assert knobs == {"aws_access_key_id": "AK",
                     "aws_secret_access_key": "SK"}
    assert parsed["graph"] == graph and parsed["matcher"] == {"chunk": 64}
    conf.write_text(json.dumps({"graph": graph,
                                "pipeline": {"region": "x"}}))
    with pytest.raises(ValueError, match="unknown pipeline keys"):
        simple_reporter.read_pipeline_config(str(conf))
    assert simple_reporter.main(["--match-config", str(conf), "--match-dir",
                                 str(tmp_path), "--device", "cpu"]) == 1


def test_report_stage_threads_the_credentials(tmp_path, monkeypatch):
    """A bucket destination's tiles go out through ``egress_tile`` with
    the credentials the config named."""
    from reporter_tpu_torch.utils import http as http_egress
    sent = []
    monkeypatch.setattr(http_egress, "egress_tile",
                        lambda dest, key, payload, credentials=None:
                        sent.append((dest, key, credentials)) or True)
    rows = tmp_path / "rows" / "0_3599" / "0"
    rows.mkdir(parents=True)
    (rows / "42").write_text("5,6,10,1,600,0,0,10,src,AUTO\n" * 2)
    dest = "https://bucket.s3.amazonaws.com/prefix"
    simple_reporter._report_worker([str(rows / "42")],
                                   str(tmp_path / "rows"), dest, 2,
                                   ("AK", "SK"))
    ((got_dest, key, creds),) = sent
    assert got_dest == dest and creds == ("AK", "SK")
    assert key.startswith(os.path.join("0_3599", "0", "42") + "/")


def test_the_module_imports_no_torch():
    """Spawned gather and report children re-import the module: it must
    stay cheap and never reach the card."""
    probe = ("import sys, reporter_tpu_torch.pipeline.simple_reporter; "
             "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "False"
