"""The matcher, the service, the worker and the pipeline over a decode mesh
and across hosts, on the CPU.

A mesh that names ``cpu`` several times stands for several cards. The
contract is the JAX package's ``tests/test_sharded_decode.py``:

- ``match_many`` /report bodies are byte-equal at mesh widths 1, 2 and 8
  (five traces, so the rows do not divide and filler rows are decoded),
  on the native and the numpy path, and equal to the JAX matcher's on its
  8-device mesh;
- the default chunk scales by the data width and pads to its multiple,
  the dispatcher's default flush cap is two chunks on a mesh (256
  without), and the profiler keys a shape by the entries its decode
  spans, so a change of mesh is a new shape and no rebuild;
- device routes on a 2-entry mesh give the unsharded bodies, their
  relaxations split across the entries;
- the worker's ``--uuid-filter`` behaves as the JAX package's, and two
  workers (``--num-processes 2 --process-id 0|1``) over one stream, like
  two pipeline runs over one archive, write together the tile rows of one.
"""
import gzip
import json
import os

import numpy as np
import pytest

from reporter_tpu import ops as jax_ops
from reporter_tpu.matcher import MatchParams as JaxParams
from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.parallel import mesh as jax_mesh
from reporter_tpu.parallel import multihost as jax_multihost
from reporter_tpu.service.report import report_json as jax_report_json
from reporter_tpu.streaming import worker as jax_worker
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu.synth import generate_trace as jax_trace
from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
from reporter_tpu_torch.matcher.matcher import (MATCH_BATCH_DEFAULT,
                                                match_batch_default)
from reporter_tpu_torch.obs import profiler
from reporter_tpu_torch.parallel.multihost import owned_by_host
from reporter_tpu_torch.pipeline import simple_reporter
from reporter_tpu_torch.service.report import report_json
from reporter_tpu_torch.service.server import (ReporterService,
                                               parse_config,
                                               slot_matcher_keys)
from reporter_tpu_torch.streaming import worker
from reporter_tpu_torch.streaming.anonymiser import Anonymiser
from reporter_tpu_torch.streaming.formatter import Formatter
from reporter_tpu_torch.synth import build_grid_city, generate_trace
from reporter_tpu_torch.utils import metrics

CITY = dict(rows=8, cols=8, spacing_m=200.0, seed=17)
LEVELS = [(15, {0, 1, 2}, {0, 1, 2}), (3600, {0, 1}, {0, 1, 2})]


def cpus(n):
    return ["cpu"] * n


def mixed_reqs(city, make_trace, n=5, seed=23, max_edges=10):
    """The JAX package's ``_mixed_reqs``: ``n`` seeded traces."""
    rng = np.random.default_rng(seed)
    reqs = []
    while len(reqs) < n:
        tr = make_trace(city, f"v{len(reqs)}", rng, noise_m=4.0,
                        min_route_edges=5, max_route_edges=max_edges)
        if tr is not None:
            reqs.append({"uuid": tr.uuid, "trace": tr.points,
                         "match_options": {"mode": "auto"}})
    return reqs


@pytest.fixture(scope="module")
def cities():
    ref, port = jax_city(**CITY), build_grid_city(**CITY)
    reqs = mixed_reqs(port, generate_trace)
    assert reqs == mixed_reqs(ref, jax_trace)
    return ref, port, reqs


def bodies(matches, reqs, writer=report_json):
    return [[writer(m, r, *lv) for lv in LEVELS]
            for m, r in zip(matches, reqs)]


def matcher(city, n, **kw):
    kw.setdefault("params", MatchParams(max_candidates=6))
    return SegmentMatcher(city, device="cpu",
                          mesh_devices=cpus(n) if n > 1 else None, **kw)


@pytest.fixture(scope="module")
def jax_mesh_bodies(cities):
    """The JAX matcher's bodies on its 8-device mesh, by the scan (the
    bit-identity decode), native and numpy."""
    ref, _port, reqs = cities
    saved = jax_ops._sharded_cache
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("REPORTER_TPU_DECODE", "scan")
        mp.setenv("REPORTER_TPU_SHARD", "1")
        mp.delenv("REPORTER_TPU_DECODE_SHARD", raising=False)
        mp.delenv("REPORTER_TPU_DEVICE_SLICE", raising=False)
        jax_ops._sharded_cache = None
        jax_mesh.reset_decode_mesh()
        out = {}
        for native in (True, False):
            m = JaxMatcher(net=ref, params=JaxParams(max_candidates=6),
                           use_native=native)
            assert m.decode_mesh is not None \
                and m.decode_mesh.devices.size == 8
            out[native] = bodies(m.match_many(reqs), reqs, jax_report_json)
        return out
    finally:
        mp.undo()
        jax_ops._sharded_cache = saved
        jax_mesh.reset_decode_mesh()


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("n", [1, 2, 8])
def test_bodies_byte_equal_across_widths_and_to_the_jax_mesh(
        cities, jax_mesh_bodies, n, native):
    _ref, city, reqs = cities
    m = matcher(city, n, native=native)
    assert (m.decode_mesh is None) == (n == 1)
    c0 = metrics.default.counter("decode.shard.chunks")
    got = bodies(m.match_many(reqs), reqs)
    assert any('"segment_id"' in b[0] for b in got)
    assert got == jax_mesh_bodies[native]
    sharded = metrics.default.counter("decode.shard.chunks") - c0
    assert (sharded > 0) == (n > 1)
    m.close()


@pytest.mark.parametrize("pipeline", [True, False])
def test_assoc_on_a_data_mesh_equals_one_device(cities, pipeline):
    _ref, city, reqs = cities
    one = matcher(city, 1, decode="assoc", pipeline=pipeline)
    mesh4 = matcher(city, 4, decode="assoc", pipeline=pipeline)
    assert bodies(mesh4.match_many(reqs), reqs) == bodies(
        one.match_many(reqs), reqs)


def test_assoc_on_a_seq_mesh_serves(cities):
    """A (2, 2) mesh: rows and time split; each body equal to one
    device's but where the two decodes' paths tie (here none differ)."""
    _ref, city, reqs = cities
    m = matcher(city, 4, decode="assoc", seq_shards=2)
    assert m.decode_mesh.shape == (2, 2) and m.pad_rows == 2
    c0 = metrics.default.counter("decode.shard.chunks")
    got = bodies(m.match_many(reqs), reqs)
    assert metrics.default.counter("decode.shard.chunks") > c0
    want = bodies(matcher(city, 1, decode="assoc").match_many(reqs), reqs)
    assert got == want


def test_chunk_and_flush_cap_scale_with_the_mesh(cities):
    _ref, city, _reqs = cities
    one = matcher(city, 1)
    eight = matcher(city, 8)
    assert eight.chunk == 8 * one.chunk and eight.pad_rows == 8
    assert one.pad_rows is None
    assert match_batch_default(one) == MATCH_BATCH_DEFAULT == 256
    assert match_batch_default(eight) == max(256, 2 * eight.chunk)
    svc = ReporterService(eight)
    try:
        assert svc.dispatcher.max_batch == match_batch_default(eight)
    finally:
        svc.dispatcher.close()
    # an explicit chunk is not scaled, only padded to the data multiple
    assert matcher(city, 8, chunk=100).chunk == 104
    assert matcher(city, 1, chunk=100).chunk == 100
    # a seq mesh pads for assoc only
    assert matcher(city, 4, seq_shards=2).pad_rows is None
    assert matcher(city, 4, seq_shards=2, decode="assoc").pad_rows == 2


def test_rows_pad_to_the_data_multiple():
    from reporter_tpu_torch.matcher.batchpad import padded_batch_rows
    from reporter_tpu.matcher.batchpad import padded_batch_rows as jax_rows
    for B in range(1, 40):
        assert padded_batch_rows(B) == jax_rows(B, None)
        for pad in (2, 3, 4, 8):
            assert padded_batch_rows(B, pad) == jax_rows(B, pad)


def test_profiler_keys_a_shape_by_its_mesh(cities):
    _ref, city, reqs = cities
    profiler.reset()
    try:
        def keys():
            return {(s["B"], s["T"], s["backend"], s["mesh"])
                    for s in profiler.snapshot(n_events=0)["shapes"]}

        seen = []
        for n, kw in ((8, {}), (1, {}),
                      (4, {"decode": "assoc", "seq_shards": 2})):
            before = keys()
            matcher(city, n, pipeline=False, **kw).match_many(reqs)
            seen.append({(B, w) for B, _T, _b, w in keys() - before})
        assert seen[0] and all(B % 8 == 0 and w == 8 for B, w in seen[0])
        assert seen[1] and all(w == 1 for _B, w in seen[1])
        assert seen[2] and all(w == 4 for _B, w in seen[2])
        shapes = profiler.snapshot(n_events=0)["shapes"]
        assert sum(max(0, s["compiles"] - 1) for s in shapes) == 0
    finally:
        profiler.reset()


def test_device_routes_on_a_mesh_equal_unsharded(cities):
    _ref, city, reqs = cities
    want = bodies(matcher(city, 1, route_device=True).match_many(reqs), reqs)
    c0 = metrics.default.counter("route.device.sharded_chunks")
    m = matcher(city, 2, route_device=True)
    assert m.route_kernel.mesh is m.decode_mesh
    assert bodies(m.match_many(reqs), reqs) == want
    assert metrics.default.counter("route.device.sharded_chunks") > c0


def test_mesh_keys_through_the_config(cities, tmp_path):
    _ref, city, _reqs = cities
    base = {"graph": "g.npz"}
    conf = parse_config(dict(base, service={
        "decode_shard": "off", "device_slice": "0/2", "seq_shards": 2}))
    assert conf["matcher"] == {"decode_shard": "off", "device_slice": "0/2",
                               "seq_shards": 2}
    for bad in ({"decode_shard": "maybe"}, {"device_slice": "banana"},
                {"device_slice": 3}, {"seq_shards": 0},
                {"seq_shards": "2"}):
        with pytest.raises(ValueError):
            parse_config(dict(base, service=bad))
    import torch
    cuda = torch.device("cuda")
    assert slot_matcher_keys({}, cuda, 1, 2) == {"device_slice": "1/2"}
    assert slot_matcher_keys({"device_slice": "0:1"}, cuda, 1, 2) == {
        "device_slice": "0:1"}
    assert slot_matcher_keys({}, cuda, 0, 1) == {}
    assert slot_matcher_keys({}, torch.device("cpu"), 1, 2) == {}
    assert slot_matcher_keys({}, torch.device("cuda:1"), 1, 2) == {}
    with pytest.raises(ValueError):
        SegmentMatcher(city, device="cpu", decode_shard="maybe")
    with pytest.raises(ValueError):
        SegmentMatcher(city, device="cpu", mesh_devices=cpus(2),
                       device_slice="banana")


def test_close_closes_the_mesh(cities):
    _ref, city, reqs = cities
    m = matcher(city, 2)
    m.match_many(reqs)
    m.close()
    with pytest.raises(RuntimeError, match="closed"):
        m.match_many(reqs)


# -- the worker's uuid filter ------------------------------------------------

@pytest.mark.parametrize("mode,bootstrap,n,pid,on", [
    ("auto", None, 2, 1, True), ("auto", "broker:9092", 2, 1, False),
    ("on", "broker:9092", 2, 1, True), ("off", None, 2, 1, False),
    ("auto", None, None, None, False), ("on", None, 1, 0, False)])
def test_resolve_uuid_filter_as_the_jax_packages(monkeypatch, mode,
                                                 bootstrap, n, pid, on):
    for var, val in ((jax_multihost.ENV_NUM_PROCESSES, n),
                     (jax_multihost.ENV_PROCESS_ID, pid)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, str(val))
    want = jax_worker.resolve_uuid_filter(mode, bootstrap)
    got = worker.resolve_uuid_filter(mode, bootstrap, n, pid)
    assert (got is not None) == (want is not None) == on
    if on:
        uuids = [f"veh-{i}" for i in range(200)]
        assert [u for u in uuids if got(u)] == [u for u in uuids if want(u)]


def test_resolve_uuid_filter_refuses_bad_settings():
    with pytest.raises(ValueError):
        worker.resolve_uuid_filter("auto", None, 2, 2)
    with pytest.raises(ValueError):
        worker.resolve_uuid_filter("maybe", None, 2, 1)


def test_workers_partition_a_shared_stream():
    """The JAX package's ``test_workers_partition_shared_stream``: two
    workers over one stream process disjoint uuids, all of them."""
    from reporter_tpu_torch.streaming.worker import StreamWorker
    seen = [set(), set()]

    def make(pid):
        def submit(trace):
            seen[pid].add(trace["uuid"])
            return {"datastore": {"mode": "auto", "reports": []},
                    "shape_used": len(trace["trace"]), "stats": {}}
        sink = type("S", (), {"store": lambda self, *a, **k: None})()
        return StreamWorker(
            Formatter.from_config(';sv;,;0;2;3;1;4'), submit,
            Anonymiser(sink, 2, 3600), flush_interval_s=1e9,
            uuid_filter=lambda u, pid=pid: owned_by_host(u, 2, pid))

    lines = [f"veh-{i},{1500000000 + j * 10},{14.58 + j * 1e-3},121.0,10"
             for i in range(12) for j in range(12)]
    w0, w1 = make(0), make(1)
    for ln in lines:
        w0.offer(ln)
        w1.offer(ln)
    w0.drain()
    w1.drain()
    assert seen[0] and seen[1] and not seen[0] & seen[1]
    assert seen[0] | seen[1] == {f"veh-{i}" for i in range(12)}
    assert w0.skipped_other_host and w1.skipped_other_host


def rows_by_dir(root):
    """{tile directory: sorted data rows} of every tile file under
    ``root`` (headers and the dead-letter spool left out)."""
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if not d.startswith(".")]
        for name in files:
            with open(os.path.join(dirpath, name)) as f:
                lines = f.read().splitlines()[1:]
            out.setdefault(os.path.relpath(dirpath, root), []).extend(lines)
    return {k: sorted(v) for k, v in out.items()}


def merged(*trees):
    out = {}
    for t in trees:
        for k, v in t.items():
            out[k] = sorted(out.get(k, []) + v)
    return out


SV = r",sv,\|,0,1,2,3,4"


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_stream")
    city = build_grid_city(rows=10, cols=10, spacing_m=200.0, seed=5)
    graph = str(root / "city.npz")
    city.save(graph)
    rng = np.random.default_rng(31)
    rows, i = [], 0
    while i < 12:
        tr = generate_trace(city, f"veh-{i}", rng, noise_m=4.0,
                            sample_period_s=5.0,
                            start_time=1_500_000_000 + 20 * i)
        if tr is None:
            continue
        rows += [(p["time"], tr.uuid, p) for p in tr.points]
        i += 1
    rows.sort(key=lambda r: (r[0], r[1]))
    path = str(root / "stream.txt")
    with open(path, "w") as f:
        f.write("\n".join(f"{u}|{p['lat']}|{p['lon']}|{p['time']}|"
                          f"{p['accuracy']}" for _t, u, p in rows) + "\n")
    return graph, path


def test_two_workers_write_one_workers_tiles(stream, tmp_path):
    graph, path = stream

    def run(out, *extra):
        assert worker.main(["-f", SV, "--graph", graph, "-p", "1", "-q",
                            "3600", "-i", "1000000000", "-s", "t", "-o",
                            out, "--input", path, "-r", "0,1,2", "-x",
                            "0,1,2", "--report-flush-interval", "0",
                            "--device", "cpu", *extra]) == 0
        return rows_by_dir(out)

    one = run(str(tmp_path / "one"))
    parts = [run(str(tmp_path / f"p{p}"), "--num-processes", "2",
                 "--process-id", str(p)) for p in range(2)]
    assert one and parts[0] and parts[1]
    assert merged(*parts) == one
    # --uuid-filter off: each of the two processes writes everything
    assert run(str(tmp_path / "off"), "--num-processes", "2",
               "--process-id", "1", "--uuid-filter", "off") == one
    assert worker.main(["-f", SV, "--graph", graph, "-p", "1", "-q", "3600",
                        "-i", "1", "-s", "t", "-o", str(tmp_path / "bad"),
                        "--input", path, "--device", "cpu",
                        "--num-processes", "2", "--process-id", "2"]) == 1


def test_two_pipeline_hosts_write_one_runs_tiles(tmp_path, monkeypatch):
    """Two pipeline runs over one archive, ``--process-id`` 0 and 1 of 2:
    each gathers only its uuids, and their tile rows together are one
    run's (privacy 1, so no host's cull depends on the other's rows)."""
    monkeypatch.chdir(tmp_path)
    city = build_grid_city(rows=10, cols=10, spacing_m=200.0, seed=4)
    graph = str(tmp_path / "city.npz")
    city.save(graph)
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"graph": graph}))
    rng = np.random.default_rng(41)
    lines = []
    for i in range(24):
        tr = None
        while tr is None:
            tr = generate_trace(city, f"veh-{i}", rng, noise_m=3.0,
                                start_time=1_500_000_000 + 37 * i,
                                min_route_edges=10)
        for p in tr.points:
            cols = ["x"] * 11
            cols[0], cols[1] = str(p["time"]), tr.uuid
            cols[5], cols[9], cols[10] = (str(p["accuracy"]), str(p["lat"]),
                                          str(p["lon"]))
            lines.append("|".join(cols))
    src = tmp_path / "src"
    src.mkdir()
    for k in range(2):
        opener = gzip.open if k else open
        name = f"part-{k}" + (".gz" if k else "")
        with opener(str(src / name), "wt") as f:
            f.write("\n".join(lines[k::2]) + "\n")

    def run(name, *extra):
        assert simple_reporter.main(
            ["--src", str(src), "--match-config", str(conf),
             "--concurrency", "2", "--privacy", "1", "--source-id", "t",
             "--dest", str(tmp_path / name), "--device", "cpu",
             *extra]) == 0
        return rows_by_dir(str(tmp_path / name))

    one = run("one")
    parts = [run(f"p{p}", "--num-processes", "2", "--process-id", str(p))
             for p in range(2)]
    assert one and parts[0] and parts[1]
    assert merged(*parts) == one
