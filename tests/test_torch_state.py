"""The port's durable streaming state against the JAX package's.

The v3 snapshot (``streaming/state.py``) is one format in both packages:
the same batcher and anonymiser state snapshots to the same bytes (the
header's wall-clock stamp aside), a snapshot written by either package
restores in the other, carried decode frames included, and the
flush-epoch protocol (pre-egress snapshot, deterministic epoch names,
the committed-epoch marker) behaves the same. The cases are the JAX
package's ``tests/test_state.py``, run on both packages where they
compare outputs. Tolerance: exact.
"""
import os
import struct

import numpy as np
import pytest

from reporter_tpu.core import types as jax_types
from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.streaming import anonymiser as jax_anon
from reporter_tpu.streaming import batcher as jax_batcher
from reporter_tpu.streaming import state as jax_state
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu.synth import generate_trace as jax_trace
from reporter_tpu_torch.core.types import Point, Segment
from reporter_tpu_torch.matcher import SegmentMatcher
from reporter_tpu_torch.streaming import state as state_mod
from reporter_tpu_torch.streaming.anonymiser import Anonymiser, TileSink
from reporter_tpu_torch.streaming.batcher import Batch, PointBatcher
from reporter_tpu_torch.streaming.state import (StateStore, restore_bytes,
                                                snapshot_bytes)
from reporter_tpu_torch.synth import build_grid_city, generate_trace

CITY = dict(rows=10, cols=10, spacing_m=200.0, seed=5,
            service_road_fraction=0.0, internal_fraction=0.0)


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


def _batcher():
    return PointBatcher(lambda trace: None, lambda key, seg: None)


def _anonymiser(tmp_path):
    return Anonymiser(TileSink(str(tmp_path / "tiles")), privacy=1,
                      quantisation=3600)


def _seg(i=1, n=2, t0=1000.0):
    return Segment(id=i, next_id=n, min=t0, max=t0 + 30.0, length=500,
                   queue=0)


def without_stamp(raw: bytes) -> bytes:
    """A snapshot with its header's wall-clock stamp zeroed."""
    return raw[:8] + bytes(8) + raw[16:]


def seeded_state(P, B, PB, A, S, Seg, tmp_path, seed=5):
    """A batcher and an anonymiser of one package filled from one numpy
    seed: open batches (one pending, one retrying), tile slices across
    time buckets and a flush epoch."""
    rng = np.random.default_rng(seed)
    b = PB(lambda t: None, lambda k, s: None)
    for u in range(6):
        batch = B(P(14.6 + float(rng.uniform(0, .01)), 121.0, 10, 100))
        for i in range(int(rng.integers(1, 9))):
            batch.update(P(14.6 + float(rng.uniform(0, .01)),
                           121.0 + float(rng.uniform(0, .01)),
                           int(rng.integers(3, 30)), 100 + 5 * (i + 1)))
        batch.last_update = int(rng.integers(0, 10 ** 12))
        batch.retries = u % 3
        b.store[f"veh-{u}"] = batch
    b.pending["veh-2"] = None
    a = A(S(str(tmp_path)), privacy=1, quantisation=900)
    for _ in range(40):
        t0 = 1.5e9 + float(rng.uniform(0, 5000))
        s = Seg(int(rng.integers(1, 6)) << 25, int(rng.integers(1, 4)), t0,
                t0 + float(rng.uniform(1, 1000)), 400, 0)
        a.process(f"{s.id} {s.next_id}", s)
    a.flush_epoch = 7
    return b, a


JAX = (jax_types.Point, jax_batcher.Batch, jax_batcher.PointBatcher,
       jax_anon.Anonymiser, jax_anon.TileSink, jax_types.Segment)
PORT = (Point, Batch, PointBatcher, Anonymiser, TileSink, Segment)


class TestSnapshotRoundtrip:
    def test_snapshot_bytes_equal_the_jax_package(self, tmp_path):
        jb, ja = seeded_state(*JAX, tmp_path / "j")
        b, a = seeded_state(*PORT, tmp_path / "p")
        frames = [("veh-1", b"\x01\x02"), ("veh-3", bytes(range(40)))]
        assert without_stamp(snapshot_bytes(b, a, incremental=frames)) == \
            without_stamp(jax_state.snapshot_bytes(jb, ja,
                                                   incremental=frames))

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_either_package_restores_the_others_snapshot(self, tmp_path,
                                                         writer):
        src = JAX if writer == "jax" else PORT
        dst = PORT if writer == "jax" else JAX
        write = (jax_state if writer == "jax" else state_mod).snapshot_bytes
        read = (state_mod if writer == "jax" else jax_state).restore_bytes
        b, a = seeded_state(*src, tmp_path / "src")
        frames = [("veh-4", b"carried")]
        raw = write(b, a, incremental=frames)
        b2 = dst[2](lambda t: None, lambda k, s: None)
        a2 = dst[3](dst[4](str(tmp_path / "dst")), privacy=1,
                    quantisation=900)
        assert read(raw, b2, a2) == frames
        # ...and the restored state snapshots back to the same bytes
        back = (state_mod if writer == "jax" else jax_state).snapshot_bytes
        assert without_stamp(back(b2, a2, incremental=frames)) == \
            without_stamp(raw)

    def test_batches_and_slices_survive(self, tmp_path):
        b, a = _batcher(), _anonymiser(tmp_path)
        batch = Batch(Point(lat=14.6, lon=121.0, accuracy=10, time=100))
        batch.update(Point(lat=14.61, lon=121.01, accuracy=12, time=160))
        batch.last_update = 160000
        batch.retries = 1
        b.store["veh-1"] = batch
        b.pending["veh-1"] = None
        a.process("1 2", _seg())
        a.flush_epoch = 7
        b2, a2 = _batcher(), _anonymiser(tmp_path)
        restore_bytes(snapshot_bytes(b, a), b2, a2)
        got = b2.store["veh-1"]
        assert (got.last_update, got.retries) == (160000, 1)
        assert got.max_separation == pytest.approx(batch.max_separation)
        assert [p.to_bytes() for p in got.points] == \
            [p.to_bytes() for p in batch.points]
        assert list(b2.pending) == ["veh-1"]
        assert {k: [s.to_bytes() for s in v] for k, v in a2.slices.items()} \
            == {k: [s.to_bytes() for s in v] for k, v in a.slices.items()}
        assert a2.slice_of == a.slice_of and a2.flush_epoch == 7

    def test_points_roundtrip_losslessly(self):
        p = Point(lat=14.600001234, lon=121.0000056789, accuracy=10,
                  time=100)
        q = Point.from_bytes(p.to_bytes())
        assert (q.lat, q.lon, q.accuracy, q.time) == \
            (p.lat, p.lon, p.accuracy, p.time)
        ref = jax_types.Point(lat=14.600001234, lon=121.0000056789,
                              accuracy=10, time=100)
        assert (p.lat, p.lon) == (ref.lat, ref.lon)

    def test_empty_state_roundtrips(self, tmp_path):
        b, a = _batcher(), _anonymiser(tmp_path)
        b2, a2 = _batcher(), _anonymiser(tmp_path)
        assert restore_bytes(snapshot_bytes(b, a), b2, a2) == []
        assert not b2.store and not a2.slices


def stores(tmp_path, name="state.bin"):
    """The port's and the JAX package's StateStore on sibling paths."""
    return (StateStore(str(tmp_path / "p" / name)),
            jax_state.StateStore(str(tmp_path / "j" / name)))


class TestStateStore:
    def test_restore_missing_file_is_fresh_start(self, tmp_path):
        store = StateStore(str(tmp_path / "state.bin"))
        assert store.restore(_batcher(), _anonymiser(tmp_path)) is False

    def test_save_then_restore(self, tmp_path):
        path = str(tmp_path / "state.bin")
        b, a = _batcher(), _anonymiser(tmp_path)
        b.store["u"] = Batch(Point(lat=1.0, lon=2.0, accuracy=5, time=7))
        StateStore(path).save(b, a)
        b2, a2 = _batcher(), _anonymiser(tmp_path)
        assert StateStore(path).restore(b2, a2) is True
        assert "u" in b2.store

    @pytest.mark.parametrize("raw", [b"RTS1garbage",
                                     struct.pack("<4sIQ", b"RTS1", 1, 0)
                                     + struct.pack("<I", 0) * 3])
    def test_corrupt_or_v1_snapshot_discarded(self, tmp_path, raw):
        for store in stores(tmp_path):
            os.makedirs(os.path.dirname(store.path), exist_ok=True)
            with open(store.path, "wb") as f:
                f.write(raw)
        port, ref = stores(tmp_path)
        assert port.restore(_batcher(), _anonymiser(tmp_path)) is False
        assert ref.restore(jax_batcher.PointBatcher(lambda t: None,
                                                    lambda k, s: None),
                           jax_anon.Anonymiser(
                               jax_anon.TileSink(str(tmp_path / "jt")),
                               1, 3600)) is False

    def test_truncated_snapshot_discarded(self, tmp_path):
        b, a = _batcher(), _anonymiser(tmp_path)
        b.store["u"] = Batch(Point(lat=1.0, lon=2.0, accuracy=5, time=7))
        a.process("1 2", _seg())
        raw = snapshot_bytes(b, a)
        path = tmp_path / "state.bin"
        path.write_bytes(raw[:len(raw) // 2])
        b2, a2 = _batcher(), _anonymiser(tmp_path)
        assert StateStore(str(path)).restore(b2, a2) is False
        assert not b2.store and not a2.slices and not a2.slice_of

    def test_marker_survives_lost_snapshot_and_seeds_epoch(self, tmp_path):
        store = StateStore(str(tmp_path / "state.bin"))
        store.commit_epoch(4)
        b, a = _batcher(), _anonymiser(tmp_path)
        assert store.restore(b, a) is False
        assert a.flush_epoch == 5
        (tmp_path / "state.bin").write_bytes(b"RTS1garbage")
        b2, a2 = _batcher(), _anonymiser(tmp_path)
        assert StateStore(str(tmp_path / "state.bin")).restore(b2, a2) \
            is False
        assert a2.flush_epoch == 5
        # the marker's text is the JAX package's
        ref = jax_state.StateStore(str(tmp_path / "j.bin"))
        ref.commit_epoch(4)
        assert open(store.epoch_path).read() == open(ref.epoch_path).read()

    def test_maybe_save_respects_interval(self, tmp_path):
        now = [0.0]
        store = StateStore(str(tmp_path / "s.bin"), interval_s=30.0,
                           clock=lambda: now[0])
        b, a = _batcher(), _anonymiser(tmp_path)
        assert store.maybe_save(b, a) is False
        now[0] = 31.0
        assert store.maybe_save(b, a) is True
        assert store.maybe_save(b, a) is False

    def test_maybe_save_every_nth_call(self, tmp_path):
        """``every``: the snapshot's position is a count of calls, not a
        wall time."""
        store = StateStore(str(tmp_path / "s.bin"), interval_s=0.0,
                           every=3)
        b, a = _batcher(), _anonymiser(tmp_path)
        assert [store.maybe_save(b, a) for _ in range(7)] == \
            [False, False, True, False, False, True, False]


class TestFlushEpochExactlyOnce:
    def _tiles(self, out):
        return sorted(os.path.join(r, f) for r, _d, fs in os.walk(out)
                      for f in fs if ".deadletter" not in r)

    def test_crash_after_commit_before_save_skips_epoch(self, tmp_path):
        out = tmp_path / "tiles"
        path = str(tmp_path / "state.bin")
        b, a = _batcher(), Anonymiser(TileSink(str(out)), privacy=1,
                                      quantisation=3600)
        a.process("1 2", _seg())
        store = StateStore(path)
        store.save(b, a)
        epoch = a.flush_epoch
        assert a.punctuate() == 1
        store.commit_epoch(epoch)
        tiles = self._tiles(out)
        assert len(tiles) == 1 and tiles[0].endswith(".e00000000")
        b2, a2 = _batcher(), Anonymiser(TileSink(str(out)), privacy=1,
                                        quantisation=3600)
        assert StateStore(path).restore(b2, a2) is True
        assert not a2.slices and not a2.slice_of
        assert a2.flush_epoch == 1
        a2.punctuate()
        assert self._tiles(out) == tiles

    def test_crash_before_commit_reemits_same_file_name(self, tmp_path):
        out = tmp_path / "tiles"
        path = str(tmp_path / "state.bin")
        b, a = _batcher(), Anonymiser(TileSink(str(out)), privacy=1,
                                      quantisation=3600)
        a.process("1 2", _seg())
        StateStore(path).save(b, a)
        a.punctuate()
        before = self._tiles(out)
        b2, a2 = _batcher(), Anonymiser(TileSink(str(out)), privacy=1,
                                        quantisation=3600)
        assert StateStore(path).restore(b2, a2) is True
        assert a2.slices and a2.flush_epoch == 0
        assert a2.punctuate() == 1
        assert self._tiles(out) == before

    def test_pre_egress_barrier_makes_report_trims_durable(self, tmp_path):
        response = {"shape_used": 5, "datastore": {"reports": [{
            "id": 1, "next_id": 2, "t0": 1000.0, "t1": 1030.0,
            "length": 500, "queue_length": 0}]}}
        out = tmp_path / "tiles"
        a = Anonymiser(TileSink(str(out)), privacy=1, quantisation=3600)
        b = PointBatcher(lambda t: None,
                         lambda key, seg: a.process(key, seg),
                         submit_many=lambda tb: [response] * len(tb))
        for i in range(12):
            b.process("veh", Point(lat=14.6 + i * 0.001, lon=121.0,
                                   accuracy=10, time=1000 + i * 10),
                      stream_time_ms=(1000 + i * 10) * 1000)
        assert "veh" in b.pending
        b.flush_pending()
        assert len(b.store["veh"].points) == 7
        store = StateStore(str(tmp_path / "state.bin"))
        store.save(b, a)
        epoch = a.flush_epoch
        assert a.punctuate() == 1
        store.commit_epoch(epoch)
        a2 = Anonymiser(TileSink(str(out)), privacy=1, quantisation=3600)
        b2 = PointBatcher(lambda t: None, lambda k, s: None)
        assert StateStore(str(tmp_path / "state.bin")).restore(b2, a2)
        assert not a2.slices
        assert len(b2.store["veh"].points) == 7
        assert not b2.pending

    def test_normal_flush_then_save_does_not_skip(self, tmp_path):
        out = tmp_path / "tiles"
        path = str(tmp_path / "state.bin")
        b, a = _batcher(), Anonymiser(TileSink(str(out)), privacy=1,
                                      quantisation=3600)
        a.process("1 2", _seg())
        store = StateStore(path)
        epoch = a.flush_epoch
        a.punctuate()
        store.commit_epoch(epoch)
        store.save(b, a)
        a.process("1 2", _seg(t0=2000.0))
        store.save(b, a)
        b2, a2 = _batcher(), Anonymiser(TileSink(str(out)), privacy=1,
                                        quantisation=3600)
        assert StateStore(path).restore(b2, a2) is True
        assert a2.slices and a2.flush_epoch == 1


def crash_resume_tiles(pkg, tmp_path, lines):
    """Half a trace through one package's worker with a snapshot after
    every message, a 'crash' (no drain), a fresh worker restored from
    the snapshot reading the rest: (the restored worker's open batch,
    its carried decode states, the tile tree)."""
    if pkg == "jax":
        from reporter_tpu.service.server import ReporterService as Svc
        from reporter_tpu.streaming.formatter import Formatter as F
        from reporter_tpu.streaming.worker import StreamWorker as W
        from reporter_tpu.streaming.worker import inproc_submitter as sub
        city = jax_city(**CITY)
        matcher = JaxMatcher(net=city)
        A, S, St = jax_anon.Anonymiser, jax_anon.TileSink, \
            jax_state.StateStore
    else:
        from reporter_tpu_torch.service.server import ReporterService as Svc
        from reporter_tpu_torch.streaming.formatter import Formatter as F
        from reporter_tpu_torch.streaming.worker import StreamWorker as W
        from reporter_tpu_torch.streaming.worker import \
            inproc_submitter as sub
        matcher = SegmentMatcher(build_grid_city(**CITY), device="cpu")
        A, S, St = Anonymiser, TileSink, StateStore
    out = str(tmp_path / pkg / "results")
    state_path = str(tmp_path / pkg / "state.bin")
    service = Svc(matcher, threshold_sec=15, max_wait_ms=1.0)

    def make_worker():
        return W(F.from_config(r",sv,\|,0,1,2,3,4"), sub(service),
                 A(S(out), privacy=1, quantisation=3600, source="t"),
                 reports="0,1,2", transitions="0,1,2",
                 flush_interval_s=1e9, report_flush_interval_s=0.0,
                 submit_many=service.report_incremental,
                 state=St(state_path, interval_s=0.0,
                          incremental=lambda: matcher.incremental_table))

    w1 = make_worker()
    assert w1.restored is False
    half = len(lines) // 2
    for line in lines[:half]:
        w1.offer(line)
    w2 = make_worker()
    assert w2.restored is True
    n_open = len(w2.batcher.store["veh"].points)
    frames = matcher.incremental_table.gauge()["traces"]
    for line in lines[half:]:
        w2.offer(line)
    w2.drain()
    service.dispatcher.close()
    tiles = {}
    for r, _d, fs in os.walk(out):
        for f in fs:
            with open(os.path.join(r, f), "rb") as fh:
                tiles[os.path.relpath(os.path.join(r, f), out)] = fh.read()
    return n_open, frames, tiles


def test_worker_crash_resume_equals_the_jax_package(tmp_path):
    """Feed half a trace, 'crash' (no drain), restart from the snapshot
    (v3: the carried decode state too), feed the rest: both packages
    restore the same open batch and write the same tiles."""
    rng = np.random.default_rng(3)
    tr = None
    while tr is None:
        tr = generate_trace(build_grid_city(**CITY), "veh", rng,
                            noise_m=3.0, min_route_edges=10)
    rng = np.random.default_rng(3)
    ref = None
    while ref is None:
        ref = jax_trace(jax_city(**CITY), "veh", rng, noise_m=3.0,
                        min_route_edges=10)
    assert tr.points == ref.points
    lines = [f"veh|{p['lat']}|{p['lon']}|{p['time']}|{p['accuracy']}"
             for p in tr.points]
    got = crash_resume_tiles("port", tmp_path, lines)
    want = crash_resume_tiles("jax", tmp_path, lines)
    assert got == want
    n_open, frames, tiles = got
    assert n_open > 0 and frames == 1 and tiles
