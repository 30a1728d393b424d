"""The port's OSM XML importer (``reporter_tpu_torch.graph.osm``) and OSM
fixture town (``tools/osm_fixture.py``) against the JAX package's.

The first part ports the JAX package's ``tests/test_osm.py`` (parsing,
classification, OSMLR ids, matching and queue lengths on an imported
network) and ``tests/test_osm_accuracy.py`` (the fixture town's accuracy
gates) onto the port, on the CPU. The second part holds both packages to
each other: ``build_city_xml`` gives the same bytes, the importers give
the same columns (dtypes, values, segment-id synthesis order, in-way
offsets, float32 lengths) and the same ``map_version`` tokens, with and
without ``.profile`` bytes, and the queue-length traces answer with the
JAX service's bodies. Tolerance: exact.
"""
import io

import numpy as np
import pytest

from reporter_tpu_torch.core.osmlr import segment_index, tile_level
from reporter_tpu_torch.graph.network import COLUMNS
from reporter_tpu_torch.graph.osm import network_from_osm_xml
from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
from reporter_tpu_torch.synth import generate_trace
from reporter_tpu_torch.tools.accuracy_cli import score
from reporter_tpu_torch.tools.osm_fixture import build_city_xml

# A small real-shaped extract: a primary two-way street, a oneway
# residential, a reverse-oneway street, a motorway ramp (internal), a
# service alley (unassociated), a non-drivable footway, and a way with a
# node missing from the extract (clipped).
OSM_XML = """<?xml version="1.0" encoding="UTF-8"?>
<osm version="0.6" generator="test">
  <node id="1" lat="14.5800" lon="121.0000"/>
  <node id="2" lat="14.5810" lon="121.0000"/>
  <node id="3" lat="14.5820" lon="121.0000"/>
  <node id="4" lat="14.5810" lon="121.0010"/>
  <node id="5" lat="14.5820" lon="121.0010"/>
  <node id="6" lat="14.5800" lon="121.0010"/>
  <node id="7" lat="14.5830" lon="121.0000"/>
  <node id="8" lat="14.5840" lon="121.0010"/>
  <node id="9" lat="14.5850" lon="121.0010"/>
  <node id="10" lat="14.5860" lon="121.0010"/>
  <way id="100">
    <nd ref="1"/><nd ref="2"/><nd ref="3"/>
    <tag k="highway" v="primary"/>
    <tag k="maxspeed" v="50"/>
  </way>
  <way id="101">
    <nd ref="2"/><nd ref="4"/>
    <tag k="highway" v="residential"/>
    <tag k="oneway" v="yes"/>
  </way>
  <way id="102">
    <nd ref="4"/><nd ref="5"/>
    <tag k="highway" v="residential"/>
    <tag k="oneway" v="-1"/>
    <tag k="maxspeed" v="20 mph"/>
  </way>
  <way id="103">
    <nd ref="3"/><nd ref="5"/>
    <tag k="highway" v="motorway_link"/>
  </way>
  <way id="104">
    <nd ref="4"/><nd ref="6"/>
    <tag k="highway" v="service"/>
  </way>
  <way id="105">
    <nd ref="1"/><nd ref="6"/>
    <tag k="highway" v="footway"/>
  </way>
  <way id="106">
    <nd ref="7"/><nd ref="999"/>
    <tag k="highway" v="residential"/>
  </way>
  <way id="107">
    <nd ref="8"/><nd ref="9"/><nd ref="10"/>
    <tag k="highway" v="residential"/>
    <tag k="oneway" v="yes"/>
  </way>
</osm>
"""


@pytest.fixture(scope="module")
def net():
    return network_from_osm_xml(io.BytesIO(OSM_XML.encode()))


def _edges_between(net, a_osm_idx, b_osm_idx):
    return [e for e in range(net.num_edges)
            if net.edge_start[e] == a_osm_idx and net.edge_end[e] == b_osm_idx]


class TestImport:
    def test_counts(self, net):
        # way 100: 2 node pairs x 2 dirs = 4; way 101: 1; way 102: 1;
        # way 103: 2 dirs? no - _link is internal but still two-way: 2;
        # way 104 service two-way: 2; way 107 oneway 2 pairs: 2;
        # footway skipped; clipped way dropped
        assert net.num_edges == 4 + 1 + 1 + 2 + 2 + 2

    def test_two_way_and_oneway(self, net):
        s = net.edge_start.tolist()
        e = net.edge_end.tolist()
        pairs = set(zip(s, e))
        # primary is bidirectional between consecutive nodes
        assert (0, 1) in pairs and (1, 0) in pairs
        # oneway=yes: only forward
        assert (1, 3) in pairs and (3, 1) not in pairs
        # oneway=-1: only reverse
        assert (4, 3) in pairs and (3, 4) not in pairs

    def test_speeds(self, net):
        e_fwd = _edges_between(net, 0, 1)[0]
        assert net.edge_speed_kph[e_fwd] == pytest.approx(50.0)
        e_rev = _edges_between(net, 4, 3)[0]
        assert net.edge_speed_kph[e_rev] == pytest.approx(32.19, abs=0.01)

    def test_osmlr_levels_and_association(self, net):
        e_primary = _edges_between(net, 0, 1)[0]
        sid = int(net.edge_segment_id[e_primary])
        assert sid >= 0
        assert tile_level(sid) == 1  # primary -> arterial level
        assert sid in net.segment_length_m
        e_res = _edges_between(net, 1, 3)[0]
        assert tile_level(int(net.edge_segment_id[e_res])) == 2

    def test_internal_and_service_unassociated(self, net):
        e_ramp = _edges_between(net, 2, 4)[0]
        assert net.edge_internal[e_ramp]
        assert net.edge_segment_id[e_ramp] == -1
        e_svc = _edges_between(net, 3, 5)[0]
        assert not net.edge_internal[e_svc]
        assert net.edge_segment_id[e_svc] == -1

    def test_direction_segments_distinct(self, net):
        # each direction of a two-way associated way is its own segment
        e_fwd = _edges_between(net, 0, 1)[0]
        e_rev = _edges_between(net, 1, 0)[0]
        a, b = int(net.edge_segment_id[e_fwd]), int(net.edge_segment_id[e_rev])
        assert a != b and a >= 0 and b >= 0
        assert segment_index(a) != segment_index(b)

    def test_segments_split_at_junctions(self, net):
        # way 100 passes through node 2, which way 101 also uses — a
        # decision point, so the OSMLR segment SPLITS there (real OSMLR
        # breaks at intersections); each piece restarts its offsets and
        # carries its own length
        e1 = _edges_between(net, 0, 1)[0]
        e2 = _edges_between(net, 1, 2)[0]
        assert int(net.edge_segment_id[e1]) != int(net.edge_segment_id[e2])
        assert net.edge_segment_offset_m[e1] == pytest.approx(0.0)
        assert net.edge_segment_offset_m[e2] == pytest.approx(0.0)
        for e in (e1, e2):
            sid = int(net.edge_segment_id[e])
            assert net.segment_length_m[sid] == pytest.approx(
                float(net.edge_length_m[e]), rel=1e-5)

    def test_segment_offsets_cumulative_between_junctions(self, net):
        # way 107's interior node 9 belongs to no other way: NOT a
        # decision point, so both edges share one segment with
        # cumulative offsets
        lat9 = 14.5850
        n9 = int(np.argmin(np.abs(net.node_lat - lat9)))
        e1 = [e for e in range(net.num_edges) if net.edge_end[e] == n9][0]
        e2 = [e for e in range(net.num_edges) if net.edge_start[e] == n9][0]
        assert int(net.edge_segment_id[e1]) == int(net.edge_segment_id[e2])
        assert net.edge_segment_offset_m[e1] == pytest.approx(0.0)
        assert net.edge_segment_offset_m[e2] == pytest.approx(
            net.edge_length_m[e1], rel=1e-5)
        sid = int(net.edge_segment_id[e1])
        assert net.segment_length_m[sid] == pytest.approx(
            float(net.edge_length_m[e1] + net.edge_length_m[e2]), rel=1e-5)

    def test_no_drivable_ways_raises(self):
        xml = ('<?xml version="1.0"?><osm>'
               '<node id="1" lat="0" lon="0"/></osm>')
        with pytest.raises(ValueError):
            network_from_osm_xml(io.BytesIO(xml.encode()))

    def test_roundtrip_npz(self, net, tmp_path):
        from reporter_tpu_torch.graph.network import RoadNetwork
        p = tmp_path / "osm.npz"
        net.save(str(p))
        back = RoadNetwork.load(str(p))
        assert back.num_edges == net.num_edges
        np.testing.assert_array_equal(back.edge_segment_id,
                                      net.edge_segment_id)


class TestMatchOnImported:
    def test_trace_matches_primary_street(self, net):
        """Probes along the primary way decode to its OSMLR segment."""
        from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher

        m = SegmentMatcher(net, MatchParams(max_candidates=4), device="cpu")
        rng = np.random.default_rng(0)
        # walk node 1 -> 3 (indices 0..2) at ~30 km/h with 3 m noise
        lats = np.linspace(14.5800, 14.5820, 12)
        pts = [{"lat": float(la + rng.normal(0, 3e-5)),
                "lon": float(121.0 + rng.normal(0, 3e-5)),
                "time": 1500000000 + i * 7} for i, la in enumerate(lats)]
        out = m.match_many([{"uuid": "osm-veh", "trace": pts}])[0]
        sids = {s.get("segment_id") for s in out["segments"]
                if "segment_id" in s}
        e_fwd = _edges_between(net, 0, 1)[0]
        assert int(net.edge_segment_id[e_fwd]) in sids


class TestQueueLength:
    """queue_length = slow tail measured from the segment end
    (reference README.md:283)."""

    def _match(self, net, pts):
        from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
        m = SegmentMatcher(net, MatchParams(max_candidates=4), device="cpu")
        return m.match_many([{"uuid": "q", "trace": pts}])[0]

    def test_stalled_tail_reports_queue(self, net):
        # fast along the primary, then creep near the segment end
        pts, t = [], 1500000000
        for la in np.linspace(14.5800, 14.58145, 8):
            pts.append({"lat": float(la), "lon": 121.0, "time": t}); t += 3
        for i in range(4):  # ~1.6 m / 7 s ≈ 0.8 km/h
            pts.append({"lat": 14.58146 + i * 1.5e-5, "lon": 121.0,
                        "time": t}); t += 7
        out = self._match(net, pts)
        # the way splits into per-block OSMLR segments at node 2; the
        # stall sits on the 2->3 piece, so find the queued segment
        seg = max((s for s in out["segments"] if "segment_id" in s),
                  key=lambda s: s["queue_length"])
        assert seg["queue_length"] > 20
        sid = seg["segment_id"]
        assert seg["queue_length"] <= net.segment_length_m[sid]

    def test_free_flow_has_no_queue(self, net):
        pts = [{"lat": float(la), "lon": 121.0, "time": 1500000000 + i * 3}
               for i, la in enumerate(np.linspace(14.5800, 14.5818, 10))]
        out = self._match(net, pts)
        for s in out["segments"]:
            assert s["queue_length"] == 0

    def test_midsegment_slowdown_then_recovery_clears_queue(self, net):
        # slow in the MIDDLE of the 2->3 block-segment (the way splits at
        # node 2 now), fast again before its end: queue resets to 0
        pts, t = [], 1500000000
        for la in np.linspace(14.5810, 14.58125, 4):
            pts.append({"lat": float(la), "lon": 121.0, "time": t}); t += 3
        for i in range(3):  # crawl mid-segment
            pts.append({"lat": 14.5813 + i * 1.5e-5, "lon": 121.0,
                        "time": t}); t += 7
        for la in np.linspace(14.5815, 14.5819, 5):
            pts.append({"lat": float(la), "lon": 121.0, "time": t}); t += 3
        out = self._match(net, pts)
        for s in out["segments"]:
            assert s["queue_length"] == 0

    def test_far_from_end_stall_reports_no_queue(self, net):
        # stall early in a LONG segment (>100 m from its end): the
        # segment end was never observed, so no queue may be
        # extrapolated. Way 107 (nodes 8->10, ~222 m) has no interior
        # junction, so it stays one segment after splitting.
        pts, t = [], 1500000000
        for la in np.linspace(14.5840, 14.5843, 4):
            pts.append({"lat": float(la), "lon": 121.001, "time": t})
            t += 3
        for i in range(4):
            pts.append({"lat": 14.58432 + i * 1.5e-5, "lon": 121.001,
                        "time": t}); t += 7
        out = self._match(net, pts)
        for s in out["segments"]:
            assert s["queue_length"] == 0

    def test_offnetwork_tail_reports_no_queue(self, net):
        # trailing points with no candidates (vehicle left the mapped
        # network) must not be mistaken for a stalled queue
        pts, t = [], 1500000000
        for la in np.linspace(14.5800, 14.58145, 8):
            pts.append({"lat": float(la), "lon": 121.0, "time": t}); t += 3
        for i in range(4):  # far off any road, minutes of dwell
            pts.append({"lat": 14.60, "lon": 121.05, "time": t}); t += 60
        out = self._match(net, pts)
        for s in out["segments"]:
            assert s["queue_length"] == 0


# ---- the fixture town (tests/test_osm_accuracy.py) ------------------------

@pytest.fixture(scope="module")
def osm_city():
    return network_from_osm_xml(io.BytesIO(build_city_xml().encode()))


def test_fixture_is_deterministic():
    assert build_city_xml() == build_city_xml()


def test_fixture_imports_realistically(osm_city):
    net = osm_city
    assert net.num_edges > 500
    assert net.edge_internal.sum() > 0          # motorway_link ramps
    assert (net.edge_segment_id < 0).sum() > 0  # service alleys
    lens = np.array(list(net.segment_length_m.values()))
    # junction-split OSMLR: block-scale segments, none beyond the cap +
    # one trailing block
    assert 100.0 < lens.mean() < 500.0
    assert lens.max() < 1400.0


def test_accuracy_gates_on_osm_city(osm_city):
    net = osm_city
    # turn penalty 500 mirrors the reference's own accuracy harness
    # (reference: py/generate_test_trace.py:172)
    matcher = SegmentMatcher(net, MatchParams(turn_penalty_factor=500.0),
                             device="cpu")
    rng = np.random.default_rng(0)
    traces = []
    while len(traces) < 24:
        tr = generate_trace(net, f"acc-{len(traces)}", rng, noise_m=4.0,
                            min_route_edges=8)
        if tr is not None:
            traces.append(tr)
    result = score(net, matcher, traces)
    assert result["agreement"] >= 0.99, result
    assert result["point_agreement"] >= 0.975, result
    assert result["segments_emitted"] > 50, result


# ---- both packages on the same input ---------------------------------------

def _columns_equal(a, b):
    for name in COLUMNS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert list(a.segment_length_m.items()) \
        == list(b.segment_length_m.items())


def test_fixture_bytes_equal_the_jax_fixture(tmp_path, capsys):
    """``build_city_xml`` and ``main --out`` give the JAX package's bytes
    and line."""
    from reporter_tpu.tools import osm_fixture as jax_fixture
    from reporter_tpu_torch.tools import osm_fixture
    assert build_city_xml() == jax_fixture.build_city_xml()
    lines = []
    for mod, name in ((jax_fixture, "jax"), (osm_fixture, "port")):
        out = tmp_path / f"{name}.osm.xml"
        assert mod.main(["--out", str(out)]) == 0
        lines.append(capsys.readouterr().out.replace(str(out), "OUT"))
    assert lines[0] == lines[1]
    assert (tmp_path / "jax.osm.xml").read_bytes() \
        == (tmp_path / "port.osm.xml").read_bytes()


@pytest.mark.parametrize("source", ["extract", "town", "town-path"])
def test_imported_columns_and_versions_equal_the_jax_importer(tmp_path,
                                                              source):
    """The same XML (the small extract, the fixture town, and the town
    read from a path) through both importers: every column equal in dtype
    and value, the segment lengths in the same insertion order, and the
    same ``map_version`` tokens, bare and with ``.profile`` bytes."""
    from reporter_tpu.graph.osm import network_from_osm_xml as jax_osm
    from reporter_tpu.graph.version import map_version as jax_version
    from reporter_tpu_torch.graph.version import map_version
    xml = (OSM_XML if source == "extract" else build_city_xml()).encode()
    if source == "town-path":
        path = tmp_path / "town.osm.xml"
        path.write_bytes(xml)
        ref, net = jax_osm(str(path)), network_from_osm_xml(str(path))
    else:
        ref = jax_osm(io.BytesIO(xml))
        net = network_from_osm_xml(io.BytesIO(xml))
    _columns_equal(net, ref)
    assert map_version(net) == jax_version(ref)
    extra = b'{"version": 1, "pairs": [[0, 1]]}'
    assert map_version(net, extra=extra) == jax_version(ref, extra=extra)
    assert map_version(net, extra=extra) != map_version(net)
    assert map_version(net) == jax_version(ref)  # extra is not cached


def test_queue_reports_equal_the_jax_service():
    """The queue-length traces of ``TestQueueLength`` (and the primary
    street's walk) through both packages' services on the imported
    extract: the same statuses and byte-equal ``/report`` bodies."""
    from reporter_tpu.graph.osm import network_from_osm_xml as jax_osm
    from reporter_tpu.matcher import MatchParams as JaxParams
    from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
    from reporter_tpu.service.server import ReporterService as JaxService
    from reporter_tpu_torch.service.server import ReporterService
    xml = OSM_XML.encode()
    ref = JaxService(JaxMatcher(net=jax_osm(io.BytesIO(xml)),
                                params=JaxParams(max_candidates=4)))
    svc = ReporterService(SegmentMatcher(
        network_from_osm_xml(io.BytesIO(xml)), MatchParams(max_candidates=4),
        device="cpu"))
    opts = {"mode": "auto", "report_levels": [0, 1, 2],
            "transition_levels": [0, 1, 2]}
    try:
        for i, pts in enumerate(_queue_traces()):
            req = {"uuid": f"q{i}", "trace": pts, "match_options": opts}
            code, body = svc.handle(dict(req))
            want_code, want = ref.handle(dict(req))
            assert code == want_code == 200
            assert bytes(body) == (want.encode() if isinstance(want, str)
                                   else bytes(want))
    finally:
        ref.dispatcher.close()
        svc.dispatcher.close()


def _queue_traces():
    """The point lists of the queue-length cases, in their order."""
    rng = np.random.default_rng(0)
    walk = [{"lat": float(la + rng.normal(0, 3e-5)),
             "lon": float(121.0 + rng.normal(0, 3e-5)),
             "time": 1500000000 + i * 7}
            for i, la in enumerate(np.linspace(14.5800, 14.5820, 12))]
    stalled, t = [], 1500000000
    for la in np.linspace(14.5800, 14.58145, 8):
        stalled.append({"lat": float(la), "lon": 121.0, "time": t})
        t += 3
    for i in range(4):
        stalled.append({"lat": 14.58146 + i * 1.5e-5, "lon": 121.0,
                        "time": t})
        t += 7
    free = [{"lat": float(la), "lon": 121.0, "time": 1500000000 + i * 3}
            for i, la in enumerate(np.linspace(14.5800, 14.5818, 10))]
    off, t = list(stalled[:8]), stalled[7]["time"] + 3
    for i in range(4):
        off.append({"lat": 14.60, "lon": 121.05, "time": t})
        t += 60
    return [walk, stalled, free, off]
