"""The port's RGT graph tile store (``reporter_tpu_torch.graph.tilestore``)
and its native parser (``native.parse_tile``) against the JAX package's.

The first part ports the JAX package's ``tests/test_tilestore.py`` onto
the port: the RGT1 format, the partition and merge round trip, bbox
loading, the parsers' parity and the ``graph`` CLI's round trip. The
second part holds both packages to each other on the same networks (a
grid and the OSM fixture town): the same tile tree, path for path and
byte for byte; the port's C++ parser, its numpy parser and the JAX
parser column for column; a malformed blob refused with the numpy
parser's message; and ``/report`` bodies on a merged graph equal to the
JAX package's. Tolerance: exact.
"""
import io
import os

import numpy as np
import pytest

from reporter_tpu.graph import tilestore as jax_tilestore
from reporter_tpu.graph.osm import network_from_osm_xml as jax_osm
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu.tools.osm_fixture import build_city_xml
from reporter_tpu_torch import native
from reporter_tpu_torch.core.osmlr import tile_level
from reporter_tpu_torch.graph.network import COLUMNS, RoadNetwork
from reporter_tpu_torch.graph.osm import network_from_osm_xml
from reporter_tpu_torch.graph.tilestore import (GraphTileStore,
                                                edge_tile_assignment,
                                                tile_from_bytes,
                                                tile_from_bytes_np,
                                                write_tiles)
from reporter_tpu_torch.synth import build_grid_city, generate_trace
from reporter_tpu_torch.utils import metrics

GRID = dict(rows=10, cols=10, spacing_m=400.0, seed=11)


@pytest.fixture(scope="module")
def city():
    return build_grid_city(**GRID)


@pytest.fixture(scope="module")
def networks():
    """{name: (the JAX package's network, the port's)}: the grid and the
    OSM fixture town through each package's importer."""
    xml = build_city_xml().encode()
    return {"grid": (jax_city(**GRID), build_grid_city(**GRID)),
            "town": (jax_osm(io.BytesIO(xml)),
                     network_from_osm_xml(io.BytesIO(xml)))}


def edge_key_set(net):
    """Geometry-keyed multiset of edges, invariant to node/edge reindexing."""
    keys = []
    for e in range(net.num_edges):
        a, b = int(net.edge_start[e]), int(net.edge_end[e])
        keys.append((
            round(float(net.node_lat[a]), 9), round(float(net.node_lon[a]), 9),
            round(float(net.node_lat[b]), 9), round(float(net.node_lon[b]), 9),
            round(float(net.edge_length_m[e]), 3),
            int(net.edge_segment_id[e]),
            round(float(net.edge_segment_offset_m[e]), 3),
            bool(net.edge_internal[e]),
        ))
    return sorted(keys)


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for r, _d, fs in os.walk(root):
        for f in fs:
            path = os.path.join(r, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _columns_equal(a, b):
    for name in COLUMNS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.segment_length_m == b.segment_length_m


# ---- the JAX package's cases, on the port ----------------------------------

class TestAssignment:
    def test_levels_follow_osmlr_ids(self, city):
        levels, tiles = edge_tile_assignment(city)
        assoc = city.edge_segment_id >= 0
        for e in np.flatnonzero(assoc)[:50]:
            assert levels[e] == tile_level(int(city.edge_segment_id[e]))
        assert (levels[~assoc] == 2).all()
        assert (tiles >= 0).all()


class TestRoundtrip:
    def test_write_then_load_all_preserves_graph(self, city, tmp_path):
        written = write_tiles(city, str(tmp_path))
        assert len(written) >= 2  # multiple levels at least
        for rel in written:
            assert os.path.exists(tmp_path / rel)
            assert rel.endswith(".rgt")
        store = GraphTileStore(str(tmp_path))
        assert store.tile_paths() == sorted(written)
        merged = store.load_all()
        assert merged.num_edges == city.num_edges
        assert edge_key_set(merged) == edge_key_set(city)
        assert merged.segment_length_m == city.segment_length_m

    def test_matcher_equivalent_on_merged_graph(self, city, tmp_path):
        """A trace matched on the recomposed graph gives the same segment
        sequence as on the original."""
        from reporter_tpu_torch.matcher import SegmentMatcher
        write_tiles(city, str(tmp_path))
        merged = GraphTileStore(str(tmp_path)).load_all()
        rng = np.random.default_rng(5)
        tr = None
        while tr is None:
            tr = generate_trace(city, "veh", rng, noise_m=3.0)
        (m1,) = SegmentMatcher(city, device="cpu").match_many(
            [{"trace": tr.points}])
        (m2,) = SegmentMatcher(merged, device="cpu").match_many(
            [{"trace": tr.points}])
        segs1 = [s["segment_id"] for s in m1["segments"]]
        segs2 = [s["segment_id"] for s in m2["segments"]]
        assert segs1 == segs2 and len(segs1) > 0


class TestBboxLoad:
    def test_bbox_scoped_subset(self, city, tmp_path):
        write_tiles(city, str(tmp_path))
        store = GraphTileStore(str(tmp_path))
        lat_mid = float(np.median(city.node_lat))
        lon_mid = float(np.median(city.node_lon))
        sub = store.load_bbox([lon_mid - 0.002, lat_mid - 0.002,
                               lon_mid + 0.002, lat_mid + 0.002])
        assert 0 < sub.num_edges <= city.num_edges

    def test_bbox_missing_raises(self, city, tmp_path):
        write_tiles(city, str(tmp_path))
        store = GraphTileStore(str(tmp_path))
        with pytest.raises(FileNotFoundError):
            store.load_bbox([10.0, 10.0, 10.1, 10.1])


class TestParserParity:
    def test_numpy_and_cpp_parsers_agree(self, city, tmp_path):
        written = write_tiles(city, str(tmp_path))
        raw = open(tmp_path / written[0], "rb").read()
        via_np = tile_from_bytes_np(raw)
        via_cpp = native.parse_tile(raw)
        assert via_cpp is not None
        assert set(via_cpp) == set(via_np)
        for k in via_np:
            np.testing.assert_array_equal(via_cpp[k], via_np[k], err_msg=k)

    def test_malformed_rejected(self):
        with pytest.raises(ValueError, match="bad magic"):
            tile_from_bytes_np(b"JUNK" + b"\0" * 32)
        assert native.parse_tile(b"JUNK" + b"\0" * 32) is None

    def test_truncation_rejected(self, city, tmp_path):
        written = write_tiles(city, str(tmp_path))
        raw = open(tmp_path / written[0], "rb").read()
        with pytest.raises(ValueError):
            tile_from_bytes_np(raw[:-4])
        assert native.parse_tile(raw[:-4]) is None


class TestGraphCli:
    def test_tile_untile_info(self, tmp_path, capsys):
        from reporter_tpu_torch.__main__ import main
        npz = str(tmp_path / "g.npz")
        assert main(["graph", "build-synth", "--rows", "6", "--cols", "6",
                     "--out", npz]) == 0
        tile_dir = str(tmp_path / "tiles")
        assert main(["graph", "tile", "--graph", npz,
                     "--out-dir", tile_dir]) == 0
        out2 = str(tmp_path / "g2.npz")
        assert main(["graph", "untile", "--tile-dir", tile_dir,
                     "--out", out2]) == 0
        assert main(["graph", "info", tile_dir]) == 0
        assert "nodes" in capsys.readouterr().out
        a, b = RoadNetwork.load(npz), RoadNetwork.load(out2)
        assert a.num_edges == b.num_edges
        assert edge_key_set(a) == edge_key_set(b)


# ---- both packages on the same networks ------------------------------------

@pytest.mark.parametrize("name", ["grid", "town"])
def test_write_tiles_gives_the_jax_tree(networks, tmp_path, name):
    """Both packages' ``write_tiles`` write the same paths with the same
    bytes, and return them in the same order."""
    ref, net = networks[name]
    want = jax_tilestore.write_tiles(ref, str(tmp_path / "jax"))
    got = write_tiles(net, str(tmp_path / "port"))
    assert got == want and len(got) >= 2
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


@pytest.mark.parametrize("name", ["grid", "town"])
def test_three_parsers_agree_column_for_column(networks, tmp_path, name):
    """Every tile of the tree through the port's C++ parser (counted),
    the port's numpy parser and the JAX package's parser: the same
    columns, dtypes and values; the merged networks equal, bbox-scoped
    too."""
    ref, net = networks[name]
    written = write_tiles(net, str(tmp_path))
    metrics.default.reset()
    for rel in written:
        raw = (tmp_path / rel).read_bytes()
        got = tile_from_bytes(raw)
        for other in (tile_from_bytes_np(raw),
                      jax_tilestore.tile_from_bytes_np(raw)):
            assert list(got) == list(other)
            for k in got:
                assert got[k].dtype == other[k].dtype, k
                np.testing.assert_array_equal(got[k], other[k], err_msg=k)
    assert metrics.default.counter("tilestore.parse.native") == len(written)
    _columns_equal(GraphTileStore(str(tmp_path)).load_all(),
                   jax_tilestore.GraphTileStore(str(tmp_path)).load_all())
    lat, lon = float(np.median(net.node_lat)), float(np.median(net.node_lon))
    box = [lon - 0.002, lat - 0.002, lon + 0.002, lat + 0.002]
    _columns_equal(GraphTileStore(str(tmp_path)).load_bbox(box),
                   jax_tilestore.GraphTileStore(str(tmp_path)).load_bbox(box))


@pytest.mark.parametrize("cut", ["magic", "version", "truncated",
                                 "trailing", "header"])
def test_a_rejected_blob_raises_the_numpy_message(city, tmp_path, cut):
    """A blob the C++ parser refuses raises from ``tile_from_bytes`` with
    the numpy parser's message (the JAX package's message for the same
    blob)."""
    written = write_tiles(city, str(tmp_path))
    raw = (tmp_path / written[0]).read_bytes()
    bad = {"magic": b"JUNK" + raw[4:],
           "version": raw[:4] + (2).to_bytes(4, "little") + raw[8:],
           "truncated": raw[:-4], "trailing": raw + b"\0\0",
           "header": raw[:20]}[cut]
    assert native.parse_tile(bad) is None
    with pytest.raises(Exception) as want:
        jax_tilestore.tile_from_bytes_np(bad)
    with pytest.raises(type(want.value)) as got:
        tile_from_bytes(bad)
    assert str(got.value) == str(want.value)


def test_report_bodies_on_a_merged_graph_equal_the_jax_service(networks,
                                                               tmp_path):
    """The town written as tiles and merged back by each package, then
    served: every ``/report`` body byte-equal to the JAX service's."""
    from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
    from reporter_tpu.service.server import ReporterService as JaxService
    from reporter_tpu_torch.matcher import SegmentMatcher
    from reporter_tpu_torch.service.server import ReporterService
    ref, net = networks["town"]
    write_tiles(net, str(tmp_path))
    merged = GraphTileStore(str(tmp_path)).load_all()
    ref_merged = jax_tilestore.GraphTileStore(str(tmp_path)).load_all()
    rng = np.random.default_rng(7)
    reqs = []
    while len(reqs) < 6:
        tr = generate_trace(merged, f"t{len(reqs)}", rng, noise_m=3.0,
                            min_route_edges=8)
        if tr is not None:
            reqs.append(tr.request_json())
    ref_svc = JaxService(JaxMatcher(net=ref_merged))
    svc = ReporterService(SegmentMatcher(merged, device="cpu"))
    try:
        for req in reqs:
            code, body = svc.handle(dict(req))
            want_code, want = ref_svc.handle(dict(req))
            assert code == want_code == 200
            assert bytes(body) == (want.encode() if isinstance(want, str)
                                   else bytes(want))
    finally:
        ref_svc.dispatcher.close()
        svc.dispatcher.close()
