"""The port's tools and umbrella CLI (``reporter_tpu_torch.tools``,
``python -m reporter_tpu_torch``) against the JAX package's: the replay
producer, the print-consumer's rendering, the tiles CLI and
``tiles_for_bbox``, the synthetic-trace generator and the accuracy gate
(their output byte-equal to the JAX tools' for the same seed), and the
umbrella's help, unknown commands and dispatch."""
import http.server
import json
import os
import tarfile
import threading

import numpy as np
import pytest

from reporter_tpu.core.tiles import tiles_for_bbox as jax_tiles_for_bbox
from reporter_tpu.tools import accuracy_cli as jax_accuracy
from reporter_tpu.tools import synth_cli as jax_synth
from reporter_tpu_torch.__main__ import COMMANDS, main as umbrella
from reporter_tpu_torch.core.tiles import tiles_for_bbox
from reporter_tpu_torch.core.types import Point, Segment
from reporter_tpu_torch.tools.print_consumer import render
from reporter_tpu_torch.tools.replay import bbox_send_if, replay
from reporter_tpu_torch.tools.tiles_cli import download_tiles, list_tiles


# -- the JAX package's cases -------------------------------------------------

class TestReplay:
    def test_lambdas_applied(self):
        lines = ["a|1", "b|2", "skip|3"]
        sent = []
        n_sent, n_total = replay(
            lines, lambda k, v: sent.append((k, v)),
            key_with=lambda l: l.split("|")[0],
            value_with=lambda l: l.upper(),
            send_if=lambda l: not l.startswith("skip"))
        assert n_sent == 2 and n_total == 3
        assert sent == [("a", "A|1"), ("b", "B|2")]

    def test_bad_line_skipped_not_fatal(self):
        # reference: cat_to_kafka.py:62-65 — per-line failure logged, loop
        # continues
        lines = ["good", "bad", "good"]

        def key_with(l):
            if l == "bad":
                raise ValueError("boom")
            return l

        sent = []
        n_sent, n_total = replay(lines, lambda k, v: sent.append(k),
                                 key_with=key_with)
        assert n_sent == 2 and n_total == 3

    def test_bbox_filter(self):
        # reference: make_requests.sh:38-44
        send_if = bbox_send_if([120.0, 14.0, 122.0, 16.0], "|", 1, 2)
        assert send_if("uuid|15.0|121.0|0|10")
        assert not send_if("uuid|17.0|121.0|0|10")
        assert not send_if("uuid|not_a_number|121.0|0|10")

    def test_cli_stdout_sink(self, capsys, tmp_path):
        from reporter_tpu_torch.tools.replay import main
        src = tmp_path / "in.sv"
        src.write_text("u1|15.0|121.0|0|10\nu2|99.0|121.0|0|10\n")
        assert main([str(src), "--bbox", "120,14,122,16",
                     "--lat-index", "1", "--lon-index", "2"]) == 0
        out = capsys.readouterr().out
        assert "u1|15.0" in out and "u2|99.0" not in out


class TestPrintConsumer:
    def test_renders_point(self):
        p = Point(lat=14.6, lon=121.0, accuracy=10, time=1500000000)
        assert "14.6" in render("formatted", "veh-1", p.to_bytes())

    def test_renders_segment_list(self):
        segs = [Segment(1, 2, 10.0, 20.0, 100, 0),
                Segment(3, None, 20.0, 30.0, 50, 5)]
        raw = b"".join(s.to_bytes() for s in segs)
        text = render("segments", "1 2", raw)
        assert "Segment" in text and "100" in text

    def test_renders_utf8_and_binary(self):
        assert render("raw", None, b"hello") == "None=hello"
        assert render("raw", None, b"\xff\xfe") == "None=fffe"


class TestTilesCli:
    def test_list_matches_library(self):
        bbox = [120.9, 14.5, 121.1, 14.7]
        assert list_tiles(bbox) == list(tiles_for_bbox(bbox))

    def test_download_and_tar(self, tmp_path):
        # serve fake tiles from a local dir over HTTP; one path 404s
        bbox = [120.99, 14.59, 121.01, 14.61]
        paths = list_tiles(bbox)
        assert len(paths) >= 3  # one per level
        src = tmp_path / "src"
        for p in paths[:-1]:
            f = src / p
            f.parent.mkdir(parents=True, exist_ok=True)
            f.write_bytes(b"tile:" + p.encode())

        handler = lambda *a, **kw: http.server.SimpleHTTPRequestHandler(
            *a, directory=str(src), **kw)
        httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            url = f"http://127.0.0.1:{httpd.server_port}"
            out = tmp_path / "out"
            missing = download_tiles(bbox, url, str(out), processes=3,
                                     tar_output=True)
            assert missing == [paths[-1]]
            for p in paths[:-1]:
                assert (out / p).read_bytes() == b"tile:" + p.encode()
            tars = [f for f in os.listdir(out) if f.endswith(".tar")]
            assert len(tars) == 1
            with tarfile.open(out / tars[0]) as tar:
                assert sorted(tar.getnames()) == sorted(paths[:-1])
        finally:
            httpd.shutdown()


class TestUmbrella:
    def test_unknown_command(self, capsys):
        assert umbrella(["nope"]) == 2
        assert "unknown command" in capsys.readouterr().err

    def test_help(self, capsys):
        assert umbrella(["--help"]) == 0
        assert "stream" in capsys.readouterr().out

    def test_dispatch_tiles(self, capsys):
        assert umbrella(["tiles", "list", "--bbox", "120.9,14.5,121.1,14.7"]) == 0
        assert "2/" in capsys.readouterr().out


class TestSynthCli:
    def test_sv_and_json_output(self, capsys):
        from reporter_tpu_torch.tools.synth_cli import main
        assert main(["--traces", "2", "--rows", "6", "--cols", "6",
                     "--format", "sv"]) == 0
        sv = capsys.readouterr().out.strip().splitlines()
        assert len(sv) >= 4
        assert all(len(line.split("|")) == 5 for line in sv)
        uuids = {line.split("|")[0] for line in sv}
        assert uuids == {"synth-0", "synth-1"}

        assert main(["--traces", "1", "--rows", "6", "--cols", "6",
                     "--format", "json"]) == 0
        body = json.loads(capsys.readouterr().out)
        assert body["uuid"] == "synth-0"
        assert len(body["trace"]) >= 2
        assert body["match_options"]["report_levels"] == [0, 1]


class TestAccuracyCli:
    def test_gate_passes_on_clean_city(self, capsys):
        from reporter_tpu_torch.tools.accuracy_cli import main
        assert main(["--traces", "8", "--rows", "10", "--cols", "10",
                     "--noise-m", "3.0", "--min-agreement", "0.99",
                     "--device", "cpu"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["traces"] == 8
        assert out["agreement"] >= 0.99
        assert out["segment_precision"] >= 0.99
        assert 0.9 <= out["point_agreement"] <= 1.0

    def test_gate_fails_below_threshold(self, capsys):
        from reporter_tpu_torch.tools.accuracy_cli import main
        # an impossible bar guarantees the failure path
        assert main(["--traces", "4", "--rows", "8", "--cols", "8",
                     "--noise-m", "12.0", "--min-agreement", "1.01",
                     "--device", "cpu"]) == 1


# -- against the JAX package's tools -----------------------------------------

@pytest.mark.parametrize("argv", [
    ["--traces", "3", "--rows", "6", "--cols", "6", "--format", "sv"],
    ["--traces", "2", "--rows", "7", "--cols", "5", "--format", "json",
     "--seed", "5", "--noise-m", "8.0"],
    ["--traces", "2", "--rows", "6", "--cols", "6", "--format", "json",
     "--mode", "bicycle", "--seed", "3"]])
def test_synth_prints_the_jax_tools_bytes(capsys, argv):
    from reporter_tpu_torch.tools.synth_cli import main
    assert jax_synth.main(argv) == 0
    want = capsys.readouterr().out
    assert main(argv) == 0
    assert capsys.readouterr().out == want and want


@pytest.mark.parametrize("argv", [
    ["--traces", "64"],
    ["--traces", "16", "--rows", "10", "--cols", "12", "--noise-m", "8.0",
     "--seed", "3", "--turn-penalty-factor", "0"]])
def test_accuracy_prints_the_jax_tools_json(capsys, argv):
    from reporter_tpu_torch.tools.accuracy_cli import main
    assert jax_accuracy.main(argv) == 0
    want = capsys.readouterr().out
    assert main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert json.loads(got) == json.loads(want) and got == want


@pytest.mark.parametrize("argv", [
    ["--osm-fixture", "--traces", "16"],
    ["--osm-fixture", "--traces", "64", "--min-agreement", "0.99",
     "--min-point-agreement", "0.975"]])
def test_accuracy_osm_fixture_prints_the_jax_tools_json(capsys, argv):
    """``--osm-fixture`` (the fixture town through each package's OSM
    importer): the JAX tool's JSON line, at ci.yml's gates too."""
    from reporter_tpu_torch.tools.accuracy_cli import main
    assert jax_accuracy.main(argv) == 0
    want = capsys.readouterr().out
    assert main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and json.loads(got)["traces"] == int(argv[2])


def test_accuracy_osm_file_equals_the_fixture(capsys, tmp_path):
    """``--osm FILE`` of the fixture's bytes answers as ``--osm-fixture``,
    and as the JAX tool given the same file."""
    from reporter_tpu_torch.tools import osm_fixture
    from reporter_tpu_torch.tools.accuracy_cli import main
    path = tmp_path / "town.osm.xml"
    path.write_text(osm_fixture.build_city_xml())
    outs = []
    for fn, argv in ((jax_accuracy.main, ["--osm", str(path)]),
                     (main, ["--osm", str(path), "--device", "cpu"]),
                     (main, ["--osm-fixture", "--device", "cpu"])):
        assert fn(argv + ["--traces", "8"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == outs[2]


def _graph_run(main, argv, capsys, root):
    """(exit code, stdout lines with ``root`` masked) of one graph CLI
    call."""
    rc = main(argv)
    return rc, capsys.readouterr().out.replace(str(root), "ROOT")


def _npz_arrays(path):
    with np.load(path) as data:
        return {k: (data[k].dtype, data[k].tolist()) for k in data.files}


def _files(root):
    out = {}
    for r, _d, fs in os.walk(root):
        for f in fs:
            full = os.path.join(r, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, root)] = fh.read()
    return out


def test_graph_cli_equals_the_jax_cli(capsys, tmp_path):
    """Each ``graph`` subcommand through the JAX CLI and the port's (the
    umbrella's ``graph``): the same lines, the same ``.npz`` arrays
    (the archives' timestamps aside) and the same tile trees byte for
    byte."""
    from reporter_tpu.tools import graph_cli as jax_graph
    from reporter_tpu_torch.tools import osm_fixture
    xml = tmp_path / "town.osm.xml"
    xml.write_text(osm_fixture.build_city_xml())
    runs = {}
    for name, main in (("jax", jax_graph.main),
                       ("port", lambda a: umbrella(["graph", *a]))):
        root = tmp_path / name
        root.mkdir()
        lines = []
        for argv in (
                ["build-synth", "--rows", "7", "--cols", "6", "--seed", "3",
                 "--out", f"{root}/synth.npz"],
                ["import-osm", "--in", str(xml), "--out",
                 f"{root}/town.npz"],
                ["tile", "--graph", f"{root}/town.npz", "--out-dir",
                 f"{root}/tiles"],
                ["untile", "--tile-dir", f"{root}/tiles", "--out",
                 f"{root}/back.npz"],
                ["untile", "--tile-dir", f"{root}/tiles",
                 "--bbox=-122.33,47.60,-122.32,47.61", "--out",
                 f"{root}/box.npz"],
                ["info", f"{root}/tiles"], ["info", f"{root}/synth.npz"]):
            lines.append(_graph_run(main, argv, capsys, root))
        runs[name] = (lines, {f: _npz_arrays(root / f) for f in
                              ("synth.npz", "town.npz", "back.npz",
                               "box.npz")},
                      _files(root / "tiles"))
    assert runs["port"][0] == runs["jax"][0]
    assert all(rc == 0 for rc, _out in runs["port"][0])
    assert runs["port"][1] == runs["jax"][1]
    assert runs["port"][2] == runs["jax"][2] and runs["port"][2]


def test_accuracy_scores_as_the_jax_tool_on_the_same_matches():
    """``score`` over the same matches and traces: the port's own copy of
    the scoring."""
    from reporter_tpu_torch.matcher import SegmentMatcher
    from reporter_tpu_torch.synth import build_grid_city, generate_trace
    from reporter_tpu_torch.tools.accuracy_cli import score
    net = build_grid_city(rows=8, cols=8, seed=2, service_road_fraction=0.0,
                          internal_fraction=0.0)
    rng = np.random.default_rng(2)
    traces = [t for t in (generate_trace(net, f"a-{i}", rng, noise_m=6.0,
                                         min_route_edges=8)
                          for i in range(60)) if t is not None]
    matcher = SegmentMatcher(net, device="cpu")
    got = score(net, matcher, traces)
    assert got == jax_accuracy.score(net, matcher, traces)
    assert got["traces"] == len(traces) > 10


@pytest.mark.parametrize("seed", range(3))
def test_truth_complete_segments_equal_the_jax_packages(seed):
    from reporter_tpu.synth import build_grid_city as jax_grid
    from reporter_tpu.synth import generate_trace as jax_trace
    from reporter_tpu_torch.synth import build_grid_city, generate_trace
    kw = dict(rows=9, cols=11, seed=seed, edges_per_segment=seed + 1)
    net, jax_net = build_grid_city(**kw), jax_grid(**kw)
    rng, jax_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    n = 0
    for i in range(30):
        tr = generate_trace(net, f"t-{i}", rng, min_route_edges=4)
        want = jax_trace(jax_net, f"t-{i}", jax_rng, min_route_edges=4)
        assert (tr is None) == (want is None)
        if tr is not None:
            assert tr.points == want.points
            assert tr.truth_complete_segments(net) == \
                want.truth_complete_segments(jax_net)
            n += bool(tr.truth_complete_segments(net))
    assert n >= 5


def test_accuracy_without_a_card_fails_closed(capsys):
    import torch
    from reporter_tpu_torch.tools.accuracy_cli import main
    if not torch.cuda.is_available():
        assert main(["--traces", "2", "--rows", "6", "--cols", "6"]) == 1
        assert "CUDA" in capsys.readouterr().err
    assert main(["--traces", "2", "--rows", "6", "--cols", "6", "--device",
                 "cpu"]) == 0


def random_bboxes(seed, n=40):
    """Seeded lon/lat boxes: small and large ones anywhere, and boxes
    across the antimeridian (min_lon > max_lon, or past ±180)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        lat0 = float(rng.uniform(-89.0, 88.0))
        lat1 = min(90.0, lat0 + float(rng.uniform(0.01, 6.0)))
        lon0 = float(rng.uniform(-180.0, 179.0))
        w = float(rng.uniform(0.01, 9.0))
        kind = i % 4
        if kind == 0:
            box = [lon0, lat0, min(180.0, lon0 + w), lat1]
        elif kind == 1:   # wraps: written min_lon > max_lon
            box = [float(rng.uniform(170.0, 180.0)), lat0,
                   float(rng.uniform(-180.0, -170.0)), lat1]
        elif kind == 2:   # past +180
            box = [float(rng.uniform(175.0, 179.9)), lat0,
                   float(rng.uniform(180.1, 185.0)), lat1]
        else:             # past -180
            box = [float(rng.uniform(-185.0, -180.1)), lat0,
                   float(rng.uniform(-179.9, -175.0)), lat1]
        out.append(box)
    return out


@pytest.mark.parametrize("levels", [(0, 1, 2), (2,), (0,)])
@pytest.mark.parametrize("seed", range(4))
def test_tiles_for_bbox_equals_the_jax_packages(seed, levels):
    for box in random_bboxes(seed):
        want = list(jax_tiles_for_bbox(box, "gph", levels))
        assert list(tiles_for_bbox(box, "gph", levels)) == want and want


def test_tiles_for_bbox_refuses_as_the_jax_package_does():
    for box in ([0.0, -91.0, 1.0, 1.0], [0.0, 0.0, 1.0, 91.0]):
        with pytest.raises(ValueError) as jax_err:
            list(jax_tiles_for_bbox(box))
        with pytest.raises(ValueError) as err:
            list(tiles_for_bbox(box))
        assert str(err.value) == str(jax_err.value)


def test_kafka_tools_need_the_client(tmp_path, monkeypatch):
    """``replay --bootstrap`` and ``print-consumer`` reach ``KafkaBroker``,
    which refuses without the client library (its import guard)."""
    from reporter_tpu_torch.streaming import broker
    monkeypatch.setattr(broker, "kafka_available", lambda: False)
    src = tmp_path / "in.sv"
    src.write_text("u1|15.0|121.0|0|10\n")
    with pytest.raises(RuntimeError, match="kafka"):
        umbrella(["replay", str(src), "--bootstrap", "localhost:9092"])
    with pytest.raises(RuntimeError, match="kafka"):
        umbrella(["print-consumer", "--bootstrap", "localhost:9092",
                  "--topic", "raw"])


# -- the umbrella ------------------------------------------------------------

def test_help_lists_the_commands_and_those_to_come(capsys):
    """Every command is listed; none is left to come."""
    assert umbrella([]) == 2
    text = capsys.readouterr().out
    for name in COMMANDS:
        assert f"\n  {name} " in text
    assert "Still to come" not in text and "\n  graph " in text


@pytest.mark.parametrize("name", ["graph"])
def test_commands_still_to_come_are_unknown(capsys, name):
    """``graph`` was the last command still to come: it is dispatched now,
    so the port's umbrella knows every command of the JAX package's and
    an unknown name is still refused."""
    from reporter_tpu.__main__ import COMMANDS as JAX_COMMANDS
    assert name in COMMANDS and set(COMMANDS) == set(JAX_COMMANDS)
    assert umbrella([f"{name}-x", "--help"]) == 2
    assert "unknown command" in capsys.readouterr().err


@pytest.mark.parametrize("name,prog", [
    ("serve", "reporter_tpu_torch.service.server"),
    ("stream", "reporter_tpu_torch.streaming.worker"),
    ("pipeline", "reporter_tpu_torch pipeline"),
    ("replay", "reporter-replay"),
    ("print-consumer", "reporter-print-consumer"),
    ("tiles", "reporter-tiles"),
    ("synth", "reporter-synth"),
    ("accuracy", "reporter_tpu_torch accuracy"),
    ("datastore", "reporter-datastore"),
    ("graph", "reporter-graph")])
def test_umbrella_dispatches_each_ported_command(capsys, name, prog):
    assert set(COMMANDS) == {"serve", "stream", "pipeline", "replay",
                             "print-consumer", "tiles", "synth", "accuracy",
                             "datastore", "graph"}
    with pytest.raises(SystemExit) as e:
        umbrella([name, "--help"])
    assert e.value.code == 0
    assert prog in capsys.readouterr().out
