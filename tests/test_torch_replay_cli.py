"""The port's dead-letter replay CLI (``reporter_tpu_torch/tools/
replay_cli.py``) against the JAX repo's ``tools/replay_cli.py``.

One spool, copied twice: three /report-ready trace bodies and a poison
body under ``.traces``, and a tile whose datastore tee failed. The JAX
CLI drains its copy through the JAX service, the port's through the
port's (``device="cpu"``), each over HTTP into a real anonymiser, a tile
sink and a datastore, with one attempt an entry. The recovered tiles are
byte-equal, the stores equal (``meta.json``'s wall-clock ``created``
masked), and the same file lands in ``.quarantine``.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.service.server import ReporterService as JaxService
from reporter_tpu.service.server import serve as jax_serve
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu_torch.matcher import SegmentMatcher
from reporter_tpu_torch.service.server import ReporterService, serve
from reporter_tpu_torch.synth import build_grid_city, generate_trace
from reporter_tpu_torch.tools import replay_cli
from reporter_tpu_torch.utils import metrics

REPO = Path(__file__).resolve().parents[1]
CITY = dict(rows=8, cols=8, spacing_m=200.0, seed=5,
            service_road_fraction=0.0, internal_fraction=0.0)
SOURCE = "replay-test"


def _tree(root, mask_created=False):
    """{relpath: bytes} under ``root`` (dot entries left out);
    ``meta.json``'s ``created`` masked when asked."""
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith("."))
        for name in sorted(files):
            if name.startswith("."):
                continue
            path = os.path.join(dirpath, name)
            raw = Path(path).read_bytes()
            if mask_created and name == "meta.json":
                meta = json.loads(raw)
                meta.pop("created")
                raw = json.dumps(meta, sort_keys=True).encode()
            out[os.path.relpath(path, root)] = raw
    return out


@pytest.fixture(scope="module")
def spool(tmp_path_factory):
    """The spool both CLIs drain (copied per run)."""
    from reporter_tpu_torch.core import types
    from reporter_tpu_torch.datastore import LocalDatastore
    from reporter_tpu_torch.streaming.anonymiser import Anonymiser, TileSink
    from reporter_tpu_torch.utils import faults
    root = tmp_path_factory.mktemp("spool")
    dl = root / "dl"
    traces = dl / ".traces"
    traces.mkdir(parents=True)
    city = build_grid_city(**CITY)
    rng = np.random.default_rng(3)
    for i in range(3):
        tr = None
        while tr is None:
            tr = generate_trace(city, f"v{i}", rng, noise_m=3.0,
                                min_route_edges=8)
        req = tr.request_json(report_levels=(0, 1, 2),
                              transition_levels=(0, 1, 2))
        (traces / f"batch.v{i}.json").write_text(json.dumps(req))
    (traces / "batch.poison.json").write_text(json.dumps(
        {"uuid": "poison", "trace": [{"lat": 0.0}]}))
    # a tile whose tee failed: spooled with its ingest key
    ds = LocalDatastore(str(root / "tee_store"))
    sink = TileSink(str(root / "tee_out"), deadletter=str(dl))
    anon = Anonymiser(sink, privacy=1, quantisation=3600, source="t",
                      tee=lambda _t, segs, ingest_key=None:
                      ds.ingest_segments(segs, ingest_key=ingest_key))
    t0 = 1483344000.0
    for i in range(12):
        anon.process("k", types.Segment(123456 + 8 * (i % 3), None,
                                        t0 + 40.0 * i, t0 + 40.0 * i + 9.5,
                                        120, 0))
    faults.configure("datastore.commit=error#1")
    try:
        anon.punctuate()
    finally:
        faults.clear()
    assert len(_tree(str(dl))) == 1  # the tile; .traces is a dot dir
    return dl


@pytest.fixture(scope="module")
def urls():
    ref = JaxService(JaxMatcher(net=jax_city(**CITY)), threshold_sec=15,
                     max_batch=8)
    port = ReporterService(SegmentMatcher(build_grid_city(**CITY),
                                          device="cpu"),
                           threshold_sec=15, max_batch=8)
    servers = [(jax_serve(ref, "127.0.0.1", 0), ref),
               (serve(port, "127.0.0.1", 0), port)]
    yield [f"http://127.0.0.1:{h.server_address[1]}/report"
           for h, _s in servers]
    for h, svc in servers:
        h.shutdown()
        h.server_close()
        svc.dispatcher.close()


def _args(work, url):
    return ["--spool", str(work / "dl"), "--url", url, "--privacy", "1",
            "--quantisation", "3600", "--sink", str(work / "out"),
            "--datastore", str(work / "store"), "--attempts", "1",
            "--source", SOURCE]


@pytest.fixture(scope="module")
def drained(spool, urls, tmp_path_factory):
    """(JAX work dir, port work dir, port exit code, port stdout)."""
    works = []
    for name in ("jax", "port"):
        work = tmp_path_factory.mktemp(f"drain_{name}")
        shutil.copytree(spool, work / "dl")
        works.append(work)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "tools/replay_cli.py", *_args(works[0], urls[0])],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    metrics.default.reset()
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = replay_cli.main(_args(works[1], urls[1]))
    return works[0], works[1], rc, json.loads(buf.getvalue()), \
        json.loads(proc.stdout)


def test_the_port_drains_and_reports_as_the_jax_cli(drained):
    _jw, _pw, rc, got, want = drained
    assert rc == 0
    assert got == want
    assert got["after"] == {"tiles": 0, "traces": 0}
    assert got["before"] == {"tiles": 1, "traces": 4}
    assert got["traces"] == {"ok": 3, "fail": 1}
    assert got["quarantined"] == 1 and got["recovered_tiles"] > 0


def test_recovered_tiles_are_byte_equal(drained):
    jw, pw, *_ = drained
    want = _tree(str(jw / "out"))
    assert want and any(SOURCE in k for k in want)
    assert _tree(str(pw / "out")) == want


def test_stores_are_equal(drained):
    jw, pw, *_ = drained
    want = _tree(str(jw / "store"), mask_created=True)
    assert want
    assert _tree(str(pw / "store"), mask_created=True) == want


def test_the_same_files_are_quarantined(drained):
    jw, pw, *_ = drained
    got = _tree(str(pw / "dl" / ".traces" / ".quarantine"))
    want = _tree(str(jw / "dl" / ".traces" / ".quarantine"))
    assert got == want and list(got) == ["batch.poison.json"]


def test_flags_are_the_jax_clis(tmp_path):
    """Usage errors: nothing to do, and --url without a pipeline."""
    for argv in (["--spool", str(tmp_path)],
                 ["--spool", str(tmp_path), "--url", "http://x/report"]):
        with pytest.raises(SystemExit) as e:
            replay_cli.main(argv)
        assert e.value.code == 2


def test_tiles_only_without_url(spool, tmp_path, capsys):
    work = tmp_path / "w"
    shutil.copytree(spool, work / "dl")
    rc = replay_cli.main(["--spool", str(work / "dl"), "--sink",
                          str(work / "out"), "--datastore",
                          str(work / "store")])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["after"]["tiles"] == 0
    assert out["after"]["traces"] == 4  # no --url: traces stay spooled
