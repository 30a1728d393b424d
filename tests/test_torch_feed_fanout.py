"""The port's change-feed fan-out proof
(``reporter_tpu_torch/tools/feed_fanout.py``) against the JAX repo's
``tools/feed_fanout_bench.py`` at the same CI scale, on the CPU.

Both harnesses run 64 world-bbox subscribers against a two-worker
pre-fork fleet whose workers each hold at most 16 feed waiters, so the
shed path fires; both close the accounting (delivered + shed = 64, no
error, nothing silent) with shed events. Every event the port's fleet
delivered equals, once its cursor (``seq``) and wall-clock ``arrival``
are dropped, the event the JAX package's feed publishes for the same
commit seen by a store watcher.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

from reporter_tpu_torch.tools import feed_fanout

REPO = Path(__file__).resolve().parents[1]
CI = ["--feed-fanout", "64", "--procs", "2", "--waiters", "16", "--ramp",
      "2", "--deadline", "30"]
#: event fields that carry a cursor or a clock
CLOCKED = ("seq", "arrival")


def _closed(art, n=64):
    assert art["silent_lost"] == 0 and art["errors"] == 0, art
    assert art["delivered"] + art["shed"] == n, art
    assert art["shed_events"] > 0, art
    assert art["subscribers"] == n and art["procs"] == 2


def _jax_flush(n, start):
    """``feed_fanout._flush`` in the JAX package's types."""
    from reporter_tpu.core.osmlr import make_segment_id
    from reporter_tpu.core.types import Segment
    sid = make_segment_id(2, 756425, 10)
    nid = make_segment_id(2, 756425, 11)
    return [Segment(sid, nid, start + i * 30, start + i * 30 + 10.0, 100,
                    0) for i in range(n)]


def _unclocked(events):
    return [{k: v for k, v in ev.items() if k not in CLOCKED}
            for ev in events]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("fanout")
    out, events = d / "port.json", d / "events.jsonl"
    rc = feed_fanout.main(["--device", "cpu", *CI, "--out", str(out),
                           "--events", str(events), "--min-fanout",
                           "0.95"])
    art = json.loads(out.read_text())
    delivered = [json.loads(ln) for ln in
                 events.read_text().splitlines()]
    return rc, art, delivered


def test_the_port_closes_its_accounting(port_run):
    rc, art, delivered = port_run
    assert rc == 0
    _closed(art)
    assert art["kind"] == "feed_fanout" and art["device"] == "cpu"
    assert art["waiter_cap"] == 16 and art["pool"] == 700
    assert art["fanout_ratio"] == round(art["delivered"] / 64, 4)
    assert len(delivered) == art["delivered"]
    assert art["delivery_p50_ms"] <= art["delivery_p99_ms"]


def test_the_jax_harness_closes_its_accounting_with_the_same_keys(
        port_run, tmp_path):
    out = tmp_path / "jax.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "tools/feed_fanout_bench.py", *CI, "--out",
         str(out)], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = json.loads(out.read_text())
    _closed(ref)
    _rc, art, _ = port_run
    assert set(ref) <= set(art)
    assert set(art) - set(ref) == {"device"}


def test_delivered_events_equal_the_jax_packages(port_run, monkeypatch):
    """The JAX package's feed in this process, over the harness's store
    and commits: a service primed on the seed, a writer that commits the
    harness's live flush, one poll from cursor 0."""
    from reporter_tpu.datastore import LocalDatastore as JaxStore
    from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
    from reporter_tpu.service.server import ReporterService as JaxService
    from reporter_tpu.synth import build_grid_city as jax_city
    monkeypatch.setenv("REPORTER_TPU_FRESHNESS_POLL_S", "0.1")
    _rc, _art, delivered = port_run
    assert delivered
    with tempfile.TemporaryDirectory() as root:
        store = os.path.join(root, "store")
        writer = JaxStore(store)
        writer.ingest_segments(_jax_flush(5, feed_fanout.T0H),
                               ingest_key="fanout-seed")
        city = jax_city(rows=4, cols=4, spacing_m=200.0, seed=5,
                        service_road_fraction=0.0, internal_fraction=0.0)
        svc = JaxService(JaxMatcher(net=city), datastore=JaxStore(store))
        try:
            code, _body = svc.feed({"cursor": "-1", "timeout": "0.5"})
            assert code == 200
            writer.ingest_segments(_jax_flush(3, feed_fanout.T0H + 3600),
                                   ingest_key="fanout-live")
            code, body = svc.feed({"cursor": "0", "timeout": "10",
                                   "bbox": [-180.0, -90.0, 180.0, 90.0],
                                   "level": "2"})
        finally:
            svc.dispatcher.close()
    assert code == 200
    want = _unclocked(json.loads(body)["events"])
    assert want and want[0]["kind"] == "tile"
    for events in delivered:
        assert _unclocked(events) == want
