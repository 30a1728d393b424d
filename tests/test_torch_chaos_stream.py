"""The port's chaos harness (``reporter_tpu_torch/tools/chaos.py``), its
streaming scenarios, on the CPU at the JAX harness's sizes.

``kill_restore`` and ``stream_resume`` kill a ``python -m
reporter_tpu_torch stream`` child (``os._exit(137)``) and restart it from
its snapshot; the port's fault-free tile tree and its recovered one must
both be byte-equal to the tree the JAX package's own worker
(``reporter_tpu.streaming.worker.main``) writes from the same seeded
lines. ``submit_burst``, ``egress_outage`` and ``replay_drain`` run the
worker in process; the egress outage's replayed store is held cell for
cell against the JAX package's ingest of the fault-free tiles. Each
child has its own timeout (``chaos.CHILD_TIMEOUT_S``). Tolerance:
exact.
"""
import sys

import pytest

from reporter_tpu.datastore import LocalDatastore as JaxDatastore
from reporter_tpu.datastore import ingest_dir as jax_ingest_dir
from reporter_tpu.streaming import worker as jax_worker
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu.synth import generate_trace as jax_trace
from reporter_tpu_torch.tools import chaos
from reporter_tpu_torch.utils import faults

CITY = dict(rows=10, cols=10, spacing_m=200.0, seed=5,
            service_road_fraction=0.0, internal_fraction=0.0)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.clear()
    yield
    faults.clear()


def jax_lines(n_traces, seed=9):
    """The JAX harness's seeded probe lines, from the JAX synth."""
    import numpy as np
    city = jax_city(**CITY)
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_traces):
        tr = None
        while tr is None:
            tr = jax_trace(city, f"veh-{i}", rng, noise_m=3.0,
                           min_route_edges=8)
        lines += ["|".join([tr.uuid, str(p["lat"]), str(p["lon"]),
                            str(p["time"]), str(p["accuracy"])])
                  for p in tr.points]
    return lines


def jax_tiles(tmp_path, lines, flush, monkeypatch, lag=None):
    """The tile tree the JAX package's worker writes from ``lines``, with
    the harness's flags (``--report-flush-interval flush``)."""
    if lag is not None:
        monkeypatch.setenv("REPORTER_TPU_INCREMENTAL_LAG", str(lag))
    graph = str(tmp_path / "jax_city.npz")
    jax_city(**CITY).save(graph)
    inp = tmp_path / "jax_in.txt"
    inp.write_text("\n".join(lines) + "\n")
    out = str(tmp_path / "jax_out")
    assert jax_worker.main([
        "-f", chaos.FMT, "--graph", graph, "-p", "1", "-q", "3600",
        "-i", "1000000000", "-s", "chaos", "-o", out, "--input", str(inp),
        "--uuid-filter", "off", "-r", "0,1,2", "-x", "0,1,2",
        "--report-flush-interval", flush]) == 0
    return chaos.tile_tree(out)


def test_kill_restore_recovers_the_jax_packages_tiles(tmp_path,
                                                       monkeypatch):
    keep = {}
    assert chaos.scenario_kill_restore("cpu", keep) == 0
    assert keep["lines"] == jax_lines(8)
    want = jax_tiles(tmp_path, keep["lines"], "1000000000", monkeypatch)
    assert want and keep["ref"] == want
    assert keep["got"] == want
    # the comparand chip_smoke.py rebuilds on the CPU for a card run
    assert chaos.fault_free("kill_restore", "cpu", keep) == want


def test_stream_resume_recovers_the_jax_packages_tiles(tmp_path,
                                                        monkeypatch):
    """Both legs (the commit fault's batch-path fallback, and the kill
    with the carried decode states restored) end on the JAX package's
    fault-free tiles at the same incremental lag."""
    keep = {}
    assert chaos.scenario_stream_resume("cpu", keep) == 0
    assert keep["frames"] > 0
    assert keep["lines"] == jax_lines(6)
    want = jax_tiles(tmp_path, keep["lines"], "0", monkeypatch,
                     lag=chaos.RESUME_LAG)
    assert want and keep["ref"] == want
    assert keep["err"] == want and keep["got"] == want
    assert chaos.fault_free("stream_resume", "cpu", keep) == want


def test_submit_burst_requeues_then_dead_letters():
    keep = {}
    assert chaos.scenario_submit_burst("cpu", keep) == 0
    assert keep["burst"]["batch.requeued"] > 0
    assert not keep["burst"].get("batch.dropped")
    assert keep["tiles"]
    assert keep["dead"]["batch.deadletter"] == keep["spooled"] > 0


def test_egress_outage_replays_to_the_jax_packages_store(tmp_path):
    """The spool replayed into a store equals the JAX package's ingest of
    the fault-free run's tiles, cell for cell."""
    keep = {}
    assert chaos.scenario_egress_outage("cpu", keep) == 0
    root = tmp_path / "tiles"
    for rel, body in keep["tiles"].items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(body)
    ds = JaxDatastore(str(tmp_path / "jax_store"))
    got = jax_ingest_dir(ds, str(root))
    assert got["rows"] == keep["stats"]["rows"] and not got["failures"]
    assert ds.merged_cells() == keep["cells"]
    assert chaos.fault_free("egress_outage", "cpu", keep) == keep["ref"] \
        == keep["tiles"]


def test_replay_drain_empties_both_spools():
    keep = {}
    assert chaos.scenario_replay_drain("cpu", keep) == 0
    assert keep["counters"]["replay.traces.ok"] > 0
    assert keep["counters"]["replay.tiles.ok"] > 0
    assert keep["tiles"] and keep["cells"]


def test_a_failing_scenario_fails_the_run(tmp_path, monkeypatch):
    """Any failure is a nonzero exit: a child that cannot start fails
    kill_restore at its fault-free run."""
    monkeypatch.setattr(chaos, "PYTHON", [sys.executable, "-c",
                                          "import sys; sys.exit(3)", "--"])
    assert chaos.main(["--device", "cpu", "kill_restore"]) == 1
