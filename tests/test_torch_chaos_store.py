"""The port's chaos harness (``reporter_tpu_torch/tools/chaos.py``), its
datastore scenarios, on the CPU at the JAX harness's sizes.

``lease_kill`` kills a ``stream`` child holding the store's writer
lease mid-compaction, ``swap_kill`` a registry child inside
``CityRegistry.swap``, and ``double_ingest`` a child between its tee
ingest and its epoch commit. Each recovered store's merged cells must
equal a fault-free ingest, by the JAX package's ``LocalDatastore``, of
the tile trees the port's workers wrote (for ``swap_kill`` under both
map epochs, and each epoch's pinned view too). Each child has its own
timeout (``chaos.CHILD_TIMEOUT_S``). Tolerance: exact.
"""
import pytest

from reporter_tpu.datastore import EpochView as JaxEpochView
from reporter_tpu.datastore import LocalDatastore as JaxDatastore
from reporter_tpu.datastore import ingest_dir as jax_ingest_dir
from reporter_tpu.graph.version import map_version as jax_map_version
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu_torch.tools import chaos
from reporter_tpu_torch.utils import faults

CITY = dict(rows=10, cols=10, spacing_m=200.0, seed=5,
            service_road_fraction=0.0, internal_fraction=0.0)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.clear()
    yield
    faults.clear()


def write_tree(root, tree):
    """Lay a {relpath: bytes} tile tree out under ``root``."""
    for rel, body in tree.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(body)
    return str(root)


def test_lease_kill_recovers_the_jax_ingest_of_its_tiles(tmp_path):
    keep = {}
    assert chaos.scenario_lease_kill("cpu", keep) == 0
    assert len(keep["tiles"]) == 2 and all(keep["tiles"])
    ds = JaxDatastore(str(tmp_path / "jax_store"))
    for w, tree in enumerate(keep["tiles"]):
        got = jax_ingest_dir(ds, write_tree(tmp_path / f"w{w}", tree))
        assert got["rows"] and not got["failures"]
    assert keep["cells"] and ds.merged_cells() == keep["cells"]


def test_swap_kill_recovers_both_epochs_as_the_jax_store(tmp_path):
    keep = {}
    assert chaos.scenario_swap_kill("cpu", keep) == 0
    city2 = jax_city(**CITY)
    city2.edge_speed_kph = city2.edge_speed_kph * 1.1
    assert (keep["mv1"], keep["mv2"]) == (jax_map_version(jax_city(**CITY)),
                                          jax_map_version(city2))
    ds = JaxDatastore(str(tmp_path / "jax_store"))
    for mv, tree in ((keep["mv1"], keep["tiles_v1"]),
                     (keep["mv2"], keep["tiles_v2"])):
        ds.set_map_version(mv)
        got = jax_ingest_dir(ds, write_tree(tmp_path / mv, tree))
        assert got["rows"] and not got["failures"]
    ds.compact(max_deltas=0)
    assert ds.merged_cells() == keep["cells"]
    for mv in (keep["mv1"], keep["mv2"]):
        assert JaxDatastore.merged_cells(JaxEpochView(ds, mv)) \
            == keep["pinned"][mv]
    # the comparand chip_smoke.py rebuilds on the CPU for a card run
    assert chaos.fault_free("swap_kill", "cpu", keep) == keep["ref"] \
        == [keep["tiles_v1"], keep["tiles_v2"]]


def test_double_ingest_dedupes_to_the_jax_ingest_of_its_tiles(tmp_path):
    """The crash-replayed tee store and the fault-free tee store both
    equal the JAX package's ingest of the fault-free run's tiles; the
    in-process leg's tiles are the same flushes."""
    keep = {}
    assert chaos.scenario_double_ingest("cpu", keep) == 0
    ds = JaxDatastore(str(tmp_path / "jax_store"))
    got = jax_ingest_dir(ds, write_tree(tmp_path / "ref", keep["ref_tiles"]))
    assert got["rows"] and not got["failures"]
    assert ds.merged_cells() == keep["cells"] == keep["ref_cells"]
    assert keep["tiles"]
    assert chaos.fault_free("double_ingest", "cpu", keep) == keep["ref"] \
        == keep["tiles"]
