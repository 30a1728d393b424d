"""``upload_in_place_share.replay``: the share of the decode's uploaded
bytes the prep wrote into their slab, and nothing from a program that
uploads without slabs."""
import pytest

from portbench.lib import bench

NAME = "upload_in_place_share.replay"


def read(counters):
    obs = bench.Obs(window_s=10.0, work=2000.0, counters=counters)
    return bench.load_module("metrics", NAME).read(obs)


@pytest.mark.parametrize("counters,want", [
    ({}, None),
    # a program without slabs counts bytes and no copies
    ({"decode.upload.bytes": 600_000}, None),
    ({"decode.upload.bytes": 600_000, "decode.upload.copies": 40}, 100.0),
    ({"decode.upload.bytes": 600_000, "decode.upload.copies": 40,
      "decode.upload.restaged_bytes": 150_000}, 75.0),
    ({"decode.upload.bytes": 0, "decode.upload.copies": 0}, None),
])
def test_share_of_bytes_written_in_place(counters, want):
    got = read(counters)
    assert got == (want if want is None else pytest.approx(want))


def test_it_is_the_cells_metric():
    cells = {m["name"]: m for m in bench.cell_metrics(
        bench.benchmark(), "replay-metro341.sparse", "per_layer")}
    m = cells[NAME]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) \
        == ("%", "higher", "program_counter", "dispatch lane uploads",
            "card_busy_ns_per_probe")
