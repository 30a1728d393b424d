"""The streaming deployment's cell, ``stream-metro341.worker``: its files
found by name, a small run of its entry (``worker_traced``) on the CPU
correct and without a device metric, the planted faults of
``test_portbench_correct.py`` not correct, and the incremental step's
roofline against a count by hand."""
import json

import pytest

from portbench.lib import bench, devtrace, incremental_roofline, roofline
from portbench.run import execute
from portbench.tests.test_portbench_correct import (SEED, alter,
                                                    break_matcher,
                                                    drop_half, freeze_state)

CELL = "stream-metro341.worker"
#: the cell at a small size: a 30x30 city, 128 vehicles on one short
#: trip each, a minute of stream warm
SMALL = dict(
    config={"city": {"rows": 30, "cols": 30}},
    mix={"vehicles": 128, "trips": [1, 1], "trip_s": [560, 600],
         "stop_s": [0, 0], "start_spread_s": 30},
    cell={"warm_stream_s": 65, "unit_messages": 128})
#: the cell's per-layer metrics that a run off the card reads
HOST_METRICS = ("incremental_prep_us_per_probe.worker",
                "incremental_upload_us_per_probe.worker",
                "incremental_cell_fill.worker",
                "assemble_us_per_probe.worker",
                "upload_bytes_per_probe.worker",
                "incremental_rows_per_launch.worker",
                "incremental_steps_per_probe.worker",
                "stream_probes_per_s.wall", "flush_p95_ms.worker",
                "incremental_us_per_probe.worker")
NEW_METRICS = HOST_METRICS + ("incremental_roofline.worker",
                              "device_idle.worker")


def run_small(trace=False, seconds=1.0):
    result, _lines = execute(bench.benchmark(), CELL, SEED, seconds, trace,
                             device="cpu", overrides=SMALL)
    return result


def test_the_cell_and_its_files_are_found_by_name():
    b = bench.benchmark()
    cell = bench.load_json("cells", CELL)
    work = next(w for w in b["workloads"] if w["name"] == CELL)
    assert (work["config"], work["traffic"], work["chips"]) == \
        (cell["config"], cell["traffic"], 1)
    conf = next(c for c in b["configs"] if c["name"] == cell["config"])
    with open(conf["file"].replace("portbench/", bench.HERE + "/", 1)) as f:
        cfg = json.load(f)
    assert cfg["source"] == conf["source"]
    assert sorted(cfg["reduced"]) == sorted(conf["reduced"])
    # the replay configuration's city and matcher, every width uncut
    replay = bench.load_json("configs", "replay-metro341")
    assert cfg["city"] == replay["city"]
    assert cfg["matcher"] == replay["matcher"]
    assert bench.load_json("traffic", cell["traffic"])["vehicles"] == 2048
    assert callable(bench.load_module("entries", cell["entry"]).run)
    e2e = [m["name"] for m in bench.cell_metrics(b, CELL, "end_to_end")]
    assert e2e == ["card_busy_ns_per_probe", "setup_s"]
    layer = [m["name"] for m in bench.cell_metrics(b, CELL, "per_layer")]
    assert set(NEW_METRICS) <= set(layer)
    for name in layer:
        assert callable(bench.load_module("metrics", name).read)


def test_a_small_run_is_correct_and_reads_no_card_off_it():
    result = run_small()
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s"}


def test_a_traced_run_reads_the_program_s_new_counters():
    result = run_small(trace=True)
    assert result["correct"] is True, result["checks"]
    got = result["metrics"]
    for name in HOST_METRICS:
        assert got[name]["value"] > 0, name
    assert got["incremental_cell_fill.worker"]["value"] <= 100.0
    # no card, no kernel time: the roofline, the idle share and the card
    # metric are absent
    for name in ("incremental_roofline.worker", "device_idle.worker",
                 "card_busy_ns_per_probe"):
        assert name not in got, name


def test_the_probes_are_the_messages_the_window_consumed(monkeypatch):
    """``worker_traced`` counts the window's whole units of
    ``unit_messages`` lines, not the answered requests' points, and hands
    those points to the readers apart."""
    from types import SimpleNamespace

    from portbench.entries import worker, worker_traced

    def fake_run(env):
        assert env.trace is True   # the card is traced in every run on it
        _t0, elapsed, _n = bench.timed_units(range(10), lambda u: None,
                                             -1.0)
        device = devtrace.DeviceSummary(busy_s=6e-3, window_s=elapsed)
        return bench.Outcome(e2e={"stream_probes_per_s": 1.0}, setup_s=1.0,
                             attempted=1, failed=0, checks=[],
                             memory_peak_bytes=0,
                             obs=bench.Obs(window_s=elapsed, work=900.0,
                                           device=device))

    monkeypatch.setattr(worker, "run", fake_run)
    env = SimpleNamespace(trace=False, on_card=True,
                          cell={"unit_messages": 2048},
                          config={"matcher": {"max_candidates": 8}})
    real = bench.timed_units
    out = worker_traced.run(env)
    assert bench.timed_units is real   # restored after the run
    # a window that ends at once runs one unit of 2,048 messages
    assert out.obs.work == 2048.0
    assert out.obs.extra == {"K": 8, "request_points": 900.0}
    assert out.e2e == {"card_busy_ns_per_probe": pytest.approx(6e6 / 2048)}


@pytest.mark.parametrize("fault", ["state", "altered", "half"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    if fault == "state":
        freeze_state(monkeypatch)
    else:
        break_matcher(monkeypatch, alter if fault == "altered"
                      else drop_half)
    result = run_small()
    assert result["correct"] is False, result["checks"]


def test_the_step_bytes_are_the_slab_s_row_and_a_hand_count():
    from reporter_tpu_torch.matcher.incremental import slab_row_bytes
    for K in (1, 8, 16, 64):
        assert incremental_roofline.step_bytes(K) == slab_row_bytes(K)
    # K = 8: a step reads 32 B of distances, 8 of flags, 256 of routes,
    # 4 of gc and 4 of case, and writes 32 B of scores, 32 of
    # back-pointers and 4 of best: 372 B; a row reads 32 B of carried
    # scores and its 4 B step count. 3 steps over 2 rows: 1,188 B
    assert incremental_roofline.step_bytes(8) == 32 + 8 + 256 + 4 + 4 + \
        32 + 32 + 4 == 372
    assert incremental_roofline.row_bytes(8) == 36
    bound = incremental_roofline.bound_s(3, 2, 8)
    assert bound == pytest.approx(1188 / roofline.HBM_BYTES_PER_S, rel=1e-12)
    # bytes bound it: 3 x (6 x 64 + 32) operations take far less
    assert 3 * (6 * 64 + 32) / roofline.F32_OPS_PER_S < bound


def test_the_roofline_reader_takes_both_kernels_of_the_step():
    reader = bench.load_module("metrics", "incremental_roofline.worker")
    device = devtrace.DeviceSummary(busy_s=1e-3, window_s=1.0, kernels=[
        ("void (anonymous namespace)::incremental_packed<8>("
         "(anonymous namespace)::StepIn, (anonymous namespace)::StepOut)",
         2e-6, 1),
        ("incremental_rows(StepIn, StepOut)", 1e-6, 1),
        ("viterbi_kernel<__half, 8>", 5e-6, 1)])
    obs = bench.Obs(window_s=1.0, work=10.0, device=device, extra={"K": 8},
                    counters={"match.incremental.cells.kept": 3000,
                              "match.incremental.rows.launched": 2000})
    want = 100 * (3000 * 372 + 2000 * 36) / roofline.HBM_BYTES_PER_S / 3e-6
    assert reader.read(obs) == pytest.approx(want, rel=1e-12)
    # the parent's program counts no steps: nothing to read
    obs.counters = {}
    assert reader.read(obs) is None
