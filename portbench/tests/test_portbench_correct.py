"""The comparison that decides ``correct``, shown to fail: a run on the
CPU at a small size (the harness's look for a card skipped) with the
timed path broken underneath comes out not correct, once for each fault
its cell can have; the control (the reference at the precision below the
configuration's, in the program's place) fails the replay comparison; and
sound runs come out correct. The replay entry on the dense phone mix
and the worker and ``/report`` entries, which no cell of
``BENCHMARK.json`` runs yet, are held to the same here on cells and a
configuration of this file's own. One test runs a cell on the card."""
import json
import os
import subprocess
import sys

import pytest

from portbench import control
from portbench.lib import bench
from portbench.run import execute

SEED = 2 ** 31 + 99
CITY = {"city": {"rows": 30, "cols": 30}}
#: the streaming deployment's settings (the upstream's batcher, worker
#: and service defaults) on a small city, for the stream entries
STREAM_CONFIG = {
    "city": {"rows": 30, "cols": 30, "spacing_m": 200.0, "seed": 42,
             "lat0": 14.6, "lon0": 120.98},
    "matcher": bench.load_json("configs", "replay-metro341")["matcher"],
    "worker": {"threshold_sec": 15, "privacy": 2, "quantisation": 3600,
               "mode": "auto", "reports": "0,1", "transitions": "0,1",
               "flush_interval_s": 60, "session_gap_ms": 60000,
               "report_flush_interval_s": 1.0, "source": "portbench"},
    "batcher": {"report_min_s": 60, "report_min_points": 10,
                "report_min_m": 500},
    "service": {"threshold_sec": 15, "mode": "auto",
                "report_levels": [0, 1], "transition_levels": [0, 1]},
}
STREAM_MIX = {"shape_seed": 20170716, "probe_interval_s": 5,
              "trips": [1, 1], "trip_s": [560, 600], "stop_s": [0, 0],
              "speed_factor": [0.55, 0.95], "start_spread_s": 30,
              "turn_p": 0.4, "noise_m": 4.0}
LIMIT = {"answers_mismatch_share": 0.04}
CELLS = {
    "replay-metro341.sparse": dict(
        config=CITY, mix={"vehicles": 1024},
        cell={"units": 8, "warm_vehicles": 16, "warm_units": 1,
              "judge": {"units": 2}}),
    "replay.dense": dict(
        config=CITY, mix={"vehicles": 16, "trips": [1, 2]},
        cell={"config": "replay-metro341", "traffic": "phone-dense",
              "entry": "replay", "units": 4, "warm_vehicles": 2,
              "warm_units": 1, "judge": {"units": 2},
              "limits": bench.load_json(
                  "cells", "replay-metro341.sparse")["limits"]}),
    "stream.worker": dict(
        config=STREAM_CONFIG, mix=dict(STREAM_MIX, vehicles=128),
        cell={"config": "stream", "traffic": "partition", "entry": "worker",
              "warm_stream_s": 65, "unit_messages": 128,
              "prebuild_vehicles": 8, "judge": {"requests": 400},
              "limits": LIMIT}),
    "stream.report": dict(
        config=STREAM_CONFIG,
        mix=dict(STREAM_MIX, vehicles=256, window_points=[12, 24]),
        cell={"config": "stream", "traffic": "windows", "entry": "report",
              "clients": 8, "warm_vehicles": 16, "warm_limit_s": 180,
              "judge": {"requests": 400}, "limits": LIMIT}),
}


def run_small(cell, seconds=1.0):
    result, _lines = execute(bench.benchmark(), cell, SEED, seconds, False,
                             device="cpu", overrides=CELLS[cell])
    return result


def drop_half(results):
    """Half of the batch left out: the second half's answers empty."""
    out = list(results)
    for i in range(len(out) // 2, len(out)):
        if out[i] is not None:
            out[i] = {"segments": [], "mode": "auto"}
    return out


def alter(results):
    """An answer altered where it is produced: every segment entered and
    left 7 s later."""
    out = []
    for m in results:
        if m is not None:
            segs = [dict(s) for s in m["segments"]]
            for s in segs:
                for key in ("start_time", "end_time"):
                    if s.get(key, -1) > 0:
                        s[key] += 7.0
            m = {"segments": segs, "mode": m["mode"]}
        out.append(m)
    return out


def break_matcher(monkeypatch, fault):
    from reporter_tpu_torch.matcher import SegmentMatcher
    for name in ("match_many", "match_incremental"):
        real = getattr(SegmentMatcher, name)

        def broken(self, traces, _real=real):
            return fault(_real(self, traces))
        monkeypatch.setattr(SegmentMatcher, name, broken)


def freeze_state(monkeypatch):
    """A step that returns its state unchanged: the incremental decode's
    rounds hand back the scores they were given."""
    from reporter_tpu_torch import ops

    def unchanged(dist_m, valid, route_m, gc_m, case, prev, n_steps,
                  sigma, beta, out=None):
        import torch
        R, N, K = dist_m.shape
        scores = prev.expand(R, N, K).clone()
        bp = torch.arange(K, dtype=torch.int32).expand(R, N, K).clone()
        best = prev.argmax(-1).to(torch.int32).expand(R, N).clone()
        return scores, bp, best
    monkeypatch.setattr(ops, "incremental_steps", unchanged)


def duplicate_rows(monkeypatch):
    """Rows written twice: every tile file a call writes holds each of
    its rows again, as a unit written twice would leave it (no reference
    row is missing, so only the surplus shows)."""
    from reporter_tpu_torch.pipeline import simple_reporter
    real = simple_reporter.match_traces

    def doubled(*args, **kwargs):
        out = real(*args, **kwargs)
        for dirpath, _d, files in os.walk(out):
            for name in files:
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    rows = f.read()
                with open(path, "a") as f:
                    f.write(rows)
        return out
    monkeypatch.setattr(simple_reporter, "match_traces", doubled)


REPLAY = ("replay-metro341.sparse", "replay.dense")
FAULTS = [(cell, f) for cell in CELLS for f in ("half", "altered")] + \
    [("stream.worker", "state")] + [(cell, "doubled") for cell in REPLAY]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    if fault == "state":
        freeze_state(monkeypatch)
    elif fault == "doubled":
        duplicate_rows(monkeypatch)
    else:
        break_matcher(monkeypatch, drop_half if fault == "half" else alter)
    result = run_small(cell)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    result = run_small(cell)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell", REPLAY)
def test_the_control_fails_the_replay_comparison(cell):
    env = bench.Env(cell, SEED, 0, False, 0, ".", "cpu", CELLS[cell])
    value = control.reading(env)
    assert value > env.limits()["rows_mismatch_share"], value


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload",
         "replay-metro341.sparse", "--seed", str(SEED), "--seconds", "3",
         "--trace", "1"], cwd=bench.ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["kind"] == card
    assert result["device"]["busy_s"] > 0
