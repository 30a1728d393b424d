"""The benchmark's own arithmetic and files: the traffic generator, the
roofline, the idle share, the names, the import boundary, and cells
found by name."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench.lib import bench, devtrace, roofline, textio, traffic

HERE = bench.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
GRID = dict(rows=30, cols=30, spacing_m=200.0, lat0=14.60, lon0=120.98)
MIXES = sorted(f[:-5] for f in os.listdir(os.path.join(HERE, "traffic")))


def small(mix):
    return dict(traffic.load_mix(mix), vehicles=24)


@pytest.mark.parametrize("mix", MIXES)
def test_fleet_is_deterministic_in_its_seed(mix):
    m = small(mix)
    a = traffic.fleet(m, GRID, 2 ** 31 + 5)
    b = traffic.fleet(m, GRID, 2 ** 31 + 5)
    c = traffic.fleet(m, GRID, 2 ** 31 + 6)
    for k in ("vehicle", "time", "lat", "lon", "offsets"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert not np.array_equal(a.lat, c.lat)
    # every seed drives the same trips: the same probes per vehicle, to
    # within a probe a trip (the probe phase)
    assert np.abs(np.diff(a.offsets) - np.diff(c.offsets)).max() <= 20


@pytest.mark.parametrize("mix", MIXES)
def test_fleet_probes_are_ordered_and_on_the_grid(mix):
    m = small(mix)
    f = traffic.fleet(m, GRID, 7)
    assert np.all(np.diff(f.vehicle) >= 0)
    for v in range(f.vehicles):
        t = f.time[f.offsets[v]:f.offsets[v + 1]]
        assert np.all(np.diff(t) >= m["probe_interval_s"] - 1)
    half = (GRID["rows"] - 1) / 2 * GRID["spacing_m"] + 40
    assert np.abs((f.lat - GRID["lat0"]) * 111195.0).max() < half


def test_text_round_trips_what_both_sides_read():
    f = traffic.fleet(small("fleet-sparse"), GRID, 3)
    raw = textio.text(len(f), textio.digits(f.time, 10), b",",
                      textio.fixed(f.lat, 3, 6), b",",
                      textio.fixed(f.lon, 3, 6))
    for line, t, la, lo in zip(raw.decode().splitlines(), f.time, f.lat,
                               f.lon):
        a, b, c = line.split(",")
        assert (int(a), float(b), float(c)) == (t, la, lo)
    assert textio.fixed(np.array([-1.5]), 2, 1).tobytes() == b"-01.5"


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_drive_the_same_routes_and_streams_other_ones(mix):
    """The run seed moves each probe along its vehicle's route (the
    phase) and off it (the noise), never onto another route: without
    noise, each vehicle's probes span the same box under two seeds, to
    within one probe interval's drive at each end."""
    m = dict(small(mix), noise_m=0.0)
    reach = m["probe_interval_s"] * 80 / 3.6 + 1.0

    def boxes(f):
        y = (f.lat - GRID["lat0"]) * 111195.0
        x = (f.lon - GRID["lon0"]) * 111195.0 * np.cos(
            np.radians(GRID["lat0"]))
        return np.array([[x[a:b].min(), x[a:b].max(), y[a:b].min(),
                          y[a:b].max()] for a, b in
                         zip(f.offsets[:-1], f.offsets[1:])])
    a = boxes(traffic.fleet(m, GRID, 11))
    assert np.abs(a - boxes(traffic.fleet(m, GRID, 2 ** 31 + 12))).max() \
        <= reach
    assert np.abs(a - boxes(traffic.fleet(m, GRID, 11, stream=1))).max() \
        > reach


def test_report_windows_cover_each_vehicle_in_order():
    m = dict(small("fleet-sparse"), window_points=[12, 24])
    f = traffic.fleet(m, GRID, 9)
    w = traffic.windows(f, m)
    n = w[:, 2] - w[:, 1]
    assert n.min() >= m["window_points"][0]
    assert n.max() <= m["window_points"][1]
    assert np.all(np.diff(f.time[w[:, 2] - 1]) >= 0)


def test_roofline_on_synthetic_shapes():
    B, T, K = 128, 64, 8
    steps = T - 1
    per_row = T * K * 3 + steps * (K * K * 2 + 2) + T * 4 + T * 4 + 4
    assert roofline.wire_bytes(B, T, K) == B * per_row
    assert roofline.wire_ops(B, T, K) == B * (steps * K * K * 6 + T * K * 4)
    t_bytes = B * per_row / roofline.HBM_BYTES_PER_S
    t_ops = roofline.wire_ops(B, T, K) / roofline.F32_OPS_PER_S
    assert roofline.bound_s(B, T, K) == max(t_bytes, t_ops)
    # float32 on the wire moves more bytes than float16
    assert roofline.wire_bytes(B, T, K, 4) > roofline.wire_bytes(B, T, K)


def test_busy_union_and_idle_gaps():
    busy, merged = devtrace._union([(0, 10), (5, 20), (30, 40), (40, 45)])
    assert busy == 35 and merged == [[0, 20], [30, 45]]
    assert devtrace._union([]) == (0.0, [])


def test_readers_find_nothing_and_say_so():
    obs = bench.Obs(window_s=10.0, work=0.0)
    for m in bench.benchmark()["per_layer"]:
        assert bench.load_module("metrics", m["name"]).read(obs) is None
    d = devtrace.DeviceSummary(busy_s=0.5, window_s=10.0, kernels=[
        ("viterbi_kernel<__half, 8>", 0.002, 10)])
    obs = bench.Obs(window_s=10.0, work=1000.0, device=d,
                    shapes=[(128, 64, 8, 10)])
    share = bench.load_module("metrics", "viterbi_roofline.replay").read(obs)
    assert share == pytest.approx(
        100 * 10 * roofline.bound_s(128, 64, 8) / 0.002)
    idle = bench.load_module("metrics", "device_idle.replay").read(obs)
    assert idle == pytest.approx(95.0)


def test_benchmark_names_units_and_files():
    b = bench.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in b["configs"]:
        assert os.path.exists(os.path.join(bench.ROOT, c["file"]))
        for k in c["reduced"]:
            assert NAME.match(k) and k in bench.load_json(
                "configs", c["name"])
    for w in b["workloads"]:
        cell = bench.load_json("cells", w["name"])
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert os.path.exists(os.path.join(HERE, "entries",
                                           cell["entry"] + ".py"))
        assert NAME.match(w["traffic"])
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def imported_tops(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def sources(sub=""):
    for dirpath, _d, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_imports_the_jax_stack_or_the_jax_package():
    # whole top-level names: the program's name begins with the JAX
    # package's and passes
    assert bench.FORBIDDEN == ("jax", "jaxlib", "flax", "reporter_tpu")
    for path in sources():
        assert not imported_tops(path) & set(bench.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("ref"):
        assert "reporter_tpu_torch" not in imported_tops(path), path
        assert "reporter_tpu_torch" not in open(path).read().replace(
            "``reporter_tpu_torch/", ""), path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "reporter_tpu_torch_fake", sys)
    assert "reporter_tpu_torch_fake" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "reporter_tpu.fake", sys)
    assert "reporter_tpu.fake" in bench.forbidden_modules()


def test_a_new_cell_is_found_by_name(tmp_path):
    """A cell, its mix and a reader added as new files to a copy are
    found by name; no file that was there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(bench.ROOT, "BENCHMARK.json"), root)
    before = {p: open(p, "rb").read() for p in map(str, root.rglob("*"))
              if os.path.isfile(p)}
    pb = root / "portbench"
    mix = dict(traffic.load_mix("fleet-sparse"), vehicles=64)
    (pb / "traffic" / "fleet-tiny.json").write_text(json.dumps(mix))
    cell = dict(bench.load_json("cells", "replay-metro341.sparse"),
                traffic="fleet-tiny")
    (pb / "cells" / "replay-metro341.tiny.json").write_text(
        json.dumps(cell))
    (pb / "metrics" / "probes_per_window.tiny.py").write_text(
        "def read(obs):\n    return obs.work / obs.window_s\n")
    code = (
        "import json, sys; sys.path.insert(0, '.');"
        "from portbench.lib import bench;"
        "e = bench.Env('replay-metro341.tiny', 1, 1, False, 0, '.', 'cpu');"
        "r = bench.load_module('metrics', 'probes_per_window.tiny');"
        "print(json.dumps([e.mix['vehicles'], e.config['name'],"
        " r.read(bench.Obs(window_s=2.0, work=10.0))]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout) == [64, "replay-metro341", 5.0]
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


def test_without_the_program_it_exits_nonzero(tmp_path):
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(bench.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload",
         "replay-metro341.sparse", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
