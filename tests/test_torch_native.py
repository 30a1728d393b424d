"""The port's native host runtime against the JAX package's, on the CPU.

Both libraries are built from their own sources: the JAX package's through
its own binding, the port's with g++ into ``reporter_tpu_torch/_build/``.
On seeded synthetic traces over a small grid city (with jitter and an
off-network point), the batched prep, the batched assembly and the wire
writer give the same bits and bytes. Tolerance: exact.
"""
import copy
import json
from decimal import Decimal

import numpy as np
import pytest
import torch

from reporter_tpu import native as ref_native
from reporter_tpu.core.tracebatch import TraceBatch as JaxTraceBatch
from reporter_tpu.matcher import MatchParams as JaxParams
from reporter_tpu.matcher.batchpad import prepare_batch as jax_prepare_batch
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu_torch import native
from reporter_tpu_torch.core.tracebatch import TraceBatch
from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
from reporter_tpu_torch.matcher.batchpad import prepare_batch
from reporter_tpu_torch.matcher.hmm import viterbi_decode_batch
from reporter_tpu_torch.matcher.matcher import (GRID_CELL_M, MatchRuns,
                                                RunColumns, _jnum,
                                                render_segments_json,
                                                render_segments_json_py)
from reporter_tpu_torch.service.report import (_report_json_py, report,
                                               report_json, report_wire)
from reporter_tpu_torch.synth import build_grid_city, generate_trace

CITY = dict(rows=8, cols=8, spacing_m=200.0, seed=3)
PARAMS = MatchParams()
#: (bucket T, traces): T=16 with one trace longer than the bucket
SHAPES = [(16, 11), (64, 9)]


@pytest.fixture(scope="module")
def cities():
    return jax_city(**CITY), build_grid_city(**CITY)


@pytest.fixture(scope="module")
def runtimes(cities):
    ref_city, city = cities
    assert ref_native.available(), "the JAX package's host runtime"
    return (ref_native.NativeRuntime(ref_city, cell_m=GRID_CELL_M),
            native.NativeRuntime(city, cell_m=GRID_CELL_M))


def _columns(city, T: int, n: int, seed: int):
    """(pt_off, lat, lon, times) for ``n`` seeded traces of at most T raw
    points (the last one of T=16 longer), with GPS jitter (a repeated,
    nudged point) and an off-network point in every third trace."""
    rng = np.random.default_rng(seed)
    traces = []
    while len(traces) < n:
        tr = generate_trace(city, "t", rng, noise_m=4.0)
        if tr is None:
            continue
        pts = [(p["lat"], p["lon"], p["time"]) for p in tr.points]
        cap = 30 if (T == 16 and len(traces) == n - 1) else T
        pts = pts[:int(rng.integers(2, cap + 1))]
        if len(pts) > 3:
            lat, lon, t = pts[2]
            pts.insert(3, (lat + 1e-5, lon, t + 1))
            if len(traces) % 3 == 0:
                pts.insert(1, (lat + 0.5, lon + 0.5, t))
        traces.append(pts[:cap])
    counts = [len(p) for p in traces]
    pt_off = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=pt_off[1:])
    flat = np.array([p for pts in traces for p in pts], np.float64)
    return pt_off, flat[:, 0].copy(), flat[:, 1].copy(), flat[:, 2].copy()


def _prep_kwargs(p):
    return dict(search_radius=p.search_radius,
                interpolation_distance=p.interpolation_distance,
                breakage_distance=p.breakage_distance,
                max_route_distance_factor=p.max_route_distance_factor,
                backward_tolerance_m=p.backward_tolerance_m,
                max_route_time_factor=p.max_route_time_factor,
                min_time_bound_s=p.min_time_bound_s,
                turn_penalty_factor=p.turn_penalty_factor)


def _bits_equal(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


def _prepare(runtimes, cities, T, n, seed):
    """Both runtimes' prepare_batch on the same columns, rows > B."""
    cols = _columns(cities[1], T, n, seed)
    rows = 1 << (n - 1).bit_length()
    assert rows > n
    return cols, [rt.prepare_batch(*cols, T, PARAMS.max_candidates,
                                   n_threads=3, n_rows=rows,
                                   **_prep_kwargs(PARAMS))
                  for rt in runtimes]


@pytest.mark.parametrize("T,n", SHAPES)
def test_prepare_batch_bit_equal(runtimes, cities, T, n):
    _cols, (want, got) = _prepare(runtimes, cities, T, n, seed=T)
    assert set(got) == set(want)
    for key in sorted(set(want) - {"phase_ns"}):
        _bits_equal(got[key], want[key], key)
    assert (got["num_kept"][:n] > 0).all()
    assert (got["case"][n:] == 2).all()  # filler rows: all SKIP


@pytest.mark.parametrize("T,n", SHAPES)
def test_batchpad_prepare_batch_equals_reference(runtimes, cities, T, n):
    """The padded batch (the f16 wire decision included) and every
    per-trace view equal the JAX package's ``prepare_batch``."""
    pt_off, lat, lon, times = _columns(cities[1], T, n, seed=T + 1)
    rows = 1 << (n - 1).bit_length()
    want = jax_prepare_batch(runtimes[0],
                             JaxTraceBatch(pt_off, lat, lon, times),
                             JaxParams(), T, pad_rows=rows)
    got = prepare_batch(runtimes[1], TraceBatch(pt_off, lat, lon, times),
                        PARAMS, T, pad_rows=rows)
    for key in ("dist_m", "valid", "route_m", "gc_m", "case", "pt_off",
                "times_flat"):
        _bits_equal(np.asarray(getattr(got, key)),
                    np.asarray(getattr(want, key)), key)
    assert got.dist_m.dtype == np.float16
    assert len(got.traces) == len(want.traces) == n
    for g, w in zip(got.traces, want.traces):
        assert (g.num_raw, g.num_kept) == (w.num_raw, w.num_kept)
        assert g.trailing_jitter_dwell_s == w.trailing_jitter_dwell_s
        for key in ("kept_idx", "times", "edge_ids", "dist_m", "offset_m",
                    "route_m", "gc_m", "case"):
            _bits_equal(getattr(g, key), getattr(w, key), key)
        np.testing.assert_array_equal(g.has_cands, w.has_cands.astype(bool))


def test_to_f16_bit_equal_to_numpy(runtimes):
    rng = np.random.default_rng(5)
    edges = [0.0, -0.0, 1.0, -1.0, 2049.0, 2051.0, 4096.0, 4097.0,
             65504.0, 65519.99, 65520.0, 1e9, -1e9, np.inf, -np.inf, np.nan,
             6.1e-5, 5.96e-8, 3e-8, 2.9e-8, 1e-10, 0.1, 1 / 3, 2.0]
    vals = np.concatenate([np.array(edges, np.float32),
                           rng.uniform(-5000, 5000, 4096).astype(np.float32),
                           rng.standard_normal(4096).astype(np.float32)
                           * np.float32(1e-4)]).reshape(2, -1)
    with np.errstate(over="ignore"):
        want = vals.astype(np.float16)
    got = runtimes[1].to_f16(vals)
    assert got.shape == want.shape
    _bits_equal(got.view(np.uint16), want.view(np.uint16), "f16")


def _decoded(prep, T):
    """Paths of a prep's live rows from the plain decode."""
    x = [torch.from_numpy(prep[k]) for k in ("dist_m", "route_m", "gc_m")]
    valid = torch.from_numpy(prep["edge_ids"] != -1)
    paths, _ = viterbi_decode_batch(x[0], valid, x[1], x[2],
                                    torch.from_numpy(prep["case"]),
                                    np.float32(PARAMS.effective_sigma),
                                    np.float32(PARAMS.beta))
    return paths.numpy()


def _assemble(runtimes, cities, T, n):
    (pt_off, _lat, _lon, times), (_want, prep) = _prepare(
        runtimes, cities, T, n, seed=T + 2)
    paths = _decoded(prep, T)[:n]
    kw = dict(queue_threshold_kph=PARAMS.queue_speed_threshold_kph,
              interpolation_distance_m=PARAMS.interpolation_distance,
              backward_tolerance_m=PARAMS.backward_tolerance_m,
              turn_penalty_factor=PARAMS.turn_penalty_factor)
    return [rt.assemble_batch(paths, prep, pt_off, times, **kw)
            for rt in runtimes], times[pt_off[1:] - 1]


@pytest.mark.parametrize("T,n", SHAPES)
def test_assemble_batch_run_columns_equal(runtimes, cities, T, n):
    (want, got), _ends = _assemble(runtimes, cities, T, n)
    n_runs = got["n_runs"]
    assert n_runs == want["n_runs"] > n
    _bits_equal(got["run_off"], want["run_off"], "run_off")
    for key in ("seg_id", "internal", "start", "end", "length", "queue",
                "begin_idx", "end_idx"):
        _bits_equal(got[key][:n_runs], want[key][:n_runs], key)
    _bits_equal(got["way_off"][:n_runs + 1], want["way_off"][:n_runs + 1],
                "way_off")
    n_ways = int(got["way_off"][n_runs])
    _bits_equal(got["ways"][:n_ways], want["ways"][:n_ways], "ways")


@pytest.mark.parametrize("mode", ["auto", "bicycle"])
@pytest.mark.parametrize("T,n", SHAPES)
def test_render_segments_json_byte_equal_to_python(runtimes, cities, T, n,
                                                   mode):
    (_want, runs), _ends = _assemble(runtimes, cities, T, n)
    cols = RunColumns(runs)
    ro = runs["run_off"].tolist()
    spans = [(ro[b], ro[b + 1]) for b in range(n)] + [(ro[1], ro[1])]
    for lo, hi in spans:
        got = render_segments_json(cols, lo, hi, mode)
        assert got == render_segments_json_py(cols, lo, hi, mode)
        assert got == json.dumps(MatchRuns(cols, lo, hi, mode)._materialise(),
                                 separators=(",", ":"))


@pytest.mark.parametrize("levels", [
    ({0, 1, 2}, {0, 1, 2}), ({0, 1}, {0}),
    ([0, 1.0, "2", None, 9, 2.5], [True, 2]),   # a mask, as the scan reads
    ({0, -1}, {0, 1, 2}), ([Decimal(1)], {0})])  # no mask: Python writer
def test_report_writers_agree(runtimes, cities, levels):
    """The C writer (whole-chunk memo and per-trace calls), the Python
    columnar writer and json.dumps of the dict report() give one body."""
    (_want, runs), ends = _assemble(runtimes, cities, 64, 9)
    cols = RunColumns(runs)
    cols.arrays["_run_off"] = runs["run_off"]
    cols.arrays["_trace_end"] = np.ascontiguousarray(ends)
    ro = runs["run_off"].tolist()
    rep, trans = levels
    for threshold in (15, 3600):
        for b in range(len(ro) - 1):
            trace = {"trace": [{"time": float(ends[b])}]}
            m = MatchRuns(cols, ro[b], ro[b + 1], "auto")
            want = json.dumps(report(copy.deepcopy(m._materialise()), trace,
                                     threshold, rep, trans),
                              separators=(",", ":"))
            assert report_json(m, trace, threshold, rep, trans) == want
            assert bytes(report_wire(m, trace, threshold, rep,
                                     trans)) == want.encode()
            assert _report_json_py(m, trace, threshold, rep, trans) == want
            # a trace end other than the chunk's: the per-trace C call
            trace = {"trace": [{"time": float(ends[b]) + 20.0}]}
            assert report_json(m, trace, threshold, rep, trans) == \
                _report_json_py(m, trace, threshold, rep, trans)


def test_json_double_equals_repr():
    rng = np.random.default_rng(3)
    values = [0.0, -0.0, -1.0, 1.0, 3.125, 1234.567, 0.1, 0.5, 0.25, 0.062,
              0.0625, 1e-7, 123456789.123, 1.5e9 + 0.123,
              1.7976931348623157e308, 2.5, 97.001, 1e12 + 0.375, 5e-324]
    values += np.round(rng.uniform(0, 2e9, 300), 3).tolist()
    values += rng.uniform(0, 1, 200).tolist()
    values += [float(v) for v in rng.integers(0, 10**15, 100)]
    for v in values:
        assert native.json_double(v).decode() == repr(v), v
    for v in (float("inf"), float("-inf"), float("nan")):
        assert native.json_double(v).decode() == _jnum(v) == json.dumps(v)


@pytest.mark.parametrize("fault", ["no compiler", "build fails",
                                   "ABI mismatch"])
def test_binding_raises_and_never_falls_back(cities, tmp_path, monkeypatch,
                                             fault):
    monkeypatch.setattr(native, "_lib", None)
    if fault == "no compiler":
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    elif fault == "build fails":
        monkeypatch.setattr(native, "CXX", "false")
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    else:
        monkeypatch.setattr(native, "ABI_VERSION", native.ABI_VERSION + 1)
    with pytest.raises(RuntimeError):
        native.load()
    with pytest.raises(RuntimeError):
        SegmentMatcher(cities[1], device="cpu")
    assert native._lib is None
    assert not list(tmp_path.glob("*.so"))
    assert SegmentMatcher(cities[1], device="cpu", native=False).runtime \
        is None


def test_writer_fault_raises(cities, monkeypatch):
    """A C writer fault reaches the caller: no Python-writer fallback."""
    rng = np.random.default_rng(4)
    tr = None
    while tr is None:
        tr = generate_trace(cities[1], "w", rng, noise_m=4.0)
    req = tr.request_json(report_levels=(0, 1, 2),
                          transition_levels=(0, 1, 2))
    match = SegmentMatcher(cities[1], device="cpu",
                           pipeline=False).match_many([req])[0]
    assert isinstance(match, MatchRuns)

    def fault(*_args):
        raise OSError("writer fault")

    monkeypatch.setattr(native, "write_report_json_batch", fault)
    with pytest.raises(OSError, match="writer fault"):
        report_json(match, req, 15, {0, 1, 2}, {0, 1, 2})


def test_runtime_counters_and_fork_guard(cities):
    rt = native.NativeRuntime(cities[1], cell_m=GRID_CELL_M)
    cols = _columns(cities[1], 16, 4, seed=9)
    rt.prepare_batch(*cols, 16, 8, **_prep_kwargs(PARAMS))
    assert rt.route_memo_stats()["misses"] > 0
    assert rt.cache_size() > 0
    rt.cache_clear()
    assert rt.cache_size() == 0
    rt._owner_pid = -1  # as a forked child sees its parent's handle
    with pytest.raises(RuntimeError, match="fork"):
        rt.prepare_batch(*cols, 16, 8, **_prep_kwargs(PARAMS))
