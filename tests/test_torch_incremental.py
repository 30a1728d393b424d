"""The port's incremental streaming decode against the JAX package's.

On the JAX package's incremental test city (12x12, built by each package's
own ``build_grid_city``), with the same windows fed to both:

- the plain step (``ops.incremental_step_plain``) is bit-equal to the JAX
  ``incremental_step_batch``, signed zeros, ties, unreachable routes and
  invalid candidates included, and padded rows leave the real rows alone;
- ``NativeRuntime.candidates``/``route_matrices`` are bit-equal to the JAX
  package's, and agree with the port's numpy lookups (candidates
  bit-equal, routes to one f32 ulp, as the JAX package's two preps);
- ``SegmentMatcher.match_incremental`` serves exactly the windows the JAX
  package's serves, each byte-equal to that one's and to the port's own
  ``match_many``; the carried-state blobs and the table's counters are
  equal after every history, on the native and the numpy prep;
- blobs move both ways between the packages and resume byte-exact;
- ``ReporterService.report_incremental`` answers each slot as
  ``report_many`` does.

The JAX package reads its lag, budget and prune knobs from the
environment; the port takes them as arguments. Tolerance: exact.
"""
import json

import numpy as np
import pytest
import torch

from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.matcher import incremental as jinc
from reporter_tpu.matcher.batchpad import ENV_PRUNE
from reporter_tpu.matcher.matcher import \
    render_segments_json as jax_render_segments_json
from reporter_tpu.ops.incremental import \
    incremental_step_batch as jax_step
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu_torch import ops
from reporter_tpu_torch.core.tracebatch import TraceBatch
from reporter_tpu_torch.graph.route import candidate_route_matrices
from reporter_tpu_torch.matcher import SegmentMatcher
from reporter_tpu_torch.matcher import incremental as inc
from reporter_tpu_torch.matcher.hmm import NORMAL, RESTART, SKIP
from reporter_tpu_torch.matcher.matcher import render_segments_json
from reporter_tpu_torch.service.server import ReporterService
from reporter_tpu_torch.synth import build_grid_city, generate_trace
from reporter_tpu_torch.utils import metrics

CITY = dict(rows=12, cols=12, spacing_m=200.0, seed=2,
            service_road_fraction=0.0, internal_fraction=0.0)
OPTS = {"mode": "auto", "report_levels": [0, 1, 2],
        "transition_levels": [0, 1, 2]}
SIGMA, BETA = np.float32(4.07), np.float32(3.0)


@pytest.fixture(scope="module")
def cities():
    return jax_city(**CITY), build_grid_city(**CITY)


def ser(obj) -> str:
    """Canonical JSON of a port match (dict or MatchRuns)."""
    if not isinstance(obj, dict):
        obj = json.loads(render_segments_json(obj.cols, obj.lo, obj.hi,
                                              obj.mode))
    return json.dumps(obj, sort_keys=True)


def jax_ser(obj) -> str:
    """Canonical JSON of a JAX package match (dict or its MatchRuns)."""
    if not isinstance(obj, dict):
        obj = json.loads(jax_render_segments_json(obj.cols, obj.lo, obj.hi,
                                                  obj.mode))
    return json.dumps(obj, sort_keys=True)


def make_trace(city, seed, noise=4.0):
    rng = np.random.default_rng(seed)
    for _ in range(500):
        tr = generate_trace(city, f"veh-{seed}", rng, noise_m=noise)
        if tr is not None:
            return list(tr.points)
    raise RuntimeError("could not generate a trace")


def stop_and_go(pts, rng):
    """A stopped-vehicle jitter cluster mid-trace, then the tail moved
    3 km (breakage: a RESTART)."""
    k = len(pts) // 2
    base = pts[k]
    stop = [dict(lat=base["lat"] + rng.normal(0, 2e-6),
                 lon=base["lon"] + rng.normal(0, 2e-6),
                 time=base["time"] + 1 + i) for i in range(8)]
    shift = stop[-1]["time"] - base["time"]
    tail = [dict(p, time=p["time"] + shift, lat=p["lat"] + 0.027)
            for p in pts[k + 1:]]
    return pts[:k + 1] + stop + tail


def pair(cities, monkeypatch, prep="native", lag=inc.DEFAULT_LAG,
         mb=inc.DEFAULT_BUDGET_MB, prune=0.0, incremental=True):
    """(the JAX package's matcher, the port's), configured alike: the
    JAX package's knobs through its environment, the port's as
    arguments."""
    ref_city, city = cities
    monkeypatch.setenv(jinc.ENV_LAG, str(lag))
    monkeypatch.setenv(jinc.ENV_BUDGET_MB, str(mb))
    monkeypatch.setenv(jinc.ENV_INCREMENTAL, "on" if incremental else "off")
    if prune:
        monkeypatch.setenv(ENV_PRUNE, str(prune))
    else:
        monkeypatch.delenv(ENV_PRUNE, raising=False)
    native = prep == "native"
    return (JaxMatcher(net=ref_city, use_native=native),
            SegmentMatcher(city, device="cpu", native=native,
                           prune_sigma=prune, incremental=incremental,
                           incremental_lag=lag, incremental_mb=mb))


def stream(jm, m, pts, uuid, start=6, step=3, trim_every=0):
    """Feed growing (optionally prefix-trimmed) windows of ``pts`` to both
    packages' ``match_incremental``: both serve or both decline, and a
    served match is byte-equal to the JAX package's and to the port's
    ``match_many``. Returns (served, windows)."""
    served = windows = 0
    lo = 0
    for hi in range(start, len(pts) + 1, step):
        req = {"uuid": uuid, "trace": pts[lo:hi]}
        got = m.match_incremental([req])[0]
        want = jm.match_incremental([req])[0]
        windows += 1
        assert (got is None) == (want is None), \
            f"{uuid} [{lo}:{hi}]: port serves {got is not None}"
        if got is not None:
            served += 1
            body = json.dumps(got, sort_keys=True)
            assert body == jax_ser(want), f"{uuid} [{lo}:{hi}]"
            assert body == ser(m.match_many([req])[0]), f"{uuid} [{lo}:{hi}]"
        if trim_every and (hi // step) % trim_every == 0:
            lo = max(lo, hi - 3 * step)  # the batcher's prefix trim
    return served, windows


def assert_same_tables(jm, m):
    """Equal gauges (counters included) and byte-equal blobs."""
    assert m.incremental_table.gauge() == jm.incremental_table.gauge()
    assert dict(m.incremental_table.to_blobs()) == \
        dict(jm.incremental_table.to_blobs())


# -- the step ------------------------------------------------------------------
def step_inputs(N, K, seed):
    """Step rows with ties (a few distances, routes and scores repeat),
    NORMAL, RESTART and SKIP rows, routes at 1e9 and +inf, invalid
    candidates, on-edge points (em == -0.0) and scores holding -0.0."""
    rng = np.random.default_rng(seed)
    dist = rng.choice(np.array([0.0, 0.0, 1.0, 2.5, 5.5, 10.0, 40.0],
                               np.float32), (N, K))
    valid = rng.random((N, K)) > 0.2
    gc = rng.choice(np.array([0.0, 5.0, 10.0, 20.0], np.float32), N)
    route = (gc[:, None, None] + rng.choice(
        np.array([0.0, 0.0, 3.0, 6.0], np.float32), (N, K, K))
             ).astype(np.float32)
    route[rng.random(route.shape) < 0.1] = 1.0e9
    route[rng.random(route.shape) < 0.1] = np.inf
    case = rng.choice(np.array([NORMAL, RESTART, SKIP], np.int32), N)
    prev = rng.choice(np.array([-0.0, 0.0, -1.0, -2.0, -1.0e30],
                               np.float32), (N, K))
    return dist, valid, route, gc.astype(np.float32), case, prev


def plain_step(arrays):
    return [t.numpy() for t in ops.incremental_step_batch(
        *(torch.from_numpy(a) for a in arrays), SIGMA, BETA)]


def assert_bits_equal(got, want):
    scores, bp, prev_best = got
    assert np.array_equal(scores.view(np.int32),
                          np.asarray(want[0]).view(np.int32))
    assert np.array_equal(bp, np.asarray(want[1]))
    assert np.array_equal(prev_best, np.asarray(want[2]))


@pytest.mark.parametrize("K", [4, 8, 16])
@pytest.mark.parametrize("N", [1, 5, 64])
def test_plain_step_is_bit_equal_to_the_jax_step(N, K):
    signs = set()
    for seed in range(16):
        arrays = step_inputs(N, K, 1000 * N + K + seed)
        got = plain_step(arrays)
        assert_bits_equal(got, jax_step(*arrays, SIGMA, BETA))
        assert got[0].dtype == np.float32 and got[1].dtype == np.int32
        signs |= set(np.signbit(got[0][got[0] == 0]).tolist())
    # zeros of both signs reached the scores
    assert signs == {False, True}


@pytest.mark.parametrize("order", ["+0,-0", "-0,+0"])
def test_a_maximum_of_signed_zeros_keeps_the_later(order):
    """The JAX step's reduction keeps the later of equal values: a
    RESTART's max(prev) over (+0, -0) is -0, over (-0, +0) is +0."""
    prev = np.array([[0.0, -0.0]] if order == "+0,-0" else [[-0.0, 0.0]],
                    np.float32)
    arrays = (np.zeros((1, 2), np.float32), np.ones((1, 2), bool),
              np.full((1, 2, 2), 10.0, np.float32),
              np.array([10.0], np.float32), np.array([RESTART], np.int32),
              prev)
    got = plain_step(arrays)
    assert_bits_equal(got, jax_step(*arrays, SIGMA, BETA))
    assert bool(np.signbit(got[0][0, 0])) == (order == "+0,-0")


@pytest.mark.parametrize("N", [1, 5, 64])
def test_padded_rows_leave_the_real_rows_alone(N):
    """The JAX table pads rounds to a power of two of rows; the port
    does not. Rows filled as the JAX table fills its padding change
    nothing in the real rows."""
    K = 8
    arrays = step_inputs(N, K, 7 + N)
    rows = 1 << max(N - 1, 0).bit_length()
    pad = rows + 3 - N
    padded = tuple(np.concatenate([a, np.broadcast_to(fill, (pad,) + a.shape[1:])])
                   for a, fill in zip(arrays, (np.float32(1.0e9), False,
                                               np.float32(1.0e9),
                                               np.float32(0.0),
                                               np.int32(RESTART),
                                               np.float32(0.0))))
    got = plain_step(arrays)
    full = plain_step(padded)
    assert_bits_equal(got, [a[:N] for a in full])


def test_the_step_refuses_what_it_does_not_take():
    arrays = [torch.from_numpy(a) for a in step_inputs(4, 8, 3)]
    with pytest.raises(ValueError, match="CUDA"):
        ops.incremental_step_cuda(*arrays, SIGMA, BETA)
    with pytest.raises(ValueError, match="CPU path"):
        ops.incremental_step_batch(
            *arrays, SIGMA, BETA,
            out=torch.empty(ops.incremental.output_words(4, 8),
                            dtype=torch.int32))
    wide = [torch.from_numpy(a) for a in step_inputs(2, 129, 3)]
    with pytest.raises(ValueError, match="K=129"):
        ops.incremental_step_cuda(*wide, SIGMA, BETA)
    assert ops.incremental_step_cuda.launches == 0


# -- single-trace native lookups -------------------------------------------
@pytest.mark.parametrize("with_dt", [False, True])
@pytest.mark.parametrize("K", [4, 8, 16])
def test_native_lookups_equal_the_jax_package_and_numpy(cities, K, with_dt):
    ref_city, city = cities
    jm = JaxMatcher(net=ref_city, use_native=True)
    m = SegmentMatcher(city, device="cpu")
    pts = make_trace(city, 40 + K, noise=12.0)
    lat = np.array([p["lat"] for p in pts])
    lon = np.array([p["lon"] for p in pts])
    times = np.array([p["time"] for p in pts])
    got = m.runtime.candidates(lat, lon, K, 50.0)
    fields = ("edge_ids", "dist_m", "offset_m", "proj_x", "proj_y")
    for want in (jm.runtime.candidates(lat, lon, K, 50.0),
                 m.grid.candidates(lat, lon, K, 50.0)):
        for f in fields:
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
    gc = np.full(len(lat) - 1, 25.0, np.float32)
    kw = dict(backward_tolerance_m=25.0, turn_penalty_factor=10.0,
              max_route_time_factor=2.0 if with_dt else 0.0,
              dt=np.diff(times) if with_dt else None)
    route = m.runtime.route_matrices(got, gc, **kw)
    assert route.shape == (len(lat) - 1, K, K)
    assert (route < 1.0e9).any() and (route >= 1.0e9).any()
    assert np.array_equal(route.view(np.int32),
                          jm.runtime.route_matrices(got, gc, **kw)
                          .view(np.int32))
    # the numpy search sums a route's legs in another order than the C++
    # one (so do the JAX package's two): the same routes are reachable,
    # and their lengths agree to one f32 ulp
    numpy_route = candidate_route_matrices(city, got, gc, **kw)
    reach = route < 1.0e9
    assert np.array_equal(reach, numpy_route < 1.0e9)
    ulps = np.abs(route.view(np.int32)[reach].astype(np.int64)
                  - numpy_route.view(np.int32)[reach])
    assert ulps.max(initial=0) <= 1


# -- stream parity -------------------------------------------------------------
PREPS = ["native", "numpy"]


@pytest.mark.parametrize("prep", PREPS)
def test_noise_profiles_serve_byte_equal(cities, monkeypatch, prep):
    """Urban canyon (20 m noise), sparse rural (every third fix) and
    stop-and-go (a jitter cluster, then a breakage teleport)."""
    _ref_city, city = cities
    jm, m = pair(cities, monkeypatch, prep)
    rng = np.random.default_rng(7)
    served = stream(jm, m, make_trace(city, 100, noise=20.0), "canyon",
                    step=4)[0]
    served += stream(jm, m, make_trace(city, 200, noise=5.0)[::3], "rural",
                     start=4, step=2)[0]
    served += stream(jm, m, stop_and_go(make_trace(city, 300, noise=8.0),
                                        rng), "sg", step=4)[0]
    assert served > 20
    assert_same_tables(jm, m)


@pytest.mark.parametrize("prep", PREPS)
def test_pruned_candidates_serve_byte_equal(cities, monkeypatch, prep):
    """``prune_sigma`` > 0 (the JAX package's
    REPORTER_TPU_ROUTE_PRUNE_SIGMA): 20 m noise leaves candidates past
    the margin, which both prune before the step."""
    _ref_city, city = cities
    jm, m = pair(cities, monkeypatch, prep, prune=1.5)
    served = stream(jm, m, make_trace(city, 101, noise=20.0)[:45],
                    "pruned", step=4)[0]
    assert served > 5
    assert_same_tables(jm, m)


@pytest.mark.parametrize("prep", PREPS)
def test_prefix_trims_reset_and_stay_byte_equal(cities, monkeypatch, prep):
    _ref_city, city = cities
    jm, m = pair(cities, monkeypatch, prep)
    served, _ = stream(jm, m, make_trace(city, 42, noise=6.0), "trim",
                       trim_every=2)
    assert served > 0 and m.incremental_table.resets > 0
    assert_same_tables(jm, m)


@pytest.mark.parametrize("prep", PREPS)
def test_reports_inside_the_lag_window(cities, monkeypatch, prep):
    """A window inside the lag bound decodes from the ring alone: every
    window served, nothing committed."""
    _ref_city, city = cities
    jm, m = pair(cities, monkeypatch, prep, lag=64)
    served, windows = stream(jm, m, make_trace(city, 9)[:12], "short")
    assert served == windows
    table = m.incremental_table
    assert table.gauge()["traces"] == 1 and table.gauge()["lag"] == 64
    assert all(not st.c_kept for st in table._states.values())
    assert_same_tables(jm, m)


@pytest.mark.parametrize("prep", PREPS)
def test_lag_two_falls_back_where_the_jax_package_does(cities, monkeypatch,
                                                      prep):
    _ref_city, city = cities
    jm, m = pair(cities, monkeypatch, prep, lag=2)
    served, windows = stream(jm, m, make_trace(city, 17, noise=12.0),
                             "tight")
    assert m.incremental_table.fallbacks > 0 and served < windows
    assert m.incremental_table.gauge()["lag"] == 2
    assert_same_tables(jm, m)


@pytest.mark.parametrize("prep", PREPS)
def test_lag_is_floored_at_two(cities, monkeypatch, prep):
    jm, m = pair(cities, monkeypatch, prep, lag=0)
    assert m.incremental_table.gauge()["lag"] == \
        jm.incremental_table.gauge()["lag"] == 2


@pytest.mark.parametrize("prep", PREPS)
def test_eviction_under_a_tiny_budget(cities, monkeypatch, prep):
    """Two uuids in turns under a budget that holds one: each report
    evicts the other's state, which then replays from its window."""
    _ref_city, city = cities
    jm, m = pair(cities, monkeypatch, prep, mb=0.012)
    a, b = make_trace(city, 23, noise=6.0), make_trace(city, 24, noise=6.0)
    served = 0
    for hi in range(6, 31, 6):
        for uuid, pts in (("ev-a", a), ("ev-b", b)):
            reqs = [{"uuid": uuid, "trace": pts[:hi]}]
            got = m.match_incremental(reqs)[0]
            want = jm.match_incremental(reqs)[0]
            assert (got is None) == (want is None)
            if got is not None:
                served += 1
                assert json.dumps(got, sort_keys=True) == jax_ser(want)
                assert json.dumps(got, sort_keys=True) == \
                    ser(m.match_many(reqs)[0])
    assert served > 0 and m.incremental_table.evictions > 0
    assert m.incremental_table.gauge()["budget_bytes"] == int(0.012 * 2**20)
    assert_same_tables(jm, m)
    m.incremental_table.evict("ev-b", "test")
    jm.incremental_table.evict("ev-b", "test")
    assert_same_tables(jm, m)


@pytest.mark.parametrize("prep", PREPS)
def test_the_kill_switch_serves_nothing(cities, monkeypatch, prep):
    _ref_city, city = cities
    jm, m = pair(cities, monkeypatch, prep, incremental=False)
    reqs = [{"uuid": "k", "trace": make_trace(city, 5)}]
    assert m.match_incremental(reqs) == jm.match_incremental(reqs) == [None]
    assert m._incremental_table is None


def test_an_error_raises_and_drops_the_states_it_touched(cities):
    """A failure mid-call raises out of the table and drops the state of
    every trace the call reached, the failing one included; the matcher
    counts it on the ``match.incremental`` breaker and declines every
    slot of the call. The next report replays their windows byte-exact."""
    _ref_city, city = cities
    m = SegmentMatcher(city, device="cpu")
    a, b = make_trace(city, 23), make_trace(city, 24)

    def reqs(hi):
        return [{"uuid": "a", "trace": a[:hi]}, {"uuid": "b", "trace": b[:hi]}]

    assert None not in m.match_incremental(reqs(10))
    lookup = m.runtime.candidates
    calls = []

    def failing_second(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("lookup failed")
        return lookup(*args, **kw)

    m.runtime.candidates = failing_second
    failures = metrics.counter("matcher.circuit.incremental.failures")
    assert m.match_incremental(reqs(14)) == [None, None]
    assert metrics.counter("matcher.circuit.incremental.failures") \
        == failures + 1
    assert m.incremental_table.gauge()["traces"] == 0
    assert None not in m.match_incremental(reqs(10))
    calls.clear()
    with pytest.raises(RuntimeError, match="lookup failed"):
        m.incremental_table.match_many(
            TraceBatch.from_requests(reqs(14)), [m.params] * 2, [None] * 2)
    del m.runtime.candidates
    assert m.incremental_table.gauge()["traces"] == 0
    for got, req in zip(m.match_incremental(reqs(14)), reqs(14)):
        assert json.dumps(got, sort_keys=True) == ser(m.match_many([req])[0])


def test_a_window_past_the_largest_bucket_falls_back(cities, monkeypatch):
    """A first report whose window keeps more points than the largest
    bucket (1,024) falls back: the batch path truncates it. The JAX
    package counts only the steps of earlier reports against the bucket
    and serves such a window, with bytes that differ from its own batch
    path's; the port declines it."""
    _ref_city, city = cities
    jm, m = pair(cities, monkeypatch)
    pts, t_off, seed = [], 0.0, 0
    while len(pts) < 1500:
        seg = make_trace(city, 500 + seed, noise=5.0)
        base = seg[0]["time"]
        pts.extend(dict(p, time=p["time"] - base + t_off) for p in seg)
        t_off = pts[-1]["time"] + 5.0
        seed += 1
    req = {"uuid": "long", "trace": pts[:1500]}
    assert m.match_incremental([req]) == [None]
    assert m.incremental_table.fallbacks == 1
    want = jm.match_incremental([req])[0]
    assert want is not None
    assert jax_ser(want) != jax_ser(jm.match_many([req])[0])
    assert ser(m.match_many([req])[0]) == jax_ser(jm.match_many([req])[0])


def test_parameter_groups_advance_in_their_own_rounds(cities, monkeypatch):
    """Traces with other match_options step in rounds of their own, and
    every served slot of the mixed call is byte-equal."""
    _ref_city, city = cities
    jm, m = pair(cities, monkeypatch)
    traces = [make_trace(city, 60 + s, noise=5.0) for s in range(4)]
    opts = [dict(OPTS), dict(OPTS, sigma_z=6.0)]
    for hi in (8, 14, 20):
        reqs = [{"uuid": f"g{s}", "trace": pts[:hi],
                 "match_options": opts[s % 2]}
                for s, pts in enumerate(traces)]
        got = m.match_incremental(reqs)
        want = jm.match_incremental(reqs)
        batch = m.match_many(reqs)
        for g, w, b in zip(got, want, batch):
            assert (g is None) == (w is None)
            if g is not None:
                assert json.dumps(g, sort_keys=True) == jax_ser(w) == ser(b)
    rounds = m.incremental_table.rounds
    assert len(rounds) == 2 and sorted({k[0] for k in rounds}) == [4.07, 6.0]
    assert_same_tables(jm, m)


# -- serde ---------------------------------------------------------------------
def test_a_jax_blob_resumes_in_the_port_and_back(cities, monkeypatch):
    """Blobs cross the packages both ways mid-stream; each side resumes
    where the other stopped (no reset) and stays byte-exact."""
    ref_city, city = cities
    jm, m = pair(cities, monkeypatch)
    pts = make_trace(city, 55, noise=6.0)
    mid = max(9, (len(pts) // 2) // 3 * 3)
    assert stream(jm, m, pts[:mid], "crash")[0] > 0
    # the JAX package's blob into a fresh port matcher, and the reverse
    jm2, m2 = pair(cities, monkeypatch)
    assert m2.incremental_table.restore_blobs(
        jm.incremental_table.to_blobs()) == 1
    assert jm2.incremental_table.restore_blobs(
        m.incremental_table.to_blobs()) == 1
    assert stream(jm2, m2, pts, "crash", start=mid, step=3)[0] > 0
    assert m2.incremental_table.resets == jm2.incremental_table.resets == 0
    assert_same_tables(jm2, m2)


def test_blobs_carry_the_graph_version_and_a_new_graph_resets(
        cities, monkeypatch):
    ref_city, city = cities
    jm, m = pair(cities, monkeypatch)
    pts = make_trace(city, 78, noise=5.0)
    mid = max(9, (len(pts) // 2) // 3 * 3)
    stream(jm, m, pts[:mid], "swap")
    table = m.incremental_table
    assert table.map_version == jm.incremental_table.map_version
    blobs = table.to_blobs()
    assert inc.CarriedState.from_bytes(blobs[0][1]).map_version == \
        table.map_version
    bare = inc.CarriedState((1.0, 2.0), False, 4)
    assert bare.to_bytes() == jinc.CarriedState((1.0, 2.0), False,
                                                4).to_bytes()
    assert inc.CarriedState.from_bytes(bare.to_bytes()).map_version is None

    city2 = build_grid_city(**CITY)
    city2.edge_speed_kph = city2.edge_speed_kph * 1.3
    m2 = SegmentMatcher(city2, device="cpu")
    t2 = m2.incremental_table
    assert t2.map_version != table.map_version
    assert t2.restore_blobs(blobs) == len(blobs)
    served = 0
    for hi in range(mid, len(pts) + 1, 3):
        req = {"uuid": "swap", "trace": pts[:hi]}
        got = m2.match_incremental([req])[0]
        if got is not None:
            served += 1
            assert json.dumps(got, sort_keys=True) == \
                ser(m2.match_many([req])[0])
    assert served > 0 and t2.resets == 1


def test_a_corrupt_blob_is_skipped(cities, monkeypatch):
    jm, m = pair(cities, monkeypatch)
    bad = [("bad", b"\x00\x01garbage")]
    assert m.incremental_table.restore_blobs(bad) == \
        jm.incremental_table.restore_blobs(bad) == 0
    assert_same_tables(jm, m)


# -- the service ---------------------------------------------------------------
def test_report_incremental_answers_each_slot_as_report_many(cities):
    """Served and declined slots in one call (no uuid; lag windows that
    do not converge under lag 4), each equal to ``report_many``'s."""
    _ref_city, city = cities
    service = ReporterService(SegmentMatcher(city, device="cpu",
                                             incremental_lag=4))
    plain = ReporterService(SegmentMatcher(city, device="cpu",
                                           incremental=False))
    traces = [make_trace(city, 80 + s, noise=6.0) for s in range(4)]
    try:
        for hi in (8, 12, 16):
            reqs = [{"uuid": None if s == 0 else f"r{s}",
                     "trace": pts[:hi], "match_options": OPTS}
                    for s, pts in enumerate(traces)]
            served = [mt is not None
                      for mt in service.matcher.match_incremental(reqs)]
            assert not served[0] and set(served[1:]) == {False, True}
            got = service.report_incremental(reqs)
            assert got == plain.report_many(reqs)
            assert all(g is not None for g in got)
        health = json.loads(service.health()[1])["incremental"]
        assert health == {"enabled": True,
                          **service.matcher.incremental_table.gauge()}
        assert health["fallbacks"] > 0 and health["traces"] > 0
        assert json.loads(plain.health()[1])["incremental"] == \
            {"enabled": False}
    finally:
        service.dispatcher.close()
        plain.dispatcher.close()
