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
from reporter_tpu.utils import metrics as jax_metrics
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
    # the one round is the multi-round kernel's, whose wrapper counts
    assert ops.incremental_steps_cuda.launches == 0


@pytest.mark.parametrize("K", [4, 8, 16])
@pytest.mark.parametrize("N,R", [(1, 1), (1, 5), (7, 4), (64, 6)])
def test_rounds_equal_successive_single_steps(N, K, R):
    """R rounds in one call, each row for its own number of rounds, give
    the bits of R successive single steps with the scores carried; a
    row's rounds past its count are zeros. Ragged counts, RESTART and
    SKIP rounds, signed zeros and ties included."""
    rng = np.random.default_rng(100 * N + 10 * K + R)
    rounds = [step_inputs(N, K, 7_000 + 97 * r + N + K) for r in range(R)]
    stacked = [np.stack([rd[k] for rd in rounds]) for k in range(5)]
    prev = rounds[0][5]
    n_steps = rng.integers(0, R + 1, N).astype(np.int32)
    n_steps[0] = R
    got = [t.numpy() for t in ops.incremental_steps(
        *(torch.from_numpy(a) for a in stacked), torch.from_numpy(prev),
        torch.from_numpy(n_steps), SIGMA, BETA)]
    assert got[0].shape == (R, N, K) and got[1].dtype == np.int32 \
        and got[2].shape == (R, N)
    p = prev
    signs = set()
    for r in range(R):
        want = plain_step((*(a[r] for a in stacked), p))
        live = n_steps > r
        for g, w in zip(got, want):
            assert np.array_equal(
                g[r][live].view(np.int32),
                np.asarray(w)[live].view(np.int32)), f"round {r}"
            assert not g[r][~live].view(np.int32).any(), f"round {r}"
        assert_bits_equal([g[r][live] for g in got],
                          jax_step(*(a[r][live] for a in stacked), p[live],
                                   SIGMA, BETA))
        signs |= set(np.signbit(got[0][r][live][got[0][r][live] == 0])
                     .tolist())
        p = want[0]
    if N >= 64:  # enough rows for every kind
        assert signs == {False, True}
        assert (stacked[4] == RESTART).any() and (stacked[4] == SKIP).any()


def test_step_counts_outside_the_rounds_clamp_to_them():
    """A row's step count is read clamped to 0..R: a count past R runs
    all R rounds, a negative one none (the kernel reads it the same
    way, so it never loads past the (R, N, ...) operands)."""
    R, N, K = 3, 6, 8
    rounds = [step_inputs(N, K, 40 + r) for r in range(R)]
    x = [torch.from_numpy(np.stack([rd[k] for rd in rounds]))
         for k in range(5)]
    prev = torch.from_numpy(rounds[0][5])
    wild = torch.tensor([R + 5, -2, R, 0, 2**30, -(2**30)],
                        dtype=torch.int32)
    tame = wild.clamp(0, R)
    for g, w in zip(ops.incremental_steps(*x, prev, wild, SIGMA, BETA),
                    ops.incremental_steps(*x, prev, tame, SIGMA, BETA)):
        assert np.array_equal(g.numpy().view(np.int32),
                              w.numpy().view(np.int32))


def test_the_rounds_refuse_what_they_do_not_take():
    x = [torch.from_numpy(np.stack([a] * 2))
         for a in step_inputs(4, 8, 3)[:5]]
    prev = torch.zeros((4, 8))
    n_steps = torch.full((4,), 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.incremental_steps_cuda(*x, prev, n_steps, SIGMA, BETA)
    with pytest.raises(ValueError, match="CPU path"):
        ops.incremental_steps(*x, prev, n_steps, SIGMA, BETA,
                              out=torch.empty(ops.incremental.output_words(
                                  4, 8, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(R, N, K\)"):
        ops.incremental_steps_cuda(*(t[0] for t in x), prev, n_steps,
                                   SIGMA, BETA)
    assert ops.incremental_steps_cuda.launches == 0


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


INC_COUNTERS = ("match.incremental.steps", "match.incremental.commits",
                "match.incremental.fallbacks", "match.incremental.matches")


def _counting_jax_rounds(monkeypatch, jm):
    """Count the JAX table's device rounds by (sigma, beta, K), as the
    port's ``IncrementalTable.rounds`` counts its replayed rounds."""
    table = jm.incremental_table
    rounds: dict = {}
    step = table._round

    def counted(grp, r, K, sigma, beta, kernel, lag):
        key = (float(sigma), float(beta), int(K))
        rounds[key] = rounds.get(key, 0) + 1
        return step(grp, r, K, sigma, beta, kernel, lag)

    monkeypatch.setattr(table, "_round", counted)
    return rounds


def test_rounds_of_a_call_replay_as_the_jax_package(cities, monkeypatch):
    """Eight points appended a call, so each call's rounds of a group run
    in one device call and replay on the host; a lag of 8 makes windows
    fall back in the middle of a call's rounds while the other traces
    step on. Bodies, blobs and the counters (steps, rounds, commits,
    fallbacks, matches) equal the JAX package's, which steps a round at a
    time."""
    _ref_city, city = cities
    jm, m = pair(cities, monkeypatch, lag=8)
    jax_rounds = _counting_jax_rounds(monkeypatch, jm)
    traces = [make_trace(city, 300 + s, noise=6.0) for s in range(5)]
    opts = [dict(OPTS), dict(OPTS, sigma_z=6.0)]
    table = m.incremental_table
    replay = table._replay
    late_fallbacks = []

    def watched(grp, r, ran):
        alive = [job[5] for job in grp]
        replay(grp, r, ran)
        if r > 0 and any(a and not job[5] for a, job in zip(alive, grp)):
            late_fallbacks.append(r)

    monkeypatch.setattr(table, "_replay", watched)
    j0 = [jax_metrics.counter(n) for n in INC_COUNTERS]
    p0 = [metrics.counter(n) for n in INC_COUNTERS]
    served = 0
    for hi in range(8, 41, 8):
        reqs = [{"uuid": f"mc{s}", "trace": pts[:hi],
                 "match_options": opts[s % 2]}
                for s, pts in enumerate(traces)]
        got = m.match_incremental(reqs)
        want = jm.match_incremental(reqs)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                served += 1
                assert json.dumps(g, sort_keys=True) == jax_ser(w)
    assert served > 0
    assert [metrics.counter(n) - c for n, c in zip(INC_COUNTERS, p0)] == \
        [jax_metrics.counter(n) - c for n, c in zip(INC_COUNTERS, j0)]
    assert table.rounds == jax_rounds and len(jax_rounds) == 2
    assert table.fallbacks > 0
    assert late_fallbacks, "no window fell back after a call's first round"
    assert_same_tables(jm, m)


@pytest.mark.parametrize("slab_rounds", [1, 3])
def test_ragged_first_reports_run_in_bounded_slabs(cities, monkeypatch,
                                                   slab_rounds):
    """One call of first reports of 6 to 120 points in one parameter
    group: with a slab of ``slab_rounds`` rounds of all its rows, every
    launch's padded operands and outputs stay within ``SLAB_BYTES``, a
    slab takes only the rows still stepping, the scores carry from slab
    to slab, and bodies, blobs and counters equal the JAX package's,
    which steps a round at a time."""
    _ref_city, city = cities
    jm, m = pair(cities, monkeypatch, lag=8)
    jax_rounds = _counting_jax_rounds(monkeypatch, jm)
    lengths = [6, 120, 16, 6, 40, 16]
    traces = [make_trace(city, 400 + s, noise=5.0) for s in range(6)]
    K = m.params.max_candidates
    monkeypatch.setattr(inc, "SLAB_BYTES",
                        slab_rounds * len(lengths) * inc.slab_row_bytes(K))
    table = m.incremental_table
    launch = table._launch
    slabs = []

    def counted(arrays, sigma, beta):
        R, n = arrays[0].shape[:2]
        assert R * n * inc.slab_row_bytes(K) <= inc.SLAB_BYTES or R == 1
        assert (arrays[6] > 0).all()  # only the rows still stepping
        slabs.append((R, n))
        return launch(arrays, sigma, beta)

    monkeypatch.setattr(table, "_launch", counted)
    j0 = [jax_metrics.counter(n) for n in INC_COUNTERS]
    p0 = [metrics.counter(n) for n in INC_COUNTERS]
    for grow in (0, 4):
        reqs = [{"uuid": f"rg{s}", "trace": pts[:hi + grow]}
                for s, (pts, hi) in enumerate(zip(traces, lengths))]
        got = m.match_incremental(reqs)
        want = jm.match_incremental(reqs)
        assert [g is None for g in got] == [w is None for w in want]
        for g, w in zip(got, want):
            if g is not None:
                assert json.dumps(g, sort_keys=True) == jax_ser(w)
    assert [metrics.counter(n) - c for n, c in zip(INC_COUNTERS, p0)] == \
        [jax_metrics.counter(n) - c for n, c in zip(INC_COUNTERS, j0)]
    assert table.rounds == jax_rounds
    assert len(slabs) > 2 and min(n for _R, n in slabs) < len(lengths)
    assert_same_tables(jm, m)


@pytest.mark.parametrize("seed,windows", [(18, (6, 14, 22)),
                                          (19, (5, 15, 30))])
def test_a_uuid_twice_in_a_call_steps_as_the_jax_package(
        cities, monkeypatch, seed, windows):
    """Two windows of one uuid in one call share one carried state, and
    each of its rows starts a round from what the round before left in
    it: the call steps one round a device call, as the JAX package does,
    and its fallbacks, counters and declines equal the JAX package's (one
    device call for all rounds would carry each row's own scores and fall
    back elsewhere)."""
    _ref_city, city = cities
    jm, m = pair(cities, monkeypatch, lag=4)
    jax_rounds = _counting_jax_rounds(monkeypatch, jm)
    pts = make_trace(city, seed, noise=12.0)
    first, a, b = windows
    j0 = [jax_metrics.counter(n) for n in INC_COUNTERS]
    p0 = [metrics.counter(n) for n in INC_COUNTERS]
    for reqs in ([{"uuid": "u", "trace": pts[:first]}],
                 [{"uuid": "u", "trace": pts[:a]},
                  {"uuid": "u", "trace": pts[:b]}]):
        got = m.match_incremental(reqs)
        want = jm.match_incremental(reqs)
        assert [g is None for g in got] == [w is None for w in want]
        for g, w in zip(got, want):
            if g is not None:
                assert json.dumps(g, sort_keys=True) == jax_ser(w)
    assert [metrics.counter(n) - c for n, c in zip(INC_COUNTERS, p0)] == \
        [jax_metrics.counter(n) - c for n, c in zip(INC_COUNTERS, j0)]
    assert m.incremental_table.rounds == jax_rounds
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


# -- with the streaming worker's batcher and state -----------------------------
def test_session_gap_eviction_drops_carried_state(cities, monkeypatch):
    """The batcher's session-gap eviction (punctuate) rides the on_evict
    hook in both packages: the uuid's carried decode state dies with the
    session, after its final relaxed-threshold report."""
    from reporter_tpu.core.types import Point as JaxPoint
    from reporter_tpu.streaming.batcher import PointBatcher as JaxBatcher
    from reporter_tpu_torch.core.types import Point
    from reporter_tpu_torch.streaming.batcher import PointBatcher
    _ref_city, city = cities
    jm, m = pair(cities, monkeypatch)
    pts = make_trace(city, 31)
    for matcher, P, cls in ((jm, JaxPoint, JaxBatcher),
                            (m, Point, PointBatcher)):
        assert matcher.match_incremental(
            [{"uuid": "veh", "trace": pts}])[0] is not None
        assert matcher.incremental_table.gauge()["traces"] == 1
        evicted = []

        def on_evict(uuid, _m=matcher):
            _m.incremental_table.evict(uuid, "session gap")
            evicted.append(uuid)

        pb = cls(lambda t: None, lambda k, s: None, on_evict=on_evict)
        pb.process("veh", P(14.6, 121.0, 10, 0), stream_time_ms=0)
        pb.punctuate(stream_time_ms=200_000)  # past the 60 s gap
        assert evicted == ["veh"]
    assert_same_tables(jm, m)
    assert m.incremental_table.gauge()["traces"] == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_snapshot_v3_carries_frames(cities, monkeypatch, tmp_path,
                                          writer):
    """StateStore.save tees the carried state into the v3 snapshot and
    restore hands it back through the provider, across the packages:
    a snapshot either one saved restores its frames in the other, and
    both resume the stream byte-equal."""
    from reporter_tpu.streaming import anonymiser as jax_anon
    from reporter_tpu.streaming import batcher as jax_batcher
    from reporter_tpu.streaming import state as jax_state
    from reporter_tpu_torch.streaming import anonymiser, batcher, state
    _ref_city, city = cities
    jm, m = pair(cities, monkeypatch)
    pts = make_trace(city, 71)
    mid = max(9, (len(pts) // 2) // 3 * 3)
    assert stream(jm, m, pts[:mid], "snap")[0] > 0
    packages = {"jax": (jm, jax_anon, jax_batcher, jax_state),
                "port": (m, anonymiser, batcher, state)}
    src_m, src_anon, src_batcher, src_state = packages[writer]
    path = str(tmp_path / "state.bin")
    src_state.StateStore(path, incremental=lambda: src_m.incremental_table
                         ).save(src_batcher.PointBatcher(lambda t: None,
                                                         lambda k, s: None),
                                src_anon.Anonymiser(src_anon.TileSink(
                                    str(tmp_path / "t")), 2, 60))
    jm2, m2 = pair(cities, monkeypatch)
    for matcher, name in ((jm2, "jax"), (m2, "port")):
        _m, anon, bat, st = packages[name]
        pb = bat.PointBatcher(lambda t: None, lambda k, s: None)
        assert st.StateStore(path, incremental=lambda _x=matcher:
                             _x.incremental_table).restore(
            pb, anon.Anonymiser(anon.TileSink(str(tmp_path / "t")), 2, 60))
        assert matcher.incremental_table.gauge()["traces"] == 1
    assert stream(jm2, m2, pts, "snap", start=mid, step=3)[0] > 0
    assert m2.incremental_table.resets == jm2.incremental_table.resets == 0
    assert_same_tables(jm2, m2)


def test_v2_snapshot_still_restores(tmp_path):
    """A pre-incremental (v2) snapshot restores batches and slices in
    both packages: the missing section is an empty cache, not
    corruption."""
    import struct
    from reporter_tpu.streaming import anonymiser as jax_anon
    from reporter_tpu.streaming import batcher as jax_batcher
    from reporter_tpu.streaming import state as jax_state
    from reporter_tpu_torch.core.types import Point
    from reporter_tpu_torch.streaming import anonymiser, batcher, state
    pb = batcher.PointBatcher(lambda t: None, lambda k, s: None)
    pb.process("veh", Point(14.6, 121.0, 10, 0), stream_time_ms=0)
    anon = anonymiser.Anonymiser(anonymiser.TileSink(str(tmp_path / "t")),
                                 2, 60)
    raw = bytearray(state.snapshot_bytes(pb, anon))
    # the header's version rewritten to 2, the (empty) incremental
    # section's count dropped
    struct.pack_into("<I", raw, 4, 2)
    path = tmp_path / "state.bin"
    path.write_bytes(bytes(raw[:-4]))
    for anon_mod, bat_mod, st_mod in ((anonymiser, batcher, state),
                                      (jax_anon, jax_batcher, jax_state)):
        pb2 = bat_mod.PointBatcher(lambda t: None, lambda k, s: None)
        assert st_mod.StateStore(str(path)).restore(
            pb2, anon_mod.Anonymiser(anon_mod.TileSink(str(tmp_path / "t")),
                                     2, 60))
        assert list(pb2.store) == ["veh"]
