"""The port's /report match path against the JAX package's, end to end.

On the report-parity fixture's city, built by each package's own
``build_grid_city``, each prep path of the JAX package's matcher and the
port's ``SegmentMatcher(device="cpu")`` give equal match dicts and
byte-equal ``/report`` bodies: numpy prep (``use_native=False`` against
``native=False``) and the native host runtime (the reference's default
against the port's). The port's two paths, and its pipelined and inline
runs, give the same bytes. Tolerance: exact.
"""
import copy
import json
import os

import numpy as np
import pytest

from reporter_tpu.matcher import MatchParams as JaxParams
from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.service.report import report as jax_report
from reporter_tpu.service.report import report_json as jax_report_json
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu.synth import generate_trace as jax_trace
from reporter_tpu_torch import ops
from reporter_tpu_torch.graph.network import COLUMNS, network_from_arrays
from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
from reporter_tpu_torch.service.report import report, report_json
from reporter_tpu_torch.synth import build_grid_city, generate_trace

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "report_parity.json")

LEVELS = [
    (15, {0, 1, 2}, {0, 1, 2}),
    (15, {0, 1}, {0, 1, 2}),
    (15, {0, 1, 2}, {0}),
    (3600, {0, 1, 2}, {0, 1, 2}),
]


@pytest.fixture(scope="module")
def fixture():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cities(fixture):
    return jax_city(**fixture["city"]), build_grid_city(**fixture["city"])


@pytest.fixture(scope="module", params=["numpy", "native"])
def matchers(cities, request):
    """(the JAX package's matcher, the port's) on one prep path."""
    ref_city, city = cities
    native = request.param == "native"
    return (JaxMatcher(net=ref_city, params=JaxParams(max_candidates=8),
                       use_native=native),
            SegmentMatcher(city, MatchParams(max_candidates=8), device="cpu",
                           native=native))


@pytest.fixture(scope="module")
def mixed_requests(fixture, cities):
    """The fixture's requests plus short traces from the same seeded
    numpy stream through each package's synth: T=16 and T=64 buckets
    (and the fixture's one T=256 trace) in one call."""
    ref_city, city = cities
    reqs = list(fixture["requests"])
    rng_ref, rng = np.random.default_rng(11), np.random.default_rng(11)
    while len(reqs) < len(fixture["requests"]) + 6:
        tr_ref = jax_trace(ref_city, f"short-{len(reqs)}", rng_ref)
        tr = generate_trace(city, f"short-{len(reqs)}", rng)
        assert (tr_ref is None) == (tr is None)
        if tr is None:
            continue
        assert tr.points == tr_ref.points
        req = tr.request_json(report_levels=(0, 1, 2),
                              transition_levels=(0, 1, 2))
        req["trace"] = tr.points[:12]
        reqs.append(req)
    return reqs


def _ref_columns(net) -> dict:
    seg_ids = np.array(sorted(net.segment_length_m), dtype=np.int64)
    cols = {name: getattr(net, name) for name in COLUMNS}
    cols.update(seg_ids=seg_ids,
                seg_lens=np.array([net.segment_length_m[s] for s in seg_ids],
                                  dtype=np.float32))
    return cols


def test_reference_city_carries_across(cities, tmp_path):
    ref_city, city = cities
    carried = network_from_arrays(_ref_columns(ref_city))
    ref_city.save(str(tmp_path / "city.npz"))
    loaded = type(city).load(str(tmp_path / "city.npz"))
    for net in (carried, loaded):
        for name in COLUMNS:
            got, want = getattr(net, name), getattr(city, name)
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        assert net.segment_length_m == city.segment_length_m


def test_match_dicts_equal(matchers, mixed_requests):
    ref, port = matchers
    buckets = {p.T for p in port.prepare_many(mixed_requests)}
    assert {16, 64} <= buckets
    # the reference's MatchRuns compares equal to dicts, not to the
    # port's MatchRuns: compare each port match with the reference's dict
    want = [dict(m) for m in ref.match_many(mixed_requests)]
    got = port.match_many(mixed_requests)
    assert got == want
    assert sum(len(m["segments"]) for m in got) > 0


def test_report_bodies_byte_equal(matchers, mixed_requests):
    ref, port = matchers
    want = ref.match_many(mixed_requests)
    got = port.match_many(mixed_requests)
    checked = 0
    for req, m_ref, m in zip(mixed_requests, want, got):
        for threshold, rep, trans in LEVELS:
            body_ref = jax_report_json(m_ref, req, threshold, rep, trans)
            assert report_json(m, req, threshold, rep, trans) == body_ref
            if isinstance(m, dict):  # the dict report() of the numpy path
                body = json.dumps(report(copy.deepcopy(m), req, threshold,
                                         rep, trans), separators=(",", ":"))
                assert body == json.dumps(
                    jax_report(copy.deepcopy(m_ref), req, threshold, rep,
                               trans), separators=(",", ":")) == body_ref
            checked += 1
    assert checked == len(mixed_requests) * len(LEVELS)


def _bodies(matches, reqs):
    return [report_json(m, req, threshold, rep, trans)
            for m, req in zip(matches, reqs)
            for threshold, rep, trans in LEVELS]


def test_native_and_numpy_bodies_byte_equal(cities, mixed_requests):
    city = cities[1]
    got = [_bodies(SegmentMatcher(city, device="cpu", native=native)
                   .match_many(mixed_requests), mixed_requests)
           for native in (True, False)]
    assert got[0] == got[1]
    assert len(got[0]) == len(mixed_requests) * len(LEVELS)


def test_pipelined_and_inline_bodies_byte_equal(cities, mixed_requests):
    city = cities[1]
    runs = []
    for pipeline in (True, False):
        m = SegmentMatcher(city, device="cpu", pipeline=pipeline, chunk=4)
        runs.append(_bodies(m.match_many(mixed_requests), mixed_requests))
        assert all(v > 0 for v in m.stage_seconds.values())
    assert runs[0] == runs[1]


@pytest.mark.parametrize("prep_threads", [1, 3])
def test_prep_threads_give_the_same_bytes(cities, mixed_requests,
                                          prep_threads):
    city = cities[1]
    runs = [_bodies(SegmentMatcher(city, device="cpu", prep_threads=n)
                    .match_many(mixed_requests), mixed_requests)
            for n in (None, prep_threads)]
    assert runs[0] == runs[1]


def test_match_json_equals_reference(matchers, fixture):
    ref, port = matchers
    for req in fixture["requests"][:3]:
        assert port.Match(json.dumps(req)) == ref.Match(json.dumps(req))


def test_cpu_matcher_never_launches_the_kernel(matchers, fixture):
    _, port = matchers
    before = ops.viterbi_cuda.launches
    port.match_many(fixture["requests"][:2])
    assert ops.viterbi_cuda.launches == before
