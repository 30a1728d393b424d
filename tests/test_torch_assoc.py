"""The port's associative-scan decode against the JAX package's.

The same inputs, made from a seeded numpy stream, go through the JAX
``ops.viterbi_assoc_batch`` and the port's ``ops.viterbi_assoc_batch`` on
the CPU: paths and scores bit-equal (score bits compared as int32, so
signed zeros count) on prepared traces of a synthetic city, RESTART and
SKIP steps, both route layouts (T-1 and T time rows), the f16 wire, T of
1, 2, 3, 64 and 65, and exact ties. Against the port's sequential scan
each path agrees in quality: an f64 re-score within ``abs=1e-2`` (the
contract of the JAX package's own ``tests/test_parallel.py``).

Through the matcher, ``SegmentMatcher(decode="assoc")`` gives ``/report``
bodies byte-equal to the JAX matcher with ``REPORTER_TPU_DECODE=assoc``,
and equal to ``decode="fused"`` except on traces whose two paths tie by
the re-score. Also: the decode key through ``parse_config``, unknown
names, the shadow's verdict and the profiler's shape key.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reporter_tpu import ops as jax_ops
from reporter_tpu.matcher import MatchParams as JaxParams
from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.matcher.batchpad import pack_batches as jax_pack
from reporter_tpu.matcher.batchpad import prepare_trace as jax_prepare
from reporter_tpu.ops import assoc_viterbi as jax_assoc
from reporter_tpu.parallel import mesh as jax_mesh
from reporter_tpu.service.report import report_json as jax_report_json
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu.synth import generate_trace as jax_trace
from reporter_tpu_torch import ops
from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
from reporter_tpu_torch.matcher.batchpad import pack_batches
from reporter_tpu_torch.matcher.hmm import (NORMAL, RESTART, SKIP,
                                            viterbi_decode_batch)
from reporter_tpu_torch.obs import profiler
from reporter_tpu_torch.ops import assoc_viterbi
from reporter_tpu_torch.service import server
from reporter_tpu_torch.service.report import report_json
from reporter_tpu_torch.synth import build_grid_city, generate_trace

SIGMA, BETA = 4.07, 3.0
#: the f64 re-score tolerance of the JAX package's test_parallel.py
TOL = 1e-2
LEVELS = [(15, {0, 1, 2}, {0, 1, 2}), (3600, {0, 1}, {0, 1, 2})]


def _jax(args):
    p, s = jax_assoc.viterbi_assoc_batch(*args, np.float32(SIGMA),
                                         np.float32(BETA))
    return np.asarray(p), np.asarray(s)


def _port(args):
    p, s = assoc_viterbi.viterbi_assoc_batch(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args),
        SIGMA, BETA)
    return p.numpy(), s.numpy()


def _assert_bit_equal(args):
    (pj, sj), (pt, st) = _jax(args), _port(args)
    assert pt.dtype == np.int32 and st.dtype == np.float32
    assert torch.equal(torch.from_numpy(pt), torch.from_numpy(pj.copy()))
    np.testing.assert_array_equal(st.view(np.int32), sj.view(np.int32))
    return pt


def rescore_f64(dist, route, gc, case, path, sigma=SIGMA, beta=BETA):
    """One decoded path's total log-score in float64 numpy, independent of
    either decode's order of accumulation (kept points only; a RESTART
    adds no transition; an unroutable step, which a random input may
    force on every path, costs a fixed 1e9)."""
    total = 0.0
    for t in range(len(case)):
        if case[t] == SKIP:
            continue
        k = int(path[t])
        total += -0.5 * (float(dist[t, k]) / sigma) ** 2
        if t > 0 and case[t] == NORMAL:
            r = float(route[t - 1, int(path[t - 1]), k])
            total += (-abs(r - float(gc[t - 1])) / beta if r < 0.5e9
                      else -1e9)
    return total


def _assert_quality_equal(args, got):
    """Each path of ``got`` re-scores within TOL of the port's scan's;
    returns how many rows differ from the scan (ties)."""
    dist, valid, route, gc, case = args
    want, _ = viterbi_decode_batch(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args),
        SIGMA, BETA)
    want = want.numpy()
    for b in range(len(case)):
        s_scan = rescore_f64(dist[b], route[b], gc[b], case[b], want[b])
        s_assoc = rescore_f64(dist[b], route[b], gc[b], case[b], got[b])
        assert s_assoc == pytest.approx(s_scan, abs=TOL), f"trace {b}"
    return int((want != got).any(axis=1).sum())


def random_inputs(B, T, K, seed, f16=False, route_rows=None, ties=False):
    """Seeded decode inputs with RESTART and SKIP steps, masked candidates
    and unreachable routes; ``ties`` rounds the distances to whole
    meters so exact score ties are common."""
    rng = np.random.default_rng(seed)
    Tr = T - 1 if route_rows is None else route_rows
    dist = rng.uniform(0, 30, (B, T, K)).astype(np.float32)
    route = rng.uniform(5, 80, (B, Tr, K, K)).astype(np.float32)
    gc = rng.uniform(5, 40, (B, Tr)).astype(np.float32)
    if ties:
        dist, route, gc = np.round(dist), np.round(route), np.round(gc)
    valid = rng.random((B, T, K)) > 0.2
    valid[:, :, 0] = True
    route[rng.random(route.shape) < 0.1] = np.inf if f16 else 1.0e9
    case = rng.choice([NORMAL] * 6 + [RESTART, SKIP], (B, T)).astype(np.int32)
    case[:, 0] = RESTART
    if f16:
        dist, route, gc = (a.astype(np.float16) for a in (dist, route, gc))
    return dist, valid, route, gc, case


# ---- the decode ------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 2, 3, 64, 65])
@pytest.mark.parametrize("wire", ["f32", "f16"])
@pytest.mark.parametrize("route_rows", ["T-1", "T"])
def test_bit_equal_to_jax(T, wire, route_rows):
    args = random_inputs(8, T, 8, seed=T, f16=wire == "f16",
                         route_rows=T if route_rows == "T" else None)
    got = _assert_bit_equal(args)
    trimmed = args[:2] + (args[2][:, :T - 1], args[3][:, :T - 1], args[4])
    _assert_quality_equal(trimmed, got)


@pytest.mark.parametrize("B,T,K", [(16, 37, 8), (4, 256, 8), (5, 17, 16),
                                   (3, 9, 1)])
def test_bit_equal_with_ties(B, T, K):
    args = random_inputs(B, T, K, seed=B * T + K, ties=True)
    got = _assert_bit_equal(args)
    _assert_quality_equal(args, got)


def test_all_tied_candidates_break_to_the_lowest_index():
    """torch.argmax returns the first maximal index, as jnp.argmax does."""
    B, T, K = 2, 7, 4
    dist = np.full((B, T, K), 3.0, np.float32)
    valid = np.ones((B, T, K), bool)
    route = np.full((B, T - 1, K, K), 12.0, np.float32)
    gc = np.full((B, T - 1), 12.0, np.float32)
    case = np.full((B, T), NORMAL, np.int32)
    case[:, 0] = RESTART
    case[1, 3] = RESTART
    paths = _assert_bit_equal((dist, valid, route, gc, case))
    assert (paths == 0).all()


def test_signed_zeros_bit_equal():
    """Zero distances and zero route deviations make -0.0 entries; the
    JAX scan's interleave adds its zero pads, and so does the port's."""
    B, T, K = 2, 9, 3
    dist = np.zeros((B, T, K), np.float32)
    valid = np.ones((B, T, K), bool)
    route = np.full((B, T - 1, K, K), 10.0, np.float32)
    gc = np.full((B, T - 1), 10.0, np.float32)
    case = np.full((B, T), NORMAL, np.int32)
    case[:, 0] = RESTART
    _assert_bit_equal((dist, valid, route, gc, case))


@pytest.fixture(scope="module")
def prepared_batch():
    """Traces prepared as the JAX package's test_parallel.py prepares them
    (its city, seed and noise), packed into one batch."""
    city = jax_city(rows=10, cols=10, spacing_m=200.0, seed=6,
                    service_road_fraction=0.0, internal_fraction=0.0)
    m = JaxMatcher(net=city)
    rng = np.random.default_rng(0)
    prepared = []
    for i in range(8):
        tr = None
        while tr is None:
            tr = jax_trace(city, f"v{i}", rng, noise_m=4.0,
                           min_route_edges=8, max_route_edges=14)
        prepared.append(jax_prepare(city, m.grid, tr.points, JaxParams(),
                                    m.route_cache))
    batches = jax_pack(prepared)
    assert len(batches) == 1
    b = batches[0]
    return b.dist_m, b.valid, b.route_m, b.gc_m, b.case


def test_prepared_traces_bit_equal_and_as_good_as_the_scan(prepared_batch):
    got = _assert_bit_equal(prepared_batch)
    as_f32 = tuple(a.astype(np.float32) if a.dtype == np.float16 else a
                   for a in prepared_batch)
    _assert_quality_equal(as_f32, got)


def test_step_matrices_and_maxplus_bit_equal():
    rng = np.random.default_rng(5)
    em = rng.normal(size=(3, 11, 6)).astype(np.float32)
    tr = rng.normal(size=(3, 10, 6, 6)).astype(np.float32)
    got = assoc_viterbi.step_matrices(torch.from_numpy(em),
                                      torch.from_numpy(tr)).numpy()
    want = np.stack([np.asarray(jax_assoc.step_matrices(jnp.asarray(e),
                                                        jnp.asarray(t)))
                     for e, t in zip(em, tr)])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    a = rng.normal(size=(4, 6, 6)).astype(np.float32)
    b = rng.normal(size=(4, 6, 6)).astype(np.float32)
    got = assoc_viterbi._maxplus_matmul(torch.from_numpy(a),
                                        torch.from_numpy(b)).numpy()
    want = np.asarray(jax_assoc._maxplus_matmul(jnp.asarray(a),
                                                jnp.asarray(b)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_slices_of_rows_change_nothing(monkeypatch):
    """A budget that forces one row a slice gives the same bits."""
    args = random_inputs(6, 33, 8, seed=9, ties=True)
    whole = _port(args)
    monkeypatch.setattr(assoc_viterbi, "TEMP_BYTES", 1)
    assert assoc_viterbi.rows_per_slice(33, 8) == 1
    sliced = _port(args)
    np.testing.assert_array_equal(whole[0], sliced[0])
    np.testing.assert_array_equal(whole[1].view(np.int32),
                                  sliced[1].view(np.int32))


def test_decode_batch_dispatch():
    args = tuple(torch.from_numpy(a)
                 for a in random_inputs(4, 20, 8, seed=2, ties=True))
    fused = ops.decode_batch(*args, SIGMA, BETA)
    scan = ops.decode_batch(*args, SIGMA, BETA, decode="scan")
    assoc = ops.decode_batch(*args, SIGMA, BETA, decode="assoc")
    want = assoc_viterbi.viterbi_assoc_batch(*args, SIGMA, BETA)
    for a, b in zip(fused, scan):
        assert torch.equal(a, b)
    for a, b in zip(assoc, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown decode"):
        ops.decode_batch(*args, SIGMA, BETA, decode="pallas")
    for decode in ops.DECODES:
        with pytest.raises(ValueError, match="events"):
            ops.decode_batch(*args, SIGMA, BETA, events=(None, None),
                             decode=decode)


# ---- through the matcher ---------------------------------------------------

@pytest.fixture(scope="module")
def city_and_requests():
    """Each package's 10x10 city and 24 seeded requests (T buckets 16 and
    64), the same points on both sides."""
    kw = dict(rows=10, cols=10, spacing_m=200.0, seed=6,
              service_road_fraction=0.0, internal_fraction=0.0)
    ref_city, city = jax_city(**kw), build_grid_city(**kw)
    rng_ref, rng = np.random.default_rng(21), np.random.default_rng(21)
    reqs = []
    while len(reqs) < 24:
        tr_ref = jax_trace(ref_city, f"a{len(reqs)}", rng_ref, noise_m=6.0)
        tr = generate_trace(city, f"a{len(reqs)}", rng, noise_m=6.0)
        assert (tr_ref is None) == (tr is None)
        if tr is None:
            continue
        assert tr.points == tr_ref.points
        reqs.append(tr.request_json(report_levels=(0, 1, 2),
                                    transition_levels=(0, 1, 2)))
    return ref_city, city, reqs


def _bodies(matches, reqs):
    return [[report_json(m, req, *lv) for lv in LEVELS]
            for m, req in zip(matches, reqs)]


@pytest.fixture
def jax_assoc_decode(monkeypatch):
    """The JAX package's matcher decoding by its assoc backend on one
    device (no mesh padding)."""
    saved = jax_ops._sharded_cache
    monkeypatch.setenv("REPORTER_TPU_SHARD", "0")
    monkeypatch.setenv("REPORTER_TPU_DECODE", "assoc")
    jax_ops._sharded_cache = None
    jax_mesh.reset_decode_mesh()
    yield
    jax_ops._sharded_cache = saved
    jax_mesh.reset_decode_mesh()


@pytest.mark.parametrize("native", [True, False])
def test_assoc_matcher_bodies_equal_the_jax_assoc_matcher(
        city_and_requests, jax_assoc_decode, native):
    ref_city, city, reqs = city_and_requests
    ref = JaxMatcher(net=ref_city, use_native=native)
    port = SegmentMatcher(city, device="cpu", native=native, decode="assoc")
    want = [[jax_report_json(m, req, *lv) for lv in LEVELS]
            for m, req in zip(ref.match_many(reqs), reqs)]
    assert _bodies(port.match_many(reqs), reqs) == want


def test_assoc_matcher_agrees_with_fused_up_to_ties(city_and_requests):
    """Bodies equal to the default decode's; a trace whose body differs
    decodes to a different path of equal f64 score."""
    _, city, reqs = city_and_requests
    fused = _bodies(SegmentMatcher(city, device="cpu").match_many(reqs),
                    reqs)
    m = SegmentMatcher(city, device="cpu", decode="assoc")
    assoc = _bodies(m.match_many(reqs), reqs)
    prepared = m.prepare_many(reqs)
    tied = set()
    for batch in pack_batches(prepared):
        args = tuple(a.astype(np.float32) if a.dtype == np.float16 else a
                     for a in (batch.dist_m, batch.valid, batch.route_m,
                               batch.gc_m, batch.case))
        got, _ = assoc_viterbi.viterbi_assoc_batch(
            *(torch.from_numpy(a) for a in args), SIGMA, BETA)
        _assert_quality_equal(args, got.numpy())
        want, _ = viterbi_decode_batch(
            *(torch.from_numpy(a) for a in args), SIGMA, BETA)
        for row, p in enumerate(batch.traces):
            if not torch.equal(got[row], want[row]):
                tied.add(next(i for i, q in enumerate(prepared) if q is p))
    differ = {i for i, (a, b) in enumerate(zip(fused, assoc)) if a != b}
    assert differ <= tied
    assert len(differ) < len(reqs)


def test_unknown_decode_raises(city_and_requests):
    city = city_and_requests[1]
    with pytest.raises(ValueError, match="unknown decode"):
        SegmentMatcher(city, device="cpu", decode="pallas")
    for decode in ops.DECODES:
        assert SegmentMatcher(city, device="cpu",
                              decode=decode).decode == decode


def test_decode_key_reaches_the_matcher(city_and_requests, tmp_path):
    city = city_and_requests[1]
    path = str(tmp_path / "city.npz")
    city.save(path)
    assert "decode" in server.MATCHER_KEYS
    conf = server.parse_config({"graph": path,
                                "service": {"decode": "assoc"}})
    assert conf["matcher"] == {"decode": "assoc"}
    assert server.matcher_from_config(conf, "cpu").decode == "assoc"
    # a city registry's config-built matchers take the same keys
    conf = server.parse_config({"graph": path, "cities": {"a": {"graph":
                                                                path}},
                                "service": {"decode": "scan"}})
    reg = server.cities_from_config(conf, "cpu")
    assert reg.get("a").service.matcher.decode == "scan"
    assert reg.evict("a")
    bad = server.parse_config({"graph": path,
                               "service": {"decode": "nope"}})
    with pytest.raises(ValueError, match="unknown decode"):
        server.matcher_from_config(bad, "cpu")


def test_shadow_of_an_assoc_matcher_counts_no_mismatch(city_and_requests):
    _, city, reqs = city_and_requests
    m = SegmentMatcher(city, device="cpu", decode="assoc")
    profiler.reset()
    server.configure_obs({"shadow_sample": 1.0})
    try:
        m.match_many(reqs)
        assert profiler.drain_shadow(30.0)
        assert profiler.shadow_stats()["sampled"] == len(reqs)
        assert profiler.shadow_mismatches() == 0
    finally:
        server.configure_obs({"shadow_sample": 0.0})
        assert profiler.drain_shadow(30.0)
        profiler.reset()


def test_profiler_shape_key_carries_the_decode(city_and_requests):
    _, city, reqs = city_and_requests
    profiler.reset()
    try:
        for decode in ops.DECODES:
            SegmentMatcher(city, device="cpu", decode=decode,
                           pipeline=False).match_many(reqs[:4])
        backends = {s["backend"] for s in profiler.snapshot()["shapes"]}
        assert backends == {"plain", "scan", "assoc"}
        with profiler.dispatch_span(8, 64, 8, "cuda", "assoc"):
            pass
        with profiler.dispatch_span(8, 64, 8, "cuda"):
            pass
        shapes = {(s["platform"], s["backend"])
                  for s in profiler.snapshot()["shapes"] if s["B"] == 8}
        assert shapes == {("cuda", "assoc"), ("cuda", "cuda")}
    finally:
        profiler.reset()


def test_match_json_through_assoc(city_and_requests):
    _, city, reqs = city_and_requests
    m = SegmentMatcher(city, device="cpu", decode="assoc")
    got = json.loads(m.Match(json.dumps(reqs[0])))
    assert got["segments"]
