"""The decode wire's upload slab (``reporter_tpu_torch/matcher/slab.py``).

On the card every batch's host arrays reach the decode through one host
slab and one copy: the native prep writes the f16 wire straight into the
slab's views, and the dispatch lane copies any other batch into a fresh
slab first (restaged). Here, on the CPU, with a plain (unpinned) slab
allocator: the layout (every offset on 16 bytes, every view's bytes the
array it stands for) on the f16 wire, the f32 wire, filler rows and a batch
with a device route tensor; ``prepare_batch`` with a slab bit-equal to
``prepare_batch`` without one; the upload counters; the device views. The
card's own check (slabs in flight against the pageable upload) is
``tools/upload_probe.py``, run by the card-marked test.
"""
import numpy as np
import pytest
import torch

from reporter_tpu_torch import ops
from reporter_tpu_torch.core.tracebatch import TraceBatch
from reporter_tpu_torch.graph.route_device import DeviceRouteKernel
from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
from reporter_tpu_torch.matcher import slab as wire_slab
from reporter_tpu_torch.matcher.batchpad import (bucket_length,
                                                 pack_batches, prepare_batch)
from reporter_tpu_torch.synth import build_grid_city, generate_trace
from reporter_tpu_torch.utils import metrics

PARAMS = MatchParams()
KINDS = ("f16", "f32", "filler", "device_route")
FIELDS = ("dist_m", "valid", "route_m", "gc_m", "case")


def plain(nbytes):
    """A slab allocator without the card: pageable host memory."""
    return torch.empty(nbytes, dtype=torch.uint8)


@pytest.fixture(scope="module")
def cities():
    """The grid city, and one whose blocks are 5 km long: its routes are
    finite past the f16 wire's range."""
    return (build_grid_city(rows=8, cols=8, spacing_m=200.0, seed=3),
            build_grid_city(rows=3, cols=3, spacing_m=5000.0, seed=3))


@pytest.fixture(scope="module")
def matchers(cities):
    return (SegmentMatcher(cities[0], PARAMS, device="cpu"),
            SegmentMatcher(cities[1], MatchParams(breakage_distance=12000.0),
                           device="cpu"))


def _reqs(city, n, seed=11):
    """``n`` seeded requests of 4-48 points."""
    rng = np.random.default_rng(seed)
    reqs = []
    while len(reqs) < n:
        tr = generate_trace(city, f"s-{len(reqs)}", rng, noise_m=4.0,
                            min_route_edges=4, max_route_edges=20)
        if tr is not None and len(tr.points) >= 4:
            reqs.append({"uuid": tr.uuid, "trace": tr.points[:48]})
    return reqs


def _tb(city, n):
    """A chunk of ``n`` requests and the bucket all of them fit."""
    tb = TraceBatch.from_requests(_reqs(city, n))
    return tb, max(bucket_length(int(n)) for n in tb.lengths())


def _far(city):
    """Two traces along the long city's first row, a probe at each of its
    three nodes 300 s apart."""
    lat, lon = np.asarray(city.node_lat), np.asarray(city.node_lon)
    pts = [{"lat": float(lat[i]) + 1e-5, "lon": float(lon[i]),
            "time": 300.0 * i} for i in range(3)]
    return TraceBatch.from_requests([{"uuid": "a", "trace": pts},
                                     {"uuid": "b", "trace": pts}]), 16


def _batch(kind, cities, matchers, slab_alloc=None):
    if kind == "f32":
        tb, T = _far(cities[1])
        return prepare_batch(matchers[1].runtime, tb, matchers[1].params, T,
                             slab_alloc=slab_alloc)
    tb, T = _tb(cities[0], 5 if kind == "filler" else 6)
    kw = {}
    if kind == "filler":
        kw["pad_rows"] = 8
    if kind == "device_route":
        kw = dict(route_kernel=DeviceRouteKernel(cities[0], "cpu"),
                  defer_routes=True)
    batch = prepare_batch(matchers[0].runtime, tb, PARAMS, T,
                          slab_alloc=slab_alloc, **kw)
    batch.finalize_wire()
    batch.routes_to_host()
    return batch


def _arrays(batch):
    return tuple(getattr(batch, f) for f in FIELDS)


def _host(arrays):
    return [a for a in arrays if not isinstance(a, torch.Tensor)]


@pytest.mark.parametrize("kind", KINDS)
def test_the_slab_lays_every_array_on_16_bytes_with_its_bytes(
        kind, cities, matchers):
    batch = _batch(kind, cities, matchers, plain)
    arrays = _arrays(batch)
    host = _host(arrays)
    assert len(host) == (4 if kind == "device_route" else 5)
    wire = wire_slab.stage(arrays, batch.slab, plain)
    base = wire.buf.data_ptr()
    for off, view, a in zip(wire.offsets, wire.views, host):
        assert off % 16 == 0 and off % wire_slab.ALIGN == 0
        assert view.ctypes.data == base + off
        assert view.ctypes.data % 16 == 0
        assert view.dtype == a.dtype and view.shape == a.shape
        assert view.tobytes() == a.tobytes()
    ends = [o + v.nbytes for o, v in zip(wire.offsets, wire.views)]
    assert all(e <= o for e, o in zip(ends, wire.offsets[1:]))
    assert ends[-1] <= wire.used == wire.buf.numel()
    assert wire.used % wire_slab.ALIGN == 0 and wire.used - ends[-1] < \
        wire_slab.ALIGN


@pytest.mark.parametrize("kind", KINDS)
def test_prepare_batch_with_a_slab_is_bit_equal_to_without(
        kind, cities, matchers):
    want = _batch(kind, cities, matchers)
    got = _batch(kind, cities, matchers, plain)
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    for k, v in want.prep.items():
        if k != "phase_ns":
            assert v.tobytes() == got.prep[k].tobytes(), k
    assert want.slab is None
    # the native prep writes the f16 wire in place; the f32 wire is the
    # prep's own arrays, and deferred routes settle on the dispatch lane
    assert (got.slab is not None) == (kind in ("f16", "filler"))
    if got.slab is not None:
        assert got.slab.holds(_arrays(got))
        assert got.dist_m.dtype == np.float16
    if kind == "f32":
        assert got.dist_m.dtype == np.float32


@pytest.mark.parametrize("kind", KINDS)
def test_upload_counts_the_arrays_bytes_and_what_was_restaged(
        kind, cities, matchers):
    batch = _batch(kind, cities, matchers, plain)
    arrays = _arrays(batch)
    nbytes = sum(a.nbytes for a in _host(arrays))
    metrics.default.reset()
    wire = wire_slab.stage(arrays, batch.slab, plain)
    counters = metrics.snapshot()["counters"]
    assert counters["decode.upload.bytes"] == nbytes <= wire.used
    assert counters["decode.upload.copies"] == 1
    restaged = counters.get("decode.upload.restaged_bytes", 0)
    if kind in ("f16", "filler"):
        assert wire is batch.slab and restaged == 0
    else:
        assert wire is not batch.slab and restaged == nbytes


def test_a_pack_batches_batch_is_restaged_whole(cities, matchers):
    prepped = matchers[0].prepare_many(_reqs(cities[0], 6))
    for batch in pack_batches(prepped):
        arrays = _arrays(batch)
        nbytes = sum(a.nbytes for a in arrays)
        metrics.default.reset()
        wire_slab.stage(arrays, batch.slab, plain)
        counters = metrics.snapshot()["counters"]
        assert batch.slab is None
        assert counters["decode.upload.restaged_bytes"] == nbytes
        assert counters["decode.upload.bytes"] == nbytes
        assert counters["decode.upload.copies"] == 1


@pytest.mark.parametrize("kind", KINDS)
def test_uploaded_views_decode_as_the_arrays(kind, cities, matchers):
    """The views of the one device buffer (here the CPU's) are contiguous,
    start on 16 bytes, hold the arrays, and decode to the same paths."""
    batch = _batch(kind, cities, matchers, plain)
    arrays = _arrays(batch)
    metrics.default.reset()
    x = wire_slab.upload(arrays, batch.slab, plain, torch.device("cpu"))
    assert metrics.snapshot()["counters"]["decode.upload.copies"] == 1
    for a, t in zip(arrays, x):
        if isinstance(a, torch.Tensor):
            assert t is a
            continue
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
        assert t.dtype == torch.from_numpy(a).dtype
        assert np.array_equal(t.numpy(), a)
    sigma, beta = np.float32(PARAMS.effective_sigma), np.float32(PARAMS.beta)
    want, want_scores = ops.decode_batch(
        *(a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
          for a in arrays), sigma, beta)
    got, got_scores = ops.decode_batch(*x, sigma, beta)
    assert torch.equal(want, got) and torch.equal(want_scores, got_scores)


def test_layout_rounds_each_offset_up():
    offsets, used = wire_slab.layout([((3,), np.float16), ((5,), np.bool_),
                                      ((0, 4), np.float32), ((2,), np.int32)])
    A = wire_slab.ALIGN
    assert offsets == (0, A, 2 * A, 2 * A) and used == 3 * A


def test_to_f16_writes_into_out(matchers):
    rt = matchers[0].runtime
    rng = np.random.default_rng(3)
    a = rng.uniform(-7000, 7000, (4, 5, 6)).astype(np.float32)
    a[0, 0, :2] = (1.0e9, 65520.0)
    out = np.full(a.shape, 7, np.float16)
    assert rt.to_f16(a, out=out) is out
    assert out.tobytes() == rt.to_f16(a).tobytes()
    with np.errstate(over="ignore"):
        assert out.tobytes() == a.astype(np.float16).tobytes()
    for bad in (np.empty(a.shape, np.float32), np.empty((4, 30), np.float16),
                np.empty((4, 5, 12), np.float16)[:, :, ::2]):
        with pytest.raises(ValueError):
            rt.to_f16(a, out=bad)


def test_the_matcher_stages_on_the_card_only(cities):
    """On the CPU the matcher passes no slab allocator, so the prep and
    the decode get plain numpy arrays, and nothing is uploaded."""
    m = SegmentMatcher(cities[0], PARAMS, device="cpu")
    assert m._slab_alloc is None
    tb, _T = _tb(cities[0], 6)
    metrics.default.reset()
    m.match_many(tb)
    counters = metrics.snapshot()["counters"]
    assert not any(k.startswith("decode.upload.") for k in counters)
    m.close()


@pytest.mark.parametrize("devices,slabs", [(None, True),
                                            (["cpu", "cpu"], False)])
def test_a_batch_the_mesh_shards_is_prepared_without_a_slab(
        devices, slabs, cities):
    """With a slab allocator, the native prep stages a batch in a slab
    unless the decode mesh shards it: each entry then uploads its own rows
    from the prep's arrays."""
    m = SegmentMatcher(cities[0], PARAMS, device="cpu",
                       mesh_devices=devices)
    assert (m.decode_mesh is not None) == (devices is not None)
    made = []

    def counting(nbytes):
        made.append(nbytes)
        return plain(nbytes)

    m._slab_alloc = counting
    tb, _T = _tb(cities[0], 6)
    out = m.match_many(tb)
    m.close()
    assert len(out) == 6 and bool(made) == slabs


@pytest.mark.card
def test_slabs_in_flight_match_the_pageable_upload():
    """On the card: match_many with at least 8 chunks' slabs live, and on
    the numpy prep and device routes (restaged), every batch's paths
    bit-equal to its host arrays uploaded pageable."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    from reporter_tpu_torch.tools import upload_probe
    got = upload_probe.check_in_flight(torch.device("cuda", 0), traces=1152)
    assert got["native"]["slabs"] >= upload_probe.IN_FLIGHT
    assert got["native"]["restaged_bytes"] == 0
    for leg in ("native", "numpy", "device_routes"):
        assert got[leg]["paths_equal"] == got[leg]["batches"] > 0
        assert got[leg]["copies"] == got[leg]["batches"]
