"""The port's device profiler against the JAX package's.

Per-chunk wide events and padding waste for the same ``match_many``, the
decode shadow's verdicts and its sampling accumulator, the build and
launch telemetry (driven by injected build events: no ``nvcc`` here), a
device trace of a CPU region, and the incremental shadow over the same
stream. The JAX package is configured through its environment
(``monkeypatch.setenv``), the port through its config keys
(``service.server.configure_obs``). Tolerances: wide-event fields and
verdict counts equal.
"""
import json
import logging
import os
import types

import numpy as np
import pytest

from reporter_tpu import ops as jax_ops
from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.matcher import incremental as jax_inc
from reporter_tpu.matcher.cpu_ref import viterbi_decode_numpy
from reporter_tpu.obs import profiler as jax_profiler
from reporter_tpu.parallel import mesh as jax_mesh
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu.utils import metrics as jax_metrics
from reporter_tpu_torch.matcher import SegmentMatcher
from reporter_tpu_torch.matcher.batchpad import occupancy_stats
from reporter_tpu_torch.matcher.hmm import NORMAL, RESTART
from reporter_tpu_torch.obs import profiler
from reporter_tpu_torch.obs import trace as obs_trace
from reporter_tpu_torch.service.server import configure_obs
from reporter_tpu_torch.synth import build_grid_city, generate_trace
from reporter_tpu_torch.utils import metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "report_parity.json")
SIGMA, BETA = 4.07, 3.0


@pytest.fixture(autouse=True)
def _clean_profiler():
    for prof in (profiler, jax_profiler):
        prof.reset()
    yield
    configure_obs({"shadow_sample": 0.0,
                   "profile_events": profiler.DEFAULT_EVENTS})
    for prof in (profiler, jax_profiler):
        assert prof.drain_shadow(30.0)
        prof.reset()


@pytest.fixture(scope="module")
def fixture():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.fixture
def unsharded(monkeypatch):
    """The JAX package's decode on one device: no mesh padding of the
    batch rows, the port's layout."""
    saved = jax_ops._sharded_cache
    monkeypatch.setenv("REPORTER_TPU_SHARD", "0")
    jax_ops._sharded_cache = None
    jax_mesh.reset_decode_mesh()
    yield
    jax_ops._sharded_cache = saved
    jax_mesh.reset_decode_mesh()


def _strip(events):
    return [{k: v for k, v in e.items() if k not in ("ts_ms", "trace_id")}
            for e in events]


# ---------------------------------------------------------------------------
class TestWideEvents:
    def test_native_chunk_events_equal_the_jax_ones(self, fixture,
                                                    unsharded, monkeypatch):
        """The same match_many on the native prep: every chunk's event
        field by field, the totals and the per-bucket waste. One prep
        thread each: with more, the route memo's hits depend on how the
        threads interleave."""
        monkeypatch.setenv("REPORTER_TPU_PREP_THREADS", "1")
        reqs = fixture["requests"]
        ref = JaxMatcher(net=jax_city(**fixture["city"]), use_native=True)
        port = SegmentMatcher(build_grid_city(**fixture["city"]),
                              device="cpu", prep_threads=1)

        def occupancy_counts():
            timers = metrics.snapshot()["timers"]
            return [timers.get(f"decode.occupancy.t{T}", {}).get("count", 0)
                    for T in (64, 256)]

        before = occupancy_counts()
        ref.match_many(reqs)
        port.match_many(reqs)
        want = _strip(jax_profiler.recent_events(None))
        got = _strip(profiler.recent_events(None))
        assert len(got) == 2 and got == want
        assert profiler.padding_waste() == jax_profiler.padding_waste()
        for T in (16, 64, 256):
            assert profiler.bucket_waste(T) == jax_profiler.bucket_waste(T)
        assert [a - b for a, b in zip(occupancy_counts(), before)] == [1, 1]

    def test_numpy_chunk_events(self, fixture, unsharded):
        """The numpy prep: the same events but for the padded rows, which
        the port's pack leaves out (its kernel takes any batch size) and
        the JAX package's pads to a power of two."""
        reqs = fixture["requests"]
        ref = JaxMatcher(net=jax_city(**fixture["city"]), use_native=False)
        port = SegmentMatcher(build_grid_city(**fixture["city"]),
                              device="cpu", native=False)
        jax_metrics.default.reset()
        metrics.default.reset()
        ref.match_many(reqs)
        port.match_many(reqs)
        want = jax_profiler.recent_events(None)
        got = profiler.recent_events(None)
        padded = ("rows", "padded_cells", "occupancy", "padding_waste")
        assert [{k: v for k, v in e.items() if k not in padded}
                for e in _strip(got)] == \
            [{k: v for k, v in e.items() if k not in padded}
             for e in _strip(want)]
        for e in got:
            assert e["rows"] == e["traces"]
            cells, occ, waste = occupancy_stats(e["kept_points"], e["rows"],
                                                e["bucket_T"])
            assert (e["padded_cells"], e["occupancy"],
                    e["padding_waste"]) == (cells, round(occ, 6),
                                            round(waste, 6))

    def test_ring_queue_depth_and_trace_id(self):
        configure_obs({"profile_events": 16})
        obs_trace.configure(True)
        try:
            profiler.note_queue_depth(7, name="d0")
            profiler.note_queue_depth(3, name="d1")
            with obs_trace.span("root") as root:
                for _ in range(50):
                    profiler.chunk_event(bucket_T=16, K=8, traces=1, rows=1,
                                         kept_points=8, raw_points=10)
        finally:
            obs_trace.configure(False)
        evs = profiler.recent_events(None)
        assert len(evs) == 16 and profiler.recent_events(0) == []
        assert {e["trace_id"] for e in evs} == {root.trace_id}
        assert {e["queue_depth"] for e in evs} == {7}
        assert profiler.queue_depths() == {"d0": 7, "d1": 3}
        profiler.chunk_event(bucket_T=16, K=8, traces=1, rows=1,
                             kept_points=8, raw_points=10)
        assert profiler.recent_events(1)[0]["trace_id"] is None

    def test_occupancy_math_as_the_jax_module(self):
        from reporter_tpu.matcher.batchpad import \
            occupancy_stats as jax_occupancy
        for args in ((60, 2, 64), (0, 0, 64), (132, 1, 256), (545, 16, 64)):
            assert occupancy_stats(*args) == jax_occupancy(*args)


# ---------------------------------------------------------------------------
def _toy_batch(seed=3):
    """A hand-built one-trace decode batch and its plain path."""
    B, T, K = 1, 6, 3
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0, 30, (B, T, K)).astype(np.float32)
    valid = np.ones((B, T, K), bool)
    gc = rng.uniform(5, 40, (B, T - 1)).astype(np.float32)
    route = rng.uniform(5, 80, (B, T - 1, K, K)).astype(np.float32)
    case = np.full((B, T), NORMAL, np.int32)
    case[:, 0] = RESTART
    batch = types.SimpleNamespace(dist_m=dist, valid=valid, route_m=route,
                                  gc_m=gc, case=case)
    path, _ = viterbi_decode_numpy(dist[0], valid[0], route[0], gc[0],
                                   case[0], SIGMA, BETA)
    return batch, path


def _shadow_both(monkeypatch, frac, batch, decoded, times=1):
    """Feed the same chunks to both packages' shadows at ``frac``;
    returns [(sampled, mismatch)] of (port, JAX)."""
    monkeypatch.setenv(jax_profiler.ENV_SHADOW, str(frac))
    configure_obs({"shadow_sample": frac})
    out = []
    for prof, reg in ((profiler, metrics), (jax_profiler, jax_metrics)):
        seen = []
        for _ in range(times):
            c0 = reg.default.counter("decode.shadow.chunks")
            prof.maybe_shadow(batch, decoded, 1, SIGMA, BETA)
            assert prof.drain_shadow(30.0)
            seen.append(reg.default.counter("decode.shadow.chunks") - c0)
        stats = prof.shadow_stats()
        out.append((seen, stats["sampled"], stats["mismatch"]))
    return out


class TestShadow:
    def test_agreeing_decode_has_no_mismatch(self, monkeypatch):
        batch, path = _toy_batch()
        port, ref = _shadow_both(monkeypatch, 1.0, batch, path[None, :])
        assert port == ref == ([1], 1, 0)

    def test_doctored_decode_is_a_mismatch(self, monkeypatch):
        batch, path = _toy_batch()
        bad = path.copy()
        bad[2] = (bad[2] + 1) % 3  # a strictly worse state
        port, ref = _shadow_both(monkeypatch, 1.0, batch, bad[None, :])
        assert port == ref == ([1], 1, 1)
        assert metrics.default.counter("decode.shadow.mismatch") >= 1

    def test_tie_breaks_are_agreement(self, monkeypatch):
        B, T, K = 1, 3, 2
        case = np.full((B, T), NORMAL, np.int32)
        case[:, 0] = RESTART
        batch = types.SimpleNamespace(
            dist_m=np.full((B, T, K), 5.0, np.float32),
            valid=np.ones((B, T, K), bool),
            route_m=np.full((B, T - 1, K, K), 10.0, np.float32),
            gc_m=np.full((B, T - 1), 10.0, np.float32), case=case)
        other = np.array([[1, 1, 1]], np.int32)  # the other tied path
        port, ref = _shadow_both(monkeypatch, 1.0, batch, other)
        assert port == ref == ([1], 1, 0)

    def test_accumulator_samples_the_jax_chunks(self, monkeypatch):
        batch, path = _toy_batch()
        port, ref = _shadow_both(monkeypatch, 0.5, batch, path[None, :],
                                 times=7)
        assert port == ref
        assert port[0] == [0, 1, 0, 1, 0, 1, 0]

    def test_off_by_default_and_suspended(self, monkeypatch):
        batch, path = _toy_batch()
        profiler.maybe_shadow(batch, path[None, :], 1, SIGMA, BETA)
        assert profiler.shadow_stats()["sampled"] == 0
        configure_obs({"shadow_sample": 1.0})
        profiler.set_shadow_suspended(True)
        s0 = metrics.default.counter("decode.shadow.suppressed")
        profiler.maybe_shadow(batch, path[None, :], 1, SIGMA, BETA)
        assert metrics.default.counter("decode.shadow.suppressed") == s0 + 1
        assert profiler.shadow_stats()["suspended"]

    def test_submit_failure_never_escapes_or_leaks(self, monkeypatch):
        configure_obs({"shadow_sample": 1.0})

        def boom():
            raise RuntimeError("can't start new thread")
        monkeypatch.setattr(profiler, "_ensure_shadow_pool", boom)
        batch, path = _toy_batch()
        e0 = metrics.default.counter("decode.shadow.errors")
        profiler.maybe_shadow(batch, path[None, :], 1, SIGMA, BETA)
        assert metrics.default.counter("decode.shadow.errors") == e0 + 1
        assert profiler.shadow_stats()["pending"] == 0

    def test_backlog_is_bounded_in_bytes(self, monkeypatch):
        """Chunks wait for the shadow up to the byte bound; past it they
        are dropped, counted. The first chunk is always taken."""
        configure_obs({"shadow_sample": 1.0})
        waiting = []
        monkeypatch.setattr(profiler, "_ensure_shadow_pool",
                            lambda: types.SimpleNamespace(
                                submit=lambda *a: waiting.append(a)))
        monkeypatch.setattr(profiler, "_SHADOW_MAX_PENDING_BYTES", 1)
        batch, path = _toy_batch()
        d0 = metrics.default.counter("decode.shadow.dropped")
        for _ in range(3):
            profiler.maybe_shadow(batch, path[None, :], 1, SIGMA, BETA)
        assert len(waiting) == 1
        assert metrics.default.counter("decode.shadow.dropped") == d0 + 2
        job, *args = waiting[0]
        job(*args)
        assert profiler.shadow_stats()["pending"] == 0
        assert profiler._shadow_pending_bytes == 0

    @pytest.mark.parametrize("native", [True, False])
    def test_match_many_shadows_every_chunk(self, fixture, native):
        """Through the matcher's drain lane: every chunk sampled, every
        trace agreeing, and the served results unchanged."""
        m = SegmentMatcher(build_grid_city(**fixture["city"]),
                           device="cpu", native=native)
        reqs = fixture["requests"]
        plain = [json.dumps(dict(r), sort_keys=True)
                 for r in m.match_many(reqs)]
        configure_obs({"shadow_sample": 1.0})
        got = [json.dumps(dict(r), sort_keys=True)
               for r in m.match_many(reqs)]
        assert profiler.drain_shadow(30.0)
        assert got == plain
        assert profiler.shadow_stats()["sampled"] == len(reqs)
        assert profiler.shadow_mismatches() == 0
        assert metrics.default.counter("decode.shadow.chunks") >= 2
        assert profiler.shutdown_shadow_pool()


# ---------------------------------------------------------------------------
class TestBuildTelemetry:
    def test_episode_then_recompile_storm(self, caplog):
        """Injected build events: a dispatch during which a library built
        is an episode; the same shape building again is a storm."""
        c0 = metrics.default.counter("decode.compile.count")
        r0 = metrics.default.counter("decode.compile.recompiles")
        with profiler.dispatch_span(8, 64, 8, "cuda"):
            profiler._on_build("build", 0.25, "viterbi")
        assert metrics.default.counter("decode.compile.count") == c0 + 1
        assert metrics.default.counter("decode.compile.recompiles") == r0
        with profiler.dispatch_span(8, 64, 8, "cuda"):
            pass
        profiler._on_build("load", 1.0, "viterbi")  # no dispatch active
        with caplog.at_level(logging.WARNING, "reporter_tpu_torch.obs"):
            with profiler.dispatch_span(8, 64, 8, "cuda"):
                profiler._on_build("load", 0.1, "viterbi")
        assert metrics.default.counter("decode.compile.recompiles") == r0 + 1
        assert any("recompile storm" in r.message for r in caplog.records)
        (shape,) = profiler.snapshot()["shapes"]
        assert (shape["platform"], shape["backend"], shape["mesh"]) == \
            ("cuda", "cuda", 1)
        assert shape["compiles"] == 2 and shape["dispatches"] == 3
        assert shape["steady"]["n"] == 1
        assert shape["compile_s"] == pytest.approx(0.35, abs=1e-6)
        assert profiler.compile_count() == 2
        # the same (B, T, K) on the CPU is another shape, not a storm
        with profiler.dispatch_span(8, 64, 8, "cpu"):
            profiler._on_build("build", 0.1, "viterbi")
        assert metrics.default.counter("decode.compile.recompiles") == r0 + 1

    def test_the_listener_hears_nvcc_load(self, monkeypatch, tmp_path):
        """ops.nvcc.load tells its listeners of a load; the profiler's
        listener credits it to the dispatch on this thread."""
        from reporter_tpu_torch.ops import nvcc
        lib = tmp_path / "libfake.so"
        src = tmp_path / "fake.cu"
        src.write_text("")
        lib.write_bytes(b"")
        monkeypatch.setattr(nvcc, "library_path", lambda s, stem: lib)
        monkeypatch.setattr(nvcc.ctypes, "CDLL", lambda path: object())
        monkeypatch.setattr(nvcc, "_loaded", {})
        c0 = metrics.default.counter("decode.compile.count")
        with profiler.dispatch_span(4, 16, 8, "cuda"):
            nvcc.load(src, "fake")
            nvcc.load(src, "fake")  # cached: no second event
        assert metrics.default.counter("decode.compile.count") == c0 + 1
        (shape,) = profiler.snapshot()["shapes"]
        assert shape["compile_calls"] == 1

    def test_failed_dispatch_records_nothing(self):
        with pytest.raises(RuntimeError):
            with profiler.dispatch_span(8, 64, 8):
                raise RuntimeError("device fell over")
        assert profiler.snapshot()["shapes"] == []

    def test_launch_telemetry(self):
        with profiler.dispatch_span(128, 64, 8, "cuda"):
            pass
        profiler.note_launch(128, 64, 8, "cuda", 0.002)
        profiler.note_launch(128, 64, 8, "cuda", 0.004)
        (shape,) = profiler.snapshot()["shapes"]
        assert shape["launch_latency"] == {"n": 2, "mean_s": 0.003, "max_s": 0.004}
        assert metrics.snapshot()["timers"]["decode.launch.latency"][
            "count"] >= 2

    def test_cpu_matcher_dispatches_are_steady(self, fixture):
        m = SegmentMatcher(build_grid_city(**fixture["city"]),
                           device="cpu")
        m.match_many(fixture["requests"])
        shapes = profiler.snapshot()["shapes"]
        assert {(s["B"], s["T"], s["backend"]) for s in shapes} == \
            {(16, 64, "plain"), (1, 256, "plain")}
        assert all(s["compiles"] == 0 and s["launch_latency"]["n"] == 0
                   for s in shapes)
        assert set(profiler.route_kernel_stats()) >= {
            "device_chunks", "relaxes", "sweeps"}


def test_device_trace_of_a_cpu_region(tmp_path):
    import torch
    with metrics.device_trace(str(tmp_path), "cpu") as dt:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert dt.path and os.path.exists(dt.path)
    with open(dt.path) as f:
        assert json.load(f)["traceEvents"]
    assert any("mm" in e.name for e in dt.profile.events())


# ---------------------------------------------------------------------------
INC_CITY = dict(rows=12, cols=12, spacing_m=200.0, seed=2,
                service_road_fraction=0.0, internal_fraction=0.0)


def _streams(city, n=3):
    rng = np.random.default_rng(7)
    out = []
    while len(out) < n:
        tr = generate_trace(city, f"veh-{len(out)}", rng, noise_m=4.0)
        if tr is not None and len(tr.points) >= 24:
            out.append(list(tr.points))
    return out


@pytest.mark.parametrize("native", [True, False])
def test_incremental_shadow_counts_as_the_jax_one(native, monkeypatch):
    """At fraction 0.5 over the same growing windows: the same checks,
    no mismatch and no error in either package."""
    monkeypatch.setenv(jax_inc.ENV_INCREMENTAL, "on")
    monkeypatch.setenv(jax_profiler.ENV_SHADOW, "0.5")
    configure_obs({"shadow_sample": 0.5})
    monkeypatch.setattr(jax_inc, "_shadow_acc", 0.0)
    from reporter_tpu_torch.matcher import incremental as inc
    monkeypatch.setattr(inc, "_shadow_acc", 0.0)
    ref = JaxMatcher(net=jax_city(**INC_CITY), use_native=native)
    city = build_grid_city(**INC_CITY)
    port = SegmentMatcher(city, device="cpu", native=native)
    names = ("match.incremental.shadow_checks",
             "match.incremental.shadow_mismatches",
             "match.incremental.shadow_errors")
    before = [[r.default.counter(n) for n in names]
              for r in (metrics, jax_metrics)]
    served = 0
    for u, pts in enumerate(_streams(city)):
        for hi in range(8, len(pts) + 1, 4):
            req = {"uuid": f"veh-{u}", "trace": pts[:hi]}
            got = port.match_incremental([req])[0]
            want = ref.match_incremental([req])[0]
            assert (got is None) == (want is None)
            served += got is not None
    after = [[r.default.counter(n) for n in names]
             for r in (metrics, jax_metrics)]
    port_d, jax_d = ([a - b for a, b in zip(x, y)]
                     for x, y in zip(after, before))
    assert served >= 6
    assert port_d == jax_d == [served // 2, 0, 0]
