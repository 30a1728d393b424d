"""Device-level profiling: kernel-build and launch telemetry, per-chunk
wide events, and the decode shadow.

- **Build telemetry.** Every decode dispatch runs under
  :func:`dispatch_span`, which credits each library build or load of
  ``ops/nvcc.py`` on the dispatching thread to the dispatch's shape
  ``(B, T, K, device type, "cuda"|"plain", 1)``. A dispatch during which
  one fired is an *episode*: counted (``decode.compile.count``), timed
  (``decode.compile``), and, when the same shape builds a second time,
  flagged as a recompile storm (``decode.compile.recompiles`` and a
  warning). Dispatch wall time splits into ``decode.dispatch.first``
  (episodes) and ``decode.dispatch.steady``. The metric names are the
  JAX package's, whose episodes are XLA compiles.
- **Launch telemetry.** :func:`note_launch` adds one launch's latency
  (a CUDA event pair the kernel's launcher records around the launch,
  read by the drain lane after the event wait it already does) to its
  shape's row and to the ``decode.launch.latency`` histogram. On an
  idle stream the start event completes at once, so the pair holds the
  launch's submission as well as the kernel: the kernel's own time is
  in ``utils.metrics.device_trace``.
- **Builds on the card.** ``ops/nvcc.py`` builds or loads a library
  once per process and caches it, so on the card at most one dispatch
  of a process is an episode and a recompile cannot happen; the
  per-shape recompile count keeps the JAX package's metric for a
  loader that could build a shape twice.
- **Wide events.** A bounded ring of per-chunk records: bucket T, K,
  traces against padded rows, kept points against the ``rows*T`` point
  cells, the padding waste, the queue depth at dispatch, route-memo or
  route-cache counters and the trace id when tracing is armed. Served on
  ``/profile``; per-bucket occupancy histograms (``decode.occupancy.t<T>``)
  ride the metrics registry onto ``/stats`` and ``/metrics``.
- **The decode shadow.** With ``shadow_sample`` > 0 a deterministic
  accumulator picks that fraction of decoded chunks and re-decodes each
  through the plain scan (``matcher/hmm.py``) on the CPU, on one
  background thread, off the card's stream; it checks and never serves.
  The verdict compares path quality (an f64 re-score: two decoders may
  break an exact score tie differently, which is agreement). On the
  card the kernel is bit-equal to the plain scan, so a mismatch is a
  kernel fault. ``decode.shadow.{chunks,sampled,mismatch,errors}``
  count the verdicts and ``decode.shadow.mismatch_ratio`` histograms
  the per-chunk ratio.

Accounting is per chunk (hundreds of traces), not per trace: a handful
of scalar operations and one deque append.
"""
from __future__ import annotations

import collections
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import locks as _locks
from ..utils import metrics
from . import trace as obs_trace

logger = logging.getLogger("reporter_tpu_torch.obs")

#: score agreement tolerance of the shadow verdict, in f64 log-score units
SHADOW_SCORE_TOL = 1e-2
#: default wide-event ring size (the JAX package's REPORTER_TPU_PROFILE_EVENTS)
DEFAULT_EVENTS = 512

#: chunk bytes allowed to wait for the shadow before sampling sheds load:
#: a burst of serving queues its chunks (the plain scan's many small
#: torch ops each take the interpreter lock back, so under load it runs
#: far behind the card) and the shadow drains them after; past the bound
#: it sheds, counted, and never becomes an unbounded backlog
_SHADOW_MAX_PENDING_BYTES = 256 << 20

_lock = _locks.new_lock("profiler")

#: (B, T, K, device type, backend, 1) -> per-shape stats (dispatch_span)
_shapes: Dict[Tuple[int, int, int, str, str, int], dict] = {}


def _new_ring(n: int):
    return _locks.Guarded(collections.deque(maxlen=max(16, int(n))), _lock,
                          "profiler.events")


#: the wide-event ring; writes and reads hold _lock (iterating a deque
#: mid-append raises), audited by the Guarded wrapper (racecheck RC003)
_events = _new_ring(DEFAULT_EVENTS)
_events_size = DEFAULT_EVENTS

_tls = threading.local()  # .active: [build events, build seconds] or None

_listener_registered = False
#: per-dispatcher queue-depth gauges, keyed by dispatcher name
_queue_depths: Dict[str, int] = {}
_total_kept = 0           # running occupancy totals (point slots)
_total_cells = 0
#: bucket T -> running [kept, cells]
_bucket_totals: Dict[int, list] = {}
_compile_episodes = 0

_shadow_frac = 0.0
_shadow_acc = 0.0         # deterministic sampling accumulator
_shadow_pending = 0
_shadow_pending_bytes = 0
_shadow_pool: Optional[ThreadPoolExecutor] = None
_shadow_sampled = 0
_shadow_mismatch = 0
#: sampling suspended (counted as decode.shadow.suppressed)
_shadow_suspended = False


def configure(shadow_sample: Optional[float] = None,
              events: Optional[int] = None) -> None:
    """Set the shadow's sampled fraction (the config's ``shadow_sample``;
    0 turns it off) and the wide-event ring's size (``profile_events``,
    at least 16; the ring restarts empty). None leaves a setting as it
    is."""
    global _shadow_frac, _events, _events_size
    with _lock:
        if shadow_sample is not None:
            _shadow_frac = max(0.0, float(shadow_sample))
        if events is not None:
            _events_size = int(events)
            _events = _new_ring(_events_size)


# ---- build telemetry -------------------------------------------------------

def _on_build(event: str, seconds: float, stem: str) -> None:
    """``ops.nvcc`` listener: credit a build or load to the dispatch
    active on this thread (loads run on the dispatching thread)."""
    acc = getattr(_tls, "active", None)
    if acc is not None:
        acc[0] += 1
        acc[1] += seconds


def _ensure_listener() -> None:
    global _listener_registered
    if _listener_registered:
        return
    from ..ops import nvcc  # lazy: ops imports the matcher package
    nvcc.add_listener(_on_build)
    _listener_registered = True


def _backend(device: str, decode: str) -> str:
    """The shape key's backend: the decode's name, the fused decode's
    being "cuda" on the card and "plain" (the scan) on the CPU."""
    if decode == "fused":
        return "cuda" if device == "cuda" else "plain"
    return decode


def _shape_key(B: int, T: int, K: int, device: str,
               decode: str = "fused", mesh: int = 1) -> tuple:
    """A compiled shape: (B, T, K), the device type, the backend and the
    mesh entries the decode spans (``ops.shard_width``), so a change of
    mesh is a new shape, not a rebuild storm."""
    return (B, T, K, device, _backend(device, decode), mesh)


class _DispatchSpan:
    """Times one decode dispatch and credits library builds to its shape;
    updates the shape table and the decode.* metrics on exit."""

    __slots__ = ("B", "T", "K", "device", "decode", "mesh", "_acc", "_t0")

    def __init__(self, B: int, T: int, K: int, device: str, decode: str,
                 mesh: int = 1):
        self.B = B
        self.T = T
        self.K = K
        self.device = device
        self.decode = decode
        self.mesh = mesh

    def __enter__(self):
        _ensure_listener()
        self._acc = [0, 0.0]
        _tls.active = self._acc
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        elapsed = time.perf_counter() - self._t0
        _tls.active = None
        if exc_type is not None:
            # a failed dispatch's wall is time to failure, not latency
            return False
        calls, build_s = self._acc
        built = calls > 0
        key = _shape_key(self.B, self.T, self.K, self.device, self.decode,
                         self.mesh)
        global _compile_episodes
        with _lock:
            st = _shapes.get(key)
            if st is None:
                st = _shapes[key] = {
                    "B": self.B, "T": self.T, "K": self.K,
                    "platform": key[3], "backend": key[4], "mesh": key[5],
                    "dispatches": 0, "compiles": 0,
                    "compile_calls": 0, "compile_s": 0.0,
                    "first_s": elapsed, "steady_n": 0,
                    "steady_total_s": 0.0, "steady_max_s": 0.0,
                    "launches": 0, "launch_s": 0.0, "launch_max_s": 0.0}
            st["dispatches"] += 1
            recompiled = False
            if built:
                recompiled = st["compiles"] >= 1
                st["compiles"] += 1
                st["compile_calls"] += calls
                st["compile_s"] += build_s
                _compile_episodes += 1
            else:
                st["steady_n"] += 1
                st["steady_total_s"] += elapsed
                if elapsed > st["steady_max_s"]:
                    st["steady_max_s"] = elapsed
        if built:
            metrics.count("decode.compile.count")
            metrics.observe("decode.compile", build_s)
            metrics.observe("decode.dispatch.first", elapsed)
            if recompiled:
                metrics.count("decode.compile.recompiles")
                logger.warning(
                    "recompile storm: decode shape B=%d T=%d K=%d (%s/%s) "
                    "built again (%d episodes, %.0f ms this time); a "
                    "steady-state service builds each kernel once",
                    self.B, self.T, self.K, key[3], key[4], st["compiles"],
                    build_s * 1e3)
        else:
            metrics.observe("decode.dispatch.steady", elapsed)
        return False


def dispatch_span(B: int, T: int, K: int, device: str = "cpu",
                  decode: str = "fused", mesh: int = 1) -> _DispatchSpan:
    """Wrap one decode dispatch (the matcher's dispatch lane) on a device
    of type ``device`` ("cuda" or "cpu") by the decode named ``decode``
    (``ops.DECODES``) over ``mesh`` entries (``ops.shard_width``)."""
    return _DispatchSpan(B, T, K, device, decode, mesh)


def note_launch(B: int, T: int, K: int, device: str,
                seconds: float) -> None:
    """One launch's latency, measured by a CUDA event pair around it
    and read after the drain lane's event wait (the fused decode's
    kernel: the only decode that is one launch)."""
    key = _shape_key(B, T, K, device)
    with _lock:
        st = _shapes.get(key)
        if st is not None:
            st["launches"] += 1
            st["launch_s"] += seconds
            if seconds > st["launch_max_s"]:
                st["launch_max_s"] = seconds
    metrics.observe("decode.launch.latency", seconds)


def compile_count() -> int:
    with _lock:
        return _compile_episodes


# ---- wide events -----------------------------------------------------------

def note_queue_depth(depth: int, name: str = "dispatch") -> None:
    """A named dispatcher's backlog after draining a batch, stamped into
    each wide event as the queue depth at dispatch."""
    with _lock:
        _queue_depths[name] = int(depth)


def queue_depth(name: Optional[str] = None) -> int:
    """One dispatcher's last-noted depth, or with no name the largest of
    them."""
    with _lock:
        if name is not None:
            return _queue_depths.get(name, 0)
        return max(_queue_depths.values(), default=0)


def queue_depths() -> Dict[str, int]:
    """Every named gauge (the /profile per-dispatcher view)."""
    with _lock:
        return dict(_queue_depths)


def _reset_queue_depths() -> None:
    """Fork hook: a pre-fork child's gauges start empty (the parent's
    describe queues the child does not own)."""
    with _lock:
        _queue_depths.clear()


def chunk_event(bucket_T: int, K: int, traces: int, rows: int,
                kept_points: int, raw_points: int,
                cache: Optional[dict] = None,
                path: str = "native") -> None:
    """Record one decode chunk's wide event (once per chunk, from the
    matcher's dispatch paths). ``rows`` is the padded batch dimension,
    so ``rows * bucket_T`` is the point-slot grid the device decodes;
    ``kept_points`` is how many of those slots carry a kept probe."""
    # lazy: batchpad sits under matcher/, which imports this module
    from ..matcher.batchpad import occupancy_stats
    global _total_kept, _total_cells
    cells, occupancy, waste = occupancy_stats(kept_points, rows, bucket_T)
    ctx = obs_trace.current()
    event = {
        "ts_ms": int(time.time() * 1000),
        "trace_id": ctx[0] if ctx is not None else None,
        "path": path,
        "bucket_T": int(bucket_T),
        "K": int(K),
        "traces": int(traces),
        "rows": int(rows),
        "raw_points": int(raw_points),
        "kept_points": int(kept_points),
        "padded_cells": int(cells),
        "occupancy": round(occupancy, 6),
        "padding_waste": round(waste, 6),
        "queue_depth": queue_depth(),
    }
    if cache:
        event["cache"] = cache
    with _lock:
        _events.extend((event,))
        _total_kept += int(kept_points)
        _total_cells += int(cells)
        tot = _bucket_totals.get(int(bucket_T))
        if tot is None:
            tot = _bucket_totals[int(bucket_T)] = [0, 0]
        tot[0] += int(kept_points)
        tot[1] += int(cells)
    metrics.count("profile.chunks")
    # the ratio rides the log-bucket timer machinery (units: ratio, not
    # seconds): p50/p95/p99 occupancy per bucket on /stats and /metrics
    metrics.observe(f"decode.occupancy.t{int(bucket_T)}", occupancy)


def recent_events(n: Optional[int] = 16) -> List[dict]:
    """The last ``n`` wide events, oldest first (a copy); ``n=0`` none,
    ``None`` the whole ring."""
    with _lock:
        evs = list(_events)
    if n is None:
        return evs
    return evs[-n:] if n > 0 else []


def padding_waste() -> Optional[float]:
    """Lifetime padding-waste ratio over every recorded chunk; None
    before the first."""
    with _lock:
        if not _total_cells:
            return None
        return 1.0 - _total_kept / _total_cells


def bucket_waste(bucket_T: int) -> Optional[float]:
    """Recorded padding-waste ratio of one bucket; None before its first
    chunk."""
    with _lock:
        tot = _bucket_totals.get(int(bucket_T))
        if not tot or not tot[1]:
            return None
        return 1.0 - tot[0] / tot[1]


# ---- the decode shadow ------------------------------------------------------

def shadow_fraction() -> float:
    return _shadow_frac


def set_shadow_suspended(on: bool) -> None:
    """Suspend or resume shadow sampling (the accumulator does not advance
    while suspended)."""
    global _shadow_suspended
    with _lock:
        _shadow_suspended = bool(on)


def _ensure_shadow_pool() -> ThreadPoolExecutor:
    global _shadow_pool
    with _lock:
        if _shadow_pool is None:
            _shadow_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="shadow-decode")
        return _shadow_pool


def _host_routes(batch) -> np.ndarray:
    """A batch's route tensor on the host as the decode read it: device
    routes come from the prep dict they are written back into
    (``PaddedBatch.routes_to_host``, which waits for their copy), cast
    to the wire's dtype (torch and numpy both round to nearest even)."""
    import torch
    route = batch.route_m
    if not isinstance(route, torch.Tensor):
        return route
    batch.routes_to_host()
    host = batch.prep["route_m"]
    if batch.dist_m.dtype == np.float16:
        with np.errstate(over="ignore"):
            return host.astype(np.float16)
    return host


def maybe_shadow(batch, decoded: np.ndarray, n_real: int,
                 sigma: float, beta: float) -> None:
    """Sample this chunk for the shadow (deterministic accumulator: a
    fraction of 0.25 samples exactly every 4th chunk). The plain scan
    runs on one background thread; past ``_SHADOW_MAX_PENDING_BYTES`` of
    waiting chunks, chunks are shed (``decode.shadow.dropped``) rather
    than queued without bound."""
    frac = _shadow_frac
    if frac <= 0.0 or n_real <= 0:
        return
    if _shadow_suspended:
        metrics.count("decode.shadow.suppressed")
        return
    global _shadow_acc, _shadow_pending, _shadow_pending_bytes
    with _lock:
        _shadow_acc += min(frac, 1.0)
        if _shadow_acc < 1.0:
            return
        _shadow_acc -= 1.0
    try:
        arrays = (batch.dist_m, batch.valid, _host_routes(batch),
                  batch.gc_m, batch.case, np.asarray(decoded))
        nbytes = sum(int(np.asarray(a).nbytes) for a in arrays)
        with _lock:
            shed = _shadow_pending > 0 and _shadow_pending_bytes + nbytes \
                > _SHADOW_MAX_PENDING_BYTES
            if not shed:
                _shadow_pending += 1
                _shadow_pending_bytes += nbytes
        if shed:
            metrics.count("decode.shadow.dropped")
            return
    except Exception as e:
        metrics.count("decode.shadow.errors")
        logger.error("shadow sampling failed (chunk skipped): %s", e)
        return
    try:
        pool = _ensure_shadow_pool()
        pool.submit(_shadow_job, *arrays, n_real, float(sigma), float(beta),
                    nbytes)
    except Exception as e:
        # the sampler never takes serving down, and the reserved slot
        # must not leak
        with _lock:
            _shadow_pending -= 1
            _shadow_pending_bytes -= nbytes
        metrics.count("decode.shadow.errors")
        logger.error("shadow submit failed (chunk skipped): %s", e)


def _path_scores_f64(dist, route, gc, case, paths, n, sigma: float,
                     beta: float, normal_code: int,
                     unreachable: float) -> np.ndarray:
    """(B,) f64 re-scores of ``paths`` over each row's first ``n[b]``
    points, independent of either decoder's accumulation order; -inf
    where a path crosses an unroutable transition (always a mismatch)."""
    B, T = case.shape
    t = np.arange(T)
    live = t[None, :] < n[:, None]
    p = np.asarray(paths[:, :T], dtype=np.int64)
    d = np.take_along_axis(dist, p[:, :, None], 2)[:, :, 0].astype(
        np.float64)
    total = np.where(live, -0.5 * (d / sigma) ** 2, 0.0).sum(axis=1)
    if T > 1:
        r = route[np.arange(B)[:, None], t[None, :-1], p[:, :-1],
                  p[:, 1:]].astype(np.float64)
        normal = live[:, 1:] & (case[:, 1:] == normal_code)
        dev = np.abs(r - gc[:, :T - 1].astype(np.float64))
        total += np.where(normal, -dev / beta, 0.0).sum(axis=1)
        total[(normal & (r >= unreachable)).any(axis=1)] = -np.inf
    return total


def _shadow_job(dist, valid, route, gc, case, decoded, n_real: int,
                sigma: float, beta: float, nbytes: int) -> None:
    global _shadow_sampled, _shadow_mismatch, _shadow_pending, \
        _shadow_pending_bytes
    try:
        import torch
        # lazy: hmm sits under matcher/, which imports this module
        from ..matcher.hmm import (NORMAL, SKIP, UNREACHABLE_THRESHOLD,
                                   viterbi_decode_batch)
        T = dist.shape[1]
        # the native layout carries a dead trailing time row
        dist, valid, case = (np.asarray(a[:n_real])
                             for a in (dist, valid, case))
        route = np.asarray(route[:n_real, :max(T - 1, 0)])
        gc = np.asarray(gc[:n_real, :max(T - 1, 0)])
        oracle, _ = viterbi_decode_batch(
            *(torch.from_numpy(np.ascontiguousarray(a))
              for a in (dist, valid, route, gc, case)), sigma, beta)
        n = np.count_nonzero(case != SKIP, axis=1)
        s_dev, s_plain = (
            _path_scores_f64(dist, route, gc, case, paths, n, sigma, beta,
                             NORMAL, UNREACHABLE_THRESHOLD)
            for paths in (np.asarray(decoded)[:n_real], oracle.numpy()))
        # path quality: a differently broken exact tie is agreement
        mismatches = int(((n > 0) & ~(np.abs(s_dev - s_plain)
                                      <= SHADOW_SCORE_TOL)).sum())
        metrics.count("decode.shadow.chunks")
        metrics.count("decode.shadow.sampled", n_real)
        if mismatches:
            metrics.count("decode.shadow.mismatch", mismatches)
            logger.warning(
                "shadow decode: %d/%d traces in a sampled chunk scored "
                "differently from the plain scan", mismatches, n_real)
        metrics.observe("decode.shadow.mismatch_ratio",
                        mismatches / n_real)
        with _lock:
            _shadow_sampled += n_real
            _shadow_mismatch += mismatches
    except Exception as e:  # the sampler never takes serving down
        metrics.count("decode.shadow.errors")
        logger.error("shadow decode failed (chunk skipped): %s", e)
    finally:
        with _lock:
            _shadow_pending -= 1
            _shadow_pending_bytes -= nbytes


def shadow_stats() -> dict:
    with _lock:
        return {"fraction": _shadow_frac,
                "sampled": _shadow_sampled,
                "mismatch": _shadow_mismatch,
                "pending": _shadow_pending,
                "suspended": _shadow_suspended}


def shadow_mismatches() -> int:
    with _lock:
        return _shadow_mismatch


def drain_shadow(timeout_s: float = 30.0) -> bool:
    """Block until no shadow chunk is in flight; True when drained,
    False on timeout."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with _lock:
            if _shadow_pending == 0:
                return True
        time.sleep(0.005)
    return False


def shutdown_shadow_pool(timeout_s: float = 30.0) -> bool:
    """Drain in-flight shadow chunks, then join the sampler thread; a
    later :func:`maybe_shadow` makes a new pool. True when the drain
    completed."""
    global _shadow_pool
    drained = drain_shadow(timeout_s)
    with _lock:
        pool, _shadow_pool = _shadow_pool, None
    if pool is not None:
        pool.shutdown(wait=True)
    return drained


# ---- export ----------------------------------------------------------------

def _shape_view(st: dict) -> dict:
    """One shape-table row as the /profile wire form."""
    n, nl = st["steady_n"], st["launches"]
    return {
        "B": st["B"], "T": st["T"], "K": st["K"],
        "platform": st["platform"],
        "backend": st["backend"],
        "mesh": st["mesh"],
        "dispatches": st["dispatches"],
        "compiles": st["compiles"],
        "compile_calls": st["compile_calls"],
        "compile_s": round(st["compile_s"], 6),
        "first_s": round(st["first_s"], 6),
        "steady": {"n": n,
                   "mean_s": round(st["steady_total_s"] / n, 6)
                   if n else 0.0,
                   "max_s": round(st["steady_max_s"], 6)},
        "launch_latency": {"n": nl,
                           "mean_s": round(st["launch_s"] / nl, 9)
                           if nl else 0.0,
                           "max_s": round(st["launch_max_s"], 9)},
    }


def snapshot(n_events: int = 64) -> dict:
    """The ``/profile`` payload: per-shape build, dispatch and launch
    latency stats, the last ``n_events`` wide events, lifetime occupancy
    totals, shadow verdicts, route-kernel counters and the dispatcher
    queue depths."""
    with _lock:
        raw = [dict(st) for st in _shapes.values()]
        kept, cells = _total_kept, _total_cells
        depths = dict(_queue_depths)
        episodes = _compile_episodes
    shapes = [_shape_view(st) for st in raw]
    shapes.sort(key=lambda s: (s["T"], s["K"], s["B"]))
    return {
        "shapes": shapes,
        "compile_episodes": episodes,
        "events": recent_events(n_events),
        "totals": {
            "kept_points": kept,
            "padded_cells": cells,
            "padding_waste": round(1.0 - kept / cells, 6) if cells
            else None},
        "shadow": shadow_stats(),
        "routes": route_kernel_stats(),
        "queue_depth": max(depths.values(), default=0),
        "queue_depths": depths,
    }


def route_kernel_stats() -> dict:
    """The device route kernel's counters (``graph/route_device.py``) for
    ``/profile``: chunks it routed (0 with host routes), their pairs and
    sources, node-kernel cache rows, and its relaxations."""
    c = metrics.default.counter
    return {
        "device_chunks": c("route.device.chunks"),
        "device_pairs": c("route.device.pairs"),
        "device_sources": c("route.device.sources"),
        "deferred_chunks": c("route.device.deferred_chunks"),
        "cache_hit_rows": c("route.device.cache_hit_rows"),
        "cache_miss_rows": c("route.device.cache_miss_rows"),
        "empty_chunks": c("route.device.empty_chunks"),
        "nonconverged": c("route.device.nonconverged"),
        "budget_exceeded": c("route.device.budget_exceeded"),
        "relaxes": c("route.device.relaxes"),
        "sweeps": c("route.device.sweeps"),
    }


def reset() -> None:
    """Drop every table, ring and total, and the shadow's counts."""
    global _total_kept, _total_cells, _compile_episodes, _events, \
        _shadow_acc, _shadow_pending, _shadow_pending_bytes, \
        _shadow_sampled, _shadow_mismatch, _shadow_suspended
    with _lock:
        _shapes.clear()
        _bucket_totals.clear()
        _queue_depths.clear()
        _shadow_suspended = False
        _total_kept = 0
        _total_cells = 0
        _compile_episodes = 0
        _shadow_acc = 0.0
        _shadow_pending = 0
        _shadow_pending_bytes = 0
        _shadow_sampled = 0
        _shadow_mismatch = 0
        _events = _new_ring(_events_size)


from ..utils import forksafe as _forksafe  # noqa: E402

_forksafe.register(_reset_queue_depths)
