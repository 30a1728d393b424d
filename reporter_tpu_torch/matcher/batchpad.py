"""Host-side trace preparation: candidates, route tensors, padding buckets.

Two pieces of irregularity are resolved here so the device decode stays
fixed-shape and branch-free:

1. **Point filtering.** Probe points closer than ``interpolation_distance``
   to the last kept point (GPS jitter while slow/stopped) and points with no
   candidate edges are *excluded* from the HMM; the Viterbi runs over the
   kept subsequence only, and excluded jitter points are attributed to the
   decoded runs afterwards (assemble.py).

2. **Bucketed padding.** Kept subsequences are padded to the smallest bucket
   in ``LENGTH_BUCKETS``, so the decode sees a handful of shapes.

Two preps give the same tensors: :func:`prepare_traces_numpy` +
:func:`pack_batches` (numpy, per trace) and :func:`prepare_batch` (one
call into the native host runtime per chunk, whose route costs may come
from the device route kernel instead, ``graph/route_device.py``).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from ..core.geo import equirectangular_m
from ..core.tracebatch import TraceBatch
from ..graph.network import RoadNetwork
from ..graph.route import RouteCache, candidate_route_matrices, UNREACHABLE
from ..graph.spatial import CandidateSet, SpatialGrid, PAD_EDGE, PAD_DIST
from ..obs import trace as obs_trace
from ..utils import metrics
from .hmm import NORMAL, RESTART, SKIP, UNREACHABLE_THRESHOLD, WIRE_MAX_M
from .params import MatchParams
from .slab import Slab

LENGTH_BUCKETS = (16, 64, 256, 1024)
#: padding-waste ratio above which the native dispatch breaks a
#: mixed-length bucket into power-of-two sub-buckets
#: (``SegmentMatcher._split_bucket``): a 17-point trace padded to T=64
#: (waste ~0.73) splits, an exactly filled bucket never does
SPLIT_WASTE = 0.35

#: the pressure ladder's ``coarse_buckets`` rung (service/admission.py):
#: under sustained overload the adaptive splitter is off, so fewer,
#: larger decode shapes and no split dispatches. One global load where
#: the splitter reads it
_pressure_coarse = False


def set_pressure_coarse(on: bool) -> None:
    global _pressure_coarse
    _pressure_coarse = bool(on)


class DeviceRouteError(RuntimeError):
    """The device route kernel failed on a chunk (the ``route.device``
    failure domain). Raised out of :func:`prepare_batch` as its own type,
    so the native prep's breaker does not take it for a native prep
    failure and re-prep the chunk's routes on the host."""


def split_threshold() -> float:
    """The padding waste above which a bucket splits: ``SPLIT_WASTE``, or
    1.0 (never split) while the ``coarse_buckets`` rung holds."""
    return 1.0 if _pressure_coarse else SPLIT_WASTE


def bucket_length(n: int) -> int:
    """Smallest bucket >= n (the last bucket caps the trace length)."""
    idx = bisect.bisect_left(LENGTH_BUCKETS, n)
    return LENGTH_BUCKETS[min(idx, len(LENGTH_BUCKETS) - 1)]


def kept_point_count(batch: "PaddedBatch") -> int:
    """Kept (non-SKIP) probe points across a padded batch: filler rows
    and padding tails are all-SKIP."""
    return int(np.count_nonzero(np.asarray(batch.case) != SKIP))


def occupancy_stats(kept_points: int, rows: int, T: int
                    ) -> "tuple[int, float, float]":
    """(padded point cells, occupancy, padding-waste ratio) for a batch
    padded to ``rows`` traces of bucket length ``T``: the waste is the
    fraction of decoded point slots that carry no real probe (the
    candidate width K scales both sides, so it cancels)."""
    cells = rows * T
    occ = kept_points / cells if cells else 0.0
    return cells, occ, 1.0 - occ


def padded_batch_rows(B: int, pad: "int | None" = None) -> int:
    """Rows a native batch of B traces decodes as: a multiple of ``pad``
    (a decode mesh's data width, so the mesh divides the batch), then the
    next power of two where that stays a multiple (the JAX package's
    policy); the power of two bounds the launch shapes per bucket. The
    filler rows are all-SKIP and decode to nothing."""
    rows = B
    if pad:
        rows = -(-rows // pad) * pad
    p2 = 1 << max(rows - 1, 0).bit_length()
    if not pad or p2 % pad == 0:
        rows = p2
    return rows


@dataclass
class PreparedTrace:
    """One trace's fixed-width tensors, padded to bucket length T.

    Tensor rows 0..num_kept-1 correspond to the *kept* points;
    ``kept_idx`` maps them back to indices in the original trace.
    """
    num_raw: int           # points in the original trace
    num_kept: int          # points included in the HMM
    kept_idx: np.ndarray   # (num_kept,) i32 original indices
    times: np.ndarray      # (num_raw,) f64 epoch seconds
    edge_ids: np.ndarray   # (T, K) i32
    dist_m: np.ndarray     # (T, K) f32
    offset_m: np.ndarray   # (T, K) f32
    route_m: np.ndarray    # (T-1, K, K) f32
    gc_m: np.ndarray       # (T-1,) f32
    case: np.ndarray       # (T,) i32
    # seconds the raw tail verifiably dwelt at the last kept point (jitter
    # drops only; 0 when the tail was off-network or bucket-truncated)
    trailing_jitter_dwell_s: float = 0.0
    # (num_raw,) bool: raw point had any candidate edge
    has_cands: "np.ndarray | None" = None

    @property
    def T(self) -> int:
        return self.edge_ids.shape[0]


def _select_kept(lat, lon, has_cands, interpolation_distance):
    """Indices of points that enter the HMM: drop candidate-less points and
    points within ``interpolation_distance`` of the last kept point.

    Vectorised common case: when every consecutive pair of candidate-
    bearing points is at least the interpolation distance apart (a moving
    vehicle), the anchor never skips a point and the answer is one array
    op. The sequential scan only runs from the first violation onward,
    where the moving-anchor semantics are irreducibly order-dependent.
    """
    has = np.asarray(has_cands, dtype=bool)
    idx = np.flatnonzero(has)
    if idx.size <= 1:
        return idx.astype(np.int32)
    lat = np.asarray(lat)
    lon = np.asarray(lon)
    gc = np.atleast_1d(equirectangular_m(lat[idx[:-1]], lon[idx[:-1]],
                                         lat[idx[1:]], lon[idx[1:]]))
    viol = np.flatnonzero(gc < interpolation_distance)
    if viol.size == 0:
        return idx.astype(np.int32)
    j = int(viol[0])  # pairs before the first violation are all kept
    kept = idx[:j + 1].tolist()
    for i in idx[j + 1:].tolist():
        gc_i = equirectangular_m(lat[kept[-1]], lon[kept[-1]],
                                 lat[i], lon[i])
        if gc_i < interpolation_distance:
            continue
        kept.append(i)
    return np.asarray(kept, dtype=np.int32)


def prepare_traces_numpy(net: RoadNetwork, grid: SpatialGrid,
                         tb: TraceBatch, params: MatchParams,
                         cache: RouteCache | None = None,
                         prune_margin_m: float = 0.0,
                         ) -> List[PreparedTrace]:
    """Whole-chunk host prep: ONE vectorised candidate search over every
    point of every trace in the chunk, then per-trace route tensors
    through the shared cross-batch route cache. The grid query is a pure
    per-point function, so each trace's slice equals a per-trace lookup.
    ``prune_margin_m`` > 0 prunes each kept point's candidates as the
    native prep does (:func:`_prune_candidates`)."""
    K = params.max_candidates
    all_c = grid.candidates(tb.lat, tb.lon, K, params.search_radius)
    has_all = (all_c.edge_ids != PAD_EDGE).any(axis=1)
    out = []
    offsets = tb.offsets
    for b in range(len(tb)):
        lo, hi = int(offsets[b]), int(offsets[b + 1])
        sub = CandidateSet(
            edge_ids=all_c.edge_ids[lo:hi], dist_m=all_c.dist_m[lo:hi],
            offset_m=all_c.offset_m[lo:hi], proj_x=all_c.proj_x[lo:hi],
            proj_y=all_c.proj_y[lo:hi])
        out.append(_prepare_from_candidates(
            net, tb.lat[lo:hi], tb.lon[lo:hi], tb.time[lo:hi], sub,
            has_all[lo:hi], params, cache, prune_margin_m))
    return out


def _prepare_from_candidates(net, lat, lon, times, all_cands, has_cands,
                             params: MatchParams, cache,
                             prune_margin_m: float) -> PreparedTrace:
    """Kept-point selection, route tensors, case codes and padding for one
    trace whose candidate lookup already happened."""
    num_raw = len(lat)
    K = params.max_candidates
    kept = _select_kept(lat, lon, has_cands, params.interpolation_distance)
    n = len(kept)
    T = bucket_length(max(n, 1))
    truncated = n > T
    if truncated:  # cap at the largest bucket
        kept = kept[:T]
        n = T

    # dwell time of a *jitter-only* trailing tail: every raw point after the
    # last kept one must have candidates and sit within the interpolation
    # distance of that kept point — i.e. the vehicle verifiably stayed put.
    # Tails dropped for lacking candidates (off-network driving) or by
    # bucket truncation carry no such guarantee and count no dwell. Used by
    # segment assembly to detect a vehicle queued at trace end.
    trailing_jitter_dwell_s = 0.0
    if n and not truncated and int(kept[-1]) < num_raw - 1:
        lk = int(kept[-1])
        tail = np.arange(lk + 1, num_raw)
        tail_gc = equirectangular_m(lat[lk], lon[lk], lat[tail], lon[tail])
        if bool(has_cands[tail].all()) and \
                bool((np.atleast_1d(tail_gc)
                      < params.interpolation_distance).all()):
            trailing_jitter_dwell_s = float(times[num_raw - 1] - times[lk])

    cands = CandidateSet(
        edge_ids=all_cands.edge_ids[kept], dist_m=all_cands.dist_m[kept],
        offset_m=all_cands.offset_m[kept], proj_x=all_cands.proj_x[kept],
        proj_y=all_cands.proj_y[kept])
    cands = _prune_candidates(cands, prune_margin_m)

    gc = equirectangular_m(lat[kept[:-1]], lon[kept[:-1]],
                           lat[kept[1:]], lon[kept[1:]]) if n > 1 else np.zeros(0)
    gc = np.atleast_1d(np.asarray(gc, dtype=np.float32))

    # probe time deltas between consecutive KEPT points feed Meili's
    # max_route_time_factor admissibility bound; None disables the bound
    # entirely (factor <= 0)
    dt = None
    if params.max_route_time_factor > 0 and n > 1:
        dt = np.diff(times[kept])

    route = candidate_route_matrices(
        net, cands, gc,
        max_route_distance_factor=params.max_route_distance_factor,
        cache=cache,
        backward_tolerance_m=params.backward_tolerance_m,
        dt=dt, max_route_time_factor=params.max_route_time_factor,
        min_time_bound_s=params.min_time_bound_s,
        turn_penalty_factor=params.turn_penalty_factor)

    # case codes over kept points: RESTART at the first point and after
    # breakage-sized gaps; SKIP only in the padding tail
    case = np.full(T, SKIP, dtype=np.int32)
    if n:
        case[:n] = NORMAL
        case[0] = RESTART
        if n > 1:
            case[1:n][gc[:n - 1] > params.breakage_distance] = RESTART

    # pad to bucket
    edge_ids = np.full((T, K), PAD_EDGE, dtype=np.int32)
    dist = np.full((T, K), PAD_DIST, dtype=np.float32)
    offset = np.zeros((T, K), dtype=np.float32)
    route_p = np.full((max(T - 1, 0), K, K), UNREACHABLE, dtype=np.float32)
    gc_p = np.zeros(max(T - 1, 0), dtype=np.float32)

    edge_ids[:n] = cands.edge_ids
    dist[:n] = cands.dist_m
    offset[:n] = cands.offset_m
    if n > 1:
        route_p[:n - 1] = route
        gc_p[:n - 1] = gc

    return PreparedTrace(num_raw=num_raw, num_kept=n, kept_idx=kept,
                         times=times, edge_ids=edge_ids, dist_m=dist,
                         offset_m=offset, route_m=route_p, gc_m=gc_p,
                         case=case,
                         trailing_jitter_dwell_s=trailing_jitter_dwell_s,
                         has_cands=np.asarray(has_cands))


def _prune_candidates(cands: CandidateSet, margin: float) -> CandidateSet:
    """The native prep's candidate pruning: per point, drop the
    distance-sorted suffix beyond ``dist[0] + margin``. The best
    candidate always survives; pad slots stay pad."""
    if margin <= 0 or cands.edge_ids.size == 0:
        return cands
    live = cands.edge_ids != PAD_EDGE
    cut = (cands.dist_m > cands.dist_m[:, :1] + np.float32(margin)) & live
    if not cut.any():
        return cands
    return CandidateSet(
        edge_ids=np.where(cut, PAD_EDGE, cands.edge_ids),
        dist_m=np.where(cut, PAD_DIST, cands.dist_m),
        offset_m=np.where(cut, np.float32(0.0), cands.offset_m),
        proj_x=cands.proj_x, proj_y=cands.proj_y)


class _LazyTraceViews:
    """Sequence of PreparedTrace views over a native batch, built on first
    element access: the native matcher only takes ``len()``."""

    def __init__(self, n: int, build):
        self._n = n
        self._build = build
        self._views: List[PreparedTrace] | None = None

    def _mat(self) -> List[PreparedTrace]:
        if self._views is None:
            self._views = self._build()
        return self._views

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        return self._mat()[i]

    def __iter__(self):
        return iter(self._mat())


@dataclass
class PaddedBatch:
    """A device-ready batch of same-bucket traces: host numpy arrays, but
    for ``route_m`` after a device route fill (a tensor on the route
    kernel's device)."""
    traces: "List[PreparedTrace] | _LazyTraceViews"
    dist_m: np.ndarray   # (B, T, K) f16 wire or f32
    valid: np.ndarray    # (B, T, K) bool
    # route/gc time rows: T-1 from pack_batches, T from prepare_batch (a
    # dead last step); the decode takes either
    route_m: "np.ndarray | torch.Tensor | None"  # (B, T-1|T, K, K) f16/f32
    gc_m: np.ndarray     # (B, T-1 | T) f16 wire or f32
    case: np.ndarray     # (B, T) i32
    # prepare_batch only: the native prep's tensors and the chunk's flat
    # point offsets and times, which the native assembly reads
    prep: "dict | None" = None
    pt_off: "np.ndarray | None" = None      # (B+1,) i64
    times_flat: "np.ndarray | None" = None  # flat f64 raw probe times
    # deferred device routes (prepare_batch(defer_routes=True)): the
    # decode stage runs ``finalize`` once before it reads the tensors, and
    # waits for the route tensor's finite max there instead of in prep;
    # route_m is None until it has run. ``routes`` (a graph.route_device.
    # DeferredRoutes) copies the route bytes back into ``prep``
    finalize: "object | None" = None
    routes: "object | None" = None
    # the host slab whose views dist_m, valid, route_m, gc_m and case are
    # (prepare_batch with a slab allocator, f16 wire): the dispatch lane
    # uploads it in one copy (``slab.upload``); held until the drain
    slab: "Slab | None" = None

    def finalize_wire(self) -> None:
        """Install the deferred route tensor and settle the wire dtype; a
        no-op for a batch built without deferred routes, and after the
        first call."""
        f, self.finalize = self.finalize, None
        if f is not None:
            f(self)

    def routes_to_host(self) -> None:
        """Write deferred device routes into the prep dict, waiting for
        their copy back (a no-op without them, and after the first
        call)."""
        if self.routes is not None:
            self.routes.write_back(self.prep)


def _f16_safe(p: PreparedTrace) -> bool:
    """True when every finite distance in the trace fits the f16 wire
    undistorted (sentinel values >= UNREACHABLE_THRESHOLD travel as +inf)."""
    if p.gc_m.size and float(np.amax(p.gc_m)) > WIRE_MAX_M:
        return False
    for arr in (p.route_m, p.dist_m):
        if arr.size and float(np.amax(
                arr, initial=0.0,
                where=arr < UNREACHABLE_THRESHOLD)) > WIRE_MAX_M:
            return False
    return True


def pack_batches(prepared: Sequence[PreparedTrace],
                 pad_rows: "int | None" = None) -> List[PaddedBatch]:
    """Group prepared traces by bucket length and stack into batches of
    exactly the group's size: the decode kernel takes any batch size, so
    no filler rows are shipped or decoded, but with ``pad_rows`` (a
    decode mesh's data width) each batch is padded with all-SKIP rows to
    its multiple, so that the mesh divides it.

    The float tensors are built in the f16 wire format — the cast happens
    inside the copy the pack already performs, halving host->device
    bytes; the unreachable/pad sentinels overflow to +inf, which the
    decode's scoring treats identically (matcher/hmm.py). A bucket
    containing any trace with finite distances beyond ``WIRE_MAX_M``
    ships f32 instead: that is a rule of the data, not a setting.
    """
    by_T: dict[int, List[PreparedTrace]] = {}
    for p in prepared:
        by_T.setdefault(p.T, []).append(p)

    batches = []
    for T, group in sorted(by_T.items()):
        dtype = np.float16 if all(map(_f16_safe, group)) else np.float32
        B = len(group)
        if pad_rows:
            B = -(-B // pad_rows) * pad_rows
        K = group[0].edge_ids.shape[1]
        with np.errstate(over="ignore"):  # sentinels overflow f16 to +inf
            dist = np.full((B, T, K), PAD_DIST, dtype=dtype)
            valid = np.zeros((B, T, K), dtype=bool)
            route = np.full((B, max(T - 1, 0), K, K), UNREACHABLE,
                            dtype=dtype)
            gc = np.zeros((B, max(T - 1, 0)), dtype=dtype)
            case = np.full((B, T), SKIP, dtype=np.int32)
            for b, p in enumerate(group):
                dist[b] = p.dist_m
                valid[b] = p.edge_ids != PAD_EDGE
                route[b] = p.route_m
                gc[b] = p.gc_m
                case[b] = p.case
        batches.append(PaddedBatch(traces=group, dist_m=dist, valid=valid,
                                   route_m=route, gc_m=gc, case=case))
    return batches


def prepare_batch(runtime, tb: TraceBatch, params: MatchParams, T: int,
                  pad_rows: int | None = None,
                  n_threads: int = 0, route_kernel=None,
                  route_circuit=None, defer_routes: bool = False,
                  prune_margin_m: float = 0.0,
                  slab_alloc=None) -> PaddedBatch:
    """Whole-chunk host prep through ONE native call
    (``NativeRuntime.prepare_batch``), with the per-trace semantics of
    :func:`prepare_traces_numpy`: the flat coordinate columns of ``tb``
    go straight to C++ threads, which write padded (rows, T, ...)
    tensors.

    ``T`` is the padding bucket every trace of the chunk shares (callers
    bucket by raw length first); ``pad_rows`` >= B adds all-SKIP filler
    rows. Float tensors ship on the f16 wire when every finite distance
    the prep wrote is at most ``WIRE_MAX_M`` (the prep's ``max_finite``),
    else f32, as :func:`pack_batches` decides. route_m and gc_m carry T
    time rows (a dead last step). ``prune_margin_m`` > 0 prunes
    candidates in the native prep.

    ``route_kernel`` (``graph.route_device.DeviceRouteKernel``) moves the
    route costs to its device: the native call skips its route search
    and the kernel fills ``route_m`` from one batched relaxation. A
    device failure raises :class:`DeviceRouteError` and counts a failure
    on ``route_circuit`` (the ``route.device`` failure domain) when one
    is given; while that breaker is open the chunk is refused after the
    native call and before any launch
    (:class:`~..utils.circuit.CircuitOpen`), so a half-open probe is
    taken only where its outcome is recorded. Nothing re-preps the chunk
    with host routes: that would move the card's work to the host. With
    ``defer_routes=True`` the route tensor stays on the device:
    ``route_m`` is None and the batch carries a ``finalize`` that the
    decode stage runs (:meth:`PaddedBatch.finalize_wire`), which installs
    the padded (rows, T, K, K) tensor on the device and decides the wire
    dtype from the same folded ``max_finite`` the synchronous path reads.
    The route bytes reach the prep dict through ``routes``
    (:meth:`PaddedBatch.routes_to_host`), which the assembly and the
    per-trace views wait on.

    ``slab_alloc`` (bytes -> ``uint8`` tensor; ``slab.pinned`` on the
    card) stages the f16 wire in one host slab (:class:`slab.Slab`): the
    casts, the valid mask and the case codes are written straight into
    its views, which become the batch's arrays, bit-equal to those made
    without one. The f32 wire and deferred routes leave the slab to the
    dispatch lane (``slab.stage``): their arrays are the prep's own, or
    made there.

    The batch's ``traces`` are PreparedTrace views over rows of the f32
    tensors, built on first access.
    """
    B = len(tb)
    pt_off, times = tb.offsets, tb.time
    counts = np.diff(pt_off)
    out = runtime.prepare_batch(
        pt_off, tb.lat, tb.lon, times, T, params.max_candidates,
        search_radius=params.search_radius,
        interpolation_distance=params.interpolation_distance,
        breakage_distance=params.breakage_distance,
        max_route_distance_factor=params.max_route_distance_factor,
        backward_tolerance_m=params.backward_tolerance_m,
        max_route_time_factor=params.max_route_time_factor,
        min_time_bound_s=params.min_time_bound_s,
        turn_penalty_factor=params.turn_penalty_factor,
        prune_margin_m=prune_margin_m,
        skip_routes=route_kernel is not None,
        n_threads=n_threads, n_rows=pad_rows)
    pending = None
    if route_kernel is not None:
        if route_circuit is not None and not route_circuit.allow():
            metrics.count("route.device.refused_chunks")
            raise route_circuit.refuse("route.device")
        try:
            with obs_trace.span("prep.routes_device"):
                pending = route_kernel.fill_prep(out, params, B,
                                                 defer=defer_routes)
        except Exception as e:
            metrics.count("route.device.errors")
            if route_circuit is not None:
                route_circuit.record_failure()
            raise DeviceRouteError(f"device route kernel failed: {e}") \
                from e
        if route_circuit is not None:
            route_circuit.record_success()

    def build_views() -> List[PreparedTrace]:
        if pending is not None:
            pending.write_back(out)
        kept, num_kept = out["kept_idx"], out["num_kept"]
        views = []
        for b in range(B):
            nk = int(num_kept[b])
            lo, hi = pt_off[b], pt_off[b + 1]
            views.append(PreparedTrace(
                num_raw=int(counts[b]), num_kept=nk, kept_idx=kept[b, :nk],
                times=times[lo:hi], edge_ids=out["edge_ids"][b],
                dist_m=out["dist_m"][b], offset_m=out["offset_m"][b],
                route_m=out["route_m"][b, :max(T - 1, 0)],
                gc_m=out["gc_m"][b, :max(T - 1, 0)], case=out["case"][b],
                trailing_jitter_dwell_s=float(out["dwell"][b]),
                has_cands=out["has_cands"][lo:hi].astype(bool)))
        return views

    dist, route, gc, case = (out["dist_m"], out["route_m"], out["gc_m"],
                             out["case"])
    valid = wire = finalize = None
    if pending is not None:
        route = None

        def finalize(batch, rows=int(dist.shape[0])):
            batch.route_m = _device_route_full(pending.route, rows, T)
            if pending.fold_max(out) <= WIRE_MAX_M:
                batch.dist_m = runtime.to_f16(out["dist_m"])
                batch.gc_m = runtime.to_f16(out["gc_m"])
                batch.route_m = batch.route_m.to(torch.float16)
    elif float(out["max_finite"][0]) <= WIRE_MAX_M:
        if slab_alloc is None:
            dist, route, gc = (runtime.to_f16(a) for a in (dist, route, gc))
        else:
            edge = out["edge_ids"]
            wire = Slab(((dist.shape, np.float16), (edge.shape, np.bool_),
                         (route.shape, np.float16), (gc.shape, np.float16),
                         (case.shape, np.int32)), slab_alloc)
            to_dist, valid, to_route, to_gc, case = wire.views
            dist, route, gc = (runtime.to_f16(a, out=v) for a, v in (
                (dist, to_dist), (route, to_route), (gc, to_gc)))
            np.not_equal(edge, PAD_EDGE, out=valid)
            np.copyto(case, out["case"])
    if valid is None:
        valid = out["edge_ids"] != PAD_EDGE
    return PaddedBatch(traces=_LazyTraceViews(B, build_views), dist_m=dist,
                       valid=valid, route_m=route, gc_m=gc, case=case,
                       prep=out, pt_off=pt_off, times_flat=times,
                       finalize=finalize, routes=pending, slab=wire)


def _device_route_full(route_dev, rows: int, T: int):
    """The device route tensor (B, T-1, K, K) in the native wire layout
    (rows, T, K, K), a fresh allocation on its device: filler rows and the
    dead last step carry UNREACHABLE, the bytes the native tail fill
    writes, so every decode shape and SKIP row is as on the host path."""
    B, _steps, K, _ = route_dev.shape
    full = torch.full((rows, T, K, K), float(UNREACHABLE),
                      dtype=torch.float32, device=route_dev.device)
    full[:B, :T - 1] = route_dev
    return full
