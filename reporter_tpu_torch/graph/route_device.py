"""DeviceRouteKernel: the chunk-batched device route-cost stage.

Owns one :class:`RoadNetwork`'s edge columns on a device and turns a
native-prepared chunk's candidate tensors into its (B, T-1, K, K) route
tensor with one multi-source bounded relaxation and one pair-cost
assembly (``ops.relax_routes`` and ``ops.route_pair_costs``: the CUDA
kernels of ``ops/csrc/route_relax.cu`` on the card, their plain PyTorch
versions on the CPU) instead of the host's per-pair Dijkstra searches.
The host route search (``graph/route.py``, the native ``route_step``)
gives the same bytes and is the reference it is held to.

Per chunk the kernel

1. collects the live candidate edges' end nodes (the relaxation
   sources), deduplicated by a flag scan and padded to a power of two by
   repeating the first (a repeated row is redundant, not wrong);
2. relaxes them all at the chunk-global bound, the largest live step's
   ``max(min_bound, factor * gc)``. A bounded search at a larger bound
   settles a superset of the same exact distances, and the assembly
   applies each step's own bound again;
3. assembles the route tensor for ``route_m[:B, :T-1]`` of the prep dict
   (row T-1 is the dead step the native tail fill already wrote) and
   folds its finite max into ``max_finite``, so the f16 wire decision
   sees the device-written values.

A relaxation that does not converge within the sweep cap raises, and so
does a chunk whose relaxation would allocate more than its device's
budget (:func:`over_budget`): nothing falls back to the host search. On
the card the relaxation is chosen by N when the kernel is built
(``route_relax.relax_kernel_for``): ``relax`` (one launch, a block per
source row with the row's state in shared memory) up to 14,528 nodes,
``relax_cluster`` (one launch, the row's state over a thread-block
cluster of 2 to 8 blocks) up to 116,216, ``relax_sweep`` (a launch a
sweep) past that.

On a graph whose ``2 * N * N`` float32 node kernels fit
``_CACHE_BUDGET_ELEMS`` the kernel keeps a node-kernel cache on the
device: an (N, N) distance and time row per relaxed source node, tagged
with the bound it was relaxed at. A row relaxed at bound ``b`` is exact
for any query bound ``<= b`` (every admissible path's prefixes are
admissible, so the settled values and the tie sets the time minimum runs
over are the same), the host RouteCache's reuse rule. A warm city's
chunks then skip the relaxation and run only the assembly. Rows are
written (``index_copy_``) only after a converged relaxation. The cache
is updated in place: an assembly still queued on the stream when a later
chunk writes rows reads either the old rows or the new ones, both exact
at its own bound, so its bytes are the same either way.
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import ops
from ..ops import route_relax
from ..utils import faults, metrics
from .network import RoadNetwork
from .route import UNREACHABLE

#: the CPU's ceiling, the reference's: the plain relaxation's two
#: (sources x max(nodes, edges)) float32 gathers, in elements. A chunk over
#: it raises (as the reference's budget check does before its breaker)
_STATE_BUDGET_ELEMS = 64 * 1024 * 1024

#: the card's ceiling on what one chunk's relaxation allocates, in bytes:
#: 4 GiB, a twentieth of the H100's 80 GB, so that the relaxation never
#: crowds the decode, the node-kernel cache and the caching allocator's
#: other blocks of a serving process. The 100x100 city's chunks (2,048
#: padded sources x 10,000 nodes, 164 MB of output planes) are well
#: inside it; a chunk over it raises rather than run the card out of
#: memory
_CUDA_BUDGET_BYTES = 4 * 2**30

#: ceiling on the dense (nodes x nodes) node-kernel cache (two float32
#: states); graphs over it (N > ~2.8k nodes) serve uncached, per chunk
_CACHE_BUDGET_ELEMS = 16 * 1024 * 1024


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def relax_bytes(S: int, N: int, E: int, device_type: str,
                kernel: str) -> int:
    """Bytes one relaxation of ``S`` padded sources over ``N`` nodes and
    ``E`` edges allocates. On the CPU the plain version's two (S, max(N,
    E)) float32 gathers, the reference's count; on the card the (S, N)
    dist and time planes ``relax`` and ``relax_cluster`` write (their
    state lives in shared memory), and for ``relax_sweep`` its two packed
    (S, N) int64 states besides."""
    if device_type == "cpu":
        return 2 * 4 * S * max(N, E)
    planes = 2 * 4 * S * N
    return planes + (2 * 8 * S * N if kernel == "relax_sweep" else 0)


def over_budget(S: int, N: int, E: int, device_type: str,
                kernel: str) -> bool:
    """Whether that relaxation exceeds its device's ceiling
    (``_STATE_BUDGET_ELEMS`` float32 elements on the CPU,
    ``_CUDA_BUDGET_BYTES`` on the card)."""
    ceiling = (4 * _STATE_BUDGET_ELEMS if device_type == "cpu"
               else _CUDA_BUDGET_BYTES)
    return relax_bytes(S, N, E, device_type, kernel) > ceiling


def pack_blobs(edge, offset, nk, bounds, caps, node_row, btol, tpen):
    """The assembly's two blobs (``ops.route_relax.unpack_blobs``): int32
    [edge | nk | node_row] and float32 [offset | bounds | caps |
    backward_tol | turn_penalty_factor]."""
    ints = np.concatenate([
        np.ascontiguousarray(edge, dtype=np.int32).ravel(),
        np.asarray(nk, dtype=np.int32), node_row])
    f32s = np.concatenate([
        np.ascontiguousarray(offset, dtype=np.float32).ravel(),
        bounds.ravel(), caps.ravel(),
        np.array([btol, tpen], dtype=np.float32)])
    return ints, f32s


class ChunkPlan(NamedTuple):
    """What one chunk asks of the kernel (:meth:`DeviceRouteKernel.plan`)."""
    edge: np.ndarray      # (B, T, K) int32 candidate edges
    offset: np.ndarray    # (B, T, K) float32 offsets along them
    nk: np.ndarray        # (B,) int32 kept points
    bounds: np.ndarray    # (B, T-1) float32 per-step distance bound
    caps: np.ndarray      # (B, T-1) float32 per-step time cap (-1: off)
    pairs: int            # live candidate pairs
    chunk_bound: np.float32  # relaxation bound: the largest live step's
    srcs: np.ndarray      # (n,) int32 sorted unique source nodes


class DeferredRoutes:
    """A chunk's dispatched but unsynchronised device route tensor.

    ``fill_prep(defer=True)`` returns one of these instead of copying the
    route tensor to the host: ``route`` is the (B, T-1, K, K) float32
    tensor on the device, ``max_finite`` its 0-d finite max. The decode
    stage reads only the max (:meth:`fold_max`, for the wire dtype), then
    starts the copy back behind the decode (:meth:`copy_back_async`); the
    first consumer that needs the host bytes (the native assembly, the
    lazy per-trace views) calls :meth:`write_back`, which waits there.
    Every failure (budget, non-convergence) still raises in ``fill_prep``."""

    __slots__ = ("route", "max_finite", "_B", "_T", "_lock", "_done",
                 "_staged")

    def __init__(self, route, max_finite, B: int, T: int):
        self.route = route
        self.max_finite = max_finite
        self._B = B
        self._T = T
        self._lock = threading.RLock()  # every method runs under it
        self._done = False
        self._staged = None  # (pinned host tensor, event) once copying

    def fold_max(self, out: dict) -> float:
        """Fold the finite max into ``out['max_finite']`` (idempotent) and
        return the folded value: on the card a 4-byte read, which waits
        for the work queued on the stream before it (the assembly)."""
        with self._lock:
            out["max_finite"][0] = max(float(out["max_finite"][0]),
                                       float(self.max_finite))
            return float(out["max_finite"][0])

    def copy_back_async(self) -> None:
        """On the card, start the route tensor's copy into pinned host
        memory on the current stream, behind whatever is queued there (the
        decode), and record an event after it; :meth:`write_back` waits
        on that event. A no-op off the card and after the first call."""
        with self._lock:
            if self._done or self._staged is not None \
                    or self.route.device.type != "cuda":
                return
            host = torch.empty(self.route.shape, dtype=self.route.dtype,
                               pin_memory=True)
            host.copy_(self.route, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            self._staged = (host, event)

    def write_back(self, out: dict) -> None:
        """Copy into the prep dict (idempotent, thread-safe): the route
        bytes into ``route_m[:B, :T-1]``, the finite max folded into
        ``max_finite``. Waits for the copy :meth:`copy_back_async`
        started, else copies synchronously."""
        with self._lock:
            if self._done:
                return
            self.fold_max(out)
            if self._staged is not None:
                host, event = self._staged
                event.synchronize()
            else:
                host = self.route.cpu()
            out["route_m"][:self._B, :self._T - 1] = host.numpy()
            self._staged = None
            self._done = True


class DeviceRouteKernel:
    """Batched device route costs for one road network on one device:
    ``cuda`` unless given the CPU (where the plain versions run). On the
    card the kernels are built here, and a failed build raises."""

    def __init__(self, net: RoadNetwork, device=None):
        self.device = torch.device("cuda" if device is None else device)
        on_card = self.device.type == "cuda"
        if on_card:
            route_relax.build()
        self.net = net
        self.n_nodes = int(net.num_nodes)
        self.n_edges = int(net.num_edges)
        # float32 edge columns in the C++ runtime's exact arithmetic:
        # m/s = max(kph, 1) * (1/3.6) as float32, secs = meters / v
        speed = np.asarray(net.edge_speed_kph, dtype=np.float32)
        v = np.maximum(speed, np.float32(1.0)) \
            * (np.float32(1.0) / np.float32(3.6))
        e_len = np.asarray(net.edge_length_m, dtype=np.float32)
        heads = np.asarray(net.headings(), dtype=np.float32)
        # node ids: int32 for the kernels, int64 for the plain versions'
        # indexing on the CPU
        idx = torch.int32 if self.device.type == "cuda" else torch.int64
        self._e_start = self._upload(net.edge_start).to(idx)
        self._e_end = self._upload(net.edge_end).to(idx)
        self._e_len = self._upload(e_len)
        self._e_v = self._upload(v)
        secs = e_len / v
        self._e_secs = self._upload(secs)
        self._head_x = self._upload(np.ascontiguousarray(heads[:, 0]))
        self._head_y = self._upload(np.ascontiguousarray(heads[:, 1]))
        # the relaxation this graph takes: relax or relax_cluster (over
        # the CSR arcs, uploaded once) or relax_sweep on the card, by N
        # alone; the plain version on the CPU
        self.relax_kernel = (route_relax.relax_kernel_for(self.n_nodes)
                             if on_card else "plain")
        self._arcs = (route_relax.csr_arcs(*net.csr(), net.edge_end, e_len,
                                           secs, self.device)
                      if self.relax_kernel in ("relax", "relax_cluster")
                      else None)
        # host copy for gathering sources (no device round trip per chunk)
        self._end_np = np.asarray(net.edge_end, dtype=np.int32)
        # observed relaxation stats (stats())
        self.max_iters_seen = 0
        self.max_bound_seen = 0.0
        # the node-kernel cache (module docstring): (N, N) relaxed rows,
        # row i = source node i, valid while _row_bound[i] >= the query
        # bound; -1 = never relaxed
        self._cache_ok = 2 * self.n_nodes * self.n_nodes \
            <= _CACHE_BUDGET_ELEMS
        self._cache_dist = None
        self._cache_time = None
        self._row_bound = np.full(self.n_nodes, -1.0, dtype=np.float32)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A fresh tensor on the device (starts on 16 bytes, as the
        kernels need) holding ``arr``."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(self.device) if self.device.type != "cpu" else t.clone()

    # -- profile plumbing --------------------------------------------------
    def stats(self) -> dict:
        """Observed relaxation stats for a serving profile."""
        return {"route_hops": int(self.max_iters_seen),
                "route_bound_m": float(self.max_bound_seen)}

    def _iter_cap(self) -> int:
        """The sweep cap: a Jacobi relaxation on non-negative weights is
        quiet within N sweeps, so at N a relaxation never stops short."""
        return max(self.n_nodes, 2)

    # -- the chunk hot path ------------------------------------------------
    def plan(self, out: dict, params, B: int,
             min_bound_m: float = 500.0) -> Optional[ChunkPlan]:
        """What the chunk in the native prep dict ``out`` (rows [:B], T >=
        2) asks of the kernel, or None when it has no live transition.
        Raises when its padded relaxation state exceeds the budget."""
        edge = np.asarray(out["edge_ids"][:B])
        T = edge.shape[1]
        nk = np.asarray(out["num_kept"][:B])
        gc = np.asarray(out["gc_m"][:B, :T - 1])
        dt = np.asarray(out["dt"][:B, :T - 1])
        # per-step bounds and caps in the C++ double->float32 expression
        bounds = np.maximum(
            np.float64(min_bound_m),
            np.float64(params.max_route_distance_factor)
            * gc.astype(np.float64)).astype(np.float32)
        tf = float(params.max_route_time_factor)
        caps = np.where(
            (tf > 0) & (dt > 0),
            np.maximum(np.float64(params.min_time_bound_s),
                       np.float64(tf) * dt),
            np.float64(-1.0)).astype(np.float32)
        live_step = np.arange(T - 1)[None, :] < (nk[:, None] - 1)
        ea_live = live_step[:, :, None] & (edge[:, :T - 1, :] >= 0)
        if not bool(ea_live.any()):
            return None
        # unique source nodes by a flag scan over the node ids: O(pairs +
        # N), no sort, the same sorted result as np.unique
        flags = np.zeros(self.n_nodes, dtype=bool)
        flags[self._end_np[edge[:, :T - 1, :][ea_live]]] = True
        srcs = np.flatnonzero(flags).astype(np.int32)
        S = _next_pow2(len(srcs))
        if over_budget(S, self.n_nodes, self.n_edges, self.device.type,
                       self.relax_kernel):
            metrics.count("route.device.budget_exceeded")
            raise RuntimeError(
                f"route relax state over budget: {len(srcs)} sources x "
                f"{self.n_nodes} nodes")
        return ChunkPlan(edge, np.asarray(out["offset_m"][:B]), nk, bounds,
                         caps, int(ea_live.sum()) * edge.shape[2],
                         np.float32(bounds[live_step].max()), srcs)

    def fill_prep(self, out: dict, params, B: int,
                  min_bound_m: float = 500.0,
                  defer: bool = False) -> Optional[DeferredRoutes]:
        """Compute ``out['route_m'][:B, :T-1]`` for a native
        ``prepare_batch(..., skip_routes=True)`` result dict and fold its
        finite max into ``out['max_finite']``. Raises on non-convergence
        or an over-budget chunk.

        ``defer=True`` leaves the route tensor on the device and returns a
        :class:`DeferredRoutes` (None when the chunk had nothing to route
        and the prep dict is already complete). The ``route.device``
        failpoint sits before any work."""
        faults.failpoint("route.device")
        if out["edge_ids"].shape[1] < 2:
            return None
        p = self.plan(out, params, B, min_bound_m)
        if p is None:
            # no live transition anywhere: the native tail fill already
            # wrote every route row of these traces
            metrics.count("route.device.empty_chunks")
            return None
        T = p.edge.shape[1]
        btol = float(params.backward_tolerance_m)
        tpen = float(params.turn_penalty_factor)
        metrics.count("route.device.chunks")
        metrics.count("route.device.pairs", p.pairs)
        metrics.count("route.device.sources", int(len(p.srcs)))
        pending = DeferredRoutes(
            *self._run(p.edge, p.offset, p.nk, p.bounds, p.caps, p.srcs,
                       p.chunk_bound, btol, tpen), B, T)
        if defer:
            metrics.count("route.device.deferred_chunks")
            return pending
        pending.write_back(out)  # the one device-to-host copy either way
        return None

    def _relax(self, srcs: np.ndarray, chunk_bound) -> tuple:
        """Relax the padded source set at ``chunk_bound``; raises on
        non-convergence (before any cache write). Returns the (S, N)
        distance and time kernels, S = len(srcs) padded to a power of
        two."""
        S = _next_pow2(len(srcs))
        pad = np.empty(S, dtype=np.int32)
        pad[:len(srcs)] = srcs
        pad[len(srcs):] = srcs[0]  # duplicate rows are redundant, not wrong
        cap = self._iter_cap()
        dist, time, iters, converged = ops.relax_routes(
            self._e_start, self._e_end, self._e_len, self._e_secs,
            self._upload(pad), np.float32(chunk_bound),
            n_nodes=self.n_nodes, max_iters=cap, arcs=self._arcs)
        metrics.count("route.device.relaxes")
        metrics.count("route.device.sweeps", iters)
        if not converged:
            metrics.count("route.device.nonconverged")
            raise RuntimeError(
                f"route relax did not converge within {cap} sweeps "
                f"(bound {float(chunk_bound):.0f} m)")
        self.max_iters_seen = max(self.max_iters_seen, int(iters))
        self.max_bound_seen = max(self.max_bound_seen, float(chunk_bound))
        return dist, time

    def _kernels_cached(self, srcs: np.ndarray, chunk_bound) -> tuple:
        """(dist_sn, time_sn, node_row) from the node-kernel cache,
        relaxing only the rows whose cached bound does not cover this
        chunk's."""
        missing = srcs[self._row_bound[srcs] < np.float32(chunk_bound)]
        if len(missing):
            dist, time = self._relax(missing, chunk_bound)
            if self._cache_dist is None:
                shape = (self.n_nodes, self.n_nodes)
                self._cache_dist = torch.full(shape, float("inf"),
                                              device=self.device)
                self._cache_time = torch.full(shape, float("inf"),
                                              device=self.device)
            rows = self._upload(missing.astype(np.int64))
            self._cache_dist.index_copy_(0, rows, dist[:len(missing)])
            self._cache_time.index_copy_(0, rows, time[:len(missing)])
            self._row_bound[missing] = np.float32(chunk_bound)
            metrics.count("route.device.cache_miss_rows", int(len(missing)))
        metrics.count("route.device.cache_hit_rows",
                      int(len(srcs) - len(missing)))
        # cache row i belongs to node i: node_row is the identity on the
        # nodes this chunk needs (all just proven covered), -1 elsewhere
        node_row = np.full(self.n_nodes, -1, dtype=np.int32)
        node_row[srcs] = srcs
        return self._cache_dist, self._cache_time, node_row

    def _run(self, edge, offset, nk, bounds, caps, srcs, chunk_bound,
             btol, tpen):
        """Relax (or serve from the cache) and assemble; returns the
        (B, T-1, K, K) float32 route tensor and its 0-d finite max on the
        device, dispatched and not synchronised."""
        if self._cache_ok:
            dist, time, node_row = self._kernels_cached(srcs, chunk_bound)
        else:
            dist, time = self._relax(srcs, chunk_bound)
            node_row = np.full(self.n_nodes, -1, dtype=np.int32)
            node_row[srcs] = np.arange(len(srcs), dtype=np.int32)
        # two packed blobs instead of eight small uploads: on a warm cache
        # the per-chunk uploads are the dispatch's cost
        B, T, K = edge.shape
        ints, f32s = pack_blobs(edge, offset, nk, bounds, caps, node_row,
                                btol, tpen)
        return ops.route_pair_costs(
            self._upload(ints), self._upload(f32s), dist, time,
            *self.edge_columns(), B=B, T=T, K=K, N=self.n_nodes)

    def edge_columns(self) -> tuple:
        """(edge_start, edge_end, edge_len, edge_v, head_x, head_y) on the
        device, as the pair-cost assembly takes them."""
        return (self._e_start, self._e_end, self._e_len, self._e_v,
                self._head_x, self._head_y)

    # -- standalone matrices (tests) -----------------------------------------
    def route_matrices(self, cands, gc,
                       max_route_distance_factor: float = 5.0,
                       min_bound_m: float = 500.0,
                       backward_tolerance_m: float = 25.0,
                       dt=None, max_route_time_factor: float = 0.0,
                       min_time_bound_s: float = 60.0,
                       turn_penalty_factor: float = 0.0) -> np.ndarray:
        """(T-1, K, K) route tensor for one trace's candidate set: the
        device twin of ``graph.route.candidate_route_matrices``."""
        edge = np.asarray(cands.edge_ids, dtype=np.int32)[None]
        offset = np.asarray(cands.offset_m, dtype=np.float32)[None]
        T = edge.shape[1]
        if T < 2:
            return np.zeros((0, edge.shape[2], edge.shape[2]),
                            dtype=np.float32)
        gc = np.asarray(gc, dtype=np.float32).reshape(1, T - 1)
        bounds = np.maximum(
            np.float64(min_bound_m),
            np.float64(max_route_distance_factor)
            * gc.astype(np.float64)).astype(np.float32)
        if dt is not None and max_route_time_factor > 0:
            d64 = np.asarray(dt, dtype=np.float64).reshape(1, T - 1)
            caps = np.where(
                d64 > 0,
                np.maximum(np.float64(min_time_bound_s),
                           np.float64(max_route_time_factor) * d64),
                np.float64(-1.0)).astype(np.float32)
        else:
            caps = np.full((1, T - 1), -1.0, dtype=np.float32)
        nk = np.array([T], dtype=np.int32)
        live = edge[:, :T - 1, :] >= 0
        if not bool(live.any()):
            return np.full((T - 1, edge.shape[2], edge.shape[2]),
                           UNREACHABLE, dtype=np.float32)
        srcs = np.unique(self._end_np[edge[:, :T - 1, :][live]])
        route, _ = self._run(edge, offset, nk, bounds, caps, srcs,
                             np.float32(bounds.max()),
                             float(backward_tolerance_m),
                             float(turn_penalty_factor))
        return route[0].cpu().numpy()
