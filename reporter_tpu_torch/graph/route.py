"""Bounded shortest-path route distances for HMM transition costs.

Meili's transition probability compares the network route distance between
consecutive candidate pairs against the great-circle distance between the
probes (reference: SURVEY.md §2.3; knobs ``max-route-distance-factor`` and
``beta`` at Dockerfile:14-17). Graph search is inherently sequential, so it
stays on the host: a bounded Dijkstra over the CSR adjacency, with a
per-source-node cache so a batch of traces over the same city amortises the
searches. The device only ever sees the resulting (T-1, K, K) cost tensors.

UNREACHABLE marks pairs with no route within the bound; the device matcher
turns those into -inf transition scores.
"""
from __future__ import annotations

import heapq
import math
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from .network import RoadNetwork
from .spatial import CandidateSet, PAD_EDGE

UNREACHABLE = np.float32(1.0e9)

# LRU capacities. Node entries hold whole bounded-Dijkstra result dicts
# (big, few); pair entries are 3-tuples (tiny, many).
NODE_CAP = 1 << 16
PAIR_CAP = 1 << 20


def _edge_secs(net: RoadNetwork, e: int, meters: float) -> float:
    """Travel seconds for ``meters`` of edge ``e`` at its speed (floored at
    1 kph)."""
    v = max(float(net.edge_speed_kph[e]), 1.0) / 3.6
    return meters / v


def _dijkstra_bounded(net: RoadNetwork, source_node: int, max_dist: float,
                      ) -> Dict[int, tuple]:
    """Single-source shortest paths out to ``max_dist``; each entry is
    ``(distance_m, travel_time_s)`` along the shortest-DISTANCE path.

    Time rides along for the max_route_time_factor admissibility bound —
    it does not drive the search (matching Meili: routes by distance, then
    bounds the route's travel time against the probes' elapsed time).
    """
    offsets, edge_ids = net.csr()
    lengths = net.edge_length_m
    ends = net.edge_end
    dist: Dict[int, tuple] = {source_node: (0.0, 0.0)}
    heap = [(0.0, source_node)]
    while heap:
        d, u = heapq.heappop(heap)
        du = dist.get(u)
        if du is not None and d > du[0]:
            continue
        if d > max_dist:
            break
        tu = dist[u][1]
        for idx in range(offsets[u], offsets[u + 1]):
            e = edge_ids[idx]
            v = int(ends[e])
            nd = d + float(lengths[e])
            dv = dist.get(v)
            if nd <= max_dist and (dv is None or nd < dv[0]):
                dist[v] = (nd, tu + _edge_secs(net, e, float(lengths[e])))
                heapq.heappush(heap, (nd, v))
    return dist


def shortest_path_edges(net: RoadNetwork, src_node: int, dst_node: int,
                        max_dist: float = 1.0e8):
    """Edge-id path from ``src_node`` to ``dst_node`` (Dijkstra with
    predecessor tracking), or None if unreachable. Used by the synthetic
    trace generator, not the matcher hot path."""
    offsets, edge_ids = net.csr()
    lengths = net.edge_length_m
    ends = net.edge_end
    dist = {src_node: 0.0}
    pred: Dict[int, int] = {}  # node -> incoming edge id
    heap = [(0.0, src_node)]
    while heap:
        d, u = heapq.heappop(heap)
        if u == dst_node:
            break
        if d > dist.get(u, np.inf) or d > max_dist:
            continue
        for idx in range(offsets[u], offsets[u + 1]):
            e = int(edge_ids[idx])
            v = int(ends[e])
            nd = d + float(lengths[e])
            if nd <= max_dist and nd < dist.get(v, np.inf):
                dist[v] = nd
                pred[v] = e
                heapq.heappush(heap, (nd, v))
    if dst_node not in dist or (dst_node != src_node and dst_node not in pred):
        return None
    path = []
    node = dst_node
    while node != src_node:
        e = pred[node]
        path.append(e)
        node = int(net.edge_start[e])
    return path[::-1]


class RouteCache:
    """Two-level LRU route cache, shared across batches and requests.

    Level 1 (``distances_from``) caches bounded single-source Dijkstra
    result dicts by source node — a batch of traces over one city
    amortises the searches. A cached entry is only reused when its bound
    covers the requested bound; otherwise it is recomputed at the larger
    bound. Entries map ``node -> (distance_m, travel_time_s)``.

    Level 2 (``pair_get``/``pair_put``) caches the node-to-node route
    kernel per ``(edge_from, edge_to)`` — the same urban edge pairs
    recur on every batch and every service request, and the pair hit
    skips not just the Dijkstra but the whole result-dict probe. The
    cached value is the raw (bound, distance_m, travel_time_s) triple;
    offset arithmetic, turn penalties and the time-admissibility check
    are reapplied per query from the live dt, so a hit is bit-identical
    to a recompute and the key
    deliberately does NOT include dt: the cached kernel is
    dt-independent, and keying on it would only fragment the LRU across
    sampling-gap buckets.

    Both levels are LRU-bounded so a long-running service cannot grow
    without bound. Hits and misses of each level publish as the
    ``route.cache.*`` counters through :meth:`flush_metrics`.

    Concurrency: shared across threads under CPython's GIL. Each dict
    operation is atomic, but a get can race a concurrent eviction, so
    the LRU bookkeeping (``move_to_end``/``popitem``) tolerates the key
    having vanished — a lost LRU bump or a double-evict costs a
    redundant recompute, never corruption and never an exception (the
    SegmentMatcher concurrent-Match contract).
    """

    def __init__(self, net: RoadNetwork):
        self.net = net
        self._cache: "OrderedDict[int, tuple]" = OrderedDict()
        self._pairs: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.hits = self.misses = self.pair_hits = self.pair_misses = 0
        self._flushed = (0, 0, 0, 0)

    @staticmethod
    def _bump(lru: OrderedDict, key) -> None:
        try:
            lru.move_to_end(key)
        except KeyError:  # concurrently evicted; the fetched value stands
            pass

    @staticmethod
    def _evict(lru: OrderedDict, cap: int) -> None:
        while len(lru) > cap:
            try:
                lru.popitem(last=False)
            except KeyError:  # concurrent evictor got there first
                break

    def distances_from(self, node: int, max_dist: float) -> Dict[int, tuple]:
        entry = self._cache.get(node)
        if entry is not None and entry[0] >= max_dist:
            self.hits += 1
            self._bump(self._cache, node)
            return entry[1]
        self.misses += 1
        dist = _dijkstra_bounded(self.net, node, max_dist)
        self._cache[node] = (max_dist, dist)
        self._bump(self._cache, node)
        self._evict(self._cache, NODE_CAP)
        return dist

    # ---- pair level ------------------------------------------------------
    def pair_get(self, edge_a: int, edge_b: int):
        """Cached (bound_m, node_dist_m, node_secs) for the general route
        from edge_a's end node to edge_b's start node, or None. node_dist
        is inf when the pair was unreachable within bound_m."""
        got = self._pairs.get((edge_a, edge_b))
        if got is not None:
            self.pair_hits += 1
            self._bump(self._pairs, (edge_a, edge_b))
        else:
            self.pair_misses += 1
        return got

    def pair_put(self, edge_a: int, edge_b: int,
                 bound: float, node_dist: float, node_secs: float) -> None:
        self._pairs[(edge_a, edge_b)] = (bound, node_dist, node_secs)
        self._evict(self._pairs, PAIR_CAP)

    def flush_metrics(self) -> None:
        """Publish the counts since the last flush as the
        ``route.cache.*`` counters (once per route tensor: a counter per
        pair would take the registry lock per (t, i, j))."""
        from ..utils import metrics

        now = (self.hits, self.misses, self.pair_hits, self.pair_misses)
        names = ("route.cache.node_hits", "route.cache.node_misses",
                 "route.cache.pair_hits", "route.cache.pair_misses")
        for name, cur, old in zip(names, now, self._flushed):
            if cur > old:
                metrics.count(name, cur - old)
        self._flushed = now


def route_distance(net: RoadNetwork, edge_a: int, offset_a: float,
                   edge_b: int, offset_b: float, max_dist: float,
                   cache: Optional[RouteCache] = None,
                   backward_tolerance_m: float = 0.0,
                   time_cap_s: float = -1.0,
                   turn_penalty_m: float = 0.0) -> float:
    """Network distance from a point ``offset_a`` along ``edge_a`` to a point
    ``offset_b`` along ``edge_b``; UNREACHABLE beyond ``max_dist``.

    ``backward_tolerance_m`` forgives small *apparent* backward movement on
    the same directed edge (along-track GPS noise): without it a few meters
    of backward jitter prices the same-edge transition as a full loop around
    the block, which makes a one-point flicker onto the co-located reverse
    edge the cheaper Viterbi path — exactly the segment-flapping the matcher
    must not emit.

    ``time_cap_s`` >= 0 additionally requires the route's travel time at
    edge speeds to fit the cap (Meili's ``max-route-time-factor`` bound);
    ``turn_penalty_m`` is added to general routes after admissibility (the
    caller prices the heading change between the two candidate edges).
    """
    if edge_a == edge_b and offset_b >= offset_a:
        if time_cap_s >= 0 and _edge_secs(net, edge_a,
                                          offset_b - offset_a) > time_cap_s:
            return float(UNREACHABLE)
        return offset_b - offset_a
    if edge_a == edge_b and offset_a - offset_b <= backward_tolerance_m:
        return 0.0
    remaining = float(net.edge_length_m[edge_a]) - offset_a
    via = remaining + offset_b
    if via > max_dist:
        return float(UNREACHABLE)
    src = int(net.edge_end[edge_a])
    dst = int(net.edge_start[edge_b])
    node_dt = None
    if cache is not None:
        # pair level first: a bounded-Dijkstra dict entry is always the
        # EXACT shortest distance (relaxation never inserts past the
        # bound), so a cached finite pair is reusable at any query bound;
        # a cached unreachable only proves unreachability up to the bound
        # it was searched at
        got = cache.pair_get(edge_a, edge_b)
        sub = max_dist - via
        if got is not None and math.isinf(got[1]) and got[0] < sub:
            got = None  # unreachable verdict from a shallower search
        if got is not None:
            node_dt = None if math.isinf(got[1]) else (got[1], got[2])
        else:
            node_dt = cache.distances_from(src, sub).get(dst)
            cache.pair_put(edge_a, edge_b, sub,
                           node_dt[0] if node_dt is not None else math.inf,
                           node_dt[1] if node_dt is not None else 0.0)
    else:
        node_dt = _dijkstra_bounded(net, src, max_dist - via).get(dst)
    # a reused cache entry may have been computed at a larger bound and
    # contain nodes beyond this query's cap — re-check the total
    if node_dt is None or via + node_dt[0] > max_dist:
        return float(UNREACHABLE)
    if time_cap_s >= 0:
        secs = (_edge_secs(net, edge_a, remaining)
                + _edge_secs(net, edge_b, offset_b) + node_dt[1])
        if secs > time_cap_s:
            return float(UNREACHABLE)
    return via + node_dt[0] + turn_penalty_m


def _edge_headings(net: RoadNetwork) -> np.ndarray:
    """(E, 2) unit heading per edge (cached on the network)."""
    return net.headings()


def candidate_route_matrices(net: RoadNetwork, cands: CandidateSet,
                             gc_dist: np.ndarray,
                             max_route_distance_factor: float = 5.0,
                             min_bound_m: float = 500.0,
                             cache: Optional[RouteCache] = None,
                             backward_tolerance_m: float = 0.0,
                             dt: Optional[np.ndarray] = None,
                             max_route_time_factor: float = 0.0,
                             min_time_bound_s: float = 15.0,
                             turn_penalty_factor: float = 0.0) -> np.ndarray:
    """(T-1, K, K) route-distance tensor between consecutive candidates.

    ``gc_dist`` is the (T-1,) great-circle distance between consecutive
    probes; the search bound per step is
    ``max(min_bound_m, factor * gc_dist)`` mirroring the reference's
    ``max-route-distance-factor`` cap (reference: Dockerfile:14-17).

    ``dt`` (T-1,) probe time deltas + ``max_route_time_factor`` > 0 enable
    Meili's time-admissibility bound: a transition whose travel time at
    edge speeds exceeds ``max(min_time_bound_s, factor * dt[t])`` is
    unreachable (the floor parallels ``min_bound_m`` on the distance side —
    at 1 Hz sampling factor*dt is ~2 s, which GPS noise alone overruns).
    ``turn_penalty_factor`` adds ``factor * 0.5 * (1 - cos(theta))`` meters
    for the heading change between the two candidate edges (0 straight,
    ``factor`` for a U-turn) — the penalised route distance Meili feeds its
    transition cost.
    """
    T, K = cands.edge_ids.shape
    if cache is None:
        cache = RouteCache(net)
    heads = _edge_headings(net) if turn_penalty_factor > 0 else None
    out = np.full((max(T - 1, 0), K, K), UNREACHABLE, dtype=np.float32)
    for t in range(T - 1):
        bound = max(min_bound_m, max_route_distance_factor * float(gc_dist[t]))
        time_cap = -1.0
        if dt is not None and max_route_time_factor > 0 and float(dt[t]) > 0:
            time_cap = max(min_time_bound_s,
                           max_route_time_factor * float(dt[t]))
        for i in range(K):
            ea = int(cands.edge_ids[t, i])
            if ea == PAD_EDGE:
                continue
            oa = float(cands.offset_m[t, i])
            for j in range(K):
                eb = int(cands.edge_ids[t + 1, j])
                if eb == PAD_EDGE:
                    continue
                ob = float(cands.offset_m[t + 1, j])
                penalty = 0.0
                if heads is not None:
                    cos_th = float(heads[ea] @ heads[eb])
                    penalty = turn_penalty_factor * 0.5 * (1.0 - cos_th)
                out[t, i, j] = route_distance(
                    net, ea, oa, eb, ob, bound, cache,
                    backward_tolerance_m=backward_tolerance_m,
                    time_cap_s=time_cap, turn_penalty_m=penalty)
    cache.flush_metrics()
    return out
