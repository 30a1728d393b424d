"""Synthetic road networks and ground-truth GPS traces.

A deterministic grid city with OSMLR-associated edges, and noisy
per-second probe traces routed between random nodes. The numpy random
streams are drawn in the same order as the JAX package's ``synth``, so one
seed gives the same city and the same traces in both packages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .core.geo import local_meters_projection
from .core.osmlr import make_segment_id
from .core.tiles import TileHierarchy
from .graph.network import RoadNetwork
from .graph.route import shortest_path_edges

# Manila-ish anchor so tile ids look like the reference deployment's
DEFAULT_LAT0 = 14.60
DEFAULT_LON0 = 120.98


def build_grid_city(rows: int = 20, cols: int = 20, spacing_m: float = 200.0,
                    lat0: float = DEFAULT_LAT0, lon0: float = DEFAULT_LON0,
                    edges_per_segment: int = 3, seed: int = 0,
                    service_road_fraction: float = 0.05,
                    internal_fraction: float = 0.02) -> RoadNetwork:
    """A grid city: ``rows x cols`` intersections ``spacing_m`` apart.

    Streets get hierarchy levels the way real OSMLR tiles do: every 8th
    row/col is a level-0 highway (80 kph), every 4th a level-1 arterial
    (60 kph), the rest level-2 locals (40 kph). Consecutive same-direction
    edges chain into OSMLR segments of ``edges_per_segment`` blocks whose
    tile index is the true geographic tile of the segment midpoint.
    A few edges are left unassociated (service roads) or marked internal
    (turn channels), which the report path must skip / merge across
    (reference: py/reporter_service.py:109-110,159-162).
    """
    rng = np.random.default_rng(seed)
    _, to_ll = local_meters_projection(lat0, lon0)

    xs = (np.arange(cols) - (cols - 1) / 2.0) * spacing_m
    ys = (np.arange(rows) - (rows - 1) / 2.0) * spacing_m
    gx, gy = np.meshgrid(xs, ys)  # (rows, cols)
    node_lat, node_lon = to_ll(gx.ravel(), gy.ravel())

    def node_id(r: int, c: int) -> int:
        return r * cols + c

    def street_level(index: int) -> int:
        if index % 8 == 0:
            return 0
        if index % 4 == 0:
            return 1
        return 2

    speed_for_level = {0: 80.0, 1: 60.0, 2: 40.0}

    starts: List[int] = []
    ends: List[int] = []
    lengths: List[float] = []
    speeds: List[float] = []
    seg_ids: List[int] = []
    seg_offsets: List[float] = []
    internal: List[bool] = []

    hierarchy = TileHierarchy()
    seg_counters = {}  # (level, tile_idx) -> next segment index
    segment_length_m = {}

    def add_run(node_seq: List[int], level: int):
        """One directed run of edges along a street, chained into segments."""
        speed = speed_for_level[level]
        for chunk_start in range(0, len(node_seq) - 1, edges_per_segment):
            chunk = node_seq[chunk_start:chunk_start + edges_per_segment + 1]
            if len(chunk) < 2:
                break
            # geographic tile of the chunk midpoint names the segment's tile
            mid = chunk[len(chunk) // 2]
            tiles = hierarchy.tiles(level)
            tile_idx = tiles.tile_id(float(node_lat[mid]), float(node_lon[mid]))
            key = (level, tile_idx)
            seg_idx = seg_counters.get(key, 0)
            seg_counters[key] = seg_idx + 1
            sid = make_segment_id(level, tile_idx, seg_idx)

            offset = 0.0
            for a, b in zip(chunk[:-1], chunk[1:]):
                is_service = rng.random() < service_road_fraction
                is_internal = (not is_service) and rng.random() < internal_fraction
                starts.append(a)
                ends.append(b)
                lengths.append(spacing_m)
                speeds.append(speed)
                if is_service or is_internal:
                    seg_ids.append(-1)
                    seg_offsets.append(0.0)
                else:
                    seg_ids.append(sid)
                    seg_offsets.append(offset)
                internal.append(is_internal)
                offset += spacing_m
            segment_length_m[sid] = offset

    # horizontal streets (both directions), vertical streets (both directions)
    for r in range(rows):
        level = street_level(r)
        seq = [node_id(r, c) for c in range(cols)]
        add_run(seq, level)
        add_run(seq[::-1], level)
    for c in range(cols):
        level = street_level(c)
        seq = [node_id(r, c) for r in range(rows)]
        add_run(seq, level)
        add_run(seq[::-1], level)

    return RoadNetwork(
        node_lat=np.asarray(node_lat, dtype=np.float64),
        node_lon=np.asarray(node_lon, dtype=np.float64),
        edge_start=np.asarray(starts, dtype=np.int32),
        edge_end=np.asarray(ends, dtype=np.int32),
        edge_length_m=np.asarray(lengths, dtype=np.float32),
        edge_speed_kph=np.asarray(speeds, dtype=np.float32),
        edge_segment_id=np.asarray(seg_ids, dtype=np.int64),
        edge_segment_offset_m=np.asarray(seg_offsets, dtype=np.float32),
        edge_internal=np.asarray(internal, dtype=bool),
        segment_length_m=segment_length_m,
    )


@dataclass
class SyntheticTrace:
    """A generated probe trace plus its ground truth."""
    uuid: str
    points: List[dict]          # [{lat, lon, time, accuracy}, ...]
    edge_path: List[int]        # ground-truth edge ids traversed
    point_edges: List[int]      # ground-truth edge id at each sample
    point_offsets: List[float]  # along-edge offset at each sample

    def request_json(self, mode: str = "auto",
                     report_levels=(0, 1), transition_levels=(0, 1)) -> dict:
        """The /report request body (reference: Batch.java:56-66)."""
        return {
            "uuid": self.uuid,
            "trace": self.points,
            "match_options": {
                "mode": mode,
                "report_levels": list(report_levels),
                "transition_levels": list(transition_levels),
            },
        }


def generate_trace(net: RoadNetwork, uuid: str, rng: np.random.Generator,
                   noise_m: float = 5.0, sample_period_s: float = 1.0,
                   start_time: int = 1_500_000_000,
                   min_route_edges: int = 6,
                   max_route_edges: int = 60) -> Optional[SyntheticTrace]:
    """Route between random nodes and synthesise noisy per-second probes.

    The vehicle advances along the edge path at each edge's speed; a probe is
    emitted every ``sample_period_s`` with isotropic Gaussian position noise
    of ``noise_m`` meters std (the reference's correlated-walk noise model at
    generate_test_trace.py:77-92 is approximated as iid; accuracy is the
    95th-percentile circle like generate_test_trace.py:40).
    """
    src, dst = rng.integers(0, net.num_nodes, size=2)
    if src == dst:
        return None
    path = shortest_path_edges(net, int(src), int(dst))
    if path is None or not (min_route_edges <= len(path)):
        return None
    path = path[:max_route_edges]

    nx, ny = net.node_xy()
    _, to_ll = net.projection()

    accuracy = int(math.ceil(min(100.0, 1.96 * max(1.0, noise_m))))
    points: List[dict] = []
    point_edges: List[int] = []
    point_offsets: List[float] = []

    t = 0.0
    next_sample = 0.0
    for e in path:
        length = float(net.edge_length_m[e])
        mps = float(net.edge_speed_kph[e]) * 1000.0 / 3600.0
        duration = length / mps
        ax, ay = nx[net.edge_start[e]], ny[net.edge_start[e]]
        bx, by = nx[net.edge_end[e]], ny[net.edge_end[e]]
        while next_sample < t + duration:
            frac = (next_sample - t) / duration
            x = ax + frac * (bx - ax) + rng.normal(0.0, noise_m)
            y = ay + frac * (by - ay) + rng.normal(0.0, noise_m)
            lat, lon = to_ll(x, y)
            points.append({
                "lat": round(float(lat), 6),
                "lon": round(float(lon), 6),
                "time": int(start_time + round(next_sample)),
                "accuracy": accuracy,
            })
            point_edges.append(e)
            point_offsets.append(frac * length)
            next_sample += sample_period_s
        t += duration

    if len(points) < 2:
        return None
    return SyntheticTrace(uuid=uuid, points=points, edge_path=path,
                          point_edges=point_edges, point_offsets=point_offsets)
