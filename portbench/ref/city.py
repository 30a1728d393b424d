"""The benchmark's cities: a frozen copy of the port's grid city
(``reporter_tpu_torch/synth.py`` ``build_grid_city``), returning the column
arrays that both the program (``graph.network.network_from_arrays``) and
the reference (``ref.network.network_from_arrays``) build their network
from. The same arguments give the same arrays as the port's builder."""
from __future__ import annotations

from typing import List

import numpy as np

from .geo import local_meters_projection
from .osmlr import make_segment_id
from .tiles import TileHierarchy


def build_grid_city(rows: int = 20, cols: int = 20, spacing_m: float = 200.0,
                    lat0: float = 14.60, lon0: float = 120.98,
                    edges_per_segment: int = 3, seed: int = 0,
                    service_road_fraction: float = 0.05,
                    internal_fraction: float = 0.02) -> dict:
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
    edge_seg: List[int] = []
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
                    edge_seg.append(-1)
                    seg_offsets.append(0.0)
                else:
                    edge_seg.append(sid)
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

    seg_ids = np.array(sorted(segment_length_m), dtype=np.int64)
    return {
        "node_lat": np.asarray(node_lat, dtype=np.float64),
        "node_lon": np.asarray(node_lon, dtype=np.float64),
        "edge_start": np.asarray(starts, dtype=np.int32),
        "edge_end": np.asarray(ends, dtype=np.int32),
        "edge_length_m": np.asarray(lengths, dtype=np.float32),
        "edge_speed_kph": np.asarray(speeds, dtype=np.float32),
        "edge_segment_id": np.asarray(edge_seg, dtype=np.int64),
        "edge_segment_offset_m": np.asarray(seg_offsets, dtype=np.float32),
        "edge_internal": np.asarray(internal, dtype=bool),
        "seg_ids": seg_ids,
        "seg_lens": np.array([segment_length_m[s] for s in seg_ids],
                             dtype=np.float32),
    }
