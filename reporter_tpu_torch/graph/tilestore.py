"""Tiled on-disk graph storage: a :class:`RoadNetwork` partitioned into
per-tile binary files under ``{level}/{nnn}/{nnn}/{nnn}.rgt`` (the tile
hierarchy's path scheme, three levels), the same trees the JAX package
writes. Any bbox-worth of tiles composes back into a network, and tile
files ship individually with the tiles CLI.

Partitioning rule: an edge lives in the tile containing its *start node*
(so a tile is self-contained for candidate lookup) at the hierarchy level
of its OSMLR segment id when associated (highway segments in the 4°
level-0 tiles, arterials in level 1, locals in level 2), and level 2 when
unassociated. End nodes referenced across the boundary are carried in the
tile's node table, deduplicated by global id at load time.

Binary layout (RGT1, little-endian), parsed by the C++ host runtime
(``native.parse_tile``; the library is required), with the numpy parser
:func:`tile_from_bytes_np` naming the fault of a blob it rejects:

  magic   b"RGT1"
  u32     version (=1)
  i64     n_nodes, n_edges, n_segments
  i64[N]  node_gid          global node id
  f64[N]  node_lat, node_lon
  i32[E]  edge_start, edge_end          (local node indices)
  f32[E]  edge_length_m, edge_speed_kph
  i64[E]  edge_segment_id               (-1 = unassociated)
  f32[E]  edge_segment_offset_m
  u8[E]   edge_internal
  i64[S]  seg_ids
  f32[S]  seg_lens
"""
from __future__ import annotations

import os
import struct
from typing import Dict, Iterable, List, Tuple

import numpy as np

from ..core.osmlr import tile_level
from ..core.tiles import TileHierarchy, tiles_for_bbox
from .network import RoadNetwork

MAGIC = b"RGT1"
VERSION = 1
SUFFIX = "rgt"
_HEADER = struct.Struct("<4sIqqq")


def tile_to_bytes(node_gid: np.ndarray, node_lat: np.ndarray,
                  node_lon: np.ndarray, edge_start: np.ndarray,
                  edge_end: np.ndarray, edge_length_m: np.ndarray,
                  edge_speed_kph: np.ndarray, edge_segment_id: np.ndarray,
                  edge_segment_offset_m: np.ndarray,
                  edge_internal: np.ndarray, seg_ids: np.ndarray,
                  seg_lens: np.ndarray) -> bytes:
    parts = [_HEADER.pack(MAGIC, VERSION, len(node_gid), len(edge_start),
                          len(seg_ids))]
    for arr, dtype in (
            (node_gid, "<i8"), (node_lat, "<f8"), (node_lon, "<f8"),
            (edge_start, "<i4"), (edge_end, "<i4"),
            (edge_length_m, "<f4"), (edge_speed_kph, "<f4"),
            (edge_segment_id, "<i8"), (edge_segment_offset_m, "<f4"),
            (edge_internal, "u1"), (seg_ids, "<i8"), (seg_lens, "<f4")):
        parts.append(np.ascontiguousarray(arr, dtype=dtype).tobytes())
    return b"".join(parts)


def tile_from_bytes(raw: bytes) -> dict:
    """Parse one RGT1 blob into its column arrays with the C++ parser. A
    blob it rejects raises ``ValueError`` with the numpy parser's
    message."""
    from .. import native
    parsed = native.parse_tile(raw)
    if parsed is None:
        tile_from_bytes_np(raw)  # raises, naming the fault
        raise ValueError("malformed RGT tile")
    return parsed


def tile_from_bytes_np(raw: bytes) -> dict:
    magic, version, n_nodes, n_edges, n_segs = _HEADER.unpack_from(raw, 0)
    if magic != MAGIC:
        raise ValueError("not an RGT tile (bad magic)")
    if version != VERSION:
        raise ValueError(f"unsupported RGT version {version}")
    out: dict = {}
    off = _HEADER.size
    for name, dtype, count in (
            ("node_gid", "<i8", n_nodes), ("node_lat", "<f8", n_nodes),
            ("node_lon", "<f8", n_nodes),
            ("edge_start", "<i4", n_edges), ("edge_end", "<i4", n_edges),
            ("edge_length_m", "<f4", n_edges),
            ("edge_speed_kph", "<f4", n_edges),
            ("edge_segment_id", "<i8", n_edges),
            ("edge_segment_offset_m", "<f4", n_edges),
            ("edge_internal", "u1", n_edges),
            ("seg_ids", "<i8", n_segs), ("seg_lens", "<f4", n_segs)):
        arr = np.frombuffer(raw, dtype=dtype, count=count, offset=off)
        out[name] = arr
        off += arr.nbytes
    if off != len(raw):
        raise ValueError(f"RGT tile has {len(raw) - off} trailing bytes")
    out["edge_internal"] = out["edge_internal"].astype(bool)
    return out


def edge_tile_assignment(net: RoadNetwork) -> Tuple[np.ndarray, np.ndarray]:
    """(level, tile_id) per edge: OSMLR level when associated (else local
    level 2), geographic tile of the start node at that level."""
    E = net.num_edges
    levels = np.full(E, 2, dtype=np.int32)
    assoc = net.edge_segment_id >= 0
    if assoc.any():
        levels[assoc] = [tile_level(int(s))
                         for s in net.edge_segment_id[assoc]]
    hierarchy = TileHierarchy()
    tile_ids = np.empty(E, dtype=np.int64)
    start_lat = net.node_lat[net.edge_start]
    start_lon = net.node_lon[net.edge_start]
    for lvl in np.unique(levels):
        t = hierarchy.tiles(int(lvl))
        sel = levels == lvl
        rows = ((start_lat[sel] - t.bbox.miny) / t.tilesize).astype(np.int64)
        cols = ((start_lon[sel] - t.bbox.minx) / t.tilesize).astype(np.int64)
        rows = np.clip(rows, 0, t.nrows - 1)
        cols = np.clip(cols, 0, t.ncolumns - 1)
        tile_ids[sel] = rows * t.ncolumns + cols
    return levels, tile_ids


def write_tiles(net: RoadNetwork, root: str) -> List[str]:
    """Partition ``net`` into RGT tile files under ``root``; returns the
    relative paths written."""
    levels, tile_ids = edge_tile_assignment(net)
    hierarchy = TileHierarchy()
    written: List[str] = []
    # group edges by (level, tile_id) via one lexsort
    order = np.lexsort((tile_ids, levels))
    groups: Dict[Tuple[int, int], np.ndarray] = {}
    if len(order):
        key_change = np.flatnonzero(
            (np.diff(levels[order]) != 0) | (np.diff(tile_ids[order]) != 0))
        starts = np.concatenate([[0], key_change + 1])
        ends = np.concatenate([key_change + 1, [len(order)]])
        for s, e in zip(starts, ends):
            idx = order[s:e]
            groups[(int(levels[idx[0]]), int(tile_ids[idx[0]]))] = idx

    for (lvl, tid), edge_idx in sorted(groups.items()):
        node_gids = np.unique(np.concatenate(
            [net.edge_start[edge_idx], net.edge_end[edge_idx]]))
        local_of = {int(g): i for i, g in enumerate(node_gids)}
        remap = np.vectorize(local_of.__getitem__, otypes=[np.int32])
        seg_ids_here = np.unique(
            net.edge_segment_id[edge_idx][net.edge_segment_id[edge_idx] >= 0])
        seg_lens_here = np.array(
            [net.segment_length_m.get(int(s), 0.0) for s in seg_ids_here],
            dtype=np.float32)
        blob = tile_to_bytes(
            node_gid=node_gids,
            node_lat=net.node_lat[node_gids],
            node_lon=net.node_lon[node_gids],
            edge_start=remap(net.edge_start[edge_idx]),
            edge_end=remap(net.edge_end[edge_idx]),
            edge_length_m=net.edge_length_m[edge_idx],
            edge_speed_kph=net.edge_speed_kph[edge_idx],
            edge_segment_id=net.edge_segment_id[edge_idx],
            edge_segment_offset_m=net.edge_segment_offset_m[edge_idx],
            edge_internal=net.edge_internal[edge_idx],
            seg_ids=seg_ids_here, seg_lens=seg_lens_here)
        rel = hierarchy.tiles(lvl).file_path(tid, lvl, SUFFIX)
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(blob)
        written.append(rel)
    return written


def merge_tiles(parsed: Iterable[dict]) -> RoadNetwork:
    """Compose parsed tile dicts into one RoadNetwork, deduplicating
    boundary nodes by global id."""
    parsed = list(parsed)
    if not parsed:
        raise ValueError("no tiles to merge")
    all_gids = np.unique(np.concatenate([p["node_gid"] for p in parsed]))
    index_of = {int(g): i for i, g in enumerate(all_gids)}
    N = len(all_gids)
    node_lat = np.zeros(N, dtype=np.float64)
    node_lon = np.zeros(N, dtype=np.float64)
    cols: Dict[str, list] = {k: [] for k in (
        "edge_start", "edge_end", "edge_length_m", "edge_speed_kph",
        "edge_segment_id", "edge_segment_offset_m", "edge_internal")}
    segment_length: Dict[int, float] = {}
    for p in parsed:
        merged_idx = np.array([index_of[int(g)] for g in p["node_gid"]],
                              dtype=np.int32)
        node_lat[merged_idx] = p["node_lat"]
        node_lon[merged_idx] = p["node_lon"]
        cols["edge_start"].append(merged_idx[p["edge_start"]])
        cols["edge_end"].append(merged_idx[p["edge_end"]])
        for k in ("edge_length_m", "edge_speed_kph", "edge_segment_id",
                  "edge_segment_offset_m", "edge_internal"):
            cols[k].append(p[k])
        segment_length.update(zip(p["seg_ids"].tolist(),
                                  p["seg_lens"].tolist()))
    return RoadNetwork(
        node_lat=node_lat, node_lon=node_lon,
        edge_start=np.concatenate(cols["edge_start"]).astype(np.int32),
        edge_end=np.concatenate(cols["edge_end"]).astype(np.int32),
        edge_length_m=np.concatenate(cols["edge_length_m"]).astype(np.float32),
        edge_speed_kph=np.concatenate(
            cols["edge_speed_kph"]).astype(np.float32),
        edge_segment_id=np.concatenate(
            cols["edge_segment_id"]).astype(np.int64),
        edge_segment_offset_m=np.concatenate(
            cols["edge_segment_offset_m"]).astype(np.float32),
        edge_internal=np.concatenate(cols["edge_internal"]).astype(bool),
        segment_length_m=segment_length,
    )


class GraphTileStore:
    """Read side: compose a RoadNetwork from a tile tree on disk."""

    def __init__(self, root: str):
        self.root = root

    def tile_paths(self) -> List[str]:
        out = []
        for r, _d, fs in os.walk(self.root):
            for f in fs:
                if f.endswith("." + SUFFIX):
                    out.append(os.path.relpath(os.path.join(r, f), self.root))
        return sorted(out)

    def read_tile(self, rel_path: str) -> dict:
        with open(os.path.join(self.root, rel_path), "rb") as f:
            return tile_from_bytes(f.read())

    def load_all(self) -> RoadNetwork:
        paths = self.tile_paths()
        return merge_tiles(self.read_tile(p) for p in paths)

    def load_bbox(self, bbox_lonlat: List[float],
                  levels: Tuple[int, ...] = (0, 1, 2)) -> RoadNetwork:
        """Network covering a (min_lon, min_lat, max_lon, max_lat) bbox:
        only the intersecting tiles are read."""
        wanted = set(tiles_for_bbox(bbox_lonlat, suffix=SUFFIX,
                                    levels=levels))
        present = [p for p in self.tile_paths() if p in wanted]
        if not present:
            raise FileNotFoundError(
                f"no tiles under {self.root} intersect bbox {bbox_lonlat}")
        return merge_tiles(self.read_tile(p) for p in present)
