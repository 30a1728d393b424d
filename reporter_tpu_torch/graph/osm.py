"""OSM XML importer: build a RoadNetwork from raw OpenStreetMap data,
column for column the network the JAX package's importer builds from the
same file.

- stdlib ``xml.etree.iterparse`` streaming parse, two passes over the
  file: ways first (to learn which nodes are referenced), then nodes.
- drivable ways only, classified onto the 3-level tile hierarchy (0 =
  highway, 1 = arterial, 2 = local).
- one directed edge per consecutive node pair; two-way roads emit both
  directions; ``oneway``/roundabout semantics honoured.
- speeds from ``maxspeed`` (kph or "N mph"), else per-class defaults.
- OSMLR association synthesised per (way, direction), split at decision
  points as real OSMLR segments are: a new segment starts at every
  interior node shared with another drivable way (an intersection) and
  whenever the running length passes ~1 km, so complete-traversal
  reporting (length=-1 otherwise) is meaningful. Each segment's 64-bit id
  packs the hierarchy level, the level's geographic tile of the segment's
  first node and a per-tile running index (core/osmlr.py bit layout).
  ``service`` roads and internal edges (``*_link`` ramps, roundabouts)
  stay unassociated.

Segments never merge across ways (real OSMLR chains same-road ways). Ids
are valid, level/tile bits are geographically correct, and every
reporting path (levels, tile bucketing, privacy, CSV, complete-traversal
reporting) behaves as with authentic ids.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, IO, List, Union

import numpy as np

from ..core.geo import equirectangular_m
from ..core.osmlr import SEGMENT_INDEX_MASK, make_segment_id
from ..core.tiles import TileHierarchy
from .network import RoadNetwork

# highway=* values imported, with (hierarchy level, default speed kph):
# 0 highway, 1 arterial, 2 local
_HIGHWAY_CLASSES: Dict[str, tuple] = {
    "motorway": (0, 100.0), "motorway_link": (0, 60.0),
    "trunk": (0, 90.0), "trunk_link": (0, 50.0),
    "primary": (1, 60.0), "primary_link": (1, 40.0),
    "secondary": (1, 50.0), "secondary_link": (1, 40.0),
    "tertiary": (2, 40.0), "tertiary_link": (2, 30.0),
    "unclassified": (2, 40.0), "residential": (2, 30.0),
    "living_street": (2, 10.0), "service": (2, 20.0),
}
# classes that never get an OSMLR association (service roads); ramps and
# roundabouts are internal
_UNASSOCIATED = {"service"}
_INTERNAL_SUFFIX = "_link"
# OSMLR segments cap out around a kilometre; longer stretches between
# intersections split so complete-traversal reporting stays fine-grained
_MAX_SEGMENT_LEN_M = 1000.0


def _parse_speed(val: str, default: float) -> float:
    val = (val or "").strip().lower()
    if not val:
        return default
    try:
        if val.endswith("mph"):
            return float(val[:-3].strip()) * 1.609344
        return float(val.split()[0])
    except ValueError:
        return default


def _is_oneway(tags: Dict[str, str]) -> int:
    """0 = two-way, 1 = forward only, -1 = reverse only."""
    ow = tags.get("oneway", "").strip().lower()
    if ow in ("yes", "true", "1"):
        return 1
    if ow == "-1":
        return -1
    if ow in ("no", "false", "0"):
        return 0
    if tags.get("junction") in ("roundabout", "circular"):
        return 1
    return 0


# top-level OSM elements; cleared once fully processed. Children (nd/tag)
# must NOT be cleared early — their parent way's end event needs them.
_TOP_LEVEL = {"node", "way", "relation", "bounds"}


def _iter_elements(source: Union[str, IO[bytes]], tag: str):
    root = None
    for event, elem in ET.iterparse(source, events=("start", "end")):
        if event == "start":
            if root is None:
                root = elem
            continue
        if elem.tag == tag:
            yield elem
        if elem.tag in _TOP_LEVEL:
            elem.clear()
            # detach completed children from the root too, or country-scale
            # extracts accumulate one empty Element per node/way
            if root is not None and len(root) > 1024:
                root.clear()


def network_from_osm_xml(source: Union[str, IO[bytes]]) -> RoadNetwork:
    """Parse an OSM XML file (path or binary file object) into a
    RoadNetwork. Two streaming passes; memory is O(referenced nodes)."""
    # pass 1: drivable ways + the node ids they reference
    ways: List[tuple] = []  # (tags, [node ids])
    needed: Dict[int, int] = {}  # osm node id -> dense index (insertion order)
    for elem in _iter_elements(source, "way"):
        tags = {t.get("k"): t.get("v", "") for t in elem.findall("tag")}
        cls = tags.get("highway", "")
        if cls not in _HIGHWAY_CLASSES:
            continue
        refs = [int(nd.get("ref")) for nd in elem.findall("nd")]
        if len(refs) < 2:
            continue
        ways.append((tags, refs))
        for r in refs:
            needed.setdefault(r, len(needed))
    if not ways:
        raise ValueError("no drivable ways found in OSM input")

    # pass 2: coordinates for referenced nodes
    lat = np.full(len(needed), np.nan)
    lon = np.full(len(needed), np.nan)
    if isinstance(source, str):
        node_src: Union[str, IO[bytes]] = source
    else:
        source.seek(0)
        node_src = source
    for elem in _iter_elements(node_src, "node"):
        idx = needed.get(int(elem.get("id")))
        if idx is not None:
            lat[idx] = float(elem.get("lat"))
            lon[idx] = float(elem.get("lon"))
    missing = np.isnan(lat)
    if missing.any():
        # drop ways touching nodes absent from the extract (clipped bbox)
        bad = {osm_id for osm_id, i in needed.items() if missing[i]}
        ways = [(t, refs) for t, refs in ways
                if not any(r in bad for r in refs)]
        if not ways:
            raise ValueError("all ways reference nodes missing from input")

    hierarchy = TileHierarchy()
    seg_counters: Dict[int, int] = {}  # (level<<22|tile) -> next seg index

    e_start: List[int] = []
    e_end: List[int] = []
    e_len: List[float] = []
    e_speed: List[float] = []
    e_seg: List[int] = []
    e_off: List[float] = []
    e_internal: List[bool] = []
    segment_length: Dict[int, float] = {}

    def next_segment_id(level: int, first_node: int) -> int:
        tile_idx = hierarchy.tiles(level).tile_id(
            float(lat[first_node]), float(lon[first_node]))
        key = (level << 22) | tile_idx
        idx = seg_counters.get(key, 0)
        if idx > SEGMENT_INDEX_MASK:
            raise ValueError(f"tile {tile_idx} level {level} overflows "
                             "the 21-bit segment index")
        seg_counters[key] = idx + 1
        return make_segment_id(level, tile_idx, idx)

    # decision points: nodes referenced by more than one drivable way (or
    # more than once by the same way — a self-loop junction). Real OSMLR
    # segments break at these; segment splitting below follows suit.
    way_count: Dict[int, int] = {}
    for _tags, refs in ways:
        local: Dict[int, int] = {}
        for r in refs:
            local[r] = local.get(r, 0) + 1
        for r, c in local.items():
            # a node referenced twice by ONE way (closed ring) is a
            # decision point too: count it as two uses so the split
            # triggers at the loop-closure node
            way_count[r] = way_count.get(r, 0) + (2 if c > 1 else 1)

    for tags, refs in ways:
        cls = tags.get("highway", "")
        level, cls_speed = _HIGHWAY_CLASSES[cls]
        speed = _parse_speed(tags.get("maxspeed", ""), cls_speed)
        internal = cls.endswith(_INTERNAL_SUFFIX) \
            or tags.get("junction") in ("roundabout", "circular")
        associated = cls not in _UNASSOCIATED and not internal
        oneway = _is_oneway(tags)

        nodes = [needed[r] for r in refs]
        is_junction = [way_count.get(r, 0) > 1 for r in refs]
        seg_len = [equirectangular_m(lat[a], lon[a], lat[b], lon[b])
                   for a, b in zip(nodes[:-1], nodes[1:])]
        total = float(sum(seg_len))
        if total <= 0.0:
            continue

        directions = []
        if oneway >= 0:
            directions.append((nodes, seg_len, is_junction))
        if oneway <= 0:
            directions.append((nodes[::-1], seg_len[::-1],
                               is_junction[::-1]))
        for chain, lens, junction in directions:
            # split the way into OSMLR segments at interior decision
            # points and at the ~1 km length cap; offsets restart at 0
            # within each segment
            seg_id = next_segment_id(level, chain[0]) if associated else -1
            off = 0.0
            for step, ((a, b), L) in enumerate(
                    zip(zip(chain[:-1], chain[1:]), lens)):
                e_start.append(a)
                e_end.append(b)
                e_len.append(float(L))
                e_speed.append(speed)
                e_seg.append(seg_id)
                e_off.append(off if seg_id >= 0 else 0.0)
                e_internal.append(internal)
                off += float(L)
                interior = step + 1 < len(chain) - 1
                if seg_id >= 0 and interior and (
                        junction[step + 1] or off >= _MAX_SEGMENT_LEN_M):
                    segment_length[seg_id] = off
                    seg_id = next_segment_id(level, chain[step + 1])
                    off = 0.0
            if seg_id >= 0:
                segment_length[seg_id] = off

    # compact to nodes actually used by surviving edges: dropped/clipped
    # ways leave orphans (and NaN coords for nodes absent from the
    # extract) that would poison the centroid projection and spatial grid
    starts = np.asarray(e_start, dtype=np.int32)
    ends = np.asarray(e_end, dtype=np.int32)
    used = np.zeros(len(needed), dtype=bool)
    used[starts] = True
    used[ends] = True
    remap = np.cumsum(used) - 1
    lat = lat[used]
    lon = lon[used]

    return RoadNetwork(
        node_lat=lat, node_lon=lon,
        edge_start=remap[starts].astype(np.int32),
        edge_end=remap[ends].astype(np.int32),
        edge_length_m=np.asarray(e_len, dtype=np.float32),
        edge_speed_kph=np.asarray(e_speed, dtype=np.float32),
        edge_segment_id=np.asarray(e_seg, dtype=np.int64),
        edge_segment_offset_m=np.asarray(e_off, dtype=np.float32),
        edge_internal=np.asarray(e_internal, dtype=bool),
        segment_length_m=segment_length,
    )
