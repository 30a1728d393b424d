"""Deterministic OSM-XML city fixture: a non-grid road network.

The accuracy gate needs a map that exercises the OSM import path
(graph/osm.py: way classification, one-way semantics, multi-node curved
ways, per-way OSMLR synthesis with in-way segment offsets) rather than
the synthetic grid, whose edges are axis-aligned and one a segment. This
module generates an OSM XML document of a plausible mid-size town,
deterministically: the same bytes every run (and the JAX package's
bytes), no checked-in binary blob:

- a jittered street net (sinusoidal node displacement: no two streets
  parallel or axis-aligned, varied block sizes and edge lengths);
- every street a single multi-node curved way (so one OSMLR segment
  spans many edges, with nonzero in-segment offsets);
- mixed classes (primary diagonals, secondary arterials, residential
  infill), alternating one-way residentials, a motorway stub with
  ``_link`` ramps (internal edges), service alleys (unassociated);
- mixed ``maxspeed`` tag formats (kph, "N mph", absent).

Usage: python -m reporter_tpu_torch.tools.osm_fixture --out city.osm.xml
"""
from __future__ import annotations

import argparse
import math
import sys
from typing import Dict, List, Tuple

LAT0, LON0 = 47.6000, -122.3300   # anchor; ~3 km x 3 km town
M_PER_DEG = 20037581.187 / 180.0
COS0 = math.cos(LAT0 * math.pi / 180.0)

GRID_N = 9          # major street grid
SPACING = 350.0     # meters between arterials


def _ll(x_m: float, y_m: float) -> Tuple[float, float]:
    return (LAT0 + y_m / M_PER_DEG,
            LON0 + x_m / (M_PER_DEG * COS0))


def _jitter(i: int, j: int) -> Tuple[float, float]:
    """Deterministic per-intersection displacement, up to ~±45 m — bends
    every street so ways are genuinely curved."""
    dx = 45.0 * math.sin(1.7 * i + 0.9 * j) * math.cos(0.6 * j)
    dy = 45.0 * math.sin(1.3 * j - 0.7 * i) * math.cos(0.8 * i)
    return dx, dy


def build_city_xml() -> str:
    nodes: Dict[Tuple[str, int, int], int] = {}
    node_ll: List[Tuple[int, float, float]] = []
    ways: List[Tuple[int, List[int], Dict[str, str]]] = []
    next_node = [1000]
    next_way = [9000]

    def node(kind: str, i: int, j: int, x: float, y: float) -> int:
        key = (kind, i, j)
        if key in nodes:
            return nodes[key]
        nid = next_node[0]
        next_node[0] += 1
        lat, lon = _ll(x, y)
        nodes[key] = nid
        node_ll.append((nid, lat, lon))
        return nid

    def grid_node(i: int, j: int) -> int:
        dx, dy = _jitter(i, j)
        return node("g", i, j, i * SPACING + dx, j * SPACING + dy)

    def vmid_node(i: int, j: int) -> int:
        """Midpoint of avenue i between rows j and j+1 (shared between
        the avenue and the residential mid-row crossing it)."""
        dx, dy = _jitter(i, j)
        dx2, dy2 = _jitter(i, j + 1)
        return node("vm", i, j, i * SPACING + 0.5 * (dx + dx2),
                    (j + 0.5) * SPACING + 0.5 * (dy + dy2))

    def way(node_ids: List[int], tags: Dict[str, str]) -> None:
        wid = next_way[0]
        next_way[0] += 1
        ways.append((wid, node_ids, tags))

    # arterials: each full row/column one curved multi-node way; avenues
    # thread through midpoint nodes so residential mid-rows intersect them
    for j in range(GRID_N):
        way([grid_node(i, j) for i in range(GRID_N)],
            {"highway": "secondary", "name": f"East Street {j}",
             **({"maxspeed": "50"} if j % 3 == 0 else {})})
    for i in range(GRID_N):
        nds = []
        for j in range(GRID_N):
            nds.append(grid_node(i, j))
            if j < GRID_N - 1:
                nds.append(vmid_node(i, j))
        way(nds, {"highway": "secondary", "name": f"North Avenue {i}",
                  **({"maxspeed": "35 mph"} if i % 3 == 1 else {})})

    # two primary diagonals weaving through grid intersections
    diag = []
    for k in range(GRID_N):
        diag.append(grid_node(k, k))
        if k < GRID_N - 1:
            dx, dy = _jitter(k, k)
            diag.append(node("d1", k, k,
                             (k + 0.5) * SPACING + dx + 40.0,
                             (k + 0.5) * SPACING + dy - 35.0))
    way(diag, {"highway": "primary", "name": "Grand Diagonal",
               "maxspeed": "60"})
    diag2 = []
    for k in range(GRID_N):
        i, j = k, GRID_N - 1 - k
        diag2.append(grid_node(i, j))
        if k < GRID_N - 1:
            dx, dy = _jitter(i, j)
            diag2.append(node("d2", i, j,
                              (i + 0.5) * SPACING + dx - 30.0,
                              (j - 0.5) * SPACING + dy + 25.0))
    way(diag2, {"highway": "primary", "name": "Counter Diagonal"})

    # residential infill: midblock streets between arterial rows,
    # alternating one-way, intersecting every avenue at its midpoint node
    for j in range(GRID_N - 1):
        mids = []
        for i in range(GRID_N):
            mids.append(vmid_node(i, j))
            if i < GRID_N - 1:
                dx, dy = _jitter(i, j)
                mids.append(node("r", i, j,
                                 (i + 0.5) * SPACING + dx + 15.0,
                                 (j + 0.5) * SPACING + dy
                                 + 25.0 * math.sin(1.1 * i + j)))
        tags = {"highway": "residential", "name": f"Mid Row {j}"}
        if j % 2 == 0:
            tags["oneway"] = "yes"
        way(mids, tags)

    # motorway stub north of town with link ramps (internal edges)
    mw = []
    for i in range(GRID_N):
        mw.append(node("m", i, 0, i * SPACING,
                       GRID_N * SPACING + 240.0 + 30.0 * math.sin(0.9 * i)))
    way(mw, {"highway": "motorway", "oneway": "yes",
             "name": "Bypass", "maxspeed": "100"})
    for i in (2, 6):
        way([mw[i], grid_node(i, GRID_N - 1)],
            {"highway": "motorway_link", "oneway": "yes"})
        way([grid_node(i + 1, GRID_N - 1), mw[i + 1]],
            {"highway": "motorway_link", "oneway": "yes"})

    # service alleys (unassociated edges)
    for i in (1, 4, 7):
        a = grid_node(i, 1)
        dx, dy = _jitter(i, 1)
        b = node("s", i, 1, i * SPACING + dx + 90.0,
                 1 * SPACING + dy + 110.0)
        way([a, b], {"highway": "service"})

    out = ['<?xml version="1.0" encoding="UTF-8"?>',
           '<osm version="0.6" generator="reporter_tpu-fixture">']
    for nid, lat, lon in node_ll:
        out.append(f'  <node id="{nid}" lat="{lat:.7f}" lon="{lon:.7f}"/>')
    for wid, nds, tags in ways:
        out.append(f'  <way id="{wid}">')
        out.extend(f'    <nd ref="{n}"/>' for n in nds)
        out.extend(f'    <tag k="{k}" v="{v}"/>' for k, v in tags.items())
        out.append('  </way>')
    out.append('</osm>')
    return "\n".join(out) + "\n"


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="reporter_tpu_torch osm-fixture", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", required=True, help="output .osm.xml path")
    args = parser.parse_args(argv)
    xml = build_city_xml()
    with open(args.out, "w") as f:
        f.write(xml)
    print(f"wrote {args.out}: {xml.count('<node')} nodes, "
          f"{xml.count('<way')} ways")
    return 0


if __name__ == "__main__":
    sys.exit(main())
