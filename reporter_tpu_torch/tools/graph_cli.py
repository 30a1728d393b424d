"""Graph tooling: build, tile and inspect road networks.

  build-synth   generate a synthetic grid city -> monolithic .npz
  import-osm    parse raw OSM XML -> monolithic .npz (graph/osm.py)
  tile          partition a monolithic .npz into an RGT tile tree
  untile        compose a tile tree (optionally bbox-scoped) -> .npz
  info          counts for a .npz or tile tree

Reading tiles (``untile``, ``info`` of a tree) parses them with the C++
host runtime, which is built with g++ at first use.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="reporter-graph", description="Road-network tooling")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_b = sub.add_parser("build-synth", help="generate a grid city")
    p_b.add_argument("--rows", type=int, default=20)
    p_b.add_argument("--cols", type=int, default=20)
    p_b.add_argument("--spacing-m", type=float, default=200.0)
    p_b.add_argument("--seed", type=int, default=0)
    p_b.add_argument("--out", required=True, help=".npz path")

    p_o = sub.add_parser("import-osm", help="parse OSM XML into a graph")
    p_o.add_argument("--in", dest="osm_in", required=True,
                     help="OSM XML file (.osm / .xml)")
    p_o.add_argument("--out", required=True, help=".npz path")

    p_t = sub.add_parser("tile", help="partition a .npz into RGT tiles")
    p_t.add_argument("--graph", required=True)
    p_t.add_argument("--out-dir", required=True)

    p_u = sub.add_parser("untile", help="compose RGT tiles into a .npz")
    p_u.add_argument("--tile-dir", required=True)
    p_u.add_argument("--bbox", help="min_lon,min_lat,max_lon,max_lat; "
                     "omit for all tiles")
    p_u.add_argument("--out", required=True)

    p_i = sub.add_parser("info", help="print graph counts")
    p_i.add_argument("target", help=".npz file or tile tree dir")

    args = parser.parse_args(argv)

    from ..graph.network import RoadNetwork
    from ..graph.tilestore import GraphTileStore, write_tiles

    if args.cmd == "build-synth":
        from ..synth import build_grid_city
        net = build_grid_city(rows=args.rows, cols=args.cols,
                              spacing_m=args.spacing_m, seed=args.seed)
        net.save(args.out)
        print(f"wrote {args.out}: {net.num_nodes} nodes, "
              f"{net.num_edges} edges")
    elif args.cmd == "import-osm":
        from ..graph.osm import network_from_osm_xml
        net = network_from_osm_xml(args.osm_in)
        net.save(args.out)
        print(f"wrote {args.out}: {net.num_nodes} nodes, "
              f"{net.num_edges} edges, "
              f"{len(net.segment_length_m)} OSMLR segments")
    elif args.cmd == "tile":
        net = RoadNetwork.load(args.graph)
        written = write_tiles(net, args.out_dir)
        print(f"wrote {len(written)} tiles under {args.out_dir}")
        for rel in written:
            print(rel)
    elif args.cmd == "untile":
        store = GraphTileStore(args.tile_dir)
        if args.bbox:
            bbox = [float(x) for x in args.bbox.split(",")]
            net = store.load_bbox(bbox)
        else:
            net = store.load_all()
        net.save(args.out)
        print(f"wrote {args.out}: {net.num_nodes} nodes, "
              f"{net.num_edges} edges")
    else:  # info
        import os
        if os.path.isdir(args.target):
            store = GraphTileStore(args.target)
            paths = store.tile_paths()
            net = store.load_all()
            print(f"{len(paths)} tiles, {net.num_nodes} nodes, "
                  f"{net.num_edges} edges, "
                  f"{len(net.segment_length_m)} OSMLR segments")
        else:
            net = RoadNetwork.load(args.target)
            print(f"{net.num_nodes} nodes, {net.num_edges} edges, "
                  f"{len(net.segment_length_m)} OSMLR segments")
    return 0


if __name__ == "__main__":
    sys.exit(main())
