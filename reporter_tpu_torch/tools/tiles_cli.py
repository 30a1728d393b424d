"""Tile tooling: list / download / tar graph tiles for a bounding box.

Equivalent of the reference's ``py/get_tiles.py`` CLI (bbox -> tile file
paths, get_tiles.py:104-172) and ``py/download_tiles.sh`` (parallel curl
download + optional tar, download_tiles.sh:55-77), built on the tile
hierarchy math in :mod:`reporter_tpu_torch.core.tiles`.

``download`` fetches over HTTP with a thread pool (this image has no
network egress — the code path is exercised in tests against a local
server). Missing tiles are warned about, not fatal, matching the
reference's behavior (download_tiles.sh:62-69).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import logging
import os
import sys
import tarfile
import time
import urllib.error
import urllib.request

from ..core.tiles import tiles_for_bbox

logger = logging.getLogger("reporter_tpu_torch.tiles")


def list_tiles(bbox: list[float], suffix: str = "gph",
               levels=(0, 1, 2)) -> list[str]:
    return list(tiles_for_bbox(bbox, suffix=suffix, levels=levels))


def fetch_one(url: str, dest: str, timeout: float = 30.0) -> bool:
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            with open(dest, "wb") as out:
                out.write(resp.read())
        return True
    except (urllib.error.URLError, OSError) as e:
        logger.warning("%s was not found! (%s)", url, e)
        return False


def download_tiles(bbox: list[float], base_url: str, out_dir: str,
                   processes: int = 5, suffix: str = "gph",
                   levels=(0, 1, 2), tar_output: bool = False) -> list[str]:
    """Download every tile in the bbox; returns the list of missing paths."""
    paths = list_tiles(bbox, suffix=suffix, levels=levels)
    base = base_url.rstrip("/")
    with concurrent.futures.ThreadPoolExecutor(max_workers=processes) as ex:
        ok = list(ex.map(
            lambda p: fetch_one(f"{base}/{p}", os.path.join(out_dir, p)),
            paths))
    missing = [p for p, good in zip(paths, ok) if not good]
    if tar_output:
        # sorted, no-recursion member list like the reference's tar invocation
        stamp = time.strftime("%Y_%m_%d-%H_%M_%S")
        tar_path = os.path.join(out_dir, f"tiles_{stamp}.tar")
        with tarfile.open(tar_path, "w") as tar:
            for p in sorted(set(paths) - set(missing)):
                tar.add(os.path.join(out_dir, p), arcname=p, recursive=False)
        logger.info("Wrote %s", tar_path)
    return missing


def _levels(arg: str):
    return tuple(int(x) for x in arg.split(","))


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="reporter-tiles", description="Graph tile tooling")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_list = sub.add_parser("list", help="print tile paths for a bbox")
    p_list.add_argument("--bbox", required=True,
                        help="min_lon,min_lat,max_lon,max_lat")
    p_list.add_argument("--suffix", default="gph")
    p_list.add_argument("--levels", type=_levels, default=(0, 1, 2))

    p_dl = sub.add_parser("download", help="download tiles for a bbox")
    p_dl.add_argument("--bbox", required=True)
    p_dl.add_argument("--url", required=True)
    p_dl.add_argument("--output-dir", required=True)
    p_dl.add_argument("--processes", type=int, default=5)
    p_dl.add_argument("--suffix", default="gph")
    p_dl.add_argument("--levels", type=_levels, default=(0, 1, 2))
    p_dl.add_argument("--tar", action="store_true")

    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    bbox = [float(x) for x in args.bbox.split(",")]

    if args.cmd == "list":
        for path in list_tiles(bbox, args.suffix, args.levels):
            print(path)
        return 0

    missing = download_tiles(bbox, args.url, args.output_dir,
                             processes=args.processes, suffix=args.suffix,
                             levels=args.levels, tar_output=args.tar)
    if missing:
        logger.warning("%d tiles missing", len(missing))
    return 0


if __name__ == "__main__":
    sys.exit(main())
