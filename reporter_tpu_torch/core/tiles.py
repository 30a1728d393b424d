"""Valhalla-compatible 3-level geographic tile hierarchy (the part the
synthetic city needs to name its segments' tiles).

Level 2 = local (0.25°), level 1 = arterial (1°), level 0 = highway (4°),
over the whole-world bounding box; tile ids are row-major
(reference: py/get_tiles.py:30-102).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

WORLD_MIN_X, WORLD_MIN_Y, WORLD_MAX_X, WORLD_MAX_Y = -180.0, -90.0, 180.0, 90.0

LEVEL_SIZES = {2: 0.25, 1: 1.0, 0: 4.0}


@dataclass(frozen=True)
class BoundingBox:
    minx: float
    miny: float
    maxx: float
    maxy: float


class Tiles:
    """Row/column math for one hierarchy level
    (reference: get_tiles.py:41-102)."""

    def __init__(self, bbox: BoundingBox, size: float):
        self.bbox = bbox
        self.tilesize = size
        self.ncolumns = int(math.ceil((bbox.maxx - bbox.minx) / size))
        self.nrows = int(math.ceil((bbox.maxy - bbox.miny) / size))
        self.max_tile_id = self.ncolumns * self.nrows - 1

    def row(self, y: float) -> int:
        if y < self.bbox.miny or y > self.bbox.maxy:
            return -1
        if y == self.bbox.maxy:
            return self.nrows - 1
        return int((y - self.bbox.miny) / self.tilesize)

    def col(self, x: float) -> int:
        if x < self.bbox.minx or x > self.bbox.maxx:
            return -1
        if x == self.bbox.maxx:
            return self.ncolumns - 1
        c = (x - self.bbox.minx) / self.tilesize
        return int(c) if c >= 0.0 else int(c - 1)

    def tile_id(self, lat: float, lon: float) -> int:
        r, c = self.row(lat), self.col(lon)
        if r < 0 or c < 0:
            return -1
        return r * self.ncolumns + c


class TileHierarchy:
    def __init__(self):
        world = BoundingBox(WORLD_MIN_X, WORLD_MIN_Y, WORLD_MAX_X, WORLD_MAX_Y)
        self.levels = {lvl: Tiles(world, size) for lvl, size in LEVEL_SIZES.items()}

    def tiles(self, level: int) -> Tiles:
        return self.levels[level]
