"""Frozen copy of the port's ``reporter_tpu_torch/core/tiles.py`` (the plain
reference of the benchmark; imports nothing of the program).

Valhalla-compatible 3-level geographic tile hierarchy.

Level 2 = local (0.25°), level 1 = arterial (1°), level 0 = highway (4°),
over the whole-world bounding box; tile ids are row-major
(reference: py/get_tiles.py:30-102). File paths group the decimal id into
3-digit directories: ``{level}/{nnn}/{nnn}/{nnn}.{suffix}``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Tuple

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

    def tile_bbox(self, tile_id: int) -> BoundingBox:
        """Bounding box of one tile, the inverse of :meth:`tile_id` (any
        interior point maps back to the same id; the shared max edge
        belongs to the neighbour except at the world boundary)."""
        if tile_id < 0 or tile_id > self.max_tile_id:
            raise ValueError(f"tile id {tile_id} out of range "
                             f"[0, {self.max_tile_id}]")
        r, c = divmod(tile_id, self.ncolumns)
        minx = self.bbox.minx + c * self.tilesize
        miny = self.bbox.miny + r * self.tilesize
        return BoundingBox(minx, miny,
                           min(minx + self.tilesize, self.bbox.maxx),
                           min(miny + self.tilesize, self.bbox.maxy))

    def _digits(self, number: int) -> int:
        digits = 1 if number < 0 else 0
        while number:
            number //= 10
            digits += 1
        return digits

    def file_path(self, tile_id: int, level: int, suffix: str) -> str:
        """``{level}/{nnn}/{nnn}/{nnn}.{suffix}`` grouping the decimal tile id
        into 3-digit directories (reference: get_tiles.py:82-102)."""
        max_length = self._digits(self.max_tile_id)
        if max_length % 3:
            max_length += 3 - max_length % 3
        # prepend the level digit, then group by thousands
        combined = level * 10 ** max_length + tile_id
        grouped = f"{combined:,}".replace(",", "/")
        if level == 0:
            # a leading "1" placeholder keeps the zero-padding; swap it back
            grouped_full = f"{10 ** max_length + tile_id:,}".replace(",", "/")
            grouped = "0" + grouped_full[1:]
        return f"{grouped}.{suffix}"


class TileHierarchy:
    def __init__(self):
        world = BoundingBox(WORLD_MIN_X, WORLD_MIN_Y, WORLD_MAX_X, WORLD_MAX_Y)
        self.levels = {lvl: Tiles(world, size) for lvl, size in LEVEL_SIZES.items()}

    def tiles(self, level: int) -> Tiles:
        return self.levels[level]


def _split_antimeridian(bbox: List[float]) -> List[BoundingBox]:
    """Split a (minx,miny,maxx,maxy) box crossing ±180 into two boxes
    (reference: get_tiles.py:139-157)."""
    minx, miny, maxx, maxy = bbox
    if minx >= maxx:
        minx -= 360
    span = WORLD_MAX_X - WORLD_MIN_X
    if minx < WORLD_MIN_X and maxx > WORLD_MIN_X:
        return [BoundingBox(WORLD_MIN_X, miny, maxx, maxy),
                BoundingBox(minx + span, miny, WORLD_MAX_X, maxy)]
    if minx < WORLD_MAX_X and maxx > WORLD_MAX_X:
        return [BoundingBox(minx, miny, WORLD_MAX_X, maxy),
                BoundingBox(WORLD_MIN_X, miny, maxx - span, maxy)]
    return [BoundingBox(minx, miny, maxx, maxy)]


def tiles_for_bbox(bbox_lonlat: List[float], suffix: str = "gph",
                   levels: Tuple[int, ...] = (0, 1, 2)) -> Iterator[str]:
    """Yield tile file paths intersecting a lon/lat bbox
    (min_lon, min_lat, max_lon, max_lat), splitting at the antimeridian
    (reference: get_tiles.py:130-172)."""
    hierarchy = TileHierarchy()
    for box in _split_antimeridian(list(bbox_lonlat)):
        if box.miny < WORLD_MIN_Y or box.maxy > WORLD_MAX_Y:
            raise ValueError(f"latitude out of range in bbox {bbox_lonlat}")
        for level in levels:
            t = hierarchy.tiles(level)
            min_col, max_col = t.col(box.minx), t.col(box.maxx)
            min_row, max_row = t.row(box.miny), t.row(box.maxy)
            if -1 in (min_col, max_col, min_row, max_row):
                raise ValueError(f"bbox {bbox_lonlat} outside tile system")
            for r in range(min_row, max_row + 1):
                for c in range(min_col, max_col + 1):
                    yield t.file_path(r * t.ncolumns + c, level, suffix)
