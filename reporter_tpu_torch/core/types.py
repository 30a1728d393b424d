"""Core value types with the reference's exact wire/CSV layouts (the port
of ``reporter_tpu/core/types.py``; bytes and CSV text identical).

Point: 20-byte fixed binary (f32 lat, f32 lon, i32 accuracy, i64 time)
  (reference: Point.java:18,50-58)
Segment: 40-byte fixed binary (i64 id, i64 next_id, f64 min, f64 max,
  i32 length, i32 queue) and the 10-column tile CSV row
  (reference: Segment.java:22,55-74)
TimeQuantisedTile: 16-byte key (i64 time_range_start, i64 tile_id)
  (reference: TimeQuantisedTile.java:19,49-88)
"""
from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from typing import List, Optional

from .osmlr import (
    INVALID_SEGMENT_ID,
    LEVEL_BITS,
    LEVEL_MASK,
    TILE_INDEX_MASK,
    tile_id_of_segment,
)


def _fmt_float(v: float) -> str:
    """Format a float with up to 6 fractional digits, no trailing zeros.

    Mirrors the reference's DecimalFormat("###.######") used when emitting
    point JSON (reference: Point.java:49,59-65).
    """
    s = f"{float(v):.6f}".rstrip("0").rstrip(".")
    return s if s not in ("", "-0") else "0"


_POINT_STRUCT = struct.Struct(">ffiq")  # big-endian like java.nio ByteBuffer


_F32 = struct.Struct(">ff")


@dataclass
class Point:
    lat: float
    lon: float
    accuracy: int
    time: int

    SIZE = _POINT_STRUCT.size  # 20

    def __post_init__(self):
        # the f32 wire format IS the value domain: quantise at
        # construction so every serde roundtrip (Kafka frame, state
        # snapshot) is the identity. Before this, a point restored from
        # a crash snapshot differed from its never-snapshotted twin in
        # the f32-truncated digits — enough to flip a rounded report
        # duration and break crash/restore output parity (the chaos
        # harness's kill_restore scenario caught exactly that).
        self.lat, self.lon = _F32.unpack(_F32.pack(self.lat, self.lon))

    def to_bytes(self) -> bytes:
        return _POINT_STRUCT.pack(self.lat, self.lon, self.accuracy, self.time)

    @classmethod
    def from_bytes(cls, raw: bytes, offset: int = 0) -> "Point":
        lat, lon, accuracy, time = _POINT_STRUCT.unpack_from(raw, offset)
        return cls(lat, lon, accuracy, time)

    def to_json_obj(self) -> dict:
        return {
            "lat": round(float(self.lat), 6),
            "lon": round(float(self.lon), 6),
            "time": int(self.time),
            "accuracy": int(self.accuracy),
        }

    def to_json_str(self) -> str:
        return (
            '{"lat":' + _fmt_float(self.lat)
            + ',"lon":' + _fmt_float(self.lon)
            + ',"time":' + str(int(self.time))
            + ',"accuracy":' + str(int(self.accuracy)) + "}"
        )


_SEGMENT_STRUCT = struct.Struct(">qqddii")  # 40 bytes


@dataclass
class Segment:
    """A single observation of a (segment, next segment) pair — one histogram
    entry in a traffic tile (reference: Segment.java:11-31)."""

    id: int
    next_id: Optional[int]
    min: float   # epoch seconds at segment start
    max: float   # epoch seconds at next-segment start (or segment end)
    length: int  # meters
    queue: int   # meters

    SIZE = _SEGMENT_STRUCT.size  # 40

    def __post_init__(self):
        if self.next_id is None:
            self.next_id = INVALID_SEGMENT_ID

    def tile_id(self) -> int:
        """3-bit level + 22-bit tile index (reference: Segment.java:33-36)."""
        return tile_id_of_segment(self.id)

    def valid(self) -> bool:
        # reference: Segment.java:38-40
        return self.min > 0 and self.max > 0 and self.max > self.min \
            and self.length > 0 and self.queue >= 0

    def sort_key(self):
        # reference: Segment.java:50-53 (id, then next_id)
        return (self.id, self.next_id)

    def csv_row(self, mode: str, source: str) -> str:
        """One tile CSV row (reference: Segment.java:59-74). ``next_id`` is
        left empty when invalid; duration is round(max-min); count always 1."""
        next_str = "" if self.next_id == INVALID_SEGMENT_ID else str(self.next_id)
        # half-up rounding to match Java Math.round (Python round() is banker's)
        duration = int(math.floor((self.max - self.min) + 0.5))
        return ",".join([
            str(self.id),
            next_str,
            str(duration),
            "1",
            str(int(self.length)),
            str(int(self.queue)),
            str(int(math.floor(self.min))),
            str(int(math.ceil(self.max))),
            source,
            mode,
        ])

    @staticmethod
    def column_layout() -> str:
        # reference: Segment.java:55-57 / simple_reporter.py:252
        return ("segment_id,next_segment_id,duration,count,length,queue_length,"
                "minimum_timestamp,maximum_timestamp,source,vehicle_type")

    def to_bytes(self) -> bytes:
        return _SEGMENT_STRUCT.pack(
            self.id, self.next_id, self.min, self.max, self.length, self.queue)

    @classmethod
    def from_bytes(cls, raw: bytes, offset: int = 0) -> "Segment":
        sid, nid, mn, mx, ln, q = _SEGMENT_STRUCT.unpack_from(raw, offset)
        return cls(sid, nid, mn, mx, ln, q)


_TILE_STRUCT = struct.Struct(">qq")


@dataclass(frozen=True)
class TimeQuantisedTile:
    """Key for the anonymiser's accumulation map: (time bucket start, graph
    tile id) (reference: TimeQuantisedTile.java:16-24)."""

    time_range_start: int
    tile_id: int

    SIZE = _TILE_STRUCT.size  # 16

    @staticmethod
    def tiles_for(segment: Segment, quantisation: int) -> List["TimeQuantisedTile"]:
        """All time buckets a segment observation spans
        (reference: TimeQuantisedTile.java:26-35)."""
        lo = int(segment.min)
        hi = int(segment.max)
        return [
            TimeQuantisedTile(b * quantisation, segment.tile_id())
            for b in range(lo // quantisation, hi // quantisation + 1)
        ]

    def tile_index(self) -> int:
        return (self.tile_id >> LEVEL_BITS) & TILE_INDEX_MASK

    def tile_level(self) -> int:
        return self.tile_id & LEVEL_MASK

    def __str__(self) -> str:
        return f"{self.time_range_start}_{self.tile_id}"

    def to_bytes(self) -> bytes:
        return _TILE_STRUCT.pack(self.time_range_start, self.tile_id)

    @classmethod
    def from_bytes(cls, raw: bytes, offset: int = 0) -> "TimeQuantisedTile":
        start, tid = _TILE_STRUCT.unpack_from(raw, offset)
        return cls(start, tid)
