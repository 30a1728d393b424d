"""OSMLR 64-bit segment-id bit layout.

An OSMLR traffic segment id packs, from the low bits up: a 3-bit hierarchy
level, a 22-bit tile index within that level, and a 21-bit segment index
within the tile (reference: py/simple_reporter.py:36-49; mirrored in Java at
src/main/java/io/opentraffic/reporter/Segment.java:33-36 and
TimeQuantisedTile.java:37-43).

The all-ones 46-bit value is the INVALID sentinel used for "no next segment"
(reference: Segment.java:16, simple_reporter.py:43).
"""

LEVEL_BITS = 3
TILE_INDEX_BITS = 22
SEGMENT_INDEX_BITS = 21

LEVEL_MASK = (1 << LEVEL_BITS) - 1
TILE_INDEX_MASK = (1 << TILE_INDEX_BITS) - 1
SEGMENT_INDEX_MASK = (1 << SEGMENT_INDEX_BITS) - 1

INVALID_SEGMENT_ID = (
    (SEGMENT_INDEX_MASK << (TILE_INDEX_BITS + LEVEL_BITS))
    | (TILE_INDEX_MASK << LEVEL_BITS)
    | LEVEL_MASK
)  # == 0x3fffffffffff


def make_segment_id(level: int, tile_idx: int, seg_idx: int) -> int:
    """Pack (level, tile index, segment index) into a 64-bit OSMLR id."""
    if not 0 <= level <= LEVEL_MASK:
        raise ValueError(f"level {level} out of range")
    if not 0 <= tile_idx <= TILE_INDEX_MASK:
        raise ValueError(f"tile index {tile_idx} out of range")
    if not 0 <= seg_idx <= SEGMENT_INDEX_MASK:
        raise ValueError(f"segment index {seg_idx} out of range")
    return (seg_idx << (TILE_INDEX_BITS + LEVEL_BITS)) | (tile_idx << LEVEL_BITS) | level


def tile_level(segment_id: int) -> int:
    """Hierarchy level (0=highway, 1=arterial, 2=local) from the low 3 bits."""
    return segment_id & LEVEL_MASK


def tile_index(segment_id: int) -> int:
    return (segment_id >> LEVEL_BITS) & TILE_INDEX_MASK


def segment_index(segment_id: int) -> int:
    return (segment_id >> (LEVEL_BITS + TILE_INDEX_BITS)) & SEGMENT_INDEX_MASK


def tile_id_of_segment(segment_id: int) -> int:
    """Level + tile-index bits only — the 25-bit graph tile id.

    (reference: Segment.java:34-36 ``id & 0x1FFFFFF``)
    """
    return segment_id & ((1 << (LEVEL_BITS + TILE_INDEX_BITS)) - 1)
