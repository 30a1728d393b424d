from .geo import METERS_PER_DEG, equirectangular_m, local_meters_projection
from .osmlr import INVALID_SEGMENT_ID, make_segment_id
from .tiles import BoundingBox, TileHierarchy, Tiles, tiles_for_bbox
from .tracebatch import TraceBatch, as_trace_batch, points_to_columns

__all__ = [
    "METERS_PER_DEG", "equirectangular_m", "local_meters_projection",
    "INVALID_SEGMENT_ID", "make_segment_id",
    "BoundingBox", "TileHierarchy", "Tiles", "tiles_for_bbox",
    "TraceBatch", "as_trace_batch", "points_to_columns",
]
