"""The streaming worker: raw probe stream -> anonymised traffic tiles
(the port of ``reporter_tpu/streaming/``)."""
from .formatter import Formatter
from .batcher import Batch, PointBatcher
from .anonymiser import Anonymiser
from .broker import InMemoryBroker
from .state import StateStore

__all__ = ["Formatter", "Batch", "PointBatcher", "Anonymiser",
           "InMemoryBroker", "StateStore"]
