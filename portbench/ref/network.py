"""Frozen copy of the port's ``reporter_tpu_torch/graph/network.py`` (the plain
reference of the benchmark; imports nothing of the program).

Road network: a columnar, numpy-backed directed graph with OSMLR
segment associations, stored as ``.npz`` in the same format the JAX
package writes (so one saved city serves both).

Edges are directed; geometry is the straight segment between end nodes.
Each edge belongs to at most one OSMLR traffic segment
(``edge_segment_id``; -1 when unassociated), entering it at
``edge_segment_offset_m`` from the segment start; ``segment_length_m``
maps segment id -> full length, which reporting needs to tell complete
from partial traversals.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from .geo import local_meters_projection

#: the persisted columns, in ``.npz`` key order (besides seg_ids/seg_lens)
COLUMNS = ("node_lat", "node_lon", "edge_start", "edge_end",
           "edge_length_m", "edge_speed_kph", "edge_segment_id",
           "edge_segment_offset_m", "edge_internal")


@dataclass
class RoadNetwork:
    # nodes
    node_lat: np.ndarray  # (N,) f64 degrees
    node_lon: np.ndarray  # (N,) f64
    # directed edges
    edge_start: np.ndarray        # (E,) i32 node index
    edge_end: np.ndarray          # (E,) i32
    edge_length_m: np.ndarray     # (E,) f32
    edge_speed_kph: np.ndarray    # (E,) f32
    edge_segment_id: np.ndarray   # (E,) i64, -1 = unassociated
    edge_segment_offset_m: np.ndarray  # (E,) f32
    edge_internal: np.ndarray     # (E,) bool
    # OSMLR segment id -> total segment length (meters)
    segment_length_m: Dict[int, float] = field(default_factory=dict)

    # derived, built lazily
    _csr_offsets: Optional[np.ndarray] = None   # (N+1,) out-edge CSR
    _csr_edges: Optional[np.ndarray] = None     # (E,) edge ids sorted by start node
    _node_x: Optional[np.ndarray] = None        # projected meters
    _node_y: Optional[np.ndarray] = None
    _proj: Optional[tuple] = None               # (to_xy, to_ll)
    _headings: Optional[np.ndarray] = None      # (E, 2) unit headings

    @property
    def num_nodes(self) -> int:
        return len(self.node_lat)

    @property
    def num_edges(self) -> int:
        return len(self.edge_start)

    def projection_anchor(self):
        """(lat0, lon0) the local projection is anchored at: the network
        centroid. The native batched prep projects points with it."""
        return float(np.mean(self.node_lat)), float(np.mean(self.node_lon))

    def projection(self):
        """Local equirectangular meters projection anchored at the network
        centroid; built once and shared by spatial index and matcher."""
        if self._proj is None:
            self._proj = local_meters_projection(*self.projection_anchor())
        return self._proj

    def node_xy(self):
        if self._node_x is None:
            to_xy, _ = self.projection()
            self._node_x, self._node_y = to_xy(self.node_lat, self.node_lon)
        return self._node_x, self._node_y

    def headings(self) -> np.ndarray:
        """(E, 2) unit heading per edge in projected meters; turn-penalty
        pricing and its removal in assembly both read it."""
        if self._headings is None:
            nx, ny = self.node_xy()
            dx = nx[self.edge_end] - nx[self.edge_start]
            dy = ny[self.edge_end] - ny[self.edge_start]
            n = np.maximum(np.hypot(dx, dy), 1e-9)
            self._headings = np.stack([dx / n, dy / n], axis=1)
        return self._headings

    def csr(self):
        """Out-edge adjacency in CSR form: (offsets[N+1], edge_ids[E])."""
        if self._csr_offsets is None:
            order = np.argsort(self.edge_start, kind="stable")
            counts = np.bincount(self.edge_start, minlength=self.num_nodes)
            offsets = np.zeros(self.num_nodes + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
            self._csr_offsets = offsets
            self._csr_edges = order.astype(np.int32)
        return self._csr_offsets, self._csr_edges

    def save(self, path) -> None:
        """Write the network ``.npz``: the persisted columns, then the
        segment lengths as ``seg_ids`` (sorted) and ``seg_lens`` (f32), the
        format :meth:`load` and the JAX package's ``RoadNetwork.load``
        read."""
        seg_ids = np.array(sorted(self.segment_length_m), dtype=np.int64)
        seg_lens = np.array([self.segment_length_m[s] for s in seg_ids],
                            dtype=np.float32)
        np.savez_compressed(path, **{name: getattr(self, name)
                                     for name in COLUMNS},
                            seg_ids=seg_ids, seg_lens=seg_lens)

    @classmethod
    def load(cls, path) -> "RoadNetwork":
        """Read a network ``.npz`` (:meth:`save`'s format, which is the
        JAX package's)."""
        with np.load(path) as data:
            return network_from_arrays({k: data[k] for k in data.files})


def network_from_arrays(cols: Dict[str, np.ndarray]) -> RoadNetwork:
    """Build a network from its column arrays: the keys of the ``.npz``
    format (``node_lat`` ... ``edge_internal``, ``seg_ids``, ``seg_lens``).

    This is how a network built elsewhere crosses into this package; the
    segment-length dict goes through the same f32 round trip as a saved
    file, so either route gives the same network.
    """
    seg = dict(zip(np.asarray(cols["seg_ids"]).tolist(),
                   np.asarray(cols["seg_lens"], dtype=np.float32).tolist()))
    return RoadNetwork(
        node_lat=np.asarray(cols["node_lat"], dtype=np.float64),
        node_lon=np.asarray(cols["node_lon"], dtype=np.float64),
        edge_start=np.asarray(cols["edge_start"], dtype=np.int32),
        edge_end=np.asarray(cols["edge_end"], dtype=np.int32),
        edge_length_m=np.asarray(cols["edge_length_m"], dtype=np.float32),
        edge_speed_kph=np.asarray(cols["edge_speed_kph"], dtype=np.float32),
        edge_segment_id=np.asarray(cols["edge_segment_id"], dtype=np.int64),
        edge_segment_offset_m=np.asarray(cols["edge_segment_offset_m"],
                                         dtype=np.float32),
        edge_internal=np.asarray(cols["edge_internal"], dtype=bool),
        segment_length_m=seg,
    )
