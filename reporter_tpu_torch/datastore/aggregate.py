"""Whole-batch histogram aggregation — the datastore's hot kernel.

Turns a columnar :class:`~.schema.ObservationBatch` into per-partition
deltas:

- **histogram cells**: sorted unique composite keys (segment x
  hour-of-week x speed bin, schema.hist_key) with per-cell observation
  counts and speed sums (the speed sum keeps query-side means exact
  instead of bin-center approximations),
- **transition counts**: sorted unique (segment, next segment) pairs.

The whole batch flows through ``np.searchsorted`` / ``np.unique`` /
``np.add.at``, with no per-row Python. It stays numpy on the host, as in
the JAX package: no torch, no device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from ..utils import metrics
from .schema import (
    GRAPH_TILE_MASK,
    INVALID_SEGMENT_ID,
    ObservationBatch,
    hist_key,
    hour_of_week,
    speed_bin,
)
from ..core.osmlr import LEVEL_BITS, LEVEL_MASK


@dataclass
class Delta:
    """One partition's aggregation increment (all arrays sorted by key)."""

    hist_key: np.ndarray        # int64, sorted unique composite keys
    hist_count: np.ndarray      # int64 observations per cell
    hist_speed_sum: np.ndarray  # float64 sum of kph per cell
    trans_from: np.ndarray      # int64, sorted (from, to) pairs
    trans_to: np.ndarray        # int64
    trans_count: np.ndarray     # int64

    def __len__(self) -> int:
        return int(self.hist_key.shape[0])

    @property
    def rows(self) -> int:
        return int(self.hist_count.sum()) if len(self) else 0


def _reduce_hist(keys: np.ndarray, counts: np.ndarray,
                 speed_mass: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
    """Sum counts and speed mass (sum of kph) over duplicate keys."""
    ukeys, inv = np.unique(keys, return_inverse=True)
    csum = np.zeros(ukeys.shape[0], dtype=np.int64)
    ssum = np.zeros(ukeys.shape[0], dtype=np.float64)
    np.add.at(csum, inv, counts)
    np.add.at(ssum, inv, speed_mass)
    return ukeys, csum, ssum


def _reduce_trans(frm: np.ndarray, to: np.ndarray,
                  counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """Sum counts over duplicate (from, to) pairs, sorted by (from, to)."""
    pairs = np.stack([frm, to], axis=1)
    upairs, inv = np.unique(pairs, axis=0, return_inverse=True)
    csum = np.zeros(upairs.shape[0], dtype=np.int64)
    np.add.at(csum, inv, counts)
    return upairs[:, 0].copy(), upairs[:, 1].copy(), csum


def aggregate(obs: ObservationBatch) -> Dict[Tuple[int, int], Delta]:
    """Aggregate a batch into ``{(level, tile_index): Delta}``.

    Invalid observations (zero duration/length, unset timestamps) are
    masked out in one pass; transitions additionally require a real next
    segment id.
    """
    with metrics.timer("datastore.aggregate"):
        keep = obs.valid_mask()
        seg = obs.segment_id[keep]
        if seg.shape[0] == 0:
            return {}
        nxt = obs.next_id[keep]
        cnt = obs.count[keep]
        kph = obs.speeds_kph()[keep]
        hour = hour_of_week(obs.min_ts[keep])
        keys = hist_key(seg, hour, speed_bin(kph))

        tile_part = seg & GRAPH_TILE_MASK
        out: Dict[Tuple[int, int], Delta] = {}
        # few distinct graph tiles per flush — the per-partition loop is
        # coarse; everything inside it is whole-array numpy
        for tile in np.unique(tile_part):
            m = tile_part == tile
            hk, hc, hs = _reduce_hist(keys[m], cnt[m], kph[m] * cnt[m])
            mt = m & (nxt != INVALID_SEGMENT_ID)
            tf, tt, tc = _reduce_trans(seg[mt], nxt[mt], cnt[mt])
            level = int(tile) & LEVEL_MASK
            index = int(tile) >> LEVEL_BITS
            out[(level, index)] = Delta(hk, hc, hs, tf, tt, tc)
        metrics.count("datastore.aggregate.rows", int(seg.shape[0]))
        return out


def merge_deltas(parts) -> Delta:
    """Merge already-reduced deltas of ONE partition into one Delta —
    the compaction kernel (store.py) and the multi-file query reducer."""
    parts = [p for p in parts if len(p) or p.trans_from.shape[0]]
    if not parts:
        z = np.zeros(0, dtype=np.int64)
        return Delta(z, z.copy(), np.zeros(0, dtype=np.float64),
                     z.copy(), z.copy(), z.copy())
    hk, hc, hs = _reduce_hist(
        np.concatenate([p.hist_key for p in parts]),
        np.concatenate([p.hist_count for p in parts]),
        np.concatenate([p.hist_speed_sum for p in parts]))
    tf, tt, tc = _reduce_trans(
        np.concatenate([p.trans_from for p in parts]),
        np.concatenate([p.trans_to for p in parts]),
        np.concatenate([p.trans_count for p in parts]))
    return Delta(hk, hc, hs, tf, tt, tc)


__all__ = ["Delta", "aggregate", "merge_deltas"]
