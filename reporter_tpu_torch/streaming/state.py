"""Durable streaming state: snapshot/restore for batcher + anonymiser.

The port of ``reporter_tpu/streaming/state.py``, byte for byte the same
format: a snapshot written by either package restores in the other (the
incremental section carries ``IncrementalTable.to_blobs()`` frames,
which are the JAX package's carried-state blobs).

The reference's streaming worker keeps all state in **in-memory** Kafka
Streams stores — explicitly not RocksDB — so a crash loses every open
per-uuid batch and every accumulated tile slice
(reference: BatchingProcessor.java:20-22, AnonymisingProcessor.java:47-59).
SURVEY.md §5 flags that as the durability decision to improve on.

This module is the improvement: a periodic, atomic, binary snapshot of
the worker's two state stores, restored on startup. The wire layouts are
the framework's own fixed-width serdes (Point 20 B, Segment 40 B,
TimeQuantisedTile 16 B — core/types.py), so the snapshot stays compact
and the serde code paths get exercised in production. Writes go to a tmp
file (fsync'd, then the directory fsync'd after ``os.replace`` — a bare
rename can survive a power loss as an empty file) so a crash mid-write
leaves the previous snapshot intact; restore of a truncated/corrupt file
is treated as "no snapshot" (the reference's crash semantics) rather
than an error.

Exactly-once-ish egress (three-step flush protocol, worker._flush_tiles):
(1) a PRE-egress snapshot makes the report trims that fed the flush
durable — no crash can restore untrimmed batches that would re-report
already-egressed segments; (2) the tiles egress under deterministic
epoch file names; (3) :meth:`StateStore.commit_epoch` durably marks the
epoch fully egressed in a sidecar file (``<path>.epoch``) before the
post-flush snapshot. A crash after the marker restores the pre-flush
snapshot, detects ``committed >= snapshot.flush_epoch`` and skips the
epoch — clearing the restored slices instead of double-emitting them; a
crash *before* the marker re-emits the epoch under the same names,
which the file sink overwrites byte-identically and remote sinks dedupe
on — every window is covered.

Layout (little-endian, "RTS1" magic, version 3; v1 snapshots predate the
flush epoch and are discarded as corrupt — the reference's crash
semantics, one replay window wide. v2 snapshots are READ compatibly:
they simply predate the incremental section, which is a pure work-saving
cache — restoring none of it just means those traces re-decode their
window on the next report):

  header:  4s magic | u32 version | u64 snapshot_unix_ms
  epoch:   u64 flush_epoch
  batches: u32 count, then per uuid:
           u16 uuid_len | uuid utf-8 | f32 max_separation |
           u64 last_update_ms | u32 retries | u32 n_points |
           n_points * Point
  pending: u32 count, then per uuid: u16 uuid_len | uuid utf-8
           (sessions awaiting a batched report flush — restoring them
           keeps flush boundaries deterministic across a crash)
  slices:  u32 count, then per slice:
           u16 name_len | name utf-8 | u32 n_segments | n * Segment
  slice_of: u32 count, then per tile: Tile | u32 slice_no
  incremental (v3+): u32 count, then per uuid:
           u16 uuid_len | uuid utf-8 | u32 blob_len | blob
           (opaque CarriedState frames, matcher/incremental.py serde —
           crash-restore resumes mid-stream incremental decode instead
           of paying a full-window replay per live session)
"""
from __future__ import annotations

import logging
import os
import struct
import time
from typing import Optional

from ..core.types import Point, Segment, TimeQuantisedTile
from ..utils import faults, fsio, metrics
from .batcher import Batch, PointBatcher
from .anonymiser import Anonymiser

logger = logging.getLogger("reporter_tpu_torch.streaming")

_MAGIC = b"RTS1"
_VERSION = 3
_HEADER = struct.Struct("<4sIQ")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_BATCH_META = struct.Struct("<fQII")


def _pack_str(out: bytearray, s: str) -> None:
    raw = s.encode("utf-8")
    out += _U16.pack(len(raw))
    out += raw


class _Reader:
    def __init__(self, raw: bytes):
        self.raw = raw
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.raw):
            raise ValueError("truncated snapshot")
        chunk = self.raw[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def u16(self) -> int:
        return _U16.unpack(self.take(2))[0]

    def u32(self) -> int:
        return _U32.unpack(self.take(4))[0]

    def u64(self) -> int:
        return _U64.unpack(self.take(8))[0]

    def string(self) -> str:
        return self.take(self.u16()).decode("utf-8")


def snapshot_bytes(batcher: PointBatcher, anonymiser: Anonymiser,
                   incremental=None) -> bytes:
    """``incremental`` is [(uuid, blob)] carried-state frames
    (IncrementalTable.to_blobs()), or None for an empty section."""
    out = bytearray()
    out += _HEADER.pack(_MAGIC, _VERSION, int(time.time() * 1000))
    out += _U64.pack(anonymiser.flush_epoch)

    out += _U32.pack(len(batcher.store))
    for uuid, batch in batcher.store.items():
        _pack_str(out, uuid)
        out += _BATCH_META.pack(batch.max_separation, batch.last_update,
                                batch.retries, len(batch.points))
        for p in batch.points:
            out += p.to_bytes()

    out += _U32.pack(len(batcher.pending))
    for uuid in batcher.pending:
        _pack_str(out, uuid)

    out += _U32.pack(len(anonymiser.slices))
    for name, segments in anonymiser.slices.items():
        _pack_str(out, name)
        out += _U32.pack(len(segments))
        for s in segments:
            out += s.to_bytes()

    out += _U32.pack(len(anonymiser.slice_of))
    for tile, slice_no in anonymiser.slice_of.items():
        out += tile.to_bytes()
        out += _U32.pack(slice_no)

    frames = incremental or []
    out += _U32.pack(len(frames))
    for uuid, blob in frames:
        _pack_str(out, uuid)
        out += _U32.pack(len(blob))
        out += blob
    return bytes(out)


def restore_bytes(raw: bytes, batcher: PointBatcher,
                  anonymiser: Anonymiser) -> list:
    """Populate the two stores from a snapshot; returns the carried
    incremental-state frames as [(uuid, blob)] (empty for a v2
    snapshot). Raises ValueError on a corrupt/truncated snapshot — in
    that case the stores are left UNTOUCHED (the whole snapshot is
    parsed before anything is applied), so callers can safely treat the
    failure as "no snapshot"."""
    r = _Reader(raw)
    magic, version, _ts = _HEADER.unpack(r.take(_HEADER.size))
    if magic != _MAGIC or version not in (2, _VERSION):
        raise ValueError(f"bad snapshot header {magic!r} v{version}")
    flush_epoch = r.u64()

    store = {}
    for _ in range(r.u32()):
        uuid = r.string()
        max_sep, last_update, retries, n_points = _BATCH_META.unpack(
            r.take(_BATCH_META.size))
        batch = Batch()
        batch.max_separation = max_sep
        batch.last_update = last_update
        batch.retries = retries
        for _ in range(n_points):
            batch.points.append(Point.from_bytes(r.take(Point.SIZE)))
        store[uuid] = batch

    pending = {}
    for _ in range(r.u32()):
        pending[r.string()] = None

    slices = {}
    for _ in range(r.u32()):
        name = r.string()
        slices[name] = [Segment.from_bytes(r.take(Segment.SIZE))
                        for _ in range(r.u32())]

    slice_of = {}
    for _ in range(r.u32()):
        tile = TimeQuantisedTile.from_bytes(r.take(TimeQuantisedTile.SIZE))
        slice_of[tile] = r.u32()

    frames = []
    if version >= 3:
        for _ in range(r.u32()):
            uuid = r.string()
            frames.append((uuid, r.take(r.u32())))

    # parse succeeded in full — apply atomically
    batcher.store.update(store)
    batcher.pending.update(pending)
    anonymiser.slices.update(slices)
    anonymiser.slice_of.update(slice_of)
    anonymiser.flush_epoch = flush_epoch
    return frames


class StateStore:
    """Owns the snapshot file; periodic save + startup restore.

    ``interval_s`` bounds the replay window after a crash: at most that
    many seconds of stream go unsnapshotted (the reference loses
    *everything* open on crash instead). ``every`` > 0 snapshots every
    ``every``-th :meth:`maybe_save` instead (the worker calls it once a
    processed message), so the snapshot's stream position is a pure
    function of the stream: a replay crashed right after one restores
    exactly that prefix. The port's addition; the JAX package's exact
    resume needs ``interval_s`` 0, a snapshot of the whole state per
    message.
    """

    def __init__(self, path: str, interval_s: float = 30.0,
                 clock=time.time, incremental=None, every: int = 0):
        self.path = path
        self.interval_s = interval_s
        self.every = int(every)
        self._calls = 0
        self.clock = clock
        self._last_save = clock()
        # zero-arg callable -> matcher.incremental.IncrementalTable (or
        # None): every save tees the carried decode state into the
        # snapshot and restore hands the frames back, so a crash-restored
        # worker resumes mid-stream incremental decode (snapshot v3)
        self.incremental = incremental
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)

    # -- committed-epoch marker --------------------------------------------
    @property
    def epoch_path(self) -> str:
        return self.path + ".epoch"

    def commit_epoch(self, epoch: int) -> None:
        """Durably record that ``epoch``'s tiles fully reached the sink.
        Called between egress and the post-flush snapshot — it is what
        lets restore tell "flushed then crashed" from "crashed mid-way"."""
        fsio.atomic_write_text(self.epoch_path, str(int(epoch)))

    def committed_epoch(self) -> int:
        """The last epoch known to have fully egressed; -1 when none."""
        try:
            with open(self.epoch_path, encoding="utf-8") as f:
                return int(f.read().strip())
        except (FileNotFoundError, ValueError):
            return -1

    # -- snapshot ----------------------------------------------------------
    def restore(self, batcher: PointBatcher,
                anonymiser: Anonymiser) -> bool:
        """Load state if a snapshot exists; False when starting fresh.

        When the committed-epoch marker says the snapshot's next flush
        epoch already reached the sink (the crash landed between egress
        and snapshot), the restored tile slices are SKIPPED instead of
        queued for a duplicate emission."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            self._seed_epoch(anonymiser)
            return False
        try:
            frames = restore_bytes(raw, batcher, anonymiser)
        except ValueError as e:
            logger.error("Discarding corrupt state snapshot %s: %s",
                         self.path, e)
            self._seed_epoch(anonymiser)
            return False
        if frames:
            table = self.incremental() if self.incremental else None
            if table is not None:
                n = table.restore_blobs(frames)
                logger.info("Restored %d/%d carried incremental decode "
                            "states", n, len(frames))
        committed = self.committed_epoch()
        if committed >= anonymiser.flush_epoch:
            dropped = len(anonymiser.slices)
            anonymiser.slices.clear()
            anonymiser.slice_of.clear()
            anonymiser.flush_epoch = committed + 1
            metrics.count("state.epoch_skipped")
            logger.warning(
                "Snapshot pre-dates committed flush epoch %d: skipping "
                "%d already-egressed tile slices (crash landed between "
                "egress and snapshot)", committed, dropped)
        logger.info("Restored state: %d open batches, %d tile slices, "
                    "flush epoch %d", len(batcher.store),
                    len(anonymiser.slices), anonymiser.flush_epoch)
        return True

    def _seed_epoch(self, anonymiser: Anonymiser) -> None:
        """Fresh-start epoch seeding: even with no usable snapshot, a
        surviving ``.epoch`` marker means epoch-named tiles up to that
        number are already committed at the sink — restarting the
        counter at 0 would deterministically OVERWRITE them with
        different data (the hazard the removed uuid4 names could never
        hit). Resume numbering past the marker instead."""
        committed = self.committed_epoch()
        if committed >= anonymiser.flush_epoch:
            anonymiser.flush_epoch = committed + 1
            logger.warning(
                "No usable snapshot but flush epochs up to %d are "
                "committed; resuming tile numbering at epoch %d",
                committed, committed + 1)

    def save(self, batcher: PointBatcher, anonymiser: Anonymiser) -> None:
        faults.failpoint("state.save")
        table = self.incremental() if self.incremental else None
        frames = table.to_blobs() if table is not None else None
        # tmp + fsync + replace + dir fsync via fsio: os.replace
        # promises atomicity, not durability — after a power loss an
        # un-fsynced rename can legally surface as an EMPTY new name
        fsio.atomic_write_bytes(self.path,
                                snapshot_bytes(batcher, anonymiser,
                                               incremental=frames))
        faults.failpoint("state.save", after=True)
        self._last_save = self.clock()

    def maybe_save(self, batcher: PointBatcher,
                   anonymiser: Anonymiser) -> bool:
        if self.every > 0:
            self._calls += 1
            if self._calls % self.every:
                return False
        elif self.clock() - self._last_save < self.interval_s:
            return False
        self.save(batcher, anonymiser)
        return True
