"""Append-only columnar histogram store, partitioned by graph tile.

Layout on disk (one partition per ``(level, tile_index)`` — the same key
the anonymiser's flush paths and the OSMLR id low bits use)::

    <root>/<level>/<tile_index>/
        MANIFEST.json            {"seq": N, "segments": ["base-…", "delta-…"]}
        delta-000001/            one committed aggregation increment
            hist_key.npy         sorted int64 composite keys (schema.py)
            hist_count.npy       int64
            hist_speed_sum.npy   float64
            trans_from.npy       int64 (sorted pairs)
            trans_to.npy         int64
            trans_count.npy      int64
            meta.json
        base-000007/             compaction output (same columns)

Commit protocol (single-writer per process, lock-held; crash-safe):
arrays are written into a dot-prefixed temp dir in the partition, then
``os.replace``'d to the final segment name, then the manifest is
rewritten via temp-file + ``os.replace``. A reader loads the manifest
and mmaps only segments it lists, so a half-written segment is never
visible and a crashed commit leaves only an ignorable temp dir.

Reads are ``np.load(..., mmap_mode="r")`` — a query touches the pages of
one binary-searched key range per segment file, not the whole partition.
Compaction merges every live segment into a single ``base-`` segment and
then deletes the merged dirs; concurrent readers holding the old
manifest keep valid mmaps (POSIX unlink semantics).
"""
from __future__ import annotations

import itertools
import json
import logging
import os
import shutil
import time
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils import faults, fsio, metrics
from ..utils import locks as _locks
from .aggregate import Delta, aggregate, merge_deltas
from .lease import DEFAULT_TTL_S, StoreLease
from .schema import ObservationBatch

logger = logging.getLogger("reporter_tpu_torch.datastore")

MANIFEST = "MANIFEST.json"

#: per-process stage-dir sequence: itertools.count() is atomic under
#: the GIL, so concurrent unlocked stagers in one process never collide
#: (cross-process collisions are excluded by the pid in the name)
_STAGE_IDS = itertools.count()


#: the JAX package's defaults of REPORTER_TPU_DATASTORE_HANDLES and
#: REPORTER_TPU_INGEST_LEDGER_MAX: partition handles kept open, and keys
#: a partition's ``ingested`` ledger keeps (0 = unbounded)
DEFAULT_HANDLES = 64
DEFAULT_LEDGER_MAX = 4096

_COLUMNS = (
    ("hist_key", np.int64),
    ("hist_count", np.int64),
    ("hist_speed_sum", np.float64),
    ("trans_from", np.int64),
    ("trans_to", np.int64),
    ("trans_count", np.int64),
)


def pressure_exceeded(n_deltas: int, delta_bytes: int,
                      max_deltas: Optional[int],
                      max_delta_bytes: Optional[int]) -> bool:
    """THE compaction-pressure predicate — one definition shared by
    the store's automatic policy and the background compactor's
    backlog gauge, so the gauge can never report pressure the policy
    would not compact (or vice versa)."""
    return ((max_deltas is not None and n_deltas > max_deltas)
            or (max_delta_bytes is not None
                and delta_bytes > max_delta_bytes))


class HistogramStore:
    """The local datastore: ingest observation batches, serve mmap'd
    deltas to the query layer, compact partitions in place.

    Reads go through a bounded partition-handle LRU: one /histogram
    request used to re-``np.load``/mmap every segment file of the
    partition. Handles are keyed by
    the manifest's segment list, so any committed append or compaction
    invalidates naturally on the next read — the manifest itself is
    still read per request (a tiny JSON open; it IS the invalidation
    signal), only the mmap opens are amortised. Hit/miss counts surface
    as ``datastore.query.cache.*`` on /stats.
    """

    def __init__(self, root: str, handle_cache_size: int = DEFAULT_HANDLES,
                 ledger_max: int = DEFAULT_LEDGER_MAX,
                 lease_ttl_s: float = DEFAULT_TTL_S):
        self.root = root
        os.makedirs(root, exist_ok=True)
        # long_hold_ok: the fsync-heavy segment STAGING runs unlocked
        # (see append()), but the
        # residual critical section is the commit protocol itself:
        # manifest read -> rename+dir-fsync -> atomic manifest write.
        # Those fsyncs are the durability barrier and are irreducibly
        # disk-bound (hundreds of ms on a loaded box), and serialising
        # commits per store is the design — the same documented-long-
        # holder class as the native once-only build lock.
        self._lock = _locks.new_lock("datastore.store", long_hold_ok=True)
        self.handle_cache_size = max(0, int(handle_cache_size))
        self.ledger_max = int(ledger_max)
        self._handle_lock = _locks.new_lock("datastore.handles")
        # (pdir, (segment names...)) -> [Delta] of live mmap handles
        self._handles: "OrderedDict[tuple, List[Delta]]" = OrderedDict()
        # (pdir, (segment names...)) -> int64 resident segment ids —
        # the bbox query's enumeration, cached under the same
        # manifest-content key (and bound) as the handles: recomputing
        # it per request would rescan every live file's whole key
        # column at dashboard QPS
        self._resident_ids: "OrderedDict[tuple, np.ndarray]" = \
            OrderedDict()
        # cross-process writer lease (lease.py): every mutating entry
        # point below must hold it — prefork slots, the drainer and the
        # worker tee can all point at this root at once, and the
        # in-process _lock above cannot see the other processes
        self.lease = StoreLease(root, ttl_s=lease_ttl_s)
        # optional freshness tier (freshness.py, attached via
        # LocalDatastore.enable_freshness): ingest() records every
        # per-partition delta here so window=/feed surfaces see a
        # flush the instant it lands, whatever producer drove it
        self.freshness = None
        # active graph epoch (graph/version.py): owners serving a
        # versioned graph set this (``make_service`` stamps the graph it
        # serves); when set, commits stamp it into the manifest +
        # per-segment epoch map and the ingest-ledger key so histograms
        # can never silently mix observations from two map builds.
        # None (the default, every pre-versioning producer) keeps the
        # layout and ledger keys byte-identical to before
        self.map_version: Optional[str] = None

    def set_map_version(self, version: Optional[str]) -> None:
        self.map_version = str(version) if version else None

    def _epoch_key(self, ingest_key: Optional[str]) -> Optional[str]:
        """The effective exactly-once ledger key: the flush identity,
        epoch-qualified when this store serves a versioned graph. The
        same tile re-offered under a NEW map build is new data (its
        segments were matched against different geometry), so it must
        not dedupe against the old epoch's commit."""
        if ingest_key is None or self.map_version is None:
            return ingest_key
        suffix = f"@{self.map_version}"
        # idempotent: ingest() qualifies before the freshness hook and
        # append() qualifies again — both must agree on one spelling
        return ingest_key if ingest_key.endswith(suffix) \
            else ingest_key + suffix

    # -- paths -------------------------------------------------------------
    def partition_dir(self, level: int, index: int) -> str:
        return os.path.join(self.root, str(int(level)), str(int(index)))

    def partitions(self) -> Iterator[Tuple[int, int]]:
        """All (level, tile_index) partitions present on disk."""
        try:
            levels = sorted(d for d in os.listdir(self.root)
                            if d.isdigit())
        except FileNotFoundError:
            return
        for lvl in levels:
            ldir = os.path.join(self.root, lvl)
            for idx in sorted(d for d in os.listdir(ldir) if d.isdigit()):
                if os.path.exists(os.path.join(ldir, idx, MANIFEST)):
                    yield int(lvl), int(idx)

    # -- manifest ----------------------------------------------------------
    def _read_manifest(self, pdir: str) -> dict:
        try:
            with open(os.path.join(pdir, MANIFEST), encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return {"seq": 0, "segments": []}

    def _write_manifest(self, pdir: str, manifest: dict) -> None:
        # the manifest IS the commit point: tmp + fsync + replace + dir
        # fsync (fsio), so a power loss can neither tear it nor lose
        # the rename
        fsio.atomic_write_text(os.path.join(pdir, MANIFEST),
                               json.dumps(manifest))

    # -- write path --------------------------------------------------------
    def append(self, level: int, index: int, delta: Delta,
               ingest_key: Optional[str] = None) -> Optional[str]:
        """Commit one delta as a new immutable segment; returns its name.

        ``ingest_key`` is the exactly-once idempotency key:
        the flush-file identity ``{t0}_{t1}/{level}/{tile}/{source}
        [.writer].e{epoch}`` every producer path derives the same way —
        the worker tee from its flush epoch, directory replays from the
        tile file's relpath. The partition manifest carries an
        ``ingested`` ledger of keys it has committed; a key already in
        the ledger makes this append a counted no-op (returns None), so
        a crash-replayed tee flush or an interrupted ``ingest --delete``
        re-run leaves the store BYTE-IDENTICAL instead of double
        counting. Ledger entry and segment commit share the one atomic
        manifest write, so there is no window where one is durable
        without the other.

        The ledger is bounded: a long-lived tee adds one key per flush
        per touched partition forever, and the whole manifest is
        re-serialised on every append, so an unbounded ledger turns
        into O(n^2) cumulative manifest I/O. Beyond
        ``ledger_max`` keys (insertion-ordered;
        oldest evicted first, ``datastore.ingest.ledger_evicted``) the
        dedupe window slides: the newest N flushes per partition stay
        idempotent — replays older than that must rely on ``ingest
        --delete`` having removed their files."""
        # failure domain: a failed commit surfaces to the caller (the
        # worker tee logs-and-continues; `datastore ingest` quarantines
        # the tile) and the crash-safe protocol below leaves only an
        # ignorable temp dir behind
        faults.failpoint("datastore.commit")
        # cross-process gate FIRST: a non-holder must refuse before any
        # staging I/O — the tee catches LeaseHeldElsewhere and spools
        # the tile body for replay, it never risks a manifest commit
        # interleaved with the live holder's
        self.lease.require()
        # epoch-qualify the ledger key up front so every use below —
        # pre-check, authoritative re-check, ledger insert — sees one
        # spelling (a None map_version leaves the key untouched)
        ingest_key = self._epoch_key(ingest_key)
        with metrics.timer("datastore.store.append"):
            pdir = self.partition_dir(level, index)
            os.makedirs(pdir, exist_ok=True)
            # unlocked dedupe pre-check: a replayed flush (the dead-
            # letter drainer's common case) must not pay a whole
            # segment's staging I/O just to be thrown away — the
            # authoritative re-check under the lock below still owns
            # correctness against a racing first ingest
            if ingest_key is not None \
                    and ingest_key in self._read_manifest(pdir).get(
                        "ingested", {}):
                metrics.count("datastore.ingest.deduped")
                logger.info("dedupe: %s already ingested into %d/%d; "
                            "skipping", ingest_key, level, index)
                return None
            # stage the fsync-heavy column writes OUTSIDE the store
            # lock (the runtime witness flagged the old lock-held
            # protocol as RC002: whole-segment disk I/O under the lock
            # stalled every concurrent append/compaction); the lock
            # covers only manifest read -> rename -> manifest commit
            tmp = self._stage_segment(pdir, delta)
            with self._lock:
                manifest = self._read_manifest(pdir)
                if ingest_key is not None \
                        and ingest_key in manifest.get("ingested", {}):
                    metrics.count("datastore.ingest.deduped")
                    logger.info("dedupe: %s already ingested into %d/%d "
                                "(segment %s); skipping", ingest_key,
                                level, index,
                                manifest["ingested"][ingest_key])
                    shutil.rmtree(tmp, ignore_errors=True)
                    return None
                seq = manifest["seq"] + 1
                name = f"delta-{seq:06d}"
                self._commit_segment(pdir, tmp, name)
                self._check_seq_fence(pdir, seq - 1)
                manifest["seq"] = seq
                manifest["segments"] = manifest["segments"] + [name]
                if self.map_version is not None:
                    # epoch stamp: the manifest's map_version is the
                    # active epoch, ``epochs`` tags each segment with
                    # the build that produced it — queries pin on it
                    # (EpochView) and compaction never merges across it
                    manifest["map_version"] = self.map_version
                    epochs = dict(manifest.get("epochs", {}))
                    epochs[name] = self.map_version
                    manifest["epochs"] = epochs
                    metrics.count("datastore.epoch.stamped_segments")
                if ingest_key is not None:
                    ingested = dict(manifest.get("ingested", {}))
                    ingested[ingest_key] = name
                    cap = self.ledger_max
                    if cap and len(ingested) > cap:
                        evicted = len(ingested) - cap
                        for old in list(ingested)[:evicted]:
                            del ingested[old]
                        metrics.count("datastore.ingest.ledger_evicted",
                                      evicted)
                    manifest["ingested"] = ingested
                self._write_manifest(pdir, manifest)
                return name

    def _stage_segment(self, pdir: str, delta: Delta) -> str:
        """Write one segment's columns into a dot-prefixed temp dir,
        every file fsync'd — run UNLOCKED (this is the long disk I/O).
        The temp name is pid- and counter-qualified so concurrent
        stagers never collide; a crash leaves only this ignorable dir."""
        tmp = os.path.join(
            pdir, f".tmp-{os.getpid()}-{next(_STAGE_IDS)}")
        os.makedirs(tmp)
        for col, dtype in _COLUMNS:
            col_path = os.path.join(tmp, col + ".npy")
            np.save(col_path,
                    np.ascontiguousarray(getattr(delta, col), dtype=dtype))
            fsio.fsync_path(col_path)
        tmp_meta = os.path.join(tmp, "meta.json")
        with open(tmp_meta, "w", encoding="utf-8") as f:
            json.dump({"cells": len(delta), "rows": delta.rows,
                       "transitions": int(delta.trans_from.shape[0]),
                       "created": time.time()}, f)
            f.flush()
            os.fsync(f.fileno())
        fsio.fsync_dir(tmp)
        return tmp

    def _commit_segment(self, pdir: str, tmp: str, name: str) -> None:
        """Rename a staged temp dir to its final segment name — run
        under the store lock, right before the manifest write that
        makes it visible. Rename durability: every column is fsync'd at stage time, the
        segment dir's entries are fsync'd, THEN the rename, THEN the
        partition dir — a power loss right after the manifest lists
        this segment cannot surface empty columns. The content fsyncs
        live in _stage_segment (the split exists so the fsync-heavy
        staging runs unlocked).

        A pre-existing dir at the target name is a crashed commit's
        orphan, never live data, PROVIDED we verifiably hold the lease
        at this instant: committed names are seq-monotonic (every
        commit uses manifest seq + 1 under the lease + lock), so a
        manifest can only list names at or below its seq — the name
        being committed now is above it. A holder SIGKILLed between
        rename and manifest write leaves exactly
        this orphan, and the next holder's commit at the same seq must
        replace it, not ENOTEMPTY. The proviso is re-checked HERE, at
        the last moment before the destructive steps: a holder that
        stalled past its TTL inside the staged merge (GC/NFS/swap) may
        have been stolen from — its deadline lapsed, so require() hits
        the slow path, sees the live new holder, and fails LOUDLY
        (LeaseHeldElsewhere) instead of clearing that holder's
        committed segment and overwriting its manifest from a stale
        read."""
        self.lease.require()
        dest = os.path.join(pdir, name)
        if os.path.exists(dest):
            if not self.lease.enabled():
                # lease off = the proviso cannot be verified: an
                # existing dest may be ANOTHER process's live commit,
                # so keep the loud ENOTEMPTY below over any clearing
                logger.error("commit target %s already exists and the "
                             "writer lease is disabled — cannot prove "
                             "it is an orphan", dest)
            else:
                # NON-DESTRUCTIVE clearing: rename the orphan aside
                # (dot-prefixed, manifest-invisible) instead of rmtree.
                # Even in the worst post-require stall — our lease
                # lapses RIGHT HERE and the dest is actually the new
                # holder's live commit — its bytes survive for
                # recovery, and the seq fence at manifest-write time
                # (append/_compact_partition) aborts our stale commit
                # before it can tear the manifest.
                aside = os.path.join(
                    pdir, f".orphan-{os.getpid()}-{next(_STAGE_IDS)}")
                logger.warning("moving crashed-commit orphan %s aside "
                               "to %s", dest, os.path.basename(aside))
                os.replace(dest, aside)
        # every column and the segment dir were fsync'd at stage time
        # (_stage_segment, unlocked): this is the rename alone
        os.replace(tmp, dest)  # lint: ignore[DUR002]
        fsio.fsync_dir(pdir)

    def _check_seq_fence(self, pdir: str, expected_seq: int) -> None:
        """Optimistic fence re-read RIGHT BEFORE a manifest write: the
        manifest's seq must still be what this commit was computed
        from. Within one process the store lock guarantees it; across
        processes only a holder that stalled past its TTL and was
        stolen from can trip it — that stale holder must abort LOUDLY
        (its renamed segment stays behind as an ignorable orphan)
        rather than overwrite the new live holder's manifest from a
        stale read."""
        current = self._read_manifest(pdir)["seq"]
        if current != expected_seq:
            metrics.count("datastore.store.stale_commits")
            raise RuntimeError(
                f"stale commit on {pdir}: manifest seq moved "
                f"{expected_seq} -> {current} underneath this writer "
                "(lease lapsed mid-commit?); aborting before the "
                "manifest tears — the staged segment is left as an "
                "orphan")

    def ingest(self, obs: ObservationBatch,
               max_deltas: Optional[int] = None,
               max_delta_bytes: Optional[int] = None,
               ingest_key: Optional[str] = None) -> int:
        """Aggregate + append a whole observation batch (possibly spanning
        partitions). Returns the number of valid rows ingested — rows a
        partition's ledger deduped (``ingest_key`` already committed
        there) are not counted. With compaction thresholds set, each
        partition THIS batch touched is pressure-checked right after its
        append — O(touched partitions), not a store-wide sweep (the
        worker tee runs this on every flush)."""
        rows = 0
        # the freshness hook records EVERY partition delta this batch
        # carries — committed, deduped (the overlay dedupes on the same
        # key, so it no-ops there too) or failed (in_store=False: the
        # tile is being spooled, and window=∞ must serve those rows
        # from the overlay until the dead-letter replay lands)
        fresh = self.freshness
        # the overlay dedupes (and uncommitted_deltas re-checks the
        # ledger) on the SAME epoch-qualified key append commits under
        ekey = self._epoch_key(ingest_key)
        for (level, index), delta in aggregate(obs).items():
            try:
                name = self.append(level, index, delta,
                                   ingest_key=ingest_key)
            except Exception:
                if fresh is not None:
                    fresh.record(level, index, delta, ekey,
                                 in_store=False,
                                 map_version=self.map_version)
                raise
            if fresh is not None:
                fresh.record(level, index, delta, ekey,
                             in_store=True,
                             map_version=self.map_version)
            if name is None:
                continue
            rows += delta.rows
            if max_deltas is not None or max_delta_bytes is not None:
                self._maybe_compact_partition(level, index, max_deltas,
                                              max_delta_bytes)
        return rows

    # -- read path ---------------------------------------------------------
    def load_segment(self, pdir: str, name: str) -> Optional[Delta]:
        """mmap one committed segment's columns; None if it was compacted
        away between manifest read and open."""
        sdir = os.path.join(pdir, name)
        try:
            cols = {col: np.load(os.path.join(sdir, col + ".npy"),
                                 mmap_mode="r")
                    for col, _ in _COLUMNS}
        except FileNotFoundError:
            return None
        return Delta(**cols)

    def live_segments(self, level: int, index: int) -> List[Delta]:
        """Every committed delta of one partition, mmap'd (may be empty).

        Handles come from the partition LRU when the manifest's segment
        list is unchanged; a changed manifest (append/compaction) keys
        differently and the stale entry ages out of the bound."""
        pdir = self.partition_dir(level, index)
        manifest = self._read_manifest(pdir)
        key = (pdir, tuple(manifest["segments"]))
        if self.handle_cache_size:
            with self._handle_lock:
                got = self._handles.get(key)
                if got is not None:
                    self._handles.move_to_end(key)
                    metrics.count("datastore.query.cache.hits")
                    return list(got)
            # only a live cache counts misses: a disabled cache emitting
            # a permanent 0% hit ratio reads as misconfiguration
            metrics.count("datastore.query.cache.misses")
        out = []
        for name in manifest["segments"]:
            d = self.load_segment(pdir, name)
            if d is not None:
                out.append(d)
        if self.handle_cache_size:
            with self._handle_lock:
                # drop any stale handle list of this partition (older
                # manifest) before inserting the fresh one
                for stale in [k for k in self._handles if k[0] == pdir
                              and k != key]:
                    del self._handles[stale]
                self._handles[key] = list(out)
                self._handles.move_to_end(key)
                while len(self._handles) > self.handle_cache_size:
                    self._handles.popitem(last=False)
        return out

    def resident_segments(self, level: int, index: int) -> np.ndarray:
        """Distinct segment ids with histogram cells in one partition,
        cached keyed by the manifest's segment list (append/compaction
        re-key it, exactly like the handle LRU — the manifest read IS
        the invalidation signal)."""
        pdir = self.partition_dir(level, index)
        manifest = self._read_manifest(pdir)
        key = (pdir, tuple(manifest["segments"]))
        if self.handle_cache_size:
            with self._handle_lock:
                got = self._resident_ids.get(key)
                if got is not None:
                    self._resident_ids.move_to_end(key)
                    return got
        from .schema import CELLS_PER_SEGMENT
        segs = [np.unique(np.asarray(part.hist_key) // CELLS_PER_SEGMENT)
                for part in self.live_segments(level, index)]
        ids = np.unique(np.concatenate(segs)) if segs \
            else np.zeros(0, dtype=np.int64)
        if self.handle_cache_size:
            with self._handle_lock:
                for stale in [k for k in self._resident_ids
                              if k[0] == pdir and k != key]:
                    del self._resident_ids[stale]
                self._resident_ids[key] = ids
                self._resident_ids.move_to_end(key)
                while len(self._resident_ids) > self.handle_cache_size:
                    self._resident_ids.popitem(last=False)
        return ids

    # -- compaction --------------------------------------------------------
    def _delta_pressure(self, pdir: str, names: List[str]) -> Tuple[int, int]:
        """(count, bytes) of uncompacted ``delta-`` segments — the inputs
        to the automatic compaction policy (a ``base-`` segment is
        already compacted and exerts no pressure)."""
        n = 0
        total = 0
        for name in names:
            if not name.startswith("delta-"):
                continue
            n += 1
            sdir = os.path.join(pdir, name)
            try:
                total += sum(os.path.getsize(os.path.join(sdir, f))
                             for f in os.listdir(sdir))
            except FileNotFoundError:
                continue
        return n, total

    def compact(self, level: Optional[int] = None,
                index: Optional[int] = None,
                max_deltas: Optional[int] = None,
                max_delta_bytes: Optional[int] = None) -> dict:
        """Merge each selected partition's segments into one ``base-``
        segment. With ``max_deltas`` / ``max_delta_bytes`` set this is
        the *automatic policy*: only partitions whose uncompacted delta
        count or byte total exceeds a threshold are compacted (the
        worker's datastore tee and the CLI pass these, so steady-state
        operation needs no manual compaction pass). Returns
        ``{"partitions", "merged_segments", "skipped"}``."""
        merged = parts = skipped = 0
        # fail fast before the partition walk; _compact_partition
        # re-checks per partition (the lease can be stolen mid-sweep)
        self.lease.require()
        thresholds = max_deltas is not None or max_delta_bytes is not None
        with metrics.timer("datastore.store.compact"):
            for lvl, idx in list(self.partitions()):
                if level is not None and lvl != level:
                    continue
                if index is not None and idx != index:
                    continue
                if thresholds:
                    got = self._maybe_compact_partition(
                        lvl, idx, max_deltas, max_delta_bytes)
                    if got is None:
                        skipped += 1
                    else:
                        merged += got
                        parts += 1
                    continue
                merged += self._compact_partition(lvl, idx)
                parts += 1
        return {"partitions": parts, "merged_segments": merged,
                "skipped": skipped}

    def _maybe_compact_partition(self, level: int, index: int,
                                 max_deltas: Optional[int],
                                 max_delta_bytes: Optional[int]
                                 ) -> Optional[int]:
        """Compact ONE partition iff its uncompacted-delta pressure
        crosses a threshold; None when below pressure (skipped)."""
        pdir = self.partition_dir(level, index)
        names = self._read_manifest(pdir)["segments"]
        n, nbytes = self._delta_pressure(pdir, names)
        if not pressure_exceeded(n, nbytes, max_deltas, max_delta_bytes):
            return None
        metrics.count("datastore.store.auto_compactions")
        return self._compact_partition(level, index)

    def _compact_partition(self, level: int, index: int) -> int:
        # same cross-process gate as append: the torn-manifest scenario
        # the lease exists for IS two compactions interleaving their
        # seq bumps
        self.lease.require()
        with self._lock:
            pdir = self.partition_dir(level, index)
            manifest = self._read_manifest(pdir)
            names = manifest["segments"]
            if len(names) <= 1:
                return 0
            # compaction is epoch-aware: segments group by the map
            # build that produced them (untagged legacy segments form
            # their own group) and each group merges into its OWN base
            # — merging across epochs would manufacture exactly the
            # mixed-version histogram cells the epoch stamps exist to
            # prevent. The common single-epoch partition still ends in
            # one base, byte-identical to the pre-epoch behaviour.
            tags = manifest.get("epochs", {})
            groups: "OrderedDict[Optional[str], List[str]]" = OrderedDict()
            for n in names:
                groups.setdefault(tags.get(n), []).append(n)
            seq0 = manifest["seq"]
            bumps = 0
            new_segments: List[str] = []
            new_epochs: Dict[str, str] = {}
            for tag, group in groups.items():
                deltas = [d for d
                          in (self.load_segment(pdir, n) for n in group)
                          if d is not None]
                bumps += 1
                base = f"base-{seq0 + bumps:06d}"
                # staged under the lock, unlike append: the merge input
                # is the live segment list, which must not move
                # underneath it
                tmp = self._stage_segment(pdir, merge_deltas(deltas))
                self._commit_segment(pdir, tmp, base)
                new_segments.append(base)
                if tag is not None:
                    new_epochs[base] = tag
            # failpoint: a crash HERE dies HOLDING the
            # lease mid-compaction, in the widest window — the merged
            # base- dir is renamed in place but the manifest still
            # lists the old segments. Readers stay manifest-driven (the
            # orphan dir is invisible), and the next process must steal
            # the dead holder's lease and re-compact to an untorn state
            faults.failpoint("datastore.compact")
            self._check_seq_fence(pdir, seq0)
            # the ingested ledger survives compaction: the merged base
            # still CONTAINS those flushes, so dropping their keys would
            # re-open the double-ingest window the ledger closes
            compacted = {"seq": seq0 + bumps, "segments": new_segments}
            if new_epochs:
                compacted["epochs"] = new_epochs
            if manifest.get("map_version"):
                compacted["map_version"] = manifest["map_version"]
            if manifest.get("ingested"):
                compacted["ingested"] = manifest["ingested"]
            self._write_manifest(pdir, compacted)
            # the new manifest is durable; merged segment dirs are dead
            for name in names:
                shutil.rmtree(os.path.join(pdir, name), ignore_errors=True)
            # garbage-collect aside-renamed orphans while we verifiably
            # hold the lease: they are manifest-invisible, so this is
            # pure disk hygiene. (.tmp- stage dirs are NOT touched — a
            # concurrent append in THIS process stages unlocked, so an
            # in-flight .tmp- dir may be live)
            for leftover in os.listdir(pdir):
                if leftover.startswith(".orphan-"):
                    shutil.rmtree(os.path.join(pdir, leftover),
                                  ignore_errors=True)
            logger.info("compacted %d/%d: %d segments -> %s",
                        level, index, len(names),
                        ",".join(new_segments))
            return len(names)

    # -- introspection -----------------------------------------------------
    def merged_cells(self) -> Dict[tuple, tuple]:
        """``{(level, index, hist_key): (count, speed_sum)}`` merged
        across every committed segment (speed sums rounded to 1e-6) —
        the layout-independent comparand of the exactly-once checks: two stores that compacted at
        different points differ byte-wise but must carry identical
        cells. ONE definition, so the harnesses cannot drift apart."""
        out: Dict[tuple, tuple] = {}
        for level, index in self.partitions():
            parts = self.live_segments(level, index)
            if not parts:
                continue
            merged = merge_deltas(parts)
            keys = np.asarray(merged.hist_key)
            counts = np.asarray(merged.hist_count)
            sums = np.asarray(merged.hist_speed_sum)
            for k, c, s in zip(keys.tolist(), counts.tolist(),
                               sums.tolist()):
                out[(level, index, k)] = (c, round(s, 6))
        return out

    def stats(self) -> dict:
        """Partition/segment/cell totals plus on-disk byte size."""
        out: Dict[str, int] = {"partitions": 0, "segments": 0, "cells": 0,
                               "rows": 0, "transitions": 0, "bytes": 0}
        for level, index in self.partitions():
            out["partitions"] += 1
            pdir = self.partition_dir(level, index)
            for name in self._read_manifest(pdir)["segments"]:
                sdir = os.path.join(pdir, name)
                try:
                    with open(os.path.join(sdir, "meta.json"),
                              encoding="utf-8") as f:
                        meta = json.load(f)
                except (FileNotFoundError, ValueError):
                    continue
                out["segments"] += 1
                out["cells"] += meta.get("cells", 0)
                out["rows"] += meta.get("rows", 0)
                out["transitions"] += meta.get("transitions", 0)
                out["bytes"] += sum(
                    os.path.getsize(os.path.join(sdir, f))
                    for f in os.listdir(sdir))
        return out


class EpochView:
    """Store-protocol facade pinning reads to ONE map_version.

    Satisfies the same three-method protocol the query layer sweeps
    (``partitions`` / ``live_segments`` / ``resident_segments``, like
    freshness.OverlayView), serving only segments whose manifest epoch
    tag matches the pin. Untagged segments — everything committed
    before the store carried a version — pass through, so enabling
    versioning on an existing store never hides its history. Reads are
    manifest-driven per call and bypass the handle LRU: a pinned query
    is the rare post-swap audit path, not the dashboard hot path.
    """

    def __init__(self, store: HistogramStore, map_version: str):
        self.store = store
        self.map_version = str(map_version)

    def partitions(self):
        return self.store.partitions()

    def live_segments(self, level: int, index: int) -> List[Delta]:
        pdir = self.store.partition_dir(level, index)
        manifest = self.store._read_manifest(pdir)
        tags = manifest.get("epochs", {})
        out = []
        for name in manifest["segments"]:
            tag = tags.get(name)
            if tag is not None and tag != self.map_version:
                continue
            d = self.store.load_segment(pdir, name)
            if d is not None:
                out.append(d)
        return out

    def resident_segments(self, level: int, index: int) -> np.ndarray:
        from .schema import CELLS_PER_SEGMENT
        segs = [np.unique(np.asarray(p.hist_key) // CELLS_PER_SEGMENT)
                for p in self.live_segments(level, index)]
        return np.unique(np.concatenate(segs)) if segs \
            else np.zeros(0, dtype=np.int64)


__all__ = ["HistogramStore", "EpochView", "MANIFEST"]
