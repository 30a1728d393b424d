"""Segment accumulation, privacy culling, and tile egress.

The streaming analog of the reference's AnonymisingProcessor
(reference: AnonymisingProcessor.java). Semantics preserved:

- each segment observation is appended to every (time bucket, graph tile)
  slice it touches (AnonymisingProcessor.java:120-153), slices capped at
  20,000 segments (the reference's Kafka ~1MB value cap, :32-45)
- on each flush interval, slices per tile are gathered, sorted by
  (id, next_id), and runs of identical pairs shorter than the privacy
  threshold are removed (:155-175, :223-266)
- surviving tiles are written as CSV with the reference's column layout to
  S3 / HTTP POST / local files, under
  ``{t0}_{t1}/{level}/{tile_index}/{source}.{uuid4}`` (:177-220)

S3 egress uses boto3 when available, else the hand-signed PUT with the
sink's ``credentials``, falling back to an error log and the spool,
mirroring the reference's swallow-and-log egress failures
(HttpClient.java:95-98).

The port of ``reporter_tpu/streaming/anonymiser.py``. The JAX package's
``REPORTER_TPU_WRITER_ID`` is the ``writer_id`` argument, and its S3
credentials from ``AWS_ACCESS_KEY_ID``/``AWS_SECRET_ACCESS_KEY`` are
``TileSink(credentials=(key, secret))``: the port reads no environment.
"""
from __future__ import annotations

import logging
import os
import tempfile
from typing import Dict, List, Optional, Tuple

from ..core.types import Segment, TimeQuantisedTile
from ..obs import flightrec
from ..obs import trace as obs_trace
from ..utils import faults, fsio, spool
from ..utils import http as http_egress
from ..utils import locks as _locks
from ..utils import metrics

logger = logging.getLogger("reporter_tpu_torch.streaming")

SLICE_SIZE = 20000  # reference: AnonymisingProcessor.java:45


def privacy_cull(segments: List[Segment], privacy: int) -> List[Segment]:
    """Drop runs of identical (id, next_id) pairs shorter than ``privacy``.

    Input must be sorted by (id, next_id)
    (reference: AnonymisingProcessor.java:155-175).
    """
    out: List[Segment] = []
    i = 0
    n = len(segments)
    while i < n:
        j = i
        while j < n and segments[j].sort_key() == segments[i].sort_key():
            j += 1
        if j - i >= privacy:
            out.extend(segments[i:j])
        i = j
    return out


class TileSink:
    """Where finished tiles go: file dir, http(s) endpoint, or s3 bucket
    (reference: AnonymisingProcessor.java:85-101,177-220).

    The reference swallows-and-logs egress failures (HttpClient.java:95-98)
    — a flaky endpoint silently loses tiles. Here every outcome is counted
    (``egress.ok`` / ``egress.fail`` in ``metrics.default``) and a failed
    tile body is spooled to a dead-letter directory in the same
    ``{t0}_{t1}/{level}/{tile_index}/{file}`` layout the file sink writes,
    so the drainer (``streaming/drainer.py``) replays it through the same
    sink without loss or double counting. ``credentials`` (access key,
    secret) sign an S3 bucket PUT when boto3 is not installed.
    """

    def __init__(self, output: str, deadletter: Optional[str] = None,
                 credentials: Optional[Tuple[str, str]] = None):
        self.output = output.rstrip("/")
        self.credentials = credentials
        self.is_bucket = self.output.endswith("amazonaws.com") or \
            self.output.startswith("s3://")
        self.is_http = self.output.startswith("http://") or \
            self.output.startswith("https://")
        if self.is_bucket and not (self.is_http or
                                   self.output.startswith("s3://")):
            raise ValueError(f"Cannot PUT to {output} without a scheme")
        if not self.is_bucket and not self.is_http:
            os.makedirs(self.output, exist_ok=True)
            default_dl = os.path.join(self.output, ".deadletter")
        else:
            # remote sink: spool locally at a stable ABSOLUTE path — a
            # cwd-relative default would scatter spools across launch
            # dirs (or hit an unwritable / under a service manager)
            default_dl = os.path.join(tempfile.gettempdir(),
                                      "reporter_tpu_deadletter")
        self.deadletter = deadletter if deadletter is not None else default_dl

    def store(self, tile_name: str, file_name: str, payload: str) -> bool:
        ok = False
        try:
            # failure domain: the before-hook models a sink that never
            # got the payload (error/timeout/crash); the after-hook
            # models a committed-but-unacknowledged write (kind=partial)
            # — the duplicate-risk window the epoch-stamped file names
            # (the sink idempotency key) exist to absorb
            faults.failpoint("egress.http")
            if self.is_http:
                # signed PUT for AWS endpoints, plain POST otherwise
                # (reference: AnonymisingProcessor.java:177-220)
                ok = http_egress.egress_tile(
                    self.output, tile_name + "/" + file_name, payload,
                    credentials=self.credentials)
            elif self.is_bucket:  # s3:// form needs the SDK
                ok = self._store_s3(tile_name + "/" + file_name, payload)
            else:
                path = os.path.join(self.output, tile_name)
                os.makedirs(path, exist_ok=True)
                # atomic commit (reporter-lint DUR001): these files
                # carry deterministic epoch names — a torn write under
                # the final name after a crash would be "committed"
                # garbage the epoch marker then tells restore to skip
                fsio.atomic_write_text(os.path.join(path, file_name),
                                       payload)
                ok = True
            if ok:
                faults.failpoint("egress.http", after=True)
        except Exception as e:
            ok = False
            logger.error("Couldn't flush tile to sink %s/%s: %s",
                         tile_name, file_name, e)
        if ok:
            metrics.count("egress.ok")
            return True
        metrics.count("egress.fail")
        self.spool_tile(tile_name, file_name, payload)
        return False

    def spool_tile(self, tile_name: str, file_name: str, payload: str,
                   reason: str = "egress") -> None:
        """Spool a tile body for later replay. ``reason`` labels WHOSE
        failure this is — ``egress`` (this sink, the default) counts
        ``egress.deadletter``; the anonymiser passes ``tee`` for a
        datastore-tee failure with successful egress, counted
        ``datastore.tee.deadletter`` so an alert on the egress metric
        never rotates a healthy sink over a datastore fault."""
        try:
            # atomic spool (reporter-lint DUR001): a torn dead-letter
            # body would replay as a silently-truncated tile — ingest
            # drops malformed rows rather than failing the file. The
            # shared spool layer also enforces the byte cap (the
            # ``deadletter_max_mb`` key, oldest shed first): a dead sink
            # must not fill the disk at stream rate
            spool.write(self.deadletter, tile_name + "/" + file_name,
                        payload)
            # two literal count sites, not one conditional expression:
            # the registry-drift lint attributes literal metric names
            if reason == "egress":
                metrics.count("egress.deadletter")
            else:
                metrics.count("datastore.tee.deadletter")
            logger.warning("Spooled failed tile (%s failure) to %s/%s/%s",
                           reason, self.deadletter, tile_name, file_name)
            # a tile in the spool means a consumer is failing: leave a
            # postmortem of what led up to it, naming which one
            flightrec.dump(f"deadletter.tile.{reason}",
                           {"tile": tile_name, "file": file_name})
        except Exception as e:  # spool is best-effort: never raise
            logger.error("Dead-letter spool failed for %s/%s: %s",
                         tile_name, file_name, e)

    def _store_s3(self, key: str, payload: str) -> bool:
        try:
            import boto3  # gated: not present in all deployments
        except ImportError:
            logger.error("s3:// output configured but boto3 unavailable; "
                         "use an https bucket URL for SDK-less egress")
            return False
        bucket = self.output.replace("s3://", "").split("/")[0]
        boto3.client("s3").put_object(Bucket=bucket, Key=key,
                                      Body=payload.encode())
        return True


class Anonymiser:
    """Stateful slice store + flush loop."""

    def __init__(self, sink: TileSink, privacy: int, quantisation: int,
                 mode: str = "auto", source: str = "rtpu", tee=None,
                 writer_id: str = ""):
        if privacy < 1:
            raise ValueError("Need a privacy parameter of 1 or more")
        if quantisation < 60:
            raise ValueError("Need quantisation parameter of 60 or more")
        self.sink = sink
        self.privacy = privacy
        self.quantisation = quantisation
        self.mode = mode.upper()
        self.source = source
        # optional callable(tile, segments) fed every culled flush before
        # egress — the zero-serialisation hook a co-located datastore uses
        # (datastore.LocalDatastore.ingest_segments); a tee failure is
        # logged but never blocks tile egress. A tee accepting an
        # ``ingest_key`` kwarg additionally receives the flush identity
        # (the exactly-once ledger key ``{tile_name}/{file_name}`` —
        # identical to the tile file's relpath a directory replay would
        # derive), detected once here so legacy two-arg tees keep working
        self.tee = tee
        self._tee_wants_key = False
        if tee is not None:
            import inspect
            try:
                params = inspect.signature(tee).parameters.values()
                self._tee_wants_key = any(
                    p.name == "ingest_key" or p.kind == p.VAR_KEYWORD
                    for p in params)
            except (TypeError, ValueError):  # builtins/partials: legacy
                pass
        # monotonic flush epoch: stamped into every tile file name this
        # flush emits (the sink idempotency key) and carried in the
        # StateStore snapshot. The reference named files {source}.{uuid4}
        # (AnonymisingProcessor.java:209) — random names mean a crash
        # between egress and snapshot re-emits the same segments under a
        # NEW name (duplicate tiles); deterministic epoch names make the
        # re-emit overwrite byte-identically, and a committed-epoch
        # marker lets restore skip the epoch outright (state.py).
        self.flush_epoch = 0
        # optional writer id distinguishing concurrent workers sharing
        # one sink (multihost): without it two workers' epoch-0 files
        # for one tile would collide
        self.writer_id = writer_id
        # tile -> current slice number; "tile.slice" -> segments
        self.slice_of: Dict[TimeQuantisedTile, int] = {}
        self.slices: Dict[str, List[Segment]] = {}
        # segments kept and culled by the privacy threshold and tiles
        # written, over every flush (the worker's summary)
        self.kept = self.culled = self.tiles_written = 0

    def epoch_file_name(self, epoch: int) -> str:
        """The deterministic per-flush file name: one flush writes at
        most one file per tile dir, so source + epoch identifies it."""
        writer = f".{self.writer_id}" if self.writer_id else ""
        return f"{self.source}{writer}.e{epoch:08d}"

    # the tile map (slice_of/slices) is single-thread-owned by design:
    # the worker punctuation loop is the only writer, and the drainer
    # forwards replayed segments on that same thread. @thread_affine
    # turns a second thread slipping in (racecheck RC004) into a named
    # finding instead of a silently torn slice table.
    @_locks.thread_affine
    def process(self, key: str, segment: Segment) -> None:
        for tile in TimeQuantisedTile.tiles_for(segment, self.quantisation):
            slice_no = self.slice_of.get(tile)
            if slice_no is None:
                slice_no = 0
                self.slice_of[tile] = 0
            name = f"{tile}.{slice_no}"
            bucket = self.slices.setdefault(name, [])
            bucket.append(segment)
            if len(bucket) >= SLICE_SIZE:
                self.slice_of[tile] = slice_no + 1

    @_locks.thread_affine
    def punctuate(self) -> int:
        """Flush every tile: gather slices, sort, cull, store. Returns the
        number of tiles written. Every flush consumes one epoch (bumped
        even when nothing qualifies, so epoch numbering is a pure
        function of the punctuation sequence — deterministic replays
        stay deterministic)."""
        written = 0
        epoch = self.flush_epoch
        file_name = self.epoch_file_name(epoch)
        # the flush span carries the epoch; a tile file on disk names
        # its epoch too, so the file is traceable back to this span —
        # and through its parents to the requests that fed it
        with obs_trace.span("egress.flush", epoch=epoch):
            for tile, max_slice in list(self.slice_of.items()):
                del self.slice_of[tile]
                segments: List[Segment] = []
                for i in range(max_slice + 1):
                    name = f"{tile}.{i}"
                    part = self.slices.pop(name, None)
                    if part is not None:
                        segments.extend(part)
                    else:
                        logger.warning("Missing quantised tile slice %s",
                                       name)
                segments.sort(key=Segment.sort_key)
                before = len(segments)
                segments = privacy_cull(segments, self.privacy)
                self.kept += len(segments)
                self.culled += before - len(segments)
                logger.info(
                    "Anonymised quantised tile %s from %d to %d segments",
                    tile, before, len(segments))
                if not segments:
                    continue
                tile_name = "{}_{}/{}/{}".format(
                    tile.time_range_start,
                    tile.time_range_start + self.quantisation - 1,
                    tile.tile_level(), tile.tile_index())
                tee_ok = True
                if self.tee is not None:
                    try:
                        if self._tee_wants_key:
                            # the flush identity == the tile file's
                            # relpath: tee ingest and a later directory
                            # replay of the same flush derive the SAME
                            # ledger key, so they dedupe against each
                            # other (end-to-end exactly-once)
                            self.tee(tile, segments,
                                     ingest_key=f"{tile_name}/{file_name}")
                        else:
                            self.tee(tile, segments)
                    except Exception as e:
                        tee_ok = False
                        logger.error("datastore tee failed for tile %s: %s",
                                     tile, e)
                payload = "\n".join(
                    [Segment.column_layout()]
                    + [s.csv_row(self.mode, self.source) for s in segments])
                logger.info("Writing tile to %s/%s/%s with %d segments",
                            self.sink.output, tile_name, file_name,
                            len(segments))
                with obs_trace.span("egress.tile", epoch=epoch,
                                    tile=tile_name):
                    ok = self.sink.store(tile_name, file_name, payload)
                if ok:
                    written += 1
                    if not tee_ok and hasattr(self.sink, "spool_tile"):
                        # egress succeeded but the datastore ingest did
                        # not: without a spool entry this observation
                        # would live in the tile file and NEVER in the
                        # store (the loss path bigreplay's exactly-once
                        # parity check catches). Spool it so the drainer
                        # replays it into the datastore — the ledger key
                        # dedupes the already-egressed sink side.
                        # (reason="tee": a datastore fault must not be
                        # counted — or alerted — as a sink failure)
                        self.sink.spool_tile(tile_name, file_name,
                                             payload, reason="tee")
        # drop unreferenced slices (reference: :258-265)
        for name in list(self.slices):
            logger.warning("Deleting unreferenced quantised tile slice %s",
                           name)
            del self.slices[name]
        self.flush_epoch = epoch + 1
        self.tiles_written += written
        return written
