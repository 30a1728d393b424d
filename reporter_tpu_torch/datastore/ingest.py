"""Tile ingestion: flushed CSV tiles -> columnar observation batches.

Two entry paths:

- :func:`parse_tile_csv` reads one flushed tile payload (the anonymiser's
  CSV, ``Segment.column_layout`` header) into an
  :class:`~.schema.ObservationBatch` — one pass
  over the lines to split, then whole-column numpy conversion.
- :func:`scan_tiles` walks an anonymiser output directory (the
  ``{t0}_{t1}/{level}/{tile_index}/{source}.{uuid}`` layout, which the
  dead-letter spool mirrors) and yields tile file paths, so
  ``datastore_cli ingest`` replays a results dir and a
  ``.deadletter`` dir with the same code.

Past ``parse_tile_csv``'s line split, everything stays columnar.
"""
from __future__ import annotations

import logging
import os
from typing import Iterator, Optional

import numpy as np

from ..utils import metrics
from .lease import LeaseHeldElsewhere
from .schema import INVALID_SEGMENT_ID, ObservationBatch

logger = logging.getLogger("reporter_tpu_torch.datastore")

_HEADER_PREFIX = "segment_id,"
_N_COLUMNS = 10


def parse_tile_csv(payload: str) -> ObservationBatch:
    """Parse one tile CSV payload (header optional) into columns.

    Rows with the wrong column count are dropped (counted in
    ``datastore.ingest.bad_rows``) rather than failing the tile: a
    dead-letter replay must not wedge on one truncated flush.
    """
    with metrics.timer("datastore.ingest.parse"):
        lines = payload.strip("\n").split("\n")
        if lines and lines[0].startswith(_HEADER_PREFIX):
            lines = lines[1:]
        cells = [ln.split(",") for ln in lines if ln]
        bad = sum(1 for row in cells if len(row) != _N_COLUMNS)
        if bad:
            metrics.count("datastore.ingest.bad_rows", bad)
            cells = [row for row in cells if len(row) == _N_COLUMNS]
        if not cells:
            return ObservationBatch.empty()
        cols = list(zip(*cells))
        nxt = np.array(cols[1], dtype=object)
        nxt[nxt == ""] = INVALID_SEGMENT_ID
        return ObservationBatch(
            segment_id=np.array(cols[0], dtype=np.int64),
            next_id=nxt.astype(np.int64),
            duration_s=np.array(cols[2], dtype=np.float64),
            count=np.array(cols[3], dtype=np.int64),
            length_m=np.array(cols[4], dtype=np.int64),
            queue_m=np.array(cols[5], dtype=np.int64),
            min_ts=np.array(cols[6], dtype=np.int64),
            max_ts=np.array(cols[7], dtype=np.int64),
        )


def scan_tiles(root: str,
               skip_names: tuple = (".deadletter", ".traces",
                                    ".flightrec",
                                    ".quarantine")) -> Iterator[str]:
    """Yield tile file paths under an anonymiser output (or dead-letter)
    directory, skipping the dead-letter spool, the batcher's trace-JSON
    spool (``.traces`` — request bodies, not tile CSV), the flight
    recorder's postmortem dumps (``.flightrec`` — span JSON), the
    replayer's poison quarantine (``.quarantine`` — entries that beat
    the replay budget, manual autopsy only) and dot-state files when
    scanning a results root. The dot-file skip also covers the store's
    own control artifacts when a store root is (mis)scanned: the
    ``.lease`` writer-lease file and the ``.profile`` route-memo
    pre-warm artifact are coordination state, never tile CSV."""
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in skip_names)
        for name in sorted(filenames):
            if name.startswith("."):
                continue
            yield os.path.join(dirpath, name)


def ingest_file(store, path: str,
                ingest_key: Optional[str] = None) -> int:
    """Parse + aggregate + append one tile file; returns rows ingested.
    ``ingest_key`` (the file's flush identity — its relpath under the
    scan root) makes the append idempotent via the partition ledger."""
    with open(path, "r", encoding="utf-8") as f:
        obs = parse_tile_csv(f.read())
    return store.ingest(obs, ingest_key=ingest_key)


def ingest_dir(store, root: str, delete: bool = False,
               limit: Optional[int] = None) -> dict:
    """Replay every tile file under ``root`` into ``store``.

    Exactly-once: each file's relpath under ``root`` — which IS the
    flush identity ``{t0}_{t1}/{level}/{tile}/{source}[.writer].e{epoch}``
    the anonymiser stamps, in the output dir and the dead-letter spool
    alike — rides the append as its ledger key, so replaying a
    directory the store (or the worker's tee) already ingested is a
    counted no-op and an ``ingest --delete`` interrupted between append
    and unlink cannot double-count on the re-run.

    ``delete=True`` removes each file after a successful append — the
    dead-letter replay contract (a replayed tile must not double-count
    on the next replay). A file that FAILS mid-ingest is quarantined
    (renamed to ``.<name>.failed``, which :func:`scan_tiles` skips) for
    the same reason: a multi-partition tile may have durably committed
    some partitions' deltas before the error, so blindly replaying it
    would double-count those (the ledger shields exactly the partitions
    that committed). Quarantined files keep the unappended rows for
    manual recovery. Returns ``{"files", "rows", "failures"}`` (plus
    ``"aborted": true`` when a mid-replay writer-lease loss stopped
    the pass — files intact and replayable, NOT counted as failures).
    """
    files = rows = failures = 0
    aborted = False
    # writer-lease gate up front: a replay against a store another
    # process owns must refuse loudly BEFORE touching any tile — not
    # quarantine every file as "failed"
    store.lease.require()
    with metrics.timer("datastore.ingest.dir"):
        for path in scan_tiles(root):
            if limit is not None and files >= limit:
                break
            key = os.path.relpath(path, root).replace(os.sep, "/")
            try:
                rows += ingest_file(store, path, ingest_key=key)
            except LeaseHeldElsewhere:
                # stolen mid-replay (our lease expired under load): the
                # file is intact and replayable — abort the pass, do
                # NOT quarantine, and do NOT count it as a failure
                # ("failures" means quarantined files; this is a
                # healthy retryable abort, flagged separately)
                logger.warning("writer lease lost mid-replay of %s; "
                               "aborting (files left for the next run)",
                               root)
                aborted = True
                break
            except Exception as e:
                logger.error("could not ingest %s (quarantining): %s",
                             path, e)
                failures += 1
                metrics.count("datastore.ingest.quarantined")
                try:
                    d, name = os.path.split(path)
                    os.replace(path, os.path.join(d, f".{name}.failed"))
                except OSError as re:
                    logger.error("could not quarantine %s: %s", path, re)
                continue
            files += 1
            if delete:
                os.unlink(path)
    metrics.count("datastore.ingest.files", files)
    out = {"files": files, "rows": rows, "failures": failures}
    if aborted:
        # a mid-replay lease loss: nothing quarantined, everything
        # left replayable — distinct from "failures" (quarantined)
        out["aborted"] = True
    return out


__all__ = ["parse_tile_csv", "scan_tiles", "ingest_file", "ingest_dir"]
