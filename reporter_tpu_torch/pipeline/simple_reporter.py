"""The batched (historical) pipeline: raw probe archives -> traffic tiles.

The port of ``reporter_tpu/pipeline/simple_reporter.py`` (itself the
rebuild of the reference's py/simple_reporter.py), with the match stage's
decode on the card. Same three stages, same artifacts, same bytes:

1. **gather_traces** — list + download part files (S3 via boto3 when
   configured and available, else a local directory), parse each line with
   a user-supplied ``--src-valuer`` lambda, bbox-filter, cap accuracy at
   1000 m, and shard lines into files by ``sha1(uuid)[:3]``
   (reference: :87-129, :256-276). IO-bound -> process fan-out.

2. **match_traces** — per shard: group by uuid, sort by time, split into
   windows at ``--inactivity`` gaps (reference: :149-163), chunk windows
   past the largest padding bucket with a holdback overlap, and send all
   windows of a shard to the card in batches of ``device_batch`` through
   ``SegmentMatcher.match_many``; ``report()`` post-processing and the
   usable-segment filter are unchanged (:176-177), and rows land in
   ``{bucket_start}_{bucket_end}/{level}/{tile_index}`` files (:178-196).
   A failed ``match_many`` raises out of the stage (the JAX package logs it
   and skips the batch): a decode failure on the card never turns into a
   run that exits 0 with tiles missing.

3. **report_tiles** — per tile file: sort, privacy-cull (id, next_id) runs
   below ``--privacy`` observations, prepend the CSV header, upload/write
   (reference: :211-254). Bucket credentials are an argument, read by
   ``main`` from the config file's ``pipeline`` block.

Stage-level resume via --trace-dir / --match-dir is preserved
(reference: :350-363).

Multi-host: with ``--num-processes N --process-id P`` the gather keeps
only the uuids host P owns (``parallel.host_uuid_filter``), so N hosts
reading one archive split it; ``--coordinator`` also joins a gloo process
group (``parallel.init_multihost``) after the gather and before the match
stage. The matcher decodes over a mesh of every visible card when there
is more than one (the config's ``decode_shard``, ``device_slice`` and
``seq_shards``).

Worker processes are spawned and re-import this module, so its top level
imports neither torch nor anything that does: the gather and report
children stay cheap and never open the card. Only the match stage and
``main`` import torch.
"""
from __future__ import annotations

import argparse
import calendar
import functools  # noqa: F401 -- DEFAULT_VALUER names it, eval'd here
import glob
import gzip
import hashlib
import logging
import math
import multiprocessing
import os
import re
import shutil
import sys
import tempfile
import time
from typing import Callable, Iterable, List, Optional, Tuple

from ..core.osmlr import INVALID_SEGMENT_ID, tile_index, tile_level
from ..core.types import Segment

# worker processes are spawned, not forked: the parent may hold the card
# and the matcher's lane threads, and forking a multi-threaded process can
# deadlock the children mid-mutex
_MP = multiprocessing.get_context("spawn")

logger = logging.getLogger("reporter_tpu_torch.pipeline")

MAX_ACCURACY_M = 1000  # reference: simple_reporter.py:112

#: the keys of the config file's ``pipeline`` block
PIPELINE_KEYS = ("aws_access_key_id", "aws_secret_access_key")


# --------------------------------------------------------------------------
# stage 1: gather
# --------------------------------------------------------------------------

def _parse_part_file(path: str, valuer: Callable, time_pattern: str,
                     bbox: List[float], dest_dir: str,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Parse one downloaded part file into uuid-sharded trace files. In a
    job of ``num_processes`` hosts this one (``process_id``) keeps only
    the uuids it owns (``parallel.host_uuid_filter``), so N hosts reading
    the same archive split the work with no coordination."""
    # the torch-free module: this runs in a spawned gather child
    from ..parallel.multihost import host_uuid_filter
    uuid_filter = host_uuid_filter(num_processes, process_id)
    fast_time = time_pattern == "%Y-%m-%d %H:%M:%S"
    opener = gzip.open if path.endswith(".gz") else open
    shards: dict[str, list[str]] = {}
    count = 0
    with opener(path, "rt") as f:
        for line in f:
            try:
                uuid, tm, lat, lon, acc = valuer(line)
                if uuid_filter is not None and not uuid_filter(str(uuid)):
                    continue
                lat = float(lat)
                lon = float(lon)
                if lat < bbox[0] or lat > bbox[2] or \
                        lon < bbox[1] or lon > bbox[3]:
                    continue
                if isinstance(tm, str) and not tm.isdigit():
                    if fast_time:
                        st = time.struct_time((
                            int(tm[0:4]), int(tm[5:7]), int(tm[8:10]),
                            int(tm[11:13]), int(tm[14:16]), int(tm[17:19]),
                            0, 0, 0))
                    else:
                        st = time.strptime(tm, time_pattern)
                    epoch = calendar.timegm(st)
                else:
                    epoch = int(tm)
                acc = min(int(math.ceil(float(acc))), MAX_ACCURACY_M)
            except Exception:
                continue
            shard = hashlib.sha1(str(uuid).encode()).hexdigest()[:3]
            shards.setdefault(shard, []).append(
                f"{uuid},{epoch},{lat},{lon},{acc}\n")
            count += 1
    # one shard file per worker process (suffix = pid): concurrent gather
    # workers never share a file, so no interleaved/torn rows — stage 2
    # walks every file in the directory regardless of suffix
    pid = os.getpid()
    for shard, rows in shards.items():
        with open(os.path.join(dest_dir, f"{shard}.{pid}"), "a") as f:
            f.write("".join(rows))
    return count


def _gather_worker(paths: List[str], valuer_src: str, time_pattern: str,
                   bbox: List[float], dest_dir: str,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    valuer = eval(valuer_src)  # user-supplied lambda, like the reference
    for path in paths:
        try:
            n = _parse_part_file(path, valuer, time_pattern, bbox, dest_dir,
                                 num_processes, process_id)
            logger.info("Gathered %d probes from %s", n, path)
        except Exception as e:
            logger.error("%s was not processed: %s", path, e)


def gather_traces(src: str, key_regex: str, valuer_src: str,
                  time_pattern: str, bbox: List[float],
                  concurrency: int, num_processes: Optional[int] = None,
                  process_id: Optional[int] = None) -> str:
    """Stage 1 driver. ``src`` is a local directory of part files, or an
    ``s3://bucket/prefix`` URL (requires boto3 + credentials). With
    ``num_processes`` > 1 this host gathers only the uuids it owns
    (``process_id``); a bad id raises before any child starts."""
    from ..parallel.multihost import host_uuid_filter
    host_uuid_filter(num_processes, process_id)
    dest_dir = tempfile.mkdtemp(prefix="traces_", dir=".")
    if src.startswith("s3://"):
        paths = _download_s3(src, key_regex)
    else:
        rx = re.compile(key_regex)
        paths = sorted(
            p for p in glob.glob(os.path.join(src, "**", "*"), recursive=True)
            if os.path.isfile(p) and rx.match(os.path.relpath(p, src)))
    logger.info("Gathering %d part files into %s", len(paths), dest_dir)
    chunks = [paths[i::concurrency] for i in range(concurrency)]
    procs = []
    for chunk in chunks:
        if not chunk:
            continue
        p = _MP.Process(
            target=_gather_worker,
            args=(chunk, valuer_src, time_pattern, bbox, dest_dir,
                  num_processes, process_id))
        p.start()
        procs.append(p)
    for p in procs:
        p.join()
    return dest_dir


def _download_s3(url: str, key_regex: str) -> List[str]:
    try:
        import boto3
    except ImportError:
        raise RuntimeError("s3 source requires boto3, which is unavailable")
    bucket, _, prefix = url[len("s3://"):].partition("/")
    client = boto3.client("s3")
    rx = re.compile(key_regex)
    keys = []
    token = None
    while True:
        kw = {"Bucket": bucket, "Prefix": prefix}
        if token:
            kw["ContinuationToken"] = token
        resp = client.list_objects_v2(**kw)
        keys.extend(o["Key"] for o in resp.get("Contents", []))
        token = resp.get("NextContinuationToken")
        if not token:
            break
    keys = [k for k in keys if rx.match(k)]
    paths = []
    dl_dir = tempfile.mkdtemp(prefix="parts_", dir=".")
    for key in keys:
        path = os.path.join(dl_dir, hashlib.sha1(key.encode()).hexdigest())
        client.download_file(bucket, key, path)
        paths.append(path)
    return paths


# --------------------------------------------------------------------------
# stage 2: match (batched on the card)
# --------------------------------------------------------------------------

# longest window sent to the matcher in one request: the largest padding
# bucket (batchpad.LENGTH_BUCKETS[-1]); longer active windows are chunked
# with a trailing-holdback overlap instead of being truncated
MAX_WINDOW_POINTS = 1024


def _window_spans(times, inactivity: int,
                  max_window: int = MAX_WINDOW_POINTS,
                  holdback_s: int = 15) -> Iterable[tuple]:
    """Index spans ``(lo, hi)`` of matcher windows over a sorted times
    array: split at gaps > ``inactivity`` seconds (reference:
    simple_reporter.py:149-163), then chunk long windows with a
    trailing-holdback overlap (see :func:`_windows_of`). Operating on
    index spans keeps the columnar pipeline zero-copy: each window is a
    slice of the uuid's coordinate arrays, never a list of point dicts.
    """
    import numpy as np

    times = np.asarray(times, dtype=np.float64)
    n = len(times)

    def chunked(start: int, end: int) -> Iterable[tuple]:
        while end - start > max_window:
            yield (start, start + max_window)
            end_t = times[start + max_window - 1]
            j = max_window - 1
            while j > 0 and end_t - times[start + j] <= holdback_s:
                j -= 1
            # progress floor: a pathological burst (>max_window points
            # inside one holdback span) must not degrade to 1-point steps
            # and ~N chunks; advancing at least half a window caps the
            # re-presented overlap at 2x total work
            j = max(max_window // 2, min(j, max_window - 1))
            start += j
        if end - start >= 2:
            yield (start, end)

    gap_at = np.flatnonzero(np.diff(times) > inactivity) + 1
    lo = 0
    for g in gap_at.tolist() + [n]:
        if g - lo >= 2:
            yield from chunked(lo, g)
        lo = g


def _windows_of(points: List[dict], inactivity: int,
                max_window: int = MAX_WINDOW_POINTS,
                holdback_s: int = 15) -> Iterable[List[dict]]:
    """Split a uuid's points at gaps > ``inactivity`` seconds
    (reference: simple_reporter.py:149-163).

    Windows longer than ``max_window`` (the device's largest padding
    bucket) are further split into chunks whose overlap covers the last
    ``holdback_s`` seconds of the previous chunk — the same consumed-prefix
    overlap the streaming path gets from ``shape_used`` trimming
    (reference: Batch.java:73-76, reporter_service.py:89-92): report()
    withholds segments inside the trailing holdback, and the next chunk
    re-presents those points, so pairs at the seam are reported exactly
    once with match context preserved. (Dict-list convenience wrapper
    over :func:`_window_spans`, which the columnar stage uses directly.)
    """
    times = [p["time"] for p in points]
    for lo, hi in _window_spans(times, inactivity, max_window, holdback_s):
        yield points[lo:hi]


def match_traces(trace_dir: str, matcher, mode: str,
                 report_levels: set, transition_levels: set,
                 quantisation: int, inactivity: int, source: str,
                 threshold_sec: int = 15,
                 device_batch: int = 512) -> str:
    """Stage 2 driver: shard files -> batched matching on the matcher's
    device -> tile rows. Returns the directory of tile-row files.

    ``matcher`` is a SegmentMatcher (or anything with ``match_many``). A
    ``match_many`` failure raises, and the partial row directory is
    removed; a ``report()`` failure on one trace is logged and skipped.
    Counts ``pipeline.windows``, ``pipeline.chunks`` (windows cut from an
    active window past ``MAX_WINDOW_POINTS``), ``pipeline.batches``
    (``match_many`` calls) and ``pipeline.seam_dropped`` (reports at or
    below their uuid's highest emitted t0: seam duplicates).
    """
    dest_dir = tempfile.mkdtemp(prefix="matches_", dir=".")
    try:
        _match_into(dest_dir, trace_dir, matcher, mode, report_levels,
                    transition_levels, quantisation, inactivity, source,
                    threshold_sec, device_batch)
    except BaseException:
        shutil.rmtree(dest_dir, ignore_errors=True)
        raise
    return dest_dir


def _match_into(dest_dir, trace_dir, matcher, mode, report_levels,
                transition_levels, quantisation, inactivity, source,
                threshold_sec, device_batch) -> None:
    """:func:`match_traces`' work, its rows written under ``dest_dir``.
    Times each shard's parse and row writes, and each batch's reports
    (``pipeline.match.parse``, ``.write``, ``.report``)."""
    from ..core.tracebatch import TraceBatch
    from ..service.report import report as make_report
    from ..utils import metrics

    # gather workers write one file per (shard, worker pid); all files with
    # the same sha1-prefix shard belong together so a uuid's points are
    # consolidated no matter which worker parsed them
    by_shard: dict[str, list[str]] = {}
    for r, _d, files in os.walk(trace_dir):
        for f in files:
            by_shard.setdefault(f.split(".")[0], []).append(
                os.path.join(r, f))
    total_traces = 0
    shared_opts = {"mode": mode}
    for shard, paths in sorted(by_shard.items()):
        with metrics.timer("pipeline.match.parse"):
            parts = _parse_shard(paths, shared_opts, inactivity,
                                 threshold_sec)
        metrics.count("pipeline.windows", len(parts))

        tiles: dict[str, list[str]] = {}
        # exactly-once across chunk seams: a uuid's windows are processed
        # in time order, and pair start times are strictly increasing along
        # a trace, so dropping reports at or below the uuid's
        # highest-emitted t0 removes seam duplicates (and nothing else)
        last_t0: dict[str, float] = {}
        for lo in range(0, len(parts), device_batch):
            tb = TraceBatch.concat(parts[lo:lo + device_batch])
            matches = matcher.match_many(tb)
            metrics.count("pipeline.batches")
            with metrics.timer("pipeline.match.report"):
                for trace, match in zip(tb, matches):
                    uuid = trace["uuid"]
                    try:
                        rep = make_report(match, trace, threshold_sec,
                                          report_levels, transition_levels)
                    except Exception:
                        logger.error("Failed to report trace with uuid %s "
                                     "from file %s", uuid, shard)
                        continue
                    floor = last_t0.get(uuid)
                    reports = rep["datastore"]["reports"]
                    if floor is not None:
                        kept = [r for r in reports if r["t0"] > floor]
                        metrics.count("pipeline.seam_dropped",
                                      len(reports) - len(kept))
                        reports = rep["datastore"]["reports"] = kept
                    if reports:
                        last_t0[uuid] = max(r["t0"] for r in reports)
                    _emit_rows(rep, trace, quantisation, source, mode, tiles)
        with metrics.timer("pipeline.match.write"):
            for tile_file, rows in tiles.items():
                path = os.path.join(dest_dir, tile_file)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "a") as f:
                    f.writelines(rows)
        total_traces += len(parts)
        logger.info("Finished matching %d windows in %s",
                    len(parts), shard)
    logger.info("Matched %d windows total", total_traces)


def _parse_shard(paths: List[str], opts: dict, inactivity: int,
                 threshold_sec: int) -> list:
    """One shard's files as columnar window parts (uuid, lat, lon, time,
    accuracy, options) over array slices, in each uuid's time order."""
    import numpy as np

    from ..utils import metrics

    # columnar parse: per-uuid coordinate LISTS (one append per row,
    # never a point dict), then arrays + argsort per uuid
    by_uuid: dict[str, tuple] = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                try:
                    uuid, tm, lat, lon, acc = line.strip().split(",")
                    cols = by_uuid.get(uuid)
                    if cols is None:
                        cols = by_uuid[uuid] = ([], [], [], [])
                    cols[0].append(int(tm))
                    cols[1].append(float(lat))
                    cols[2].append(float(lon))
                    cols[3].append(int(acc))
                except ValueError:
                    continue

    # build every window request in this shard up front. The chunker's
    # holdback must equal report()'s threshold: report withholds segments
    # starting within threshold_sec of a chunk's end, and the next chunk
    # re-presents exactly that span
    parts = []
    for uuid, (tms, lats, lons, accs) in by_uuid.items():
        tm = np.asarray(tms, dtype=np.float64)
        order = np.argsort(tm, kind="stable")
        tm = tm[order]
        la = np.asarray(lats, dtype=np.float64)[order]
        lo_ = np.asarray(lons, dtype=np.float64)[order]
        ac = np.asarray(accs, dtype=np.float32)[order]
        spans = list(_window_spans(tm, inactivity,
                                   holdback_s=threshold_sec))
        for k, (a, b) in enumerate(spans):
            parts.append((uuid, la[a:b], lo_[a:b], tm[a:b], ac[a:b],
                          opts))
            # a chunk of a longer active window overlaps a neighbour
            if (k and a < spans[k - 1][1]) or \
                    (k + 1 < len(spans) and spans[k + 1][0] < b):
                metrics.count("pipeline.chunks")
    return parts


def _emit_rows(rep: dict, trace: dict, quantisation: int, source: str,
               mode: str, tiles: dict) -> None:
    """Usable reports -> per-bucket tile rows
    (reference: simple_reporter.py:176-196)."""
    points = trace["trace"]
    max_buckets = (points[-1]["time"] - points[0]["time"]) // quantisation + 1
    for r in rep["datastore"]["reports"]:
        if not (r["t0"] > 0 and r["t1"] > 0 and r["t1"] - r["t0"] > 0.5
                and r["length"] > 0 and r["queue_length"] >= 0):
            continue
        duration = int(round(r["t1"] - r["t0"]))
        start = int(math.floor(r["t0"]))
        end = int(math.ceil(r["t1"]))
        lo_b, hi_b = start // quantisation, end // quantisation
        if hi_b - lo_b > max_buckets:
            logger.error("Segment spans %d buckets but should be <= %d",
                         hi_b - lo_b, max_buckets)
            continue
        for b in range(lo_b, hi_b + 1):
            tile_file = os.path.join(
                f"{b * quantisation}_{(b + 1) * quantisation - 1}",
                str(tile_level(r["id"])), str(tile_index(r["id"])))
            row = ",".join([
                str(r["id"]), str(r.get("next_id", INVALID_SEGMENT_ID)),
                str(duration), "1", str(r["length"]),
                str(r["queue_length"]), str(start), str(end),
                source, mode.upper()]) + "\n"
            tiles.setdefault(tile_file, []).append(row)


# --------------------------------------------------------------------------
# stage 3: report
# --------------------------------------------------------------------------

def _report_worker(files: List[str], match_dir: str, dest: str,
                   privacy: int,
                   credentials: Optional[Tuple[str, str]] = None) -> None:
    for path in files:
        with open(path) as f:
            rows = f.readlines()
        rows.sort()
        # cull rows below the privacy threshold on (segment, next) runs
        kept: list[str] = []
        i = 0
        while i < len(rows):
            ki = rows[i].split(",")[:2]
            j = i
            while j < len(rows) and rows[j].split(",")[:2] == ki:
                j += 1
            if j - i >= privacy:
                kept.extend(rows[i:j])
            i = j
        rel = os.path.relpath(path, match_dir)
        if not kept:
            logger.info("No segments for %s after anonymising", rel)
            continue
        name = hashlib.sha1(path.encode()).hexdigest()
        payload = Segment.column_layout() + "\n" + "".join(kept)
        key = rel + "/" + name
        logger.info("Writing %d segments to %s", len(kept), key)
        if _is_remote(dest):
            _put_remote(dest, key, payload, credentials)
        else:
            out_path = os.path.join(dest, key)
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            with open(out_path, "w") as f:
                f.write(payload)


def _is_remote(dest: str) -> bool:
    return dest.startswith(("s3://", "http://", "https://"))


def _put_remote(dest: str, key: str, payload: str,
                credentials: Optional[Tuple[str, str]] = None) -> None:
    if not dest.startswith("s3://"):
        # signed PUT / boto3 for AWS endpoints, plain POST otherwise —
        # same routing as the streaming TileSink
        from ..utils import http as http_egress
        http_egress.egress_tile(dest, key, payload, credentials=credentials)
        return
    try:
        import boto3
    except ImportError:
        logger.error("s3 destination requires boto3, which is unavailable")
        return
    bucket, _, prefix = dest[len("s3://"):].partition("/")
    full_key = (prefix.rstrip("/") + "/" + key) if prefix else key
    boto3.client("s3").put_object(Bucket=bucket, Key=full_key,
                                  Body=payload.encode())


def report_tiles(match_dir: str, dest: str, privacy: int,
                 concurrency: int,
                 credentials: Optional[Tuple[str, str]] = None) -> None:
    """Stage 3 driver. ``credentials`` (access key, secret) sign a bucket
    destination's PUTs when boto3 is not installed."""
    files = sorted(
        os.path.join(r, f)
        for r, _d, fs in os.walk(match_dir) for f in fs)
    logger.info("Reporting %d anonymised time tiles", len(files))
    if not _is_remote(dest):
        os.makedirs(dest, exist_ok=True)
    chunks = [files[i::concurrency] for i in range(concurrency)]
    procs = []
    for chunk in chunks:
        if not chunk:
            continue
        p = _MP.Process(
            target=_report_worker,
            args=(chunk, match_dir, dest, privacy, credentials))
        p.start()
        procs.append(p)
    for p in procs:
        p.join()


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def _bbox(arg: str) -> List[float]:
    b = [float(x) for x in arg.split(",")]
    if b[0] < -90 or b[1] < -180 or b[2] > 90 or b[3] > 180 \
            or b[0] >= b[2] or b[1] >= b[3]:
        raise argparse.ArgumentTypeError(f"{arg} is not a valid bbox")
    return b


def _int_set(arg: str) -> set:
    return {int(x) for x in arg.split(",")}


DEFAULT_VALUER = ("lambda l: functools.partial(lambda c: "
                  "[c[1], c[0], c[9], c[10], c[5]], l.split('|'))()")


def read_pipeline_config(path: str):
    """(the service's :func:`~..service.server.parse_config` of the file,
    its ``pipeline`` block): an unknown key in either raises."""
    from ..service.server import read_config_block
    return read_config_block(path, "pipeline", PIPELINE_KEYS)


def main(argv=None):
    import torch

    parser = argparse.ArgumentParser(
        prog="python -m reporter_tpu_torch pipeline",
        description="batched pipeline: probe archives -> tile files")
    parser.add_argument("--src", help="local dir of part files or s3://bucket/prefix")
    parser.add_argument("--src-key-regex", default=".*")
    parser.add_argument("--src-valuer", default=DEFAULT_VALUER,
                        help="lambda extracting (uuid, time, lat, lon, accuracy)")
    parser.add_argument("--src-time-pattern", default="%Y-%m-%d %H:%M:%S")
    parser.add_argument("--match-config", required=True,
                        help="JSON config: the service's keys (graph, "
                             "matcher, service) and a pipeline block "
                             "(aws_access_key_id, aws_secret_access_key)")
    parser.add_argument("--device", type=torch.device, default="cuda",
                        help="cuda (default), cuda:I or cpu")
    parser.add_argument("--mode", default="auto")
    parser.add_argument("--report-levels", type=_int_set, default={0, 1})
    parser.add_argument("--transition-levels", type=_int_set, default={0, 1})
    parser.add_argument("--quantisation", type=int, default=3600)
    parser.add_argument("--inactivity", type=int, default=120)
    parser.add_argument("--privacy", type=int, default=2)
    parser.add_argument("--source-id", default="smpl_rprt")
    parser.add_argument("--dest", help="output dir or s3://bucket[/prefix]")
    parser.add_argument("--concurrency", type=int,
                        default=multiprocessing.cpu_count())
    parser.add_argument("--bbox", type=_bbox,
                        default=[-90.0, -180.0, 90.0, 180.0])
    parser.add_argument("--trace-dir", help="resume: pre-gathered traces")
    parser.add_argument("--match-dir", help="resume: pre-matched segments")
    parser.add_argument("--device-batch", type=int, default=512)
    parser.add_argument("--cleanup", action=argparse.BooleanOptionalAction,
                        default=True)
    from ..parallel.multihost import (add_multihost_args, init_multihost,
                                      shutdown_multihost)
    add_multihost_args(parser)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    from ..service.server import (configure_faults, configure_obs,
                                  matcher_from_config)
    from ..utils import metrics

    try:
        conf, knobs = read_pipeline_config(args.match_config)
        configure_obs(conf["obs"])
        configure_faults(conf["faults"])
    except Exception as e:
        sys.stderr.write(f"Problem with config file: {e}\n")
        return 1
    credentials = None
    if knobs.get("aws_access_key_id") or knobs.get("aws_secret_access_key"):
        credentials = (knobs.get("aws_access_key_id"),
                       knobs.get("aws_secret_access_key"))

    trace_dir = args.trace_dir
    match_dir = args.match_dir
    matcher = None
    if not match_dir:
        if not trace_dir and not args.src:
            parser.error("--src is required unless resuming")
        # the matcher first: a run that cannot match (no card, a bad
        # graph) fails before it gathers anything
        try:
            matcher = matcher_from_config(conf, args.device)
        except Exception as e:
            sys.stderr.write(f"could not start the matcher: {e}\n")
            return 1
    if not trace_dir and not match_dir:
        with metrics.timer("pipeline.gather"):
            trace_dir = gather_traces(args.src, args.src_key_regex,
                                      args.src_valuer, args.src_time_pattern,
                                      args.bbox, args.concurrency,
                                      args.num_processes, args.process_id)
    if not match_dir:
        try:
            # a multi-host job's rendezvous: after the gather (pure IO,
            # which needs no peer) and before the match stage
            init_multihost(args.coordinator, args.num_processes,
                           args.process_id)
        except Exception as e:
            sys.stderr.write(f"could not join the multi-host job: {e}\n")
            return 1
        try:
            with metrics.timer("pipeline.match"):
                match_dir = match_traces(
                    trace_dir, matcher, args.mode, args.report_levels,
                    args.transition_levels, args.quantisation,
                    args.inactivity, args.source_id,
                    device_batch=args.device_batch)
        except Exception as e:
            logger.error("Match stage failed: %s; the gathered traces stay "
                         "in %s (resume with --trace-dir)", e, trace_dir)
            return 1
        finally:
            shutdown_multihost()
    if args.dest:
        with metrics.timer("pipeline.report"):
            report_tiles(match_dir, args.dest, args.privacy, args.concurrency,
                         credentials)
    timers = metrics.snapshot()["timers"]
    logging.info("Stage timings: %s", {
        k: v["total_s"] for k, v in timers.items()
        if k.startswith("pipeline.")})
    if args.cleanup:
        for d in (trace_dir, match_dir):
            if d and not (d == args.trace_dir or d == args.match_dir):
                shutil.rmtree(d, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
