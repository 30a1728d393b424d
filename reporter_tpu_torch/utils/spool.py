"""Bounded dead-letter spools: one write, shed and measure layer.

- :func:`write` commits a spool entry by the :mod:`.fsio` atomic protocol
  (spool entries replay later: a torn body would replay as a silent
  truncation) and then enforces the byte cap.
- :func:`set_cap_mb` caps each spool root (the service's
  ``deadletter_max_mb`` config key). When a write pushes a root over the
  cap, the oldest entries are shed first (by mtime, ties by name), and
  every shed file counts into ``deadletter.shed``. 0 (the default)
  disables shedding.
- :func:`backlog` / :func:`backlog_snapshot` measure the spooled files
  and bytes, so ``/health`` shows a stalled drain as a gauge before the
  disk fills.

The trace spool's root is registered process-wide (:func:`set_trace_dir`,
the service's ``deadletter_dir`` config key): the matcher's
poisoned-trace quarantine writes into it and ``/health`` reads its
backlog. The port of ``reporter_tpu/utils/spool.py``; the tile spool
(its root and writer) comes with the streaming worker.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

from . import forksafe as _forksafe
from . import fsio, metrics
from . import locks as _locks

logger = logging.getLogger("reporter_tpu_torch.spool")

#: directory names that live inside a tile spool root but are not tile
#: bodies (the trace spool, flight-recorder dumps, the drain quarantine);
#: shedding and backlog walks of a tile root skip them, each is its own
#: spool with its own accounting
NESTED_SPOOLS = (".traces", ".flightrec", ".quarantine")

#: seconds a gauge walk stays cached: /health probes arrive every few
#: seconds, and a full-spool walk is O(backlog) stats at exactly the
#: moment the node is degraded
BACKLOG_TTL_S = 5.0

_lock = _locks.new_lock("spool")
_trace_dir: Optional[str] = None
_cap_bytes = 0
# per-root approximate spooled bytes, kept by write() and made exact by
# enforce_cap(): the common under-cap write must not pay a tree walk.
# Drains and sheds outside write() only make the estimate high, which
# costs one recalibrating walk, never a missed shed
_approx_bytes = _locks.Guarded({}, _lock, "spool.approx_bytes")
_backlog_cache = _locks.Guarded({}, _lock, "spool.backlog_cache")


def set_cap_mb(mb: float) -> None:
    """Cap each spool root at ``mb`` MiB (0: unbounded)."""
    global _cap_bytes
    with _lock:
        _cap_bytes = int(mb * 1024 * 1024) if mb > 0 else 0


def cap_bytes() -> int:
    """The per-spool-root byte cap (0 = unbounded)."""
    return _cap_bytes


def set_trace_dir(path: Optional[str]) -> None:
    """Register the trace-JSON dead-letter root (the quarantine's)."""
    global _trace_dir
    with _lock:
        _trace_dir = path


def trace_dir() -> Optional[str]:
    with _lock:
        return _trace_dir


def walk_files(root: str, skip_nested: bool):
    """Yield (path, size, mtime) for every spooled file under ``root``
    (dot files and temp files skipped; nested spools skipped when
    asked): the one definition of what counts as a spool entry."""
    for dirpath, dirnames, filenames in os.walk(root):
        if skip_nested:
            dirnames[:] = [d for d in dirnames if d not in NESTED_SPOOLS]
        for name in filenames:
            if name.startswith(".") or name.endswith(".tmp"):
                continue
            path = os.path.join(dirpath, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            yield path, st.st_size, st.st_mtime


def backlog(root: Optional[str], skip_nested: bool = True) -> Dict[str, int]:
    """{"files", "bytes"} spooled under ``root`` (0s when absent)."""
    files = total = 0
    if root and os.path.isdir(root):
        for _path, size, _mtime in walk_files(root, skip_nested):
            files += 1
            total += size
    return {"files": files, "bytes": total}


def backlog_cached(root: Optional[str],
                   skip_nested: bool = True) -> Dict[str, int]:
    """:func:`backlog` behind a :data:`BACKLOG_TTL_S` cache: the gauge
    surface (``/health``). Exact callers use :func:`backlog`."""
    if not root:
        return {"files": 0, "bytes": 0}
    now = time.monotonic()
    with _lock:
        hit = _backlog_cache.get(root)
        if hit is not None and now - hit[0] < BACKLOG_TTL_S:
            return hit[1]
    fresh = backlog(root, skip_nested=skip_nested)
    with _lock:
        _backlog_cache[root] = (now, fresh)
    return fresh


def backlog_snapshot() -> Dict[str, Dict[str, int]]:
    """Backlog gauges of the spool roots: ``/health``'s ``deadletter``
    block. No tile spool runs in the port yet, so ``tiles`` reads 0s."""
    return {"tiles": backlog_cached(None),
            "traces": backlog_cached(trace_dir())}


def enforce_cap(root: str, skip_nested: bool = True,
                cap: Optional[int] = None) -> int:
    """Shed oldest first until ``root`` fits the cap; returns files shed."""
    cap = cap_bytes() if cap is None else cap
    if not cap:
        return 0
    entries = sorted(walk_files(root, skip_nested),
                     key=lambda e: (e[2], e[0]))
    total = sum(size for _p, size, _m in entries)
    shed = 0
    for path, size, _mtime in entries:
        if total <= cap:
            break
        try:
            os.unlink(path)
        except OSError:
            continue
        total -= size
        shed += 1
        logger.warning("dead-letter cap: shed oldest spool entry %s "
                       "(%d B)", path, size)
    with _lock:
        _approx_bytes[root] = total  # exact again after the walk
    if shed:
        metrics.count("deadletter.shed", shed)
    return shed


def write(root: str, relpath: str, payload: str,
          skip_nested: bool = True) -> str:
    """Atomically spool ``payload`` at ``root/relpath`` (parent
    directories made), then enforce the byte cap on ``root``; returns the
    final path."""
    path = os.path.join(root, relpath)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fsio.atomic_write_text(path, payload)
    cap = cap_bytes()
    if cap:
        with _lock:
            if root not in _approx_bytes:
                # the first capped write for this root seeds the estimate
                # from disk (a restart may inherit a full spool)
                _approx_bytes[root] = backlog(
                    root, skip_nested=skip_nested)["bytes"]
            else:
                _approx_bytes[root] += len(payload.encode("utf-8"))
            over = _approx_bytes[root] > cap
        if over:
            enforce_cap(root, skip_nested=skip_nested, cap=cap)
    return path


def _fork_reset() -> None:
    """The byte estimates and gauges described the parent's view; a child
    seeds its own from disk. The roots and the cap stay: they are
    configuration, and forked workers share the deployment's spools."""
    with _lock:
        _approx_bytes.clear()
        _backlog_cache.clear()


_forksafe.register(_fork_reset)

__all__ = ["write", "enforce_cap", "backlog", "backlog_cached",
           "backlog_snapshot", "cap_bytes", "set_cap_mb", "walk_files",
           "set_trace_dir", "trace_dir", "NESTED_SPOOLS"]
