"""Flight recorder: a bounded ring of recent span events, dumped on
failure so a crash leaves a postmortem.

It keeps the last ``RING_EVENTS`` closed spans and every open span in
memory (filled by :mod:`.trace` whenever tracing is armed, nothing
otherwise) and commits them (:mod:`..utils.fsio`: tmp, fsync, rename,
directory fsync) to ``<dump dir>/flightrec-<pid>-
<seq>-<reason>.json`` at the failure sites that call :func:`dump` (a
runtime concurrency finding, ``analysis/racecheck.py``). The dump also
carries the counters and the last decode chunks' wide events.

The dump directory is set by :func:`set_dump_dir` (the service config's
``flightrec_dir`` key; a pre-fork worker uses ``p<slot>`` under it).
Without one, dumps are skipped; the ring still serves the ``?trace=1``
exporter.
"""
from __future__ import annotations

import collections
import json
import os
import time
from typing import List, Optional

from ..utils import fsio
from ..utils import locks as _locks

#: closed-span ring capacity: at ~20 spans a request, the last ~200
#: requests of context, and enough that one ``?trace=1`` request's spans
#: survive a busy server's concurrent traffic until its export
RING_EVENTS = 4096

#: ring and open-table writes and reads hold the lock: iterating a deque
#: while another thread appends raises RuntimeError (audited by the
#: Guarded wrappers, racecheck RC003)
_lock = _locks.new_lock("flightrec")
_ring = _locks.Guarded(collections.deque(maxlen=RING_EVENTS), _lock,
                       "flightrec.ring")
_open = _locks.Guarded({}, _lock, "flightrec.open")
_dump_dir: Optional[str] = None
_seq = 0


def set_dump_dir(path: Optional[str]) -> None:
    """Where :func:`dump` writes; None turns dumping off."""
    global _dump_dir
    with _lock:
        _dump_dir = path


def dump_dir() -> Optional[str]:
    with _lock:
        return _dump_dir


# ---- ring maintenance (called by trace.py, armed only) ---------------------

def span_opened(span_id: int, record: dict) -> None:
    with _lock:
        _open[span_id] = record


def span_closed(span_id: int, dur_ns: int) -> None:
    with _lock:
        record = _open.pop(span_id, None)
        if record is not None:
            record["dur_ns"] = dur_ns
            _ring.append(record)


def record_closed(records: List[dict]) -> None:
    """Append already-closed span records (synthetic phase spans, links)."""
    with _lock:
        _ring.extend(records)


def open_record(span_id: int) -> Optional[dict]:
    """The record of one open span (None once it closed)."""
    with _lock:
        return _open.get(span_id)


def events() -> List[dict]:
    """Closed spans, oldest first (a copy)."""
    with _lock:
        return list(_ring)


def in_flight() -> List[dict]:
    """Open spans right now, with their age stamped in."""
    now_ns = time.time_ns()
    with _lock:
        open_now = list(_open.values())
    return [{**r, "age_ns": max(0, now_ns - r["t0_ns"])} for r in open_now]


def reset() -> None:
    """Drop the ring and the open table."""
    with _lock:
        _open.clear()
        _ring.clear()


# ---- the postmortem --------------------------------------------------------

def dump(reason: str, extra: Optional[dict] = None) -> Optional[str]:
    """Write the postmortem; returns its path, or None without a dump
    directory. Never raises: every caller is already on a failure path."""
    global _seq
    try:
        with _lock:
            if _dump_dir is None:
                return None
            _seq += 1
            seq = _seq
            out_dir = _dump_dir
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in reason)[:80]
        payload = {
            "reason": reason,
            "pid": os.getpid(),
            "ts_ns": time.time_ns(),
            "in_flight": in_flight(),
            "spans": events(),
        }
        if extra:
            payload["extra"] = extra
        from ..utils import metrics  # lazy: metrics imports obs.trace
        payload["counters"] = metrics.default.export_state()[0]
        # the last decode chunks' wide events beside the span ring: what
        # the device was working on. In a guard of its own: a failure
        # here costs the wide events, never the postmortem
        try:
            from . import profiler  # lazy: profiler imports metrics
            payload["wide_events"] = profiler.recent_events(16)
        except Exception:
            payload["wide_events"] = []
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir,
                            f"flightrec-{os.getpid()}-{seq:04d}-{safe}.json")
        fsio.atomic_write_text(
            path, json.dumps(payload, separators=(",", ":")))
        metrics.count("flightrec.dumps")
        return path
    except Exception:  # the postmortem must never kill its caller
        return None


# fork safety: a forked worker's postmortem carries its own spans; the dump
# directory survives (dump names carry the pid)
from ..utils import forksafe as _forksafe  # noqa: E402

_forksafe.register(reset)
