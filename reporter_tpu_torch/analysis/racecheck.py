"""Runtime concurrency witness (RC rules).

Armed through :func:`reporter_tpu_torch.utils.locks.arm`, every
:class:`~reporter_tpu_torch.utils.locks.TrackedLock` acquire and release
and every Guarded / thread_affine access reports here. The witness keeps
a per-thread held-lock stack and a process-wide held-before graph (edge
A -> B when some thread acquired B while holding A, with the acquisition
stack), and turns what it sees into ``path:line: RULE-ID message``
findings.

RC001  runtime lock-order inversion: acquiring B while holding A closed
       a cycle in the held-before graph — some schedule of the threads
       involved deadlocks. Reported once per cycle with both acquisition
       stacks.
RC002  long hold: a lock held longer than the arming threshold. Locks
       built ``long_hold_ok=True`` (the datastore's commit lock) are
       exempt.
RC003  guarded shared state accessed without its owning lock held by the
       accessing thread (:class:`~reporter_tpu_torch.utils.locks.Guarded`).
RC004  thread-affine state touched from a foreign thread
       (:func:`~reporter_tpu_torch.utils.locks.thread_affine`).

Every new finding counts into the ``racecheck.*`` metrics and leaves a
flight-recorder postmortem (``racecheck.<rule>``). The witness's own
bookkeeping runs under a bare lock and a thread-local re-entrancy guard,
so the locks it takes while recording never feed back into the graph.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

RULES = {
    "RC001": "runtime lock-order inversion (held-before cycle)",
    "RC002": "lock held past the long-hold threshold",
    "RC003": "guarded shared state accessed without its owning lock",
    "RC004": "thread-affine state touched from a foreign thread",
}


@dataclass(frozen=True, order=True)
class Finding:
    """One diagnostic: ``path:line: rule message``, ``path`` relative to
    the repo root with forward slashes."""

    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: frames of the instrumentation itself, skipped when attributing an
#: event to a call site
_SELF_FILES = (
    os.path.join("reporter_tpu_torch", "utils", "locks.py"),
    os.path.join("reporter_tpu_torch", "analysis", "racecheck.py"),
)

_enabled = False
_hold_ns = 200 * 1_000_000

_tls = threading.local()   # .held: List[_HeldRec]; .busy: bool

#: the witness's own state runs under a bare lock: a TrackedLock here
#: would re-enter the witness
_graph_lock = threading.Lock()

# (held_name, acquired_name) -> (site, stack, thread_name)
_edges: Dict[Tuple[str, str], Tuple[str, str, str]] = {}
_adj: Dict[str, Set[str]] = {}
_findings: List[Finding] = []
_reported: Set[Tuple] = set()


class _HeldRec:
    __slots__ = ("lock", "t0_ns", "site", "stack")

    def __init__(self, lock, t0_ns: int, site: Tuple[str, int],
                 stack: str):
        self.lock = lock
        self.t0_ns = t0_ns
        self.site = site
        self.stack = stack


def enable(hold_ms: float) -> None:
    global _enabled, _hold_ns
    _hold_ns = int(max(0.0, hold_ms) * 1e6)
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def _call_site() -> Tuple[Tuple[str, int], str]:
    """((relpath, line), short stack chain) of the nearest caller frame
    outside the instrumentation; the chain keeps up to 4 repo frames."""
    frames: List[Tuple[str, int]] = []
    f = sys._getframe(2)
    while f is not None and len(frames) < 4:
        fn = f.f_code.co_filename
        if any(fn.endswith(s) for s in _SELF_FILES):
            f = f.f_back
            continue
        if fn.startswith(_REPO_ROOT):
            rel = os.path.relpath(fn, _REPO_ROOT).replace(os.sep, "/")
            frames.append((rel, f.f_lineno))
        f = f.f_back
    if not frames:
        return ("<external>", 0), "<external>"
    chain = " <- ".join(f"{p}:{ln}" for p, ln in frames)
    return frames[0], chain


def _record(finding: Finding, dedupe_key: Tuple) -> None:
    """Register one finding (deduplicated), count it and leave a
    postmortem. Callers hold the busy guard. The side effects take the
    metrics-registry and flightrec locks, which are not re-entrant, so
    each is skipped when its lock is on this thread's held stack; the
    finding itself is always recorded."""
    with _graph_lock:
        if dedupe_key in _reported:
            return
        _reported.add(dedupe_key)
        _findings.append(finding)
    held_names = {h.lock.name for h in getattr(_tls, "held", ())}
    if "metrics.registry" not in held_names:
        from ..utils import metrics  # lazy: metrics imports locks
        metrics.count("racecheck.findings")
        metrics.count(f"racecheck.{finding.rule}")
    if "flightrec" not in held_names:
        from ..obs import flightrec
        flightrec.dump(f"racecheck.{finding.rule}",
                       {"finding": finding.render()})


# ---- lock witness (TrackedLock hooks) --------------------------------------

def note_acquired(lock) -> None:
    if not _enabled or getattr(_tls, "busy", False):
        return
    _tls.busy = True
    try:
        held = getattr(_tls, "held", None)
        if held is None:
            held = _tls.held = []
        site, stack = _call_site()
        rec = _HeldRec(lock, time.perf_counter_ns(), site, stack)
        for h in held:
            if h.lock.name != lock.name:
                _note_edge(h, rec)
        held.append(rec)
    finally:
        _tls.busy = False


def note_released(lock) -> None:
    if not _enabled or getattr(_tls, "busy", False):
        return
    _tls.busy = True
    try:
        held = getattr(_tls, "held", None)
        if not held:
            return
        rec = None
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is lock:
                rec = held.pop(i)
                break
        if rec is None:
            return  # acquired while busy or before arming
        dur_ns = time.perf_counter_ns() - rec.t0_ns
        if dur_ns >= _hold_ns and not lock.long_hold_ok:
            path, line = rec.site
            _record(Finding(
                path, line, "RC002",
                f"lock {lock.name} held {dur_ns / 1e6:.0f} ms "
                f"(threshold {_hold_ns / 1e6:.0f} ms) — acquired here "
                f"({rec.stack}); a blocking call under a lock stalls "
                "every waiter"), ("RC002", lock.name, path, line))
    finally:
        _tls.busy = False


def _note_edge(held: _HeldRec, new: _HeldRec) -> None:
    """Record held.lock -> new.lock; report RC001 when it closes a
    cycle. Runs inside the busy guard."""
    a, b = held.lock.name, new.lock.name
    with _graph_lock:
        if (a, b) in _edges:
            return
        _edges[(a, b)] = (f"{new.site[0]}:{new.site[1]}", new.stack,
                          threading.current_thread().name)
        _adj.setdefault(a, set()).add(b)
        path = _find_path(b, a)
    if path is None:
        return
    cycle = [a] + path  # a -> b -> ... -> a
    with _graph_lock:
        rev_site, rev_stack, rev_thread = _edges.get(
            (path[-2] if len(path) >= 2 else b, a), ("?", "?", "?"))
    p, line = new.site
    _record(Finding(
        p, line, "RC001",
        f"runtime lock-order inversion: {a} -> {b} acquired here "
        f"(thread {threading.current_thread().name}; {new.stack}) "
        f"closes the cycle {' -> '.join(cycle)} — the reverse edge into "
        f"{a} was observed at {rev_site} (thread {rev_thread}; "
        f"{rev_stack}); opposite-order threads deadlock"),
        ("RC001", frozenset(cycle)))


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """A path src -> ... -> dst in the held-before graph (the caller
    holds ``_graph_lock``); None when unreachable."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for nxt in sorted(_adj.get(node, ())):
            if nxt == dst:
                return path + [dst]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


# ---- guarded-state audit (Guarded / thread_affine hooks) -------------------

def note_guard_violation(state_name: str, lock_name: str) -> None:
    if not _enabled or getattr(_tls, "busy", False):
        return
    _tls.busy = True
    try:
        site, stack = _call_site()
        path, line = site
        _record(Finding(
            path, line, "RC003",
            f"guarded state {state_name} accessed without holding its "
            f"lock {lock_name} ({stack}) — every access needs the "
            "lock"), ("RC003", state_name, path, line))
    finally:
        _tls.busy = False


def note_affinity_violation(what: str) -> None:
    if not _enabled or getattr(_tls, "busy", False):
        return
    _tls.busy = True
    try:
        site, stack = _call_site()
        path, line = site
        _record(Finding(
            path, line, "RC004",
            f"thread-affine {what} called from foreign thread "
            f"{threading.current_thread().name} ({stack}) — this "
            "object is single-thread-owned by design"),
            ("RC004", what, path, line))
    finally:
        _tls.busy = False


# ---- reporting -------------------------------------------------------------

def findings() -> List[Finding]:
    with _graph_lock:
        return list(_findings)


def render() -> List[str]:
    """The findings as ``path:line: RC0xx message`` lines."""
    return [f.render() for f in sorted(findings())]


def edge_count() -> int:
    """Held-before edges observed so far."""
    with _graph_lock:
        return len(_edges)


def reset() -> None:
    """Drop the graph, the findings and this thread's held stack (other
    threads' stacks clear as those threads release)."""
    with _graph_lock:
        _edges.clear()
        _adj.clear()
        _findings.clear()
        _reported.clear()
    _tls.held = []


def fork_reset() -> None:
    """Child-side post-fork reset (called by ``utils.locks``' fork hook).
    The graph lock is rebound, not taken: a parent thread that held it at
    the fork does not exist in the child."""
    global _graph_lock
    _graph_lock = threading.Lock()
    _edges.clear()
    _adj.clear()
    _findings.clear()
    _reported.clear()
    _tls.held = []


__all__ = ["RULES", "Finding", "enable", "disable", "note_acquired",
           "note_released", "note_guard_violation",
           "note_affinity_violation", "findings", "render", "reset",
           "edge_count", "fork_reset"]
