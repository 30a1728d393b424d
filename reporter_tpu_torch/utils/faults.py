"""Deterministic named failpoints.

Named failpoints sit at the stage boundaries of the ``/report`` path
(``failpoint("native.prep")``, ``"decode.dispatch"``,
``"matcher.assemble"``, ``"route.device"``, ``"match.incremental.commit"``,
``"wire.native"``, ``"admission.gate"``), armed by a spec string so that
a chaos run replays bit for bit, and costing one module-flag check when
disarmed: the hot paths carry the hooks permanently. The port of
``reporter_tpu/utils/faults.py``, with the same grammar, sites and
firing positions, so one spec fires on the same calls in both packages.
It is armed by :func:`configure` (the service's ``faults`` config key),
never from the environment.

Spec grammar (comma-separated)::

    site=kind[:prob][@seed][#limit][+skip]

    kind    error    raise FaultError before the effect runs
            timeout  raise FaultTimeout (also a TimeoutError) before it
            partial  the effect RUNS, then FaultError: a committed but
                     unacknowledged operation
            crash    dump the flight recorder, then os._exit(137)
    prob    fire probability per eligible call (default 1.0), drawn
            from a per-site random.Random(seed): replayable
    seed    RNG seed (default 0)
    limit   stop firing after this many fires (default unlimited):
            bounded storms that end, so recovery paths run
    skip    ignore the first N eligible calls (default 0)

Examples::

    native.prep=error@7#10        ten deterministic prep errors, then clean
    wire.native=error:0.25@42     a flaky writer, 25% failures, replayable

Hook convention: ``failpoint(site)`` sits before the effect and fires
error, timeout and crash; ``failpoint(site, after=True)`` sits after the
effect and fires only ``partial``.

Thread safety: :func:`configure` swaps the whole site table under the
module lock; firing mutates only per-site counters under that site's
lock; ``failpoint`` reads the module flag lock-free.
"""
from __future__ import annotations

import logging
import os
import random
import re
import sys
from typing import Dict, Optional

from . import forksafe as _forksafe
from . import locks as _locks

logger = logging.getLogger("reporter_tpu_torch.faults")

CRASH_EXIT_CODE = 137  # what a SIGKILL'd process reports (128 + 9)

KINDS = ("error", "timeout", "partial", "crash")

#: every failpoint site the JAX package compiles in (the port places the
#: ``/report`` path's; the streaming and datastore sites come with those
#: layers). Arming a site not listed warns: a typo'd spec must not
#: silently run a faultless chaos scenario
KNOWN_SITES = frozenset({
    "native.prep", "decode.dispatch", "matcher.assemble",
    "matcher.submit", "egress.http", "datastore.commit",
    "datastore.compact", "datastore.lease", "state.save",
    "worker.offer", "worker.post_egress", "wire.native",
    "admission.gate", "route.device", "match.incremental.commit",
    "city.swap",
})

#: sites that place an ``after=True`` hook (the only position where
#: kind=partial can fire); partial armed anywhere else warns
AFTER_HOOK_SITES = frozenset({"egress.http", "state.save"})

_ENABLED = False
_SITES: Dict[str, "_FailPoint"] = {}
_SPEC: Optional[str] = None
_lock = _locks.new_lock("faults.configure")


class FaultError(RuntimeError):
    """Raised by an armed ``error`` or ``partial`` failpoint."""


class FaultTimeout(FaultError, TimeoutError):
    """Raised by an armed ``timeout`` failpoint; catchable as either a
    TimeoutError or a FaultError."""


# suffixes after kind[:prob] may come in any order (#limit / +skip / @seed)
_SPEC_RE = re.compile(
    r"^(?P<site>[A-Za-z0-9_.\-]+)=(?P<kind>[a-z]+)"
    r"(?::(?P<prob>[0-9.]+))?"
    r"(?:@(?P<seed>\d+)|#(?P<limit>\d+)|\+(?P<skip>\d+)){0,3}$")


class _FailPoint:
    __slots__ = ("site", "kind", "prob", "seed", "limit", "skip",
                 "rng", "fired", "seen", "lock")

    def __init__(self, site: str, kind: str, prob: float, seed: int,
                 limit: Optional[int], skip: int):
        self.site = site
        self.kind = kind
        self.prob = prob
        self.seed = seed
        self.limit = limit
        self.skip = skip
        self.rng = random.Random(seed)
        self.fired = 0
        self.seen = 0
        self.lock = _locks.new_lock(f"faults.site.{site}")

    def fire(self, after: bool) -> None:
        # partial fires only after the effect, everything else before it
        if (self.kind == "partial") != after:
            return
        with self.lock:
            self.seen += 1
            if self.seen <= self.skip:
                return
            if self.limit is not None and self.fired >= self.limit:
                return
            if self.prob < 1.0 and self.rng.random() >= self.prob:
                return
            self.fired += 1
        if self.kind == "crash":
            # uncatchable, no cleanup, no atexit. The flight recorder gets
            # the last word first (guarded: a broken postmortem must not
            # turn a crash test into a hang)
            try:
                from ..obs import flightrec
                flightrec.dump(f"crash.{self.site}")
            except BaseException:
                pass
            sys.stderr.write(f"FAULT crash at {self.site}\n")
            sys.stderr.flush()
            os._exit(CRASH_EXIT_CODE)
        if self.kind == "timeout":
            raise FaultTimeout(f"injected timeout at {self.site}")
        raise FaultError(f"injected {self.kind} at {self.site}")


def parse_spec(spec: str) -> Dict[str, _FailPoint]:
    """Parse a whole spec string; raises ValueError on any malformed
    entry."""
    sites: Dict[str, _FailPoint] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        m = _SPEC_RE.match(entry)
        if m is None:
            raise ValueError(f"bad fault spec entry {entry!r} "
                             f"(want site=kind[:prob][@seed][#limit][+skip])")
        kind = m.group("kind")
        if kind not in KINDS:
            raise ValueError(f"bad fault kind {kind!r} in {entry!r} "
                             f"(one of {KINDS})")
        prob = float(m.group("prob")) if m.group("prob") else 1.0
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"fault prob {prob} out of [0,1] in {entry!r}")
        sites[m.group("site")] = _FailPoint(
            m.group("site"), kind, prob,
            int(m.group("seed") or 0),
            int(m.group("limit")) if m.group("limit") else None,
            int(m.group("skip") or 0))
    return sites


def configure(spec: Optional[str]) -> None:
    """(Re)arm the failpoint table from a spec string; None or "" disarms.
    Counters reset: a chaos scenario starts from a clean slate."""
    global _ENABLED, _SITES, _SPEC
    sites = parse_spec(spec) if spec else {}
    with _lock:
        _SITES = sites
        _SPEC = spec if sites else None
        _ENABLED = bool(sites)
    if sites:
        logger.warning("fault injection ARMED: %s", spec)
        for site, fp in sites.items():
            if site not in KNOWN_SITES:
                logger.warning(
                    "fault site %r is not a compiled-in failpoint "
                    "(%s): it will never fire unless some code calls "
                    "failpoint(%r)", site, sorted(KNOWN_SITES), site)
            elif fp.kind == "partial" and site not in AFTER_HOOK_SITES:
                logger.warning(
                    "fault site %r has no after-hook: kind=partial "
                    "will never fire there (after-hook sites: %s)",
                    site, sorted(AFTER_HOOK_SITES))


def clear() -> None:
    """Disarm every failpoint."""
    configure(None)


def failpoint(site: str, after: bool = False) -> None:
    """The hook: one module-flag check when disarmed. May raise
    :class:`FaultError`/:class:`FaultTimeout` or end the process
    (kind=crash). ``after=True`` marks the committed-but-unacknowledged
    position (only ``partial`` fires there)."""
    if not _ENABLED:
        return
    fp = _SITES.get(site)
    if fp is not None:
        fp.fire(after)


def active_spec() -> Optional[str]:
    """The armed spec string, or None (``/health``'s ``faults``)."""
    return _SPEC


def fired_counts() -> Dict[str, int]:
    """{site: times fired} for every armed site."""
    return {site: fp.fired for site, fp in _SITES.items()}


def _fork_reset() -> None:
    """A forked worker re-arms the parent's spec from a clean slate, its
    own counters and RNGs, so each worker replays the spec from its first
    call."""
    global _SITES
    if _SPEC:
        # lint: ignore[LD001] — the forked child runs this alone, first
        _SITES = parse_spec(_SPEC)


_forksafe.register(_fork_reset)

__all__ = ["FaultError", "FaultTimeout", "KINDS", "KNOWN_SITES",
           "configure", "clear", "failpoint", "active_spec",
           "fired_counts", "parse_spec"]
