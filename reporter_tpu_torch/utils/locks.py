"""Instrumented locking: the runtime concurrency-analysis substrate.

Every lock of the observability layer (and the metrics registry's) comes
from :func:`new_lock`, a :class:`TrackedLock`. When the witness is armed
(:func:`arm`, the service config's ``lockcheck`` key) each acquire and
release feeds the runtime held-before graph in
:mod:`reporter_tpu_torch.analysis.racecheck`, which reports lock-order
inversions (RC001, potential deadlock) and long holds (RC002) with the
acquisition stacks.

- :class:`TrackedLock`: a named ``threading.Lock`` wrapper. Disarmed,
  it costs one module-flag load per acquire and per release (pinned by
  ``python -m reporter_tpu_torch.tools.racefuzz --overhead``, the
  serialized 512-trace A/B). In raw mode (:func:`set_raw`, the config's
  ``lockcheck: "raw"``) :func:`new_lock` hands out bare
  ``threading.Lock`` objects instead: the A leg of that A/B. The witness
  cannot arm in raw mode.
- :class:`Guarded` / :func:`thread_affine`: the shared-state audit.
  ``Guarded(obj, lock, name)`` proxies a mutable object and, armed,
  asserts the owning :class:`TrackedLock` is held by the calling thread
  on every access (RC003). ``@thread_affine`` marks methods of
  single-thread-owned objects: the first armed call binds the instance
  to its thread, any other thread's call is RC004.
- :func:`fuzz_point`: the schedule-perturbation layer. Armed
  (:func:`configure_fuzz`, the service config's ``racefuzz`` key, a
  ``seed[:prob][@max_us]`` spec), every :class:`TrackedLock` acquire and
  every hooked site (the dispatcher's queue put and get) sleeps a seeded
  random few microseconds with probability ``prob``, to reach
  interleavings the scheduler would rarely pick. Each site draws from its
  own generator seeded by ``crc32(site) ^ seed``, so a site's decision
  sequence replays bit-identically by seed. Disarmed, a hook is one
  module-global load.
"""
from __future__ import annotations

import functools
import logging
import random
import sys
import threading
import time
import weakref
import zlib
from typing import Optional

logger = logging.getLogger("reporter_tpu_torch.locks")

#: default RC002 long-hold threshold: generous enough that a loaded host
#: holding the metrics lock through a GC pause stays silent, small enough
#: that a lock held across an HTTP round trip or a subprocess does not
DEFAULT_HOLD_MS = 200.0

_ENABLED = False      # the one flag every disarmed lock site loads
_RAW = False          # new_lock() hands out bare threading.Lock
_witness = None       # reporter_tpu_torch.analysis.racecheck, set by arm()
_FUZZ: Optional["_FuzzSpec"] = None   # the armed perturbation spec
#: every live TrackedLock, for the post-fork sweep (a WeakSet: a lock
#: lives as long as its owner)
_instances: "weakref.WeakSet[TrackedLock]" = weakref.WeakSet()


class TrackedLock:
    """A named lock the runtime witness can observe. Same contract as
    ``threading.Lock`` (non-reentrant; ``with`` support; ``locked()``)
    plus a stable ``name``: the node in the held-before graph (instances
    sharing a name share a node; same-name edges are skipped).

    ``long_hold_ok`` exempts a documented long holder from RC002 (the
    datastore's commit lock: its manifest fsyncs are the design).
    """

    __slots__ = ("_lock", "name", "long_hold_ok", "_owner", "__weakref__")

    def __init__(self, name: str, long_hold_ok: bool = False):
        self._lock = threading.Lock()
        self.name = name
        self.long_hold_ok = long_hold_ok
        self._owner = 0  # acquiring thread id, kept only when armed
        _instances.add(self)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _FUZZ is not None:
            _FUZZ.maybe_yield("lock." + self.name)
        got = self._lock.acquire(blocking, timeout)
        if got and _ENABLED:
            self._owner = threading.get_ident()
            _witness.note_acquired(self)
        return got

    def release(self) -> None:
        if _ENABLED:
            # clear ownership, drop the lock, then tell the witness: an
            # RC002 finding's recording takes the metrics and flightrec
            # locks, and this lock may be one of them
            self._owner = 0
            self._lock.release()
            _witness.note_released(self)
        else:
            self._lock.release()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        return self._lock.locked()

    def held_by_me(self) -> bool:
        """Armed only: is this lock held by the calling thread? Owners are
        kept from arming on, so a lock taken before :func:`arm` reads as
        not held."""
        return self._lock.locked() \
            and self._owner == threading.get_ident()


def new_lock(name: str, long_hold_ok: bool = False):
    """The package lock factory: a :class:`TrackedLock`, or a bare
    ``threading.Lock`` in raw mode (:func:`set_raw`)."""
    if _RAW:
        return threading.Lock()
    return TrackedLock(name, long_hold_ok=long_hold_ok)


# ---- guarded shared state --------------------------------------------------

class Guarded:
    """Audit proxy around a shared mutable (dict, deque, ...): armed, every
    access asserts the owning lock is held by the calling thread (RC003).
    Disarmed, each access costs one flag check plus the forward."""

    __slots__ = ("_gd_obj", "_gd_lock", "_gd_name")

    def __init__(self, obj, lock, name: str):
        object.__setattr__(self, "_gd_obj", obj)
        object.__setattr__(self, "_gd_lock", lock)
        object.__setattr__(self, "_gd_name", name)

    def _gd_check(self) -> None:
        lock = self._gd_lock
        if not (isinstance(lock, TrackedLock) and lock.held_by_me()):
            _witness.note_guard_violation(self._gd_name,
                                          getattr(lock, "name", "?"))

    def unwrap(self):
        """The raw object, unaudited."""
        return self._gd_obj

    def __getattr__(self, attr):
        if _ENABLED:
            self._gd_check()
        return getattr(self._gd_obj, attr)

    def __getitem__(self, key):
        if _ENABLED:
            self._gd_check()
        return self._gd_obj[key]

    def __setitem__(self, key, value):
        if _ENABLED:
            self._gd_check()
        self._gd_obj[key] = value

    def __delitem__(self, key):
        if _ENABLED:
            self._gd_check()
        del self._gd_obj[key]

    def __contains__(self, key):
        if _ENABLED:
            self._gd_check()
        return key in self._gd_obj

    def __iter__(self):
        if _ENABLED:
            self._gd_check()
        return iter(self._gd_obj)

    def __len__(self):
        if _ENABLED:
            self._gd_check()
        return len(self._gd_obj)

    def __bool__(self):
        if _ENABLED:
            self._gd_check()
        return bool(self._gd_obj)


_AFFINE_ATTR = "_thread_affinity_tid"


def thread_affine(method):
    """Mark a method of a single-thread-owned object: the first armed
    call binds the instance to its thread; a call from another thread is
    an RC004 finding. All ``@thread_affine`` methods of one instance share
    the binding; :func:`reset_affinity` unbinds."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        if _ENABLED:
            tid = threading.get_ident()
            bound = getattr(self, _AFFINE_ATTR, None)
            if bound is None:
                try:
                    setattr(self, _AFFINE_ATTR, tid)
                except AttributeError:  # a __slots__ class cannot bind
                    pass
            elif bound != tid:
                _witness.note_affinity_violation(
                    f"{type(self).__name__}.{method.__name__}")
        return method(self, *args, **kwargs)

    return wrapper


def reset_affinity(obj) -> None:
    """Drop an instance's thread binding (an object legitimately handed
    to a new owner thread)."""
    try:
        delattr(obj, _AFFINE_ATTR)
    except AttributeError:
        pass


# ---- arming ----------------------------------------------------------------

def armed() -> bool:
    return _ENABLED


def arm(hold_ms: Optional[float] = None) -> None:
    """Arm the witness and the audit; ``hold_ms`` is the RC002 long-hold
    threshold (default ``DEFAULT_HOLD_MS``). Raises in raw mode."""
    global _ENABLED, _witness
    if _RAW:
        raise RuntimeError("lockcheck \"raw\" hands out bare locks; the "
                           "witness cannot arm in this process")
    from ..analysis import racecheck
    racecheck.enable(DEFAULT_HOLD_MS if hold_ms is None else hold_ms)
    _witness = racecheck
    _ENABLED = True


def disarm() -> None:
    global _ENABLED
    _ENABLED = False


def set_raw() -> None:
    """Raw mode for the rest of the process: every :func:`new_lock` is a
    bare ``threading.Lock``. It must come before the process makes its
    first :class:`TrackedLock`, so that no lock of the process stays
    tracked: the command line reads the config's ``lockcheck`` before it
    imports the command (``python -m reporter_tpu_torch serve|stream|
    pipeline``), and ``tools/racefuzz.py``'s overhead leg sets it first
    thing. Raises while the witness is armed or once a tracked lock
    exists; a no-op when raw mode is on already."""
    global _RAW
    if _RAW:
        return
    if _ENABLED:
        raise RuntimeError("the witness is armed; raw mode cannot start")
    if len(_instances):
        raise RuntimeError(
            f"lockcheck \"raw\" after {len(_instances)} tracked lock(s) were "
            "made would leave them tracked: set it before the package's "
            "modules load (python -m reporter_tpu_torch serve|stream|"
            "pipeline reads it from the config first)")
    _RAW = True


def raw() -> bool:
    """Is raw mode on (:func:`set_raw`)?"""
    return _RAW


# ---- schedule perturbation -------------------------------------------------

class _FuzzSpec:
    """Seeded micro-yield injector: one generator per site, seeded by
    ``crc32(site) ^ seed``, so the decision and duration sequence at each
    site replays bit-identically under the same seed (which thread gets
    which draw still depends on the schedule: that is the point)."""

    __slots__ = ("seed", "prob", "max_us", "yields", "_rngs", "_meta")

    def __init__(self, seed: int, prob: float = 0.25,
                 max_us: float = 200.0):
        if not 0.0 < prob <= 1.0:
            raise ValueError(f"fuzz prob {prob} out of (0,1]")
        if max_us <= 0:
            raise ValueError(f"fuzz max_us {max_us} must be positive")
        self.seed = seed
        self.prob = prob
        self.max_us = max_us
        self.yields = 0
        self._rngs = {}
        # a bare lock, deliberately: the fuzzer's own serialisation must
        # not feed the witness or re-enter itself
        self._meta = threading.Lock()

    def maybe_yield(self, site: str) -> None:
        # one draw sequence per site, serialised so that replays by seed
        # stay deterministic per site
        with self._meta:
            rng = self._rngs.get(site)
            if rng is None:
                rng = self._rngs[site] = random.Random(
                    zlib.crc32(site.encode("utf-8")) ^ self.seed)
            if rng.random() >= self.prob:
                return
            dur = rng.random() * self.max_us / 1e6
            self.yields += 1
        time.sleep(dur)


def parse_fuzz_spec(spec: str) -> _FuzzSpec:
    """``seed[:prob][@max_us]``, e.g. ``7``, ``7:0.5``, ``7:0.5@400``.
    Raises ValueError on a malformed spec (a mistyped fuzz run must not
    run unperturbed)."""
    body = spec.strip()
    max_us = 200.0
    if "@" in body:
        body, us = body.split("@", 1)
        max_us = float(us)
    prob = 0.25
    if ":" in body:
        body, p = body.split(":", 1)
        prob = float(p)
    return _FuzzSpec(int(body), prob=prob, max_us=max_us)


def configure_fuzz(spec: Optional[str]) -> None:
    """(Re)arm the perturbation layer from a spec string; None or "" is
    off."""
    global _FUZZ
    _FUZZ = parse_fuzz_spec(spec) if spec else None
    if _FUZZ is not None:
        logger.warning("schedule perturbation ARMED: seed=%d prob=%g "
                       "max_us=%g", _FUZZ.seed, _FUZZ.prob, _FUZZ.max_us)


def fuzz_point(site: str) -> None:
    """A perturbation hook at a schedule-sensitive site (the dispatcher's
    queue put and get; lock acquires hook internally). One global load
    when disarmed."""
    f = _FUZZ
    if f is not None:
        f.maybe_yield(site)


def fuzz_yields() -> int:
    """Yields injected so far (0 when disarmed): the gauge that
    perturbation actually happened."""
    f = _FUZZ
    return f.yields if f is not None else 0


# ---- fork safety -----------------------------------------------------------

def _fork_reset() -> None:
    """Post-fork child-side sweep: a lock another parent thread held at
    the fork stays locked forever in the child, so its inner lock is
    replaced. Armed, the surviving thread's own holds are kept (owners
    are known); disarmed, any locked lock is presumed orphaned. Runs
    first among the forksafe hooks (this module registers at import,
    before any user of :func:`new_lock`)."""
    me = threading.get_ident()
    for lk in list(_instances):
        try:
            if lk._lock.locked() and lk._owner != me:
                lk._lock = threading.Lock()
                lk._owner = 0
        except Exception:  # a dying referent mid-sweep must not poison it
            pass
    rc = sys.modules.get("reporter_tpu_torch.analysis.racecheck")
    if rc is not None:
        try:
            rc.fork_reset()
        except Exception:
            pass


from . import forksafe as _forksafe  # noqa: E402

_forksafe.register(_fork_reset)

__all__ = ["TrackedLock", "Guarded", "new_lock", "thread_affine",
           "reset_affinity", "arm", "disarm", "armed", "set_raw", "raw",
           "configure_fuzz",
           "parse_fuzz_spec", "fuzz_point", "fuzz_yields",
           "DEFAULT_HOLD_MS"]
