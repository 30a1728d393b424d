"""Multi-city residency: several cities served by one process.

Every ``city=``-tagged request routes through a :class:`CityRegistry`: a
byte-budgeted LRU of fully wired per-city stacks (graph, matcher with its
native runtime, dispatcher and datastore). A request for a non-resident
city loads it (evicting the least recently used city once the budget is
exceeded) and pre-warms the native route-pair memo from the city's
committed ``.profile`` artifact (``datastore/profile.py``), so the first
batch of a newly resident city hits a warm memo.

Configuration is the service config's ``cities`` map::

    {"cities": {"metro-a": {"graph": "a.npz", "datastore": "/data/a",
                            "profile": "/data/a/.profile"}}}

(``profile`` defaults to ``<datastore>/.profile``; either key may be
omitted: a city can serve /report without a datastore and the reverse.)

The registry's arguments stand for the JAX package's environment knobs:

  budget_bytes    REPORTER_TPU_CITY_BUDGET_MB x 2**20 (512 MiB)
  swap_sample     REPORTER_TPU_SWAP_SAMPLE            (0.25)
  swap_agreement  REPORTER_TPU_SWAP_AGREEMENT         (0.99)
  swap_window     REPORTER_TPU_SWAP_WINDOW            (64)
  swap_force      REPORTER_TPU_SWAP_FORCE             (false)

The budget bounds resident host graph bytes (:func:`graph_bytes`); the
most recently used city is never evicted, so one oversized city still
serves. A city's matcher with ``route_device=True`` also holds its arcs
on the card, outside the budget. Each city's matcher is built on the
registry's ``device`` with the default ``MatchParams``; an evicted or
swapped-out city's stack is closed: its dispatcher drains, its matcher's
lanes, native handle and device tensors are released
(``SegmentMatcher.close``). Counters surface as ``datastore.city.*`` and
``swap.*``; /health and /profile carry the residency table.
"""
from __future__ import annotations

import json
import logging
import os
from collections import OrderedDict, deque
from typing import Callable, Dict, Optional

import numpy as np

from ..utils import faults, metrics
from ..utils import locks as _locks

logger = logging.getLogger("reporter_tpu_torch.service")

#: the registry's defaults (the JAX package's environment defaults)
DEFAULT_BUDGET_BYTES = 512 * 1024 * 1024
DEFAULT_SWAP_SAMPLE = 0.25
DEFAULT_SWAP_AGREEMENT = 0.99
DEFAULT_SWAP_WINDOW = 64

#: the keys of one city's config entry
CITY_CONFIG_KEYS = ("graph", "datastore", "profile")


def graph_bytes(net) -> int:
    """Resident-size estimate of one city: the graph's numpy columns (the
    dominant host term; the native handle mirrors the same columns, so
    this undercounts by a small constant factor: the budget is a
    residency bound, not an allocator)."""
    return sum(v.nbytes for v in vars(net).values()
               if isinstance(v, np.ndarray))


class CityEntry:
    """One resident city's wired stack.

    ``swap_sample`` of admitted /report requests (deterministic
    accumulator sampling) land in a capture ring of ``swap_window``
    requests, which a swap re-scores on both map builds."""

    def __init__(self, name: str, service, size_bytes: int,
                 warmed_pairs: int = 0, map_version: Optional[str] = None,
                 swap_sample: float = DEFAULT_SWAP_SAMPLE,
                 swap_window: int = DEFAULT_SWAP_WINDOW):
        self.name = name
        self.service = service
        self.size_bytes = size_bytes
        self.warmed_pairs = warmed_pairs
        # content-derived graph identity (graph/version.py), stamped by
        # the registry's load; swap() compares it across versions
        self.map_version = map_version
        # in-flight request pins (the registry's _res_lock guards both): an
        # evicted entry with live pins defers its close to the last release
        self._refs = 0
        self._evicted = False
        self._sample = max(0.0, min(1.0, float(swap_sample)))
        self._capture: deque = deque(maxlen=max(1, int(swap_window)))
        self._cap_acc = 0.0
        self._cap_lock = _locks.new_lock("datastore.cities.capture")

    def observe(self, req: dict) -> None:
        """Sample one admitted /report request into the capture ring."""
        if self._sample <= 0.0:
            return
        with self._cap_lock:
            self._cap_acc += self._sample
            if self._cap_acc < 1.0:
                return
            self._cap_acc -= 1.0
            self._capture.append(req)
        metrics.count("swap.shadow.sampled")

    def capture_samples(self) -> list:
        with self._cap_lock:
            return list(self._capture)

    def close(self) -> None:
        """Release on eviction: drain and stop the dispatcher, then close
        the matcher (its lanes, carried incremental state, native handle
        and device tensors), so an evicted stack holds no thread and no
        card memory past its last request."""
        try:
            self.service.dispatcher.close()
        except Exception as e:
            logger.warning("evicting %s: dispatcher close failed: %s",
                           self.name, e)
        try:
            self.service.matcher.close()
        except Exception as e:
            logger.warning("evicting %s: matcher close failed: %s",
                           self.name, e)

    def snapshot(self) -> dict:
        m = self.service.matcher
        memo = m.runtime.route_memo_stats() if m.runtime is not None \
            else None
        return {"size_bytes": self.size_bytes,
                # the cold-start pair: warmed_pairs > 0 with memo hits
                # climbing on the first batch is the pre-warm working
                "warmed_pairs": self.warmed_pairs,
                "route_memo": memo,
                "map_version": self.map_version,
                "datastore": self.service.datastore is not None}


class CityRegistry:
    """Byte-budgeted LRU of :class:`CityEntry` (see the module docstring).

    ``loader`` (tests, harnesses) overrides the config-driven build:
    ``loader(name) -> (service, size_bytes_or_None)``. ``device`` is where
    a config-built city's matcher decodes (``cuda`` unless given), and
    ``matcher`` its ``SegmentMatcher`` keyword arguments (the service
    config's matcher keys, ``server.MATCHER_KEYS``)."""

    def __init__(self, config: Optional[Dict[str, dict]] = None,
                 budget_bytes: int = DEFAULT_BUDGET_BYTES,
                 loader: Optional[Callable] = None, device=None,
                 swap_sample: float = DEFAULT_SWAP_SAMPLE,
                 swap_agreement: float = DEFAULT_SWAP_AGREEMENT,
                 swap_window: int = DEFAULT_SWAP_WINDOW,
                 swap_force: bool = False,
                 matcher: Optional[dict] = None):
        self.config = dict(config or {})
        self.matcher_kwargs = dict(matcher or {})
        self.budget_bytes = int(budget_bytes)
        self.loader = loader
        self.device = device
        self.swap_sample = float(swap_sample)
        self.swap_agreement = float(swap_agreement)
        self.swap_window = int(swap_window)
        self.swap_force = bool(swap_force)
        # long_hold_ok: a miss loads a whole city (graph parse, native
        # build, memo pre-warm: seconds) under the lock by design; loads
        # and swaps must be serialised, and concurrent requests for the
        # loading city want exactly this wait
        self._lock = _locks.new_lock("datastore.cities", long_hold_ok=True)
        # the resident map has its own small lock so /health and /profile
        # snapshots (and pin/release) never wait out a city load; the
        # order is always _lock -> _res_lock
        self._res_lock = _locks.new_lock("datastore.cities.resident")
        self._resident: "OrderedDict[str, CityEntry]" = OrderedDict()
        # swap bookkeeping (guarded by _res_lock): the last record per city
        # and the flip and refusal totals, /health's swap block
        self._swap_last: Dict[str, dict] = {}
        self._swap_flips = 0
        self._swap_refusals = 0

    def _entry(self, name: str, service, size_bytes: int) -> CityEntry:
        return CityEntry(name, service, size_bytes,
                         swap_sample=self.swap_sample,
                         swap_window=self.swap_window)

    # -- residency -----------------------------------------------------------
    def _hit(self, name: str, pin: bool) -> Optional[CityEntry]:
        """Resident-map lookup under the small lock only: a request for a
        loaded city never waits out another city's load. The pin is taken
        inside the same critical section, so no eviction can close the
        entry first."""
        with self._res_lock:
            got = self._resident.get(name)
            if got is not None:
                self._resident.move_to_end(name)
                if pin:
                    got._refs += 1
        return got

    def _evict_over_budget(self) -> list:
        """Drop LRU cities until resident bytes fit the budget, the most
        recent staying regardless (called with _res_lock held); returns the
        unpinned evictees for the caller to close after the locks drop (a
        pinned one closes at its last release)."""
        evicted = []
        while len(self._resident) > 1 and sum(
                e.size_bytes for e in self._resident.values()) \
                > self.budget_bytes:
            # lint: ignore[LD001] — its callers (get, _admit) hold _res_lock
            ename, e = self._resident.popitem(last=False)
            e._evicted = True
            metrics.count("datastore.city.evictions")
            if e._refs <= 0:
                evicted.append((ename, e))
        return evicted

    def get(self, name: str, pin: bool = False) -> CityEntry:
        """The city's entry, loading (and pre-warming) it on a miss under
        the registry lock; resident hits take only the map lock; evicted
        stacks are closed after the locks drop."""
        got = self._hit(name, pin)
        if got is not None:
            metrics.count("datastore.city.hits")
            return got
        evicted = []
        try:
            # a miss loads the whole city (graph, host runtime build, memo
            # pre-warm) under _lock by design (long_hold_ok): loads and
            # swaps are serialised, and requests for the loading city want
            # this wait; hits take _res_lock only
            with self._lock:  # lint: ignore[LD003]
                got = self._hit(name, pin)  # loaded while we waited
                if got is not None:
                    metrics.count("datastore.city.hits")
                    return got
                if self.loader is None and name not in self.config:
                    raise KeyError(f"unknown city {name!r}; configured: "
                                   f"{sorted(self.config)}")
                metrics.count("datastore.city.misses")
                entry = self._load(name)
                with self._res_lock:
                    self._resident[name] = entry
                    if pin:
                        entry._refs += 1
                    evicted = self._evict_over_budget()
                return entry
        finally:
            for ename, e in evicted:
                logger.info("evicting city %s (%.1f MB) over the residency "
                            "budget", ename, e.size_bytes / 1e6)
                e.close()

    def acquire(self, name: str) -> CityEntry:
        """:meth:`get` with a pin: the entry cannot be closed (only
        unmapped) until the matching :meth:`release`."""
        return self.get(name, pin=True)

    def release(self, entry: CityEntry) -> None:
        """Unpin; closes an entry evicted mid-request once its last
        in-flight request has drained off it."""
        with self._res_lock:
            entry._refs -= 1
            close_now = entry._evicted and entry._refs <= 0
        if close_now:
            logger.info("closing evicted city %s after its last in-flight "
                        "request", entry.name)
            entry.close()

    def _load(self, name: str) -> CityEntry:
        with metrics.timer("datastore.city.load"):
            if self.loader is not None:
                service, size = self.loader(name)
                if size is None:
                    size = graph_bytes(service.matcher.net)
                entry = self._entry(name, service, size)
            else:
                entry = self._load_from_config(name)
            self._finish_load(name, entry)
            return entry

    def _finish_load(self, name: str, entry: CityEntry) -> None:
        """Wire-up common to every load (config, loader, swap candidate):
        the profile pre-warm, the map-version stamp, the counters."""
        from ..datastore import load_profile, warm_matcher
        from ..datastore.profile import profile_path
        from ..graph.version import map_version
        conf = self.config.get(name, {})
        ppath = conf.get("profile")
        if ppath is None and conf.get("datastore"):
            ppath = profile_path(conf["datastore"])
        if ppath is None and entry.service.datastore is not None:
            ppath = profile_path(entry.service.datastore.root)
        if ppath:
            try:
                entry.warmed_pairs = warm_matcher(entry.service.matcher,
                                                  load_profile(ppath))
            except Exception as e:
                # the pre-warm is an optimisation: it never costs the load
                logger.warning("profile pre-warm of %s failed (loading "
                               "cold): %s", name, e)
        # the graph's persisted columns plus the committed profile: two
        # builds with identical bytes share a version, any change mints a
        # new one
        extra = None
        if ppath and os.path.exists(ppath):
            with open(ppath, "rb") as fh:
                extra = fh.read()
        entry.map_version = map_version(entry.service.matcher.net,
                                        extra=extra)
        # the version stamps the city's datastore (epoch-qualified ledger
        # keys and manifest tags keep map builds apart across a swap)
        if entry.service.datastore is not None:
            try:
                entry.service.datastore.set_map_version(entry.map_version)
            except Exception as e:
                logger.warning("stamping %s datastore with map %s failed: "
                               "%s", name, entry.map_version, e)
        metrics.count("datastore.city.loads")
        logger.info("city %s resident: %.1f MB, %d memo pairs pre-warmed, "
                    "map %s", name, entry.size_bytes / 1e6,
                    entry.warmed_pairs, entry.map_version)

    def _load_from_config(self, name: str) -> CityEntry:
        from ..graph.network import RoadNetwork
        from ..matcher import SegmentMatcher
        from .server import ReporterService
        conf = self.config[name]
        if not conf.get("graph"):
            raise ValueError(f"city {name!r} has no 'graph' configured")
        net = RoadNetwork.load(conf["graph"])
        datastore = None
        if conf.get("datastore"):
            from ..datastore import LocalDatastore
            datastore = LocalDatastore(conf["datastore"])
        service = ReporterService(
            SegmentMatcher(net, device=self.device, **self.matcher_kwargs),
            datastore=datastore)
        return self._entry(name, service, graph_bytes(net))

    def evict(self, name: str) -> bool:
        """Explicit eviction (tests, admin); a pinned entry closes at its
        last release. Takes the registry lock too (the same _lock ->
        _res_lock order as get), so it serialises with loads."""
        with self._lock, self._res_lock:
            entry = self._resident.pop(name, None)
            if entry is not None:
                entry._evicted = True
                close_now = entry._refs <= 0
        if entry is None:
            return False
        metrics.count("datastore.city.evictions")
        if close_now:
            entry.close()
        return True

    # -- the map swap ----------------------------------------------------------
    def swap(self, name: str, new_source=None,
             force: Optional[bool] = None) -> dict:
        """Swap city ``name`` to a new map build without downtime.

        ``new_source`` is the next version: a config dict (replaces
        ``self.config[name]``) or a zero-argument callable returning
        ``(service, size_bytes_or_None)``; None reloads from the current
        config or loader. The candidate loads and pre-warms beside the
        serving stack (both count against the budget meanwhile), the
        shadow gate re-scores the capture ring on both, and the flip
        happens at a request boundary: in-flight requests finish on the
        old stack through their pins (closed at the last release), new
        ones route to the candidate.

        The swap refuses (the old version keeps serving) rather than evict
        an unrelated pinned city for room, and when the shadow agreement
        falls below ``swap_agreement`` unless forced (``force``, default
        the registry's ``swap_force``). The record's ``result`` is
        ``flipped``, ``loaded``, ``refused_budget`` or ``refused_shadow``;
        every outcome is counted (``swap.flips`` / ``swap.refusals``) and
        on /health's swap block."""
        forced = self.swap_force if force is None else bool(force)
        # a swap loads and shadow-scores the candidate under _lock by
        # design (long_hold_ok): swaps serialise with loads, and the old
        # map serves (hits take _res_lock only) meanwhile
        with self._lock:  # lint: ignore[LD003]
            prev_conf = self.config.get(name)
            if new_source is not None and not callable(new_source):
                self.config[name] = dict(new_source)
            cand = None
            try:
                if callable(new_source):
                    service, size = new_source()
                    if size is None:
                        size = graph_bytes(service.matcher.net)
                    cand = self._entry(name, service, size)
                    with metrics.timer("datastore.city.load"):
                        self._finish_load(name, cand)
                else:
                    if self.loader is None and name not in self.config:
                        raise KeyError(f"unknown city {name!r}; configured:"
                                       f" {sorted(self.config)}")
                    cand = self._load(name)
                old = self._hit(name, pin=False)
                if old is None:
                    # nothing resident to shadow against: a plain budgeted
                    # load of the new version
                    record = {"city": name, "from": None,
                              "to": cand.map_version, "agreement": None,
                              "checks": 0, "forced": forced,
                              "result": "loaded"}
                    self._admit(name, cand, record)
                    return record
                record = {"city": name, "from": old.map_version,
                          "to": cand.map_version, "forced": forced}
                # both versions count against the budget through the
                # shadow window: unpinned unrelated LRU cities are evicted
                # for room, a pinned one refuses the swap. Old plus
                # candidate alone over budget still proceeds (the swapping
                # city must serve); the overshoot ends at the flip
                evicted = []
                refused_for = None
                with self._res_lock:
                    for ename in [n for n in self._resident if n != name]:
                        total = cand.size_bytes + sum(
                            e.size_bytes for e in self._resident.values())
                        if total <= self.budget_bytes:
                            break
                        e = self._resident[ename]
                        if e._refs > 0:
                            continue  # pinned: a swap never evicts it
                        del self._resident[ename]
                        e._evicted = True
                        metrics.count("datastore.city.evictions")
                        evicted.append((ename, e))
                    total = cand.size_bytes + sum(
                        e.size_bytes for e in self._resident.values())
                    if total > self.budget_bytes:
                        pinned = sorted(
                            n for n in self._resident
                            if n != name and self._resident[n]._refs > 0)
                        if pinned:
                            refused_for = pinned
                for ename, e in evicted:
                    logger.info("evicting city %s (%.1f MB) for the swap "
                                "of %s", ename, e.size_bytes / 1e6, name)
                    e.close()
                if refused_for is not None:
                    record["pinned"] = refused_for
                    self._restore_conf(name, prev_conf, new_source)
                    return self._refuse(name, cand, record,
                                        "refused_budget")
                # the shadow gate: the serving entry's capture ring
                # re-scored on both stacks (the handler threads keep
                # routing to the old one), segment-id sequences compared.
                # An empty ring passes: no sampled traffic, nothing to
                # disagree about
                checks = agree = 0
                for sub in old.capture_samples():
                    va = self._shadow_score(old.service, sub)
                    vb = self._shadow_score(cand.service, sub)
                    checks += 1
                    metrics.count("swap.shadow.checks")
                    if va == vb:
                        agree += 1
                        metrics.count("swap.shadow.agree")
                    else:
                        metrics.count("swap.shadow.mismatch")
                agreement = (agree / checks) if checks else 1.0
                record["agreement"] = round(agreement, 4)
                record["checks"] = checks
                floor = self.swap_agreement
                if agreement < floor and not forced:
                    record["floor"] = floor
                    self._restore_conf(name, prev_conf, new_source)
                    return self._refuse(name, cand, record,
                                        "refused_shadow")
                # the widest chaos window: candidate loaded, warmed and
                # gated, the old version serving, nothing flipped yet
                faults.failpoint("city.swap")
                with self._res_lock:
                    self._resident[name] = cand
                    self._resident.move_to_end(name)
                    old._evicted = True
                    close_old_now = old._refs <= 0
                    record["result"] = "flipped"
                    self._swap_last[name] = record
                    self._swap_flips += 1
                metrics.count("swap.flips")
                logger.info("city %s swapped map %s -> %s (agreement %.4f "
                            "over %d checks%s)", name, record["from"],
                            record["to"], agreement, checks,
                            ", FORCED" if forced and agreement < floor
                            else "")
                if close_old_now:
                    old.close()
                # an epoch event on the new version's change feed: /feed
                # subscribers learn the map changed before any new deltas
                ds = cand.service.datastore
                if ds is not None \
                        and getattr(ds, "freshness", None) is not None:
                    try:
                        ds.freshness.feed.publish_epoch(cand.map_version)
                    except Exception as e:
                        logger.warning("epoch feed event for %s failed: "
                                       "%s", name, e)
                return record
            except BaseException:
                self._restore_conf(name, prev_conf, new_source)
                if cand is not None:
                    try:
                        cand.close()
                    except Exception:
                        logger.exception("closing the candidate of %s",
                                         name)
                raise

    def _restore_conf(self, name: str, prev_conf, new_source) -> None:
        """Put back a refused or failed swap's config (swap holds _lock)."""
        if new_source is None or callable(new_source):
            return
        if prev_conf is None:
            # lint: ignore[LD001] — its caller, swap, holds _lock
            self.config.pop(name, None)
        else:
            # lint: ignore[LD001] — its caller, swap, holds _lock
            self.config[name] = prev_conf

    def _refuse(self, name: str, cand: CityEntry, record: dict,
                result: str) -> dict:
        record["result"] = result
        with self._res_lock:
            self._swap_last[name] = record
            self._swap_refusals += 1
        metrics.count("swap.refusals")
        logger.warning("swap of city %s REFUSED (%s); map %s keeps serving: "
                       "%s", name, result, record.get("from"), record)
        try:
            cand.close()
        except Exception:
            logger.exception("closing the refused candidate of %s", name)
        return record

    def _admit(self, name: str, entry: CityEntry, record: dict) -> None:
        """Insert a swap-loaded entry for a non-resident city under the
        same budget policy as :meth:`get`."""
        with self._res_lock:
            self._resident[name] = entry
            evicted = self._evict_over_budget()
            self._swap_last[name] = record
        for ename, e in evicted:
            logger.info("evicting city %s (%.1f MB) over the residency "
                        "budget", ename, e.size_bytes / 1e6)
            e.close()

    @staticmethod
    def _shadow_score(service, sub: dict):
        """The segment-id sequence one version's stack reports for a
        captured request, the shadow gate's comparison key. A non-200
        outcome compares by status (both versions rejecting a request the
        same way is agreement)."""
        try:
            status, body = service.handle(dict(sub))
        except Exception as e:
            return ("error", str(e))
        if status != 200:
            return (status,)
        if isinstance(body, (bytes, bytearray, memoryview)):
            body = bytes(body).decode("utf-8")
        try:
            doc = json.loads(body)
        except ValueError:
            return ("unparseable",)
        segs = (doc.get("segment_matcher") or {}).get("segments") or []
        return (200, tuple(s.get("segment_id") for s in segs))

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> dict:
        """The residency table and swap block. Each entry is pinned while
        its stats are read outside the map lock, so an eviction meanwhile
        closes it only after the read."""
        with self._res_lock:
            entries = list(self._resident.items())
            for _name, e in entries:
                e._refs += 1
            swap = {"flips": self._swap_flips,
                    "refusals": self._swap_refusals,
                    "last": {c: dict(r) for c, r in self._swap_last.items()}}
        try:
            resident = {name: e.snapshot() for name, e in entries}
        finally:
            for _name, e in entries:
                self.release(e)
        return {"budget_bytes": self.budget_bytes,
                "resident_bytes": sum(e["size_bytes"]
                                      for e in resident.values()),
                "configured": sorted(self.config),
                "resident": resident,
                "swap": swap}


__all__ = ["CityRegistry", "CityEntry", "CITY_CONFIG_KEYS",
           "DEFAULT_BUDGET_BYTES", "DEFAULT_SWAP_SAMPLE",
           "DEFAULT_SWAP_AGREEMENT", "DEFAULT_SWAP_WINDOW", "graph_bytes"]
