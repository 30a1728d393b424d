"""Carried per-trace decode state: the incremental streaming decode.

A streaming uuid's window grows between reports (the batcher trims only
the consumed prefix), so re-decoding the whole window on every report
costs O(T·K²) each time. This module carries the decode forward instead:
per uuid it keeps the last-step log-scores (K,), a bounded backpointer
ring of the **uncommitted** tail, and the per-step scalars that segment
assembly reads for the committed prefix. An appended kept point then
costs its candidate row, one route row and one row of a batched device
step (``ops.incremental_step_batch``: on the card the CUDA kernel
``incremental_step``, one launch a round for every trace that advances).

Every report it serves is byte-identical to ``SegmentMatcher.match_many``
over the same window:

- the step scores with ``hmm.emission_scores``/``transition_scores`` and
  takes exact f32 maxima, so the carried scores are the batch scan's;
- the f16 wire policy is the batch path's (``batchpad.pack_batches``):
  every appended step goes through the same f16 round trip, and a window
  whose finite distances leave the f16 range falls back, because the pack
  would ship that whole window as f32;
- **fixed-lag commit** finalises a ring step only when every current
  state's backtrace converges to the same ancestor there, which is what
  the final backtrace picks whatever is appended later. A window whose
  ambiguity outlives the lag bound falls back rather than guess;
- the host prep repeats the batch prep step by step (kept points against
  the last kept anchor, candidate pruning, f32 great-circle casts,
  breakage RESTARTs, the trailing-jitter dwell), and assembly runs the
  same ``assemble_segments`` over a synthesised ``PreparedTrace``.

What the incremental path cannot reproduce byte for byte (a window past
the largest bucket, a wire-dtype flip, a lag window that does not
converge, an evicted state) is a *fallback to the batch path for that
trace*: ``match_many`` leaves its slot None. That is a choice of path
with equal bytes, not a degrade; an error raises.

The table is the port of ``reporter_tpu/matcher/incremental.py``. Its
environment knobs are the owning matcher's constructor arguments
(``incremental``, ``incremental_lag``, ``incremental_mb``); the snapshot
blob (``CarriedState.to_bytes``) is byte-equal to the JAX package's.
"""
from __future__ import annotations

import logging
import struct
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import ops
from ..core.geo import equirectangular_m
from ..graph.route import UNREACHABLE, candidate_route_matrices
from ..graph.spatial import PAD_EDGE, CandidateSet
from ..graph.version import map_version
from ..utils import metrics
from .assemble import assemble_segments
from .batchpad import LENGTH_BUCKETS, PreparedTrace, _prune_candidates
from .hmm import NORMAL, RESTART, UNREACHABLE_THRESHOLD, WIRE_MAX_M

logger = logging.getLogger("reporter_tpu_torch.matcher.incremental")

#: max uncommitted ring steps per trace (``incremental_lag``); the floor
#: is 2, as the JAX package's ``lag_bound`` floors it
DEFAULT_LAG = 32
MIN_LAG = 2
#: carried-state byte budget in MiB (``incremental_mb``); LRU beyond it
DEFAULT_BUDGET_MB = 64.0
#: the batch path ships f16 wherever the data fits it, so every carried
#: state quantises through the f16 wire
WIRE_F16 = True


class _Fallback(Exception):
    """This trace must be served by the batch path (reason in args[0]).
    Not an error: raised wherever the incremental path cannot reproduce
    the batch bytes (truncation, wire flip, non-convergent lag window)."""


class _Ring:
    """One uncommitted kept step: its full candidate row (assembly needs
    the chosen one, unknown until backtrace), backpointers, and the raw
    f32 route row from the previous kept step (pre-wire values, as the
    batch prep stores them)."""

    __slots__ = ("kept_idx", "case", "edge_ids", "offset_m", "bp",
                 "prev_best", "route_in")

    def __init__(self, kept_idx, case, edge_ids, offset_m, bp, prev_best,
                 route_in):
        self.kept_idx = int(kept_idx)
        self.case = int(case)
        self.edge_ids = edge_ids      # (K,) i32
        self.offset_m = offset_m      # (K,) f32
        self.bp = bp                  # (K,) i32 | None (window-first step)
        self.prev_best = int(prev_best)
        self.route_in = route_in      # (K, K) f32 | None (window-first)

    def nbytes(self, K: int) -> int:
        return 4 * K * K + 3 * 4 * K + 64


class _Step:
    """Host-prepped inputs for one appended kept point, queued for the
    batched device step."""

    __slots__ = ("kept_idx", "case", "dist_w", "valid", "route_w", "gc_w",
                 "edge_ids", "offset_m", "route_raw")

    def __init__(self, kept_idx, case, dist_w, valid, route_w, gc_w,
                 edge_ids, offset_m, route_raw):
        self.kept_idx = kept_idx
        self.case = case
        self.dist_w = dist_w          # (K,) f32, wire round-tripped
        self.valid = valid            # (K,) bool
        self.route_w = route_w        # (K,K) f32, wire round-tripped
        self.gc_w = gc_w              # f32 scalar, wire round-tripped
        self.edge_ids = edge_ids      # (K,) i32 (pruned)
        self.offset_m = offset_m      # (K,) f32 (pruned)
        self.route_raw = route_raw    # (K,K) f32 pre-wire | None (first)


class CarriedState:
    """Everything one uuid's decode carries between appended points."""

    __slots__ = ("params_key", "f16", "K", "map_version",
                 "t0", "last_time", "n_raw",
                 "has_cands", "last_kept_raw", "last_lat", "last_lon",
                 "tail_ok", "prev_cand", "scores",
                 "c_kept", "c_case", "c_col", "c_edge", "c_off", "c_route",
                 "ring")

    def __init__(self, params_key, f16: bool, K: int,
                 map_version: Optional[str] = None):
        self.params_key = params_key
        self.f16 = bool(f16)
        self.K = int(K)
        # the graph build this state's edge ids and backpointers belong to
        # (graph/version.py): part of the cache identity, so a state never
        # serves segment ids decoded against another graph
        self.map_version = map_version
        self.t0 = 0.0                 # first raw time of the window
        self.last_time = 0.0          # last processed raw time
        self.n_raw = 0                # raw points processed
        self.has_cands: List[bool] = []
        self.last_kept_raw = -1       # raw index of the last kept point
        self.last_lat = 0.0
        self.last_lon = 0.0
        self.tail_ok = True           # raw tail since last kept is jitter
        self.prev_cand = None         # pruned (K,) candidate row arrays
        self.scores: Optional[np.ndarray] = None  # (K,) f32 carried
        # committed prefix: the scalars assembly reads, one per step
        self.c_kept: List[int] = []   # raw index
        self.c_case: List[int] = []
        self.c_col: List[int] = []    # chosen candidate column
        self.c_edge: List[int] = []
        self.c_off: List[float] = []
        self.c_route: List[float] = []  # route to NEXT committed step
        self.ring: List[_Ring] = []

    @property
    def n_kept(self) -> int:
        return len(self.c_kept) + len(self.ring)

    def nbytes(self) -> int:
        K = self.K
        return (256 + len(self.has_cands)
                + 40 * len(self.c_kept)
                + sum(e.nbytes(K) for e in self.ring)
                + 5 * 4 * K)

    # -- snapshot serde (the JAX package's state snapshot v3 blob) ---------
    _HEAD = struct.Struct("<BBHddiiq??dd")

    def to_bytes(self) -> bytes:
        """Self-contained blob: scalars struct-packed, arrays raw
        ``tobytes`` with shapes implied by K and the packed counts."""
        K = self.K
        key = np.asarray(self.params_key, dtype=np.float64)
        out = [self._HEAD.pack(2, int(self.f16), K, self.t0,
                               self.last_time, self.n_raw,
                               self.last_kept_raw, len(self.c_kept),
                               self.tail_ok, self.prev_cand is not None,
                               self.last_lat, self.last_lon),
               struct.pack("<HH", len(key), len(self.ring)),
               key.tobytes(),
               np.packbits(np.asarray(self.has_cands, dtype=bool)
                           ).tobytes()]
        if self.prev_cand is not None:
            out += [a.tobytes() for a in self.prev_cand]
        sc = self.scores if self.scores is not None \
            else np.zeros(0, dtype=np.float32)
        out.append(struct.pack("<H", len(sc)))
        out.append(sc.tobytes())
        out.append(np.asarray(self.c_kept, dtype=np.int32).tobytes())
        out.append(np.asarray(self.c_case, dtype=np.int8).tobytes())
        out.append(np.asarray(self.c_col, dtype=np.int16).tobytes())
        out.append(np.asarray(self.c_edge, dtype=np.int32).tobytes())
        out.append(np.asarray(self.c_off, dtype=np.float32).tobytes())
        out.append(np.asarray(self.c_route, dtype=np.float32).tobytes())
        for r in self.ring:
            first = r.bp is None
            out.append(struct.pack("<iiB?", r.kept_idx, r.case,
                                   r.prev_best, first))
            out += [r.edge_ids.tobytes(), r.offset_m.tobytes()]
            if not first:
                out += [r.bp.tobytes(), r.route_in.tobytes()]
        # v2 trailer: the graph version the state was decoded against
        mv = (self.map_version or "").encode()
        out.append(struct.pack("<H", len(mv)))
        out.append(mv)
        return b"".join(out)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "CarriedState":
        off = 0

        def take(n):
            nonlocal off
            if off + n > len(blob):
                raise ValueError("truncated carried-state blob")
            b = blob[off:off + n]
            off += n
            return b

        (ver, f16, K, t0, last_time, n_raw, last_kept, n_c, tail_ok,
         has_prev, last_lat, last_lon) = cls._HEAD.unpack(
            take(cls._HEAD.size))
        if ver not in (1, 2):
            raise ValueError(f"carried-state version {ver} unsupported")
        n_key, n_ring = struct.unpack("<HH", take(4))
        key = tuple(np.frombuffer(take(8 * n_key), dtype=np.float64)
                    .tolist())
        st = cls(key, bool(f16), K)
        st.t0, st.last_time, st.n_raw = t0, last_time, n_raw
        st.last_kept_raw = last_kept
        st.tail_ok = bool(tail_ok)
        st.last_lat, st.last_lon = last_lat, last_lon
        bits = np.frombuffer(take((n_raw + 7) // 8), dtype=np.uint8)
        st.has_cands = np.unpackbits(bits, count=n_raw).astype(bool) \
            .tolist()
        if has_prev:
            st.prev_cand = tuple(
                np.frombuffer(take(4 * K), dtype=dt)
                for dt in (np.int32, np.float32, np.float32, np.float32,
                           np.float32))
        (n_sc,) = struct.unpack("<H", take(2))
        sc = np.frombuffer(take(4 * n_sc), dtype=np.float32)
        st.scores = sc.copy() if n_sc else None
        st.c_kept = np.frombuffer(take(4 * n_c), np.int32).tolist()
        st.c_case = np.frombuffer(take(1 * n_c), np.int8).tolist()
        st.c_col = np.frombuffer(take(2 * n_c), np.int16).tolist()
        st.c_edge = np.frombuffer(take(4 * n_c), np.int32).tolist()
        st.c_off = np.frombuffer(take(4 * n_c), np.float32).tolist()
        st.c_route = np.frombuffer(take(4 * n_c), np.float32).tolist()
        for _ in range(n_ring):
            kept_idx, case, prev_best, first = struct.unpack(
                "<iiB?", take(10))
            edge = np.frombuffer(take(4 * K), dtype=np.int32)
            offm = np.frombuffer(take(4 * K), dtype=np.float32)
            bp = route_in = None
            if not first:
                bp = np.frombuffer(take(4 * K), dtype=np.int32)
                route_in = np.frombuffer(take(4 * K * K), dtype=np.float32
                                         ).reshape(K, K)
            st.ring.append(_Ring(kept_idx, case, edge, offm, bp,
                                 prev_best, route_in))
        if ver >= 2:
            (n_mv,) = struct.unpack("<H", take(2))
            st.map_version = take(n_mv).decode() or None
        # a version-1 blob predates graph versions: map_version stays None,
        # which a table treats as a mismatch, so the trace re-decodes
        return st


def _wire_roundtrip(arr: np.ndarray) -> np.ndarray:
    """The f16 wire quantisation the batch pack applies, as a value map:
    f32 -> f16 -> f32 (sentinels overflow to +inf and come back intact,
    which is what the decode sees after the wire)."""
    with np.errstate(over="ignore"):
        return arr.astype(np.float16).astype(np.float32)


class IncrementalTable:
    """uuid -> :class:`CarriedState`, byte-budgeted with LRU eviction.

    Owned by a :class:`~.matcher.SegmentMatcher` (its
    ``incremental_table``); its device work goes through
    ``ops.incremental_step_batch`` on the matcher's device, every trace
    that advances in a round in one launch. ``lag`` is the most
    uncommitted ring steps a trace may hold (at least ``MIN_LAG``),
    ``budget_mb`` the carried-state budget in MiB. Mutations run under
    one lock: a streaming worker advances from its flush thread while
    ``/health`` reads the gauge from another.
    """

    def __init__(self, matcher, lag: int = DEFAULT_LAG,
                 budget_mb: float = DEFAULT_BUDGET_MB):
        self.matcher = matcher
        self.lag = max(MIN_LAG, int(lag))
        self.budget_bytes = int(max(0.0, float(budget_mb)) * 1024 * 1024)
        # cache identity includes the graph build: a matcher built around
        # another graph resets every state minted against the old one
        self.map_version: Optional[str] = map_version(matcher.net)
        self._states: Dict[str, CarriedState] = {}
        self._order: List[str] = []   # LRU, oldest first
        self._lock = threading.Lock()
        self._bytes = 0
        self.evictions = 0
        self.fallbacks = 0
        self.resets = 0
        #: device steps run, by parameter group (sigma, beta, K): one
        #: launch each on the card
        self.rounds: Dict[tuple, int] = {}

    # -- gauges ------------------------------------------------------------
    def gauge(self) -> dict:
        with self._lock:
            return {"traces": len(self._states),
                    "map_version": self.map_version,
                    "state_bytes": self._bytes,
                    "budget_bytes": self.budget_bytes,
                    "lag": self.lag,
                    "evictions": self.evictions,
                    "fallbacks": self.fallbacks,
                    "resets": self.resets}

    def _recount(self) -> None:
        self._bytes = sum(s.nbytes() for s in self._states.values())

    def _touch(self, uuid: str) -> None:
        try:
            self._order.remove(uuid)
        except ValueError:
            pass
        self._order.append(uuid)

    def evict(self, uuid: str, reason: str = "evicted") -> None:
        with self._lock:
            if self._states.pop(uuid, None) is not None:
                try:
                    self._order.remove(uuid)
                except ValueError:
                    pass
                self.evictions += 1
                metrics.count("match.incremental.evictions")
                self._recount()
                logger.debug("carried state for %s %s", uuid, reason)

    def clear(self) -> None:
        """Drop every carried state."""
        with self._lock:
            n = len(self._states)
            self._states.clear()
            self._order.clear()
            self._bytes = 0
            if n:
                self.evictions += n
                metrics.count("match.incremental.evictions", n)

    def _enforce_budget(self, keep: Optional[str] = None) -> None:
        """LRU-evict until under budget (called with the lock held)."""
        while self._bytes > self.budget_bytes and self._order:
            victim = next((u for u in self._order if u != keep),
                          self._order[0])  # even the active trace goes
            self._states.pop(victim, None)
            self._order.remove(victim)
            self.evictions += 1
            metrics.count("match.incremental.evictions")
            self._recount()

    # -- snapshot serde ----------------------------------------------------
    def to_blobs(self) -> List[tuple]:
        """[(uuid, blob)] for a state snapshot."""
        with self._lock:
            return [(u, s.to_bytes()) for u, s in self._states.items()]

    def restore_blobs(self, blobs) -> int:
        """Load [(uuid, blob)]; returns the count loaded. A blob that does
        not parse is skipped and logged: that trace re-decodes from its
        window on its next report (a snapshot only saves work)."""
        n = 0
        with self._lock:
            for uuid, blob in blobs:
                try:
                    self._states[uuid] = CarriedState.from_bytes(blob)
                except (ValueError, struct.error) as e:
                    logger.warning("carried state for %s failed to restore "
                                   "(%s); it will re-decode", uuid, e)
                    continue
                self._touch(uuid)
                n += 1
            self._recount()
        return n

    # -- the advance + match path ------------------------------------------
    def match_many(self, tb, per_trace_params, results) -> None:
        """Advance the carried state of every trace of ``tb`` that has a
        uuid and fill ``results[i]`` with its match dict; a slot left None
        falls back to the batch path. An error drops every state the call
        touched and raises."""
        jobs = []   # [i, uuid, state, steps, params, alive]
        touched = []  # every uuid whose state this call may have changed
        with self._lock:
            try:
                # decode cost (prep of the appended points, the device
                # rounds, the fixed-lag commits), timed apart from the
                # assembly below, which the batch path pays alike
                t_dec = time.perf_counter()
                for i in range(len(tb)):
                    uuid = tb.uuid(i)
                    if not uuid:
                        continue
                    params = per_trace_params[i]
                    lat, lon, times = tb.trace_columns(i)
                    if len(times) == 0:
                        continue
                    touched.append(uuid)
                    try:
                        state = self._state_for(uuid, params, times)
                        steps = self._prep_appended(state, params, lat,
                                                    lon, times)
                    except _Fallback as fb:
                        self._fall_back(uuid, fb)
                        continue
                    jobs.append([i, uuid, state, steps, params, True])
                self._run_rounds(jobs)
                metrics.observe("match.incremental.decode",
                                time.perf_counter() - t_dec)

                for i, uuid, state, _steps, params, alive in jobs:
                    if not alive:
                        continue
                    times = tb.trace_columns(i)[2]
                    results[i] = self._build_match(state, times, params)
                    self._touch(uuid)
                    metrics.count("match.incremental.matches")
            except BaseException:
                # a mid-advance error leaves some state half-stepped
                # (n_raw past the scores): drop every state this call
                # touched, so nothing stale survives to the next report
                metrics.count("match.incremental.errors")
                for uuid in touched:
                    self._drop(uuid)
                self._recount()
                raise
            delta = -self._bytes
            self._recount()
            delta += self._bytes
            if delta:
                metrics.count("match.incremental.state_bytes", delta)
            self._enforce_budget(keep=jobs[-1][1] if jobs else None)

    def _fall_back(self, uuid: str, fb: _Fallback) -> None:
        """Count a fallback and drop the trace's state (lock held)."""
        self.fallbacks += 1
        metrics.count("match.incremental.fallbacks")
        logger.debug("trace %s falls back to the batch path (%s)", uuid, fb)
        self._drop(uuid)

    def _drop(self, uuid: str) -> None:
        """Lock-held removal (fallback and error paths)."""
        if self._states.pop(uuid, None) is not None:
            try:
                self._order.remove(uuid)
            except ValueError:
                pass

    def _state_for(self, uuid, params, times) -> CarriedState:
        key = tuple(float(getattr(params, f))
                    for f in type(self.matcher)._PREP_KEY_FIELDS)
        n = len(times)
        st = self._states.get(uuid)
        if st is not None:
            ok = (st.params_key == key and st.f16 == WIRE_F16
                  and st.map_version == self.map_version
                  and 0 < st.n_raw <= n
                  and st.t0 == float(times[0])
                  and st.last_time == float(times[st.n_raw - 1]))
            if not ok:
                # the window's identity changed (a trimmed prefix, a new
                # session on the uuid, other params or graph): the batch
                # path frames the new window with a RESTART at its first
                # kept point, so the carried chain resets and replays
                self._drop(uuid)
                self.resets += 1
                metrics.count("match.incremental.resets")
                st = None
        if st is None:
            st = CarriedState(key, WIRE_F16, int(params.max_candidates),
                              map_version=self.map_version)
            self._states[uuid] = st
            self._touch(uuid)
        return st

    def _prep_appended(self, state: CarriedState, params, lat, lon,
                       times) -> List[_Step]:
        """Host prep for raw points [state.n_raw, len(times)): kept-point
        selection and the kept points' pruned candidates, with the batch
        prep's semantics, then :meth:`_make_steps`. One candidate lookup
        covers every appended point. Mutates the selection state as it
        goes (a fallback drops the state)."""
        m = self.matcher
        K = state.K
        n = len(times)
        j0 = state.n_raw
        if j0 == 0:
            state.t0 = float(times[0])
        if j0 >= n:
            return []
        lookup = m.runtime if m.runtime is not None else m.grid
        rows = lookup.candidates(lat[j0:n], lon[j0:n], K,
                                 params.search_radius)
        has = (rows.edge_ids != PAD_EDGE).any(axis=1).tolist()
        state.has_cands.extend(has)
        state.n_raw = n
        state.last_time = float(times[n - 1])
        anchor = state.last_kept_raw   # what the first new step routes from
        kept: List[int] = []
        gcs: List[float] = []          # from the previous kept point
        for j in range(j0, n):
            if not has[j - j0]:
                state.tail_ok = False  # off-network tail: no dwell
                continue
            if state.last_kept_raw >= 0:
                gc64 = equirectangular_m(state.last_lat, state.last_lon,
                                         float(lat[j]), float(lon[j]))
                if gc64 < params.interpolation_distance:
                    continue           # jitter drop; the tail stays ok
                gcs.append(gc64)
            kept.append(j)
            state.last_kept_raw = j
            state.last_lat = float(lat[j])
            state.last_lon = float(lon[j])
            state.tail_ok = True
        if not kept:
            return []
        if state.n_kept + len(kept) > LENGTH_BUCKETS[-1]:
            # the batch path truncates at the largest bucket; that is
            # window-global, not per step
            raise _Fallback("window exceeds the largest bucket")
        idx = np.asarray(kept, dtype=np.int64) - j0
        pruned = _prune_candidates(
            CandidateSet(edge_ids=rows.edge_ids[idx],
                         dist_m=rows.dist_m[idx],
                         offset_m=rows.offset_m[idx],
                         proj_x=rows.proj_x[idx], proj_y=rows.proj_y[idx]),
            m._prune_margin(params))
        steps = self._make_steps(state, params, pruned, kept, gcs, anchor,
                                 times)
        state.prev_cand = tuple(
            np.ascontiguousarray(a[-1]).copy()
            for a in (pruned.edge_ids, pruned.dist_m, pruned.offset_m,
                      pruned.proj_x, pruned.proj_y))
        return steps

    def _make_steps(self, state, params, pruned, kept, gcs, anchor,
                    times) -> List[_Step]:
        """Route rows, case codes and the wire cast for the appended kept
        points (raw indices ``kept``, candidate rows ``pruned``, ``gcs``
        their great-circle distances from each previous kept point, the
        first from ``anchor``, -1 when the first opens the window): the
        JAX package's per-point ``_make_step``, with one route call for
        all of them."""
        K = state.K
        first = anchor < 0             # kept[0] opens the window
        gc32 = np.asarray(gcs, dtype=np.float32)
        route = self._route_rows(state, params, pruned, gc32, first,
                                 times, [anchor] + kept[:-1], kept)
        dist = pruned.dist_m
        # the batch pack's wire decision per window (a state is always on
        # the f16 wire, ``_state_for``): a finite value past the f16 range
        # would ship the WHOLE window as f32, history the carried f16
        # scores cannot rewrite
        fin = max(float(np.amax(dist, initial=0.0,
                                where=dist < UNREACHABLE_THRESHOLD)),
                  float(np.amax(route, initial=0.0,
                                where=route < UNREACHABLE_THRESHOLD)),
                  float(np.amax(gc32, initial=0.0)))
        if fin > WIRE_MAX_M:
            raise _Fallback("finite distance beyond the f16 wire")
        valid = pruned.edge_ids != PAD_EDGE
        dist_w = _wire_roundtrip(dist)
        route_w = _wire_roundtrip(route)
        gc_w = _wire_roundtrip(gc32)
        steps = []
        for t, j in enumerate(kept):
            s = t - int(first)         # its route/gc row
            if s < 0:                  # the window's first kept point
                # no route in: UNREACHABLE, +inf after the wire
                steps.append(_Step(
                    j, RESTART, dist_w[t], valid[t],
                    np.full((K, K), np.inf, dtype=np.float32),
                    np.float32(0.0), pruned.edge_ids[t],
                    pruned.offset_m[t], None))
                continue
            case = RESTART if gc32[s] > params.breakage_distance else NORMAL
            steps.append(_Step(j, case, dist_w[t], valid[t], route_w[s],
                               gc_w[s], pruned.edge_ids[t],
                               pruned.offset_m[t], route[s]))
        return steps

    def _route_rows(self, state, params, pruned, gc32, first, times, froms,
                    tos) -> np.ndarray:
        """(len(gc32), K, K) raw f32 route rows into each appended kept
        point that has a previous kept point, in one call: consecutive
        rows of the chain [previous kept point's row, appended rows]."""
        K = state.K
        if not len(gc32):
            return np.zeros((0, K, K), dtype=np.float32)
        if first:
            chain = pruned
            froms, tos = froms[1:], tos[1:]
        else:
            chain = CandidateSet(*(
                np.concatenate([p[None], a]) for p, a in zip(
                    state.prev_cand,
                    (pruned.edge_ids, pruned.dist_m, pruned.offset_m,
                     pruned.proj_x, pruned.proj_y))))
        dt = None
        if params.max_route_time_factor > 0:
            dt = times[np.asarray(tos)] - times[np.asarray(froms)]
        kw = dict(max_route_distance_factor=params.max_route_distance_factor,
                  backward_tolerance_m=params.backward_tolerance_m, dt=dt,
                  max_route_time_factor=params.max_route_time_factor,
                  min_time_bound_s=params.min_time_bound_s,
                  turn_penalty_factor=params.turn_penalty_factor)
        m = self.matcher
        if m.runtime is not None:
            route = m.runtime.route_matrices(chain, gc32, **kw)
        else:
            route = candidate_route_matrices(m.net, chain, gc32,
                                             cache=m.route_cache, **kw)
        return np.ascontiguousarray(route, dtype=np.float32)

    def _run_rounds(self, jobs) -> None:
        """Advance every job's queued steps through the batched step, one
        device step per round and parameter group (round r = each trace's
        r-th step)."""
        r = 0
        while True:
            rows = [job for job in jobs if job[5] and r < len(job[3])]
            if not rows:
                break
            # group rows by the device scalars; the steady state is one
            # shared params object
            groups: Dict[tuple, list] = {}
            for job in rows:
                p = job[4]
                gkey = (float(p.effective_sigma), float(p.beta),
                        int(p.max_candidates))
                groups.setdefault(gkey, []).append(job)
            for gkey, grp in groups.items():
                self._round(grp, r, *gkey)
                self.rounds[gkey] = self.rounds.get(gkey, 0) + 1
            r += 1

    def _round(self, grp, r, sigma, beta, K) -> None:
        n = len(grp)
        dist = np.empty((n, K), dtype=np.float32)
        valid = np.empty((n, K), dtype=bool)
        route = np.empty((n, K, K), dtype=np.float32)
        gc = np.empty(n, dtype=np.float32)
        case = np.empty(n, dtype=np.int32)
        prev = np.zeros((n, K), dtype=np.float32)
        for b, job in enumerate(grp):
            step = job[3][r]
            st = job[2]
            dist[b] = step.dist_w
            valid[b] = step.valid
            route[b] = step.route_w
            gc[b] = step.gc_w
            case[b] = step.case
            if st.scores is not None:
                prev[b] = st.scores
        new_scores, bp, prev_best = self._step(
            (dist, valid, route, gc, case, prev), np.float32(sigma),
            np.float32(beta))
        metrics.count("match.incremental.steps", n)
        for b, job in enumerate(grp):
            step = job[3][r]
            st = job[2]
            first = st.scores is None
            st.scores = new_scores[b].copy()
            st.ring.append(_Ring(
                step.kept_idx, step.case, step.edge_ids, step.offset_m,
                None if first else bp[b].copy(),
                0 if first else int(prev_best[b]),
                None if first else step.route_raw))
            try:
                while len(st.ring) > self.lag:
                    self._commit_one(st)
            except _Fallback as fb:
                job[5] = False
                self._fall_back(job[1], fb)

    def _step(self, arrays, sigma, beta):
        """One ``ops.incremental_step_batch`` on the matcher's device;
        (new_scores, bp, prev_best) as host arrays. On the card: one upload
        per operand, one launch, and one copy of the kernel's one output
        buffer into pinned memory."""
        dev = self.matcher.device
        x = tuple(torch.from_numpy(a) for a in arrays)
        if dev.type == "cpu":
            return tuple(t.numpy() for t in
                         ops.incremental_step_batch(*x, sigma, beta))
        N, K = arrays[0].shape
        with torch.cuda.device(dev):
            out = torch.empty(ops.incremental.output_words(N, K),
                              dtype=torch.int32, device=dev)
            ops.incremental_step_batch(*(t.to(dev) for t in x), sigma,
                                       beta, out=out)
            host = torch.empty(out.shape, dtype=torch.int32,
                               pin_memory=True)
            host.copy_(out, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
        h = host.numpy()
        return (h[:N * K].view(np.float32).reshape(N, K),
                h[N * K:2 * N * K].reshape(N, K), h[2 * N * K:])

    def _commit_one(self, st: CarriedState) -> None:
        """Fixed-lag commit of the oldest ring step: finalise its choice
        iff every current state's backtrace converges there. Whatever is
        appended later enters above these steps, so the converged
        ancestor is what the final backtrace picks."""
        K = st.K
        cur = np.arange(K, dtype=np.int32)
        for e in reversed(st.ring[1:]):
            if e.case == RESTART:
                cur = np.full(K, e.prev_best, dtype=np.int32)
            else:
                cur = e.bp[cur]
        c = int(cur[0])
        if not bool((cur == c).all()):
            raise _Fallback("lag window did not converge")
        e0 = st.ring.pop(0)
        if st.c_kept and e0.route_in is not None:
            # the transition INTO this step, at the now-known pair of
            # choices, becomes the previous committed step's outgoing
            # route scalar (what assembly reads)
            st.c_route[-1] = float(e0.route_in[st.c_col[-1], c])
        st.c_kept.append(e0.kept_idx)
        st.c_case.append(e0.case)
        st.c_col.append(c)
        st.c_edge.append(int(e0.edge_ids[c]))
        st.c_off.append(float(e0.offset_m[c]))
        st.c_route.append(float(UNREACHABLE))   # until the next commit
        metrics.count("match.incremental.commits")

    def _build_match(self, st: CarriedState, times, params) -> dict:
        """Synthesise a PreparedTrace and decoded path from the carried
        state and run the batch path's scalar assembly over them."""
        K = st.K
        nc = len(st.c_kept)
        n = st.n_kept
        # the live tail's backtrace (the batch backward pass over the ring)
        ring_path: List[int] = []
        if st.ring:
            cur = int(np.argmax(st.scores))
            ring_path = [cur]
            for e in reversed(st.ring[1:]):
                cur = e.prev_best if e.case == RESTART else int(e.bp[cur])
                ring_path.append(cur)
            ring_path.reverse()
        path = np.zeros(max(n, 1), dtype=np.int32)
        path[nc:n] = ring_path

        edge_ids = np.full((n, K), PAD_EDGE, dtype=np.int32)
        offset = np.zeros((n, K), dtype=np.float32)
        case = np.zeros(n, dtype=np.int32)
        kept_idx = np.zeros(n, dtype=np.int32)
        route_m = np.full((max(n - 1, 0), K, K), UNREACHABLE,
                          dtype=np.float32)
        if nc:
            kept_idx[:nc] = st.c_kept
            case[:nc] = st.c_case
            edge_ids[:nc, 0] = st.c_edge
            offset[:nc, 0] = st.c_off
            # committed -> committed transitions sit at the (0, 0) cell
            # the all-zero committed path indexes
            route_m[:nc - 1, 0, 0] = st.c_route[:nc - 1]
        for t, e in enumerate(st.ring):
            kept_idx[nc + t] = e.kept_idx
            case[nc + t] = e.case
            edge_ids[nc + t] = e.edge_ids
            offset[nc + t] = e.offset_m
            if e.route_in is None:
                continue
            if t == 0 and nc:
                # last committed -> first ring step: the committed side
                # sits in column 0, the ring side keeps its true index
                route_m[nc - 1, 0, :] = e.route_in[st.c_col[-1], :]
            elif t > 0:
                route_m[nc + t - 1] = e.route_in
        dwell = 0.0
        if n and st.last_kept_raw < st.n_raw - 1 and st.tail_ok:
            dwell = float(times[st.n_raw - 1] - times[st.last_kept_raw])
        prepared = PreparedTrace(
            num_raw=st.n_raw, num_kept=n, kept_idx=kept_idx,
            times=np.asarray(times), edge_ids=edge_ids,
            dist_m=np.zeros((n, K), dtype=np.float32),
            offset_m=offset, route_m=route_m,
            gc_m=np.zeros(max(n - 1, 0), dtype=np.float32), case=case,
            trailing_jitter_dwell_s=dwell,
            has_cands=np.asarray(st.has_cands, dtype=bool))
        return assemble_segments(
            self.matcher.net, prepared, path, mode=params.mode,
            queue_threshold_kph=params.queue_speed_threshold_kph,
            interpolation_distance_m=params.interpolation_distance,
            backward_tolerance_m=params.backward_tolerance_m,
            turn_penalty_factor=params.turn_penalty_factor)


__all__ = ["IncrementalTable", "CarriedState", "DEFAULT_LAG",
           "DEFAULT_BUDGET_MB", "MIN_LAG"]
