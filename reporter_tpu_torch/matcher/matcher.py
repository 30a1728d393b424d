"""SegmentMatcher: the matcher facade.

Surface of the reference's ``valhalla`` extension module:

    m = SegmentMatcher(net)
    match_json = m.Match(trace_json_str)

plus the batched entry point ``match_many``: many traces prepared on the
host, decoded in one batched Viterbi per padding bucket on the card.

A call runs three stages per chunk of traces. The calling thread runs
host prep: by default one call into the native host runtime per chunk
(``batchpad.prepare_batch``), or with ``native=False`` the numpy prep
(``prepare_traces_numpy`` + ``pack_batches``). With ``route_device=True``
the native prep leaves the route costs to the device route kernel, whose
route tensor stays on the device until the dispatch lane finalises the
batch. Two single-worker device
lanes take each prepared chunk in order: the dispatch lane uploads it,
launches the decode (``ops.decode_batch``, the CUDA kernel on the card)
and starts a non-blocking copy of the paths into pinned host memory,
recorded on a CUDA event; the drain lane waits on that event and
assembles the paths into OSMLR segment runs (native batched assembly,
or ``assemble_segments`` per trace on the numpy path). So chunk N's
decode overlaps the prep of chunk N+1 and the assembly of chunk N-1.
With ``pipeline=False`` both lanes run inline on the calling thread.

The native path returns :class:`MatchRuns`, lazy mapping views over one
chunk's run columns, which the C wire writer serialises directly; the
numpy path returns plain dicts. Both give the same ``/report`` bytes. A
decode, assembly or writer failure raises: nothing falls back to another
implementation.

``match_incremental`` is the streaming path: each trace with a uuid
advances carried decode state by the points appended since its last
report (``matcher/incremental.py``), and a window it cannot reproduce
byte for byte is left to ``match_many``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import cached_property
from typing import List, Optional

import numpy as np
import torch

from .. import ops
from ..core.tracebatch import TraceBatch, as_trace_batch
from ..graph.network import RoadNetwork
from ..graph.route import RouteCache
# the module, not its class: importing graph.route_device first imports
# ops, whose viterbi imports this package
from ..graph import route_device as device_routes
from ..graph.spatial import SpatialGrid
from ..native import NativeRuntime
from ..service import wire
from ..utils import metrics
from .assemble import assemble_segments
from .batchpad import (LENGTH_BUCKETS, SPLIT_WASTE, PaddedBatch,
                       PreparedTrace, kept_point_count, pack_batches,
                       padded_batch_rows, prepare_batch,
                       prepare_traces_numpy)
from .incremental import (DEFAULT_BUDGET_MB, DEFAULT_LAG,
                          IncrementalTable)
from .params import MatchParams

#: spatial grid cell, ~1.5x the default 50 m search radius: reach stays 1
#: (a 3x3 cell scan) while each cell holds few edges
GRID_CELL_M = 75.0
#: the native prep's default worker count is the host's cores up to this
#: cap (the reference's); past it the threads mostly contend
PREP_THREADS_MAX = 32
#: the service dispatcher's default flush cap in traces: two 128-trace
#: chunks per drained batch, so the dispatch lane has a second chunk in
#: flight while the drain lane assembles the first. One device per
#: matcher; a decode mesh would scale it
MATCH_BATCH_DEFAULT = 256


def resolve_device(device=None) -> torch.device:
    """The device a matcher decodes on: CUDA unless the caller names the
    CPU. Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; the matcher decodes on the card "
                "unless it is given device='cpu'")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class RunColumns:
    """One decoded chunk's run columns as Python lists (one bulk
    ``.tolist()`` per column), shared by every :class:`MatchRuns` view of
    the chunk, and the same columns as numpy arrays (``arrays``, start and
    end rounded) for the C wire writer."""

    __slots__ = ("seg_id", "internal", "start", "end", "length", "queue",
                 "begin_idx", "end_idx", "way_off", "ways", "arrays")

    def __init__(self, runs: dict):
        self.seg_id = runs["seg_id"].tolist()
        self.internal = runs["internal"].astype(bool).tolist()
        start_r = np.round(runs["start"], 3)
        end_r = np.round(runs["end"], 3)
        self.start = start_r.tolist()
        self.end = end_r.tolist()
        self.length = runs["length"].tolist()
        self.queue = runs["queue"].tolist()
        self.begin_idx = runs["begin_idx"].tolist()
        self.end_idx = runs["end_idx"].tolist()
        self.way_off = runs["way_off"].tolist()
        self.ways = runs["ways"].tolist()
        self.arrays = {
            "seg_id": runs["seg_id"], "internal": runs["internal"],
            "start": start_r, "end": end_r, "length": runs["length"],
            "queue": runs["queue"], "begin_idx": runs["begin_idx"],
            "end_idx": runs["end_idx"], "way_off": runs["way_off"],
            "ways": runs["ways"]}


def _jnum(x) -> str:
    """One JSON scalar, byte-equal to ``json.dumps(x)``: floats via
    ``float.__repr__`` (with the Infinity/NaN spellings), bools and None
    as their JSON literals, ints via ``str``."""
    if x is True:
        return "true"
    if x is False:
        return "false"
    if x is None:
        return "null"
    if isinstance(x, float):
        if x != x:
            return "NaN"
        if x == float("inf"):
            return "Infinity"
        if x == float("-inf"):
            return "-Infinity"
        return repr(x)
    return str(x)


def render_segments_json(cols: RunColumns, lo: int, hi: int,
                         mode: str) -> str:
    """Run columns [lo, hi) as the reference-schema
    ``{"segments":[...],"mode":...}`` JSON, from the C writer; byte-equal
    to :func:`render_segments_json_py`."""
    return bytes(wire.native_segments(cols.arrays, lo, hi, mode)
                 ).decode("utf-8")


def render_segments_json_py(cols: RunColumns, lo: int, hi: int,
                            mode: str) -> str:
    """The Python columnar segments writer, the oracle the C writer is
    held against, byte-equal to ``json.dumps`` of the materialised match
    dict. Start and end times are finite floats here (rounded probe
    times or -1.0), so bare ``repr`` formats them as json.dumps does."""
    way_off, ways = cols.way_off, cols.ways
    start, end, length = cols.start, cols.end, cols.length
    queue, internal = cols.queue, cols.internal
    begin_idx, end_idx, seg_id = cols.begin_idx, cols.end_idx, cols.seg_id
    parts = []
    for r in range(lo, hi):
        w = ",".join(map(str, ways[way_off[r]:way_off[r + 1]]))
        sid = seg_id[r]
        parts.append(
            f'{{"way_ids":[{w}],'
            f'"start_time":{start[r]!r},'
            f'"end_time":{end[r]!r},'
            f'"length":{length[r]},'
            f'"queue_length":{queue[r]},'
            f'"internal":{"true" if internal[r] else "false"},'
            f'"begin_shape_index":{begin_idx[r]},'
            f'"end_shape_index":{end_idx[r]}'
            + (f',"segment_id":{sid}}}' if sid >= 0 else "}"))
    mode_json = '"auto"' if mode == "auto" else json.dumps(mode)
    return ('{"segments":[' + ",".join(parts) + '],"mode":'
            + mode_json + "}")


class MatchRuns:
    """One trace's match result as a lazy view over its chunk's shared
    :class:`RunColumns`.

    Dict-shaped consumers see the reference-schema match dict through the
    mapping protocol below; the per-run dicts materialise on first
    structural access. ``Match()`` and ``service.report.report_json``
    serialise straight from the columns and never materialise. Not a dict
    subclass: ``json.dumps`` of one raises (use the writers)."""

    __slots__ = ("cols", "lo", "hi", "mode", "_dict")

    def __init__(self, cols: RunColumns, lo: int, hi: int, mode: str):
        self.cols = cols
        self.lo = lo
        self.hi = hi
        self.mode = mode
        self._dict = None

    def _materialise(self) -> dict:
        d = self._dict
        if d is None:
            c, lo, hi = self.cols, self.lo, self.hi
            wo, ways = c.way_off, c.ways
            segments = [
                {"way_ids": ways[wo[r]:wo[r + 1]],
                 "start_time": c.start[r],
                 "end_time": c.end[r],
                 "length": c.length[r],
                 "queue_length": c.queue[r],
                 "internal": c.internal[r],
                 "begin_shape_index": c.begin_idx[r],
                 "end_shape_index": c.end_idx[r],
                 **({"segment_id": c.seg_id[r]}
                    if c.seg_id[r] >= 0 else {})}
                for r in range(lo, hi)]
            d = self._dict = {"segments": segments, "mode": self.mode}
        return d

    # -- mapping protocol (materialises) -----------------------------------
    def __getitem__(self, key):
        return self._materialise()[key]

    def __setitem__(self, key, value):
        if key == "mode":
            # report() stamps mode without needing the segment dicts
            self.mode = value
            if self._dict is not None:
                self._dict["mode"] = value
            return
        self._materialise()[key] = value

    def get(self, key, default=None):
        return self._materialise().get(key, default)

    def __contains__(self, key):
        return key in self._materialise()

    def __iter__(self):
        return iter(self._materialise())

    def __len__(self):
        return len(self._materialise())

    def keys(self):
        return self._materialise().keys()

    def values(self):
        return self._materialise().values()

    def items(self):
        return self._materialise().items()

    def __eq__(self, other):
        if isinstance(other, MatchRuns):
            other = other._materialise()
        if isinstance(other, dict):
            return self._materialise() == other
        return NotImplemented

    __hash__ = None  # mutable mapping semantics, like dict

    def __bool__(self):
        return True  # a match result is always a non-empty mapping

    def __repr__(self):
        return repr(self._materialise())


class SegmentMatcher:
    """Batched HMM matcher bound to one road network and one device.

    ``native`` picks the host prep and assembly: the C++ host runtime
    (default; built with g++ at first use, and a failed build raises) or
    numpy. ``pipeline`` runs decode and assembly on the two device lanes,
    overlapped with prep; ``False`` runs them inline. ``prep_threads``
    is the native prep's worker count (default the host's cores, at most
    ``PREP_THREADS_MAX``); ``chunk`` the traces per prep call and decode
    launch (default 128 with the lanes on a multi-core host, where chunks
    are the overlap's grain, else 512). None of these changes a result.

    ``route_device=True`` moves the native prep's route costs onto the
    matcher's device (``graph.route_device.DeviceRouteKernel``, built
    here: on the card its kernels compile now, and a failure raises); the
    numpy prep keeps its host routes. ``prune_sigma`` > 0 prunes each
    kept point's candidates beyond ``prune_sigma * effective_sigma``
    meters of its best, on both preps; unlike the options above it
    changes results.

    ``incremental`` turns on :meth:`match_incremental`'s carried decode
    state (``incremental_table``, built at first use); ``incremental_lag``
    is the most uncommitted steps a trace carries (at least 2) and
    ``incremental_mb`` the table's byte budget in MiB. They choose a
    path, never a result.
    """

    def __init__(self, net: Optional[RoadNetwork] = None,
                 params: Optional[MatchParams] = None, device=None,
                 native: bool = True, pipeline: bool = True,
                 prep_threads: Optional[int] = None,
                 chunk: Optional[int] = None, route_device: bool = False,
                 prune_sigma: float = 0.0, incremental: bool = True,
                 incremental_lag: int = DEFAULT_LAG,
                 incremental_mb: float = DEFAULT_BUDGET_MB):
        self.device = resolve_device(device)
        if net is None:
            raise ValueError("no network: pass net=")
        if prune_sigma < 0:
            raise ValueError(f"prune_sigma={prune_sigma} must be >= 0")
        self.net = net
        self.params = params if params is not None else MatchParams()
        self.prune_sigma = float(prune_sigma)
        cores = os.cpu_count() or 1
        self.prep_threads = (prep_threads if prep_threads is not None
                             else min(PREP_THREADS_MAX, cores))
        self.chunk = chunk if chunk is not None else (
            128 if pipeline and cores > 1 else 512)
        self.runtime = (NativeRuntime(net, cell_m=GRID_CELL_M) if native
                        else None)
        self.route_kernel = (
            device_routes.DeviceRouteKernel(net, self.device)
            if route_device and native else None)
        #: wall seconds per stage, summed over calls (callers may reset).
        #: With the lanes on, the stages overlap and do not sum to the
        #: wall; "decode" is the dispatch lane's upload, launch and copy
        #: enqueue plus the drain lane's wait for the paths
        self.stage_seconds = {"prep": 0.0, "decode": 0.0, "assemble": 0.0}
        self._stage_lock = threading.Lock()
        #: bucket T -> [kept points, padded point cells] over every native
        #: chunk decoded so far: the padding waste _split_bucket consults
        self.bucket_totals: dict[int, list] = {}
        self.incremental = bool(incremental)
        self.incremental_lag = int(incremental_lag)
        self.incremental_mb = float(incremental_mb)
        self._incremental_table: Optional[IncrementalTable] = None
        self._incremental_lock = threading.Lock()
        # two single-worker FIFO lanes; their threads start on first submit
        self._lanes = ((ThreadPoolExecutor(1, "device-dispatch"),
                        ThreadPoolExecutor(1, "device-drain"))
                       if pipeline else None)

    @cached_property
    def grid(self) -> SpatialGrid:
        return SpatialGrid(self.net, cell_m=GRID_CELL_M)

    @cached_property
    def route_cache(self) -> RouteCache:
        return RouteCache(self.net)

    @property
    def incremental_table(self) -> IncrementalTable:
        """The carried per-trace decode state (built at first use)."""
        with self._incremental_lock:
            if self._incremental_table is None:
                self._incremental_table = IncrementalTable(
                    self, lag=self.incremental_lag,
                    budget_mb=self.incremental_mb)
            return self._incremental_table

    def _prune_margin(self, params: MatchParams) -> float:
        """Candidate pruning margin in meters for ``params`` (0: off)."""
        return self.prune_sigma * float(params.effective_sigma)

    def _add_stage(self, name: str, t0: float) -> None:
        dt = time.perf_counter() - t0
        with self._stage_lock:
            self.stage_seconds[name] += dt

    # -- single-trace, reference-shaped API --------------------------------
    def Match(self, trace_json: str) -> str:
        trace = json.loads(trace_json)
        result = self.match_many([trace])[0]
        if isinstance(result, MatchRuns):
            return render_segments_json(result.cols, result.lo, result.hi,
                                        result.mode)
        return json.dumps(result, separators=(",", ":"))

    # -- batched path ------------------------------------------------------
    def prepare_many(self, traces,
                     params: Optional[MatchParams] = None
                     ) -> List[PreparedTrace]:
        """Numpy host prep alone (candidates, kept points, route tensors)
        for a batch of traces, under one set of params."""
        params = params if params is not None else self.params
        return prepare_traces_numpy(
            self.net, self.grid, as_trace_batch(traces), params,
            self.route_cache, self._prune_margin(params))

    def match_many(self, traces) -> list:
        """Match a batch of traces; returns one match per trace, in order:
        :class:`MatchRuns` on the native path, dicts on the numpy path.

        ``traces`` is a columnar :class:`TraceBatch` or a sequence of
        request dicts ({"uuid", "trace": [{lat, lon, time, ...}],
        "match_options"}), converted to columns once at this edge.
        Per-trace match_options may override params; a TraceBatch with one
        shared options dict resolves params once for the whole batch.
        """
        tb = as_trace_batch(traces)
        ntr = len(tb)
        per_trace_params = self._trace_params(tb)

        results: list = [None] * ntr
        futures = []
        if self._lanes is not None:
            dispatch_lane, drain_lane = self._lanes

            def submit(batch, order, sigma, beta):
                d_fut = dispatch_lane.submit(self._dispatch_stage, batch,
                                             sigma, beta)
                futures.append((d_fut, drain_lane.submit(
                    self._drain_stage, batch, order, d_fut,
                    per_trace_params, results)))
        else:
            def submit(batch, order, sigma, beta):
                self._drain_stage(batch, order,
                                  self._dispatch_stage(batch, sigma, beta),
                                  per_trace_params, results)

        try:
            if self.runtime is not None:
                self._dispatch_native(tb, per_trace_params, submit)
            else:
                self._dispatch_numpy(tb, per_trace_params, submit)
        except BaseException:
            # a prep failure quiesces the lanes before it propagates, so
            # later chunks do not go on decoding discarded work: cancel
            # everything still queued first (waiting pair by pair would
            # let the lanes dequeue later chunks), then wait out the rest
            running = [f for pair in futures for f in reversed(pair)
                       if not f.cancel()]
            for f in running:
                try:
                    f.result()
                except BaseException:
                    pass
            raise
        # drain every chunk, then raise the first failure in submission
        # order; a dispatch failure re-raises out of its drain future
        first_err = None
        for _d_fut, a_fut in futures:
            try:
                a_fut.result()
            except BaseException as e:
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return results

    def match_incremental(self, traces) -> list:
        """Match through carried per-trace decode state where it can.

        Same input as :meth:`match_many`. Each trace with a uuid advances
        its carried state (``incremental_table``) by the points appended
        since its last report: O(K) device work per appended kept point
        instead of a whole-window decode. Returns one match dict per trace,
        in order, and None for each trace this path declines: no uuid,
        ``incremental=False``, a window it cannot reproduce byte for byte
        (past the largest bucket, out of the f16 wire's range, a lag window
        that does not converge), or an evicted state. A caller sends those
        through :meth:`match_many`, whose bytes are the same
        (``tests/test_torch_incremental.py``). An error raises: there is
        no breaker here and nothing degrades.
        """
        tb = as_trace_batch(traces)
        ntr = len(tb)
        results: list = [None] * ntr
        if ntr == 0:
            return results
        if not self.incremental:
            return results
        with metrics.timer("match.incremental.advance"):
            self.incremental_table.match_many(tb, self._trace_params(tb),
                                              results)
        return results

    def _trace_params(self, tb: TraceBatch) -> list:
        """Each trace's MatchParams: the matcher's, with its own
        match_options applied (one shared options dict resolves once)."""
        ntr = len(tb)
        opts = tb.options
        if opts is None:
            return [self.params] * ntr
        if isinstance(opts, dict):
            return [self.params.with_options(opts)] * ntr
        return [self.params.with_options(o) if o else self.params
                for o in opts]

    # every param that shapes the prepared tensors or the assembly: traces
    # may only share one prep chunk (and one device batch) when all of
    # these agree; sigma/beta ride along because they are batch-wide
    # scalars on the device
    _PREP_KEY_FIELDS = (
        "effective_sigma", "beta", "max_candidates", "search_radius",
        "interpolation_distance", "breakage_distance",
        "max_route_distance_factor", "backward_tolerance_m",
        "max_route_time_factor", "min_time_bound_s", "turn_penalty_factor",
        "queue_speed_threshold_kph")

    def _param_groups(self, per_trace_params):
        """[(params, index array)] — one group per distinct prep-param
        key, insertion-ordered. The steady state (one params object for
        the whole batch) is an identity scan."""
        ntr = len(per_trace_params)
        if ntr == 0:
            return []
        p0 = per_trace_params[0]
        if all(p is p0 for p in per_trace_params):
            return [(p0, np.arange(ntr, dtype=np.int64))]
        keyed: dict[tuple, tuple] = {}
        for i, p in enumerate(per_trace_params):
            key = tuple(getattr(p, f) for f in self._PREP_KEY_FIELDS)
            got = keyed.get(key)
            if got is None:
                keyed[key] = (p, [i])
            else:
                got[1].append(i)
        return [(p, np.asarray(idxs, dtype=np.int64))
                for p, idxs in keyed.values()]

    def _dispatch_native(self, tb: TraceBatch, per_trace_params,
                         submit) -> None:
        """Group by prep params, bucket by raw length, split buckets whose
        padding waste pays for it, then ONE native prep call per chunk on
        this thread, each prepared chunk handed to ``submit``. Raw length
        bounds the kept length, so a jitter-heavy trace may decode in a
        larger bucket than on the numpy path: same path, the SKIP tail is
        inert."""
        chunk = self.chunk
        buckets = np.asarray(LENGTH_BUCKETS, dtype=np.int64)
        raw_counts = tb.lengths()
        Ts = buckets[np.minimum(
            np.searchsorted(buckets, np.maximum(raw_counts, 1)),
            len(buckets) - 1)]
        for params, idxs in self._param_groups(per_trace_params):
            sigma = np.float32(params.effective_sigma)
            beta = np.float32(params.beta)
            for T0 in np.unique(Ts[idxs]).tolist():
                group = idxs[Ts[idxs] == T0]
                for T, bucket in self._split_bucket(int(T0), group,
                                                    raw_counts):
                    for lo in range(0, len(bucket), chunk):
                        part = bucket[lo:lo + chunk]
                        rows = padded_batch_rows(len(part))
                        t0 = time.perf_counter()
                        batch = prepare_batch(
                            self.runtime, tb.gather(part), params, T,
                            pad_rows=rows, n_threads=self.prep_threads,
                            route_kernel=self.route_kernel,
                            defer_routes=True,
                            prune_margin_m=self._prune_margin(params))
                        self._add_stage("prep", t0)
                        tot = self.bucket_totals.setdefault(T, [0, 0])
                        tot[0] += kept_point_count(batch)
                        tot[1] += rows * T
                        submit(batch, part, sigma, beta)

    def _padded_cells(self, n: int, T: int) -> int:
        """Point cells ``n`` traces of bucket ``T`` decode as, chunked as
        the dispatch loop chunks them (each chunk padded to pow2 rows)."""
        cells = 0
        while n > 0:
            take = min(n, self.chunk)
            cells += padded_batch_rows(take) * T
            n -= take
        return cells

    def _split_bucket(self, T: int, group, raw_counts):
        """``[(sub_T, index array)]`` for one bucket's group, ``[(T,
        group)]`` when no split pays. A split sends each trace to the
        smallest power of two >= its raw length (clipped to [smallest
        bucket, T]) when the padding waste of decoding all at T exceeds
        ``SPLIT_WASTE``. The waste is the larger of a projection from the
        raw lengths (kept <= raw, so it never over-splits) and the waste
        recorded for T in ``bucket_totals`` (which sees jitter drops),
        and a split must cut the padded cells, pow2 row padding
        included."""
        if len(group) < 2 or T <= LENGTH_BUCKETS[0]:
            return [(T, group)]
        raws = np.minimum(raw_counts[group], T)
        cells_unsplit = self._padded_cells(len(group), T)
        waste = 1.0 - float(raws.sum()) / cells_unsplit
        tot = self.bucket_totals.get(T)
        if tot is not None and tot[1]:
            waste = max(waste, 1.0 - tot[0] / tot[1])
        if waste <= SPLIT_WASTE:
            return [(T, group)]
        subTs = np.minimum(np.maximum(
            np.exp2(np.ceil(np.log2(np.maximum(raws, 1))))
            .astype(np.int64), LENGTH_BUCKETS[0]), T)
        uniq, counts = np.unique(subTs, return_counts=True)
        if uniq.tolist() == [T]:
            return [(T, group)]
        cells_split = sum(self._padded_cells(int(c), int(s))
                          for s, c in zip(uniq.tolist(), counts.tolist()))
        if cells_split >= cells_unsplit:
            return [(T, group)]
        return [(int(s), group[subTs == s]) for s in uniq.tolist()]

    def _dispatch_numpy(self, tb: TraceBatch, per_trace_params,
                        submit) -> None:
        """numpy prep: one vectorised candidate search per chunk, route
        tensors per trace through the shared route cache, then
        ``pack_batches`` (one batch per bucket, exactly its traces)."""
        chunk = self.chunk
        for params, idxs in self._param_groups(per_trace_params):
            sigma = np.float32(params.effective_sigma)
            beta = np.float32(params.beta)
            for lo in range(0, len(idxs), chunk):
                part = idxs[lo:lo + chunk]
                t0 = time.perf_counter()
                prepped = prepare_traces_numpy(
                    self.net, self.grid, tb.gather(part), params,
                    self.route_cache, self._prune_margin(params))
                self._add_stage("prep", t0)
                idx_of = {id(p): int(i) for p, i in zip(prepped, part)}
                for batch in pack_batches(prepped):
                    submit(batch, [idx_of[id(p)] for p in batch.traces],
                           sigma, beta)

    def _dispatch_stage(self, batch: PaddedBatch, sigma, beta):
        """Dispatch lane: settle deferred device routes
        (``finalize_wire``), upload one batch, launch the decode and, on
        the card, start a non-blocking copy of the paths into pinned host
        memory recorded on a CUDA event, and one of the deferred route
        tensor behind it. Returns ``(paths on the host,
        event or None, device paths)``; the device paths ride along so
        they stay alive until the drain lane has waited on the event.
        Everything runs on the device's current stream."""
        t0 = time.perf_counter()
        batch.finalize_wire()
        # numpy arrays, but for a device route tensor (already a tensor on
        # this device)
        arrays = tuple(a if isinstance(a, torch.Tensor)
                       else torch.from_numpy(a)
                       for a in (batch.dist_m, batch.valid, batch.route_m,
                                 batch.gc_m, batch.case))
        if self.device.type == "cpu":
            paths, _scores = ops.decode_batch(*arrays, sigma, beta)
            self._add_stage("decode", t0)
            return paths, None, None
        with torch.cuda.device(self.device):
            # whole arrays, filler rows included: each upload (and the
            # device route tensor) is a fresh allocation, which starts on
            # 16 bytes as the kernel needs
            x = tuple(a.to(self.device) for a in arrays)
            paths, _scores = ops.decode_batch(*x, sigma, beta)
            host = torch.empty(paths.shape, dtype=paths.dtype,
                               pin_memory=True)
            host.copy_(paths, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            if batch.routes is not None:
                # device routes: their copy back queues behind the decode
                batch.routes.copy_back_async()
        self._add_stage("decode", t0)
        return host, event, paths

    def _drain_stage(self, batch: PaddedBatch, order, decoded,
                     per_trace_params, results) -> None:
        """Drain lane: wait for one batch's paths, then assemble them into
        the ``results`` slots named by ``order`` (row b is trace
        ``order[b]``). ``decoded`` is the dispatch stage's return, or a
        future of it on the lanes."""
        if hasattr(decoded, "result"):
            decoded = decoded.result()
        host, event, _dev_paths = decoded
        if event is not None:
            t0 = time.perf_counter()
            event.synchronize()
            self._add_stage("decode", t0)
        paths = host.numpy()
        t0 = time.perf_counter()
        if batch.prep is not None:
            # native batched assembly: ONE call walks every path of the
            # batch; the results are lazy views over one RunColumns. It
            # reads the route bytes, so deferred device routes land first
            batch.routes_to_host()
            B = len(batch.traces)
            gp = per_trace_params[order[0]]
            runs = self.runtime.assemble_batch(
                paths[:B], batch.prep, batch.pt_off, batch.times_flat,
                queue_threshold_kph=gp.queue_speed_threshold_kph,
                interpolation_distance_m=gp.interpolation_distance,
                backward_tolerance_m=gp.backward_tolerance_m,
                turn_penalty_factor=gp.turn_penalty_factor)
            ro = runs["run_off"].tolist()
            cols = RunColumns(runs)
            # the chunk's layout for the batch writer: per-trace run spans
            # and last point times, so the first /report body of this
            # chunk emits every trace's body in one C call
            cols.arrays["_run_off"] = runs["run_off"]
            cols.arrays["_trace_end"] = np.ascontiguousarray(
                batch.times_flat[batch.pt_off[1:] - 1])
            for b, i in enumerate(order):
                results[i] = MatchRuns(cols, ro[b], ro[b + 1],
                                       per_trace_params[i].mode)
        else:
            for b, i in enumerate(order):
                q = per_trace_params[i]
                results[i] = assemble_segments(
                    self.net, batch.traces[b], paths[b], mode=q.mode,
                    queue_threshold_kph=q.queue_speed_threshold_kph,
                    interpolation_distance_m=q.interpolation_distance,
                    backward_tolerance_m=q.backward_tolerance_m,
                    turn_penalty_factor=q.turn_penalty_factor)
        self._add_stage("assemble", t0)
