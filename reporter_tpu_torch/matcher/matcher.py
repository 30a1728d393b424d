"""SegmentMatcher: the matcher facade.

Surface of the reference's ``valhalla`` extension module:

    m = SegmentMatcher(net)
    match_json = m.Match(trace_json_str)

plus the batched entry point ``match_many``: many traces prepared on the
host, decoded in one batched Viterbi per padding bucket on the card.

A call runs three stages in order on the calling thread, one chunk of
traces at a time: host prep (numpy candidate search, kept-point
selection, case codes and route tensors; ``batchpad``), device decode
(``ops.decode_batch``, the CUDA kernel on the card), and assembly of the
decoded paths into OSMLR segment runs (``assemble``). A decode failure
raises; nothing falls back to another decoder.
"""
from __future__ import annotations

import json
import time
from typing import List, Optional

import numpy as np
import torch

from .. import ops
from ..core.tracebatch import TraceBatch, as_trace_batch
from ..graph.network import RoadNetwork
from ..graph.route import RouteCache
from ..graph.spatial import SpatialGrid
from .assemble import assemble_segments
from .batchpad import (PaddedBatch, PreparedTrace, pack_batches,
                       prepare_traces_numpy)
from .params import MatchParams

#: traces per prep + decode chunk: the service's batch
DECODE_CHUNK = 512
#: spatial grid cell, ~1.5x the default 50 m search radius: reach stays 1
#: (a 3x3 cell scan) while each cell holds few edges
GRID_CELL_M = 75.0


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


class SegmentMatcher:
    """Batched HMM matcher bound to one road network and one device."""

    def __init__(self, net: Optional[RoadNetwork] = None,
                 params: Optional[MatchParams] = None, device=None):
        self.device = resolve_device(device)
        if net is None:
            raise ValueError("no network: pass net=")
        self.net = net
        self.params = params if params is not None else MatchParams()
        self.grid = SpatialGrid(net, cell_m=GRID_CELL_M)
        self.route_cache = RouteCache(net)
        #: wall seconds per stage, summed over calls (callers may reset)
        self.stage_seconds = {"prep": 0.0, "decode": 0.0, "assemble": 0.0}

    # -- single-trace, reference-shaped API --------------------------------
    def Match(self, trace_json: str) -> str:
        trace = json.loads(trace_json)
        return json.dumps(self.match_many([trace])[0], separators=(",", ":"))

    # -- batched path ------------------------------------------------------
    def prepare_many(self, traces,
                     params: Optional[MatchParams] = None
                     ) -> List[PreparedTrace]:
        """Host prep alone (candidates, kept points, route tensors) for a
        batch of traces, under one set of params."""
        return prepare_traces_numpy(
            self.net, self.grid, as_trace_batch(traces),
            params if params is not None else self.params, self.route_cache)

    def match_many(self, traces) -> List[dict]:
        """Match a batch of traces; returns match dicts in order.

        ``traces`` is a columnar :class:`TraceBatch` or a sequence of
        request dicts ({"uuid", "trace": [{lat, lon, time, ...}],
        "match_options"}), converted to columns once at this edge.
        Per-trace match_options may override params; a TraceBatch with one
        shared options dict resolves params once for the whole batch.
        """
        tb = as_trace_batch(traces)
        ntr = len(tb)
        opts = tb.options
        if opts is None:
            per_trace_params = [self.params] * ntr
        elif isinstance(opts, dict):
            per_trace_params = [self.params.with_options(opts)] * ntr
        else:
            per_trace_params = [
                self.params.with_options(o) if o else self.params
                for o in opts]

        results: List[Optional[dict]] = [None] * ntr
        for params, idxs in self._param_groups(per_trace_params):
            for lo in range(0, len(idxs), DECODE_CHUNK):
                self._match_chunk(tb, idxs[lo:lo + DECODE_CHUNK], params,
                                  per_trace_params, results)
        return results

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

    def _match_chunk(self, tb: TraceBatch, part, params: MatchParams,
                     per_trace_params, results) -> None:
        """Prep one chunk, then decode and assemble each of its padded
        batches, writing into the ``results`` slots named by ``part``."""
        t0 = time.perf_counter()
        prepped = prepare_traces_numpy(self.net, self.grid, tb.gather(part),
                                       params, self.route_cache)
        self.stage_seconds["prep"] += time.perf_counter() - t0
        sigma = np.float32(params.effective_sigma)
        beta = np.float32(params.beta)
        idx_of = {id(p): int(i) for p, i in zip(prepped, part)}
        for batch in pack_batches(prepped):
            paths = self.decode(batch, sigma, beta)
            t0 = time.perf_counter()
            for b, p in enumerate(batch.traces):
                i = idx_of[id(p)]
                q = per_trace_params[i]
                results[i] = assemble_segments(
                    self.net, p, paths[b], mode=q.mode,
                    queue_threshold_kph=q.queue_speed_threshold_kph,
                    interpolation_distance_m=q.interpolation_distance,
                    backward_tolerance_m=q.backward_tolerance_m,
                    turn_penalty_factor=q.turn_penalty_factor)
            self.stage_seconds["assemble"] += time.perf_counter() - t0

    def decode(self, batch: PaddedBatch, sigma, beta) -> np.ndarray:
        """Decode one padded batch on the matcher's device; returns the
        (B, T) int32 paths on the host."""
        t0 = time.perf_counter()
        dist, valid, route, gc, case = (
            torch.from_numpy(a).to(self.device)
            for a in (batch.dist_m, batch.valid, batch.route_m, batch.gc_m,
                      batch.case))
        paths, _scores = ops.decode_batch(dist, valid, route, gc, case,
                                          sigma, beta)
        out = paths.cpu().numpy()
        self.stage_seconds["decode"] += time.perf_counter() - t0
        return out
