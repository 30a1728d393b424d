"""The plain reference's entry: one trace's raw points to its match, its
datastore reports and its tile rows, in NumPy, one trace at a time.

The steps are the port's numpy path, frozen here: candidates by the
uniform grid, kept points, bounded route searches, the Viterbi decode at
the configuration's precision (or the control's), path assembly and the
reporter's pairwise emission. It takes only the network's column arrays
and the points, never anything the program made.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np

from .assemble import assemble_segments
from .consts import GRID_CELL_M
from .decode import on_wire, viterbi_decode_numpy
from .network import network_from_arrays
from .params import MatchParams
from .prep import _f16_safe, _prepare_from_candidates
from .report import _window_spans, emit_rows, report_body
from .route import RouteCache
from .spatial import PAD_EDGE, SpatialGrid


class Reference:
    """A network's reference matcher. ``params`` holds MatchParams
    fields; ``precision`` is the wire's: ``"float16"`` (the configuration's)
    or ``"float8_e5m2"`` (the control)."""

    def __init__(self, arrays: dict, params: dict,
                 precision: str = "float16"):
        self.net = network_from_arrays(arrays)
        self.grid = SpatialGrid(self.net, GRID_CELL_M)
        self.cache = RouteCache(self.net)
        self.params = MatchParams(**params)
        self.precision = precision

    def match(self, lat, lon, times) -> dict:
        """The match dict (``segments``, ``mode``) of one trace."""
        p = self.params
        lat = np.asarray(lat, dtype=np.float64)
        lon = np.asarray(lon, dtype=np.float64)
        times = np.asarray(times, dtype=np.float64)
        cands = self.grid.candidates(lat, lon, p.max_candidates,
                                     p.search_radius)
        has = (cands.edge_ids != PAD_EDGE).any(axis=1)
        prep = _prepare_from_candidates(self.net, lat, lon, times, cands,
                                        has, p, self.cache, 0.0)
        if prep.num_kept == 0:
            return {"segments": [], "mode": p.mode}
        dist, route, gc = on_wire(prep.dist_m, prep.route_m, prep.gc_m,
                                  _f16_safe(prep), self.precision)
        path, _score = viterbi_decode_numpy(
            dist, prep.edge_ids != PAD_EDGE, route, gc, prep.case,
            p.effective_sigma, p.beta)
        return assemble_segments(
            self.net, prep, path, mode=p.mode,
            queue_threshold_kph=p.queue_speed_threshold_kph,
            interpolation_distance_m=p.interpolation_distance,
            backward_tolerance_m=p.backward_tolerance_m,
            turn_penalty_factor=p.turn_penalty_factor)

    def answer(self, lat, lon, times, threshold_sec: float,
               report_levels: Iterable[int],
               transition_levels: Iterable[int]) -> dict:
        """The trace's ``/report`` answer: ``stats``, ``shape_used``,
        ``datastore.reports`` (the embedded match left out)."""
        return report_body(self.match(lat, lon, times), float(times[-1]),
                           threshold_sec, report_levels, transition_levels)

    def reports(self, lat, lon, times, threshold_sec: float,
                report_levels: Iterable[int],
                transition_levels: Iterable[int]) -> List[dict]:
        """The trace's ``datastore.reports``, as ``/report`` answers them."""
        return self.answer(lat, lon, times, threshold_sec, report_levels,
                           transition_levels)["datastore"]["reports"]

    def vehicle_rows(self, lat, lon, times, pipe: dict) -> dict:
        """{tile file: [row, ...]} the batched pipeline writes for one
        vehicle's probes (sorted by time): its windows in time order, each
        window's reports, the seam dedupe (reports at or below the
        vehicle's highest emitted t0 dropped), the tile rows. ``pipe``
        holds the stage's arguments (``inactivity``, ``threshold_sec``,
        ``report_levels``, ``transition_levels``, ``quantisation``,
        ``source``, ``mode``)."""
        times = np.asarray(times, dtype=np.float64)
        tiles: dict = {}
        floor = None
        for a, b in _window_spans(times, pipe["inactivity"],
                                  holdback_s=pipe["threshold_sec"]):
            reps = self.reports(lat[a:b], lon[a:b], times[a:b],
                                pipe["threshold_sec"], pipe["report_levels"],
                                pipe["transition_levels"])
            if floor is not None:
                reps = [r for r in reps if r["t0"] > floor]
            if reps:
                floor = max(r["t0"] for r in reps)
            emit_rows(reps, times[a:b], pipe["quantisation"], pipe["source"],
                      pipe["mode"], tiles)
        return tiles


def report_key(r: dict) -> tuple:
    """A datastore report as a comparable tuple: ids, times, length,
    queue (a missing ``next_id`` is None)."""
    nx = r.get("next_id")
    return (int(r["id"]), None if nx is None else int(nx), float(r["t0"]),
            float(r["t1"]), int(r["length"]), int(r["queue_length"]))


def same_answer(got: dict, want: dict, tol_s: float = 1e-6) -> bool:
    """Equal ``/report`` answers: the same stats and ``shape_used``, and
    :func:`same_reports`."""
    return (got.get("stats") == want["stats"]
            and got.get("shape_used") == want.get("shape_used")
            and same_reports(got["datastore"]["reports"],
                             want["datastore"]["reports"], tol_s))


def same_reports(got: list, want: list, tol_s: float = 1e-6) -> bool:
    """Equal report lists: the same ids, lengths and queues in the same
    order, times within ``tol_s``."""
    if len(got) != len(want):
        return False
    for a, b in zip(map(report_key, got), map(report_key, want)):
        if a[:2] != b[:2] or a[4:] != b[4:] \
                or abs(a[2] - b[2]) > tol_s or abs(a[3] - b[3]) > tol_s:
            return False
    return True
