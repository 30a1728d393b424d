"""Frozen copy of the port's ``reporter_tpu_torch/matcher/params.py`` (the plain
reference of the benchmark; imports nothing of the program).

Matcher tuning knobs, named after the reference's configuration keys.

Defaults mirror the reference deployment (reference: Dockerfile:14-17,
py/generate_test_trace.py:45-52): sigma_z 4.07, beta 3,
max-route-distance-factor 5, search_radius 50 m, breakage_distance 2000 m.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class MatchParams:
    mode: str = "auto"
    sigma_z: float = 4.07              # emission Gaussian std, meters
    beta: float = 3.0                  # transition exponential scale
    max_route_distance_factor: float = 5.0
    max_route_time_factor: float = 2.0
    # floor on the time-admissibility cap max(floor, factor*dt), the time
    # analog of the 500 m floor on the distance bound: at 1 Hz sampling
    # factor*dt is ~2 s, which GPS projection noise alone overruns, so an
    # unfloored bound prunes honest transitions instead of absurd detours.
    # The floor is sized to NOISE-scale jumps, not the full distance
    # bound: a projection hop of ~100 m at a slow-but-moving 25 km/h
    # takes ~15 s, so 15 s keeps every honest noise-induced route while
    # pruning teleports (e.g. 250 m of 30 km/h road "travelled" between
    # 1 Hz probes). The previous 60 s floor — sized to the 500 m distance
    # floor at 30 km/h — made the bound nearly inert at defaults: it only
    # ever pruned sub-30 km/h crawls sustained for a full minute.
    min_time_bound_s: float = 15.0
    breakage_distance: float = 2000.0  # meters; larger probe gaps split the HMM
    search_radius: float = 50.0        # meters candidate search radius
    turn_penalty_factor: float = 0.0
    gps_accuracy: float = 0.0          # >0 widens sigma to at least accuracy/1.96
    max_candidates: int = 8            # K, fixed width of candidate tensors
    # points closer than this to the last kept point are excluded from the
    # HMM and interpolated onto the decoded path afterwards — Meili's cure
    # for GPS jitter flipping the matched direction of travel
    interpolation_distance: float = 10.0
    # apparent backward movement along the same directed edge up to this
    # many meters is priced as staying put rather than as a loop around the
    # block; suppresses one-point flickers onto the co-located reverse edge
    # (see graph/route.py route_distance)
    backward_tolerance_m: float = 25.0
    # observed speeds below this mark queued traffic: queue_length is the
    # distance from the segment end occupied by the slow tail (reference:
    # README.md:283 defines the field; the C++ matcher's threshold constant
    # is not published, so it is a knob here)
    queue_speed_threshold_kph: float = 10.0

    def with_options(self, options: dict) -> "MatchParams":
        """Apply per-request ``match_options`` overrides by reference name
        (reference: generate_test_trace.py:45-52).

        Returns ``self`` when every override already equals the current
        value — the common case (e.g. mode=auto on every request), and
        what lets match_many group such traces into one prep/decode batch
        without building 512 identical frozen dataclasses per call."""
        fields = {}
        for key in ("mode", "sigma_z", "beta", "breakage_distance",
                    "search_radius", "turn_penalty_factor", "gps_accuracy",
                    "max_route_distance_factor", "max_route_time_factor"):
            if key in options and options[key] != getattr(self, key):
                fields[key] = options[key]
        return replace(self, **fields) if fields else self

    @property
    def effective_sigma(self) -> float:
        if self.gps_accuracy and self.gps_accuracy > 0:
            return max(self.sigma_z, self.gps_accuracy / 1.96)
        return self.sigma_z
