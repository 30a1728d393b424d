"""The one traffic generator: a fleet of vehicles driving a grid city.

A mix is a data file, ``portbench/traffic/<mix>.json``, of parameters this
module reads; nothing about one mix is code. The fleet's sizes (how many
trips each vehicle drives, how long each trip and each stop lasts, its
speed factor, when it starts) and its routes are drawn from the mix's own
``shape_seed``, so every run seed drives the same streets on the same
vehicles and gives the units of work, cut by vehicle, the same size and
the same route searches; the run's ``--seed`` draws only the probe
phases (where along its route each probe falls) and the position noise.
Two runs of one seed give the same probes. A second fleet of one mix
(``stream``) drives other routes, for warm-up traffic that is none of
the measured stream's.

A vehicle drives a random walk over the grid's streets (straight on, or a
turn with probability ``turn_p``; never a U-turn but in a corner) at its
speed factor times each street's speed (80/60/40 km/h by level, as the
city builder sets them). It reports a probe every ``probe_interval_s``
while it drives, with iid Gaussian noise of ``noise_m`` on each axis, and
none while it stops between trips. Positions are rounded to 1e-6 degree
and times to whole seconds, as the text formats carry them.

The ``[worker]`` and ``[pipeline]`` stream writers of ``chip_smoke.py``
(``write_worker_stream``, ``write_pipeline_archive``) routed each trip by
a host shortest-path search per vehicle, about 100 s of Python for 512
vehicles; this generator is vectorised over the fleet instead.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

import numpy as np

from ..ref.geo import local_meters_projection

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the city builder's street speeds by level (``ref/city.py``)
LEVEL_KPH = np.array([80.0, 60.0, 40.0])
#: the first probe's epoch second: 2017-07-14, as the upstream's archives
EPOCH0 = 1_500_000_000


def load_mix(name: str) -> dict:
    """The parameters of the mix ``name``."""
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def street_level(index: np.ndarray) -> np.ndarray:
    """The city builder's level of a row or column: 0 every 8th, 1 every
    4th, else 2."""
    return np.where(index % 8 == 0, 0, np.where(index % 4 == 0, 1, 2))


@dataclass
class Fleet:
    """The probes of every vehicle, sorted by (vehicle, time):
    ``vehicle`` (n,) i32, ``time`` (n,) i64, ``lat``/``lon`` (n,) f64,
    ``accuracy`` the one accuracy every probe carries, ``offsets``
    (V+1,) the vehicles' spans."""
    vehicle: np.ndarray
    time: np.ndarray
    lat: np.ndarray
    lon: np.ndarray
    accuracy: int
    offsets: np.ndarray

    @property
    def vehicles(self) -> int:
        return len(self.offsets) - 1

    def __len__(self) -> int:
        return len(self.time)


def _uniform(rng, lohi, n):
    lo, hi = lohi
    return rng.uniform(lo, hi, n)


def _sizes(mix: dict):
    """The fleet's sizes from the mix's own seed: per vehicle its trips'
    durations and the stops after them (lists of arrays), its speed
    factor and its start offset."""
    rng = np.random.default_rng(int(mix["shape_seed"]))
    V = int(mix["vehicles"])
    long_every = int(mix.get("long_shift_every", 0))
    trips = rng.integers(mix["trips"][0], mix["trips"][1] + 1, V)
    if long_every:
        # exactly one vehicle in long_shift_every drives a long shift
        longs = rng.permutation(V)[:V // long_every]
        trips[longs] = rng.integers(mix["long_shift_trips"][0],
                                    mix["long_shift_trips"][1] + 1,
                                    len(longs))
    drive = [_uniform(rng, mix["trip_s"], int(k)) for k in trips]
    stop = [_uniform(rng, mix["stop_s"], int(k)) for k in trips]
    speed = _uniform(rng, mix["speed_factor"], V)
    start = _uniform(rng, (0.0, float(mix["start_spread_s"])), V)
    return drive, stop, speed, start


def _walk(grid: dict, speed: np.ndarray, need_s: np.ndarray, rng,
          turn_p: float):
    """Random walks until each vehicle has driven ``need_s`` seconds:
    (vehicle, row, col, seconds at the end of the edge) per step of every
    vehicle, the vehicle's start node first (0 seconds)."""
    R, C = int(grid["rows"]), int(grid["cols"])
    V = len(speed)
    r = rng.integers(1, R - 1, V)
    c = rng.integers(1, C - 1, V)
    # direction: 0 east, 1 north, 2 west, 3 south
    d = rng.integers(0, 4, V)
    dr = np.array([0, 1, 0, -1])
    dc = np.array([1, 0, -1, 0])
    spacing = float(grid["spacing_m"])
    clock = np.zeros(V)
    steps = [(np.arange(V), r.copy(), c.copy(), clock.copy())]
    active = np.arange(V)
    while active.size:
        ra, ca, da = r[active], c[active], d[active]
        u = rng.random(active.size)
        # straight, left or right by turn_p; U-turn only when boxed in
        pref = np.where(u < turn_p / 2, (da + 1) % 4,
                        np.where(u < turn_p, (da + 3) % 4, da))
        order = np.stack([pref, da, (da + 1) % 4, (da + 3) % 4,
                          (da + 2) % 4], axis=1)
        nd = order[:, -1].copy()
        chosen = np.zeros(active.size, bool)
        for k in range(order.shape[1]):
            cand = order[:, k]
            rr, cc = ra + dr[cand], ca + dc[cand]
            ok = ~chosen & (rr >= 0) & (rr < R) & (cc >= 0) & (cc < C)
            nd[ok] = cand[ok]
            chosen |= ok
        nr, nc = ra + dr[nd], ca + dc[nd]
        # the street driven: a row for east/west, a column for north/south
        level = np.where(nd % 2 == 0, street_level(ra), street_level(ca))
        mps = LEVEL_KPH[level] / 3.6 * speed[active]
        clock[active] += spacing / mps
        r[active], c[active], d[active] = nr, nc, nd
        steps.append((active, nr, nc, clock[active].copy()))
        active = active[clock[active] < need_s[active]]
    veh = np.concatenate([s[0] for s in steps])
    order = np.argsort(veh, kind="stable")
    return (veh[order], np.concatenate([s[1] for s in steps])[order],
            np.concatenate([s[2] for s in steps])[order],
            np.concatenate([s[3] for s in steps])[order])


def fleet(mix: dict, grid: dict, seed: int, stream: int = 0) -> Fleet:
    """Every probe of the mix's fleet ``stream`` on the grid city ``grid``
    (the configuration's ``rows``, ``cols``, ``spacing_m``, ``lat0``,
    ``lon0``) for run seed ``seed``: the routes from the mix's
    ``shape_seed`` and ``stream``, the phases and the noise from
    ``seed`` and ``stream``."""
    drive, stop, speed, start = _sizes(mix)
    V = len(speed)
    route_rng = np.random.default_rng(
        [int(mix["shape_seed"]), int(stream), 0x5e11])
    rng = np.random.default_rng(
        [int(seed) % 2 ** 64, int(stream), 0x7e1e])
    dt = float(mix["probe_interval_s"])

    # probe times: per trip from a random phase every dt, as driving
    # seconds (the walk's clock) and as epoch seconds
    pv, p_drive, p_wall = [], [], []
    for v in range(V):
        d_off = np.concatenate([[0.0], np.cumsum(drive[v])[:-1]])
        w_off = start[v] + np.concatenate(
            [[0.0], np.cumsum(drive[v] + stop[v])[:-1]])
        phase = rng.uniform(0.0, dt, len(drive[v]))
        for d0, w0, dur, ph in zip(d_off, w_off, drive[v], phase):
            k = np.arange(ph, dur, dt)
            pv.append(np.full(len(k), v, np.int32))
            p_drive.append(d0 + k)
            p_wall.append(w0 + k)
    pv = np.concatenate(pv)
    p_drive = np.concatenate(p_drive)
    p_wall = np.concatenate(p_wall)
    need = np.array([float(np.sum(x)) for x in drive])

    sv, sr, sc, st = _walk(grid, speed, need, route_rng,
                           float(mix["turn_p"]))
    # one monotone key over all vehicles: vehicle * H + driving seconds
    H = float(max(need.max(), st.max())) + 10.0
    key = sv * H + st
    pk = pv * H + p_drive
    j = np.searchsorted(key, pk, side="right")  # the step ending after
    a, b = j - 1, j
    frac = (pk - key[a]) / (key[b] - key[a])
    spacing = float(grid["spacing_m"])
    R, C = int(grid["rows"]), int(grid["cols"])

    def xy(rr, cc):
        return ((cc - (C - 1) / 2.0) * spacing,
                (rr - (R - 1) / 2.0) * spacing)

    ax, ay = xy(sr[a], sc[a])
    bx, by = xy(sr[b], sc[b])
    noise = float(mix["noise_m"])
    x = ax + frac * (bx - ax) + rng.normal(0.0, noise, len(pk))
    y = ay + frac * (by - ay) + rng.normal(0.0, noise, len(pk))
    _, to_ll = local_meters_projection(float(grid["lat0"]),
                                       float(grid["lon0"]))
    lat, lon = to_ll(x, y)
    lat = np.round(np.asarray(lat) * 1e6) / 1e6
    lon = np.round(np.asarray(lon) * 1e6) / 1e6
    time = EPOCH0 + np.floor(p_wall).astype(np.int64)
    offsets = np.zeros(V + 1, np.int64)
    np.cumsum(np.bincount(pv, minlength=V), out=offsets[1:])
    accuracy = int(math.ceil(min(100.0, 1.96 * max(1.0, noise))))
    return Fleet(vehicle=pv, time=time, lat=lat, lon=lon,
                 accuracy=accuracy, offsets=offsets)


def windows(fl: Fleet, mix: dict) -> np.ndarray:
    """Cut each vehicle's probes into consecutive report windows of
    ``window_points`` [lo, hi] points (lengths from the mix's own seed; a
    tail shorter than lo is left out). Returns (n, 3) [vehicle, first,
    end) probe indices, in the order of each window's last probe time."""
    lo, hi = mix["window_points"]
    rng = np.random.default_rng([int(mix["shape_seed"]), 1])
    lengths = rng.integers(lo, hi + 1, len(fl) // lo + 1)
    out, k = [], 0
    for v in range(fl.vehicles):
        a, end = int(fl.offsets[v]), int(fl.offsets[v + 1])
        while end - a >= lo:
            n = min(int(lengths[k]), end - a)
            k += 1
            out.append((v, a, a + n))
            a += n
    w = np.asarray(out, dtype=np.int64).reshape(-1, 3)
    return w[np.argsort(fl.time[w[:, 2] - 1], kind="stable")]
