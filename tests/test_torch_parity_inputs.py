"""/report bodies of the port against the JAX package's on varied inputs.

The other parity tests hold K=8, default options and grid cities. Here
each case's requests go through the JAX package's matcher and the port's
(``device="cpu"``) on each prep path, the numpy prep (``use_native=False``
against ``native=False``), the native host runtime (the defaults) and the
device route costs (``REPORTER_TPU_ROUTE_DEVICE=1`` against
``route_device=True``; the port runs their plain versions here), and every
``/report`` body must be byte-equal:

- K of 4, 8 and 16;
- per-trace ``match_options`` that vary ``sigma_z``, ``beta``,
  ``search_radius``, ``turn_penalty_factor``, ``max_route_time_factor``,
  ``breakage_distance`` and ``gps_accuracy`` (one value per trace, so a
  call splits into prep groups);
- one trace past 1,024 points (the last length bucket and past it);
- duplicate times: repeated timestamps and repeated points;
- the generated OSM town (each package's ``tools/osm_fixture.py``
  through its own ``graph/osm.py``, the columns held equal): curved
  multi-edge ways, one-ways, ramps.

Inputs come from seeded numpy streams through the port's synth. Tolerance:
exact.
"""
import io

import numpy as np
import pytest

from reporter_tpu.graph.osm import network_from_osm_xml as jax_osm
from reporter_tpu.matcher import MatchParams as JaxParams
from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.service.report import report_json as jax_report_json
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu.tools.osm_fixture import build_city_xml as jax_xml
from reporter_tpu.utils import metrics as jax_metrics
from reporter_tpu_torch.graph.network import COLUMNS
from reporter_tpu_torch.graph.osm import network_from_osm_xml
from reporter_tpu_torch.matcher import MatchParams, SegmentMatcher
from reporter_tpu_torch.service.report import report_json
from reporter_tpu_torch.synth import build_grid_city, generate_trace
from reporter_tpu_torch.utils import metrics

GRID = dict(rows=10, cols=10, spacing_m=200.0, seed=5)
LEVELS = {"mode": "auto", "report_levels": [0, 1, 2],
          "transition_levels": [0, 1, 2]}
PREPS = ["numpy", "native", "device"]
#: each option's values, one per trace of the case
OPTIONS = {
    "sigma_z": [2.0, 4.07, 9.0, 20.0],
    "beta": [0.5, 3.0, 8.0, 25.0],
    "search_radius": [15.0, 50.0, 90.0, 150.0],
    "turn_penalty_factor": [0.0, 15.0, 60.0, 200.0],
    "max_route_time_factor": [0.0, 0.5, 2.0, 6.0],
    "breakage_distance": [60.0, 150.0, 500.0, 2000.0],
    "gps_accuracy": [0.0, 12.0, 40.0, 90.0],
}


@pytest.fixture(scope="module")
def nets():
    """{name: (the JAX package's network, the port's)}: the grid city
    built by each package's synth, and the OSM town imported by each
    package's importer from its own fixture's bytes (the columns held
    equal)."""
    from reporter_tpu_torch.tools.osm_fixture import build_city_xml
    ref = jax_osm(io.BytesIO(jax_xml().encode()))
    town = network_from_osm_xml(io.BytesIO(build_city_xml().encode()))
    for name in COLUMNS:
        got, want = getattr(town, name), getattr(ref, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert town.segment_length_m == ref.segment_length_m
    return {"grid": (jax_city(**GRID), build_grid_city(**GRID)),
            "osm": (ref, town)}


def _traces(net, seed, n, min_pts=8, max_pts=60):
    """``n`` seeded synthetic traces' points, each cut to at most
    ``max_pts``."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        tr = generate_trace(net, f"p-{len(out)}", rng, noise_m=6.0,
                            min_route_edges=3, max_route_edges=40)
        if tr is not None and len(tr.points) >= min_pts:
            out.append(tr.points[:max_pts])
    return out


def _requests(case, net):
    """The case's requests on the port's network ``net``."""
    if case in OPTIONS:
        pts = _traces(net, 31, len(OPTIONS[case]))
        return [{"uuid": f"{case}-{i}", "trace": p,
                 "match_options": dict(LEVELS, **{case: v})}
                for i, (p, v) in enumerate(zip(pts, OPTIONS[case]))]
    if case == "long":
        # consecutive drives stitched into one trace of 1,100 points, the
        # clock running on (the jumps between drives are < 2 km)
        pts, t = [], 1_500_000_000
        for drive in _traces(net, 41, 60, max_pts=200):
            for p in drive:
                pts.append(dict(p, time=t))
                t += 1
        pts = pts[:1100]
        assert len(pts) == 1100
        return [{"uuid": "long", "trace": pts, "match_options": LEVELS},
                {"uuid": "short", "trace": _traces(net, 42, 1)[0],
                 "match_options": LEVELS}]
    if case == "duplicate_times":
        reqs = []
        for i, p in enumerate(_traces(net, 51, 4)):
            p = [dict(q) for q in p]
            for j in range(2, len(p), 4):     # a timestamp repeated
                p[j]["time"] = p[j - 1]["time"]
            if i % 2:                          # a point repeated whole
                p.insert(3, dict(p[3]))
            reqs.append({"uuid": f"dup-{i}", "trace": p,
                         "match_options": LEVELS})
        return reqs
    return [{"uuid": f"{case}-{i}", "trace": p, "match_options": LEVELS}
            for i, p in enumerate(_traces(net, 61, 5))]


CASES = [  # (case, network, K)
    ("k4", "grid", 4), ("k8", "grid", 8), ("k16", "grid", 16),
    *((name, "grid", 8) for name in OPTIONS),
    ("long", "grid", 8), ("duplicate_times", "grid", 8),
    ("osm_town", "osm", 8),
]


def _bodies(matches, reqs, writer):
    return [writer(m, r, 15, {0, 1, 2}, {0, 1, 2})
            for m, r in zip(matches, reqs)]


@pytest.mark.parametrize("prep", PREPS)
@pytest.mark.parametrize("case,net_name,K", CASES)
def test_report_bodies_equal_jax(nets, monkeypatch, case, net_name, K,
                                 prep):
    ref_net, net = nets[net_name]
    reqs = _requests(case, net)
    if prep == "device":
        monkeypatch.setenv("REPORTER_TPU_ROUTE_DEVICE", "1")
    jax_metrics.default.reset()
    metrics.default.reset()
    ref = JaxMatcher(net=ref_net, params=JaxParams(max_candidates=K),
                     use_native=prep != "numpy")
    want = _bodies(ref.match_many(reqs), reqs, jax_report_json)
    port = SegmentMatcher(net, MatchParams(max_candidates=K), device="cpu",
                          native=prep != "numpy",
                          route_device=prep == "device")
    got = _bodies(port.match_many(reqs), reqs, report_json)
    assert got == want
    # the device preps routed on the device, the others did not
    routed = [m.snapshot()["counters"].get("route.device.chunks", 0)
              for m in (jax_metrics.default, metrics.default)]
    assert all((n > 0) == (prep == "device") for n in routed), routed
    # every case matches something: a body with no segment checks little
    assert sum(b.count('"segment_id"') for b in got) >= len(reqs) - 1
