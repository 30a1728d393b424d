"""The incremental decode's timers and counters (``matcher/incremental.py``).

On a small city, windows that grow a few points a call go through
``SegmentMatcher.match_incremental`` on the CPU, with ``ops.incremental_steps``
wrapped to record each launch's operands. The counters must equal what the
launches held: one ``match.incremental.launches`` a launch, its R x N cells
(``.cells.launched``), its real steps (``.cells.kept``, also the
``.steps`` the rounds replay), its N rows and the operands' bytes
(``.upload.bytes``); the ``.prep`` and ``.assemble`` timers run once a
call and ``.upload`` once a launch. Every name is in the registry, and the answers are
bit-equal with the tracing armed and disarmed.
"""
import json

import numpy as np
import pytest

from reporter_tpu_torch import ops
from reporter_tpu_torch.analysis import registry
from reporter_tpu_torch.matcher import SegmentMatcher
from reporter_tpu_torch.obs import trace as obs_trace
from reporter_tpu_torch.synth import build_grid_city, generate_trace
from reporter_tpu_torch.utils import metrics

CITY = dict(rows=12, cols=12, spacing_m=200.0, seed=2,
            service_road_fraction=0.0, internal_fraction=0.0)
COUNTERS = ("match.incremental.launches", "match.incremental.cells.launched",
            "match.incremental.cells.kept", "match.incremental.rows.launched",
            "match.incremental.upload.bytes",
            "match.incremental.evictions.budget")
TIMERS = ("match.incremental.prep", "match.incremental.upload",
          "match.incremental.assemble")


@pytest.fixture(scope="module")
def city():
    return build_grid_city(**CITY)


def traces(city, n, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        tr = generate_trace(city, f"veh-{len(out)}", rng, noise_m=4.0)
        if tr is not None and len(tr.points) >= 24:
            out.append(list(tr.points))
    return out


def feed(m, pts_list, start=6, step=4):
    """Windows growing ``step`` points a call, every trace in each call;
    the canonical JSON of every answer, in order."""
    bodies = []
    longest = max(len(p) for p in pts_list)
    for hi in range(start, longest + 1, step):
        reqs = [{"uuid": f"u{k}", "trace": p[:hi]}
                for k, p in enumerate(pts_list) if hi <= len(p)]
        bodies += [json.dumps(x, sort_keys=True)
                   for x in m.match_incremental(reqs)]
    return bodies


@pytest.fixture
def launches(monkeypatch):
    """Each ``ops.incremental_steps`` call's (R, N, real steps, operand
    bytes), recorded as the decode launches it."""
    seen = []
    real = ops.incremental_steps

    def recorded(dist, valid, route, gc, case, init, n_steps, *rest,
                 **kw):
        R, N, _K = dist.shape
        seen.append((R, N, int(n_steps.sum()),
                     sum(t.numpy().nbytes for t in
                         (dist, valid, route, gc, case, init, n_steps))))
        return real(dist, valid, route, gc, case, init, n_steps, *rest,
                    **kw)
    monkeypatch.setattr(ops, "incremental_steps", recorded)
    return seen


def test_the_counters_equal_what_each_launch_held(city, launches):
    m = SegmentMatcher(city, device="cpu")
    metrics.default.reset()
    feed(m, traces(city, 6))
    snap = metrics.snapshot()
    c, t = snap["counters"], snap["timers"]
    assert launches, "no launch ran"
    assert c["match.incremental.launches"] == len(launches)
    assert c["match.incremental.cells.launched"] == \
        sum(R * N for R, N, _k, _b in launches)
    assert c["match.incremental.cells.kept"] == \
        sum(k for _R, _N, k, _b in launches) == c["match.incremental.steps"]
    assert c["match.incremental.cells.launched"] >= \
        c["match.incremental.cells.kept"] > 0
    assert c["match.incremental.rows.launched"] == \
        sum(N for _R, N, _k, _b in launches)
    assert c["match.incremental.upload.bytes"] == \
        sum(b for _R, _N, _k, b in launches)
    assert t["match.incremental.upload"]["count"] == len(launches)
    # one prep a call into the table, as many as the advance timer counts
    assert t["match.incremental.prep"]["count"] == \
        t["match.incremental.advance"]["count"] > 0
    assert t["match.incremental.prep"]["total_s"] <= \
        t["match.incremental.advance"]["total_s"]
    # the assembly once a call too, outside the decode and inside the
    # advance
    assert t["match.incremental.assemble"]["count"] == \
        t["match.incremental.advance"]["count"]
    assert t["match.incremental.assemble"]["total_s"] \
        + t["match.incremental.decode"]["total_s"] <= \
        t["match.incremental.advance"]["total_s"]
    assert "match.incremental.evictions.budget" not in c
    m.close()


def test_a_budget_eviction_is_counted_apart(city):
    m = SegmentMatcher(city, device="cpu", incremental_mb=0.0)
    metrics.default.reset()
    feed(m, traces(city, 2))
    c = metrics.snapshot()["counters"]
    assert c["match.incremental.evictions.budget"] > 0
    assert c["match.incremental.evictions.budget"] == \
        c["match.incremental.evictions"]
    m.close()


@pytest.mark.parametrize("profiler", [False, True])
def test_answers_are_bit_equal_armed_and_disarmed(city, profiler):
    """Disarmed, then armed (with the spans mirrored onto the profiler's
    clock, or not): the same bytes."""
    pts = traces(city, 5, seed=11)
    want = feed(SegmentMatcher(city, device="cpu"), pts)
    obs_trace.configure(True, profiler=profiler)
    try:
        got = feed(SegmentMatcher(city, device="cpu"), pts)
    finally:
        obs_trace.configure(False)
    assert got == want
    assert sum(b != "null" for b in got) > 0


@pytest.mark.parametrize("name", COUNTERS + TIMERS)
def test_every_new_name_is_in_the_registry(name):
    assert name in registry.METRICS
