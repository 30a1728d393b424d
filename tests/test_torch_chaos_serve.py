"""The port's chaos harness (``reporter_tpu_torch/tools/chaos.py``), its
serving scenarios, on the CPU at the JAX harness's sizes.

``storm``: the native prep breaker opens and the numpy prep serves
byte-identical results until a probe re-closes it. ``decode_poison``
holds the port's own contract for the decode domain (500, then 503 with
``Retry-After`` while open, never a host decode; the probe re-closes it
with the healthy bytes) and the JAX package's for the assemble domain
(exactly one trace quarantined). ``prefork_kill`` SIGKILLs one of two
``SO_REUSEPORT`` workers, once plain and once with each worker's decode
mesh naming the CPU twice; every answer, the successor's among them,
equals an in-process CPU service's bytes. ``overload_recovery`` sheds,
fails open and recovers. The tool's entry point refuses a missing card
and unknown scenarios. Each scenario's fault-free comparand (storm's
results, decode_poison's healthy bodies, prefork_kill's six bodies) is
also held against the JAX package's ``SegmentMatcher`` and
``ReporterService`` on the same seeded city and requests, so the port's
recovered answers equal the reference's. Tolerance: exact.
"""
import pytest
import torch

from reporter_tpu.matcher import SegmentMatcher as JaxMatcher
from reporter_tpu.service.server import ReporterService as JaxService
from reporter_tpu.synth import build_grid_city as jax_city
from reporter_tpu_torch.tools import chaos
from reporter_tpu_torch.utils import faults

#: chaos._city()'s and prefork_kill's cities, built by the JAX package
CHAOS_CITY = dict(rows=10, cols=10, spacing_m=200.0, seed=5,
                  service_road_fraction=0.0, internal_fraction=0.0)
PREFORK_CITY = dict(CHAOS_CITY, rows=8, cols=8, seed=3)


def jax_bodies(city, reqs):
    """(status, body text) of each request through the JAX package's
    service, one at a time, as ``chaos._handle_all`` runs the port's."""
    svc = JaxService(JaxMatcher(net=jax_city(**city)), threshold_sec=15,
                     max_batch=64, max_wait_ms=5.0)
    try:
        out = []
        for req in reqs:
            code, body = svc.handle(dict(req))
            if not isinstance(body, str):
                body = bytes(body).decode("utf-8")
            out.append((code, body))
        return out
    finally:
        svc.dispatcher.close()


@pytest.fixture(autouse=True)
def _disarmed():
    faults.clear()
    yield
    faults.clear()


def test_storm_serves_the_numpy_prep_bytes_and_recloses():
    keep = {}
    assert chaos.scenario_storm("cpu", keep) == 0
    assert keep["counters"]["matcher.circuit.closed"] >= 1
    assert len(keep["want"]) == 8
    jm = JaxMatcher(net=jax_city(**CHAOS_CITY))
    assert [chaos._as_plain(r) for r in jm.match_many(keep["reqs"])] \
        == keep["want"]
    # the comparand chip_smoke.py rebuilds on the CPU for a card run
    assert chaos.fault_free("storm", "cpu", keep) == keep["ref"] \
        == keep["want"]


def test_decode_poison_refuses_then_recloses_and_quarantines_one():
    keep = {}
    assert chaos.scenario_decode_poison("cpu", keep) == 0
    codes = keep["codes"]
    assert codes[:3] == [500, 500, 500] and set(codes[3:]) == {503}
    assert all(code == 200 for code, _b in keep["healthy"])
    assert jax_bodies(CHAOS_CITY, keep["reqs"]) == keep["healthy"]
    assert chaos.fault_free("decode_poison", "cpu", keep) == keep["ref"] \
        == keep["healthy"]
    assert [i for i, (g, w) in enumerate(zip(keep["got"], keep["want"]))
            if g != w] == [keep["poisoned"]]


def test_prefork_bodies_are_the_jax_services():
    """The bytes every prefork_kill worker is held to."""
    _city, reqs = chaos.prefork_requests()
    want = chaos.prefork_bodies()
    assert all(code == 200 for code, _b in want)
    assert jax_bodies(PREFORK_CITY, reqs) == want


@pytest.mark.parametrize("mesh", [False, True], ids=["plain", "mesh"])
def test_prefork_kill_successor_answers_the_cpu_bytes(mesh):
    keep = {}
    assert chaos.scenario_prefork_kill("cpu", keep, mesh=mesh) == 0
    verdict = keep["verdict"]
    assert verdict["ok"] and verdict["new_tag"] not in verdict["tags"]
    assert verdict["successor_answers"] > 0
    assert keep["names"][0] != keep["names"][1]


def test_overload_recovery_sheds_counts_and_recovers():
    keep = {}
    assert chaos.scenario_overload_recovery("cpu", keep) == 0
    assert keep["shed"] > 0 and keep["counted"] >= keep["shed"]
    assert keep["level_down"] >= 1 and keep["backpressure_shed"] > 0


def test_entry_point_needs_a_card_and_known_scenarios():
    assert chaos.main(["--device", "cpu", "no_such"]) == 1
    assert sorted(chaos.SCENARIOS) == sorted([
        "storm", "kill_restore", "stream_resume", "prefork_kill",
        "submit_burst", "egress_outage", "decode_poison", "double_ingest",
        "replay_drain", "lease_kill", "swap_kill", "overload_recovery"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            chaos.main(["storm"])
