"""The port's overload proof (``reporter_tpu_torch/tools/overload.py``) on
the CPU at ``--smoke``.

Tier-1 holds the gates that read only the accounting of every arrival:
no hard error, every 429 counted by a shed counter and carrying a
positive ``retry_after_s``, and the armed leg's arrivals reconcile. The
gates that read latencies and rates (the control leg's breach, the armed
p99, goodput, and a sustained shed stepping the ladder) depend on how
fast the host runs the match beside the 20 ms service floor; on this
kind of host the unshed leg's batching absorbs the load, so they are
held on the card (``chip_smoke.py`` ``[overload]``). The artifact's keys
equal the JAX harness's.
"""
import importlib.util
import json
import os

from reporter_tpu_torch.tools import overload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_harness(monkeypatch):
    """The JAX repo's tools/overload.py as a module (nothing run)."""
    monkeypatch.setenv("REPORTER_TPU_PLATFORM", "cpu")
    spec = importlib.util.spec_from_file_location(
        "jax_overload_tool", os.path.join(REPO, "tools", "overload.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_accounts_for_every_arrival(tmp_path):
    out = tmp_path / "overload.json"
    rc = overload.main(["--smoke", "--device", "cpu", "--out", str(out)])
    art = json.loads(out.read_text())
    failed = {gate for gate, _msg in overload.check_gates(art)}
    assert not failed & set(overload.ACCOUNTING_GATES), failed
    assert rc == (1 if failed else 0)
    armed, unshed = art["legs"]["armed"], art["legs"]["unshed"]
    assert armed["errors"] == unshed["errors"] == 0
    assert armed["sent"] == art["arrivals"] == unshed["sent"]
    assert armed["sent"] == armed["ok"] + armed["shed"]
    assert armed["shed_missing_retry_after"] == 0
    shed_counted = sum(v for k, v in armed["counters"].items()
                       if k.startswith(("admission.shed.",
                                        "dispatch.queue.")))
    assert shed_counted >= armed["shed"]
    assert armed["counters"]["admission.admitted"] >= armed["ok"]


def test_artifact_keys_equal_the_jax_harness(monkeypatch):
    jax = jax_harness(monkeypatch)
    results = [(200, None, 0.01), (429, 2, 0.001), (500, None, 0.02)]
    assert overload._leg_stats(results, 0.3, 1.0) \
        == jax._leg_stats(results, 0.3, 1.0)
    assert overload._p99([0.1, 0.2, 0.3]) == jax._p99([0.1, 0.2, 0.3])
    art = {"kind": "overload", "mean_service_ms": 1.0, "rate_hz": 1.0,
           "arrivals": 1, "slo_budget_ms": 300,
           "legs": {"unshed": {}, "armed": {}}}
    src = open(os.path.join(REPO, "tools", "overload.py")).read()
    for key in list(art) + ["counters", "pressure_level_seen"]:
        assert f'"{key}"' in src
    port = open(overload.__file__).read()
    for key in list(art) + ["counters", "pressure_level_seen"]:
        assert f'"{key}"' in port
    for name in ("admission.admitted", "admission.shed.queue",
                 "admission.shed.slo", "admission.shed.inflight",
                 "admission.errors", "dispatch.queue.rejected",
                 "dispatch.queue.evicted"):
        assert f'"{name}"' in src and f'"{name}"' in port


def test_gates_read_the_artifact():
    leg = {"sent": 10, "ok": 8, "shed": 2, "errors": 0,
           "shed_missing_retry_after": 0, "p50_ms": 10.0, "p99_ms": 50.0,
           "goodput_per_s": 8.0, "in_budget": 8}
    art = {"slo_budget_ms": 100, "legs": {
        "unshed": dict(leg, shed=0, ok=10, p99_ms=500.0, goodput_per_s=4.0),
        "armed": dict(leg, counters={"admission.shed.inflight": 2},
                      pressure_level_seen=1)}}
    assert overload.check_gates(art) == []
    art["legs"]["armed"]["counters"] = {"admission.shed.inflight": 1}
    art["legs"]["armed"]["shed_missing_retry_after"] = 1
    assert [g for g, _m in overload.check_gates(art)] \
        == ["retry_after", "silent_loss"]
    art["legs"]["unshed"]["p99_ms"] = 50.0
    assert "unshed_breach" in [g for g, _m in overload.check_gates(art)]
