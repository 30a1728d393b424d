"""The port's schedule fuzzer (``reporter_tpu_torch/tools/racefuzz.py``)
on the CPU.

One seed of each scenario (the traced multi-writer replay, chaos's
``submit_burst`` and ``storm``) in its own interpreter with the witness
and the fuzz layer armed by its config file: no finding, and the
perturbation fired in every one. ``lockcheck: "raw"`` makes every lock of the
process a bare ``threading.Lock`` and refuses to arm the witness, as the
JAX package's ``REPORTER_TPU_LOCKCHECK=raw`` does. ``--overhead`` runs its
live legs with the lock flavours it claims, its A/B and A/A controls
the medians of paired calls; its 2% gate is held on the card
(``chip_smoke.py`` ``[racefuzz]``), not on a shared host.
"""
import json
import os
import re
import subprocess
import sys

import pytest

from reporter_tpu_torch.tools import racefuzz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RAW_PROBE = """
import json, threading
{arm}
from {pkg}.utils import locks
lk = locks.new_lock("probe")
try:
    locks.arm()
    armed = "armed"
except RuntimeError as e:
    armed = "refused"
from {pkg}.utils import metrics
print(json.dumps({{"bare": type(lk) is type(threading.Lock()),
                   "metrics": type(metrics.default._lock).__name__,
                   "arm": armed}}))
"""


def probe(pkg, arm, env=None):
    out = subprocess.run([sys.executable, "-c", RAW_PROBE.format(
        pkg=pkg, arm=arm)], capture_output=True, text=True, check=True,
        timeout=120, cwd=REPO, env=env)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_one_seed_of_each_scenario_is_clean_and_perturbed(capsys):
    assert racefuzz.run_fuzz([1], racefuzz.DEFAULT_SCENARIOS, 0.25, 200.0,
                             "cpu") == 0
    out = capsys.readouterr().out
    yields = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"racefuzz: (\w+): .*?(\d+) perturbation yields", out)}
    assert set(yields) == set(racefuzz.DEFAULT_SCENARIOS)
    assert all(n > 0 for n in yields.values()), yields
    assert out.count(": 0 findings (held-before edges observed") == 3


def test_raw_lockcheck_hands_out_bare_locks_as_the_jax_package(tmp_path):
    """The command line reads ``lockcheck: "raw"`` from the config before
    the command loads, so every lock of the process is bare, the metrics
    registry's (made at import) too, as under the JAX package's
    ``REPORTER_TPU_LOCKCHECK=raw``."""
    conf = tmp_path / "serve.json"
    conf.write_text(json.dumps({"graph": "city.npz",
                                "service": {"lockcheck": "raw"}}))
    port = probe("reporter_tpu_torch",
                 "from reporter_tpu_torch import __main__ as _m\n"
                 f"_m.raw_locks_first('serve', ['--procs', '2', {str(conf)!r}, "
                 "'127.0.0.1:0'])\n"
                 "from reporter_tpu_torch.service.server import "
                 "configure_obs\n"
                 "configure_obs({'lockcheck': 'raw'})\n"
                 "from reporter_tpu_torch.utils import locks as _l\n"
                 "assert _l.raw() and not len(_l._instances)")
    env = dict(os.environ, REPORTER_TPU_LOCKCHECK="raw")
    jax = probe("reporter_tpu", "", env=env)
    assert port["bare"] and jax["bare"]
    assert port["arm"] == jax["arm"] == "refused"
    assert port["metrics"] == jax["metrics"] == "lock"


def test_raw_lockcheck_is_refused_once_a_tracked_lock_exists():
    """A process whose package already made its locks cannot turn raw:
    it would run with tracked and bare locks mixed."""
    got = subprocess.run([sys.executable, "-c", (
        "from reporter_tpu_torch.service.server import configure_obs\n"
        "from reporter_tpu_torch.utils import locks\n"
        "try:\n    configure_obs({'lockcheck': 'raw'})\n"
        "except RuntimeError:\n    print('refused', locks.raw())\n")],
        capture_output=True, text=True, check=True, timeout=120, cwd=REPO)
    assert got.stdout.strip() == "refused False"


@pytest.mark.parametrize("name, rest, want", [
    ("serve", ["c.json", "127.0.0.1:8002"], "c.json"),
    ("serve", ["--procs", "2", "--device=cpu", "c.json", "h:1"], "c.json"),
    ("stream", ["--graph", "g.npz", "--config", "c.json"], "c.json"),
    ("stream", ["--config=c.json"], "c.json"),
    ("pipeline", ["--src", "d", "--match-config", "c.json"], "c.json"),
    ("stream", ["--graph", "g.npz"], None),
    ("accuracy", ["--config", "c.json"], None),
])
def test_the_command_line_finds_the_config_it_reads_raw_from(name, rest,
                                                             want):
    from reporter_tpu_torch import __main__ as umbrella
    assert umbrella.config_path(name, rest) == want


def test_raw_mode_refuses_to_start_under_an_armed_witness():
    got = subprocess.run([sys.executable, "-c", (
        "from reporter_tpu_torch.utils import locks\n"
        "locks.arm()\n"
        "try:\n    locks.set_raw()\nexcept RuntimeError:\n"
        "    print('refused')\n")], capture_output=True, text=True,
        check=True, timeout=120, cwd=REPO)
    assert got.stdout.strip() == "refused"


def test_overhead_legs_run_their_lock_flavours():
    """Live legs at the shipped prep threads, raw i and disarmed i back
    to back a round; the A/B is the median over those pairs, the A/A
    controls the same over neighbouring processes of one leg."""
    import statistics
    got = racefuzz.measure_overhead(2, "cpu", procs=2)
    assert got["types"] == {"raw": "lock", "disarmed": "TrackedLock"}
    assert racefuzz.OVERHEAD_KEYS == {"pipeline": False}
    legs = got["legs"]
    assert {leg: [len(c) for c in calls] for leg, calls in legs.items()} \
        == {"raw": [2, 2], "disarmed": [2, 2]}
    for leg in ("raw", "disarmed"):
        assert got[f"{leg}_ms"] == statistics.median(
            t for c in legs[leg] for t in c) > 0
        assert got[f"aa_{leg}_pct"] == pytest.approx((statistics.median(
            legs[leg][1][r] / legs[leg][0][r] for r in range(2)) - 1) * 100)
    assert got["pct"] == pytest.approx((statistics.median(
        legs["disarmed"][i][r] / legs["raw"][i][r]
        for r in range(2) for i in range(2)) - 1) * 100)
    # the disarmed legs' tracked locks are taken, the same count in each,
    # and the direct reading is that count times a pair's extra cost
    assert len(got["acquires"]) == 1 and got["acquires"][0] > 0
    assert got["wrapper_pct"] >= 0.0


def test_the_direct_reading_is_acquisitions_times_the_extra_pair_cost(
        monkeypatch):
    cost = racefuzz.lock_pair_ns(n=2000, blocks=2)
    assert cost["tracked_ns"] > 0 and cost["bare_ns"] > 0
    assert racefuzz.wrapper_pct(15, {"tracked_ns": 1300.0,
                                     "bare_ns": 300.0}, 80.0) \
        == pytest.approx(15 * 1000.0 / 80e6 * 100)
    # a bare lock slower than a tracked one reads as no cost
    assert racefuzz.wrapper_pct(15, {"tracked_ns": 1.0, "bare_ns": 2.0},
                                80.0) == 0.0
    from reporter_tpu_torch.utils import locks
    monkeypatch.setattr(locks, "_RAW", True)
    with pytest.raises(RuntimeError, match="disarmed tracked"):
        racefuzz.lock_overhead("cpu")


def test_a_child_config_key_outside_its_set_is_refused(tmp_path):
    conf = tmp_path / "child.json"
    conf.write_text(json.dumps({"service": {"faults": "x=error"}}))
    with pytest.raises(ValueError, match="unknown keys"):
        racefuzz._arm_child(str(conf))
