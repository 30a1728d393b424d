"""The port's lint passes (``reporter_tpu_torch/analysis/``): each rule
fires on a bad fixture and stays silent on a good one, the ABI checks
catch drifts injected into copies of the live bindings (the host runtime
and the card's seven ``extern "C"`` entry points), the placement pass
(DP) finds on its torch fixture what the JAX pass finds on the JAX one
and catches a sync injected into a live lane, the tensor contract (TC)
catches signature drift, a widening plain version and each side of its
coverage, the live tree runs clean with the empty committed baseline,
and the fuzz layer of ``utils/locks.py`` (the JAX package's
``TestFuzzLayer`` cases).

Fixtures: where a rule is unchanged from the JAX package's, its
``tests/lint_fixtures/`` file is read as it is, under a fake port path;
where a rule is restated (config keys, ``"raises"`` legs, the card's
ABI), under ``tests/torch_lint_fixtures/``.
"""
import ast
import copy
import json
import os
import re
import subprocess
import sys

import pytest

from reporter_tpu_torch import analysis
from reporter_tpu_torch.analysis import (abi, durability, fallback,
                                         fault_coverage, hotpath, lockgraph,
                                         locks, placement, registry,
                                         registry_drift, tensorcontract)
from reporter_tpu_torch.analysis.core import SourceFile, parse_suppressions
from reporter_tpu_torch.tools import lint as lint_cli
from reporter_tpu_torch.utils import locks as port_locks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
TORCH_FIXTURES = os.path.join(REPO, "tests", "torch_lint_fixtures")
PKG = os.path.join(REPO, "reporter_tpu_torch")
LIVE_CPP = os.path.join(REPO, abi.DEFAULT_CPP)
LIVE_PY = os.path.join(REPO, abi.DEFAULT_PY)


def _read(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


def _fixture(name, relpath, root=FIXTURES):
    """A fixture loaded under a fake repo-relative path, so the passes'
    module-scope filters apply."""
    sf = SourceFile.load(os.path.join(root, name), REPO)
    sf.relpath = relpath
    return sf


def _run_pass(pass_mod, name, relpath, root=FIXTURES):
    sf = _fixture(name, relpath, root)
    return sf, analysis.filter_suppressed(pass_mod.run([sf], REPO), [sf])


def _expected_lines(sf, rule):
    """Lines whose trailing comment names the rule (``# HP001: why``,
    ``# LD003 (x2): why``)."""
    out = {}
    for i, line in enumerate(sf.text.splitlines(), start=1):
        m = re.search(rf"#\s*{rule}(?:\s*\(x(\d+)\))?:", line)
        if m:
            out[i] = int(m.group(1) or 1)
    return out


def _assert_matches_annotations(sf, findings, rules):
    got = {}
    for f in findings:
        got.setdefault(f.rule, {}).setdefault(f.line, 0)
        got[f.rule][f.line] += 1
    for rule in rules:
        assert got.get(rule, {}) == _expected_lines(sf, rule), \
            f"{rule} findings diverge from fixture annotations"


@pytest.fixture(scope="module")
def live_files():
    return analysis.collect_py_files(REPO, [PKG])


# ---- the code passes on the JAX package's fixtures -------------------------

@pytest.mark.parametrize("pass_mod,name,relpath,rules", [
    (hotpath, "hotpath_bad.py", "reporter_tpu_torch/matcher/fixture_bad.py",
     ("HP001", "HP002", "HP003")),
    (locks, "locks_bad.py", "reporter_tpu_torch/streaming/fixture_bad.py",
     ("LD001",)),
    (lockgraph, "lockgraph_bad.py",
     "reporter_tpu_torch/streaming/fixture_bad.py", ("LD002", "LD003")),
])
def test_code_pass_fires_on_bad_fixture(pass_mod, name, relpath, rules):
    sf, findings = _run_pass(pass_mod, name, relpath)
    assert findings
    _assert_matches_annotations(sf, findings, rules)


@pytest.mark.parametrize("pass_mod,name,relpath", [
    (hotpath, "hotpath_good.py", "reporter_tpu_torch/matcher/fixture.py"),
    (locks, "locks_good.py", "reporter_tpu_torch/streaming/fixture.py"),
    (lockgraph, "lockgraph_good.py",
     "reporter_tpu_torch/streaming/fixture.py"),
])
def test_code_pass_silent_on_good_fixture(pass_mod, name, relpath):
    assert _run_pass(pass_mod, name, relpath)[1] == []


@pytest.mark.parametrize("pass_mod,name", [
    (hotpath, "hotpath_bad.py"), (locks, "locks_bad.py")])
def test_scope_is_the_declared_module_set(pass_mod, name):
    assert _run_pass(pass_mod, name,
                     "reporter_tpu_torch/tools/fixture_bad.py")[1] == []


def test_suppression_comment_silences_rule():
    src = ("def f(rows):\n"
           "    out = []\n"
           "    for r in rows:\n"
           "        out.append({'id': r})  # lint: ignore[HP002]\n"
           "    return out\n")

    def load(text):
        return SourceFile(path="x", relpath="reporter_tpu_torch/matcher/x.py",
                          text=text, tree=ast.parse(text),
                          suppressions=parse_suppressions(text))
    sf = load(src)
    assert analysis.filter_suppressed(hotpath.run([sf], REPO), [sf]) == []
    bare = load(src.replace("  # lint: ignore[HP002]", ""))
    assert any(f.rule == "HP002" for f in hotpath.run([bare], REPO))


def test_lockgraph_does_not_resolve_a_foreign_receiver_to_the_class():
    """``self._resident.get()`` under a lock is a dict's get, not the
    class's own ``get``: no edge, so no false cycle."""
    src = ("class Reg:\n"
           "    def get(self, k):\n"
           "        with self._lock:\n"
           "            return self._hit(k)\n"
           "    def _hit(self, k):\n"
           "        with self._res_lock:\n"
           "            return self._resident.get(k)\n")
    sf = SourceFile(path="x", relpath="reporter_tpu_torch/service/x.py",
                    text=src, tree=ast.parse(src), suppressions={})
    assert lockgraph.run([sf], REPO) == []
    looped = src.replace("self._resident.get(k)", "self.get(k)")
    sf = SourceFile(path="x", relpath="reporter_tpu_torch/service/x.py",
                    text=looped, tree=ast.parse(looped), suppressions={})
    assert [f.rule for f in lockgraph.run([sf], REPO)] == ["LD002"]


def test_lockgraph_counts_a_kernel_build_as_blocking():
    src = ("import threading\n"
           "from . import nvcc\n"
           "_lock = threading.Lock()\n"
           "def build():\n"
           "    with _lock:\n"
           "        return nvcc.load('x.cu', 'x')\n")
    sf = SourceFile(path="x", relpath="reporter_tpu_torch/ops/x.py",
                    text=src, tree=ast.parse(src), suppressions={})
    found = lockgraph.run([sf], REPO)
    assert [(f.rule, f.line) for f in found] == [("LD003", 5)]
    assert "nvcc.load" in found[0].message


def test_live_build_holds_are_documented_suppressions(live_files):
    """Every once-only build lock (the host runtime's, nvcc's and each
    kernel library's) is an LD003 the pass sees, and each carries its
    inline suppression."""
    raw = lockgraph.run(live_files, REPO)
    held = {f.path for f in raw if f.rule == "LD003"}
    for rel in ("reporter_tpu_torch/native/__init__.py",
                "reporter_tpu_torch/ops/nvcc.py",
                "reporter_tpu_torch/ops/viterbi.py",
                "reporter_tpu_torch/ops/incremental.py",
                "reporter_tpu_torch/ops/route_relax.py"):
        assert rel in held, rel
    assert analysis.filter_suppressed(raw, live_files) == []


def test_city_registry_lock_order_is_in_the_graph(live_files):
    """``_lock`` before ``_res_lock``: the edge is seen, and no cycle."""
    sf = next(f for f in live_files
              if f.relpath == "reporter_tpu_torch/service/cities.py")
    c = lockgraph._Collector(sf)
    c.visit(sf.tree)
    nested = {(h[2], n[2]) for info in c.funcs.values()
              for h, _line, n in info.held_locks}
    assert ("_lock", "_res_lock") in nested
    assert ("_res_lock", "_lock") not in nested
    assert not [f for f in lockgraph.run(live_files, REPO)
                if f.rule == "LD002"]


# ---- durability ------------------------------------------------------------

_DUR_BAD = {f"reporter_tpu_torch/streaming/fixture_bad.py::{fn}":
            ("punctuate", "commit_epoch")
            for fn in ("commit_before_ack", "commit_without_ack",
                       "missing_commit")}


def test_durability_fires_on_bad_fixture():
    sf = _fixture("durability_bad.py",
                  "reporter_tpu_torch/streaming/fixture_bad.py")
    findings = analysis.filter_suppressed(
        durability.run([sf], REPO, modules=(sf.relpath,),
                       contracts=_DUR_BAD), [sf])
    _assert_matches_annotations(sf, findings,
                                ("DUR001", "DUR002", "DUR003", "DUR004"))


def test_durability_silent_on_good_fixture():
    sf = _fixture("durability_good.py",
                  "reporter_tpu_torch/streaming/fixture_good.py")
    assert durability.run(
        [sf], REPO, modules=(sf.relpath,),
        contracts={"reporter_tpu_torch/streaming/fixture_good.py::"
                   "commit_after_ack": ("punctuate", "commit_epoch")}) == []


def test_durability_live_flush_contract_holds():
    """The port's worker commits the epoch marker after the sink ack, and
    a copy that commits it first is DUR004."""
    rel = "reporter_tpu_torch/streaming/worker.py"
    live = _read(os.path.join(REPO, rel))
    sf = SourceFile.load(os.path.join(REPO, rel), REPO)
    assert durability.run([sf], REPO) == []
    target = "written = self.anonymiser.punctuate()"
    assert target in live, "worker flush drifted; update the injection"
    mutated = live.replace(
        target, "self.state.commit_epoch(epoch)\n        " + target, 1)
    bad = SourceFile(path="x", relpath=rel, text=mutated,
                     tree=ast.parse(mutated), suppressions={})
    assert any(f.rule == "DUR004" for f in durability.run([bad], REPO))


def test_durability_live_modules_are_clean():
    files = [SourceFile.load(os.path.join(REPO, rel), REPO)
             for rel in registry.DURABLE_MODULES]
    assert analysis.filter_suppressed(durability.run(files, REPO),
                                      files) == []


# ---- registry drift: config keys and metrics -------------------------------

_KEYS = {"service.known": "fixture key"}
_METRICS = {"known.metric": "fixture", "family.*": "fixture"}


def _run_registry(name, relpath):
    sf = _fixture(name, relpath, TORCH_FIXTURES)
    return sf, analysis.filter_suppressed(registry_drift.run(
        [sf], REPO, config_keys=_KEYS, metrics_reg=_METRICS,
        readme_text="", key_tuples={relpath: {"SERVICE_KEYS": "service"}},
        full_scope=False), [sf])


def test_registry_drift_fires_on_bad_fixture():
    sf, findings = _run_registry(
        "registry_bad.py", "reporter_tpu_torch/service/fixture_bad.py")
    _assert_matches_annotations(sf, findings, ("KN001", "MT001"))


def test_registry_drift_silent_on_good_fixture():
    assert _run_registry("registry_good.py",
                         "reporter_tpu_torch/service/fixture.py")[1] == []


def test_config_keys_are_every_parse_config_tuple():
    """The registry is exactly the keys of the tuples the config file's
    blocks accept (read at run time from the modules themselves)."""
    from reporter_tpu_torch import datastore
    from reporter_tpu_torch.pipeline import simple_reporter
    from reporter_tpu_torch.service import server
    from reporter_tpu_torch.streaming import worker
    want = {f"service.{k}" for k in (
        server.SERVICE_KEYS + server.MATCHER_KEYS + server.SERVER_KEYS
        + server.OBS_KEYS + server.FAULT_KEYS + server.CITY_KEYS)}
    want |= {f"worker.{k}" for k in worker.WORKER_KEYS}
    want |= {f"pipeline.{k}" for k in simple_reporter.PIPELINE_KEYS}
    want |= {f"datastore.{k}" for k in datastore.DATASTORE_KEYS}
    assert set(registry.CONFIG_KEYS) == want


def test_dead_key_and_readme_drift_detected(live_files):
    readme = _read(os.path.join(REPO, "README.md"))
    keys = dict(registry.CONFIG_KEYS, **{"service.ghost": "never read"})
    found = registry_drift.run(live_files, REPO, config_keys=keys,
                               readme_text=readme)
    assert {f.rule for f in found if "service.ghost" in f.message} \
        == {"KN001", "KN002"}
    # a live key dropped from the registry: its tuple entry fires KN001
    # and its README row KN002
    keys = dict(registry.CONFIG_KEYS)
    del keys["service.decode"]
    found = registry_drift.run(live_files, REPO, config_keys=keys,
                               readme_text=readme)
    assert any(f.rule == "KN001" and "service.decode" in f.message
               and f.path == "reporter_tpu_torch/service/server.py"
               for f in found)
    assert any(f.rule == "KN002" and f.path == "README.md"
               and "service.decode" in f.message for f in found)
    # a row dropped from README
    target = "| `service.racefuzz` |"
    assert target in readme
    cut = "\n".join(ln for ln in readme.splitlines()
                    if not ln.startswith(target))
    found = registry_drift.run(live_files, REPO, readme_text=cut)
    assert [f.rule for f in found if "service.racefuzz" in f.message] \
        == ["KN002"]


def test_a_declared_tuple_gone_from_its_module_is_reported(live_files):
    tuples = copy.deepcopy(registry_drift.KEY_TUPLES)
    tuples["reporter_tpu_torch/streaming/worker.py"]["GONE_KEYS"] = "worker"
    found = registry_drift.run(live_files, REPO, key_tuples=tuples)
    assert any(f.rule == "KN001" and "GONE_KEYS" in f.message
               for f in found)


def test_dead_and_unregistered_metrics_detected(live_files):
    found = registry_drift.run(
        live_files, REPO, metrics_reg=dict(registry.METRICS,
                                           **{"ghost.metric": "dead"}))
    assert any(f.rule == "MT002" and "ghost.metric" in f.message
               for f in found)
    metrics_reg = dict(registry.METRICS)
    del metrics_reg["egress.deadletter"]
    found = registry_drift.run(live_files, REPO, metrics_reg=metrics_reg,
                               full_scope=False)
    assert any(f.rule == "MT001" and "egress.deadletter" in f.message
               and f.path == "reporter_tpu_torch/streaming/anonymiser.py"
               for f in found)


# ---- fault coverage --------------------------------------------------------

def _run_faultcov(name, relpath):
    sf = _fixture(name, relpath)
    return sf, analysis.filter_suppressed(fault_coverage.run(
        [sf], REPO, sites={"known.site": "fixture"}, full_scope=False),
        [sf])


def test_faultcov_fires_on_bad_fixture():
    sf, findings = _run_faultcov(
        "faultcov_bad.py", "reporter_tpu_torch/streaming/fixture_bad.py")
    _assert_matches_annotations(sf, findings, ("FP001",))


def test_faultcov_silent_on_good_fixture():
    assert _run_faultcov("faultcov_good.py",
                         "reporter_tpu_torch/streaming/fixture.py")[1] == []


def test_faultcov_registry_mirrors_known_sites():
    from reporter_tpu_torch.utils import faults
    assert set(registry.FAULT_SITES) == set(faults.KNOWN_SITES)


def test_faultcov_live_drift_and_coverage_detected(live_files):
    sites = dict(registry.FAULT_SITES, **{"ghost.site": "nothing"})
    found = fault_coverage.run(live_files, REPO, sites=sites)
    assert {f.rule for f in found if "ghost.site" in f.message} \
        == {"FP001", "FP002", "FP003"}
    sites = dict(registry.FAULT_SITES)
    del sites["worker.offer"]
    found = fault_coverage.run(live_files, REPO, sites=sites)
    assert any(f.rule == "FP001" and "worker.offer" in f.message
               and f.path == "reporter_tpu_torch/streaming/worker.py"
               for f in found)


def test_faultcov_every_site_is_exercised(live_files):
    """FP003 against the port's exercise files: every registered site is
    armed by tests/test_torch_faults.py, the chaos tool or
    chip_smoke.py."""
    assert fault_coverage.EXERCISE_FILES == (
        "tests/test_torch_faults.py", "reporter_tpu_torch/tools/chaos.py",
        "chip_smoke.py")
    found = fault_coverage.run(live_files, REPO)
    assert [f.render() for f in found if f.rule == "FP003"] == []


def test_faultcov_a_site_only_a_chaos_scenario_arms_is_exercised(
        live_files):
    """A site armed only by a tools/chaos.py scenario counts as
    exercised; the same site armed nowhere is FP003."""
    sites = dict(registry.FAULT_SITES, **{"chaos.only": "fixture"})
    texts = ["", 'faults.configure("chaos.only=crash#1")', ""]
    found = fault_coverage.run(live_files, REPO, sites=sites,
                               exercise_texts=texts)
    assert not [f for f in found
                if f.rule == "FP003" and "chaos.only" in f.message]
    found = fault_coverage.run(live_files, REPO, sites=sites,
                               exercise_texts=["", "", ""])
    assert [f for f in found
            if f.rule == "FP003" and "chaos.only" in f.message]
    with open(os.path.join(REPO, fault_coverage.EXERCISE_FILES[1])) as f:
        chaos_text = f.read()
    assert "city.swap=crash#1" in chaos_text


# ---- failure domains -------------------------------------------------------

_FB_PAIRS = {
    "covered.circuit": {"fault_site": "native.prep",
                        "knob": "service.native",
                        "fallback": "numpy prep",
                        "parity_test": "tests/x.py::test_covered"},
    "card.circuit": {"fault_site": "decode.dispatch",
                     "knob": "service.decode", "fallback": "raises",
                     "parity_test": ("tests/x.py::test_card",
                                     "tests/x.py::TestCard::test_probe")},
}
_FB_TEXTS = {"tests/x.py": "def test_covered():\n    pass\n"
                           "def test_card():\n    pass\n"
                           "class TestCard:\n    def test_probe(self):\n"
                           "        pass\n"}


def _run_fallback(name, relpath, pairs=_FB_PAIRS, full_scope=False):
    sf = _fixture(name, relpath, TORCH_FIXTURES)
    return sf, analysis.filter_suppressed(fallback.run(
        [sf], REPO, pairs=pairs, test_texts=_FB_TEXTS,
        full_scope=full_scope), [sf])


def test_fallback_fires_on_bad_fixture():
    sf, findings = _run_fallback(
        "fallback_bad.py", "reporter_tpu_torch/service/fixture_bad.py")
    _assert_matches_annotations(sf, findings, ("FB001",))


def test_fallback_silent_on_good_fixture_in_full_scope():
    assert _run_fallback("fallback_good.py",
                         "reporter_tpu_torch/service/fixture.py",
                         full_scope=True)[1] == []


@pytest.mark.parametrize("leg", ["fault_site", "knob", "fallback",
                                 "parity_test"])
def test_fallback_missing_leg_detected(leg):
    pairs = copy.deepcopy(_FB_PAIRS)
    del pairs["card.circuit"][leg]
    found = _run_fallback("fallback_good.py",
                          "reporter_tpu_torch/service/fixture.py",
                          pairs=pairs)[1]
    assert [f.rule for f in found if f"{leg!r}" in f.message] == ["FB002"]


def test_fallback_unknown_config_key_and_dangling_test_detected():
    pairs = copy.deepcopy(_FB_PAIRS)
    pairs["covered.circuit"]["knob"] = "REPORTER_TPU_NATIVE"
    pairs["card.circuit"]["parity_test"] = ("tests/x.py::test_card",
                                            "tests/x.py::test_gone")
    found = _run_fallback("fallback_good.py",
                          "reporter_tpu_torch/service/fixture.py",
                          pairs=pairs, full_scope=True)[1]
    assert sorted(f.rule for f in found) == ["FB002", "FB003"]
    assert any("test_gone" in f.message for f in found)


def test_fallback_live_domains_fully_declared(live_files):
    """Every breaker the port constructs has its pair; the card's domains
    declare that they raise and point at the test that pins it."""
    assert analysis.filter_suppressed(fallback.run(live_files, REPO),
                                      live_files) == []
    card = "tests/test_torch_faults.py::" \
           "test_card_domains_refuse_and_never_degrade"
    for domain in ("matcher.circuit.decode", "matcher.circuit.route"):
        assert registry.FALLBACK_PAIRS[domain]["fallback"] == "raises"
        assert registry.FALLBACK_PAIRS[domain]["parity_test"] == card
    assert card in registry.FALLBACK_PAIRS["matcher.circuit"]["parity_test"]
    pairs = dict(registry.FALLBACK_PAIRS)
    del pairs["matcher.circuit.route"]
    found = fallback.run(live_files, REPO, pairs=pairs)
    assert any(f.rule == "FB001"
               and f.path == "reporter_tpu_torch/matcher/matcher.py"
               and "matcher.circuit.route" in f.message for f in found)


# ---- ABI: the host runtime -------------------------------------------------

def test_abi_fixture_pairs():
    cpp = _read(os.path.join(FIXTURES, "abi_good.cpp"))
    assert abi.check(cpp, _read(os.path.join(FIXTURES, "abi_good.py")),
                     "abi_good.cpp", "abi_good.py") == []
    found = abi.check(cpp, _read(os.path.join(FIXTURES, "abi_bad.py")),
                      "abi_good.cpp", "abi_bad.py")
    assert {f.rule for f in found} == {"ABI001", "ABI002", "ABI003",
                                       "ABI004", "ABI005"}


def test_abi_live_host_pair_validates():
    exports, version = abi.parse_cpp(_read(LIVE_CPP))
    from reporter_tpu_torch import native
    assert version == native.ABI_VERSION
    assert {"rt_prepare_batch", "rt_assemble_batch", "rt_report_json",
            "rt_tile_parse", "rt_route_memo_warm"} <= set(exports)
    assert abi.check(_read(LIVE_CPP), _read(LIVE_PY)) == []


def _host_copy(tmp_path, old, new, name):
    live = _read(LIVE_PY)
    assert live.count(old) == 1, "live binding drifted; update the test"
    path = tmp_path / name
    path.write_text(live.replace(old, new), encoding="utf-8")
    return abi.run_paths(LIVE_CPP, str(path), abi.DEFAULT_CPP, name)


def test_abi_host_drifts_are_caught(tmp_path):
    found = _host_copy(tmp_path, "lib.rt_json_double.argtypes = [f64, u8p]",
                       "lib.rt_json_double.argtypes = [f32p, u8p]", "a.py")
    assert any(f.rule == "ABI003" and "rt_json_double" in f.message
               for f in found)
    found = _host_copy(tmp_path, "lib.rt_json_double.argtypes = [f64, u8p]",
                       "lib.rt_json_double.argtypes = [f64]", "b.py")
    assert any(f.rule == "ABI002" and "rt_json_double" in f.message
               for f in found)


def test_abi_version_bump_is_caught(tmp_path):
    live = _read(LIVE_PY)
    mutated = re.sub(r"^ABI_VERSION = \d+", "ABI_VERSION = 999", live,
                     count=1, flags=re.MULTILINE)
    assert mutated != live
    path = tmp_path / "ver.py"
    path.write_text(mutated, encoding="utf-8")
    found = abi.run_paths(LIVE_CPP, str(path), abi.DEFAULT_CPP, "ver.py")
    assert [f.rule for f in found] == ["ABI004"]


# ---- ABI: the card's entry points ------------------------------------------

_CARD_NAMES = ("fixture_decode", "fixture_occupancy", "fixture_gone")


def test_abi_card_fixtures():
    cu = _read(os.path.join(TORCH_FIXTURES, "abi_card.cu"))
    assert set(abi.parse_cu(cu)) == {"fixture_decode", "fixture_occupancy"}
    assert abi.parse_cu(cu)["fixture_occupancy"] == (
        ("val", "i32"), [("val", "i32"), ("val", "i32"), ("ptr", "i32")])
    good = _read(os.path.join(TORCH_FIXTURES, "abi_card_good.py"))
    assert abi.check_card(cu, {"good.py": (good, _CARD_NAMES[:2])},
                          "abi_card.cu") == []
    rel = "tests/torch_lint_fixtures/abi_card_bad.py"
    sf = SourceFile.load(os.path.join(REPO, rel), REPO)
    found = abi.check_card(cu, {rel: (sf.text, _CARD_NAMES)}, "abi_card.cu")
    _assert_matches_annotations(sf, found, ("ABI001", "ABI002", "ABI003",
                                            "ABI005"))
    # an entry point no module binds
    found = abi.check_card(cu, {"good.py": (good, ("fixture_decode",))},
                           "abi_card.cu")
    assert [(f.rule, f.path) for f in found] == [("ABI001", "abi_card.cu")]


def test_abi_card_pairs_cover_all_seven_entry_points():
    names = sorted(n for _cu, mods in abi.CARD_PAIRS
                   for bound in mods.values() for n in bound)
    assert names == sorted(["viterbi_decode", "incremental_steps", "relax",
                            "relax_cluster_occupancy", "relax_cluster",
                            "relax_global", "pair_costs"])
    for cu, mods in abi.CARD_PAIRS:
        exports = abi.parse_cu(_read(os.path.join(REPO, cu)))
        assert set(exports) == {n for b in mods.values() for n in b}
    assert abi.run_card(REPO) == []


_VITERBI = "reporter_tpu_torch/ops/viterbi.py"
_VITERBI_ARGS = ("fn.argtypes = [p, p, p, p, p, i, i, i, i, i, "
                 "ctypes.c_float,")


@pytest.mark.parametrize("old,new,rule", [
    (_VITERBI_ARGS, "fn.argtypes = [p, p, p, p, i, i, i, i, i, i, "
                    "ctypes.c_float,", "ABI003"),
    (_VITERBI_ARGS, "fn.argtypes = [p, p, p, p, i, i, i, i, i, "
                    "ctypes.c_float,", "ABI002"),
])
def test_abi_card_binding_drift_is_caught(tmp_path, old, new, rule):
    """A copy of ops/viterbi.py with one ``p`` turned ``i``, or one
    argument dropped, fails the check of viterbi_decode."""
    live = _read(os.path.join(REPO, _VITERBI))
    assert live.count(old) == 1, "binding drifted; update the injection"
    path = tmp_path / "viterbi.py"
    path.write_text(live.replace(old, new), encoding="utf-8")
    found = abi.run_card(REPO, {_VITERBI: str(path)})
    assert [(f.rule, "viterbi_decode" in f.message) for f in found] \
        == [(rule, True)]


def test_abi_card_signature_gaining_an_argument_is_caught(tmp_path):
    cu_rel = "reporter_tpu_torch/ops/csrc/route_relax.cu"
    live = _read(os.path.join(REPO, cu_rel))
    old = 'extern "C" int pair_costs(const void* ints, const void* f32s,'
    assert live.count(old) == 1
    path = tmp_path / "route_relax.cu"
    path.write_text(live.replace(old, old + " int extra,"), encoding="utf-8")
    found = abi.run_card(REPO, {cu_rel: str(path)})
    assert [(f.rule, "pair_costs" in f.message) for f in found] \
        == [("ABI002", True)]


# ---- placement (DP rules) --------------------------------------------------

_DP_ENTRIES = {"kernel_entry"}


def _dp_run(pass_mod, sf):
    rel = sf.relpath
    return analysis.filter_suppressed(pass_mod.run(
        [sf], REPO, lanes=(f"{rel}::Lane.stage",),
        sync_points=(f"{rel}::Lane.drain",), entry_names=_DP_ENTRIES,
        full_scope=False), [sf])


def test_placement_fires_on_the_torch_fixture_as_the_jax_pass_on_its():
    """The JAX package's placement_bad.py and its torch restatement, line
    for line: each package's pass finds the same rules on the same
    lines."""
    from reporter_tpu.analysis import placement as jax_placement
    from reporter_tpu.analysis.core import SourceFile as JaxSource
    sf = _fixture("placement_bad.py",
                  "reporter_tpu_torch/matcher/fixture_bad.py",
                  TORCH_FIXTURES)
    got = _dp_run(placement, sf)
    _assert_matches_annotations(sf, got, ("DP001", "DP002", "DP003"))
    jsf = JaxSource.load(os.path.join(FIXTURES, "placement_bad.py"), REPO)
    jsf.relpath = "reporter_tpu/matcher/fixture_bad.py"
    want = jax_placement.run(
        [jsf], REPO, lanes=(f"{jsf.relpath}::Lane.stage",),
        sync_points=(f"{jsf.relpath}::Lane.drain",),
        entry_names=_DP_ENTRIES, full_scope=False)
    assert sorted((f.line, f.rule) for f in got) \
        == sorted((f.line, f.rule) for f in want)
    assert {f.rule for f in got} == {"DP001", "DP002", "DP003"}


def test_placement_fires_on_every_torch_sink():
    sf = _fixture("placement_sinks.py",
                  "reporter_tpu_torch/matcher/fixture_sinks.py",
                  TORCH_FIXTURES)
    findings = _dp_run(placement, sf)
    _assert_matches_annotations(sf, findings, ("DP001", "DP002", "DP003"))


def test_placement_silent_on_the_good_torch_fixture():
    sf = _fixture("placement_good.py",
                  "reporter_tpu_torch/matcher/fixture_good.py",
                  TORCH_FIXTURES)
    assert _dp_run(placement, sf) == []


def test_placement_live_lanes_are_disciplined(live_files):
    """The declared lanes bring device values to the host only at the
    declared sync points, each the counterpart of the JAX package's."""
    assert analysis.filter_suppressed(placement.run(live_files, REPO),
                                      live_files) == []
    from reporter_tpu.analysis import registry as jax_registry
    for table, ref in ((registry.DEVICE_LANES, jax_registry.DEVICE_LANES),
                       (registry.SYNC_POINTS, jax_registry.SYNC_POINTS)):
        assert {k.replace("reporter_tpu_torch/", "reporter_tpu/")
                for k in table} == set(ref)


def test_placement_undeclared_sync_on_a_lane_is_caught(live_files):
    """A copy to the host inlined into fill_prep's tail, past the
    declared write-back: DP001 at the real line on the prep lane."""
    rel = "reporter_tpu_torch/graph/route_device.py"
    live = _read(os.path.join(REPO, rel))
    target = "        pending.write_back(out)  # the one device-to-host"
    assert live.count(target) == 1, "fill_prep drifted; update the test"
    mutated = live.replace(target, (
        "        route, _mx = self._run(p.edge, p.offset, p.nk, p.bounds,\n"
        "                               p.caps, p.srcs, p.chunk_bound,\n"
        "                               btol, tpen)\n"
        "        out['route_m'][:B, :T - 1] = route.cpu().numpy()\n"
        + target), 1)
    bad = SourceFile(path="x", relpath=rel, text=mutated,
                     tree=ast.parse(mutated), suppressions={})
    files = [bad if sf.relpath == rel else sf for sf in live_files]
    found = placement.run(files, REPO)
    assert any(f.rule == "DP001" and f.path == rel and "'route'" in
               f.message for f in found), [f.render() for f in found]


def test_placement_dangling_registry_entries_are_caught(live_files):
    lanes = list(registry.DEVICE_LANES) + [
        "reporter_tpu_torch/matcher/matcher.py::SegmentMatcher._gone"]
    sync = list(registry.SYNC_POINTS) + [
        "reporter_tpu_torch/matcher/batchpad.py::PaddedBatch.gone"]
    found = placement.run(live_files, REPO, lanes=lanes, sync_points=sync)
    assert {(f.rule, f.path) for f in found} == {
        ("DP003", placement.REGISTRY_REL), ("DP001", placement.REGISTRY_REL)}


# ---- tensor contracts (TC rules) -------------------------------------------

@pytest.fixture(scope="module")
def fresh_contracts():
    return tensorcontract.compute_signatures()


def test_committed_contracts_are_a_subset_of_a_fresh_regeneration(
        fresh_contracts):
    with open(os.path.join(REPO, tensorcontract.CONTRACTS_REL),
              encoding="utf-8") as f:
        committed = json.load(f)
    assert committed["dims"].items() <= fresh_contracts["dims"].items()
    assert committed["buckets"] == fresh_contracts["buckets"]
    for key, entry in committed["entries"].items():
        assert tensorcontract._diff_entry(
            entry, fresh_contracts["entries"][key]) is None, key
    assert set(committed["entries"]) == set(registry.KERNEL_CONTRACTS)


def test_contract_dims_and_buckets_are_the_jax_files():
    with open(os.path.join(REPO, "tools", "kernel_contracts.json"),
              encoding="utf-8") as f:
        ref = json.load(f)
    assert list(tensorcontract.BUCKETS) == ref["buckets"]
    assert {k: tensorcontract.DIMS[k] for k in ref["dims"]} == ref["dims"]


def test_the_decode_contract_is_the_jax_scan_decodes(fresh_contracts):
    """The plain decode's cases equal the JAX contract of the scan decode
    it is held bit-equal to."""
    with open(os.path.join(REPO, "tools", "kernel_contracts.json"),
              encoding="utf-8") as f:
        ref = json.load(f)["entries"][
            "reporter_tpu/matcher/hmm.py::viterbi_decode_batch"]
    got = fresh_contracts["entries"][
        "reporter_tpu_torch/ops/viterbi.py::viterbi_cuda"]
    assert [(c["inputs"], c["outputs"]) for c in got["cases"]] \
        == [(c["inputs"], c["outputs"]) for c in ref["cases"]]


@pytest.mark.parametrize("mutation", ["dtype", "shape", "count",
                                      "keywords", "gone", "new"])
def test_tensorcontract_signature_drift_is_caught(live_files,
                                                  fresh_contracts,
                                                  mutation):
    fresh = copy.deepcopy(fresh_contracts)
    key = "reporter_tpu_torch/ops/viterbi.py::viterbi_cuda"
    entry = fresh["entries"][key]
    if mutation == "dtype":
        entry["cases"][0]["outputs"][1][1] = "float64"
    elif mutation == "shape":
        entry["cases"][1]["outputs"][0][0] = [8, 256, 1]
    elif mutation == "count":
        entry["cases"][0]["outputs"].pop()
    elif mutation == "keywords":
        entry["keyword_args"] = ["interpret"]
    elif mutation == "gone":
        del fresh["entries"][key]
    else:
        fresh["entries"]["reporter_tpu_torch/ops/x.py::x_cuda"] = entry
    found = tensorcontract.run(live_files, REPO, signatures=fresh)
    assert [f.rule for f in found] == ["TC001"], \
        [f.render() for f in found]


def test_tensorcontract_widening_plain_version_is_caught(live_files,
                                                         monkeypatch):
    """A plain version that widens its scores to f64: the fresh run on
    meta tensors differs from the committed file."""
    from reporter_tpu_torch.matcher import hmm
    real = hmm.viterbi_decode_batch

    def widened(*args, **kw):
        paths, scores = real(*args, **kw)
        return paths, scores.double()

    monkeypatch.setattr(hmm, "viterbi_decode_batch", widened)
    found = tensorcontract.run(live_files, REPO)
    assert [(f.rule, f.path) for f in found] == [
        ("TC001", "reporter_tpu_torch/ops/viterbi.py")]
    assert "float64" in found[0].message


def _tc2(files, contracts=None, entries=None):
    base = copy.deepcopy(registry.KERNEL_CONTRACTS)
    return [f for f in tensorcontract.run(
        files, REPO, contracts=contracts or base, entries=entries,
        signatures={"entries": {}},
        contracts_path=os.path.join(REPO, "no-such-file.json"))
        if f.rule == "TC002"]


def test_tensorcontract_uncontracted_wrapper_is_caught(live_files):
    src = ("def fixture_cuda(x):\n    fixture_cuda.launches += 1\n"
           "    return x\n\n\nfixture_cuda.launches = 0\n")
    sf = SourceFile(path="x", relpath="reporter_tpu_torch/ops/fixture.py",
                    text=src, tree=ast.parse(src), suppressions={})
    found = tensorcontract.run([sf], REPO, full_scope=False)
    assert [(f.rule, f.line) for f in found] == [("TC002", 6)]
    assert _tc2(live_files + [sf])[0].message.startswith(
        "counted kernel wrapper reporter_tpu_torch/ops/fixture.py::"
        "fixture_cuda")


def test_tensorcontract_three_sides_are_held(live_files):
    assert _tc2(live_files) == []
    bad = copy.deepcopy(registry.KERNEL_CONTRACTS)
    bad["reporter_tpu_torch/ops/viterbi.py::gone_cuda"] = dict(
        bad["reporter_tpu_torch/ops/viterbi.py::viterbi_cuda"])
    found = _tc2(live_files, bad)
    assert any("names no counted kernel wrapper" in f.message
               for f in found)
    bad = copy.deepcopy(registry.KERNEL_CONTRACTS)
    bad["reporter_tpu_torch/ops/route_relax.py::relax_cluster_cuda"][
        "entries"] = ("relax_cluster",)
    found = _tc2(live_files, bad)
    assert [f.message.split(" is ")[0] for f in found] == [
        'extern "C" relax_cluster_occupancy']
    bad = copy.deepcopy(registry.KERNEL_CONTRACTS)
    bad["reporter_tpu_torch/ops/viterbi.py::viterbi_cuda"][
        "entries"] = ("viterbi_decode", "viterbi_gone")
    bad["reporter_tpu_torch/ops/viterbi.py::viterbi_cuda"][
        "plain"] = "reporter_tpu_torch/matcher/hmm.py::gone"
    found = _tc2(live_files, bad)
    assert len(found) == 2
    assert any("viterbi_gone, which no card source defines" in f.message
               for f in found)
    assert any("plain version reporter_tpu_torch/matcher/hmm.py::gone"
               in f.message for f in found)


def test_tensorcontract_claims_the_abi_passes_seven_entries(live_files):
    entries = tensorcontract.card_entries(REPO)
    assert len(entries) == 7
    claimed = {n for c in registry.KERNEL_CONTRACTS.values()
               for n in c["entries"]}
    assert claimed == set(entries)
    assert set(tensorcontract.counted_wrappers(live_files)) \
        == set(registry.KERNEL_CONTRACTS)


def test_tensorcontract_missing_file_is_caught(live_files, tmp_path):
    found = tensorcontract.run(live_files, REPO,
                               contracts_path=str(tmp_path / "none.json"))
    assert [f.rule for f in found] == ["TC001"]


def test_tensorcontract_write_regenerates_the_file(tmp_path):
    out = tmp_path / "k.json"
    assert tensorcontract.main(["--out", str(out)]) == 0
    assert out.read_text() == _read(os.path.join(
        REPO, tensorcontract.CONTRACTS_REL))


# ---- the driver ------------------------------------------------------------

def _lint(*args):
    return subprocess.run(
        [sys.executable, "-m", "reporter_tpu_torch.tools.lint", *args],
        capture_output=True, text=True, cwd=REPO)


def test_live_tree_is_clean_with_the_empty_baseline():
    assert analysis.load_baseline(lint_cli.DEFAULT_BASELINE) == []
    assert _read(lint_cli.DEFAULT_BASELINE) == ""
    proc = _lint()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout


@pytest.mark.parametrize("flag", ["--abi-only", "--contracts-only",
                                  "--locks-only"])
def test_guards_pass_on_the_live_tree(flag):
    assert lint_cli.main([flag]) == 0


def test_abi_only_fails_on_a_drifted_host_binding(tmp_path):
    mutated = _read(LIVE_PY).replace(
        "lib.rt_json_double.argtypes = [f64, u8p]",
        "lib.rt_json_double.argtypes = [f32p, u8p]", 1)
    path = tmp_path / "bad.py"
    path.write_text(mutated, encoding="utf-8")
    assert lint_cli.main(["--abi-only", "--abi-py", str(path)]) == 1


def test_stale_baseline_entry_fails_the_run(tmp_path, capsys):
    stale = tmp_path / "baseline.txt"
    stale.write_text("reporter_tpu_torch/matcher/matcher.py:1: HP001 ghost\n",
                     encoding="utf-8")
    assert lint_cli.main(["--baseline", str(stale)]) == 1
    assert "stale baseline entry" in capsys.readouterr().out


def test_partial_run_and_write_baseline(tmp_path):
    base = tmp_path / "baseline.txt"
    base.write_text("reporter_tpu_torch/service/report.py:1: HP001 ghost\n",
                    encoding="utf-8")
    target = os.path.join(PKG, "matcher", "matcher.py")
    assert lint_cli.main([target, "--baseline", str(base)]) == 0
    assert lint_cli.main([target, "--write-baseline",
                          "--baseline", str(base)]) == 2
    assert lint_cli.main(["--write-baseline", "--baseline", str(base)]) == 0
    assert _read(str(base)) == ""


def test_list_rules_covers_every_ported_pass(capsys):
    assert lint_cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in ("HP001", "HP002", "HP003", "ABI001", "ABI002", "ABI003",
                 "ABI004", "ABI005", "LD001", "LD002", "LD003", "DUR001",
                 "DUR002", "DUR003", "DUR004", "KN001", "KN002", "MT001",
                 "MT002", "FP001", "FP002", "FP003", "FB001", "FB002",
                 "FB003", "RC001", "RC002", "RC003", "RC004", "DP001",
                 "DP002", "DP003", "TC001", "TC002"):
        assert rule in out
    assert set(analysis.ALL_RULES) == set(re.findall(r"^(\w+\d{3}) ", out,
                                                     re.MULTILINE))


def test_lint_is_not_an_umbrella_command():
    from reporter_tpu_torch import __main__ as umbrella
    src = _read(umbrella.__file__)
    assert "lint" not in re.findall(r'"(\w+)"', src)


# ---- the fuzz layer of utils/locks.py --------------------------------------

class TestFuzzLayer:
    def test_spec_grammar(self):
        s = port_locks.parse_fuzz_spec("7")
        assert (s.seed, s.prob, s.max_us) == (7, 0.25, 200.0)
        s = port_locks.parse_fuzz_spec("7:0.5@400")
        assert (s.seed, s.prob, s.max_us) == (7, 0.5, 400.0)
        s = port_locks.parse_fuzz_spec("9@50")
        assert (s.seed, s.prob, s.max_us) == (9, 0.25, 50.0)
        for bad in ("", "x", "7:0", "7:1.5", "7@0", "7@-3", "7:a@b"):
            with pytest.raises(ValueError):
                port_locks.parse_fuzz_spec(bad)

    def test_spec_fields_equal_the_jax_package(self):
        from reporter_tpu.utils import locks as jax_locks
        for spec in ("7", "7:0.5@400", "9@50", "3:1.0@1"):
            a = port_locks.parse_fuzz_spec(spec)
            b = jax_locks.parse_fuzz_spec(spec)
            assert (a.seed, a.prob, a.max_us) == (b.seed, b.prob, b.max_us)

    def test_replay_is_bit_identical_by_seed(self):
        def drive(mod, seed):
            spec = mod._FuzzSpec(seed, prob=0.5, max_us=1.0)
            out = []
            for _ in range(64):
                spec.maybe_yield("test.site")
                out.append(spec.yields)
            return out

        from reporter_tpu.utils import locks as jax_locks
        assert drive(port_locks, 5) == drive(port_locks, 5) \
            == drive(jax_locks, 5)
        # per-site streams are independent: a second site draws its own
        # sequence from crc32(site) ^ seed, unaffected by the first
        spec = port_locks._FuzzSpec(5, prob=0.5, max_us=1.0)
        for _ in range(10):
            spec.maybe_yield("other.site")
        base = spec.yields
        for _ in range(64):
            spec.maybe_yield("test.site")
        assert spec.yields - base == drive(port_locks, 5)[-1]

    def test_disarmed_fuzz_point_is_a_noop(self):
        port_locks.configure_fuzz(None)
        port_locks.fuzz_point("test.site")
        assert port_locks.fuzz_yields() == 0 and port_locks._FUZZ is None

    def test_configure_rejects_malformed(self):
        with pytest.raises(ValueError):
            port_locks.configure_fuzz("not-a-spec")
        port_locks.configure_fuzz(None)

    def test_armed_hooks_yield_at_locks_and_the_dispatcher(self):
        """Armed at prob 1, a tracked lock's acquire and the dispatcher's
        queue put and get each yield; the racefuzz config key arms and
        disarms it."""
        from reporter_tpu_torch.service.dispatch import BatchDispatcher
        from reporter_tpu_torch.service.server import configure_obs
        configure_obs({"racefuzz": "3:1.0@1"})
        try:
            lk = port_locks.new_lock("t.fuzz")
            with lk:
                pass
            assert port_locks.fuzz_yields() == 1
            d = BatchDispatcher(lambda traces: [{} for _ in traces],
                                max_batch=4, max_wait_ms=1.0)
            try:
                assert d.submit({"uuid": "a"}) == {}
            finally:
                d.close()
            sites = set(port_locks._FUZZ._rngs)
            assert {"lock.t.fuzz", "dispatch.queue.put",
                    "dispatch.queue.get"} <= sites
        finally:
            configure_obs({"racefuzz": None})
        assert port_locks._FUZZ is None and port_locks.fuzz_yields() == 0
        with pytest.raises(ValueError):
            configure_obs({"racefuzz": "seven"})
