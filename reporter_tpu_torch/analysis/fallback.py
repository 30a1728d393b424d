"""Failure-domain pass (FB rules): every breaker has a declared, proven leg.

Each circuit-broken path of the port is shippable only because what
serves when it fails is declared and tested: on the host a second
implementation held byte-equal to the first (numpy prep, per-trace
assembly, the Python writer, the batch path), on the card a refusal
(the port never degrades from the card to the CPU: the chunk raises,
the breaker opens and refuses until a probe closes it).
``registry.FALLBACK_PAIRS`` makes that a contract: one entry per circuit
domain, declaring the fault site that exercises it, the config key that
chooses its path, its ``fallback`` leg (a path, or ``"raises"``) and the
tests that pin that leg. This pass closes the loop in both directions:

FB001  a ``CircuitBreaker("<domain>", ...)`` constructed in the package
       with no FALLBACK_PAIRS entry for its domain: a failure domain
       shipping without its declared leg. (A breaker that guards no
       alternative path is a deliberate exception: suppress with
       ``# lint: ignore[FB001]`` and say why.)
FB002  a registry pair missing a leg (fault_site / knob / fallback /
       parity_test), naming a fault site or config key the registry does
       not know, or (reverse direction) declaring a domain no breaker in
       the package constructs.
FB003  a parity-test reference pointing at a file that does not exist
       or a test name the file does not contain: a dangling proof is no
       proof.

FB002's reverse direction and FB003's filesystem checks judge the
registry against the whole package and run only under
``full_scope=True`` (skipped by partial path runs, as the other contract
passes are).
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Mapping, Optional, Sequence

from . import registry
from .core import Finding, SourceFile, terminal_name

RULES = {
    "FB001": "circuit breaker domain with no FALLBACK_PAIRS entry",
    "FB002": "FALLBACK_PAIRS entry missing or mis-declaring a leg",
    "FB003": "dangling parity-test reference in FALLBACK_PAIRS",
}

REGISTRY_REL = "reporter_tpu_torch/analysis/registry.py"

#: the breaker class's own module: constructions there are the class
#: definition and its docstring examples, not real domains
_EXCLUDE_RELS = frozenset({"reporter_tpu_torch/utils/circuit.py",
                           REGISTRY_REL})

#: the legs every pair must declare (the domain itself is the key)
_LEGS = ("fault_site", "knob", "fallback", "parity_test")


def _registry_lines(repo_root: str) -> Dict[str, int]:
    """First-occurrence line of each string constant in registry.py, so
    registry-side findings point at the real entry."""
    path = os.path.join(repo_root, REGISTRY_REL)
    out: Dict[str, int] = {}
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError):
        return out
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.setdefault(node.value, node.lineno)
    return out


def _breaker_sites(files: Sequence[SourceFile]) -> List[tuple]:
    """(domain, relpath, lineno) for every literal-domain
    ``CircuitBreaker("...")`` construction in view."""
    sites = []
    for sf in files:
        if sf.relpath in _EXCLUDE_RELS:
            continue
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and terminal_name(node.func) == "CircuitBreaker"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            sites.append((node.args[0].value, sf.relpath, node.lineno))
    return sites


def _refs(value) -> List[str]:
    """A ``parity_test`` leg as a list of references (one, or a tuple)."""
    if not value:
        return []
    return [value] if isinstance(value, str) else list(value)


def run(files: Sequence[SourceFile], repo_root: str,
        pairs: Optional[Mapping[str, Mapping[str, object]]] = None,
        test_texts: Optional[Mapping[str, str]] = None,
        full_scope: bool = True) -> List[Finding]:
    """``pairs``/``test_texts`` are injectable for tests: ``test_texts``
    maps a parity-test file's repo-relative path to its text (default:
    read from ``repo_root``)."""
    if pairs is None:
        pairs = registry.FALLBACK_PAIRS
    findings: List[Finding] = []
    reg_lines = _registry_lines(repo_root)
    sites = _breaker_sites(files)

    # FB001: constructed breaker domain without a registry pair
    for domain, relpath, lineno in sites:
        if domain not in pairs:
            findings.append(Finding(
                relpath, lineno, "FB001",
                f"circuit domain {domain!r} has no registry."
                "FALLBACK_PAIRS entry — a failure domain needs a "
                "declared fault site, config key, fallback leg and "
                "parity test (or a justified suppression if this breaker "
                "guards no alternative path)"))

    # FB002 forward: each pair carries every leg, and the legs resolve
    # against the registry's own tables
    for domain in sorted(pairs):
        legs = pairs[domain]
        line = reg_lines.get(domain, 1)
        for leg in _LEGS:
            if not legs.get(leg):
                findings.append(Finding(
                    REGISTRY_REL, line, "FB002",
                    f"FALLBACK_PAIRS[{domain!r}] is missing the "
                    f"{leg!r} leg — the pair is not a full contract "
                    "without it"))
        fault_site = legs.get("fault_site")
        if fault_site and fault_site not in registry.FAULT_SITES:
            findings.append(Finding(
                REGISTRY_REL, reg_lines.get(fault_site, line), "FB002",
                f"FALLBACK_PAIRS[{domain!r}] names fault site "
                f"{fault_site!r} which is not in registry.FAULT_SITES "
                "— the domain cannot be fault-injected"))
        knob = legs.get("knob")
        if knob and knob not in registry.CONFIG_KEYS:
            findings.append(Finding(
                REGISTRY_REL, reg_lines.get(knob, line), "FB002",
                f"FALLBACK_PAIRS[{domain!r}] names config key {knob!r} "
                "which is not in registry.CONFIG_KEYS — an undocumented "
                "key chooses no path an operator can find"))

    if not full_scope:
        return findings

    # FB002 reverse: a registered pair whose domain no breaker in the
    # package constructs
    constructed = {domain for domain, _, _ in sites}
    for domain in sorted(set(pairs) - constructed):
        findings.append(Finding(
            REGISTRY_REL, reg_lines.get(domain, 1), "FB002",
            f"FALLBACK_PAIRS[{domain!r}] matches no CircuitBreaker "
            "construction in the package — dead pair entries hide "
            "real coverage gaps"))

    # FB003: each parity-test reference points at a real file and names
    # that the file contains
    for domain in sorted(pairs):
        for ref in _refs(pairs[domain].get("parity_test")):
            line = reg_lines.get(ref, reg_lines.get(domain, 1))
            relpath, _, name = ref.partition("::")
            if test_texts is not None:
                text = test_texts.get(relpath)
            else:
                try:
                    with open(os.path.join(repo_root, relpath),
                              encoding="utf-8") as f:
                        text = f.read()
                except OSError:
                    text = None
            if text is None:
                findings.append(Finding(
                    REGISTRY_REL, line, "FB003",
                    f"FALLBACK_PAIRS[{domain!r}] parity test {ref!r} "
                    "points at a file that does not exist"))
                continue
            missing = [part for part in name.split("::")
                       if part and f"def {part}" not in text
                       and f"class {part}" not in text]
            if not name or missing:
                findings.append(Finding(
                    REGISTRY_REL, line, "FB003",
                    f"FALLBACK_PAIRS[{domain!r}] parity test {ref!r} "
                    f"names {missing[0] if missing else '(nothing)'!r} "
                    f"which {relpath} does not define — a dangling "
                    "proof is no proof"))
    return findings
