"""Fault-coverage pass (FP rules): every failpoint is real and proven.

The failpoint layer is only worth its hooks if the site table
stays honest: a ``failpoint("typo.site")`` never fires and silently
runs a faultless fault test; a ``KNOWN_SITES`` entry with no call site
documents a hook that does not exist; and a site no fault test or card
run ever arms is an untested failure domain — the exact thing
the layer exists to prevent.

FP001  site-name drift: a ``failpoint(site)`` call whose literal site is
       not in ``registry.FAULT_SITES``; a non-literal site argument
       (unauditable); or ``utils/faults.py``'s ``KNOWN_SITES`` /
       the registry disagreeing (they must be identical — the runtime
       warning table and the lint contract are the same list).
FP002  a registered site with NO ``failpoint()`` call site: the hook
       the registry promises was removed (or never landed).
FP003  a registered site exercised by none of a
       ``tests/test_torch_faults.py`` case, a ``tools/chaos.py`` scenario
       and ``chip_smoke.py``'s phases on the card (substring scan of the
       three files — specs are strings, so the site name appears
       verbatim wherever it is armed).
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import registry
from .core import Finding, SourceFile, terminal_name

RULES = {
    "FP001": "failpoint site unknown to the registry (or registry/"
             "KNOWN_SITES drift)",
    "FP002": "registered fault site with no failpoint() call site",
    "FP003": "registered fault site exercised by no fault test or card "
             "run",
}

FAULTS_REL = "reporter_tpu_torch/utils/faults.py"
REGISTRY_REL = "reporter_tpu_torch/analysis/registry.py"
#: where a site must be exercised (relative to the repo root)
EXERCISE_FILES = ("tests/test_torch_faults.py",
                  "reporter_tpu_torch/tools/chaos.py", "chip_smoke.py")


def _call_sites(files: Sequence[SourceFile]
                ) -> Tuple[Dict[str, List[Tuple[str, int]]],
                           List[Tuple[str, int]]]:
    """({site: [(relpath, line)]}, [unresolvable call locations]) over
    every ``failpoint(...)`` call outside utils/faults.py itself."""
    sites: Dict[str, List[Tuple[str, int]]] = {}
    opaque: List[Tuple[str, int]] = []
    for sf in files:
        if sf.relpath in (FAULTS_REL, REGISTRY_REL):
            continue
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and terminal_name(node.func) == "failpoint"):
                continue
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                sites.setdefault(node.args[0].value, []).append(
                    (sf.relpath, node.lineno))
            else:
                opaque.append((sf.relpath, node.lineno))
    return sites, opaque


def _known_sites_ast(files: Sequence[SourceFile]
                     ) -> Optional[Tuple[Set[str], int]]:
    """(KNOWN_SITES entries, line) parsed from utils/faults.py."""
    for sf in files:
        if sf.relpath != FAULTS_REL:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == "KNOWN_SITES":
                entries: Set[str] = set()
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Constant) \
                            and isinstance(sub.value, str):
                        entries.add(sub.value)
                return entries, node.lineno
    return None


def _registry_lines(repo_root: str) -> Dict[str, int]:
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


def run(files: Sequence[SourceFile], repo_root: str,
        sites: Optional[Dict[str, str]] = None,
        exercise_texts: Optional[Sequence[str]] = None,
        full_scope: bool = True) -> List[Finding]:
    """``full_scope=False`` (partial/fixture runs) checks only FP001 on
    the given files — FP002/FP003 need the whole package in view."""
    sites = dict(registry.FAULT_SITES if sites is None else sites)
    reg_lines = _registry_lines(repo_root)
    findings: List[Finding] = []

    call_sites, opaque = _call_sites(files)
    for name in sorted(call_sites):
        if name not in sites:
            for rel, line in call_sites[name]:
                findings.append(Finding(
                    rel, line, "FP001",
                    f"failpoint site {name!r} is not in "
                    "registry.FAULT_SITES — a typo'd site never fires "
                    "(register it and mirror KNOWN_SITES)"))
    for rel, line in opaque:
        findings.append(Finding(
            rel, line, "FP001",
            "failpoint() with a non-literal site name — fault coverage "
            "cannot be audited statically; use a string literal"))

    known = _known_sites_ast(files)
    if known is not None:
        entries, line = known
        for name in sorted(entries - set(sites)):
            findings.append(Finding(
                FAULTS_REL, line, "FP001",
                f"KNOWN_SITES entry {name!r} is missing from "
                "registry.FAULT_SITES — the two lists must be "
                "identical"))
        for name in sorted(set(sites) - entries):
            findings.append(Finding(
                FAULTS_REL, line, "FP001",
                f"registry.FAULT_SITES entry {name!r} is missing from "
                "KNOWN_SITES — arming it would warn as unknown at "
                "runtime"))

    if not full_scope:
        return findings

    for name in sorted(sites):
        if name not in call_sites:
            findings.append(Finding(
                REGISTRY_REL, reg_lines.get(name, 1), "FP002",
                f"registered fault site {name!r} has no failpoint() "
                "call site — the hook it promises does not exist"))

    if exercise_texts is None:
        exercise_texts = []
        for rel in EXERCISE_FILES:
            try:
                with open(os.path.join(repo_root, rel),
                          encoding="utf-8") as f:
                    exercise_texts.append(f.read())
            except OSError:
                exercise_texts.append("")
    blob = "\n".join(exercise_texts)
    for name in sorted(sites):
        if name not in blob:
            findings.append(Finding(
                REGISTRY_REL, reg_lines.get(name, 1), "FP003",
                f"fault site {name!r} is exercised by no "
                "tests/test_torch_faults.py case, tools/chaos.py scenario "
                "or chip_smoke.py phase — an untested failure domain"))

    return findings
