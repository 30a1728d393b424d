"""Registry-drift pass (KN/MT rules): config keys and metric names,
two-sided.

The config file's keys and the metric names on /stats are operator API:
a key README does not document is undiscoverable, a documented key the
code no longer accepts fails every config that sets it, and a renamed
metric breaks every dashboard reading the old name. The JAX package's
KN rules check ``REPORTER_TPU_*`` environment knobs; the port reads none,
and its config keys stand for them (``service/server.py``'s table).

All checks are two-sided against :mod:`registry` (the single source of
truth), so the lists can neither rot nor bloat:

KN001  key drift between the code and the registry: a key of one of the
       config-key tuples ``parse_config`` and its blocks accept
       (``KEY_TUPLES``: the service block's six tuples, the worker's and
       the pipeline's blocks, the datastore object's knobs) missing from
       ``registry.CONFIG_KEYS`` as ``<block>.<key>``, or a registered key
       no tuple holds (or a declared tuple gone from its module).
KN002  key drift between the registry and README's key table: a
       registered key with no row, or a row for an unregistered key. Rows
       name keys in full, ``block.key`` in backticks.
MT001  a metric name passed to the metrics layer (``count``/``timer``/
       ``observe`` on a metrics registry) that no registry entry
       covers. Literal names must match an exact entry or a ``prefix.*``
       pattern; f-strings with a static prefix must match a pattern.
       Names that are dynamic from the first character (the circuit
       breaker's ``f"{self.name}.opened"``) are unresolvable and
       skipped: register the instantiated family as a pattern.
MT002  a dead exact registry entry: no string literal anywhere in the
       scanned code matches it. Pattern entries are exempt: they exist
       because their call sites are dynamic.

The registry and this package are excluded from the code scans (the
registry must not witness itself).
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import registry
from .core import Finding, SourceFile

RULES = {
    "KN001": "config key drift between the code and the registry",
    "KN002": "config key drift between the registry and README's table",
    "MT001": "metric name not covered by the registry",
    "MT002": "dead registry metric entry (no call site or literal)",
}

_METRIC_SINKS = frozenset({"count", "timer", "observe"})
_METRIC_BASES = frozenset({"metrics", "registry", "_registry", "default",
                           "reg"})
#: package paths excluded from the code-side scans: the registry must
#: not be its own evidence, and fixtures are not product code.
_SELF = "reporter_tpu_torch/analysis/"
#: analysis/ modules that ARE product code (the runtime concurrency
#: witness emits real metrics), exempt from the self-skip.
_RUNTIME_IN_SELF = ("reporter_tpu_torch/analysis/racecheck.py",)

#: module relpath -> {tuple name: config block}: the tuples of keys the
#: config file's blocks accept
KEY_TUPLES: Dict[str, Dict[str, str]] = {
    "reporter_tpu_torch/service/server.py": {
        name: "service" for name in (
            "SERVICE_KEYS", "MATCHER_KEYS", "SERVER_KEYS", "OBS_KEYS",
            "FAULT_KEYS", "CITY_KEYS")},
    "reporter_tpu_torch/streaming/worker.py": {"WORKER_KEYS": "worker"},
    "reporter_tpu_torch/pipeline/simple_reporter.py": {
        "PIPELINE_KEYS": "pipeline"},
    "reporter_tpu_torch/datastore/__init__.py": {
        "DATASTORE_KEYS": "datastore"},
}

README_KEY_HEADER = "### The port's configuration keys"
_KEY_CELL_RE = re.compile(
    r"`((?:service|worker|pipeline|datastore)\.[a-z0-9_]+)`")


def _self_excluded(relpath: str) -> bool:
    return relpath.startswith(_SELF) and relpath not in _RUNTIME_IN_SELF


def _config_keys(files: Sequence[SourceFile],
                 key_tuples: Dict[str, Dict[str, str]]
                 ) -> Tuple[Dict[str, Tuple[str, int]],
                            List[Tuple[str, str]]]:
    """({"block.key": (relpath, line)} of every key in a declared tuple
    in view, [(relpath, tuple name) declared but not found in a module in
    view])."""
    keys: Dict[str, Tuple[str, int]] = {}
    missing: List[Tuple[str, str]] = []
    for sf in files:
        tuples = key_tuples.get(sf.relpath)
        if not tuples:
            continue
        found = set()
        for node in sf.tree.body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id in tuples):
                continue
            name = node.targets[0].id
            found.add(name)
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Constant) \
                        and isinstance(sub.value, str):
                    keys.setdefault(f"{tuples[name]}.{sub.value}",
                                    (sf.relpath, sub.lineno))
        missing += [(sf.relpath, n) for n in sorted(set(tuples) - found)]
    return keys, missing


def parse_readme_keys(readme_text: str) -> Dict[str, int]:
    """{"block.key": line} from the rows (lines starting with ``|``) of
    README's port key table, the section under ``README_KEY_HEADER`` up
    to the next heading."""
    out: Dict[str, int] = {}
    in_section = False
    for i, line in enumerate(readme_text.splitlines(), start=1):
        if line.startswith("#"):
            in_section = line.strip() == README_KEY_HEADER
            continue
        if in_section and line.lstrip().startswith("|"):
            for name in _KEY_CELL_RE.findall(line):
                out.setdefault(name, i)
    return out


# ---- metric call-site extraction -------------------------------------------

def _metric_name_glob(node: ast.AST) -> Optional[str]:
    """A metric-name argument as a match glob: literal strings verbatim,
    f-strings with each dynamic field collapsed to ``*`` (only when the
    leading part is static); None = unresolvable (skipped)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts: List[str] = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                parts.append("*")
        if not parts or parts[0] == "*":
            return None  # dynamic from the first char: unresolvable
        glob = "".join(parts)
        while "**" in glob:
            glob = glob.replace("**", "*")
        return glob
    return None


def _metric_sites(files: Sequence[SourceFile]
                  ) -> List[Tuple[str, int, str]]:
    """(relpath, line, name-glob) for every resolvable metric-name
    argument at a metrics-layer call site."""
    out: List[Tuple[str, int, str]] = []
    for sf in files:
        if _self_excluded(sf.relpath):
            continue
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _METRIC_SINKS):
                continue
            base = node.func.value
            base_name = base.attr if isinstance(base, ast.Attribute) \
                else base.id if isinstance(base, ast.Name) else None
            if base_name not in _METRIC_BASES:
                continue
            if not node.args:
                continue
            glob = _metric_name_glob(node.args[0])
            if glob is not None:
                out.append((sf.relpath, node.lineno, glob))
    return out


def _covered(glob: str, metrics_reg: Dict[str, str]) -> bool:
    """Is a call-site name glob covered by the registry? A literal name
    must equal an exact entry or extend a ``prefix.*`` pattern (a
    truncated literal that merely prefixes a pattern is a typo, not
    covered); an f-string glob's static prefix must be compatible with
    a pattern (either side extending the other) or with an exact entry
    it prefixes."""
    if "*" not in glob:
        if glob in metrics_reg:
            return True
        return any(entry.endswith("*") and glob.startswith(entry[:-1])
                   for entry in metrics_reg)
    prefix = glob.split("*", 1)[0]
    for entry in metrics_reg:
        if entry.endswith("*"):
            ep = entry[:-1]
            if prefix.startswith(ep) or ep.startswith(prefix):
                return True
        elif entry.startswith(prefix):
            return True
    return False


def _string_literals(files: Sequence[SourceFile]) -> Set[str]:
    out: Set[str] = set()
    for sf in files:
        if _self_excluded(sf.relpath):
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, str):
                out.add(node.value)
    return out


REGISTRY_REL = "reporter_tpu_torch/analysis/registry.py"


def _registry_lines(repo_root: str) -> Dict[str, int]:
    """{entry string: line in registry.py} so registry-side findings
    point at the entry to delete/fix."""
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


README_REL = "README.md"


def run(files: Sequence[SourceFile], repo_root: str,
        config_keys: Optional[Dict[str, str]] = None,
        metrics_reg: Optional[Dict[str, str]] = None,
        readme_text: Optional[str] = None,
        key_tuples: Optional[Dict[str, Dict[str, str]]] = None,
        full_scope: bool = True) -> List[Finding]:
    """``full_scope=False`` (a partial or fixture run) checks only the
    code -> registry direction: the reverse directions (dead keys, dead
    metrics, README drift) need the whole package in view."""
    config_keys = dict(registry.CONFIG_KEYS if config_keys is None
                       else config_keys)
    metrics_reg = dict(registry.METRICS if metrics_reg is None
                       else metrics_reg)
    key_tuples = KEY_TUPLES if key_tuples is None else key_tuples
    if readme_text is None:
        try:
            with open(os.path.join(repo_root, README_REL),
                      encoding="utf-8") as f:
                readme_text = f.read()
        except OSError:
            readme_text = ""
    reg_lines = _registry_lines(repo_root)
    findings: List[Finding] = []

    # ---- KN001: code <-> registry ------------------------------------------
    in_code, missing = _config_keys(files, key_tuples)
    for name in sorted(in_code):
        if name not in config_keys:
            rel, line = in_code[name]
            findings.append(Finding(
                rel, line, "KN001",
                f"config key {name} is accepted here but not in "
                "registry.CONFIG_KEYS — register it (and add a README "
                "key-table row)"))
    for rel, tuple_name in missing:
        findings.append(Finding(
            rel, 1, "KN001",
            f"config-key tuple {tuple_name} is declared in "
            "registry_drift.KEY_TUPLES but not assigned here"))
    if full_scope:
        for name in sorted(config_keys):
            if name not in in_code:
                findings.append(Finding(
                    REGISTRY_REL, reg_lines.get(name, 1), "KN001",
                    f"registered config key {name} is in no config-key "
                    "tuple of the code — dead entry, remove it"))

    # ---- KN002: registry <-> README table ----------------------------------
    if full_scope:
        table = parse_readme_keys(readme_text)
        for name in sorted(config_keys):
            if name not in table:
                findings.append(Finding(
                    REGISTRY_REL, reg_lines.get(name, 1), "KN002",
                    f"registered config key {name} has no row in "
                    "README's port key table — document it"))
        for name in sorted(table):
            if name not in config_keys:
                findings.append(Finding(
                    README_REL, table[name], "KN002",
                    f"README documents config key {name} but it is not "
                    "in registry.CONFIG_KEYS — stale doc or missing "
                    "registration"))

    # ---- MT001: call sites -> registry -------------------------------------
    for rel, line, glob in _metric_sites(files):
        if not _covered(glob, metrics_reg):
            findings.append(Finding(
                rel, line, "MT001",
                f"metric name {glob!r} is not covered by "
                "registry.METRICS — register it (exact, or a "
                "'prefix.*' pattern for dynamic families)"))

    # ---- MT002: registry -> code literals ----------------------------------
    if full_scope:
        literals = _string_literals(files)
        for entry in sorted(metrics_reg):
            if entry.endswith("*"):
                continue  # dynamic family: call sites are f-strings
            if entry not in literals:
                findings.append(Finding(
                    REGISTRY_REL, reg_lines.get(entry, 1), "MT002",
                    f"registry metric {entry!r} matches no string "
                    "literal in the code — dead entry, remove it"))

    return findings
