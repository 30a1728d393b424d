"""Shared machinery for the port's lint passes.

Every pass consumes :class:`SourceFile` objects (parsed once, shared) and
emits :class:`Finding` rows rendered ``path:line: RULE-ID message`` — the
grep-able contract the driver, the baseline file and CI all speak.

Suppression: a ``# lint: ignore[RULE-ID]`` comment on the flagged line or
the line directly above silences that rule there (comma-separate several
ids; ``*`` silences every rule). Suppressions are for *documented* false
positives — the comment next to them should say why.

Baseline: a committed text file of rendered findings (one per line, ``#``
comments allowed). The driver fails on findings missing from the baseline
AND on baseline entries that no longer fire (stale entries would silently
mask a future regression at the same site).
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*ignore\[([A-Za-z0-9_\-,\s\*]+)\]")


@dataclass(frozen=True, order=True)
class Finding:
    """One diagnostic: ``path:line: rule message``. ``path`` is repo-relative
    with forward slashes so renderings are stable across hosts."""

    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclass
class SourceFile:
    """A parsed Python source file plus its suppression map."""

    path: str          # absolute
    relpath: str       # repo-relative, forward slashes
    text: str
    tree: ast.AST
    # line -> set of rule ids suppressed on that line ("*" = all)
    suppressions: Dict[int, Set[str]] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str, repo_root: str) -> "SourceFile":
        with open(path, encoding="utf-8") as f:
            text = f.read()
        rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
        tree = ast.parse(text, filename=rel)
        return cls(path=path, relpath=rel, text=text, tree=tree,
                   suppressions=parse_suppressions(text))

    def suppressed(self, rule: str, line: int) -> bool:
        for ln in (line, line - 1):
            rules = self.suppressions.get(ln)
            if rules and (rule in rules or "*" in rules):
                return True
        return False


def parse_suppressions(text: str) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def filter_suppressed(findings: Iterable[Finding],
                      files: Sequence[SourceFile]) -> List[Finding]:
    by_rel = {f.relpath: f for f in files}
    kept = []
    for fnd in findings:
        sf = by_rel.get(fnd.path)
        if sf is not None and sf.suppressed(fnd.rule, fnd.line):
            continue
        kept.append(fnd)
    return kept


def collect_py_files(repo_root: str,
                     roots: Optional[Sequence[str]] = None
                     ) -> List[SourceFile]:
    """Parse every .py under ``roots`` (default: the reporter_tpu_torch
    package). Explicit file paths are accepted alongside directories."""
    if not roots:
        roots = [os.path.join(repo_root, "reporter_tpu_torch")]
    paths: List[str] = []
    for root in roots:
        if os.path.isfile(root):
            paths.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            for name in sorted(filenames):
                if name.endswith(".py"):
                    paths.append(os.path.join(dirpath, name))
    return [SourceFile.load(p, repo_root) for p in sorted(set(paths))]


# ---- baseline --------------------------------------------------------------

def load_baseline(path: str) -> List[str]:
    if not os.path.exists(path):
        return []
    entries = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                entries.append(line)
    return entries


def compare_baseline(findings: Sequence[Finding],
                     baseline: Sequence[str]
                     ) -> Tuple[List[Finding], List[str]]:
    """(new findings not in baseline, stale baseline entries)."""
    rendered = [f.render() for f in findings]
    have = set(rendered)
    base = set(baseline)
    new = [f for f, r in zip(findings, rendered) if r not in base]
    stale = [b for b in baseline if b not in have]
    return new, stale


# ---- small AST helpers shared by the passes --------------------------------

def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def terminal_name(node: ast.AST) -> Optional[str]:
    """Last identifier of a Name/Attribute chain ('self._lock' -> '_lock')."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None
