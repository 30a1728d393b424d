"""Durability pass (DUR rules): the atomic-commit discipline, statically.

The crash-consistency story rests on one protocol — write a temp
file, fsync it, ``os.replace`` it over the final name, fsync the parent
directory — and on the exactly-once-ish egress ordering (epoch marker
committed only after the sink ack). Both were conventions; this pass
pins them on the declared durable-module set
(:data:`registry.DURABLE_MODULES`, the modules whose writes land under
durable roots: datastore partitions, state snapshots, tile sinks and
dead-letter spools).

DUR001  bare ``open(path, "w"/"wb"/"a")`` of a non-temp path in a
        durable module: a crash mid-write leaves a torn final file
        (worse: under a deterministic epoch name the marker may say it
        committed). Write through ``utils.fsio.atomic_write_*`` or the
        tmp+replace protocol. A path is "temp" when its expression
        mentions a tmp-ish name or a dot-prefixed constant.
DUR002  ``os.replace(tmp, final)`` with no fsync of the written temp
        content anywhere before it in the function: rename is atomic
        but NOT durable — power loss can surface the new name empty.
        Function-granular by design: ANY earlier fsync satisfies it (a
        per-file dataflow association is beyond a syntactic pass), so a
        multi-artifact commit that fsyncs one temp but not another
        still passes — review owns per-file completeness; the pass owns
        "there is no fsync at all".
DUR003  no directory fsync after the ``os.replace``: the rename itself
        lives in the directory inode and needs the same barrier
        (``fsio.fsync_dir`` / a ``_fsync_dir`` helper).
DUR004  epoch-marker ordering: in the functions annotated in
        :data:`registry.EPOCH_COMMIT_CONTRACTS`, a commit call (e.g.
        ``commit_epoch``) reachable on a path that has NOT passed the
        ack call (``punctuate``) — the marker would declare an epoch
        durable that never reached the sink.

DUR002/003 only judge replaces whose SOURCE is temp-ish: renames of
already-committed files (ingest quarantine) are not commits and stay
out of scope.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Tuple

from . import registry
from .core import Finding, SourceFile, terminal_name

RULES = {
    "DUR001": "bare write into a durable root (no tmp+replace commit)",
    "DUR002": "os.replace of a temp file never fsync'd before the rename",
    "DUR003": "no directory fsync after an os.replace commit",
    "DUR004": "epoch marker committed before (or without) the sink ack",
}

_FSYNC_NAMES = frozenset({"fsync", "fsync_path", "fsync_file"})
_DIR_FSYNC_NAMES = frozenset({"fsync_dir", "_fsync_dir"})


def _is_tmpish(node: ast.AST) -> bool:
    """Does a path expression look like a temp name? (mentions a name
    containing "tmp", or a dot-prefixed / tmp-suffixed string constant)"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and "tmp" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and "tmp" in sub.attr.lower():
            return True
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            v = sub.value
            if "tmp" in v.lower() or v.startswith("."):
                return True
    return False


def _open_mode(call: ast.Call) -> Optional[str]:
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
            and isinstance(call.args[1].value, str):
        return call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    return None  # default "r"


class _FuncScan:
    """One function's durability-relevant events, in source order."""

    def __init__(self) -> None:
        self.opens: List[Tuple[int, ast.Call]] = []      # write-mode opens
        self.replaces: List[Tuple[int, ast.Call]] = []   # os.replace calls
        self.fsync_lines: List[int] = []
        self.dir_fsync_lines: List[int] = []


def _scan_function(fn: ast.AST) -> _FuncScan:
    out = _FuncScan()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        leaf = terminal_name(node.func)
        if leaf == "open" and isinstance(node.func, ast.Name):
            mode = _open_mode(node)
            if mode is not None and mode.replace("+", "") \
                    .replace("b", "") in ("w", "a", "x"):
                out.opens.append((node.lineno, node))
        elif leaf == "replace" and isinstance(node.func, ast.Attribute) \
                and terminal_name(node.func.value) == "os":
            out.replaces.append((node.lineno, node))
        elif leaf in _FSYNC_NAMES:
            out.fsync_lines.append(node.lineno)
        elif leaf in _DIR_FSYNC_NAMES:
            out.dir_fsync_lines.append(node.lineno)
    return out


# ---- DUR004: commit-after-ack ordering -------------------------------------

def _contains_call(stmt: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Call) and terminal_name(n.func) == name
               for n in ast.walk(stmt))


def _call_positions(node: ast.AST, name: str) -> List[Tuple[int, int]]:
    return [(n.lineno, n.col_offset) for n in ast.walk(node)
            if isinstance(n, ast.Call) and terminal_name(n.func) == name]


def _check_fragment(node: ast.AST, ack: str, commit: str, acked: bool,
                    bad: List[int]) -> bool:
    """Judge one straight-line fragment (a simple statement, or a
    compound statement's header expression): a commit is bad unless the
    ack already ran, or an ack call appears lexically before it in the
    same fragment (evaluation order for non-pathological code)."""
    acks = _call_positions(node, ack)
    for pos in _call_positions(node, commit):
        if not acked and not any(a < pos for a in acks):
            bad.append(pos[0])
    return acked or bool(acks)


def _check_ordering(body: Sequence[ast.stmt], ack: str, commit: str,
                    acked: bool, bad: List[int]) -> bool:
    """Walk a statement list tracking "has the ack definitely run".
    Records line numbers of commit calls reachable while un-acked.
    Compound statements recurse (their bodies own their own judgement);
    only their header expressions are judged at this level. Returns the
    acked state at the end of the list."""
    for stmt in body:
        if isinstance(stmt, ast.If):
            acked = _check_fragment(stmt.test, ack, commit, acked, bad)
            a = _check_ordering(stmt.body, ack, commit, acked, bad)
            b = _check_ordering(stmt.orelse, ack, commit, acked, bad)
            acked = a and b
        elif isinstance(stmt, (ast.For, ast.While)):
            header = stmt.iter if isinstance(stmt, ast.For) else stmt.test
            acked = _check_fragment(header, ack, commit, acked, bad)
            # loop body may run zero times: state does not advance
            _check_ordering(stmt.body, ack, commit, acked, bad)
            _check_ordering(stmt.orelse, ack, commit, acked, bad)
        elif isinstance(stmt, ast.Try):
            # the body may be cut short by the exception: handlers run
            # with the ENTRY state, and only finally advances it
            _check_ordering(stmt.body, ack, commit, acked, bad)
            for h in stmt.handlers:
                _check_ordering(h.body, ack, commit, acked, bad)
            acked = _check_ordering(stmt.finalbody, ack, commit,
                                    acked, bad)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                acked = _check_fragment(item.context_expr, ack, commit,
                                        acked, bad)
            acked = _check_ordering(stmt.body, ack, commit, acked, bad)
        else:
            acked = _check_fragment(stmt, ack, commit, acked, bad)
    return acked


def _iter_functions(tree: ast.AST):
    """(qualname, node) for every function/method, outermost class path
    included."""
    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield prefix + child.name, child
                yield from walk(child, prefix + child.name + ".")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, prefix + child.name + ".")
    yield from walk(tree, "")


def run(files: Sequence[SourceFile], repo_root: str,
        modules: Optional[Sequence[str]] = None,
        contracts: Optional[Dict[str, Tuple[str, str]]] = None
        ) -> List[Finding]:
    modules = tuple(modules if modules is not None
                    else registry.DURABLE_MODULES)
    contracts = dict(registry.EPOCH_COMMIT_CONTRACTS
                     if contracts is None else contracts)
    findings: List[Finding] = []
    for sf in files:
        in_durable = sf.relpath in modules
        for qualname, fn in _iter_functions(sf.tree):
            key = f"{sf.relpath}::{qualname}"
            if key in contracts:
                ack, commit = contracts[key]
                bad: List[int] = []
                acked = _check_ordering(fn.body, ack, commit, False, bad)
                has_commit = any(
                    _contains_call(s, commit) for s in fn.body)
                for line in bad:
                    findings.append(Finding(
                        sf.relpath, line, "DUR004",
                        f"{commit}() reachable before {ack}() in "
                        f"{qualname} — the epoch marker must commit "
                        "only after the sink ack"))
                if not has_commit:
                    findings.append(Finding(
                        sf.relpath, fn.lineno, "DUR004",
                        f"{qualname} is annotated with an epoch-commit "
                        f"contract but never calls {commit}()"))
            if not in_durable:
                continue
            scan = _scan_function(fn)
            for line, call in scan.opens:
                if not call.args:
                    continue
                if _is_tmpish(call.args[0]):
                    continue
                findings.append(Finding(
                    sf.relpath, line, "DUR001",
                    "bare write into a durable root — a crash leaves a "
                    "torn file under its final name; commit via "
                    "utils.fsio.atomic_write_* (tmp + fsync + replace "
                    "+ dir fsync)"))
            for line, call in scan.replaces:
                if not call.args or not _is_tmpish(call.args[0]):
                    continue  # not a tmp-commit rename
                if not any(fl < line for fl in scan.fsync_lines):
                    findings.append(Finding(
                        sf.relpath, line, "DUR002",
                        "os.replace of a temp file with no fsync before "
                        "the rename — power loss can surface the final "
                        "name with empty contents"))
                if not (any(dl > line for dl in scan.dir_fsync_lines)
                        or any(rl > line for rl, _ in scan.replaces
                               if rl != line)):
                    # the dir fsync may follow the LAST replace of a
                    # multi-step commit; only the final one needs it
                    findings.append(Finding(
                        sf.relpath, line, "DUR003",
                        "no directory fsync after the os.replace — the "
                        "rename lives in the directory inode and needs "
                        "the same barrier (fsio.fsync_dir)"))
    return findings
