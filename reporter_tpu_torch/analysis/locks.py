"""Lock-discipline pass (LD rules).

The streaming worker, the /report service, the datastore's compactor
and feed, the city registry and the metrics registry share mutable state
across threads (handler pool, dispatch loop, device lanes, native build
lock). The convention is simple — state that a ``with
<lock>`` block protects anywhere must be protected *everywhere* it is
written — and until now it was only a convention. One unlocked write next
to a locked one is exactly the race that "tolerated by convention"
becomes a corrupted counter or a half-initialised handle under load.

LD001  instance attribute or module global written both inside and
       outside ``with <lock>`` blocks. Writes in ``__init__`` are
       construction (single-threaded by contract) and do not count as
       unguarded sites; a name is "lock-like" when its last path segment
       matches ``lock``/``mutex``/``mu`` (``self._lock``,
       ``_build_lock``, ``stripe.mu`` ...).

The pass runs on the declared threaded module set only — single-threaded
modules mixing locked and unlocked writes are not a race (and GIL-
tolerated lock-free designs like graph/route.RouteCache stay out of
scope by the same declaration).
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Sequence, Set, Tuple

from .core import Finding, SourceFile, terminal_name

RULES = {
    "LD001": "shared state written both inside and outside a lock",
}

#: the declared threaded module set: everything with threads or shared
#: process-global state reachable from multiple threads.
THREADED_PREFIXES = (
    "reporter_tpu_torch/streaming/",
    # the dispatcher, the admission gate, the wire breaker and the city
    # registry (service/cities.py: _lock before _res_lock)
    "reporter_tpu_torch/service/",
    "reporter_tpu_torch/utils/metrics.py",
    "reporter_tpu_torch/utils/faults.py",
    "reporter_tpu_torch/utils/circuit.py",
    "reporter_tpu_torch/native/__init__.py",
    # span contexts / the flight-recorder ring are touched from every
    # serving thread
    "reporter_tpu_torch/obs/",
    # the background compactor's thread and the change feed's long-poll
    # waiters and store watcher
    "reporter_tpu_torch/datastore/compactor.py",
    "reporter_tpu_torch/datastore/feed.py",
)

_LOCKISH = re.compile(r"(^|_)(lock|mutex|mu)s?$", re.IGNORECASE)

_MUTATORS = frozenset({
    "append", "extend", "add", "update", "clear", "pop", "popitem",
    "remove", "discard", "insert", "setdefault", "appendleft",
    "move_to_end", "sort", "reverse",
})

_CONSTRUCTORS = ("__init__", "__new__", "__post_init__")


def _is_lock_expr(node: ast.AST) -> bool:
    name = terminal_name(node)
    return bool(name and _LOCKISH.search(name))


class _Site:
    __slots__ = ("line", "locked", "in_ctor", "func")

    def __init__(self, line: int, locked: bool, in_ctor: bool, func: str):
        self.line = line
        self.locked = locked
        self.in_ctor = in_ctor
        self.func = func


class _Visitor(ast.NodeVisitor):
    """Collects write sites per (owner, attribute) where owner is a class
    (instance attributes via ``self``) or the module (globals)."""

    def __init__(self, sf: SourceFile):
        self.sf = sf
        # (owner, attr) -> [sites]
        self.writes: Dict[Tuple[str, str], List[_Site]] = {}
        self._class_stack: List[str] = []
        self._func_stack: List[str] = []
        self._lock_depth = 0
        self._globals_declared: List[Set[str]] = []
        self.module_names: Set[str] = {
            t.id
            for node in sf.tree.body if isinstance(node, ast.Assign)
            for t in node.targets if isinstance(t, ast.Name)
        } | {
            node.target.id
            for node in sf.tree.body if isinstance(node, ast.AnnAssign)
            and isinstance(node.target, ast.Name)
        }

    # -- scope tracking ----------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._func_stack.append(node.name)
        self._globals_declared.append(set())
        self.generic_visit(node)
        self._globals_declared.pop()
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Global(self, node: ast.Global) -> None:
        if self._globals_declared:
            self._globals_declared[-1].update(node.names)

    def visit_With(self, node: ast.With) -> None:
        locked = any(_is_lock_expr(item.context_expr)
                     or (isinstance(item.context_expr, ast.Call)
                         and _is_lock_expr(item.context_expr.func))
                     for item in node.items)
        for item in node.items:
            self.visit(item)
        if locked:
            self._lock_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if locked:
            self._lock_depth -= 1

    visit_AsyncWith = visit_With  # type: ignore[assignment]

    # -- write collection --------------------------------------------------
    def _record(self, owner: str, attr: str, line: int) -> None:
        in_ctor = bool(self._func_stack) \
            and self._func_stack[0] in _CONSTRUCTORS
        func = ".".join(self._class_stack + self._func_stack) or "<module>"
        self.writes.setdefault((owner, attr), []).append(
            _Site(line, self._lock_depth > 0, in_ctor, func))

    def _owner_attr(self, target: ast.AST):
        """(owner, attr) for a write target, descending through
        subscripts: ``self.x[k] = v`` writes ``self.x``."""
        was_subscript = False
        while isinstance(target, ast.Subscript):
            was_subscript = True
            target = target.value
        if isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id == "self" and self._class_stack:
            return self._class_stack[-1], target.attr
        if isinstance(target, ast.Name) and self._func_stack:
            if self._globals_declared \
                    and target.id in self._globals_declared[-1]:
                return "<module>", target.id
            if was_subscript and target.id in self.module_names:
                # item assignment mutates the module-level container even
                # without a ``global`` declaration
                return "<module>", target.id
        return None

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            oa = self._owner_attr(t)
            if oa:
                self._record(*oa, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            oa = self._owner_attr(node.target)
            if oa:
                self._record(*oa, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        oa = self._owner_attr(node.target)
        if oa:
            self._record(*oa, node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        # mutating method on self.X or a module-level container:
        # self.store.pop(...), pending.clear(), ...
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _MUTATORS:
            base = func.value
            oa = None
            if isinstance(base, ast.Attribute) \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id == "self" and self._class_stack:
                oa = (self._class_stack[-1], base.attr)
            elif isinstance(base, ast.Name) and self._func_stack \
                    and base.id in self.module_names:
                oa = ("<module>", base.id)
            if oa:
                self._record(*oa, node.lineno)
        self.generic_visit(node)


def run(files: Sequence[SourceFile], repo_root: str) -> List[Finding]:
    findings: List[Finding] = []
    for sf in files:
        if not sf.relpath.startswith(THREADED_PREFIXES):
            continue
        v = _Visitor(sf)
        v.visit(sf.tree)
        for (owner, attr), sites in sorted(v.writes.items()):
            locked = [s for s in sites if s.locked]
            unlocked = [s for s in sites if not s.locked and not s.in_ctor]
            if locked and unlocked:
                where = "self." if owner != "<module>" else ""
                for s in unlocked:
                    findings.append(Finding(
                        sf.relpath, s.line, "LD001",
                        f"{where}{attr} is written under a lock elsewhere "
                        f"(e.g. line {locked[0].line}) but not here in "
                        f"{s.func} — every write needs the lock"))
    return findings
