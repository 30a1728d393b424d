"""Lock-graph pass (LD002-LD003): whole-package lock acquisition order.

LD001 checks that guarded state is guarded everywhere — a
per-write property. What it cannot see is the *relationship between
locks*: two threads acquiring the same two locks in opposite orders
deadlock, and a lock held across a blocking call (an HTTP round trip, a
subprocess, a ctypes ``rt_*`` native) turns one slow dependency into a
process-wide stall. Multi-process serving (the pre-fork mode, the
cross-process writer lease) amplifies both.

The pass builds a static lock-acquisition graph over the whole scanned
package: a node per lock — identified ``(module, owner, attr)``, where
owner is the class for ``self._lock`` attributes and the module for
globals — and an edge A -> B when a ``with B`` runs (or a function that
acquires B is called) while A is held. Call edges resolve through the
package's own functions: same-class methods first (for calls on
``self`` or a bare name only: ``self._resident.get()`` is a dict's
``get``, not the class's), then same-module functions, then a
package-wide unique name; ambiguous names are not followed, and nested
defs are folded into their enclosing function (documented
approximations — both err toward missing an edge, never toward
inventing one).

Callbacks handed to ``executor.submit(fn, ...)`` and
``Thread(target=fn)`` resolve like direct calls: the callback runs on
another thread, but a caller that holds a lock at the submit site is
coupled to everything the callback acquires — the idiom is
submit-then-``result()``/``join()``, and even without the join the
callback's acquisitions order against the held lock whenever the pool
runs it before the holder releases. Lambdas and non-name callbacks are not followed
(same err-toward-missing rule as ambiguous calls).

LD002  cycle in the lock-acquisition graph: some execution order of the
       involved threads deadlocks. Reported once per cycle, at the
       acquisition site that closes it.
LD003  blocking call reachable while a lock is held: HTTP egress
       (``urlopen``, ``http_egress.post/put/egress_tile``), subprocess
       spawns, ctypes ``rt_*`` natives, and a kernel build
       (``nvcc.load``: an ``nvcc`` run of seconds to minutes). A
       documented once-only build hold (a library built once under its
       lock, so that two threads never build it twice) suppresses with
       a reason.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Finding, SourceFile, dotted, terminal_name
from .locks import _is_lock_expr

RULES = {
    "LD002": "lock-acquisition cycle (potential deadlock)",
    "LD003": "lock held across a blocking call (HTTP/subprocess/native)",
}

#: call shapes that block: unambiguous terminal names, and dotted
#: suffixes for the short ones (a bare ``post`` would match JSON
#: helpers; ``http_egress.post`` is the egress module's).
_BLOCKING_TERMINAL = frozenset({"urlopen", "check_call", "check_output",
                                "Popen", "egress_tile", "aws_put"})
_BLOCKING_DOTTED = (
    "subprocess.run", "http_egress.post", "http_egress.put",
    "requests.get", "requests.post", "requests.put", "nvcc.load",
)


def _callback_name(call: ast.Call) -> Optional[str]:
    """The terminal name of a callback handed to ``<pool>.submit(fn,
    ...)`` or ``Thread(target=fn)`` — the call shapes that move work to
    another thread. None for lambdas/partials/non-name callbacks (not
    followed; errs toward missing an edge)."""
    leaf = terminal_name(call.func)
    if leaf == "submit" and isinstance(call.func, ast.Attribute) \
            and call.args:
        return terminal_name(call.args[0])
    if leaf == "Thread":
        for kw in call.keywords:
            if kw.arg == "target":
                return terminal_name(kw.value)
    return None


def _is_blocking(call: ast.Call) -> Optional[str]:
    leaf = terminal_name(call.func)
    if leaf is None:
        return None
    if leaf.startswith("rt_"):
        return f"ctypes native {leaf}()"
    if leaf in _BLOCKING_TERMINAL:
        return f"{leaf}()"
    d = dotted(call.func)
    if d is not None:
        for suffix in _BLOCKING_DOTTED:
            if d == suffix or d.endswith("." + suffix):
                return f"{suffix}()"
    return None


#: ubiquitous stdlib protocol names (containers, files, queues,
#: threads, futures): ``obj.append(...)``'s receiver is almost never
#: package code, so a package function that happens to share the name
#: (``HistogramStore.append``, ``http.put``) must not be resolved as
#: the callee through the package-wide-unique fallback. Same-class and
#: same-module resolution still apply — only the fallback is barred
#: (errs toward missing an edge, like every approximation here).
_COMMON_METHODS = frozenset({
    "append", "appendleft", "extend", "add", "insert", "remove",
    "discard", "pop", "popitem", "clear", "update", "setdefault",
    "get", "put", "get_nowait", "put_nowait", "close", "open", "read",
    "write", "flush", "seek", "join", "start", "run", "send", "recv",
    "acquire", "release", "wait", "notify", "notify_all", "set",
    "result", "cancel", "shutdown", "submit", "sort", "reverse",
    "index", "copy", "items", "keys", "values",
})

LockId = Tuple[str, str, str]  # (relpath, owner, attr)


def _fmt_lock(lock: LockId) -> str:
    rel, owner, attr = lock
    mod = rel.rsplit("/", 1)[-1]
    return f"{mod}:{owner}.{attr}" if owner != "<module>" \
        else f"{mod}:{attr}"


def _lock_id(expr: ast.AST, relpath: str,
             cls: Optional[str]) -> Optional[LockId]:
    node = expr.func if isinstance(expr, ast.Call) else expr
    name = terminal_name(node)
    if name is None:
        return None
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return (relpath, cls or "<class>", name)
    if isinstance(node, ast.Name):
        return (relpath, "<module>", name)
    return (relpath, "<attr>", name)  # foreign chains: keyed by attr


class _FuncInfo:
    """What one function does, lock-wise. Nested defs are folded in."""

    __slots__ = ("key", "relpath", "cls", "acquires", "held_calls",
                 "held_locks", "held_blocking", "all_calls",
                 "all_blocking", "local_names")

    def __init__(self, key: str, relpath: str, cls: Optional[str]):
        self.key = key
        self.relpath = relpath
        self.cls = cls
        self.acquires: List[Tuple[LockId, int]] = []
        # (held lock, with-line, callee terminal name, called on self
        # or as a bare name)
        self.held_calls: List[Tuple[LockId, int, str, bool]] = []
        # (held lock, with-line, nested lock)
        self.held_locks: List[Tuple[LockId, int, LockId]] = []
        # (held lock, with-line, blocking description) — direct
        self.held_blocking: List[Tuple[LockId, int, str]] = []
        # every (terminal call name, on self or bare) / blocking
        # description anywhere in the function body (the closure edges)
        self.all_calls: Set[Tuple[str, bool]] = set()
        self.all_blocking: Set[str] = set()
        self.local_names: Set[str] = set()


class _Collector(ast.NodeVisitor):
    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.funcs: Dict[str, _FuncInfo] = {}
        self._cls: List[str] = []
        self._fn: List[_FuncInfo] = []
        self._held: List[Tuple[LockId, int]] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._cls.append(node.name)
        self.generic_visit(node)
        self._cls.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if self._fn:  # nested def: fold into the enclosing function —
            # but its body does NOT run at def time, so it must not see
            # the def site's held-lock stack (a closure defined under a
            # lock and called later is not a held blocking call)
            self._fn[-1].local_names.add(node.name)
            held, self._held = self._held, []
            for stmt in node.body:
                self.visit(stmt)
            self._held = held
            return
        cls = self._cls[-1] if self._cls else None
        key = ".".join(self._cls + [node.name])
        info = _FuncInfo(key, self.sf.relpath, cls)
        self.funcs[key] = info
        self._fn.append(info)
        for stmt in node.body:
            self.visit(stmt)
        self._fn.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_With(self, node: ast.With) -> None:
        if not self._fn:
            return
        info = self._fn[-1]
        entered = 0
        for item in node.items:
            expr = item.context_expr
            is_lock = _is_lock_expr(expr) or (
                isinstance(expr, ast.Call) and _is_lock_expr(expr.func))
            if is_lock:
                lock = _lock_id(expr, info.relpath, info.cls)
                if lock is not None:
                    for held, line in self._held:
                        info.held_locks.append((held, line, lock))
                    info.acquires.append((lock, node.lineno))
                    self._held.append((lock, node.lineno))
                    entered += 1
            else:
                self.visit(expr)  # non-lock items evaluate while held
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(entered):
            self._held.pop()

    visit_AsyncWith = visit_With  # type: ignore[assignment]

    def visit_Call(self, node: ast.Call) -> None:
        if self._fn:
            info = self._fn[-1]
            leaf = terminal_name(node.func)
            own = isinstance(node.func, ast.Name) or (
                isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self")
            desc = _is_blocking(node)
            if leaf is not None:
                info.all_calls.add((leaf, own))
            if desc is not None:
                info.all_blocking.add(desc)
            for held, line in self._held:
                if desc is not None:
                    info.held_blocking.append((held, line, desc))
                elif leaf is not None:
                    info.held_calls.append((held, line, leaf, own))
            # executor.submit / Thread(target=...) callbacks: resolve
            # the handed function like a direct call, so locks it
            # acquires (and blocking work it does) are no longer
            # invisible to the graph just because a pool runs them
            cb = _callback_name(node)
            if cb is not None:
                info.all_calls.add((cb, True))
                for held, line in self._held:
                    info.held_calls.append((held, line, cb, True))
        self.generic_visit(node)


class _Resolver:
    """Callee name -> _FuncInfo across the package, scope-preferring."""

    def __init__(self, by_file: Dict[str, Dict[str, _FuncInfo]]):
        self.by_file = by_file
        self.by_name: Dict[str, List[_FuncInfo]] = {}
        for funcs in by_file.values():
            for info in funcs.values():
                self.by_name.setdefault(
                    info.key.rsplit(".", 1)[-1], []).append(info)

    def resolve(self, caller: _FuncInfo, name: str,
                own: bool = True) -> Optional[_FuncInfo]:
        """``own``: the call is on ``self`` or a bare name, so a method
        of the caller's class may be the callee."""
        if name in caller.local_names:
            return None  # already folded into the caller
        if own and caller.cls is not None:
            got = self.by_file[caller.relpath].get(f"{caller.cls}.{name}")
            if got is not None:
                return got
        got = self.by_file[caller.relpath].get(name)
        if got is not None:
            return got
        if name in _COMMON_METHODS:
            return None  # stdlib protocol name: receiver is foreign
        everywhere = self.by_name.get(name, [])
        if len(everywhere) == 1:
            return everywhere[0]
        return None  # ambiguous or foreign: not followed


def _closure(info: _FuncInfo, resolver: _Resolver,
             cache: Dict[str, Tuple[Set[LockId], Set[str]]],
             stack: Set[str]) -> Tuple[Set[LockId], Set[str]]:
    """(locks acquired, blocking descriptions) reachable from ``info``
    through package-resolvable calls, cycle-safe."""
    fid = f"{info.relpath}::{info.key}"
    if fid in cache:
        return cache[fid]
    if fid in stack:
        return set(), set()
    stack.add(fid)
    locks = {lock for lock, _ in info.acquires}
    blocking = set(info.all_blocking)
    for name, own in sorted(info.all_calls):
        callee = resolver.resolve(info, name, own)
        if callee is not None and callee is not info:
            cl, cb = _closure(callee, resolver, cache, stack)
            locks |= cl
            blocking |= cb
    stack.discard(fid)
    cache[fid] = (locks, blocking)
    return cache[fid]


def run(files: Sequence[SourceFile], repo_root: str) -> List[Finding]:
    by_file: Dict[str, Dict[str, _FuncInfo]] = {}
    for sf in files:
        c = _Collector(sf)
        c.visit(sf.tree)
        by_file[sf.relpath] = c.funcs

    resolver = _Resolver(by_file)
    cache: Dict[str, Tuple[Set[LockId], Set[str]]] = {}

    edges: Dict[LockId, Set[LockId]] = {}
    edge_sites: Dict[Tuple[LockId, LockId], Tuple[str, int]] = {}
    findings: List[Finding] = []

    for sf in files:
        for info in by_file[sf.relpath].values():
            for held, line, nested in info.held_locks:
                if nested != held:
                    edges.setdefault(held, set()).add(nested)
                    edge_sites.setdefault((held, nested),
                                          (sf.relpath, line))
            for held, line, desc in info.held_blocking:
                findings.append(Finding(
                    sf.relpath, line, "LD003",
                    f"lock {_fmt_lock(held)} is held across blocking "
                    f"call {desc} — a stall there stalls every waiter"))
            reported: Set[Tuple[LockId, int, str]] = set()
            for held, line, name, own in info.held_calls:
                callee = resolver.resolve(info, name, own)
                if callee is None:
                    continue
                cl, cb = _closure(callee, resolver, cache, set())
                for lock in cl:
                    if lock != held:
                        edges.setdefault(held, set()).add(lock)
                        edge_sites.setdefault((held, lock),
                                              (sf.relpath, line))
                for desc in sorted(cb):
                    key = (held, line, desc)
                    if key in reported:
                        continue
                    reported.add(key)
                    findings.append(Finding(
                        sf.relpath, line, "LD003",
                        f"lock {_fmt_lock(held)} is held across "
                        f"blocking call {desc} (via {name}()) — a "
                        "stall there stalls every waiter"))

    # cycle detection (DFS from every node; each cycle reported once)
    seen_cycles: Set[Tuple[LockId, ...]] = set()
    for start in sorted(edges):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(edges.get(node, ())):
                if nxt == start:
                    cyc = tuple(sorted(path))
                    if cyc in seen_cycles:
                        continue
                    seen_cycles.add(cyc)
                    rel, line = edge_sites[(node, start)]
                    order = " -> ".join(_fmt_lock(p) for p in path)
                    findings.append(Finding(
                        rel, line, "LD002",
                        f"lock-acquisition cycle {order} -> "
                        f"{_fmt_lock(start)} — opposite-order callers "
                        "deadlock"))
                elif nxt not in path:
                    stack.append((nxt, path + [nxt]))

    return findings
