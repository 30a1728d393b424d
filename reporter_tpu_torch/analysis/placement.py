"""Transfer-discipline pass (DP rules): where device values reach the host.

The matcher's device lanes keep the card busy while the host preps the
next chunk: device values come back to the host at the declared points
only (the drain lane's gather of the decoded paths, the deferred route
tensor's write-back and the wire decision at dispatch). Any other
materialisation on a lane (``.cpu()``, ``.numpy()``, ``.item()``,
``.tolist()``, ``float()`` of a device tensor, ``torch.cuda.synchronize``
or an event's ``.synchronize()``) is a hidden synchronisation: the
submitting thread waits for the card, the overlap the lanes exist for
collapses, and nothing fails.

The pass walks the package's call graph from ``registry.DEVICE_LANES``
(the lanes are declared, since their submits go through
``SegmentMatcher._lane_stage``), resolving calls as ``lockgraph`` does
(same class, same module, then a name unique in the package; stdlib
protocol names are not followed) and stopping at ``registry.SYNC_POINTS``.
Device values are locals assigned from a kernel wrapper
(``registry.KERNEL_CONTRACTS``), from the ``ops`` dispatchers that reach
one (``DISPATCHERS``), from ``.to(...)``/``.cuda()``, and from package
functions that return such a local.

DP001  a host materialisation of a device value, or a device
       synchronisation, reachable from a device lane outside
       SYNC_POINTS (also a SYNC_POINTS entry naming no function: a
       dangling whitelist entry is a hole)
DP002  the same inside a loop that also launches device work: a
       round trip to the card per iteration
DP003  a numpy array handed straight to a kernel wrapper or dispatcher
       on a device-resident path (an implicit upload per call; wrap it
       with ``torch.from_numpy(...).to(device)`` at the boundary), and a
       DEVICE_LANES entry naming no function

Approximations (they err toward silence): values are tracked within a
function through assignments only; attribute loads, containers and
arguments are not followed; ``bool()`` and ``int()`` are not sinks (a
relaxation's convergence read is a deliberate, declared sync).
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set

from . import registry
from .core import Finding, SourceFile, dotted, terminal_name
from .lockgraph import _callback_name, _Resolver

RULES = {
    "DP001": "host materialisation of a device value outside SYNC_POINTS",
    "DP002": "device<->host round trip inside a launching loop",
    "DP003": "numpy array handed to a kernel on a device-resident path",
}

REGISTRY_REL = "reporter_tpu_torch/analysis/registry.py"

#: the ``ops`` dispatchers that launch a kernel on CUDA tensors
DISPATCHERS = frozenset({"decode_batch", "incremental_steps",
                         "incremental_step_batch", "relax_routes",
                         "route_pair_costs"})
#: methods that bring a tensor's values to the host
_TENSOR_SINKS = frozenset({"cpu", "numpy", "item", "tolist"})
#: calls that make a device value
_TO_DEVICE = frozenset({"to", "cuda"})


def default_entry_names() -> Set[str]:
    """Kernel wrappers and dispatchers by bare name."""
    return {k.split("::")[1] for k in registry.KERNEL_CONTRACTS} \
        | set(DISPATCHERS)


class _Fn:
    """One module- or class-level function (the shape lockgraph's
    resolver reads: key, relpath, cls, local_names)."""

    __slots__ = ("key", "relpath", "cls", "local_names", "calls", "node")

    def __init__(self, key: str, relpath: str, cls: Optional[str],
                 node: ast.AST):
        self.key = key
        self.relpath = relpath
        self.cls = cls
        self.node = node
        self.local_names: Set[str] = set()
        self.calls: Set[str] = set()
        for n in ast.walk(node):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and n is not node:
                self.local_names.add(n.name)
            elif isinstance(n, ast.Call):
                leaf = terminal_name(n.func)
                if leaf is not None:
                    self.calls.add(leaf)
                cb = _callback_name(n)
                if cb is not None:
                    self.calls.add(cb)

    @property
    def spec(self) -> str:
        return f"{self.relpath}::{self.key}"


def _collect(files: Sequence[SourceFile]) -> Dict[str, Dict[str, _Fn]]:
    by_file: Dict[str, Dict[str, _Fn]] = {}
    for sf in files:
        funcs: Dict[str, _Fn] = {}
        for node in sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs[node.name] = _Fn(node.name, sf.relpath, None, node)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        key = f"{node.name}.{sub.name}"
                        funcs[key] = _Fn(key, sf.relpath, node.name, sub)
        by_file[sf.relpath] = funcs
    return by_file


def _numpy_roots(tree: ast.AST) -> Set[str]:
    """Local names bound to numpy (``import numpy as np``)."""
    out = {"numpy"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    out.add(a.asname or "numpy")
    return out


def _targets(node: ast.Assign) -> Set[str]:
    out: Set[str] = set()
    for t in node.targets:
        if isinstance(t, ast.Name):
            out.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            out.update(e.id for e in t.elts if isinstance(e, ast.Name))
    return out


def _makes_device(call: ast.Call, producers: Set[str]) -> bool:
    """A call whose result lies on the device: a producer, or a tensor's
    ``.to(...)``/``.cuda()``."""
    leaf = terminal_name(call.func)
    if leaf in producers:
        return True
    return isinstance(call.func, ast.Attribute) and leaf in _TO_DEVICE \
        and (leaf == "cuda" or bool(call.args) or any(
            kw.arg == "device" for kw in call.keywords))


def _device_locals(node: ast.AST, producers: Set[str]) -> Set[str]:
    """Locals assigned (tuple-unpacked too) from a device-making call."""
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) \
                and _makes_device(n.value, producers):
            out |= _targets(n)
    return out


def _numpy_locals(node: ast.AST, roots: Set[str]) -> Set[str]:
    """Locals assigned from an ``np.*`` call: host arrays."""
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            d = dotted(n.value.func)
            if d is not None and d.split(".")[0] in roots:
                out |= _targets(n)
    return out


def _producers(by_file: Dict[str, Dict[str, _Fn]],
               seed: Set[str]) -> Set[str]:
    """Fixpoint: a function that returns a device local becomes a
    producer under its bare name."""
    producers = set(seed)
    changed = True
    while changed:
        changed = False
        for funcs in by_file.values():
            for fn in funcs.values():
                bare = fn.key.rsplit(".", 1)[-1]
                if bare in producers:
                    continue
                dev = _device_locals(fn.node, producers)
                if not dev:
                    continue
                for n in ast.walk(fn.node):
                    if isinstance(n, ast.Return) and n.value is not None \
                            and any(isinstance(c, ast.Name) and c.id in dev
                                    for c in ast.walk(n.value)):
                        producers.add(bare)
                        changed = True
                        break
    return producers


def _first_mention(expr: ast.AST, names: Set[str]) -> Optional[str]:
    for n in ast.walk(expr):
        if isinstance(n, ast.Name) and n.id in names:
            return n.id
    return None


class _LaneScan(ast.NodeVisitor):
    """The DP sinks inside one lane-reachable function."""

    def __init__(self, fn: _Fn, device: Set[str], host: Set[str],
                 producers: Set[str], entries: Set[str]):
        self.fn = fn
        self.device = device
        self.host = host
        self.producers = producers
        self.entries = entries
        self.loops: List[bool] = []  # each enclosing loop: launches?
        self.findings: List[Finding] = []

    def _emit(self, node: ast.AST, desc: str) -> None:
        if any(self.loops):
            self.findings.append(Finding(
                self.fn.relpath, node.lineno, "DP002",
                f"{desc} inside a loop that also launches device work: a "
                "round trip to the card per iteration"))
        else:
            self.findings.append(Finding(
                self.fn.relpath, node.lineno, "DP001",
                f"{desc} on a device lane outside registry.SYNC_POINTS: a "
                "hidden sync serialises the lanes (move it to a declared "
                "sync point)"))

    def _loop(self, node) -> None:
        launches = any(isinstance(n, ast.Call)
                       and terminal_name(n.func) in self.producers
                       for n in ast.walk(node))
        self.loops.append(launches)
        self.generic_visit(node)
        self.loops.pop()

    visit_For = _loop
    visit_While = _loop
    visit_AsyncFor = _loop  # type: ignore[assignment]

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        leaf = terminal_name(func)
        d = dotted(func)
        if isinstance(func, ast.Name) and func.id == "float" and node.args:
            name = _first_mention(node.args[0], self.device)
            if name is not None:
                self._emit(node, f"float() of device value {name!r}")
        elif isinstance(func, ast.Attribute) and leaf in _TENSOR_SINKS \
                and not node.args:
            name = _first_mention(func.value, self.device)
            if name is not None:
                self._emit(node, f".{leaf}() of device value {name!r}")
        elif d is not None and (d == "torch.cuda.synchronize"
                                or d.endswith(".cuda.synchronize")):
            self._emit(node, "torch.cuda.synchronize()")
        elif isinstance(func, ast.Attribute) and leaf == "synchronize":
            self._emit(node, f"{d or '<expr>.synchronize'}()")
        if leaf in self.entries:
            for a in node.args:
                if isinstance(a, ast.Name) and a.id in self.host:
                    self.findings.append(Finding(
                        self.fn.relpath, node.lineno, "DP003",
                        f"numpy array {a.id!r} handed straight to "
                        f"{leaf}() on a device-resident path: an "
                        "implicit upload per call; move it to the device "
                        "at the boundary"))
        self.generic_visit(node)


def _registry_lines(repo_root: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    try:
        with open(os.path.join(repo_root, REGISTRY_REL),
                  encoding="utf-8") as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError):
        return out
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.setdefault(node.value, node.lineno)
    return out


def run(files: Sequence[SourceFile], repo_root: str,
        lanes: Optional[Sequence[str]] = None,
        sync_points: Optional[Sequence[str]] = None,
        entry_names: Optional[Set[str]] = None,
        full_scope: bool = True) -> List[Finding]:
    """The DP findings over ``files``. ``full_scope=False`` (a partial or
    fixture run) skips the dangling-entry checks, which judge the
    registry against the whole package."""
    lanes = list(registry.DEVICE_LANES if lanes is None else lanes)
    sync = set(registry.SYNC_POINTS if sync_points is None
               else sync_points)
    entries = default_entry_names() if entry_names is None \
        else set(entry_names)

    by_file = _collect(files)
    roots_by_rel = {sf.relpath: _numpy_roots(sf.tree) for sf in files}
    resolver = _Resolver(by_file)
    producers = _producers(by_file, entries)
    findings: List[Finding] = []

    if full_scope:
        reg_lines = _registry_lines(repo_root)
        all_specs = {fn.spec for funcs in by_file.values()
                     for fn in funcs.values()}
        for spec in sorted(set(lanes) - all_specs):
            findings.append(Finding(
                REGISTRY_REL, reg_lines.get(spec, 1), "DP003",
                f"DEVICE_LANES entry {spec} names no module- or class-"
                "level function: a dangling lane walks nothing"))
        for spec in sorted(sync - all_specs):
            findings.append(Finding(
                REGISTRY_REL, reg_lines.get(spec, 1), "DP001",
                f"SYNC_POINTS entry {spec} names no module- or class-"
                "level function: a dangling whitelist entry is a hole"))

    # breadth-first over the call graph from the lanes, stopping at the
    # declared sync points
    work = []
    for spec in lanes:
        relpath, key = spec.split("::", 1)
        fn = by_file.get(relpath, {}).get(key)
        if fn is not None and fn.spec not in sync:
            work.append(fn)
    seen: Set[str] = set()
    while work:
        fn = work.pop()
        if fn.spec in seen:
            continue
        seen.add(fn.spec)
        scan = _LaneScan(fn, _device_locals(fn.node, producers),
                         _numpy_locals(fn.node,
                                       roots_by_rel.get(fn.relpath,
                                                        {"numpy"})),
                         producers, entries)
        scan.visit(fn.node)
        findings.extend(scan.findings)
        for name in sorted(fn.calls):
            callee = resolver.resolve(fn, name)
            if callee is not None and callee.spec not in sync \
                    and callee.spec not in seen:
                work.append(callee)
    return findings
