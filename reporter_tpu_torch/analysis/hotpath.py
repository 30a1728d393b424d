"""Hot-path purity pass (HP rules).

The host pipeline is columnar: trace data crosses every layer as flat
numpy columns, with no per-trace Python. One innocent ``for p in
points`` in a matcher loop would quietly reintroduce it. This pass pins
the invariant on a declared hot-path module set:

HP001  per-element Python loop over trace/point data (a ``for`` statement
       whose iterable is per-point data: ``points``, ``pts``, ``trace``,
       ``probes``, or a ``["trace"]`` subscript). Columnarise instead;
       the single sanctioned per-point pass lives in the declared edge
       functions (``points_to_columns`` and friends).
HP002  dict construction inside a statement loop — the per-trace dict
       builder pattern the columnar pipeline exists to kill. Responses
       serialise straight from run columns to JSON bytes (the columnar
       writers in matcher/matcher.py and service/report.py); the
       remaining edges below are wire-ingestion contracts.
HP003  ``.item()`` anywhere, and ``.tolist()`` inside a loop *body*
       (a ``.tolist()`` in the ``for ... in <iter>`` header runs once and
       is the approved bulk-conversion idiom; per-iteration conversions
       pay fixed numpy overhead per element — the ~4k-tiny-tolist-calls
       regression RunColumns documents).

Edge functions are whitelisted by "relpath::qualname" with a reason; they
are exactly the boundaries where per-element Python is the *contract*
(wire ingestion, JSON response materialisation, the numpy fallback
assembler). Everything else needs a ``# lint: ignore[HP00x]`` with a
comment, or a fix.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from .core import Finding, SourceFile

RULES = {
    "HP001": "per-element Python loop over trace data on the hot path",
    "HP002": "dict construction inside a loop on the hot path",
    "HP003": ".item()/.tolist() per-element conversion on the hot path",
}

#: the declared hot-path module set: matcher, graph, the
#: columnar batch core, the streaming batcher, the serving-side
#: report/dispatch path that runs once per trace per request, and the
#: datastore's ingest/aggregate kernels — the serving-side
#: analogue of the matcher's batch pipeline, held to the same purity.
HOT_PATH_PREFIXES = (
    "reporter_tpu_torch/matcher/",
    "reporter_tpu_torch/graph/",
    "reporter_tpu_torch/core/tracebatch.py",
    "reporter_tpu_torch/streaming/batcher.py",
    "reporter_tpu_torch/service/report.py",
    "reporter_tpu_torch/service/dispatch.py",
    "reporter_tpu_torch/datastore/ingest.py",
    "reporter_tpu_torch/datastore/aggregate.py",
    # the observability layer rides every hot path above — a per-element
    # loop here would tax every stage at once
    "reporter_tpu_torch/obs/",
)

#: "relpath::qualname" -> why per-element Python is the contract there.
EDGE_FUNCTIONS: Dict[str, str] = {
    # wire ingestion: the single sanctioned pass over point dicts/structs
    "reporter_tpu_torch/core/tracebatch.py::points_to_columns":
        "the one documented place request point dicts are read",
    "reporter_tpu_torch/core/tracebatch.py::TraceBatch.from_requests":
        "request-dict conversion edge (columnarise once at the wire)",
    "reporter_tpu_torch/core/tracebatch.py::PointsView.__getitem__":
        "on-demand point materialisation for dict-shaped consumers",
    "reporter_tpu_torch/core/tracebatch.py::PointsView.__iter__":
        "on-demand point materialisation for dict-shaped consumers",
    "reporter_tpu_torch/streaming/batcher.py::Batch.request_body":
        "HTTP split-deployment JSON body (per-point dicts ARE the wire)",
    "reporter_tpu_torch/streaming/batcher.py::Batch.request_columns":
        "columnarisation edge over Point structs (one pass per flush)",
    # (the old JSON dict builders — _format_runs/_runs_as_lists and the
    # dict-building report() state machine — are gone: the columnar
    # response writer serialises run columns straight to JSON bytes
    # (matcher.render_segments_json / service.report_json), and the
    # emission scan accumulates parallel lists, so none of them need a
    # per-element whitelist anymore)
    # numpy fallback assembler (native assemble_batch replaces it on the
    # hot path; this runs per trace only without the C++ runtime)
    "reporter_tpu_torch/matcher/assemble.py::assemble_segments":
        "numpy fallback assembler + JSON edge (native path bypasses it)",
    "reporter_tpu_torch/matcher/assemble.py::_chain_to_segments":
        "numpy fallback assembler + JSON edge (native path bypasses it)",
    # tile CSV wire ingestion: the one sanctioned per-line pass turning a
    # flushed tile payload into columns (everything downstream is numpy)
    "reporter_tpu_torch/datastore/ingest.py::parse_tile_csv":
        "tile-CSV columnarisation edge (one pass per flushed tile)",
    # graph build/load edges: run at startup or in tooling, not per batch
    "reporter_tpu_torch/graph/osm.py::network_from_osm_xml":
        "OSM import edge (offline graph build)",
    "reporter_tpu_torch/graph/tilestore.py::write_tiles":
        "tile build edge (offline)",
    "reporter_tpu_torch/graph/tilestore.py::merge_tiles":
        "tile load edge (startup)",
    "reporter_tpu_torch/graph/tilestore.py::GraphTileStore":
        "tile load edge (startup)",
    "reporter_tpu_torch/graph/network.py::RoadNetwork.load":
        "graph load edge (startup)",
    "reporter_tpu_torch/graph/network.py::RoadNetwork.save":
        "graph save edge (tooling)",
}

_TRACE_DATA_NAMES = frozenset({"points", "pts", "trace", "probes"})


def _iter_mentions_trace_data(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in _TRACE_DATA_NAMES:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in _TRACE_DATA_NAMES:
            return True
        if isinstance(sub, ast.Subscript):
            sl = sub.slice
            if isinstance(sl, ast.Constant) and sl.value == "trace":
                return True
    return False


class _Visitor(ast.NodeVisitor):
    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.findings: List[Finding] = []
        self._func_stack: List[str] = []
        self._class_stack: List[str] = []
        self._loop_depth = 0
        self._iter_depth = 0  # inside a For.iter expression

    # -- scope bookkeeping -------------------------------------------------
    def _qualname(self) -> Optional[str]:
        if not self._func_stack and not self._class_stack:
            return None
        return ".".join(self._class_stack + self._func_stack)

    def _whitelisted(self) -> bool:
        parts = self._class_stack + self._func_stack
        # any enclosing scope prefix may be whitelisted (methods of a
        # whitelisted class, helpers nested in a whitelisted function)
        for i in range(1, len(parts) + 1):
            key = f"{self.sf.relpath}::{'.'.join(parts[:i])}"
            if key in EDGE_FUNCTIONS:
                return True
        return False

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        if self._whitelisted():
            return
        self.findings.append(Finding(self.sf.relpath, node.lineno, rule,
                                     message))

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    # -- rules -------------------------------------------------------------
    def visit_For(self, node: ast.For) -> None:
        if _iter_mentions_trace_data(node.iter):
            self._emit("HP001", node,
                       "per-element loop over trace data "
                       "(columnarise; see analysis/hotpath.py edge list)")
        # the iter expression runs once — .tolist() there is bulk, fine
        self._iter_depth += 1
        self.visit(node.iter)
        self._iter_depth -= 1
        self._loop_depth += 1
        for child in (*node.body, *node.orelse):
            self.visit(child)
        self._loop_depth -= 1
        self.visit(node.target)

    def visit_While(self, node: ast.While) -> None:
        self.visit(node.test)
        self._loop_depth += 1
        for child in (*node.body, *node.orelse):
            self.visit(child)
        self._loop_depth -= 1

    def visit_Dict(self, node: ast.Dict) -> None:
        if self._loop_depth and not self._iter_depth and node.keys:
            self._emit("HP002", node,
                       "dict built inside a loop on the hot path "
                       "(build columns and convert in bulk)")
        self.generic_visit(node)

    def visit_DictComp(self, node: ast.DictComp) -> None:
        if self._loop_depth and not self._iter_depth:
            self._emit("HP002", node,
                       "dict comprehension inside a loop on the hot path")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute) and not node.args \
                and not node.keywords:
            if func.attr == "item":
                self._emit("HP003", node,
                           ".item() per-element scalar extraction "
                           "(index the array, or convert in bulk)")
            elif func.attr == "tolist" and self._loop_depth \
                    and not self._iter_depth:
                self._emit("HP003", node,
                           ".tolist() inside a loop body (hoist one bulk "
                           "conversion out of the loop)")
        self.generic_visit(node)


def run(files, repo_root: str) -> List[Finding]:
    findings: List[Finding] = []
    for sf in files:
        if not sf.relpath.startswith(HOT_PATH_PREFIXES):
            continue
        v = _Visitor(sf)
        v.visit(sf.tree)
        findings.extend(v.findings)
    return findings
