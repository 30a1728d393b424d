"""ctypes <-> C ABI cross-check (ABI rules).

The port calls two kinds of native code through hand-written flat C
ABIs, and ctypes checks neither: a drifted ``argtypes`` list passes the
wrong argument list and corrupts memory.

- ``native/__init__.py`` binds ``native/csrc/host_runtime.cpp``'s
  ``rt_*`` exports and holds the ``ABI_VERSION`` handshake constant
  against ``rt_abi_version()``'s return. The handshake catches a library
  and a binding from different commits; this pass catches both sides
  landed in one commit, wrong.
- The card's kernels: each ``extern "C"`` entry point of
  ``ops/csrc/*.cu`` (``CARD_PAIRS``) is bound by a hand-written list in
  its wrapper module (``lib.relax.argtypes = [...]``, or ``fn =
  lib.viterbi_decode; fn.argtypes = [...]``). A drift there corrupts card
  memory, and only the card would show it. These have no version
  handshake, so ABI004 does not apply to them.

The C side is parsed with a deliberately narrow grammar (the ``rt_*``
export style of host_runtime.cpp; ``extern "C"`` definitions, over
several lines, in the .cu sources); the Python side by AST, resolving
the ndpointer aliases (``f32p`` ...), the ctypes aliases (``p, i, f =
ctypes.c_void_p, ctypes.c_int, ctypes.c_float``), ``ctypes.POINTER``
wrappers and function aliases (``fn = lib.name``).

ABI001  export/binding missing on one side
ABI002  argument-count mismatch
ABI003  argument type/order mismatch at a position
ABI004  ABI_VERSION constant != rt_abi_version() return
ABI005  return-type mismatch (an unset restype on a void function is
        accepted: ctypes' default c_int return is ignored by callers)

Width model: pointers match on pointee width (f64*, i32*, ...); the
8-bit class is one width (``uint8_t*`` binds as either ``c_char_p`` for
bytes or an ndpointer(uint8) for arrays); ``void*`` matches only
``c_void_p``. Scalars must match exactly.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from .core import Finding

RULES = {
    "ABI001": "native export/binding missing on one side",
    "ABI002": "argtypes arity differs from the C signature",
    "ABI003": "argtype width/order differs from the C signature",
    "ABI004": "ABI_VERSION constant differs from rt_abi_version()",
    "ABI005": "restype differs from the C return type",
}

DEFAULT_CPP = "reporter_tpu_torch/native/csrc/host_runtime.cpp"
DEFAULT_PY = "reporter_tpu_torch/native/__init__.py"

#: the card's entry points: (CUDA source, {binding module: the entry
#: points it binds}); every ``extern "C"`` definition of a source is bound
#: by exactly one of its modules
CARD_PAIRS: Tuple[Tuple[str, Dict[str, Tuple[str, ...]]], ...] = (
    ("reporter_tpu_torch/ops/csrc/viterbi.cu", {
        "reporter_tpu_torch/ops/viterbi.py": ("viterbi_decode",),
        "reporter_tpu_torch/ops/incremental.py": ("incremental_steps",),
    }),
    ("reporter_tpu_torch/ops/csrc/route_relax.cu", {
        "reporter_tpu_torch/ops/route_relax.py": (
            "relax", "relax_cluster_occupancy", "relax_cluster",
            "relax_global", "pair_costs"),
    }),
)

# (kind, width): kind 'ptr' | 'val'; width 'f64' 'f32' 'i64' 'i32' 'u16'
# 'u8' 'i8' 'void'
CType = Tuple[str, str]

_C_WIDTHS = {
    "double": "f64", "float": "f32", "int64_t": "i64", "int32_t": "i32",
    "uint16_t": "u16", "uint8_t": "u8", "char": "i8", "void": "void",
    "int": "i32", "long": "i64", "size_t": "i64", "uint32_t": "i32",
    "uint64_t": "i64", "int8_t": "i8", "bool": "u8",
}

# longer alternatives first (int64_t before int, etc.); any type may
# carry a pointer star so typed-pointer returns stay visible to ABI001
_SIG_RE = re.compile(
    r"^\s*(?:const\s+)?"
    r"((?:int64_t|int32_t|int8_t|uint64_t|uint32_t|uint16_t|uint8_t"
    r"|size_t|long|int|double|float|bool|char|void)\s*\*?)"
    r"\s*(rt_\w+)\s*\(([^;{)]*)\)\s*\{",
    re.MULTILINE)

_EXTERN_C_RE = re.compile(
    r'extern\s+"C"\s+(?:const\s+)?'
    r"((?:int64_t|int32_t|int8_t|uint64_t|uint32_t|uint16_t|uint8_t"
    r"|size_t|long|int|double|float|bool|char|void)\s*\*?)"
    r"\s*(\w+)\s*\(([^;{)]*)\)\s*\{")

_VERSION_RE = re.compile(
    r"rt_abi_version\s*\(\s*void\s*\)\s*\{\s*return\s+(\d+)\s*;")

_NDP_DTYPES = {
    "float64": "f64", "float32": "f32", "int64": "i64", "int32": "i32",
    "uint16": "u16", "uint8": "u8", "int8": "i8", "float16": "u16",
}

_CTYPES_SCALARS = {
    "c_double": ("val", "f64"), "c_float": ("val", "f32"),
    "c_int64": ("val", "i64"), "c_int32": ("val", "i32"),
    "c_int": ("val", "i32"), "c_uint8": ("val", "u8"),
    "c_uint16": ("val", "u16"), "c_int8": ("val", "i8"),
    "c_longlong": ("val", "i64"), "c_size_t": ("val", "i64"),
    "c_bool": ("val", "u8"),
    "c_void_p": ("ptr", "void"), "c_char_p": ("ptr", "i8"),
}


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.DOTALL)
    return re.sub(r"//[^\n]*", "", text)


def _parse_c_arg(raw: str) -> Optional[CType]:
    raw = raw.strip()
    if not raw or raw == "void":
        return None
    is_ptr = "*" in raw
    tokens = [t for t in re.split(r"[\s\*]+", raw)
              if t and t not in ("const", "restrict", "volatile", "struct")]
    # drop the parameter name (last token unless it is itself the type)
    type_tokens = [t for t in tokens if t in _C_WIDTHS]
    if not type_tokens:
        return ("val", f"?{raw}")
    width = _C_WIDTHS[type_tokens[0]]
    return ("ptr" if is_ptr else "val", width)


def parse_cpp(text: str, pattern: "re.Pattern" = _SIG_RE
              ) -> Tuple[Dict[str, Tuple[CType, List[CType]]],
                         Optional[int]]:
    """{export name: (return, [args])}, abi version. ``pattern`` picks
    the grammar: the ``rt_*`` exports (default) or, for a CUDA source,
    :func:`parse_cu`'s ``extern "C"`` definitions."""
    text = _strip_comments(text)
    out: Dict[str, Tuple[CType, List[CType]]] = {}
    for m in pattern.finditer(text):
        ret_raw, name, args_raw = m.groups()
        ret_width = _C_WIDTHS[ret_raw.replace("*", "").strip()]
        ret = ("ptr", ret_width) if "*" in ret_raw \
            else ("val", ret_width)
        args: List[CType] = []
        if args_raw.strip() and args_raw.strip() != "void":
            for part in args_raw.split(","):
                a = _parse_c_arg(part)
                if a is not None:
                    args.append(a)
        out[name] = (ret, args)
    vm = _VERSION_RE.search(text)
    return out, (int(vm.group(1)) if vm else None)


def parse_cu(text: str) -> Dict[str, Tuple[CType, List[CType]]]:
    """{entry point: (return, [args])} of a CUDA source's ``extern "C"``
    definitions."""
    return parse_cpp(text, _EXTERN_C_RE)[0]


# ---- Python (ctypes) side --------------------------------------------------

def _ndpointer_width(call: ast.Call) -> Optional[str]:
    if not call.args:
        return None
    d = _last_attr(call.args[0])
    return _NDP_DTYPES.get(d or "")


def _last_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _classify_py(node: ast.AST, aliases: Dict[str, CType]) -> CType:
    """ctypes argtype expression -> (kind, width); unknown -> ('?', repr)."""
    if isinstance(node, ast.Name):
        got = aliases.get(node.id)
        if got is not None:
            return got
        got = _CTYPES_SCALARS.get(node.id)
        if got is not None:
            return got
        return ("?", node.id)
    if isinstance(node, ast.Attribute):
        got = _CTYPES_SCALARS.get(node.attr)
        if got is not None:
            return got
        return ("?", node.attr)
    if isinstance(node, ast.Call):
        leaf = _last_attr(node.func)
        if leaf == "POINTER" and node.args:
            inner = _classify_py(node.args[0], aliases)
            return ("ptr", inner[1])
        if leaf == "ndpointer":
            w = _ndpointer_width(node)
            if w:
                return ("ptr", w)
        return ("?", ast.dump(node)[:40])
    if isinstance(node, ast.Constant) and node.value is None:
        return ("val", "void")  # restype = None: explicit void
    return ("?", type(node).__name__)


class _PyBindings(ast.NodeVisitor):
    """argtypes/restype assignments + ABI_VERSION from the binding module.
    ``names`` limits the bound functions collected (default: ``rt_*``)."""

    def __init__(self, names: Optional[Sequence[str]] = None):
        self.names = None if names is None else frozenset(names)
        self.aliases: Dict[str, CType] = {}
        self.functions: Dict[str, str] = {}  # fn = lib.name
        self.argtypes: Dict[str, Tuple[int, List[CType]]] = {}
        self.restype: Dict[str, Tuple[int, CType]] = {}
        self.version: Optional[int] = None
        self.version_line = 0

    def _wanted(self, name: str) -> bool:
        return name.startswith("rt_") if self.names is None \
            else name in self.names

    def _alias(self, name: str, value: ast.AST) -> None:
        """Record ``name = value`` as a ctypes type alias or a function
        alias (``fn = lib.viterbi_decode``)."""
        if isinstance(value, (ast.Call, ast.Attribute, ast.Name)):
            got = _classify_py(value, self.aliases)
            if got[0] != "?":
                self.aliases[name] = got
            elif isinstance(value, ast.Attribute) \
                    and self._wanted(value.attr):
                self.functions[name] = value.attr

    def visit_Assign(self, node: ast.Assign) -> None:
        target = node.targets[0] if len(node.targets) == 1 else None
        # alias definitions: f32p = np.ctypeslib.ndpointer(np.float32, ..),
        # i64ref = ctypes.POINTER(i64), p, i = ctypes.c_void_p, ctypes.c_int
        if isinstance(target, ast.Name):
            if target.id == "ABI_VERSION" \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, int):
                self.version = node.value.value
                self.version_line = node.lineno
            else:
                self._alias(target.id, node.value)
        elif isinstance(target, ast.Tuple) \
                and isinstance(node.value, ast.Tuple) \
                and len(target.elts) == len(node.value.elts):
            for t, v in zip(target.elts, node.value.elts):
                if isinstance(t, ast.Name):
                    self._alias(t.id, v)
        # lib.rt_x.argtypes = [...] / lib.rt_x.restype = ... / fn.argtypes
        fname = None
        if isinstance(target, ast.Attribute):
            owner = target.value
            if isinstance(owner, ast.Attribute) and self._wanted(owner.attr):
                fname = owner.attr
            elif isinstance(owner, ast.Name):
                fname = self.functions.get(owner.id)
        if fname is not None:
            if target.attr == "argtypes":
                elems = node.value.elts \
                    if isinstance(node.value, (ast.List, ast.Tuple)) else []
                self.argtypes[fname] = (
                    node.lineno,
                    [_classify_py(e, self.aliases) for e in elems])
            elif target.attr == "restype":
                self.restype[fname] = (
                    node.lineno, _classify_py(node.value, self.aliases))
        self.generic_visit(node)


def _compatible(c: CType, py: CType) -> bool:
    ck, cw = c
    pk, pw = py
    if ck != pk:
        return False
    if ck == "ptr":
        eight_bit = {"i8", "u8"}
        if cw in eight_bit and pw in eight_bit:
            return True
    return cw == pw


def _fmt(t: CType) -> str:
    kind, width = t
    return f"{width}*" if kind == "ptr" else width


def check(cpp_text: str, py_text: str, cpp_rel: str = DEFAULT_CPP,
          py_rel: str = DEFAULT_PY) -> List[Finding]:
    """Cross-check one (host_runtime.cpp, native/__init__.py) pair."""
    exports, c_version = parse_cpp(cpp_text)
    pb = _PyBindings()
    pb.visit(ast.parse(py_text, filename=py_rel))
    return _version_findings(c_version, pb, cpp_rel, py_rel) \
        + _compare(exports, pb, cpp_rel, py_rel)


def check_card(cu_text: str, bindings: Dict[str, Tuple[str, Tuple[str, ...]]],
               cu_rel: str) -> List[Finding]:
    """Cross-check one CUDA source's ``extern "C"`` entry points against
    its binding modules: ``bindings`` maps each module's relpath to
    (its text, the entry points it binds). An entry point no module
    binds, or a module binding a name the source does not define, is
    ABI001."""
    exports = parse_cu(cu_text)
    findings: List[Finding] = []
    claimed = set()
    for py_rel, (py_text, names) in sorted(bindings.items()):
        claimed.update(names)
        pb = _PyBindings(names)
        pb.visit(ast.parse(py_text, filename=py_rel))
        mine = {n: exports[n] for n in names if n in exports}
        for n in names:
            if n not in exports and n not in pb.argtypes:
                findings.append(Finding(
                    cu_rel, 1, "ABI001",
                    f"{n} is bound from {py_rel} but {cu_rel} has no "
                    'extern "C" definition of it'))
        findings.extend(_compare(mine, pb, cu_rel, py_rel))
    for n in sorted(set(exports) - claimed):
        findings.append(Finding(
            cu_rel, 1, "ABI001",
            f'extern "C" {n} is bound by no module in CARD_PAIRS — '
            "ctypes would guess int-sized arguments"))
    return findings


def _version_findings(c_version: Optional[int], pb: "_PyBindings",
                      cpp_rel: str, py_rel: str) -> List[Finding]:
    findings: List[Finding] = []
    if c_version is None:
        findings.append(Finding(cpp_rel, 1, "ABI004",
                                "rt_abi_version() not found in the C++ "
                                "runtime"))
    elif pb.version is None:
        findings.append(Finding(py_rel, 1, "ABI004",
                                "ABI_VERSION constant not found in the "
                                "binding"))
    elif c_version != pb.version:
        findings.append(Finding(
            py_rel, pb.version_line, "ABI004",
            f"ABI_VERSION={pb.version} but rt_abi_version() returns "
            f"{c_version} — bump both in the same commit"))
    return findings


def _compare(exports: Dict[str, Tuple[CType, List[CType]]],
             pb: "_PyBindings", cpp_rel: str, py_rel: str) -> List[Finding]:
    findings: List[Finding] = []
    for name in sorted(set(exports) | set(pb.argtypes)):
        if name not in exports:
            line = pb.argtypes[name][0]
            findings.append(Finding(
                py_rel, line, "ABI001",
                f"{name} has argtypes but no extern \"C\" definition in "
                f"{cpp_rel}"))
            continue
        c_ret, c_args = exports[name]
        if name not in pb.argtypes:
            findings.append(Finding(
                py_rel, 1, "ABI001",
                f"extern \"C\" {name} has no argtypes binding — ctypes "
                "would guess int-sized arguments"))
            continue
        line, py_args = pb.argtypes[name]
        if len(c_args) != len(py_args):
            findings.append(Finding(
                py_rel, line, "ABI002",
                f"{name}: {len(py_args)} argtypes vs {len(c_args)} C "
                "parameters"))
        else:
            for i, (ca, pa) in enumerate(zip(c_args, py_args)):
                if pa[0] == "?":
                    findings.append(Finding(
                        py_rel, line, "ABI003",
                        f"{name} arg {i}: unresolvable argtype {pa[1]!r}"))
                elif not _compatible(ca, pa):
                    findings.append(Finding(
                        py_rel, line, "ABI003",
                        f"{name} arg {i}: binding passes {_fmt(pa)} but C "
                        f"expects {_fmt(ca)}"))
        # return type
        got = pb.restype.get(name)
        if c_ret == ("val", "void"):
            if got is not None and got[1] != ("val", "void"):
                findings.append(Finding(
                    py_rel, got[0], "ABI005",
                    f"{name}: restype set to {_fmt(got[1])} but C returns "
                    "void"))
        else:
            if got is None:
                findings.append(Finding(
                    py_rel, line, "ABI005",
                    f"{name}: C returns {_fmt(c_ret)} but restype is "
                    "unset (ctypes truncates to c_int)"))
            elif not _compatible(c_ret, got[1]):
                findings.append(Finding(
                    py_rel, got[0], "ABI005",
                    f"{name}: restype {_fmt(got[1])} but C returns "
                    f"{_fmt(c_ret)}"))
    return findings


def _read(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read()


def run_paths(cpp_path: str, py_path: str, cpp_rel: str,
              py_rel: str) -> List[Finding]:
    return check(_read(cpp_path), _read(py_path), cpp_rel, py_rel)


def run_card(repo_root: str,
             overrides: Optional[Dict[str, str]] = None) -> List[Finding]:
    """Every ``CARD_PAIRS`` source against its binding modules, read
    under ``repo_root``; ``overrides`` maps a relpath to the path of a
    file to read in its place (a drifted copy)."""
    overrides = overrides or {}

    def text(rel: str) -> str:
        return _read(overrides.get(rel) or os.path.join(repo_root, rel))

    findings: List[Finding] = []
    for cu_rel, modules in CARD_PAIRS:
        findings.extend(check_card(
            text(cu_rel),
            {py_rel: (text(py_rel), names)
             for py_rel, names in modules.items()}, cu_rel))
    return findings
