"""Tensor-contract pass (TC rules): the kernels' shape and dtype signatures.

Each hand kernel's wrapper is held on the card against its plain version,
and the plain version is what the CPU runs: so the plain version's
signature is the contract every caller and the kernel keep. A silent
f32 to f64 widening doubles the bytes a launch moves, a new axis or a
dropped output breaks the callers at dispatch time. This pass runs each
kernel's plain version on ``torch.device("meta")`` tensors (shapes and
dtypes only: nothing is allocated and nothing computed) at the JAX
package's representative dimensions and time buckets
(``tools/kernel_contracts.json``'s ``dims`` and ``buckets``), and diffs
the signatures against the committed
``reporter_tpu_torch/tools/kernel_contracts.json``.

TC001  signature drift: the committed contract and the fresh signature
       disagree (an input or output shape or dtype, the output count,
       the keyword arguments), or the contract file lags the harness (an
       entry added or removed without a regeneration).
TC002  three-sided kernel coverage: every counted kernel wrapper of
       ``ops/`` (a function whose ``.launches`` counts its launches) is a
       ``registry.KERNEL_CONTRACTS`` key and every key a counted
       wrapper; every card ``extern "C"`` entry point of the ABI pass's
       sources (``abi.CARD_PAIRS``) is claimed by one contract, and every
       entry point a contract names exists; a contract's plain version
       names a function of the package.

The relaxation's plain version loops until a sweep changes nothing, a
read of values that meta tensors do not have: its case runs the
initial state and one sweep (``relax_step``) on meta tensors, with the
sweep count and convergence flag as an ``int`` and a ``bool`` output.

No subject in the port: the JAX pass's TC003 (a ``jnp.where`` whose two
branches are weak-typed Python scalars inside a jitted region) and TC004
(``static_argnames`` naming an array), and the ``jit_hygiene`` pass that
enumerates jitted regions. The port has no traced region: no
``torch.compile``, no ``torch.jit`` and no graph capture on its paths, so
every torch op runs eagerly with the dtypes its operands carry, and a
keyword argument is a plain Python value on every call.

Regeneration: ``python -m reporter_tpu_torch.analysis.tensorcontract
--write`` rewrites the contract file from the live plain versions; a test
pins the committed file to stay a subset of a fresh regeneration.

The AST side (TC002) is stdlib only; torch is imported inside
:func:`compute_signatures`, on full-scope runs.
"""
from __future__ import annotations

import ast
import json
import os
from typing import Dict, List, Optional, Sequence, Set

from . import abi, registry
from .core import Finding, SourceFile

RULES = {
    "TC001": "kernel signature drift against kernel_contracts.json",
    "TC002": "kernel wrapper <-> registry.KERNEL_CONTRACTS <-> extern "
             "\"C\" coverage gap",
}

REGISTRY_REL = "reporter_tpu_torch/analysis/registry.py"
CONTRACTS_REL = "reporter_tpu_torch/tools/kernel_contracts.json"
OPS_PREFIX = "reporter_tpu_torch/ops/"

#: the JAX package's representative dimensions (its contract file's
#: ``dims``) and R, the incremental kernel's rounds a launch
DIMS = {"B": 8, "K": 4, "N": 96, "E": 256, "S": 16, "R": 4}
#: the JAX package's time buckets (its contract file's ``buckets``)
BUCKETS = (64, 256)

_F32, _I32, _BOOL = "float32", "int32", "bool"


def _decode_cases(d):
    """(dist_m, valid, route_m, gc_m, case, sigma, beta) a bucket."""
    B, K = d["B"], d["K"]
    return [([((B, T, K), _F32), ((B, T, K), _BOOL),
              ((B, T - 1, K, K), _F32), ((B, T - 1), _F32),
              ((B, T), _I32), ((), _F32), ((), _F32)], {})
            for T in BUCKETS]


def _incremental_cases(d):
    """(dist_m, valid, route_m, gc_m, case, prev_scores, n_steps, sigma,
    beta): R rounds, and one, for N = B carried traces (no time axis)."""
    N, K = d["B"], d["K"]
    return [([((R, N, K), _F32), ((R, N, K), _BOOL), ((R, N, K, K), _F32),
              ((R, N), _F32), ((R, N), _I32), ((N, K), _F32),
              ((N,), _I32), ((), _F32), ((), _F32)], {})
            for R in (1, d["R"])]


def _relax_cases(d):
    E, S, N = d["E"], d["S"], d["N"]
    return [([((E,), _I32), ((E,), _I32), ((E,), _F32), ((E,), _F32),
              ((S,), _I32), ((), _F32)],
             {"n_nodes": N, "max_iters": 64})]


def _packed_cases(d):
    B, K, E, S, N = d["B"], d["K"], d["E"], d["S"], d["N"]
    out = []
    for T in BUCKETS:
        btk, bt1 = B * T * K, B * (T - 1)
        out.append(([((btk + B + N,), _I32), ((btk + 2 * bt1 + 2,), _F32),
                     ((S, N), _F32), ((S, N), _F32),
                     ((E,), _I32), ((E,), _I32), ((E,), _F32),
                     ((E,), _F32), ((E,), _F32), ((E,), _F32)],
                    {"B": B, "T": T, "K": K, "N": N}))
    return out


#: plain version -> the function that makes its cases
CASES = {
    "reporter_tpu_torch/matcher/hmm.py::viterbi_decode_batch":
        _decode_cases,
    "reporter_tpu_torch/ops/incremental.py::incremental_steps_plain":
        _incremental_cases,
    "reporter_tpu_torch/ops/route_relax.py::relax_csr": _relax_cases,
    "reporter_tpu_torch/ops/route_relax.py::pair_costs_packed":
        _packed_cases,
}


def _load(spec: str):
    import importlib
    relpath, fname = spec.split("::")
    return getattr(importlib.import_module(
        relpath[:-3].replace("/", ".")), fname)


def _signature(out) -> list:
    """[[shape, dtype]] of a result's leaves; an int or a bool output as
    [[], "int"] or [[], "bool"]."""
    import torch
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    sig = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            sig.append([list(leaf.shape), str(leaf.dtype).split(".")[-1]])
        else:
            sig.append([[], type(leaf).__name__])
    return sig


def _run_case(plain: str, fn, tensors, keywords):
    if plain.endswith("::relax_csr"):
        # the loop reads values; the initial state, then one sweep
        from ..ops.route_relax import relax_step
        kw = dict(keywords, max_iters=0)
        dist, time, iters, converged = fn(*tensors, **kw)
        es, ee, el, esecs, _src, bound = tensors
        dist, time = relax_step(dist, time, es.long(), ee.long(), el, esecs,
                                bound)
        return dist, time, iters + 1, bool(converged)
    return fn(*tensors, **keywords)


def compute_signatures(contracts: Optional[Dict[str, dict]] = None
                       ) -> dict:
    """Run every contract's plain version on meta tensors; the table the
    contract file holds."""
    import torch
    contracts = registry.KERNEL_CONTRACTS if contracts is None \
        else contracts
    meta = torch.device("meta")
    entries: Dict[str, dict] = {}
    for key in sorted(contracts):
        plain = contracts[key]["plain"]
        build = CASES.get(plain)
        if build is None:
            continue
        fn = _load(plain)
        cases = []
        names: Set[str] = set()
        for inputs, keywords in build(DIMS):
            names |= set(keywords)
            tensors = [torch.empty(shape, dtype=getattr(torch, dt),
                                   device=meta) for shape, dt in inputs]
            out = _run_case(plain, fn, tensors, keywords)
            cases.append({
                "keywords": {k: keywords[k] for k in sorted(keywords)},
                "inputs": [[list(s), dt] for s, dt in inputs],
                "outputs": _signature(out)})
        entries[key] = {"plain": plain, "keyword_args": sorted(names),
                        "cases": cases}
    return {"version": 1, "dims": dict(DIMS), "buckets": list(BUCKETS),
            "entries": entries}


def _diff_entry(committed: dict, fresh: dict) -> Optional[str]:
    """The first difference between two contract entries, in words."""
    for field in ("plain", "keyword_args"):
        if committed.get(field) != fresh.get(field):
            return (f"{field} {committed.get(field)} != fresh "
                    f"{fresh.get(field)}")
    cc, fc = committed.get("cases", []), fresh.get("cases", [])
    if len(cc) != len(fc):
        return f"{len(cc)} contracted case(s) != {len(fc)} fresh"
    for i, (c, f) in enumerate(zip(cc, fc)):
        for side in ("keywords", "inputs"):
            if c.get(side) != f.get(side):
                return f"case {i} {side}: {c.get(side)} != {f.get(side)}"
        co, fo = c.get("outputs", []), f.get("outputs", [])
        if len(co) != len(fo):
            return (f"case {i}: output count {len(co)} contracted != "
                    f"{len(fo)} fresh")
        for j, (a, b) in enumerate(zip(co, fo)):
            if a != b:
                return (f"case {i} output {j}: contracted shape={a[0]} "
                        f"dtype={a[1]}, fresh shape={b[0]} dtype={b[1]}")
    return None


# ---- the AST side (TC002) ---------------------------------------------------

def counted_wrappers(files: Sequence[SourceFile]) -> Dict[str, int]:
    """``relpath::name`` -> line of every ``<name>.launches = 0`` at a
    module's top level under ``ops/``: the counted kernel wrappers."""
    out: Dict[str, int] = {}
    for sf in files:
        if not sf.relpath.startswith(OPS_PREFIX):
            continue
        for node in sf.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Attribute) and t.attr == "launches" \
                        and isinstance(t.value, ast.Name):
                    out[f"{sf.relpath}::{t.value.id}"] = node.lineno
    return out


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


def _functions(files: Sequence[SourceFile]) -> Set[str]:
    return {f"{sf.relpath}::{node.name}" for sf in files
            for node in sf.tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))}


def card_entries(repo_root: str) -> Dict[str, str]:
    """extern "C" entry point -> its CUDA source, over abi.CARD_PAIRS."""
    out: Dict[str, str] = {}
    for cu_rel, _modules in abi.CARD_PAIRS:
        try:
            with open(os.path.join(repo_root, cu_rel),
                      encoding="utf-8") as f:
                text = f.read()
        except OSError:
            continue
        for name in abi.parse_cu(text):
            out[name] = cu_rel
    return out


def run(files: Sequence[SourceFile], repo_root: str,
        contracts: Optional[Dict[str, dict]] = None,
        signatures: Optional[dict] = None,
        contracts_path: Optional[str] = None,
        entries: Optional[Dict[str, str]] = None,
        full_scope: bool = True) -> List[Finding]:
    """The TC findings. ``full_scope=False`` (a partial or fixture run)
    checks only the code -> registry direction of TC002; the reverse
    directions and TC001 need the whole package in view. ``signatures``
    injects a fresh signature table (tests mutate one); ``entries`` the
    card's entry points (default: read from ``abi.CARD_PAIRS``)."""
    contracts = dict(registry.KERNEL_CONTRACTS if contracts is None
                     else contracts)
    findings: List[Finding] = []
    reg_lines = _registry_lines(repo_root)

    wrappers = counted_wrappers(files)
    for key, line in sorted(wrappers.items()):
        if key not in contracts:
            findings.append(Finding(
                key.split("::")[0], line, "TC002",
                f"counted kernel wrapper {key} is not in registry."
                "KERNEL_CONTRACTS: its plain version's signature is held "
                "by nothing (TC001)"))
    if not full_scope:
        return findings

    for key in sorted(set(contracts) - set(wrappers)):
        findings.append(Finding(
            REGISTRY_REL, reg_lines.get(key, 1), "TC002",
            f"KERNEL_CONTRACTS entry {key} names no counted kernel "
            "wrapper: the kernel it contracts is gone or renamed"))
    funcs = _functions(files)
    for key in sorted(contracts):
        plain = contracts[key].get("plain")
        if plain not in funcs:
            findings.append(Finding(
                REGISTRY_REL, reg_lines.get(key, 1), "TC002",
                f"KERNEL_CONTRACTS entry {key}: plain version {plain} "
                "names no function of the package"))
    entries = card_entries(repo_root) if entries is None else entries
    claimed: Dict[str, str] = {}
    for key in sorted(contracts):
        for name in contracts[key].get("entries", ()):
            claimed[name] = key
            if name not in entries:
                findings.append(Finding(
                    REGISTRY_REL, reg_lines.get(key, 1), "TC002",
                    f"KERNEL_CONTRACTS entry {key} names extern \"C\" "
                    f"{name}, which no card source defines"))
    for name in sorted(set(entries) - set(claimed)):
        findings.append(Finding(
            entries[name], 1, "TC002",
            f"extern \"C\" {name} is claimed by no KERNEL_CONTRACTS "
            "entry: a card entry point outside every contract"))

    # -- TC001: the meta-tensor signatures against the committed file ----
    path = contracts_path or os.path.join(repo_root, CONTRACTS_REL)
    try:
        with open(path, encoding="utf-8") as f:
            committed = json.load(f)
    except (OSError, ValueError):
        findings.append(Finding(
            CONTRACTS_REL, 1, "TC001",
            "committed contract file missing or unparseable: run python "
            "-m reporter_tpu_torch.analysis.tensorcontract --write"))
        return findings
    fresh = compute_signatures(contracts) if signatures is None \
        else signatures
    com_e = committed.get("entries", {})
    fre_e = fresh.get("entries", {})
    for key in sorted(set(com_e) | set(fre_e)):
        relpath = key.split("::")[0]
        line = wrappers.get(key, 1)
        where = relpath if key in wrappers else CONTRACTS_REL
        if key not in fre_e:
            findings.append(Finding(
                where, line, "TC001",
                f"contract entry {key} is no longer computed by the "
                "harness: regenerate the contract file"))
        elif key not in com_e:
            findings.append(Finding(
                where, line, "TC001",
                f"kernel {key} has a signature but no committed "
                "contract: regenerate the contract file"))
        else:
            diff = _diff_entry(com_e[key], fre_e[key])
            if diff is not None:
                findings.append(Finding(
                    where, line, "TC001",
                    f"signature drift for {key}: {diff}"))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m reporter_tpu_torch.analysis.tensorcontract --write``
    rewrites the committed contract file from the live plain versions;
    without ``--write`` (or ``--out``) it prints the table."""
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m reporter_tpu_torch.analysis.tensorcontract")
    parser.add_argument("--write", action="store_true",
                        help=f"rewrite {CONTRACTS_REL}")
    parser.add_argument("--out", default=None,
                        help="write to this path instead")
    args = parser.parse_args(argv)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    text = json.dumps(compute_signatures(), indent=2, sort_keys=True) + "\n"
    if args.write or args.out:
        out = args.out or os.path.join(repo_root, CONTRACTS_REL)
        with open(out, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"wrote {len(json.loads(text)['entries'])} contract "
              f"entr(y/ies) to {out}")
    else:
        print(text, end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
