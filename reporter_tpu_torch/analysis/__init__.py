"""Analysis of the port: static lint passes and the runtime witness.

The lint passes are AST (and, for the ABI, text) checks of
``reporter_tpu_torch`` itself, pinning invariants the code depends on but
no general-purpose tool can see. Four per-file code passes:

  hotpath         HP001-HP003   the columnar host pipeline stays columnar
  locks           LD001         lock-guarded state is guarded at every write
  lockgraph       LD002-LD003   no lock cycles; no lock held across
                                blocking HTTP/subprocess/native calls or
                                kernel builds
  durability      DUR001-DUR004 tmp+fsync+replace+dir-fsync commits in the
                                durable modules; epoch marker after sink ack

five cross-layer contract passes against the declarative registry
(:mod:`registry`):

  registry_drift  KN001-KN002   config keys: code <-> registry <-> README
                  MT001-MT002   metric names: call sites <-> registry
  fault_coverage  FP001-FP003   failpoint sites: registered, hooked, and
                                exercised by a fault test or the card run
  tensorcontract  TC001-TC002   the kernels' plain versions keep the
                                committed shape/dtype signatures (on meta
                                tensors); counted wrappers <-> contracts
                                <-> the card's ``extern "C"`` entries
  placement       DP001-DP003   device lanes bring device values to the
                                host only at declared sync points
  fallback        FB001-FB003   every circuit domain declares its fault
                                site, config key, fallback leg ("raises"
                                on the card) and parity test

and the ABI pass over both native boundaries:

  abi             ABI001-ABI005 the ctypes bindings mirror
                                host_runtime.cpp and the card's
                                ``extern "C"`` entry points

Driver: ``python -m reporter_tpu_torch.tools.lint``. Suppress a
documented false positive with a ``# lint: ignore[RULE-ID]`` comment on
the line (or the line above), with its reason beside it. The baseline
(``lint_baseline.txt`` here) is committed empty.

:mod:`racecheck` is the runtime concurrency witness the lock factory in
:mod:`..utils.locks` feeds when armed; its RC rules join the catalogue
but no static pass emits them. :mod:`dsmem_atomics` is a card probe.

The lint modules import nothing beyond the stdlib, so the lint runs on a
host with no accelerator stack; tensorcontract's TC001 imports torch
inside its harness (full runs only) and needs no device. The JAX
package's ``jit_hygiene`` pass and its TC003/TC004 have no subject here:
the port has no traced region (no ``torch.compile``, no ``torch.jit``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from . import (abi, durability, fallback, fault_coverage, hotpath,
               lockgraph, locks, placement, racecheck, registry,
               registry_drift, tensorcontract)
from .core import (Finding, SourceFile, collect_py_files, compare_baseline,
                   filter_suppressed, load_baseline)

#: per-file code passes, in report order (abi runs separately on its file
#: pairs). These are safe on partial runs: a subset of files can only
#: under-report, never false-fire.
CODE_PASSES = (hotpath, locks, lockgraph, durability)

#: cross-layer contract passes needing the WHOLE package (plus README and
#: the fault tests) in view: their reverse directions (dead entries, doc
#: drift, coverage) would false-fire on a subset.
CONTRACT_PASSES = (registry_drift, fault_coverage, tensorcontract,
                   placement, fallback)

ALL_RULES: Dict[str, str] = {}
for _p in (*CODE_PASSES, *CONTRACT_PASSES, abi, racecheck):
    ALL_RULES.update(_p.RULES)


def run_code_passes(files: Sequence[SourceFile],
                    repo_root: str) -> List[Finding]:
    findings: List[Finding] = []
    for p in CODE_PASSES:
        findings.extend(p.run(files, repo_root))
    return sorted(filter_suppressed(findings, files))


def run_contract_passes(files: Sequence[SourceFile], repo_root: str,
                        full_scope: bool = True) -> List[Finding]:
    """The registry-backed cross-layer passes. ``full_scope`` tells the
    passes whether the whole package is in view (partial runs check only
    the code -> registry direction)."""
    findings: List[Finding] = []
    for p in CONTRACT_PASSES:
        findings.extend(p.run(files, repo_root, full_scope=full_scope))
    return sorted(filter_suppressed(findings, files))


__all__ = ["Finding", "SourceFile", "collect_py_files", "load_baseline",
           "compare_baseline", "filter_suppressed", "run_code_passes",
           "run_contract_passes", "CODE_PASSES", "CONTRACT_PASSES",
           "ALL_RULES", "abi", "hotpath", "locks", "lockgraph",
           "durability", "registry", "registry_drift", "fault_coverage",
           "tensorcontract", "placement", "fallback", "racecheck"]
