"""The port's lint driver: run the static-analysis passes over
``reporter_tpu_torch``.

Usage::

  python -m reporter_tpu_torch.tools.lint              # full suite
  python -m reporter_tpu_torch.tools.lint --abi-only   # both ABI checks
  python -m reporter_tpu_torch.tools.lint --contracts-only
                               # registry drift, fault coverage, failure
                               # domains, durability, lock graph
  python -m reporter_tpu_torch.tools.lint --locks-only # LD001-LD003
  python -m reporter_tpu_torch.tools.lint --list-rules # rule catalogue
  python -m reporter_tpu_torch.tools.lint path.py ...  # code passes on
                                                       # these paths only

Exit status: 0 clean; 1 findings (or stale baseline entries); 2 usage
or internal error. Output lines are ``file:line: RULE-ID message``.

The baseline (``reporter_tpu_torch/analysis/lint_baseline.txt``) is
committed empty: a finding is fixed, or suppressed inline with
``# lint: ignore[RULE-ID]`` and its reason. An entry that stops firing
fails the run as stale; ``--write-baseline`` rewrites the file from the
current findings (a full run only). ``--abi-only``, ``--contracts-only``
and ``--locks-only`` ignore the baseline.
"""
from __future__ import annotations

import argparse
import os
import sys

from .. import analysis
from ..analysis import abi

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE)
DEFAULT_BASELINE = os.path.join(PACKAGE, "analysis", "lint_baseline.txt")


def _report(findings, label: str, ok: str) -> int:
    for f in findings:
        print(f.render())
    if findings:
        print(f"lint {label}: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    print(f"lint {label}: {ok}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m reporter_tpu_torch.tools.lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("paths", nargs="*",
                        help="files/dirs for the code passes (default: "
                             "the reporter_tpu_torch package)")
    parser.add_argument("--abi-only", action="store_true",
                        help="run only the ABI checks (host runtime and "
                             "the card's entry points)")
    parser.add_argument("--contracts-only", action="store_true",
                        help="run only the cross-layer contract passes")
    parser.add_argument("--locks-only", action="store_true",
                        help="run only the lock passes (LD001-LD003)")
    parser.add_argument("--abi-cpp", default=None,
                        help="read this file as the host runtime source")
    parser.add_argument("--abi-py", default=None,
                        help="read this file as the host runtime binding")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE,
                        help="baseline file (default: the committed, "
                             "empty analysis/lint_baseline.txt)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="rewrite the baseline from current findings")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in sorted(analysis.ALL_RULES):
            print(f"{rule}  {analysis.ALL_RULES[rule]}")
        return 0

    def abi_findings():
        cpp = args.abi_cpp or os.path.join(REPO_ROOT, abi.DEFAULT_CPP)
        py = args.abi_py or os.path.join(REPO_ROOT, abi.DEFAULT_PY)
        return sorted(abi.run_paths(
            cpp, py, os.path.relpath(cpp, REPO_ROOT).replace(os.sep, "/"),
            os.path.relpath(py, REPO_ROOT).replace(os.sep, "/"))
            + abi.run_card(REPO_ROOT))

    if args.abi_only:
        return _report(abi_findings(), "--abi-only",
                       "bindings match the host runtime and the card's "
                       "entry points")

    if args.locks_only or args.contracts_only:
        files = analysis.collect_py_files(REPO_ROOT, [PACKAGE])
        passes = (analysis.locks, analysis.lockgraph) if args.locks_only \
            else (analysis.durability, analysis.lockgraph)
        findings = analysis.filter_suppressed(
            [f for p in passes for f in p.run(files, REPO_ROOT)], files)
        if args.contracts_only:
            findings += analysis.run_contract_passes(files, REPO_ROOT)
            label = "--contracts-only"
        else:
            label = "--locks-only"
        return _report(sorted(findings), label,
                       f"clean ({len(files)} files)")

    partial = bool(args.paths)
    if args.write_baseline and partial:
        # a partial run sees a subset of findings; writing it out would
        # drop every entry outside the paths
        print("error: --write-baseline requires a full run (no paths)",
              file=sys.stderr)
        return 2
    roots = [os.path.abspath(p) for p in args.paths] if partial \
        else [PACKAGE]
    files = analysis.collect_py_files(REPO_ROOT, roots)
    findings = analysis.run_code_passes(files, REPO_ROOT)
    # the ABI pairs are fixed infrastructure, and the contract passes'
    # reverse directions need every file in view: whole-package only
    findings = sorted(findings + (
        analysis.run_contract_passes(files, REPO_ROOT, full_scope=False)
        if partial else
        abi_findings() + analysis.run_contract_passes(files, REPO_ROOT)))

    if args.write_baseline:
        with open(args.baseline, "w", encoding="utf-8") as f:
            for fnd in findings:
                f.write(fnd.render() + "\n")
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    baseline = analysis.load_baseline(args.baseline)
    new, stale = analysis.compare_baseline(findings, baseline)
    if partial:
        # entries for files outside the paths legitimately did not fire
        stale = []
    for f in new:
        print(f.render())
    for entry in stale:
        print(f"stale baseline entry (no longer fires — remove it): "
              f"{entry}")
    if new or stale:
        print(f"lint: {len(new)} finding(s), {len(stale)} stale baseline "
              f"entr(y/ies)", file=sys.stderr)
        return 1
    n_base = f" ({len(baseline)} baselined)" if baseline else ""
    print(f"lint: clean — {len(files)} files, {len(analysis.ALL_RULES)} "
          f"rules{n_base}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
