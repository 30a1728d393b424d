"""The port's sanitizer legs: the host runtime under ASan, UBSan and TSan.

Usage::

  python -m reporter_tpu_torch.tools.sanitize            # asan, then ubsan
  python -m reporter_tpu_torch.tools.sanitize tsan       # ThreadSanitizer
  python -m reporter_tpu_torch.tools.sanitize asan|ubsan # one leg
  ... [--cxx g++]                                         # the compiler

Each leg builds ``native/csrc/host_runtime.cpp`` with ``SAN_FLAGS`` and
the leg's ``-fsanitize=`` into ``reporter_tpu_torch/_build/`` (named by a
hash of the source and the flags, as ``native.build`` names the regular
library), then runs a child interpreter with the sanitizer's runtime in
``LD_PRELOAD``: the interpreter stays uninstrumented, and the preloaded
runtime resolves the instrumented library's symbols. The child binds that
library with ``native.load(library=path)``, which holds it to the same
ABI handshake as the regular build.

- asan and ubsan: the child runs ``TESTS`` through ``pytest.main`` in its
  own process, the native prep at two threads (``PREP_THREADS``). For
  asan, libstdc++ is preloaded too: asan's ``__cxa_throw`` interceptor must
  find the real symbol at start-up, before a C++ extension loaded later
  throws. Leak checking is off: the interpreter does not free everything
  at exit, and the legs look for overflows and undefined behaviour in the
  runtime.
- tsan: the child runs ``tools/tsan_drive.py``, not pytest (pytest
  deadlocks under a preloaded libtsan on common glibc pairings), at four
  prep threads and a memo bound of 64 pairs.

The skip contract: a leg whose compiler cannot link its sanitizer's
runtime prints a notice and is skipped; for tsan, so is one whose
runtime does not survive being preloaded into an interpreter. A run where
every leg was skipped exits 0. Otherwise the exit is 1 on any sanitizer
report (``halt_on_error``/``abort_on_error`` end the child) or failed test,
else 0.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

from .. import native

REPO = Path(__file__).resolve().parents[2]
#: the reference Makefile's sanitizer flags (F16C added as ``native``
#: adds it); ``-shared`` and the leg's ``-fsanitize=`` follow
SAN_FLAGS = ("-O1", "-g", "-fno-omit-frame-pointer", "-std=c++17", "-fPIC",
             "-pthread", "-Wall", "-Wextra")
#: leg -> (the leg's own flags, its runtime library, the child's options
#: variable and value)
LEGS = {
    "asan": (("-fsanitize=address",), "libasan.so",
             ("ASAN_OPTIONS", "detect_leaks=0:abort_on_error=1")),
    "ubsan": (("-fsanitize=undefined", "-fno-sanitize-recover=undefined"),
              "libubsan.so",
              ("UBSAN_OPTIONS", "print_stacktrace=1:halt_on_error=1")),
    "tsan": (("-fsanitize=thread",), "libtsan.so",
             ("TSAN_OPTIONS", "halt_on_error=1:report_thread_leaks=0:"
                              "report_signal_unsafe=0")),
}
#: the port's native test files: the host runtime's bindings and writer,
#: the batch prep through the matcher, /report bodies on the native prep,
#: and the device route path's native half (skip_routes, pruning, dt)
TESTS = ("tests/test_torch_native.py", "tests/test_torch_matcher.py",
         "tests/test_torch_parity_inputs.py",
         "tests/test_torch_route_device.py")
#: prep threads in the pytest legs, the drive's in the tsan leg
PREP_THREADS = 2
TSAN_PREP_THREADS = 4
#: seconds a child may run
CHILD_TIMEOUT_S = 1800


def log(msg: str) -> None:
    print(f"== sanitize: {msg} ==", flush=True)


def flags(leg: str) -> tuple:
    """The leg's full compiler flags."""
    extra = tuple(f for f in native.cxx_flags() if f.startswith("-mf16c")
                  or f == "-mavx")
    return SAN_FLAGS + extra + LEGS[leg][0] + ("-shared",)


def library_path(leg: str) -> Path:
    """Where the leg's build lands: ``libreporter_host_<leg>-<sha16>.so``."""
    return native.BUILD_DIR / native.library_name(
        flags(leg), f"libreporter_host_{leg}")


def build(leg: str, cxx: str = None) -> Path:
    """Compile the leg's library (once per source and flags)."""
    return native.build(flags(leg), f"libreporter_host_{leg}", cxx)


def runtime_library(leg: str, cxx: str = None) -> str:
    """The sanitizer runtime's path as the compiler gives it."""
    out = subprocess.run([cxx or native.CXX,
                          f"-print-file-name={LEGS[leg][1]}"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def probe(leg: str, cxx: str = None) -> bool:
    """Whether the compiler links a program with the leg's sanitizer."""
    with tempfile.TemporaryDirectory(prefix="reporter_san_") as d:
        try:
            proc = subprocess.run(
                [cxx or native.CXX, LEGS[leg][0][0], "-x", "c++", "-",
                 "-o", str(Path(d) / "probe")],
                input="int main(){return 0;}", capture_output=True,
                text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            return False
    return proc.returncode == 0


def env_prefix(leg: str, cxx: str = None) -> list:
    """``env LD_PRELOAD=... <OPTIONS>=...``: the child's command prefix,
    which adds the two variables to the environment it inherits."""
    preload = [runtime_library(leg, cxx)]
    if leg == "asan":
        preload.append(subprocess.run(
            [cxx or native.CXX, "-print-file-name=libstdc++.so"],
            capture_output=True, text=True, timeout=60).stdout.strip())
    name, value = LEGS[leg][2]
    return ["env", "LD_PRELOAD=" + " ".join(preload), f"{name}={value}"]


def preload_survives(leg: str, cxx: str = None) -> bool:
    """Whether an interpreter starts with the leg's runtime preloaded
    (some glibc and libtsan pairings abort on an unexpected mapping)."""
    name, _ = LEGS[leg][2]
    cmd = env_prefix(leg, cxx)[:2] + [f"{name}=report_bugs=0:exitcode=0",
                                      sys.executable, "-c", "pass"]
    try:
        return subprocess.run(cmd, capture_output=True,
                              timeout=120).returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        return False


def child_command(leg: str, lib: Path, cxx: str = None) -> list:
    """The child interpreter's command line for one leg."""
    if leg == "tsan":
        body = [sys.executable, "-m", "reporter_tpu_torch.tools.tsan_drive",
                "--library", str(lib), "--prep-threads",
                str(TSAN_PREP_THREADS)]
    else:
        body = [sys.executable, "-m", "reporter_tpu_torch.tools.sanitize",
                "--pytest-child", str(lib)]
    return env_prefix(leg, cxx) + body


def pytest_child(lib: str, tests=TESTS) -> int:
    """In the child: bind the instrumented library, set the native prep
    to ``PREP_THREADS`` and run the test files in this process."""
    import pytest

    from ..matcher import matcher
    native.load(library=lib)
    matcher.PREP_THREADS_MAX = PREP_THREADS
    return int(pytest.main([*tests, "-q", "-p", "no:cacheprovider",
                            "-p", "no:randomly"]))


def run_leg(leg: str, cxx: str = None, timeout: float = CHILD_TIMEOUT_S
            ) -> str:
    """Probe, build and run one leg: "skipped", "ok" or "failed"."""
    if not probe(leg, cxx):
        log(f"{cxx or native.CXX} cannot link -fsanitize for {leg}; "
            f"skipping {leg}")
        return "skipped"
    if leg == "tsan" and not preload_survives(leg, cxx):
        log("libtsan cannot be preloaded into this interpreter; "
            "skipping tsan")
        return "skipped"
    log(f"building and running under {leg}")
    lib = build(leg, cxx)
    try:
        rc = subprocess.run(child_command(leg, lib, cxx), cwd=REPO,
                            timeout=timeout).returncode
    except subprocess.TimeoutExpired:
        log(f"{leg}: the child ran past {timeout} s")
        return "failed"
    log(f"{leg}: child exited {rc}")
    return "ok" if rc == 0 else "failed"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m reporter_tpu_torch.tools.sanitize",
        description=__doc__.splitlines()[0])
    parser.add_argument("mode", nargs="?", default="default",
                        choices=("default", "asan", "ubsan", "tsan"),
                        help="default: asan then ubsan; tsan runs alone")
    parser.add_argument("--cxx", default=None,
                        help=f"the C++ compiler (default {native.CXX})")
    parser.add_argument("--pytest-child", metavar="LIB",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.pytest_child:
        return pytest_child(args.pytest_child)
    legs = ("asan", "ubsan") if args.mode == "default" else (args.mode,)
    results = {leg: run_leg(leg, args.cxx) for leg in legs}
    print(" ".join(f"{leg}={r}" for leg, r in results.items()), flush=True)
    if all(r == "skipped" for r in results.values()):
        log(f"no sanitizer support in this toolchain ({args.mode}); "
            f"skipped")
        return 0
    return 1 if "failed" in results.values() else 0


if __name__ == "__main__":
    sys.exit(main())
