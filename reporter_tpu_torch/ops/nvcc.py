"""Build and load the port's CUDA kernels: one ``nvcc`` helper for every
source under ``ops/csrc/``.

Each source is compiled for Hopper (``sm_90a``) into a shared library
with a plain C interface, named by the hash of its bytes and the flags
(``reporter_tpu_torch/_build/lib<stem>-<sha16>.so``), at first use and
never at import, and loaded with ``ctypes``. ptxas's report (``-Xptxas
-v``: registers, spills) is kept beside the library as ``.log``, so a
later process that finds the library built still has it. Several
processes may build at once: each compiles to a name of its own and
moves the result into place. A missing ``nvcc`` or a failed build
raises. :func:`add_listener` hears of each build and load (the
profiler's build telemetry).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
#: IEEE f32 throughout: no FMA contraction (the plain versions and the
#: JAX package round every multiply and add), IEEE division, no fast math
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_locks: dict = {}   # source path -> its lock: two sources build at once
_loaded: dict = {}  # source path -> (ctypes.CDLL, build log)
_listeners: list = []


def add_listener(fn) -> None:
    """Call ``fn(event, seconds, stem)`` on the loading thread each time
    :func:`load` builds a library (``"build"``: nvcc and the load) or
    loads one already built (``"load"``)."""
    with _lock:
        if fn not in _listeners:
            _listeners.append(fn)


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit's nvcc")


def library_path(source: Path, stem: str) -> Path:
    """Where ``source`` is built: named by its bytes and the flags."""
    tag = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    return BUILD_DIR / f"lib{stem}-{tag}.so"


def load(source: Path, stem: str):
    """Compile ``source`` (once per content and flags) and load it.
    Returns ``(ctypes.CDLL, compiler log)``; raises if the build fails."""
    with _lock:
        lock = _locks.setdefault(source, threading.Lock())
    # the build runs under its source's lock by design: a library builds
    # once, and a second caller waits for that build, not a second nvcc
    with lock:  # lint: ignore[LD003]
        got = _loaded.get(source)
        if got is None:
            t0 = time.perf_counter()
            event = "load"
            out = library_path(source, stem)
            log_path = out.with_suffix(".log")
            if not out.exists():
                event = "build"
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                proc = subprocess.run(
                    [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                    capture_output=True, text=True)
                log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"nvcc failed ({proc.returncode}) "
                                       f"building {source.name}:\n{log}")
                log_path.write_text(log)
                os.replace(tmp, out)
            log = log_path.read_text() if log_path.exists() else ""
            got = _loaded[source] = (ctypes.CDLL(str(out)), log)
            for fn in list(_listeners):
                fn(event, time.perf_counter() - t0, stem)
        return got


def check_operands(dev, **tensors) -> None:
    """Raise unless every tensor lies on the CUDA device ``dev``, is
    contiguous and starts on 16 bytes (a tensor of its own does; a slice
    may not), as the kernels read them."""
    for name, x in tensors.items():
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be on the CUDA device {dev}, "
                             f"got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes (a tensor of "
                             f"its own does; a slice may not)")
